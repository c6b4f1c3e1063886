"""Decoder-only LM, dense and MoE: init, forward and loss, prefill, decode.

Mirrors ``repro.models.transformer`` for the dense, audio and vlm families
(codeqwen1.5-7b, phi3-medium-14b, minicpm-2b, qwen1.5-32b, musicgen-large,
chameleon-34b) and the moe family (mixtral-8x22b, arctic-480b), whose
feed-forward half is ``moe.moe_block``.  Layer parameters keep the
reference's stacked leading [L] axis; a Python loop over it takes the
place of ``lax.scan``, and
``torch.utils.checkpoint`` on each layer that of ``jax.checkpoint``.
Attention in the forward and in prefill goes through
``ops.flash_attention``, so on the card it runs the hand-written flash
kernels, forward and backward.

Under a mesh with a "model" axis (``parallel.ctx``) the forward, and so
the loss, runs tensor-parallel as the reference's does under GSPMD: each
rank attends over its share of the heads, zero-padded to a multiple of the
axis (``layers._qkv``'s ``pad_tp``, with zero rows of ``wo`` for the
phantom heads), runs its share of the MLP's hidden dim, and the partial
outputs are summed.  Prefill pads no heads, as the reference's does not,
so its K/V cache holds the model's KV heads.

Under placed parameters and a sharded batch (a placed serving call,
``serve.server.placed_prefill``/``placed_decode``), prefill and decode run
SPMD on each rank's rows and blocks: each layer gathers its blocks, the
attention runs on the rank's padded heads as the loss's does, and the
cache is the rank's block as ``ctx.kv_split`` says: its KV heads (split by
heads), its slots of every KV head (split by sequence: their k/v computed
from the whole ``wk``/``wv`` for only the positions those slots hold), or
all of it.  Padded heads never reach the cache.

One difference: with a sliding window, prefill stores position j of the
prompt in cache slot j mod W, where decode writes it.  The reference
stores the last W positions in slots 0..W-1, so for a prompt longer than
W, and not a multiple of it, its decode overwrites a key still inside
the window and keeps one that has left it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..configs.base import ArchConfig
from ..kernels import ops
from ..parallel import ctx, spmd
from ..serve import graphs
from . import layers, moe
from .layers import Params

Cache = Dict[str, torch.Tensor]


def _residual_scale(cfg: ArchConfig) -> float:
    # minicpm: depth-scaled residual branch (scale_depth / sqrt(L))
    return 1.4 / (cfg.n_layers ** 0.5) if cfg.depth_scaled_residual else 1.0


# ------------------------------------------------------------------ init

def init_layer(cfg: ArchConfig, gen: torch.Generator, dtype) -> Params:
    if cfg.family == "moe":
        dev = gen.device
        p = {
            "ln1": torch.ones(cfg.d_model, dtype=dtype, device=dev),
            "attn": layers.init_attention(cfg, gen, dtype),
            "ln2": torch.ones(cfg.d_model, dtype=dtype, device=dev),
            "moe": moe.init_moe_block(cfg, gen, dtype),
        }
        if cfg.dense_residual:
            p["mlp"] = layers.init_mlp(cfg.d_model, cfg.d_ff, gen, dtype)
        return p
    return layers.init_block(cfg, gen, dtype)


def init_params(cfg: ArchConfig, seed: int = 0, dtype=torch.bfloat16,
                device="cuda") -> Params:
    """Random parameters from a seeded ``torch.Generator`` on ``device``.

    Same tree and scales as the reference (``layers._dense_init``,
    ``init_embeddings``); the draws differ, since the generators do."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    emb = layers.init_embeddings(cfg, gen, dtype)
    stacked = layers.init_stacked(cfg.n_layers, lambda: init_layer(cfg, gen, dtype))
    return {"emb": emb, "layers": stacked}


# ------------------------------------------------------------------ forward

def _mix(cfg: ArchConfig, lp: Params, h: torch.Tensor) -> torch.Tensor:
    """The feed-forward (MLP or MoE) half of a block; under a mesh, split over
    its "model" axis."""
    hin = layers.rms_norm(h, lp["ln2"])
    if cfg.family == "moe":
        return moe.moe_block(cfg, lp["moe"], hin,
                             mlp=lp.get("mlp") if cfg.dense_residual else None)
    return layers.swiglu_tp(lp["mlp"], hin)


def _attn_full(cfg: ArchConfig, lp: Params, h: torch.Tensor,
               positions: torch.Tensor, pad_tp: bool = False):
    """Self-attention over h; returns (branch output, k, v).  ``pad_tp``: TP
    head padding under a mesh (``layers._qkv``); k and v are then this
    rank's padded heads, so prefill, which caches them, does not pad."""
    b, t, _ = h.shape
    q, k, v = layers._qkv(cfg, lp["attn"], layers.rms_norm(h, lp["ln1"]),
                          positions, pad_tp=pad_tp)
    hq, kvh = q.shape[2], k.shape[2]
    out = ops.flash_attention(q.reshape(b, t, kvh, hq // kvh, cfg.hd),
                              k, v, window=cfg.swa_window)
    out = out.reshape(b, t, hq * cfg.hd)
    mesh = layers.tp_mesh() if pad_tp else None
    if mesh is None:
        return layers._mm(out, lp["attn"]["wo"]), k, v
    # zero rows for the phantom heads (exact), this rank's rows of them
    wo = spmd.model_part(lp["attn"]["wo"], mesh, 0, hq * cfg.hd,
                         padded=hq * layers._tp_size() * cfg.hd)
    return spmd.reduce_model(layers._mm(out, wo), mesh), k, v


def _positions(b: int, t: int, device) -> torch.Tensor:
    return torch.arange(t, dtype=torch.int32, device=device)[None].expand(b, t)


def _hidden(cfg: ArchConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, T] -> the last layer's output [B, T, d].

    Differentiable in every parameter leaf.  Each layer is checkpointed, as
    the reference's default ``remat=True`` does: it keeps only its input for
    the backward and runs again inside it.  Under placed parameters it is
    given the layer's blocks and gathers them inside, so the recompute
    gathers them again and one layer at a time is held gathered."""
    b, t = tokens.shape
    positions = _positions(b, t, tokens.device)
    h = layers.embed(params["emb"], tokens)
    rs = _residual_scale(cfg)
    gather = layers.gatherer("layers", stacked=True)

    def block(h, lp):
        lp = gather(lp)
        h = h + rs * _attn_full(cfg, lp, h, positions, pad_tp=True)[0]
        return h + rs * _mix(cfg, lp, h)

    for lp in layers.unstack(params["layers"]):
        h = checkpoint(block, h, lp, use_reentrant=False)
    return h


def forward(cfg: ArchConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, T] -> logits [B, T, V]."""
    return layers.unembed(params["emb"], _hidden(cfg, params, tokens))


def loss_fn(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor]
            ) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` against ``batch["labels"]``."""
    return layers.lm_loss(params["emb"], _hidden(cfg, params, batch["tokens"]),
                          batch["labels"], cfg.vocab)


# ------------------------------------------------------------------ serving

def kv_cache_spec(cfg: ArchConfig, batch: int, smax: int, dtype_name: str):
    """Shapes and dtypes of the per-layer-stacked KV cache."""
    kvh, hd, L = cfg.n_kv_heads, cfg.hd, cfg.n_layers
    if cfg.swa_window:
        smax = min(smax, cfg.swa_window)    # SWA: ring buffer of window size
    if dtype_name == "int8":
        return {
            "k": ((L, batch, smax, kvh, hd), torch.int8),
            "v": ((L, batch, smax, kvh, hd), torch.int8),
            "k_scale": ((L, batch, smax, kvh, 1), torch.bfloat16),
            "v_scale": ((L, batch, smax, kvh, 1), torch.bfloat16),
        }
    return {
        "k": ((L, batch, smax, kvh, hd), torch.bfloat16),
        "v": ((L, batch, smax, kvh, hd), torch.bfloat16),
    }


def _prompt_runs(t: int, n_slots: int, lo: int, n: int):
    """The prompt positions whose K/V land in cache slots [lo, lo + n) of a
    cache of ``n_slots`` (position j in slot j mod n_slots, the ring decode
    continues; the last n_slots positions kept), as runs of consecutive
    positions in slot order: (first slot - lo, first position, length) each,
    at most two; slots past the prompt hold none."""
    runs, s, end = [], lo, min(lo + n, t)
    while s < end:
        j = s + n_slots * ((t - 1 - s) // n_slots)
        m = min(end - s, t - j)
        runs.append((s - lo, j, m))
        s += m
    return runs


class PromptKV:
    """Where a prompt [B, T]'s K/V land in this rank's block of a layer's
    cache of ``cache_smax`` slots (``ctx.kv_split``): its KV heads of every
    slot (split by heads), its slots of every KV head (split by sequence),
    or all of it; position j in slot j mod cache_smax.  Where the rank holds
    every KV head of its slots under placed parameters, their K/V come from
    the layer's input for only the positions those slots hold (``own``);
    else from the attention's own k/v, which are then the rank's heads."""

    def __init__(self, cfg: ArchConfig, b: int, t: int, cache_smax: int, device):
        split = ctx.kv_split()
        self.cfg = cfg
        lo, self.n_slots = layers.cache_slots(cache_smax)
        self.kv_heads = cfg.n_kv_heads // (layers._tp_size() if split == "heads" else 1)
        self.runs = _prompt_runs(t, cache_smax, lo, self.n_slots)
        self.own_rows = ctx.param_placements() is not None and split != "heads"
        if self.own_rows:
            self.row_pos = self.rows(torch.arange(t, device=device)[None].expand(b, t))

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """x's prompt positions that this rank's slots hold, in slot order."""
        return torch.cat([x[:, :0]] + [x[:, j:j + m] for _, j, m in self.runs], 1)

    def own(self, lp: Params, h: torch.Tensor):
        """(k, v) of every KV head for this rank's slots, from the layer's input
        h (``own_rows``; the attention's k/v are its padded heads), else None."""
        if not self.own_rows:
            return None
        return layers._kv(self.cfg, layers.whole(lp["attn"]),
                          layers.rms_norm(self.rows(h), lp["ln1"]), self.row_pos)

    def write(self, cache_k: torch.Tensor, cache_v: torch.Tensor, own, k_all: torch.Tensor,
              v_all: torch.Tensor) -> None:
        """A layer's K/V into its cache [B, n_slots, KV, hd] in place: ``own``
        where given, else the attention's k/v [B, T, KV, hd] by slot runs."""
        if own is not None:
            k, v = own
            cache_k[:, :k.shape[1]] = k
            cache_v[:, :v.shape[1]] = v
            return
        for off, j, m in self.runs:
            cache_k[:, off:off + m] = k_all[:, j:j + m]
            cache_v[:, off:off + m] = v_all[:, j:j + m]


def prefill(cfg: ArchConfig, params: Params, tokens: torch.Tensor, smax: int,
            kv_dtype_name: str = "bfloat16") -> Tuple[torch.Tensor, Cache]:
    """Process the full prompt; return (last-token logits [B,1,V], cache dict).

    The cache is bf16 (or int8 + bf16 scales) whatever the params' dtype,
    holds zero rows past the prompt, and is allocated once at its full
    [L, ...] size (this rank's block of it, under a placed serving call)."""
    b, t = tokens.shape
    dev = tokens.device
    cache_smax = min(smax, cfg.swa_window) if cfg.swa_window else smax
    if not cfg.swa_window and t > smax:
        raise ValueError(f"prompt of {t} tokens does not fit a cache of {smax}")
    placed = ctx.param_placements() is not None
    kvw = PromptKV(cfg, b, t, cache_smax, dev)
    cache = {name: torch.zeros((*shape[:2], kvw.n_slots, kvw.kv_heads, shape[-1]), dtype=dt,
                               device=dev)
             for name, (shape, dt) in kv_cache_spec(cfg, b, smax, kv_dtype_name).items()}
    positions = _positions(b, t, dev)
    h = layers.embed(params["emb"], tokens)
    rs = _residual_scale(cfg)
    gather = layers.gatherer("layers", stacked=True)
    for i, lp in enumerate(layers.unstack(params["layers"])):
        lp = gather(lp)
        own = kvw.own(lp, h)
        attn, k_all, v_all = _attn_full(cfg, lp, h, positions, pad_tp=placed)
        h = h + rs * attn
        h = h + rs * _mix(cfg, lp, h)
        if kv_dtype_name == "int8":
            # quantized after zero-padding, as the reference does, so the
            # unused slots hold the scale of a zero row
            k, v = own if own is not None else (kvw.rows(k_all), kvw.rows(v_all))
            pad = (0, 0, 0, 0, 0, kvw.n_slots - k.shape[1])
            (kq, ks), (vq, vs) = (layers._quantize_kv(F.pad(x, pad)) for x in (k, v))
            for name, x in (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs)):
                cache[name][i] = x
        else:
            kvw.write(cache["k"][i], cache["v"][i], own, k_all, v_all)
    return layers.unembed(params["emb"], h[:, -1:]), cache


def decode_step(cfg: ArchConfig, params: Params, token: torch.Tensor,
                cache: Cache, cache_len: int) -> Tuple[torch.Tensor, Cache]:
    """One decode step.  token [B,1]; cache from ``prefill``; cache_len: the
    number of positions already in it.  The new token's k/v are written into
    ``cache`` in place.  Returns (logits [B,1,V], cache).  On the decode kernel's
    route, off a mesh and for a dense block, the step runs as segments that a
    server on the card captures once a wave and replays (``_decode_segments``)."""
    int8 = "k_scale" in cache
    smax = cache["k"].shape[2] * (layers._tp_size() if ctx.kv_split() == "sequence" else 1)
    write_pos = cache_len % smax if cfg.swa_window else cache_len
    n_valid = min(cache_len + 1, smax)
    if _segmented(cfg, cache):
        return _decode_segments(cfg, params, token, cache, cache_len, write_pos,
                                n_valid), cache
    h = layers.embed(params["emb"], token)
    rs = _residual_scale(cfg)
    gather = layers.gatherer("layers", stacked=True)
    for i, lp in enumerate(layers.unstack(params["layers"])):
        lp = gather(lp)
        scales = (cache["k_scale"][i], cache["v_scale"][i]) if int8 else None
        out, _, _, _ = layers.attention_decode(
            cfg, lp["attn"], layers.rms_norm(h, lp["ln1"]), cache["k"][i],
            cache["v"][i], write_pos, cache_len, n_valid, kv_scale=scales)
        h = h + rs * out
        h = h + rs * _mix(cfg, lp, h)
    return layers.unembed(params["emb"], h), cache


def _segmented(cfg: ArchConfig, cache: Cache) -> bool:
    """Whether a decode step runs as ``serve.graphs`` segments around each layer's
    decode kernel (``_decode_segments``): off a mesh, a dense block (an MoE block's
    routing is not captured) over a bf16 cache on the kernel's route (the cache lies
    where q does)."""
    return (cfg.family != "moe" and "k_scale" not in cache and ctx.get_mesh() is None
            and ops.takes_decode_attention(cache["k"], cache["k"]))


def _decode_segments(cfg: ArchConfig, params: Params, token: torch.Tensor, cache: Cache,
                     cache_len: int, write_pos: int, n_valid: int) -> torch.Tensor:
    """``decode_step``'s logits, its operations in the same order, as segments
    (``serve.graphs``) between the layers' decode kernels, the only launches that
    take the step's length: the embedding and the first layer's q/k/v and cache
    write; then, after each layer's attention, the rest of that layer and the next
    one's q/k/v and cache write, or the head.  The position and the slot are tensors
    that enter the first segment, which hands them on, so that the later ones read
    them where they lie."""
    if not 0 <= write_pos < cache["k"].shape[2]:
        raise IndexError(f"cache write at slot {write_pos} outside [0, {cache['k'].shape[2]})")
    rs = _residual_scale(cfg)
    lps = layers.unstack(params["layers"])
    last = len(lps) - 1
    b, dev = token.shape[0], token.device

    def qkv(i, h, pos, slot):
        q, k, v = layers._qkv(cfg, lps[i]["attn"], layers.rms_norm(h, lps[i]["ln1"]), pos)
        for dst, new in ((cache["k"][i], k), (cache["v"][i], v)):
            dst.index_copy_(1, slot, new.to(dst.dtype))
        return q

    def first(tok, pos, slot):
        h = layers.embed(params["emb"], tok)
        return h, qkv(0, h, pos, slot), pos, slot

    def after(i, h, out, pos, slot):
        h = h + rs * layers._out_proj(out, lps[i]["attn"]["wo"], False)
        h = h + rs * _mix(cfg, lps[i], h)
        if i == last:
            return layers.unembed(params["emb"], h)
        return h, qkv(i + 1, h, pos, slot)

    h, q, pos, slot = graphs.segment(
        ("dense", -1), first, token,
        torch.full((b, 1), cache_len, dtype=torch.int32, device=dev),
        torch.full((1,), write_pos, dtype=torch.long, device=dev))
    for i in range(len(lps)):
        hq = q.shape[2] * q.shape[3]
        out = ops.decode_attention(q, cache["k"][i], cache["v"][i], n_valid).reshape(b, 1, hq)
        if i == last:
            return graphs.segment(("dense", i), lambda hh, oo: after(last, hh, oo, None, None),
                                  h, out)
        h, q = graphs.segment(("dense", i), lambda hh, oo, pp, ss, i=i: after(i, hh, oo, pp, ss),
                              h, out, pos, slot)
