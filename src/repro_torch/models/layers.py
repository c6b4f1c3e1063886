"""Transformer building blocks: plain functions on tensors.

Mirrors ``repro.models.layers``: parameters are nested dicts with the same
leaf names, projections stay fused 2-D ([d, H*hd]), and activations keep
the same layouts (x [B,T,D], per-layer cache [B,Smax,KV,hd]).

Two differences from JAX shape the code:
  * ``torch.einsum``/``matmul`` refuse mixed dtypes where JAX promotes
    (an fp32 q against the bf16 cache), so operands are cast to the type
    JAX would compute in (``torch.promote_types``);
  * ``lax.dynamic_update_slice`` clamps an out-of-range write; the port
    writes the cache by slice, in place, and raises on overflow instead.
Under a mesh with a "model" axis (``parallel.ctx``) the projections and
attention run tensor-parallel, SPMD on each rank's own tensors: ``_qkv``
with ``pad_tp`` returns this rank's share of the heads, zero-padded up to a
multiple of the axis when they do not divide it (the reference's
``pad_tp``), and ``swiglu_tp`` splits the hidden dim.  The gradients of the
weights and of the region's input are summed over the axis
(``parallel.spmd``).  Under placed parameters (``ctx.param_placements``,
a train step's) the model is given each rank's blocks: a weight split
over "model" arrives as this rank's block, taken as it is where it is the
rank's part (``spmd.model_part``); the embedding looks up its rank's
slice of the vocab and ``lm_loss`` runs the head and the cross-entropy
vocab-parallel.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from ..parallel import ctx, spmd

Params = Dict[str, Any]


# ---------------------------------------------------------------- initializers

def _normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * std).to(dtype)


def _dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
                dtype) -> torch.Tensor:
    return _normal(gen, (in_dim, out_dim), (2.0 / (in_dim + out_dim)) ** 0.5,
                   dtype)


def init_attention(cfg: ArchConfig, gen: torch.Generator, dtype) -> Params:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dev = gen.device
    p: Params = {
        "wq": _dense_init(gen, d, H * hd, dtype),
        "wk": _dense_init(gen, d, KV * hd, dtype),
        "wv": _dense_init(gen, d, KV * hd, dtype),
        "wo": _dense_init(gen, H * hd, d, dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(H * hd, dtype=dtype, device=dev)
        p["bk"] = torch.zeros(KV * hd, dtype=dtype, device=dev)
        p["bv"] = torch.zeros(KV * hd, dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=dtype, device=dev)
        p["k_norm"] = torch.ones(hd, dtype=dtype, device=dev)
    return p


def init_mlp(d: int, f: int, gen: torch.Generator, dtype) -> Params:
    return {
        "w1": _dense_init(gen, d, f, dtype),   # gate
        "w3": _dense_init(gen, d, f, dtype),   # up
        "w2": _dense_init(gen, f, d, dtype),   # down
    }


def init_block(cfg: ArchConfig, gen: torch.Generator, dtype) -> Params:
    dev = gen.device
    return {
        "ln1": torch.ones(cfg.d_model, dtype=dtype, device=dev),
        "attn": init_attention(cfg, gen, dtype),
        "ln2": torch.ones(cfg.d_model, dtype=dtype, device=dev),
        "mlp": init_mlp(cfg.d_model, cfg.d_ff, gen, dtype),
    }


# -------------------------------------------------------- [L]-stacked layers

def init_stacked(n: int, init_one: Callable[[], Params]) -> Params:
    """``n`` draws of ``init_one()`` stacked on a leading [n] axis, as the
    reference's ``jax.vmap`` over layer keys lays them out.  Layers are drawn
    one at a time into the stacked leaves, so the fp32 draw never holds more
    than one layer."""
    first = init_one()
    stacked = _empty_like_stacked(first, n)
    _stack_into(stacked, first, 0)
    for i in range(1, n):
        _stack_into(stacked, init_one(), i)
    return stacked


def _empty_like_stacked(tree: Params, n: int) -> Params:
    return {k: _empty_like_stacked(v, n) if isinstance(v, dict)
            else v.new_empty((n, *v.shape)) for k, v in tree.items()}


def _stack_into(dst: Params, src: Params, i: int) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _stack_into(dst[k], v, i)
        else:
            dst[k][i] = v


def unstack(stacked: Params) -> list:
    """The per-layer slices of an [L]-stacked tree, as views.

    One ``torch.unbind`` per leaf: its backward stacks the L layer gradients
    into the stacked leaf's once, where indexing layer by layer would add a
    zero-padded [L, ...] gradient per layer."""
    flat = {k: (unstack(v) if isinstance(v, dict) else torch.unbind(v))
            for k, v in stacked.items()}
    n = len(next(iter(flat.values())))
    return [{k: v[i] for k, v in flat.items()} for i in range(n)]


# ------------------------------------------------------------------- primitives

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, T, H, hd]; positions: [B, T]."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions[..., None].float() * freqs            # [B, T, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in the dtype JAX's einsum would promote the pair to."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def swiglu(p: Params, x: torch.Tensor) -> torch.Tensor:
    gate = torch.nn.functional.silu(_mm(x, p["w1"]))
    return _mm(gate * _mm(x, p["w3"]), p["w2"])


def tp_mesh():
    """The ambient mesh when it has a "model" axis, else None."""
    mesh = ctx.get_mesh()
    if mesh is None or "model" not in (mesh.mesh_dim_names or ()):
        return None
    return mesh


def _tp_size() -> int:
    mesh = tp_mesh()
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index("model"))


def gatherer(name: str, stacked: bool = False, whole: bool = False):
    """The function that turns this rank's blocks of ``params[name]`` (one
    layer's, for an [L]-stacked tree) into what the model computes with:
    ``spmd.gather`` under placed parameters, else the identity.  A block
    calls it inside its checkpointed function, on the blocks it was given."""
    pl = ctx.param_placements()
    if pl is None:
        return lambda tree: tree
    pl = spmd.layer_placements(pl[name]) if stacked else pl[name]
    mesh = ctx.get_mesh()
    return lambda tree: spmd.gather(tree, pl, mesh, whole)


def swiglu_tp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``swiglu``; under a mesh with a "model" axis, its hidden dim split over
    the axis (each rank's share of w1, w3 columns and w2 rows, the partial
    outputs summed), or the whole product on every rank when the dim does
    not divide the axis, as the sharding rules then replicate it."""
    mesh, tp = tp_mesh(), _tp_size()
    f = spmd.whole_size(p["w1"], 1, mesh)
    if mesh is None or f % tp:
        return swiglu(p, x)
    x = spmd.enter_model(x, mesh)
    w1, w3, w2 = (spmd.model_part(p[n], mesh, dim, f // tp)
                  for n, dim in (("w1", 1), ("w3", 1), ("w2", 0)))
    out = _mm(torch.nn.functional.silu(_mm(x, w1)) * _mm(x, w3), w2)
    return spmd.reduce_model(out, mesh)


# ------------------------------------------------------------------- attention

def _qkv(cfg: ArchConfig, p: Params, x: torch.Tensor, positions: torch.Tensor,
         pad_tp: bool = False):
    """QKV projections (+bias, qk-norm, RoPE) -> q [B,T,H,hd], k/v [B,T,KV,hd].

    ``pad_tp`` under a mesh with a "model" axis of size tp: TP head padding.
    When the heads do not divide tp, the projection weights are padded with
    zero columns up to Hp, the next multiple of tp (exact: the phantom
    heads meet zero rows of wo), and GQA with kv heads that do not divide
    tp expands k/v per padded q head.  Each rank computes and returns its
    Hp / tp heads only (rank r: heads [r Hp/tp, (r+1) Hp/tp)), and k/v the
    kv heads those read."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    b, t, _ = x.shape
    mesh = tp_mesh() if pad_tp else None
    if mesh is None:
        q, k, v = _mm(x, p["wq"]), _mm(x, p["wk"]), _mm(x, p["wv"])
        if cfg.qkv_bias:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        hq, nk = H, KV
    else:
        tp = _tp_size()
        need = tp > 1 and (H % tp != 0 or KV % tp != 0)
        hp = -(-H // tp) * tp if need else H
        mha = KV == H
        hq = hp // tp
        x = spmd.enter_model(x, mesh)

        def q_cols(w):          # padded to hp heads, this rank's hq of them
            return spmd.model_part(w, mesh, -1, hq * hd, padded=hp * hd)

        if need and not mha:    # GQA-uneven: k/v whole here, expanded below
            kv_cols, nk = (lambda w: spmd.model_whole(w, mesh)), KV
        elif need:              # MHA: padded like q
            kv_cols, nk = q_cols, hq
        else:
            nk = KV // tp
            kv_cols = lambda w: spmd.model_part(w, mesh, -1, nk * hd)  # noqa: E731
        q = _mm(x, q_cols(p["wq"]))
        k, v = _mm(x, kv_cols(p["wk"])), _mm(x, kv_cols(p["wv"]))
        if cfg.qkv_bias:
            q, k, v = q + q_cols(p["bq"]), k + kv_cols(p["bk"]), v + kv_cols(p["bv"])
    q = q.reshape(b, t, hq, hd)
    k = k.reshape(b, t, nk, hd)
    v = v.reshape(b, t, nk, hd)
    if mesh is not None and need and not mha:
        # each of this rank's padded q heads reads kv head min(h // (H/KV), KV-1)
        lo = spmd.model_rank(mesh) * hq
        qmap = torch.clamp(torch.arange(lo, lo + hq, device=x.device) // max(H // KV, 1),
                           max=KV - 1)
        k, v = k[:, :, qmap], v[:, :, qmap]
    if cfg.qk_norm:
        norms = ((p["q_norm"], p["k_norm"]) if mesh is None else
                 (spmd.model_whole(p["q_norm"], mesh), spmd.model_whole(p["k_norm"], mesh)))
        q = rms_norm(q, norms[0])
        k = rms_norm(k, norms[1])
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def _sdpa(cfg: ArchConfig, q, k, v, q_pos, k_pos, k_valid=None):
    """Grouped-query scaled-dot-product attention with causal (+SWA) mask.

    q [B,Tq,H,hd], k/v [B,Tk,KV,hd]; *_pos absolute positions [B,Tq]/[B,Tk].
    k_valid: optional [B,Tk] bool (cache entries actually written)."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    b, tq = q.shape[0], q.shape[1]
    dt = torch.promote_types(q.dtype, k.dtype)
    qg = q.reshape(b, tq, KV, H // KV, hd).to(dt)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, k.to(dt)).float()
    logits = logits / (hd ** 0.5)
    mask = q_pos[:, None, None, :, None] >= k_pos[:, None, None, None, :]
    if cfg.swa_window:
        near = (q_pos[:, None, None, :, None]
                - k_pos[:, None, None, None, :]) < cfg.swa_window
        mask = mask & near
    if k_valid is not None:
        mask = mask & k_valid[:, None, None, None, :]
    logits = logits.masked_fill(~mask, -1e30)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", w.to(dt), v.to(dt))
    return out.reshape(b, tq, H * hd)


def _write_slot(cache: torch.Tensor, new: torch.Tensor, pos: int) -> None:
    """cache[:, pos] = new, in place; raises where JAX would clamp."""
    if not 0 <= pos < cache.shape[1]:
        raise IndexError(f"cache write at slot {pos} outside [0, {cache.shape[1]})")
    cache[:, pos:pos + 1] = new.to(cache.dtype)


def attention_decode(cfg: ArchConfig, p: Params, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     write_pos: int, q_pos: int, n_valid: int,
                     kv_scale: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """One-token decode against a KV cache (ring buffer for SWA).

    x [B,1,D]; cache_k/v [B,Smax,KV,hd] (bf16, or int8 with kv_scale);
    write_pos: slot to write (== q_pos for full attn, q_pos % window for SWA);
    q_pos: absolute position of the new token (RoPE);
    n_valid: number of populated cache slots AFTER this write.
    The new token's k/v (and scales) are written into the given cache
    tensors in place.  Returns (out [B,1,D], cache_k, cache_v, scales)."""
    b = x.shape[0]
    smax = cache_k.shape[1]
    dev = x.device
    positions = torch.full((b, 1), q_pos, dtype=torch.int32, device=dev)
    q, k_new, v_new = _qkv(cfg, p, x, positions)

    slot = torch.arange(smax, dtype=torch.int32, device=dev)[None, :].expand(b, smax)
    k_valid = slot < n_valid
    if kv_scale is not None:
        ks, vs = kv_scale
        k_q, k_s = _quantize_kv(k_new)
        v_q, v_s = _quantize_kv(v_new)
        for dst, src in ((cache_k, k_q), (cache_v, v_q), (ks, k_s), (vs, v_s)):
            _write_slot(dst, src, write_pos)
        # scales applied after the dot: (q.k_q)*s_k == q.(k_q*s_k) per (token, head)
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        qg = q.reshape(b, 1, KV, H // KV, hd)
        s = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), cache_k.float())
        s = s * ks[..., 0].transpose(1, 2)[:, :, None, None, :].float()
        s = s / (hd ** 0.5)
        s = s.masked_fill(~k_valid[:, None, None, None, :], -1e30)
        pr = torch.softmax(s, dim=-1)
        pv = (pr * vs[..., 0].transpose(1, 2)[:, :, None, None, :].float()
              ).to(torch.bfloat16)
        outh = torch.einsum("bkgqs,bskh->bqkgh", pv, cache_v.to(torch.bfloat16))
        out = outh.reshape(b, 1, H * hd)
        new_scales = (ks, vs)
    else:
        _write_slot(cache_k, k_new, write_pos)
        _write_slot(cache_v, v_new, write_pos)
        zeros = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        out = _sdpa(cfg, q, cache_k, cache_v, zeros, torch.zeros_like(slot),
                    k_valid)
        new_scales = None
    return _mm(out, p["wo"]), cache_k, cache_v, new_scales


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per (token, head) symmetric int8 quantization along hd."""
    x32 = x.float()
    scale = x32.abs().amax(-1, keepdim=True) / 127.0 + 1e-8
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


# ------------------------------------------------------------------- embeddings

def init_embeddings(cfg: ArchConfig, gen: torch.Generator, dtype) -> Params:
    V = padded_vocab(cfg)
    p = {"tok": _normal(gen, (V, cfg.d_model), 0.02, dtype),
         "ln_f": torch.ones(cfg.d_model, dtype=dtype, device=gen.device)}
    if not cfg.tie_embeddings:
        p["out"] = _dense_init(gen, cfg.d_model, V, dtype)
    return p


def padded_vocab(cfg: ArchConfig) -> int:
    return (cfg.vocab + 255) // 256 * 256


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``tokens``; with ``emb/tok`` split over "model" (placed
    parameters), each rank looks up the tokens in its slice of the vocab and
    the rows are summed over the axis."""
    tok = gatherer("emb")({"tok": p["tok"]})["tok"]
    if spmd.model_dim(tok) != 0:
        return tok[tokens]
    mesh, n = tp_mesh(), tok.shape[0]
    lo = spmd.model_rank(mesh) * n
    mine = (tokens >= lo) & (tokens < lo + n)
    rows = tok[torch.where(mine, tokens - lo, 0)]
    return spmd.reduce_model(torch.where(mine[..., None], rows, 0), mesh)


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, p["ln_f"])
    if "out" in p:
        return _mm(x, p["out"])
    return _mm(x, p["tok"].t())


def lm_loss(p: Params, h: torch.Tensor, labels: torch.Tensor, vocab: int) -> torch.Tensor:
    """``cross_entropy(unembed(p, h), labels, vocab)``.  With the head
    (``emb/out``, or a tied ``emb/tok``) split over "model" by the vocab
    (placed parameters), vocab-parallel: each rank's logits are its slice
    of the vocab, [B, T, V / tp], and the cross-entropy's max, exp-sum and
    gold logit are reduced over "model" (``_cross_entropy_vocab_parallel``)."""
    tied = "out" not in p
    head = gatherer("emb")({k: p[k] for k in ("ln_f", "tok" if tied else "out")})
    w = head["tok" if tied else "out"]
    mesh = tp_mesh()
    if spmd.model_dim(w) != (0 if tied else 1):
        return cross_entropy(unembed(head, h), labels, vocab)
    x = spmd.enter_model(rms_norm(h, head["ln_f"]), mesh)
    logits = _mm(x, w.t() if tied else w)
    return _cross_entropy_vocab_parallel(logits, labels, vocab,
                                         spmd.model_rank(mesh) * logits.shape[-1], mesh)


def _cross_entropy_vocab_parallel(logits: torch.Tensor, labels: torch.Tensor, vocab: int,
                                  lo: int, mesh) -> torch.Tensor:
    """``cross_entropy`` of logits whose last dim holds vocab entries
    [lo, lo + n) on each "model" rank.  The row max is the largest over the
    axis and keeps its gradient (the reference's max term, on the rank that
    holds the argmax); the exp-sum and the gold logit are summed over it."""
    logits = logits.float()
    n = logits.shape[-1]
    if lo + n > vocab:          # the padded entries, on whichever rank holds them
        cols = lo + torch.arange(n, device=logits.device)
        logits = logits.masked_fill(cols >= vocab, -1e30)
    m = spmd.max_model(logits, mesh)
    s = spmd.reduce_model(torch.exp(logits - m.detach()[..., None]).sum(-1), mesh)
    logz = torch.log(s) + m
    mine = (labels >= lo) & (labels < lo + n)
    gold = torch.gather(logits, -1, torch.where(mine, labels - lo, 0)[..., None].long())[..., 0]
    gold = spmd.reduce_model(torch.where(mine, gold, 0.0), mesh)
    return (logz - gold).mean()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab: int) -> torch.Tensor:
    """fp32 softmax cross-entropy, ignoring padded vocab entries.

    Mirrors ``repro.models.layers.cross_entropy``, with one difference: the
    gold logit is gathered (``torch.gather``) where the reference sums
    against an iota one-hot, which it keeps for GSPMD's vocab sharding.
    Exactly one term of that sum is nonzero, so the value is the same and
    no [B,T,V] one-hot is made."""
    logits = logits.float()
    if logits.shape[-1] > vocab:
        cols = torch.arange(logits.shape[-1], device=logits.device)
        logits = logits.masked_fill(cols >= vocab, -1e30)
    m = logits.amax(-1, keepdim=True)
    logz = torch.log(torch.exp(logits - m.detach()).sum(-1)) + m[..., 0]
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()
