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
``pad_tp``), ``swiglu_tp`` splits the hidden dim and ``rms_norm_tp``
normalises a vector whose last dim is split.  The gradients of the
weights and of the region's input are summed over the axis
(``parallel.spmd``).  Under placed parameters (``ctx.param_placements``,
a train step's) the model is given each rank's blocks: a weight split
over "model" arrives as this rank's block, taken as it is where it is the
rank's part (``spmd.model_part``); the embedding looks up its rank's
slice of the vocab, ``unembed`` gives this rank's slice of the logits and
``lm_loss`` runs the head and the cross-entropy vocab-parallel.  A placed
serving call also hands the model its block of the K/V cache
(``ctx.kv_split``): decode attention then runs on the rank's heads, or on
its slots of every head with the softmax reduced over "model".
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from ..kernels import ops
from ..parallel import ctx, spmd
from ..parallel import sharding as shd

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


def gatherer(name: str, stacked: bool = False):
    """The function that turns this rank's blocks of ``params[name]`` (one
    layer's, for an [L]-stacked tree) into what the model computes with:
    ``spmd.gather`` under placed parameters, else the identity.  A block
    calls it inside its checkpointed function, on the blocks it was given."""
    pl = ctx.param_placements()
    if pl is None:
        return lambda tree: tree
    pl = spmd.layer_placements(pl[name]) if stacked else pl[name]
    mesh = ctx.get_mesh()
    return lambda tree: spmd.gather(tree, pl, mesh)


def model_share(n: int) -> Optional[Tuple[int, int]]:
    """(this rank's first, its count) of ``n`` heads split evenly over the
    ambient mesh's "model" axis; None without such an axis, or where they do
    not divide it (the block then runs whole on every rank)."""
    mesh = tp_mesh()
    if mesh is None or n % _tp_size():
        return None
    per = n // _tp_size()
    return spmd.model_rank(mesh) * per, per


def gathered_whole(p: Params) -> Params:
    """A block's weights as every "model" rank uses them whole, each running
    the whole block alike: blocks split over "model" gathered
    (``spmd.gather_model``); ``p`` itself without a "model" axis."""
    mesh = tp_mesh()
    if mesh is None:
        return p
    return {n: spmd.gather_model(w, mesh) for n, w in p.items()}


def rms_norm_tp(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``rms_norm`` of a vector whose last dim is split over the ambient
    mesh's "model" axis: x [..., n] and w [n] are this rank's block of it.
    The mean of squares is the local mean times n / (whole width), summed
    over "model"; on an axis of size 1 that factor is 1.0 and the sum a
    copy, so the operations and values are ``rms_norm``'s."""
    mesh = tp_mesh()
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True) * (1 / _tp_size())
    var = spmd.enter_model(spmd.reduce_model(var, mesh), mesh)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def state_model_dim(cfg: ArchConfig, name: str, shape) -> Optional[int]:
    """The dim of the recurrent state or cache leaf ``name`` of whole
    ``shape`` that ``sharding.cache_pspec`` splits over "model" on the
    ambient mesh (a placed serving call then hands the model this rank's
    block of it), or None."""
    mesh = tp_mesh()
    if mesh is None:
        return None
    spec = shd.cache_pspec(name, tuple(shape), mesh, cfg)
    return next((d for d, e in enumerate(spec) if e == shd.MP), None)


def state_block(cfg: ArchConfig, name: str, shape) -> tuple:
    """The shape of this rank's block of the state or cache leaf ``name`` of
    whole ``shape``: ``state_model_dim``'s dim divided over "model"."""
    dim = state_model_dim(cfg, name, shape)
    if dim is None:
        return tuple(shape)
    return (*shape[:dim], shape[dim] // _tp_size(), *shape[dim + 1:])


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
        q = _proj(x, p["wq"], p["bq"] if cfg.qkv_bias else None).reshape(b, t, H, hd)
        if cfg.qk_norm:
            q = rms_norm(q, p["q_norm"])
        return (rope(q, positions, cfg.rope_theta), *_kv(cfg, p, x, positions))
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
    if need and not mha:
        # each of this rank's padded q heads reads kv head min(h // (H/KV), KV-1)
        lo = spmd.model_rank(mesh) * hq
        qmap = torch.clamp(torch.arange(lo, lo + hq, device=x.device) // max(H // KV, 1),
                           max=KV - 1)
        k, v = k[:, :, qmap], v[:, :, qmap]
    if cfg.qk_norm:
        q = rms_norm(q, spmd.model_whole(p["q_norm"], mesh))
        k = rms_norm(k, spmd.model_whole(p["k_norm"], mesh))
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def _proj(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None
          ) -> torch.Tensor:
    """``x @ w (+ bias)``, every column.  Given this rank's block of a
    weight split over "model" by its columns (placed parameters), and of its
    bias, the rank's columns gathered over "model" (forward only: every
    model rank must hold the same rows of x)."""
    y = _mm(x, w) if bias is None else _mm(x, w) + bias
    return y if spmd.model_dim(w) is None else spmd.all_gather_model(y, tp_mesh())


def _out_proj(out: torch.Tensor, wo: torch.Tensor, rank_heads: bool) -> torch.Tensor:
    """``out @ wo``.  Given this rank's block of rows of ``wo`` (split over
    "model"), the block against out's matching columns (all of out where it
    holds only this rank's heads: ``rank_heads``), summed over "model"."""
    if spmd.model_dim(wo) is None:
        return _mm(out, wo)
    mesh, n = tp_mesh(), wo.shape[0]
    if not rank_heads:
        out = out.narrow(-1, spmd.model_rank(mesh) * n, n)
    return spmd.reduce_model(_mm(out, wo), mesh)


def _kv(cfg: ArchConfig, p: Params, x: torch.Tensor, positions: torch.Tensor):
    """The K/V projections (+bias, k-norm, RoPE) of every KV head -> k/v
    [B,T,KV,hd] (``_proj``)."""
    b, t, _ = x.shape
    k = _proj(x, p["wk"], p["bk"] if cfg.qkv_bias else None)
    v = _proj(x, p["wv"], p["bv"] if cfg.qkv_bias else None)
    k = k.reshape(b, t, cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"])
    return rope(k, positions, cfg.rope_theta), v.reshape(b, t, cfg.n_kv_heads, cfg.hd)


def whole(p: Params) -> Params:
    """An attention's weights as every "model" rank uses them whole: under
    placed parameters, blocks split over "model" gathered first; else ``p``."""
    if ctx.param_placements() is None:
        return p
    mesh = tp_mesh()
    return {n: spmd.model_whole(w, mesh) for n, w in p.items()}


def cache_slots(n_slots: int) -> Tuple[int, int]:
    """(this rank's first slot, its slots) of a K/V cache of ``n_slots``
    slots: a contiguous range where the cache is split by its sequence over
    "model" (``ctx.kv_split``), else all of them."""
    if ctx.kv_split() != "sequence":
        return 0, n_slots
    mesh = tp_mesh()
    n = n_slots // _tp_size()
    return spmd.model_rank(mesh) * n, n


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
    tensors in place.  Returns (out [B,1,D], cache_k, cache_v, scales).
    With n_valid == q_pos + 1 (full attention) the causal mask reduces to
    the validity mask, and for the SWA ring validity is the mask.

    Given a block of a cache split over "model" (``ctx.kv_split``), the
    cache's dims are this rank's and the slots global.  Split by its heads,
    the rank runs its q heads against its KV heads, then its rows of wo.
    Split by its sequence (slots [r n, (r + 1) n) of every KV head:
    context-parallel attention), every rank has q, k and v of every head
    (``_proj``) and only the rank whose slots hold ``write_pos`` writes;
    the softmax's max and exp-sum are reduced over "model", each rank
    normalises its own probabilities and casts them as the mesh-free path
    does (to bf16 in the int8 path, before the product with v), and the
    partial outputs are summed over "model" in fp32 and rounded once to
    the mesh-free output's dtype; then its rows of wo (``_out_proj``).

    Where ``ops`` sends the call to the card and the cache is bf16 (no scales)
    and not split by its sequence, the attention is the decode kernel
    (``ops.decode_attention``: the valid slots read in place, scores and sums in
    fp32); the einsums below are the plain path of every other call."""
    split, mesh = ctx.kv_split(), tp_mesh()
    seq = split == "sequence"
    b, n = x.shape[0], cache_k.shape[1]
    dev = x.device
    positions = torch.full((b, 1), q_pos, dtype=torch.int32, device=dev)
    q, k_new, v_new = _qkv(cfg, p, x, positions, pad_tp=split == "heads")
    lo = spmd.model_rank(mesh) * n if seq else 0
    if not seq or lo <= write_pos < lo + n:
        new = (k_new, v_new)
        if kv_scale is not None:
            (k_q, k_s), (v_q, v_s) = _quantize_kv(k_new), _quantize_kv(v_new)
            new = (k_q, v_q, k_s, v_s)
        for dst, src in zip((cache_k, cache_v, *(kv_scale or ())), new):
            _write_slot(dst, src, write_pos - lo)
    H, KV, hd = q.shape[2], cache_k.shape[2], cfg.hd
    if kv_scale is None and not seq and ops.takes_decode_attention(q, cache_k):
        out = ops.decode_attention(q, cache_k, cache_v, n_valid).reshape(b, 1, H * hd)
        return _out_proj(out, p["wo"], split == "heads"), cache_k, cache_v, kv_scale
    qg = q.reshape(b, 1, KV, H // KV, hd)
    if kv_scale is not None:
        # scales applied after the dot: (q.k_q)*s_k == q.(k_q*s_k) per (token, head)
        ks, vs = kv_scale
        s = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), cache_k.float())
        s = s * ks[..., 0].transpose(1, 2)[:, :, None, None, :].float()
        out_dt = torch.bfloat16
    else:
        out_dt = torch.promote_types(q.dtype, cache_k.dtype)
        s = torch.einsum("bqkgh,bskh->bkgqs", qg.to(out_dt), cache_k.to(out_dt)).float()
    k_valid = lo + torch.arange(n, dtype=torch.int32, device=dev) < n_valid
    s = (s / (hd ** 0.5)).masked_fill(~k_valid, -1e30)
    if seq:
        e = torch.exp(s - spmd.amax_model(s.amax(-1, keepdim=True), mesh))
        pr = e / spmd.reduce_model(e.sum(-1, keepdim=True), mesh)
    else:
        pr = torch.softmax(s, dim=-1)
    if kv_scale is not None:
        pv = (pr * vs[..., 0].transpose(1, 2)[:, :, None, None, :].float()).to(out_dt)
    else:
        pv = pr.to(q.dtype).to(out_dt)
    if seq:
        part = torch.einsum("bkgqs,bskh->bqkgh", pv.float(), cache_v.float())
        outh = spmd.reduce_model(part, mesh).to(out_dt)
    else:
        outh = torch.einsum("bkgqs,bskh->bqkgh", pv, cache_v.to(out_dt))
    out = outh.reshape(b, 1, H * hd)
    return _out_proj(out, p["wo"], split == "heads"), cache_k, cache_v, kv_scale


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


def _logits(head: Params, x: torch.Tensor) -> torch.Tensor:
    """The final norm and the head (``out``, or the tied ``tok``) over x."""
    x = rms_norm(x, head["ln_f"])
    if "out" in head:
        return _mm(x, head["out"])
    return _mm(x, head["tok"].t())


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x [B, T, d] -> logits [B, T, V_pad].  With the head split over "model"
    by the vocab (placed parameters), this rank's slice of the vocab,
    [B, T, V_pad / tp], as ``sharding.logits_sharding`` places the logits."""
    return _logits(gatherer("emb")({k: p[k] for k in ("ln_f", "out" if "out" in p else "tok")}),
                   x)


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
        return cross_entropy(_logits(head, h), labels, vocab)
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
