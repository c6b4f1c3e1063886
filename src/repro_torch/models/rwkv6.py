"""RWKV6 "Finch", the attention-free RNN LM (rwkv6-1.6b).

Mirrors ``repro.models.rwkv6``: data-dependent token shift (ddlerp with a
shared low-rank projection), data-dependent per-channel decay
w_t = exp(-exp(w0 + lora(x_t))), and the same parameter tree with layers
stacked on [L].  At T > 1 the WKV recurrence goes through ``ops.wkv6``, so
on the card it runs the hand-written WKV6 kernel, and in training its
backward kernel; a single decode step takes the per-step
``ref.rwkv6_naive``, as the reference does.  ``loss_fn`` checkpoints each
layer (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` of
its scanned block does.

State per layer: tmix shift [B,d], cmix shift [B,d] (both in the compute
dtype, as the reference returns them, whatever ``state_spec`` says) and
the fp32 wkv state [B,H,K,V].

Under a mesh with a "model" axis (a placed train step or serving call),
each layer runs split over it as the reference's rules place its weights
(``tmix``, ``cmix``), from each rank's blocks; the state is the rank's
block as ``sharding.cache_pspec`` places it, converted at each layer's
edge where the layer reads more of it (``_shift_edges``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..configs.base import ArchConfig
from ..kernels import ops, ref
from ..parallel import spmd
from . import layers
from .layers import Params, _dense_init, _mm, _normal

MAA_RANK = 32     # token-shift lora rank
DECAY_RANK = 64   # decay lora rank

State = Dict[str, torch.Tensor]


def init_layer(cfg: ArchConfig, gen: torch.Generator, dtype) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    hd = cfg.ssm_head_dim
    H = d // hd
    dev = gen.device

    def full(shape, value, dt=dtype):
        return torch.full(shape, value, dtype=dt, device=dev)

    return {
        "ln1": full((d,), 1.0),
        "tmix": {
            "maa_x": full((d,), 0.0),
            "maa_rkvwg": full((5, d), 0.0),
            "maa_w1": _dense_init(gen, d, 5 * MAA_RANK, dtype),
            "maa_w2": _normal(gen, (5, MAA_RANK, d), 0.02, dtype),
            "decay": full((d,), -4.0, torch.float32),       # w0
            "decay_w1": _dense_init(gen, d, DECAY_RANK, dtype),
            "decay_w2": _dense_init(gen, DECAY_RANK, d, dtype),
            "u": _normal(gen, (H, hd), 0.3, torch.float32),   # "time_faaaa" bonus
            "wr": _dense_init(gen, d, d, dtype),
            "wk": _dense_init(gen, d, d, dtype),
            "wv": _dense_init(gen, d, d, dtype),
            "wg": _dense_init(gen, d, d, dtype),
            "wo": _dense_init(gen, d, d, dtype),
            "ln_x": full((d,), 1.0),
        },
        "ln2": full((d,), 1.0),
        "cmix": {
            "maa_k": full((d,), 0.0),
            "maa_r": full((d,), 0.0),
            "wk": _dense_init(gen, d, f, dtype),
            "wv": _dense_init(gen, f, d, dtype),
            "wr": _dense_init(gen, d, d, dtype),
        },
    }


def init_params(cfg: ArchConfig, seed: int = 0, dtype=torch.bfloat16,
                device="cuda") -> Params:
    """Random parameters from a seeded ``torch.Generator`` on ``device``: the
    reference's tree and scales, other draws."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    return {"emb": layers.init_embeddings(cfg, gen, dtype),
            "layers": layers.init_stacked(cfg.n_layers,
                                          lambda: init_layer(cfg, gen, dtype))}


# ------------------------------------------------------------------ pieces

def _shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Token shift: x_{t-1} with ``prev`` filling t=0.  x [B,T,d], prev [B,d]."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _tmix_inputs(p: Params, x: torch.Tensor, x_prev: torch.Tensor):
    """Data-dependent lerp (ddlerp) producing the 5 mixed inputs r,k,v,w,g."""
    sx = _shift(x, x_prev) - x
    xxx = x + sx * p["maa_x"]
    m = torch.tanh(_mm(xxx, p["maa_w1"]))
    m = m.reshape(*m.shape[:2], 5, MAA_RANK)
    dt = torch.promote_types(m.dtype, p["maa_w2"].dtype)
    mm = torch.einsum("btfr,frd->fbtd", m.to(dt), p["maa_w2"].to(dt))
    return [x + sx * (p["maa_rkvwg"][i] + mm[i]) for i in range(5)]   # xr,xk,xv,xw,xg


def tmix(cfg: ArchConfig, p: Params, x: torch.Tensor, x_prev: torch.Tensor,
         wkv_state: torch.Tensor, chunk: int = 64):
    """The time mix over x [B,T,d], from the whole previous row ``x_prev``
    [B,d] and the wkv state -> (out [B,T,d], x's last row, wkv state).

    Under a mesh with a "model" axis that divides the heads, each rank runs
    its heads (``layers.model_share``): its columns of wr/wk/wv/wg and its
    channels of the decay, u and ln_x, and the wkv state [B, H/tp, K, V] of
    those heads; the ddlerp's and the decay's low-rank weights whole; the
    split ``ln_x`` norm (``layers.rms_norm_tp``); its rows of wo, summed
    over "model".  Where the heads do not divide it, every rank runs the
    whole mix on the weights gathered whole."""
    hd = cfg.ssm_head_dim
    H = cfg.d_model // hd
    b, t, _ = x.shape
    mesh, share = layers.tp_mesh(), layers.model_share(H)
    if share is None:
        p = layers.gathered_whole(p)
        nh, low = H, p

        def mine(name, dim, per=hd):
            return p[name]
    else:
        nh = share[1]
        x = spmd.enter_model(x, mesh)
        low = {n: spmd.model_whole(p[n], mesh)
               for n in ("maa_x", "maa_rkvwg", "maa_w1", "maa_w2", "decay_w1")}

        def mine(name, dim, per=hd):     # this rank's heads of a leaf
            return spmd.model_part(p[name], mesh, dim, nh * per)
    xr, xk, xv, xw, xg = _tmix_inputs(low, x, x_prev)
    r = _mm(xr, mine("wr", -1)).reshape(b, t, nh, hd).float()
    k = _mm(xk, mine("wk", -1)).reshape(b, t, nh, hd).float()
    v = _mm(xv, mine("wv", -1)).reshape(b, t, nh, hd).float()
    g = F.silu(_mm(xg, mine("wg", -1)))
    ww = mine("decay", 0) + _mm(torch.tanh(_mm(xw, low["decay_w1"])),
                                mine("decay_w2", -1)).float()
    w = torch.exp(-torch.exp(ww)).reshape(b, t, nh, hd)
    u = mine("u", 0, 1)
    if t == 1:
        y, new_state = ref.rwkv6_naive(r, k, v, w, u, wkv_state)
    else:
        y, new_state = ops.wkv6(r, k, v, w, u, wkv_state, chunk)
    y = y.reshape(b, t, nh * hd).to(x.dtype)
    # the shift states are copies: a view would keep the layer's whole input alive
    if share is None:
        y = layers.rms_norm(y, p["ln_x"]) * g
        return _mm(y, p["wo"]), x[:, -1, :].clone(), new_state
    y = layers.rms_norm_tp(y, mine("ln_x", 0)) * g
    return spmd.reduce_model(_mm(y, mine("wo", 0)), mesh), x[:, -1, :].clone(), new_state


def cmix(p: Params, x: torch.Tensor, x_prev: torch.Tensor):
    """The channel mix over x [B,T,d] from the whole previous row ``x_prev``
    -> (out [B,T,d], x's last row).

    Under a mesh with a "model" axis that divides d and d_ff, each rank
    runs its share: its columns of wk and rows of wv split the hidden dim,
    whose partial products are reduce-scattered onto the rank's d-block,
    where its columns of wr put the gate; the gated block is gathered to the
    whole residual.  Else every rank runs it whole."""
    mesh, tp = layers.tp_mesh(), layers._tp_size()
    if mesh is not None:
        f, d = spmd.whole_size(p["wk"], 1, mesh), spmd.whole_size(p["wr"], 1, mesh)
        if f % tp or d % tp:
            p, mesh = layers.gathered_whole(p), None
    if mesh is None:
        sx = _shift(x, x_prev) - x
        xk = x + sx * p["maa_k"]
        xr = x + sx * p["maa_r"]
        k = torch.square(F.relu(_mm(xk, p["wk"])))
        return torch.sigmoid(_mm(xr, p["wr"])) * _mm(k, p["wv"]), x[:, -1, :].clone()
    x = spmd.enter_model(x, mesh)
    sx = _shift(x, x_prev) - x
    xk = x + sx * spmd.model_whole(p["maa_k"], mesh)
    xr = x + sx * spmd.model_whole(p["maa_r"], mesh)
    k = torch.square(F.relu(_mm(xk, spmd.model_part(p["wk"], mesh, 1, f // tp))))
    gate = torch.sigmoid(_mm(xr, spmd.model_part(p["wr"], mesh, 1, d // tp)))
    kv = spmd.reduce_scatter_model(_mm(k, spmd.model_part(p["wv"], mesh, 0, f // tp)), mesh)
    return spmd.all_gather_model(gate * kv, mesh), x[:, -1, :].clone()


# ------------------------------------------------------------------ model

def state_spec(cfg: ArchConfig, batch: int):
    d = cfg.d_model
    hd = cfg.ssm_head_dim
    H = d // hd
    L = cfg.n_layers
    return {
        "tmix_x": ((L, batch, d), torch.bfloat16),
        "cmix_x": ((L, batch, d), torch.bfloat16),
        "wkv": ((L, batch, H, hd, hd), torch.float32),
    }


def zero_state(cfg: ArchConfig, batch: int, device="cpu") -> State:
    """The zero state; under a mesh, this rank's block of it (over "model"
    as ``sharding.cache_pspec`` splits it; ``batch``: the rank's rows)."""
    return {k: torch.zeros(layers.state_block(cfg, k, shape), dtype=dt, device=device)
            for k, (shape, dt) in state_spec(cfg, batch).items()}


def _block(cfg: ArchConfig, lp: Params, h: torch.Tensor, tx: torch.Tensor,
           cx: torch.Tensor, wkv: torch.Tensor):
    """One layer: h [B,T,d] and its state in -> (h, tmix shift, cmix shift, wkv state)."""
    att, tx2, wkv2 = tmix(cfg, lp["tmix"], layers.rms_norm(h, lp["ln1"]), tx.to(h.dtype), wkv)
    h = h + att
    ffn, cx2 = cmix(lp["cmix"], layers.rms_norm(h, lp["ln2"]), cx.to(h.dtype))
    return h + ffn, tx2, cx2, wkv2


def _shift_edges(cfg: ArchConfig, b: int):
    """(in, out) of a layer's shift state: the state as the placed state holds
    it -> the whole previous row the ddlerp reads, and the layer's last row
    -> what the state keeps: under a mesh on which ``sharding.cache_pspec``
    splits tmix_x/cmix_x [L, B, d] over "model", this rank's block of d,
    gathered on entry; else the identity."""
    if layers.state_model_dim(cfg, "tmix_x", state_spec(cfg, b)["tmix_x"][0]) is None:
        return (lambda x: x), (lambda x: x)
    mesh = layers.tp_mesh()
    n = cfg.d_model // layers._tp_size()
    lo = spmd.model_rank(mesh) * n
    return (lambda x: spmd.all_gather_model(x, mesh)), (lambda x: x.narrow(-1, lo, n))


def _backbone(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
              state: State = None) -> Tuple[torch.Tensor, State]:
    """tokens [B,T] -> (final hidden [B,T,d], new state).  Under placed
    parameters (a placed serving call) each layer gathers its blocks as the
    loss's do, and the state is this rank's block of it as
    ``sharding.cache_pspec`` places it: its rows, and over "model" the wkv
    state's heads and the shift states' d (``_shift_edges``)."""
    b, _ = tokens.shape
    if state is None:
        state = zero_state(cfg, b, tokens.device)
    h = layers.embed(params["emb"], tokens)
    gather = layers.gatherer("layers", stacked=True)
    shift_in, shift_out = _shift_edges(cfg, b)
    tx, cx, wkv = [], [], []
    for i, lp in enumerate(layers.unstack(params["layers"])):
        h, tx2, cx2, wkv2 = _block(cfg, gather(lp), h, shift_in(state["tmix_x"][i]),
                                   shift_in(state["cmix_x"][i]), state["wkv"][i])
        tx.append(shift_out(tx2))
        cx.append(shift_out(cx2))
        wkv.append(wkv2)
    return h, {"tmix_x": torch.stack(tx), "cmix_x": torch.stack(cx),
               "wkv": torch.stack(wkv)}


def forward(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
            state: State = None) -> Tuple[torch.Tensor, State]:
    """tokens [B,T] -> (logits [B,T,V], new state)."""
    h, new_state = _backbone(cfg, params, tokens, state)
    return layers.unembed(params["emb"], h), new_state


def loss_fn(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]``, from the zero state.  Differentiable in every parameter
    leaf; each layer keeps only its input for the backward and runs again
    inside it.  Under placed parameters each layer gathers its blocks over
    the data axes inside, and runs split over "model" as ``tmix`` and
    ``cmix`` say; the embedding and head are vocab-parallel
    (``layers.embed``, ``layers.lm_loss``)."""
    tokens = batch["tokens"]
    b = tokens.shape[0]
    h = layers.embed(params["emb"], tokens)
    H = cfg.d_model // cfg.ssm_head_dim
    share = layers.model_share(H)
    shift = h.new_zeros((b, cfg.d_model))
    wkv = torch.zeros((b, H if share is None else share[1], cfg.ssm_head_dim,
                       cfg.ssm_head_dim), dtype=torch.float32, device=tokens.device)

    gather = layers.gatherer("layers", stacked=True)

    def block(h, lp):
        return _block(cfg, gather(lp), h, shift, shift, wkv)[0]

    for lp in layers.unstack(params["layers"]):
        h = checkpoint(block, h, lp, use_reentrant=False)
    return layers.lm_loss(params["emb"], h, batch["labels"], cfg.vocab)


def prefill(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
            smax: int = 0, kv_dtype_name: str = "bfloat16"):
    """The prompt from a zero state -> (last-token logits [B,1,V], state).
    ``smax`` and ``kv_dtype_name`` are taken and ignored, as in the reference:
    the state does not grow with the sequence."""
    h, state = _backbone(cfg, params, tokens)
    return layers.unembed(params["emb"], h[:, -1:]), state


def decode_step(cfg: ArchConfig, params: Params, token: torch.Tensor,
                state: State, cache_len=None):
    """One token [B,1] through the per-step recurrence -> (logits [B,1,V], state)."""
    return forward(cfg, params, token, state)
