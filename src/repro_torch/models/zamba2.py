"""zamba2-7b: a Mamba2 backbone and ONE shared attention/MLP block.

Mirrors ``repro.models.zamba2``: 81 Mamba2 mixer layers (stacked on [L]);
after every ``attn_every`` (6) of them the shared transformer block (one
set of weights, 13 call sites) runs.  A Mamba2 layer: in_proj ->
[z | x | B | C | dt], a short causal conv over (x, B, C) carrying its K-1
tail, the SSD scan, gated RMSNorm, out_proj.

At T > 1 the SSD scan goes through ``ops.mamba2_ssd`` and the shared
block's attention through ``ops.flash_attention``, so on the card both run
hand-written kernels, forward and, in training, backward (the reference
calls ``ref.mamba2_ssd`` and ``ref.flash_attention`` directly); a single
decode step takes the per-step ``ref.mamba2_naive`` and
``layers.attention_decode``, as the reference does.  ``loss_fn``
checkpoints each mamba layer and each shared-block site, as the
reference's ``jax.checkpoint`` does, and keeps no K/V cache.

State: per mamba layer the conv tail [B, din+2N, K-1] (in the compute
dtype, as the reference returns it) and the fp32 SSD state [B,H,P,N]; per
call site of the shared block a K/V cache [B, smax, KV, hd], written in
place by decode.

Under a mesh with a "model" axis (a placed train step or serving call),
each Mamba2 layer runs on the rank's heads (``mamba_layer``) and the
shared block as the transformer's layers do, from each rank's blocks; the
state is the rank's block as ``sharding.cache_pspec`` places it (the conv
tail converted at each layer's edge, ``_conv_edges``; the K/V as
``ctx.kv_split`` says, written by ``transformer.PromptKV``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import obs, resolve_device
from ..configs.base import ArchConfig
from ..kernels import ops, ref
from ..parallel import ctx, spmd
from ..serve import graphs
from . import layers, transformer
from .layers import Params, _dense_init, _mm, _normal

CONV_K = 4  # mamba short-conv width

State = Dict[str, torch.Tensor]


def _din(cfg: ArchConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def init_mamba_layer(cfg: ArchConfig, gen: torch.Generator, dtype) -> Params:
    d = cfg.d_model
    din = _din(cfg)
    N = cfg.ssm_state
    H = din // cfg.ssm_head_dim
    dev = gen.device

    def full(shape, value, dt=dtype):
        return torch.full(shape, value, dtype=dt, device=dev)

    return {
        "ln": full((d,), 1.0),
        "in_z": _dense_init(gen, d, din, dtype),
        "in_x": _dense_init(gen, d, din, dtype),
        "in_B": _dense_init(gen, d, N, dtype),
        "in_C": _dense_init(gen, d, N, dtype),
        "in_dt": _dense_init(gen, d, H, dtype),
        "conv_w": _normal(gen, (CONV_K, din), 0.2, dtype),
        "conv_b": full((din,), 0.0),
        "conv_Bw": _normal(gen, (CONV_K, N), 0.2, dtype),
        "conv_Cw": _normal(gen, (CONV_K, N), 0.2, dtype),
        "A_log": full((H,), 0.0, torch.float32),          # A = -exp(A_log)
        "D": full((H,), 1.0, torch.float32),
        "dt_bias": full((H,), -2.0, torch.float32),
        "norm": full((din,), 1.0),
        "out_proj": _dense_init(gen, din, d, dtype),
    }


def init_params(cfg: ArchConfig, seed: int = 0, dtype=torch.bfloat16,
                device="cuda") -> Params:
    """Random parameters from a seeded ``torch.Generator`` on ``device``: the
    reference's tree and scales, other draws."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    return {
        "emb": layers.init_embeddings(cfg, gen, dtype),
        "mamba": layers.init_stacked(cfg.n_layers,
                                     lambda: init_mamba_layer(cfg, gen, dtype)),
        "shared": layers.init_block(cfg, gen, dtype),     # THE shared block
    }


# ------------------------------------------------------------------ mamba2

def mamba_layer(cfg: ArchConfig, p: Params, h: torch.Tensor,
                conv_state: torch.Tensor, ssd_state: torch.Tensor):
    """h [B,T,d]; conv_state [B, din+2N, K-1]; ssd_state [B,H,P,N].

    Under a mesh with a "model" axis that divides the heads, each rank runs
    its heads (``layers.model_share``): its columns of in_z and in_x, its
    channels of the conv and the norm, and its heads of dt, A and D, with B
    and C whole (one group); conv_state is then the tail of its n
    x-channels and of B and C [B, n + 2N, K-1] (``_conv_edges`` converts
    the placed state), ssd_state its heads' [B, H/tp, P, N]; the split norm
    (``layers.rms_norm_tp``) and its rows of out_proj, summed over "model".
    Where the heads do not divide it, every rank runs the whole layer on
    the weights gathered whole."""
    b, t, _ = h.shape
    din = _din(cfg)
    N = cfg.ssm_state
    P = cfg.ssm_head_dim
    H = din // P
    mesh, share = layers.tp_mesh(), layers.model_share(H)
    x_in = layers.rms_norm(h, p["ln"])
    if share is None:
        p = layers.gathered_whole(p)
        nh = H

        def mine(name, dim, per=1):
            return p[name]

        def whole(name):
            return p[name]
    else:
        nh = share[1]
        x_in = spmd.enter_model(x_in, mesh)

        def mine(name, dim, per=1):     # this rank's heads (or channels) of a leaf
            return spmd.model_part(p[name], mesh, dim, nh * per)

        def whole(name):
            return spmd.model_whole(p[name], mesh)
    n = nh * P
    z = _mm(x_in, mine("in_z", -1, P))
    xbc = torch.cat([_mm(x_in, mine("in_x", -1, P)), _mm(x_in, whole("in_B")),
                     _mm(x_in, whole("in_C"))], dim=-1)
    dt = _mm(x_in, mine("in_dt", -1))

    # short causal convs on x / B / C, carrying the K-1 tail as state
    xbc_pad = torch.cat([conv_state.transpose(1, 2).to(xbc.dtype), xbc], dim=1)
    # a copy: a view would keep the whole [B, T+K-1, din+2N] input alive with the state
    new_conv_state = xbc_pad[:, -(CONV_K - 1):].transpose(1, 2).clone()
    conv_b = mine("conv_b", 0, P)
    w_cat = torch.cat([mine("conv_w", -1, P), whole("conv_Bw"), whole("conv_Cw")], dim=1)
    b_cat = torch.cat([conv_b, conv_b.new_zeros(2 * N)])
    conv = sum(xbc_pad[:, i:i + t] * w_cat[i] for i in range(CONV_K)) + b_cat
    x, B, C = torch.split(F.silu(conv), [n, N, N], dim=-1)

    dt = F.softplus(dt.float() + mine("dt_bias", 0))      # [B,T,H]
    A = -torch.exp(mine("A_log", 0))
    xh = x.reshape(b, t, nh, P).float().contiguous()
    B, C = B.float().contiguous(), C.float().contiguous()
    if t == 1:
        y, new_ssd = ref.mamba2_naive(xh, dt, A, B, C, ssd_state)
    else:
        y, new_ssd = ops.mamba2_ssd(xh, dt, A, B, C, ssd_state, chunk=128)
    y = y + mine("D", 0)[None, None, :, None] * xh
    y = y.reshape(b, t, n).to(h.dtype)
    if share is None:
        y = layers.rms_norm(y, p["norm"]) * F.silu(z)
        return _mm(y, p["out_proj"]), new_conv_state, new_ssd
    y = layers.rms_norm_tp(y, mine("norm", 0, P)) * F.silu(z)
    return spmd.reduce_model(_mm(y, mine("out_proj", 0, P)), mesh), new_conv_state, new_ssd


def _conv_edges(cfg: ArchConfig, b: int):
    """(in, out) of a layer's conv tail: the tail as the placed state holds it
    [B, C, K-1] -> the channels ``mamba_layer`` computes, and its new tail ->
    what the state keeps.  ``sharding.cache_pspec`` splits the C = din + 2N
    channels x | B | C evenly over "model" where they divide it, so rank r
    holds [r C/tp, (r + 1) C/tp), while it computes x-channels
    [r din/tp, (r + 1) din/tp) and all of B and C: on entry the blocks are
    gathered and the rank's channels taken, on exit the ranks' x-channels
    gathered beside B and C and the rank's block kept.  The identity
    without a "model" axis."""
    mesh = layers.tp_mesh()
    if mesh is None:
        return (lambda x: x), (lambda x: x)
    din, tp = _din(cfg), layers._tp_size()
    split = layers.state_model_dim(cfg, "conv", conv_state_spec(cfg, b)) is not None
    share = layers.model_share(din // cfg.ssm_head_dim)
    n = din // tp
    lo = spmd.model_rank(mesh) * n
    blk = (din + 2 * cfg.ssm_state) // tp

    def conv_in(x):
        if split:
            x = spmd.all_gather_model(x, mesh, 1)
        return x if share is None else torch.cat([x[:, lo:lo + n], x[:, din:]], 1)

    def conv_out(x):
        if share is not None:
            x = torch.cat([spmd.all_gather_model(x[:, :n], mesh, 1), x[:, n:]], 1)
        return x.narrow(1, spmd.model_rank(mesh) * blk, blk) if split else x

    return conv_in, conv_out


def conv_state_spec(cfg: ArchConfig, batch: int):
    return (cfg.n_layers, batch, _din(cfg) + 2 * cfg.ssm_state, CONV_K - 1)


def ssd_state_spec(cfg: ArchConfig, batch: int):
    H = _din(cfg) // cfg.ssm_head_dim
    return (cfg.n_layers, batch, H, cfg.ssm_head_dim, cfg.ssm_state)


def n_attn_sites(cfg: ArchConfig) -> int:
    return cfg.n_layers // cfg.attn_every


def state_spec(cfg: ArchConfig, batch: int, smax: int, kv_dtype_name: str = "bfloat16"):
    sites = n_attn_sites(cfg)
    kvh, hd = cfg.n_kv_heads, cfg.hd
    return {
        "conv": (conv_state_spec(cfg, batch), torch.bfloat16),
        "ssd": (ssd_state_spec(cfg, batch), torch.float32),
        "k": ((sites, batch, smax, kvh, hd), torch.bfloat16),
        "v": ((sites, batch, smax, kvh, hd), torch.bfloat16),
    }


def zero_state(cfg: ArchConfig, batch: int, smax: int,
               kv_dtype_name: str = "bfloat16", device="cpu") -> State:
    return {k: torch.zeros(s, dtype=dt, device=device)
            for k, (s, dt) in state_spec(cfg, batch, smax, kv_dtype_name).items()}


# ------------------------------------------------------------------ assembly

def _shared_block(cfg: ArchConfig, sp: Params, h: torch.Tensor,
                  positions: torch.Tensor):
    """The shared attention + MLP block over h; returns (h, k, v).  Under a
    mesh it runs as the transformer's layers do: the attention on each
    rank's heads, padded to a multiple of "model" (k and v are then its
    heads), and the MLP's hidden dim split."""
    attn, k, v = transformer._attn_full(cfg, sp, h, positions, pad_tp=True)
    h = h + attn
    return h + layers.swiglu_tp(sp["mlp"], layers.rms_norm(h, sp["ln2"])), k, v


def _zero_ssm_state(cfg: ArchConfig, b: int, device) -> State:
    """The zero conv tail and SSD state; under a mesh, this rank's block of
    each, as ``sharding.cache_pspec`` splits it over "model"."""
    return {"conv": torch.zeros(layers.state_block(cfg, "conv", conv_state_spec(cfg, b)),
                                dtype=torch.bfloat16, device=device),
            "ssd": torch.zeros(layers.state_block(cfg, "ssd", ssd_state_spec(cfg, b)),
                               dtype=torch.float32, device=device)}


def _backbone(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
              state: Optional[State] = None, smax: int = 0):
    """tokens [B,T] -> (final hidden [B,T,d], new state).  The per-site K/V
    come back in a cache of ``smax`` slots (``T`` if 0), zero past T.  Under
    placed parameters (a placed serving call) each mamba layer gathers its
    blocks as the loss's do, the shared block is gathered once, and the
    state is this rank's block as ``sharding.cache_pspec`` places it: its
    rows, and over "model" the conv tail's channels (``_conv_edges``), the
    SSD state's heads and the K/V's heads or slots (``ctx.kv_split``,
    written as the transformer's prefill writes them)."""
    b, t = tokens.shape
    period = cfg.attn_every
    smax = smax or t
    if t > smax:
        raise ValueError(f"prompt of {t} tokens does not fit a cache of {smax}")
    if state is None:
        state = _zero_ssm_state(cfg, b, tokens.device)
    positions = transformer._positions(b, t, tokens.device)
    h = layers.embed(params["emb"], tokens)
    kvw = transformer.PromptKV(cfg, b, t, smax, tokens.device)
    kv_shape = (n_attn_sites(cfg), b, kvw.n_slots, kvw.kv_heads, cfg.hd)
    cache_k = cache_v = None
    gather = layers.gatherer("mamba", stacked=True)
    sp = layers.gatherer("shared")(params["shared"])
    conv_in, conv_out = _conv_edges(cfg, b)
    convs, ssds = [], []
    for i, lp in enumerate(layers.unstack(params["mamba"])):
        out, cs, ss = mamba_layer(cfg, gather(lp), h, conv_in(state["conv"][i]),
                                  state["ssd"][i])
        h = h + out
        convs.append(conv_out(cs))
        ssds.append(ss)
        site, last_of_period = divmod(i + 1, period)
        if last_of_period == 0:
            own = kvw.own(sp, h)
            h, k, v = _shared_block(cfg, sp, h, positions)
            if cache_k is None:     # the K/V dtype is the compute dtype, as in the reference
                cache_k = k.new_zeros(kv_shape)
                cache_v = v.new_zeros(kv_shape)
            kvw.write(cache_k[site - 1], cache_v[site - 1], own, k, v)
    return h, {"conv": torch.stack(convs), "ssd": torch.stack(ssds),
               "k": cache_k, "v": cache_v}


def forward(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
            state: Optional[State] = None) -> Tuple[torch.Tensor, State]:
    """tokens [B,T] -> (logits [B,T,V], new state)."""
    h, new_state = _backbone(cfg, params, tokens, state)
    return layers.unembed(params["emb"], h), new_state


def loss_fn(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]``, from the zero state.  Differentiable in every parameter
    leaf; each mamba layer and each shared-block site keeps only its input for
    the backward and runs again inside it.  No K/V cache is written.  Under
    placed parameters each of them gathers its blocks over the data axes
    inside (the shared block at each of its sites) and runs split over
    "model" (``mamba_layer``, ``_shared_block``); the embedding and head are
    vocab-parallel."""
    tokens = batch["tokens"]
    b, t = tokens.shape
    positions = transformer._positions(b, t, tokens.device)
    h = layers.embed(params["emb"], tokens)
    P = cfg.ssm_head_dim
    share = layers.model_share(_din(cfg) // P)
    H = _din(cfg) // P if share is None else share[1]     # the heads this rank runs
    conv = h.new_zeros((b, H * P + 2 * cfg.ssm_state, CONV_K - 1))
    ssd = torch.zeros((b, H, P, cfg.ssm_state), dtype=torch.float32, device=tokens.device)

    gather_mamba = layers.gatherer("mamba", stacked=True)
    gather_shared = layers.gatherer("shared")

    def mamba_block(h, lp):
        return h + mamba_layer(cfg, gather_mamba(lp), h, conv, ssd)[0]

    def shared_block(h, sp):
        return _shared_block(cfg, gather_shared(sp), h, positions)[0]

    for i, lp in enumerate(layers.unstack(params["mamba"])):
        h = checkpoint(mamba_block, h, lp, use_reentrant=False)
        if (i + 1) % cfg.attn_every == 0:
            h = checkpoint(shared_block, h, params["shared"], use_reentrant=False)
    return layers.lm_loss(params["emb"], h, batch["labels"], cfg.vocab)


def prefill(cfg: ArchConfig, params: Params, tokens: torch.Tensor, smax: int,
            kv_dtype_name: str = "bfloat16") -> Tuple[torch.Tensor, State]:
    """The prompt from a zero state -> (last-token logits [B,1,V], state), the
    per-site K/V padded to ``smax`` slots so decode can append; raises if the
    prompt does not fit."""
    h, state = _backbone(cfg, params, tokens, smax=smax)
    return layers.unembed(params["emb"], h[:, -1:]), state


def decode_step(cfg: ArchConfig, params: Params, token: torch.Tensor,
                state: State, cache_len: int) -> Tuple[torch.Tensor, State]:
    """One token [B,1] through 81 mamba steps and 13 shared-attention decode
    sites.  The new token's k/v are written into ``state``'s cache in place.
    Returns (logits [B,1,V], state).  Under placed parameters, gathered and
    split as ``_backbone`` does; the decode attention runs on the rank's
    block of the K/V (``layers.attention_decode``)."""
    period = cfg.attn_every
    h = layers.embed(params["emb"], token)
    gather = layers.gatherer("mamba", stacked=True)
    sp = layers.gatherer("shared")(params["shared"])
    conv_in, conv_out = _conv_edges(cfg, token.shape[0])
    convs, ssds = [], []
    for i, lp in enumerate(layers.unstack(params["mamba"])):
        out, cs, ss = mamba_layer(cfg, gather(lp), h, conv_in(state["conv"][i]),
                                  state["ssd"][i])
        h = h + out
        convs.append(conv_out(cs))
        ssds.append(ss)
        site, last_of_period = divmod(i + 1, period)
        if last_of_period == 0:
            out, _, _, _ = layers.attention_decode(
                cfg, sp["attn"], layers.rms_norm(h, sp["ln1"]), state["k"][site - 1],
                state["v"][site - 1], cache_len, cache_len, cache_len + 1)
            h = h + out
            h = h + layers.swiglu_tp(sp["mlp"], layers.rms_norm(h, sp["ln2"]))
    return layers.unembed(params["emb"], h), {
        "conv": torch.stack(convs), "ssd": torch.stack(ssds),
        "k": state["k"], "v": state["v"]}


# ------------------------------------------------ the published Zamba2 hybrid layer
#
# Zyphra's Zamba2-7B (``configs/zamba2_7b_instruct.py``), beside the twin above:
# with e the embedding output, kept for the whole pass, layer i is
#   h = h + Mamba_i(RMS_i(h + T_j))   at site j (layer hybrid_layer_ids[j]),
#   h = h + Mamba_i(RMS_i(h))         elsewhere,
# where T_j = Linear_j(S_{j % n}(h, e)) and the shared block S is
#   u = RMS([h | e]); a = attn(u) W_o (heads over the 2d-wide u, RoPE on every dim,
#   the config's softmax scale); m = RMS(a);
#   g | p = m W_gu + (m A_j) B_j (the site's adapter); S = (act(g) * p) W_down,
# with no residual inside it.  Mamba2 takes in_proj -> z | x | B | C | dt (B and C
# in G groups), a causal conv with bias over x | B | C then SiLU, dt = softplus(dt +
# dt_bias), the SSD scan (head h reading group h // (H/G)) plus D x, then the gated
# norm: y * silu(z) in fp32, RMS over each of the G groups of channels, and out_proj.
# Serving only: no loss, no mesh.  Each site's block runs in a ``zamba2.shared``
# span and each run of consecutive Mamba2 layers in a ``zamba2.mamba`` span; the
# parts between a decode step's attentions are ``serve.graphs`` segments.
# ``models.get_model`` takes these functions for a config that ``published`` names.

def published(cfg: ArchConfig) -> bool:
    """Whether ``cfg`` is the published hybrid (it names its hybrid layers)."""
    return bool(cfg.hybrid_layer_ids)


def site_layers(cfg: ArchConfig) -> Tuple[int, ...]:
    """The layers that run a shared block first: the config's, below its depth."""
    return tuple(i for i in cfg.hybrid_layer_ids if i < cfg.n_layers)


def _pub_widths(cfg: ArchConfig):
    """(din, G * N, heads) of a published Mamba2 layer."""
    din = _din(cfg)
    return din, cfg.ssm_groups * cfg.ssm_state, din // cfg.ssm_head_dim


def _refuse_unsupported(what: str) -> None:
    if layers.tp_mesh() is not None or ctx.param_placements() is not None:
        raise NotImplementedError(f"the published Zamba2 hybrid has no mesh path ({what})")


def init_pub_mamba_layer(cfg: ArchConfig, gen: torch.Generator, dtype) -> Params:
    d = cfg.d_model
    din, gn, nh = _pub_widths(cfg)
    dev = gen.device
    # dt log-uniform in [1e-3, 0.1], floored at 1e-4, and dt_bias its softplus inverse
    u = torch.rand(nh, generator=gen, device=dev, dtype=torch.float32)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3)).clamp(min=1e-4)
    return {
        "ln": torch.ones(d, dtype=dtype, device=dev),
        "in_proj": _dense_init(gen, d, 2 * din + 2 * gn + nh, dtype),   # z | x | B | C | dt
        "conv_w": _normal(gen, (CONV_K, din + 2 * gn), 0.2, dtype),
        "conv_b": _normal(gen, (din + 2 * gn,), 0.02, dtype),
        "A_log": torch.log(torch.arange(1, nh + 1, dtype=torch.float32, device=dev)),
        "D": torch.ones(nh, dtype=torch.float32, device=dev),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "norm": torch.ones(din, dtype=dtype, device=dev),
        "out_proj": _dense_init(gen, din, d, dtype),
    }


def init_pub_shared(cfg: ArchConfig, gen: torch.Generator, dtype) -> Params:
    d, f, hq = cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.hd
    dev = gen.device
    d_in = 2 * d if cfg.attn_concat_embed else d
    return {
        "ln1": torch.ones(d_in, dtype=dtype, device=dev),
        "wqkv": _dense_init(gen, d_in, hq + 2 * cfg.n_kv_heads * cfg.hd, dtype),   # q | k | v
        "wo": _dense_init(gen, hq, d, dtype),
        "ln2": torch.ones(d, dtype=dtype, device=dev),
        "w_gu": _dense_init(gen, d, 2 * f, dtype),                                # g | p
        "w_down": _dense_init(gen, f, d, dtype),
    }


def init_pub_site(cfg: ArchConfig, gen: torch.Generator, dtype) -> Params:
    d, r = cfg.d_model, cfg.adapter_rank
    return {"lin": _dense_init(gen, d, d, dtype),
            "ad_a": _dense_init(gen, d, r, dtype),
            "ad_b": _dense_init(gen, r, 2 * cfg.d_ff, dtype)}


def init_pub_params(cfg: ArchConfig, seed: int = 0, dtype=torch.bfloat16,
                    device="cuda") -> Params:
    """Random parameters from a seeded ``torch.Generator`` on ``device``: the
    published hybrid's tree (``perfbench/reference/hybrid_layout.py`` lays it out)."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    return {
        "emb": layers.init_embeddings(cfg, gen, dtype),
        "mamba": layers.init_stacked(cfg.n_layers, lambda: init_pub_mamba_layer(cfg, gen, dtype)),
        "shared": layers.init_stacked(cfg.shared_blocks, lambda: init_pub_shared(cfg, gen, dtype)),
        "sites": layers.init_stacked(len(site_layers(cfg)),
                                     lambda: init_pub_site(cfg, gen, dtype)),
    }


def pub_state_spec(cfg: ArchConfig, batch: int, smax: int):
    din, gn, nh = _pub_widths(cfg)
    kv = (len(site_layers(cfg)), batch, smax, cfg.n_kv_heads, cfg.hd)
    return {
        "conv": ((cfg.n_layers, batch, din + 2 * gn, CONV_K - 1), torch.bfloat16),
        "ssd": ((cfg.n_layers, batch, nh, cfg.ssm_head_dim, cfg.ssm_state), torch.float32),
        "k": (kv, torch.bfloat16),
        "v": (kv, torch.bfloat16),
    }


def pub_mamba_layer(cfg: ArchConfig, p: Params, x: torch.Tensor, A: torch.Tensor,
                    conv_state: torch.Tensor, ssd_state: torch.Tensor) -> torch.Tensor:
    """x [B,T,d], the layer's input -> its output [B,T,d]; A = -exp(A_log) [H].
    ``conv_state`` [B, din+2GN, K-1] and ``ssd_state`` [B,H,P,N] fp32 are read and
    overwritten with the new ones.  T > 1 runs the chunked scan (``ops.mamba2_ssd``);
    one token everything after in_proj as one step (``ops.mamba2_step``), in place."""
    b, t, d = x.shape
    din, gn, nh = _pub_widths(cfg)
    G, N, P = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
    u = _mm(F.rms_norm(x, (d,), p["ln"], cfg.rms_eps), p["in_proj"])
    if t == 1:
        y = ops.mamba2_step(u[:, 0], conv_state, p["conv_w"], p["conv_b"], p["dt_bias"], A,
                            p["D"], ssd_state, p["norm"], G, cfg.rms_eps)
        return _mm(y[:, None], p["out_proj"])
    z, xbc, dt = torch.split(u, [din, din + 2 * gn, nh], dim=-1)
    xbc_pad = torch.cat([conv_state.to(xbc.dtype), xbc.transpose(1, 2)], dim=2)
    conv_state.copy_(xbc_pad[:, :, -(CONV_K - 1):])
    conv = F.conv1d(xbc_pad, p["conv_w"].t().unsqueeze(1), p["conv_b"], groups=din + 2 * gn)
    xs, B, C = torch.split(F.silu(conv.transpose(1, 2)), [din, gn, gn], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])                        # [B,T,H]
    xh = xs.reshape(b, t, nh, P).float()
    B, C = (v.float().reshape(b, t, G, N).contiguous() for v in (B, C))
    y, s_new = ops.mamba2_ssd(xh.contiguous(), dt, A, B, C, ssd_state, chunk=128)
    ssd_state.copy_(s_new)
    y = (y + p["D"][:, None] * xh).reshape(b, t, G, din // G) \
        * F.silu(z.float()).reshape(b, t, G, din // G)
    y = F.rms_norm(y, (din // G,), eps=cfg.rms_eps).reshape(b, t, din)
    return _mm(y.to(x.dtype) * p["norm"], p["out_proj"])


def _site_pre(cfg: ArchConfig, sp: Params, h: torch.Tensor, e: torch.Tensor):
    """A site's attention inputs before RoPE: q [B,T,H,hd], k, v [B,T,KV,hd] from
    block ``sp`` over h and the embeddings e [B,T,d]."""
    b, t, _ = h.shape
    hq, hk = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    u = torch.cat([h, e], dim=-1) if cfg.attn_concat_embed else h
    q, k, v = torch.split(_mm(F.rms_norm(u, (u.shape[-1],), sp["ln1"], cfg.rms_eps),
                              sp["wqkv"]), [hq, hk, hk], dim=-1)
    return (q.reshape(b, t, cfg.n_heads, cfg.hd), k.reshape(b, t, cfg.n_kv_heads, cfg.hd),
            v.reshape(b, t, cfg.n_kv_heads, cfg.hd))


def _site_post(cfg: ArchConfig, sp: Params, st: Params, h: torch.Tensor,
               o: torch.Tensor) -> torch.Tensor:
    """h + T_j: the rest of block ``sp`` after its attention's output o [B,T,H*hd]
    (W_o, the norm, the GeGLU MLP with the site's own adapter ``st``) and the site's
    linear."""
    m = F.rms_norm(_mm(o, sp["wo"]), (h.shape[-1],), sp["ln2"], cfg.rms_eps)
    gu = _mm(m, sp["w_gu"])
    gu += _mm(_mm(m, st["ad_a"]), st["ad_b"])
    g, up = gu.chunk(2, dim=-1)
    act = F.gelu(g) if cfg.mlp_act == "gelu" else F.silu(g)
    return h + _mm(_mm(act * up, sp["w_down"]), st["lin"])


def _pub_layers(cfg: ArchConfig, params: Params, e: torch.Tensor, state: State,
               attend) -> torch.Tensor:
    """Every layer over the embeddings e, the state updated in place;
    ``attend(j, q, k, v)`` -> [B,T,H*hd] is site j's attention.  Each run of Mamba2
    layers, and each site's parts before and after its attention, is a segment
    (``serve.graphs``): a graph where the server captures a decode step's segments."""
    sites = site_layers(cfg)
    mamba = layers.unstack(params["mamba"])
    shared = layers.unstack(params["shared"])
    own = layers.unstack(params["sites"])

    def run(lo, hi, h, x):
        for i in range(lo, hi):
            lp = mamba[i]
            h = h + pub_mamba_layer(cfg, lp, x, -torch.exp(lp["A_log"]), state["conv"][i],
                                    state["ssd"][i])
            x = h
        return h

    h = e
    bounds = (0, *sites, cfg.n_layers)
    for r, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
        x = h
        if r > 0:           # the run starts at site r - 1
            j = r - 1
            sp, st = shared[j % cfg.shared_blocks], own[j]
            with obs.span("zamba2.shared"):
                q, k, v = graphs.segment(("pre", j),
                                         lambda hh, ee, sp=sp: _site_pre(cfg, sp, hh, ee), h, e)
                o = attend(j, q, k, v)
                x = graphs.segment(("post", j),
                                   lambda hh, oo, sp=sp, st=st: _site_post(cfg, sp, st, hh, oo),
                                   h, o)
        if hi == lo:
            h = x
            continue
        with obs.span("zamba2.mamba"):
            h = graphs.segment(("run", r),
                               lambda hh, xx, lo=lo, hi=hi: run(lo, hi, hh, xx), h, x)
    return h


def _rope_tables(position: int, half: int, theta: float, device):
    """cos, sin [1,1,1,half] of one position, as ``layers.rope`` computes them."""
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))
    angles = freqs * float(position)
    return torch.cos(angles)[None, None, None], torch.sin(angles)[None, None, None]


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``layers.rope`` of x [B,1,H,hd] at the position of ``_rope_tables``."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _pub_logits(cfg: ArchConfig, emb: Params, h: torch.Tensor) -> torch.Tensor:
    return _mm(F.rms_norm(h, (h.shape[-1],), emb["ln_f"], cfg.rms_eps), emb["tok"].t())


def pub_prefill(cfg: ArchConfig, params: Params, tokens: torch.Tensor, smax: int,
                last_only: bool = True) -> Tuple[torch.Tensor, State]:
    """The prompt [B,T] from a zero state -> (logits [B,1,V] of its last position,
    or [B,T,V] of every one, the state), the sites' K/V in a cache of ``smax``
    slots in the compute dtype; raises if the prompt does not fit."""
    _refuse_unsupported("prefill")
    b, t = tokens.shape
    if t > smax:
        raise ValueError(f"prompt of {t} tokens does not fit a cache of {smax}")
    e = layers.embed(params["emb"], tokens)
    spec = pub_state_spec(cfg, b, smax)
    state = {name: torch.zeros(shape, dtype=dtype if name == "ssd" else e.dtype,
                               device=tokens.device)
             for name, (shape, dtype) in spec.items()}
    positions = transformer._positions(b, t, tokens.device)

    def attend(j, q, k, v):
        q, k = (layers.rope(x, positions, cfg.rope_theta) for x in (q, k))
        state["k"][j, :, :t] = k
        state["v"][j, :, :t] = v
        kvh = cfg.n_kv_heads
        o = ops.flash_attention(q.reshape(b, t, kvh, cfg.n_heads // kvh, cfg.hd).contiguous(),
                                k.contiguous(), v.contiguous(), scale=cfg.attn_scale)
        return o.reshape(b, t, cfg.n_heads * cfg.hd)

    h = _pub_layers(cfg, params, e, state, attend)
    return _pub_logits(cfg, params["emb"], h[:, -1:] if last_only else h), state


def pub_decode_step(cfg: ArchConfig, params: Params, token: torch.Tensor, state: State,
                    cache_len: int) -> Tuple[torch.Tensor, State]:
    """One token [B,1] at position ``cache_len`` through every layer: the state
    (conv tails, SSD states, the sites' K/V in slot ``cache_len``) updated in
    place.  Returns (logits [B,1,V], state)."""
    _refuse_unsupported("decode")
    b = token.shape[0]
    e = layers.embed(params["emb"], token)
    cos, sin = _rope_tables(cache_len, cfg.hd // 2, cfg.rope_theta, token.device)

    def attend(j, q, k, v):
        q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
        ck, cv = state["k"][j], state["v"][j]
        layers._write_slot(ck, k, cache_len)
        layers._write_slot(cv, v, cache_len)
        o = ops.decode_attention(q.contiguous(), ck, cv, cache_len + 1, cfg.attn_scale)
        return o.reshape(b, 1, cfg.n_heads * cfg.hd)

    h = _pub_layers(cfg, params, e, state, attend)
    return _pub_logits(cfg, params["emb"], h), state


def pub_loss_fn(cfg: ArchConfig, params: Params, batch) -> torch.Tensor:
    raise NotImplementedError(f"{cfg.name}: training the published Zamba2 hybrid is not "
                              "supported (no K1-bwd at its head dim, no K3-bwd with groups)")
