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
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..configs.base import ArchConfig
from ..kernels import ops, ref
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
    """h [B,T,d]; conv_state [B, din+2N, K-1]; ssd_state [B,H,P,N]."""
    b, t, _ = h.shape
    din = _din(cfg)
    N = cfg.ssm_state
    P = cfg.ssm_head_dim
    H = din // P
    x_in = layers.rms_norm(h, p["ln"])
    z = _mm(x_in, p["in_z"])
    xbc = torch.cat([_mm(x_in, p["in_x"]), _mm(x_in, p["in_B"]),
                     _mm(x_in, p["in_C"])], dim=-1)
    dt = _mm(x_in, p["in_dt"])

    # short causal convs on x / B / C, carrying the K-1 tail as state
    xbc_pad = torch.cat([conv_state.transpose(1, 2).to(xbc.dtype), xbc], dim=1)
    # a copy: a view would keep the whole [B, T+K-1, din+2N] input alive with the state
    new_conv_state = xbc_pad[:, -(CONV_K - 1):].transpose(1, 2).clone()
    w_cat = torch.cat([p["conv_w"], p["conv_Bw"], p["conv_Cw"]], dim=1)
    b_cat = torch.cat([p["conv_b"], p["conv_b"].new_zeros(2 * N)])
    conv = sum(xbc_pad[:, i:i + t] * w_cat[i] for i in range(CONV_K)) + b_cat
    x, B, C = torch.split(F.silu(conv), [din, N, N], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])             # [B,T,H]
    A = -torch.exp(p["A_log"])
    xh = x.reshape(b, t, H, P).float().contiguous()
    B, C = B.float().contiguous(), C.float().contiguous()
    if t == 1:
        y, new_ssd = ref.mamba2_naive(xh, dt, A, B, C, ssd_state)
    else:
        y, new_ssd = ops.mamba2_ssd(xh, dt, A, B, C, ssd_state, chunk=128)
    y = y + p["D"][None, None, :, None] * xh
    y = layers.rms_norm(y.reshape(b, t, din).to(h.dtype), p["norm"]) * F.silu(z)
    return _mm(y, p["out_proj"]), new_conv_state, new_ssd


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
    """The shared attention + MLP block over h; returns (h, k, v)."""
    attn, k, v = transformer._attn_full(cfg, sp, h, positions)
    h = h + attn
    return h + layers.swiglu(sp["mlp"], layers.rms_norm(h, sp["ln2"])), k, v


def _backbone(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
              state: Optional[State] = None, smax: int = 0):
    """tokens [B,T] -> (final hidden [B,T,d], new state).  The per-site K/V
    come back in a cache of ``smax`` slots (``T`` if 0), zero past T.  Under
    placed parameters (a placed serving call) each mamba layer gathers its
    blocks whole, as the loss's do, and the shared block is gathered whole
    once; the state holds this rank's rows."""
    b, t = tokens.shape
    period = cfg.attn_every
    smax = smax or t
    if t > smax:
        raise ValueError(f"prompt of {t} tokens does not fit a cache of {smax}")
    if state is None:
        state = {"conv": torch.zeros(conv_state_spec(cfg, b), dtype=torch.bfloat16,
                                     device=tokens.device),
                 "ssd": torch.zeros(ssd_state_spec(cfg, b), dtype=torch.float32,
                                    device=tokens.device)}
    positions = transformer._positions(b, t, tokens.device)
    h = layers.embed(params["emb"], tokens)
    kv_shape = (n_attn_sites(cfg), b, smax, cfg.n_kv_heads, cfg.hd)
    cache_k = cache_v = None
    gather = layers.gatherer("mamba", stacked=True, whole=True)
    sp = layers.gatherer("shared", whole=True)(params["shared"])
    convs, ssds = [], []
    for i, lp in enumerate(layers.unstack(params["mamba"])):
        out, cs, ss = mamba_layer(cfg, gather(lp), h, state["conv"][i], state["ssd"][i])
        h = h + out
        convs.append(cs)
        ssds.append(ss)
        site, last_of_period = divmod(i + 1, period)
        if last_of_period == 0:
            h, k, v = _shared_block(cfg, sp, h, positions)
            if cache_k is None:     # the K/V dtype is the compute dtype, as in the reference
                cache_k = k.new_zeros(kv_shape)
                cache_v = v.new_zeros(kv_shape)
            cache_k[site - 1, :, :t] = k
            cache_v[site - 1, :, :t] = v
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
    placed parameters each of them gathers its blocks whole inside (the
    blocks run whole on every "model" rank; the shared block at each of its
    sites), and the embedding and head are vocab-parallel."""
    tokens = batch["tokens"]
    b, t = tokens.shape
    positions = transformer._positions(b, t, tokens.device)
    h = layers.embed(params["emb"], tokens)
    conv = h.new_zeros((b, _din(cfg) + 2 * cfg.ssm_state, CONV_K - 1))
    ssd = torch.zeros(ssd_state_spec(cfg, b)[1:], dtype=torch.float32, device=tokens.device)

    gather_mamba = layers.gatherer("mamba", stacked=True, whole=True)
    gather_shared = layers.gatherer("shared", whole=True)

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
    Returns (logits [B,1,V], state).  Under placed parameters, gathered as
    ``_backbone`` gathers them."""
    period = cfg.attn_every
    h = layers.embed(params["emb"], token)
    gather = layers.gatherer("mamba", stacked=True, whole=True)
    sp = layers.gatherer("shared", whole=True)(params["shared"])
    convs, ssds = [], []
    for i, lp in enumerate(layers.unstack(params["mamba"])):
        out, cs, ss = mamba_layer(cfg, gather(lp), h, state["conv"][i], state["ssd"][i])
        h = h + out
        convs.append(cs)
        ssds.append(ss)
        site, last_of_period = divmod(i + 1, period)
        if last_of_period == 0:
            out, _, _, _ = layers.attention_decode(
                cfg, sp["attn"], layers.rms_norm(h, sp["ln1"]), state["k"][site - 1],
                state["v"][site - 1], cache_len, cache_len, cache_len + 1)
            h = h + out
            h = h + layers.swiglu(sp["mlp"], layers.rms_norm(h, sp["ln2"]))
    return layers.unembed(params["emb"], h), {
        "conv": torch.stack(convs), "ssd": torch.stack(ssds),
        "k": state["k"], "v": state["v"]}
