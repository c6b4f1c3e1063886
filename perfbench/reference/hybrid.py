"""The published Zamba2 hybrid (zamba2-7b-instruct), written out plainly in float32.

With e the token rows (kept for the whole pass) and h = e, layer i is
``h = h + Mamba_i(RMS_i(h + T_j))`` at site j (layer ``hybrid_layer_ids[j]``) and
``h = h + Mamba_i(RMS_i(h))`` elsewhere, where ``T_j = Linear_j(S_{j % n}(h, e))``:

* the shared block S: ``u = RMS([h | e])``; q, k, v = u W_qkv (heads of hd, RoPE
  on every dim of each head), causal softmax attention with the configuration's
  scale, ``a = o W_o``; ``m = RMS(a)``; ``g | p = m W_gu + (m A_j) B_j`` (the
  site's adapter); ``S = (act(g) p) W_down``, with no residual inside it;
* Mamba2: ``z | x | B | C | dt = u W_in``; a causal depthwise convolution of
  width 4 with bias over x | B | C (``F.conv1d``), then SiLU;
  ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``; the scan from a zero
  state in its quadratic form, y_i = sum_{j <= i} exp(sum_{k=j+1..i} A dt_k)
  (C_i . B_j) dt_j x_j, head h reading group h // (H/G), the segment sums taken
  directly (a masked cumulative sum over each j's own rows, no difference of
  long sums), a block of heads at a time; ``+ D x``; the gated norm: ``y silu(z)``,
  RMS over each of the G groups of channels, the weight; ``out_proj``;
* the final norm and the head (the token rows, tied).

RMS norms take the configuration's eps.  Weights are the flat dict the program
was given (``weights_hybrid``), taken to float32 one layer at a time.  Products
go through ``precision`` so that the control computes them in fp8.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .hybrid_layout import CONV_K, sites, widths
from .layout import head_dim
from .model import rope
from .precision import FP32, Precision

HEAD_BLOCK = 8      # heads of the scan and of attention computed at once


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _leaves(weights: Dict, top: str, i: int) -> Dict[str, torch.Tensor]:
    return {path[1]: t[i].float() for path, t in weights.items() if path[0] == top}


def scan(arch: Dict, x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
         C: torch.Tensor, prec: Precision) -> torch.Tensor:
    """y [b,T,H,P] of the SSD from a zero state: x [b,T,H,P], dt [b,T,H], A [H],
    B, C [b,T,G,N]."""
    b, t, nh, _ = x.shape
    per = nh // B.shape[2]
    below = torch.ones(t, t, dtype=torch.bool, device=x.device).tril(-1)    # k > j
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()     # j <= i
    cb = [prec.einsum("bin,bjn->bij", C[:, :, g], B[:, :, g]) for g in range(B.shape[2])]
    ys = []
    for h0 in range(0, nh, HEAD_BLOCK):
        hs = slice(h0, min(h0 + HEAD_BLOCK, nh))
        a = (A[hs] * dt[:, :, hs]).transpose(1, 2)                    # [b,h,T] log decays
        seg = torch.where(below, a[..., :, None], 0.0).cumsum(-2)     # [b,h,i,j]: k in (j, i]
        decay = torch.exp(seg.masked_fill(~causal, float("-inf")))
        del seg
        groups = torch.arange(hs.start, hs.stop, device=x.device) // per
        m = decay * torch.stack([cb[int(g)] for g in groups], 1)
        m = m * dt[:, :, hs].transpose(1, 2)[:, :, None, :]
        ys.append(prec.einsum("bhij,bjhp->bihp", m, x[:, :, hs]))
    return torch.cat(ys, 2)


def mamba(arch: Dict, p: Dict, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    b, t, _ = x.shape
    din, gn, nh = widths(arch)
    G, N, P = arch["ssm_groups"], arch["ssm_state"], arch["ssm_head_dim"]
    eps = arch["rms_eps"]
    z, xbc, dt = torch.split(prec.mm(rms(x, p["ln"], eps), p["in_proj"]),
                             [din, din + 2 * gn, nh], -1)
    conv = F.conv1d(xbc.transpose(1, 2), p["conv_w"].t()[:, None, :], p["conv_b"],
                    padding=CONV_K - 1, groups=din + 2 * gn)[..., :t].transpose(1, 2)
    xs, B, C = torch.split(F.silu(conv), [din, gn, gn], -1)
    dt = F.softplus(dt + p["dt_bias"])
    xh = xs.reshape(b, t, nh, P)
    y = scan(arch, xh, dt, -torch.exp(p["A_log"]), B.reshape(b, t, G, N),
             C.reshape(b, t, G, N), prec)
    y = (y + p["D"][:, None] * xh).reshape(b, t, din) * F.silu(z)
    y = y.reshape(b, t, G, din // G)
    y = (y * torch.rsqrt((y * y).mean(-1, keepdim=True) + eps)).reshape(b, t, din)
    return prec.mm(y * p["norm"], p["out_proj"])


def attention(arch: Dict, p: Dict, u: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Causal attention of u [b,T,d_in] -> [b,T,H*hd] (before W_o)."""
    b, t, _ = u.shape
    hq, hk, hd = arch["n_heads"], arch["n_kv_heads"], head_dim(arch)
    theta = arch.get("rope_theta", 10000.0)
    scale = arch.get("attn_scale") or hd ** -0.5
    q, k, v = torch.split(prec.mm(u, p["wqkv"]), [hq * hd, hk * hd, hk * hd], -1)
    q = rope(q.reshape(b, t, hq, hd), theta)
    k = rope(k.reshape(b, t, hk, hd), theta).repeat_interleave(hq // hk, 2)
    v = v.reshape(b, t, hk, hd).repeat_interleave(hq // hk, 2)
    causal = torch.ones(t, t, dtype=torch.bool, device=u.device).tril()
    out = []
    for h0 in range(0, hq, HEAD_BLOCK):
        hs = slice(h0, h0 + HEAD_BLOCK)
        s = prec.einsum("bqhd,bkhd->bhqk", q[:, :, hs], k[:, :, hs]) * scale
        pr = torch.softmax(s.masked_fill(~causal, float("-inf")), -1)
        out.append(prec.einsum("bhqk,bkhd->bqhd", pr, v[:, :, hs]))
    return torch.cat(out, 2).reshape(b, t, hq * hd)


def site(arch: Dict, sp: Dict, st: Dict, h: torch.Tensor, e: torch.Tensor,
         prec: Precision) -> torch.Tensor:
    """T_j = Linear_j(S(h, e)) of one site: ``sp`` its shared block, ``st`` its own."""
    eps = arch["rms_eps"]
    u = torch.cat([h, e], -1) if arch.get("attn_concat_embed") else h
    a = prec.mm(attention(arch, sp, rms(u, sp["ln1"], eps), prec), sp["wo"])
    m = rms(a, sp["ln2"], eps)
    g, up = (prec.mm(m, sp["w_gu"]) + prec.mm(prec.mm(m, st["ad_a"]), st["ad_b"])).chunk(2, -1)
    act = F.gelu(g) if arch.get("mlp_act") == "gelu" else F.silu(g)
    return prec.mm(prec.mm(act * up, sp["w_down"]), st["lin"])


@torch.no_grad()
def forward_logits(arch: Dict, weights: Dict, tokens: torch.Tensor,
                   prec: Precision = FP32) -> torch.Tensor:
    """tokens [B, T] -> logits [B, T, V] in float32, one layer's weights at a time."""
    e = weights[("emb", "tok")][tokens].float()
    h = e
    at = {layer: j for j, layer in enumerate(sites(arch))}
    for i in range(arch["n_layers"]):
        x = h
        if i in at:
            j = at[i]
            x = h + site(arch, _leaves(weights, "shared", j % arch["shared_blocks"]),
                         _leaves(weights, "sites", j), h, e, prec)
        h = h + mamba(arch, _leaves(weights, "mamba", i), x, prec)
    tok = weights[("emb", "tok")].float()
    return prec.mm(rms(h, weights[("emb", "ln_f")].float(), arch["rms_eps"]),
                   tok.t())[..., :arch["vocab"]]
