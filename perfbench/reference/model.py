"""The dense decoder (minicpm-2b), written out plainly in float32.

Token rows, then per layer
``h += r * attn(norm(h))`` and ``h += r * swiglu(norm(h))`` with
``r = 1.4 / sqrt(L)`` where the residual is depth-scaled, RoPE on q and k
(rotating the two halves of each head), causal softmax attention, a final
norm and the head (the token rows, where tied).  RMS norms take eps 1e-6.

Weights are a flat dict path -> tensor in any dtype, taken to float32 one
layer at a time, so the served weights in bfloat16 are all the reference
holds besides one layer.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .layout import head_dim
from .precision import FP32, Precision

EPS = 1e-6
Weights = Dict[Tuple[str, ...], torch.Tensor]


def rms_norm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + EPS) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, T, H, hd] at positions 0..T-1."""
    t, half = x.shape[1], x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(arch: Dict, p: Dict, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Causal multi-head attention of x [B, T, d] (GQA by repeating k, v)."""
    b, t, _ = x.shape
    hq, hk, hd = arch["n_heads"], arch["n_kv_heads"], head_dim(arch)
    theta = arch.get("rope_theta", 10000.0)
    q = rope(prec.mm(x, p["attn/wq"]).view(b, t, hq, hd), theta)
    k = rope(prec.mm(x, p["attn/wk"]).view(b, t, hk, hd), theta)
    v = prec.mm(x, p["attn/wv"]).view(b, t, hk, hd)
    if hq != hk:
        k = k.repeat_interleave(hq // hk, 2)
        v = v.repeat_interleave(hq // hk, 2)
    s = prec.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    pr = torch.softmax(s.masked_fill(~causal, float("-inf")), -1)
    o = prec.einsum("bhqk,bkhd->bqhd", pr, v).reshape(b, t, hq * hd)
    return prec.mm(o, p["attn/wo"])


def swiglu(p: Dict, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    return prec.mm(F.silu(prec.mm(x, p["mlp/w1"])) * prec.mm(x, p["mlp/w3"]), p["mlp/w2"])


# ---------------------------------------------------------------- assembly

def block_params(weights: Weights, i: int) -> Dict[str, torch.Tensor]:
    """Layer i's weights in float32, by name below ``layers`` ("attn/wq")."""
    return {"/".join(path[1:]): w[i].float() for path, w in weights.items()
            if path[0] == "layers"}


def block(arch: Dict, p: Dict, h: torch.Tensor, prec: Precision) -> torch.Tensor:
    r = 1.4 / math.sqrt(arch["n_layers"]) if arch.get("depth_scaled_residual") else 1.0
    h = h + r * attention(arch, p, rms_norm(h, p["ln1"]), prec)
    return h + r * swiglu(p, rms_norm(h, p["ln2"]), prec)


def head_weight(weights: Weights) -> torch.Tensor:
    """The head [d, V_pad]: ``emb/out``, or the tied token rows transposed."""
    if ("emb", "out") in weights:
        return weights[("emb", "out")].float()
    return weights[("emb", "tok")].float().t()


def logits(arch: Dict, weights: Weights, h: torch.Tensor, prec: Precision = FP32,
           head=None) -> torch.Tensor:
    """The final norm and the head over h -> [B, T, V] over the real vocabulary."""
    head = head_weight(weights) if head is None else head
    x = rms_norm(h, weights[("emb", "ln_f")].float())
    return prec.mm(x, head)[..., :arch["vocab"]]


def cross_entropy(z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The mean of log-sum-exp less the gold logit, with the row max added
    back outside the sum and keeping its gradient: the loss the
    configurations train (so each row's gradient also holds its argmax's
    one-hot), not the plain cross-entropy's gradient."""
    m = z.amax(-1, keepdim=True)
    logz = torch.log(torch.exp(z - m.detach()).sum(-1)) + m[..., 0]
    return (logz - torch.gather(z, -1, labels[..., None])[..., 0]).mean()


@torch.no_grad()
def forward_logits(arch: Dict, weights: Weights, tokens: torch.Tensor,
                   prec: Precision = FP32) -> torch.Tensor:
    """tokens [B, T] -> logits [B, T, V] in float32, one block's weights at a time."""
    h = weights[("emb", "tok")][tokens].float()
    for i in range(arch["n_layers"]):
        h = block(arch, block_params(weights, i), h, prec)
    return logits(arch, weights, h, prec)
