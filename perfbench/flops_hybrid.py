"""Model flops of the published Zamba2 hybrid: the parameters a token passes through.

As ``flops`` counts the dense decoder's: each Mamba2 layer once (in_proj, the
depthwise conv's taps, out_proj), each site's shared block, adapter and linear
once per site (a block's weights count at every site that uses them), and the
head over the real vocabulary; the embedding lookup is no product.  The scan's
own products, attention's score and value products and the norms are left out,
so the share of the peak that follows is a floor.  At the published sizes:
6.35 B in the Mamba2 layers, 4.56 B over the 13 sites and 0.11 B in the head.
"""

from __future__ import annotations

from typing import Dict

from .reference.hybrid_layout import CONV_K, sites, widths
from .reference.layout import head_dim


def mamba_layer(a: Dict) -> int:
    d = a["d_model"]
    din, gn, nh = widths(a)
    return d * (2 * din + 2 * gn + nh) + CONV_K * (din + 2 * gn) + din * d


def site(a: Dict) -> int:
    d, f, r = a["d_model"], a["d_ff"], a["adapter_rank"]
    hq, hk = a["n_heads"] * head_dim(a), a["n_kv_heads"] * head_dim(a)
    d_in = 2 * d if a.get("attn_concat_embed") else d
    return d_in * (hq + 2 * hk) + hq * d + d * 2 * f + f * d + d * r + r * 2 * f + d * d


def body(a: Dict) -> int:
    return a["n_layers"] * mamba_layer(a) + len(sites(a)) * site(a)


def head(a: Dict) -> int:
    return a["d_model"] * a["vocab"]


def decode(a: Dict, tokens: int) -> float:
    return 2.0 * (body(a) + head(a)) * tokens
