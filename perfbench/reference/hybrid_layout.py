"""The parameter tree of the published Zamba2 hybrid (zamba2-7b-instruct).

The leaves the measured model takes (``repro_torch.models.zamba2``'s published
path), with the dense layout's conventions (``layout.Leaf``): projections fused
and stored [in, out], layer leaves on a leading [L] axis, the shared blocks' on
[blocks] and the sites' own on [sites].  ``mamba/A_log``, ``mamba/D`` and
``mamba/dt_bias`` are fp32 and drawn as ones here; ``perfbench.weights_hybrid``
then gives them the published initial values.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .layout import Leaf, _dense, _embeddings, head_dim

CONV_K = 4


def sites(arch: Dict) -> Tuple[int, ...]:
    """The layers that run a shared block first (the published ids below the depth)."""
    return tuple(i for i in arch["hybrid_layer_ids"] if i < arch["n_layers"])


def widths(arch: Dict) -> Tuple[int, int, int]:
    """(din, G * N, heads) of a Mamba2 layer."""
    din = arch.get("ssm_expand", 2) * arch["d_model"]
    return din, arch["ssm_groups"] * arch["ssm_state"], din // arch["ssm_head_dim"]


def layout(arch: Dict) -> List[Leaf]:
    """Every leaf of the hybrid's tree, in sorted path order."""
    if arch["family"] != "hybrid" or not arch.get("hybrid_layer_ids"):
        raise ValueError("the hybrid reference takes the published Zamba2 hybrid only")
    d, f, r = arch["d_model"], arch["d_ff"], arch["adapter_rank"]
    din, gn, nh = widths(arch)
    hq = arch["n_heads"] * head_dim(arch)
    hk = arch["n_kv_heads"] * head_dim(arch)
    d_in = 2 * d if arch.get("attn_concat_embed") else d
    L, nb, ns = (arch["n_layers"],), (arch["shared_blocks"],), (len(sites(arch)),)
    leaves = _embeddings(arch) + [
        Leaf(("mamba", "ln"), (*L, d), "param", ("ones",)),
        _dense(("mamba", "in_proj"), d, 2 * din + 2 * gn + nh, L),
        Leaf(("mamba", "conv_w"), (*L, CONV_K, din + 2 * gn), "param", ("normal", 0.2)),
        Leaf(("mamba", "conv_b"), (*L, din + 2 * gn), "param", ("normal", 0.02)),
        Leaf(("mamba", "A_log"), (*L, nh), "fp32", ("ones",)),
        Leaf(("mamba", "D"), (*L, nh), "fp32", ("ones",)),
        Leaf(("mamba", "dt_bias"), (*L, nh), "fp32", ("ones",)),
        Leaf(("mamba", "norm"), (*L, din), "param", ("ones",)),
        _dense(("mamba", "out_proj"), din, d, L),
        Leaf(("shared", "ln1"), (*nb, d_in), "param", ("ones",)),
        _dense(("shared", "wqkv"), d_in, hq + 2 * hk, nb),
        _dense(("shared", "wo"), hq, d, nb),
        Leaf(("shared", "ln2"), (*nb, d), "param", ("ones",)),
        _dense(("shared", "w_gu"), d, 2 * f, nb),
        _dense(("shared", "w_down"), f, d, nb),
        _dense(("sites", "lin"), d, d, ns),
        _dense(("sites", "ad_a"), d, r, ns),
        _dense(("sites", "ad_b"), r, 2 * f, ns),
    ]
    return sorted(leaves, key=lambda leaf: leaf.path)
