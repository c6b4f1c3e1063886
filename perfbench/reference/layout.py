"""The parameter tree of a configuration, and how each leaf is first drawn.

A leaf is ``Leaf(path, shape, dtype, init)``: ``dtype`` is ``"param"`` (the
type the weights are served or trained in) or ``"fp32"``, ``init``
``("normal", std)`` or ``("ones",)``.  Layer leaves carry a leading [L]
axis.  The tree is the one the measured models take, so the same weights
reach both sides.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple


class Leaf(NamedTuple):
    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    dtype: str
    init: tuple


def padded_vocab(arch: Dict) -> int:
    """The embedding's rows: the vocabulary rounded up to a multiple of 256."""
    return (arch["vocab"] + 255) // 256 * 256


def head_dim(arch: Dict) -> int:
    return arch.get("head_dim") or arch["d_model"] // arch["n_heads"]


def _glorot(n_in: int, n_out: int) -> tuple:
    return ("normal", (2.0 / (n_in + n_out)) ** 0.5)


def _dense(prefix, n_in, n_out, stack=()):
    return Leaf(prefix, (*stack, n_in, n_out), "param", _glorot(n_in, n_out))


def _attention_block(arch: Dict, prefix: Tuple[str, ...], stack=()) -> List[Leaf]:
    d, f = arch["d_model"], arch["d_ff"]
    hq, hk = arch["n_heads"] * head_dim(arch), arch["n_kv_heads"] * head_dim(arch)
    return [
        Leaf(prefix + ("ln1",), (*stack, d), "param", ("ones",)),
        _dense(prefix + ("attn", "wq"), d, hq, stack),
        _dense(prefix + ("attn", "wk"), d, hk, stack),
        _dense(prefix + ("attn", "wv"), d, hk, stack),
        _dense(prefix + ("attn", "wo"), hq, d, stack),
        Leaf(prefix + ("ln2",), (*stack, d), "param", ("ones",)),
        _dense(prefix + ("mlp", "w1"), d, f, stack),
        _dense(prefix + ("mlp", "w3"), d, f, stack),
        _dense(prefix + ("mlp", "w2"), f, d, stack),
    ]


def _embeddings(arch: Dict) -> List[Leaf]:
    d, v = arch["d_model"], padded_vocab(arch)
    leaves = [Leaf(("emb", "tok"), (v, d), "param", ("normal", 0.02)),
              Leaf(("emb", "ln_f"), (d,), "param", ("ones",))]
    if not arch.get("tie_embeddings"):
        leaves.append(_dense(("emb", "out"), d, v))
    return leaves


def layout(arch: Dict) -> List[Leaf]:
    """Every leaf of ``arch``'s tree, in sorted path order (the order the
    optimizer walks them)."""
    if arch["family"] != "dense":
        raise ValueError(f"no reference for family {arch['family']!r}")
    if arch.get("qkv_bias") or arch.get("qk_norm") or arch.get("swa_window"):
        raise ValueError("the dense reference has no qkv bias, qk norm or window")
    leaves = _embeddings(arch) + _attention_block(arch, ("layers",), (arch["n_layers"],))
    return sorted(leaves, key=lambda leaf: leaf.path)


def decayed(path: Tuple[str, ...]) -> bool:
    """Whether AdamW decays the leaf: every leaf but those whose own name
    starts with ``ln`` or ``b`` or holds ``norm``."""
    name = path[-1]
    return not (name.startswith("ln") or name.startswith("b") or "norm" in name)
