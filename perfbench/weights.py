"""Weights made from the seed, on the device, one call a leaf.

Each leaf has a generator of its own, seeded from the run's seed and the
leaf's place in the layout, so any leaf can be drawn again alone: the
reference draws the initial weights again once the program has trained or
freed its own.  The draws go straight into the leaf's storage in the type
it is served in (``normal_`` on a bfloat16 tensor), so no
float32 copy of a large leaf is ever made.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch

from .reference.layout import Leaf

Path = Tuple[str, ...]


def leaf_seed(seed: int, index: int) -> int:
    return (int(seed) * 1_000_003 + 7919 * (index + 1)) % (1 << 63)


@torch.no_grad()
def draw_into(t: torch.Tensor, leaf: Leaf, seed: int, index: int) -> torch.Tensor:
    """Fills ``t`` (of ``leaf``'s shape) with the leaf's initial values."""
    kind = leaf.init[0]
    if kind == "ones":
        return t.fill_(1.0)
    if kind == "normal":
        g = torch.Generator(device=t.device).manual_seed(leaf_seed(seed, index))
        return t.normal_(0.0, leaf.init[1], generator=g)
    raise ValueError(f"unknown init {leaf.init!r}")


def torch_dtype(leaf: Leaf, param_dtype: torch.dtype) -> torch.dtype:
    return param_dtype if leaf.dtype == "param" else torch.float32


def make(layout: Iterable[Leaf], seed: int, param_dtype: torch.dtype, device,
         only: Optional[Iterable[Path]] = None) -> Dict[Path, torch.Tensor]:
    """Flat {path: tensor} of the layout's leaves (or of those in ``only``)."""
    keep = None if only is None else set(only)
    out = {}
    for i, leaf in enumerate(layout):
        if keep is None or leaf.path in keep:
            t = torch.empty(leaf.shape, dtype=torch_dtype(leaf, param_dtype), device=device)
            out[leaf.path] = draw_into(t, leaf, seed, i)
    return out


def fill(tree: Dict, layout: Iterable[Leaf], seed: int, param_dtype: torch.dtype) -> None:
    """Draws the layout's values into a nested dict of tensors made elsewhere
    (the program's own), after checking that its leaves are the layout's."""
    flat = dict(flatten(tree))
    layout = list(layout)
    want = {leaf.path: (tuple(leaf.shape), torch_dtype(leaf, param_dtype)) for leaf in layout}
    got = {p: (tuple(t.shape), t.dtype) for p, t in flat.items()}
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()))
        raise ValueError(f"the program's parameter tree is not the layout: {diff[:6]}")
    for i, leaf in enumerate(layout):
        draw_into(flat[leaf.path], leaf, seed, i)


def nest(flat: Dict[Path, torch.Tensor]) -> Dict:
    tree: Dict = {}
    for path, t in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return tree


def flatten(tree: Dict, prefix: Path = ()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v
