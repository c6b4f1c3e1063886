"""Parameter trees between the JAX package (as numpy) and the port (as torch).

The JAX side hands over ``jax.tree.map(np.asarray, params)``: a nested dict
of numpy arrays whose bf16 leaves carry numpy's ``bfloat16`` extension
dtype.  That dtype is recognised by name, so this module needs no
``ml_dtypes``; bf16 crosses as its raw 16 bits, which keeps the round trip
bit-exact.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from . import resolve_device

Tree = Dict[str, Any]


def _leaf_to_torch(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.tensor(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.tensor(a)
    return t.to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        try:
            bf16 = np.dtype("bfloat16")
        except TypeError as e:
            raise TypeError("numpy has no 'bfloat16' dtype registered in this "
                            "process (it comes with ml_dtypes, which JAX "
                            "imports)") from e
        return t.view(torch.int16).numpy().view(bf16)
    return t.numpy()


def to_torch(tree: Tree, device="cuda") -> Tree:
    """Nested dict of numpy arrays -> the same tree of torch tensors on ``device``."""
    dev = resolve_device(device)
    return {k: to_torch(v, dev) if isinstance(v, dict) else _leaf_to_torch(v, dev)
            for k, v in tree.items()}


def to_numpy(tree: Tree) -> Tree:
    """Inverse of :func:`to_torch`: torch tensors -> numpy arrays (bf16 stays bf16)."""
    return {k: to_numpy(v) if isinstance(v, dict) else _leaf_to_numpy(v)
            for k, v in tree.items()}
