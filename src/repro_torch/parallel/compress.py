"""Gradient compression for the data-parallel all-reduce.

Mirrors ``repro.parallel.compress``: int8 block-quantised gradients with
error feedback.  Each block of ``BLOCK`` values keeps one fp32 scale,
max|block| / 127 + 1e-12, and its values are rounded stochastically; the
quantisation residual is carried into the next step's gradient.  A
standalone utility, as in the reference: no train step calls it.

The reference draws the rounding noise with ``jax.random.uniform(fold_in(key,
i), shape) - 0.5``.  Here it comes from a ``torch.Generator``, or is passed
in as a tensor (uniform in [-0.5, 0.5), one value a padded element), so
that a caller can feed the same noise to both.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..train.optimizer import flatten_with_paths, unflatten

BLOCK = 256


def _pad_to_block(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    return torch.nn.functional.pad(flat, (0, pad)), pad


def noise_like(n: int, gen: torch.Generator) -> torch.Tensor:
    """Rounding noise for ``n`` values (padded to whole blocks), uniform in
    [-0.5, 0.5), on ``gen``'s device."""
    n += (-n) % BLOCK
    return torch.rand(n, generator=gen, device=gen.device) - 0.5


def quantize(g: torch.Tensor, noise) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 values [N], fp32 scales [N/BLOCK]); stochastic rounding.

    ``noise``: a ``torch.Generator``, or a tensor of ``N`` (the padded size)
    values in [-0.5, 0.5)."""
    flat, _ = _pad_to_block(g.float())
    if isinstance(noise, torch.Generator):
        noise = noise_like(g.numel(), noise)
    blocks = flat.reshape(-1, BLOCK)
    # a tensor divisor: CUDA divides by a Python scalar as a product with its
    # reciprocal, a bit off the reference's division
    scale = blocks.abs().amax(1, keepdim=True) / blocks.new_full((), 127.0) + 1e-12
    scaled = blocks / scale
    q = torch.clamp(torch.round(scaled + noise.reshape(scaled.shape)), -127, 127)
    return q.to(torch.int8).reshape(-1), scale[:, 0]


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape, dtype) -> torch.Tensor:
    blocks = q.reshape(-1, BLOCK).float() * scale[:, None]
    n = 1
    for d in shape:
        n *= d
    return blocks.reshape(-1)[:n].reshape(shape).to(dtype)


def compress_tree(grads, residual, noise):
    """Error-feedback quantisation leaf by leaf of a tree of gradients (nested
    dicts, leaves in the reference's order: keys sorted).  Returns (the
    dequantised grads in each leaf's dtype, what the other ranks would see
    after the int8 all-reduce; the new fp32 residual tree).  ``residual``
    None starts from zero.  ``noise``: a ``torch.Generator`` drawn from leaf
    by leaf, or a sequence of noise tensors, one a leaf."""
    leaves = list(flatten_with_paths(grads))
    res_leaves = ([r for _, r in flatten_with_paths(residual)] if residual is not None
                  else [torch.zeros_like(g, dtype=torch.float32) for _, g in leaves])
    out, new_res = [], []
    for i, ((path, g), r) in enumerate(zip(leaves, res_leaves)):
        corrected = g.float() + r
        q, scale = quantize(corrected, noise if isinstance(noise, torch.Generator)
                            else noise[i])
        deq = dequantize(q, scale, g.shape, torch.float32)
        out.append((path, deq.to(g.dtype)))
        new_res.append((path, corrected - deq))
    return unflatten(out), unflatten(new_res)


def zero_residual(grads):
    return unflatten((path, torch.zeros(g.shape, dtype=torch.float32, device=g.device))
                     for path, g in flatten_with_paths(grads))
