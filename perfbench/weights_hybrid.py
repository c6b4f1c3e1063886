"""The hybrid's weights from the seed: ``weights.make``, then Mamba2's own
initial values where the published model draws them.

As Zamba2's ``_init_weights`` draws them: ``A_log = log(1 .. H)`` (A = -1 .. -H),
``D = 1``, and ``dt_bias`` the softplus inverse of a step dt drawn log-uniform
in [time_step_min, time_step_max] = [1e-3, 0.1] and floored at 1e-4, so the
state carries as far as in the deployed model.  Both the program and the
reference take their weights from here.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable

import torch

from . import weights
from .reference.layout import Leaf

DT_MIN, DT_MAX, DT_FLOOR = 1e-3, 0.1, 1e-4


@torch.no_grad()
def draw_ssm(w: Dict, seed: int, index: int) -> None:
    """Gives ``w``'s (flat) ``mamba/A_log``, ``D`` and ``dt_bias`` [L, H] their
    published initial values, in place; ``index`` seeds the dt draw."""
    a_log, d, dt_bias = (w[("mamba", k)] for k in ("A_log", "D", "dt_bias"))
    n_heads = a_log.shape[-1]
    a_log.copy_(torch.log(torch.arange(1, n_heads + 1, dtype=torch.float32,
                                       device=a_log.device)).expand_as(a_log))
    d.fill_(1.0)
    g = torch.Generator(device=dt_bias.device).manual_seed(weights.leaf_seed(seed, index))
    u = torch.rand(dt_bias.shape, generator=g, device=dt_bias.device, dtype=torch.float32)
    dt = torch.exp(u * (math.log(DT_MAX) - math.log(DT_MIN)) + math.log(DT_MIN))
    dt = dt.clamp(min=DT_FLOOR)
    dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))


def make(layout: Iterable[Leaf], seed: int, param_dtype: torch.dtype, device) -> Dict:
    """Flat {path: tensor} of every leaf of the hybrid's layout."""
    layout = list(layout)
    w = weights.make(layout, seed, param_dtype, device)
    draw_ssm(w, seed, len(layout))
    return w
