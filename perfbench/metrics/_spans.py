"""What the readers of the program's own spans (``repro_torch.obs``) share.

A run's window is what follows set-up: the spans that start at or after
``ctx.t_start + record["setup_s"]`` (set-up's warm-up, checked steps and
warm-up wave come before it).  Where the program records no spans (a
checkout without ``repro_torch.obs``), each reader returns None and its
metric is left out of the result.
"""

from __future__ import annotations

from typing import List, Optional


def window(record, ctx) -> Optional[List]:
    """The program's spans that start in the run's window, oldest first."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    t0 = (ctx.t_start + record["setup_s"]) * 1e9
    return [s for s in obs.spans() if s.start_ns >= t0]


def step_share(record, ctx, part: str) -> Optional[float]:
    """Percent of the profiled window steps' device time (``train.step``) in
    their ``part`` spans (CUDA events on the card; the host clock without one)."""
    spans = window(record, ctx)
    if spans is None:
        return None
    steps = {s for s in spans if s.name == "train.step" and s.profiled}
    whole = sum(s.device_ns for s in steps)
    if whole <= 0:
        return None
    return 100.0 * sum(s.device_ns for s in spans if s.name == part and s.parent in steps) / whole
