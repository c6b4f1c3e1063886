"""Arithmetic of the readers: percentiles over all samples, rates over windows."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile of every sample (linear between order statistics)."""
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def serve_step_ends(wave: Dict) -> List[float]:
    """The ends of a wave's steps: the entry of each call into the model after
    the first (the server reads each step's tokens before the next call),
    and the return of ``serve``."""
    return wave["entries"][1:] + [wave["end"]]


def token_gaps(record: Dict) -> List[float]:
    """Every gap between consecutive output tokens of a wave, in seconds."""
    out = []
    for w in record["waves"]:
        ends = serve_step_ends(w)
        out += [b - a for a, b in zip(ends, ends[1:])]
    return out


def tokens_after(record: Dict, t0: float) -> int:
    """Output tokens of real requests whose step ended after ``t0``: step j
    of a wave (the prefill is step 0) gives a token to each request that
    asked for more than j."""
    return sum(sum(n > j for n in w["new"]) for w in record["waves"]
               for j, e in enumerate(serve_step_ends(w)) if e > t0)
