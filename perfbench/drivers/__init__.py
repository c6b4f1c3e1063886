"""Drivers, one per kind of entry point: ``train`` (``Trainer.train``) and
``serve`` (``BatchServer.serve``).  A cell names its driver in its file;
a new cell of an existing kind is data only.

``run(ctx)`` builds the program from the cell's configuration and traffic,
warms it up, measures a window of ``ctx.seconds``, reads the device's peak
memory, frees the program and holds what the window produced to the
reference.  It returns the run's record, from which the metric readers
take their numbers.
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import torch


def param_dtype(ctx) -> torch.dtype:
    """The type the configuration serves or trains its weights in."""
    return getattr(torch, ctx.config["param_dtype"])


class GcClock:
    """The host's time in Python's cyclic garbage collector, from ``open``
    (set-up's objects collected, then frozen, so the window's collections
    scan only what the window made) to ``close`` (unfrozen again, so the
    program's objects can be freed before the check)."""

    def __init__(self):
        self.seconds = 0.0
        self.runs = 0
        self._t = None

    def _note(self, phase: str, info: Dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t
            self.runs += 1
            self._t = None

    def open(self) -> "GcClock":
        gc.collect()
        gc.freeze()
        gc.callbacks.append(self._note)
        return self

    def close(self) -> Dict:
        gc.callbacks.remove(self._note)
        gc.unfreeze()
        return {"gc_s": self.seconds, "gc_runs": self.runs}
