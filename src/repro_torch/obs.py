"""The port's spans: named, nested stretches of host time at its layer boundaries.

    with obs.span("train.step"):
        ...

A span records its host start and end (``time.perf_counter_ns``) and the
span it ran inside (the innermost span open on its thread).  On exit it
adds its host time to its parent's ``child_ns``, so a span's self time
is its own time less its children's, and goes into one bounded ring a
process (:data:`RING` spans, the oldest dropped first), which
:func:`spans` reads and :func:`reset` clears.

The host clock is always on.  Only while a ``torch.profiler`` session is
on does a span also enter ``torch.profiler.record_function`` (so it lies
on the profiler's clock and in its events) and, where CUDA is initialised,
record a ``torch.cuda.Event`` pair on the current stream, whose device
time :func:`spans` resolves after one synchronise.  ``profiled`` says that
a session was on at the span's entry or exit, or at one of its
children's.  Without streams (on the CPU) a span's device time is its host
time.  With the profiler off a span makes no device call.
"""

from __future__ import annotations

import collections
import threading
from time import perf_counter_ns
from typing import Deque, List, Optional

import torch

__all__ = ["RING", "Span", "span", "spans", "reset"]

RING = 65_536
_ring: Deque["Span"] = collections.deque(maxlen=RING)
_profiling = torch.autograd._profiler_enabled


class _Open(threading.local):
    def __init__(self):
        self.stack: List["Span"] = []


_open = _Open()


class Span:
    """One span, and the context manager that records it."""

    __slots__ = ("name", "parent", "start_ns", "end_ns", "child_ns", "profiled",
                 "_rf", "_events", "_device_ns")

    def __init__(self, name: str):
        self.name = name
        self.parent: Optional[Span] = None
        self.start_ns = self.end_ns = self.child_ns = 0
        self.profiled = False
        self._rf = self._events = self._device_ns = None

    def __enter__(self) -> "Span":
        stack = _open.stack
        if stack:
            self.parent = stack[-1]
        stack.append(self)
        if _profiling():
            self.profiled = True
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
            if torch.cuda.is_initialized():
                self._events = (torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True))
                self._events[0].record()
        self.start_ns = perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = perf_counter_ns()
        if self._events is not None:
            self._events[1].record()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        if _profiling():
            self.profiled = True
        _open.stack.pop()
        parent = self.parent
        if parent is not None:
            parent.child_ns += self.end_ns - self.start_ns
            parent.profiled = parent.profiled or self.profiled
        _ring.append(self)
        return False

    @property
    def host_ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def self_ns(self) -> int:
        """Host time outside the span's children."""
        return self.host_ns - self.child_ns

    @property
    def device_ns(self) -> int:
        """Time on the device's stream between the span's entry and exit, where
        its events were recorded (read through :func:`spans`); else its host time."""
        return self.host_ns if self._device_ns is None else self._device_ns


span = Span


def spans() -> List[Span]:
    """The ring's spans, oldest first, their device times resolved."""
    pending = [s for s in _ring if s._events is not None]
    if pending:
        torch.cuda.synchronize()
        for s in pending:
            start, end = s._events
            s._device_ns = round(start.elapsed_time(end) * 1e6)
            s._events = None
    return list(_ring)


def reset() -> None:
    _ring.clear()
