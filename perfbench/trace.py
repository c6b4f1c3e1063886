"""The device trace of a traced run: ``torch.profiler`` over whole steps or waves.

``Tracer.start`` and ``stop`` are called where the device is idle (after a
step's or a wave's synchronising read); ``finish``, after the window,
reads the trace into a summary that holds:

* ``wall_s``: the host time between them, the traced window;
* ``busy_s``: the device time of every kernel, copy and fill in it;
* ``kernels``: {name: [device s, launches]} and ``ops``: {operator: calls}
  for the program's own operators (``repro_torch::*``);
* ``top``: the ten device operations that took longest, and ``gaps``: the
  ten longest stretches with nothing on the device, each named by what the
  host was doing then (the outermost benchmark span, ``pb:*``, and the
  innermost host operation around the gap's middle).

The profiler adds host time to every launch, so these numbers belong to
the traced run only.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

span = record_function      # a named host span: ``with span("pb:step"): ...``


class Tracer:
    def __init__(self):
        self.prof: Optional[profile] = None
        self.summary: Optional[Dict] = None
        self._t0 = self._wall = 0.0
        self._done = None

    @property
    def active(self) -> bool:
        return self.prof is not None

    def start(self) -> None:
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self._wall = time.perf_counter() - self._t0
        self.prof.stop()
        self._done, self.prof = self.prof, None

    def finish(self) -> Optional[Dict]:
        """The summary, read once the window has closed (reading it takes host time)."""
        if self.summary is None and self._done is not None:
            self.summary = summarize(self._done, self._wall)
            self._done = None
        return self.summary


def _is_device(e) -> bool:
    return e.device_type == DeviceType.CUDA


def summarize(prof, wall_s: float) -> Dict:
    """A host span also shows on the device's timeline (as a user annotation
    of the same name): device rows whose name a host row has are no work."""
    kernels: Dict[str, List[float]] = {}
    ops: Dict[str, int] = {}
    rows = prof.key_averages()
    host = {e.key for e in rows if not _is_device(e)}
    for e in rows:
        if _is_device(e) and e.self_device_time_total > 0 and e.key not in host:
            kernels[e.key] = [e.self_device_time_total / 1e6, e.count]
        elif e.key.startswith("repro_torch::"):
            ops[e.key] = e.count
    busy = sum(s for s, _ in kernels.values())
    top = sorted(([k[:120], s] for k, (s, _) in kernels.items()), key=lambda r: -r[1])[:10]
    return {"wall_s": wall_s, "busy_s": busy, "kernels": kernels, "ops": ops,
            "top": top, "gaps": _idle_gaps(prof.events())}


def _idle_gaps(events, n: int = 10) -> List[list]:
    dev, host = [], []
    for e in events:
        tr = e.time_range
        (dev if _is_device(e) else host).append((tr.start, tr.end, e.name))
    names = {name for _, _, name in host}
    dev = [d for d in dev if d[2] not in names]
    if not dev or not host:
        return []
    dev.sort()
    lo = min(s for s, _, _ in host)
    hi = max(t for _, t, _ in host)
    gaps, end = [], lo
    for s, t, _ in dev:
        if s > end:
            gaps.append((end, s))
        end = max(end, t)
    if hi > end:
        gaps.append((end, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, t in gaps[:n]:
        mid = (s + t) / 2
        around = [(b - a, a, name) for a, b, name in host if a <= mid <= b]
        spans = sorted((a, name) for _, a, name in around if name.startswith("pb:"))
        inner = min(around)[2] if around else "nothing traced"
        label = f"{spans[0][1]} > {inner}" if spans and spans[0][1] != inner else inner
        out.append([label[:120], (t - s) / 1e6])
    return out
