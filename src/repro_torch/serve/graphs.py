"""A decode step's segments as CUDA graphs, captured once a wave and replayed.

A model marks a part of its decode step as a segment, ``segment(key, fn, *inputs)``:
a function of tensors whose launches take nothing that changes from step to step of
a wave (a state it updates, it updates in place; whatever takes the step's position
runs between segments).  Outside ``StepGraphs.on()`` a segment is ``fn(*inputs)``.

``BatchServer`` keeps one ``StepGraphs`` on the card and turns it on for every
decode step of a wave but the first, whose launches warm what a capture records
(libraries, scratch).  The second step captures each segment, on one capture stream
and into one memory pool a wave (so a wave's graphs replay in the order they were
captured); every later step copies a segment's inputs into the buffers it was
captured with (an input that is another segment's output is read in place) and
replays it.  ``reset`` drops the wave's graphs.  A capture runs nothing, so it takes
back the launches the kernel wrappers counted in it and each replay adds them again:
the wrappers' ``launches`` count what ran.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch

from ..kernels.checksum import checksum
from ..kernels.decode_attention import decode_attention
from ..kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
from ..kernels.mamba2_ssd import ssd_bwd, ssd_fwd
from ..kernels.mamba2_step import mamba2_step
from ..kernels.rwkv6_scan import wkv6_bwd, wkv6_fwd

COUNTED = (flash_attention_fwd, flash_attention_bwd, checksum, ssd_fwd, ssd_bwd, wkv6_fwd,
           wkv6_bwd, decode_attention, mamba2_step)

_active: Optional["StepGraphs"] = None


class StepGraphs:
    """The captured segments of one wave on ``device``."""

    def __init__(self, device):
        self.stream = torch.cuda.Stream(device)
        self.reset()

    def reset(self) -> None:
        self.pool = None
        self.graphs: Dict[object, tuple] = {}
        self.outputs: Dict[int, torch.Tensor] = {}

    @contextlib.contextmanager
    def on(self):
        """For the block, every segment is captured or replayed here."""
        global _active
        saved, _active = _active, self
        try:
            yield
        finally:
            _active = saved

    def _capture(self, fn: Callable, inputs) -> tuple:
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        static = [x if id(x) in self.outputs else x.clone() for x in inputs]
        before = [w.launches for w in COUNTED]
        g = torch.cuda.CUDAGraph()
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream):
            g.capture_begin(pool=self.pool)
            out = fn(*static)
            g.capture_end()
        torch.cuda.current_stream().wait_stream(self.stream)
        counted = [(w, w.launches - n) for w, n in zip(COUNTED, before) if w.launches != n]
        for w, n in counted:
            w.launches -= n
        for y in (out if isinstance(out, tuple) else (out,)):
            self.outputs[id(y)] = y
        return g, static, out, counted

    def run(self, key, fn: Callable, inputs):
        if key not in self.graphs:
            self.graphs[key] = self._capture(fn, inputs)
        g, static, out, counted = self.graphs[key]
        for buf, x in zip(static, inputs):
            if buf is not x:
                buf.copy_(x)
        g.replay()
        for w, n in counted:
            w.launches += n
        return out


def segment(key, fn: Callable, *inputs):
    """``fn(*inputs)``, or, inside ``StepGraphs.on()``, the graph ``key`` of that
    ``StepGraphs``: captured the first time, then given its inputs and replayed."""
    if _active is None:
        return fn(*inputs)
    return _active.run(key, fn, inputs)
