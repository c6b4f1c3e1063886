"""Where a decode step's host time goes: issuing work, or waiting on the device.

    PYTHONPATH=src python3 tools/decode_diag.py [--arch minicpm-2b] [--batch 32]
        [--prompt 512 2048] [--steps 24] [--sleep-ms 400] [--reduced] [--out FILE]

Serves waves of ``--batch`` requests through ``BatchServer`` (weights from
the model's ``init`` in bf16; prompt lengths spread over ``--prompt``;
every request asks for ``--steps`` + 1 tokens) and reads each decode step's
spans (``repro_torch.obs``): ``serve.decode`` less its ``serve.tokens``
child is the host's time in the step before it waits for the tokens.
Five readings, one JSON line (and ``--out``):

* ``steady``: the spans of a wave served back to back, as in the benchmark.
* ``behind_sleep``: the same steps, each issued behind a spin kernel of
  ``--sleep-ms`` (``torch.cuda._sleep``), so the device completes nothing
  while the host issues the step.  A step that issues in far less than the
  sleep never waits on the device while issuing: its time is the host's own
  work.  One that takes about the sleep waits on the device somewhere (a
  full launch queue, a copy that synchronises).
* ``host_bound``: a wave of one request with a short prompt, whose decode
  steps launch the same kernels with little work in each, so the device
  keeps up with the host: a step's time outside its wait for the tokens is
  then the host's own cost of issuing it.
* ``sync_ops``: the lines of the program that synchronise with the device
  in one decode step (``torch.cuda.set_sync_debug_mode``), the step's own
  ``.tolist()`` included.
* ``profile``: a few steps under ``torch.profiler`` with Python stacks: each
  ``cudaMemcpyAsync`` by the op and the program line that issued it, with
  its host microseconds, the device's copies by kind (pageable or pinned,
  host or device), and the host time of the kernel launches that took over
  100 us (a launch that waits for room in the queue).

On a machine without CUDA (``--reduced``, for a check of the script) the
sleep and the sync readings are left out and the profile reads the CPU.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import statistics
import subprocess
import traceback
import warnings

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import get_arch
from repro_torch.models import get_model
from repro_torch.serve.server import BatchServer, Request


def step_readings(spans):
    """Mean host, self and tokens ms of the unprofiled ``serve.decode`` spans."""
    steps = [s for s in spans if s.name == "serve.decode" and not s.profiled]
    if not steps:
        return None
    return {"n": len(steps),
            "host_ms": statistics.mean(s.host_ns for s in steps) / 1e6,
            "self_ms": statistics.mean(s.self_ns for s in steps) / 1e6,
            "tokens_ms": statistics.mean(s.host_ns - s.self_ns for s in steps) / 1e6,
            "self_ms_each": [round(s.self_ns / 1e6, 3) for s in steps]}


def program_line(stack) -> str:
    """The innermost frame of the port in a profiler event's Python stack."""
    for frame in stack or ():
        if "repro_torch" in frame:
            return frame.split("repro_torch/")[-1]
    return "(outside the port)"


def with_stack(ev):
    """The event, or its nearest ancestor that has a Python stack."""
    while ev is not None and not ev.stack:
        ev = ev.cpu_parent
    return ev


def op_chain(ev, depth=3) -> str:
    names = []
    ev = ev.cpu_parent
    while ev is not None and len(names) < depth:
        if not ev.name.startswith(("serve.", "pb:")):
            names.append(ev.name)
        ev = ev.cpu_parent
    return " < ".join(names)


def profile_readings(prof, n_steps: int):
    events = prof.events()
    memcpy = collections.defaultdict(lambda: [0, 0.0])
    launches_long = [0, 0.0]
    launches = [0, 0.0]
    for ev in events:
        if ev.name == "cudaMemcpyAsync":
            src = with_stack(ev)
            key = f"{op_chain(ev)} @ {program_line(src.stack if src else None)}"
            memcpy[key][0] += 1
            memcpy[key][1] += ev.cpu_time_total
        elif ev.name == "cudaLaunchKernel":
            launches[0] += 1
            launches[1] += ev.cpu_time_total
            if ev.cpu_time_total > 100:
                launches_long[0] += 1
                launches_long[1] += ev.cpu_time_total
    device_copies = collections.defaultdict(lambda: [0, 0.0])
    for ev in events:
        for k in ev.kernels:
            if k.name.startswith("Memcpy") or k.name.startswith("Memset"):
                device_copies[f"{k.name} by {ev.name}"][0] += 1
                device_copies[f"{k.name} by {ev.name}"][1] += k.duration
    per = 1.0 / n_steps
    return {
        "steps": n_steps,
        "memcpy_per_step": {k: {"calls": c * per, "host_us": t * per}
                            for k, (c, t) in sorted(memcpy.items(), key=lambda kv: -kv[1][1])},
        "device_copies_per_step": {k: {"n": c * per, "device_us": t * per}
                                   for k, (c, t) in device_copies.items()},
        "launches_per_step": {"calls": launches[0] * per, "host_us": launches[1] * per,
                              "over_100us": launches_long[0] * per,
                              "over_100us_host_us": launches_long[1] * per},
    }


class Hooks:
    """Wraps the server's ``api.decode``: a spin kernel before chosen steps,
    a profiler over others, a sync check over one."""

    def __init__(self, api, cuda: bool):
        self.api, self.cuda = api, cuda
        self.n = 0
        self.sleep_cycles = 0
        self.sleep_steps = set()
        self.profile_steps = range(0)
        self.sync_step = None
        self.prof = None
        self.sync_ops = None

    def decode(self, *a, **k):
        self.n += 1
        if self.n in self.sleep_steps:
            torch.cuda._sleep(self.sleep_cycles)
        if self.n == self.profile_steps.start and self.prof is None:
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
            self.prof = profile(activities=acts, with_stack=True)
            self.prof.start()
        if self.n == self.sync_step:
            torch.cuda.synchronize()
            lines = collections.Counter()

            def note(*_args, **_kw):
                frames = traceback.extract_stack()[:-1]
                mine = [f for f in frames if "repro_torch" in f.filename or f.filename == __file__]
                at = mine[-1] if mine else frames[-1]
                lines[f"{at.filename.rsplit('/', 1)[-1]}:{at.lineno} {at.line}"] += 1

            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = note
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = self.api.decode(*a, **k)
                    out[0][:, -1, :1].argmax(-1).tolist()    # the step's own read
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            self.sync_ops = dict(lines)
            return out
        out = self.api.decode(*a, **k)
        if self.prof is not None and self.n == self.profile_steps.stop - 1:
            if self.cuda:
                torch.cuda.synchronize()
            self.prof.stop()
        return out


def spin_cycles_per_ms() -> float:
    """Cycles of ``torch.cuda._sleep`` a device millisecond."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cycles = 50_000_000
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    return cycles / start.elapsed_time(end)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--prompt", type=int, nargs=2, default=[512, 2048])
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--sleep-ms", type=float, default=400.0)
    ap.add_argument("--reduced", action="store_true", help="the arch's reduced config")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    cuda = torch.cuda.is_available()
    dev = "cuda" if cuda else "cpu"
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = get_model(cfg).init(0, torch.bfloat16, dev)
    smax = args.prompt[1] + args.steps + 1
    server = BatchServer(cfg, params, batch=args.batch, smax=smax, device=dev)
    hooks = Hooks(server.api, cuda)
    server.api = dataclasses.replace(server.api, decode=hooks.decode)
    rng = np.random.default_rng(0)
    lens = np.linspace(args.prompt[0], args.prompt[1], args.batch).astype(int)

    def wave(new):
        return [Request(i, rng.integers(0, cfg.vocab, int(n)).tolist(), new)
                for i, n in enumerate(lens)]

    out = {"device": torch.cuda.get_device_name(0) if cuda else "cpu",
           "arch": cfg.name, "batch": args.batch, "prompt": args.prompt, "steps": args.steps}
    server.serve(wave(3))                                     # warm-up
    S = args.steps

    obs.reset()
    hooks.n = 0
    server.serve(wave(S + 1))
    out["steady"] = step_readings(obs.spans())

    if cuda:
        out["sleep_ms"] = args.sleep_ms
        hooks.sleep_cycles = int(spin_cycles_per_ms() * args.sleep_ms)
        hooks.n = 0
        hooks.sleep_steps = set(range(2, S + 1, 2))       # every other step, behind a spin
        obs.reset()
        server.serve(wave(S + 1))
        spans = [s for s in obs.spans() if s.name == "serve.decode"]
        behind = [s for i, s in enumerate(spans, 1) if i in hooks.sleep_steps]
        out["behind_sleep"] = step_readings(behind)
        hooks.sleep_steps = set()

        hooks.n = 0
        hooks.sync_step = 3
        server.serve(wave(5))
        out["sync_ops"] = hooks.sync_ops
        hooks.sync_step = None

    small = BatchServer(cfg, params, batch=1, smax=64 + S + 1, device=dev)
    small.serve([Request(0, list(range(1, 65)), 3)])            # warm-up
    obs.reset()
    small.serve([Request(0, list(range(1, 65)), S + 1)])
    out["host_bound"] = step_readings(obs.spans())

    hooks.n = 0
    n_prof = 4
    hooks.profile_steps = range(3, 3 + n_prof)
    server.serve(wave(3 + n_prof + 2))
    out["profile"] = profile_readings(hooks.prof, n_prof)
    if cuda:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        out["power_limit"] = smi.stdout.strip()
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
