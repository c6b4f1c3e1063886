"""The host cost of one span of ``repro_torch.obs``, with the profiler off and on.

    PYTHONPATH=src python3 tools/obs_cost.py [--spans 200000] [--profiled 20000]

Times spans with empty bodies, alone and as a parent with one child: with
no profiler session, then inside a ``torch.profiler`` session of the
benchmark's activities (CPU, and CUDA where there is a card, whose spans
then record a pair of CUDA events each); then the time ``obs.spans()``
takes a profiled span to resolve its device time.  Prints one JSON line,
in microseconds a span, with the device's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs


def per_span_us(n: int, nested: bool) -> float:
    obs.reset()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with obs.span("cost.outer"):
            if nested:
                with obs.span("cost.inner"):
                    pass
    return (time.perf_counter_ns() - t0) / (n * (2 if nested else 1)) / 1e3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spans", type=int, default=200_000)
    ap.add_argument("--profiled", type=int, default=20_000)
    args = ap.parse_args()
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU]
    if cuda:
        torch.zeros(1, device="cuda")       # initialised, as in a run on the card
        acts.append(ProfilerActivity.CUDA)
    out = {"device": torch.cuda.get_device_name(0) if cuda else "cpu",
           "off_us": {k: per_span_us(args.spans, k == "nested") for k in ("flat", "nested")}}
    out["on_us"] = {}
    for kind in ("flat", "nested"):
        with profile(activities=acts):
            out["on_us"][kind] = per_span_us(args.profiled, kind == "nested")
        t0 = time.perf_counter_ns()
        n = len(obs.spans())
        out.setdefault("resolve_us", {})[kind] = (time.perf_counter_ns() - t0) / n / 1e3
    if cuda:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        out["power_limit"] = smi.stdout.strip()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
