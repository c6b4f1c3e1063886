"""Host-side A/B of the port's train steps between two source trees, on one card.

    python tools/train_step_ab.py --tree parent=build/parent/src --tree change=src \\
        --runs parent,change,change+k,parent,change,parent --out results/train_step_ab.jsonl

Each run is a fresh process (``--worker``) that imports ``repro_torch`` from
its tree, joins a world of one NCCL rank (as ``chip_smoke.py`` does) and
times the train steps of ``--models`` (both by default), one after the other:

  * ``rwkv6``: rwkv6-1.6b at full width and depth, B=2, T=2048 (phase (i));
  * ``mesh``: minicpm-2b cut to 4 layers, DTensor params and ZeRO-1 state on
    a 1 x 1 mesh (phase (j1)).

A run named ``<tree>+k`` first counts one step of each as phase (k) of
``chip_smoke.py`` does (``roofline.Count`` on the card, then the dry run's
lowering on fake tensors), so that what the counts leave in the process is
in the timed steps.  For every step: wall ms (synchronised), the process's
CPU ms (every thread: the backward runs on autograd's device thread), ms in
Python's garbage collector (the CPU clock ticks in 10 ms steps on some
machines: read its mean over the steps); for the steps, the collections by
generation and the objects the collector tracked before them (a bigger
heap costs every collection more); then one step under
torch.profiler for device-busy ms and the host's costliest operators.  The
runs alternate as ``--runs`` lists them, so drift in the host falls on both
trees.  Every record goes to ``--out``; the summary (the median of each
run's median step, by tree and model) is the last line of stdout.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

MODELS = ("rwkv6", "mesh")
B, T = 2, 2048
SOURCES = ("flash_attention", "flash_attention_bwd", "checksum", "rwkv6_scan",
           "mamba2_ssd", "rwkv6_scan_bwd", "mamba2_ssd_bwd")


class HostClock:
    """Wall, process-CPU and garbage-collector time of a block."""

    def __init__(self):
        self.gc_s, self.gc_full, self._t = 0.0, 0, None
        gc.callbacks.append(self._gc)

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc_s += time.perf_counter() - self._t
            self.gc_full += info["generation"] == 2

    def sample(self):
        return time.perf_counter(), time.process_time(), self.gc_s, self.gc_full

    @staticmethod
    def delta(a, b) -> dict:
        wall, cpu = b[0] - a[0], b[1] - a[1]
        return {"ms": wall * 1e3, "cpu_ms": cpu * 1e3, "gc_ms": (b[2] - a[2]) * 1e3,
                "gc_full": b[3] - a[3]}


def _batch(cfg, seed: int):
    import torch
    m = min(cfg.vocab, 97)
    gen = torch.Generator().manual_seed(seed)
    start = torch.randint(0, m, (B, 1), generator=gen)
    seq = ((start + 3 * torch.arange(T + 1)[None]) % m).to("cuda")
    return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}


def _setup(model: str):
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_model
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step
    if model == "rwkv6":
        cfg = get_arch("rwkv6-1.6b")
    else:
        cfg = dataclasses.replace(get_arch("minicpm-2b"), n_layers=4)
    oc = opt.opt_config_for(cfg, lr=1e-3, warmup_steps=2, total_steps=100)
    whole = get_model(cfg).init(0, torch.bfloat16, "cuda")
    if model == "rwkv6":
        params, state = whole, opt.init_opt_state(oc, whole)
    else:
        mesh = make_host_mesh(1, 1, "cuda")
        params = shd.distribute_tree(whole, shd.param_shardings(cfg, whole, mesh), mesh)
        state = opt.init_opt_state(oc, params, shd.opt_shardings(cfg, whole, mesh))
        del whole
    return cfg, make_train_step(cfg, oc), params, state


def _count(step, params, state, batch) -> None:
    """Phase (k)'s two counts of one step: on the card, then the dry run's lowering."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, roofline
    with roofline.Count("cuda"):
        step(params, state, batch)
    with FakeTensorMode(), ops.kernel_path(), roofline.Count("cpu"):
        step(*dryrun.fake_twin((params, state, batch), "cpu"))
    FakeTensorMode.cache_clear()


def _profile(step, params, state, batch) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = prof.key_averages()
    busy = sum(e.self_device_time_total for e in ev if e.device_type == DeviceType.CUDA) / 1e3
    host = sorted((e for e in ev if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    ops_rows = [{"op": e.key, "calls": e.count, "cpu_total_ms": e.cpu_time_total / 1e3}
                for e in ev if e.key.startswith("repro_torch::")]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "idle_share": 1 - busy / (wall * 1e3) if busy else None,
            "host_top": [{"op": e.key, "calls": e.count,
                          "self_cpu_ms": e.self_cpu_time_total / 1e3} for e in host[:8]],
            "kernel_operators": ops_rows}


def worker(args) -> None:
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clock = HostClock()
    rec = {"run": args.label, "src": args.src, "counts_first": args.counts_first,
           "nvidia_smi": args.smi, "models": {}}
    with tempfile.TemporaryDirectory() as rdv:
        init_process_group(str(Path(rdv) / "pg"), 0, 1, "nccl", 60)
        try:
            for model in args.models.split(","):
                cfg, step, params, state = _setup(model)
                batches = [_batch(cfg, 100 + i) for i in range(args.steps + 2)]
                for b in batches[:2]:                                   # warm-up
                    params, state, _ = step(params, state, b)
                if args.counts_first:
                    _count(step, params, state, batches[0])
                gc.collect()
                objects, before = len(gc.get_objects()), [g["collections"] for g in gc.get_stats()]
                steps = []
                for b in batches[2:]:
                    torch.cuda.synchronize()
                    a = clock.sample()
                    params, state, _ = step(params, state, b)
                    torch.cuda.synchronize()
                    steps.append(clock.delta(a, clock.sample()))
                rec["models"][model] = {
                    "arch": cfg.name, "layers": cfg.n_layers, "steps": steps,
                    "median_ms": statistics.median(s["ms"] for s in steps),
                    "mean_ms": statistics.mean(s["ms"] for s in steps),
                    "mean_cpu_ms": statistics.mean(s["cpu_ms"] for s in steps),
                    "gc_ms": sum(s["gc_ms"] for s in steps), "gc_tracked_objects": objects,
                    "gc_collections": [g["collections"] - n for g, n in
                                       zip(gc.get_stats(), before)],
                    "profile": _profile(step, params, state, batches[-1])}
                del params, state, step
                gc.collect()
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    print("AB " + json.dumps(rec), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[], help="NAME=SRC_DIR")
    ap.add_argument("--runs", default="", help="comma-separated NAME or NAME+k, in order")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--models", default=",".join(MODELS), help="of " + ", ".join(MODELS))
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--src"), ap.add_argument("--label")
    ap.add_argument("--counts-first", action="store_true")
    ap.add_argument("--smi", default="")
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args)

    trees = dict(t.split("=", 1) for t in args.tree)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    build = ("import sys; sys.path.insert(0, sys.argv[1]); from repro_torch.kernels "
             "import _build; _build.build_all(sys.argv[2:])")
    builds = [subprocess.Popen([sys.executable, "-c", build, src, *SOURCES])
              for src in trees.values()]
    if any(p.wait(timeout=600) for p in builds):
        raise SystemExit("a tree's kernels did not build")
    records = []
    for run in args.runs.split(","):
        name, _, k = run.partition("+")
        out = subprocess.run(
            [sys.executable, __file__, "--worker", "--src", trees[name], "--label", run,
             "--steps", str(args.steps), "--models", args.models, "--smi", smi,
             *(["--counts-first"] if k else [])],
            capture_output=True, text=True, timeout=600)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("AB ")]
        if out.returncode or not lines:
            raise SystemExit(f"run {run} failed ({out.returncode}):\n{out.stderr[-3000:]}")
        records.append(json.loads(lines[-1][3:]))
        r = records[-1]["models"]
        print(f"{run}: " + ", ".join(f"{m} {r[m]['median_ms']:.1f} ms (cpu "
                                     f"{r[m]['mean_cpu_ms']:.1f}, gc {r[m]['gc_ms']:.1f})"
                                     for m in r), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in records))
    summary = {}
    for run in dict.fromkeys(r["run"] for r in records):
        mine = [r for r in records if r["run"] == run]
        summary[run] = {m: {"run_medians_ms": [r["models"][m]["median_ms"] for r in mine],
                            "median_ms": statistics.median(r["models"][m]["median_ms"]
                                                           for r in mine),
                            "run_mean_cpu_ms": [r["models"][m]["mean_cpu_ms"] for r in mine]}
                        for m in mine[0]["models"]}
    print(smi)
    print(json.dumps({"summary": summary, "nvidia_smi": smi}))


if __name__ == "__main__":
    main()
