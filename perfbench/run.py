"""Run one cell of the benchmark once, on the card it is started on.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The run builds the measured program
(``repro_torch``, from ``src/``) at the cell's configuration, warms it up
at the cell's shapes, measures a window of ``--seconds``, and holds what
the window produced to the plain reference (``perfbench/reference``).
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a device trace of a stated part of the window.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown`` with
``--trace 1``), ``host`` (the window's time in Python's garbage
collector), then ``checks``: each number compared with its limit, which
are also the last lines of standard error.  Without a CUDA device, or
with fewer than the cell asks for, it prints no result and exits 2; it
exits 3, with no result, if JAX or the JAX package was loaded.  Kernel
libraries are built into ``build/`` inside the checkout, so only a
checkout's first run compiles.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Ctx:
    """What a driver and the readers are given."""

    def __init__(self, **kw):
        self.hooks = {}
        self.extra_readings = {}
        self.tracer = None
        self.trace = None
        self.reference = None
        self.__dict__.update(kw)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "not read"


def measure(ctx, bench: dict) -> dict:
    """Runs the cell's driver and reads its metrics; returns the result."""
    import importlib

    import torch

    from perfbench import check, manifest
    from perfbench.trace import Tracer

    driver = importlib.import_module(f"perfbench.drivers.{ctx.cell['driver']}")
    if ctx.traced:
        ctx.tracer = Tracer()
    record = driver.run(ctx)
    ctx.trace = ctx.tracer.finish() if ctx.tracer is not None else None
    metrics = {}
    for m in manifest.metrics_of(bench, ctx.name, ctx.traced):
        value = manifest.reader(m["name"])(record, ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    verdict = check.judge(record["numbers"], ctx.cell["limits"])
    dev = ctx.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
              "count": ctx.chips, "memory_peak_bytes": record["memory_peak_bytes"]}
    result = {"correct": verdict["correct"] and record["failed"] == 0,
              "attempted": record["attempted"], "failed": record["failed"],
              "metrics": metrics, "device": device}
    if ctx.trace is not None:
        device["busy_s"] = ctx.trace["busy_s"]
        device["window_s"] = ctx.trace["wall_s"]
        result["breakdown"] = {"device_ops": ctx.trace["top"], "idle_gaps": ctx.trace["gaps"]}
    result["host"] = record["host"]
    extra = {k: v for k, v in record["readings"].items() if k != "program"}
    if extra:
        result["readings"] = extra
    result["checks"] = verdict["checks"]
    return _finite(result)


def _finite(x):
    """``x`` with every infinite or NaN number as None, so the line is strict JSON."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def setup(workload: str):
    """A run's surroundings: the kernel caches inside the checkout, the
    checkout and its ``src/`` importable.  Returns BENCHMARK.json and the
    files of the cell ``workload``."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import manifest
    bench = manifest.load(ROOT)
    return bench, manifest.cell(bench, workload, ROOT)


def new_ctx(found: dict, workload: str, seed: int, seconds: float, traced: bool,
            t_start: float) -> Ctx:
    """The context of one run of the cell on the first CUDA device."""
    import torch
    torch.set_num_threads(4)
    return Ctx(name=workload, seed=seed, seconds=seconds, traced=traced,
               chips=found["entry"]["chips"], device=torch.device("cuda", 0), t_start=t_start,
               **{k: found[k] for k in ("cell", "config", "traffic")})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench, found = setup(args.workload)
    chips = found["entry"]["chips"]

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    ctx = new_ctx(found, args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    result = measure(ctx, bench)
    result["device"]["power_limit"] = power_limit()
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {bad}; the benchmark measures repro_torch alone",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
