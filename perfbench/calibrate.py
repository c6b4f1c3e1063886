"""The readings that a cell's limits are set from, many seeds in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 --seconds <s> [--out FILE]

For each seed it runs the cell's driver as a run does (set-up, a window of
``--seconds``: 0 for a training cell, whose readings need none, and for a
serving cell long enough to finish its longest wave) and prints one JSON
line: the program's numbers (``program``), and on the control seeds the
control's (the reference in fp8 in the program's place, ``control``) and,
in a training cell, the fault of half the batch left out, the mean taken
over the rest (``half_batch``).  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench.run import new_ctx, setup
    _, found = setup(args.workload)

    import torch

    driver = importlib.import_module(f"perfbench.drivers.{found['cell']['driver']}")
    control = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        ctx = new_ctx(found, args.workload, seed, args.seconds, False, time.perf_counter())
        if seed in control:
            ctx.extra_readings["control"] = driver.control_readings
            if hasattr(driver, "half_batch_readings"):
                ctx.extra_readings["half_batch"] = driver.half_batch_readings
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        record = driver.run(ctx)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "readings": record["readings"], "setup_s": record["setup_s"],
                           "memory_peak_bytes": record["memory_peak_bytes"],
                           "attempted": record["attempted"], "failed": record["failed"],
                           "check_s": record["check_s"],
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del record, ctx
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
