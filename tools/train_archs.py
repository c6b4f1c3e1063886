"""chip_smoke.py's training phases for chosen attention archs, alone, on one card.

    python3 tools/train_archs.py                          # (f2) for every arch of F2_ARCHS
    python3 tools/train_archs.py phi3-medium-14b mixtral-8x22b --no-launchers

Builds the kernels, runs the bf16 K1-bwd cases of phase (c) at (f2)'s group sizes,
then phase (f2) (``chip_smoke.phase_f2``: the depth cut, TRAIN_STEPS steps, the
profiled step, phase (k)'s count and the kernel-vs-plain checks) for each arch named,
going on to the next where one fails, then phase (m) (both launchers for every
arch) unless ``--no-launchers``.  Every phase logs as in ``chip_smoke.py``; the last
line of stdout is one JSON object with each arch's layers, step ms, trained tok/s,
peak GB, the checks' largest errors and (k)'s shares, or the failure.  The quick way
to iterate on (f2) without the whole smoke run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def _summary(r: dict) -> dict:
    out = {k: r[k] for k in ("layers", "check_layers", "step_ms_steady", "trained_tok_s",
                             "peak_mem_gb", "phase_peak_mem_gb", "reckoned_gb",
                             "launches_per_step", "phase_s")}
    for key in ("consistency", "consistency_bf16"):
        c = r[key]
        out[key] = {k: c[k] for k in ("loss_err", "grad_err_max", "param_err_max",
                                      "argmax_rows_flipped_by_call")
                    if k in c}
        out[key]["noise_floor"] = c.get("plain_vs_half_chunk_grad_err_max")
    out["counts"] = {k: r["counts"][k] for k in ("measured_ms", "bound_ms", "roofline_share",
                                                 "mfu", "predicted_over_card_count")}
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("archs", nargs="*", default=list(cs.F2_ARCHS))
    ap.add_argument("--no-launchers", action="store_true")
    args = ap.parse_args()
    t0 = time.perf_counter()
    summary = {"device": cs.device_line()}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs._build.build_all(["flash_attention", "flash_attention_bwd", "checksum", *cs.SCAN_SOURCES])
    summary["flash_bwd"] = [cs.flash_bwd_case(1, 1024, 8, 6, 128, 0, 0, torch.bfloat16, 44),
                            cs.flash_bwd_case(1, 1100, 8, 8, 128, 0, 0, torch.bfloat16, 45)]
    for arch in args.archs:
        t1 = time.perf_counter()
        try:
            summary[arch] = _summary(cs.phase_f2(arch))
        except Exception:
            traceback.print_exc()
            summary[arch] = f"failed after {time.perf_counter() - t1:.1f} s"
        cs.free_device_memory()
    if not args.no_launchers:
        summary["launchers_wall_s"] = {a: r["wall_s"] for a, r in cs.phase_launchers().items()}
    summary["total_s"] = time.perf_counter() - t0
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
