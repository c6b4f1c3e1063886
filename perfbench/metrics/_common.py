"""What several readers share: model flops over a window and kernel rooflines."""

from __future__ import annotations

from typing import Dict, Iterable, Optional

from .. import work

BF16_PEAK = work.PEAK_FLOPS["bf16"]

FLASH_FWD = ("flash_fwd",)
FLASH_BWD = ("delta_kernel", "dkdv_", "dq_mma", "dq_kernel")


def kernel_seconds(trace: Dict, names: Iterable[str]) -> float:
    names = tuple(names)
    return sum(s for k, (s, _) in trace["kernels"].items() if any(n in k for n in names))


def op_calls(trace: Dict, op: str) -> int:
    return trace["ops"].get(f"repro_torch::{op}", 0)


def roofline(trace: Optional[Dict], parts) -> Optional[float]:
    """Percent of the kernels' bound reached: sum of bound seconds over the
    calls the profiler counted, over the device seconds of their kernels.
    ``parts``: (operator, kernel name parts, bound seconds of one call)."""
    if not trace:
        return None
    bound = busy = 0.0
    for op, names, one in parts:
        bound += op_calls(trace, op) * one
        busy += kernel_seconds(trace, names)
    if bound == 0 or busy == 0:
        return None
    return 100.0 * bound / busy


def idle_share(trace: Optional[Dict]) -> Optional[float]:
    if not trace or trace["wall_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["wall_s"])
