"""The numbers that decide ``correct``, each against its limit.

Training (the program's first three steps against the reference's, from
the same weights and batches):

* ``batch_tokens_wrong``: token ids of the three steps' batches, as the
  trainer read them back from the volume, that differ from the tokens the
  benchmark wrote (an exact comparison: limit 0);
* ``loss_gap``: the largest of the three steps' |loss - reference| / reference;
* ``grad_norm_gap``: the same for the gradients' global norm before clipping;
* ``grad_gap``: the first step's gradient as the optimizer got it (its first
  moment after one step over 1 - b1), by the worst leaf: |norm - reference
  norm| over the larger of that leaf's reference norm and the median leaf's;
* ``change_gap``: the same for each leaf's change over the three steps
  (the master weights, where there are, less the initial weights), leaving
  out the leaves whose first reference gradient is under a thousandth of the
  median leaf's (they move by round-off alone).

Serving: ``logit_gap``, the widest gap by which a served token's logit lies
below the reference's best at its position, over a sample of the finished
requests drawn from the seed with the longest among them.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence


def rel_gap(got: Sequence[float], want: Sequence[float]) -> float:
    return max(abs(g - w) / abs(w) for g, w in zip(got, want))


def leaf_gap(got: Dict, want: Dict, keep=None) -> float:
    """The worst leaf's |got - want| over max(want, the median leaf's want)."""
    med = statistics.median(want.values())
    keys = [k for k in want if keep is None or k in keep]
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in keys)


def moved_leaves(first_grad: Dict) -> List:
    """Leaves whose first reference gradient is at least a thousandth of the median leaf's."""
    med = statistics.median(first_grad.values())
    return [k for k, v in first_grad.items() if v >= 1e-3 * med]


def train_numbers(prog: Dict, ref: Dict, change_ref: Dict) -> Dict[str, float]:
    keep = moved_leaves(ref["first_grad"])
    return {"batch_tokens_wrong": prog["batch_tokens_wrong"],
            "loss_gap": rel_gap(prog["loss"], ref["loss"]),
            "grad_norm_gap": rel_gap(prog["grad_norm"], ref["grad_norm"]),
            "grad_gap": leaf_gap(prog["first_grad"], ref["first_grad"]),
            "change_gap": leaf_gap(prog["change"], change_ref, keep)}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """{name: {"value", "limit"}} for every number, and whether all are within."""
    missing = set(limits) - set(numbers)
    checks = {k: {"value": numbers.get(k), "limit": limits[k]} for k in limits}
    ok = not missing and all(numbers[k] <= limits[k] for k in limits)
    return {"correct": bool(ok), "checks": checks}
