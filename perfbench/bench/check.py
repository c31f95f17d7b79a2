"""The comparison that decides ``correct`` for a training cell.

The program's readings are taken in set-up, from the object the window
then drives; the reference's after the window, from the same seed, the
same carried residual and the same round's batch.  The numbers, each
compared where ``perfbench/limits/<cell>.json`` gives it a limit:

  loss_gap    the relative gap of the checked round's mean loss
  grad_gap    the worst leaf's gap between the program's and the
              reference's norm of the first step's gradient (all learners,
              as the optimizer gets it)
  change_gap  the worst leaf's gap between the two norms of the
              parameters' change over the checked round
  change_median  the same, of the median leaf
  ef_gap      the worst unit's gap between the two norms of the error
              feedback's residual after the checked round (top-k levels;
              a leaf, or a bucket under bucketing)
  ref_gap     the same, of the change of the error feedback's reference

A leaf's gap is |program - reference| over the larger of the reference's
norm of that leaf and of the median leaf.  Leaves whose reference
gradient norm is under a thousandth of the median leaf's are left out of
both leaf numbers: rounding alone moves them.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

SILENT = 1e-3


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep: List[str]) -> Tuple[float, str]:
    """(worst gap, its leaf) over the leaves ``keep``."""
    floor = statistics.median(ref[k] for k in keep)
    worst, at = 0.0, ""
    for k in keep:
        gap = abs(prog[k] - ref[k]) / max(ref[k], floor)
        if gap > worst or not at:
            worst, at = gap, k
    return worst, at


def numbers(prog: Dict, ref: Dict) -> Dict[str, Dict]:
    """Each compared number from the two sides' readings: ``loss``,
    ``grad_norms`` and ``change_norms`` ({leaf: norm}), ``ef_norms`` and
    ``ref_norms`` ({unit: norm})."""
    med = statistics.median(ref["grad_norms"].values())
    keep = [k for k, v in ref["grad_norms"].items() if v >= SILENT * med]
    grad, grad_at = leaf_gap(prog["grad_norms"], ref["grad_norms"], keep)
    change, change_at = leaf_gap(prog["change_norms"], ref["change_norms"],
                                 keep)
    out = {"loss_gap": {"value": abs(prog["loss"] - ref["loss"])
                        / abs(ref["loss"])},
           "grad_gap": {"value": grad, "leaf": grad_at},
           "change_gap": {"value": change, "leaf": change_at},
           "change_median": {"value": median_gap(
               prog["change_norms"], ref["change_norms"], keep)},
           "left_out": len(ref["grad_norms"]) - len(keep)}
    for key, name in (("ef_norms", "ef_gap"), ("ref_norms", "ref_gap")):
        if not ref.get(key):
            continue
        if sorted(prog[key]) != sorted(ref[key]):
            raise ValueError(f"error-feedback units differ: program "
                             f"{len(prog[key])}, reference {len(ref[key])}")
        gap, at = leaf_gap(prog[key], ref[key], list(ref[key]))
        out[name] = {"value": gap, "unit": at}
    return out


def median_gap(prog: Dict[str, float], ref: Dict[str, float],
               keep: List[str]) -> float:
    """The median leaf's gap (same measure as :func:`leaf_gap`)."""
    floor = statistics.median(ref[k] for k in keep)
    return statistics.median(abs(prog[k] - ref[k]) / max(ref[k], floor)
                             for k in keep)


def judge(nums: Dict, limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = nums[name]["value"]
        good = v == v and v <= limit         # a NaN fails
        ok = ok and good
        out[name] = {"value": v, "limit": limit}
    return ok, out
