"""What decides ``correct``: the program's readings of its first training
steps against the reference's, as numbers each held to its own limit
(``checks/<cell>.json``, with the readings each limit was set from).

Every gap of norms is taken leaf by leaf and the worst leaf kept: the
distance between the program's norm and the reference's, over the
reference's norm of that leaf or of the median leaf, whichever is
larger. ``change_gap`` and ``delta_gap`` leave out the leaves whose
reference gradient is under a thousandth of the median leaf's: under
Adam-like steps such a leaf moves by round-off alone.
"""
from __future__ import annotations

import json
import math
import os
import statistics
from typing import Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a leaf whose first reference gradient is under this share of the
# median leaf's is left out of the change and Delta gaps
QUIET_LEAF = 1e-3


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   names: Optional[List[str]] = None) -> Tuple[float, str]:
    names = list(ref) if names is None else names
    median = statistics.median(ref[k] for k in ref)
    worst, which = 0.0, ""
    for k in names:
        denom = max(ref[k], median)
        gap = abs(prog[k] - ref[k]) / denom if denom > 0 else (
            0.0 if prog[k] == ref[k] else math.inf)
        if math.isnan(gap):  # a NaN reads as the widest gap
            gap = math.inf
        if gap > worst:
            worst, which = gap, k
    return worst, which


def moving_leaves(ref_grad1: Dict[str, float]) -> List[str]:
    median = statistics.median(ref_grad1.values())
    return [k for k, v in ref_grad1.items() if v >= QUIET_LEAF * median]


def median_leaf_gap(prog: Dict[str, float], ref: Dict[str, float]
                    ) -> Tuple[float, str]:
    """The median over the leaves of ``worst_leaf_gap``'s per-leaf gap."""
    median = statistics.median(ref[k] for k in ref)
    gaps = []
    for k in ref:
        gap = abs(prog[k] - ref[k]) / max(ref[k], median)
        gaps.append(math.inf if math.isnan(gap) else gap)
    return statistics.median(gaps), f"{len(gaps)} leaves"


def loss_gaps(prog: Dict, ref: Dict) -> List[float]:
    out = [abs(a - b) / abs(b) if b else math.inf
           for a, b in zip(prog["losses"], ref["losses"])]
    return [math.inf if math.isnan(v) else v for v in out]


def numbers(prog: Dict, ref: Dict) -> Dict[str, Tuple[float, str]]:
    """Every number read, as (value, where it was worst): the relative
    gap of the first step's loss and the worst over the checked steps;
    the worst and the median leaf's gap of the first gradient; the worst
    leaf's gap of the change after the checked steps and of Delta then;
    and with BN, the worst gap of its first step's batch statistics."""
    losses = loss_gaps(prog, ref)
    worst_step = max(range(len(losses)), key=losses.__getitem__)
    moving = moving_leaves(ref["grad1"])
    out = {"loss1_gap": (losses[0], "step 1"),
           "loss_gap": (losses[worst_step], f"step {worst_step + 1}"),
           "grad_gap": worst_leaf_gap(prog["grad1"], ref["grad1"]),
           "grad_median": median_leaf_gap(prog["grad1"], ref["grad1"]),
           "change_gap": worst_leaf_gap(prog["change"], ref["change"],
                                        moving),
           "delta_gap": worst_leaf_gap(prog["delta"], ref["delta"], moving)}
    if ref.get("bn"):
        out["bn_gap"] = worst_leaf_gap(prog["bn"], ref["bn"])
    return out


def load_limits(cell: str) -> Dict[str, float]:
    """``{number: limit}`` of a cell; a number without a limit is read
    and printed but decides nothing."""
    path = os.path.join(HERE, "checks", f"{cell}.json")
    with open(path) as f:
        spec = json.load(f)
    return {k: v["limit"] for k, v in spec["numbers"].items()
            if v.get("limit") is not None}


def verdict(nums: Dict[str, Tuple[float, str]], limits: Dict[str, float]
            ) -> bool:
    return all(nums[k][0] <= lim for k, lim in limits.items())
