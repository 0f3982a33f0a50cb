"""BN fusion accounting (the fused BN kernels, DESIGN.md §10): a
two-trace *comparison* report, not a single-step pass, so it is not in
the pass registry.

It counts the passes one BN site's forward + backward makes over its
activation: ``reduction_ops`` (a reduction over an activation-sized
input, or a launch of a statistics kernel: ``bn_stats``,
``bn_bwd_sums``) and ``activation_writes`` (a new activation-sized
buffer made by an op other than a convolution / matmul, or a launch of
an elementwise kernel: ``bn_apply``, ``bn_bwd_dx``). Convolutions and
matmuls are the useful compute, the same fused or not.
"""
from __future__ import annotations

import math
from typing import Dict

from repro_torch.analysis.op_trace import OpTrace
from repro_torch.analysis.passes.interleave import COMPUTE_OPS
from repro_torch.analysis.passes.precision import REDUCTIONS

REDUCTION_KERNELS = {"bn_stats", "bn_bwd_sums"}
WRITE_KERNELS = {"bn_apply", "bn_bwd_dx"}
# allocations write nothing
ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided"}


def bn_pass_counts(trace: OpTrace, act_elems: int) -> Dict[str, float]:
    reduction = writes = 0.0
    for op in trace.ops:
        if op.is_kernel:
            k = op.name[len("kernel."):]
            reduction += op.launches * (k in REDUCTION_KERNELS)
            writes += op.launches * (k in WRITE_KERNELS)
            continue
        big_in = any(math.prod(s) >= act_elems for s in op.in_shapes)
        if op.short in REDUCTIONS or op.short.startswith("sum") or \
                op.short in ("mean", "var_mean"):
            reduction += float(big_in)
            continue
        if op.short in COMPUTE_OPS or op.short in ALLOCATIONS or op.view \
                or op.owner != op.index:
            continue
        if any(math.prod(s) >= act_elems for s in op.out_shapes):
            writes += 1
    return {"reduction_ops": reduction, "activation_writes": writes}


def fusion_report(fused: OpTrace, unfused: OpTrace, act_elems: int,
                  n_sites: int = 1) -> Dict[str, object]:
    """Per-BN-site pass counts of the same forward + backward recorded
    fused and unfused: the fused path must make strictly fewer reduction
    passes and no more activation-sized writes."""
    f = bn_pass_counts(fused, act_elems)
    u = bn_pass_counts(unfused, act_elems)
    n = max(n_sites, 1)
    report: Dict[str, object] = {
        "act_elems": act_elems,
        "n_sites": n_sites,
        "fused": f,
        "unfused": u,
        "reduction_ops_per_site": {"fused": f["reduction_ops"] / n,
                                   "unfused": u["reduction_ops"] / n},
        "activation_writes_per_site": {
            "fused": f["activation_writes"] / n,
            "unfused": u["activation_writes"] / n},
        "reduction_collapse": f["reduction_ops"] < u["reduction_ops"],
        "elementwise_collapse":
            f["activation_writes"] <= u["activation_writes"],
    }
    report["collapsed"] = bool(report["reduction_collapse"]
                               and report["elementwise_collapse"])
    return report
