"""Collective/compute interleaving (the backward-overlapped sync,
DESIGN.md §8) as the ``interleave`` audit pass.

The trace is in call order, so position is evidence: in the
non-overlapped step every gradient collective starts after the last
backward convolution or matmul; in the overlapped step each bucket's
collective starts as soon as its stage's backward is done, before
the next stage's backward compute.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.analysis.op_trace import OpTrace
from repro_torch.analysis.passes import AuditContext, PassResult, register_pass

# the backward's compute: convolutions and matrix products
COMPUTE_OPS = {"convolution", "convolution_backward", "_convolution",
               "cudnn_convolution", "mm", "addmm", "bmm", "baddbmm",
               "_scaled_mm"}


def interleave_report(trace: OpTrace,
                      min_collective_bytes: int = 512) -> Dict[str, object]:
    """Whether the gradient collectives are interleaved with the backward
    compute or clustered at the tail.

    A step counts as ``interleaved`` when it has >= 2 qualifying
    (>= ``min_collective_bytes``) collectives, at least one backward
    convolution / matmul between the first and the last of them, and at
    least one after the first one: the first gradient collective is
    started before the last backward convolution or matmul. Tiny metric
    all-reduces fall under the byte floor. The fields are the JAX
    package's (``computation`` is the whole step here)."""
    coll_pos: List[int] = []
    weights: List[int] = []
    for i, op in enumerate(trace.ops):
        weights.append(int(op.backward and op.short in COMPUTE_OPS))
        if op.collective is not None and \
                op.coll_bytes >= min_collective_bytes:
            coll_pos.append(i)
    if not coll_pos:
        return {"n_collectives": 0, "interleaved": False,
                "reason": "no qualifying collectives"}
    total = sum(weights)
    first, last = coll_pos[0], coll_pos[-1]
    after_first = sum(weights[first + 1:])
    between = sum(weights[first + 1:last])
    gaps_with_compute = sum(
        1 for lo, hi in zip(coll_pos, coll_pos[1:])
        if sum(weights[lo + 1:hi]) > 0)
    n = len(coll_pos)
    return {
        "computation": "step",
        "n_collectives": n,
        "compute_ops_total": total,
        "compute_ops_before_first": sum(weights[:first]),
        "compute_ops_after_first": after_first,
        "compute_ops_between_first_last": between,
        "gaps_with_compute": gaps_with_compute,
        "interleaved": n >= 2 and between >= 1 and after_first >= 1,
    }


@register_pass("interleave")
def interleave_pass(ctx: AuditContext) -> PassResult:
    """Summary = ``interleave_report``; when the audit sets
    ``expectations["require_interleaved"]`` a non-interleaved schedule
    is an error (the overlap modes' contract)."""
    res = PassResult(name="interleave")
    floor = int(ctx.expectations.get("min_collective_bytes", 512))
    rep = interleave_report(ctx.trace, min_collective_bytes=floor)
    res.summary.update(rep)
    if ctx.expectations.get("require_interleaved") and \
            not rep.get("interleaved"):
        res.add("error",
                "gradient collectives are clustered at the tail, not "
                "interleaved with backward compute",
                op=str(rep.get("computation", "")),
                n_collectives=rep.get("n_collectives", 0),
                compute_ops_between_first_last=rep.get(
                    "compute_ops_between_first_last", 0))
    return res
