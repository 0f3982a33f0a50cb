"""Communication summary (bucketed sync verification, DESIGN.md §6) as
the ``comm`` audit pass."""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.analysis.cost import Analysis, gradient_sync_mode
from repro_torch.analysis.op_trace import OpTrace
from repro_torch.analysis.passes import AuditContext, PassResult, register_pass
from repro_torch.analysis.passes.interleave import interleave_report


def comm_report(a: Analysis, trace: Optional[OpTrace] = None,
                min_collective_bytes: int = 512) -> Dict[str, object]:
    """Communication summary of one recorded step: how many collectives
    it launches, how many wire bytes each moves, in which dtype, and (with
    ``trace``) whether they interleave with the backward
    (``interleave_report``)."""
    per_op = {}
    for op, execs in sorted(a.collective_exec_counts.items()):
        byts = a.collective_bytes.get(op, 0.0)
        per_op[op] = {
            "executions_per_step": round(execs, 2),
            "wire_bytes_per_device": byts,
            "bytes_per_collective": byts / execs if execs else 0.0,
            "max_bytes_per_collective": a.collective_max_exec_bytes.get(
                op, 0.0),
            "dtype_bytes": dict(a.collective_dtypes.get(op, {})),
        }
    total_execs = sum(a.collective_exec_counts.values())
    total_bytes = a.total_collective_bytes
    report: Dict[str, object] = {
        "per_op": per_op,
        "total_executions_per_step": round(total_execs, 2),
        "total_wire_bytes_per_device": total_bytes,
        "mean_bytes_per_collective": (total_bytes / total_execs
                                      if total_execs else 0.0),
        "gradient_sync": gradient_sync_mode(a),
    }
    if trace is not None:
        report["interleave"] = interleave_report(
            trace, min_collective_bytes=min_collective_bytes)
    return report


@register_pass("comm")
def comm_pass(ctx: AuditContext) -> PassResult:
    """Summary = ``comm_report`` (with the interleave section). Purely
    informational: the gating checks live in the ``collectives``
    schedule linter and the per-mode contracts."""
    res = PassResult(name="comm")
    floor = int(ctx.expectations.get("min_collective_bytes", 512))
    res.summary.update(comm_report(ctx.analysis, trace=ctx.trace,
                                   min_collective_bytes=floor))
    return res
