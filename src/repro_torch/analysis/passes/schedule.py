"""Collective-schedule linter (``collectives`` pass).

Contract-checkable facts about the step's collective schedule:

- per-kind *qualifying* execution counts, each collective sized by
  ``max(input, output)`` bytes so an all-gather's big output counts,
  with a byte floor that drops metric all-reduces / LARS trust-ratio
  sums out of the gradient accounting;
- the largest single execution per kind (what "zero has no all-reduce
  above metric size" pins down);
- optional expectation-driven gates: ``max_collectives_per_step`` (the
  bucketed modes: a *bounded* number of launches) and per-kind byte
  caps, ``forbid_allreduce_above_bytes`` (ZeRO: the full-gradient
  all-reduce is gone; hierarchical: only the shard-sized inter-group
  all-reduce survives), ``forbid_reduce_scatter_above_bytes`` /
  ``forbid_allgather_above_bytes`` (flat modes: no stray hierarchical
  stages, DESIGN.md §14).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict

from repro_torch.analysis.cost import gradient_sync_mode
from repro_torch.analysis.passes import AuditContext, PassResult, register_pass


@register_pass("collectives")
def schedule_pass(ctx: AuditContext) -> PassResult:
    res = PassResult(name="collectives")
    floor = float(ctx.expectations.get("schedule_min_bytes", 2048))
    execs: Dict[str, float] = defaultdict(float)
    max_bytes: Dict[str, float] = defaultdict(float)
    small_execs = 0.0
    for op in ctx.trace.collectives():
        b = float(op.coll_bytes)
        max_bytes[op.collective] = max(max_bytes[op.collective], b)
        if b >= floor:
            execs[op.collective] += 1
        else:
            small_execs += 1

    total = sum(execs.values())
    res.summary.update({
        "per_op": {
            k: {"execs": round(v, 2), "max_bytes": max_bytes[k]}
            for k, v in sorted(execs.items())
        },
        "qualifying_execs_total": round(total, 2),
        "small_execs_total": round(small_execs, 2),
        "schedule_min_bytes": floor,
        "gradient_sync": gradient_sync_mode(
            ctx.analysis,
            metric_bytes_floor=int(
                ctx.expectations.get("metric_bytes_floor", 1024))),
        "allreduce_max_bytes": max_bytes.get("all-reduce", 0.0),
        "reduce_scatter_max_bytes": max_bytes.get("reduce-scatter", 0.0),
        "allgather_max_bytes": max_bytes.get("all-gather", 0.0),
    })

    cap = ctx.expectations.get("max_collectives_per_step")
    if cap is not None and total > float(cap):
        res.add("error",
                f"{total:.1f} qualifying collectives/step exceeds the "
                f"contract cap of {float(cap):.0f} (bucketing is "
                f"supposed to bound launches)",
                qualifying_execs_total=total, cap=float(cap))
    for opname, key in (
            ("all-reduce", "forbid_allreduce_above_bytes"),
            ("reduce-scatter", "forbid_reduce_scatter_above_bytes"),
            ("all-gather", "forbid_allgather_above_bytes")):
        op_cap = ctx.expectations.get(key)
        if op_cap is not None and \
                max_bytes.get(opname, 0.0) > float(op_cap):
            res.add("error",
                    f"{opname} moving {max_bytes[opname]:.0f} B "
                    f"survives; this mode promises none above "
                    f"{float(op_cap):.0f} B",
                    **{f"{opname.replace('-', '_')}_max_bytes":
                       max_bytes[opname], "cap": float(op_cap)})
    return res
