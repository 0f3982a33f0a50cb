"""Declarative per-(model, sync-mode) contracts over audit-pass output
(DESIGN.md §12): the port's copy of the JAX package's module, its
table and checks unchanged (one error message names the port's
audit). The port holds its recorded step (``analysis/op_trace.py``) to
the same contracts as the JAX package's compiled one.

A :class:`Contract` says what the compiled train step of one
(model, dp/sync mode, optimizer) cell must look like: which passes run,
which pass-level gates are armed (via expectation knobs the passes
understand), and a list of :class:`Check` assertions over the passes'
summary fields. Checks reference facts the audit computes, symbolically —
``value="$n_buckets"`` resolves against the expectations dict at
evaluation time — so the same contract text covers the reduced and full
configs, any bucket size, and any mesh.

Field paths are dotted into the pass summaries:
``"collectives.per_op.all-reduce.execs"`` means
``record["collectives"]["summary"]["per_op"]["all-reduce"]["execs"]``.

The contract table below encodes the repo's sync-mode claims
(DESIGN.md §5–§9) as machine-checked invariants:

========== ==========================================================
mode       must hold in the compiled step
========== ==========================================================
gspmd      gradient sync is all-reduce; ≥1 qualifying all-reduce
perleaf    all-reduce per big leaf (≥ the big-leaf count unless XLA's
           combiner merged them — gated by total wire bytes instead)
bucketed   exactly ``n_buckets`` qualifying all-reduces; total
           qualifying collectives ≤ the mode's launch budget; no
           reduce-scatter/all-gather above metric size (flat schedule)
overlap    bucketed + collectives interleaved with backward compute
zero       reduce-scatter+all-gather carry the gradient;
           ``n_buckets`` of each; NO all-reduce above metric size
zero_ovl   zero + interleaved
hier       every bucket lowers to intra-axis reduce-scatter +
           inter-axis all-reduce + intra-axis all-gather: exact
           per-op execution counts, per-op byte ceilings, and NO
           all-reduce above the shard size (the flat full-bucket
           all-reduce is gone, DESIGN.md §14)
hier_ovl   hier + interleaved
hier_zero  double reduce-scatter in, double all-gather out per
           bucket; NO all-reduce above metric size; byte ceilings
hier_z_ovl hier_zero + interleaved
all        no precision / donation / determinism errors
========== ==========================================================
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

ALL_PASSES: Tuple[str, ...] = (
    "comm", "interleave", "precision", "donation", "memory",
    "collectives", "determinism")

# passes whose error findings fail every contract
BASE_FORBID: Tuple[str, ...] = (
    "precision", "donation", "determinism", "collectives", "interleave",
    "memory")


@dataclasses.dataclass(frozen=True)
class Check:
    field: str            # dotted path, first segment = pass name
    op: str               # == != >= <= > < is_true is_false
    value: Any = None     # literal, or "$key" into expectations
    label: str = ""

    def describe(self) -> str:
        return self.label or f"{self.field} {self.op} {self.value}"


@dataclasses.dataclass
class Contract:
    name: str
    passes: Tuple[str, ...] = ALL_PASSES
    # pass-gate knobs, merged into AuditContext.expectations ("$"-refs
    # resolved first)
    expectations: Dict[str, Any] = dataclasses.field(default_factory=dict)
    checks: Tuple[Check, ...] = ()
    forbid_errors: Tuple[str, ...] = BASE_FORBID


def resolve(value: Any, expectations: Dict[str, Any]) -> Any:
    if isinstance(value, str) and value.startswith("$"):
        key = value[1:]
        if key not in expectations:
            raise KeyError(
                f"contract references ${key} but the audit did not "
                f"compute it; have {sorted(expectations)}")
        return expectations[key]
    return value


def lookup(record: Dict[str, Any], field: str) -> Any:
    parts = field.split(".")
    if parts[0] not in record:
        raise KeyError(f"no pass record {parts[0]!r} for field {field!r}")
    node: Any = record[parts[0]].get("summary", {})
    for p in parts[1:]:
        if not isinstance(node, dict) or p not in node:
            raise KeyError(f"field {field!r}: missing {p!r}")
        node = node[p]
    return node


_OPS = {
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    ">=": lambda a, b: a >= b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    "<": lambda a, b: a < b,
    "is_true": lambda a, b: bool(a),
    "is_false": lambda a, b: not a,
}


def evaluate(contract: Contract, record: Dict[str, Any],
             expectations: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Return the list of violations (empty = contract holds).
    ``record`` maps pass name -> ``PassResult.as_dict()``."""
    violations: List[Dict[str, Any]] = []
    for pname in contract.forbid_errors:
        rec = record.get(pname)
        if rec is None:
            violations.append({"kind": "missing_pass", "pass": pname,
                               "message": f"pass {pname!r} did not run"})
            continue
        for f in rec.get("findings", []):
            if f.get("severity") == "error":
                violations.append({"kind": "pass_error", "pass": pname,
                                   "message": f.get("message", ""),
                                   "finding": f})
    for chk in contract.checks:
        try:
            actual = lookup(record, chk.field)
            expected = resolve(chk.value, expectations)
            ok = _OPS[chk.op](actual, expected)
        except KeyError as e:
            violations.append({"kind": "check_error",
                               "check": chk.describe(),
                               "message": str(e)})
            continue
        if not ok:
            violations.append({
                "kind": "check_failed", "check": chk.describe(),
                "field": chk.field, "op": chk.op,
                "expected": expected, "actual": actual,
            })
    return violations


def contract_for(model: str, mode: str, optimizer: str) -> Contract:
    """The contract table. ``model`` is currently informational (every
    registered model makes the same per-mode promises); ``mode`` is one
    of gspmd / perleaf / bucketed / overlap / zero / zero_overlap."""
    common = (
        Check("collectives.qualifying_execs_total", ">=", 1,
              label="step has at least one substantial collective"),
    )
    exp: Dict[str, Any] = {}
    checks: Tuple[Check, ...] = common

    if mode == "gspmd":
        checks += (
            Check("collectives.gradient_sync", "==", "all_reduce"),
            Check("collectives.per_op.all-reduce.execs", ">=", 1),
        )
    elif mode == "perleaf":
        # XLA's all-reduce combiner may merge per-leaf syncs, so the
        # launch count is a floor of 1; the per-leaf promise that
        # survives compilation is the wire volume: every big leaf's
        # bytes cross the wire via all-reduce.
        checks += (
            Check("collectives.gradient_sync", "==", "all_reduce"),
            Check("collectives.per_op.all-reduce.execs", ">=", 1),
            Check("comm.per_op.all-reduce.wire_bytes_per_device", ">=",
                  "$min_gradient_wire_bytes",
                  label="all-reduce carries the full gradient volume"),
        )
    elif mode in ("bucketed", "overlap"):
        exp["max_collectives_per_step"] = "$collective_budget"
        # flat schedule: a reduce-scatter or all-gather above metric
        # size would mean a hierarchical stage leaked in (DESIGN.md §14)
        exp["forbid_reduce_scatter_above_bytes"] = "$metric_bytes_floor"
        exp["forbid_allgather_above_bytes"] = "$metric_bytes_floor"
        checks += (
            Check("collectives.gradient_sync", "==", "all_reduce"),
            Check("collectives.per_op.all-reduce.execs", "==",
                  "$n_buckets",
                  label="exactly one all-reduce per gradient bucket"),
        )
        if mode == "overlap":
            exp["require_interleaved"] = True
            checks += (Check("interleave.interleaved", "is_true"),)
    elif mode in ("hier", "hier_overlap"):
        exp["max_collectives_per_step"] = "$collective_budget"
        # the inter-axis all-reduce runs on the 1/inner shard: any
        # all-reduce above that ceiling is a surviving flat big sync
        exp["forbid_allreduce_above_bytes"] = "$ar_bytes_ceiling"
        checks += (
            Check("collectives.gradient_sync", "==", "hierarchical"),
            Check("collectives.per_op.reduce-scatter.execs", "==",
                  "$n_rs",
                  label="one intra-axis reduce-scatter per bucket"),
            Check("collectives.per_op.all-reduce.execs", "==", "$n_ar",
                  label="one inter-axis all-reduce per bucket shard"),
            Check("collectives.per_op.all-gather.execs", "==", "$n_ag",
                  label="one intra-axis all-gather per bucket"),
            Check("collectives.per_op.reduce-scatter.max_bytes", "<=",
                  "$rs_bytes_ceiling",
                  label="reduce-scatter stays bucket-sized (f32)"),
            Check("collectives.per_op.all-reduce.max_bytes", "<=",
                  "$ar_bytes_ceiling",
                  label="all-reduce stays 1/inner shard-sized"),
            Check("collectives.per_op.all-gather.max_bytes", "<=",
                  "$ag_bytes_ceiling",
                  label="all-gather stays bucket-sized (wire dtype)"),
        )
        if mode == "hier_overlap":
            exp["require_interleaved"] = True
            checks += (Check("interleave.interleaved", "is_true"),)
    elif mode in ("hier_zero", "hier_zero_overlap"):
        exp["max_collectives_per_step"] = "$collective_budget"
        exp["forbid_allreduce_above_bytes"] = "$metric_bytes_floor"
        checks += (
            Check("collectives.gradient_sync", "==",
                  "reduce_scatter+all_gather"),
            Check("collectives.per_op.reduce-scatter.execs", "==",
                  "$n_rs",
                  label="inner + outer reduce-scatter per bucket"),
            Check("collectives.per_op.all-gather.execs", "==", "$n_ag",
                  label="outer + inner all-gather per param bucket"),
            Check("collectives.per_op.reduce-scatter.max_bytes", "<=",
                  "$rs_bytes_ceiling",
                  label="reduce-scatter stays bucket-sized (f32)"),
            Check("collectives.per_op.all-gather.max_bytes", "<=",
                  "$ag_bytes_ceiling",
                  label="all-gather stays bucket-sized (f32 stream)"),
        )
        if mode == "hier_zero_overlap":
            exp["require_interleaved"] = True
            checks += (Check("interleave.interleaved", "is_true"),)
    elif mode in ("zero", "zero_overlap"):
        exp["max_collectives_per_step"] = "$collective_budget"
        exp["forbid_allreduce_above_bytes"] = "$metric_bytes_floor"
        checks += (
            Check("collectives.gradient_sync", "==",
                  "reduce_scatter+all_gather"),
            Check("collectives.per_op.reduce-scatter.execs", "==",
                  "$n_buckets",
                  label="one reduce-scatter per gradient bucket"),
            Check("collectives.per_op.all-gather.execs", "==",
                  "$n_buckets",
                  label="one all-gather per updated-param bucket"),
        )
        if mode == "zero_overlap":
            exp["require_interleaved"] = True
            checks += (Check("interleave.interleaved", "is_true"),)
    else:
        raise ValueError(f"no contract for mode {mode!r}")

    return Contract(name=f"{model}/{mode}/{optimizer}",
                    expectations=exp, checks=checks)
