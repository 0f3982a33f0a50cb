"""Precision-policy lint (``precision`` pass).

Two rails from the large-batch literature (Goyal et al. 1706.02677,
Yamazaki et al. 1903.12650: wrong-dtype accumulations are where
large-minibatch regressions hide):

1. Every *big* reduction (BN statistics, segment norms, loss means:
   anything that collapses an activation- or parameter-sized input)
   must produce a >= 4-byte float. A reduction whose result is bf16 /
   f16 / f8 over a big input is an **error**: the JAX package's lint
   reads the accumulation dtype off the result, and so does this one.
2. Narrow round trips (f32 -> f16 -> f32 casts of one value) silently
   truncate mantissa. They are a **warn** (the bucketed wire does this
   on purpose, with error feedback), and a round trip whose outer cast
   only feeds collectives is suppressed.
"""
from __future__ import annotations

import math

from repro_torch.analysis.passes import AuditContext, PassResult, register_pass

REDUCTIONS = {"sum", "mean", "var", "std", "var_mean", "std_mean", "norm",
              "linalg_vector_norm", "prod", "nansum", "logsumexp",
              "_native_batch_norm_legit", "native_batch_norm",
              "_native_batch_norm_legit_functional", "batch_norm_stats",
              "native_layer_norm", "_fused_rms_norm"}
CASTS = {"_to_copy", "copy_", "to"}
NARROW = {"float16", "bfloat16", "float8_e4m3fn", "float8_e5m2",
          "float8_e4m3fnuz", "float8_e5m2fnuz"}
WIDE = {"float32", "float64"}


def _elems(shape) -> int:
    return math.prod(shape) if shape else 1


def _cast(op):
    """(source dtype, result dtype) of a cast op, else None."""
    if op.short not in CASTS or not op.in_dtypes or not op.out_dtypes:
        return None
    if op.short == "copy_":  # copy_(self, src): src's dtype into self's
        if len(op.in_dtypes) < 2:
            return None
        return op.in_dtypes[1], op.in_dtypes[0]
    return op.in_dtypes[0], op.out_dtypes[0]


@register_pass("precision")
def precision_pass(ctx: AuditContext) -> PassResult:
    res = PassResult(name="precision")
    floor = int(ctx.expectations.get("reduction_elems_floor", 2048))
    ops = ctx.trace.ops
    consumers = ctx.trace.consumers()
    n_checked = n_narrow = n_roundtrip = n_suppressed = 0
    for op in ops:
        if op.short in REDUCTIONS and op.in_shapes:
            big = max(_elems(s) for s in op.in_shapes)
            if big < floor:
                continue
            n_checked += 1
            acc = op.out_dtypes[0] if op.out_dtypes else ""
            if acc in NARROW:
                n_narrow += 1
                res.add("error",
                        f"big reduction ({big} elems) produces {acc}; "
                        f"activation-sized reductions must accumulate f32",
                        op=f"{op.index}:{op.short}", elems=big, dtype=acc)
            continue
        outer = _cast(op)
        if outer is None or outer[1] not in WIDE or outer[0] not in NARROW:
            continue
        # the narrow value's producer: the copy_'s source, the cast's input
        k = 1 if op.short == "copy_" else 0
        if len(op.src) <= k or op.src[k] < 0:
            continue
        inner_op = ops[op.src[k]]
        inner = _cast(inner_op)
        if inner is None or inner[0] != outer[1] or inner[1] != outer[0]:
            continue
        elems = _elems(op.out_shapes[0]) if op.out_shapes else 0
        if elems < floor:
            continue  # scalar / metric casts are noise
        cons = consumers.get(op.index, [])
        if cons and all(ops[c].collective is not None for c in cons):
            n_suppressed += 1
            continue
        n_roundtrip += 1
        res.add("warn",
                f"{outer[1]} -> {outer[0]} -> {outer[1]} round trip on a "
                f"{elems}-elem value (mantissa truncation outside the "
                f"error-feedback wire)",
                op=f"{op.index}:{op.short}", narrow_dtype=outer[0])

    res.summary.update({
        "big_reductions_checked": n_checked,
        "narrow_reductions": n_narrow,
        "roundtrips": n_roundtrip,
        "roundtrips_suppressed_collective": n_suppressed,
        "reduction_elems_floor": floor,
    })
    return res
