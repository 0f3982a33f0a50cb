"""Cost accounting over a recorded step (``analysis/op_trace.py``): the
port's counterpart of the JAX package's ``analysis/cost.py``.

Per step, as this worker ran it:
  flops            dot + convolution FLOPs (``torch.utils.flop_counter``'s
                   formulas, the backward's included)
  memory_bytes     bytes touched: each op's input and output bytes (a view
                   touches none); kernel launches move bytes the trace does
                   not see and add none
  collectives      per-kind ring-model wire bytes per device, dtypes,
                   executions and the largest single execution

The JAX engine's trip-count weighting and its bf16-promotion correction
have no counterpart: an eager step has no loops to unroll, and the op
stream carries each collective's true dtype.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List

from repro_torch.analysis.op_trace import Op, OpTrace

_CONV_OPS = {"convolution", "_convolution", "cudnn_convolution",
             "convolution_backward", "cudnn_convolution_transpose"}


@dataclasses.dataclass
class Analysis:
    flops: float
    dot_flops: float
    conv_flops: float
    memory_bytes: float
    parameter_bytes: float
    collective_bytes: Dict[str, float]  # kind -> wire bytes (per device)
    collective_dtypes: Dict[str, Dict[str, float]]  # kind -> dtype -> bytes
    collective_count: int
    op_histogram: Dict[str, int]
    top_memory_ops: List[tuple] = dataclasses.field(default_factory=list)
    top_collective_ops: List[tuple] = dataclasses.field(
        default_factory=list)
    # kind -> executions per step
    collective_exec_counts: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    # kind -> largest single-execution wire bytes
    collective_max_exec_bytes: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    # kernel -> launches per step (the ctypes kernels)
    kernel_launches: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _wire_bytes(op: Op, k: int) -> float:
    """Ring-model per-device wire bytes for one collective execution
    (the JAX package's ``cost.py:_wire_bytes``)."""
    if k <= 1:
        return 0.0
    frac = (k - 1) / k
    in_b, out_b = float(op.in_bytes), float(op.out_bytes)
    if op.collective == "all-reduce":
        return 2.0 * in_b * frac
    if op.collective == "all-gather":
        return out_b * frac
    if op.collective in ("reduce-scatter", "all-to-all"):
        return in_b * frac
    if op.collective in ("broadcast", "scatter"):
        return max(in_b, out_b)
    return in_b


def analyze_trace(trace: OpTrace, total_devices: int = 1,
                  parameter_bytes: float = 0.0) -> Analysis:
    flops = dot_flops = conv_flops = 0.0
    mem = 0.0
    coll_bytes: Dict[str, float] = defaultdict(float)
    coll_dtypes: Dict[str, Dict[str, float]] = defaultdict(
        lambda: defaultdict(float))
    coll_execs: Dict[str, float] = defaultdict(float)
    coll_max: Dict[str, float] = defaultdict(float)
    histogram: Dict[str, int] = defaultdict(int)
    top_mem: List[tuple] = []
    top_coll: List[tuple] = []
    coll_count = 0
    for op in trace.ops:
        histogram[op.short] += 1
        if op.is_kernel:
            continue
        if op.flops:
            flops += op.flops
            if op.short in _CONV_OPS:
                conv_flops += op.flops
            else:
                dot_flops += op.flops
        if op.collective is not None:
            k = op.group_size or total_devices
            wb = _wire_bytes(op, k)
            coll_bytes[op.collective] += wb
            coll_dtypes[op.collective][op.dtype] += wb
            coll_execs[op.collective] += 1
            coll_max[op.collective] = max(coll_max[op.collective], wb)
            coll_count += 1
            top_coll.append((wb, op.collective, k, op.dtype, op.index))
        if not op.view:
            b = float(op.in_bytes + op.out_bytes)
            mem += b
            if b > 0:
                top_mem.append((b, op.short, op.index))
    top_mem.sort(reverse=True)
    top_coll.sort(reverse=True)
    return Analysis(
        flops=flops, dot_flops=dot_flops, conv_flops=conv_flops,
        memory_bytes=mem, parameter_bytes=parameter_bytes,
        collective_bytes=dict(coll_bytes),
        collective_dtypes={k: dict(v) for k, v in coll_dtypes.items()},
        collective_count=coll_count, op_histogram=dict(histogram),
        top_memory_ops=top_mem[:40], top_collective_ops=top_coll[:40],
        collective_exec_counts=dict(coll_execs),
        collective_max_exec_bytes=dict(coll_max),
        kernel_launches=dict(trace.launches))


def gradient_sync_mode(a: Analysis,
                       metric_bytes_floor: int = 1024) -> str:
    """Classify the step's gradient-sync mechanism from its collective
    mix, with the JAX package's four answers (and its "mixed"):
    ``"reduce_scatter+all_gather"`` when scatter + gather carry the
    gradient and every all-reduce is metric-sized (below
    ``metric_bytes_floor`` wire bytes an execution); ``"hierarchical"``
    when a substantial all-reduce runs between them (the two-level
    schedule); ``"all_reduce"`` when all-reduces carry it; ``"none"``
    without substantial collectives."""
    rs = a.collective_bytes.get("reduce-scatter", 0.0)
    ag = a.collective_bytes.get("all-gather", 0.0)
    ar = a.collective_bytes.get("all-reduce", 0.0)
    ar_max = a.collective_max_exec_bytes.get("all-reduce", 0.0)
    if rs > 0 and ag > 0 and ar_max < metric_bytes_floor:
        return "reduce_scatter+all_gather"
    if rs > 0 and ag > 0 and ar_max >= metric_bytes_floor:
        return "hierarchical"
    if ar >= max(rs, ag) and ar_max >= metric_bytes_floor:
        return "all_reduce"
    if max(rs, ag, ar) == 0.0:
        return "none"
    return "mixed"
