"""Least time of the hybrid update's and the bf16 wire casts' work over
their kernels' device time in the trace: each gradient and state element
read once, each output written once (``harness/counts.py``,
``update_bytes``) at the HBM rate. The kernels are the port's fused
update and cast kernels (``csrc/fused_update.cu``,
``csrc/bucket_ops.cu``), matched by name below."""
from harness.counts import PEAKS, update_bytes
from reference.train import task_for

PATTERNS = (r"\(anonymous namespace\)::hybrid_update_leaves_kernel\b",
            r"\(anonymous namespace\)::cast_kernel\b")


def read(run):
    if run.trace is None or not run.traced_step_s:
        return None
    spent = run.trace.kernel_seconds(PATTERNS)
    if not spent:
        return None
    n = sum(leaf.numel for leaf in task_for(run.cfg).leaves)
    least = update_bytes(n) / PEAKS["hbm_bytes"] * len(run.traced_step_s)
    return 100.0 * least / spent
