"""Least time of the BN function's work over the summed device time of
every BN kernel in the trace. The work is counted from the shapes of
every BN site (``harness/counts.py``, ``resnet_bn_bytes``) at the HBM
rate; the kernels are the port's fused BN kernels (``csrc/fused_bn.cu``),
matched by name below. A kernel that takes over this work under another
name adds its pattern here."""
from harness.counts import PEAKS, resnet_bn_bytes

PATTERNS = (r"\(anonymous namespace\)::(stats_kernel|apply_kernel|"
            r"sums_partial|sums_merge|dx_kernel)\b",)


def read(run):
    if run.trace is None or not run.traced_step_s:
        return None
    spent = run.trace.kernel_seconds(PATTERNS)
    if not spent:
        return None
    least = resnet_bn_bytes(run.cfg["model"], run.mix["batch"]) \
        / PEAKS["hbm_bytes"] * len(run.traced_step_s)
    return 100.0 * least / spent
