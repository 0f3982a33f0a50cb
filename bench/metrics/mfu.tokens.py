"""Model FLOPs of the window's steps (``harness/counts.py``: forward x 3,
from the layer shapes) over the window's wall time and one card's bf16
dense peak."""
from harness.counts import PEAKS


def read(run):
    if not run.steps:
        return None
    flops = run.step_flops() * run.steps
    return 100.0 * flops / run.window_s / PEAKS["bf16_flops"]
