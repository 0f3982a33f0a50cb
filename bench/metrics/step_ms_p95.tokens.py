"""The 95th percentile of every step's wall time in the window, each
step from the wait for its batch to the read of its loss (host clock)."""
import statistics


def read(run):
    if len(run.step_s) < 2:
        return None
    return statistics.quantiles(run.step_s, n=100)[94] * 1e3
