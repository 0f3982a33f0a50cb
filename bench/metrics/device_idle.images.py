"""Share of the window in which no operation ran on the device: 1 - the
device work of a traced step (the union of every device activity's
interval, all streams) over the wall time of an untraced step of the
window. The profiler's own host cost slows the traced steps; measured
so, it is left out."""


def read(run):
    share = run.busy_share()
    return None if share is None else 100.0 * (1.0 - share)
