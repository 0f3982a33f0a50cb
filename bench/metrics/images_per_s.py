"""Images trained in the window over the window's wall time (host clock,
the last step synced). Moves on its own: the cell's throughput."""


def read(run):
    if not run.steps:
        return None
    return run.steps * run.images_per_step / run.window_s
