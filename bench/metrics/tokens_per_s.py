"""Tokens trained in the window over the window's wall time (host clock,
the last step synced)."""


def read(run):
    if not run.steps or not run.tokens_per_step:
        return None
    return run.steps * run.tokens_per_step / run.window_s
