"""Mean host time a step spends in the input pipeline's ``next()`` (the
harness's span, host clock): the wait for its batch and the staging of
the next one (pinned copy, host-to-device copy issued on a side
stream)."""
import statistics


def read(run):
    return statistics.mean(run.data_wait_s) * 1e3 if run.data_wait_s \
        else None
