"""Mean host time a step spends inside the program's ``train_step`` call
(the harness's span, host clock): dispatch of the forward, backward,
bucketed sync and update, before the loss read waits on the device."""
import statistics


def read(run):
    return statistics.mean(run.step_host_s) * 1e3 if run.step_host_s \
        else None
