"""The share of the traced window in which no operation ran on the device
(the union of the trace's device intervals, as
``scripts/torch_train_step_profile.py`` takes it), in %."""


def read(run):
    if run.trace is None or not run.trace.spans:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
