"""Seconds from the start of the process to the first timed call: the
kernels' build (or finding them built), the weights, the model and the
warm-up calls."""


def read(run):
    return run.setup_s
