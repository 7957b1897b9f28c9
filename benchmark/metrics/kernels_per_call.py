"""Device kernels launched a call, over the traced window."""


def read(run):
    if run.trace is None or not run.calls:
        return None
    return len(run.trace.kernels) / len(run.calls)
