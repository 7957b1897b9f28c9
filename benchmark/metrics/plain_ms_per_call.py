"""Device milliseconds a call of every kernel that is none of the port's
hand-written ones (no count lists its symbol): the model's plain PyTorch
work around the kernels."""


from harness.trace import is_symbol


def read(run):
    if run.trace is None or not run.calls:
        return None
    symbols = [s for c in run.counts.values() for s in c.SYMBOLS]
    ns = sum(k.end_ns - k.start_ns for k in run.trace.kernels
             if not is_symbol(k.name, symbols))
    return ns / 1e6 / len(run.calls)
