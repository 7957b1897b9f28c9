"""The whole call's share of the card's peak over the traced window: the
FLOPs of every count (each kernel's and the plain products') over all
calls, over the window's seconds at the peak for float32 operands, in %."""


def read(run):
    if run.trace is None or not run.calls:
        return None
    flops = sum(run.work(name)[1] for name in run.counts)
    return 100.0 * flops / (run.trace.window_s
                            * run.peaks["flop_per_s"]["f32"])
