"""The 95th percentile of every call's latency in the window, in ms: from
the moment its host-side batch is made to the moment its outputs are on
the host (linear between order statistics, as numpy's default)."""

import statistics


def read(run):
    ms = [c["ms"] for c in run.calls]
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=20, method="inclusive")[18]
