"""Kernel #1 (``fused_encode``): its count's least time at the peaks over
the device time of its kernels, in %."""


def read(run):
    return run.roofline_pct("fused_encode")
