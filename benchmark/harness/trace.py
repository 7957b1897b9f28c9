"""The traced run: ``torch.profiler`` over the window, reduced to device
intervals, the benchmark's own host spans and the idle gaps between.

Spans are ``record_function`` ranges named ``bench.<name>`` that the
benchmark opens around each layer it calls into (``make_request``,
``to_device``, ``predict_step``, ``readback``).  The device's busy time is
the union of the intervals of every operation the trace puts on the
device (kernels, copies, fills).  The traced window runs from the first
span's start to the last span's end.
"""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field
from typing import List, Tuple

SPAN_PREFIX = "bench."


@dataclass
class Interval:
    name: str
    start_ns: int
    end_ns: int
    kernel: bool = True


@dataclass
class Trace:
    device: List[Interval] = field(default_factory=list)
    spans: List[Interval] = field(default_factory=list)

    @property
    def kernels(self) -> List[Interval]:
        return [d for d in self.device if d.kernel]

    @property
    def window(self) -> Tuple[int, int]:
        return (min(s.start_ns for s in self.spans),
                max(s.end_ns for s in self.spans))

    @property
    def window_s(self) -> float:
        lo, hi = self.window
        return (hi - lo) / 1e9

    def busy(self) -> List[Tuple[int, int]]:
        """The union of the device intervals inside the window, merged."""
        lo, hi = self.window
        merged: List[Tuple[int, int]] = []
        for d in sorted(self.device, key=lambda d: d.start_ns):
            s, e = max(d.start_ns, lo), min(d.end_ns, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def gaps(self) -> List[Tuple[str, float]]:
        """Every idle stretch of the device inside the window, named by the
        benchmark span that was open on the host when it began."""
        lo, hi = self.window
        spans = sorted(self.spans, key=lambda s: s.start_ns)
        starts = [s.start_ns for s in spans]
        out, at = [], lo
        for s, e in self.busy() + [(hi, hi)]:
            if s > at:
                i = bisect.bisect_right(starts, at) - 1
                name = (spans[i].name if i >= 0 and spans[i].end_ns >= at
                        else "between spans")
                out.append((name, (s - at) / 1e9))
            at = max(at, e)
        return out

    def kernel_seconds(self, symbols) -> float:
        """Device seconds of the kernels that are one of ``symbols``."""
        return sum(k.end_ns - k.start_ns for k in self.kernels
                   if is_symbol(k.name, symbols)) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict = {}
        for d in self.device:
            by_name[d.name] = by_name.get(d.name, 0) + d.end_ns - d.start_ns
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: -g[1])[:top]
        return {"device_ops": [[n, t / 1e9] for n, t in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def is_symbol(name: str, symbols) -> bool:
    """Whether a traced kernel name (``void fused_decode_kernel<true,
    float>(DecArgs)``) is one of ``symbols`` (bare function names)."""
    base = name[5:] if name.startswith("void ") else name
    return any(base == s or base.startswith((s + "<", s + "("))
               for s in symbols)


def _get(event, attr):
    value = getattr(event, attr)
    return value() if callable(value) else value


def from_profiler(prof) -> Trace:
    """The device operations and benchmark spans of a finished profile."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    trace = Trace()
    for ev in prof.profiler.kineto_results.events():
        name = _get(ev, "name")
        start = int(_get(ev, "start_ns"))
        end = start + int(_get(ev, "duration_ns"))
        on_device = _get(ev, "device_type") == cuda
        if on_device and not name.startswith(SPAN_PREFIX):
            low = name.lower()
            kernel = not (low.startswith(("memcpy", "memset"))
                          or "memcpy" in low or "memset" in low)
            trace.device.append(Interval(name, start, end, kernel))
        elif not on_device and name.startswith(SPAN_PREFIX):
            trace.spans.append(Interval(name[len(SPAN_PREFIX):], start, end))
    return trace


@contextlib.contextmanager
def profiled():
    """A CPU + CUDA profile and the span opener that goes with it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def span(name):
        return record_function(SPAN_PREFIX + name)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof, span
