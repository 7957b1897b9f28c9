"""The comparison that decides ``correct``.

While the window runs, ``Keep`` sees every finished call: it counts the
calls that stopped before the configuration's cap and keeps a sample of
the calls, drawn from the seed by reservoir sampling, and the call with
the longest source.  Once the window has closed and the program's state is
freed, the plain reference runs once over each kept call's source (and
speaker) with the call's served frames as its step inputs.  Two numbers
are compared: the widest gap between a served code logit and the
reference's at the same step (``logit_gap``), and the widest gap between a
served stop logit and the reference's (``stop_gap``), each over every step
of every kept call.  The stop logits sit near the stop bias, where float32
is coarser than near the code logits, so each has a limit of its own.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch


class Keep:
    def __init__(self, size: int, seed: int, cap_steps: int):
        self.size = size
        self.rng = np.random.default_rng([int(seed), 0xC4])
        self.cap = cap_steps
        self.seen = 0
        self.short_calls = 0
        self.reservoir: List[tuple] = []
        self.longest: Optional[tuple] = None

    def __call__(self, req, result) -> None:
        self.short_calls += int(result["steps"] != self.cap)
        item = (req, result)
        if (self.longest is None
                or req.source.shape[0] > self.longest[0].source.shape[0]):
            self.longest = item
        if len(self.reservoir) < self.size:
            self.reservoir.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.reservoir[j] = item
        self.seen += 1

    def sample(self) -> List[tuple]:
        """The kept calls, the longest among them, each once."""
        items = list(self.reservoir)
        if self.longest is not None and all(
                self.longest[0].index != r.index for r, _ in items):
            items.append(self.longest)
        return items


@torch.no_grad()
def gaps(reference, items, device):
    """Per kept call, the widest |served - reference| code logit and stop
    logit; and the highest stop logit the reference reads over those
    calls.  Calls that served as many steps run through the reference
    together."""
    logit_gap, stop_gap, stop_max = {}, {}, float("-inf")
    by_steps: Dict[int, list] = {}
    for req, result in items:
        by_steps.setdefault(result["logits"].shape[0], []).append(
            (req, result))
    for steps, group in by_steps.items():
        served = torch.stack([r["logits"] for _, r in group]).to(device)
        served_stop = torch.stack([r["stop"] for _, r in group]).to(device)
        logits, stop = reference(
            [torch.from_numpy(q.source).to(device) for q, _ in group],
            steps, [q.speaker for q, _ in group], feed=served)
        for (q, _), lg, sg in zip(group, (logits - served).abs().amax((1, 2)),
                                  (stop - served_stop).abs().amax(1)):
            logit_gap[q.index], stop_gap[q.index] = float(lg), float(sg)
        stop_max = max(stop_max, float(stop.max()))
    order = [q.index for q, _ in items]
    return ([logit_gap[i] for i in order], [stop_gap[i] for i in order],
            stop_max)


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """{name: {"value", "limit"}}; every number at or under its limit is
    correct."""
    return {k: {"value": numbers[k], "limit": limits[k]} for k in numbers}


def is_correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
