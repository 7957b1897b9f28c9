"""Scalar metrics of a training run: a JSONL stream and TensorBoard events.

The port's ``MetricsLogger`` of the JAX package's ``utils/metrics.py``:
each ``log`` appends one JSON line (``step``, ``time`` and the scalars,
under an optional prefix such as ``eval/``) to ``metrics.jsonl`` and one
scalar event to a TensorBoard event file (``utils/tb_events.py``) in the
same directory.  The alignment plots (``MetricsSaver``) are not ported: the
JAX module draws them with matplotlib, which the port does not depend on.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

from .tb_events import EventWriter


class MetricsLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self._tb = EventWriter(log_dir)

    def log(self, step: int, metrics: Dict[str, float], prefix: str = ""):
        now = time.time()
        scalars = {prefix + k: float(v) for k, v in metrics.items()}
        self._f.write(json.dumps({"step": int(step), "time": now,
                                  **scalars}) + "\n")
        self._f.flush()
        self._tb.add_scalars(int(step), scalars, wall_time=now)

    def close(self):
        self._f.close()
        self._tb.close()
