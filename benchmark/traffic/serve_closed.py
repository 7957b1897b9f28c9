"""A closed loop of serving calls: each client sends its next request when
the previous one is back (``cli.predict``'s way of serving), here one
client at batch 1.

Requests come from the seed alone.  Source lengths are drawn in blocks:
each block is a fresh permutation of the mix's grid of ``grid`` lengths
spread evenly over ``source_length`` [lo, hi], so every seed sends the
same lengths in another order and any window holds whole blocks but the
last.  Phone ids are uniform over [1, num_symbols - 1]; with ``speakers``
> 0 each request's speaker is uniform over that many ids from the
configuration's ``speaker_embedding_offset``.

Parameters (``traffic/<mix>.json``): ``kind`` ("serve_closed"),
``clients``, ``batch``, ``source_length`` [lo, hi], ``grid``,
``speakers``.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass
class Request:
    index: int
    source: np.ndarray          # (T,) int64 phone ids
    speaker: Optional[int]


def grid(mix: dict) -> np.ndarray:
    lo, hi = mix["source_length"]
    n = min(int(mix["grid"]), hi - lo + 1)
    return np.unique(np.round(np.linspace(lo, hi, n)).astype(np.int64))


def requests(mix: dict, hp: dict, seed: int) -> Iterator[Request]:
    """The mix's endless request sequence for ``seed``."""
    if mix["clients"] != 1 or mix["batch"] != 1:
        raise ValueError("serve_closed drives one client at batch 1")
    rng = np.random.default_rng([int(seed), 0x5E])
    lengths = grid(mix)
    speakers = int(mix.get("speakers", 0))
    index = itertools.count()
    while True:
        for T in rng.permutation(lengths):
            source = rng.integers(1, hp["num_symbols"], int(T))
            speaker = (int(rng.integers(0, speakers))
                       + hp["speaker_embedding_offset"] if speakers else None)
            yield Request(next(index), source, speaker)


def warmup(mix: dict, hp: dict, seed: int):
    """The few requests set-up sends: the longest and the shortest source
    of the grid, twice each, so that every kernel instance and every
    allocation the window needs exists before it opens."""
    rng = np.random.default_rng([int(seed), 0x3A])
    lengths = grid(mix)
    speakers = int(mix.get("speakers", 0))
    out = []
    for T in (lengths[-1], lengths[0]) * 2:
        out.append(Request(-1 - len(out), rng.integers(1, hp["num_symbols"],
                                                       int(T)),
                           hp["speaker_embedding_offset"] if speakers
                           else None))
    return out


def run_window(call, reqs: Iterator[Request], seconds: float, keep,
               spans) -> dict:
    """Calls ``call(request, spans)`` back to back until ``seconds`` have
    passed since the first began; the call that is running then finishes.
    Each call is timed from before its request is made into a batch to
    after its outputs are on the host.  ``keep(request, result)`` sees
    every finished call.  Returns the calls' records and the window."""
    records = []
    start = time.perf_counter()
    end = start
    while end - start < seconds:
        req = next(reqs)
        t0 = time.perf_counter()
        result = call(req, spans)
        end = time.perf_counter()
        records.append(dict(index=req.index, T=int(req.source.shape[0]),
                            steps=result["steps"], rows=1,
                            ms=(end - t0) * 1e3))
        keep(req, result)
    return dict(calls=records, window_s=end - start)
