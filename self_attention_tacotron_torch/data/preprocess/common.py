"""Shared preprocessing machinery: parallel map + corpus mel statistics.

The reference drives preprocessing with PySpark RDDs and reduces per-utterance
``MelStatistics`` into corpus average/stddev/min per mel bin, written to an
``hparams.json`` the user merges into model configs
(reference: preprocess_vctk.py:63-89, preprocess/vctk.py:115-141).
Here a process pool replaces Spark and the same reduction runs as a numpy
tree-free fold.

A copy of the JAX package's module.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Iterable, List, NamedTuple, Optional, Sequence

import numpy as np


class SpeakerInfo(NamedTuple):
    id: int
    age: int
    gender: int


class MelStatistics(NamedTuple):
    """reference: preprocess/vctk.py:55-56."""

    id: int
    key: str
    max: np.ndarray
    min: np.ndarray
    sum: np.ndarray
    length: int
    moment2: np.ndarray


def parallel_map(fn: Callable, items: Sequence, num_workers: int = 0,
                 ordered: bool = True) -> List:
    """Process-pool map (the Spark ``rdd.map`` replacement)."""
    if num_workers == 0:
        num_workers = os.cpu_count() or 4
    if num_workers == 1 or len(items) <= 1:
        return [fn(x) for x in items]
    with ProcessPoolExecutor(num_workers) as pool:
        return list(pool.map(fn, items))


def reduce_mel_statistics(stats: Iterable[MelStatistics]) -> dict:
    """Corpus statistics -> partial hparams.json content
    (reference: preprocess_vctk.py:66-89)."""
    stats = list(stats)
    total_len = sum(s.length for s in stats)
    total_sum = np.sum([s.sum for s in stats], axis=0)
    total_m2 = np.sum([s.moment2 for s in stats], axis=0)
    mel_min = np.min([s.min for s in stats], axis=0)
    mel_max = np.max([s.max for s in stats], axis=0)
    average = total_sum / total_len
    variance = total_m2 / total_len - average ** 2
    return {
        "average_mel_level_db": average.tolist(),
        "stddev_mel_level_db": np.sqrt(np.maximum(variance, 0.0)).tolist(),
        "min_mel_level_db": mel_min.tolist(),
        "max_mel_level_db": mel_max.tolist(),
    }


def write_hparams_json(stats_dict: dict, out_dir: str,
                       filename: str = "hparams.json") -> str:
    path = os.path.join(out_dir, filename)
    with open(path, "w") as f:
        json.dump(stats_dict, f)
    return path


def write_key_list(keys: Sequence[str], out_dir: str,
                   filename: str = "list.csv") -> str:
    """reference: preprocess_vctk.py:91-94."""
    path = os.path.join(out_dir, filename)
    with open(path, "w") as f:
        f.write("\n".join(keys) + "\n")
    return path


def load_speaker_info(path: str, skip_ids: Sequence[str] = ("315",)
                      ) -> List[SpeakerInfo]:
    """Parse VCTK-style speaker-info.txt, skipping speaker 315
    (reference: preprocess/vctk.py:121-127)."""
    infos = []
    with open(path, encoding="utf8") as f:
        for line in f.readlines()[1:]:
            si = line.split()
            if not si:
                continue
            if str(si[0]) in skip_ids:
                continue
            gender = 0 if si[2] == "F" else 1
            infos.append(SpeakerInfo(int(si[0]), int(si[1]), gender))
    return infos
