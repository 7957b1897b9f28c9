"""Batch-1 serving reader for the VQ-code corpus.

The subset of the JAX package's ``data/dataset.py`` that prediction runs:
one utterance at a time, the source padded to the bucketing's 32-step
source width (``Bucketing.source_pad_length``), the code target kept as the
ground truth of the prediction record.  Training-time bucketing, shuffling
and multi-host scheduling come with the training slice.
"""

from __future__ import annotations

import os
from typing import Iterator, List, NamedTuple, Optional, Sequence

import numpy as np

from ..config import HParams
from . import records as R
from .tfrecord import read_examples

SOURCE_PAD_WIDTH = 32


class UtteranceMeta(NamedTuple):
    id: int
    key: str
    text: str
    lang: str = ""


class Utterance(NamedTuple):
    meta: UtteranceMeta
    source: np.ndarray            # (T_pad,) int64, zero past source_length
    source_length: int
    target: Optional[np.ndarray]  # (T, num_codes) one-hot float32
    target_length: int


def _read_example(path: str) -> dict:
    return next(iter(read_examples(path)))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def load_utterance(source_file: str, target_file: Optional[str],
                   hp: HParams) -> Utterance:
    """One source record (+ its code target) padded for the model."""
    src = R.parse_source_record(_read_example(source_file))
    use_phone = hp.source == "phone" and src.phone is not None
    source = src.phone if use_phone else src.source
    length = int(src.phone_length if use_phone else src.source_length)
    text = src.phone_txt if use_phone else src.text
    padded = np.zeros(_round_up(max(length, 1), SOURCE_PAD_WIDTH), np.int64)
    padded[:length] = np.asarray(source, np.int64)[:length]
    target, target_length = None, 0
    if target_file is not None:
        tgt = R.parse_code_target_record(_read_example(target_file))
        target = tgt.codes.astype(np.float32)
        target_length = tgt.codes_length * hp.outputs_per_step
    return Utterance(UtteranceMeta(src.id, src.key, text, src.lang), padded,
                     length, target, int(target_length))


def iter_utterances(source_files: Sequence[str],
                    target_files: Optional[Sequence[str]],
                    hp: HParams) -> Iterator[Utterance]:
    """In list order; targets longer than ``max_iters * r`` are skipped
    (the reference's filter_by_max_output_length)."""
    max_out = hp.max_iters * hp.outputs_per_step
    for i, s in enumerate(source_files):
        u = load_utterance(s, target_files[i] if target_files else None, hp)
        if u.target is not None and u.target_length > max_out:
            continue
        yield u


def find_dataset_files(data_root: str, key_list: Sequence[str],
                       extension: str) -> List[str]:
    """<root>/<key>.<extension> for each selected key."""
    return [os.path.join(data_root, f"{key}.{extension}") for key in key_list]


def load_key_list(path: str) -> List[str]:
    with open(path) as f:
        return [line.rstrip("\n") for line in f if line.strip()]
