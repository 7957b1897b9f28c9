"""Readers of the VQ-code and mel corpora: batch-1 serving and single-host
training.

The subset of the JAX package's ``data/dataset.py`` that the port runs,
for two target kinds:

* ``codes`` — one-hot (T, num_codes) targets, target length codes * r;
* ``mel`` — (T, num_mels) dB targets normalised by
  ``average_mel_level_db`` and ``stddev_mel_level_db``, r frames of
  ``silence_mel_level_db`` added at head and tail and the length padded to
  a multiple of r with it.

* serving — one utterance at a time, the source padded to the bucketing's
  32-step source width (``Bucketing.source_pad_length``), the target kept
  as the ground truth of the prediction record;
* training — ``Bucketing`` (each bucket pads its targets to its upper
  edge), ``pad_batch`` (sources 0, codes 0 or mel frames
  ``silence_mel_level_db``, done 1, masks 0 past each length), ``Dataset``
  (shuffle, repeat, drop_remainder, batches of one bucket),
  ``to_model_batch``, ``pad_model_batch_rows`` and ``dataset_factory``
  (the target kind from ``hp.dataset``, as in the JAX package).  Each
  utterance's ``speaker_id`` goes from its source record to the model's
  batch.  The multi-host bucket schedule and the MGC-LF0 targets come with
  later slices.
"""

from __future__ import annotations

import os
import random
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

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
    target: Optional[np.ndarray]  # (T, C) one-hot codes or mel frames
    target_length: int
    speaker_id: int = 0           # the source record's (VCTK: 225-376)


def _read_example(path: str) -> dict:
    return next(iter(read_examples(path)))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def load_utterance(source_file: str, target_file: Optional[str],
                   hp: HParams, target_kind: str = "codes") -> Utterance:
    """One source record (+ its ``codes`` or ``mel`` target) padded for the
    model."""
    src = R.parse_source_record(_read_example(source_file))
    use_phone = hp.source == "phone" and src.phone is not None
    source = src.phone if use_phone else src.source
    length = int(src.phone_length if use_phone else src.source_length)
    text = src.phone_txt if use_phone else src.text
    padded = np.zeros(_round_up(max(length, 1), SOURCE_PAD_WIDTH), np.int64)
    padded[:length] = np.asarray(source, np.int64)[:length]
    target, target_length = None, 0
    if target_file is not None and target_kind == "codes":
        tgt = R.parse_code_target_record(_read_example(target_file))
        target = tgt.codes.astype(np.float32)
        target_length = tgt.codes_length * hp.outputs_per_step
    elif target_file is not None and target_kind == "mel":
        target, target_length = _mel_target(
            R.parse_mel_target_record(_read_example(target_file)), hp)
    elif target_file is not None:
        raise NotImplementedError(f"{target_kind!r} targets are not ported "
                                  "yet")
    return Utterance(UtteranceMeta(src.id, src.key, text, src.lang), padded,
                     length, target, int(target_length),
                     int(src.speaker_id))


def _mel_target(tgt: R.MelTargetRecord, hp: HParams):
    """Normalised mel frames with r silence frames at head and tail, the
    length padded to a multiple of r (reference:
    datasets/vctk/dataset.py:152-193)."""
    r = hp.outputs_per_step
    avg = np.asarray(hp.average_mel_level_db, np.float32)
    std = np.asarray(hp.stddev_mel_level_db, np.float32)
    sil = np.float32(hp.silence_mel_level_db)
    length = tgt.target_length + 2 * r
    padded = _round_up(length, r)
    mel = np.pad((tgt.mel - avg) / std, ((r, r + padded - length), (0, 0)),
                 constant_values=sil)
    return mel.astype(np.float32), padded


def iter_utterances(source_files: Sequence[str],
                    target_files: Optional[Sequence[str]],
                    hp: HParams, target_kind: str = "codes"
                    ) -> Iterator[Utterance]:
    """In list order; targets longer than ``max_iters * r`` are skipped
    (the reference's filter_by_max_output_length)."""
    max_out = hp.max_iters * hp.outputs_per_step
    for i, s in enumerate(source_files):
        u = load_utterance(s, target_files[i] if target_files else None, hp,
                           target_kind)
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


# ------------------------------------------------------------------ training

class NumpyBatch(NamedTuple):
    meta: List[UtteranceMeta]
    source: np.ndarray            # (B, T_in) int64
    source_length: np.ndarray     # (B,) int32
    target: np.ndarray            # (B, T, C) float32
    target_length: np.ndarray     # (B,) int32
    done: np.ndarray              # (B, T // r) float32
    spec_loss_mask: np.ndarray    # (B, T)
    binary_loss_mask: np.ndarray  # (B, T // r)
    speaker_id: np.ndarray        # (B,) int32


class Bucketing:
    """Static-shape bucket table: bucket i pads targets to its upper edge."""

    def __init__(self, hp: HParams, source_width: int = SOURCE_PAD_WIDTH):
        self.min_len = hp.approx_min_target_length
        self.width = hp.batch_bucket_width
        self.num_buckets = hp.batch_num_buckets
        self.r = hp.outputs_per_step
        self.source_width = source_width

    def bucket_id(self, target_length: int) -> int:
        over = max(target_length - self.min_len, 0)
        return min(self.num_buckets, over // self.width)

    def target_pad_length(self, bucket_id: int) -> int:
        edge = self.min_len + (bucket_id + 1) * self.width
        return _round_up(edge, self.r)

    def source_pad_length(self, max_source: int) -> int:
        return _round_up(max_source, self.source_width)


def pad_batch(utts: Sequence[Utterance], hp: HParams,
              target_pad: Optional[int] = None,
              source_pad: Optional[int] = None,
              target_kind: str = "codes") -> NumpyBatch:
    """Pad utterances to common shapes: sources 0, codes 0.0 or mel frames
    ``silence_mel_level_db``, done 1 and loss masks 0 past each length;
    done is [0, ..., 0, 1] and the masks are 1 within it."""
    B, r = len(utts), hp.outputs_per_step
    src_len = max(u.source_length for u in utts)
    source = np.zeros((B, max(source_pad or src_len, src_len)), np.int64)
    tgt_len = max(u.target_length for u in utts)
    tgt_pad = _round_up(max(target_pad or tgt_len, tgt_len), r)
    fill = hp.silence_mel_level_db if target_kind == "mel" else 0.0
    target = np.full((B, tgt_pad, utts[0].target.shape[1]), fill,
                     np.float32)
    done = np.ones((B, tgt_pad // r), np.float32)
    spec_mask = np.zeros((B, tgt_pad), np.float32)
    binary_mask = np.zeros((B, tgt_pad // r), np.float32)
    for i, u in enumerate(utts):
        source[i, :u.source_length] = u.source[:u.source_length]
        L = u.target_length
        s = L // r
        target[i, :L] = u.target[:L]
        done[i, :s] = 0.0
        done[i, s - 1] = 1.0
        spec_mask[i, :L] = 1.0
        binary_mask[i, :s] = 1.0
    return NumpyBatch(
        meta=[u.meta for u in utts], source=source,
        source_length=np.asarray([u.source_length for u in utts], np.int32),
        target=target,
        target_length=np.asarray([u.target_length for u in utts], np.int32),
        done=done, spec_loss_mask=spec_mask, binary_loss_mask=binary_mask,
        speaker_id=np.asarray([u.speaker_id for u in utts], np.int32))


class Dataset:
    """Utterances with ``target_kind`` targets -> padded batches of one
    bucket each:
    shuffled (``seed``) per epoch, repeated, targets longer than
    ``max_iters * r`` skipped; a batch leaves its bucket when it holds
    ``batch_size`` utterances, the remainders at the end of a finite pass
    unless ``drop_remainder``."""

    def __init__(self, source_files: Sequence[str],
                 target_files: Sequence[str], hp: HParams,
                 batch_size: Optional[int] = None, shuffle: bool = True,
                 repeat: bool = False, seed: int = 0,
                 drop_remainder: bool = False, target_kind: str = "codes"):
        assert len(source_files) == len(target_files)
        self.pairs = list(zip(source_files, target_files))
        self.hp = hp
        self.batch_size = batch_size or hp.batch_size
        self.shuffle, self.repeat = shuffle, repeat
        self.seed, self.drop_remainder = seed, drop_remainder
        self.target_kind = target_kind
        self.bucketing = Bucketing(hp)

    def _utterances(self) -> Iterator[Utterance]:
        rng = random.Random(self.seed)
        while True:
            pairs = list(self.pairs)
            if self.shuffle:
                rng.shuffle(pairs)
            yield from iter_utterances([s for s, _ in pairs],
                                       [t for _, t in pairs], self.hp,
                                       self.target_kind)
            if not self.repeat:
                return

    def _pads_for(self, bid: int, batch: Sequence[Utterance]
                  ) -> Tuple[int, int]:
        return (self.bucketing.target_pad_length(bid),
                self.bucketing.source_pad_length(
                    max(u.source_length for u in batch)))

    def __iter__(self) -> Iterator[NumpyBatch]:
        buckets: dict = {}
        for u in self._utterances():
            bid = self.bucketing.bucket_id(u.target_length)
            buckets.setdefault(bid, []).append(u)
            if len(buckets[bid]) == self.batch_size:
                batch = buckets.pop(bid)
                yield pad_batch(batch, self.hp, *self._pads_for(bid, batch),
                                self.target_kind)
        if not self.drop_remainder:
            for bid, batch in sorted(buckets.items()):
                yield pad_batch(batch, self.hp, *self._pads_for(bid, batch),
                                self.target_kind)


def to_model_batch(nb: NumpyBatch):
    """NumpyBatch -> models.Batch of CPU tensors."""
    import torch
    from ..models.tacotron import Batch
    t = torch.from_numpy
    return Batch(source=t(nb.source), source_length=t(nb.source_length),
                 target=t(nb.target), target_length=t(nb.target_length),
                 done=t(nb.done), spec_loss_mask=t(nb.spec_loss_mask),
                 binary_loss_mask=t(nb.binary_loss_mask),
                 speaker_id=t(nb.speaker_id))


def pad_model_batch_rows(mb, multiple: int):
    """Pad a model Batch's rows up to a multiple of ``multiple`` with copies
    of its last row whose loss masks are zero, so they add nothing to any
    loss (every loss normalises by its mask sum) and stay out of the
    batch-norm statistics.  Returns ``(padded batch, rows added)``."""
    import torch
    B = mb.source.shape[0]
    pad = (-B) % multiple
    if pad == 0:
        return mb, 0
    rows = [None if x is None else torch.cat(
        [x, x[-1:].expand(pad, *x.shape[1:])]) for x in mb]
    padded = type(mb)(*rows)
    masks = {}
    for name in ("spec_loss_mask", "binary_loss_mask"):
        m = getattr(padded, name)
        if m is not None:
            m = m.clone()
            m[B:] = 0.0
        masks[name] = m
    return padded._replace(**masks), pad


def target_kind_of(hp: HParams) -> str:
    """The target kind ``hp.dataset`` names (the JAX package's
    ``dataset_factory``): codes, mgclf0, else mel (vctk, ljspeech)."""
    name = hp.dataset.lower()
    if "codes" in name:
        return "codes"
    if "mgc" in name or "lf0" in name:
        return "mgclf0"
    return "mel"


def dataset_factory(source_files, target_files, hp: HParams,
                    **kwargs) -> Dataset:
    """The JAX package's name-keyed dispatch: ``target_kind`` (a keyword,
    or derived from ``hp.dataset``) selects codes or mel targets; MGC-LF0
    targets are not ported yet."""
    kind = kwargs.pop("target_kind", None) or target_kind_of(hp)
    if kind not in ("codes", "mel"):
        raise NotImplementedError(f"{kind!r} targets are not ported yet")
    return Dataset(source_files, target_files, hp, target_kind=kind,
                   **kwargs)
