"""Readers of the VQ-code, mel and MGC/LF0 corpora: batch-1 serving and
training.

The JAX package's ``data/dataset.py`` for its three target kinds:

* ``codes`` — one-hot (T, num_codes) targets, target length codes * r;
* ``mel`` — (T, num_mels) dB targets normalised by
  ``average_mel_level_db`` and ``stddev_mel_level_db``, r frames of
  ``silence_mel_level_db`` added at head and tail and the length padded to
  a multiple of r with it;
* ``mgclf0`` — the (T, num_mgcs) mgc frames as ``target`` and, as
  ``target2``, the f0 track quantised to one-hot classes: class 0 for an
  unvoiced frame (f0 <= 0), else 1 + floor of its log-f0, clipped to
  [log f0_min, log f0_max], over that range times ``num_lf0s - 2``;
  target length T * r.

With ``use_accent_type`` each utterance carries ``accent_type``: the
source record's accent ids, cut to the source length or padded with
``accent_type_unknown``, or all unknown when the record has none; batches
pad it with ``accent_type_unknown``.

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
  batch.

The input pipeline is the JAX package's: records are read by the C++
reader (``native_reader``, built at first use) where a C++ compiler is
found, else by the pure-Python codec (``reader_in_use`` says which, logged
once with the reason); ``num_workers`` threads read ahead in a bounded
window of ``2 * num_workers`` utterances consumed in order, so the seeded
epoch order is that of serial reading; ``prefetch`` prepares batches on a
background thread.  For data parallelism every rank's batches must keep
the same shapes: ``fixed_target_pad`` / ``fixed_source_pad`` pad every
batch to one shape (utterances that do not fit are skipped with a
warning), or the shared bucket schedule (``bucket_schedule_seed``,
``bucket_weights``, ``bucket_buffer_cap``) draws each batch's bucket from a
seed common to the ranks and fills it from the rank's own shard.

Without target files (``Dataset(source_files, None, hp)``, predict time)
every utterance is a batch of its own, whatever ``batch_size`` is, its
source padded to ``fixed_source_pad`` or to the bucketing's source width;
its target fields are ``None`` and its ``target_length`` 0.  The bucket
schedule skips such utterances.
"""

from __future__ import annotations

import logging
import os
import queue
import random
import threading
from collections import Counter, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..config import HParams
from . import native_reader
from . import records as R
from .tfrecord import checksum_in_use, read_examples

log = logging.getLogger(__name__)

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
    accent_type: Optional[np.ndarray] = None  # (T_pad,) int64
    target2: Optional[np.ndarray] = None      # (T, num_lf0s) one-hot lf0


_reader: Optional[str] = None
reads: Counter = Counter()   # records read, by reader


def reader_in_use() -> str:
    """``native`` or ``python``: which reader serves ``_read_example``
    (logged once, with the reason when it is not the native one)."""
    global _reader
    if _reader is None:
        reason = native_reader.unavailable_reason()
        _reader = "native" if reason is None else "python"
        if reason is None:
            log.info("TFRecord reader: native (%s); checksum %s",
                     native_reader.library_path().name, checksum_in_use())
        else:
            log.warning("TFRecord reader: pure Python (%s); checksum %s",
                        reason, checksum_in_use())
    return _reader


def _read_example(path: str) -> dict:
    """The file's first Example, native-first; a corrupt record raises
    from either reader."""
    which = reader_in_use()
    reads[which] += 1
    if which == "native":
        return next(native_reader.read_examples_native(path))
    return next(iter(read_examples(path)))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def load_utterance(source_file: str, target_file: Optional[str],
                   hp: HParams, target_kind: str = "codes") -> Utterance:
    """One source record (+ its ``codes``, ``mel`` or ``mgclf0`` target)
    padded for the model."""
    src = R.parse_source_record(_read_example(source_file))
    use_phone = hp.source == "phone" and src.phone is not None
    source = src.phone if use_phone else src.source
    length = int(src.phone_length if use_phone else src.source_length)
    text = src.phone_txt if use_phone else src.text
    padded = np.zeros(_round_up(max(length, 1), SOURCE_PAD_WIDTH), np.int64)
    padded[:length] = np.asarray(source, np.int64)[:length]
    target = target2 = None
    target_length = 0
    if target_file is not None and target_kind == "codes":
        tgt = R.parse_code_target_record(_read_example(target_file))
        target = tgt.codes.astype(np.float32)
        target_length = tgt.codes_length * hp.outputs_per_step
    elif target_file is not None and target_kind == "mel":
        target, target_length = _mel_target(
            R.parse_mel_target_record(_read_example(target_file)), hp)
    elif target_file is not None and target_kind == "mgclf0":
        tgt = R.parse_mgc_lf0_target_record(_read_example(target_file))
        target = tgt.mgc.astype(np.float32)
        target2 = lf0_classes(tgt.lf0, hp)
        target_length = tgt.target_length * hp.outputs_per_step
    elif target_file is not None:
        raise ValueError(target_kind)
    accent = None
    if hp.use_accent_type:
        accent = np.full(len(padded), hp.accent_type_unknown, np.int64)
        if src.accent_type is not None and len(src.accent_type) > 0:
            ids = np.asarray(src.accent_type, np.int64)[:length]
            accent[:len(ids)] = ids
    return Utterance(UtteranceMeta(src.id, src.key, text, src.lang), padded,
                     length, target, int(target_length),
                     int(src.speaker_id), accent, target2)


def lf0_classes(lf0: np.ndarray, hp: HParams) -> np.ndarray:
    """(T,) f0 in Hz -> (T, num_lf0s) one-hot classes: 0 for an unvoiced
    frame (f0 <= 0), else 1 + floor((clip(log f0, lo, hi) - lo) / (hi - lo)
    * (num_lf0s - 2)) with lo, hi = log f0_min, log f0_max (the JAX
    package's quantisation, in its arithmetic)."""
    lo, hi = np.log(hp.f0_min), np.log(hp.f0_max)
    voiced = lf0 > 0
    idx = np.zeros(len(lf0), np.int64)
    safe = np.clip(np.log(np.maximum(lf0, 1e-8)), lo, hi)
    idx[voiced] = 1 + np.floor(
        (safe[voiced] - lo) / (hi - lo) * (hp.num_lf0s - 2)).astype(np.int64)
    return np.eye(hp.num_lf0s, dtype=np.float32)[idx]


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
    """A padded batch; without targets ``target``, ``target2``, ``done``
    and the masks are ``None`` and ``target_length`` is zeros."""
    meta: List[UtteranceMeta]
    source: np.ndarray            # (B, T_in) int64
    source_length: np.ndarray     # (B,) int32
    target: Optional[np.ndarray]  # (B, T, C) float32
    target_length: np.ndarray     # (B,) int32
    done: Optional[np.ndarray]              # (B, T // r) float32
    spec_loss_mask: Optional[np.ndarray]    # (B, T)
    binary_loss_mask: Optional[np.ndarray]  # (B, T // r)
    speaker_id: np.ndarray        # (B,) int32
    accent_type: Optional[np.ndarray] = None  # (B, T_in) int64
    target2: Optional[np.ndarray] = None      # (B, T, num_lf0s) float32


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
    """Pad utterances to common shapes: sources 0, accent types
    ``accent_type_unknown``, codes and mgc frames 0.0 or mel frames
    ``silence_mel_level_db``, lf0 classes 0.0, done 1 and loss masks 0
    past each length; done is [0, ..., 0, 1] and the masks are 1 within
    it.  Utterances without a target leave the target fields ``None``."""
    B, r = len(utts), hp.outputs_per_step
    src_len = max(u.source_length for u in utts)
    source = np.zeros((B, max(source_pad or src_len, src_len)), np.int64)
    accent = (np.full(source.shape, hp.accent_type_unknown, np.int64)
              if hp.use_accent_type else None)
    for i, u in enumerate(utts):
        source[i, :u.source_length] = u.source[:u.source_length]
        if accent is not None and u.accent_type is not None:
            accent[i, :u.source_length] = u.accent_type[:u.source_length]
    target = target2 = done = spec_mask = binary_mask = None
    if utts[0].target is not None:
        tgt_len = max(u.target_length for u in utts)
        tgt_pad = _round_up(max(target_pad or tgt_len, tgt_len), r)
        fill = hp.silence_mel_level_db if target_kind == "mel" else 0.0
        target = np.full((B, tgt_pad, utts[0].target.shape[1]), fill,
                         np.float32)
        target2 = (np.zeros((B, tgt_pad, utts[0].target2.shape[1]),
                            np.float32)
                   if utts[0].target2 is not None else None)
        done = np.ones((B, tgt_pad // r), np.float32)
        spec_mask = np.zeros((B, tgt_pad), np.float32)
        binary_mask = np.zeros((B, tgt_pad // r), np.float32)
        for i, u in enumerate(utts):
            L = u.target_length
            s = L // r
            target[i, :L] = u.target[:L]
            if target2 is not None:
                target2[i, :L] = u.target2[:L]
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
        speaker_id=np.asarray([u.speaker_id for u in utts], np.int32),
        accent_type=accent, target2=target2)


class Dataset:
    """Utterances with ``target_kind`` targets -> padded batches of one
    bucket each (the JAX package's ``Dataset``):
    shuffled (``seed``) per epoch, repeated, targets longer than
    ``max_iters * r`` skipped; a batch leaves its bucket when it holds
    ``batch_size`` utterances, the remainders at the end of a finite pass
    unless ``drop_remainder``.  ``num_workers`` (0: from the
    ``interleave_cycle_length_*`` hparams) threads read ahead in order;
    ``fixed_target_pad`` / ``fixed_source_pad`` fix every batch's shape;
    ``bucket_schedule_seed`` turns on the shared bucket schedule
    (``_iter_scheduled``).  ``target_files=None`` serves predict time:
    each utterance is a batch of its own, without targets."""

    def __init__(self, source_files: Sequence[str],
                 target_files: Optional[Sequence[str]], hp: HParams,
                 batch_size: Optional[int] = None, shuffle: bool = True,
                 repeat: bool = False, seed: int = 0,
                 drop_remainder: bool = False, target_kind: str = "codes",
                 num_workers: int = 0,
                 fixed_target_pad: Optional[int] = None,
                 fixed_source_pad: Optional[int] = None,
                 bucket_schedule_seed: Optional[int] = None,
                 bucket_weights: Optional[Sequence[float]] = None,
                 bucket_buffer_cap: int = 4096):
        assert target_files is None or len(source_files) == len(target_files)
        self.pairs = list(zip(source_files,
                              target_files or [None] * len(source_files)))
        self.hp = hp
        self.batch_size = batch_size or hp.batch_size
        self.shuffle, self.repeat = shuffle, repeat
        self.seed, self.drop_remainder = seed, drop_remainder
        self.target_kind = target_kind
        self.fixed_target_pad = fixed_target_pad
        self.fixed_source_pad = fixed_source_pad
        self.bucket_schedule_seed = bucket_schedule_seed
        self.bucket_weights = list(bucket_weights) if bucket_weights else None
        self.bucket_buffer_cap = bucket_buffer_cap
        self.bucketing = Bucketing(hp)
        if num_workers <= 0:
            n = int((os.cpu_count() or 4)
                    * hp.interleave_cycle_length_cpu_factor)
            num_workers = min(max(n, hp.interleave_cycle_length_min),
                              hp.interleave_cycle_length_max)
        self.num_workers = num_workers

    def _utterances(self) -> Iterator[Utterance]:
        """Each epoch's utterances in its shuffled order, read by
        ``num_workers`` threads through a window of at most
        ``2 * num_workers`` pending reads consumed first in, first out
        (the reference's ``parallel_interleave``: bounded parallel reads,
        an ordered stream); targets longer than ``max_iters * r`` are
        skipped."""
        rng = random.Random(self.seed)
        window = max(2 * self.num_workers, 1)
        max_out = self.hp.max_iters * self.hp.outputs_per_step
        while True:
            pairs = list(self.pairs)
            if self.shuffle:
                rng.shuffle(pairs)
            with ThreadPoolExecutor(self.num_workers) as pool:
                def submit(pair):
                    return pool.submit(load_utterance, pair[0], pair[1],
                                       self.hp, self.target_kind)
                it = iter(pairs)
                pending = deque(submit(p) for _, p in zip(range(window), it))
                while pending:
                    u = pending.popleft().result()
                    nxt = next(it, None)
                    if nxt is not None:
                        pending.append(submit(nxt))
                    if u.target is not None and u.target_length > max_out:
                        continue
                    yield u
            if not self.repeat:
                return

    def _pads_for(self, bid: int, batch: Sequence[Utterance]
                  ) -> Tuple[int, int]:
        return (self.fixed_target_pad
                or self.bucketing.target_pad_length(bid),
                self.fixed_source_pad
                or self.bucketing.source_pad_length(
                    max(u.source_length for u in batch)))

    def _fits_fixed_pads(self, u: Utterance) -> bool:
        for what, length, pad in (
                ("source", u.source_length, self.fixed_source_pad),
                ("target", u.target_length if u.target is not None else 0,
                 self.fixed_target_pad)):
            if pad and length > pad:
                log.warning("skipping %s: %s length %d > fixed pad %d",
                            u.meta.key, what, length, pad)
                return False
        return True

    def _iter_scheduled(self) -> Iterator[NumpyBatch]:
        """The shared bucket schedule: each batch's bucket is drawn (by
        ``bucket_weights``) from a generator seeded with
        ``bucket_schedule_seed``, the same on every rank, and filled from
        the rank's buffered utterances of that bucket or below (the
        largest first).  A rank whose shard cannot fill the drawn bucket
        buffers utterances until ``bucket_buffer_cap``, then raises."""
        rng = random.Random(self.bucket_schedule_seed)
        bk = self.bucketing
        max_out = self.hp.max_iters * self.hp.outputs_per_step
        ids = [b for b in range(bk.num_buckets + 1)
               if bk.target_pad_length(b) <= max_out or b == 0]
        weights = self.bucket_weights or [1.0] * len(ids)
        if len(weights) != len(ids):
            raise ValueError(f"multihost_bucket_weights needs {len(ids)} "
                             f"entries (one per bucket), got {len(weights)}")
        if self.fixed_source_pad is None:
            log.warning("bucket schedule without fixed_source_pad: source "
                        "shapes depend on the data and are not the same on "
                        "every rank")
        stream = self._utterances()
        buckets: dict = {}
        buffered = 0
        while True:
            b = rng.choices(ids, weights)[0]
            batch: List[Utterance] = []
            while len(batch) < self.batch_size:
                bid = next((i for i in range(b, -1, -1) if buckets.get(i)),
                           None)
                if bid is not None:
                    batch.append(buckets[bid].pop())
                    buffered -= 1
                    continue
                u = next(stream, None)
                if u is None:
                    return      # a finite stream ran out
                if u.target is None or not self._fits_fixed_pads(u):
                    continue
                buckets.setdefault(bk.bucket_id(u.target_length),
                                   []).append(u)
                buffered += 1
                if buffered > self.bucket_buffer_cap:
                    raise RuntimeError(
                        f"bucket-schedule starvation: buffered {buffered} "
                        f"utterances without filling bucket {b} (pad "
                        f"{bk.target_pad_length(b)}); this rank's shard has "
                        "no utterances that short: set "
                        "multihost_bucket_weights to skip short buckets or "
                        "use multihost_target_pad_length")
            sp = (self.fixed_source_pad
                  or bk.source_pad_length(max(u.source_length
                                              for u in batch)))
            yield pad_batch(batch, self.hp, bk.target_pad_length(b), sp,
                            self.target_kind)

    def __iter__(self) -> Iterator[NumpyBatch]:
        if self.bucket_schedule_seed is not None:
            yield from self._iter_scheduled()
            return
        buckets: dict = {}
        for u in self._utterances():
            if not self._fits_fixed_pads(u):
                continue
            if u.target is None:
                yield pad_batch([u], self.hp, source_pad=(
                    self.fixed_source_pad
                    or self.bucketing.source_pad_length(u.source_length)),
                    target_kind=self.target_kind)
                continue
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

    def prefetch(self, buffer_size: Optional[int] = None
                 ) -> Iterator[NumpyBatch]:
        """The batches of ``iter(self)``, prepared up to ``buffer_size``
        (``hp.prefetch_buffer_size``) ahead on a background thread.  An
        error there is raised here; closing the iterator stops the
        thread."""
        buffer_size = buffer_size or self.hp.prefetch_buffer_size
        q: queue.Queue = queue.Queue(maxsize=buffer_size)
        stop = threading.Event()
        end = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            batches = iter(self)
            try:
                for batch in batches:
                    if not put(batch):
                        break
            except BaseException as e:  # noqa: BLE001 - raised below
                put(e)
                return
            finally:
                batches.close()
            put(end)

        t = threading.Thread(target=worker, daemon=True,
                             name="dataset-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=60)


def to_model_batch(nb: NumpyBatch):
    """NumpyBatch -> models.Batch of CPU tensors."""
    import torch
    from ..models.tacotron import Batch
    def t(x):
        return None if x is None else torch.from_numpy(x)
    target = t(nb.target)
    if nb.target2 is not None:      # MGC/LF0: (mgc, lf0), as the JAX batch
        target = (target, t(nb.target2))
    return Batch(source=t(nb.source), source_length=t(nb.source_length),
                 target=target, target_length=t(nb.target_length),
                 done=t(nb.done), spec_loss_mask=t(nb.spec_loss_mask),
                 binary_loss_mask=t(nb.binary_loss_mask),
                 speaker_id=t(nb.speaker_id), accent_type=t(nb.accent_type))


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
    padded = mb.map(lambda x: torch.cat([x, x[-1:].expand(pad,
                                                          *x.shape[1:])]))
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
    or derived from ``hp.dataset``) selects codes, mel or mgclf0 targets;
    the other keywords go to ``Dataset``.  As there, another kind raises
    ``ValueError`` when the first target is read."""
    kind = kwargs.pop("target_kind", None) or target_kind_of(hp)
    return Dataset(source_files, target_files, hp, target_kind=kind,
                   **kwargs)
