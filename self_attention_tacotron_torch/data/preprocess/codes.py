"""VQ-code corpus preprocessing (flat dir of 'text \\t code ints' files).

Parity targets:
* CODES — reference: preprocess/codes.py:90-176: ``pXXX_YYY.txt`` files with
  'text TAB code-int-string', optional stride-2 downsampling selected by
  ``version`` (``codeints[version-1::2]``), one-hot (T, num_codes) float32
  target matrices, char-id + flite-phone sources.
* SIWIS codes — reference: preprocess/siwis_codes.py: bilingual (EN/FR)
  variant keyed by ``siwis-speaker-info.txt``; language derived from the
  filename and stored in both records.

A copy of the JAX package's module.
"""

from __future__ import annotations

import logging
import os
from typing import List, NamedTuple, Optional

import numpy as np

from ...config import HParams
from ...text.cleaners import basic_cleaners
from ...text.flite import Flite
from ...text.symbols import text_to_sequence
from .. import records as R
from .common import SpeakerInfo, load_speaker_info, parallel_map


class TxtCodeRecord(NamedTuple):
    id: int
    key: str
    txt_path: str
    code_path: str
    speaker_info: SpeakerInfo
    lang: str = "EN"


def load_accent_map(path: str) -> dict:
    """speaker id -> dense accent index from an 'ID ACCENTS' table
    (speaker_selection/accents.txt format); indices follow first-seen order
    of the accent names so the mapping is deterministic."""
    accents: dict = {}
    order: List[str] = []
    with open(path, encoding="utf8") as f:
        lines = [line.split() for line in f if line.strip()]
    # only drop the first line when it actually is the column header — a
    # headerless file must not silently lose its first speaker
    if lines and lines[0] and lines[0][0].upper() == "ID":
        lines = lines[1:]
    for parts in lines:
        if len(parts) < 2:
            logging.warning("accent map %s: skipping malformed line %r",
                            path, " ".join(parts))
            continue
        if parts[1] not in order:
            order.append(parts[1])
        accents[parts[0]] = order.index(parts[1])
    return accents


class CODES:
    def __init__(self, in_dir: str, out_dir: str, version: int,
                 num_codes: int, hparams: HParams,
                 speaker_info_filename: str = "speaker-info.txt",
                 accent_file: Optional[str] = None):
        self.in_dir = in_dir
        self.out_dir = out_dir
        self.version = int(version)
        self.num_codes = int(num_codes)
        self.hparams = hparams
        self.speaker_info_filename = speaker_info_filename
        # per-speaker accent annotation: accent ids live in the source-token
        # domain (reference: hparams.py:55-62); English-corpus speakers get
        # their speaker-level accent broadcast over the tokens, offset into
        # the accent embedding's id range
        self.accent_map = load_accent_map(accent_file) if accent_file else None
        self.g2p = None
        if hparams.phoneme == "flite":
            g2p = Flite(hparams.flite_binary_path,
                        hparams.phoneset_path or "uscmu")
            self.g2p = g2p if g2p.available() else None

    def _accent_ids(self, speaker_id, length: int) -> Optional[np.ndarray]:
        if self.accent_map is None:
            return None
        idx = self.accent_map.get(str(speaker_id))
        value = (self.hparams.accent_type_offset + idx if idx is not None
                 else self.hparams.accent_type_unknown)
        return np.full(length, value, np.int64)

    def list_files(self) -> List[TxtCodeRecord]:
        records = []
        info_path = (self.speaker_info_filename
                     if os.path.exists(self.speaker_info_filename)
                     else os.path.join(self.in_dir,
                                       self.speaker_info_filename))
        for si in load_speaker_info(info_path):
            spk = f"p{si.id}"
            files = sorted(f for f in os.listdir(self.in_dir)
                           if f.endswith(".txt") and f.startswith(spk))
            for f in files:
                key = f[:-4]
                path = os.path.join(self.in_dir, f)
                records.append(TxtCodeRecord(0, key, path, path, si))
        return [TxtCodeRecord(i, r.key, r.txt_path, r.code_path,
                              r.speaker_info, r.lang)
                for i, r in enumerate(records)]

    def process_sources(self, records, num_workers: int = 0):
        return parallel_map(self._process_txt, records, num_workers)

    def process_targets(self, records, num_workers: int = 0):
        return parallel_map(self._process_code, records, num_workers)

    def _parse_code_line(self, path: str) -> Optional[np.ndarray]:
        with open(path, encoding="utf8") as f:
            line = f.readline().rstrip("\n")
        parts = line.split("\t")
        if len(parts) != 2:
            return None
        codeints = [int(c) for c in parts[1].split(" ") if c != ""]
        start = self.version - 1
        if start >= 0:
            # stride-2 downsample (reference: preprocess/codes.py:149-151)
            codeints = codeints[start::2]
        return np.asarray(codeints, np.int64)

    def _process_code(self, record: TxtCodeRecord) -> Optional[str]:
        a = self._parse_code_line(record.code_path)
        if a is None:
            return None
        codes = np.zeros((a.size, self.num_codes), np.float32)
        codes[np.arange(a.size), a] = 1.0
        path = os.path.join(self.out_dir, f"{record.key}.target.tfrecord")
        R.write_code_target_record(
            R.CodeTargetRecord(record.id, record.key, record.lang, codes,
                               a.size, self.num_codes), path)
        return record.key

    def _process_txt(self, record: TxtCodeRecord) -> str:
        with open(record.txt_path, encoding="utf8") as f:
            txt = f.readline().rstrip("\n").split("\t")[0]
        sequence, clean_text = text_to_sequence(txt, basic_cleaners)
        phone_ids, phone_txt = (self.g2p.convert_to_phoneme(clean_text)
                                if self.g2p is not None else (None, None))
        source = np.array(sequence, dtype=np.int64)
        path = os.path.join(self.out_dir, f"{record.key}.source.tfrecord")
        R.write_source_record(
            R.SourceRecord(
                id=record.id, key=record.key, source=source,
                source_length=len(source), text=clean_text,
                speaker_id=record.speaker_info.id,
                age=record.speaker_info.age,
                gender=record.speaker_info.gender,
                phone=(np.array(phone_ids, np.int64)
                       if phone_ids is not None
                       else np.zeros((0,), np.int64)),
                phone_length=len(phone_ids) if phone_ids is not None else 0,
                phone_txt=phone_txt or "", lang=record.lang,
                accent_type=self._accent_ids(
                    record.speaker_info.id,
                    max(len(source),
                        len(phone_ids) if phone_ids is not None else 0))),
            path, with_speaker=True, with_phone=True, with_lang=True)
        return record.key


class SiwisCodes(CODES):
    """Bilingual SIWIS variant (reference: preprocess/siwis_codes.py):
    headerless ``siwis-speaker-info.txt`` of string speaker ids + language
    ('EN-26 EN'); files are ``<speaker>_*.txt``; the language rides in the
    record's lang field.  String speaker ids map to stable integers by
    enumeration order (the downstream speaker embedding indexes integers)."""

    def __init__(self, in_dir: str, out_dir: str, version: int,
                 num_codes: int, hparams: HParams,
                 speaker_info_filename: str = "siwis-speaker-info.txt",
                 accent_file: Optional[str] = None):
        super().__init__(in_dir, out_dir, version, num_codes, hparams,
                         speaker_info_filename, accent_file=accent_file)

    @staticmethod
    def _lang_of(filename: str) -> str:
        return "FR" if filename.upper().startswith("FR") else "EN"

    def _speakers(self):
        info_path = (self.speaker_info_filename
                     if os.path.exists(self.speaker_info_filename)
                     else os.path.join(self.in_dir,
                                       self.speaker_info_filename))
        with open(info_path, encoding="utf8") as f:
            for line in f:
                si = line.split()
                if si:
                    yield si[0], (si[1] if len(si) > 1 else "EN")

    def list_files(self) -> List[TxtCodeRecord]:
        records = []
        for idx, (spk, lang) in enumerate(self._speakers()):
            files = sorted(f for f in os.listdir(self.in_dir)
                           if f.endswith(".txt") and f.startswith(spk))
            for f in files:
                key = f[:-4]
                path = os.path.join(self.in_dir, f)
                records.append(TxtCodeRecord(
                    0, key, path, path, SpeakerInfo(idx, 0, -1),
                    self._lang_of(os.path.basename(f))))
        return [TxtCodeRecord(i, r.key, r.txt_path, r.code_path,
                              r.speaker_info, r.lang)
                for i, r in enumerate(records)]
