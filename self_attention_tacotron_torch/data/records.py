"""Typed record schemas over the TFRecord codec.

Byte-compatible with the reference's Example layouts:
* mel source/target — reference: preprocess/vctk.py:19-44,
  preprocess/ljspeech.py (same minus speaker fields)
* code source/target — reference: preprocess/codes.py:20-49
* parsers — reference: utils/tfrecord.py:62-141,
  datasets/codes/dataset.py:66-97
* prediction results — reference: utils/tfrecord.py:144-219
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np

from .tfrecord import (bytes_feature, int64_feature, read_examples,
                       write_example)


# ------------------------------------------------------------------- sources

class SourceRecord(NamedTuple):
    id: int
    key: str
    source: np.ndarray           # (T,) int64 char ids
    source_length: int
    text: str
    speaker_id: int = 0
    age: int = 0
    gender: int = -1
    phone: Optional[np.ndarray] = None   # (T,) int64 phone ids
    phone_length: int = 0
    phone_txt: str = ""
    lang: str = ""
    accent_type: Optional[np.ndarray] = None  # (T,) int64 per-token accent
    #   ids, source-sequence domain (reference capability: hparams.py:55-62,
    #   EncoderV1WithAccentType / SelfAttentionCBHGEncoderWithAccentType)


def write_source_record(rec: SourceRecord, path: str,
                        with_speaker: bool = True,
                        with_phone: bool = False,
                        with_lang: bool = False) -> None:
    feats = {
        "id": int64_feature([rec.id]),
        "key": bytes_feature([rec.key.encode("utf-8")]),
        "source": bytes_feature([np.asarray(rec.source, np.int64).tobytes()]),
        "source_length": int64_feature([rec.source_length]),
        "text": bytes_feature([rec.text.encode("utf-8")]),
    }
    if with_speaker:
        feats["speaker_id"] = int64_feature([rec.speaker_id])
        feats["age"] = int64_feature([rec.age])
        feats["gender"] = int64_feature([rec.gender])
    if with_phone:
        phone = (rec.phone if rec.phone is not None
                 else np.zeros((0,), np.int64))
        feats["phone"] = bytes_feature([np.asarray(phone, np.int64).tobytes()])
        feats["phone_length"] = int64_feature([len(phone)])
        feats["phone_txt"] = bytes_feature([rec.phone_txt.encode("utf-8")])
    if with_lang:
        feats["lang"] = bytes_feature([rec.lang.encode("utf-8")])
    if rec.accent_type is not None:
        feats["accent_type"] = bytes_feature(
            [np.asarray(rec.accent_type, np.int64).tobytes()])
    write_example(feats, path)


def _get(example, name, default=None):
    if name not in example:
        return default
    return example[name][1]


def parse_source_record(example: dict) -> SourceRecord:
    source = np.frombuffer(_get(example, "source")[0], np.int64)
    phone_raw = _get(example, "phone")
    return SourceRecord(
        id=int(_get(example, "id")[0]),
        key=_get(example, "key")[0].decode("utf-8"),
        source=source,
        source_length=int(_get(example, "source_length")[0]),
        text=_get(example, "text")[0].decode("utf-8"),
        speaker_id=int(_get(example, "speaker_id", [0])[0]),
        age=int(_get(example, "age", [0])[0]),
        gender=int(_get(example, "gender", [-1])[0]),
        phone=(np.frombuffer(phone_raw[0], np.int64)
               if phone_raw is not None else None),
        phone_length=int(_get(example, "phone_length", [0])[0]),
        phone_txt=_get(example, "phone_txt", [b""])[0].decode("utf-8"),
        lang=_get(example, "lang", [b""])[0].decode("utf-8"),
        accent_type=(np.frombuffer(_get(example, "accent_type")[0], np.int64)
                     if _get(example, "accent_type") is not None else None),
    )


# --------------------------------------------------------------- mel targets

class MelTargetRecord(NamedTuple):
    id: int
    key: str
    mel: np.ndarray              # (T, num_mels) float32
    mel_width: int
    target_length: int


def write_mel_target_record(rec: MelTargetRecord, path: str) -> None:
    write_example({
        "id": int64_feature([rec.id]),
        "key": bytes_feature([rec.key.encode("utf-8")]),
        "mel": bytes_feature([np.asarray(rec.mel, np.float32).tobytes()]),
        "target_length": int64_feature([rec.target_length]),
        "mel_width": int64_feature([rec.mel_width]),
    }, path)


def parse_mel_target_record(example: dict) -> MelTargetRecord:
    width = int(_get(example, "mel_width")[0])
    length = int(_get(example, "target_length")[0])
    mel = np.frombuffer(_get(example, "mel")[0], np.float32).reshape(
        length, width)
    return MelTargetRecord(id=int(_get(example, "id")[0]),
                           key=_get(example, "key")[0].decode("utf-8"),
                           mel=mel, mel_width=width, target_length=length)


# -------------------------------------------------------------- code targets

class CodeTargetRecord(NamedTuple):
    id: int
    key: str
    lang: str
    codes: np.ndarray            # (T, num_codes) float32 one-hot
    codes_length: int
    codes_width: int


def write_code_target_record(rec: CodeTargetRecord, path: str) -> None:
    write_example({
        "id": int64_feature([rec.id]),
        "key": bytes_feature([rec.key.encode("utf-8")]),
        "lang": bytes_feature([rec.lang.encode("utf-8")]),
        "codes": bytes_feature([np.asarray(rec.codes, np.float32).tobytes()]),
        "codes_length": int64_feature([rec.codes_length]),
        "codes_width": int64_feature([rec.codes_width]),
    }, path)


def parse_code_target_record(example: dict) -> CodeTargetRecord:
    length = int(_get(example, "codes_length")[0])
    width = int(_get(example, "codes_width")[0])
    codes = np.frombuffer(_get(example, "codes")[0], np.float32).reshape(
        length, width)
    return CodeTargetRecord(id=int(_get(example, "id")[0]),
                            key=_get(example, "key")[0].decode("utf-8"),
                            lang=_get(example, "lang", [b""])[0].decode("utf-8"),
                            codes=codes, codes_length=length, codes_width=width)


# ------------------------------------------------------------ mgc+lf0 targets

class MgcLf0TargetRecord(NamedTuple):
    id: int
    key: str
    mgc: np.ndarray              # (T, mgc_width) float32
    mgc_width: int
    lf0: np.ndarray              # (T,) float32
    target_length: int


def write_mgc_lf0_target_record(rec: MgcLf0TargetRecord, path: str) -> None:
    write_example({
        "id": int64_feature([rec.id]),
        "key": bytes_feature([rec.key.encode("utf-8")]),
        "mgc": bytes_feature([np.asarray(rec.mgc, np.float32).tobytes()]),
        "mgc_width": int64_feature([rec.mgc_width]),
        "lf0": bytes_feature([np.asarray(rec.lf0, np.float32).tobytes()]),
        "target_length": int64_feature([rec.target_length]),
    }, path)


def parse_mgc_lf0_target_record(example: dict) -> MgcLf0TargetRecord:
    width = int(_get(example, "mgc_width")[0])
    length = int(_get(example, "target_length")[0])
    mgc = np.frombuffer(_get(example, "mgc")[0], np.float32).reshape(
        length, width)
    lf0 = np.frombuffer(_get(example, "lf0")[0], np.float32)
    return MgcLf0TargetRecord(id=int(_get(example, "id")[0]),
                              key=_get(example, "key")[0].decode("utf-8"),
                              mgc=mgc, mgc_width=width, lf0=lf0,
                              target_length=length)


# --------------------------------------------------------- prediction results

class PredictionRecord(NamedTuple):
    """reference: utils/tfrecord.py:144-157 (codes flavor)."""

    id: int
    key: str
    codes: np.ndarray
    ground_truth_codes: np.ndarray
    text: str
    source: np.ndarray


def write_prediction_record(rec: PredictionRecord, path: str) -> None:
    codes = np.asarray(rec.codes, np.float32)
    gt = np.asarray(rec.ground_truth_codes, np.float32)
    source = np.asarray(rec.source, np.int64)
    write_example({
        "id": int64_feature([rec.id]),
        "key": bytes_feature([rec.key.encode("utf-8")]),
        "codes": bytes_feature([codes.tobytes()]),
        "codes_length": int64_feature([codes.shape[0]]),
        "codes_width": int64_feature([codes.shape[1]]),
        "ground_truth_codes": bytes_feature([gt.tobytes()]),
        "ground_truth_codes_length": int64_feature([gt.shape[0]]),
        "text": bytes_feature([rec.text.encode("utf-8")]),
        "source": bytes_feature([source.tobytes()]),
        "source_length": int64_feature([source.shape[0]]),
    }, path)


def parse_prediction_record(example: dict) -> PredictionRecord:
    length = int(_get(example, "codes_length")[0])
    width = int(_get(example, "codes_width")[0])
    codes = np.frombuffer(_get(example, "codes")[0], np.float32).reshape(
        length, width)
    gt_len = int(_get(example, "ground_truth_codes_length")[0])
    gt = np.frombuffer(_get(example, "ground_truth_codes")[0], np.float32)
    gt = gt.reshape(gt_len, -1) if gt_len else gt.reshape(0, width)
    return PredictionRecord(
        id=int(_get(example, "id")[0]),
        key=_get(example, "key")[0].decode("utf-8"),
        codes=codes, ground_truth_codes=gt,
        text=_get(example, "text")[0].decode("utf-8"),
        source=np.frombuffer(_get(example, "source")[0], np.int64))


class MelPredictionRecord(NamedTuple):
    """reference: utils/tfrecord.py:183-219 (mel flavor)."""

    id: int
    key: str
    mel: np.ndarray
    ground_truth_mel: np.ndarray
    alignment: Optional[np.ndarray]
    text: str
    source: np.ndarray


def write_mel_prediction_record(rec: MelPredictionRecord, path: str) -> None:
    mel = np.asarray(rec.mel, np.float32)
    gt = np.asarray(rec.ground_truth_mel, np.float32)
    source = np.asarray(rec.source, np.int64)
    align = (np.asarray(rec.alignment, np.float32)
             if rec.alignment is not None else np.zeros((0,), np.float32))
    write_example({
        "id": int64_feature([rec.id]),
        "key": bytes_feature([rec.key.encode("utf-8")]),
        "mel": bytes_feature([mel.tobytes()]),
        "mel_length": int64_feature([mel.shape[0]]),
        "mel_width": int64_feature([mel.shape[1]]),
        "ground_truth_mel": bytes_feature([gt.tobytes()]),
        "ground_truth_mel_length": int64_feature([gt.shape[0]]),
        "alignment": bytes_feature([align.tobytes()]),
        "text": bytes_feature([rec.text.encode("utf-8")]),
        "source": bytes_feature([source.tobytes()]),
        "source_length": int64_feature([source.shape[0]]),
    }, path)


def parse_mel_prediction_record(example: dict) -> MelPredictionRecord:
    length = int(_get(example, "mel_length")[0])
    width = int(_get(example, "mel_width")[0])
    mel = np.frombuffer(_get(example, "mel")[0], np.float32).reshape(
        length, width)
    gt_len = int(_get(example, "ground_truth_mel_length")[0])
    gt = np.frombuffer(_get(example, "ground_truth_mel")[0],
                       np.float32).reshape(gt_len, width)
    return MelPredictionRecord(
        id=int(_get(example, "id")[0]),
        key=_get(example, "key")[0].decode("utf-8"),
        mel=mel, ground_truth_mel=gt, alignment=None,
        text=_get(example, "text")[0].decode("utf-8"),
        source=np.frombuffer(_get(example, "source")[0], np.int64))


class MgcLf0PredictionRecord(NamedTuple):
    """reference: utils/tfrecord.py:160-180 (mgc+lf0 flavor)."""

    id: int
    key: str
    mgc: np.ndarray
    ground_truth_mgc: np.ndarray
    lf0: np.ndarray
    ground_truth_lf0: np.ndarray
    alignments: List[np.ndarray]
    text: str
    source: np.ndarray
    accent_type: Optional[np.ndarray] = None


def write_mgc_lf0_prediction_record(rec: MgcLf0PredictionRecord,
                                    path: str) -> None:
    mgc = np.asarray(rec.mgc, np.float32)
    gt_mgc = np.asarray(rec.ground_truth_mgc, np.float32)
    lf0 = np.asarray(rec.lf0, np.float32)
    gt_lf0 = np.asarray(rec.ground_truth_lf0, np.float32)
    source = np.asarray(rec.source, np.int64)
    feats = {
        "id": int64_feature([rec.id]),
        "key": bytes_feature([rec.key.encode("utf-8")]),
        "mgc": bytes_feature([mgc.tobytes()]),
        "target_length": int64_feature([mgc.shape[0]]),
        "mgc_width": int64_feature([mgc.shape[1]]),
        "ground_truth_mgc": bytes_feature([gt_mgc.tobytes()]),
        "ground_truth_target_length": int64_feature([gt_mgc.shape[0]]),
        "lf0": bytes_feature([lf0.tobytes()]),
        "ground_truth_lf0": bytes_feature([gt_lf0.tobytes()]),
        "alignment": bytes_feature(
            [np.asarray(a, np.float32).tobytes() for a in rec.alignments]
            or [b""]),
        "text": bytes_feature([rec.text.encode("utf-8")]),
        "source": bytes_feature([source.tobytes()]),
        "source_length": int64_feature([source.shape[0]]),
        "accent_type": bytes_feature(
            [np.asarray(rec.accent_type, np.int64).tobytes()]
            if rec.accent_type is not None else [b""]),
    }
    write_example(feats, path)


def read_first_example(path: str) -> dict:
    return next(iter(read_examples(path)))
