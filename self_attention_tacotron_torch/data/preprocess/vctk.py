"""VCTK corpus preprocessing (0.8 wav layout and 0.91 flac/mic2 layout).

Parity targets:
* VCTK 0.8 — reference: preprocess/vctk.py:59-152: wav48/p*/ + txt/p*/ walk,
  speaker-info.txt (speaker 315 skipped), basic_cleaners char sources,
  trim + mel targets, per-utterance tfrecords, mel statistics.
* VCTK 0.91 — reference: preprocess/vctk_v091.py: ``*_mic2.flac`` audio,
  known-missing txt files skipped, speakers 315/362 skipped, and flite phone
  ids included in the source records.

FLAC decode for 0.91 needs an external decoder; ``flac -d`` is invoked when
available (the reference relies on librosa/audioread which shells out
similarly).  A copy of the JAX package's module; ``device`` is where
``Audio`` runs the STFT when ``hparams.preprocess_on_device``.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import List, NamedTuple, Optional

import numpy as np

from ...config import HParams
from ...text.cleaners import basic_cleaners
from ...text.flite import Flite
from ...text.symbols import text_to_sequence
from ...utils.audio import Audio, load_wav
from .. import records as R
from .common import (MelStatistics, SpeakerInfo, load_speaker_info,
                     parallel_map, reduce_mel_statistics)


class TxtWavRecord(NamedTuple):
    id: int
    key: str
    txt_path: str
    wav_path: str
    speaker_info: SpeakerInfo


class VCTK:
    """VCTK 0.8 (wav48 layout)."""

    speaker_skip = ("315",)
    audio_suffix = ".wav"

    def __init__(self, in_dir: str, out_dir: str, hparams: HParams,
                 speaker_info_filename: str = "speaker-info.txt",
                 device="cuda"):
        self.in_dir = in_dir
        self.out_dir = out_dir
        self.hparams = hparams
        self.audio = Audio(hparams, device)
        self.speaker_info_filename = speaker_info_filename
        self.g2p = None

    # ------------------------------------------------------------- listing
    def _audio_dir(self, speaker: SpeakerInfo) -> str:
        return os.path.join(self.in_dir, "wav48", f"p{speaker.id}")

    def _txt_dir(self, speaker: SpeakerInfo) -> str:
        return os.path.join(self.in_dir, "txt", f"p{speaker.id}")

    def _key_from_audio(self, filename: str) -> str:
        return os.path.basename(filename)[: -len(self.audio_suffix)]

    def list_files(self) -> List[TxtWavRecord]:
        records = []
        for si in load_speaker_info(
                os.path.join(self.in_dir, self.speaker_info_filename),
                self.speaker_skip):
            adir, tdir = self._audio_dir(si), self._txt_dir(si)
            if not os.path.isdir(adir) or not os.path.isdir(tdir):
                continue
            wavs = sorted(f for f in os.listdir(adir)
                          if f.endswith(self.audio_suffix))
            txts = sorted(f for f in os.listdir(tdir) if f.endswith(".txt"))
            txt_keys = {t[:-4]: t for t in txts}
            for w in wavs:
                key = self._key_from_audio(w)
                tk = key.replace("_mic2", "")
                if tk in txt_keys:
                    records.append(TxtWavRecord(
                        0, tk, os.path.join(tdir, txt_keys[tk]),
                        os.path.join(adir, w), si))
        return [TxtWavRecord(i, r.key, r.txt_path, r.wav_path, r.speaker_info)
                for i, r in enumerate(records)]

    # ------------------------------------------------------------ processing
    def process_sources(self, records: List[TxtWavRecord],
                        num_workers: int = 0) -> List[str]:
        return parallel_map(self._process_txt, records, num_workers)

    def process_targets(self, records: List[TxtWavRecord],
                        num_workers: int = 0) -> List[MelStatistics]:
        return parallel_map(self._process_wav, records, num_workers)

    def corpus_statistics(self, stats: List[MelStatistics]) -> dict:
        return reduce_mel_statistics(stats)

    def _load_audio(self, path: str) -> np.ndarray:
        return load_wav(path, self.hparams.sample_rate)

    def _process_wav(self, record: TxtWavRecord) -> MelStatistics:
        wav = self._load_audio(record.wav_path)
        wav = self.audio.trim(wav)
        mel = self.audio.melspectrogram(wav).astype(np.float32).T
        path = os.path.join(self.out_dir, f"{record.key}.target.tfrecord")
        R.write_mel_target_record(
            R.MelTargetRecord(record.id, record.key, mel, mel.shape[1],
                              len(mel)), path)
        return MelStatistics(id=record.id, key=record.key,
                             min=np.min(mel, axis=0), max=np.max(mel, axis=0),
                             sum=np.sum(mel, axis=0), length=len(mel),
                             moment2=np.sum(np.square(mel), axis=0))

    def _process_txt(self, record: TxtWavRecord) -> str:
        with open(record.txt_path, encoding="utf8") as f:
            txt = f.readline().rstrip("\n")
        sequence, clean_text = text_to_sequence(txt, basic_cleaners)
        source = np.array(sequence, dtype=np.int64)
        phone_ids, phone_txt = (self.g2p.convert_to_phoneme(clean_text)
                                if self.g2p is not None else (None, None))
        path = os.path.join(self.out_dir, f"{record.key}.source.tfrecord")
        R.write_source_record(
            R.SourceRecord(
                id=record.id, key=record.key, source=source,
                source_length=len(source), text=clean_text,
                speaker_id=record.speaker_info.id,
                age=record.speaker_info.age,
                gender=record.speaker_info.gender,
                phone=(np.array(phone_ids, np.int64)
                       if phone_ids is not None else None),
                phone_length=len(phone_ids) if phone_ids is not None else 0,
                phone_txt=phone_txt or ""),
            path, with_speaker=True, with_phone=self.g2p is not None)
        return record.key


class VCTK_v091(VCTK):
    """VCTK 0.91: ``wav48_silence_trimmed/p*/**_mic2.flac`` audio + flite
    phones (reference: preprocess/vctk_v091.py:97-134)."""

    speaker_skip = ("315", "362")
    audio_suffix = "_mic2.flac"
    missing_txt = ("s5_052.txt", "s5_219.txt")

    def __init__(self, in_dir: str, out_dir: str, hparams: HParams,
                 speaker_info_filename: str = "speaker-info.txt",
                 device="cuda"):
        super().__init__(in_dir, out_dir, hparams, speaker_info_filename,
                         device)
        if hparams.phoneme == "flite":
            g2p = Flite(hparams.flite_binary_path,
                        hparams.phoneset_path or "uscmu")
            self.g2p = g2p if g2p.available() else None

    def _audio_dir(self, speaker: SpeakerInfo) -> str:
        for cand in ("wav48_silence_trimmed", "wav48"):
            d = os.path.join(self.in_dir, cand, f"p{speaker.id}")
            if os.path.isdir(d):
                return d
        return os.path.join(self.in_dir, "wav48", f"p{speaker.id}")

    def _load_audio(self, path: str) -> np.ndarray:
        if path.endswith(".flac"):
            if shutil.which("flac") is None:
                raise RuntimeError("flac decoder not available for " + path)
            with tempfile.NamedTemporaryFile(suffix=".wav") as tmp:
                subprocess.run(["flac", "-d", "-f", "-s", "-o", tmp.name,
                                path], check=True)
                return load_wav(tmp.name, self.hparams.sample_rate)
        return super()._load_audio(path)
