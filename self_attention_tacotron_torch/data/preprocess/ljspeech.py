"""LJSpeech corpus preprocessing.

Parity target: reference preprocess/ljspeech.py:75-138 and
preprocess/ljspeech_wavenet.py:56-65 — metadata.csv walk, english_cleaners,
mel extraction per utterance, per-utterance ``<key>.{source,target}.tfrecord``
files, corpus mel statistics, and the WaveNet-vocoder export of normalized
``.mfbsp`` mel + wav pairs.  A copy of the JAX package's module; ``device``
is where ``Audio`` runs the STFT when ``hparams.preprocess_on_device``.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional

import numpy as np

from ...config import HParams
from ...text.cleaners import english_cleaners
from ...text.symbols import text_to_sequence
from ...utils.audio import Audio
from .. import records as R
from .common import MelStatistics, parallel_map, reduce_mel_statistics


class TextAndPath(NamedTuple):
    id: int
    key: str
    wav_path: str
    labels_path: Optional[str]
    text: str


class LJSpeech:
    def __init__(self, in_dir: str, out_dir: str, hparams: HParams,
                 device="cuda"):
        self.in_dir = in_dir
        self.out_dir = out_dir
        self.hparams = hparams
        self.audio = Audio(hparams, device)

    def list_files(self) -> List[TextAndPath]:
        items = []
        with open(os.path.join(self.in_dir, "metadata.csv"),
                  encoding="utf-8") as f:
            for index, line in enumerate(f):
                parts = line.strip().split("|")
                key = parts[0]
                text = parts[2] if len(parts) > 2 else parts[-1]
                wav_path = os.path.join(self.in_dir, "wavs", f"{key}.wav")
                items.append(TextAndPath(index, key, wav_path, None, text))
        return items

    def process_sources(self, items: List[TextAndPath],
                        num_workers: int = 0) -> List[str]:
        return parallel_map(self._process_source, items, num_workers)

    def process_targets(self, items: List[TextAndPath],
                        num_workers: int = 0) -> List[MelStatistics]:
        return parallel_map(self._process_target, items, num_workers)

    def corpus_statistics(self, stats: List[MelStatistics]) -> dict:
        return reduce_mel_statistics(stats)

    def _process_source(self, item: TextAndPath) -> str:
        sequence, clean_text = text_to_sequence(item.text, english_cleaners)
        source = np.array(sequence, dtype=np.int64)
        path = os.path.join(self.out_dir, f"{item.key}.source.tfrecord")
        R.write_source_record(
            R.SourceRecord(id=item.id, key=item.key, source=source,
                           source_length=len(source), text=clean_text),
            path, with_speaker=False)
        return item.key

    def _process_target(self, item: TextAndPath) -> MelStatistics:
        wav = self.audio.load_wav(item.wav_path)
        mel = self.audio.melspectrogram(wav).astype(np.float32).T
        path = os.path.join(self.out_dir, f"{item.key}.target.tfrecord")
        R.write_mel_target_record(
            R.MelTargetRecord(item.id, item.key, mel, mel.shape[1], len(mel)),
            path)
        return MelStatistics(id=item.id, key=item.key,
                             min=np.min(mel, axis=0), max=np.max(mel, axis=0),
                             sum=np.sum(mel, axis=0), length=len(mel),
                             moment2=np.sum(np.square(mel), axis=0))


class LJSpeechWaveNet(LJSpeech):
    """Normalized-mel ``.mfbsp`` + wav export for WaveNet vocoder training
    (reference: preprocess/ljspeech_wavenet.py:56-65)."""

    def __init__(self, in_dir: str, mel_out_dir: str, wav_out_dir: str,
                 hparams: HParams, device="cuda"):
        super().__init__(in_dir, mel_out_dir, hparams, device)
        self.mel_out_dir = mel_out_dir
        self.wav_out_dir = wav_out_dir

    def process_wavs(self, items: List[TextAndPath],
                     num_workers: int = 0) -> List[str]:
        return parallel_map(self._process_wav, items, num_workers)

    def _process_wav(self, item: TextAndPath) -> str:
        wav = self.audio.load_wav(item.wav_path)
        mel = self.audio.melspectrogram(wav).astype(np.float32).T
        mel = self.audio.normalize_mel(mel)
        mel_path = os.path.join(self.mel_out_dir, f"{item.key}.mfbsp")
        wav_path = os.path.join(self.wav_out_dir, f"{item.key}.wav")
        mel.tofile(mel_path, format="<f4")
        self.audio.save_wav(wav, wav_path)
        return item.key
