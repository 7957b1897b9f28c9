"""self_attention_tacotron_torch — the PyTorch / CUDA port of
``self_attention_tacotron_tpu`` for one NVIDIA H100.

The port mirrors the JAX package's layout and names:
  config    — hparams tree and its JSON / comma-string layering (a copy)
  text      — symbols, cleaners, number normalisation, phone sets, flite
              (copies)
  data      — TFRecord codec, record schemas, the corpus preprocessors
              (LJSpeech, VCTK, VQ codes), the batch-1 serving reader and
              the bucketed training pipeline (codes and mel targets)
  utils     — the numpy audio DSP (a copy), the weight bridge from the JAX
              parameter tree, checkpoints (retention, resume, warm start),
              scalar metrics (JSONL and TensorBoard events)
  ops       — zoneout LSTM, CBHG convs, multi-head attention, losses, the
              counter-based training masks, the STFT / mel extractor, and
              seven kernels (CUDA C++ for sm_90a under ``ops/csrc``): the
              serving encoder and decode, the training trunk's forward and
              backward, the Pallas attention mode's full-sequence and
              KV-cache attention, and the spectrogram
  models    — embedding, prenet, attention mechanisms, encoders, decoder,
              postnet, model assembly (training, validation and
              inference) of the VQ-code and mel kinds, the loss
  parallel  — the training and evaluation steps on one device (clip,
              Adam, noam)
  cli       — ``preprocess``, ``train`` and ``predict`` (VQ codes, mels)

It imports ``torch`` and numpy only; nothing of JAX or of the JAX package.
"""

__version__ = "0.1.0"

from .config import HParams, default_hparams, hparams_debug_string

__all__ = ["HParams", "default_hparams", "hparams_debug_string", "__version__"]
