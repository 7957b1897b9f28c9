"""self_attention_tacotron_torch — the PyTorch / CUDA port of
``self_attention_tacotron_tpu`` for one NVIDIA H100.

The port mirrors the JAX package's layout and names:
  config    — hparams tree and its JSON / comma-string layering (a copy)
  data      — TFRecord codec, record schemas, the batch-1 serving reader
              and the bucketed training pipeline (codes targets)
  utils     — the weight bridge from the JAX parameter tree, checkpoints
              (retention, resume, warm start), scalar metrics (JSONL and
              TensorBoard events)
  ops       — zoneout LSTM, CBHG convs, multi-head attention, losses, the
              counter-based training masks, and six kernels (CUDA C++ for
              sm_90a under ``ops/csrc``): the serving encoder and decode,
              the training trunk's forward and backward, and the Pallas
              attention mode's full-sequence and KV-cache attention
  models    — embedding, prenet, attention mechanisms, encoder, decoder,
              model assembly (training, validation and inference), the loss
  parallel  — the training and evaluation steps on one device (clip,
              Adam, noam)
  cli       — ``train`` and ``predict`` (VQ codes)

It imports ``torch`` and numpy only; nothing of JAX or of the JAX package.
"""

__version__ = "0.1.0"

from .config import HParams, default_hparams, hparams_debug_string

__all__ = ["HParams", "default_hparams", "hparams_debug_string", "__version__"]
