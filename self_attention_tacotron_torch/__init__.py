"""self_attention_tacotron_torch — the PyTorch / CUDA port of
``self_attention_tacotron_tpu`` for one NVIDIA H100.

The port mirrors the JAX package's layout and names:
  config    — hparams tree and its JSON / comma-string layering (a copy)
  data      — TFRecord codec, record schemas, the batch-1 serving reader
  utils     — the weight bridge from the JAX parameter tree, checkpoints
  ops       — zoneout LSTM, CBHG convs, multi-head attention, and the two
              serving kernels (CUDA C++ for sm_90a under ``ops/csrc``)
  models    — embedding, prenet, attention mechanisms, encoder, decoder,
              model assembly (inference)
  cli       — ``predict`` (VQ-code serving)

It imports ``torch`` and numpy only; nothing of JAX or of the JAX package.
"""

__version__ = "0.1.0"

from .config import HParams, default_hparams, hparams_debug_string

__all__ = ["HParams", "default_hparams", "hparams_debug_string", "__version__"]
