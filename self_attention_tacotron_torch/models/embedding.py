"""Embedding tables: ids shifted down by ``index_offset``, clipped, looked up.

Counterpart of the JAX package's ``models/embedding.py``: ``Embedding``
(``weight`` (num_symbols, dim) is the flax ``embedding`` parameter) and
``ExternalEmbedding``, a (num_speakers, dim) table read from a ``.npy``,
``.npz`` (its first array) or text file and kept frozen: a buffer that is
neither a parameter nor part of the state dict, loaded again whenever the
model is built, as the JAX package keeps it in a ``constants`` collection
outside the gradients and the optimizer.  Both return their float32 rows
cast to their ``dtype`` (``ops/compute_dtype.py``), as the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


class Embedding(nn.Module):
    dtype = torch.float32

    def __init__(self, num_symbols: int, embedding_dim: int,
                 index_offset: int = 0):
        super().__init__()
        self.num_symbols = num_symbols
        self.index_offset = index_offset
        self.weight = nn.Parameter(torch.empty(num_symbols, embedding_dim))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        idx = torch.clamp(ids.long() - self.index_offset, 0,
                          self.num_symbols - 1)
        return self.weight[idx].to(self.dtype)


def load_external_embedding(path: str) -> np.ndarray:
    """Load a (num_speakers, dim) embedding matrix from .npy/.npz/.txt."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    if path.endswith(".npz"):
        data = np.load(path)
        return data[list(data.keys())[0]].astype(np.float32)
    return np.loadtxt(path, dtype=np.float32)


class ExternalEmbedding(nn.Module):
    """File-backed, non-trainable embedding."""

    dtype = torch.float32

    def __init__(self, embedding_file: str, num_speakers: int,
                 embedding_dim: int, index_offset: int = 0):
        super().__init__()
        table = load_external_embedding(embedding_file)
        if table.shape != (num_speakers, embedding_dim):
            raise ValueError(f"external embedding shape {table.shape} != "
                             f"({num_speakers}, {embedding_dim})")
        self.num_speakers = num_speakers
        self.index_offset = index_offset
        self.register_buffer("table", torch.from_numpy(table),
                             persistent=False)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        idx = torch.clamp(ids.long() - self.index_offset, 0,
                          self.num_speakers - 1)
        return self.table[idx].to(self.dtype)
