"""Embedding table: ids shifted down by ``index_offset``, clipped, looked up.

Counterpart of the JAX package's ``models/embedding.py`` ``Embedding``;
``weight`` (num_symbols, dim) is the flax ``embedding`` parameter.
"""

from __future__ import annotations

import torch
from torch import nn


class Embedding(nn.Module):
    def __init__(self, num_symbols: int, embedding_dim: int,
                 index_offset: int = 0):
        super().__init__()
        self.num_symbols = num_symbols
        self.index_offset = index_offset
        self.weight = nn.Parameter(torch.empty(num_symbols, embedding_dim))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        idx = torch.clamp(ids.long() - self.index_offset, 0,
                          self.num_symbols - 1)
        return self.weight[idx]
