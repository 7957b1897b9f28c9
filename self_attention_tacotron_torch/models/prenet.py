"""PreNet stack: Dense -> ReLU -> dropout per layer (dropout in training).

Counterpart of the JAX package's ``models/prenet.py`` ``PreNet`` and
``PreNetStack`` without speaker conditioning (``MultiSpeakerPreNet`` and
inference-time dropout come with a later slice).  Dropout is flax's
(``ops/attention_core.py`` ``dropout``), drawn from an explicit
``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.attention_core import dropout


class PreNet(nn.Module):
    def __init__(self, in_units: int, out_units: int, drop_rate: float = 0.5):
        super().__init__()
        self.drop_rate = drop_rate
        self.dense = nn.Linear(in_units, out_units)

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = torch.relu(self.dense(x))
        return dropout(h, self.drop_rate, generator) if training else h


class PreNetStack(nn.Module):
    def __init__(self, in_units: int, out_units: Sequence[int],
                 drop_rate: float = 0.5):
        super().__init__()
        self.num_layers = len(out_units)
        self.drop_rate = drop_rate
        for i, units in enumerate(out_units):
            self.add_module(f"prenet_{i}", PreNet(in_units, units, drop_rate))
            in_units = units

    def layers(self):
        return [getattr(self, f"prenet_{i}") for i in range(self.num_layers)]

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for layer in self.layers():
            x = layer(x, training, generator)
        return x
