"""PreNet stack at inference: Dense -> ReLU per layer (dropout is off).

Counterpart of the JAX package's ``models/prenet.py`` ``PreNet`` and
``PreNetStack`` without speaker conditioning (``MultiSpeakerPreNet`` and
inference-time dropout come with a later slice).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class PreNet(nn.Module):
    def __init__(self, in_units: int, out_units: int):
        super().__init__()
        self.dense = nn.Linear(in_units, out_units)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.dense(x))


class PreNetStack(nn.Module):
    def __init__(self, in_units: int, out_units: Sequence[int]):
        super().__init__()
        self.num_layers = len(out_units)
        for i, units in enumerate(out_units):
            self.add_module(f"prenet_{i}", PreNet(in_units, units))
            in_units = units

    def layers(self):
        return [getattr(self, f"prenet_{i}") for i in range(self.num_layers)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers():
            x = layer(x)
        return x
