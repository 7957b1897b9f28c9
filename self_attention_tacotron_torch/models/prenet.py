"""PreNet stack: Dense -> ReLU -> dropout per layer (dropout in training).

Counterpart of the JAX package's ``models/prenet.py``: ``PreNet``,
``MultiSpeakerPreNet`` (dense0 -> ReLU -> + softsign(speaker projection)
-> dense -> ReLU -> dropout; no dropout after dense0) and ``PreNetStack``,
whose first layer is a ``MultiSpeakerPreNet`` with ``use_speaker_embed``.
With ``apply_dropout_on_inference`` a ``PreNet`` drops out outside
training too (VALIDATION and INFERENCE); a ``MultiSpeakerPreNet`` never
does, as in the JAX package.  Dropout is flax's (``ops/attention_core.py``
``dropout``), drawn from an explicit ``torch.Generator``.  Each dense
computes in its ``dtype`` (``ops/compute_dtype.py``), and so does the
dropout after it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.attention_core import dropout
from ..ops.compute_dtype import Linear


class PreNet(nn.Module):
    def __init__(self, in_units: int, out_units: int, drop_rate: float = 0.5,
                 apply_dropout_on_inference: bool = False):
        super().__init__()
        self.drop_rate = drop_rate
        self.apply_dropout_on_inference = apply_dropout_on_inference
        self.dense = Linear(in_units, out_units)

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = torch.relu(self.dense(x))
        if training or self.apply_dropout_on_inference:
            return dropout(h, self.drop_rate, generator)
        return h


class MultiSpeakerPreNet(nn.Module):
    def __init__(self, in_units: int, out_units: int, speaker_dim: int,
                 drop_rate: float = 0.5):
        super().__init__()
        self.drop_rate = drop_rate
        self.dense0 = Linear(in_units, out_units)
        self.speaker_projection = Linear(speaker_dim, out_units)
        self.dense = Linear(out_units, out_units)

    def speaker_row(self, speaker_embed: torch.Tensor,
                    float32: bool = False) -> torch.Tensor:
        """softsign(speaker projection): the (B, out) row added after
        dense0's ReLU, constant over the steps of a decode; with
        ``float32`` computed in float32 from the upcast embedding whatever
        the ``dtype`` (the fused kernels' operand, as the JAX package's
        ``_fused_prenet_params`` makes it)."""
        p = self.speaker_projection
        s = (nn.functional.linear(speaker_embed.float(), p.weight, p.bias)
             if float32 else p(speaker_embed))
        return nn.functional.softsign(s)

    def forward(self, x: torch.Tensor, speaker_embed: torch.Tensor,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = torch.relu(self.dense0(x)) + self.speaker_row(speaker_embed)
        h = torch.relu(self.dense(h))
        return dropout(h, self.drop_rate, generator) if training else h


class PreNetStack(nn.Module):
    def __init__(self, in_units: int, out_units: Sequence[int],
                 drop_rate: float = 0.5, speaker_dim: Optional[int] = None,
                 apply_dropout_on_inference: bool = False):
        super().__init__()
        self.num_layers = len(out_units)
        self.drop_rate = drop_rate
        self.use_speaker_embed = speaker_dim is not None
        for i, units in enumerate(out_units):
            layer = (MultiSpeakerPreNet(in_units, units, speaker_dim,
                                        drop_rate)
                     if i == 0 and self.use_speaker_embed
                     else PreNet(in_units, units, drop_rate,
                                 apply_dropout_on_inference))
            self.add_module(f"prenet_{i}", layer)
            in_units = units

    def layers(self):
        return [getattr(self, f"prenet_{i}") for i in range(self.num_layers)]

    def dense_layers(self):
        """The stack's dense layers in order (a speaker prenet gives two,
        dense0 and dense) and, per layer, whether dropout follows it."""
        denses, drops = [], []
        for layer in self.layers():
            if isinstance(layer, MultiSpeakerPreNet):
                denses += [layer.dense0, layer.dense]
                drops += [False, True]
            else:
                denses.append(layer.dense)
                drops.append(True)
        return denses, tuple(drops)

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None,
                speaker_embed: Optional[torch.Tensor] = None) -> torch.Tensor:
        for layer in self.layers():
            if isinstance(layer, MultiSpeakerPreNet):
                x = layer(x, speaker_embed, training, generator)
            else:
                x = layer(x, training, generator)
        return x
