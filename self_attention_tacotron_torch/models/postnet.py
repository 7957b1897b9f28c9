"""The postnets: Tacotron 2's conv stack and the original post-CBHG.

Counterpart of the JAX package's ``models/postnet.py`` ``PostNetV2``
(selected by ``use_postnet_v2``): N - 1 x (conv -> batch norm -> tanh ->
dropout), then conv -> batch norm -> dropout and a projection back to the
mel width; the model adds the residual to the decoder's frames.  With a
speaker embedding (``speaker_embedd_to_postnet``) its projection to
``out_channels`` is tiled over time and concatenated to the first conv's
input, as the JAX package's ``PostNetV2`` does (its
``MultiSpeakerPostNet`` is the same class).
Dropout is flax's, drawn from the caller's ``torch.Generator`` in
training.  ``PostNetCBHG`` is the original Tacotron's: mel frames -> CBHG
(the bi-GRU one) -> a dense to ``num_freq`` linear-spectrogram bins (the
``post_net_*`` hparams); like the JAX package's, no model builds it.
Every layer computes in its ``dtype`` (``ops/compute_dtype.py``).
Submodule names follow the flax tree (``conv_<i>``, ``projection``,
``speaker_projection``; ``cbhg``, ``linear_projection``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.attention_core import dropout
from ..ops.compute_dtype import Linear
from ..ops.conv import Conv1dBN
from .encoders import CBHG


class PostNetV2(nn.Module):
    def __init__(self, out_units: int, num_layers: int = 5,
                 kernel_size: int = 5, out_channels: int = 512,
                 drop_rate: float = 0.5, speaker_dim: Optional[int] = None):
        super().__init__()
        self.num_layers = num_layers
        self.drop_rate = drop_rate
        in_channels = out_units
        if speaker_dim is not None:
            self.speaker_projection = Linear(speaker_dim, out_channels)
            in_channels += out_channels
        for i in range(num_layers):
            act = torch.tanh if i < num_layers - 1 else None
            self.add_module(f"conv_{i}", Conv1dBN(in_channels, kernel_size,
                                                  out_channels, act))
            in_channels = out_channels
        self.projection = Linear(out_channels, out_units)

    def forward(self, xs: torch.Tensor, is_training: bool = False,
                generator: Optional[torch.Generator] = None,
                speaker_embed: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T, out_units) frames -> the (B, T, out_units) residual."""
        h = xs
        if speaker_embed is not None:
            s = self.speaker_projection(speaker_embed)
            h = torch.cat([h, s[:, None, :].expand(-1, h.shape[1], -1)], -1)
        for i in range(self.num_layers):
            h = getattr(self, f"conv_{i}")(h, is_training)
            if is_training:
                h = dropout(h, self.drop_rate, generator)
        return self.projection(h)


class PostNetCBHG(nn.Module):
    """(B, T, in_channels) mel frames -> CBHG -> (B, T, out_dim)."""

    def __init__(self, in_channels: int, out_dim: int,
                 cbhg_out_units: int = 256, conv_channels: int = 128,
                 max_filter_width: int = 8,
                 projection1_out_channels: int = 256,
                 projection2_out_channels: int = 80, num_highway: int = 4):
        super().__init__()
        self.cbhg = CBHG(in_channels, cbhg_out_units, conv_channels,
                         max_filter_width, projection1_out_channels,
                         projection2_out_channels, num_highway)
        self.linear_projection = Linear(cbhg_out_units // 2 * 2, out_dim)

    def forward(self, xs: torch.Tensor, input_lengths=None,
                is_training: bool = False) -> torch.Tensor:
        return self.linear_projection(self.cbhg(xs, input_lengths,
                                                is_training))
