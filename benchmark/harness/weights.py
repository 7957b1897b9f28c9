"""Weights from a seed, made on the device in one draw.

The rule is a frozen copy of the measured program's own initialiser
(Glorot-uniform for every matrix and conv kernel, -1 for a highway
transform gate's bias, 1 for a batch-norm scale and running variance, 0
for every other vector), applied to the names and shapes of the program's
state dict.  All matrices come from one ``torch.rand`` call on a
``torch.Generator`` of the device seeded with ``seed``, so the same seed
gives the same weights on the same kind of device.  ``stop_bias`` then
sets the stop-token head's bias: with random weights the stop token would
fire at the first step the decoder allows, and the benchmark's calls are
to decode to the recipe's cap.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterable, Optional, Tuple

import torch

STOP_BIAS_NAME = "decoder.stop_token_projection.bias"


def _fill(name: str) -> float:
    if re.search(r"highway_\d+\.T\.bias$", name):
        return -1.0
    if name.endswith(".gates.bias"):            # a GRU cell's gate bias
        return 1.0
    if name.endswith(("bn.weight", "running_var")):
        return 1.0
    return 0.0


def glorot_limit(shape: Tuple[int, ...]) -> float:
    if len(shape) == 3:                 # conv (out, in, K)
        fan_in, fan_out = shape[1] * shape[2], shape[0] * shape[2]
    else:                               # (out, in); (1, U) energy vectors
        fan_out, fan_in = shape[0], shape[1]
    return math.sqrt(6.0 / (fan_in + fan_out))


def make_weights(shapes: Iterable[Tuple[str, Tuple[int, ...]]], seed: int,
                 device, stop_bias: Optional[float] = None
                 ) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for the (name, shape) pairs."""
    shapes = [(n, tuple(s)) for n, s in shapes]
    mats = [(n, s) for n, s in shapes if len(s) >= 2]
    total = sum(math.prod(s) for _, s in mats)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    draw = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, shape in mats:
        n = math.prod(shape)
        out[name] = (draw[at:at + n] * glorot_limit(shape)).reshape(shape)
        at += n
    for name, shape in shapes:
        if len(shape) < 2:
            out[name] = torch.full(shape, _fill(name), device=device)
    if stop_bias is not None:
        out[STOP_BIAS_NAME] = torch.full_like(out[STOP_BIAS_NAME], stop_bias)
    return out
