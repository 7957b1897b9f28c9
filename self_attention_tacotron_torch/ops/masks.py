"""Counter-based random masks shared by the training kernels and their plain
versions.

The JAX training kernel draws its dropout and zoneout masks from the TPU's
generator keyed on (seed, step) and regenerates them in its backward.  Here
one 32-bit integer hash keyed on (seed, step, mask id, row, column) does
that job.  It is written twice, with identical bits: ``mask_uniform`` below
in torch integer ops, and ``mask_uniform`` in ``csrc/masks.cuh`` for the
kernels.  Five rounds of the ``lowbias32`` mixer (one per key) give a
32-bit value whose top 24 bits, times 2^-24, are a float32 uniform in
[0, 1) with no rounding.  A unit is kept where that uniform is >= the rate
(compared in float32), as flax's dropout and the JAX zoneout keep the new
value with probability 1 - rate.
"""

from __future__ import annotations

import torch

# mask ids: prenet layer i uses id i (i < 4), then the zoneout masks
MASK_ZC_ATT, MASK_ZO_ATT = 4, 5
MASK_ZC1, MASK_ZO1, MASK_ZC2, MASK_ZO2 = 6, 7, 8, 9

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for int64 ``x`` holding uint32 values, without an
    int64 overflow (the 16-bit halves of ``c`` keep products < 2^49)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def mask_uniform(seed: int, step: int, mask_id: int, rows: int, cols: int,
                 device=None) -> torch.Tensor:
    """(rows, cols) float32 uniforms in [0, 1) for one (seed, step, mask)."""
    h = torch.tensor((int(seed) & _M32) ^ 0x9E3779B9, dtype=torch.int64,
                     device=device)
    h = _mix32(h)
    h = _mix32(h ^ (int(step) & _M32))
    h = _mix32(h ^ int(mask_id))
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    h = _mix32(_mix32(h ^ r) ^ c)
    return (h >> 8).to(torch.float32) * (2.0 ** -24)


def keep_mask(seed: int, step: int, mask_id: int, rows: int, cols: int,
              rate: float, device=None) -> torch.Tensor:
    """(rows, cols) float32 {0, 1}: 1 where the unit keeps its new value."""
    u = mask_uniform(seed, step, mask_id, rows, cols, device)
    return (u >= torch.tensor(rate, dtype=torch.float32)).to(torch.float32)
