"""Conv1d + batch norm, highway layer and the CBHG conv bank.

Counterpart of the JAX package's ``ops/conv.py``.  Layout stays (B, T, C)
at every public function.  flax's SAME padding of a width-K convolution
pads (K - 1) // 2 on the left and K // 2 on the right, which is asymmetric
for an even K (the conv bank has widths 1..16); ``conv1d_same`` keeps that.
Batch norm follows flax's ``BatchNorm`` (not ``torch.nn.BatchNorm1d``):
epsilon 1e-3; in training it normalises by the batch statistics with the
biased variance and moves the running statistics at momentum 0.99
(``running = 0.99 * running + 0.01 * batch``).  ``bn_valid_rows`` scopes a
(B,) row-validity mask over the training statistics, so that rows padded
with duplicates (``data/dataset.py`` ``pad_model_batch_rows``) stay out.
Under a data axis (``ops/collectives.py``) the training statistics are the
global batch's: the weighted count, sum and sum of squares are summed over
the ranks, with their gradient, so the running statistics come out the
same on every rank.

Model-wide bf16 (``ops/compute_dtype.py``): each module's ``dtype`` is that
of its result.  ``Conv1d`` casts its input, weight and bias to it (the
bias added after the product, as flax's ``Conv``); ``BatchNorm`` takes its
statistics and normalises in float32 against its float32 scale, bias and
running statistics and returns ``dtype`` (flax's ``BatchNorm(dtype=bf16)``
with ``force_float32_reductions``); the highway layer and the max pool run
in their input's dtype.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .collectives import current_axis, global_sum
from .compute_dtype import Linear, cast, sigmoid

BN_EPSILON = 1e-3
BN_MOMENTUM = 0.99

_BN_VALID_ROWS: contextvars.ContextVar = contextvars.ContextVar(
    "bn_valid_rows", default=None)


@contextlib.contextmanager
def bn_valid_rows(mask: Optional[torch.Tensor]):
    """Scope a (B,) bool row-validity mask over every training batch-norm
    statistic computed inside the context (None: all rows)."""
    token = _BN_VALID_ROWS.set(mask)
    try:
        yield
    finally:
        _BN_VALID_ROWS.reset(token)


def conv1d_same(xs: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, T, Cin) conv (Cout, Cin, K) with flax SAME padding -> (B, T, Cout)."""
    K = weight.shape[-1]
    x = F.pad(xs.transpose(1, 2), ((K - 1) // 2, K // 2))
    return F.conv1d(x, weight, bias).transpose(1, 2)


class Conv1d(nn.Module):
    """SAME-padded convolution; ``weight`` (out, in, K) is the flax
    kernel (K, in, out) permuted."""

    dtype = torch.float32

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, use_bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size))
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if use_bias
                     else None)

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return conv1d_same(xs, self.weight, self.bias)
        y = conv1d_same(xs.to(self.dtype), cast(self, self.weight, self.dtype))
        return (y if self.bias is None
                else y + cast(self, self.bias, self.dtype))


class BatchNorm(nn.Module):
    """Batch norm over the last axis: running statistics at inference,
    batch statistics (and a running update) in training; float32 inside,
    ``dtype`` out."""

    dtype = torch.float32

    def __init__(self, channels: int, epsilon: float = BN_EPSILON):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self._normalize(x.float(), train).to(self.dtype)

    def _normalize(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if not train:
            mul = torch.rsqrt(self.running_var + self.epsilon) * self.weight
            return (x - self.running_mean) * mul + self.bias
        rows = x.reshape(-1, x.shape[-1])
        valid = _BN_VALID_ROWS.get()
        if valid is None:
            w = torch.ones(rows.shape[0], 1, dtype=x.dtype, device=x.device)
        else:   # (B,) -> one weight per (B, T) row
            w = valid.to(x.dtype).reshape(-1, *([1] * (x.dim() - 2)))
            w = w.expand(*x.shape[:-1]).reshape(-1, 1)
        count, s1, s2 = w.sum(), (rows * w).sum(0), (rows.square() * w).sum(0)
        if current_axis() is not None:
            # the global batch's statistics, as GSPMD computes them over a
            # sharded batch: one sum of [count, s1, s2] over the ranks
            C = s1.shape[0]
            total = global_sum(torch.cat([count[None], s1, s2]), True)
            count, s1, s2 = total[0], total[1:C + 1], total[C + 1:]
        mean = s1 / count
        # flax's fast variance: E[x^2] - E[x]^2, clipped at 0 (biased)
        var = torch.clamp(s2 / count - mean.square(), min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(BN_MOMENTUM).add_(
                (1.0 - BN_MOMENTUM) * mean.detach())
            self.running_var.mul_(BN_MOMENTUM).add_(
                (1.0 - BN_MOMENTUM) * var.detach())
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        return (x - mean) * mul + self.bias


class Conv1dBN(nn.Module):
    """conv1d (SAME, bias-free) -> batch norm -> activation."""

    def __init__(self, in_channels: int, kernel_size: int, out_channels: int,
                 activation: Optional[Callable] = torch.relu):
        super().__init__()
        self.conv = Conv1d(in_channels, out_channels, kernel_size)
        self.bn = BatchNorm(out_channels)
        self.activation = activation

    def forward(self, xs: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = self.bn(self.conv(xs), train)
        return self.activation(h) if self.activation is not None else h


class HighwayNet(nn.Module):
    """T * relu(H x) + (1 - T) * x with T = sigmoid(T x)."""

    def __init__(self, in_units: int, out_units: int):
        super().__init__()
        self.H = Linear(in_units, out_units)
        self.T = Linear(in_units, out_units)

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.H(xs))
        t = sigmoid(self.T(xs))
        return h * t + xs * (1.0 - t)


def max_pool_same(xs: torch.Tensor, pool_size: int = 2) -> torch.Tensor:
    """Width-``pool_size`` stride-1 SAME max pool over axis 1 of (B, T, C)."""
    lo = (pool_size - 1) // 2
    hi = pool_size - 1 - lo
    neg = torch.finfo(xs.dtype).min
    padded = F.pad(xs.transpose(1, 2), (lo, hi), value=neg).transpose(1, 2)
    T = xs.shape[1]
    return torch.stack([padded[:, i:i + T] for i in range(pool_size)]).amax(0)


class ConvBank(nn.Module):
    """Conv1dBN of widths 1..max_filter_width, channel concat, then a
    width-2 stride-1 max pool (the CBHG front end)."""

    def __init__(self, in_channels: int, max_filter_width: int,
                 conv_channels: int):
        super().__init__()
        self.max_filter_width = max_filter_width
        for k in range(1, max_filter_width + 1):
            self.add_module(f"conv1d_K{k}",
                            Conv1dBN(in_channels, k, conv_channels))

    def forward(self, xs: torch.Tensor, train: bool = False) -> torch.Tensor:
        outs = [getattr(self, f"conv1d_K{k}")(xs, train)
                for k in range(1, self.max_filter_width + 1)]
        return max_pool_same(torch.cat(outs, dim=-1), 2)
