"""Zoneout LSTM and GRU cells and the bidirectional length-masked unroll.

Counterpart of the JAX package's ``ops/rnn.py``:
* ``ZoneoutLSTMCell`` — gate order i, g, f, o; the +1.0 forget bias is
  added at call time and not stored; zoneout is the deterministic
  inference mix ``(1 - z) * new + z * prev``, and in training each unit
  keeps its new value with probability 1 - z (``_zoneout``, drawn from an
  explicit ``torch.Generator``).
* ``BiZoneoutLSTM`` — ``tf.nn.bidirectional_dynamic_rnn`` with
  ``sequence_length``: carries freeze and outputs are zero past each row's
  length; the backward cell runs over the per-row length-reversed sequence.
* ``GRUCell`` — TF semantics: reset and update gates sigmoid([x, h] W_g +
  b_g) (b_g starts at 1.0), candidate tanh([x, r * h] W_c + b_c),
  ``h' = u * h + (1 - u) * cand``;
* ``BiGRU`` — the same bidirectional unroll over two GRU cells (the
  non-zoneout CBHG's recurrence).

Parameter layout: ``weight`` (4u, in + u) is the JAX kernel (in + u, 4u)
transposed (``utils/convert.py``), ``bias`` (4u,); a GRU cell's ``gates``
and ``candidate`` are linear layers whose weights are the JAX
``gates/kernel`` (in + u, 2u) and ``candidate/kernel`` (in + u, u)
transposed.

Model-wide bf16 (``ops/compute_dtype.py``): a cell casts [x, h] and its
float32 weights to its ``dtype``, and its carries start (and stay) in that
dtype, as the JAX package's cells.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .compute_dtype import Linear, cast, sigmoid, weak

Carry = Tuple[torch.Tensor, torch.Tensor]


def lstm_update(gates: torch.Tensor, c_prev: torch.Tensor,
                h_prev: torch.Tensor, zoneout_cell: float,
                zoneout_output: float, forget_bias: float = 0.0) -> Carry:
    """Zoneout LSTM update from gate pre-activations (i, g, f, o) ->
    (c, h); ``forget_bias`` is added to f (0 where it is already folded)."""
    i, g, f, o = gates.chunk(4, dim=-1)
    c = c_prev * sigmoid(f + forget_bias) + sigmoid(i) * torch.tanh(g)
    h = torch.tanh(c) * sigmoid(o)
    if zoneout_cell:
        c = _mix(c, c_prev, zoneout_cell)
    if zoneout_output:
        h = _mix(h, h_prev, zoneout_output)
    return c, h


def _mix(new: torch.Tensor, prev: torch.Tensor, z: float) -> torch.Tensor:
    """The inference zoneout (1 - z) new + z prev, both factors rounded to
    the carry's dtype first, as the JAX package's weak scalars are."""
    return weak(1.0 - z, new.dtype) * new + weak(z, new.dtype) * prev


def _zoneout(prev: torch.Tensor, new: torch.Tensor, factor: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """Training zoneout: keep the new value with probability 1 - factor."""
    if factor == 0.0:
        return new
    u = torch.rand(new.shape, generator=generator, device=new.device)
    return torch.where(u >= factor, new, prev)


def fold_forget_bias(b: torch.Tensor) -> torch.Tensor:
    """The (..., 4u) bias with the +1 forget bias added to its f block."""
    q = b.shape[-1] // 4
    out = b.clone()
    out[..., 2 * q:3 * q] += 1.0
    return out


class ZoneoutLSTMCell(nn.Module):
    dtype = torch.float32

    def __init__(self, input_size: int, num_units: int,
                 zoneout_factor_cell: float = 0.0,
                 zoneout_factor_output: float = 0.0):
        super().__init__()
        self.num_units = num_units
        self.zoneout_factor_cell = zoneout_factor_cell
        self.zoneout_factor_output = zoneout_factor_output
        self.weight = nn.Parameter(torch.empty(4 * num_units,
                                               input_size + num_units))
        self.bias = nn.Parameter(torch.zeros(4 * num_units))

    def forward(self, carry: Carry, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None):
        c_prev, h_prev = carry
        dt = self.dtype
        gates = (torch.cat([x, h_prev], dim=-1).to(dt)
                 @ cast(self, self.weight, dt).t() + cast(self, self.bias, dt))
        if not training:
            new_c, new_h = lstm_update(gates, c_prev, h_prev,
                                       self.zoneout_factor_cell,
                                       self.zoneout_factor_output,
                                       forget_bias=1.0)
            return (new_c, new_h), new_h
        new_c, new_h = lstm_update(gates, c_prev, h_prev, 0.0, 0.0,
                                   forget_bias=1.0)
        new_c = _zoneout(c_prev, new_c, self.zoneout_factor_cell, generator)
        new_h = _zoneout(h_prev, new_h, self.zoneout_factor_output, generator)
        return (new_c, new_h), new_h

    def initial_state(self, batch: int, device=None) -> Carry:
        z = torch.zeros(batch, self.num_units, dtype=self.dtype,
                        device=device)
        return z, z


class GRUCell(nn.Module):
    dtype = torch.float32

    def __init__(self, input_size: int, num_units: int):
        super().__init__()
        self.num_units = num_units
        self.gates = Linear(input_size + num_units, 2 * num_units)
        self.candidate = Linear(input_size + num_units, num_units)

    def forward(self, h_prev: torch.Tensor, x: torch.Tensor,
                training: bool = False,
                generator: Optional[torch.Generator] = None):
        """One step -> (h, h); ``training`` and ``generator`` are unused
        (the cell has no dropout or zoneout)."""
        r, u = sigmoid(self.gates(torch.cat([x, h_prev], -1))).chunk(
            2, dim=-1)
        cand = torch.tanh(self.candidate(torch.cat([x, r * h_prev], -1)))
        h = u * h_prev + (1.0 - u) * cand
        return h, h

    def initial_state(self, batch: int, device=None) -> torch.Tensor:
        return torch.zeros(batch, self.num_units, dtype=self.dtype,
                           device=device)


def _hold(valid: torch.Tensor, new, prev):
    """The new carry (a tensor or a tuple of them) where ``valid``, else
    the previous one."""
    if isinstance(new, torch.Tensor):
        return torch.where(valid, new, prev)
    return tuple(torch.where(valid, n, p) for n, p in zip(new, prev))


def reverse_sequence(xs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """tf.reverse_sequence over axis 1: per-row reversal of the valid prefix."""
    B, T = xs.shape[0], xs.shape[1]
    idx = torch.arange(T, device=xs.device)[None, :]
    L = lengths.to(xs.device)[:, None]
    rev = torch.where(idx < L, L - 1 - idx, idx)
    rev = rev.reshape(B, T, *([1] * (xs.dim() - 2))).expand_as(xs)
    return torch.gather(xs, 1, rev)


def unroll(cell: nn.Module, xs: torch.Tensor,
           lengths: Optional[torch.Tensor], reverse: bool = False,
           training: bool = False,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Run ``cell`` over axis 1 of ``xs`` (B, T, D) -> (B, T, units)."""
    B, T = xs.shape[0], xs.shape[1]
    if reverse:
        xs = (reverse_sequence(xs, lengths) if lengths is not None
              else xs.flip(1))
    carry = cell.initial_state(B, xs.device)
    ys = []
    for t in range(T):
        new_carry, y = cell(carry, xs[:, t], training, generator)
        if lengths is not None:
            valid = (t < lengths.to(xs.device))[:, None]
            new_carry = _hold(valid, new_carry, carry)
            y = torch.where(valid, y, torch.zeros_like(y))
        carry = new_carry
        ys.append(y)
    ys = torch.stack(ys, dim=1)
    if reverse:
        ys = reverse_sequence(ys, lengths) if lengths is not None else ys.flip(1)
    return ys


class BiZoneoutLSTM(nn.Module):
    """(B, T, D) -> (B, T, 2 * units): [forward | backward]."""

    def __init__(self, input_size: int, num_units: int,
                 zoneout_factor_cell: float = 0.0,
                 zoneout_factor_output: float = 0.0):
        super().__init__()
        self.fw = ZoneoutLSTMCell(input_size, num_units, zoneout_factor_cell,
                                  zoneout_factor_output)
        self.bw = ZoneoutLSTMCell(input_size, num_units, zoneout_factor_cell,
                                  zoneout_factor_output)

    def forward(self, xs: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        ys_f = unroll(self.fw, xs, lengths, False, training, generator)
        ys_b = unroll(self.bw, xs, lengths, True, training, generator)
        return torch.cat([ys_f, ys_b], dim=-1)


class BiGRU(nn.Module):
    """(B, T, D) -> (B, T, 2 * units): [forward | backward], as
    ``BiZoneoutLSTM``."""

    def __init__(self, input_size: int, num_units: int):
        super().__init__()
        self.fw = GRUCell(input_size, num_units)
        self.bw = GRUCell(input_size, num_units)

    def forward(self, xs: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        return torch.cat([unroll(self.fw, xs, lengths),
                          unroll(self.bw, xs, lengths, True)], dim=-1)
