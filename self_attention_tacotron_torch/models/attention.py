"""Source-attention mechanisms as step functions (inference).

Counterpart of the JAX package's ``models/attention.py``:
* ``AdditiveAttention`` — Bahdanau: keys = memory_layer(memory),
  energy = sum(v * tanh(keys + query_layer(query))), masked softmax.
* ``LocationSensitiveAttention`` — Tacotron-2's: adds a SAME conv over the
  previous (or, with ``cumulative_weights``, the accumulated) alignments,
  a location dense and a shared bias inside the tanh; with ``smoothing``
  the alignments are the masked sigmoid energies over their sum (at least
  1e-8) in place of the softmax.
* ``ForwardAttention`` — the location-sensitive energy followed by the
  forward recursion ``alpha = ((1 - u) alpha + u shift(alpha) + 1e-7) a``,
  normalized; alpha starts at [1, 0, ...] and u at 0.5.  Without the
  transition agent u stays 0.5; with it (``use_transition_agent``) the
  next u is sigmoid(``transition_factor_projection``([context of alpha,
  processed query])).  ``cumulative_weights`` selects whether the conv
  sees the running sum of alignments.

* ``TeacherForcingAttention`` — ``teacher_forcing_additive`` /
  ``teacher_forcing_forward``: replays supplied alignments step by step
  and ignores the query (no parameters).

Each mechanism has ``precompute(memory, lengths)`` (keys + mask, once per
utterance), ``initial_state`` and ``step(query, state, pack)`` ->
(alignments (B, T_mem), new state).  Masking fills -1e9.  A pack's
``teacher_alignments`` (B, T_steps, T_mem) makes the decoder replay them in
place of any mechanism (the forced-alignment mode's second pass).

Model-wide bf16 (``ops/compute_dtype.py``): the denses and the location
conv compute in the mechanism's ``dtype``, the energy vector and bias are
cast to it, and the energies, alignments and states (alpha, u, the
accumulated alignments) stay in it, as the JAX package's mechanisms.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ..ops.compute_dtype import Linear, cast, sigmoid, softmax, weak
from ..ops.conv import Conv1d

NEG_INF = -1e9


class MemoryPack(NamedTuple):
    keys: torch.Tensor    # (B, T_mem, num_units)
    values: torch.Tensor  # (B, T_mem, C_mem)
    mask: torch.Tensor    # (B, T_mem) bool
    teacher_alignments: Optional[torch.Tensor] = None  # (B, T_steps, T_mem)


class AttentionOptions(NamedTuple):
    attention: str
    num_units: int
    attention_kernel: int = 31
    attention_filters: int = 32
    smoothing: bool = False
    cumulative_weights: bool = False
    use_transition_agent: bool = False


def compute_context(alignments: torch.Tensor,
                    values: torch.Tensor) -> torch.Tensor:
    """(B, T_mem) x (B, T_mem, C) -> (B, C)."""
    return torch.einsum("bt,btc->bc", alignments, values)


def _masked_softmax(energy: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return softmax(
        torch.where(mask, energy, torch.full_like(energy, NEG_INF)), dim=-1)


def _sequence_mask(memory: torch.Tensor, lengths: torch.Tensor):
    T = memory.shape[1]
    return (torch.arange(T, device=memory.device)[None, :]
            < lengths.to(memory.device)[:, None])


class AdditiveAttention(nn.Module):
    """State: the previous alignments (unused by the energy)."""

    dtype = torch.float32

    def __init__(self, memory_dim: int, query_dim: int, num_units: int):
        super().__init__()
        self.memory_layer = Linear(memory_dim, num_units, bias=False)
        self.query_layer = Linear(query_dim, num_units, bias=False)
        self.attention_v = nn.Parameter(torch.empty(1, num_units))

    def precompute(self, memory, lengths) -> MemoryPack:
        return MemoryPack(self.memory_layer(memory), memory,
                          _sequence_mask(memory, lengths))

    def initial_state(self, batch: int, max_time: int, device=None):
        return torch.zeros(batch, max_time, dtype=self.dtype, device=device)

    def step(self, query, state, pack: MemoryPack):
        pq = self.query_layer(query)[:, None, :]
        energy = (cast(self, self.attention_v, self.dtype)[0]
                  * torch.tanh(pack.keys + pq)).sum(-1)
        alignments = _masked_softmax(energy, pack.mask)
        return alignments, alignments


class _LocationEnergy(nn.Module):
    """Layers of the location-sensitive energy, shared by the two
    location-based mechanisms."""

    dtype = torch.float32

    def __init__(self, memory_dim: int, query_dim: int, num_units: int,
                 attention_kernel: int, attention_filters: int,
                 cumulative_weights: bool):
        super().__init__()
        self.attention_kernel = attention_kernel
        self.cumulative_weights = cumulative_weights
        self.memory_layer = Linear(memory_dim, num_units, bias=False)
        self.query_layer = Linear(query_dim, num_units, bias=False)
        self.location_convolution = Conv1d(1, attention_filters,
                                           attention_kernel, use_bias=True)
        self.location_layer = Linear(attention_filters, num_units,
                                        bias=False)
        self.attention_variable = nn.Parameter(torch.empty(1, num_units))
        self.attention_bias = nn.Parameter(torch.zeros(num_units))

    def precompute(self, memory, lengths) -> MemoryPack:
        return MemoryPack(self.memory_layer(memory), memory,
                          _sequence_mask(memory, lengths))

    def _energy(self, query, conv_input, pack: MemoryPack):
        pq = self.query_layer(query)[:, None, :]
        loc = self.location_layer(
            self.location_convolution(conv_input[:, :, None]))
        dt = self.dtype
        return (cast(self, self.attention_variable, dt)[0]
                * torch.tanh(pack.keys + pq + loc
                             + cast(self, self.attention_bias, dt))).sum(-1)


class LocationSensitiveAttention(_LocationEnergy):
    """State: (alignments, accumulated alignments)."""

    def __init__(self, memory_dim: int, query_dim: int, num_units: int,
                 attention_kernel: int, attention_filters: int,
                 cumulative_weights: bool, smoothing: bool = False):
        super().__init__(memory_dim, query_dim, num_units, attention_kernel,
                         attention_filters, cumulative_weights)
        self.smoothing = smoothing

    def initial_state(self, batch: int, max_time: int, device=None):
        zeros = torch.zeros(batch, max_time, dtype=self.dtype, device=device)
        return zeros, zeros

    def step(self, query, state, pack: MemoryPack):
        prev_alignments, accumulation = state
        conv_input = accumulation if self.cumulative_weights \
            else prev_alignments
        energy = self._energy(query, conv_input, pack)
        if self.smoothing:
            sig = sigmoid(energy) * pack.mask
            alignments = sig / sig.sum(-1, keepdim=True).clamp_min(
                weak(1e-8, sig.dtype))
        else:
            alignments = _masked_softmax(energy, pack.mask)
        return alignments, (alignments, accumulation + alignments)


class ForwardAttentionState(NamedTuple):
    alignments: torch.Tensor  # (B, T_mem) conv input of the next step
    alpha: torch.Tensor       # (B, T_mem)
    u: torch.Tensor           # (B, 1) transition factor


class ForwardAttention(_LocationEnergy):
    def __init__(self, memory_dim: int, query_dim: int, num_units: int,
                 attention_kernel: int, attention_filters: int,
                 cumulative_weights: bool,
                 use_transition_agent: bool = False):
        super().__init__(memory_dim, query_dim, num_units, attention_kernel,
                         attention_filters, cumulative_weights)
        self.use_transition_agent = use_transition_agent
        if use_transition_agent:
            self.transition_factor_projection = Linear(
                memory_dim + num_units, 1)

    def initial_state(self, batch: int, max_time: int, device=None
                      ) -> ForwardAttentionState:
        dt = self.dtype
        alpha = torch.zeros(batch, max_time, dtype=dt, device=device)
        alpha[:, 0] = 1.0
        return ForwardAttentionState(
            torch.zeros(batch, max_time, dtype=dt, device=device), alpha,
            torch.full((batch, 1), 0.5, dtype=dt, device=device))

    def step(self, query, state: ForwardAttentionState, pack: MemoryPack):
        prev_alignments, prev_alpha, prev_u = state
        alignments = _masked_softmax(
            self._energy(query, prev_alignments, pack), pack.mask)
        shifted = torch.nn.functional.pad(prev_alpha[:, :-1], (1, 0))
        alpha = ((1.0 - prev_u) * prev_alpha + prev_u * shifted
                 + weak(1e-7, prev_alpha.dtype)) * alignments
        alpha = alpha / alpha.sum(dim=1, keepdim=True)
        u = prev_u
        if self.use_transition_agent:
            u = sigmoid(self.transition_factor_projection(torch.cat(
                [compute_context(alpha, pack.values),
                 self.query_layer(query)], -1)))
        next_alignments = (alignments + prev_alignments
                           if self.cumulative_weights else alignments)
        return alpha, ForwardAttentionState(next_alignments, alpha, u)


def replayed_alignment(teacher_alignments: torch.Tensor,
                       index: int) -> torch.Tensor:
    """Step ``index``'s row of (B, T_steps, T_mem) supplied alignments,
    the index clipped to [0, T_steps - 1] as the JAX package clips it."""
    return teacher_alignments[:, min(max(index, 0),
                                     teacher_alignments.shape[1] - 1)]


class TeacherForcingState(NamedTuple):
    alignments: torch.Tensor  # (B, T_mem)
    index: int


class TeacherForcingAttention(nn.Module):
    """Replays ``pack.teacher_alignments`` one step at a time, ignoring the
    query; no parameters."""

    dtype = torch.float32

    def precompute(self, memory, lengths,
                   teacher_alignments=None) -> MemoryPack:
        return MemoryPack(torch.zeros_like(memory[..., :1]), memory,
                          _sequence_mask(memory, lengths),
                          teacher_alignments)

    def initial_state(self, batch: int, max_time: int, device=None
                      ) -> TeacherForcingState:
        return TeacherForcingState(
            torch.zeros(batch, max_time, dtype=self.dtype, device=device), -1)

    def step(self, query, state: TeacherForcingState, pack: MemoryPack):
        index = state.index + 1
        alignments = replayed_alignment(pack.teacher_alignments, index)
        return alignments, TeacherForcingState(alignments, index)


def attention_mechanism_factory(options: AttentionOptions, memory_dim: int,
                                query_dim: int) -> nn.Module:
    if options.attention == "forward":
        return ForwardAttention(memory_dim, query_dim, options.num_units,
                                options.attention_kernel,
                                options.attention_filters,
                                options.cumulative_weights,
                                options.use_transition_agent)
    if options.attention == "location_sensitive":
        return LocationSensitiveAttention(memory_dim, query_dim,
                                          options.num_units,
                                          options.attention_kernel,
                                          options.attention_filters,
                                          options.cumulative_weights,
                                          options.smoothing)
    if options.attention == "additive":
        return AdditiveAttention(memory_dim, query_dim, options.num_units)
    if options.attention in ("teacher_forcing_forward",
                             "teacher_forcing_additive"):
        return TeacherForcingAttention()
    raise ValueError(f"Unknown attention mechanism: {options.attention}")
