"""The autoregressive decoder at inference.

Counterpart of the JAX package's ``models/decoder.py`` ``TacotronDecoder`` in
INFERENCE mode (``output_kind="single"``).  Per step:

    x        = prenet(next_input)                # raw logits fed back
    h        = attention_LSTM([x, prev_context])
    align_i  = mechanism_i(h, state_i)           # 1 or 2 sources
    ctx      = concat(align_i @ values_i)
    proj     = Dense([h, ctx])
    o1       = proj + LSTM_1(proj)               # zoneout only for v2
    o2       = o1 + LSTM_2(o1)
    y        = hops(o2)                          # causal KV-cache attention
    out, stop = heads(y)

Three paths, as in the JAX package:
* ``_decode_path`` — every one of ``max_iters`` steps (the scan path);
* ``_decode_path_while`` — stops once every row's stop token fired past
  ``min_iters`` (``early_stop``);
* ``_decode_path_fused`` — ``ops/fused_decode.fused_decode`` on merged
  weights, taken with ``fused_inference`` where ``_fused_unsupported_reason``
  finds nothing; otherwise one of the two above runs and the reason is
  logged once.  The gate looks at the configuration only.

Submodule names follow the flax tree so ``utils/convert.py`` maps
parameters one to one.
"""

from __future__ import annotations

import logging
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops import fused_decode as fd
from ..ops.rnn import ZoneoutLSTMCell
from .attention import (AdditiveAttention, AttentionOptions, ForwardAttention,
                        attention_mechanism_factory, compute_context)
from .encoders import SelfAttentionTransformer, weights_key
from .prenet import PreNetStack

_logger = logging.getLogger(__name__)
_warned_fused_fallback: set = set()


def _warn_fused_fallback(reason: str) -> None:
    if reason not in _warned_fused_fallback:
        _warned_fused_fallback.add(reason)
        _logger.warning(
            "decoder_fused_inference=True but the fused kernel does not "
            "cover this configuration — using the plain path: %s", reason)


def stop_lengths(row_finished: torch.Tensor) -> torch.Tensor:
    """(B, S) cumulative "stop token has fired" flags -> (B,) lengths: the
    step each row first fired (inclusive); a row that never fires runs to
    the step where every row had fired, else to S (dynamic_decode's
    final_sequence_lengths)."""
    S = row_finished.shape[1]
    all_fin = row_finished.all(0)
    steps_taken = (int(all_fin.int().argmax()) + 1 if bool(all_fin.any())
                   else S)
    first = row_finished.int().argmax(1)
    return torch.where(row_finished[:, -1], first + 1,
                       torch.full_like(first, steps_taken))


class DecoderOutput(NamedTuple):
    outputs: torch.Tensor              # (B, S * r, C)
    stop_token: torch.Tensor           # (B, S, 1) logits
    predicted_samples: torch.Tensor    # (B, S, r) argmax ids
    alignments: Tuple[torch.Tensor, ...]  # per source (B, T_mem, S)
    self_attention_alignments: List[torch.Tensor]  # per hop*head (B, T_k, T_q)
    lengths: torch.Tensor              # (B,) decoded steps


class TacotronDecoder(nn.Module):
    def __init__(self, attention_options: Sequence[AttentionOptions],
                 source_dims: Sequence[int], use_transformer: bool = True,
                 prenet_out_units: Sequence[int] = (256, 128),
                 attention_rnn_out_units: int = 256,
                 decoder_version: str = "v1", decoder_out_units: int = 256,
                 num_mels: int = 80, outputs_per_step: int = 2,
                 n_feed_frame: int = 1, max_iters: int = 500,
                 min_iters: int = 10, zoneout_factor_cell: float = 0.0,
                 zoneout_factor_output: float = 0.0,
                 self_attention_out_units: int = 256,
                 self_attention_num_heads: int = 2,
                 self_attention_num_hop: int = 1,
                 early_stop: bool = False, fused_inference: bool = False,
                 fused_dtype: str = "float32"):
        super().__init__()
        assert len(attention_options) == len(source_dims)
        self.num_sources = len(source_dims)
        self.num_mels = num_mels
        self.outputs_per_step = outputs_per_step
        self.n_feed_frame = n_feed_frame
        self.max_iters = max_iters
        self.min_iters = min_iters
        self.zoneout_factor_cell = zoneout_factor_cell
        self.zoneout_factor_output = zoneout_factor_output
        self.decoder_version = decoder_version
        self.self_attention_num_heads = self_attention_num_heads
        self.self_attention_num_hop = (self_attention_num_hop
                                       if use_transformer else 0)
        self.early_stop = early_stop
        self.fused_inference = fused_inference
        self.fused_dtype = fused_dtype

        self.prenets = PreNetStack(num_mels * n_feed_frame, prenet_out_units)
        A, D = attention_rnn_out_units, decoder_out_units
        for i, (opt, dim) in enumerate(zip(attention_options, source_dims)):
            self.add_module(f"attention_mechanism_{i}",
                            attention_mechanism_factory(opt, dim, A))
        ctx_dim = sum(source_dims)
        self.attention_lstm = ZoneoutLSTMCell(
            prenet_out_units[-1] + ctx_dim, A, zoneout_factor_cell,
            zoneout_factor_output)
        self.output_projection_wrapper = nn.Linear(A + ctx_dim, D)
        zc, zo = self._dec_zoneout()
        self.decoder_lstm1 = ZoneoutLSTMCell(D, D, zc, zo)
        self.decoder_lstm2 = ZoneoutLSTMCell(D, D, zc, zo)
        for i in range(self.self_attention_num_hop):
            self.add_module(f"transformer_{i}", SelfAttentionTransformer(
                self_attention_out_units, self_attention_out_units,
                self_attention_num_heads, use_subsequent_mask=True))
        head_in = self_attention_out_units if use_transformer else D
        self.out_projection = nn.Linear(head_in, num_mels * outputs_per_step)
        self.stop_token_projection = nn.Linear(head_in, 1)

    def _dec_zoneout(self):
        if self.decoder_version == "v2":
            return self.zoneout_factor_cell, self.zoneout_factor_output
        return 0.0, 0.0

    @property
    def attention_mechanisms(self):
        return [getattr(self, f"attention_mechanism_{i}")
                for i in range(self.num_sources)]

    @property
    def transformers(self):
        return [getattr(self, f"transformer_{i}")
                for i in range(self.self_attention_num_hop)]

    # ------------------------------------------------------------ public API
    def forward(self, sources: Sequence[torch.Tensor],
                memory_lengths: Sequence[torch.Tensor]) -> DecoderOutput:
        assert len(sources) == self.num_sources
        B = sources[0].shape[0]
        packs = tuple(mech.precompute(src, ln) for mech, src, ln in
                      zip(self.attention_mechanisms, sources, memory_lengths))
        if self.fused_inference:
            reason = self._fused_unsupported_reason(B, packs)
            if reason is None:
                return self._decode_path_fused(packs, self.max_iters)
            _warn_fused_fallback(reason)
        if self.early_stop:
            return self._decode_path_while(packs, B, self.max_iters)
        return self._decode_path(packs, B, self.max_iters)

    # ----------------------------------------------------------- step pieces
    def _initial_carry(self, B, packs, device):
        ctx_dim = sum(int(p.values.shape[-1]) for p in packs)
        return dict(
            att_lstm=self.attention_lstm.initial_state(B, device),
            lstm1=self.decoder_lstm1.initial_state(B, device),
            lstm2=self.decoder_lstm2.initial_state(B, device),
            att_states=tuple(mech.initial_state(B, p.values.shape[1], device)
                             for mech, p in zip(self.attention_mechanisms,
                                                packs)),
            prev_context=torch.zeros(B, ctx_dim, device=device),
            next_input=torch.zeros(B, self.num_mels * self.n_feed_frame,
                                   device=device),
            caches=tuple(hop.init_cache(B, self.max_iters, device)
                         for hop in self.transformers))

    def _step(self, carry, t, packs):
        """One decode step -> (carry, (out_t, stop_t, aligns, sa_rows))."""
        x = self.prenets(carry["next_input"])
        att_state, h = self.attention_lstm(
            carry["att_lstm"], torch.cat([x, carry["prev_context"]], -1))
        aligns, contexts, new_states = [], [], []
        for mech, state, pack in zip(self.attention_mechanisms,
                                     carry["att_states"], packs):
            alignment, new_state = mech.step(h, state, pack)
            aligns.append(alignment)
            contexts.append(compute_context(alignment, pack.values))
            new_states.append(new_state)
        context = torch.cat(contexts, -1)
        proj = self.output_projection_wrapper(torch.cat([h, context], -1))
        lstm1_state, l1 = self.decoder_lstm1(carry["lstm1"], proj)
        o1 = proj + l1
        lstm2_state, l2 = self.decoder_lstm2(carry["lstm2"], o1)
        y = o1 + l2
        caches, sa_rows = [], []
        for hop, cache in zip(self.transformers, carry["caches"]):
            y, cache, row = hop.step(y, t, cache)
            caches.append(cache)
            sa_rows.append(row)
        out_t = self.out_projection(y)
        stop_t = self.stop_token_projection(y)
        C = self.num_mels
        new_carry = dict(
            att_lstm=att_state, lstm1=lstm1_state, lstm2=lstm2_state,
            att_states=tuple(new_states), prev_context=context,
            # INFERENCE feeds the raw logits of the last frame(s) back
            next_input=out_t[:, -C * self.n_feed_frame:],
            caches=tuple(caches))
        return new_carry, (out_t, stop_t, aligns, sa_rows)

    # -------------------------------------------------------- decode paths
    def _decode_path(self, packs, B, num_steps):
        """All ``num_steps`` steps; lengths from the first step at which
        every row's stop token has fired (dynamic_decode semantics)."""
        device = packs[0].keys.device
        carry = self._initial_carry(B, packs, device)
        finished = torch.zeros(B, dtype=torch.bool, device=device)
        outs, stops, aligns, sa_rows, row_fin = [], [], [], [], []
        for t in range(num_steps):
            carry, (out_t, stop_t, al, sa) = self._step(carry, t, packs)
            finished = finished | ((torch.sigmoid(stop_t[:, 0]) > 0.5)
                                   & (t > self.min_iters))
            outs.append(out_t)
            stops.append(stop_t)
            aligns.append(al)
            sa_rows.append(sa)
            row_fin.append(finished)
        lengths = stop_lengths(torch.stack(row_fin, 1))
        return self._package(
            torch.stack(outs, 1), torch.stack(stops, 1),
            tuple(torch.stack([a[i] for a in aligns], 1)
                  for i in range(self.num_sources)),
            self._sa_aligns(sa_rows, B, num_steps, device), lengths,
            num_steps, mask_by_lengths=True)

    def _decode_path_while(self, packs, B, num_steps):
        """Early exit once every row's stop token fired past min_iters;
        entries past the exit stay zero."""
        device = packs[0].keys.device
        carry = self._initial_carry(B, packs, device)
        C, r = self.num_mels, self.outputs_per_step
        finished = torch.zeros(B, dtype=torch.bool, device=device)
        lengths = torch.zeros(B, dtype=torch.int64, device=device)
        buf_out = torch.zeros(B, num_steps, C * r, device=device)
        buf_stop = torch.zeros(B, num_steps, 1, device=device)
        buf_al = [torch.zeros(B, num_steps, p.values.shape[1], device=device)
                  for p in packs]
        sa_rows = []
        for t in range(num_steps):
            if bool(finished.all()):
                break
            carry, (out_t, stop_t, al, sa) = self._step(carry, t, packs)
            lengths = lengths + (~finished).long()
            finished = finished | ((torch.sigmoid(stop_t[:, 0]) > 0.5)
                                   & (t > self.min_iters))
            buf_out[:, t] = out_t
            buf_stop[:, t] = stop_t
            for i, a in enumerate(al):
                buf_al[i][:, t] = a
            sa_rows.append(sa)
        return self._package(buf_out, buf_stop, tuple(buf_al),
                             self._sa_aligns(sa_rows, B, num_steps, device),
                             lengths, num_steps, mask_by_lengths=True)

    def _sa_aligns(self, sa_rows, B, num_steps, device):
        """Per hop*head (B, S_q, S_k) from per-step (B, H, S_k) rows; steps
        never run stay zero."""
        out = []
        for hop in range(self.self_attention_num_hop):
            rows = torch.zeros(B, num_steps, self.self_attention_num_heads,
                               num_steps, device=device)
            for t, step_rows in enumerate(sa_rows):
                rows[:, t] = step_rows[hop]
            out.extend(rows[:, :, h] for h in range(rows.shape[2]))
        return out

    # ------------------------------------------------- the fused kernel
    def _fused_unsupported_reason(self, B, packs) -> Optional[str]:
        """Configuration gate of the fused decode: the batch-1 row mode
        with additive and forward sources over one memory length.  Batched
        decodes and location-sensitive sources take the plain path."""
        if B != 1:
            return (f"batch {B}: the batched row mode of the fused decode "
                    "is not ported yet")
        if self.fused_dtype != "float32":
            return f"fused_dtype={self.fused_dtype!r} is not ported yet"
        if len({int(p.keys.shape[1]) for p in packs}) != 1:
            return "sources with different memory lengths"
        for m in self.attention_mechanisms:
            if not isinstance(m, (AdditiveAttention, ForwardAttention)):
                return (f"{type(m).__name__} is not ported to the fused "
                        "decode yet")
        loc_kernels = {m.attention_kernel for m in self.attention_mechanisms
                       if isinstance(m, ForwardAttention)}
        if len(loc_kernels) > 1:
            return "mixed location-conv kernel sizes are not fused"
        return None

    def fused_params(self) -> fd.FusedDecodeParams:
        """This module's weights in the JAX layout the merges start from."""
        def row(b):
            return b.reshape(1, -1)

        def dense(m):
            return m.weight.t(), row(m.bias)

        query, loc = [], []
        for m in self.attention_mechanisms:
            if isinstance(m, AdditiveAttention):
                query.append((m.query_layer.weight.t(), m.attention_v.t()))
                loc.append(None)
                continue
            query.append((m.query_layer.weight.t(),
                          m.attention_variable.t()))
            conv = m.location_convolution           # weight (F, 1, K)
            loc.append((conv.weight[:, 0, :].t(), conv.bias,
                        m.location_layer.weight.t(), m.attention_bias))
        hops = []
        for hop in self.transformers:
            att = hop.self_attention.attention
            flat = []
            for lin in (att.key_projection, att.value_projection,
                        att.query_projection, att.output_projection,
                        hop.transform):
                flat += list(dense(lin))
            hops.append(tuple(flat))
        out_p, stop_p = self.out_projection, self.stop_token_projection
        return fd.FusedDecodeParams(
            prenet=tuple(dense(p.dense) for p in self.prenets.layers()),
            att_lstm=(self.attention_lstm.weight.t(),
                      row(self.attention_lstm.bias)),
            query=tuple(query),
            outproj=dense(self.output_projection_wrapper),
            lstm1=(self.decoder_lstm1.weight.t(),
                   row(self.decoder_lstm1.bias)),
            lstm2=(self.decoder_lstm2.weight.t(),
                   row(self.decoder_lstm2.bias)),
            hops=tuple(hops),
            head=(torch.cat([out_p.weight.t(), stop_p.weight.t()], 1),
                  row(torch.cat([out_p.bias, stop_p.bias]))),
            loc=tuple(loc))

    def fused_inputs(self, packs):
        """(weights, memory, run options) of ops/fused_decode.  The merged
        weights are made once and reused until a parameter changes
        (``weights_key``)."""
        key = weights_key(self)
        if getattr(self, "_merged", (None,))[0] != key:
            mechs = self.attention_mechanisms
            self._merged = (key, fd.merge_weights(
                self.fused_params(), num_mels=self.num_mels,
                outputs_per_step=self.outputs_per_step,
                n_feed_frame=self.n_feed_frame,
                src_kinds=tuple("additive" if isinstance(m, AdditiveAttention)
                                else "forward" for m in mechs),
                cumulative=tuple(getattr(m, "cumulative_weights", False)
                                 for m in mechs),
                loc_kernel=max(getattr(m, "attention_kernel", 1)
                               for m in mechs)))
        memory = fd.FusedDecodeMemory(
            keys=tuple(pk.keys for pk in packs),
            values=tuple(pk.values for pk in packs),
            masks=tuple(pk.mask for pk in packs))
        zc_dec, zo_dec = self._dec_zoneout()
        options = dict(
            num_heads=self.self_attention_num_heads,
            zoneout_cell=self.zoneout_factor_cell,
            zoneout_output=self.zoneout_factor_output,
            dec_zoneout_cell=zc_dec, dec_zoneout_output=zo_dec,
            early_stop=self.early_stop, min_iters=self.min_iters)
        return self._merged[1], memory, options

    def _decode_path_fused(self, packs, num_steps):
        weights, memory, options = self.fused_inputs(packs)
        out, stop, aligns = fd.fused_decode(weights, memory,
                                            num_steps=num_steps, **options)
        # lengths recovered post hoc from the stop logits
        S = num_steps
        device = out.device
        fired = (stop > 0) & (torch.arange(S, device=device)[None, :]
                              > self.min_iters)
        lengths = stop_lengths(torch.cumsum(fired.int(), 1) > 0)
        sa_aligns = [torch.zeros(1, S, S, device=device)
                     for _ in range(self.self_attention_num_hop
                                    * self.self_attention_num_heads)]
        return self._package(out, stop[..., None], aligns, sa_aligns,
                             lengths, S, mask_by_lengths=True)

    # ------------------------------------------------------------ packaging
    def _package(self, outs, stop, aligns, sa_aligns, lengths, num_steps,
                 mask_by_lengths: bool = False) -> DecoderOutput:
        r, C = self.outputs_per_step, self.num_mels
        B = outs.shape[0]
        lengths = lengths.long()
        if mask_by_lengths:
            valid = (torch.arange(num_steps, device=outs.device)[None, :]
                     < lengths[:, None]).float()
            outs = outs * valid[..., None]
            stop = stop * valid[..., None]
        samples = outs.reshape(B, num_steps, r, C).argmax(-1).int()
        return DecoderOutput(
            outputs=outs.reshape(B, num_steps * r, C), stop_token=stop,
            predicted_samples=samples,
            alignments=tuple(a.transpose(1, 2) for a in aligns),
            self_attention_alignments=[a.transpose(1, 2) for a in sa_aligns],
            lengths=lengths)
