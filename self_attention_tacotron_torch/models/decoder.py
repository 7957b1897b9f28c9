"""The decoder: teacher-forced training, validation and inference.

Counterpart of the JAX package's ``models/decoder.py`` ``TacotronDecoder``
in its TRAIN, VALIDATION and INFERENCE modes, for both output kinds:
``single`` (code logits or mel frames) and ``mgclf0`` (two prenet stacks,
``mgc_prenets`` and ``lf0_prenets``, whose outputs are concatenated; the
heads ``mgc_out_projection2(tanh(mgc_out_projection1(y)))`` and
``lf0_out_projection(y)``, the lf0 logits in ``outputs2``; the lf0 stream
is always fed back as its softmax, the mgc stream raw).  Per step:

    x        = prenet(next_input)                # see below
    h        = attention_LSTM([x, prev_context])
    align_i  = mechanism_i(h, state_i)           # 1 or 2 sources
    ctx      = concat(align_i @ values_i)
    proj     = Dense([h, ctx])
    o1       = proj + LSTM_1(proj)               # zoneout only for v2
    o2       = o1 + LSTM_2(o1)
    y        = hops(o2)                          # causal KV-cache attention
    out, stop = heads(y)

TRAIN (``train_forward``): the teacher inputs [GO, target_0, ...] run
through the recurrent trunk, then the causal hops over the whole sequence
(dropout ``self_attention_drop_rate``) and the heads.  The trunk is a
plain loop over ``_rnn_step`` (prenet dropout and zoneout from the
caller's ``torch.Generator``), or, for decoders with hops and
``fused_train`` where ``_fused_train_unsupported_reason`` finds nothing,
``ops/fused_train.fused_teacher_scan`` (its own counter-based masks,
seeded from the generator; rank r of a data axis adds ``r *
TRUNK_SEED_STRIDE`` to the seed, and the kernels' gate judges the rank's
local batch).  Decoders without hops (``ExtendedDecoder``)
always take the step loop, as the JAX package does.  The loop is
teacher-forced for them too: the JAX package's ``make_train_step`` calls
its TRAIN mode without ``teacher_forcing``, so its hop-less decoders train
on their own raw outputs, a fault of the reference that is not copied
(``teacher_forcing=True`` there is what this path matches).

VALIDATION (``validation_forward``, the trainer's evaluation) runs
``_decode_path`` over the target's T // r steps: teacher-forced, step t is
fed target step t (``feed[t] = shifted[t + 1]`` of the GO-shifted teacher
inputs); free-running, it is fed its own outputs: as softmax probabilities
with ``feedback_softmax`` (the code model), raw otherwise (the mel model).
INFERENCE always feeds back the raw last ``n_feed_frame`` frames (the
lf0 stream: its softmax).  With ``apply_dropout_on_inference`` the
prenets drop out in VALIDATION and INFERENCE too, drawn from the caller's
generator; the fused and the early-exit loops are not taken then.
VALIDATION never fuses; its lengths are the step count and nothing is
masked.  ``teacher_alignments`` (VALIDATION and INFERENCE) replay supplied
alignments in place of the mechanisms, step t taking row min(t, T_steps -
1) (the forced-alignment mode's second pass; the fused gate refuses the
replay, as the JAX package's does).

Three inference paths, as in the JAX package:
* ``_decode_path`` — every one of ``max_iters`` steps (the scan path);
* ``_decode_path_while`` — stops once every row's stop token fired past
  ``min_iters`` (``early_stop``);
* ``_decode_path_fused`` — ``ops/fused_decode.fused_decode`` on merged
  weights, at any batch, source kind and memory length, taken with
  ``fused_inference`` where ``_fused_unsupported_reason`` and the kernel's
  shared-memory plan (which bounds the batch) find nothing; otherwise one
  of the two above runs and the reason is logged once.  The gate looks at
  the configuration only.  Each inference call logs once which path serves
  the hops (``log_path_once``).

With a speaker prenet (``speaker_dim``) every mode takes the caller's
(B, E) ``speaker_embed``: the plain loops through ``PreNetStack``, the
fused kernels as the (B, P0) ``speaker_row`` that ``MultiSpeakerPreNet``
adds after dense0's ReLU.

With ``use_pallas`` the hops' attention runs the kernels of
``ops/pallas_attention`` (``ops/attention_core.py`` has the gates): the
KV-cache step in every decode loop, the full-sequence call in training
where no attention dropout is active.

Model-wide bf16 (``ops/compute_dtype.py``): the trunk, the hops and the
heads compute in their ``dtype``, and so do the carries, the feeds (the
teacher frames cast to it, as the JAX package's scan carry), the caches,
the attention states and every buffer of the loops.  The fused kernels
keep their own storage dtype (``fused_dtype``, ``fused_train_dtype``):
the keys, values and teacher reach them upcast to float32 (the keys before
the fold joins them; in training outside the ``autograd.Function``, so the
gradients return through the casts to the bf16 keys and values), the
speaker row is made in float32, and what they return is cast back to
``dtype`` after the lengths are read from the float32 stop logits.  Their
gates see the same configuration in either dtype and choose the same
path.

Submodule names follow the flax tree so ``utils/convert.py`` maps
parameters one to one.
"""

from __future__ import annotations

import enum
import logging
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops import fused_decode as fd
from ..ops import fused_train as ft
from ..ops.collectives import axis_rank
from ..ops.compute_dtype import Linear, sigmoid, softmax
from ..ops.rnn import ZoneoutLSTMCell
from .attention import (AdditiveAttention, AttentionOptions, ForwardAttention,
                        TeacherForcingAttention, attention_mechanism_factory,
                        compute_context, replayed_alignment)
from .encoders import (SelfAttentionTransformer, hop_path, log_path_once,
                       weights_key)
from .prenet import PreNetStack

_logger = logging.getLogger(__name__)
_warned_fused_fallback: set = set()
# the JAX package's per-shard seed offset of the fused trunk
TRUNK_SEED_STRIDE = 40507


def _warn_fused_fallback(reason: str,
                         flag: str = "decoder_fused_inference") -> None:
    if (flag, reason) not in _warned_fused_fallback:
        _warned_fused_fallback.add((flag, reason))
        _logger.warning(
            "%s=True but the fused kernel does not cover this "
            "configuration — using the plain path: %s", flag, reason)


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


class DecoderMode(enum.Enum):
    """The decode loop's modes (TRAIN runs ``train_forward``, no loop)."""
    VALIDATION = "validation"
    INFERENCE = "inference"


class DecoderOutput(NamedTuple):
    outputs: torch.Tensor              # (B, S * r, C)
    stop_token: torch.Tensor           # (B, S, 1) logits
    predicted_samples: torch.Tensor    # (B, S, r) argmax ids
    alignments: Tuple[torch.Tensor, ...]  # per source (B, T_mem, S)
    self_attention_alignments: List[torch.Tensor]  # per hop*head (B, T_k, T_q)
    lengths: torch.Tensor              # (B,) decoded steps
    outputs2: Optional[torch.Tensor] = None  # (B, S * r, num_lf0s) mgclf0


def _first(x):
    """A tensor, or the first of a tuple of them."""
    return x[0] if isinstance(x, tuple) else x


def _map(fn, x):
    """``fn`` over a tensor, or over each of a tuple of them (the MGC/LF0
    decoder's two streams)."""
    return tuple(map(fn, x)) if isinstance(x, tuple) else fn(x)


class TacotronDecoder(nn.Module):
    dtype = torch.float32

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
                 fused_dtype: str = "float32", drop_rate: float = 0.5,
                 self_attention_drop_rate: float = 0.0,
                 fused_train: bool = False,
                 fused_train_dtype: str = "float32",
                 use_pallas: bool = False, feedback_softmax: bool = False,
                 speaker_dim: Optional[int] = None,
                 output_kind: str = "single", num_mgcs: int = 60,
                 num_lf0s: int = 256,
                 apply_dropout_on_inference: bool = False):
        super().__init__()
        assert len(attention_options) == len(source_dims)
        assert output_kind in ("single", "mgclf0"), output_kind
        self.num_sources = len(source_dims)
        self.output_kind = output_kind
        self.num_mels = num_mels
        self.num_mgcs = num_mgcs
        self.num_lf0s = num_lf0s
        self.apply_dropout_on_inference = apply_dropout_on_inference
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
        self.fused_train = fused_train
        self.fused_train_dtype = fused_train_dtype
        self.use_pallas = use_pallas
        self.feedback_softmax = feedback_softmax
        self.self_attention_out_units = self_attention_out_units

        prenet_width = prenet_out_units[-1]
        if output_kind == "mgclf0":
            self.mgc_prenets = PreNetStack(
                num_mgcs * n_feed_frame, prenet_out_units, drop_rate,
                speaker_dim, apply_dropout_on_inference)
            self.lf0_prenets = PreNetStack(
                num_lf0s * n_feed_frame, prenet_out_units, drop_rate,
                speaker_dim, apply_dropout_on_inference)
            prenet_width *= 2
        else:
            self.prenets = PreNetStack(
                num_mels * n_feed_frame, prenet_out_units, drop_rate,
                speaker_dim, apply_dropout_on_inference)
        A, D = attention_rnn_out_units, decoder_out_units
        for i, (opt, dim) in enumerate(zip(attention_options, source_dims)):
            self.add_module(f"attention_mechanism_{i}",
                            attention_mechanism_factory(opt, dim, A))
        ctx_dim = sum(source_dims)
        self.attention_lstm = ZoneoutLSTMCell(
            prenet_width + ctx_dim, A, zoneout_factor_cell,
            zoneout_factor_output)
        self.output_projection_wrapper = Linear(A + ctx_dim, D)
        zc, zo = self._dec_zoneout()
        self.decoder_lstm1 = ZoneoutLSTMCell(D, D, zc, zo)
        self.decoder_lstm2 = ZoneoutLSTMCell(D, D, zc, zo)
        for i in range(self.self_attention_num_hop):
            self.add_module(f"transformer_{i}", SelfAttentionTransformer(
                self_attention_out_units, self_attention_out_units,
                self_attention_num_heads, use_subsequent_mask=True,
                drop_rate=self_attention_drop_rate, use_pallas=use_pallas))
        head_in = self_attention_out_units if use_transformer else D
        r = outputs_per_step
        if output_kind == "mgclf0":
            self.mgc_out_projection1 = Linear(head_in, head_in)
            self.mgc_out_projection2 = Linear(head_in, num_mgcs * r)
            self.lf0_out_projection = Linear(head_in, num_lf0s * r)
        else:
            self.out_projection = Linear(head_in, num_mels * r)
        self.stop_token_projection = Linear(head_in, 1)

    def _frame_dims(self) -> Tuple[int, ...]:
        if self.output_kind == "mgclf0":
            return self.num_mgcs, self.num_lf0s
        return (self.num_mels,)

    def _heads(self, y):
        """-> (outputs per stream, stop logits), over (..., D) rows."""
        if self.output_kind == "mgclf0":
            return (self.mgc_out_projection2(torch.tanh(
                self.mgc_out_projection1(y))),
                    self.lf0_out_projection(y)), \
                self.stop_token_projection(y)
        return (self.out_projection(y),), self.stop_token_projection(y)

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
                memory_lengths: Sequence[torch.Tensor],
                speaker_embed: Optional[torch.Tensor] = None,
                teacher_alignments: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None
                ) -> DecoderOutput:
        """INFERENCE; ``speaker_embed`` (B, E) conditions the speaker
        prenet (``speaker_dim``); ``teacher_alignments`` (per source (B,
        T_steps, T_mem)) are replayed in place of the mechanisms;
        ``generator`` draws the prenet dropout of
        ``apply_dropout_on_inference``, which takes neither the fused nor
        the early-exit loop (the JAX package's gates): the scan path's
        post-hoc lengths serve."""
        assert len(sources) == self.num_sources
        B = sources[0].shape[0]
        packs = self._packs(sources, memory_lengths, teacher_alignments)
        if self.fused_inference:
            reason = self._fused_unsupported_reason(B, teacher_alignments)
            inputs = None
            if reason is None:
                inputs = self.fused_inputs(packs, speaker_embed)
                reason = self._fused_kernel_unsupported_reason(inputs)
            if reason is None:
                log_path_once("decoder", "fused_decode kernel")
                return self._decode_path_fused(inputs, self.max_iters)
            _warn_fused_fallback(reason)
        log_path_once("decoder", hop_path(
            self.use_pallas, "incremental_attention_step")
            if self.transformers else "none (no hops)")
        if self.early_stop and not self.apply_dropout_on_inference:
            return self._decode_path_while(packs, B, self.max_iters,
                                           speaker_embed)
        return self._decode_path(packs, B, self.max_iters,
                                 speaker_embed=speaker_embed,
                                 generator=generator)

    def validation_forward(self, sources: Sequence[torch.Tensor],
                           memory_lengths: Sequence[torch.Tensor],
                           target: torch.Tensor, teacher_forcing: bool,
                           speaker_embed: Optional[torch.Tensor] = None,
                           teacher_alignments: Optional[
                               Sequence[torch.Tensor]] = None,
                           generator: Optional[torch.Generator] = None
                           ) -> DecoderOutput:
        """VALIDATION: the decode loop over the target's T // r steps,
        teacher-forced or free-running; with ``teacher_alignments`` (per
        source (B, T_steps, T_mem)) step t attends with row
        min(t, T_steps - 1) of them, whatever the mechanism (the
        forced-alignment mode's second pass).  ``target`` is (mgc, lf0)
        for the MGC/LF0 decoder; ``generator`` as in ``forward``."""
        B = sources[0].shape[0]
        num_steps = _first(target).shape[1] // self.outputs_per_step
        packs = self._packs(sources, memory_lengths, teacher_alignments)
        teacher = (self._teacher_inputs(target, num_steps) if teacher_forcing
                   else None)
        return self._decode_path(packs, B, num_steps, DecoderMode.VALIDATION,
                                 teacher, speaker_embed, generator)

    # ----------------------------------------------------------- step pieces
    def _packs(self, sources, memory_lengths, teacher_alignments=None):
        """Each source's precomputed pack, carrying its supplied alignments
        when there are any."""
        packs = []
        for i, (mech, src, ln) in enumerate(zip(
                self.attention_mechanisms, sources, memory_lengths)):
            ta = None if teacher_alignments is None else teacher_alignments[i]
            if isinstance(mech, TeacherForcingAttention):
                packs.append(mech.precompute(src, ln, ta))
            else:
                packs.append(mech.precompute(src, ln)._replace(
                    teacher_alignments=ta))
        return tuple(packs)

    def _initial_carry(self, B, packs, device, num_steps,
                       speaker_embed=None):
        ctx_dim = sum(int(p.values.shape[-1]) for p in packs)
        return dict(speaker_embed=speaker_embed, time=0,
            att_lstm=self.attention_lstm.initial_state(B, device),
            lstm1=self.decoder_lstm1.initial_state(B, device),
            lstm2=self.decoder_lstm2.initial_state(B, device),
            att_states=tuple(mech.initial_state(B, p.values.shape[1], device)
                             for mech, p in zip(self.attention_mechanisms,
                                                packs)),
            prev_context=torch.zeros(B, ctx_dim, dtype=self.dtype,
                                     device=device),
            next_input=self._go_frame(B, device),
            caches=tuple(hop.init_cache(B, num_steps, device)
                         for hop in self.transformers))

    def _go_frame(self, B, device):
        go = tuple(torch.zeros(B, C * self.n_feed_frame, dtype=self.dtype,
                               device=device)
                   for C in self._frame_dims())
        return go if self.output_kind == "mgclf0" else go[0]

    def _rnn_step(self, carry, x, packs, training: bool = False,
                  generator=None):
        """The recurrent trunk of one step -> (carry, (o2, aligns))."""
        spk = carry["speaker_embed"]
        if self.output_kind == "mgclf0":
            x = torch.cat([self.mgc_prenets(x[0], training, generator, spk),
                           self.lf0_prenets(x[1], training, generator, spk)],
                          -1)
        else:
            x = self.prenets(x, training, generator, spk)
        att_state, h = self.attention_lstm(
            carry["att_lstm"], torch.cat([x, carry["prev_context"]], -1),
            training, generator)
        aligns, contexts, new_states = [], [], []
        for mech, state, pack in zip(self.attention_mechanisms,
                                     carry["att_states"], packs):
            if (pack.teacher_alignments is not None
                    and not isinstance(mech, TeacherForcingAttention)):
                alignment, new_state = replayed_alignment(
                    pack.teacher_alignments, carry["time"]), state
            else:
                alignment, new_state = mech.step(h, state, pack)
            aligns.append(alignment)
            contexts.append(compute_context(alignment, pack.values))
            new_states.append(new_state)
        context = torch.cat(contexts, -1)
        proj = self.output_projection_wrapper(torch.cat([h, context], -1))
        lstm1_state, l1 = self.decoder_lstm1(carry["lstm1"], proj, training,
                                             generator)
        o1 = proj + l1
        lstm2_state, l2 = self.decoder_lstm2(carry["lstm2"], o1, training,
                                             generator)
        new_carry = dict(carry, time=carry["time"] + 1, att_lstm=att_state,
                         lstm1=lstm1_state, lstm2=lstm2_state,
                         att_states=tuple(new_states), prev_context=context)
        return new_carry, (o1 + l2, aligns)

    def _step(self, carry, t, packs, mode=DecoderMode.INFERENCE,
              teacher_x_t=None, generator=None):
        """One decode step -> (carry, (outs_t, stop_t, aligns, sa_rows)),
        ``outs_t`` a tuple of one (B, C * r) row per stream."""
        carry, (y, aligns) = self._rnn_step(carry, carry["next_input"], packs,
                                            generator=generator)
        caches, sa_rows = [], []
        for hop, cache in zip(self.transformers, carry["caches"]):
            y, cache, row = hop.step(y, t, cache)
            caches.append(cache)
            sa_rows.append(row)
        outs_t, stop_t = self._heads(y)
        new_carry = dict(carry, next_input=self._next_input_from_output(
            outs_t, mode, teacher_x_t), caches=tuple(caches))
        return new_carry, (outs_t, stop_t, aligns, sa_rows)

    def _next_input_from_output(self, outs_t, mode, teacher_x_t):
        """What the next step is fed: the teacher frame(s) when
        teacher-forced (``teacher_x_t`` given), else the last n_feed_frame
        frames of each stream's output — softmax probabilities for the lf0
        stream always and, with ``feedback_softmax``, for the one stream in
        VALIDATION; the raw frames otherwise."""
        if teacher_x_t is not None:
            return _map(lambda x: x.to(self.dtype), teacher_x_t)
        n, feeds = self.n_feed_frame, []
        for idx, (o, C) in enumerate(zip(outs_t, self._frame_dims())):
            if (idx == 1 or (mode == DecoderMode.VALIDATION
                             and self.feedback_softmax)):
                probs = softmax(o.reshape(o.shape[0], -1, C), -1)
                feeds.append(probs[:, -n:].reshape(o.shape[0], C * n))
            else:
                feeds.append(o[:, -C * n:])
        return tuple(feeds) if self.output_kind == "mgclf0" else feeds[0]

    # -------------------------------------------------------- decode paths
    def _decode_path(self, packs, B, num_steps, mode=DecoderMode.INFERENCE,
                     teacher=None, speaker_embed=None, generator=None):
        """All ``num_steps`` steps.  INFERENCE: lengths from the first step
        at which every row's stop token has fired (dynamic_decode
        semantics), outputs masked past them.  VALIDATION: lengths are
        ``num_steps``; ``teacher`` holds the GO-shifted teacher inputs when
        teacher-forced, None when free-running."""
        device = packs[0].keys.device
        carry = self._initial_carry(B, packs, device, num_steps,
                                    speaker_embed)
        if teacher is not None:
            # next_inputs(time=t) feeds target step t itself: the shifted
            # teacher sequence advanced by one, feed[t] = shifted[t + 1]
            teacher = _map(lambda x: torch.cat(
                [x[:, 1:], torch.zeros_like(x[:, :1])], 1), teacher)
        finished = torch.zeros(B, dtype=torch.bool, device=device)
        outs, stops, aligns, sa_rows, row_fin = [], [], [], [], []
        for t in range(num_steps):
            carry, (out_t, stop_t, al, sa) = self._step(
                carry, t, packs, mode,
                None if teacher is None else _map(lambda x: x[:, t], teacher),
                generator)
            finished = finished | ((sigmoid(stop_t[:, 0]) > 0.5)
                                   & (t > self.min_iters))
            outs.append(out_t)
            stops.append(stop_t)
            aligns.append(al)
            sa_rows.append(sa)
            row_fin.append(finished)
        inference = mode == DecoderMode.INFERENCE
        lengths = (stop_lengths(torch.stack(row_fin, 1)) if inference else
                   torch.full((B,), num_steps, dtype=torch.long,
                              device=device))
        return self._package(
            tuple(torch.stack([o[i] for o in outs], 1)
                  for i in range(len(outs[0]))), torch.stack(stops, 1),
            tuple(torch.stack([a[i] for a in aligns], 1)
                  for i in range(self.num_sources)),
            self._sa_aligns(sa_rows, B, num_steps, device), lengths,
            num_steps, mask_by_lengths=inference)

    def _decode_path_while(self, packs, B, num_steps, speaker_embed=None):
        """Early exit once every row's stop token fired past min_iters;
        entries past the exit stay zero."""
        device = packs[0].keys.device
        carry = self._initial_carry(B, packs, device, num_steps,
                                    speaker_embed)
        r = self.outputs_per_step
        finished = torch.zeros(B, dtype=torch.bool, device=device)
        lengths = torch.zeros(B, dtype=torch.int64, device=device)
        dt = self.dtype
        buf_out = tuple(torch.zeros(B, num_steps, C * r, dtype=dt,
                                    device=device)
                        for C in self._frame_dims())
        buf_stop = torch.zeros(B, num_steps, 1, dtype=dt, device=device)
        buf_al = [torch.zeros(B, num_steps, p.values.shape[1], dtype=dt,
                              device=device)
                  for p in packs]
        sa_rows = []
        for t in range(num_steps):
            if bool(finished.all()):
                break
            carry, (out_t, stop_t, al, sa) = self._step(carry, t, packs)
            lengths = lengths + (~finished).long()
            finished = finished | ((sigmoid(stop_t[:, 0]) > 0.5)
                                   & (t > self.min_iters))
            for buf, o in zip(buf_out, out_t):
                buf[:, t] = o
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
                               num_steps, dtype=self.dtype, device=device)
            for t, step_rows in enumerate(sa_rows):
                rows[:, t] = step_rows[hop]
            out.extend(rows[:, :, h] for h in range(rows.shape[2]))
        return out

    # ---------------------------------------------------------- TRAIN mode
    def train_forward(self, sources: Sequence[torch.Tensor],
                      memory_lengths: Sequence[torch.Tensor],
                      target: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      speaker_embed: Optional[torch.Tensor] = None
                      ) -> DecoderOutput:
        """Teacher-forced training over the target's T // r steps: the
        trunk, then the causal hops over the whole sequence and the heads
        (the JAX package's ``_train_transformer_path``; without hops, its
        step loop with ``teacher_forcing``); ``target`` is (mgc, lf0) for
        the MGC/LF0 decoder."""
        B = sources[0].shape[0]
        num_steps = _first(target).shape[1] // self.outputs_per_step
        packs = self._packs(sources, memory_lengths)
        teacher = self._teacher_inputs(target, num_steps)
        reason = None
        if self.fused_train:
            reason = ("decoders without self-attention hops train through "
                      "the step loop, as in the JAX package"
                      if not self.transformers else
                      self._fused_train_unsupported_reason(B, packs, teacher))
            if reason is not None:
                _warn_fused_fallback(reason, "decoder_fused_train")
        if self.fused_train and reason is None:
            y, aligns = self._train_trunk_fused(packs, teacher, generator,
                                                speaker_embed)
        else:
            y, aligns = self._train_trunk_plain(packs, teacher, generator,
                                                speaker_embed)
        sa_aligns: List[torch.Tensor] = []
        for hop in self.transformers:
            y, heads = hop(y, True, generator)
            sa_aligns.extend(heads)
        outs, stop = self._heads(y)
        lengths = torch.full((B,), num_steps, dtype=torch.long,
                             device=y.device)
        return self._package(outs, stop, aligns, sa_aligns, lengths,
                             num_steps)

    def _teacher_inputs(self, target, num_steps):
        """[GO, tgt_0, ..., tgt_{S-2}] per reduced step, keeping the last
        n_feed_frame frames of each step (of each stream)."""
        targets = target if self.output_kind == "mgclf0" else (target,)
        xs = []
        for tgt, C in zip(targets, self._frame_dims()):
            B = tgt.shape[0]
            reduced = tgt.reshape(B, num_steps, C * self.outputs_per_step)
            feed = reduced[:, :-1, -C * self.n_feed_frame:]
            go = torch.zeros(B, 1, C * self.n_feed_frame, dtype=tgt.dtype,
                             device=tgt.device)
            xs.append(torch.cat([go, feed], 1))
        return tuple(xs) if self.output_kind == "mgclf0" else xs[0]

    def _train_trunk_plain(self, packs, teacher, generator,
                           speaker_embed=None):
        B, S = _first(teacher).shape[:2]
        carry = self._initial_carry(B, packs, _first(teacher).device, S,
                                    speaker_embed)
        ys, aligns = [], []
        for t in range(S):
            carry, (y, al) = self._rnn_step(
                carry, _map(lambda x: x[:, t], teacher), packs, True,
                generator)
            ys.append(y)
            aligns.append(al)
        return torch.stack(ys, 1), tuple(
            torch.stack([a[i] for a in aligns], 1)
            for i in range(self.num_sources))

    def _fused_train_unsupported_reason(self, B, packs, teacher
                                        ) -> Optional[str]:
        """Configuration gate of the training kernels (the JAX package's
        ``_fused_train_supported`` without its TPU reasons);
        ``fused_train_dtype`` bfloat16 is their bf16 storage mode."""
        if self.output_kind != "single":
            return f"output_kind={self.output_kind!r} is not fused"
        if len({int(p.values.shape[1]) for p in packs}) != 1:
            return "sources with different memory lengths"
        reason = self._fused_attention_unsupported_reason()
        if reason is not None:
            return reason
        kinds, cum, _, _ = self._fused_attention_params()
        spec = ft.make_spec(
            self.fused_train_params(), [p.keys for p in packs],
            [p.values for p in packs], teacher, drop_rate=0.0, zc_att=0.0,
            zo_att=0.0, zc_dec=0.0, zo_dec=0.0, deterministic=False,
            p_dropout=self.prenets.dense_layers()[1],
            use_spk=self.prenets.use_speaker_embed, src_kinds=kinds,
            cumulative=cum, loc_kernel=self._loc_kernel(),
            compute_dtype=self.fused_train_dtype)
        return ft.unsupported_reason(spec)

    def _fused_attention_unsupported_reason(self) -> Optional[str]:
        for m in self.attention_mechanisms:
            if isinstance(m, TeacherForcingAttention):
                return "unsupported attention mechanism: " + type(m).__name__
            if getattr(m, "smoothing", False):
                return "sigmoid-smoothing attention is not fused"
            if getattr(m, "use_transition_agent", False):
                return "the forward-attention transition agent is not fused"
        loc_kernels = {m.attention_kernel for m in self.attention_mechanisms
                       if not isinstance(m, AdditiveAttention)}
        if len(loc_kernels) > 1:
            return "mixed location-conv kernel sizes are not fused"
        return None

    def _loc_kernel(self) -> int:
        return max(getattr(m, "attention_kernel", 1)
                   for m in self.attention_mechanisms)

    def _fused_attention_params(self):
        """Per source: the kind, the cumulative flag, the (K, U) product
        conv @ location dense (None for additive) and the (U,) fold
        attention bias + conv bias @ location dense that joins the keys.
        Plain torch ops: autograd carries the kernels' gradients back to
        the modules' weights."""
        kinds, cum, loc_ws, folds = [], [], [], []
        for m in self.attention_mechanisms:
            if isinstance(m, AdditiveAttention):
                kinds.append("additive")
                cum.append(False)
                loc_ws.append(None)
                folds.append(None)
                continue
            kinds.append("forward" if isinstance(m, ForwardAttention)
                         else "location_sensitive")
            cum.append(bool(m.cumulative_weights))
            conv = m.location_convolution                 # weight (F, 1, K)
            w_loc = m.location_layer.weight.t()           # (F, U)
            loc_ws.append(conv.weight[:, 0, :].t() @ w_loc)
            folds.append(m.attention_bias + conv.bias @ w_loc)
        return tuple(kinds), tuple(cum), tuple(loc_ws), tuple(folds)

    def fused_train_params(self) -> ft.FusedTrainParams:
        """The trunk's weights in the JAX layout ((in, out) matrices, (1,
        out) bias rows), the query projection and energy vector per
        source; the fused decode's weights start from the same."""
        def dense(mod):
            return mod.weight.t(), mod.bias[None]

        query = tuple(
            (m.query_layer.weight.t(),
             (m.attention_v if isinstance(m, AdditiveAttention)
              else m.attention_variable).t())
            for m in self.attention_mechanisms)
        return ft.FusedTrainParams(
            prenet=tuple(dense(d) for d in self.prenets.dense_layers()[0]),
            att_lstm=dense(self.attention_lstm), query=query,
            outproj=dense(self.output_projection_wrapper),
            lstm1=dense(self.decoder_lstm1), lstm2=dense(self.decoder_lstm2))

    def speaker_row(self, speaker_embed) -> Optional[torch.Tensor]:
        """The (B, P0) float32 row the speaker prenet adds after dense0's
        ReLU (the JAX package's ``_fused_prenet_params``), or None."""
        if not self.prenets.use_speaker_embed:
            return None
        return self.prenets.prenet_0.speaker_row(speaker_embed, float32=True)

    def _train_trunk_fused(self, packs, teacher, generator,
                           speaker_embed=None):
        kinds, cum, loc_ws, folds = self._fused_attention_params()
        # rank r of a data axis adds r * 40507, as the JAX package's
        # shard_map adds its axis index (``_shard_mapped_fused_scan``)
        seed = int(torch.randint(0, 1 << 31, (1,), generator=generator,
                                 device=(generator.device if generator
                                         is not None else "cpu")))
        seed += axis_rank() * TRUNK_SEED_STRIDE
        zc_dec, zo_dec = self._dec_zoneout()
        y, aligns = ft.fused_teacher_scan(
            self.fused_train_params(),
            tuple(p.keys.float() if f is None else p.keys.float() + f
                  for p, f in zip(packs, folds)),
            tuple(p.values.float() for p in packs),
            tuple(p.mask.float() for p in packs), teacher.float(), seed,
            drop_rate=self.prenets.drop_rate,
            zc_att=self.zoneout_factor_cell,
            zo_att=self.zoneout_factor_output, zc_dec=zc_dec, zo_dec=zo_dec,
            deterministic=False, p_dropout=self.prenets.dense_layers()[1],
            speaker_row=self.speaker_row(speaker_embed), src_kinds=kinds,
            cumulative=cum, loc_kernel=self._loc_kernel(), loc_ws=loc_ws,
            compute_dtype=self.fused_train_dtype)
        return y.to(self.dtype), tuple(a.to(self.dtype) for a in aligns)

    # ------------------------------------------------- the fused kernel
    def _fused_unsupported_reason(self, B, teacher_alignments=None
                                  ) -> Optional[str]:
        """Configuration gate of the fused decode (the JAX package's
        ``_fused_unsupported_reason`` and ``_fused_attention_unsupported_
        reason``): the output and KV-cache buffer limit and the mechanism
        checks; then ``_fused_kernel_unsupported_reason`` (the kernel's
        shared-memory plan, which bounds the batch).  Every batch, source
        kind and memory length is fused otherwise.  As in the JAX package
        the MGC/LF0 outputs, inference dropout, a forced-alignment replay,
        sigmoid smoothing and the transition agent are refused here.
        ``fused_dtype`` bfloat16 is the kernel's bf16 storage mode
        (``merge_weights``'s ``compute_dtype``)."""
        buf_bytes = B * self.max_iters * 4 * (
            self.num_mels * self.outputs_per_step + 1
            + 2 * len(self.transformers) * self.self_attention_out_units)
        if buf_bytes > (64 << 20):
            return (f"output/KV buffers need {buf_bytes >> 20} MiB "
                    "(> 64 MiB gate)")
        if self.output_kind != "single":
            return f"output_kind={self.output_kind!r} (mgclf0 not fused)"
        if self.apply_dropout_on_inference:
            return "inference-time prenet dropout is not fused"
        if self.fused_dtype not in ("float32", "bfloat16"):
            return f"fused_dtype={self.fused_dtype!r} is not a storage dtype"
        if teacher_alignments is not None:
            return "forced-alignment replay is not fused"
        return self._fused_attention_unsupported_reason()

    def _fused_kernel_unsupported_reason(self, inputs) -> Optional[str]:
        weights, memory, options = inputs
        return fd.unsupported_reason(
            weights, batch=int(memory.keys[0].shape[0]),
            t_sizes=[int(k.shape[1]) for k in memory.keys],
            c_sizes=[int(v.shape[2]) for v in memory.values],
            num_steps=self.max_iters, num_heads=options["num_heads"])

    def fused_params(self) -> fd.FusedDecodeParams:
        """This module's weights in the JAX layout the merges start from."""
        def row(b):
            return b.reshape(1, -1)

        def dense(m):
            return m.weight.t(), row(m.bias)

        loc = []
        for m in self.attention_mechanisms:
            if isinstance(m, AdditiveAttention):
                loc.append(None)
                continue
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
            *self.fused_train_params(), hops=tuple(hops),
            head=(torch.cat([out_p.weight.t(), stop_p.weight.t()], 1),
                  row(torch.cat([out_p.bias, stop_p.bias]))),
            loc=tuple(loc))

    def fused_inputs(self, packs, speaker_embed=None):
        """(weights, memory, run options) of ops/fused_decode.  The merged
        weights are made once and reused until a parameter changes
        (``weights_key``); the speaker row is made per call."""
        key = weights_key(self)
        if getattr(self, "_merged", (None,))[0] != key:
            mechs = self.attention_mechanisms
            self._merged = (key, fd.merge_weights(
                self.fused_params(), num_mels=self.num_mels,
                outputs_per_step=self.outputs_per_step,
                n_feed_frame=self.n_feed_frame,
                src_kinds=self._fused_attention_params()[0],
                cumulative=tuple(getattr(m, "cumulative_weights", False)
                                 for m in mechs),
                loc_kernel=max(getattr(m, "attention_kernel", 1)
                               for m in mechs),
                compute_dtype=self.fused_dtype))
        memory = fd.FusedDecodeMemory(
            keys=tuple(pk.keys.float() for pk in packs),
            values=tuple(pk.values.float() for pk in packs),
            masks=tuple(pk.mask for pk in packs))
        zc_dec, zo_dec = self._dec_zoneout()
        options = dict(
            num_heads=self.self_attention_num_heads,
            zoneout_cell=self.zoneout_factor_cell,
            zoneout_output=self.zoneout_factor_output,
            dec_zoneout_cell=zc_dec, dec_zoneout_output=zo_dec,
            early_stop=self.early_stop, min_iters=self.min_iters,
            speaker_row=self.speaker_row(speaker_embed))
        return self._merged[1], memory, options

    def _decode_path_fused(self, inputs, num_steps):
        """``fused_decode`` on ``fused_inputs``; source alignments are
        zeros for B > 1, as in the JAX package."""
        weights, memory, options = inputs
        out, stop, aligns = fd.fused_decode(weights, memory,
                                            num_steps=num_steps, **options)
        # lengths recovered post hoc from the stop logits
        S, B = num_steps, out.shape[0]
        device = out.device
        fired = (stop > 0) & (torch.arange(S, device=device)[None, :]
                              > self.min_iters)
        lengths = stop_lengths(torch.cumsum(fired.int(), 1) > 0)
        dt = self.dtype
        sa_aligns = [torch.zeros(B, S, S, dtype=dt, device=device)
                     for _ in range(self.self_attention_num_hop
                                    * self.self_attention_num_heads)]
        return self._package((out.to(dt),), stop[..., None].to(dt),
                             tuple(a.to(dt) for a in aligns), sa_aligns,
                             lengths, S, mask_by_lengths=True)

    # ------------------------------------------------------------ packaging
    def _package(self, outs, stop, aligns, sa_aligns, lengths, num_steps,
                 mask_by_lengths: bool = False) -> DecoderOutput:
        """``outs``: one (B, S, C * r) tensor per stream."""
        r, dims = self.outputs_per_step, self._frame_dims()
        B = outs[0].shape[0]
        lengths = lengths.long()
        if mask_by_lengths:
            valid = (torch.arange(num_steps, device=stop.device)[None, :]
                     < lengths[:, None])[..., None]
            outs = tuple(o * valid.to(o.dtype) for o in outs)
            stop = stop * valid.to(stop.dtype)
        samples = outs[0].reshape(B, num_steps, r, dims[0]).argmax(-1).int()
        return DecoderOutput(
            outputs=outs[0].reshape(B, num_steps * r, dims[0]),
            stop_token=stop, predicted_samples=samples,
            alignments=tuple(a.transpose(1, 2) for a in aligns),
            self_attention_alignments=[a.transpose(1, 2) for a in sa_aligns],
            lengths=lengths,
            outputs2=(outs[1].reshape(B, num_steps * r, dims[1])
                      if len(outs) > 1 else None))
