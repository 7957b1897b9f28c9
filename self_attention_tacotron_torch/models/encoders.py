"""The encoders.

Counterpart of the JAX package's ``models/encoders.py``:
* ``_CBHGTrunk`` — conv bank K=1..16 -> max pool -> two projection convs ->
  residual -> (dim-adjust dense) -> highway stack;
* ``ZoneoutCBHG`` — the trunk followed by a bidirectional zoneout LSTM;
* ``CBHG`` — the trunk followed by a bidirectional GRU (original Tacotron);
* ``SelfAttentionTransformer`` — one hop: x + tanh(Dense(MHA(x)));
* ``ZoneoutEncoderV1`` — prenet -> ZoneoutCBHG with
  ``use_zoneout_at_encoder`` (the mel recipes' encoder), else prenet ->
  CBHG (``examples/codes/tacotron.json``);
* ``SelfAttentionCBHGEncoder`` — prenet -> ZoneoutCBHG -> projection ->
  self-attention hops.  With ``fused_inference`` at batch 1 it merges its
  weights (``_fused_call``) and runs ``ops/fused_encoder.fused_encode``
  (any source length; widths the kernel has no room for raise on the
  card, ``fused_encoder.unsupported_reason``);
  in training (``is_training``: prenet dropout, batch statistics, zoneout
  and attention dropout drawn from the caller's ``torch.Generator``) it
  always takes the module path.  ``use_pallas`` (the Pallas attention mode)
  reaches each hop's ``MultiHeadAttention``; the batch-1 fused encoder keeps
  its precedence over it.  An inference call logs once which path serves
  its self-attention (``log_path_once``; the decoder does the same);
* ``EncoderV1WithAccentType`` — the phone prenet stack (``prenets``) and
  the accent-type prenet stack (``accent_type_prenets``) over the accent
  embedding, concatenated, then ZoneoutCBHG (``use_zoneout``) or CBHG;
* ``SelfAttentionCBHGEncoderWithAccentType`` — the same two stacks, then
  ZoneoutCBHG, the projection and the self-attention hops of
  ``SelfAttentionCBHGEncoder``.  As in the JAX package it has no fused
  encoder path; in the Pallas attention mode its hops run
  ``fused_self_attention``;
* ``EncoderV2`` — Tacotron 2's: N x (conv k -> batch norm -> ReLU ->
  dropout), then a zoneout bi-LSTM of ``out_units // 2`` a direction.

Model-wide bf16 (``ops/compute_dtype.py``): every layer computes in its
``dtype``; the batch-1 fused encoder takes the bf16 embeddings upcast to
float32 and its outputs are cast back to ``dtype`` (the JAX package's
``fused_encode`` boundary), its merged weights float32 as ever.

Submodule names follow the flax tree so ``utils/convert.py`` maps
parameters one to one.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence

import torch
from torch import nn

from ..ops import fused_encoder as fe
from ..ops.attention_core import SelfAttention, dropout
from ..ops.compute_dtype import Linear
from ..ops.conv import BN_EPSILON, Conv1dBN, ConvBank, HighwayNet
from ..ops.rnn import BiGRU, BiZoneoutLSTM, fold_forget_bias
from .prenet import PreNetStack

_logger = logging.getLogger(__name__)
_logged_paths: set = set()


def log_path_once(module: str, path: str) -> None:
    """Logs once per (module, path) which path serves ``module``'s
    self-attention in inference."""
    if (module, path) not in _logged_paths:
        _logged_paths.add((module, path))
        _logger.info("%s self-attention: %s", module, path)


def hop_path(use_pallas: bool, kernel: str) -> str:
    """The unfused path of a self-attention hop, for ``log_path_once``."""
    return (f"{kernel} kernel (Pallas attention mode)" if use_pallas
            else "einsum module path")


def _contiguous(tree):
    """Each tensor of a nest of tuples made contiguous (the layout the
    kernel reads, so that a cached merge keeps its pointers from call to
    call)."""
    if isinstance(tree, torch.Tensor):
        return tree.contiguous()
    return None if tree is None else tuple(map(_contiguous, tree))


def weights_key(module: nn.Module) -> tuple:
    """Identifies the current values of a module's parameters and buffers:
    storage, device and in-place version of each (a ``load_state_dict``,
    an in-place update or a move to another device changes it)."""
    return tuple((t.data_ptr(), t.device, t._version)
                 for t in (*module.parameters(), *module.buffers()))


class _CBHGTrunk(nn.Module):
    def __init__(self, in_channels: int, out_units: int, conv_channels: int,
                 max_filter_width: int, projection1_out_channels: int,
                 projection2_out_channels: int, num_highway: int):
        super().__init__()
        half = out_units // 2
        self.num_highway = num_highway
        self.conv_bank = ConvBank(in_channels, max_filter_width,
                                  conv_channels)
        self.proj1 = Conv1dBN(max_filter_width * conv_channels, 3,
                              projection1_out_channels, torch.relu)
        self.proj2 = Conv1dBN(projection1_out_channels, 3,
                              projection2_out_channels, None)
        self.adjustment_layer = (Linear(projection2_out_channels, half)
                                 if projection2_out_channels != half else None)
        for i in range(num_highway):
            self.add_module(f"highway_{i}", HighwayNet(half, half))

    def forward(self, xs: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = self.proj2(self.proj1(self.conv_bank(xs, train), train),
                       train) + xs
        if self.adjustment_layer is not None:
            h = self.adjustment_layer(h)
        for i in range(self.num_highway):
            h = getattr(self, f"highway_{i}")(h)
        return h


class ZoneoutCBHG(nn.Module):
    def __init__(self, in_channels: int, out_units: int, conv_channels: int,
                 max_filter_width: int, projection1_out_channels: int,
                 projection2_out_channels: int, num_highway: int,
                 zoneout_factor_cell: float = 0.0,
                 zoneout_factor_output: float = 0.0):
        super().__init__()
        self.trunk = _CBHGTrunk(in_channels, out_units, conv_channels,
                                max_filter_width, projection1_out_channels,
                                projection2_out_channels, num_highway)
        self.bilstm = BiZoneoutLSTM(out_units // 2, out_units // 2,
                                    zoneout_factor_cell,
                                    zoneout_factor_output)

    def forward(self, xs, input_lengths=None, is_training: bool = False,
                generator=None):
        return self.bilstm(self.trunk(xs, is_training), input_lengths,
                           is_training, generator)


class CBHG(nn.Module):
    """The trunk followed by a bidirectional GRU of out_units // 2 units a
    direction (no zoneout)."""

    def __init__(self, in_channels: int, out_units: int, conv_channels: int,
                 max_filter_width: int, projection1_out_channels: int,
                 projection2_out_channels: int, num_highway: int):
        super().__init__()
        self.trunk = _CBHGTrunk(in_channels, out_units, conv_channels,
                                max_filter_width, projection1_out_channels,
                                projection2_out_channels, num_highway)
        self.bigru = BiGRU(out_units // 2, out_units // 2)

    def forward(self, xs, input_lengths=None, is_training: bool = False,
                generator=None):
        return self.bigru(self.trunk(xs, is_training), input_lengths)


class ZoneoutEncoderV1(nn.Module):
    """PreNet stack -> ZoneoutCBHG (``use_zoneout``) or CBHG; returns the
    bidirectional recurrence's output (B, T, cbhg_out_units).  Training
    (``is_training``: prenet dropout, batch statistics and zoneout from the
    caller's ``torch.Generator``) and inference take the same module
    path."""

    def __init__(self, in_channels: int, cbhg_out_units: int = 256,
                 conv_channels: int = 128, max_filter_width: int = 16,
                 projection1_out_channels: int = 128,
                 projection2_out_channels: int = 128, num_highway: int = 4,
                 prenet_out_units: Sequence[int] = (256, 128),
                 drop_rate: float = 0.5, use_zoneout: bool = False,
                 zoneout_factor_cell: float = 0.0,
                 zoneout_factor_output: float = 0.0):
        super().__init__()
        self.prenets = PreNetStack(in_channels, prenet_out_units, drop_rate)
        trunk = (prenet_out_units[-1], cbhg_out_units, conv_channels,
                 max_filter_width, projection1_out_channels,
                 projection2_out_channels, num_highway)
        self.cbhg = (ZoneoutCBHG(*trunk, zoneout_factor_cell,
                                 zoneout_factor_output)
                     if use_zoneout else CBHG(*trunk))

    def forward(self, inputs, input_lengths=None, is_training: bool = False,
                generator=None):
        return self.cbhg(self.prenets(inputs, is_training, generator),
                         input_lengths, is_training, generator)


class EncoderV1WithAccentType(nn.Module):
    """Phone and accent-type prenet stacks, concatenated -> ZoneoutCBHG
    (``use_zoneout``) or CBHG; returns the recurrence's output."""

    def __init__(self, in_channels: int, accent_channels: int,
                 cbhg_out_units: int = 256, conv_channels: int = 128,
                 max_filter_width: int = 16,
                 projection1_out_channels: int = 128,
                 projection2_out_channels: int = 128, num_highway: int = 4,
                 prenet_out_units: Sequence[int] = (224, 112),
                 accent_type_prenet_out_units: Sequence[int] = (32, 16),
                 drop_rate: float = 0.5, use_zoneout: bool = False,
                 zoneout_factor_cell: float = 0.0,
                 zoneout_factor_output: float = 0.0):
        super().__init__()
        self.prenets = PreNetStack(in_channels, prenet_out_units, drop_rate)
        self.accent_type_prenets = PreNetStack(
            accent_channels, accent_type_prenet_out_units, drop_rate)
        trunk = (prenet_out_units[-1] + accent_type_prenet_out_units[-1],
                 cbhg_out_units, conv_channels, max_filter_width,
                 projection1_out_channels, projection2_out_channels,
                 num_highway)
        self.cbhg = (ZoneoutCBHG(*trunk, zoneout_factor_cell,
                                 zoneout_factor_output)
                     if use_zoneout else CBHG(*trunk))

    def forward(self, inputs, accent, input_lengths=None,
                is_training: bool = False, generator=None):
        h = torch.cat([self.prenets(inputs, is_training, generator),
                       self.accent_type_prenets(accent, is_training,
                                                generator)], -1)
        return self.cbhg(h, input_lengths, is_training, generator)


class EncoderV2(nn.Module):
    """N x (conv ``kernel_size`` -> batch norm -> ReLU -> dropout) -> a
    zoneout bi-LSTM of ``out_units // 2`` units a direction."""

    def __init__(self, in_channels: int, num_conv_layers: int = 3,
                 kernel_size: int = 5, out_units: int = 512,
                 drop_rate: float = 0.5, zoneout_factor_cell: float = 0.0,
                 zoneout_factor_output: float = 0.0):
        super().__init__()
        self.num_conv_layers = num_conv_layers
        self.drop_rate = drop_rate
        for i in range(num_conv_layers):
            self.add_module(f"conv_{i}", Conv1dBN(
                in_channels if i == 0 else out_units, kernel_size,
                out_units, torch.relu))
        self.bilstm = BiZoneoutLSTM(
            in_channels if num_conv_layers == 0 else out_units,
            out_units // 2, zoneout_factor_cell, zoneout_factor_output)

    def forward(self, inputs, input_lengths=None, is_training: bool = False,
                generator=None):
        h = inputs
        for i in range(self.num_conv_layers):
            h = getattr(self, f"conv_{i}")(h, is_training)
            if is_training:
                h = dropout(h, self.drop_rate, generator)
        return self.bilstm(h, input_lengths, is_training, generator)


class SelfAttentionTransformer(nn.Module):
    """One hop: x + tanh(transform(MHA(x))); ``step`` is its KV-cache form."""

    def __init__(self, out_units: int, self_attention_out_units: int,
                 self_attention_num_heads: int,
                 use_subsequent_mask: bool = False, drop_rate: float = 0.0,
                 use_pallas: bool = False):
        super().__init__()
        self.self_attention = SelfAttention(self_attention_out_units,
                                            self_attention_num_heads,
                                            use_subsequent_mask, drop_rate,
                                            use_pallas)
        self.transform = Linear(self_attention_out_units, out_units)

    def forward(self, inputs, training: bool = False, generator=None):
        attn_out, alignment = self.self_attention(inputs, training, generator)
        residual = inputs + torch.tanh(self.transform(attn_out))
        return residual, [alignment[:, i] for i in range(alignment.shape[1])]

    def init_cache(self, batch: int, max_len: int, device=None):
        return self.self_attention.init_cache(batch, max_len, device)

    def step(self, x_t, t, cache):
        attn_t, new_cache, align_row = self.self_attention.step(x_t, t, cache)
        return x_t + torch.tanh(self.transform(attn_t)), new_cache, align_row


class SelfAttentionCBHGEncoder(nn.Module):
    """Returns (lstm_out, self_attention_out, alignments)."""

    dtype = torch.float32

    def __init__(self, in_channels: int, cbhg_out_units: int = 224,
                 conv_channels: int = 128, max_filter_width: int = 16,
                 projection1_out_channels: int = 128,
                 projection2_out_channels: int = 128, num_highway: int = 4,
                 self_attention_out_units: int = 32,
                 self_attention_num_heads: int = 2,
                 self_attention_num_hop: int = 1,
                 prenet_out_units: Sequence[int] = (256, 128),
                 zoneout_factor_cell: float = 0.0,
                 zoneout_factor_output: float = 0.0,
                 fused_inference: bool = False, drop_rate: float = 0.5,
                 self_attention_drop_rate: float = 0.0,
                 use_pallas: bool = False,
                 cbhg_in_channels: Optional[int] = None):
        super().__init__()
        self.cbhg_out_units = cbhg_out_units
        self.conv_channels = conv_channels
        self.max_filter_width = max_filter_width
        self.num_highway = num_highway
        self.self_attention_out_units = self_attention_out_units
        self.self_attention_num_heads = self_attention_num_heads
        self.self_attention_num_hop = self_attention_num_hop
        self.zoneout_factor_cell = zoneout_factor_cell
        self.zoneout_factor_output = zoneout_factor_output
        self.fused_inference = fused_inference
        self.use_pallas = use_pallas
        self.prenets = PreNetStack(in_channels, prenet_out_units, drop_rate)
        self.cbhg = ZoneoutCBHG(cbhg_in_channels or prenet_out_units[-1],
                                cbhg_out_units, conv_channels,
                                max_filter_width,
                                projection1_out_channels,
                                projection2_out_channels, num_highway,
                                zoneout_factor_cell, zoneout_factor_output)
        self.self_attention_projection_layer = Linear(
            cbhg_out_units, self_attention_out_units)
        for i in range(self_attention_num_hop):
            self.add_module(f"self_attention_{i}", SelfAttentionTransformer(
                self_attention_out_units, self_attention_out_units,
                self_attention_num_heads,
                drop_rate=self_attention_drop_rate, use_pallas=use_pallas))

    def forward(self, inputs, input_lengths=None, is_training: bool = False,
                generator=None):
        fused = (self.fused_inference and not is_training
                 and inputs.shape[0] == 1)
        if not is_training:
            log_path_once("encoder", "fused_encode kernel" if fused else
                          hop_path(self.use_pallas, "fused_self_attention"))
        if fused:
            return self._fused_call(inputs, input_lengths)
        lstm_output = self.cbhg(
            self.prenets(inputs, is_training, generator), input_lengths,
            is_training, generator)
        return (lstm_output,
                *self._hops(lstm_output, is_training, generator))

    def _hops(self, lstm_output, is_training: bool, generator):
        """The projection and the hops -> (output, alignments)."""
        sa = self.self_attention_projection_layer(lstm_output)
        alignments: List[torch.Tensor] = []
        for i in range(self.self_attention_num_hop):
            sa, heads = getattr(self, f"self_attention_{i}")(
                sa, is_training, generator)
            alignments.extend(heads)
        return sa, alignments

    # ------------------------------------------------------ kernel weights
    def fused_params(self) -> fe.FusedEncoderParams:
        """Merged weights for ops/fused_encoder: BN folded into the convs,
        the bank stacked at per-width SAME tap offsets, highway [H | T]
        interleaved, LSTM forget bias folded and its input and recurrent
        halves split (the recurrent one transposed), each hop's K|V|Q fused
        and its output and transform denses multiplied together: the
        layout the kernel reads."""
        def row(b):
            return b.reshape(1, -1)

        def dense(m):
            return m.weight.t(), row(m.bias)

        def bn_fold(cbn):
            bn = cbn.bn
            scale = bn.weight / torch.sqrt(bn.running_var + BN_EPSILON)
            shift = bn.bias - bn.running_mean * scale
            # (out, in, K) -> (K, in, out), scaled per output channel
            return cbn.conv.weight.permute(2, 1, 0) * scale, shift

        prenet = tuple(dense(p.dense) for p in self.prenets.layers())
        trunk = self.cbhg.trunk
        K, C = self.max_filter_width, self.conv_channels
        E = int(prenet[-1][1].shape[1])
        pad_g = (K - 1) // 2 if K > 1 else 0
        dev = prenet[0][0].device
        w_bank = torch.zeros(K, E, K, C, device=dev)   # (tap, in, width, out)
        b_bank = torch.zeros(1, K * C, device=dev)
        for k in range(1, K + 1):
            wk, sk = bn_fold(getattr(trunk.conv_bank, f"conv1d_K{k}"))
            b_bank[0, (k - 1) * C:k * C] = sk
            first = pad_g - (k - 1) // 2      # width k's taps, SAME offsets
            w_bank[first:first + k, :, k - 1] = wk
        w_bank = w_bank.reshape(K * E, K * C)

        def proj_fold(cbn):
            w, sh = bn_fold(cbn)
            return w.reshape(-1, w.shape[2]), row(sh)

        highway = []
        for i in range(self.num_highway):
            # [H | T] columns interleaved (H_0, T_0, H_1, T_1, ...): each
            # output's two gates land in neighbouring lanes of the kernel
            hw = getattr(trunk, f"highway_{i}")
            highway.append((
                torch.stack([hw.H.weight.t(), hw.T.weight.t()], 2).flatten(1),
                row(torch.stack([hw.H.bias, hw.T.bias], 1))))

        bl = self.cbhg.bilstm
        cells = (bl.fw, bl.bw)
        W = bl.fw.weight.shape[1] - bl.fw.num_units    # weight (4u, W + u)
        wx = torch.stack([c.weight[:, :W].t() for c in cells])
        wh_t = torch.stack([c.weight[:, W:] for c in cells])
        b_lstm = torch.stack([fold_forget_bias(c.bias) for c in cells])
        hops = []
        for i in range(self.self_attention_num_hop):
            hop = getattr(self, f"self_attention_{i}")
            att = hop.self_attention.attention
            projs = (att.key_projection, att.value_projection,
                     att.query_projection)
            wo, bo = att.output_projection.weight.t(), att.output_projection.bias
            wt, bt = hop.transform.weight.t(), hop.transform.bias
            hops.append((torch.cat([p.weight.t() for p in projs], 1),
                         row(torch.cat([p.bias for p in projs])),
                         wo @ wt, row(bo @ wt + bt)))
        return fe.FusedEncoderParams(*map(_contiguous, fe.FusedEncoderParams(
            prenet=prenet, w_bank=(w_bank, b_bank),
            w_proj1=proj_fold(trunk.proj1), w_proj2=proj_fold(trunk.proj2),
            w_adjust=(dense(trunk.adjustment_layer)
                      if trunk.adjustment_layer is not None else None),
            highway=tuple(highway), lstm=(wx, wh_t, b_lstm),
            sa_proj=dense(self.self_attention_projection_layer),
            hops=tuple(hops))))

    def _fused_call(self, inputs, input_lengths):
        """Batch 1 through the fused encoder.  Its self-attention
        probabilities are not materialized (zeros), as in the JAX kernel.
        The merged weights are made once and reused until a parameter or
        buffer changes (``weights_key``)."""
        T = inputs.shape[1]
        L = int(input_lengths[0]) if input_lengths is not None else T
        key = weights_key(self)
        if getattr(self, "_merged", (None,))[0] != key:
            self._merged = (key, self.fused_params())
        lstm_out, sa = fe.fused_encode(
            self._merged[1], inputs.float(), L,
            max_filter_width=self.max_filter_width,
            conv_channels=self.conv_channels, half=self.cbhg_out_units // 2,
            sa_units=self.self_attention_out_units,
            num_heads=self.self_attention_num_heads,
            zoneout_cell=self.zoneout_factor_cell,
            zoneout_output=self.zoneout_factor_output)
        aligns = [torch.zeros(1, T, T, dtype=self.dtype, device=inputs.device)
                  for _ in range(self.self_attention_num_hop
                                 * self.self_attention_num_heads)]
        return lstm_out.to(self.dtype), sa.to(self.dtype), aligns


class SelfAttentionCBHGEncoderWithAccentType(SelfAttentionCBHGEncoder):
    """``SelfAttentionCBHGEncoder`` whose CBHG reads the phone prenet stack
    and the accent-type prenet stack, concatenated; no fused encoder path.
    Returns (lstm_out, self_attention_out, alignments)."""

    def __init__(self, in_channels: int, accent_channels: int,
                 prenet_out_units: Sequence[int] = (224, 112),
                 accent_type_prenet_out_units: Sequence[int] = (32, 16),
                 drop_rate: float = 0.5, **kwargs):
        super().__init__(
            in_channels, prenet_out_units=prenet_out_units,
            drop_rate=drop_rate, fused_inference=False,
            cbhg_in_channels=(prenet_out_units[-1]
                              + accent_type_prenet_out_units[-1]), **kwargs)
        self.accent_type_prenets = PreNetStack(
            accent_channels, accent_type_prenet_out_units, drop_rate)

    def forward(self, inputs, accent, input_lengths=None,
                is_training: bool = False, generator=None):
        if not is_training:
            log_path_once("encoder", hop_path(self.use_pallas,
                                              "fused_self_attention"))
        h = torch.cat([self.prenets(inputs, is_training, generator),
                       self.accent_type_prenets(accent, is_training,
                                                generator)], -1)
        lstm_output = self.cbhg(h, input_lengths, is_training, generator)
        return (lstm_output,
                *self._hops(lstm_output, is_training, generator))
