"""Model assembly: embedding -> encoder -> decoder -> codes, and the loss.

Counterpart of the JAX package's ``models/tacotron.py`` ``TacotronModel``
for the VQ-code kind (``DualSourceSelfAttentionTacotronModel`` with
``SelfAttentionCBHGEncoder``): the two encoder outputs (bi-LSTM and
self-attention) are the decoder's two attention sources, and the code
output is the one-hot argmax of the decoder logits.  ``forward`` is
inference (no autograd); ``validation_forward`` the VALIDATION decode of the
trainer's evaluation (no autograd, teacher-forced or free-running with
softmax feedback); ``train_forward`` is the TRAIN mode with autograd,
its batch-norm statistics scoped to the rows whose loss mask is not empty
(``bn_valid_rows``), its dropout and zoneout drawn from the caller's
``torch.Generator``.  ``compute_loss`` is ``0.1 * codes_loss + done_loss``
(+ L2).  ``hp.use_pallas_attention`` reaches the encoder's and the
decoder's self-attention hops.  The mel and MGC/LF0 kinds, speaker routing
and postnets come with later slices.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..config import HParams
from ..ops import losses as L
from ..ops.conv import bn_valid_rows
from ..utils.convert import flax_param_paths
from .attention import AttentionOptions
from .decoder import DecoderOutput, TacotronDecoder
from .embedding import Embedding
from .encoders import SelfAttentionCBHGEncoder


class Batch(NamedTuple):
    source: torch.Tensor         # (B, T_in) int
    source_length: torch.Tensor  # (B,)
    target: Optional[torch.Tensor] = None            # (B, T, C)
    target_length: Optional[torch.Tensor] = None
    done: Optional[torch.Tensor] = None              # (B, T // r)
    spec_loss_mask: Optional[torch.Tensor] = None    # (B, T)
    binary_loss_mask: Optional[torch.Tensor] = None  # (B, T // r)

    def to(self, device) -> "Batch":
        return Batch(*(None if x is None else torch.as_tensor(x).to(device)
                       for x in self))


class TacotronOutput(NamedTuple):
    outputs: torch.Tensor                    # (B, T, C) logits
    stop_token: torch.Tensor                 # (B, S, 1)
    code_output: torch.Tensor                # (B, T, C) one-hot argmax
    alignments: Tuple[torch.Tensor, ...]     # per source (B, T_mem, S)
    encoder_self_attention_alignments: List[torch.Tensor]
    decoder_self_attention_alignments: List[torch.Tensor]
    lengths: torch.Tensor
    predicted_samples: torch.Tensor


_DECODERS = {"DualSourceTransformerDecoder": True,
             "DualSourceDecoder": False}


def attention_options_from_hparams(hp: HParams) -> Tuple[AttentionOptions, ...]:
    def mk(attention: str, units: int) -> AttentionOptions:
        return AttentionOptions(
            attention=attention, num_units=units,
            attention_kernel=hp.attention_kernel,
            attention_filters=hp.attention_filters,
            cumulative_weights=hp.cumulative_weights,
            use_transition_agent=hp.use_forward_attention_transition_agent)
    return (mk(hp.attention, hp.attention1_out_units),
            mk(hp.attention2, hp.attention2_out_units))


class TacotronModel(nn.Module):
    def __init__(self, hp: HParams):
        super().__init__()
        if hp.tacotron_model != "DualSourceSelfAttentionTacotronModel":
            raise NotImplementedError(
                f"{hp.tacotron_model} is not ported yet")
        if hp.encoder != "SelfAttentionCBHGEncoder":
            raise NotImplementedError(f"encoder {hp.encoder} is not ported yet")
        if hp.decoder not in _DECODERS:
            raise NotImplementedError(f"decoder {hp.decoder} is not ported yet")
        if (hp.use_speaker_embedding or hp.use_external_speaker_embedding
                or hp.use_accent_type or hp.use_postnet_v2):
            raise NotImplementedError("speaker, accent and postnet options "
                                      "are not ported yet")
        if hp.apply_dropout_on_inference or hp.compute_dtype != "float32":
            raise NotImplementedError("inference dropout and bfloat16 "
                                      "compute are not ported yet")
        self.hp = hp
        self.embedding = Embedding(hp.num_symbols, hp.embedding_dim)
        self.encoder = SelfAttentionCBHGEncoder(
            hp.embedding_dim, cbhg_out_units=hp.cbhg_out_units,
            conv_channels=hp.conv_channels,
            max_filter_width=hp.max_filter_width,
            projection1_out_channels=hp.projection1_out_channels,
            projection2_out_channels=hp.projection2_out_channels,
            num_highway=hp.num_highway,
            self_attention_out_units=hp.self_attention_out_units,
            self_attention_num_heads=hp.self_attention_num_heads,
            self_attention_num_hop=hp.self_attention_num_hop,
            prenet_out_units=hp.encoder_prenet_out_units,
            zoneout_factor_cell=hp.zoneout_factor_cell,
            zoneout_factor_output=hp.zoneout_factor_output,
            fused_inference=hp.encoder_fused_inference,
            drop_rate=hp.encoder_prenet_drop_rate,
            self_attention_drop_rate=hp.self_attention_drop_rate,
            use_pallas=hp.use_pallas_attention)
        self.decoder = TacotronDecoder(
            attention_options_from_hparams(hp),
            source_dims=(hp.cbhg_out_units, hp.self_attention_out_units),
            use_transformer=_DECODERS[hp.decoder],
            prenet_out_units=hp.decoder_prenet_out_units,
            attention_rnn_out_units=hp.attention_out_units,
            decoder_version=hp.decoder_version,
            decoder_out_units=hp.decoder_out_units, num_mels=hp.num_mels,
            outputs_per_step=hp.outputs_per_step,
            n_feed_frame=hp.n_feed_frame, max_iters=hp.max_iters,
            min_iters=hp.decoder_min_iters,
            zoneout_factor_cell=hp.zoneout_factor_cell,
            zoneout_factor_output=hp.zoneout_factor_output,
            self_attention_out_units=hp.decoder_self_attention_out_units,
            self_attention_num_heads=hp.decoder_self_attention_num_heads,
            self_attention_num_hop=hp.decoder_self_attention_num_hop,
            early_stop=hp.decoder_early_stop,
            fused_inference=hp.decoder_fused_inference,
            fused_dtype=hp.decoder_fused_dtype,
            drop_rate=hp.decoder_prenet_drop_rate,
            self_attention_drop_rate=hp.decoder_self_attention_drop_rate,
            fused_train=hp.decoder_fused_train,
            fused_train_dtype=hp.decoder_fused_train_dtype,
            use_pallas=hp.use_pallas_attention)

    def _output(self, dec: DecoderOutput, enc_aligns) -> TacotronOutput:
        code_output = torch.nn.functional.one_hot(
            dec.outputs.detach().argmax(-1), self.hp.num_mels).to(
                dec.outputs.dtype)
        return TacotronOutput(
            outputs=dec.outputs, stop_token=dec.stop_token,
            code_output=code_output, alignments=dec.alignments,
            encoder_self_attention_alignments=[a.transpose(1, 2)
                                               for a in enc_aligns],
            decoder_self_attention_alignments=dec.self_attention_alignments,
            lengths=dec.lengths, predicted_samples=dec.predicted_samples)

    @torch.no_grad()
    def forward(self, batch: Batch) -> TacotronOutput:
        device = self.embedding.weight.device
        source = batch.source.to(device)
        lengths = batch.source_length.to(device)
        emb = self.embedding(source)
        lstm_out, sa_out, enc_aligns = self.encoder(emb, lengths)
        return self._output(self.decoder((lstm_out, sa_out),
                                         (lengths, lengths)), enc_aligns)

    @torch.no_grad()
    def validation_forward(self, batch: Batch,
                           teacher_forcing: bool) -> TacotronOutput:
        """VALIDATION mode: the deterministic encoder (batch norm on its
        running statistics), then the decode loop over the target's
        T // r steps, fed the targets (``teacher_forcing``) or its own
        softmax outputs (the JAX package's ``_forward`` in
        ``DecoderMode.VALIDATION``)."""
        batch = batch.to(self.embedding.weight.device)
        emb = self.embedding(batch.source)
        lstm_out, sa_out, enc_aligns = self.encoder(emb, batch.source_length)
        return self._output(self.decoder.validation_forward(
            (lstm_out, sa_out), (batch.source_length,) * 2,
            batch.target.float(), teacher_forcing), enc_aligns)

    def train_forward(self, batch: Batch,
                      generator: Optional[torch.Generator] = None
                      ) -> TacotronOutput:
        """TRAIN mode: teacher forcing, dropout, zoneout and batch
        statistics, with autograd.  Rows whose spectrogram loss mask is all
        zero (duplicates padding a batch) stay out of the batch-norm
        statistics."""
        device = self.embedding.weight.device
        batch = batch.to(device)
        valid = None
        if batch.spec_loss_mask is not None:
            valid = batch.spec_loss_mask.reshape(
                batch.spec_loss_mask.shape[0], -1).amax(1) > 0
        with bn_valid_rows(valid):
            emb = self.embedding(batch.source)
            lstm_out, sa_out, enc_aligns = self.encoder(
                emb, batch.source_length, True, generator)
            dec = self.decoder.train_forward(
                (lstm_out, sa_out), (batch.source_length,) * 2,
                batch.target.float(), generator)
        return self._output(dec, enc_aligns)


def compute_loss(hp: HParams, out: TacotronOutput, batch: Batch,
                 model: Optional[nn.Module] = None) -> dict:
    """The codes model's losses: code_loss = 0.1 * codes_loss, done_loss,
    l2_regularization_loss (with ``use_l2_regularization`` and a model, over
    the flax paths outside ``DEFAULT_L2_BLACKLIST``), and their sum loss."""
    device = out.outputs.device
    batch = batch.to(device)
    losses = {"code_loss": 0.1 * L.codes_loss(
        out.outputs, batch.target.float(), batch.spec_loss_mask.float(),
        hp.code_loss_type)}
    losses["done_loss"] = L.binary_loss(out.stop_token, batch.done.float(),
                                        batch.binary_loss_mask.float())
    reg = torch.zeros((), device=device)
    if hp.use_l2_regularization and model is not None:
        reg = L.l2_regularization_loss(flax_param_paths(model),
                                       hp.l2_regularization_weight,
                                       L.DEFAULT_L2_BLACKLIST)
    losses["l2_regularization_loss"] = reg
    losses["loss"] = losses["code_loss"] + losses["done_loss"] + reg
    return losses


def tacotron_model_factory(hp: HParams) -> TacotronModel:
    return TacotronModel(hp)
