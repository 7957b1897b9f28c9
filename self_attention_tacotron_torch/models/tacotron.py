"""Model assembly: embedding -> encoder -> decoder (+ postnet), and the loss.

Counterpart of the JAX package's ``models/tacotron.py`` ``TacotronModel``
for its three kinds:

* the VQ-code kind (``DualSourceSelfAttentionTacotronModel``): with
  ``SelfAttentionCBHGEncoder`` the two encoder outputs (bi-LSTM and
  self-attention) are the decoder's two attention sources; the code output
  is the one-hot argmax of the decoder logits, and a free-running
  VALIDATION decode feeds back softmax probabilities;
* the mel kind (``ExtendedTacotronV1Model``, the LJSpeech recipe): with
  ``ZoneoutEncoderV1`` and ``ExtendedDecoder`` the bi-LSTM output is the
  one source; the decoder emits mel frames, fed back raw, and
  ``use_postnet_v2`` adds ``PostNetV2``'s residual (``postnet_outputs``);
* the MGC/LF0 kind (``DualSourceSelfAttentionMgcLf0TacotronModel``, the
  paper's pitch-accent configuration, ``entry.PITCH_ACCENT``): an MGC/LF0
  decoder (``MgcLf0Decoder``, ``MgcLf0DualSourceDecoder``,
  ``DualSourceMgcLf0TransformerDecoder``) emits mgc frames (``outputs``)
  and lf0 class logits (``outputs2``); the batch's ``target`` is the pair
  (mgc frames, one-hot lf0 classes), as in the JAX package.

Every encoder and decoder of the JAX package's factory is here:
``SelfAttentionCBHGEncoder``, ``ZoneoutEncoderV1``, ``EncoderV2``,
``EncoderV1WithAccentType`` and ``SelfAttentionCBHGEncoderWithAccentType``
(whose self-attention output, like ``SelfAttentionCBHGEncoder``'s, feeds
the dual-source decoders); the decoders of ``_DECODERS``.  With
``use_accent_type`` an ``accent_embedding`` (shifted by
``accent_type_offset``) looks up the batch's ``accent_type`` ids for the
accent encoders.  ``apply_dropout_on_inference`` keeps the decoder's
prenet dropout on in VALIDATION and INFERENCE, drawn from the caller's
``generator``.  ``compute_dtype`` ``bfloat16`` is the JAX package's
model-wide bf16 (``ops/compute_dtype.py``: every module computes in bf16
from its float32 parameters, and the outputs are bf16; batch statistics,
checkpoints, gradients and the optimizer stay float32); any other string
runs float32, as there.

``forward`` is inference (no autograd); ``validation_forward`` the
VALIDATION decode of the trainer's evaluation (no autograd, teacher-forced
or free-running) and, with supplied alignments, the second pass of the
forced-alignment mode (``parallel.make_predict_step``); ``train_forward``
is the TRAIN mode with autograd, its batch-norm statistics scoped to the
rows whose loss mask is not empty (``bn_valid_rows``), its dropout and
zoneout drawn from the caller's ``torch.Generator``.  ``compute_loss`` is
``0.1 * codes_loss + done_loss`` for codes and ``mel_loss (+ postnet_loss)
+ done_loss`` for mels (+ L2).
``hp.use_pallas_attention`` reaches the encoder's and the decoder's
self-attention hops.

Speakers (the VCTK recipe): ``use_speaker_embedding`` (a trained
``Embedding`` shifted by ``speaker_embedding_offset``) or
``use_external_speaker_embedding`` (``ExternalEmbedding``, frozen, read
from ``embedding_file``) looks up each row's ``speaker_id``, or
``speaker_for_synthesis`` for every row when it is > -1; with
``speaker_embedding_projection_out_dim`` > -1 a ReLU dense projects it.  It
then goes to the decoder's speaker prenet (``speaker_embedd_to_prenet``),
is tiled over time onto both attention sources
(``speaker_embedd_to_decoder``) and to the postnet
(``speaker_embedd_to_postnet``), as in the JAX package.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..config import HParams
from ..ops import losses as L
from ..ops.attention_core import (DROP_RATE_HPARAMS, MultiHeadAttention,
                                  PallasTrainingError)
from ..ops.compute_dtype import Linear, compute_dtype, set_compute_dtype
from ..ops.conv import bn_valid_rows
from ..utils.convert import flax_param_paths
from .attention import AttentionOptions
from .decoder import DecoderOutput, TacotronDecoder
from .embedding import Embedding, ExternalEmbedding
from .encoders import (EncoderV1WithAccentType, EncoderV2,
                       SelfAttentionCBHGEncoder,
                       SelfAttentionCBHGEncoderWithAccentType,
                       ZoneoutEncoderV1)
from .postnet import PostNetV2


def _apply(fn, x):
    if isinstance(x, tuple):
        return tuple(_apply(fn, t) for t in x)
    return None if x is None else fn(x)


class Batch(NamedTuple):
    source: torch.Tensor         # (B, T_in) int
    source_length: torch.Tensor  # (B,)
    target: Any = None           # (B, T, C), or (mgc, one-hot lf0) mgclf0
    target_length: Optional[torch.Tensor] = None
    done: Optional[torch.Tensor] = None              # (B, T // r)
    spec_loss_mask: Optional[torch.Tensor] = None    # (B, T)
    binary_loss_mask: Optional[torch.Tensor] = None  # (B, T // r)
    speaker_id: Optional[torch.Tensor] = None        # (B,)
    accent_type: Optional[torch.Tensor] = None       # (B, T_in) int

    def map(self, fn) -> "Batch":
        """``fn`` over every tensor (both of an MGC/LF0 target pair); None
        fields stay None."""
        return Batch(*(_apply(fn, x) for x in self))

    def to(self, device) -> "Batch":
        return self.map(lambda x: torch.as_tensor(x).to(device))


class TacotronOutput(NamedTuple):
    outputs: torch.Tensor                    # (B, T, C) logits or mel frames
    stop_token: torch.Tensor                 # (B, S, 1)
    code_output: Optional[torch.Tensor]      # (B, T, C) one-hot argmax (codes)
    postnet_outputs: Optional[torch.Tensor]  # (B, T, C) (use_postnet_v2)
    alignments: Tuple[torch.Tensor, ...]     # per source (B, T_mem, S)
    encoder_self_attention_alignments: List[torch.Tensor]
    decoder_self_attention_alignments: List[torch.Tensor]
    lengths: torch.Tensor
    predicted_samples: torch.Tensor
    outputs2: Optional[torch.Tensor] = None  # (B, T, num_lf0s) lf0 logits


MODEL_KINDS = ("DualSourceSelfAttentionTacotronModel",
               "ExtendedTacotronV1Model",
               "DualSourceSelfAttentionMgcLf0TacotronModel")
# decoder name -> (number of sources, self-attention hops, output kind)
_DECODERS = {"ExtendedDecoder": (1, False, "single"),
             "TransformerDecoder": (1, True, "single"),
             "DualSourceDecoder": (2, False, "single"),
             "DualSourceTransformerDecoder": (2, True, "single"),
             "MgcLf0Decoder": (1, False, "mgclf0"),
             "MgcLf0DualSourceDecoder": (2, False, "mgclf0"),
             "DualSourceMgcLf0TransformerDecoder": (2, True, "mgclf0")}
_ACCENT_ENCODERS = ("EncoderV1WithAccentType",
                    "SelfAttentionCBHGEncoderWithAccentType")
# the encoders with a self-attention output (a second decoder source)
_DUAL_ENCODERS = ("SelfAttentionCBHGEncoder",
                  "SelfAttentionCBHGEncoderWithAccentType")
ENCODERS = ("SelfAttentionCBHGEncoder", "ZoneoutEncoderV1", "EncoderV2",
            *_ACCENT_ENCODERS)


def attention_options_from_hparams(hp: HParams, dual: bool
                                   ) -> Tuple[AttentionOptions, ...]:
    """One mechanism per source: ``attention`` / ``attention2`` at
    ``attention1_out_units`` / ``attention2_out_units`` for the dual-source
    decoders, ``attention`` at ``attention_out_units`` for one source."""
    def mk(attention: str, units: int) -> AttentionOptions:
        return AttentionOptions(
            attention=attention, num_units=units,
            attention_kernel=hp.attention_kernel,
            attention_filters=hp.attention_filters, smoothing=False,
            cumulative_weights=hp.cumulative_weights,
            use_transition_agent=hp.use_forward_attention_transition_agent)
    if dual:
        return (mk(hp.attention, hp.attention1_out_units),
                mk(hp.attention2, hp.attention2_out_units))
    return (mk(hp.attention, hp.attention_out_units),)


class TacotronModel(nn.Module):
    def __init__(self, hp: HParams):
        super().__init__()
        if hp.tacotron_model not in MODEL_KINDS:
            raise ValueError(f"Unknown Tacotron model: {hp.tacotron_model}")
        if hp.encoder not in ENCODERS:
            raise ValueError(f"Unknown encoder: {hp.encoder}")
        if hp.decoder not in _DECODERS:
            raise ValueError(f"Unknown decoder: {hp.decoder}")
        num_sources, use_transformer, output_kind = _DECODERS[hp.decoder]
        if num_sources == 2 and hp.encoder not in _DUAL_ENCODERS:
            raise ValueError(f"{hp.decoder} attends to the self-attention "
                             f"output, which {hp.encoder} does not have")
        if bool(hp.use_accent_type) != (hp.encoder in _ACCENT_ENCODERS):
            raise ValueError(f"use_accent_type={hp.use_accent_type} with "
                             f"{hp.encoder}: the accent-type encoders take "
                             "accent types and the others do not")
        if hp.use_speaker_embedding and hp.use_external_speaker_embedding:
            raise ValueError("use_speaker_embedding and "
                             "use_external_speaker_embedding exclude each "
                             "other")
        self.hp = hp
        self.is_code_model = (
            hp.tacotron_model == "DualSourceSelfAttentionTacotronModel")
        self.embedding = Embedding(hp.num_symbols, hp.embedding_dim)
        if hp.use_accent_type:
            self.accent_embedding = Embedding(
                hp.num_accent_type, hp.accent_type_embedding_dim,
                index_offset=hp.accent_type_offset)
        speaker_dim = None
        if hp.use_speaker_embedding:
            self.speaker_embedding = Embedding(
                hp.num_speakers, hp.speaker_embedding_dim,
                index_offset=hp.speaker_embedding_offset)
        elif hp.use_external_speaker_embedding:
            self.speaker_embedding = ExternalEmbedding(
                hp.embedding_file, hp.num_speakers,
                hp.speaker_embedding_dim,
                index_offset=hp.speaker_embedding_offset)
        if self.has_speaker:
            speaker_dim = hp.speaker_embedding_dim
            if hp.speaker_embedding_projection_out_dim > -1:
                self.speaker_projection = Linear(
                    speaker_dim, hp.speaker_embedding_projection_out_dim)
                speaker_dim = hp.speaker_embedding_projection_out_dim
        to_decoder = (speaker_dim
                      if self.has_speaker and hp.speaker_embedd_to_decoder
                      else 0)
        common = dict(cbhg_out_units=hp.cbhg_out_units,
                      conv_channels=hp.conv_channels,
                      max_filter_width=hp.max_filter_width,
                      projection1_out_channels=hp.projection1_out_channels,
                      projection2_out_channels=hp.projection2_out_channels,
                      num_highway=hp.num_highway,
                      prenet_out_units=hp.encoder_prenet_out_units,
                      drop_rate=hp.encoder_prenet_drop_rate,
                      zoneout_factor_cell=hp.zoneout_factor_cell,
                      zoneout_factor_output=hp.zoneout_factor_output)
        self_attention = dict(
            self_attention_out_units=hp.self_attention_out_units,
            self_attention_num_heads=hp.self_attention_num_heads,
            self_attention_num_hop=hp.self_attention_num_hop,
            self_attention_drop_rate=hp.self_attention_drop_rate,
            use_pallas=hp.use_pallas_attention)
        accent = dict(
            accent_channels=hp.accent_type_embedding_dim,
            prenet_out_units=hp.encoder_prenet_out_units_if_accent,
            accent_type_prenet_out_units=hp.accent_type_prenet_out_units)
        lstm_dim = hp.cbhg_out_units
        if hp.encoder == "ZoneoutEncoderV1":
            self.encoder = ZoneoutEncoderV1(
                hp.embedding_dim, use_zoneout=hp.use_zoneout_at_encoder,
                **common)
        elif hp.encoder == "SelfAttentionCBHGEncoder":
            self.encoder = SelfAttentionCBHGEncoder(
                hp.embedding_dim, fused_inference=hp.encoder_fused_inference,
                **self_attention, **common)
        elif hp.encoder == "EncoderV1WithAccentType":
            del common["prenet_out_units"]
            self.encoder = EncoderV1WithAccentType(
                hp.embedding_dim, use_zoneout=hp.use_zoneout_at_encoder,
                **accent, **common)
        elif hp.encoder == "SelfAttentionCBHGEncoderWithAccentType":
            del common["prenet_out_units"]
            self.encoder = SelfAttentionCBHGEncoderWithAccentType(
                hp.embedding_dim, **accent, **self_attention, **common)
        else:
            self.encoder = EncoderV2(
                hp.embedding_dim, hp.encoder_v2_num_conv_layers,
                hp.encoder_v2_kernel_size, hp.encoder_v2_out_units,
                hp.encoder_v2_drop_rate, hp.zoneout_factor_cell,
                hp.zoneout_factor_output)
            lstm_dim = hp.encoder_v2_out_units // 2 * 2
        self.decoder = TacotronDecoder(
            attention_options_from_hparams(hp, dual=num_sources == 2),
            source_dims=tuple(d + to_decoder for d in (
                lstm_dim, hp.self_attention_out_units)[:num_sources]),
            use_transformer=use_transformer, output_kind=output_kind,
            num_mgcs=hp.num_mgcs, num_lf0s=hp.num_lf0s,
            apply_dropout_on_inference=hp.apply_dropout_on_inference,
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
            use_pallas=hp.use_pallas_attention,
            feedback_softmax=self.is_code_model,
            speaker_dim=(speaker_dim if self.has_speaker
                         and hp.speaker_embedd_to_prenet else None))
        if hp.use_postnet_v2:
            self.postnet = PostNetV2(
                hp.num_mels, hp.num_postnet_v2_layers,
                hp.postnet_v2_kernel_size, hp.postnet_v2_out_channels,
                hp.postnet_v2_drop_rate,
                speaker_dim=(speaker_dim if self.has_speaker
                             and hp.speaker_embedd_to_postnet else None))
        self.dtype = compute_dtype(hp.compute_dtype)
        set_compute_dtype(self, self.dtype)

    @property
    def is_mgclf0(self) -> bool:
        return self.hp.tacotron_model == \
            "DualSourceSelfAttentionMgcLf0TacotronModel"

    @property
    def has_speaker(self) -> bool:
        return bool(self.hp.use_speaker_embedding
                    or self.hp.use_external_speaker_embedding)

    def _speaker(self, batch: Batch) -> Optional[torch.Tensor]:
        """The (B, E) speaker embedding of each row (``speaker_for_
        synthesis`` for all rows when > -1), projected when configured;
        None without speakers."""
        if not self.has_speaker:
            return None
        sid = batch.speaker_id
        if self.hp.speaker_for_synthesis > -1:
            sid = torch.full_like(batch.source_length,
                                  self.hp.speaker_for_synthesis)
        elif sid is None:
            raise ValueError("this model conditions on speakers: the batch "
                             "needs speaker_id")
        emb = self.speaker_embedding(sid.to(batch.source.device))
        if self.hp.speaker_embedding_projection_out_dim > -1:
            emb = torch.relu(self.speaker_projection(emb))
        return emb

    def _encode(self, batch: Batch, is_training: bool = False,
                generator: Optional[torch.Generator] = None):
        """-> (decoder sources, their lengths, encoder self-attention
        alignments, the speaker embedding or None)."""
        emb = self.embedding(batch.source)
        lengths = batch.source_length
        if self.hp.use_accent_type:
            if batch.accent_type is None:
                raise ValueError("use_accent_type: the batch needs "
                                 "accent_type")
            out = self.encoder(emb, self.accent_embedding(
                batch.accent_type.to(emb.device)), lengths, is_training,
                generator)
        else:
            out = self.encoder(emb, lengths, is_training, generator)
        if isinstance(out, tuple):
            lstm_out, sa_out, enc_aligns = out
        else:
            lstm_out, sa_out, enc_aligns = out, None, []
        speaker = self._speaker(batch)
        n = self.decoder.num_sources
        sources = (lstm_out, sa_out)[:n]
        if speaker is not None and self.hp.speaker_embedd_to_decoder:
            sources = tuple(torch.cat([s, speaker[:, None, :].expand(
                -1, s.shape[1], -1)], -1) for s in sources)
        return sources, (lengths,) * n, enc_aligns, speaker

    def _prenet_speaker(self, speaker):
        return speaker if self.hp.speaker_embedd_to_prenet else None

    def _output(self, dec: DecoderOutput, enc_aligns, is_training=False,
                generator=None, speaker=None) -> TacotronOutput:
        code_output = postnet_outputs = None
        if self.is_code_model:
            code_output = torch.nn.functional.one_hot(
                dec.outputs.detach().argmax(-1), self.hp.num_mels).to(
                    dec.outputs.dtype)
        if self.hp.use_postnet_v2:
            postnet_outputs = dec.outputs + self.postnet(
                dec.outputs, is_training, generator,
                speaker if self.hp.speaker_embedd_to_postnet else None)
        return TacotronOutput(
            outputs=dec.outputs, stop_token=dec.stop_token,
            code_output=code_output, postnet_outputs=postnet_outputs,
            alignments=dec.alignments,
            encoder_self_attention_alignments=[a.transpose(1, 2)
                                               for a in enc_aligns],
            decoder_self_attention_alignments=dec.self_attention_alignments,
            lengths=dec.lengths, predicted_samples=dec.predicted_samples,
            outputs2=dec.outputs2)

    def _targets(self, batch: Batch):
        """The decoder's target: (mgc, lf0) for the MGC/LF0 kind."""
        if self.is_mgclf0:
            return tuple(t.float() for t in batch.target)
        return batch.target.float()

    @torch.no_grad()
    def forward(self, batch: Batch,
                generator: Optional[torch.Generator] = None
                ) -> TacotronOutput:
        """INFERENCE; ``generator`` draws the prenet dropout of
        ``apply_dropout_on_inference``."""
        device = self.embedding.weight.device
        batch = Batch(batch.source.to(device), batch.source_length.to(device),
                      **{k: None if v is None else torch.as_tensor(v).to(
                          device) for k, v in (
                              ("speaker_id", batch.speaker_id),
                              ("accent_type", batch.accent_type))})
        sources, lengths, enc_aligns, speaker = self._encode(batch)
        return self._output(
            self.decoder(sources, lengths, self._prenet_speaker(speaker),
                         generator=generator),
            enc_aligns, speaker=speaker)

    @torch.no_grad()
    def validation_forward(self, batch: Batch, teacher_forcing: bool,
                           teacher_alignments=None,
                           generator: Optional[torch.Generator] = None
                           ) -> TacotronOutput:
        """VALIDATION mode: the deterministic encoder (batch norm on its
        running statistics), then the decode loop over the target's
        T // r steps, fed the targets (``teacher_forcing``) or its own
        outputs (the JAX package's ``_forward`` in
        ``DecoderMode.VALIDATION``); ``teacher_alignments`` (per source
        (B, T_steps, T_mem)) are replayed in place of the attention
        mechanisms (``parallel.make_predict_step``'s second pass);
        ``generator`` as in ``forward``."""
        batch = batch.to(self.embedding.weight.device)
        sources, lengths, enc_aligns, speaker = self._encode(batch)
        return self._output(self.decoder.validation_forward(
            sources, lengths, self._targets(batch), teacher_forcing,
            self._prenet_speaker(speaker), teacher_alignments, generator),
            enc_aligns, speaker=speaker)

    def pallas_training_refusal(self) -> Optional[PallasTrainingError]:
        """The error a TRAIN step with autograd must raise before it starts,
        or None: a self-attention hop in the Pallas mode without dropout
        would send its training call to ``fused_self_attention``, which the
        JAX package cannot differentiate either (``ops/attention_core``)."""
        if not torch.is_grad_enabled():
            return None
        hparams = sorted({
            DROP_RATE_HPARAMS[name.split(".")[0]]
            for name, m in self.named_modules()
            if isinstance(m, MultiHeadAttention) and m.use_pallas
            and m.drop_rate <= 0.0})
        return PallasTrainingError(hparams) if hparams else None

    def train_forward(self, batch: Batch,
                      generator: Optional[torch.Generator] = None
                      ) -> TacotronOutput:
        """TRAIN mode: teacher forcing, dropout, zoneout and batch
        statistics, with autograd.  Rows whose spectrogram loss mask is all
        zero (duplicates padding a batch) stay out of the batch-norm
        statistics."""
        refused = self.pallas_training_refusal()
        if refused is not None:
            raise refused
        device = self.embedding.weight.device
        batch = batch.to(device)
        valid = None
        if batch.spec_loss_mask is not None:
            valid = batch.spec_loss_mask.reshape(
                batch.spec_loss_mask.shape[0], -1).amax(1) > 0
        with bn_valid_rows(valid):
            sources, lengths, enc_aligns, speaker = self._encode(
                batch, True, generator)
            dec = self.decoder.train_forward(
                sources, lengths, self._targets(batch), generator,
                self._prenet_speaker(speaker))
            return self._output(dec, enc_aligns, True, generator, speaker)


def compute_loss(hp: HParams, out: TacotronOutput, batch: Batch,
                 model: Optional[nn.Module] = None) -> dict:
    """The losses: code_loss = 0.1 * codes_loss (the codes model);
    mel_loss = spec_loss and, with ``use_postnet_v2``, postnet_loss (the
    mel model); mgc_loss = spec_loss(``code_loss_type``) and lf0_loss =
    ``lf0_loss_factor`` * the lf0 classification loss (the MGC/LF0 model);
    done_loss; l2_regularization_loss (with ``use_l2_regularization`` and a
    model, over the flax paths outside ``DEFAULT_L2_BLACKLIST``); and their
    sum loss."""
    device = out.outputs.device
    batch = batch.to(device)
    mask = batch.spec_loss_mask.float()
    if hp.tacotron_model == "DualSourceSelfAttentionMgcLf0TacotronModel":
        mgc, lf0 = (t.float() for t in batch.target)
        losses = {"mgc_loss": L.spec_loss(out.outputs, mgc, mask,
                                          hp.code_loss_type),
                  "lf0_loss": hp.lf0_loss_factor * L.classification_loss(
                      out.outputs2, lf0, mask)}
        main = losses["mgc_loss"] + losses["lf0_loss"]
    elif hp.tacotron_model == "DualSourceSelfAttentionTacotronModel":
        target = batch.target.float()
        losses = {"code_loss": 0.1 * L.codes_loss(
            out.outputs, target, mask, hp.code_loss_type)}
        main = losses["code_loss"]
    else:
        target = batch.target.float()
        losses = {"mel_loss": L.spec_loss(out.outputs, target, mask,
                                          hp.spec_loss_type)}
        main = losses["mel_loss"]
        if out.postnet_outputs is not None:
            losses["postnet_loss"] = L.spec_loss(
                out.postnet_outputs, target, mask, hp.spec_loss_type)
            main = main + losses["postnet_loss"]
    losses["done_loss"] = L.binary_loss(out.stop_token, batch.done.float(),
                                        batch.binary_loss_mask.float())
    reg = torch.zeros((), device=device)
    if hp.use_l2_regularization and model is not None:
        reg = L.l2_regularization_loss(flax_param_paths(model),
                                       hp.l2_regularization_weight,
                                       L.DEFAULT_L2_BLACKLIST)
    losses["l2_regularization_loss"] = reg
    losses["loss"] = main + losses["done_loss"] + reg
    return losses


def tacotron_model_factory(hp: HParams) -> TacotronModel:
    return TacotronModel(hp)
