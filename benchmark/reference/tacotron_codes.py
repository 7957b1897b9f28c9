"""The codes model's inference forward in plain PyTorch: the benchmark's
yardstick for ``correct``.

A frozen, freestanding copy of the arithmetic of NII's self-attention
Tacotron for VQ codes (arXiv:1810.11960,
``DualSourceSelfAttentionTacotronModel`` with ``SelfAttentionCBHGEncoder``
and ``DualSourceTransformerDecoder``, decoder v2):

* encoder: phone embedding -> prenet (two ReLU denses, no dropout at
  inference) -> CBHG trunk (conv bank of widths 1..K with batch norm on its
  running statistics and ReLU, a width-2 SAME max pool, two projection
  convs, the residual, highway layers) -> zoneout bi-LSTM (the inference
  mix ``(1 - z) new + z prev``; gates i, g, f, o with the +1 forget bias)
  -> projection -> self-attention hops (``x + tanh(transform(MHA(x)))``);
* decoder, per step: prenet (with a speaker row after its first ReLU where
  the configuration has speakers) -> attention zoneout LSTM over [prenet,
  previous context] -> forward attention (location-sensitive energy and the
  forward recursion, transition factor 0.5) over the bi-LSTM output and
  additive attention over the hop output -> output projection -> two
  residual zoneout LSTMs -> causal self-attention hops over the growing
  cache -> code logits and stop logit.  At inference each step is fed the
  previous step's raw logits.

Each utterance is encoded alone; the utterances checked together decode
as the rows of one batch, each source masked past its length.

It reads only the raw weights (a dict keyed by the state-dict names of the
measured program, which is the interface the benchmark's weight maker
writes) and the configuration's numbers, and imports nothing of the
program.  ``tf32=True`` computes every matrix product on operands rounded
to TF32 (10 mantissa bits, round to nearest even), products summed in
float32: the control that must come out not correct.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

BN_EPSILON = 1e-3
NEG_INF = -1e9


def round_tf32(x: Tensor) -> Tensor:
    """float32 -> the nearest TF32 value (the low 13 mantissa bits cleared,
    ties to even), still stored as float32."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


def masked_softmax(energy: Tensor, valid: Tensor) -> Tensor:
    """Softmax over the valid positions (-1e9 at the others)."""
    return torch.softmax(torch.where(valid, energy,
                                     torch.full_like(energy, NEG_INF)), -1)


class CodesReference:
    """The forward of one configuration on one set of weights."""

    SUPPORTED = dict(tacotron_model="DualSourceSelfAttentionTacotronModel",
                     encoder="SelfAttentionCBHGEncoder",
                     decoder="DualSourceTransformerDecoder",
                     attention="forward", attention2="additive",
                     decoder_version="v2", outputs_per_step=1,
                     n_feed_frame=1, cumulative_weights=False,
                     use_forward_attention_transition_agent=False,
                     apply_dropout_on_inference=False,
                     use_postnet_v2=False, compute_dtype="float32")

    def __init__(self, weights: Dict[str, Tensor], hparams: dict,
                 tf32: bool = False):
        for key, want in self.SUPPORTED.items():
            if hparams[key] != want:
                raise ValueError(f"the reference computes {key}={want!r}, "
                                 f"not {hparams[key]!r}")
        if hparams["use_external_speaker_embedding"]:
            raise ValueError("the reference has no external speaker table")
        self.w = {k: v.float() for k, v in weights.items()}
        self.hp = hparams
        self.tf32 = tf32
        self.speakers = bool(hparams["use_speaker_embedding"])

    # ------------------------------------------------------------ products
    def _op(self, x: Tensor) -> Tensor:
        return round_tf32(x) if self.tf32 else x

    def linear(self, x: Tensor, name: str, bias: bool = True) -> Tensor:
        y = self._op(x) @ self._op(self.w[name + ".weight"]).t()
        return y + self.w[name + ".bias"] if bias else y

    def matmul(self, a: Tensor, b: Tensor) -> Tensor:
        return self._op(a) @ self._op(b)

    def conv_same(self, x: Tensor, weight: Tensor,
                  bias: Optional[Tensor] = None) -> Tensor:
        """([B,] T, Cin) conv (Cout, Cin, K), SAME padding (K - 1) // 2 on
        the left and K // 2 on the right -> ([B,] T, Cout)."""
        K = weight.shape[-1]
        rows = x if x.dim() == 3 else x[None]
        xp = F.pad(self._op(rows).transpose(1, 2), ((K - 1) // 2, K // 2))
        y = F.conv1d(xp, self._op(weight), bias).transpose(1, 2)
        return y if x.dim() == 3 else y[0]

    # ------------------------------------------------------------- encoder
    def conv_bn(self, x: Tensor, name: str, relu: bool) -> Tensor:
        w = self.w
        h = self.conv_same(x, w[name + ".conv.weight"])
        scale = torch.rsqrt(w[name + ".bn.running_var"] + BN_EPSILON) \
            * w[name + ".bn.weight"]
        h = (h - w[name + ".bn.running_mean"]) * scale + w[name + ".bn.bias"]
        return torch.relu(h) if relu else h

    def lstm_step(self, name: str, x: Tensor, c: Tensor, h: Tensor
                  ) -> Tuple[Tensor, Tensor]:
        z_c = self.hp["zoneout_factor_cell"]
        z_o = self.hp["zoneout_factor_output"]
        gates = self.linear(torch.cat([x, h], -1), name)
        i, g, f, o = gates.chunk(4, -1)
        c_new = c * torch.sigmoid(f + 1.0) + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.tanh(c_new) * torch.sigmoid(o)
        return ((1.0 - z_c) * c_new + z_c * c,
                (1.0 - z_o) * h_new + z_o * h)

    def attention(self, x: Tensor, name: str, heads: int,
                  causal: bool) -> Tensor:
        """Multi-head self-attention of (T, D) rows -> (T, D)."""
        T, D = x.shape
        dh = D // heads
        k, v, q = (self.linear(x, f"{name}.{p}_projection")
                   .reshape(T, heads, dh).transpose(0, 1)
                   for p in ("key", "value", "query"))
        scores = self.matmul(q, k.transpose(1, 2)) / (dh ** 0.5)
        if causal:
            keep = torch.ones(T, T, dtype=torch.bool,
                              device=x.device).tril()
            scores = torch.where(keep, scores,
                                 torch.full_like(scores, NEG_INF))
        ctx = self.matmul(torch.softmax(scores, -1), v)
        return self.linear(ctx.transpose(0, 1).reshape(T, D),
                           f"{name}.output_projection")

    def encode(self, source: Tensor) -> Tuple[Tensor, Tensor]:
        """(T,) phone ids -> (bi-LSTM output (T, 2H), hop output (T, SA))."""
        hp, w = self.hp, self.w
        table = w["embedding.weight"]
        x = table[source.long().clamp(0, table.shape[0] - 1)]
        for i in range(len(hp["encoder_prenet_out_units"])):
            x = torch.relu(self.linear(x, f"encoder.prenets.prenet_{i}.dense"))
        trunk = "encoder.cbhg.trunk"
        bank = torch.cat([
            self.conv_bn(x, f"{trunk}.conv_bank.conv1d_K{k}", True)
            for k in range(1, hp["max_filter_width"] + 1)], -1)
        lowest = torch.full_like(bank[:1], torch.finfo(bank.dtype).min)
        pooled = torch.maximum(bank, torch.cat([bank[1:], lowest]))
        h = self.conv_bn(self.conv_bn(pooled, f"{trunk}.proj1", True),
                         f"{trunk}.proj2", False) + x
        if f"{trunk}.adjustment_layer.weight" in w:
            h = self.linear(h, f"{trunk}.adjustment_layer")
        for i in range(hp["num_highway"]):
            hw = f"{trunk}.highway_{i}"
            t = torch.sigmoid(self.linear(h, f"{hw}.T"))
            h = torch.relu(self.linear(h, f"{hw}.H")) * t + h * (1.0 - t)
        T = h.shape[0]
        units = hp["cbhg_out_units"] // 2
        outs = []
        for direction, order in (("fw", range(T)),
                                 ("bw", range(T - 1, -1, -1))):
            c = h.new_zeros(units)
            s = h.new_zeros(units)
            rows = [None] * T
            for t in order:
                c, s = self.lstm_step(f"encoder.cbhg.bilstm.{direction}",
                                      h[t], c, s)
                rows[t] = s
            outs.append(torch.stack(rows))
        lstm_out = torch.cat(outs, -1)
        sa = self.linear(lstm_out, "encoder.self_attention_projection_layer")
        for i in range(hp["self_attention_num_hop"]):
            hop = f"encoder.self_attention_{i}"
            att = self.attention(sa, f"{hop}.self_attention.attention",
                                 hp["self_attention_num_heads"], False)
            sa = sa + torch.tanh(self.linear(att, f"{hop}.transform"))
        return lstm_out, sa

    # ------------------------------------------------------------- decoder
    def speaker_row(self, speaker: Optional[int], device) -> Optional[Tensor]:
        """softsign(speaker projection of the speaker's embedding): the row
        the decoder prenet adds after its first ReLU, or None."""
        if not self.speakers:
            return None
        if (not self.hp["speaker_embedd_to_prenet"]
                or self.hp["speaker_embedd_to_decoder"]
                or self.hp["speaker_embedding_projection_out_dim"] > -1):
            raise ValueError("the reference routes speakers to the prenet "
                             "only")
        table = self.w["speaker_embedding.weight"]
        sid = speaker if self.hp["speaker_for_synthesis"] < 0 \
            else self.hp["speaker_for_synthesis"]
        row = min(max(int(sid) - self.hp["speaker_embedding_offset"], 0),
                  table.shape[0] - 1)
        emb = table[row].to(device)
        return F.softsign(self.linear(
            emb, "decoder.prenets.prenet_0.speaker_projection"))

    def prenet(self, x: Tensor, spk: Optional[Tensor]) -> Tensor:
        for i in range(len(self.hp["decoder_prenet_out_units"])):
            name = f"decoder.prenets.prenet_{i}"
            if i == 0 and spk is not None:
                x = torch.relu(self.linear(x, f"{name}.dense0")) + spk
            x = torch.relu(self.linear(x, f"{name}.dense"))
        return x

    def decode(self, encoded: List[Tuple[Tensor, Tensor]], steps: int,
               speakers: Sequence[Optional[int]],
               feed: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
        """``steps`` decoder steps of each utterance, the utterances as the
        rows of one batch (each source padded to the longest and masked in
        both attentions) -> (code logits (B, steps, C), stop logits
        (B, steps)).  Step t is fed ``feed[:, t - 1]`` when ``feed``
        (B, steps, C) is given (the served frames), else its own previous
        logits; step 0 the zero GO frame."""
        hp, w = self.hp, self.w
        dev = encoded[0][0].device
        B = len(encoded)
        T = max(lo.shape[0] for lo, _ in encoded)
        lstm_out = torch.stack([F.pad(lo, (0, 0, 0, T - lo.shape[0]))
                                for lo, _ in encoded])
        sa_out = torch.stack([F.pad(so, (0, 0, 0, T - so.shape[0]))
                              for _, so in encoded])
        valid = torch.stack([torch.arange(T, device=dev) < lo.shape[0]
                             for lo, _ in encoded])
        dec = "decoder"
        m0, m1 = f"{dec}.attention_mechanism_0", f"{dec}.attention_mechanism_1"
        keys0 = self.matmul(lstm_out, w[f"{m0}.memory_layer.weight"].t())
        keys1 = self.matmul(sa_out, w[f"{m1}.memory_layer.weight"].t())
        A = hp["attention_out_units"]
        D = hp["decoder_out_units"]
        C = hp["num_mels"]
        heads = hp["decoder_self_attention_num_heads"]
        hops = hp["decoder_self_attention_num_hop"]
        dh = hp["decoder_self_attention_out_units"] // heads
        spk = (torch.stack([self.speaker_row(s, dev) for s in speakers])
               if self.speakers else None)
        zero = lstm_out.new_zeros
        att_c, att_h = zero(B, A), zero(B, A)
        l1_c, l1_h, l2_c, l2_h = (zero(B, D) for _ in range(4))
        prev_align, alpha = zero(B, T), zero(B, T)
        alpha[:, 0] = 1.0
        u = 0.5
        context = zero(B, lstm_out.shape[2] + sa_out.shape[2])
        frame = zero(B, C)
        cache_k = [zero(B, heads, steps, dh) for _ in range(hops)]
        cache_v = [zero(B, heads, steps, dh) for _ in range(hops)]
        conv_w = w[f"{m0}.location_convolution.weight"]
        logits, stops = [], []
        for t in range(steps):
            x = self.prenet(frame, spk)
            att_c, att_h = self.lstm_step(f"{dec}.attention_lstm",
                                          torch.cat([x, context], -1), att_c,
                                          att_h)
            # forward attention over the bi-LSTM output
            pq = self.linear(att_h, f"{m0}.query_layer", bias=False)
            loc = self.conv_same(prev_align[..., None], conv_w,
                                 w[f"{m0}.location_convolution.bias"])
            loc = self.linear(loc, f"{m0}.location_layer", bias=False)
            energy = (w[f"{m0}.attention_variable"][0] * torch.tanh(
                keys0 + pq[:, None] + loc + w[f"{m0}.attention_bias"])).sum(-1)
            align = masked_softmax(energy, valid)
            shifted = F.pad(alpha[:, :-1], (1, 0))
            alpha = ((1.0 - u) * alpha + u * shifted + 1e-7) * align
            alpha = alpha / alpha.sum(-1, keepdim=True)
            prev_align = align
            # additive attention over the hop output
            pq1 = self.linear(att_h, f"{m1}.query_layer", bias=False)
            energy1 = (w[f"{m1}.attention_v"][0]
                       * torch.tanh(keys1 + pq1[:, None])).sum(-1)
            align1 = masked_softmax(energy1, valid)
            context = torch.cat([self.matmul(alpha[:, None], lstm_out)[:, 0],
                                 self.matmul(align1[:, None], sa_out)[:, 0]],
                                -1)
            proj = self.linear(torch.cat([att_h, context], -1),
                               f"{dec}.output_projection_wrapper")
            l1_c, l1_h = self.lstm_step(f"{dec}.decoder_lstm1", proj, l1_c,
                                        l1_h)
            o1 = proj + l1_h
            l2_c, l2_h = self.lstm_step(f"{dec}.decoder_lstm2", o1, l2_c,
                                        l2_h)
            y = o1 + l2_h
            for i in range(hops):
                hop = f"{dec}.transformer_{i}"
                att = f"{hop}.self_attention.attention"
                k, v, q = (self.linear(y, f"{att}.{p}_projection")
                           .reshape(B, heads, dh)
                           for p in ("key", "value", "query"))
                cache_k[i][:, :, t] = k
                cache_v[i][:, :, t] = v
                scores = self.matmul(q[:, :, None], cache_k[i][:, :, :t + 1]
                                     .transpose(2, 3))[:, :, 0] / (dh ** 0.5)
                ctx = self.matmul(torch.softmax(scores, -1)[:, :, None],
                                  cache_v[i][:, :, :t + 1])[:, :, 0]
                out = self.linear(ctx.reshape(B, -1),
                                  f"{att}.output_projection")
                y = y + torch.tanh(self.linear(out, f"{hop}.transform"))
            logit = self.linear(y, f"{dec}.out_projection")
            stop = self.linear(y, f"{dec}.stop_token_projection")[:, 0]
            logits.append(logit)
            stops.append(stop)
            frame = logit if feed is None else feed[:, t]
        return torch.stack(logits, 1), torch.stack(stops, 1)

    @torch.no_grad()
    def __call__(self, sources: Sequence[Tensor], steps: int,
                 speakers: Optional[Sequence[Optional[int]]] = None,
                 feed: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
        """Utterances ((T_i,) ids each) -> (logits (B, steps, C), stop
        (B, steps)); each encoded alone, decoded together."""
        speakers = speakers or [None] * len(sources)
        return self.decode([self.encode(s) for s in sources], steps,
                           speakers, feed)


def make(weights: Dict[str, Tensor], hparams: dict,
         tf32: bool = False) -> CodesReference:
    """The reference of this configuration (the harness's entry)."""
    return CodesReference(weights, hparams, tf32)
