#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (an H100 for sm_90a).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``self_attention_tacotron_torch/ops/csrc``
(into ``build/torch_kernels/``), then, at the full widths of the shipped
VQ-code recipe (``examples/codes/self-attention-tacotron.json``; phases
13-15: the LJSpeech mel recipe ``examples/ljspeech/tacotron.json``; phases
16-19: the VCTK multi-speaker recipe) with weights drawn from a seed:

1. prints the card (``nvidia-smi`` name and power limit) and CUDA version;
2. builds the seven kernels and the grid-barrier probe, one nvcc each, in
   parallel, and prints the cost of one grid barrier at one block per SM:
   cooperative groups' beside the hand-written ``GridBarrier`` (the
   cooperative kernels') and the designs it was chosen over;
3. ``fused_encode``: kernel vs its plain PyTorch version, T = 64 phones,
   L = 64 and L = 50;
4. ``fused_decode``: kernel vs its plain version, 450 steps, early stop
   off; the code-argmax agreement; early stop on (equal lengths); a
   large-|v| case that must stay finite;
5. serving end to end: ``cli.predict.main_code`` serves a 3-utterance
   synthetic corpus from a seeded checkpoint on ``cuda``; the serving
   kernels' launch counters are zeroed just before and must both be > 0
   just after;
6. the training kernels at B = 32, T_in = 64, S = 256, with dropout 0.5
   and zoneout 0.1 on (the shared counter-based masks) and in the
   deterministic mode: ``fused_train_fwd`` vs the plain forward (y, save
   rows, alignments), ``fused_train_bwd`` vs the plain reverse-time VJP
   and vs ``torch.autograd`` of the plain forward (each gradient's max
   error over its largest magnitude);
7. training end to end: ``cli.train.main`` takes 3 steps at B = 32 on
   ``cuda`` over a synthetic 64-utterance corpus in one bucket (S = 250);
   the training kernels' counters are zeroed just before and must read
   exactly 3 launches each just after; the losses are finite and a
   checkpoint is written; ``cli.predict.main_code`` then serves one
   utterance from that checkpoint;
8. times each kernel and its plain version with CUDA events (median of 5
   after a warm-up), prints each stage's share of a profiled launch (for
   the training kernels split into copy, product, epilogue and barrier
   wait, with the attention items' time per block and source; for the
   encoder into load, product and barrier wait), times one
   training step on the fused and on the plain path,
   and prints one JSON line of per-kernel numbers: a row for each kernel
   and each main path that launched it (``path``: serving, training,
   evaluation, pallas_serving, preprocessing, mel_serving), with that
   path's own launch count;
9. the Pallas-mode attention kernels against their plain versions:
   ``fused_self_attention`` at B = 1, H = 2, T = 64, D = 16 (the encoder
   hop) and, causal and not, at B = 32, T = 250, D = 128; at the edges of
   its tiling (T in {1, 15, 16, 17, 61} at D = 16, causal and not), at
   B = 8, T = 64, D = 16 (the batched encoder's hop), at (1, 2, 3000, 128)
   causal (the longest decode) and with |q.k| ~ 1e3 (the running max);
   ``incremental_attention_step`` at B = 1 and 32, S = 250, D = 128,
   t in {0, 100, 249} and at the edges of its 32-position chunks (t = 31,
   32, 33), and at the serving cache (S = 450, t = 449);
10. training with evaluation: ``cli.train`` takes 2 steps on the same corpus
   with a 5-utterance ``validation.csv``, ``use_pallas_attention`` on and a
   checkpoint at step 2, so that one evaluation (two VALIDATION decodes an
   utterance at batch 1) runs; the ``eval @2`` line and ``metrics.jsonl``
   must hold the seven finite metrics, and the counters (zeroed just before)
   must read 2 x (the utterances' decode steps) ``incremental_attention_step``
   launches and 10 ``fused_encode`` launches;
11. Pallas-mode serving: ``cli.predict.main_code`` serves 3 utterances from
   that checkpoint with the fused paths off; the counters must read one
   ``fused_self_attention`` launch an utterance and one
   ``incremental_attention_step`` launch a decode step, and the logits must
   be within 1e-4 of the einsum path's over the steps both ran;
12. times rows 5 and 6 (kernel, plain version, and one
   ``scaled_dot_product_attention`` call of the same function, which the
   port never calls) beside their bounds, row 5 at B = 1, T = 64, D = 16
   and at B = 32, T = 256, D = 128, causal and not, with the split of one
   profiled launch (loads, scores, softmax, values), row 6 also at the
   serving cache (B = 1, S = 450, t = 449) and beside an empty kernel in
   the same queued loop (the launch floor), and one evaluation round with
   and without ``use_pallas_attention``;
13. the ``spectrogram`` kernel (the STFT of ``preprocess --on-device``,
   one launch from the signal) against its plain version at LJSpeech and
   VCTK widths (10 s, 1.3 s, and one frame from a signal shorter than the
   reflect pad): magnitudes relative to each frame's peak, dB within 60 dB
   of each frame's peak (the row's ``max_abs_err`` is that dB error); at
   10 s its time from the signal beside the plain version's, ``torch.stft``
   -> abs -> mel -> dB from the signal (the yardstick, never called by the
   port) and the bound, with the card's name and power limit;
14. ``cli.preprocess.main_ljspeech --on-device`` over a synthetic 64-
   utterance LJSpeech-layout corpus (1.5-6 s at 22.05 kHz, texts with
   numbers and abbreviations): one ``spectrogram`` launch an utterance
   (counter zeroed just before), four targets against the numpy path, and
   seconds per hour of audio for ``--on-device``, the numpy path with one
   worker and with the default pool;
15. the LJSpeech mel recipe (``examples/ljspeech/tacotron.json`` with the
   corpus statistics merged in): ``cli.train`` takes 3 steps at B = 32 on
   phase 14's records with one evaluation of 2 utterances;
   ``cli.predict.main_mel`` serves the 3 test utterances on ``cuda`` on
   the plain path (no ``fused_decode`` launch) and with
   ``decoder_fused_inference=true`` (one launch an utterance, the same
   frames); ``fused_decode`` at that shape (one forward source, no hops,
   r = 2, C = 80, 500 steps) against its plain version, timed.  The
   kernels line gains a ``spectrogram`` row (path ``preprocessing``) and a
   ``fused_decode`` row (path ``mel_serving``);
16. the fused decode's row modes against its plain version: the codes
   recipe at B = 8 (sources of 40-64 phones, 450 steps), early stop off
   and on (a stop head drawn so that the rows fire at different steps);
   location-sensitive sources, cumulative and not, at B = 1 and B = 4;
   at the VCTK recipe's widths (``examples/vctk/self-attention-tacotron
   .json``: 80 mels, r = 2, 500 steps) the encoder and the decode with the
   speaker row at B = 1, and the training kernels at B = 32, T_in = 64
   characters, S = 160 with the speaker rows and masks on;
17. the VCTK recipe end to end on the card: a synthetic 48 kHz corpus in
   VCTK 0.8 layout (4 speakers, 16 utterances of 1.5-4 s each) through
   ``cli.preprocess.main_vctk --on-device`` (one ``spectrogram`` launch an
   utterance), ``cli.speaker_selection crosscheck`` of the split lists,
   ``cli.train`` for 3 steps at B = 32 with one evaluation (3 launches of
   each training kernel, 4 encoder launches), ``cli.predict.main_mel`` on
   the 3 test utterances with the fused paths (one encoder and one decode
   launch an utterance) and on the plain path (the same frames), and one
   text under two speakers (different frames);
18. batched INFERENCE of the codes recipe through the model at B = 1, 4
   and 8 (450 steps, early stop off), fused and plain: ms an utterance and
   frames/s on the host clock, one fused decode launch a call;
19. times of the fused decode in each mode and of the training kernels at
   the VCTK shape, beside their plain versions and bounds.  The kernels
   line gains the paths ``vctk_preprocessing``, ``vctk_training``,
   ``vctk_serving`` and ``batched_inference``, each row with its own
   shapes' times.

20. the bf16 storage mode (``decoder_fused_dtype`` /
   ``decoder_fused_train_dtype = bfloat16``) at the codes recipe's widths:
   ``fused_decode`` against its plain bf16 version (B = 1, 450 steps, early
   stop off and on; the batched mode at the bf16 plan's capacity), the
   training kernels at B = 32, S = 256 (masks on) against theirs, each
   timed beside its f32 twin in turns; ``main_code`` serving 3 utterances
   with ``--hparams decoder_fused_dtype=bfloat16`` (one ``fused_decode``
   launch an utterance, no fallback logged) and ``cli.train`` taking 3
   steps with ``decoder_fused_train_dtype=bfloat16`` (3 launches of each
   training kernel, finite losses, a checkpoint).  The kernels line gains
   the paths ``bf16_serving`` and ``bf16_training``, bounded by the bytes
   with bf16 storage and the BF16 tensor peak;
21. forced-alignment prediction (``--hparams use_forced_alignment_mode=
   true``) through ``cli.predict``: ``main_code`` on 3 synthetic codes
   utterances (the first pass through ``fused_encode`` and
   ``fused_decode``, the second the plain VALIDATION loop replaying the
   first's alignments, its encoder call ``fused_encode`` again: 6 and 3
   launches), then ``main_mel`` on phase 14's test utterances with
   phase 15's checkpoint and ``decoder_fused_inference`` (3
   ``fused_decode`` launches); each ``.mfbsp`` against the same predict
   step on the plain path (1e-5 codes, 1e-4 mel), the passes' steps equal,
   and the same step run with the served settings against the plain one:
   the first pass's outputs and alignments over its decoded steps and the
   forced pass's logits (1e-5 codes, 1e-4 mel).  Paths
   ``forced_alignment`` and ``mel_forced_alignment``;
22. the SIWIS recipe (``examples/codes_siwis/self-attention-tacotron.json``:
   3000 steps, a 4-speaker table) at full width with weights from seed 0,
   B = 1, a 64-phone source, speaker 3, early stop off: one call fused
   (``fused_encode``, ``fused_decode``, path ``siwis_serving``) and one in
   the Pallas mode (one ``fused_self_attention``, 3000
   ``incremental_attention_step`` launches, path ``siwis_pallas_serving``),
   their wall times, any gate refusal logged, their logits and stop logits
   within 1e-4 over all 3000 steps; ``fused_decode`` at that shape (the
   speaker row, 3000 steps, its hop over 94 cache chunks) against its
   plain version over all steps (1e-5), ``incremental_attention_step`` at
   S = 3000 beside SDPA, both timed with their bounds;
23. the kernels past the edges of their earlier plans, each launched
   through its caller (path ``long_and_wide``): the codes recipe's encoder
   at T = 533 (the hop's rows in shared memory) and 534, 600 (streamed);
   the Pallas mode's hop at head widths 128, 129 (the full sequence's wide
   kernel) and 257 (both wide kernels), the full sequence and 64 cache
   steps; ``MelExtractor`` at n_fft 2048 (the FFT) and 1998 (the direct
   DFT), against the plain version evaluated in float64: each against its
   plain path (the step's wide kernel counted apart, ``launches_wide``, row
   ``incremental_attention_step_wide``); then the streamed encoder (bounds
   at T = 533, 534 and 600; one profiled launch's split at T = 533, the
   hop resident, and 534, streamed), both wide kernels and the DFT timed
   beside their plain versions, bounds and library calls (the step's wide
   kernel at S = 450, D = 257 in turns with the narrow kernel at D = 256
   on the same cache, and alone at S = 3000, D = 512 against its plain
   version, 1e-5; the DFT and the ``torch.stft`` chain in turns, and
   the DFT beside its own tensor-core products, 2 F Ns 2K FLOPs over the
   window's Ns folded taps, at the 3xTF32 rate, and the phases of one
   profiled launch, ``dft_timeline``), and the full sequence's wide kernel
   also at B = 8, T = 256, D = 256 against its plain version (1e-5), with
   the split of one profiled launch of each wide shape (bounds at the
   3xTF32 rate);
24. the entry points (``entry_points``): four encoders past #1's earlier
   limits (path ``widened_encoder_*``: widths of 130, the 4-byte copies;
   129 and 256 LSTM units, the 16-block cluster; 5 prenet layers, 9
   highway layers and 5 hops, the layer table) served through the model's
   encoder and held against the plain version (1e-5), each timed beside
   its bound; training with ``use_pallas_attention`` and both hop drop
   rates at 0 refused with the named ``NotImplementedError``; ``main_code``
   with matplotlib's presence patched in (path ``predict_replay``: the
   fused pass and its plain-path replay; the replay's outputs within 1e-5
   of the fused pass's, #1 within 1e-5 of its plain version on the served
   sources, the plotted source alignments' columns summing to 1 within
   1e-5, one "no PNG" line where matplotlib is absent) and the time the
   replay adds; ``cli.train`` for 3 steps with ``alignment_save_steps=2``
   and ``record_profile`` from step 1 (path ``plotted_training``: the
   saver's payload, the Chrome trace, the device-busy share); ``cli.train``
   for 3 steps without the profiler beside the training dataset alone and
   the step function alone on its batches (each step's seconds);
   ``entry()`` on the card; ``bench.measure`` over 3 decodes (path
   ``bench``), its JSON line printed, then on the bench's own model and
   source its decode against the flagship with the fused flags off (1e-5)
   and #1 and #2 against their plain versions, timed beside their bounds;
25. data parallelism (``data_parallel``): the input pipeline (the reader
   that served the run must be the native one; phase 24's ``cli.train``
   seconds a step, its dataset's seconds a batch and the step function's,
   beside one fresh batch of B = 32 through the pure-Python reader and
   checksum and through the native one); ``cli.train --num-processes 2``
   for 3 steps at global B = 32 (16 a rank, the shared bucket schedule on
   the corpus' one bucket), the two ranks sharing the card over gloo: each
   rank's log must show 3 launches of #3 and #4, finite global losses equal
   on both ranks and the native reader, and rank 0 the one checkpoint
   (path ``dp_training``, the ranks' launches added); ``cli.train`` as one
   rank over NCCL (path ``dp_training_nccl``); one deterministic 2-rank
   step held against the one-process step on the same 32 rows (every
   gradient and running statistic within 1e-4 of its tensor's largest
   magnitude, every parameter within 1e-4 of the largest parameter
   magnitude, each rank launching #3 and #4 once);
   ``entry.dryrun_multichip(2)``; #3 and #4 at a rank's shape (B = 16, S =
   250) against their plain versions, timed beside their bounds;
26. the rest of the model surface (``model_surface``): the codes recipe
   with ``TransformerDecoder`` (one forward source, one causal hop): #1 and
   #2 (B = 1, 450 steps) against their plain versions, #3 and #4 at B =
   32, S = 250 (masks on and off; the backward also against autograd),
   ``main_code`` serving 3 utterances (path
   ``transformer_decoder_serving``: one #1 and one #2 launch each, no gate
   refusing) and ``cli.train`` for 3 steps (path
   ``transformer_decoder_training``: 3 launches of #3 and #4), #2, #3 and
   #4 timed beside their plain versions and bounds, the model's serving
   call and a training step on the host clock; then the paper's
   pitch-accent configuration (``entry.PITCH_ACCENT`` over the codes
   recipe: accent-type encoder, MGC/LF0 model and decoder) on a synthetic
   40-utterance corpus with accent ids and MGC/LF0 targets: ``cli.train
   --dataset-kind mgclf0`` for 3 steps at B = 32 with one evaluation (its
   MGC/LF0 prediction record with the lf0 softmax; the training gate's
   reason logged), INFERENCE of 3 utterances from its checkpoint on the
   plain path (the decode gate's reason logged) and in the Pallas mode
   (path ``pitch_accent_pallas_serving``: one ``fused_self_attention``
   launch an utterance and one ``incremental_attention_step`` launch a
   decode step; mgc and lf0 logits within 1e-4 of the plain path's), and
   #5 / #6 at that path's shapes against their plain versions (1e-5).
27. model-wide bf16 (``compute_dtype=bfloat16``, path names
   ``bf16_model_*`` and ``bf16_pallas_serving``) at the codes recipe's
   full width: ``cli.train`` for 3 steps at B = 32 through #3 / #4 (3
   launches each, no gate refusing) with one evaluation of 2 utterances,
   then 10 train steps in bf16 and in float32 from one initialisation on
   the same batches (every loss within 5 %, ms a step); ``main_code``
   serving 3 utterances through #1 / #2 in bf16 and in float32 (ms a
   call), and the code argmax of bf16 against float32 teacher-forced on
   the same checkpoint; Pallas-mode serving of 3 utterances in bf16 (the
   bf16 instances of #5 / #6 launched, one an utterance and one a decode
   step, and no float32 instance), its logits against the bf16 einsum
   path's at phase 20's bf16 tolerances; each bf16 instance against its
   plain version (1e-2 of its largest magnitude; each kernel call moves
   the bf16 counter by one, the step's wide kernel its ``launches_wide``)
   and timed beside SDPA in bf16 and its bound (products at the bf16
   tensor cores' peak; the serving hop, B = 32 T = 256 D = 128 causal and
   not, the serving cache S = 450, the wide kernels at D = 256 and S =
   3000 D = 512), the steps at S = 450 and at S = 3000 D = 512 also in
   turns with their f32 twins on the same values, each full-sequence
   shape with the split of one profiled launch.  The kernels line gains
   ``fused_self_attention_bf16`` and ``incremental_attention_step_bf16``.
28. targetless (predict-time) serving (``targetless_serving``): a
   3-utterance codes corpus read by ``Dataset(sources, None, hp,
   batch_size=1)`` through ``prefetch`` (each utterance a batch of its
   own, no target fields), each batch served by ``make_predict_step``
   through #1 and #2 (one launch each an utterance, counters zeroed just
   before the reading), held against the targeted ``Dataset``'s batches
   of the same utterances (the same source pads; every step) and against
   the plain path with the fused flags off (the decoded steps): equal stop
   steps and code argmax, outputs and alignments within 1e-5; the phase's
   time on its own line.

The last line is ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before it; so does a machine without CUDA, or a directory that
holds this script without the package.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
RECIPE = os.path.join(ROOT, "examples", "codes", "self-attention-tacotron.json")
SEED = 0
T_IN = 64
# Tolerances (max abs error, kernel vs plain version, both float32, TF32
# off).  The encoder sums up to 6144 products per output in another order
# than the plain version's matmuls; the decoder feeds its own logits back
# for 450 steps, so summation-order differences compound along the chain.
# On an H100 the worst errors read 2.6e-8 (encoder) and 1.8e-7 (decode
# alignments) over every run; 1e-5 leaves ~50x room for summation order
# and still fails a kernel whose products drop to TF32 or bf16.
TOL_ENCODE = 1e-5
TOL_DECODE = 1e-5
# Training kernels: y, save rows and alignments within 1e-4 absolute after
# 256 recurrent steps; each gradient within 1e-3 of its largest magnitude
# (its sums over S * B = 8192 rows run in another order than the plain
# version's).
TOL_TRAIN = 1e-4
TOL_TRAIN_GRAD = 1e-3
TRAIN_B, TRAIN_S = 32, 256
# Pallas-mode attention kernels vs their plain versions: float32 both sides,
# one softmax between two products of depth <= 3000 (#5's longest decode);
# 1e-5 still fails a product that drops to TF32.
TOL_ATTENTION = 1e-5
# Pallas-mode serving vs the einsum path, logits over up to 450 fed-back
# steps.
TOL_PALLAS_SERVING = 1e-4
ATTN_HEADS, ATTN_T, ATTN_D = 2, 250, 128
SERVE_S = 450       # the serving decode's cache (the codes recipe's cap)
PALLAS_SERVING = ("use_pallas_attention=true,decoder_fused_inference=false,"
                  "encoder_fused_inference=false")
# peaks of one H100 SXM (NVIDIA data sheet): HBM bandwidth, FP32 non-tensor,
# dense BF16 tensor cores (the bf16 storage mode's bound), and the f32
# products that run on the TF32 tensor cores in the 3xTF32 split (#1, #3,
# #4, #5: 495 TFLOP/s dense TF32 over three products each)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12
PEAK_3XTF32_FLOP_PER_S = 495e12 / 3
# The bf16 storage mode (phase 20), kernel vs its plain bf16 version.  Both
# round the same inputs to bf16, but an f32 sum that lands near a bf16
# rounding boundary rounds one ulp (2^-8 relative) apart now and then and
# the decode feeds it back, so: the decode's logits and stop logits within
# 1e-2 (max abs) over the first 20 steps; over all 450 steps finite, the
# same code argmax at >= 95 % of the frames and, with early stop, equal
# lengths; the training forward (y, save rows, alignment columns) within
# 1e-2 and each gradient within 1e-2 of its largest magnitude.
BF16 = "bfloat16"
BF16_HEAD_STEPS = 20
TOL_BF16_DECODE_HEAD = 1e-2
BF16_MIN_AGREE = 0.95
TOL_BF16_TRAIN = 1e-2
TOL_BF16_TRAIN_GRAD = 1e-2


# the card's name and power limit as nvidia-smi prints them, set by main():
# every line log() prints with a time in it names them
CARD = ""
_A_TIME = re.compile(r"\d (ms|us|µs|s)\b")


def log(msg: str) -> None:
    if CARD and "card" not in msg and _A_TIME.search(msg):
        msg = f"{msg}; card {CARD}"
    print(msg, flush=True)


def _max_err(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def _rel_err(a, b) -> float:
    return _max_err(a, b) / max(float(b.abs().max()), 1e-12)


def recipe_hparams():
    from self_attention_tacotron_torch.config import default_hparams
    return default_hparams().parse_json_file(RECIPE)


def make_model(hp, device):
    from self_attention_tacotron_torch.models import tacotron_model_factory
    from self_attention_tacotron_torch.utils.convert import init_parameters
    model = tacotron_model_factory(hp)
    init_parameters(model, SEED)
    return model.to(device).eval()


def source_ids(hp, length: int, T: int, seed: int, device):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    src = np.zeros((1, T), np.int64)
    src[0, :length] = rng.integers(1, hp.num_symbols, length)
    return torch.from_numpy(src).to(device)


def encoder_inputs(model, source):
    """(params, x, kwargs) of the fused encoder for ``source`` (1, T)."""
    enc = model.encoder
    kw = dict(max_filter_width=enc.max_filter_width,
              conv_channels=enc.conv_channels, half=enc.cbhg_out_units // 2,
              sa_units=enc.self_attention_out_units,
              num_heads=enc.self_attention_num_heads,
              zoneout_cell=enc.zoneout_factor_cell,
              zoneout_output=enc.zoneout_factor_output)
    return enc.fused_params(), model.embedding(source), kw


def encoder_case(model, length: int, T: int, device):
    """(params, x, kwargs) of the fused encoder for a random source."""
    return encoder_inputs(model, source_ids(model.hp, length, T,
                                            SEED + length, device))


def decoder_inputs(model, source, length: int):
    """(weights, memory, options) of the fused decode from the encoder's
    outputs (plain version) on ``source`` (1, T), ``length`` of it valid."""
    import torch
    from self_attention_tacotron_torch.ops import fused_encoder as fe
    params, x, kw = encoder_inputs(model, source)
    lstm_out, sa = fe.fused_encode_reference(params, x, length, **kw)
    lengths = torch.tensor([length], device=source.device)
    dec = model.decoder
    packs = tuple(m.precompute(s, lengths) for m, s in
                  zip(dec.attention_mechanisms, (lstm_out, sa)))
    return dec.fused_inputs(packs)


def decoder_case(model, length: int, T: int, device):
    """(weights, memory, options) of the fused decode from the encoder's
    outputs (plain version) on a random source."""
    return decoder_inputs(model, source_ids(model.hp, length, T,
                                            SEED + length, device), length)


def phase_encode(model, device, phase: int = 3):
    """Kernel vs plain version; returns the worst max abs error."""
    import torch
    from self_attention_tacotron_torch.ops import fused_encoder as fe
    worst = 0.0
    for L in (T_IN, 50):
        params, x, kw = encoder_case(model, L, T_IN, device)
        got = [t.clone() for t in fe.fused_encode(params, x, L, **kw)]
        # the same inputs again: the first projection's atomics add its
        # chunks' partial sums in the order the blocks arrive
        again = fe.fused_encode(params, x, L, **kw)
        ref = fe.fused_encode_reference(params, x, L, **kw)
        if device.type == "cuda":
            torch.cuda.synchronize()
        errs = [(_max_err(g, r), _rel_err(g, r)) for g, r in zip(got, ref)]
        repeat = [_max_err(g, a) for g, a in zip(got, again)]
        zero_tail = bool((got[0][0, L:] == 0).all())
        log(f"phase {phase} fused_encode T={T_IN} L={L}: lstm_out abs "
            f"{errs[0][0]:.3e} rel {errs[0][1]:.3e}; sa_out abs "
            f"{errs[1][0]:.3e} rel {errs[1][1]:.3e}; zero past L: {zero_tail}"
            f"; call to call lstm_out {repeat[0]:.3e} sa_out {repeat[1]:.3e}")
        if max(e[0] for e in errs) > TOL_ENCODE or not zero_tail:
            raise AssertionError(f"fused_encode disagrees (tol {TOL_ENCODE})")
        worst = max(worst, *(e[0] for e in errs))
    return worst


def _decode_pair(weights, memory, options, steps):
    import torch
    from self_attention_tacotron_torch.ops import fused_decode as fd
    got = fd.fused_decode(weights, memory, num_steps=steps, **options)
    ref = fd.fused_decode_reference(weights, memory, num_steps=steps,
                                    **options)
    if memory.keys[0].is_cuda:
        torch.cuda.synchronize()
    return got, ref


def _post_hoc_length(stop, min_iters) -> int:
    import torch
    from self_attention_tacotron_torch.models.decoder import stop_lengths
    S = stop.shape[1]
    fired = (stop > 0) & (torch.arange(S, device=stop.device) > min_iters)
    return int(stop_lengths(torch.cumsum(fired.int(), 1) > 0)[0])


def phase_decode(model, device, steps: int, phase: int = 4):
    """Kernel vs plain version; returns the worst max abs error."""
    weights, memory, options = decoder_case(model, 50, T_IN, device)
    options = dict(options, early_stop=False)
    got, ref = _decode_pair(weights, memory, options, steps)
    errs = {"out": _max_err(got[0], ref[0]), "stop": _max_err(got[1], ref[1]),
            "aligns": max(_max_err(g, r) for g, r in zip(got[2], ref[2]))}
    agree = float((got[0].argmax(-1) == ref[0].argmax(-1)).float().mean())
    log(f"phase {phase} fused_decode {steps} steps, early stop off: max abs "
        "err "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"; code argmax agreement {agree:.4f}")
    if max(errs.values()) > TOL_DECODE or agree < 1.0:
        raise AssertionError(f"fused_decode disagrees (tol {TOL_DECODE})")

    # early stop on: a stop bias that fires right after min_iters
    head_b = weights.head_b.clone()
    head_b[weights.cr] += 5.0
    got_s, ref_s = _decode_pair(weights._replace(head_b=head_b), memory,
                                dict(options, early_stop=True), steps)
    n_got = _post_hoc_length(got_s[1], options["min_iters"])
    n_ref = _post_hoc_length(ref_s[1], options["min_iters"])
    err_s = _max_err(got_s[0], ref_s[0])
    tail_zero = bool((got_s[0][:, n_got:] == 0).all())
    log(f"phase {phase} fused_decode early stop on: lengths kernel {n_got} "
        "plain "
        f"{n_ref}; out max abs err {err_s:.3e}; zero after exit {tail_zero}")
    if n_got != n_ref or err_s > TOL_DECODE or not tail_zero:
        raise AssertionError("early-stop decode disagrees")

    # |v| scaled so that sum|v| is far above the row max of the energies
    scale = 1e3
    got_v, ref_v = _decode_pair(weights._replace(v=weights.v * scale),
                                memory, options, steps)
    finite = all(bool(t.isfinite().all()) for t in (got_v[0], got_v[1],
                                                    *got_v[2]))
    log(f"phase {phase} fused_decode |v| x{scale:g}: finite {finite}; out "
        "max abs "
        f"err vs plain {_max_err(got_v[0], ref_v[0]):.3e}")
    if not finite:
        raise AssertionError("large-|v| decode is not finite")
    return max(errs["out"], errs["stop"], errs["aligns"], err_s)


def write_corpus(hp, root: str, n: int = 3):
    """A synthetic codes corpus: phone-id sources and one-hot targets."""
    import numpy as np
    from self_attention_tacotron_torch.data.records import (
        CodeTargetRecord, SourceRecord, write_code_target_record,
        write_source_record)
    rng = np.random.default_rng(SEED)
    keys = []
    for i in range(n):
        key = f"utt{i:03d}"
        L = int(rng.integers(40, T_IN + 1))
        phone = rng.integers(1, hp.num_symbols, L).astype(np.int64)
        write_source_record(SourceRecord(
            id=i, key=key, source=phone, source_length=L, text=f"utt {i}",
            phone=phone, phone_length=L, phone_txt=" ".join(map(str, phone))),
            os.path.join(root, f"{key}.{hp.source_file_extension}"),
            with_phone=True)
        n_codes = int(rng.integers(50, 120))
        codes = np.eye(hp.num_mels, dtype=np.float32)[
            rng.integers(0, hp.num_mels, n_codes)]
        write_code_target_record(CodeTargetRecord(
            id=i, key=key, lang="", codes=codes, codes_length=n_codes,
            codes_width=hp.num_mels),
            os.path.join(root, f"{key}.{hp.target_file_extension}"))
        keys.append(key)
    with open(os.path.join(root, "test.csv"), "w") as f:
        f.write("\n".join(keys) + "\n")
    return keys


def phase_end_to_end(model, device_name: str, hparams: str = "",
                     phase: int = 5):
    """main_code on a synthetic corpus (``hparams`` over the recipe);
    returns the launch counts."""
    import numpy as np
    from self_attention_tacotron_torch.cli.predict import main_code
    from self_attention_tacotron_torch.data.records import (
        parse_prediction_record, read_first_example)
    from self_attention_tacotron_torch.ops import fused_decode as fd
    from self_attention_tacotron_torch.ops import fused_encoder as fe
    from self_attention_tacotron_torch.utils.convert import save_checkpoint
    hp = model.hp
    with tempfile.TemporaryDirectory() as tmp:
        data, ckpt, out = (os.path.join(tmp, d) for d in ("data", "ckpt",
                                                          "out"))
        os.makedirs(data)
        keys = write_corpus(hp, data)
        save_checkpoint(model, ckpt, step=1)
        fe.fused_encode.launches = 0
        fd.fused_decode.launches = 0
        rc = main_code(["--source-data-root", data, "--target-data-root", data,
                        "--checkpoint-dir", ckpt, "--output-dir", out,
                        "--hparam-json-file", RECIPE, "--hparams", hparams,
                        "--device", device_name])
        counts = {"fused_encode": fe.fused_encode.launches,
                  "fused_decode": fd.fused_decode.launches}
        if rc != 0:
            raise AssertionError(f"main_code returned {rc}")
        for key in keys:
            rec = parse_prediction_record(
                read_first_example(os.path.join(out, f"{key}.tfrecord")))
            dump = np.fromfile(os.path.join(
                out, f"{key}.{hp.predicted_mel_extension}"), "<f4")
            if (rec.codes.shape[1] != hp.num_mels or rec.codes.shape[0] < 1
                    or dump.size != rec.codes.size
                    or not np.array_equal(rec.codes.sum(1),
                                          np.ones(rec.codes.shape[0]))):
                raise AssertionError(f"bad prediction files for {key}")
    log(f"phase {phase} serving end to end: main_code served {len(keys)} "
        f"utterances on {device_name} (--hparams '{hparams}'); launch "
        f"counts {counts}")
    if device_name == "cuda" and min(counts.values()) < 1:
        raise AssertionError("a kernel of the main path never launched")
    return counts


def _time_ms(fn, reps: int = 5) -> float:
    """Median over ``reps`` of one call, CUDA events, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def encode_bound(params, x, kw):
    """(bytes, FLOPs) the encoder function needs at this input (L = T):
    every weight read once and applied to every row, x read, the outputs
    written.  The conv bank counts width k's k taps (E * C * k weights),
    not the zero blocks of the kernel's stacked (K*E, K*C) bank."""
    T = x.shape[1]
    H, SA, K = kw["half"], kw["sa_units"], kw["max_filter_width"]
    w_bank, b_bank = params.w_bank
    bank_taps = (w_bank.shape[0] // K) * kw["conv_channels"] * K * (K + 1) // 2
    weights = T * bank_taps      # weight floats times the rows they meet
    tensors = [x, b_bank]
    mats = [*params.prenet, params.w_proj1, params.w_proj2, *params.highway,
            params.sa_proj]
    if params.w_adjust is not None:
        mats.append(params.w_adjust)
    mats += [(w, b) for w_kvq, b_kvq, w_ot, b_ot in params.hops
             for w, b in ((w_kvq, b_kvq), (w_ot, b_ot))]
    for w, b in mats:
        tensors += [w, b]
        weights += T * w.numel()
    wx, wh_t, b_lstm = params.lstm
    tensors += [wx, wh_t, b_lstm]
    weights += T * (wx.numel() + wh_t.numel())
    flops = 2 * weights + len(params.hops) * 4 * T * T * SA
    out_bytes = 4 * T * (2 * H + SA)
    return _nbytes(tensors) + 4 * bank_taps + out_bytes, flops


def decode_bound(params, w, memory, steps: int, speaker_row=None,
                 wbytes: int = 4):
    """(bytes, FLOPs) of ``steps`` decode steps of B rows: each product
    counted in the cheaper of its two exact forms, the decoder's own
    (``params``) or the kernel's merged one (``w``), with every weight of
    that form read once and used once a step and row, the memory and the
    speaker row read once and the outputs written (source alignments at
    B = 1 only).  The merges win for the next prenet input (y @ (W_fb @ W0)
    rather than frame @ W0) and Wo @ Wt; the module's form wins for
    outproj + lstm1 (the merged one carries Wop @ W1x and a zero block)
    and for the location conv and dense.  The speaker row adds one add a
    step and element.  ``wbytes``: bytes of a matrix weight, key and value
    (2 in the bf16 storage mode)."""
    B = memory.keys[0].shape[0]
    t_sizes = [k.shape[1] for k in memory.keys]
    D = w.l2_b.shape[0] // 4
    P0 = w.p0_init.shape[0]
    c_total = sum(v.shape[2] for v in memory.values)
    W0 = params.prenet[0][0]
    # weights applied once a step (one multiply-add per weight)
    dense = min(W0.numel(), D * P0)                   # next prenet input
    dense += sum(m.numel() for m, _ in params.prenet[1:])
    dense += params.att_lstm[0].numel()
    dense += sum(wq.numel() for wq, _ in params.query)
    dense += min(params.outproj[0].numel() + params.lstm1[0].numel(),
                 w.big_w.numel() - D * D)
    dense += params.lstm2[0].numel() + params.head[0].numel()
    for wk, _, wv, _, wq, _, wo, _, wt, _ in params.hops:
        dense += wk.numel() + wv.numel() + wq.numel()
        dense += min(wo.numel() + wt.numel(), D * D)
    # location weights, applied at each of a source's T_i memory steps
    locs = [min(l[0].numel() + l[2].numel(), w.loc_kernel * u)
            if l is not None else 0 for l, u in zip(params.loc, w.u_sizes)]
    per_step = dense + sum(
        T * (lw + u + v.shape[2]) for T, lw, u, v in
        zip(t_sizes, locs, w.u_sizes, memory.values))
    flops = B * (2 * steps * per_step
                 + len(w.hops) * 4 * D * steps * (steps + 1) // 2)
    vecs = [w.p0_init, w.att_b, w.v, w.key_fold, w.big_b, w.l2_b, w.head_b,
            *(b for _, b in w.prenet),
            *(t for hop in w.hops for t in (hop[1], hop[3]))]
    mem = [*memory.keys, *memory.values, *memory.masks]
    kv = sum(t.numel() for t in (*memory.keys, *memory.values))
    if speaker_row is not None:
        mem.append(speaker_row)
        flops += steps * speaker_row.numel()
    out_bytes = 4 * steps * (B * (w.cr + 1) + (sum(t_sizes) if B == 1
                                               else 0))
    return (wbytes * dense + 4 * sum(locs) + _nbytes(vecs + mem)
            - (4 - wbytes) * kv + out_bytes), flops


def _stage_shares(name, launch, stages, ms: float, per: int, unit: str,
                  phase: int = 8):
    """One profiled launch: each stage's share of block 0's SM cycles, and
    that share of the kernel's measured time ``ms`` per ``unit``."""
    import torch
    launch()
    torch.cuda.synchronize()
    cycles = launch.stage_cycles.cpu().tolist()
    total = max(sum(cycles), 1)
    parts = ", ".join(
        f"{stage} {100.0 * c / total:.1f}% ({ms * 1e3 * c / total / per:.3f}"
        f" us/{unit})" for stage, c in zip(stages, cycles) if c)
    log(f"phase {phase} {name} stages (block 0 cycles between grid "
        "barriers, as a"
        f" share of {ms:.4f} ms): {parts}")


def _kernel_rows(name, src, line, launches, err, ms, plain, bound,
                 library_ms=None, peak_flops=PEAK_FP32_FLOP_PER_S):
    """One row of the kernels line for each main path that launched the
    kernel: ``launches`` maps a path to the counts of its own run (zeroed
    just before it); the counts of two paths are never added.  The bound's
    operations run at ``peak_flops`` (FP32, the 3xTF32 split's rate or the
    BF16 tensor peak)."""
    nbytes, flops = bound
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return [{"name": name, "path": path, "route": "cuda",
             "source": f"self_attention_tacotron_torch/ops/csrc/{src}.cu",
             "replaces": f"self_attention_tacotron_tpu/ops/{line}",
             "launches": counts[name], "max_abs_err": err, "ms": ms,
             "plain_ms": plain, "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": library_ms}
            for path, counts in launches.items() if counts.get(name, 0) > 0]


def phase_timing(model, device, steps: int, launches, errs):
    import torch
    from self_attention_tacotron_torch.ops import fused_decode as fd
    from self_attention_tacotron_torch.ops import fused_encoder as fe
    params, x, kw = encoder_case(model, T_IN, T_IN, device)
    enc_launch = fe.prepare_encode(params, x, T_IN, **kw)
    enc_ms = _time_ms(enc_launch)
    enc_plain = _time_ms(lambda: fe.fused_encode_reference(params, x, T_IN,
                                                           **kw))
    weights, memory, options = decoder_case(model, T_IN, T_IN, device)
    options = dict(options, early_stop=False)
    dec_launch = fd.prepare_decode(weights, memory, num_steps=steps,
                                   **options)
    dec_ms = _time_ms(dec_launch)
    dec_plain = _time_ms(lambda: fd.fused_decode_reference(
        weights, memory, num_steps=steps, **options), reps=3)
    frames = steps * model.hp.outputs_per_step
    log(f"phase 8 timing: fused_encode {enc_ms:.4f} ms (plain "
        f"{enc_plain:.4f} ms); fused_decode {steps} steps {dec_ms:.4f} ms "
        f"(plain {dec_plain:.4f} ms); {frames / ((enc_ms + dec_ms) / 1e3):.1f}"
        f" frames/s kernel, {frames / ((enc_plain + dec_plain) / 1e3):.1f} "
        "frames/s plain")
    prof = fe.prepare_encode(params, x, T_IN, **kw, profile=True)
    prof()
    torch.cuda.synchronize()
    log("phase 8 fused_encode stages (us a call, block 0's clock split "
        "into load, product and barrier wait, scaled to "
        f"{enc_ms:.4f} ms): " + fe.format_split(
            fe.profile_split(prof.stage_cycles.cpu().tolist(), enc_ms)))
    _stage_shares("fused_decode", fd.prepare_decode(
        weights, memory, num_steps=steps, **options, profile=True),
        fd.DEC_STAGES, dec_ms, steps, "step")
    bounds = {"fused_encode": encode_bound(params, x, kw),
              "fused_decode": decode_bound(model.decoder.fused_params(),
                                           weights, memory, steps)}
    timing = {"fused_encode": (enc_ms, enc_plain, bounds["fused_encode"]),
              "fused_decode": (dec_ms, dec_plain, bounds["fused_decode"])}
    log("phase 8 bound inputs: " + "; ".join(
        f"{k} {b[0]} bytes, {b[1]} FLOPs" for k, b in bounds.items()))
    return [*_kernel_rows("fused_encode", "fused_encoder",
                          "fused_encoder.py:94", launches,
                          errs["fused_encode"], enc_ms, enc_plain,
                          bounds["fused_encode"],
                          peak_flops=PEAK_3XTF32_FLOP_PER_S),
            *_kernel_rows("fused_decode", "fused_decode",
                          "fused_decode.py:250", launches,
                          errs["fused_decode"], dec_ms, dec_plain,
                          bounds["fused_decode"])], timing


# ------------------------------------------------------------- training

def _tmap(fn, tree):
    """``fn`` over the tensors of nested tuples and NamedTuples, in order
    (None stays None)."""
    if isinstance(tree, tuple):
        out = [_tmap(fn, t) for t in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return None if tree is None else fn(tree)


def _detach(tree):
    return _tmap(lambda t: t.detach().contiguous(), tree)


def _leaves(tree):
    out = []
    _tmap(out.append, tree)
    return out


def train_case(model, device, deterministic: bool, seed: int,
               steps: int = TRAIN_S, compute_dtype: str = "float32",
               batch: int = TRAIN_B):
    """The training trunk's inputs at the recipe widths: ``batch`` random
    sources (lengths 40..64) through the encoder, their attention keys
    (with the folded biases) and values, ``steps`` teacher rows (one-hot
    codes, or mel frames for a mel-target recipe), and with speakers the
    speaker rows of ids cycling over ``VCTK_SPEAKERS``; ``compute_dtype``
    the kernels' storage mode (``ops`` rounded to bf16 in that mode)."""
    import numpy as np
    import torch
    from self_attention_tacotron_torch.data.dataset import target_kind_of
    from self_attention_tacotron_torch.models import Batch
    from self_attention_tacotron_torch.ops import fused_train as ft
    hp, dec = model.hp, model.decoder
    rng = np.random.default_rng(SEED + seed)
    lengths = rng.integers(40, T_IN + 1, batch)
    lengths[0] = T_IN
    src = np.zeros((batch, T_IN), np.int64)
    for b, L in enumerate(lengths):
        src[b, :L] = rng.integers(1, hp.num_symbols, L)
    src_t = torch.from_numpy(src).to(device)
    len_t = torch.from_numpy(lengths).to(device)
    sid = torch.tensor([VCTK_SPEAKERS[b % len(VCTK_SPEAKERS)]
                        for b in range(batch)], device=device)
    sources, lens, _, speaker = model._encode(Batch(src_t, len_t,
                                                    speaker_id=sid))
    packs = tuple(m.precompute(s, ln) for m, s, ln in
                  zip(dec.attention_mechanisms, sources, lens))
    spk = dec.speaker_row(model._prenet_speaker(speaker))
    spk = None if spk is None else spk.detach().contiguous()
    frames = steps * hp.outputs_per_step
    if target_kind_of(hp) == "codes":
        codes = torch.from_numpy(rng.integers(0, hp.num_mels,
                                               (batch, frames)))
        target = torch.nn.functional.one_hot(codes, hp.num_mels).float()
    else:
        target = torch.from_numpy(rng.standard_normal(
            (batch, frames, hp.num_mels)).astype(np.float32))
    teacher = dec._teacher_inputs(target.to(device), steps)
    kinds, cum, loc_ws, folds = dec._fused_attention_params()
    params = _detach(dec.fused_train_params())
    keys = _detach(tuple(p.keys if f is None else p.keys + f
                         for p, f in zip(packs, folds)))
    values = _detach(tuple(p.values for p in packs))
    masks = tuple(p.mask.float() for p in packs)
    loc_ws = _detach(tuple(loc_ws))
    zc, zo = dec._dec_zoneout()
    spec = ft.make_spec(params, keys, values, teacher,
                        drop_rate=dec.prenets.drop_rate,
                        zc_att=dec.zoneout_factor_cell,
                        zo_att=dec.zoneout_factor_output, zc_dec=zc,
                        zo_dec=zo, deterministic=deterministic,
                        p_dropout=dec.prenets.dense_layers()[1],
                        use_spk=spk is not None, src_kinds=kinds,
                        cumulative=cum, loc_kernel=dec._loc_kernel(),
                        compute_dtype=compute_dtype)
    tf = teacher.transpose(0, 1).reshape(steps * batch,
                                         spec.cf).contiguous()
    ops = ft.train_operands(spec, params, keys, values, masks, tf, spk,
                            loc_ws)
    return spec, params, keys, values, masks, tf, loc_ws, ops, spk


def _grad_leaves(spec, d_params, d_keys, d_values, d_loc, d_spk=None):
    """Gradients in the plain VJP's layout -> named flat tensors in the
    kernel's layout (``ops/fused_train.py`` ``split_grads``)."""
    import torch
    out = {}
    for i, (w, b) in enumerate(d_params.prenet):
        out[f"prenet{i}.w"], out[f"prenet{i}.b"] = w, b.reshape(-1)
    for name in ("att_lstm", "outproj", "lstm1", "lstm2"):
        w, b = getattr(d_params, name)
        out[f"{name}.w"], out[f"{name}.b"] = w, b.reshape(-1)
    out["query.w"] = torch.cat([q for q, _ in d_params.query], 1)
    out["query.v"] = torch.cat([v.reshape(-1) for _, v in d_params.query])
    for i, (k, v) in enumerate(zip(d_keys, d_values)):
        out[f"keys{i}"] = k.reshape(-1, k.shape[-1])
        out[f"values{i}"] = v.reshape(-1, v.shape[-1])
    out["loc"] = torch.cat([
        torch.zeros(spec.loc_kernel, u, device=out["query.v"].device)
        if lw is None else lw for lw, u in zip(d_loc, spec.u_sizes)], 1)
    if d_spk is not None:
        out["spk"] = d_spk
    return out


def _kernel_grads(spec, raw):
    from self_attention_tacotron_torch.ops import fused_train as ft
    (d_pre, d_att, d_q, d_op, d_l1, d_l2, d_keys, d_values, d_v, d_loc,
     d_spk) = ft.split_grads(spec, raw)
    out = {}
    for i, (w, b) in enumerate(d_pre):
        out[f"prenet{i}.w"], out[f"prenet{i}.b"] = w, b
    for name, (w, b) in (("att_lstm", d_att), ("outproj", d_op),
                         ("lstm1", d_l1), ("lstm2", d_l2)):
        out[f"{name}.w"], out[f"{name}.b"] = w, b
    out["query.w"], out["query.v"], out["loc"] = d_q, d_v, d_loc
    for i, (k, v) in enumerate(zip(d_keys, d_values)):
        out[f"keys{i}"], out[f"values{i}"] = k, v
    if spec.use_spk:
        out["spk"] = d_spk
    return out


def phase_train_kernels(model, device, phase: int = 6,
                        steps: int = TRAIN_S):
    """Both training kernels vs their plain versions, masks on and off, at
    B = 32 and ``steps`` decoder steps; returns the worst max abs errors
    {"fused_train_fwd": ..., "fused_train_bwd": ...}.  The backward's
    tolerance is relative to each gradient's largest magnitude."""
    import torch
    from self_attention_tacotron_torch.ops import fused_train as ft
    worst = {"fused_train_fwd": 0.0, "fused_train_bwd": 0.0}
    for deterministic in (False, True):
        spec, params, keys, values, masks, tf, loc_ws, ops, _ = train_case(
            model, device, deterministic, 1, steps)
        seed = 1234
        y, save, aux = ft.fused_train_fwd(spec, ops, seed)
        y_r, save_r, aux_r = ft.fused_train_fwd_reference(
            spec, params, keys, values, masks, tf, seed, None, loc_ws)
        torch.cuda.synchronize()
        errs = {"y": _max_err(y, y_r), "save": _max_err(save, save_r),
                "aligns": _max_err(aux[:, :, 1], aux_r[:, :, 1]),
                "aux": _max_err(aux, aux_r)}
        mode = "deterministic" if deterministic else "masks on"
        log(f"phase {phase} fused_train_fwd B={spec.batch} "
            f"S={spec.num_steps} "
            f"T={spec.t_mem} ({mode}): max abs err " + ", ".join(
                f"{k} {v:.3e}" for k, v in errs.items()))
        if max(errs.values()) > TOL_TRAIN:
            raise AssertionError(f"fused_train_fwd disagrees (tol "
                                 f"{TOL_TRAIN})")
        worst["fused_train_fwd"] = max(worst["fused_train_fwd"],
                                       *errs.values())

        g = torch.randn(y.shape, generator=torch.Generator(device)
                        .manual_seed(7), device=device)
        kern = _kernel_grads(spec, ft.fused_train_bwd(spec, ops, seed, g,
                                                      save, aux))
        d_params, d_keys, d_values, _, d_loc = ft.fused_train_bwd_reference(
            spec, params, keys, values, masks, tf, seed, None, loc_ws, g,
            save_r, aux_r)
        plain = _grad_leaves(spec, d_params, d_keys, d_values, d_loc)
        tree = (params, keys, values, loc_ws)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in _leaves(tree)]
            it = iter(leaves)
            p2, k2, v2, l2 = _tmap(lambda _: next(it), tree)
            y_a, _, _ = ft.fused_train_fwd_reference(
                spec, p2, k2, v2, masks, tf, seed, None, l2)
            grads = torch.autograd.grad((y_a * g).sum(), leaves)
        it = iter(grads)
        auto = _grad_leaves(spec, *_tmap(lambda _: next(it), tree))
        torch.cuda.synchronize()
        for ref_name, ref in (("plain VJP", plain), ("autograd", auto)):
            rel = {k: _rel_err(kern[k], ref[k].reshape(kern[k].shape))
                   for k in ref}
            absolute = max(_max_err(kern[k], ref[k].reshape(kern[k].shape))
                           for k in ref)
            name, err = max(rel.items(), key=lambda kv: kv[1])
            log(f"phase {phase} fused_train_bwd ({mode}) vs {ref_name}: "
                "worst "
                f"gradient {name} {err:.3e} of its max magnitude, max abs "
                f"err {absolute:.3e}; " +
                ", ".join(f"{k} {v:.1e}" for k, v in sorted(rel.items())))
            if err > TOL_TRAIN_GRAD:
                raise AssertionError(f"fused_train_bwd disagrees with the "
                                     f"{ref_name} (tol {TOL_TRAIN_GRAD})")
            worst["fused_train_bwd"] = max(worst["fused_train_bwd"],
                                           absolute)
    return worst


def write_train_corpus(hp, root: str, n: int = 64):
    """A synthetic codes corpus whose targets (200..249 codes) all fall in
    one bucket (pad 250 at the recipe's bucketing), sources 40..64."""
    import numpy as np
    from self_attention_tacotron_torch.data.records import (
        CodeTargetRecord, SourceRecord, write_code_target_record,
        write_source_record)
    rng = np.random.default_rng(SEED + 1)
    keys = []
    for i in range(n):
        key = f"train{i:03d}"
        L = int(rng.integers(40, T_IN + 1))
        phone = rng.integers(1, hp.num_symbols, L).astype(np.int64)
        write_source_record(SourceRecord(
            id=i, key=key, source=phone, source_length=L, text=f"train {i}",
            phone=phone, phone_length=L, phone_txt=" ".join(map(str, phone))),
            os.path.join(root, f"{key}.{hp.source_file_extension}"),
            with_phone=True)
        n_codes = int(rng.integers(200, 250))
        codes = np.eye(hp.num_mels, dtype=np.float32)[
            rng.integers(0, hp.num_mels, n_codes)]
        write_code_target_record(CodeTargetRecord(
            id=i, key=key, lang="", codes=codes, codes_length=n_codes,
            codes_width=hp.num_mels),
            os.path.join(root, f"{key}.{hp.target_file_extension}"))
        keys.append(key)
    for name in ("train.csv", "test.csv"):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(keys) + "\n")
    return keys


def phase_train_end_to_end(hp, data: str, tmp: str, device_name: str,
                           hparams: str = "", phase: int = 7):
    """cli.train.main for 3 steps (``hparams`` over the recipe), then
    cli.predict from its checkpoint; returns the training kernels' launch
    counts."""
    import math
    import re
    import torch
    from self_attention_tacotron_torch.cli.predict import main_code
    from self_attention_tacotron_torch.cli.train import main as train_main
    from self_attention_tacotron_torch.ops import fused_train as ft
    tag = f"_{phase}" if phase != 7 else ""
    ckpt = os.path.join(tmp, "train_ckpt" + tag)
    out = os.path.join(tmp, "pred" + tag)
    ft.fused_train_fwd.launches = 0
    ft.fused_train_bwd.launches = 0
    t0 = time.perf_counter()
    with torch.enable_grad():
        rc = train_main(["--source-data-root", data, "--target-data-root",
                         data, "--checkpoint-dir", ckpt,
                         "--hparam-json-file", RECIPE, "--max-steps", "3",
                         "--hparams", hparams, "--device", device_name])
    wall = time.perf_counter() - t0
    counts = {"fused_train_fwd": ft.fused_train_fwd.launches,
              "fused_train_bwd": ft.fused_train_bwd.launches}
    if rc != 0:
        raise AssertionError(f"cli.train returned {rc}")
    with open(os.path.join(ckpt, os.path.basename(hp.logfile))) as f:
        losses = [float(m.group(2)) for m in re.finditer(
            r"step (\d+) loss ([-+0-9.eEinfa]+)", f.read())]
    files = sorted(os.listdir(ckpt))
    log(f"phase {phase} training end to end: cli.train took 3 steps at B="
        f"{hp.batch_size} on {device_name} (--hparams '{hparams}') in "
        f"{wall:.1f} s (build and start included); losses {losses}; launch "
        f"counts {counts}; files {files}")
    if len(losses) != 3 or not all(math.isfinite(x) for x in losses):
        raise AssertionError("training losses are missing or not finite")
    if device_name == "cuda" and counts != {"fused_train_fwd": 3,
                                            "fused_train_bwd": 3}:
        raise AssertionError("a training step did not make exactly one "
                             "forward and one backward launch")
    if "model-3.pt" not in files or "train-3.pt" not in files:
        raise AssertionError("no checkpoint of step 3 was written")
    rc = main_code(["--source-data-root", data, "--target-data-root", data,
                    "--checkpoint-dir", ckpt, "--output-dir", out,
                    "--hparam-json-file", RECIPE, "--device", device_name,
                    "--hparams", hparams, "--limit", "1"])
    served = [f for f in os.listdir(out) if f.endswith(".tfrecord")]
    log(f"phase {phase} cli.predict served {len(served)} utterance from the "
        "step-3 checkpoint")
    if rc != 0 or len(served) != 1:
        raise AssertionError("serving from the training checkpoint failed")
    return counts


def train_bound(spec, tensors_in, tensors_out, backward: bool, half=()):
    """(bytes, FLOPs) of the trunk function: each input read once and each
    output written once; one multiply-add per weight and row for every
    product, the attention's energies (the location taps, the v dot) and
    contexts per memory step.  The backward's function is the reverse
    chain (every trunk product but the prenet rows of W_att), the
    attention VJP (twice the energies' and contexts' work), the weight
    gradients (one multiply-add per weight and row) and the prenet
    backward (its weights, and the input cotangent of W_att's prenet rows
    and of layers > 0).  The tensors in ``half`` count 2 bytes an element
    (what the bf16 storage mode stores as bf16)."""
    B, S, T, K = spec.batch, spec.num_steps, spec.t_mem, spec.loc_kernel
    A, D, P = spec.a_units, spec.d_units, spec.p_sizes
    sumU, sumC = sum(spec.u_sizes), sum(spec.c_sizes)
    M = S * B
    p_in = [spec.cf, *P[:-1]]
    w_pre = sum(i * o for i, o in zip(p_in, P))
    w_att_pre = P[-1] * 4 * A
    w_trunk = ((P[-1] + sumC + A) * 4 * A + A * sumU + (A + sumC) * D
               + 2 * (2 * D * 4 * D))
    attn = S * B * T * (sum(u * (1 + (K if kind else 0)) for u, kind in
                            zip(spec.u_sizes, spec.src_kinds)) + sumC)
    if not backward:
        fma = M * (w_pre + w_trunk) + attn
    else:
        fma = (M * (w_trunk - w_att_pre) + 2 * attn + M * (w_trunk + w_pre)
               + M * (w_att_pre + sum(i * o for i, o in zip(p_in[1:],
                                                             P[1:]))))
    return (_nbytes(tensors_in) + _nbytes(tensors_out)
            - 2 * sum(t.numel() for t in half)), 2 * fma


def phase_train_timing(model, device, data: str, launches, errs):
    """Kernel and plain-version times of both training kernels (masks on),
    and one make_train_step at B = 32 on the fused and the plain path."""
    import torch
    from self_attention_tacotron_torch.data.dataset import (
        dataset_factory, find_dataset_files, load_key_list, to_model_batch)
    from self_attention_tacotron_torch.models import tacotron_model_factory
    from self_attention_tacotron_torch.ops import fused_train as ft
    from self_attention_tacotron_torch.parallel import (create_train_state,
                                                        make_train_step)
    from self_attention_tacotron_torch.utils.convert import init_parameters
    spec, params, keys, values, masks, tf, loc_ws, ops, _ = train_case(
        model, device, False, 1)
    seed = 1234
    fwd = ft.prepare_train_fwd(spec, ops, seed)
    fwd_ms = _time_ms(fwd)
    y, save, aux = fwd()
    g = torch.randn(y.shape, generator=torch.Generator(device).manual_seed(7),
                    device=device)
    bwd = ft.prepare_train_bwd(spec, ops, seed, g, save, aux)
    bwd_ms = _time_ms(bwd)
    fwd_plain = _time_ms(lambda: ft.fused_train_fwd_reference(
        spec, params, keys, values, masks, tf, seed, None, loc_ws))
    bwd_plain = _time_ms(lambda: ft.fused_train_bwd_reference(
        spec, params, keys, values, masks, tf, seed, None, loc_ws, g, save,
        aux))
    log(f"phase 8 timing: fused_train_fwd B={spec.batch} S={spec.num_steps}"
        f" {fwd_ms:.4f} ms (plain {fwd_plain:.4f} ms); fused_train_bwd "
        f"{bwd_ms:.4f} ms (plain {bwd_plain:.4f} ms)")
    for name, launch, stages, ms in (
            ("fused_train_fwd", ft.prepare_train_fwd(spec, ops, seed,
                                                     profile=True),
             ft.FWD_STAGES, fwd_ms),
            ("fused_train_bwd", ft.prepare_train_bwd(spec, ops, seed, g, save,
                                                     aux, profile=True),
             ft.BWD_STAGES, bwd_ms)):
        launch()
        torch.cuda.synchronize()
        log(f"phase 8 {name} stages (us a step, block 0's clock split into "
            "copy, product, epilogue and barrier wait): " + ft.format_split(
                *ft.profile_split(launch.stage_cycles.cpu().tolist(), stages,
                                  len(spec.src_kinds), ms, spec.num_steps)))
    flat_in = ft._flat(ops)
    bounds = {
        "fused_train_fwd": train_bound(spec, flat_in, [y, save, aux], False),
        "fused_train_bwd": train_bound(spec, flat_in + [g, save, aux],
                                       _leaves(bwd.outputs), True)}
    log("phase 8 bound inputs: " + "; ".join(
        f"{k} {b[0]} bytes, {b[1]} FLOPs" for k, b in bounds.items()))

    # one training step at B = 32 on the corpus' first batch
    hp = model.hp
    keys_list = load_key_list(os.path.join(data, "train.csv"))
    nb = next(iter(dataset_factory(
        find_dataset_files(data, keys_list, hp.source_file_extension),
        find_dataset_files(data, keys_list, hp.target_file_extension), hp,
        shuffle=False, drop_remainder=True)))
    batch = to_model_batch(nb).to(device)
    frames = int(nb.target.shape[0] * nb.target.shape[1])
    step_ms = {}
    for fused in (True, False):
        hp_s = recipe_hparams()
        hp_s.set_hparam("decoder_fused_train", fused)
        m = init_parameters(tacotron_model_factory(hp_s), SEED).to(device)
        state = create_train_state(m, hp_s)
        step = make_train_step(hp_s)
        with torch.enable_grad():
            step_ms[fused] = _time_ms(lambda: step(state, batch),
                                      reps=5 if fused else 1)
        del m, state
    log(f"phase 8 train step B={nb.target.shape[0]} S={nb.target.shape[1]}"
        f": fused path {step_ms[True]:.3f} ms "
        f"({frames / step_ms[True] * 1e3:.1f} frames/s), plain path "
        f"{step_ms[False]:.3f} ms ({frames / step_ms[False] * 1e3:.1f} "
        "frames/s)")
    return [row for name, line, ms, plain in (
                ("fused_train_fwd", 375, fwd_ms, fwd_plain),
                ("fused_train_bwd", 667, bwd_ms, bwd_plain))
            for row in _kernel_rows(name, name, f"fused_train.py:{line}",
                                    launches, errs[name], ms, plain,
                                    bounds[name],
                                    peak_flops=PEAK_3XTF32_FLOP_PER_S)]


# ------------------------------------------------- Pallas attention mode

EVAL_HPARAMS = ("use_pallas_attention=true,eval_start_delay_secs=0,"
                "eval_throttle_secs=0,save_checkpoints_steps=2")
EVAL_METRICS = {"code_loss", "done_loss", "loss", "loss_with_teacher",
                "code_loss_with_teacher", "done_loss_with_teacher",
                "l2_regularization_loss"}


def _normal(device, *shape, seed: int):
    import numpy as np
    import torch
    return torch.from_numpy(np.random.default_rng(SEED + seed).standard_normal(
        shape).astype(np.float32)).to(device)


def _attention_inputs(device, B, T, D):
    return tuple(_normal(device, B, ATTN_HEADS, T, D, seed=s)
                 for s in range(3))


def _step_inputs(device, B, t, S=ATTN_T, D=ATTN_D):
    kc, vc = (_normal(device, B, ATTN_HEADS, S, D, seed=s)
              for s in (1, 2))
    return _normal(device, B, ATTN_HEADS, D, seed=3 + t), kc, vc


def _large_scores(device, B, T, D):
    """q, k of small integers with a shared column of 32, so |q.k| ~ 1e3
    (exact in float32 and in the 3xTF32 split: both sides get the same
    scores), and v normal: the running max moves by hundreds between key
    tiles, and exp without it overflows."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 9)
    q, k = (rng.integers(-16, 17, (B, ATTN_HEADS, T, D)).astype(np.float32)
            for _ in range(2))
    q[..., 0] = k[..., 0] = 32.0
    v = rng.standard_normal((B, ATTN_HEADS, T, D)).astype(np.float32)
    return tuple(torch.from_numpy(x).to(device) for x in (q, k, v))


def phase_attention_kernels(device):
    """Rows 5 and 6 vs their plain versions; returns the worst max abs
    errors."""
    import torch
    from self_attention_tacotron_torch.ops import pallas_attention as pa
    worst = {"fused_self_attention": 0.0, "incremental_attention_step": 0.0}
    cases = [(1, T_IN, 16, False, False),
             (TRAIN_B, ATTN_T, ATTN_D, False, False),
             (TRAIN_B, ATTN_T, ATTN_D, True, False),
             *[(1, T, 16, causal, False) for T in (1, 15, 16, 17, 61)
               for causal in (False, True)],
             (8, T_IN, 16, False, False),
             (1, 3000, ATTN_D, True, False),
             (1, 200, 16, False, True), (TRAIN_B, ATTN_T, 16, True, True)]
    for B, T, D, causal, large in cases:
        q, k, v = (_large_scores(device, B, T, D) if large else
                   _attention_inputs(device, B, T, D))
        got = pa.fused_self_attention(q, k, v, causal)
        ref = pa.fused_self_attention_reference(q, k, v, causal)
        torch.cuda.synchronize()
        err = _max_err(got, ref) if got.isfinite().all() else float("inf")
        plan = pa.attention_plan(B, ATTN_HEADS, T, D, causal)
        log(f"phase 9 fused_self_attention B={B} H={ATTN_HEADS} T={T} D={D}"
            f" causal={causal}{' |q.k| ~ 1e3' if large else ''} "
            f"({plan.rows}-row blocks of {plan.warps} warps, grid "
            f"{plan.grid}): max abs err {err:.3e}")
        if err > TOL_ATTENTION:
            raise AssertionError(f"fused_self_attention disagrees (tol "
                                 f"{TOL_ATTENTION})")
        worst["fused_self_attention"] = max(worst["fused_self_attention"],
                                            err)
    P = pa.STEP_CHUNK
    for B in (1, TRAIN_B):
        for S, t in [(ATTN_T, t) for t in (0, P - 1, P, P + 1, 100,
                                          ATTN_T - 1)] + [(SERVE_S,
                                                           SERVE_S - 1)]:
            q, kc, vc = _step_inputs(device, B, t, S)
            got = pa.incremental_attention_step(q, kc, vc, t)
            ref = pa.incremental_attention_step_reference(q, kc, vc, t)
            torch.cuda.synchronize()
            err = _max_err(got, ref)
            log(f"phase 9 incremental_attention_step B={B} H={ATTN_HEADS} "
                f"S={S} D={ATTN_D} t={t} ({t // P + 1} chunks): max abs "
                f"err {err:.3e}")
            if err > TOL_ATTENTION:
                raise AssertionError(f"incremental_attention_step disagrees"
                                     f" (tol {TOL_ATTENTION})")
            worst["incremental_attention_step"] = max(
                worst["incremental_attention_step"], err)
    return worst


def _val_files(hp, data, keys):
    from self_attention_tacotron_torch.data.dataset import find_dataset_files
    return (find_dataset_files(data, keys, hp.source_file_extension),
            find_dataset_files(data, keys, hp.target_file_extension))


def validation_batches(hp, data, keys):
    """The evaluation's batches: the first ``num_evaluation_steps``
    validation utterances at batch 1, as cli.train reads them."""
    from self_attention_tacotron_torch.data.dataset import (dataset_factory,
                                                            to_model_batch)
    batches = []
    for nb in dataset_factory(*_val_files(hp, data, keys), hp, batch_size=1,
                              shuffle=False):
        if len(batches) == hp.num_evaluation_steps:
            break
        batches.append(to_model_batch(nb))
    return batches


def phase_train_with_eval(data: str, tmp: str, device_name: str):
    """cli.train, 2 steps in the Pallas mode with a checkpoint at step 2 and
    a 5-utterance validation.csv, so that one evaluation runs; returns the
    checkpoint directory, the validation keys and the launch counts."""
    import ast
    import math
    import re
    import torch
    from self_attention_tacotron_torch.cli.train import main as train_main
    from self_attention_tacotron_torch.data.dataset import load_key_list
    from self_attention_tacotron_torch.ops import fused_encoder as fe
    from self_attention_tacotron_torch.ops import pallas_attention as pa
    hp = recipe_hparams()
    hp.parse(EVAL_HPARAMS)
    keys = load_key_list(os.path.join(data, "train.csv"))[:5]
    with open(os.path.join(data, "validation.csv"), "w") as f:
        f.write("\n".join(keys) + "\n")
    steps = [int(b.target.shape[1]) // hp.outputs_per_step
             for b in validation_batches(hp, data, keys)]
    ckpt = os.path.join(tmp, "eval_ckpt")
    fe.fused_encode.launches = 0
    pa.fused_self_attention.launches = 0
    pa.incremental_attention_step.launches = 0
    t0 = time.perf_counter()
    with torch.enable_grad():
        rc = train_main(["--source-data-root", data, "--target-data-root",
                         data, "--checkpoint-dir", ckpt,
                         "--hparam-json-file", RECIPE, "--max-steps", "2",
                         "--hparams", EVAL_HPARAMS, "--device", device_name])
    wall = time.perf_counter() - t0
    counts = {"fused_encode": fe.fused_encode.launches,
              "fused_self_attention": pa.fused_self_attention.launches,
              "incremental_attention_step":
                  pa.incremental_attention_step.launches}
    if rc != 0:
        raise AssertionError(f"cli.train returned {rc}")
    with open(os.path.join(ckpt, os.path.basename(hp.logfile))) as f:
        found = re.findall(r"eval @2: (\{.*\}) \(", f.read())
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        evals = [e for e in map(json.loads, f)
                 if any(k.startswith("eval/") for k in e)]
    log(f"phase 10 training with evaluation: cli.train took 2 steps and one "
        f"evaluation of {len(steps)} utterances ({sum(steps)} decode steps a"
        f" pass) on {device_name} in {wall:.1f} s; eval @2 {found}; launch "
        f"counts {counts}")
    metrics = ast.literal_eval(found[0]) if len(found) == 1 else {}
    if (set(metrics) != EVAL_METRICS
            or not all(math.isfinite(v) for v in metrics.values())):
        raise AssertionError("the eval line lacks the seven finite metrics")
    if (len(evals) != 1 or {k for k in evals[0] if k.startswith("eval/")}
            != {"eval/" + k for k in EVAL_METRICS}):
        raise AssertionError("metrics.jsonl lacks the eval/ metrics")
    hops = hp.decoder_self_attention_num_hop
    want = {"fused_encode": 2 * len(steps), "fused_self_attention": 0,
            "incremental_attention_step": 2 * hops * sum(steps)}
    if device_name == "cuda" and counts != want:
        raise AssertionError(f"evaluation launches {counts}, expected {want}")
    return ckpt, keys, counts


def _pallas_models(ckpt, device, extra=""):
    """The checkpoint in the Pallas serving mode and with the einsum
    attention (fused paths off in both, ``extra`` hparams on both)."""
    from self_attention_tacotron_torch.models import tacotron_model_factory
    from self_attention_tacotron_torch.utils.convert import load_checkpoint
    models = {}
    for pallas in (True, False):
        hp = recipe_hparams()
        hp.parse(_join(PALLAS_SERVING, extra))
        hp.set_hparam("use_pallas_attention", pallas)
        models[pallas] = tacotron_model_factory(hp).eval()
        load_checkpoint(models[pallas], ckpt)
        models[pallas].to(device)
    return models


def _pallas_pairs(ckpt, data, keys, device, extra=""):
    """Each of ``keys`` served free-running by both of ``_pallas_models``:
    (Pallas logits, einsum logits) over the steps both ran."""
    import torch
    from self_attention_tacotron_torch.data.dataset import iter_utterances
    from self_attention_tacotron_torch.models import Batch
    models = _pallas_models(ckpt, device, extra)
    hp = models[True].hp
    pairs = []
    for u in iter_utterances(*_val_files(hp, data, keys), hp):
        batch = Batch(source=torch.from_numpy(u.source[None]).to(device),
                      source_length=torch.tensor([u.source_length],
                                                 device=device))
        got, ref = models[True](batch), models[False](batch)
        ran = min(int(got.lengths[0]), int(ref.lengths[0]))
        pairs.append((got.outputs[:, :ran], ref.outputs[:, :ran]))
    return pairs


def _serve(data, ckpt, out, device, hparams, counters, n: int = 3):
    """``main_code`` serves the last ``n`` training utterances under the
    recipe with ``hparams``; each (function, attribute) launch counter of
    ``counters`` is zeroed just before.  Returns (keys, counts by name (an
    attribute ``launches_bf16`` counts as ``<function>_bf16``,
    ``launches_wide`` as ``<function>_wide``), decode steps, ms a call,
    the gates that refused)."""
    import contextlib
    import io
    import re
    from self_attention_tacotron_torch.cli.predict import main_code
    from self_attention_tacotron_torch.data.dataset import load_key_list
    keys = load_key_list(os.path.join(data, "train.csv"))[-n:]
    with open(os.path.join(data, "serve.csv"), "w") as f:
        f.write("\n".join(keys) + "\n")
    for fn, attr in counters:
        setattr(fn, attr, 0)
    buf = io.StringIO()
    with _Fallbacks() as fb, contextlib.redirect_stdout(buf):
        rc = main_code(["--source-data-root", data, "--target-data-root",
                        data, "--checkpoint-dir", ckpt, "--output-dir", out,
                        "--list-filename", "serve.csv", "--hparam-json-file",
                        RECIPE, "--hparams", hparams, "--device",
                        device.type])
    counts = {fn.__name__ + attr[len("launches"):]: getattr(fn, attr)
              for fn, attr in counters}
    sys.stdout.write(buf.getvalue())
    found = re.findall(r"predicted \S+: (\d+) decode steps, ([0-9.]+) ms",
                       buf.getvalue())
    if rc != 0 or len(found) != n:
        raise AssertionError(f"main_code --hparams '{hparams}' failed")
    return (keys, counts, [int(s) for s, _ in found],
            [float(m) for _, m in found], fb.refused)


def phase_pallas_serving(ckpt, data, tmp, device, n: int = 3):
    """main_code serves ``n`` utterances in the Pallas mode; the launch
    counts, then the logits against the einsum path's."""
    from self_attention_tacotron_torch.ops import pallas_attention as pa
    keys, counts, steps, _, _ = _serve(
        data, ckpt, os.path.join(tmp, "pallas_pred"), device, PALLAS_SERVING,
        ((pa.fused_self_attention, "launches"),
         (pa.incremental_attention_step, "launches")), n)
    worst = max(_max_err(got, ref)
                for got, ref in _pallas_pairs(ckpt, data, keys, device))
    hp = recipe_hparams()
    log(f"phase 11 Pallas-mode serving: main_code served {len(steps)} "
        f"utterances ({steps} decode steps); launch counts {counts}; logits "
        f"vs the einsum path max abs err {worst:.3e}")
    want = {"fused_self_attention": n * hp.self_attention_num_hop,
            "incremental_attention_step":
                sum(steps) * hp.decoder_self_attention_num_hop}
    if device.type == "cuda" and counts != want:
        raise AssertionError(f"Pallas-mode serving launched {counts}, "
                             f"expected {want}")
    if worst > TOL_PALLAS_SERVING:
        raise AssertionError(f"Pallas-mode logits disagree (tol "
                             f"{TOL_PALLAS_SERVING})")
    return counts


def _device_ms(fn, reps: int = 50) -> float:
    """Device time of one call of a small kernel: ``reps`` calls queued
    behind a sleep kernel, so that the host's enqueue never leaves the
    device idle, with CUDA events around them; the median of 5 runs after a
    warm-up, divided by ``reps``."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def in_turns(fns, rounds: int, timer=None):
    """{name: [times]}: each of ``fns`` timed ``rounds`` times by ``timer``
    (by default ``_device_ms`` of 20 queued calls), in turns (A B .. B A
    ...): versions compared in one loop."""
    timer = timer or (lambda fn: _device_ms(fn, reps=20))
    order = list(fns)
    times = {name: [] for name in order}
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            times[name].append(timer(fns[name]))
    return times


def dft_timeline(stamps) -> str:
    """One profiled launch of #7's direct DFT
    (``stft.prepare_spectrograms(profile=True)``): each phase's median and
    largest time over the blocks, the frame tiles' tails and the last
    block's end after the first block's start, in microseconds."""
    import numpy as np
    from self_attention_tacotron_torch.ops import stft
    raw = stamps.cpu().numpy()
    last = raw[:, -1] == 1
    p = raw.astype(np.float64) / 1e3
    out = []
    for i, name in enumerate(stft.DFT_PHASES[:-1], start=1):
        d = p[:, i] - p[:, i - 1]
        out.append(f"{name} {np.median(d):.2f} / {d.max():.2f}")
    tail = p[last, -2] - p[last, -3]
    end = np.where(last, p[:, -2], p[:, -3]).max() - p[:, 0].min()
    return (f"{len(p)} blocks, median / largest us: " + ", ".join(out)
            + f", tail {np.median(tail):.2f} / {tail.max():.2f}; the last "
            f"block ends {end:.2f} us after the first starts")


def attention_bound(B, T, D, causal):
    """(bytes, FLOPs) of softmax(QK^T/sqrt(D))V: q, k, v read and the
    output written once; the two products over the (causal) key pairs."""
    pairs = T * (T + 1) // 2 if causal else T * T
    return 4 * 4 * B * ATTN_HEADS * T * D, 4 * B * ATTN_HEADS * pairs * D


def step_bound(B, t, D=ATTN_D):
    """(bytes, FLOPs) of one cache step: q, the t + 1 K and V rows it needs
    and the output; the two products over those rows."""
    rows = B * ATTN_HEADS * (t + 1) * D
    return 4 * (2 * rows + 2 * B * ATTN_HEADS * D), 4 * rows


def _bound_ms(bound, peak_flops=PEAK_FP32_FLOP_PER_S):
    return max(bound[0] / PEAK_BYTES_PER_S, bound[1] / peak_flops) * 1e3


def attention_split(pa, q, k, v, causal, ms: float) -> str:
    """One profiled ``fused_self_attention`` launch: the SM cycles of the
    last row block of head 0 (its warp 0; the most key tiles) by stage,
    beside the call's time ``ms``, with the launch's plan."""
    import torch
    launch = pa.prepare_attention(q, k, v, causal, profile=True)
    launch()
    torch.cuda.synchronize()
    cycles = launch.stage_cycles.cpu().tolist()
    total = max(sum(cycles), 1)
    B, H, T, D = q.shape
    plan = pa.attention_plan(B, H, T, D, causal, q.element_size())
    return (f"plan: {plan.rows}-row blocks of {plan.warps} warps, grid "
            f"{plan.grid}, {plan.keys}-key "
            f"tiles x {plan.stages} stages, {plan.smem_bytes} B shared; "
            f"its longest block {total} cycles "
            f"(the call {ms * 1e3:.2f} us): " + ", ".join(
                f"{s} {c / total:.1%}" for s, c in zip(pa.ATTN_STAGES,
                                                      cycles)))


def phase_attention_timing(device, launches, errs, ckpt, data, val_keys):
    """Rows 5 and 6: kernel, plain version and one scaled_dot_product_
    attention call of the same function, at the main paths' shapes and at
    B = 32; then one evaluation round with and without the Pallas mode."""
    import torch
    import torch.nn.functional as F
    from self_attention_tacotron_torch.ops import pallas_attention as pa
    from self_attention_tacotron_torch.parallel import (create_train_state,
                                                        make_eval_step)
    rows = []
    for B, T, D, causal in ((1, T_IN, 16, False),
                            (TRAIN_B, 256, ATTN_D, False),
                            (TRAIN_B, 256, ATTN_D, True)):
        q, k, v = _attention_inputs(device, B, T, D)
        sdpa = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        ref = pa.fused_self_attention_reference(q, k, v, causal)
        times = [_device_ms(fn) for fn in (
            lambda: pa.fused_self_attention(q, k, v, causal),
            lambda: pa.fused_self_attention_reference(q, k, v, causal),
            lambda: F.scaled_dot_product_attention(q, k, v,
                                                   is_causal=causal))]
        bound = attention_bound(B, T, D, causal)
        log(f"phase 12 fused_self_attention B={B} H={ATTN_HEADS} T={T} D={D}"
            f" causal={causal}: kernel {times[0]:.5f} ms, plain "
            f"{times[1]:.5f} ms, SDPA {times[2]:.5f} ms (vs plain max abs "
            f"{_max_err(sdpa, ref):.1e}); bound "
            f"{_bound_ms(bound, PEAK_3XTF32_FLOP_PER_S):.5f} ms ({bound[0]} "
            f"bytes, {bound[1]} FLOPs at the 3xTF32 rate)")
        log(f"phase 12 fused_self_attention B={B} causal={causal} "
            + attention_split(pa, q, k, v, causal, times[0]))
        if B == 1:
            rows += _kernel_rows(
                "fused_self_attention", "self_attention",
                "pallas_attention.py:39", launches,
                errs["fused_self_attention"], *times[:2], bound, times[2],
                peak_flops=PEAK_3XTF32_FLOP_PER_S)
    floor = _device_ms(pa.launch_floor(device))
    log(f"phase 12 an empty kernel in the same queued loop: {floor:.5f} ms")
    for B, S in ((1, ATTN_T), (TRAIN_B, ATTN_T), (1, SERVE_S)):
        t = S - 1
        q, kc, vc = _step_inputs(device, B, t, S)
        mask = torch.ones(1, 1, 1, S, dtype=torch.bool, device=device)
        step_times = [_device_ms(fn) for fn in (
            lambda: pa.incremental_attention_step(q, kc, vc, t),
            lambda: pa.incremental_attention_step_reference(q, kc, vc, t),
            lambda: F.scaled_dot_product_attention(q[:, :, None], kc, vc,
                                                   attn_mask=mask))]
        bound = step_bound(B, t)
        log(f"phase 12 incremental_attention_step B={B} H={ATTN_HEADS} "
            f"S={S} D={ATTN_D} t={t}: kernel {step_times[0]:.5f} ms, "
            f"plain {step_times[1]:.5f} ms, SDPA {step_times[2]:.5f} ms; "
            f"bound {_bound_ms(bound):.6f} ms ({bound[0]} bytes, {bound[1]} "
            "FLOPs)")
        if (B, S) == (1, ATTN_T):
            rows += _kernel_rows(
                "incremental_attention_step", "incremental_attention",
                "pallas_attention.py:109", launches,
                errs["incremental_attention_step"], *step_times[:2], bound,
                step_times[2])

    models = _pallas_models(ckpt, device)
    batches = [b.to(device) for b in validation_batches(
        models[True].hp, data, val_keys)]
    seconds = {}
    for pallas in (True, False, False, True):
        state = create_train_state(models[pallas], models[pallas].hp)
        eval_step = make_eval_step(models[pallas].hp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            metrics, _, _ = eval_step(state, b)
        float(metrics["loss"])
        torch.cuda.synchronize()
        seconds.setdefault(pallas, []).append(time.perf_counter() - t0)
    log(f"phase 12 one evaluation round ({len(batches)} utterances, two "
        f"passes, host clock, in turns): use_pallas_attention=true "
        f"{seconds[True]} s, false {seconds[False]} s")
    return rows


# --------------------------------------------- the mel-spectrogram path

MEL_RECIPE = os.path.join(ROOT, "examples", "ljspeech", "tacotron.json")
VCTK_RECIPE = os.path.join(ROOT, "examples", "vctk", "tacotron.json")
# Spectrogram kernel vs plain version (float32 both, TF32 off).  A 2048-
# or 4096-term float32 DFT sum carries an absolute error of ~1e-6 of the
# frame's peak, so a bin 60 dB under its frame's peak is good to ~0.01 dB
# and one near the -100 dB floor can differ by dBs between two right
# float32 implementations: magnitudes are compared relative to each
# frame's peak, dB only where the plain version is within 60 dB of its
# frame's peak and clears the floor by 20 dB.  Against the float64 numpy
# path of preprocessing the JAX package's own check is 0.15 dB.
TOL_SPEC_MAG = 2e-5
TOL_SPEC_DB = 1e-2
TOL_SPEC_NUMPY_DB = 0.15
# The mel recipe's fused decode vs its plain version: raw 80-wide frames
# fed back for 500 steps.
TOL_MEL_DECODE = 1e-4
MEL_UTTERANCES = 64
MEL_TEXTS = ("Dr. Smith paid $12.50 on May 3, 1999, at 10 a.m.",
             "Mr. and Mrs. Jones read 42 books in 2 weeks.",
             "The 3rd St. bus left at 7:45 with 18 riders.",
             "St. Mary's Hospital has 1,024 beds, not 512.")
MEL_SERVE_FUSED = "decoder_fused_inference=true"


def _audio_hparams(recipe):
    from self_attention_tacotron_torch.config import default_hparams
    return default_hparams().parse_json_file(recipe)


def _extractor(recipe, device):
    from self_attention_tacotron_torch.ops.stft import MelExtractor
    hp = _audio_hparams(recipe)
    return hp, MelExtractor(hp.sample_rate, hp.num_freq, hp.num_mels,
                            hp.frame_length_ms, hp.frame_shift_ms,
                            hp.ref_level_db, device=device)


def _wave(n: int, sr: int, seed: int):
    """A voiced-like test signal: two tones with vibrato under noise."""
    import numpy as np
    rng = np.random.default_rng(SEED + seed)
    t = np.arange(n) / sr
    f0 = rng.uniform(100.0, 250.0)
    phase = 2 * np.pi * f0 * (t + 0.002 * np.sin(2 * np.pi * 5 * t))
    y = 0.3 * np.sin(phase) + 0.15 * np.sin(3 * phase)
    return (y + 0.02 * rng.standard_normal(n)).astype(np.float32)


def spec_errors(got_db, ref_db):
    """(max |magnitude - plain| over the frame's peak, max dB error where
    the plain version is within 60 dB of its frame's peak and clears the
    floor by 20 dB) of (F, bins) dB tensors without the ref_level_db
    shift."""
    got, ref = got_db.double(), ref_db.double()
    mg, mr = 10.0 ** (got / 20.0), 10.0 ** (ref / 20.0)
    peak = mr.amax(1, keepdim=True).clamp(min=1e-5)
    loud = (ref > -80.0) & (ref > ref.amax(1, keepdim=True) - 60.0)
    db = float((got - ref).abs()[loud].max()) if bool(loud.any()) else 0.0
    return float(((mg - mr).abs() / peak).max()), db


def plain_spectrograms_f64(ex, y):
    """``MelExtractor.spectrograms`` through the plain version's arithmetic
    (``frames_of``, then ``spectrograms_reference``) in float64 on the CPU,
    from the same float32 window, DFT matrices and filterbank: its sums do
    not round, so a comparison with it measures the kernel's error and not
    that of a float32 reference.  ``ex`` is a CPU ``MelExtractor``."""
    import numpy as np
    import torch
    from self_attention_tacotron_torch.ops import stft
    wr, wi = (torch.from_numpy(m).double()
              for m in stft.dft_matrices(ex.n_fft))
    frames = stft.frames_of(torch.from_numpy(np.asarray(y, np.float64)),
                            ex.n_fft, ex.hop_length, ex.plan.window.double())
    lin, mel = stft.spectrograms_reference(frames, wr, wi,
                                           ex.plan.mel_t.double())
    return lin.T - ex.ref_level_db, mel.T - ex.ref_level_db


def spectrogram_bound(T, plan, F):
    """(bytes, FLOPs) of spectrograms from a T-sample signal: the signal,
    window, twiddle table and band weights read once, both outputs written
    once; a real FFT a frame (5 (N/2) log2(N/2) for the complex half-size
    transform, 10 (N/2) for the split pass), the window, the magnitudes
    and the banded mel sums."""
    import math
    N = plan.n_fft
    n, K, M = N // 2, N // 2 + 1, plan.band.shape[0]
    nnz = plan.band_w.numel()
    nbytes = 4 * (T + N + 2 * N + nnz + 3 * M + F * K + F * M)
    flops = F * (5 * n * int(math.log2(n)) + 10 * n + N + 4 * K + 2 * nnz)
    return nbytes, flops


def dft_bound(plan, F):
    """The count of the earlier DFT-as-product design for the same
    outputs, for history: frames and both (N, K) DFT matrices read,
    4 F N K + 2 F K M FLOPs."""
    N, M = plan.n_fft, plan.band.shape[0]
    K = N // 2 + 1
    return (4 * (F * N + 2 * N * K + K * M + F * K + F * M),
            4 * F * N * K + 2 * F * K * M)


def library_spectrograms(ex, y):
    """torch.stft (cuFFT) -> abs -> mel product -> dB: the same function
    from library calls (a yardstick; the port never calls it)."""
    import torch
    from self_attention_tacotron_torch.ops.stft import amp_to_db
    mag = torch.stft(y, ex.n_fft, ex.hop_length, win_length=ex.n_fft,
                     window=ex.plan.window, center=True, pad_mode="reflect",
                     return_complex=True).abs()
    return amp_to_db(mag).T, amp_to_db(ex.plan.mel_t.T @ mag).T


def phase_spectrogram(device):
    """Phase 13: the spectrogram kernel from the signal vs its plain
    version at LJSpeech and VCTK widths (10 s, 1.3 s, and one frame from a
    signal shorter than the reflect pad), and at 10 s its time from the
    signal beside the plain version's, the library chain's (also from the
    signal) and its bound.  Returns (worst dB error, {"LJSpeech": ...,
    "VCTK": ...} of the 10 s timings and bounds)."""
    import torch
    from self_attention_tacotron_torch.ops import stft as S
    worst, timing = 0.0, {}
    for recipe, name in ((MEL_RECIPE, "LJSpeech"), (VCTK_RECIPE, "VCTK")):
        hp, ex = _extractor(recipe, device)
        for seconds in (10.0, 1.3, None):
            n = int(seconds * hp.sample_rate) if seconds else \
                ex.hop_length // 2
            y = ex.signal(_wave(n, hp.sample_rate, n))
            got = S.spectrograms(y, ex.plan)
            ref = S.spectrograms_plain(y, ex.plan)
            torch.cuda.synchronize()
            F, N = 1 + n // ex.hop_length, ex.n_fft
            K, M = N // 2 + 1, ex.num_mels
            errs = [spec_errors(g, r) for g, r in zip(got, ref)]
            mag_err = max(e[0] for e in errs)
            db_err = max(e[1] for e in errs)
            log(f"phase 13 spectrogram {name} {n} samples (F={F}, n_fft={N}"
                f", bins={K}, mels={M}): magnitude max err {mag_err:.2e} of "
                f"the frame's peak, dB max err {db_err:.2e} where within 60 "
                "dB of the peak (linear, mel: " + ", ".join(
                    f"{e[0]:.1e}/{e[1]:.1e}" for e in errs) + ")")
            if got[0].shape != (F, K) or got[1].shape != (F, M):
                raise AssertionError("spectrogram output shapes are wrong")
            if mag_err > TOL_SPEC_MAG or db_err > TOL_SPEC_DB:
                raise AssertionError(f"spectrogram disagrees (tol "
                                     f"{TOL_SPEC_MAG} of the peak, "
                                     f"{TOL_SPEC_DB} dB)")
            worst = max(worst, db_err)
            if seconds != 10.0:
                continue
            lib = library_spectrograms(ex, y)
            lib_err = max(spec_errors(g, r)[1] for g, r in zip(lib, ref))
            times = [_device_ms(fn, reps=20) for fn in (
                lambda: S.spectrograms(y, ex.plan),
                lambda: S.spectrograms_plain(y, ex.plan),
                lambda: library_spectrograms(ex, y))]
            bound = spectrogram_bound(n, ex.plan, F)
            old = dft_bound(ex.plan, F)
            log(f"phase 13 timing {name} 10 s from the signal: kernel "
                f"{times[0]:.4f} ms, plain {times[1]:.4f} ms, "
                f"torch.stft+abs+mel+dB {times[2]:.4f} ms (vs plain "
                f"{lib_err:.1e} dB near the peaks); bound "
                f"{_bound_ms(bound):.4f} ms ({bound[0]} bytes, {bound[1]} "
                f"FLOPs; the DFT-as-product count {_bound_ms(old):.4f} ms)")
            timing[name] = (times, bound)
    return worst, timing


def write_ljspeech_corpus(root: str, n: int = MEL_UTTERANCES):
    """An LJSpeech-layout corpus (wavs/*.wav, metadata.csv) of ``n``
    utterances of 1.5-6 s at 22.05 kHz whose texts need the cleaners
    (numbers, money, abbreviations); returns (keys, seconds of audio)."""
    import numpy as np
    import scipy.io.wavfile
    sr = _audio_hparams(MEL_RECIPE).sample_rate
    rng = np.random.default_rng(SEED + 2)
    os.makedirs(os.path.join(root, "wavs"))
    keys, lines, total = [], [], 0.0
    for i in range(n):
        key = f"LJ900-{i:04d}"
        seconds = float(rng.uniform(1.5, 6.0))
        y = _wave(int(seconds * sr), sr, 100 + i)
        scipy.io.wavfile.write(os.path.join(root, "wavs", f"{key}.wav"), sr,
                               (np.clip(y, -1, 1) * 32767).astype(np.int16))
        text = f"{MEL_TEXTS[i % len(MEL_TEXTS)]} Take {i + 1}."
        lines.append(f"{key}|{text}|{text}")
        keys.append(key)
        total += seconds
    with open(os.path.join(root, "metadata.csv"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return keys, total


def _preprocess_in_subprocess(corpus, out, extra):
    """``main_ljspeech`` in a fresh process (its default pool forks no
    CUDA context); returns the wall seconds after the imports."""
    code = ("import sys, time\n"
            "from self_attention_tacotron_torch.cli.preprocess import "
            "main_ljspeech\n"
            "t = time.perf_counter()\n"
            "rc = main_ljspeech(sys.argv[1:])\n"
            "print('WALL', time.perf_counter() - t)\n"
            "sys.exit(rc)\n")
    res = subprocess.run([sys.executable, "-c", code, corpus, out,
                          "--hparam-json-file", MEL_RECIPE, *extra],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, PYTHONPATH=ROOT))
    if res.returncode != 0:
        raise AssertionError(f"preprocess subprocess failed: {res.stderr}")
    return float(res.stdout.split("WALL")[-1])


def phase_preprocess(tmp: str, device):
    """Phase 14: cli.preprocess.main_ljspeech over a synthetic corpus with
    --on-device (cuda), then the numpy path with one worker and with the
    default pool; a few targets against the numpy path.  Returns the
    records' directory, the merged mel recipe file and the launch counts."""
    import numpy as np
    import torch
    from self_attention_tacotron_torch.cli.preprocess import main_ljspeech
    from self_attention_tacotron_torch.data import records as R
    from self_attention_tacotron_torch.ops import stft as S
    corpus = os.path.join(tmp, "ljspeech")
    keys, seconds = write_ljspeech_corpus(corpus)
    hours = seconds / 3600.0
    outs = {m: os.path.join(tmp, f"lj_{m}") for m in ("device", "numpy1",
                                                      "pool")}
    S.spectrograms.launches = 0
    t0 = time.perf_counter()
    rc = main_ljspeech([corpus, outs["device"], "--hparam-json-file",
                        MEL_RECIPE, "--on-device", "--device", device.type])
    walls = {"device": time.perf_counter() - t0}
    counts = {"spectrogram": S.spectrograms.launches}
    if rc != 0:
        raise AssertionError(f"main_ljspeech --on-device returned {rc}")
    t0 = time.perf_counter()
    if main_ljspeech([corpus, outs["numpy1"], "--hparam-json-file",
                      MEL_RECIPE, "--num-workers", "1"]) != 0:
        raise AssertionError("main_ljspeech (numpy) failed")
    walls["numpy1"] = time.perf_counter() - t0
    walls["pool"] = _preprocess_in_subprocess(corpus, outs["pool"], [])
    mag_err = db_err = 0.0
    for key in keys[:4]:
        got, ref = (torch.from_numpy(np.array(R.parse_mel_target_record(
            R.read_first_example(os.path.join(
                outs[m], f"{key}.target.tfrecord"))).mel)) + 20.0
                    for m in ("device", "numpy1"))
        e = spec_errors(got, ref)
        mag_err, db_err = max(mag_err, e[0]), max(db_err, e[1])
    log(f"phase 14 preprocess: {len(keys)} utterances, {seconds:.1f} s of "
        f"audio; --on-device {walls['device']:.2f} s "
        f"({walls['device'] / hours:.1f} s per hour of audio), numpy one "
        f"worker {walls['numpy1']:.2f} s ({walls['numpy1'] / hours:.1f} s/h)"
        f", numpy default pool ({os.cpu_count()} workers, a fresh process) "
        f"{walls['pool']:.2f} s ({walls['pool'] / hours:.1f} s/h); launch "
        f"counts {counts}; 4 targets vs the numpy path: magnitude "
        f"{mag_err:.1e} of the frame's peak, {db_err:.3f} dB within 60 dB of "
        "the peaks")
    if device.type == "cuda" and counts["spectrogram"] != len(keys):
        raise AssertionError("--on-device did not launch the spectrogram "
                             "kernel once an utterance")
    if mag_err > TOL_SPEC_MAG or db_err > TOL_SPEC_NUMPY_DB:
        raise AssertionError("on-device targets disagree with the numpy path")
    data = outs["device"]
    with open(os.path.join(data, "list.csv")) as f:
        listed = f.read().split()
    if listed != keys:
        raise AssertionError("list.csv does not list the corpus")
    for name, part in (("train", keys), ("validation", keys[:2]),
                       ("test", keys[-3:])):
        with open(os.path.join(data, f"{name}.csv"), "w") as f:
            f.write("\n".join(part) + "\n")
    with open(MEL_RECIPE) as f:
        merged = json.load(f)
    with open(os.path.join(data, "hparams.json")) as f:
        merged.update(json.load(f))
    hp_json = os.path.join(tmp, "ljspeech_tacotron.json")
    with open(hp_json, "w") as f:
        json.dump(merged, f)
    return data, hp_json, counts


MEL_TRAIN_HPARAMS = ("save_checkpoints_steps=3,eval_start_delay_secs=0,"
                     "eval_throttle_secs=0,num_evaluation_steps=2")


def phase_mel_training(data: str, hp_json: str, tmp: str, device):
    """Phase 15a: cli.train takes 3 steps of the LJSpeech recipe at B = 32
    on phase 14's records, with one evaluation of 2 utterances."""
    import ast
    import math
    import re
    import torch
    from self_attention_tacotron_torch.cli.train import main as train_main
    ckpt = os.path.join(tmp, "mel_ckpt")
    t0 = time.perf_counter()
    with torch.enable_grad():
        rc = train_main(["--source-data-root", data, "--target-data-root",
                         data, "--checkpoint-dir", ckpt, "--hparam-json-file",
                         hp_json, "--hparams", MEL_TRAIN_HPARAMS,
                         "--max-steps", "3", "--device", device.type])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli.train returned {rc}")
    with open(os.path.join(ckpt, "log.txt")) as f:
        text = f.read()
    losses = [float(x) for x in re.findall(r"step \d+ loss ([-+0-9.eEinfa]+)",
                                           text)]
    evals = re.findall(r"eval @3: (\{.*\}) \(", text)
    metrics = ast.literal_eval(evals[0]) if len(evals) == 1 else {}
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        train_rows = [r for r in map(json.loads, f) if "mel_loss" in r]
    batch = _audio_hparams(hp_json).batch_size
    log(f"phase 15 mel training: cli.train took 3 steps of "
        f"{os.path.basename(MEL_RECIPE)} at B={batch} on {device.type} in "
        f"{wall:.1f} s; "
        f"losses {losses}; mel_loss {[r['mel_loss'] for r in train_rows]}; "
        f"eval @3 {metrics}")
    if len(losses) != 3 or not all(math.isfinite(x) for x in losses):
        raise AssertionError("mel training losses are missing or not finite")
    if ("mel_loss_with_teacher" not in metrics
            or not all(math.isfinite(v) for v in metrics.values())):
        raise AssertionError("the mel evaluation lacks finite metrics")
    if "model-3.pt" not in os.listdir(ckpt):
        raise AssertionError("no checkpoint of step 3 was written")
    return ckpt


def _serve_mel(data, ckpt, hp_json, out, device, hparams="", list_dir=None):
    import contextlib
    import io
    import re
    from self_attention_tacotron_torch.cli.predict import main_mel
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_mel(["--source-data-root", data, "--target-data-root", data,
                       "--checkpoint-dir", ckpt, "--output-dir", out,
                       "--hparam-json-file", hp_json, "--hparams", hparams,
                       "--device", device.type,
                       *(["--selected-list-dir", list_dir] if list_dir
                         else [])])
    sys.stdout.write(buf.getvalue())
    if rc != 0:
        raise AssertionError(f"main_mel returned {rc}")
    return [(k, int(n), float(ms)) for k, n, ms in re.findall(
        r"predicted (\S+): (\d+) decode steps, ([0-9.]+) ms", buf.getvalue())]


def phase_mel_serving(data, ckpt, hp_json, tmp, device):
    """Phase 15b: main_mel serves the 3 test utterances on cuda, on the
    plain path and with decoder_fused_inference; the fused decode at the
    mel recipe's shape (one forward source, no hops, r = 2, C = 80) held
    against its plain version and timed.  Returns (launch counts, rows)."""
    import numpy as np
    import torch
    from self_attention_tacotron_torch.config import load_hparams
    from self_attention_tacotron_torch.data.dataset import (iter_utterances,
                                                            load_key_list)
    from self_attention_tacotron_torch.data.records import (
        parse_mel_prediction_record, read_first_example)
    from self_attention_tacotron_torch.models import tacotron_model_factory
    from self_attention_tacotron_torch.ops import fused_decode as fd
    from self_attention_tacotron_torch.utils.convert import load_checkpoint
    keys = load_key_list(os.path.join(data, "test.csv"))
    C = _audio_hparams(hp_json).num_mels
    outs = {m: os.path.join(tmp, f"mel_pred_{m}") for m in ("plain", "fused")}
    fd.fused_decode.launches = 0
    plain = _serve_mel(data, ckpt, hp_json, outs["plain"], device)
    plain_launches = fd.fused_decode.launches
    fd.fused_decode.launches = 0
    fused = _serve_mel(data, ckpt, hp_json, outs["fused"], device,
                       MEL_SERVE_FUSED)
    counts = {"fused_decode": fd.fused_decode.launches}
    worst = 0.0
    for key in keys:
        dumps = [np.fromfile(os.path.join(o, f"{key}.mfbsp"), "<f4").reshape(
            -1, C) for o in outs.values()]
        rec = parse_mel_prediction_record(read_first_example(
            os.path.join(outs["fused"], f"{key}.tfrecord")))
        if not (np.array_equal(rec.mel, dumps[1])
                and all(np.isfinite(d).all() and len(d) for d in dumps)):
            raise AssertionError(f"bad mel prediction files for {key}")
        n = min(len(d) for d in dumps)
        worst = max(worst, float(np.abs(dumps[0][:n] - dumps[1][:n]).max()))
    log(f"phase 15 mel serving: main_mel served {len(plain)} utterances on "
        f"the plain path {[(n, ms) for _, n, ms in plain]} (steps, ms) and "
        f"{len(fused)} with {MEL_SERVE_FUSED} {[(n, ms) for _, n, ms in fused]}"
        f"; fused_decode launches {plain_launches} then {counts}; .mfbsp "
        f"fused vs plain max abs err {worst:.2e}")
    if plain_launches != 0 or (device.type == "cuda"
                               and counts["fused_decode"] != len(keys)):
        raise AssertionError("the mel serving paths launched the wrong "
                             "kernels")
    if [n for _, n, _ in plain] != [n for _, n, _ in fused] \
            or worst > TOL_MEL_DECODE:
        raise AssertionError("fused mel serving disagrees with the plain path")

    class Args:
        hparam_json_file, hparams = hp_json, MEL_SERVE_FUSED
    hp = load_hparams(Args())
    model = tacotron_model_factory(hp).eval()
    load_checkpoint(model, ckpt)
    model.to(device)
    u = next(iter_utterances(*_val_files(hp, data, keys[:1]), hp, "mel"))
    src = torch.from_numpy(u.source[None]).to(device)
    lengths = torch.tensor([u.source_length], device=device)
    memory = model.encoder(model.embedding(src), lengths)
    dec = model.decoder
    packs = (dec.attention_mechanisms[0].precompute(memory, lengths),)
    weights, mem, options = dec.fused_inputs(packs)
    options = dict(options, early_stop=False)
    steps = hp.max_iters
    got, ref = _decode_pair(weights, mem, options, steps)
    err = max(_max_err(got[0], ref[0]), _max_err(got[1], ref[1]),
              _max_err(got[2][0], ref[2][0]))
    ms = _time_ms(fd.prepare_decode(weights, mem, num_steps=steps, **options))
    plain_ms = _time_ms(lambda: fd.fused_decode_reference(
        weights, mem, num_steps=steps, **options), reps=1)
    bound = decode_bound(dec.fused_params(), weights, mem, steps)
    log(f"phase 15 fused_decode at the mel recipe (T={u.source_length}, "
        f"{steps} steps, r={hp.outputs_per_step}, C={hp.num_mels}, one "
        f"source, no hops): max abs err {err:.2e}; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms; bound {_bound_ms(bound):.4f} ms ({bound[0]} "
        f"bytes, {bound[1]} FLOPs)")
    if err > TOL_MEL_DECODE:
        raise AssertionError(f"fused_decode disagrees at the mel recipe (tol "
                             f"{TOL_MEL_DECODE})")
    return counts, _kernel_rows("fused_decode", "fused_decode",
                                "fused_decode.py:250", {"mel_serving": counts},
                                err, ms, plain_ms, bound)


# ------------------- the VCTK recipe and the fused decode's row modes

# the paper's multi-speaker recipe: forward attention, decoder v2, r = 2,
# 80 mels at 48 kHz, 500 steps, 152 speakers at offset 225, every kernel on
VCTK_SA_RECIPE = os.path.join(ROOT, "examples", "vctk",
                              "self-attention-tacotron.json")
VCTK_SPEAKERS = (225, 226, 227, 228)
VCTK_PER_SPEAKER = 16
VCTK_TEXTS = ("Please call Stella.",
              "Ask her to bring these things with her from the store.",
              "Six spoons of fresh snow peas, five thick slabs of blue "
              "cheese, and maybe a snack for her brother Bob.",
              "We also need a small plastic snake and a big toy frog.",
              "She can scoop these things into three red bags.",
              "When the sunlight strikes raindrops in the air, they act as "
              "a prism and form a rainbow.")
VCTK_TRAIN_HPARAMS = ("save_checkpoints_steps=3,eval_start_delay_secs=0,"
                      "eval_throttle_secs=0,num_evaluation_steps=2")
VCTK_PLAIN = "decoder_fused_inference=false,encoder_fused_inference=false"
VCTK_TRAIN_S = 160      # 320 frames: 4 s at the recipe's 12.5 ms shift
VCTK_T_IN = 64          # characters
BATCH_SIZES = (1, 4, 8)
# The VCTK decode feeds back raw 160-wide mel rows (r = 2) for 500 steps;
# the codes recipe at B = 8 and the location-sensitive kind feed back 1025
# logits for 450 steps, as phase 4 does.
TOL_VCTK_DECODE = 1e-4
TOL_ROW_DECODE = TOL_DECODE
# Batched serving: the kernel against the module path's logits, 450 steps.
TOL_BATCHED_SERVING = 1e-4


def _hp_with(recipe, extra=""):
    from self_attention_tacotron_torch.config import default_hparams
    hp = default_hparams().parse_json_file(recipe)
    hp.parse(extra)
    return hp


def _join(*parts):
    return ",".join(p for p in parts if p)


def write_vctk_corpus(root: str, per_speaker: int = VCTK_PER_SPEAKER):
    """A VCTK 0.8 layout corpus (wav48/pNNN/*.wav, txt/pNNN/*.txt,
    speaker-info.txt) of ``len(VCTK_SPEAKERS)`` speakers with
    ``per_speaker`` utterances of 1.5-4 s at 48 kHz each; returns (keys,
    seconds of audio)."""
    import numpy as np
    import scipy.io.wavfile
    sr = _audio_hparams(VCTK_SA_RECIPE).sample_rate
    rng = np.random.default_rng(SEED + 5)
    keys, total = [], 0.0
    info = ["ID  AGE  GENDER  ACCENTS  REGION"]
    for si, spk in enumerate(VCTK_SPEAKERS):
        for sub in ("wav48", "txt"):
            os.makedirs(os.path.join(root, sub, f"p{spk}"))
        info.append(f"{spk}  {21 + si}  {'FM'[si % 2]}    English    "
                    "Southern  England")
        for i in range(1, per_speaker + 1):
            key = f"p{spk}_{i:03d}"
            seconds = float(rng.uniform(1.5, 4.0))
            y = _wave(int(seconds * sr), sr, 1000 * spk + i)
            scipy.io.wavfile.write(
                os.path.join(root, "wav48", f"p{spk}", f"{key}.wav"), sr,
                (np.clip(y, -1, 1) * 32767).astype(np.int16))
            with open(os.path.join(root, "txt", f"p{spk}", f"{key}.txt"),
                      "w") as f:
                f.write(VCTK_TEXTS[(i + si) % len(VCTK_TEXTS)] + "\n")
            keys.append(key)
            total += seconds
    with open(os.path.join(root, "speaker-info.txt"), "w") as f:
        f.write("\n".join(info) + "\n")
    return keys, total


def phase_vctk_preprocess(tmp: str, device, extra: str = ""):
    """Phase 17a: cli.preprocess.main_vctk --on-device over the synthetic
    corpus (one spectrogram launch an utterance), then cli.speaker_selection
    crosscheck of the train/validation/test lists against the records, as
    scripts/run_vctk.sh runs them.  Returns (records, lists, merged recipe
    file, launch counts)."""
    from self_attention_tacotron_torch.cli import speaker_selection
    from self_attention_tacotron_torch.cli.preprocess import main_vctk
    from self_attention_tacotron_torch.data.dataset import load_key_list
    from self_attention_tacotron_torch.ops import stft as S
    corpus, data = os.path.join(tmp, "vctk"), os.path.join(tmp, "vctk_data")
    keys, seconds = write_vctk_corpus(corpus)
    S.spectrograms.launches = 0
    t0 = time.perf_counter()
    rc = main_vctk([corpus, data, "--hparam-json-file", VCTK_SA_RECIPE,
                    "--hparams", extra, "--on-device", "--device",
                    device.type])
    wall = time.perf_counter() - t0
    counts = {"spectrogram": S.spectrograms.launches}
    if rc != 0:
        raise AssertionError(f"main_vctk --on-device returned {rc}")
    if device.type == "cuda" and counts["spectrogram"] != len(keys):
        raise AssertionError("main_vctk --on-device did not launch the "
                             "spectrogram kernel once an utterance")
    per = VCTK_PER_SPEAKER
    test = [keys[si * per] for si in range(3)]
    validation = [keys[si * per + 1] for si in (0, 3)]
    parts = {"train": [k for k in keys if k not in test + validation],
             "validation": validation, "test": test}
    raw, lists = os.path.join(tmp, "vctk_lists_raw"), os.path.join(
        tmp, "vctk_lists")
    os.makedirs(raw)
    os.makedirs(lists)
    for name, part in parts.items():
        with open(os.path.join(raw, f"{name}.csv"), "w") as f:
            f.write("\n".join(part) + "\n")
        if speaker_selection.main(
                ["crosscheck", os.path.join(raw, f"{name}.csv"), data,
                 "--out", os.path.join(lists, f"{name}.csv")]) != 0:
            raise AssertionError("speaker_selection crosscheck failed")
        if load_key_list(os.path.join(lists, f"{name}.csv")) != part:
            raise AssertionError(f"crosscheck dropped keys of {name}.csv")
    with open(VCTK_SA_RECIPE) as f:
        merged = json.load(f)
    with open(os.path.join(data, "hparams.json")) as f:
        merged.update(json.load(f))
    hp_json = os.path.join(tmp, "vctk_self_attention_tacotron.json")
    with open(hp_json, "w") as f:
        json.dump(merged, f)
    log(f"phase 17 VCTK preprocess: main_vctk --on-device over "
        f"{len(keys)} utterances of {len(VCTK_SPEAKERS)} speakers "
        f"({seconds:.1f} s of audio at 48 kHz) in {wall:.2f} s "
        f"({wall / (seconds / 3600.0):.1f} s per hour of audio); launch "
        f"counts {counts}; speaker_selection crosscheck kept "
        + ", ".join(f"{n} {len(p)}" for n, p in parts.items()))
    return data, lists, hp_json, counts


def phase_vctk_training(data, lists, hp_json, tmp, device, extra=""):
    """Phase 17b: cli.train takes 3 steps of the VCTK recipe at B = 32 with
    one evaluation of 2 validation utterances (two VALIDATION decodes
    each).  Counters zeroed just before: 3 launches of each training
    kernel, 4 of the encoder (the evaluation's batch-1 encodes), none of
    the decode (VALIDATION runs the step loop, as in the JAX package).
    Returns (checkpoint, launch counts)."""
    import ast
    import math
    import re
    import torch
    from self_attention_tacotron_torch.cli.train import main as train_main
    from self_attention_tacotron_torch.ops import fused_decode as fd
    from self_attention_tacotron_torch.ops import fused_encoder as fe
    from self_attention_tacotron_torch.ops import fused_train as ft
    ckpt = os.path.join(tmp, "vctk_ckpt")
    for fn in (ft.fused_train_fwd, ft.fused_train_bwd, fe.fused_encode,
               fd.fused_decode):
        fn.launches = 0
    t0 = time.perf_counter()
    with torch.enable_grad():
        rc = train_main(["--source-data-root", data, "--target-data-root",
                         data, "--checkpoint-dir", ckpt,
                         "--selected-list-dir", lists, "--hparam-json-file",
                         hp_json, "--hparams",
                         _join(VCTK_TRAIN_HPARAMS, extra), "--max-steps",
                         "3", "--device", device.type])
    wall = time.perf_counter() - t0
    counts = {"fused_train_fwd": ft.fused_train_fwd.launches,
              "fused_train_bwd": ft.fused_train_bwd.launches,
              "fused_encode": fe.fused_encode.launches,
              "fused_decode": fd.fused_decode.launches}
    if rc != 0:
        raise AssertionError(f"cli.train returned {rc}")
    with open(os.path.join(ckpt, "log.txt")) as f:
        text = f.read()
    losses = [float(x) for x in re.findall(r"step \d+ loss ([-+0-9.eEinfa]+)",
                                           text)]
    times = [float(x) for x in re.findall(r"step \d+ loss \S+ \(([0-9.]+)s",
                                          text)]
    evals = re.findall(r"eval @3: (\{.*\}) \((\d+) utterances, ([0-9.]+)s",
                       text)
    metrics = ast.literal_eval(evals[0][0]) if len(evals) == 1 else {}
    hp = _hp_with(hp_json, _join(VCTK_TRAIN_HPARAMS, extra))
    log(f"phase 17 VCTK training: cli.train took 3 steps of "
        f"{os.path.basename(VCTK_SA_RECIPE)} at B={hp.batch_size} on "
        f"{device.type} in {wall:.1f} s (start included); losses {losses}; "
        f"seconds a step {times}; eval @3 {metrics} "
        f"({evals[0][1] if evals else 0} utterances, "
        f"{evals[0][2] if evals else '-'} s); launch counts {counts}")
    if len(losses) != 3 or not all(math.isfinite(x) for x in losses):
        raise AssertionError("VCTK training losses are missing or not "
                             "finite")
    # the recipe's model is a code model by name: its main loss is code_loss
    if ("code_loss_with_teacher" not in metrics
            or not all(math.isfinite(v) for v in metrics.values())):
        raise AssertionError("the VCTK evaluation lacks finite metrics")
    want = {"fused_train_fwd": 3, "fused_train_bwd": 3,
            "fused_encode": 2 * hp.num_evaluation_steps, "fused_decode": 0}
    if device.type == "cuda" and counts != want:
        raise AssertionError(f"VCTK training launches {counts}, expected "
                             f"{want}")
    if "model-3.pt" not in os.listdir(ckpt):
        raise AssertionError("no checkpoint of step 3 was written")
    return ckpt, counts


def phase_vctk_serving(data, lists, ckpt, hp_json, tmp, device, extra=""):
    """Phase 17c: cli.predict.main_mel serves the 3 test utterances (three
    speakers) with the recipe's fused paths (one encoder and one decode
    launch an utterance, the speaker row in the decode) and on the plain
    module path (no launch); the frames agree.  Then one text, two
    speakers: different frames.  Returns (launch counts, ms an utterance)."""
    import numpy as np
    import torch
    from self_attention_tacotron_torch.data.dataset import (iter_utterances,
                                                            load_key_list)
    from self_attention_tacotron_torch.models import (Batch,
                                                      tacotron_model_factory)
    from self_attention_tacotron_torch.ops import fused_decode as fd
    from self_attention_tacotron_torch.ops import fused_encoder as fe
    from self_attention_tacotron_torch.utils.convert import load_checkpoint
    keys = load_key_list(os.path.join(lists, "test.csv"))
    hp = _hp_with(hp_json, extra)
    C = hp.num_mels
    outs = {m: os.path.join(tmp, f"vctk_pred_{m}") for m in ("fused",
                                                           "plain")}
    fe.fused_encode.launches = fd.fused_decode.launches = 0
    fused = _serve_mel(data, ckpt, hp_json, outs["fused"], device, extra,
                       lists)
    counts = {"fused_encode": fe.fused_encode.launches,
              "fused_decode": fd.fused_decode.launches}
    fe.fused_encode.launches = fd.fused_decode.launches = 0
    plain = _serve_mel(data, ckpt, hp_json, outs["plain"], device,
                       _join(extra, VCTK_PLAIN), lists)
    plain_counts = (fe.fused_encode.launches, fd.fused_decode.launches)
    worst = 0.0
    for key in keys:
        dumps = [np.fromfile(os.path.join(o, f"{key}.mfbsp"), "<f4").reshape(
            -1, C) for o in outs.values()]
        if not all(np.isfinite(d).all() and len(d) for d in dumps):
            raise AssertionError(f"bad VCTK prediction files for {key}")
        n = min(len(d) for d in dumps)
        worst = max(worst, float(np.abs(dumps[0][:n] - dumps[1][:n]).max()))
    log(f"phase 17 VCTK serving: main_mel served {len(fused)} utterances "
        f"with the fused paths {[(n, ms) for _, n, ms in fused]} (steps, ms)"
        f" and on the plain path {[(n, ms) for _, n, ms in plain]}; launch "
        f"counts fused {counts}, plain {plain_counts}; .mfbsp fused vs "
        f"plain max abs err {worst:.2e}")
    if device.type == "cuda" and counts != {"fused_encode": len(keys),
                                            "fused_decode": len(keys)}:
        raise AssertionError("VCTK serving did not launch both serving "
                             "kernels once an utterance")
    if plain_counts != (0, 0):
        raise AssertionError("the plain VCTK serving path launched a kernel")
    if [n for _, n, _ in plain] != [n for _, n, _ in fused] \
            or worst > TOL_VCTK_DECODE:
        raise AssertionError("fused VCTK serving disagrees with the plain "
                             "path")

    model = tacotron_model_factory(hp).eval()
    load_checkpoint(model, ckpt)
    model.to(device)
    src_files, tgt_files = _val_files(hp, data, keys[:1])
    u = next(iter_utterances(src_files, tgt_files, hp, "mel"))
    src = torch.from_numpy(u.source[None]).to(device)
    lengths = torch.tensor([u.source_length], device=device)
    frames = [model(Batch(src, lengths, speaker_id=torch.tensor(
        [spk], device=device))).outputs for spk in VCTK_SPEAKERS[:2]]
    moved = _max_err(frames[0], frames[1])
    log(f"phase 17 one text, speakers {VCTK_SPEAKERS[:2]}: max abs "
        f"difference of the frames {moved:.3e} (utterance {u.meta.key}, "
        f"speaker {u.speaker_id})")
    if not moved > 1e-3:
        raise AssertionError("two speakers gave the same frames")
    return counts, [ms for _, _, ms in fused]


def rows_case(model, lengths, T: int, device, seed: int = 0):
    """(weights, memory, options) of the fused decode for rows of random
    sources of ``lengths`` (padded to T) through the model's encoder, with
    the speaker rows of speakers cycling over ``VCTK_SPEAKERS`` when the
    model has speakers."""
    import numpy as np
    import torch
    from self_attention_tacotron_torch.models import Batch
    B = len(lengths)
    rng = np.random.default_rng(SEED + seed)
    src = np.zeros((B, T), np.int64)
    for b, L in enumerate(lengths):
        src[b, :L] = rng.integers(1, model.hp.num_symbols, L)
    sid = torch.tensor([VCTK_SPEAKERS[b % len(VCTK_SPEAKERS)]
                        for b in range(B)], device=device)
    batch = Batch(torch.from_numpy(src).to(device),
                  torch.tensor(list(lengths), device=device), speaker_id=sid)
    sources, lens, _, speaker = model._encode(batch)
    dec = model.decoder
    packs = tuple(m.precompute(s, ln) for m, s, ln in
                  zip(dec.attention_mechanisms, sources, lens))
    return dec.fused_inputs(packs, model._prenet_speaker(speaker))


def stagger_stop(weights, memory, options, steps: int, seed: int = 0):
    """``weights`` with the stop head's row drawn from ``seed`` and a bias
    at which every row fires past min_iters and before the last two steps,
    at as many different steps as can be (random weights give near-flat
    stop logits that would cross any threshold together; the stop logit
    feeds nothing back, so the bias shifts it exactly).  The threshold sits
    midway between two neighbouring logits.  Returns (weights, each row's
    firing step)."""
    import torch
    from self_attention_tacotron_torch.ops import fused_decode as fd
    head_w, head_b = weights.head_w.clone(), weights.head_b.clone()
    g = torch.Generator().manual_seed(seed)
    head_w[weights.cr] = torch.randn(head_w.shape[1], generator=g).to(
        head_w.device)
    head_b[weights.cr] = 0.0
    weights = weights._replace(head_w=head_w, head_b=head_b)
    free = fd.fused_decode_reference(weights, memory, num_steps=steps,
                                     **dict(options, early_stop=False))[1]
    m = options["min_iters"]
    late = free[:, m + 1:].double().cpu()
    run = late.cummax(1).values
    vals = torch.unique(late.flatten()).tolist()
    best = ((0, 0), None, None)
    for lo, hi in zip(vals[:-1], vals[1:]):
        if hi - lo < 1e-5:
            continue
        theta = 0.5 * (lo + hi)
        fired = run > theta
        if not bool(fired.any(1).all()):
            continue
        fire = [m + 1 + s for s in fired.int().argmax(1).tolist()]
        if max(fire) >= steps - 2:
            continue
        key = (len(set(fire)), max(fire))
        if key > best[0]:
            best = (key, theta, fire)
    if best[1] is None:
        raise AssertionError("no stop bias makes the rows fire apart")
    head_b[weights.cr] = -best[1]
    return weights, best[2]


def phase_row_kernels(device, codes_hp):
    """Phase 16: the fused decode in its new modes against its plain
    version at the recipes' widths: the codes recipe at B = 8 (sources of
    40-64 phones, 450 steps), early stop off and on (rows that fire at
    different steps); location-sensitive sources, cumulative and not, at
    B = 1 and B = 4.  Returns (worst error, cases for the timing)."""
    import numpy as np
    import torch
    cases = {}
    rng = np.random.default_rng(SEED + 16)
    b8 = [T_IN] + rng.integers(40, T_IN + 1, 7).tolist()
    model = make_model(codes_hp, device)
    cases["codes_b8"] = (model, rows_case(model, b8, T_IN, device, 8))
    for cum in (False, True):
        loc = make_model(codes_hp.replace(attention="location_sensitive",
                                          cumulative_weights=cum), device)
        for B in (1, 4):
            cases[f"location{'_cumulative' if cum else ''}_b{B}"] = (
                loc, rows_case(loc, b8[:B], T_IN, device, B))
    worst = 0.0
    steps = codes_hp.max_iters
    for name, (_, (weights, memory, options)) in cases.items():
        options = dict(options, early_stop=False)
        got, ref = _decode_pair(weights, memory, options, steps)
        err = max(_max_err(got[0], ref[0]), _max_err(got[1], ref[1]),
                  *(_max_err(g, r) for g, r in zip(got[2], ref[2])))
        agree = float((got[0].argmax(-1) == ref[0].argmax(-1)).float()
                      .mean())
        log(f"phase 16 fused_decode {name} (B={memory.keys[0].shape[0]}, "
            f"T={memory.keys[0].shape[1]}, {steps} steps): max abs err "
            f"{err:.3e}; code argmax agreement {agree:.4f}")
        if err > TOL_ROW_DECODE or agree < 1.0:
            raise AssertionError(f"fused_decode {name} disagrees (tol "
                                 f"{TOL_ROW_DECODE})")
        worst = max(worst, err)
    weights, memory, options = cases["codes_b8"][1]
    w_stop, fire = stagger_stop(weights, memory, options, steps)
    options = dict(options, early_stop=True)
    got, ref = _decode_pair(w_stop, memory, options, steps)
    err = max(_max_err(got[0], ref[0]), _max_err(got[1], ref[1]))
    tail_zero = bool((got[0][:, max(fire) + 1:] == 0).all())
    live = bool((got[0][:, :max(fire) + 1].abs().sum(-1) > 0).all())
    log(f"phase 16 fused_decode codes_b8 early stop on: rows fire at steps "
        f"{fire}; out max abs err {err:.3e}; every row emits up to the last "
        f"firing {live}; zero after it {tail_zero}")
    if err > TOL_ROW_DECODE or not tail_zero or not live:
        raise AssertionError("batched early-stop decode disagrees")
    return max(worst, err), cases


def phase_vctk_kernels(device, extra=""):
    """Phase 16 (VCTK widths): the encoder and the decode (B = 1, the
    speaker row, 500 steps) against their plain versions, and the training
    kernels at the VCTK training shape (B = 32, T_in = 64 characters,
    S = 160 steps of r = 2 mel frames, the speaker rows, masks on) against
    the plain forward and the plain reverse-time VJP.  Returns (errors,
    timings {name: (ms, plain ms, bound)})."""
    import torch
    from self_attention_tacotron_torch.ops import fused_decode as fd
    from self_attention_tacotron_torch.ops import fused_encoder as fe
    from self_attention_tacotron_torch.ops import fused_train as ft
    hp = _hp_with(VCTK_SA_RECIPE, extra)
    model = make_model(hp, device)
    errs, timing = {}, {}
    params, x, kw = encoder_case(model, VCTK_T_IN, VCTK_T_IN, device)
    got = fe.fused_encode(params, x, VCTK_T_IN, **kw)
    ref = fe.fused_encode_reference(params, x, VCTK_T_IN, **kw)
    errs["fused_encode"] = max(_max_err(g, r) for g, r in zip(got, ref))
    timing["fused_encode"] = (
        _time_ms(fe.prepare_encode(params, x, VCTK_T_IN, **kw)),
        _time_ms(lambda: fe.fused_encode_reference(params, x, VCTK_T_IN,
                                                   **kw), reps=3),
        encode_bound(params, x, kw))

    weights, memory, options = rows_case(model, [VCTK_T_IN], VCTK_T_IN,
                                         device, 17)
    options = dict(options, early_stop=False)
    steps = hp.max_iters
    got, ref = _decode_pair(weights, memory, options, steps)
    errs["fused_decode"] = max(_max_err(got[0], ref[0]),
                               _max_err(got[1], ref[1]),
                               *(_max_err(g, r) for g, r in zip(got[2],
                                                                ref[2])))
    no_spk = fd.fused_decode_reference(
        weights, memory, num_steps=steps, **dict(options, speaker_row=None))
    spk_effect = _max_err(no_spk[0], ref[0])
    timing["fused_decode"] = (
        _time_ms(fd.prepare_decode(weights, memory, num_steps=steps,
                                   **options)),
        _time_ms(lambda: fd.fused_decode_reference(
            weights, memory, num_steps=steps, **options), reps=1),
        decode_bound(model.decoder.fused_params(), weights, memory, steps,
                     options["speaker_row"]))
    log(f"phase 16 VCTK widths (T={VCTK_T_IN} characters, {steps} steps, "
        f"r={hp.outputs_per_step}, C={hp.num_mels}, speaker row of "
        f"{options['speaker_row'].shape[1]}): fused_encode max abs err "
        f"{errs['fused_encode']:.3e}; fused_decode max abs err "
        f"{errs['fused_decode']:.3e} (the speaker row moves the plain "
        f"version's frames by {spk_effect:.3e})")
    if errs["fused_encode"] > TOL_ENCODE or \
            errs["fused_decode"] > TOL_VCTK_DECODE:
        raise AssertionError("a serving kernel disagrees at the VCTK widths")

    spec, params, keys, values, masks, tf, loc_ws, ops, spk = train_case(
        model, device, False, 2, steps=VCTK_TRAIN_S)
    seed = 4321
    y, save, aux = ft.fused_train_fwd(spec, ops, seed)
    y_r, save_r, aux_r = ft.fused_train_fwd_reference(
        spec, params, keys, values, masks, tf, seed, spk, loc_ws)
    errs["fused_train_fwd"] = max(_max_err(y, y_r), _max_err(save, save_r),
                                  _max_err(aux, aux_r))
    g = torch.randn(y.shape, generator=torch.Generator(device)
                    .manual_seed(8), device=device)
    kern = _kernel_grads(spec, ft.fused_train_bwd(spec, ops, seed, g, save,
                                                  aux))
    d_params, d_keys, d_values, d_spk, d_loc = ft.fused_train_bwd_reference(
        spec, params, keys, values, masks, tf, seed, spk, loc_ws, g, save_r,
        aux_r)
    plain = _grad_leaves(spec, d_params, d_keys, d_values, d_loc, d_spk)
    rel = {k: _rel_err(kern[k], plain[k].reshape(kern[k].shape))
           for k in plain}
    errs["fused_train_bwd"] = max(
        _max_err(kern[k], plain[k].reshape(kern[k].shape)) for k in plain)
    name, worst_rel = max(rel.items(), key=lambda kv: kv[1])
    log(f"phase 16 training kernels at the VCTK shape (B={spec.batch}, "
        f"S={spec.num_steps}, T={spec.t_mem}, p_sizes {spec.p_sizes}, "
        f"speaker rows, masks on): fused_train_fwd max abs err "
        f"{errs['fused_train_fwd']:.3e}; fused_train_bwd worst gradient "
        f"{name} {worst_rel:.3e} of its max magnitude (spk "
        f"{rel['spk']:.1e}), max abs err {errs['fused_train_bwd']:.3e}")
    if errs["fused_train_fwd"] > TOL_TRAIN or worst_rel > TOL_TRAIN_GRAD:
        raise AssertionError("a training kernel disagrees at the VCTK shape")
    fwd_ms = _time_ms(ft.prepare_train_fwd(spec, ops, seed))
    bwd = ft.prepare_train_bwd(spec, ops, seed, g, save, aux)
    bwd_ms = _time_ms(bwd)
    fwd_plain = _time_ms(lambda: ft.fused_train_fwd_reference(
        spec, params, keys, values, masks, tf, seed, spk, loc_ws), reps=1)
    bwd_plain = _time_ms(lambda: ft.fused_train_bwd_reference(
        spec, params, keys, values, masks, tf, seed, spk, loc_ws, g, save,
        aux), reps=1)
    flat_in = ft._flat(ops)
    timing["fused_train_fwd"] = (fwd_ms, fwd_plain, train_bound(
        spec, flat_in, [y, save, aux], False))
    timing["fused_train_bwd"] = (bwd_ms, bwd_plain, train_bound(
        spec, flat_in + [g, save, aux], _leaves(bwd.outputs), True))
    del model
    return errs, timing


def vctk_and_row_modes(tmp, device, codes_hp, codes_timing, errs,
                       spec_err, vctk_spec, launches):
    """Phases 16-19; adds the paths vctk_preprocessing, vctk_training,
    vctk_serving and batched_inference to ``launches`` and returns their
    rows of the kernels line, each with the times of its own shapes."""
    row_err, cases = phase_row_kernels(device, codes_hp)
    vctk_errs, vctk_timing = phase_vctk_kernels(device)
    data, lists, hp_json, launches["vctk_preprocessing"] = \
        phase_vctk_preprocess(tmp, device)
    ckpt, launches["vctk_training"] = phase_vctk_training(
        data, lists, hp_json, tmp, device)
    launches["vctk_serving"], _ = phase_vctk_serving(data, lists, ckpt,
                                                     hp_json, tmp, device)
    launches["batched_inference"], batched = phase_batched_inference(
        device, codes_hp)
    modes = phase_row_timing(cases, vctk_timing, codes_timing, batched,
                             device)
    lines = {"fused_encode": ("fused_encoder", "fused_encoder.py:94"),
             "fused_decode": ("fused_decode", "fused_decode.py:250"),
             "fused_train_fwd": ("fused_train_fwd", "fused_train.py:375"),
             "fused_train_bwd": ("fused_train_bwd", "fused_train.py:667")}

    def rows(name, path, err, timing):
        ms, plain, bound = timing
        return _kernel_rows(name, *lines[name], {path: launches[path]}, err,
                            ms, plain, bound, peak_flops=(
                                PEAK_FP32_FLOP_PER_S if name == "fused_decode"
                                else PEAK_3XTF32_FLOP_PER_S))

    (spec_ms, spec_plain, spec_lib), spec_bound = vctk_spec
    out = _kernel_rows("spectrogram", "spectrogram", "stft.py:65",
                       {"vctk_preprocessing": launches["vctk_preprocessing"]},
                       spec_err, spec_ms, spec_plain, spec_bound, spec_lib)
    for name in ("fused_train_fwd", "fused_train_bwd", "fused_encode"):
        out += rows(name, "vctk_training", vctk_errs[name],
                    vctk_timing[name])
    out += rows("fused_encode", "vctk_serving", vctk_errs["fused_encode"],
                vctk_timing["fused_encode"])
    out += rows("fused_decode", "vctk_serving", vctk_errs["fused_decode"],
                modes["vctk_speaker_b1"])
    out += rows("fused_encode", "batched_inference", errs["fused_encode"],
                codes_timing["fused_encode"])
    out += rows("fused_decode", "batched_inference", row_err,
                modes["codes_b8"])
    return out


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def phase_batched_inference(device, codes_hp):
    """Phase 18: INFERENCE of the codes recipe through the model at B = 1,
    4 and 8 (sources of 40-64 phones), with the recipe's fused paths and on
    the plain module path (the same weights), timed on the host clock
    around a device sync (median of 3 after a warm-up); the logits agree.
    Early stop is off: every row decodes all 450 steps (random weights
    fire the stop token after a dozen steps, which would time the
    encoder).  Returns (launch counts of the fused runs, {B: (fused ms,
    plain ms)})."""
    import numpy as np
    import torch
    from self_attention_tacotron_torch.models import Batch
    from self_attention_tacotron_torch.ops import fused_decode as fd
    from self_attention_tacotron_torch.ops import fused_encoder as fe
    rng = np.random.default_rng(SEED + 18)
    lengths = [T_IN] + rng.integers(40, T_IN + 1, max(BATCH_SIZES) - 1) \
        .tolist()
    src = np.zeros((len(lengths), T_IN), np.int64)
    for b, L in enumerate(lengths):
        src[b, :L] = rng.integers(1, codes_hp.num_symbols, L)
    src = torch.from_numpy(src).to(device)
    lens = torch.tensor(lengths, device=device)
    hp = codes_hp.replace(decoder_early_stop=False)
    models = {"fused": make_model(hp, device),
              "plain": make_model(hp.replace(decoder_fused_inference=False,
                                             encoder_fused_inference=False),
                                  device)}

    def wall(model, B):
        _sync(device)
        t0 = time.perf_counter()
        out = model(Batch(src[:B], lens[:B]))
        _sync(device)
        return (time.perf_counter() - t0) * 1e3, out

    times, worst = {}, 0.0
    counts = {"fused_encode": 0, "fused_decode": 0}
    for B in BATCH_SIZES:
        outs, ms = {}, {}
        for name, model in models.items():
            wall(model, B)
            fe.fused_encode.launches = fd.fused_decode.launches = 0
            runs = [wall(model, B) for _ in range(3)]
            if name == "fused":
                counts["fused_encode"] += fe.fused_encode.launches // 3
                counts["fused_decode"] += fd.fused_decode.launches // 3
            ms[name] = statistics.median(r[0] for r in runs)
            outs[name] = runs[0][1]
        err = _max_err(outs["fused"].outputs, outs["plain"].outputs)
        same = torch.equal(outs["fused"].lengths, outs["plain"].lengths)
        worst = max(worst, err)
        # every row decodes every step; lengths only mask past the stop
        frames = B * hp.max_iters * hp.outputs_per_step
        times[B] = (ms["fused"], ms["plain"])
        log(f"phase 18 batched inference B={B}: fused {ms['fused']:.2f} ms "
            f"({ms['fused'] / B:.2f} ms an utterance, "
            f"{frames / ms['fused'] * 1e3:.1f} frames/s), plain "
            f"{ms['plain']:.2f} ms ({ms['plain'] / B:.2f} ms an utterance, "
            f"{frames / ms['plain'] * 1e3:.1f} frames/s); {frames} decoded "
            "frames; "
            f"logits max abs err {err:.2e}; equal lengths {same}")
        if err > TOL_BATCHED_SERVING or not same:
            raise AssertionError(f"batched fused serving disagrees at B={B}")
    log(f"phase 18 launch counts of one fused call at each batch, summed: "
        f"{counts}")
    if counts != {"fused_encode": 1, "fused_decode": len(BATCH_SIZES)}:
        raise AssertionError("batched inference did not launch the fused "
                             "decode once a call (and the encoder at B = 1)")
    return counts, times


def phase_row_timing(cases, vctk_timing, codes_timing, batched_times,
                     device):
    """Phase 19: the fused decode's time in each mode (median of 5 after a
    warm-up) beside its plain version's and its bound: B = 1 codes (phase
    8), the VCTK speaker row (phase 16), B = 8 codes, location-sensitive
    at B = 1 and 4, with B = 8's per-stage shares; and the training
    kernels at the VCTK shape.  Returns {mode: (ms, plain ms, bound)}."""
    from self_attention_tacotron_torch.ops import fused_decode as fd
    out = {"codes_b1": codes_timing["fused_decode"],
           "vctk_speaker_b1": vctk_timing["fused_decode"]}
    for name in ("codes_b8", "location_b1", "location_cumulative_b4"):
        model, (weights, memory, options) = cases[name]
        options = dict(options, early_stop=False)
        steps = model.hp.max_iters
        out[name] = (
            _time_ms(fd.prepare_decode(weights, memory, num_steps=steps,
                                       **options)),
            _time_ms(lambda: fd.fused_decode_reference(
                weights, memory, num_steps=steps, **options), reps=1),
            decode_bound(model.decoder.fused_params(), weights, memory,
                         steps))
    model, (weights, memory, options) = cases["codes_b8"]
    _stage_shares("fused_decode B=8", fd.prepare_decode(
        weights, memory, num_steps=model.hp.max_iters, profile=True,
        **dict(options, early_stop=False)), fd.DEC_STAGES,
        out["codes_b8"][0], model.hp.max_iters, "step", 19)
    b1 = out["codes_b1"][0]
    for name, (ms, plain, bound) in out.items():
        log(f"phase 19 fused_decode {name}: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {_bound_ms(bound):.4f} ms ({bound[0]} "
            f"bytes, {bound[1]} FLOPs); {ms / b1:.2f}x the B = 1 codes call")
    for name in ("fused_train_fwd", "fused_train_bwd"):
        ms, plain, bound = vctk_timing[name]
        log(f"phase 19 {name} at the VCTK shape: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound "
            f"{_bound_ms(bound, PEAK_3XTF32_FLOP_PER_S):.4f} ms")
    for B, (f_ms, p_ms) in batched_times.items():
        log(f"phase 19 batched serving B={B}: {f_ms / B:.3f} ms an "
            f"utterance fused, {p_ms / B:.3f} plain")
    return out


# ------------------------------------------------- the bf16 storage mode

def _time_turns(fns, reps: int = 5):
    """{name: median ms} of one call each, CUDA events, in turns (A B B A
    ...) after one warm-up each: versions compared in one call."""
    import torch
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    order = list(fns)
    for rep in range(reps):
        for name in (order if rep % 2 == 0 else order[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[name]()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: statistics.median(ts) for name, ts in times.items()}


def _bf16_decode_check(tag, got, ref):
    """The bf16 decode's statistics against its plain version: max abs over
    the first BF16_HEAD_STEPS steps, over all, the code-argmax agreement,
    finiteness; raises past the tolerances.  Returns the head error."""
    head = max(_max_err(g[:, :BF16_HEAD_STEPS], r[:, :BF16_HEAD_STEPS])
               for g, r in zip((got[0], got[1], *got[2]),
                               (ref[0], ref[1], *ref[2])))
    whole = max(_max_err(g, r) for g, r in zip((got[0], got[1], *got[2]),
                                               (ref[0], ref[1], *ref[2])))
    agree = float((got[0].argmax(-1) == ref[0].argmax(-1)).float().mean())
    finite = all(bool(t.isfinite().all()) for t in (got[0], got[1],
                                                    *got[2]))
    log(f"phase 20 fused_decode bf16 {tag}: max abs err first "
        f"{BF16_HEAD_STEPS} steps {head:.3e}, all steps {whole:.3e}; code "
        f"argmax agreement {agree:.4f}; finite {finite}")
    if head > TOL_BF16_DECODE_HEAD or agree < BF16_MIN_AGREE or not finite:
        raise AssertionError(f"bf16 fused_decode disagrees ({tag})")
    return head


def phase_bf16_decode(hp, model32, device):
    """Phase 20, serving: the bf16 decode kernel against its plain bf16
    version at the codes widths, B = 1 (early stop off and on) and the
    batched mode at the bf16 plan's capacity; B = 1 timed beside the f32
    kernel in turns.  Returns (worst head error, (ms, plain ms, bound))."""
    import numpy as np
    from self_attention_tacotron_torch.ops import fused_decode as fd
    model = make_model(hp.replace(decoder_fused_dtype=BF16), device)
    steps = hp.max_iters
    weights, memory, options = decoder_case(model, 50, T_IN, device)
    options = dict(options, early_stop=False)
    worst = _bf16_decode_check("B=1, early stop off", *_decode_pair(
        weights, memory, options, steps))
    head_b = weights.head_b.clone()
    head_b[weights.cr] += 5.0
    got, ref = _decode_pair(weights._replace(head_b=head_b), memory,
                            dict(options, early_stop=True), steps)
    n_got = _post_hoc_length(got[1], options["min_iters"])
    n_ref = _post_hoc_length(ref[1], options["min_iters"])
    tail_zero = bool((got[0][:, n_got:] == 0).all())
    log(f"phase 20 fused_decode bf16 early stop on: lengths kernel {n_got} "
        f"plain {n_ref}; zero after exit {tail_zero}")
    worst = max(worst, _bf16_decode_check("B=1, early stop on", got, ref))
    if n_got != n_ref or not tail_zero:
        raise AssertionError("bf16 early-stop decode disagrees")

    shape = dict(t_sizes=[T_IN] * len(memory.keys),
                 c_sizes=[v.shape[2] for v in memory.values],
                 num_steps=steps, num_heads=options["num_heads"])
    cap = fd.max_batch(weights, **shape)
    w32, mem32, opt32 = decoder_case(model32, T_IN, T_IN, device)
    cap32 = fd.max_batch(w32, **shape)
    rng = np.random.default_rng(SEED + 20)
    lengths = [T_IN] + rng.integers(40, T_IN + 1, cap - 1).tolist()
    wb, mb, ob = rows_case(model, lengths, T_IN, device, 20)
    ob = dict(ob, early_stop=False)
    worst = max(worst, _bf16_decode_check(
        f"batched B={cap} (the bf16 plan's capacity; f32's {cap32})",
        *_decode_pair(wb, mb, ob, steps)))

    w1, m1, o1 = decoder_case(model, T_IN, T_IN, device)
    o1 = dict(o1, early_stop=False)
    opt32 = dict(opt32, early_stop=False)
    ms = _time_turns({
        "bf16": fd.prepare_decode(w1, m1, num_steps=steps, **o1),
        "f32": fd.prepare_decode(w32, mem32, num_steps=steps, **opt32)})
    plain = _time_ms(lambda: fd.fused_decode_reference(
        w1, m1, num_steps=steps, **o1), reps=1)
    rows32 = rows_case(model32, lengths[:cap32], T_IN, device, 20)
    mb_ms = _time_turns({
        "bf16": fd.prepare_decode(wb, mb, num_steps=steps, **ob),
        "f32": fd.prepare_decode(*rows32[:2], num_steps=steps,
                                 **dict(rows32[2], early_stop=False))})
    params = model.decoder.fused_params()
    bound = decode_bound(params, w1, m1, steps, wbytes=2)
    b_bound = decode_bound(params, wb, mb, steps, wbytes=2)
    _stage_shares("fused_decode bf16 B=1", fd.prepare_decode(
        w1, m1, num_steps=steps, profile=True, **o1), fd.DEC_STAGES,
        ms["bf16"], steps, "step", 20)
    log(f"phase 20 timing fused_decode B=1 {steps} steps (in turns): bf16 "
        f"{ms['bf16']:.4f} ms, f32 {ms['f32']:.4f} ms; bf16 plain "
        f"{plain:.4f} ms; bf16 bound "
        f"{_bound_ms(bound, PEAK_BF16_FLOP_PER_S):.4f} ms ({bound[0]} "
        f"bytes, {bound[1]} FLOPs)")
    log(f"phase 20 timing fused_decode batched (in turns): bf16 B={cap} "
        f"{mb_ms['bf16']:.4f} ms ({mb_ms['bf16'] / cap:.3f} ms an "
        f"utterance), f32 B={cap32} {mb_ms['f32']:.4f} ms "
        f"({mb_ms['f32'] / cap32:.3f} ms an utterance); bf16 bound "
        f"{_bound_ms(b_bound, PEAK_BF16_FLOP_PER_S):.4f} ms ({b_bound[0]} "
        f"bytes, {b_bound[1]} FLOPs)")
    return worst, (ms["bf16"], plain, bound)


def phase_bf16_train(model32, device):
    """Phase 20, training: both kernels in the bf16 mode against their
    plain bf16 versions at B = 32, S = 256, masks on, each timed beside
    its f32 twin in turns.  Returns ({name: worst error}, {name: (ms,
    plain ms, bound)})."""
    import torch
    from self_attention_tacotron_torch.ops import fused_train as ft
    spec, params, keys, values, masks, tf, loc_ws, ops, _ = train_case(
        model32, device, False, 1, compute_dtype=BF16)
    spec32, _, _, _, _, _, _, ops32, _ = train_case(model32, device, False,
                                                    1)
    seed = 1234
    y, save, aux = ft.fused_train_fwd(spec, ops, seed)
    y_r, save_r, aux_r = ft.fused_train_fwd_reference(
        spec, params, keys, values, masks, tf, seed, None, loc_ws)
    torch.cuda.synchronize()
    f_errs = {"y": _max_err(y, y_r), "save": _max_err(save, save_r),
              "aux": _max_err(aux, aux_r)}
    log(f"phase 20 fused_train_fwd bf16 B={spec.batch} S={spec.num_steps} "
        "(masks on): max abs err " + ", ".join(
            f"{k} {v:.3e}" for k, v in f_errs.items()))
    if max(f_errs.values()) > TOL_BF16_TRAIN:
        raise AssertionError("bf16 fused_train_fwd disagrees")
    g = torch.randn(y.shape, generator=torch.Generator(device)
                    .manual_seed(7), device=device)
    kern = _kernel_grads(spec, ft.fused_train_bwd(spec, ops, seed, g, save,
                                                  aux))
    d_params, d_keys, d_values, _, d_loc = ft.fused_train_bwd_reference(
        spec, params, keys, values, masks, tf, seed, None, loc_ws, g, save_r,
        aux_r)
    plain = _grad_leaves(spec, d_params, d_keys, d_values, d_loc)
    torch.cuda.synchronize()
    rel = {k: _rel_err(kern[k], plain[k].reshape(kern[k].shape))
           for k in plain}
    absolute = max(_max_err(kern[k], plain[k].reshape(kern[k].shape))
                   for k in plain)
    name, err = max(rel.items(), key=lambda kv: kv[1])
    log(f"phase 20 fused_train_bwd bf16 vs the plain bf16 VJP: worst "
        f"gradient {name} {err:.3e} of its max magnitude, max abs err "
        f"{absolute:.3e}; " + ", ".join(f"{k} {v:.1e}"
                                        for k, v in sorted(rel.items())))
    if err > TOL_BF16_TRAIN_GRAD:
        raise AssertionError("bf16 fused_train_bwd disagrees")

    y32, save32, aux32 = ft.fused_train_fwd(spec32, ops32, seed)
    launches = {
        "fwd bf16": ft.prepare_train_fwd(spec, ops, seed),
        "fwd f32": ft.prepare_train_fwd(spec32, ops32, seed),
        "bwd bf16": ft.prepare_train_bwd(spec, ops, seed, g, save, aux),
        "bwd f32": ft.prepare_train_bwd(spec32, ops32, seed, g, save32,
                                        aux32)}
    ms = _time_turns(launches)
    fwd_plain = _time_ms(lambda: ft.fused_train_fwd_reference(
        spec, params, keys, values, masks, tf, seed, None, loc_ws), reps=1)
    bwd_plain = _time_ms(lambda: ft.fused_train_bwd_reference(
        spec, params, keys, values, masks, tf, seed, None, loc_ws, g, save,
        aux), reps=1)
    for kname, stages, key in (("fused_train_fwd", ft.FWD_STAGES, "fwd"),
                               ("fused_train_bwd", ft.BWD_STAGES, "bwd")):
        prof = (ft.prepare_train_fwd(spec, ops, seed, profile=True)
                if key == "fwd" else
                ft.prepare_train_bwd(spec, ops, seed, g, save, aux,
                                     profile=True))
        prof()
        torch.cuda.synchronize()
        log(f"phase 20 {kname} bf16 stages (us a step, block 0's clock split "
            "into copy, product, epilogue and barrier wait): "
            + ft.format_split(*ft.profile_split(
                prof.stage_cycles.cpu().tolist(), stages,
                len(spec.src_kinds), ms[f"{key} bf16"], spec.num_steps)))
    flat_in = ft._flat(ops)
    half = [*(t for wb in ops.prenet for t in wb), ops.att_w, ops.att_b,
            ops.q_w, ops.v, ops.op_w, ops.op_b, ops.l1_w, ops.l1_b,
            ops.l2_w, ops.l2_b, *ops.keys, *ops.values, ops.teacher]
    bwd = launches["bwd bf16"]
    bounds = {"fused_train_fwd": train_bound(spec, flat_in, [y, save, aux],
                                             False, half + [save]),
              "fused_train_bwd": train_bound(spec, flat_in + [g, save, aux],
                                             _leaves(bwd.outputs), True,
                                             half + [save])}
    bound_ms = {k: _bound_ms(b, PEAK_BF16_FLOP_PER_S)
                for k, b in bounds.items()}
    log(f"phase 20 timing (in turns, B={spec.batch}, S={spec.num_steps}): "
        f"fused_train_fwd bf16 {ms['fwd bf16']:.4f} ms, f32 "
        f"{ms['fwd f32']:.4f} ms (bf16 plain {fwd_plain:.4f} ms, bound "
        f"{bound_ms['fused_train_fwd']:.4f} ms); "
        f"fused_train_bwd bf16 {ms['bwd bf16']:.4f} ms, f32 "
        f"{ms['bwd f32']:.4f} ms (bf16 plain {bwd_plain:.4f} ms, bound "
        f"{bound_ms['fused_train_bwd']:.4f} ms); bound inputs "
        + "; ".join(f"{k} {b[0]} bytes, {b[1]} FLOPs"
                    for k, b in bounds.items()))
    errs = {"fused_train_fwd": max(f_errs.values()),
            "fused_train_bwd": absolute}
    timing = {"fused_train_fwd": (ms["fwd bf16"], fwd_plain,
                                  bounds["fused_train_fwd"]),
              "fused_train_bwd": (ms["bwd bf16"], bwd_plain,
                                  bounds["fused_train_bwd"])}
    return errs, timing


class _Fallbacks:
    """The warnings a run logs; ``refused`` holds those of a fused gate
    that refused its configuration (the decoder's "... does not cover this
    configuration — using the plain path: <reason>")."""

    def __enter__(self):
        import logging

        class Keep(logging.Handler):
            def __init__(self):
                super().__init__(logging.WARNING)
                self.messages = []

            def emit(self, record):
                self.messages.append(record.getMessage())
        self.handler = Keep()
        logging.getLogger().addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        import logging
        logging.getLogger().removeHandler(self.handler)

    @property
    def refused(self):
        return [m for m in self.handler.messages if "does not cover" in m]


def phase_bf16(hp, model32, device, data: str, tmp: str):
    """Phase 20: the bf16 storage mode.  Returns its rows of the kernels
    line and the launch counts of its two main paths."""
    d_err, d_timing = phase_bf16_decode(hp, model32, device)
    t_errs, t_timing = phase_bf16_train(model32, device)
    launches = {}
    with _Fallbacks() as fb:
        launches["bf16_serving"] = phase_end_to_end(
            model32, "cuda", hparams=f"decoder_fused_dtype={BF16}", phase=20)
        launches["bf16_training"] = phase_train_end_to_end(
            hp, data, tmp, "cuda",
            hparams=f"decoder_fused_train_dtype={BF16}", phase=20)
    log(f"phase 20 fallbacks logged: {fb.refused or 'none'}")
    if fb.refused:
        raise AssertionError("a fused gate refused the bf16 mode")
    if launches["bf16_serving"]["fused_decode"] != 3:
        raise AssertionError("bf16 serving did not launch fused_decode once "
                             "an utterance")
    rows = _kernel_rows("fused_decode", "fused_decode", "fused_decode.py:250",
                        {"bf16_serving": launches["bf16_serving"]}, d_err,
                        *d_timing, peak_flops=PEAK_BF16_FLOP_PER_S)
    for name, line in (("fused_train_fwd", 375), ("fused_train_bwd", 667)):
        rows += _kernel_rows(name, name, f"fused_train.py:{line}",
                             {"bf16_training": launches["bf16_training"]},
                             t_errs[name], *t_timing[name],
                             peak_flops=PEAK_BF16_FLOP_PER_S)
    return rows, launches


# ------------- forced alignment, the SIWIS recipe and the kernels' gates

SIWIS_RECIPE = os.path.join(ROOT, "examples", "codes_siwis",
                            "self-attention-tacotron.json")
SIWIS_SPEAKER = 3           # the last of the recipe's 4-speaker table
FORCED = "use_forced_alignment_mode=true"
PLAIN = "decoder_fused_inference=false,encoder_fused_inference=false"
# the forced-alignment .mfbsp against the same predict step on the plain
# path: one-hot codes (exact up to 1e-5), raw mel frames fed back (1e-4)
TOL_FORCED_CODES = 1e-5
TOL_FORCED_MEL = TOL_MEL_DECODE
# the kernels' earlier edges: source lengths at the recipe's encoder
# widths (the hop's rows in shared memory up to 533), Pallas head widths
# (the tensor-core templates up to 128, the step's registers up to 256),
# n_fft (num_freq 1025: the FFT, 1000: the direct DFT)
EDGE_LENGTHS = (533, 534, 600)
EDGE_HEAD_DIMS = (128, 129, 257)
EDGE_PROFILED = (533, 534)   # #1's profiled split: resident, then streamed
WIDE_STEP_TIMED = (3000, 512)   # (S, D) of the wide step timed alone
WIDE_TIMED = (8, 256, 256)   # (B, T, D) of the wide kernel timed alone
EDGE_NUM_FREQS = (1025, 1000)


def _forced_batches(hp, data, keys, kind, device):
    """(utterance, batch) as cli.predict builds them with the flag on: the
    target padded to its bucket's length."""
    from self_attention_tacotron_torch.data.dataset import (Bucketing,
                                                            iter_utterances,
                                                            pad_batch,
                                                            to_model_batch)
    bucketing = Bucketing(hp)
    for u in iter_utterances(*_val_files(hp, data, keys), hp, kind):
        pad = bucketing.target_pad_length(bucketing.bucket_id(
            u.target_length))
        yield u, to_model_batch(pad_batch([u], hp, pad,
                                          target_kind=kind)).to(device)


def _forced_reference(hp_args, ckpt, data, keys, kind, out, device):
    """The served run against the plain path, utterance by utterance: the
    same predict step run in this process with the served hparams (the
    kernels) and with the fused gates off.  Returns ({what: largest abs
    error}, the plain run's (first, second) pass steps): "mfbsp" the
    served dump against the plain payload; "first outputs" and "first
    alignments" the first pass over its decoded steps (past its stop the
    rows are the path's own, which the forced pass replays); "forced
    logits" the second pass's outputs, whole."""
    import numpy as np
    from self_attention_tacotron_torch.config import load_hparams
    from self_attention_tacotron_torch.models import tacotron_model_factory
    from self_attention_tacotron_torch.parallel import make_predict_step
    from self_attention_tacotron_torch.utils.convert import load_checkpoint

    runs = {}
    for name, hparams in (("served", hp_args[1]),
                          ("plain", _join(hp_args[1], PLAIN))):
        class Args:
            hparam_json_file = hp_args[0]
        Args.hparams = hparams
        hp = load_hparams(Args())
        model = tacotron_model_factory(hp).eval()
        load_checkpoint(model, ckpt)
        runs[name] = (hp, model.to(device), make_predict_step(hp))
    errs = dict.fromkeys(("mfbsp", "first outputs", "first alignments",
                          "forced logits"), 0.0)
    steps = []
    hp = runs["plain"][0]
    for u, batch in _forced_batches(hp, data, keys, kind, device):
        (first, forced), (first_s, forced_s) = (
            step(model, batch) for _, model, step in
            (runs["plain"], runs["served"]))
        n = int(forced.lengths[0]) * hp.outputs_per_step
        frames = (forced.code_output if kind == "codes"
                  else forced.postnet_outputs if hp.use_postnet_v2
                  else forced.outputs)
        payload = frames[0, :n].cpu().numpy().reshape(-1)
        dump = np.fromfile(os.path.join(
            out, f"{u.meta.key}.{hp.predicted_mel_extension}"), "<f4")
        if dump.shape != payload.shape or not np.isfinite(dump).all():
            raise AssertionError(f"bad forced-alignment dump for "
                                 f"{u.meta.key}")
        s = int(first.lengths[0])
        if int(first_s.lengths[0]) != s:
            raise AssertionError(f"{u.meta.key}: the first passes stop at "
                                 f"{int(first_s.lengths[0])} and {s} steps")
        f = s * hp.outputs_per_step
        found = {"mfbsp": float(np.abs(dump - payload).max()),
                 "first outputs": _max_err(first_s.outputs[:, :f],
                                           first.outputs[:, :f]),
                 "first alignments": max(
                     _max_err(a[..., :s], b[..., :s]) for a, b in
                     zip(first_s.alignments, first.alignments)),
                 "forced logits": _max_err(forced_s.outputs,
                                           forced.outputs)}
        errs = {k: max(v, found[k]) for k, v in errs.items()}
        steps.append((s, int(forced.lengths[0])))
    return errs, steps


def _predict_forced(main, data, ckpt, hp_json, hparams, out, device):
    """``main`` (main_code or main_mel) with the flag on; returns each
    utterance's (first pass steps, second pass steps, wall ms)."""
    import contextlib
    import io
    import re
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["--source-data-root", data, "--target-data-root", data,
                   "--checkpoint-dir", ckpt, "--output-dir", out,
                   "--hparam-json-file", hp_json, "--hparams", hparams,
                   "--device", device.type])
    sys.stdout.write(buf.getvalue())
    if rc != 0:
        raise AssertionError(f"{main.__name__} returned {rc}")
    return [(int(a), int(n), float(ms)) for n, a, ms in re.findall(
        r"predicted \S+: (\d+) decode steps \(forced-alignment pass after "
        r"(\d+) free-running steps\), ([0-9.]+) ms", buf.getvalue())]


def phase_forced_alignment(model, mel_data, mel_ckpt, mel_hp, tmp, device):
    """Phase 21: forced-alignment prediction through cli.predict at full
    width: the codes recipe (first pass through #1 and #2, second the plain
    VALIDATION loop, whose encoder call is #1 again), then the mel recipe
    on phase 14's records and phase 15's checkpoint (first pass through
    #2); each .mfbsp against the same predict step on the plain path.
    Returns the launch counts of the two paths."""
    from self_attention_tacotron_torch.cli.predict import main_code, main_mel
    from self_attention_tacotron_torch.data.dataset import load_key_list
    from self_attention_tacotron_torch.ops import fused_decode as fd
    from self_attention_tacotron_torch.ops import fused_encoder as fe
    from self_attention_tacotron_torch.utils.convert import save_checkpoint
    data, ckpt = (os.path.join(tmp, d) for d in ("forced_data",
                                                  "forced_ckpt"))
    os.makedirs(data)
    keys = write_corpus(model.hp, data)
    save_checkpoint(model, ckpt, step=1)
    launches = {}
    # the .mfbsp (one-hot codes, or mel frames) and the passes' numbers
    cases = (("forced_alignment", main_code, "codes", data, ckpt, RECIPE,
              FORCED, keys, (TOL_FORCED_CODES, TOL_DECODE)),
             ("mel_forced_alignment", main_mel, "mel", mel_data, mel_ckpt,
              mel_hp, _join(FORCED, MEL_SERVE_FUSED),
              load_key_list(os.path.join(mel_data, "test.csv")),
              (TOL_FORCED_MEL, TOL_FORCED_MEL)))
    for path, main, kind, d, c, hp_json, hparams, ks, tols in cases:
        out = os.path.join(tmp, f"{path}_pred")
        fe.fused_encode.launches = 0
        fd.fused_decode.launches = 0
        served = _predict_forced(main, d, c, hp_json, hparams, out, device)
        launches[path] = {"fused_encode": fe.fused_encode.launches,
                          "fused_decode": fd.fused_decode.launches}
        errs, plain_steps = _forced_reference(
            (hp_json, hparams), c, d, ks, kind, out, device)
        tol = {k: tols[0] if k == "mfbsp" else tols[1] for k in errs}
        log(f"phase 21 {path}: {main.__name__} --hparams '{hparams}' served "
            f"{len(served)} utterances (first pass steps, forced pass "
            f"steps, wall ms) {served}; the plain path's steps "
            f"{plain_steps}; launch counts {launches[path]}; served vs the "
            "plain path max abs err " + ", ".join(
                f"{k} {v:.3e} (tol {tol[k]:g})" for k, v in errs.items()))
        if len(served) != len(ks) or [s[:2] for s in served] != plain_steps:
            raise AssertionError(f"{path}: the passes' steps disagree with "
                                 "the plain path")
        if any(v > tol[k] for k, v in errs.items()):
            raise AssertionError(f"{path}: the served passes disagree with "
                                 "the plain path")
    want = {"forced_alignment": {"fused_encode": 2 * len(keys),
                                 "fused_decode": len(keys)},
            "mel_forced_alignment": {"fused_encode": 0,
                                     "fused_decode": len(cases[1][7])}}
    if device.type == "cuda" and launches != want:
        raise AssertionError(f"forced alignment launched {launches}, "
                             f"expected {want}")
    return launches


def forced_rows(launches, errs, codes_timing, mel_rows):
    """The kernels line's rows of phase 21's paths, with the times of the
    shapes they share: the codes recipe's #1 and #2 (phase 8) and the mel
    recipe's #2 (phase 15)."""
    codes = {"forced_alignment": launches["forced_alignment"]}
    rows = [*_kernel_rows("fused_encode", "fused_encoder",
                          "fused_encoder.py:94", codes, errs["fused_encode"],
                          *codes_timing["fused_encode"],
                          peak_flops=PEAK_3XTF32_FLOP_PER_S),
            *_kernel_rows("fused_decode", "fused_decode",
                          "fused_decode.py:250", codes, errs["fused_decode"],
                          *codes_timing["fused_decode"])]
    counts = launches["mel_forced_alignment"]
    rows += [dict(row, path="mel_forced_alignment",
                  launches=counts["fused_decode"])
             for row in mel_rows if row["name"] == "fused_decode"
             and counts["fused_decode"]]
    return rows


def _siwis_batch(hp, device):
    """B = 1: a 64-phone source and speaker ``SIWIS_SPEAKER``."""
    import torch
    from self_attention_tacotron_torch.models import Batch
    return Batch(source_ids(hp, T_IN, T_IN, SEED + 7, device),
                 torch.tensor([T_IN], device=device),
                 speaker_id=torch.tensor([SIWIS_SPEAKER], device=device))


def _siwis_call(hp, model, device):
    """One INFERENCE call of the SIWIS recipe; returns (output, host-clock
    ms)."""
    import torch
    batch = _siwis_batch(hp, device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model(batch)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_siwis(device, card: str):
    """Phase 22: the SIWIS recipe at full width with weights from seed 0,
    early stop off so that all 3000 steps run, speaker 3 of its table: one
    call in the fused mode (#1, #2) and one in the Pallas mode (#5, #6),
    each with its counters zeroed just before; the two calls' logits and
    stop logits compared over all 3000 steps; #1, #2 and #6 timed at these
    shapes
    beside their plain versions and bounds.  Returns (rows, launches)."""
    import torch
    import torch.nn.functional as F
    from self_attention_tacotron_torch.config import default_hparams
    from self_attention_tacotron_torch.ops import fused_decode as fd
    from self_attention_tacotron_torch.ops import fused_encoder as fe
    from self_attention_tacotron_torch.ops import pallas_attention as pa
    hp = default_hparams().parse_json_file(SIWIS_RECIPE).parse(
        "decoder_early_stop=false")
    steps = hp.max_iters
    models = {"fused": make_model(hp, device),
              "pallas": make_model(default_hparams().parse_json_file(
                  SIWIS_RECIPE).parse(_join("decoder_early_stop=false",
                                            PALLAS_SERVING)), device)}
    launches, outs, wall, refused = {}, {}, {}, {}
    for mode, path in (("fused", "siwis_serving"),
                       ("pallas", "siwis_pallas_serving")):
        for counter in (fe.fused_encode, fd.fused_decode,
                        pa.fused_self_attention,
                        pa.incremental_attention_step):
            counter.launches = 0
        with _Fallbacks() as fb:
            outs[mode], wall[mode] = _siwis_call(hp, models[mode], device)
        refused[mode] = fb.refused
        launches[path] = {c.__name__: c.launches for c in (
            fe.fused_encode, fd.fused_decode, pa.fused_self_attention,
            pa.incremental_attention_step) if c.launches}
    whole = max(_max_err(outs["fused"].outputs, outs["pallas"].outputs),
                _max_err(outs["fused"].stop_token,
                         outs["pallas"].stop_token))
    finite = all(bool(o.outputs.isfinite().all()) for o in outs.values())
    log(f"phase 22 SIWIS {os.path.basename(SIWIS_RECIPE)} B=1 T={T_IN} "
        f"speaker {SIWIS_SPEAKER} {steps} steps (early stop off), card "
        f"{card}: fused mode {wall['fused']:.1f} ms wall, launches "
        f"{launches['siwis_serving']}, gate refusals "
        f"{refused['fused'] or 'none'}; Pallas mode {wall['pallas']:.1f} ms "
        f"wall, launches {launches['siwis_pallas_serving']}, gate refusals "
        f"{refused['pallas'] or 'none'}; logits and stop logits fused vs "
        f"Pallas max abs err {whole:.3e} over all {steps} steps; finite "
        f"{finite}")
    if refused["pallas"] or not finite or whole > TOL_PALLAS_SERVING:
        raise AssertionError("SIWIS serving disagrees between the modes")
    if device.type == "cuda" and (
            launches["siwis_pallas_serving"] != {
                "fused_self_attention": hp.self_attention_num_hop,
                "incremental_attention_step":
                    steps * hp.decoder_self_attention_num_hop}
            or launches["siwis_serving"].get("fused_encode") != 1
            or launches["siwis_serving"].get("fused_decode", 0)
            != int(not refused["fused"])):
        raise AssertionError(f"SIWIS serving launched {launches}")

    # the kernels at these shapes
    model = models["fused"]
    params, x, kw = encoder_case(model, T_IN, T_IN, device)
    enc_ms = _time_ms(fe.prepare_encode(params, x, T_IN, **kw))
    enc_plain = _time_ms(lambda: fe.fused_encode_reference(params, x, T_IN,
                                                           **kw))
    enc_err = max(_max_err(g, r) for g, r in zip(
        fe.fused_encode(params, x, T_IN, **kw),
        fe.fused_encode_reference(params, x, T_IN, **kw)))
    sources, lengths, _, speaker = model._encode(_siwis_batch(hp, device))
    dec = model.decoder
    packs = tuple(m.precompute(s, n) for m, s, n in
                  zip(dec.attention_mechanisms, sources, lengths))
    rows = []
    if not refused["fused"]:
        weights, memory, options = dec.fused_inputs(
            packs, model._prenet_speaker(speaker))
        options = dict(options, early_stop=False)
        got, ref = _decode_pair(weights, memory, options, steps)
        dec_err = max(_max_err(got[0], ref[0]), _max_err(got[1], ref[1]))
        dec_ms = _time_ms(fd.prepare_decode(weights, memory, num_steps=steps,
                                            **options))
        dec_plain = _time_ms(lambda: fd.fused_decode_reference(
            weights, memory, num_steps=steps, **options), reps=1)
        dec_bound = decode_bound(dec.fused_params(), weights, memory, steps,
                                 options["speaker_row"])
        log(f"phase 22 fused_decode at the SIWIS shape (B=1, T={T_IN}, "
            f"{steps} steps, speaker row): max abs err vs plain "
            f"{dec_err:.3e} over all steps (logits and stop logits; the "
            f"hop over {-(-steps // 32)} cache chunks); kernel {dec_ms:.4f} "
            f"ms, plain {dec_plain:.4f} ms; bound {_bound_ms(dec_bound):.4f}"
            f" ms ({dec_bound[0]} bytes, {dec_bound[1]} FLOPs); card {card}")
        if dec_err > TOL_DECODE:
            raise AssertionError("fused_decode disagrees at the SIWIS shape")
        rows += _kernel_rows("fused_decode", "fused_decode",
                             "fused_decode.py:250",
                             {"siwis_serving": launches["siwis_serving"]},
                             dec_err, dec_ms, dec_plain, dec_bound)
    rows += _kernel_rows("fused_encode", "fused_encoder",
                         "fused_encoder.py:94",
                         {"siwis_serving": launches["siwis_serving"]},
                         enc_err, enc_ms, enc_plain,
                         encode_bound(params, x, kw),
                         peak_flops=PEAK_3XTF32_FLOP_PER_S)
    t = steps - 1
    q, kc, vc = _step_inputs(device, 1, t, steps)
    mask = torch.ones(1, 1, 1, steps, dtype=torch.bool, device=device)
    step_err = _max_err(pa.incremental_attention_step(q, kc, vc, t),
                        pa.incremental_attention_step_reference(q, kc, vc, t))
    step_times = [_device_ms(fn) for fn in (
        lambda: pa.incremental_attention_step(q, kc, vc, t),
        lambda: pa.incremental_attention_step_reference(q, kc, vc, t),
        lambda: F.scaled_dot_product_attention(q[:, :, None], kc, vc,
                                               attn_mask=mask))]
    bound = step_bound(1, t)
    log(f"phase 22 incremental_attention_step B=1 H={ATTN_HEADS} S={steps} "
        f"D={ATTN_D} t={t}: max abs err {step_err:.3e}; kernel "
        f"{step_times[0]:.5f} ms, plain {step_times[1]:.5f} ms, SDPA "
        f"{step_times[2]:.5f} ms; bound {_bound_ms(bound):.6f} ms "
        f"({bound[0]} bytes, {bound[1]} FLOPs); card {card}")
    if step_err > TOL_ATTENTION:
        raise AssertionError("incremental_attention_step disagrees at S = "
                             f"{steps}")
    q, k, v = _attention_inputs(device, 1, T_IN, 16)
    att_err = _max_err(pa.fused_self_attention(q, k, v),
                       pa.fused_self_attention_reference(q, k, v))
    att_times = [_device_ms(fn) for fn in (
        lambda: pa.fused_self_attention(q, k, v),
        lambda: pa.fused_self_attention_reference(q, k, v),
        lambda: F.scaled_dot_product_attention(q, k, v))]
    pallas = {"siwis_pallas_serving": launches["siwis_pallas_serving"]}
    rows += _kernel_rows("incremental_attention_step",
                         "incremental_attention", "pallas_attention.py:109",
                         pallas, step_err, *step_times[:2], bound,
                         step_times[2])
    rows += _kernel_rows("fused_self_attention", "self_attention",
                         "pallas_attention.py:39", pallas, att_err,
                         *att_times[:2], attention_bound(1, T_IN, 16, False),
                         att_times[2], peak_flops=PEAK_3XTF32_FLOP_PER_S)
    return rows, launches


def phase_edges(model, device, card: str):
    """Phase 23: the kernels past the edges of their earlier plans, each
    served once through its caller with every counter zeroed just before
    and held against the plain path: the codes recipe's encoder at T = 533
    (the hop's rows in shared memory), 534 and 600 (streamed); the Pallas
    mode's hop at head widths 128, 129 (the full sequence's wide kernel)
    and 257 (both wide kernels), the full sequence and 64 cache steps;
    MelExtractor at n_fft 2048 (the FFT) and 1998 (the direct DFT) against
    the plain version in float64 (``plain_spectrograms_f64``).  Then
    each new branch timed beside its plain version, bound and library
    call.  Returns (rows, launch counts) of path ``long_and_wide``."""
    import torch
    import torch.nn.functional as F
    from self_attention_tacotron_torch.ops import attention_core as ac
    from self_attention_tacotron_torch.ops import fused_encoder as fe
    from self_attention_tacotron_torch.ops import pallas_attention as pa
    from self_attention_tacotron_torch.ops import stft
    from self_attention_tacotron_torch.ops.stft import MelExtractor
    enc = model.encoder
    step = pa.incremental_attention_step
    counters = {"fused_encode": (fe.fused_encode, "launches"),
                "fused_self_attention": (pa.fused_self_attention,
                                         "launches"),
                "incremental_attention_step": (step, "launches"),
                "incremental_attention_step_wide": (step, "launches_wide"),
                "spectrogram": (stft.spectrograms, "launches")}  # rows' names
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    errs = {}
    for T in EDGE_LENGTHS:
        x = model.embedding(source_ids(model.hp, T, T, SEED + T, device))
        lengths = torch.tensor([T], device=device)
        before = fe.fused_encode.launches
        got = enc(x, lengths)
        launched = fe.fused_encode.launches - before
        enc.fused_inference = False
        ref = enc(x, lengths)
        enc.fused_inference = True
        err = max(_max_err(g, r) for g, r in zip(got[:2], ref[:2]))
        errs["fused_encode"] = max(errs.get("fused_encode", 0.0), err)
        streams = fe.hop_streams(T, enc.cbhg_out_units // 2,
                                 enc.self_attention_out_units)
        log(f"phase 23 encoder T={T}: fused_encode launches {launched} "
            f"(hop {'streamed' if streams else 'in shared memory'}); vs the "
            f"module path max abs err {err:.3e}; card {card}")
        if launched != 1 or err > TOL_ENCODE or streams != (T > 533):
            raise AssertionError(f"the encoder at T = {T}")
    for D in EDGE_HEAD_DIMS:
        torch.manual_seed(D)
        mha = ac.MultiHeadAttention(2 * D, 2, use_subsequent_mask=True,
                                    use_pallas=True).to(device).eval()
        ref = ac.MultiHeadAttention(2 * D, 2, use_subsequent_mask=True).to(
            device).eval()
        ref.load_state_dict(mha.state_dict())
        x = _normal(device, 1, T_IN, 2 * D, seed=D)
        before = (pa.fused_self_attention.launches, step.launches,
                  step.launches_wide)
        err = _max_err(mha(x, x, x)[0], ref(x, x, x)[0])
        cache = mha.init_cache(1, T_IN, device)
        cache_r = ref.init_cache(1, T_IN, device)
        for t in range(T_IN):
            y, cache, _ = mha.step(x[:, t], t, cache)
            y_r, cache_r, _ = ref.step(x[:, t], t, cache_r)
            err = max(err, _max_err(y, y_r))
        counts = (pa.fused_self_attention.launches - before[0],
                  step.launches - before[1], step.launches_wide - before[2])
        wide = D > pa.STEP_MAX_D
        step_name = ("incremental_attention_step_wide" if wide
                     else "incremental_attention_step")
        for name in ("fused_self_attention", step_name):
            errs[name] = max(errs.get(name, 0.0), err)
        log(f"phase 23 Pallas-mode hop D={D} (sa_units {2 * D}, 2 heads), "
            f"T={T_IN}: launches fused_self_attention {counts[0]}, "
            f"incremental_attention_step {counts[1]} (its wide kernel "
            f"{counts[2]}); vs the einsum path max abs err {err:.3e}")
        if (counts != ((1, 0, T_IN) if wide else (1, T_IN, 0))
                or err > TOL_ATTENTION):
            raise AssertionError(f"the Pallas-mode hop at D = {D}")
    hp = _audio_hparams(MEL_RECIPE)
    y = _wave(10 * hp.sample_rate, hp.sample_rate, seed=23)
    for num_freq in EDGE_NUM_FREQS:
        args = (hp.sample_rate, num_freq, hp.num_mels, hp.frame_length_ms,
                hp.frame_shift_ms, hp.ref_level_db)
        before = stft.spectrograms.launches
        got = MelExtractor(*args, device=device).spectrograms(y)
        launched = stft.spectrograms.launches - before
        ref = plain_spectrograms_f64(MelExtractor(*args, device="cpu"), y)
        spec = [spec_errors(g.cpu().T + hp.ref_level_db,
                            r.T + hp.ref_level_db) for g, r in zip(got, ref)]
        n_fft = (num_freq - 1) * 2
        errs["spectrogram"] = max(errs.get("spectrogram", 0.0),
                                  *(d for _, d in spec))
        log(f"phase 23 MelExtractor n_fft={n_fft} (10 s, "
            f"{'FFT' if stft.takes_fft(n_fft) else 'direct DFT'}): "
            f"spectrogram launches {launched}; vs the plain version in "
            f"float64 on the CPU (magnitude / peak, dB) {spec}")
        if launched != 1 or any(m > TOL_SPEC_MAG or d > TOL_SPEC_DB
                                for m, d in spec):
            raise AssertionError(
                f"the spectrogram at n_fft = {n_fft}: launches {launched}, "
                f"(magnitude / peak, dB) errors {spec} against tolerances "
                f"{TOL_SPEC_MAG} and {TOL_SPEC_DB}")
    launches = {"long_and_wide": {name: getattr(fn, attr)
                                  for name, (fn, attr) in counters.items()}}

    # the new branches timed: the streamed hop, both wide kernels, the DFT
    params, x, kw = encoder_case(model, EDGE_LENGTHS[-1], EDGE_LENGTHS[-1],
                                 device)
    T = EDGE_LENGTHS[-1]
    enc_ms = {t: _time_ms(fe.prepare_encode(*encoder_case(
        model, t, t, device)[:2], t, **kw)) for t in EDGE_LENGTHS}
    enc_plain = _time_ms(lambda: fe.fused_encode_reference(params, x, T,
                                                           **kw), reps=1)
    enc_bound = encode_bound(params, x, kw)
    enc_bound_ms = _bound_ms(enc_bound, PEAK_3XTF32_FLOP_PER_S)
    edge_bounds = {t: _bound_ms(encode_bound(*encoder_case(model, t, t,
                                                           device)),
                                PEAK_3XTF32_FLOP_PER_S)
                   for t in EDGE_LENGTHS}
    log("phase 23 fused_encode at T = " + ", ".join(
        f"{t}: {ms:.4f} ms (bound {edge_bounds[t]:.4f} ms)"
        for t, ms in enc_ms.items()) + f"; plain at T = "
        f"{T} {enc_plain:.4f} ms; bound at T = {T} {enc_bound_ms:.4f} ms "
        f"({enc_bound[0]} bytes, {enc_bound[1]} FLOPs); card {card}")
    for t in EDGE_PROFILED:   # the hop resident, then streamed
        prof = fe.prepare_encode(*encoder_case(model, t, t, device)[:2], t,
                                 **kw, profile=True)
        prof()
        torch.cuda.synchronize()
        log(f"phase 23 fused_encode T={t} stages, one profiled launch "
            f"scaled to {enc_ms[t]:.4f} ms (us): " + fe.format_split(
                fe.profile_split(prof.stage_cycles.cpu().tolist(),
                                 enc_ms[t])) + f"; card {card}")
    rows = _kernel_rows("fused_encode", "fused_encoder",
                        "fused_encoder.py:94", launches,
                        errs["fused_encode"], enc_ms[T], enc_plain,
                        enc_bound, peak_flops=PEAK_3XTF32_FLOP_PER_S)
    Dw = EDGE_HEAD_DIMS[1]
    q, k, v = _attention_inputs(device, 1, T_IN, Dw)
    att = [_device_ms(fn) for fn in (
        lambda: pa.fused_self_attention(q, k, v, True),
        lambda: pa.fused_self_attention_reference(q, k, v, True),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))]
    att_bound = attention_bound(1, T_IN, Dw, True)
    Ds, t = EDGE_HEAD_DIMS[2], SERVE_S - 1
    qs, kc, vc = _step_inputs(device, 1, t, SERVE_S, Ds)
    # the narrow kernel one column narrower, on the same cache
    qn, kn, vn = (x[..., :pa.STEP_MAX_D].contiguous() for x in (qs, kc, vc))
    step_turns = in_turns({
        "wide": lambda: pa.incremental_attention_step(qs, kc, vc, t),
        "narrow": lambda: pa.incremental_attention_step(qn, kn, vn, t)}, 4)
    stp, nar = ([statistics.median(step_turns[name])] + [
        _device_ms(fn) for fn in (
            lambda: pa.incremental_attention_step_reference(q_, k_, v_, t),
            lambda: F.scaled_dot_product_attention(q_[:, :, None], k_, v_))]
        for name, (q_, k_, v_) in (("wide", (qs, kc, vc)),
                                   ("narrow", (qn, kn, vn))))
    stp_bound = step_bound(1, t, Ds)
    nar_bound = step_bound(1, t, pa.STEP_MAX_D)
    log(f"phase 23 wide kernels: fused_self_attention B=1 H={ATTN_HEADS} "
        f"T={T_IN} D={Dw} causal {att[0]:.5f} ms (plain {att[1]:.5f}, SDPA "
        f"{att[2]:.5f}, bound "
        f"{_bound_ms(att_bound, PEAK_3XTF32_FLOP_PER_S):.6f} at the 3xTF32 "
        f"rate); incremental_attention_step S={SERVE_S} D={Ds} t={t} "
        f"{stp[0]:.5f} ms (plain {stp[1]:.5f}, SDPA {stp[2]:.5f}, bound "
        f"{_bound_ms(stp_bound):.6f}), in turns with the narrow kernel at "
        f"D={pa.STEP_MAX_D} {nar[0]:.5f} ms (medians of "
        f"{len(step_turns['wide'])} rounds: wide "
        f"{' '.join(f'{x:.5f}' for x in step_turns['wide'])}, narrow "
        f"{' '.join(f'{x:.5f}' for x in step_turns['narrow'])}; its plain "
        f"{nar[1]:.5f}, SDPA {nar[2]:.5f}, bound "
        f"{_bound_ms(nar_bound):.6f}); card {card}")
    # the wide kernel at the SIWIS cache length and 512 columns
    S3, D3 = WIDE_STEP_TIMED
    q3, k3, v3 = _step_inputs(device, 1, S3 - 1, S3, D3)
    err3 = _max_err(pa.incremental_attention_step(q3, k3, v3, S3 - 1),
                    pa.incremental_attention_step_reference(q3, k3, v3,
                                                            S3 - 1))
    wide3 = [_device_ms(fn, reps=20) for fn in (
        lambda: pa.incremental_attention_step(q3, k3, v3, S3 - 1),
        lambda: pa.incremental_attention_step_reference(q3, k3, v3, S3 - 1),
        lambda: F.scaled_dot_product_attention(q3[:, :, None], k3, v3))]
    bound3 = step_bound(1, S3 - 1, D3)
    log(f"phase 23 incremental_attention_step B=1 H={ATTN_HEADS} S={S3} "
        f"t={S3 - 1} D={D3} (the wide kernel, plan "
        f"{tuple(pa.step_plan_wide(ATTN_HEADS, S3 - 1, D3))}): max abs err "
        f"{err3:.3e} against the plain version; kernel {wide3[0]:.5f} ms, "
        f"plain {wide3[1]:.5f} ms, SDPA {wide3[2]:.5f} ms; bound "
        f"{_bound_ms(bound3):.6f} ms ({bound3[0]} bytes); card {card}")
    if err3 > TOL_ATTENTION or max(errs["incremental_attention_step_wide"],
                                   errs["incremental_attention_step"]) \
            > TOL_ATTENTION:
        raise AssertionError(f"the wide step at S = {S3}, D = {D3} "
                             f"disagrees (tol {TOL_ATTENTION})")
    log(f"phase 23 fused_self_attention B=1 D={Dw} causal "
        + attention_split(pa, q, k, v, True, att[0]) + f"; card {card}")
    # the wide kernel at the training-like shape where it lost to SDPA
    Bw, Tw, Dw2 = WIDE_TIMED
    qw, kw_, vw = _attention_inputs(device, Bw, Tw, Dw2)
    err = _max_err(pa.fused_self_attention(qw, kw_, vw),
                   pa.fused_self_attention_reference(qw, kw_, vw))
    wide = [_device_ms(fn, reps=20) for fn in (
        lambda: pa.fused_self_attention(qw, kw_, vw),
        lambda: pa.fused_self_attention_reference(qw, kw_, vw),
        lambda: F.scaled_dot_product_attention(qw, kw_, vw))]
    wide_bound = attention_bound(Bw, Tw, Dw2, False)
    log(f"phase 23 fused_self_attention B={Bw} H={ATTN_HEADS} T={Tw} "
        f"D={Dw2}: max abs err {err:.3e} against the plain version; kernel "
        f"{wide[0]:.5f} ms, plain {wide[1]:.5f} ms, SDPA {wide[2]:.5f} ms; "
        f"bound {_bound_ms(wide_bound, PEAK_3XTF32_FLOP_PER_S):.6f} ms "
        f"({wide_bound[0]} bytes, {wide_bound[1]} FLOPs at the 3xTF32 rate)"
        f"; " + attention_split(pa, qw, kw_, vw, False, wide[0])
        + f"; card {card}")
    if err > TOL_ATTENTION:
        raise AssertionError(f"the wide kernel at B = {Bw}, T = {Tw}, D = "
                             f"{Dw2} disagrees (tol {TOL_ATTENTION})")
    rows += _kernel_rows("fused_self_attention", "self_attention",
                         "pallas_attention.py:39", launches,
                         errs["fused_self_attention"], *att[:2], att_bound,
                         att[2], peak_flops=PEAK_3XTF32_FLOP_PER_S)
    rows += _kernel_rows("incremental_attention_step",
                         "incremental_attention", "pallas_attention.py:109",
                         launches, errs["incremental_attention_step"],
                         *nar[:2], nar_bound, nar[2])
    rows += _kernel_rows("incremental_attention_step_wide",
                         "incremental_attention", "pallas_attention.py:109",
                         launches, errs["incremental_attention_step_wide"],
                         *stp[:2], stp_bound, stp[2])
    num_freq = EDGE_NUM_FREQS[1]
    ex = MelExtractor(hp.sample_rate, num_freq, hp.num_mels,
                      hp.frame_length_ms, hp.frame_shift_ms,
                      hp.ref_level_db, device=device)
    ys = ex.signal(y)
    turns = in_turns({
        "kernel": lambda: stft.spectrograms(ys, ex.plan),
        "plain": lambda: stft.spectrograms_plain(ys, ex.plan),
        "library": lambda: library_spectrograms(ex, ys)}, 4)
    spec_t = [statistics.median(turns[n])
              for n in ("kernel", "plain", "library")]
    spec_bound = spectrogram_bound(ys.shape[0], ex.plan,
                                   1 + ys.shape[0] // ex.hop_length)
    s_lo, s_hi = stft.folded_taps(ex.n_fft, ex.plan.support)
    frames = 1 + ys.shape[0] // ex.hop_length
    products = 2 * frames * (s_hi - s_lo + 1) * 2 * (ex.n_fft // 2 + 1)
    log(f"phase 23 spectrogram direct DFT n_fft={ex.n_fft} (10 s; medians "
        f"of {len(turns['kernel'])} rounds in turns): kernel "
        f"{spec_t[0]:.4f} ms, plain {spec_t[1]:.4f} ms, torch.stft chain "
        f"{spec_t[2]:.4f} ms (rounds: kernel "
        f"{' '.join(f'{x:.4f}' for x in turns['kernel'])}, chain "
        f"{' '.join(f'{x:.4f}' for x in turns['library'])}); bound "
        f"{_bound_ms(spec_bound):.4f} ms (bytes, "
        f"the work counted as an FFT's); its own tensor-core products over "
        f"the window's taps {ex.plan.support} folded to {s_hi - s_lo + 1} "
        f"{products} FLOPs, "
        f"{products / PEAK_3XTF32_FLOP_PER_S * 1e3:.4f} ms at the 3xTF32 "
        f"rate")
    profiled = stft.prepare_spectrograms(ys, ex.plan, profile=True)
    profiled()
    log(f"phase 23 spectrogram direct DFT n_fft={ex.n_fft} (10 s), one "
        f"profiled launch: {dft_timeline(profiled.stage_cycles)}")
    rows += _kernel_rows("spectrogram", "spectrogram", "stft.py:65",
                         launches, errs["spectrogram"], *spec_t[:2],
                         spec_bound, spec_t[2])
    return rows, launches


# Phase 24: encoders past #1's earlier limits (the codes recipe's widths
# otherwise): widths of 130 (not multiples of 4), 129 and 256 LSTM units a
# direction, more prenet, highway and hop layers than its fixed arrays held
WIDE_ENCODERS = (
    ("widened_encoder_w130",
     "encoder_prenet_out_units=[256,130],projection2_out_channels=130"),
    ("widened_encoder_h129", "cbhg_out_units=258"),
    ("widened_encoder_h256", "cbhg_out_units=512"),
    ("widened_encoder_layers",
     "encoder_prenet_out_units=[256,128,128,128,128],num_highway=9,"
     "self_attention_num_hop=5"),
)
PALLAS_NO_DROPOUT = ("use_pallas_attention=true,self_attention_drop_rate=0,"
                     "decoder_self_attention_drop_rate=0")
PLOTTED_TRAINING = "alignment_save_steps=2,record_profile=true,profile_steps=1"
TOL_REPLAY = 1e-5


def _reused_rows(rows, name, path, new_path, count):
    """The rows of ``name`` measured on ``path``, for ``new_path``'s run,
    which launched it ``count`` times at the same shapes."""
    return [dict(row, path=new_path, launches=count) for row in rows
            if row["name"] == name and row["path"] == path and count]


def _widened_encoders(device, card):
    import torch
    from self_attention_tacotron_torch.ops import fused_encoder as fe
    rows, launches = [], {}
    for path, extra in WIDE_ENCODERS:
        model = make_model(_hp_with(RECIPE, extra), device)
        params, x, kw = encoder_case(model, T_IN, T_IN, device)
        fe.fused_encode.launches = 0
        got = model.encoder(x, torch.tensor([T_IN], device=device))
        launched = fe.fused_encode.launches
        ref = fe.fused_encode_reference(params, x, T_IN, **kw)
        err = max(_max_err(g, r) for g, r in zip(got[:2], ref))
        launch = fe.prepare_encode(params, x, T_IN, **kw)
        ms = _time_ms(launch)
        plain = _time_ms(lambda: fe.fused_encode_reference(
            params, x, T_IN, **kw), reps=1)
        bound = encode_bound(params, x, kw)
        log(f"phase 24 {path} ({extra}; H = {kw['half']}, 16-byte copies "
            f"{bool(launch.args.v4)}, {2 * fe.dir_blocks(kw['half'])}-block "
            f"cluster): launches {launched}; vs the plain version max abs "
            f"err {err:.3e}; kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
            f"{_bound_ms(bound, PEAK_3XTF32_FLOP_PER_S):.4f} ms; card {card}")
        if launched != 1 or err > TOL_ENCODE:
            raise AssertionError(f"the widened encoder {path}")
        launches[path] = {"fused_encode": launched}
        rows += _kernel_rows("fused_encode", "fused_encoder",
                             "fused_encoder.py:94", {path: launches[path]},
                             err, ms, plain, bound,
                             peak_flops=PEAK_3XTF32_FLOP_PER_S)
        del model, launch
    return rows, launches


def _pallas_training_refused(device):
    import torch
    from self_attention_tacotron_torch.entry import _make_batch
    from self_attention_tacotron_torch.parallel import (create_train_state,
                                                        make_train_step)
    hp = _hp_with(RECIPE, PALLAS_NO_DROPOUT)
    model = make_model(hp, device)
    state = create_train_state(model, hp)
    batch = _make_batch(hp, B=2, T_in=16, T_out=8).to(device)
    try:
        with torch.enable_grad():
            make_train_step(hp)(state, batch)
    except NotImplementedError as e:
        said = str(e)
    else:
        raise AssertionError("Pallas-mode training without dropout ran")
    named = all(h + " = 0" in said for h in (
        "self_attention_drop_rate", "decoder_self_attention_drop_rate"))
    log(f"phase 24 training with {PALLAS_NO_DROPOUT}: NotImplementedError "
        f"before the first step (step {state.step}): {said[:160]}...")
    if not named or state.step != 0:
        raise AssertionError("the refusal does not name the hparams")


def _predict_with_replay(model, tmp, card):
    """main_code with the replay over 3 utterances (matplotlib's presence
    patched in, so that the card, which has none, replays too).  Returns
    its launch counts and the errors of its kernels: #2's as the replay's
    distance from the served pass (the plain module path, the same weights
    and encoder), #1's against its plain version on the served sources."""
    import contextlib
    import io
    import logging
    import re
    import numpy as np
    import torch
    from self_attention_tacotron_torch.cli.predict import main_code
    from self_attention_tacotron_torch.data.records import (
        parse_source_record, read_first_example)
    from self_attention_tacotron_torch.ops import fused_decode as fd
    from self_attention_tacotron_torch.ops import fused_encoder as fe
    from self_attention_tacotron_torch.utils import metrics
    from self_attention_tacotron_torch.utils.convert import save_checkpoint
    data, ckpt, out = (os.path.join(tmp, d) for d in (
        "replay_data", "replay_ckpt", "replay_out"))
    os.makedirs(data)
    keys = write_corpus(model.hp, data)
    save_checkpoint(model, ckpt, step=1)
    plotted = []
    plot, have = metrics.plot_predictions, metrics.have_matplotlib

    def capture(alignments, *a, **k):   # the alignments the PNG shows
        plotted.append([np.asarray(x) for x in alignments])
        return plot(alignments, *a, **k)

    said = []
    handler = logging.Handler()
    handler.emit = lambda record: said.append(record.getMessage())
    logger = logging.getLogger("predict_codes")
    logger.addHandler(handler)
    metrics.plot_predictions = capture
    metrics.have_matplotlib = lambda: True
    printed = io.StringIO()
    fe.fused_encode.launches = fd.fused_decode.launches = 0
    try:
        with contextlib.redirect_stdout(printed):
            rc = main_code(["--source-data-root", data, "--target-data-root",
                            data, "--checkpoint-dir", ckpt, "--output-dir",
                            out, "--hparam-json-file", RECIPE])
    finally:
        metrics.plot_predictions, metrics.have_matplotlib = plot, have
        logger.removeHandler(handler)
    counts = {"fused_encode": fe.fused_encode.launches,
              "fused_decode": fd.fused_decode.launches}
    text = printed.getvalue()
    print(text, end="")
    lines = re.findall(r"([\d.]+) ms wall on \w+ \(the alignment replay "
                       r"([\d.]+) ms, (\d+) steps, its outputs within "
                       r"([-+.\deE]+) of the served pass\)", text)
    errs = [float(m[3]) for m in lines]
    # the columns of the decoded steps (the plain loop stops there)
    sums = [float(np.abs(a[:, :int(m[2])].sum(0) - 1.0).max())
            for p, m in zip(plotted, lines) for a in p[:2]]
    self_attention = all(a.any() for p in plotted for a in p[2:])
    no_png = sum(metrics.NO_PNG in m for m in said)
    pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
    wall = [float(m[0]) for m in lines]
    replay = [float(m[1]) for m in lines]
    enc_err = 0.0
    for key in keys:        # #1 on each served source, after the count
        rec = parse_source_record(read_first_example(os.path.join(
            data, f"{key}.{model.hp.source_file_extension}")))
        source = torch.from_numpy(rec.source[None].astype(np.int64))
        params, x, kw = encoder_inputs(
            model, source.to(model.embedding.weight.device))
        got = fe.fused_encode(params, x, rec.source_length, **kw)
        ref = fe.fused_encode_reference(params, x, rec.source_length, **kw)
        enc_err = max(enc_err, *(_max_err(g, r) for g, r in zip(got, ref)))
    log(f"phase 24 predict with the replay: main_code served "
        f"{len(lines)} utterances; launch counts {counts}; replay vs served "
        f"outputs max abs err {max(errs, default=float('nan')):.3e}; "
        f"fused_encode vs its plain version on the served sources "
        f"{enc_err:.3e}; plotted "
        f"source alignments' columns sum to 1 within "
        f"{max(sums, default=float('nan')):.3e}; decoder self-attention "
        f"plotted {self_attention}; 'no PNG' lines {no_png}, PNGs {pngs}; "
        f"served pass {wall} ms, the replay adds {replay} ms an utterance "
        f"(median {statistics.median(replay) if replay else 0:.3f}); card "
        f"{card}")
    png_ok = (no_png == 1 and not pngs) if not metrics.have_matplotlib() \
        else pngs == sorted(f"{k}.png" for k in keys)
    if (rc != 0 or len(lines) != len(keys) or len(plotted) != len(keys)
            or max(errs) > TOL_REPLAY or max(sums) > TOL_REPLAY
            or enc_err > TOL_ENCODE
            or not self_attention or not png_ok
            or counts != {"fused_encode": 2 * len(keys),
                          "fused_decode": len(keys)}):
        raise AssertionError("predict with the alignment replay")
    return counts, {"fused_encode": enc_err, "fused_decode": max(errs)}


def _plotted_training(data, tmp, card):
    """cli.train for 3 steps with the train-time plots and the profiler;
    returns its launch counts."""
    import re
    import torch
    from self_attention_tacotron_torch.cli.train import main as train_main
    from self_attention_tacotron_torch.ops import fused_train as ft
    from self_attention_tacotron_torch.utils import metrics
    ckpt = os.path.join(tmp, "plotted_ckpt")
    payloads = []
    save = metrics.MetricsSaver.save

    def capture(self, step, key, text, alignments, ground_truth, predicted,
                *a, **k):
        payloads.append((self.mode, step, [x.shape for x in alignments],
                         ground_truth.shape, predicted.shape))
        return save(self, step, key, text, alignments, ground_truth,
                    predicted, *a, **k)

    metrics.MetricsSaver.save = capture
    ft.fused_train_fwd.launches = ft.fused_train_bwd.launches = 0
    try:
        with torch.enable_grad():
            rc = train_main(["--source-data-root", data, "--target-data-root",
                             data, "--checkpoint-dir", ckpt,
                             "--hparam-json-file", RECIPE, "--max-steps",
                             "3", "--hparams", PLOTTED_TRAINING])
    finally:
        metrics.MetricsSaver.save = save
    counts = {"fused_train_fwd": ft.fused_train_fwd.launches,
              "fused_train_bwd": ft.fused_train_bwd.launches}
    with open(os.path.join(ckpt, "log.txt")) as f:
        text = f.read()
    busy = re.search(r"profile of steps (\d+)-(\d+): device busy "
                     r"([\d.]+) % \(([\d.]+) ms a step\) of ([\d.]+) ms "
                     r"wall on cuda; trace (\S+)", text)
    trace = busy.group(6) if busy else ""
    steps = re.findall(r"step (\d+) loss [-+0-9.eEinfa]+ \(([\d.]+)s\)", text)
    log(f"phase 24 plotted training: cli.train 3 steps ({PLOTTED_TRAINING}); "
        f"launch counts {counts}; saver payloads (mode, step, alignment "
        f"shapes, ground truth, outputs) {payloads}; profile "
        f"{busy.group(0) if busy else 'missing'}; seconds a step (the "
        f"profiled ones under the profiler) {[float(t) for _, t in steps]}; "
        "trace "
        f"{os.path.getsize(trace) if os.path.exists(trace) else 0} bytes; "
        f"card {card}")
    if os.path.exists(trace):
        log("phase 24 plotted training: the profiled window's device time "
            "by event (name, ms, count): " + "; ".join(
                f"{name[:70]} {ms:.3f} ms x{n}"
                for name, ms, n in _device_time_by_name(trace)[:8]))
    C = recipe_hparams().num_mels
    ok = (len(payloads) == 1 and payloads[0][:2] == ("train", 2)
          and len(payloads[0][2]) == 2
          and all(s[1] == payloads[0][4][0] for s in payloads[0][2])
          and payloads[0][4][1] == C and payloads[0][3][1] == C)
    if (rc != 0 or not ok or busy is None or not os.path.exists(trace)
            or counts != {"fused_train_fwd": 3, "fused_train_bwd": 3}):
        raise AssertionError("training with plots and the profiler")
    return counts


def _device_time_by_name(trace):
    """[(name, ms, count)] of the device's work in a ``torch.profiler``
    trace, the most time first."""
    from self_attention_tacotron_torch.cli.train import device_events
    total = {}
    for e in device_events(trace):
        ms, n = total.get(e["name"], (0.0, 0))
        total[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    return sorted(((name, ms, n) for name, (ms, n) in total.items()),
                  key=lambda row: -row[1])


def _bench(device, card):
    """``bench.measure`` over 3 decodes (path ``bench``; its JSON line
    printed), then on the bench's own model and source: its decode against
    the flagship built with the fused flags off (the same weights), and #1
    and #2 against their plain versions, timed beside their bounds.
    Returns (rows, launch counts)."""
    import torch
    from self_attention_tacotron_torch import bench
    from self_attention_tacotron_torch.models import tacotron_model_factory
    from self_attention_tacotron_torch.ops import fused_decode as fd
    from self_attention_tacotron_torch.ops import fused_encoder as fe
    fe.fused_encode.launches = fd.fused_decode.launches = 0
    line = bench.measure(reps=3, warmup=1)
    counts = {"fused_encode": fe.fused_encode.launches,
              "fused_decode": fd.fused_decode.launches}
    log(f"phase 24 bench.measure(reps=3, warmup=1): launch counts {counts}; "
        f"card {card}; its line:")
    print(json.dumps(line), flush=True)
    if line["metric"] != "decoder_frames_per_sec_per_chip" or not (
            line["value"] > 0) or counts != {"fused_encode": 4,
                                             "fused_decode": 4}:
        raise AssertionError("the bench")
    hp, model, batch = bench.make_flagship(device)
    plain = tacotron_model_factory(hp.replace(encoder_fused_inference=False,
                                              decoder_fused_inference=False))
    plain.load_state_dict(model.state_dict())
    plain = plain.to(device).eval()
    got, ref = model(batch), plain(batch)
    model_err = max(_max_err(got.outputs, ref.outputs),
                    _max_err(got.stop_token, ref.stop_token))
    steps, L = hp.max_iters, int(batch.source_length[0])
    params, x, kw = encoder_inputs(model, batch.source)
    enc_err = max(_max_err(g, r) for g, r in zip(
        fe.fused_encode(params, x, L, **kw),
        fe.fused_encode_reference(params, x, L, **kw)))
    weights, memory, options = decoder_inputs(model, batch.source, L)
    got_d, ref_d = _decode_pair(weights, memory, options, steps)
    dec_err = max(_max_err(got_d[0], ref_d[0]), _max_err(got_d[1], ref_d[1]),
                  *(_max_err(g, r) for g, r in zip(got_d[2], ref_d[2])))
    enc_t = (_time_ms(fe.prepare_encode(params, x, L, **kw)),
             _time_ms(lambda: fe.fused_encode_reference(params, x, L, **kw)))
    dec_t = (_time_ms(fd.prepare_decode(weights, memory, num_steps=steps,
                                        **options)),
             _time_ms(lambda: fd.fused_decode_reference(
                 weights, memory, num_steps=steps, **options), reps=3))
    bounds = (encode_bound(params, x, kw),
              decode_bound(model.decoder.fused_params(), weights, memory,
                           steps))
    log(f"phase 24 bench inputs (the flagship at full width, T = {L}, "
        f"{steps} steps, early stop {options['early_stop']}): the fused "
        f"decode vs the flagship with the fused flags off max abs err "
        f"{model_err:.3e} (outputs {tuple(got.outputs.shape)}); fused_encode "
        f"vs plain {enc_err:.3e}, {enc_t[0]:.4f} ms (plain {enc_t[1]:.4f}, "
        f"bound {_bound_ms(bounds[0], PEAK_3XTF32_FLOP_PER_S):.4f}); "
        f"fused_decode vs plain {dec_err:.3e}, {dec_t[0]:.4f} ms (plain "
        f"{dec_t[1]:.4f}, bound {_bound_ms(bounds[1]):.4f}); card {card}")
    if max(model_err, dec_err) > TOL_DECODE or enc_err > TOL_ENCODE:
        raise AssertionError("the bench's decode disagrees with its plain "
                             "version")
    return [*_kernel_rows("fused_encode", "fused_encoder",
                          "fused_encoder.py:94", {"bench": counts}, enc_err,
                          *enc_t, bounds[0],
                          peak_flops=PEAK_3XTF32_FLOP_PER_S),
            *_kernel_rows("fused_decode", "fused_decode",
                          "fused_decode.py:250", {"bench": counts}, dec_err,
                          *dec_t, bounds[1])], counts


LOOP_STEPS = 3


def _training_loop_split(data, tmp, device, card):
    """Where a ``cli.train`` step's wall goes, without the profiler: the
    CLI for ``LOOP_STEPS`` steps (each ``step N loss L (s)`` line is one
    step of the loop: the batch, the step, the logging), then, on the same
    corpus and recipe, the training dataset alone (each batch's wait) and
    the step function alone on those batches (the copy to the card
    included, the loss read back as the CLI does)."""
    import re
    import torch
    from self_attention_tacotron_torch.cli.train import main as train_main
    from self_attention_tacotron_torch.data.dataset import (
        dataset_factory, find_dataset_files, load_key_list, to_model_batch)
    from self_attention_tacotron_torch.parallel import (create_train_state,
                                                        make_train_step)
    ckpt = os.path.join(tmp, "loop_ckpt")
    with torch.enable_grad():
        rc = train_main(["--source-data-root", data, "--target-data-root",
                         data, "--checkpoint-dir", ckpt,
                         "--hparam-json-file", RECIPE, "--max-steps",
                         str(LOOP_STEPS)])
    hp = recipe_hparams()
    with open(os.path.join(ckpt, os.path.basename(hp.logfile))) as f:
        loop = [float(t) for t in re.findall(
            r"step \d+ loss [-+0-9.eEinfa]+ \(([\d.]+)s\)", f.read())]
    keys = load_key_list(os.path.join(data, "train.csv"))
    ds = iter(dataset_factory(
        find_dataset_files(data, keys, hp.source_file_extension),
        find_dataset_files(data, keys, hp.target_file_extension), hp,
        shuffle=True, repeat=True, drop_remainder=True,
        batch_size=hp.batch_size, seed=hp.seed))
    waits, batches = [], []
    for _ in range(LOOP_STEPS):
        t0 = time.perf_counter()
        batches.append(next(ds))
        waits.append(time.perf_counter() - t0)
    state = create_train_state(make_model(hp, device).train(), hp)
    train_step = make_train_step(hp)
    steps = []
    with torch.enable_grad():
        for nb in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            float(train_step(state, to_model_batch(nb))["loss"])
            steps.append(time.perf_counter() - t0)
    med = statistics.median
    log(f"phase 24 training loop without the profiler: cli.train "
        f"{LOOP_STEPS} steps, s a step {loop} (past the first: median "
        f"{med(loop[1:]) if len(loop) > 1 else float('nan'):.4f}); the "
        f"dataset alone, s a batch {[round(t, 4) for t in waits]} (past the "
        f"first: median {med(waits[1:]):.4f}); the step function alone on "
        f"those batches, s {[round(t, 4) for t in steps]} (past the first: "
        f"median {med(steps[1:]):.4f}); B = {hp.batch_size}; card {card}")
    if rc != 0 or len(loop) != LOOP_STEPS:
        raise AssertionError("the unprofiled training loop")
    return {"loop": loop, "dataset": waits, "step": steps}


def phase_entry_points(model, device, card: str, data: str, tmp: str,
                       rows, codes_timing):
    """Phase 24 (``entry_points``): the widened #1, the Pallas mode refused
    under autograd, predict with the replay, training with plots and the
    profiler and without the profiler, ``entry()`` and the bench.  Returns
    (rows, launch counts)."""
    import math
    from self_attention_tacotron_torch.entry import entry
    t0 = time.perf_counter()
    new_rows, launches = _widened_encoders(device, card)
    _pallas_training_refused(device)
    launches["predict_replay"], replay_errs = _predict_with_replay(
        model, tmp, card)
    launches["plotted_training"] = _plotted_training(data, tmp, card)
    loop_split = _training_loop_split(data, tmp, device, card)
    fn, args = entry()
    loss = float(fn(*args))
    log(f"phase 24 entry(): teacher-forced VALIDATION loss {loss:.6f} of the "
        f"tiny flagship on {args[1].source.device}")
    if not math.isfinite(loss):
        raise AssertionError("entry() gave a loss that is not finite")
    bench_rows, launches["bench"] = _bench(device, card)
    # the replay's run served the codes recipe: phase 8 timed its #1 and #2
    # (T = 64, the corpus's longest source; 450 steps)
    replayed = {"predict_replay": launches["predict_replay"]}
    for name, src, line, peak in (
            ("fused_encode", "fused_encoder", "fused_encoder.py:94",
             PEAK_3XTF32_FLOP_PER_S),
            ("fused_decode", "fused_decode", "fused_decode.py:250",
             PEAK_FP32_FLOP_PER_S)):
        new_rows += _kernel_rows(name, src, line, replayed, replay_errs[name],
                                 *codes_timing[name], peak_flops=peak)
    new_rows += bench_rows
    for name in ("fused_train_fwd", "fused_train_bwd"):
        new_rows += _reused_rows(rows, name, "training", "plotted_training",
                                 launches["plotted_training"][name])
    log(f"phase 24 entry points took {time.perf_counter() - t0:.1f} s")
    return new_rows, launches, loop_split


# ------------------------------------------------- data parallelism

DP_RANKS = 2
# the corpus' one bucket (targets of 200-249 codes: pad 250) on every rank,
# its sources (40-64 phones) in one pad of 64
DP_HPARAMS = ("multihost_bucket_weights=[0,0,1,0,0,0,0],"
              "multihost_source_pad_length=64")
# a 2-rank step against the one-process step on the same 32 rows: every
# gradient and running statistic within 1e-4 of its tensor's largest
# magnitude, every parameter within 1e-4 of the largest parameter
# magnitude (``entry.step_disagreements`` says why not of its own tensor's:
# a zero-initialised bias is one Adam update, which carries the rounding
# of gradients near Adam's eps: on an H100 such a tensor reads ~1.3e-4 of
# its own magnitude and ~1e-8 of the largest), the loss and gradient norm
# relative (the ranks sum the batch in another order)
TOL_DP = 1e-4


def _rank_logs(ckpt: str, n: int):
    """(losses, launches, text, seconds a step) of each rank's log of a
    ``cli.train``."""
    import re
    name = os.path.basename(recipe_hparams().logfile)
    out = []
    for r in range(n):
        with open(os.path.join(ckpt, name + (f".p{r}" if r else ""))) as f:
            text = f.read()
        losses = [float(x) for x in re.findall(
            r"step \d+ loss ([-+0-9.eEinfa]+)", text)]
        m = re.search(r"training kernel launches: fused_train_fwd (\d+), "
                      r"fused_train_bwd (\d+)", text)
        launches = ({"fused_train_fwd": int(m.group(1)),
                     "fused_train_bwd": int(m.group(2))} if m else {})
        secs = [float(x) for x in re.findall(
            r"step \d+ loss [-+0-9.eEinfa]+ \(([\d.]+)s\)", text)]
        out.append((losses, launches, text, secs))
    return out


def _cli_ranks(data, ckpt, args, n: int, steps: int = 3):
    """``cli.train`` on the recipe for ``steps`` steps with ``args``;
    each rank's log read back, its losses finite, its training kernels
    launched once a step, the reader native; returns the rank logs."""
    import math
    import torch
    from self_attention_tacotron_torch.cli.train import main as train_main
    with torch.enable_grad():
        rc = train_main(["--source-data-root", data, "--target-data-root",
                         data, "--checkpoint-dir", ckpt,
                         "--hparam-json-file", RECIPE, "--max-steps",
                         str(steps), *args])
    logs = _rank_logs(ckpt, n)
    for r, (losses, launches, text, _) in enumerate(logs):
        if (rc != 0 or len(losses) != steps
                or not all(math.isfinite(x) for x in losses)):
            raise AssertionError(f"rank {r}: cli.train rc {rc}, losses "
                                 f"{losses}")
        if launches != {"fused_train_fwd": steps, "fused_train_bwd": steps}:
            raise AssertionError(f"rank {r} launched {launches}, not one of "
                                 "each training kernel a step")
        if "TFRecord reader: native" not in text:
            raise AssertionError(f"rank {r} was not served by the native "
                                 "reader")
    if sorted(f for f in os.listdir(ckpt) if f.endswith(".pt")) != [
            f"model-{steps}.pt", f"train-{steps}.pt"]:
        raise AssertionError(f"no single checkpoint of step {steps}: "
                             f"{sorted(os.listdir(ckpt))}")
    return logs


def _python_reader_batch(data):
    """Seconds for one B = 32 batch of the training dataset through the
    pure-Python reader and checksum (what served before the native one),
    and through the native reader, each from a fresh dataset."""
    from self_attention_tacotron_torch.data import dataset as ds
    from self_attention_tacotron_torch.data import tfrecord
    hp = recipe_hparams()
    keys = ds.load_key_list(os.path.join(data, "train.csv"))
    files = [ds.find_dataset_files(data, keys, ext) for ext in
             (hp.source_file_extension, hp.target_file_extension)]
    times = {}
    for which in ("python", "native"):
        saved = ds._reader, tfrecord._crc32c
        if which == "python":
            ds._reader, tfrecord._crc32c = "python", tfrecord.crc32c_python
        try:
            it = iter(ds.dataset_factory(*files, hp, shuffle=True,
                                         repeat=True, drop_remainder=True,
                                         seed=hp.seed + 7))
            t0 = time.perf_counter()
            next(it)
            times[which] = time.perf_counter() - t0
            it.close()
        finally:
            ds._reader, tfrecord._crc32c = saved
    return times


def _dp_step_check(device, data, card):
    """One deterministic 2-rank step (16 rows a rank, gloo on the one card)
    against the one-process step on the same 32 rows of the corpus, the
    recipe at full width with the fused trunk."""
    from self_attention_tacotron_torch import entry
    from self_attention_tacotron_torch.data import dataset as ds
    from self_attention_tacotron_torch.parallel.train_step import \
        learning_rate
    hp = recipe_hparams()
    for k, v in entry.DETERMINISTIC.items():
        hp.set_hparam(k, v)
    keys = ds.load_key_list(os.path.join(data, "train.csv"))
    nb = next(iter(ds.dataset_factory(*[ds.find_dataset_files(
        data, keys, ext) for ext in (hp.source_file_extension,
                                     hp.target_file_extension)], hp,
        shuffle=True, seed=SEED, drop_remainder=True)))
    batch = ds.to_model_batch(nb)
    t0 = time.perf_counter()
    [ranks] = entry.data_parallel_steps([(hp, batch)], DP_RANKS, "cuda",
                                        SEED)
    t_dp = time.perf_counter() - t0
    single = entry.single_process_step(hp, batch, "cuda", SEED)
    errs = entry.step_errors(single, ranks, learning_rate(hp, 0))
    log(f"phase 25 deterministic step, {DP_RANKS} ranks x "
        f"{batch.source.shape[0] // DP_RANKS} rows vs one process x "
        f"{batch.source.shape[0]} (S = {nb.target.shape[1]}, T = "
        f"{nb.source.shape[1]}): loss {ranks[0]['metrics']['loss']:.7f} vs "
        f"{single['metrics']['loss']:.7f} (rel {errs['loss']:.2e}), "
        f"grad_norm rel {errs['grad_norm']:.2e}; worst tensor over its "
        f"largest magnitude: params {errs['params']:.2e}, grads "
        f"{errs['grads']:.2e}, running stats {errs['stats']:.2e} (over "
        f"the largest of all: {errs['params_global']:.2e}, "
        f"{errs['grads_global']:.2e}, {errs['stats_global']:.2e}); noise "
        f"tensors {len(errs['noise'])} held: {errs['noise_ok']}; ranks "
        f"identical: {errs['ranks_identical']}; launches a rank "
        f"{[r['launches'] for r in ranks]}; the spawn took {t_dp:.1f} s; "
        f"card {card}")
    bad = entry.step_disagreements(errs, TOL_DP)
    if bad:
        raise AssertionError(f"the 2-rank step disagrees: {bad}")
    if any(r["launches"] != {"fused_train_fwd": 1, "fused_train_bwd": 1}
           for r in ranks):
        raise AssertionError("a rank did not launch each training kernel "
                             "once")


def _dp_kernel_rows(model, device, launches, card):
    """#3 and #4 at a rank's shape (B = 16, S = 250, T = 64, masks on)
    against their plain versions, timed (plain once) beside their
    bounds."""
    import torch
    from self_attention_tacotron_torch.ops import fused_train as ft
    B = TRAIN_B // DP_RANKS
    spec, params, keys, values, masks, tf, loc_ws, ops, _ = train_case(
        model, device, False, 3, steps=250, batch=B)
    seed = 4321
    y, save, aux = ft.fused_train_fwd(spec, ops, seed)
    y_r, save_r, aux_r = ft.fused_train_fwd_reference(
        spec, params, keys, values, masks, tf, seed, None, loc_ws)
    fwd_err = max(_max_err(y, y_r), _max_err(save, save_r),
                  _max_err(aux, aux_r))
    g = torch.randn(y.shape, generator=torch.Generator(device)
                    .manual_seed(11), device=device)
    kern = _kernel_grads(spec, ft.fused_train_bwd(spec, ops, seed, g, save,
                                                  aux))
    d_params, d_keys, d_values, _, d_loc = ft.fused_train_bwd_reference(
        spec, params, keys, values, masks, tf, seed, None, loc_ws, g,
        save_r, aux_r)
    plain = _grad_leaves(spec, d_params, d_keys, d_values, d_loc)
    rel = max(_rel_err(kern[k], plain[k].reshape(kern[k].shape))
              for k in plain)
    bwd_err = max(_max_err(kern[k], plain[k].reshape(kern[k].shape))
                  for k in plain)
    fwd = ft.prepare_train_fwd(spec, ops, seed)
    bwd = ft.prepare_train_bwd(spec, ops, seed, g, save, aux)
    times = {"fused_train_fwd": (_time_ms(fwd), _time_ms(
        lambda: ft.fused_train_fwd_reference(
            spec, params, keys, values, masks, tf, seed, None, loc_ws),
        reps=1)),
        "fused_train_bwd": (_time_ms(bwd), _time_ms(
            lambda: ft.fused_train_bwd_reference(
                spec, params, keys, values, masks, tf, seed, None, loc_ws,
                g, save, aux), reps=1))}
    flat_in = ft._flat(ops)
    bounds = {
        "fused_train_fwd": train_bound(spec, flat_in, [y, save, aux], False),
        "fused_train_bwd": train_bound(spec, flat_in + [g, save, aux],
                                       _leaves(bwd.outputs), True)}
    log(f"phase 25 training kernels at a rank's shape (B = {spec.batch}, S "
        f"= {spec.num_steps}, T = {spec.t_mem}, masks on): fused_train_fwd "
        f"max abs err {fwd_err:.3e}, {times['fused_train_fwd'][0]:.4f} ms "
        f"(plain {times['fused_train_fwd'][1]:.4f}); fused_train_bwd worst "
        f"gradient {rel:.3e} of its max magnitude (max abs {bwd_err:.3e}), "
        f"{times['fused_train_bwd'][0]:.4f} ms (plain "
        f"{times['fused_train_bwd'][1]:.4f}); card {card}")
    if fwd_err > TOL_TRAIN or rel > TOL_TRAIN_GRAD:
        raise AssertionError("a training kernel disagrees with its plain "
                             "version at a rank's shape")
    return [row for name, line, err in (
                ("fused_train_fwd", 375, fwd_err),
                ("fused_train_bwd", 667, bwd_err))
            for row in _kernel_rows(name, name, f"fused_train.py:{line}",
                                    launches, err, *times[name],
                                    bounds[name],
                                    peak_flops=PEAK_3XTF32_FLOP_PER_S)]


def phase_data_parallel(model, device, card: str, data: str, tmp: str,
                        rows, loop_split):
    """Phase 25 (``data_parallel``): the input pipeline's reader and times,
    ``cli.train`` on two ranks sharing the card over gloo and on one rank
    over NCCL, a deterministic 2-rank step against the one-process step,
    ``entry.dryrun_multichip(2)``, and #3 / #4 at a rank's shape.  Returns
    (rows, launch counts)."""
    import statistics as st
    from self_attention_tacotron_torch.data import dataset as ds
    from self_attention_tacotron_torch.entry import dryrun_multichip
    from self_attention_tacotron_torch.parallel.multihost import free_port
    t0 = time.perf_counter()
    reader, reads = ds.reader_in_use(), dict(ds.reads)
    if reader != "native" or reads.get("python"):
        raise AssertionError(f"the card run was served by the pure-Python "
                             f"reader: {reads}")
    batch_s = _python_reader_batch(data)
    med = st.median
    log(f"phase 25 input pipeline: reader {reader} (records read in this "
        f"process before the next line's batches: {reads}); phase 24's cli.train s a step "
        f"{loop_split['loop']} (past the first: median "
        f"{med(loop_split['loop'][1:]):.4f}), its dataset alone s a batch "
        f"{[round(t, 4) for t in loop_split['dataset']]} (past the first: "
        f"median {med(loop_split['dataset'][1:]):.4f}), the step function "
        f"alone s {[round(t, 4) for t in loop_split['step']]} (past the "
        f"first: median {med(loop_split['step'][1:]):.4f}); one fresh "
        f"batch of B = 32: pure-Python reader {batch_s['python']:.4f} s, "
        f"native {batch_s['native']:.4f} s; card {card}")

    launches = {}
    ckpt = os.path.join(tmp, "dp_ckpt")
    t1 = time.perf_counter()
    logs = _cli_ranks(data, ckpt, ["--num-processes", str(DP_RANKS),
                                   "--hparams", DP_HPARAMS], DP_RANKS)
    wall = time.perf_counter() - t1
    launches["dp_training"] = {k: sum(lg[1][k] for lg in logs)
                               for k in logs[0][1]}
    backends = ["gloo" if "backend gloo" in lg[2] else "?" for lg in logs]
    log(f"phase 25 cli.train --num-processes {DP_RANKS}: global B = 32 "
        f"({32 // DP_RANKS} a rank), 3 steps in {wall:.1f} s (spawn and "
        f"start included), s a step per rank {[lg[3] for lg in logs]}; "
        f"backends {backends}; losses per rank "
        f"{[lg[0] for lg in logs]}; launches per rank "
        f"{[lg[1] for lg in logs]}; card {card}")
    if backends != ["gloo"] * DP_RANKS or logs[0][0] != logs[1][0]:
        raise AssertionError("the ranks did not share the card over gloo "
                             "with the same global losses")
    ckpt = os.path.join(tmp, "nccl_ckpt")
    t1 = time.perf_counter()
    [(losses, counts, text, secs)] = _cli_ranks(
        data, ckpt, ["--num-processes", "1", "--process-id", "0",
                     "--coordinator-address", f"localhost:{free_port()}"], 1)
    log(f"phase 25 cli.train, one rank over NCCL: 3 steps in "
        f"{time.perf_counter() - t1:.1f} s, s a step {secs}, losses "
        f"{losses}, launches {counts}; card {card}")
    if "backend nccl" not in text:
        raise AssertionError("the one-rank run did not use NCCL")
    launches["dp_training_nccl"] = counts

    _dp_step_check(device, data, card)
    t1 = time.perf_counter()
    dryrun_multichip(DP_RANKS, "cuda")
    log(f"phase 25 dryrun_multichip({DP_RANKS}) took "
        f"{time.perf_counter() - t1:.1f} s")
    new_rows = _dp_kernel_rows(model, device,
                               {"dp_training": launches["dp_training"]},
                               card)
    for name in ("fused_train_fwd", "fused_train_bwd"):
        new_rows += _reused_rows(rows, name, "training", "dp_training_nccl",
                                 counts[name])
    log(f"phase 25 data parallelism took {time.perf_counter() - t0:.1f} s")
    return new_rows, launches


# ------------------------------- the rest of the model surface (phase 26)

TRANSFORMER_DECODER = "decoder=TransformerDecoder"
PITCH_ACCENT_UTTERANCES = 40    # 35 to train (one batch of 32), 2 to
#                                 evaluate, 3 to serve
PITCH_ACCENT_EVAL = ("eval_start_delay_secs=0,eval_throttle_secs=0,"
                     "save_checkpoints_steps=3,num_evaluation_steps=2")
TD_TRAIN_S = 250                # the corpus' one bucket: S = 250
PITCH_STEP_TS = (0, 31, 32, 100)   # cache steps checked beside the last


def _time_serving(model, batch, reps: int = 5):
    """Host-clock ms of one INFERENCE call ending in a synchronise, after a
    warm-up: the median and the spread."""
    import torch
    model(batch)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), min(times), max(times)


def _transformer_decoder(device, card, data, tmp, rows):
    """The codes recipe with ``TransformerDecoder`` (one forward source and
    a causal hop): #1 and #2 against their plain versions and on the
    serving path, #3 and #4 at B = 32, S = 250 against theirs and on 3
    ``cli.train`` steps, each timed beside its bound."""
    import torch
    from self_attention_tacotron_torch.models import Batch
    from self_attention_tacotron_torch.ops import fused_decode as fd
    from self_attention_tacotron_torch.ops import fused_train as ft
    from self_attention_tacotron_torch.parallel import (create_train_state,
                                                        make_train_step)
    hp = _hp_with(RECIPE, TRANSFORMER_DECODER)
    model = make_model(hp, device)
    dec = model.decoder
    log(f"phase 26 transformer_decoder: {dec.num_sources} source(s) "
        f"({type(dec.attention_mechanism_0).__name__}, "
        f"{hp.attention_out_units} units, kernel {hp.attention_kernel}, "
        f"{hp.attention_filters} filters), {len(dec.transformers)} hop(s) "
        f"of {hp.decoder_self_attention_out_units}, {hp.num_mels} codes, "
        f"r = {hp.outputs_per_step}; card {card}")
    steps = hp.max_iters
    errs = {"fused_encode": phase_encode(model, device, phase=26),
            "fused_decode": phase_decode(model, device, steps, phase=26)}
    errs.update(phase_train_kernels(model, device, phase=26,
                                    steps=TD_TRAIN_S))
    launches = {}
    with _Fallbacks() as fb:
        launches["transformer_decoder_serving"] = phase_end_to_end(
            model, "cuda", hparams=TRANSFORMER_DECODER, phase=26)
        launches["transformer_decoder_training"] = phase_train_end_to_end(
            hp, data, tmp, "cuda", hparams=TRANSFORMER_DECODER, phase=26)
    log(f"phase 26 transformer_decoder fallbacks logged: "
        f"{fb.refused or 'none'}")
    if fb.refused or launches["transformer_decoder_serving"] != {
            "fused_encode": 3, "fused_decode": 3}:
        raise AssertionError("TransformerDecoder serving did not launch #1 "
                             "and #2 once an utterance")

    # #2 at the serving shape: B = 1, 64 phones, 450 steps, early stop off
    weights, memory, options = decoder_case(model, T_IN, T_IN, device)
    options = dict(options, early_stop=False)
    dec_ms = _time_ms(fd.prepare_decode(weights, memory, num_steps=steps,
                                        **options))
    dec_plain = _time_ms(lambda: fd.fused_decode_reference(
        weights, memory, num_steps=steps, **options), reps=1)
    dec_bound = decode_bound(dec.fused_params(), weights, memory, steps)
    # #3 / #4 at the training shape: B = 32, S = 250, masks on
    spec, params, keys, values, masks, tf, loc_ws, ops, _ = train_case(
        model, device, False, 1, TD_TRAIN_S)
    seed = 1234
    fwd = ft.prepare_train_fwd(spec, ops, seed)
    fwd_ms = _time_ms(fwd)
    y, save, aux = fwd()
    g = torch.randn(y.shape, generator=torch.Generator(device).manual_seed(7),
                    device=device)
    bwd = ft.prepare_train_bwd(spec, ops, seed, g, save, aux)
    bwd_ms = _time_ms(bwd)
    fwd_plain = _time_ms(lambda: ft.fused_train_fwd_reference(
        spec, params, keys, values, masks, tf, seed, None, loc_ws), reps=1)
    bwd_plain = _time_ms(lambda: ft.fused_train_bwd_reference(
        spec, params, keys, values, masks, tf, seed, None, loc_ws, g, save,
        aux), reps=1)
    flat_in = ft._flat(ops)
    bounds = {"fused_decode": dec_bound,
              "fused_train_fwd": train_bound(spec, flat_in, [y, save, aux],
                                             False),
              "fused_train_bwd": train_bound(spec, flat_in + [g, save, aux],
                                             _leaves(bwd.outputs), True)}
    log("phase 26 transformer_decoder bound inputs: " + "; ".join(
        f"{k} {b[0]} bytes, {b[1]} FLOPs" for k, b in bounds.items()))
    log(f"phase 26 transformer_decoder timing: fused_decode B=1 {steps} "
        f"steps {dec_ms:.4f} ms (plain {dec_plain:.4f} ms, bound "
        f"{_bound_ms(dec_bound):.4f} ms); fused_train_fwd B={spec.batch} "
        f"S={spec.num_steps} {fwd_ms:.4f} ms (plain {fwd_plain:.4f} ms, "
        f"bound {_bound_ms(bounds['fused_train_fwd'], PEAK_3XTF32_FLOP_PER_S):.4f}"
        f" ms); fused_train_bwd {bwd_ms:.4f} ms (plain {bwd_plain:.4f} ms, "
        f"bound {_bound_ms(bounds['fused_train_bwd'], PEAK_3XTF32_FLOP_PER_S):.4f}"
        f" ms); card {card}")

    # the model's serving call and one training step, host clock
    src = source_ids(hp, T_IN, T_IN, SEED + T_IN, device)
    serve = _time_serving(model, Batch(src, torch.tensor([T_IN],
                                                         device=device)))
    batch = next(iter(_train_batches(hp, data))).to(device)
    state = create_train_state(make_model(hp, device).train(), hp)
    step = make_train_step(hp)
    with torch.enable_grad():
        step(state, batch)      # warm-up
        step_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"phase 26 transformer_decoder serving call (B = 1, {T_IN} phones, "
        f"{steps} steps cap, early stop on) median {serve[0]:.3f} ms "
        f"(min {serve[1]:.3f}, max {serve[2]:.3f}); train step B="
        f"{batch.source.shape[0]} S={batch.target.shape[1]} ms "
        f"{[round(t, 3) for t in step_ms]}; card {card}")
    del state, model
    new_rows = _reused_rows(
        rows, "fused_encode", "serving", "transformer_decoder_serving",
        launches["transformer_decoder_serving"]["fused_encode"])
    new_rows = [dict(r, max_abs_err=errs["fused_encode"]) for r in new_rows]
    new_rows += _kernel_rows(
        "fused_decode", "fused_decode", "fused_decode.py:250",
        {"transformer_decoder_serving":
            launches["transformer_decoder_serving"]},
        errs["fused_decode"], dec_ms, dec_plain, dec_bound)
    for name, line, ms, plain in (
            ("fused_train_fwd", 375, fwd_ms, fwd_plain),
            ("fused_train_bwd", 667, bwd_ms, bwd_plain)):
        new_rows += _kernel_rows(
            name, name, f"fused_train.py:{line}",
            {"transformer_decoder_training":
                launches["transformer_decoder_training"]},
            errs[name], ms, plain, bounds[name],
            peak_flops=PEAK_3XTF32_FLOP_PER_S)
    return new_rows, launches


def _train_batches(hp, data):
    from self_attention_tacotron_torch.data.dataset import (
        dataset_factory, find_dataset_files, load_key_list, to_model_batch)
    keys = load_key_list(os.path.join(data, "train.csv"))
    for nb in dataset_factory(
            find_dataset_files(data, keys, hp.source_file_extension),
            find_dataset_files(data, keys, hp.target_file_extension), hp,
            shuffle=False, drop_remainder=True):
        yield to_model_batch(nb)


def write_pitch_accent_corpus(hp, root: str,
                              n: int = PITCH_ACCENT_UTTERANCES):
    """A synthetic corpus for the pitch-accent configuration: phone
    sources (40..64) with an accent id each, and MGC/LF0 targets of
    200..249 frames (one bucket, pad 250): 60 mgc coefficients and an f0
    track in Hz with a quarter of its frames unvoiced.  Lists: train (35),
    validation (2), test (3)."""
    import numpy as np
    from self_attention_tacotron_torch.data.records import (
        MgcLf0TargetRecord, SourceRecord, write_mgc_lf0_target_record,
        write_source_record)
    rng = np.random.default_rng(SEED + 26)
    keys = []
    for i in range(n):
        key = f"accent{i:03d}"
        L = int(rng.integers(40, T_IN + 1))
        phone = rng.integers(1, hp.num_symbols, L).astype(np.int64)
        accent = hp.accent_type_offset + rng.integers(
            0, hp.num_accent_type, L)
        write_source_record(SourceRecord(
            id=i, key=key, source=phone, source_length=L, text=f"accent {i}",
            phone=phone, phone_length=L, phone_txt=" ".join(map(str, phone)),
            accent_type=accent),
            os.path.join(root, f"{key}.{hp.source_file_extension}"),
            with_phone=True)
        frames = int(rng.integers(200, 250))
        f0 = rng.uniform(50.0, 600.0, frames).astype(np.float32)
        f0[rng.random(frames) < 0.25] = 0.0
        write_mgc_lf0_target_record(MgcLf0TargetRecord(
            i, key, rng.standard_normal((frames, hp.num_mgcs)).astype(
                np.float32), hp.num_mgcs, f0, frames),
            os.path.join(root, f"{key}.{hp.target_file_extension}"))
        keys.append(key)
    for name, part in (("train", keys[:-5]), ("validation", keys[-5:-3]),
                       ("test", keys[-3:])):
        with open(os.path.join(root, f"{name}.csv"), "w") as f:
            f.write("\n".join(part) + "\n")
    return keys


def _pitch_accent_serving(hp, ckpt, data, device, card):
    """INFERENCE of the 3 test utterances from the training checkpoint on
    the plain path (the fused decode gate's reason logged) and in the
    Pallas mode; #5 and #6 at the path's shapes against their plain
    versions.  Returns (launch counts, errors)."""
    import torch
    from self_attention_tacotron_torch.data.dataset import (
        find_dataset_files, iter_utterances, load_key_list)
    from self_attention_tacotron_torch.models import (Batch,
                                                      tacotron_model_factory)
    from self_attention_tacotron_torch.ops import fused_decode as fd
    from self_attention_tacotron_torch.ops import fused_encoder as fe
    from self_attention_tacotron_torch.ops import pallas_attention as pa
    from self_attention_tacotron_torch.utils.convert import load_checkpoint
    keys = load_key_list(os.path.join(data, "test.csv"))
    utts = list(iter_utterances(
        find_dataset_files(data, keys, hp.source_file_extension),
        find_dataset_files(data, keys, hp.target_file_extension), hp,
        "mgclf0"))
    batches = [Batch(source=torch.from_numpy(u.source[None]).to(device),
                     source_length=torch.tensor([u.source_length],
                                                device=device),
                     accent_type=torch.from_numpy(u.accent_type[None]).to(
                         device)) for u in utts]
    outs, launches, walls = {}, {}, {}
    for mode in ("plain", "pallas"):
        hp_m = hp.replace(use_pallas_attention=mode == "pallas")
        model = tacotron_model_factory(hp_m).eval()
        load_checkpoint(model, ckpt)
        model.to(device)
        for counter in (fe.fused_encode, fd.fused_decode,
                        pa.fused_self_attention,
                        pa.incremental_attention_step):
            counter.launches = 0
        with _Fallbacks() as fb:
            outs[mode], walls[mode] = [], []
            for b in batches:
                _sync(device)
                t0 = time.perf_counter()
                outs[mode].append(model(b))
                _sync(device)
                walls[mode].append((time.perf_counter() - t0) * 1e3)
        launches[mode] = {
            "fused_encode": fe.fused_encode.launches,
            "fused_decode": fd.fused_decode.launches,
            "fused_self_attention": pa.fused_self_attention.launches,
            "incremental_attention_step":
                pa.incremental_attention_step.launches}
        steps = [int(o.lengths[0]) for o in outs[mode]]
        finite = all(bool(o.outputs.isfinite().all()
                          and o.outputs2.isfinite().all())
                     for o in outs[mode])
        log(f"phase 26 pitch_accent serving ({mode}): 3 utterances, "
            f"{steps} decode steps, ms a call "
            f"{[round(w, 3) for w in walls[mode]]}; launches "
            f"{launches[mode]}; finite {finite}; gates that took the plain "
            f"path: {fb.refused or 'none'}; card {card}")
        if not finite:
            raise AssertionError("pitch-accent serving is not finite")
        if mode == "plain" and (launches[mode]["fused_decode"]
                                or not any("mgclf0 not fused" in m
                                           for m in fb.refused)):
            # the gate's reason is logged once a process: by this call
            raise AssertionError("the MGC/LF0 decode gate did not log its "
                                 "reason")
        del model
    want = {"fused_self_attention": len(batches) * hp.self_attention_num_hop,
            "incremental_attention_step":
                sum(int(o.lengths[0]) for o in outs["pallas"])
                * hp.decoder_self_attention_num_hop}
    got = {k: launches["pallas"][k] for k in want}
    if got != want:
        raise AssertionError(f"Pallas-mode pitch-accent serving launched "
                             f"{got}, expected {want}")
    worst = 0.0
    for a, b in zip(outs["pallas"], outs["plain"]):
        ran = min(int(a.lengths[0]), int(b.lengths[0]))
        worst = max(worst, _max_err(a.outputs[:, :ran], b.outputs[:, :ran]),
                    _max_err(a.outputs2[:, :ran], b.outputs2[:, :ran]))
    log(f"phase 26 pitch_accent Pallas mode vs the einsum path: mgc and lf0 "
        f"logits max abs err {worst:.3e} (tol {TOL_PALLAS_SERVING})")
    if worst > TOL_PALLAS_SERVING:
        raise AssertionError("Pallas-mode pitch-accent serving disagrees")

    # the kernels at the path's shapes, against their plain versions
    heads = hp.self_attention_num_heads
    D = hp.self_attention_out_units // heads
    errs = {"fused_self_attention": 0.0, "incremental_attention_step": 0.0}
    for u in utts:
        q, k, v = (_normal(device, 1, heads, u.source_length, D, seed=s)
                   for s in range(3))
        err = _max_err(pa.fused_self_attention(q, k, v, False),
                       pa.fused_self_attention_reference(q, k, v, False))
        errs["fused_self_attention"] = max(errs["fused_self_attention"],
                                           err)
    dh = hp.decoder_self_attention_num_heads
    Dd = hp.decoder_self_attention_out_units // dh
    S = hp.max_iters
    kc, vc = (_normal(device, 1, dh, S, Dd, seed=s) for s in (4, 5))
    for t in (*PITCH_STEP_TS, S - 1):
        q = _normal(device, 1, dh, Dd, seed=6 + t)
        err = _max_err(pa.incremental_attention_step(q, kc, vc, t),
                       pa.incremental_attention_step_reference(q, kc, vc, t))
        errs["incremental_attention_step"] = max(
            errs["incremental_attention_step"], err)
    _sync(device)
    log(f"phase 26 pitch_accent kernels vs plain at the path's shapes "
        f"(fused_self_attention B=1 H={heads} T=source lengths "
        f"{[u.source_length for u in utts]} D={D}; "
        f"incremental_attention_step B=1 H={dh} S={S} D={Dd} t in "
        f"{[*PITCH_STEP_TS, S - 1]}): max abs err {errs}")
    if max(errs.values()) > TOL_ATTENTION:
        raise AssertionError(f"a Pallas-mode kernel disagrees (tol "
                             f"{TOL_ATTENTION})")
    return launches, errs


def _pitch_accent(device, card, tmp):
    """The paper's configuration (``entry.PITCH_ACCENT`` over the codes
    recipe): 3 ``cli.train`` steps at B = 32 with one evaluation, then
    serving on the plain path and in the Pallas mode.  Returns (launch
    counts of the Pallas-mode serving, kernel errors)."""
    import json as js
    import math
    import re
    import numpy as np
    import torch
    from self_attention_tacotron_torch.cli.train import main as train_main
    from self_attention_tacotron_torch.config import default_hparams
    from self_attention_tacotron_torch.data.records import read_first_example
    from self_attention_tacotron_torch.entry import PITCH_ACCENT
    from self_attention_tacotron_torch.ops import fused_train as ft
    with open(RECIPE) as f:
        recipe = dict(js.load(f), **PITCH_ACCENT)
    hp_json = os.path.join(tmp, "pitch_accent.json")
    with open(hp_json, "w") as f:
        js.dump(recipe, f)
    hp = default_hparams().parse_json_file(hp_json)
    data = os.path.join(tmp, "pitch_accent_data")
    ckpt = os.path.join(tmp, "pitch_accent_ckpt")
    os.makedirs(data)
    write_pitch_accent_corpus(hp, data)
    log(f"phase 26 pitch_accent: {hp.tacotron_model}, {hp.encoder}, "
        f"{hp.decoder}; {hp.num_mgcs} mgcs, {hp.num_lf0s} lf0 classes over "
        f"{hp.f0_min:g}-{hp.f0_max:g} Hz, {hp.num_accent_type} accent types "
        f"of {hp.accent_type_embedding_dim}, prenets "
        f"{hp.encoder_prenet_out_units_if_accent} and "
        f"{hp.accent_type_prenet_out_units}, lf0_loss_factor "
        f"{hp.lf0_loss_factor}; {PITCH_ACCENT_UTTERANCES} utterances")
    ft.fused_train_fwd.launches = ft.fused_train_bwd.launches = 0
    t0 = time.perf_counter()
    with _Fallbacks() as fb, torch.enable_grad():
        rc = train_main(["--source-data-root", data, "--target-data-root",
                         data, "--checkpoint-dir", ckpt,
                         "--hparam-json-file", hp_json, "--max-steps", "3",
                         "--dataset-kind", "mgclf0", "--hparams",
                         PITCH_ACCENT_EVAL, "--device", device.type])
    wall = time.perf_counter() - t0
    with open(os.path.join(ckpt, os.path.basename(hp.logfile))) as f:
        text = f.read()
    losses = [float(m.group(2)) for m in re.finditer(
        r"step (\d+) loss ([-+0-9.eEinfa]+) \(([0-9.]+)s\)", text)]
    secs = [float(m.group(3)) for m in re.finditer(
        r"step (\d+) loss ([-+0-9.eEinfa]+) \(([0-9.]+)s\)", text)]
    evals = re.findall(r"eval @(\d+): (\{.*?\}) \((\d+) utterances, "
                       r"([0-9.]+)s\)", text)
    artifacts = sorted(os.listdir(os.path.join(ckpt, "eval")))
    records = [a for a in artifacts if a.endswith(".tfrecord")]
    log(f"phase 26 pitch_accent cli.train: 3 steps at B={hp.batch_size} in "
        f"{wall:.1f} s (start included); losses {losses}; s a step {secs}; "
        f"evaluations {evals}; eval artifacts {artifacts}; training kernel "
        f"launches fwd {ft.fused_train_fwd.launches} bwd "
        f"{ft.fused_train_bwd.launches}; gates that took the plain path: "
        f"{fb.refused or 'none'}; card {card}")
    if rc != 0 or len(losses) != 3 or not all(map(math.isfinite, losses)):
        raise AssertionError("pitch-accent training failed")
    if len(evals) != 1 or "mgc_loss_with_teacher" not in evals[0][1]:
        raise AssertionError("the pitch-accent evaluation did not run")
    if not any("output_kind='mgclf0' is not fused" in m for m in fb.refused):
        raise AssertionError("the training gate did not log its reason")
    ex = read_first_example(os.path.join(ckpt, "eval", records[0]))
    lf0 = np.frombuffer(ex["lf0"][1][0], np.float32).reshape(-1, hp.num_lf0s)
    if len(records) != 1 or not np.allclose(lf0.sum(-1), 1.0, atol=1e-4):
        raise AssertionError("no MGC/LF0 prediction record with the lf0 "
                             "softmax")
    return _pitch_accent_serving(hp, ckpt, data, device, card)


def phase_model_surface(device, card: str, data: str, tmp: str, rows):
    """Phase 26: ``TransformerDecoder`` on #1-#4 and the pitch-accent
    configuration (its Pallas mode on #5 and #6).  Returns (rows, launch
    counts)."""
    t0 = time.perf_counter()
    new_rows, launches = _transformer_decoder(device, card, data, tmp, rows)
    pallas, errs = _pitch_accent(device, card, tmp)
    launches["pitch_accent_pallas_serving"] = {
        k: pallas["pallas"][k] for k in ("fused_self_attention",
                                         "incremental_attention_step")}
    for name in ("fused_self_attention", "incremental_attention_step"):
        new_rows += [dict(r, max_abs_err=errs[name]) for r in _reused_rows(
            rows, name, "pallas_serving", "pitch_accent_pallas_serving",
            launches["pitch_accent_pallas_serving"][name])]
    log(f"phase 26 the rest of the model surface took "
        f"{time.perf_counter() - t0:.1f} s")
    return new_rows, launches


# ------------------------------------------------- model-wide bf16 (27)

BF16_MODEL = "compute_dtype=bfloat16"
BF16_EVAL = ("eval_start_delay_secs=0,eval_throttle_secs=0,"
             "save_checkpoints_steps=3,num_evaluation_steps=2")
BF16_COMPARE_STEPS = 10
# bf16 training against float32 from one initialisation: every loss
# within 5 % (the JAX package's own bf16 trajectory test's bound)
TOL_BF16_LOSS = 5e-2
# a bf16 instance of #5 / #6 against its plain version (f32 math on the
# same bf16 inputs, rounded once): within 1e-2 of the plain output's
# largest magnitude, as phase 20's bf16 storage mode (one bf16 ulp is
# 2^-8 = 3.9e-3 relative; the f32 sums' order can move a value across a
# rounding boundary)
TOL_BF16_ATTENTION = 1e-2
# (name, B, T or S, D, causal or None for a cache step) of the timed
# bf16 instances: the serving hop, the training shape causal and not, the
# serving cache, the wide kernels
BF16_ATTENTION_SHAPES = (
    ("fused_self_attention", 1, T_IN, 16, False),
    ("fused_self_attention", TRAIN_B, 256, ATTN_D, False),
    ("fused_self_attention", TRAIN_B, 256, ATTN_D, True),
    ("incremental_attention_step", 1, SERVE_S, ATTN_D, None),
    ("fused_self_attention", 1, SERVE_S, 256, True),
    ("incremental_attention_step", 1, 3000, 512, None))


def bf16_attention_bound(B, T, D, causal):
    """(bytes, FLOPs) of the full-sequence attention with bf16 operands:
    q, k, v read and the output written once, 2 bytes an element."""
    nbytes, flops = attention_bound(B, T, D, causal)
    return nbytes // 2, flops


def bf16_step_bound(B, t, D):
    nbytes, flops = step_bound(B, t, D)
    return nbytes // 2, flops


def _bf16_attention_case(device, name, B, T, D, causal):
    """(kernel call, plain call, SDPA call, bound) of one bf16 instance at
    its shape (a cache step at t = S - 1).  Its bound takes the products
    at the bf16 tensor cores' peak: bf16 operands, float32 sums."""
    import torch
    import torch.nn.functional as F
    from self_attention_tacotron_torch.ops import pallas_attention as pa
    bf = torch.bfloat16
    if causal is not None:
        q, k, v = (x.to(bf) for x in _attention_inputs(device, B, T, D))
        return (lambda: pa.fused_self_attention(q, k, v, causal),
                lambda: pa.fused_self_attention_reference(q, k, v, causal),
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=causal),
                bf16_attention_bound(B, T, D, causal))
    t = T - 1
    q, kc, vc = (x.to(bf) for x in _step_inputs(device, B, t, T, D))
    mask = torch.ones(1, 1, 1, T, dtype=torch.bool, device=device)
    return (lambda: pa.incremental_attention_step(q, kc, vc, t),
            lambda: pa.incremental_attention_step_reference(q, kc, vc, t),
            lambda: F.scaled_dot_product_attention(q[:, :, None], kc, vc,
                                                   attn_mask=mask)[:, :, 0],
            bf16_step_bound(B, t, D))


def _bf16_attention_kernels(device, card):
    """(d): each bf16 instance against its plain version and timed beside
    SDPA in bf16 (the library call, never called by the port) and its
    bound; the bf16 counter (the step's wide kernel: ``launches_wide``)
    moves by one a kernel call, the float32 one not at all.  Returns
    {name: (err, ms, plain_ms, bound, library_ms)} at the serving shape
    (the first of each name)."""
    import torch
    from self_attention_tacotron_torch.ops import pallas_attention as pa
    out = {}
    for name, B, T, D, causal in BF16_ATTENTION_SHAPES:
        kernel, plain, sdpa, bound = _bf16_attention_case(
            device, name, B, T, D, causal)
        fn = getattr(pa, name)
        # the step's wide kernel counts in launches_wide in either dtype
        wide = causal is None and D > pa.STEP_MAX_D

        def state():
            return (fn.launches, fn.launches_bf16,
                    getattr(fn, "launches_wide", 0))

        def counted(call, calls):
            before = state()
            result = call()
            want = (before[0], before[1] + (0 if wide else calls),
                    before[2] + (calls if wide else 0))
            if state() != want:
                raise AssertionError(
                    f"{name} at B={B} T={T} D={D}: {calls} calls moved the "
                    f"counters from {before} to {state()}")
            return result
        got, ref = counted(kernel, 1), plain()
        if got.dtype != ref.dtype:
            raise AssertionError(f"{name} wrote {got.dtype}")
        err = _max_err(got.float(), ref.float()) / max(
            float(ref.float().abs().max()), 1e-12)
        lib_err = _max_err(sdpa().float(), ref.float())
        # _device_ms calls once to warm up, then 5 runs of reps
        times = [counted(lambda: _device_ms(kernel, reps=20), 101),
                 _device_ms(plain, reps=20), _device_ms(sdpa, reps=20)]
        split = ""
        if causal is not None:   # the full sequence: its profiled split
            q, k, v = (x.to(torch.bfloat16)
                       for x in _attention_inputs(device, B, T, D))
            split = "; " + attention_split(pa, q, k, v, causal, times[0])
        log(f"phase 27 {name} bf16 B={B} H={ATTN_HEADS} "
            f"{'T' if causal is not None else 'S'}={T} D={D}"
            f"{'' if causal is None else f' causal={causal}'}: error "
            f"{err:.2e} of the plain version's largest magnitude (SDPA's "
            f"max abs {lib_err:.1e}); kernel {times[0]:.5f} ms, plain "
            f"{times[1]:.5f} ms, SDPA bf16 {times[2]:.5f} ms; bound "
            f"{_bound_ms(bound, PEAK_BF16_FLOP_PER_S):.6f} ms ({bound[0]} "
            f"bytes, {bound[1]} FLOPs at {PEAK_BF16_FLOP_PER_S / 1e12:g} "
            f"TFLOP/s){split}; card {card}")
        if err > TOL_BF16_ATTENTION:
            raise AssertionError(f"the bf16 {name} disagrees (tol "
                                 f"{TOL_BF16_ATTENTION})")
        if causal is None and (name not in out or wide):
            twin = _step_twin_turns(device, kernel, B, T, D)
            log(f"phase 27 incremental_attention_step B={B} S={T} t={T - 1} "
                f"D={D} in turns with its f32 twin on the same values "
                f"(medians of {len(twin['bf16'])} rounds of 20 queued calls): "
                f"bf16 {statistics.median(twin['bf16']):.5f} ms, f32 "
                f"{statistics.median(twin['f32']):.5f} ms")
        out.setdefault(name, (err, times[0], times[1], bound, times[2]))
    return out


def _step_twin_turns(device, bf16_call, B, S, D):
    """{"bf16": [ms], "f32": [ms]}: the bf16 step at t = S - 1 and the f32
    step on the same values (the bf16 inputs upcast), in turns."""
    import torch
    from self_attention_tacotron_torch.ops import pallas_attention as pa
    q, kc, vc = (x.to(torch.bfloat16).float()
                 for x in _step_inputs(device, B, S - 1, S, D))
    return in_turns({
        "bf16": bf16_call,
        "f32": lambda: pa.incremental_attention_step(q, kc, vc, S - 1)}, 4)


def _bf16_train(hp, data, tmp, device, card):
    """(a): cli.train for 3 steps in bf16 with one evaluation, then
    BF16_COMPARE_STEPS train steps in bf16 and in float32 from one
    initialisation on the same batches.  Returns the checkpoint directory
    and the training kernels' launch counts."""
    import math
    import re
    import torch
    from self_attention_tacotron_torch.cli.train import main as train_main
    from self_attention_tacotron_torch.data.dataset import load_key_list
    from self_attention_tacotron_torch.models import tacotron_model_factory
    from self_attention_tacotron_torch.ops import fused_encoder as fe
    from self_attention_tacotron_torch.ops import fused_train as ft
    from self_attention_tacotron_torch.parallel import (create_train_state,
                                                        make_train_step)
    from self_attention_tacotron_torch.utils.convert import init_parameters
    keys = load_key_list(os.path.join(data, "train.csv"))[:2]
    with open(os.path.join(data, "validation.csv"), "w") as f:
        f.write("\n".join(keys) + "\n")
    ckpt = os.path.join(tmp, "bf16_ckpt")
    ft.fused_train_fwd.launches = ft.fused_train_bwd.launches = 0
    fe.fused_encode.launches = 0
    t0 = time.perf_counter()
    with _Fallbacks() as fb, torch.enable_grad():
        rc = train_main(["--source-data-root", data, "--target-data-root",
                         data, "--checkpoint-dir", ckpt,
                         "--hparam-json-file", RECIPE, "--max-steps", "3",
                         "--hparams", f"{BF16_MODEL},{BF16_EVAL}",
                         "--device", device.type])
    wall = time.perf_counter() - t0
    counts = {"fused_train_fwd": ft.fused_train_fwd.launches,
              "fused_train_bwd": ft.fused_train_bwd.launches,
              "fused_encode": fe.fused_encode.launches}
    with open(os.path.join(ckpt, os.path.basename(hp.logfile))) as f:
        text = f.read()
    steps = re.findall(r"step (\d+) loss ([-+0-9.eEinfa]+) \(([0-9.]+)s\)",
                       text)
    evals = re.findall(r"eval @3: (\{.*?\})", text)
    log(f"phase 27 (a) cli.train --hparams {BF16_MODEL}: 3 steps at B="
        f"{hp.batch_size} in {wall:.1f} s (start and evaluation included); "
        f"(step, loss, s) {steps}; eval @3 {evals}; launch counts {counts}; "
        f"gates that refused: {fb.refused or 'none'}; card {card}")
    if rc != 0 or len(steps) != 3 or not all(
            math.isfinite(float(s[1])) for s in steps):
        raise AssertionError("bf16 training failed")
    if len(evals) != 1:
        raise AssertionError("the bf16 evaluation did not run")
    if fb.refused or (device.type == "cuda" and (
            counts["fused_train_fwd"], counts["fused_train_bwd"]) != (3, 3)):
        raise AssertionError(f"bf16 training launched {counts}")

    # the corpus' batches in turn (64 utterances: 2 batches of 32)
    batches = [b.to(device) for b in _train_batches(hp, data)]
    batches = [batches[i % len(batches)] for i in range(BF16_COMPARE_STEPS)]
    losses, step_ms = {}, {}
    for name in ("float32", "bfloat16"):
        h = recipe_hparams()
        h.set_hparam("compute_dtype", name)
        model = init_parameters(tacotron_model_factory(h), SEED).to(device)
        state, step = create_train_state(model, h), make_train_step(h)
        losses[name], step_ms[name] = [], []
        with torch.enable_grad():
            for b in batches:
                _sync(device)
                t0 = time.perf_counter()
                losses[name].append(float(step(state, b)["loss"]))
                step_ms[name].append((time.perf_counter() - t0) * 1e3)
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses["bfloat16"],
                                                    losses["float32"]))
    log(f"phase 27 (a) {BF16_COMPARE_STEPS} train steps at B={TRAIN_B} from "
        f"one initialisation: float32 losses {losses['float32']}; bf16 "
        f"{losses['bfloat16']}; worst relative gap {worst:.3e} (tol "
        f"{TOL_BF16_LOSS}); ms a step (host clock, after the first) float32 "
        f"median {statistics.median(step_ms['float32'][1:]):.1f}, bf16 "
        f"median {statistics.median(step_ms['bfloat16'][1:]):.1f}; card "
        f"{card}")
    if worst > TOL_BF16_LOSS:
        raise AssertionError("bf16 training left the float32 trajectory")
    return ckpt, {k: v for k, v in counts.items() if k != "fused_encode"}


def _bf16_serve(data, ckpt, tmp, device, card, hparams, tag):
    """``_serve`` with every counter of #1, #2, #5 and #6 (both instances
    of the last two), logged; no gate may refuse."""
    from self_attention_tacotron_torch.ops import fused_decode as fd
    from self_attention_tacotron_torch.ops import fused_encoder as fe
    from self_attention_tacotron_torch.ops import pallas_attention as pa
    keys, counts, steps, ms, refused = _serve(
        data, ckpt, os.path.join(tmp, f"bf16_pred_{tag}"), device, hparams,
        ((fe.fused_encode, "launches"), (fd.fused_decode, "launches"),
         *((fn, attr) for fn in (pa.fused_self_attention,
                                 pa.incremental_attention_step)
           for attr in ("launches", "launches_bf16"))))
    log(f"phase 27 main_code --hparams '{hparams}': {steps} decode steps, "
        f"ms a call (host clock) {ms}; launch counts {counts}; gates that "
        f"refused: {refused or 'none'}; card {card}")
    if refused:
        raise AssertionError("a gate refused the bf16 model")
    return keys, counts, steps, ms


def _bf16_agreement(data, keys, ckpt, device, card):
    """(b): the code argmax of the bf16 model against the float32 model's
    on the same checkpoint, teacher-forced over ``keys``."""
    import torch
    from self_attention_tacotron_torch.data.dataset import (
        dataset_factory, find_dataset_files, to_model_batch)
    from self_attention_tacotron_torch.models import tacotron_model_factory
    from self_attention_tacotron_torch.utils.convert import load_checkpoint
    outs = {}
    for name in ("float32", "bfloat16"):
        h = recipe_hparams()
        h.set_hparam("compute_dtype", name)
        nb = next(iter(dataset_factory(
            find_dataset_files(data, keys, h.source_file_extension),
            find_dataset_files(data, keys, h.target_file_extension), h,
            batch_size=len(keys), shuffle=False)))
        model = tacotron_model_factory(h).eval()
        load_checkpoint(model, ckpt)
        model.to(device)
        batch = to_model_batch(nb).to(device)
        outs[name] = model.validation_forward(batch, True)
    mask = batch.spec_loss_mask.bool()
    agree = float((outs["float32"].outputs.argmax(-1)
                   == outs["bfloat16"].outputs.argmax(-1))[mask].float()
                  .mean())
    err = _max_err(outs["bfloat16"].outputs.float(),
                   outs["float32"].outputs)
    log(f"phase 27 (b) teacher-forced VALIDATION of the 3 utterances: code "
        f"argmax of bf16 against float32 agrees at {agree:.4f} of "
        f"{int(mask.sum())} frames; logits max abs diff {err:.3e}; outputs "
        f"{outs['bfloat16'].outputs.dtype}; card {card}")
    if outs["bfloat16"].outputs.dtype != torch.bfloat16 or not bool(
            torch.isfinite(outs["bfloat16"].outputs.float()).all()):
        raise AssertionError("the bf16 model's outputs are not finite bf16")
    return agree


def phase_model_bf16(device, card: str, tmp: str, rows):
    """Phase 27: ``compute_dtype=bfloat16`` at the codes recipe's full
    width: (a) training through #3 / #4 with one evaluation and its losses
    against float32, (b) serving through #1 / #2 and the argmax agreement
    with float32, (c) Pallas-mode serving through the bf16 instances of #5
    / #6, (d) those instances against their plain versions, timed.
    Returns (rows, launch counts)."""
    import torch
    t0 = time.perf_counter()
    hp = recipe_hparams()
    data = os.path.join(tmp, "bf16_data")
    os.makedirs(data)
    write_train_corpus(hp, data)
    launches = {}
    ckpt, launches["bf16_model_training"] = _bf16_train(hp, data, tmp,
                                                        device, card)
    keys, served, _, bf16_ms = _bf16_serve(data, ckpt, tmp, device, card,
                                           BF16_MODEL, "fused")
    _, _, _, f32_ms = _bf16_serve(data, ckpt, tmp, device, card, "",
                                  "fused32")
    log(f"phase 27 (b) main_code ms a call, bf16 {bf16_ms} against float32 "
        f"{f32_ms} (host clock, one call each; card {card})")
    launches["bf16_model_serving"] = {k: served[k] for k in (
        "fused_encode", "fused_decode")}
    if device.type == "cuda" and launches["bf16_model_serving"] != {
            "fused_encode": 3, "fused_decode": 3}:
        raise AssertionError(f"bf16 serving launched {served}")
    _bf16_agreement(data, keys, ckpt, device, card)
    _, pallas, steps, _ = _bf16_serve(data, ckpt, tmp, device, card,
                                      f"{BF16_MODEL},{PALLAS_SERVING}",
                                      "pallas")
    want = {"fused_self_attention_bf16": 3 * hp.self_attention_num_hop,
            "incremental_attention_step_bf16":
                sum(steps) * hp.decoder_self_attention_num_hop,
            "fused_self_attention": 0, "incremental_attention_step": 0}
    got = {k: pallas[k] for k in want}
    if device.type == "cuda" and got != want:
        raise AssertionError(f"bf16 Pallas-mode serving launched {got}, "
                             f"expected {want}")
    launches["bf16_pallas_serving"] = got
    # the served logits against the bf16 einsum path's, at phase 20's bf16
    # tolerances (the kernels round once, the einsum path at each op)
    pairs = _pallas_pairs(ckpt, data, keys, device, BF16_MODEL)
    head = max(_max_err(g[:, :BF16_HEAD_STEPS].float(),
                        r[:, :BF16_HEAD_STEPS].float()) for g, r in pairs)
    agree = (sum(int((g.argmax(-1) == r.argmax(-1)).sum()) for g, r in pairs)
             / sum(g.shape[1] for g, _ in pairs))
    finite = all(bool(g.float().isfinite().all()) for g, _ in pairs)
    log(f"phase 27 (c) bf16 Pallas-mode logits against the bf16 einsum path "
        f"({[g.shape[1] for g, _ in pairs]} steps): max abs err first "
        f"{BF16_HEAD_STEPS} steps {head:.3e}; code argmax agreement "
        f"{agree:.4f}; finite {finite}; dtype {pairs[0][0].dtype}")
    if (head > TOL_BF16_DECODE_HEAD or agree < BF16_MIN_AGREE or not finite
            or pairs[0][0].dtype != torch.bfloat16):
        raise AssertionError("bf16 Pallas-mode logits disagree with the "
                             "bf16 einsum path")
    timed = _bf16_attention_kernels(device, card)
    # #1-#4 run their float32 instances at phases 8's shapes: those rows
    # with this run's counts; #5 / #6 their new bf16 instances
    new_rows = []
    for name, path, src in (
            ("fused_encode", "bf16_model_serving", "serving"),
            ("fused_decode", "bf16_model_serving", "serving"),
            ("fused_train_fwd", "bf16_model_training", "training"),
            ("fused_train_bwd", "bf16_model_training", "training")):
        new_rows += _reused_rows(rows, name, src, path, launches[path][name])
    for name, src, line in (
            ("fused_self_attention", "self_attention", 39),
            ("incremental_attention_step", "incremental_attention", 109)):
        err, ms, plain, bound, lib = timed[name]
        new_rows += _kernel_rows(
            f"{name}_bf16", src, f"pallas_attention.py:{line}",
            {"bf16_pallas_serving": launches["bf16_pallas_serving"]}, err,
            ms, plain, bound, lib, peak_flops=PEAK_BF16_FLOP_PER_S)
    log(f"phase 27 model-wide bf16 took {time.perf_counter() - t0:.1f} s")
    return new_rows, launches


TOL_TARGETLESS = 1e-5     # the served batches against both references


def _serve_batches(model, batches, device):
    """``make_predict_step`` over one-utterance batches as they come;
    returns ({key: output}, the batches)."""
    from self_attention_tacotron_torch.data.dataset import to_model_batch
    from self_attention_tacotron_torch.parallel import make_predict_step
    step = make_predict_step(model.hp)
    served, seen = {}, []
    for nb in batches:
        seen.append(nb)
        (served[nb.meta[0].key],) = step(model, to_model_batch(nb).to(device))
    return served, seen


def _targetless_errors(got, ref, hp, whole: bool):
    """{what: largest abs error} of one served utterance against a
    reference; ``whole`` compares every step, else the decoded ones (past
    its stop the early-exit loop leaves zeros, the plain loop its own)."""
    s = int(ref.lengths[0])
    if int(got.lengths[0]) != s:
        raise AssertionError(f"the stop steps differ: {int(got.lengths[0])} "
                             f"against {s}")
    f = got.outputs.shape[1] if whole else s * hp.outputs_per_step
    n = got.alignments[0].shape[-1] if whole else s
    agree = bool((got.outputs[:, :f].argmax(-1)
                  == ref.outputs[:, :f].argmax(-1)).all())
    if not agree:
        raise AssertionError("the code argmax differs")
    return {"outputs": _max_err(got.outputs[:, :f], ref.outputs[:, :f]),
            "alignments": max(_max_err(a[..., :n], b[..., :n]) for a, b in
                              zip(got.alignments, ref.alignments))}


def phase_targetless_serving(model, device, card: str, tmp: str, rows):
    """Phase 28: targetless (predict-time) batches of the codes recipe
    served on the card: ``Dataset(sources, None, hp, batch_size=1)``
    through ``prefetch``, each batch through ``make_predict_step`` (one #1
    and one #2 launch), held against the targeted ``Dataset``'s batches of
    the same utterances (the same source pads), against the plain path
    with the fused flags off, and against the same batches served again
    (#1 and #2 on the same inputs, call to call).  Returns (rows, launch
    counts)."""
    from self_attention_tacotron_torch.data.dataset import (
        Dataset, find_dataset_files)
    from self_attention_tacotron_torch.ops import fused_decode as fd
    from self_attention_tacotron_torch.ops import fused_encoder as fe
    t0 = time.perf_counter()
    hp = model.hp
    data = os.path.join(tmp, "targetless_data")
    os.makedirs(data)
    keys = write_corpus(hp, data)
    src, tgt = (find_dataset_files(data, keys, ext) for ext in
                (hp.source_file_extension, hp.target_file_extension))
    fe.fused_encode.launches = 0
    fd.fused_decode.launches = 0
    served, batches = _serve_batches(model, Dataset(
        src, None, hp, batch_size=1, shuffle=False).prefetch(), device)
    counts = {"fused_encode": fe.fused_encode.launches,
              "fused_decode": fd.fused_decode.launches}
    serve_s = time.perf_counter() - t0
    if (len(batches) != len(keys)
            or any(nb.target is not None or nb.done is not None
                   or len(nb.meta) != 1 for nb in batches)):
        raise AssertionError("the targetless Dataset's batches are not one "
                             "targetless utterance each")
    targeted = list(Dataset(src, tgt, hp, batch_size=1, shuffle=False))
    pads = {nb.meta[0].key: nb.source for nb in targeted}
    if any(not (pads[nb.meta[0].key] == nb.source).all() for nb in batches):
        raise AssertionError("the targeted batches' sources differ")
    plain = make_model(_hp_with(RECIPE, PLAIN), device)
    plain.load_state_dict(model.state_dict())
    refs = {"targeted": _serve_batches(model, targeted, device)[0],
            "plain path": _serve_batches(plain, batches, device)[0],
            "run to run": _serve_batches(model, batches, device)[0]}
    errs = {}
    for name, ref in refs.items():
        found = [_targetless_errors(served[k], ref[k], hp,
                                    whole=name != "plain path")
                 for k in keys]
        errs[name] = {w: max(f[w] for f in found) for w in found[0]}
    log(f"phase 28 targetless serving: {len(batches)} targetless batches "
        f"(source pads {[nb.source.shape[1] for nb in batches]}) through "
        f"prefetch and make_predict_step on {device.type} in {serve_s:.2f} "
        f"s; stop steps {[int(served[k].lengths[0]) for k in keys]}; "
        f"launch counts {counts}; max abs err against the targeted batches "
        f"{errs['targeted']}, against the plain path {errs['plain path']}, "
        f"run to run {errs['run to run']} (tol {TOL_TARGETLESS}; card "
        f"{card})")
    if max(e for d in errs.values() for e in d.values()) > TOL_TARGETLESS:
        raise AssertionError("targetless serving disagrees with a reference")
    if device.type == "cuda" and counts != {"fused_encode": len(keys),
                                            "fused_decode": len(keys)}:
        raise AssertionError(f"targetless serving launched {counts}")
    new_rows = []
    for name in ("fused_encode", "fused_decode"):
        new_rows += _reused_rows(rows, name, "serving", "targetless_serving",
                                 counts[name])
    log(f"phase 28 targetless serving took {time.perf_counter() - t0:.1f} s")
    return new_rows, {"targetless_serving": counts}


def phase_barriers(card: str):
    """Phase 2: the cost of one grid-wide barrier at one block per SM,
    cooperative groups' (the fused encoder's) beside the hand-written ones
    (``scripts/torch_grid_barrier_probe.py``; GridBarrier is the fused
    decode's)."""
    import importlib.util
    import torch
    spec = importlib.util.spec_from_file_location(
        "torch_grid_barrier_probe",
        os.path.join(ROOT, "scripts", "torch_grid_barrier_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    costs = probe.barrier_costs(sms)
    log(f"phase 2 grid barrier ({sms} blocks, 20000 in a launch): " + ", ".join(
        f"{k} {v:.3f} us" for k, v in costs.items()) + f"; card {card}")


def main() -> int:
    global CARD
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is missing: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from self_attention_tacotron_torch.ops import cuda_build
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing: {e}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.set_grad_enabled(False)
    device = torch.device("cuda", 0)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        log(f"phase 1 card: {smi[0] if smi else 'nvidia-smi gave nothing'}"
            f"; torch {torch.__version__} CUDA {torch.version.cuda}")
        card = smi[0] if smi else torch.cuda.get_device_name(0)
        CARD = card
        matmul = torch.backends.cuda.matmul
        log(f"phase 1 precision: matmul.allow_tf32 {matmul.allow_tf32}, "
            f"cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}, "
            "matmul.allow_bf16_reduced_precision_reduction "
            f"{matmul.allow_bf16_reduced_precision_reduction}")
        log(card)

        t0 = time.perf_counter()
        kernels = ["fused_encoder", "fused_decode", "fused_train_fwd",
                   "fused_train_bwd", "self_attention",
                   "incremental_attention", "spectrogram",
                   "grid_barrier_probe"]
        logs = cuda_build.build_all(kernels)
        log(f"phase 2 built {', '.join(kernels)} in "
            f"{time.perf_counter() - t0:.1f} s")
        for name, text in logs.items():
            for line in text.splitlines():
                if "registers" in line or "smem" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")
        phase_barriers(card)

        hp = recipe_hparams()
        model = make_model(hp, device)
        steps = hp.max_iters
        errs = {"fused_encode": phase_encode(model, device),
                "fused_decode": phase_decode(model, device, steps)}
        # launch counts per main path, each from its own zeroed run
        launches = {"serving": phase_end_to_end(model, "cuda")}
        errs.update(phase_train_kernels(model, device))
        errs.update(phase_attention_kernels(device))
        with tempfile.TemporaryDirectory() as tmp:
            data = os.path.join(tmp, "train_data")
            os.makedirs(data)
            write_train_corpus(hp, data)
            launches["training"] = phase_train_end_to_end(hp, data, tmp,
                                                          "cuda")
            ckpt, val_keys, launches["evaluation"] = phase_train_with_eval(
                data, tmp, "cuda")
            launches["pallas_serving"] = phase_pallas_serving(ckpt, data,
                                                              tmp, device)
            rows, codes_timing = phase_timing(model, device, steps, launches,
                                              errs)
            rows += phase_train_timing(model, device, data, launches, errs)
            rows += phase_attention_timing(device, launches, errs, ckpt, data,
                                           val_keys)
            spec_err, spec_timing = phase_spectrogram(device)
            spec_times, spec_bound = spec_timing["LJSpeech"]
            mel_data, mel_hp, launches["preprocessing"] = phase_preprocess(
                tmp, device)
            rows += _kernel_rows(
                "spectrogram", "spectrogram", "stft.py:65",
                {"preprocessing": launches["preprocessing"]}, spec_err,
                *spec_times[:2], spec_bound, spec_times[2])
            mel_ckpt = phase_mel_training(mel_data, mel_hp, tmp, device)
            launches["mel_serving"], mel_rows = phase_mel_serving(
                mel_data, mel_ckpt, mel_hp, tmp, device)
            rows += mel_rows
            rows += vctk_and_row_modes(tmp, device, hp, codes_timing, errs,
                                       spec_err, spec_timing["VCTK"],
                                       launches)
            bf16_rows, bf16_launches = phase_bf16(hp, model, device, data,
                                                  tmp)
            rows += bf16_rows
            launches.update(bf16_launches)
            forced = phase_forced_alignment(model, mel_data, mel_ckpt,
                                            mel_hp, tmp, device)
            launches.update(forced)
            rows += forced_rows(forced, errs, codes_timing, mel_rows)
        siwis_rows, siwis_launches = phase_siwis(device, card)
        rows += siwis_rows
        launches.update(siwis_launches)
        edge_rows, edge_launches = phase_edges(model, device, card)
        rows += edge_rows
        launches.update(edge_launches)
        with tempfile.TemporaryDirectory() as tmp:
            data = os.path.join(tmp, "train_data")
            os.makedirs(data)
            write_train_corpus(hp, data)
            entry_rows, entry_launches, loop_split = phase_entry_points(
                model, device, card, data, tmp, rows, codes_timing)
            rows += entry_rows
            launches.update(entry_launches)
            dp_rows, dp_launches = phase_data_parallel(
                model, device, card, data, tmp, rows, loop_split)
            rows += dp_rows
            launches.update(dp_launches)
            surface_rows, surface_launches = phase_model_surface(
                device, card, data, tmp, rows)
            rows += surface_rows
            launches.update(surface_launches)
            bf16_rows, bf16_launches = phase_model_bf16(device, card, tmp,
                                                        rows)
            rows += bf16_rows
            launches.update(bf16_launches)
            targetless_rows, targetless_launches = phase_targetless_serving(
                model, device, card, tmp, rows)
        rows += targetless_rows
        launches.update(targetless_launches)
        log("launch counts of each main path: " + "; ".join(
            f"{path} {counts}" for path, counts in launches.items()))
        print(json.dumps({"kernels": rows}), flush=True)
    except Exception as e:  # noqa: BLE001 - every phase failure ends here
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
