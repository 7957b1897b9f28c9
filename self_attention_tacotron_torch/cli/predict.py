"""Prediction: batch-1 serving -> .mfbsp dumps + prediction records.

Counterpart of the JAX package's ``cli/predict.py`` ``main_code`` and
``main_mel``: reads the selected source and target records one utterance
at a time, restores the port's checkpoint, decodes each utterance
(free-running, up to ``max_iters`` steps) and writes
``<key>.<predicted_mel_extension>`` and ``<key>.tfrecord``:

* ``main_code`` — the one-hot codes as float32 and a prediction record
  (at most ``--limit`` utterances, 10 by default, as in the reference);
* ``main_mel`` — the predicted mel frames (the postnet's when
  ``use_postnet_v2``, the decoder's otherwise) and a mel prediction record
  with the normalised ground truth and the first source's alignment.

Each utterance goes through ``parallel.make_predict_step``, and its
alignment plot ``<key>.png`` (``utils/metrics.plot_predictions``: the
source alignments, the first two decoder self-attention alignments, the
predicted codes or the raw and postnet mels) comes from
``make_alignment_replay`` where the fused decode or the Pallas attention
mode serves it (they materialise no self-attention probabilities): the
utterance is decoded once more on the plain module path, with the same
weights (its outputs' distance from the served pass is printed).
matplotlib is optional: where it is not installed the run says once that
no PNG is written and carries on, with no replay.  With
``--hparams use_forced_alignment_mode=true`` it decodes twice: the first
pass free-running (the fused kernels where their gates let it), the second
in VALIDATION over the utterance's target steps (its target padded to its
bucket's length, as the JAX CLI's merged batch does), replaying the first
pass's alignments on the plain path; the dump and the record come from the
second pass's output and lengths.  It prints each utterance's decode steps
(of each pass) and wall time (the replay's beside it).  Runs on ``cuda``
unless ``--device cpu``.
The model logs which path serves the encoder's and the decoder's
self-attention, as its gates chose it: the fused kernels
(``encoder_fused_inference``, ``decoder_fused_inference``), the Pallas
attention mode (``use_pallas_attention`` with the fused paths off:
``--hparams use_pallas_attention=true,decoder_fused_inference=false,
encoder_fused_inference=false``) or the einsum module path.

    python -m self_attention_tacotron_torch.cli.predict \\
        --source-data-root DIR --target-data-root DIR \\
        --checkpoint-dir DIR --output-dir DIR \\
        --hparam-json-file examples/codes/self-attention-tacotron.json

serves the codes recipe (``main_code``); a first argument ``mel`` runs
``main_mel`` instead, with ``--hparam-json-file`` naming the mel recipe
and its corpus statistics (``python -m
self_attention_tacotron_torch.cli.predict mel --source-data-root ...``).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np
import torch


def build_argparser(kind: str = "codes") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--source-data-root", required=True)
    p.add_argument("--target-data-root", required=True)
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--selected-list-dir", default=None)
    p.add_argument("--list-filename", default="test.csv")
    p.add_argument("--hparams", default="")
    p.add_argument("--hparam-json-file", default=None)
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint step to restore (default: the newest)")
    p.add_argument("--limit", type=int,
                   default=10 if kind == "codes" else None)
    p.add_argument("--device", default="cuda")
    return p


def make_alignment_replay(hp, model):
    """The plot-mode replay for the fast serving paths, or None where the
    configured paths already give the alignments.

    The fused decode kernel and the Pallas attention mode do not
    materialise self-attention probabilities, and the reference's alignment
    plots are its main integration check; so with ``decoder_fused_inference``
    or ``use_pallas_attention`` each plotted utterance is decoded once more
    by a copy of ``model`` (the same weights) built with both flags off,
    and the plot takes its alignments from there (the JAX package's
    ``cli/predict.py`` ``make_alignment_replay``).  Returns ``replay(batch)
    -> TacotronOutput``."""
    if not (hp.use_pallas_attention or hp.decoder_fused_inference):
        return None
    from ..models import tacotron_model_factory
    from ..parallel import make_predict_step
    hp_plot = hp.replace(use_pallas_attention=False,
                         decoder_fused_inference=False)
    device = next(model.parameters()).device
    plot_model = tacotron_model_factory(hp_plot)
    plot_model.load_state_dict(model.state_dict())
    plot_model = plot_model.to(device).eval()
    replay_step = make_predict_step(hp_plot)

    def replay(batch):
        return replay_step(plot_model, batch)[-1]

    return replay


def predict(kind: str, argv=None) -> int:
    args = build_argparser(kind).parse_args(argv)
    from ..config import load_hparams
    from ..data.dataset import (Bucketing, find_dataset_files,
                                iter_utterances, load_key_list, pad_batch,
                                to_model_batch)
    from ..data.records import (MelPredictionRecord, PredictionRecord,
                                write_mel_prediction_record,
                                write_prediction_record)
    from ..models import Batch, tacotron_model_factory
    from ..parallel import make_predict_step
    from ..utils.convert import load_checkpoint
    from ..utils.metrics import NO_PNG, have_matplotlib, plot_predictions

    hp = load_hparams(args)
    logging.basicConfig(level=logging.INFO)
    log = logging.getLogger(f"predict_{kind}")
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    os.makedirs(args.output_dir, exist_ok=True)
    list_dir = args.selected_list_dir or args.source_data_root
    keys = load_key_list(os.path.join(list_dir, args.list_filename))
    src = find_dataset_files(args.source_data_root, keys,
                             hp.source_file_extension)
    tgt = find_dataset_files(args.target_data_root, keys,
                             hp.target_file_extension)

    model = tacotron_model_factory(hp).eval()
    step = load_checkpoint(model, args.checkpoint_dir,
                           int(args.checkpoint) if args.checkpoint else None)
    if step is None:
        log.error("no checkpoint found in %s", args.checkpoint_dir)
        return 1
    model.to(device)
    log.info("restored checkpoint step %d", step)

    count = 0
    r = hp.outputs_per_step
    predict_step = make_predict_step(hp)
    plots = have_matplotlib()
    if not plots:
        log.warning(NO_PNG)
    # the forced-alignment mode's second pass already runs the plain path
    replay = (make_alignment_replay(hp, model)
              if plots and not hp.use_forced_alignment_mode else None)
    if replay is not None:
        log.info("fast serving path configured; alignment plots come from "
                 "a plain-path replay of each utterance")
    said_no_png = not plots
    bucketing = Bucketing(hp)
    for u in iter_utterances(src, tgt, hp, kind):
        if args.limit is not None and count >= args.limit:
            break
        if hp.use_forced_alignment_mode:   # the second pass needs the target
            batch = to_model_batch(pad_batch(
                [u], hp, bucketing.target_pad_length(
                    bucketing.bucket_id(u.target_length)),
                target_kind=kind)).to(device)
        else:
            batch = Batch(source=torch.from_numpy(u.source[None]).to(device),
                          source_length=torch.tensor([u.source_length],
                                                     device=device),
                          speaker_id=torch.tensor([u.speaker_id],
                                                  device=device))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        passes = predict_step(model, batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        out = passes[-1]
        n_steps = int(out.lengths[0])
        n_frames = n_steps * r
        ground_truth = (u.target[:u.target_length] if u.target is not None
                        else np.zeros((0, hp.num_mels), np.float32))
        raw_mel = postnet_mel = None
        if kind == "codes":
            payload = out.code_output[0, :n_frames].cpu().numpy()
        else:   # the vocoder's input: the postnet's refinement when enabled
            raw_mel = out.outputs[0, :n_frames].cpu().numpy()
            if hp.use_postnet_v2:
                postnet_mel = out.postnet_outputs[0, :n_frames].cpu().numpy()
            payload = postnet_mel if hp.use_postnet_v2 else raw_mel

        mfbsp = os.path.join(args.output_dir,
                             f"{u.meta.key}.{hp.predicted_mel_extension}")
        payload.astype("<f4").tofile(mfbsp, format="<f4")
        replayed = ""
        plot_src = out
        if replay is not None:
            t0 = time.perf_counter()
            plot_src = replay(batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            ms = (time.perf_counter() - t0) * 1e3
            S = min(out.outputs.shape[1], plot_src.outputs.shape[1])
            err = float((plot_src.outputs[:, :S]
                         - out.outputs[:, :S]).abs().max())
            replayed = (f" (the alignment replay {ms:.3f} ms, "
                        f"{int(plot_src.lengths[0])} steps, its outputs "
                        f"within {err:.3e} of the served pass)")
        if plots:
            aligns = [a[0].cpu().numpy() for a in plot_src.alignments]
            aligns += [a[0].cpu().numpy() for a in
                       plot_src.decoder_self_attention_alignments[:2]]
            # the raw decoder mel beside the postnet's, as the reference
            if not plot_predictions(
                    aligns, ground_truth,
                    payload if kind == "codes" else raw_mel, u.meta.text,
                    u.meta.key,
                    os.path.join(args.output_dir, f"{u.meta.key}.png"),
                    predicted_postnet=postnet_mel) and not said_no_png:
                log.warning(NO_PNG)
                said_no_png = True
        record = os.path.join(args.output_dir, f"{u.meta.key}.tfrecord")
        source = u.source[:u.source_length]
        if kind == "codes":
            write_prediction_record(
                PredictionRecord(id=u.meta.id, key=u.meta.key, codes=payload,
                                 ground_truth_codes=ground_truth,
                                 text=u.meta.text, source=source), record)
        else:
            write_mel_prediction_record(
                MelPredictionRecord(
                    id=u.meta.id, key=u.meta.key, mel=payload,
                    ground_truth_mel=ground_truth,
                    alignment=out.alignments[0][0].cpu().numpy(),
                    text=u.meta.text, source=source), record)
        forced = (f" (forced-alignment pass after {int(passes[0].lengths[0])}"
                  " free-running steps)" if len(passes) > 1 else "")
        print(f"predicted {u.meta.key}: {n_steps} decode steps{forced}, "
              f"{wall * 1e3:.3f} ms wall on {device.type}{replayed}",
              flush=True)
        count += 1
    log.info("wrote %d predictions to %s", count, args.output_dir)
    return 0


def main_code(argv=None) -> int:
    return predict("codes", argv)


def main_mel(argv=None) -> int:
    return predict("mel", argv)


if __name__ == "__main__":
    argv = sys.argv[1:]
    kind = argv.pop(0) if argv[:1] in (["codes"], ["mel"]) else "codes"
    sys.exit(predict(kind, argv))
