"""Training CLI on one device: train, periodic checkpoints and evaluation.

Counterpart of the JAX package's ``cli/train.py`` ``main``: the same flags
(plus ``--device``, default ``cuda``), hparams layering (defaults ->
``--hparam-json-file`` -> ``--hparams``), key-list datasets
(``<selected-list-dir>/train.csv`` and ``validation.csv``), warm start,
resume from the newest checkpoint in ``--checkpoint-dir``, a checkpoint
every ``save_checkpoints_steps`` and a final one, and a ``step N loss L
(s)`` log line every ``log_step_count_steps``.  After a checkpoint, when
``EvalThrottle`` allows (``eval_start_delay_secs``, ``eval_throttle_secs``),
the first ``num_evaluation_steps`` validation utterances run through
``make_eval_step`` at batch 1 and the means of its seven metrics are
logged as ``eval @N`` (without a ``validation.csv`` there is no
evaluation).  Scalars go to ``<checkpoint-dir>/metrics.jsonl`` and a
TensorBoard event file (the eval ones under ``eval/``), the log also to
``<checkpoint-dir>/<hp.logfile>``.  The targets are codes or mel
spectrograms, by ``--dataset-kind`` or else by ``hp.dataset`` (the JAX
package's rule): the VQ-code recipe and the LJSpeech mel recipe
(``examples/ljspeech/tacotron.json``, with the corpus statistics that
``cli.preprocess`` writes to ``hparams.json`` merged in) train through the
same CLI.  Alignment plots, profiling and multi-device training are not
ported yet; the run says so once.

    python -m self_attention_tacotron_torch.cli.train \\
        --source-data-root DIR --target-data-root DIR --checkpoint-dir DIR \\
        --hparam-json-file examples/codes/self-attention-tacotron.json \\
        [--selected-list-dir DIR] [--hparams k=v,...] [--max-steps N] \\
        [--dataset-kind codes|mel] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from typing import Optional

import torch


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--source-data-root", required=True)
    p.add_argument("--target-data-root", required=True)
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--selected-list-dir", default=None)
    p.add_argument("--hparams", default="")
    p.add_argument("--hparam-json-file", default=None)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--dataset-kind", default=None, choices=["codes", "mel"],
                   help="the targets' kind (default: derived from "
                        "hp.dataset)")
    p.add_argument("--device", default="cuda")
    return p


class EvalThrottle:
    """EvalSpec cadence: evaluation follows a checkpoint, but not before
    ``start_delay_secs`` after the start of training and at most once per
    ``throttle_secs`` (tf.estimator ``EvalSpec(start_delay_secs,
    throttle_secs)``)."""

    def __init__(self, start_delay_secs: float, throttle_secs: float,
                 now: Optional[float] = None):
        self.start_delay_secs = float(start_delay_secs)
        self.throttle_secs = float(throttle_secs)
        self.start_time = time.time() if now is None else now
        self.last_eval_time: Optional[float] = None

    def should_eval(self, now: Optional[float] = None) -> bool:
        """True if an evaluation is due now; records its time when True."""
        now = time.time() if now is None else now
        if now - self.start_time < self.start_delay_secs:
            return False
        if (self.last_eval_time is not None
                and now - self.last_eval_time < self.throttle_secs):
            return False
        self.last_eval_time = now
        return True


def setup_logging(hp, checkpoint_dir: str) -> logging.Logger:
    os.makedirs(checkpoint_dir, exist_ok=True)
    log = logging.getLogger("train")
    log.setLevel(logging.INFO)
    log.propagate = False
    for h in list(log.handlers):     # an earlier run in this process
        log.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    for h in (logging.StreamHandler(sys.stdout), logging.FileHandler(
            os.path.join(checkpoint_dir, os.path.basename(hp.logfile)))):
        h.setFormatter(fmt)
        log.addHandler(h)
    return log


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from ..config import hparams_debug_string, load_hparams
    from ..data.dataset import (dataset_factory, find_dataset_files,
                                load_key_list, to_model_batch)
    from ..models import tacotron_model_factory
    from ..parallel import create_train_state, make_eval_step, make_train_step
    from ..utils.checkpoint import CheckpointManager, warm_start
    from ..utils.convert import init_parameters
    from ..utils.metrics import MetricsLogger

    hp = load_hparams(args)
    log = setup_logging(hp, args.checkpoint_dir)
    log.info(hparams_debug_string(hp))
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    log.warning("alignment plots and profiling are not ported yet: this "
                "run logs scalar metrics only")

    def files(keys):
        return (find_dataset_files(args.source_data_root, keys,
                                   hp.source_file_extension),
                find_dataset_files(args.target_data_root, keys,
                                   hp.target_file_extension))

    list_dir = args.selected_list_dir or args.source_data_root
    keys = load_key_list(os.path.join(list_dir, "train.csv"))
    val_list = os.path.join(list_dir, "validation.csv")
    val_keys = load_key_list(val_list) if os.path.exists(val_list) else []
    log.info("train %d validation %d", len(keys), len(val_keys))
    if not val_keys:
        log.warning("no utterances in %s: evaluation is off", val_list)
    kind_kw = {"target_kind": args.dataset_kind} if args.dataset_kind else {}
    train_ds = dataset_factory(*files(keys), hp, shuffle=True, repeat=True,
                               drop_remainder=True, batch_size=hp.batch_size,
                               seed=hp.seed, **kind_kw)
    val_files = files(val_keys)

    model = init_parameters(tacotron_model_factory(hp), hp.seed).to(device)
    state = create_train_state(model, hp)
    if hp.warm_start and hp.ckpt_to_initialize_from:
        copied = warm_start(model, hp.ckpt_to_initialize_from,
                            hp.vars_to_warm_start)
        log.info("warm started %d parameters from %s", len(copied),
                 hp.ckpt_to_initialize_from)
    ckpt = CheckpointManager(args.checkpoint_dir,
                             save_interval_steps=hp.save_checkpoints_steps,
                             max_to_keep=hp.keep_checkpoint_max)
    if ckpt.restore(state) is not None:
        log.info("resumed from step %d", state.step)

    train_step = make_train_step(hp)
    eval_step = make_eval_step(hp)
    metrics_log = MetricsLogger(args.checkpoint_dir)
    throttle = EvalThrottle(hp.eval_start_delay_secs, hp.eval_throttle_secs)

    def run_eval(step_no: int) -> None:
        t0 = time.perf_counter()
        n, acc = 0, {}
        for nb in dataset_factory(*val_files, hp, batch_size=1,
                                  shuffle=False, **kind_kw):
            if n >= hp.num_evaluation_steps:
                break
            metrics, _, _ = eval_step(state, to_model_batch(nb))
            for k, v in metrics.items():
                acc[k] = acc.get(k, 0.0) + float(v)
            n += 1
        if n:
            acc = {k: v / n for k, v in acc.items()}
            metrics_log.log(step_no, acc, prefix="eval/")
            log.info("eval @%d: %s (%d utterances, %.3fs)", step_no,
                     {k: round(v, 5) for k, v in acc.items()}, n,
                     time.perf_counter() - t0)

    t_last = time.perf_counter()
    try:
        for nb in train_ds:
            if args.max_steps is not None and state.step >= args.max_steps:
                break
            metrics = train_step(state, to_model_batch(nb))
            if state.step % hp.log_step_count_steps == 0:
                # float() waits for the device
                scalars = {k: float(v) for k, v in metrics.items()}
                scalars["sec_per_step"] = ((time.perf_counter() - t_last)
                                           / hp.log_step_count_steps)
                t_last = time.perf_counter()
                metrics_log.log(state.step, scalars)
                log.info("step %d loss %.5f (%.3fs)", state.step,
                         scalars["loss"], scalars["sec_per_step"])
            if ckpt.save(state.step, state):
                log.info("checkpoint @%d", state.step)
                if val_keys and throttle.should_eval():
                    run_eval(state.step)
        if ckpt.save(state.step, state, force=True):
            log.info("checkpoint @%d", state.step)
    finally:
        metrics_log.close()
    log.info("done at step %d", state.step)
    return 0


if __name__ == "__main__":
    sys.exit(main())
