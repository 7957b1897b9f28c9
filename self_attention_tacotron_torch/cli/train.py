"""Training CLI on one device: train, periodic checkpoints, resume.

Counterpart of the JAX package's ``cli/train.py`` ``main``: the same flags
(plus ``--device``, default ``cuda``), hparams layering (defaults ->
``--hparam-json-file`` -> ``--hparams``), key-list datasets
(``<selected-list-dir>/train.csv``), warm start, resume from the newest
checkpoint in ``--checkpoint-dir``, a checkpoint every
``save_checkpoints_steps`` and a final one, and a ``step N loss L (s)``
log line every ``log_step_count_steps``.  The log also goes to
``<checkpoint-dir>/<hp.logfile>``.  Evaluation, metric files, alignment
plots, profiling and multi-device training are not ported yet; the run
says so once.

    python -m self_attention_tacotron_torch.cli.train \\
        --source-data-root DIR --target-data-root DIR --checkpoint-dir DIR \\
        --hparam-json-file examples/codes/self-attention-tacotron.json \\
        [--selected-list-dir DIR] [--hparams k=v,...] [--max-steps N] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

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
    p.add_argument("--device", default="cuda")
    return p


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
    from ..parallel import create_train_state, make_train_step
    from ..utils.checkpoint import CheckpointManager, warm_start
    from ..utils.convert import init_parameters

    hp = load_hparams(args)
    log = setup_logging(hp, args.checkpoint_dir)
    log.info(hparams_debug_string(hp))
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    log.warning("evaluation, metric files and alignment plots are not "
                "ported yet: this run trains and checkpoints only")

    list_dir = args.selected_list_dir or args.source_data_root
    keys = load_key_list(os.path.join(list_dir, "train.csv"))
    log.info("train %d utterances", len(keys))
    train_ds = dataset_factory(
        find_dataset_files(args.source_data_root, keys,
                           hp.source_file_extension),
        find_dataset_files(args.target_data_root, keys,
                           hp.target_file_extension),
        hp, shuffle=True, repeat=True, drop_remainder=True,
        batch_size=hp.batch_size, seed=hp.seed)

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
    t_last = time.perf_counter()
    for nb in train_ds:
        if args.max_steps is not None and state.step >= args.max_steps:
            break
        metrics = train_step(state, to_model_batch(nb))
        if state.step % hp.log_step_count_steps == 0:
            loss = float(metrics["loss"])      # waits for the device
            dt = (time.perf_counter() - t_last) / hp.log_step_count_steps
            t_last = time.perf_counter()
            log.info("step %d loss %.5f (%.3fs)", state.step, loss, dt)
        if ckpt.save(state.step, state):
            log.info("checkpoint @%d", state.step)
    if ckpt.save(state.step, state, force=True):
        log.info("checkpoint @%d", state.step)
    log.info("done at step %d", state.step)
    return 0


if __name__ == "__main__":
    sys.exit(main())
