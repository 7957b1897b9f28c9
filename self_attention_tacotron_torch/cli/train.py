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
same CLI.  The alignment plots, on the JAX package's cadence and names:
every ``alignment_save_steps`` steps (``(step + 1) % alignment_save_steps
== 0``) the train step also returns row 0's TRAIN-forward alignments and
outputs (``make_train_step(hp, with_alignments=True)``), plotted as
``<checkpoint-dir>/alignments/train_step{N:09d}_{key}.png``; each
evaluation plots its first utterance's free-running alignments and outputs
as ``<checkpoint-dir>/eval/eval_step{N:09d}_{key}.png``, the newest
``keep_eval_results_max_epoch`` kept.  A failed save only logs, and
without matplotlib each saver says once that it writes no PNG.  (The JAX
package's MGC/LF0 evaluation plots wait for that model kind, which the
port does not have yet.)  With ``record_profile`` the steps from
``profile_steps`` to ``profile_steps + 5`` (or to the end of the run) run
under ``torch.profiler`` (CPU and CUDA activities), written as a Chrome
trace to ``<checkpoint-dir>/profile/trace_step{N}.json``, and one line
logs the window's device-busy share: the union of the device's activity
intervals (kernels, copies, sets) over the window's wall time, and the
busy milliseconds a step (the profiler slows the host, not the device).
Multi-device training is not ported yet.

    python -m self_attention_tacotron_torch.cli.train \\
        --source-data-root DIR --target-data-root DIR --checkpoint-dir DIR \\
        --hparam-json-file examples/codes/self-attention-tacotron.json \\
        [--selected-list-dir DIR] [--hparams k=v,...] [--max-steps N] \\
        [--dataset-kind codes|mel] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
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


def device_events(trace_path: str):
    """The device's own work in a Chrome trace of ``torch.profiler``: its
    kernels, copies and sets, not the step annotations it mirrors on the
    device's rows."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def device_spans(trace_path: str):
    """(start, end) in microseconds of each of ``device_events``."""
    return [(e["ts"], e["ts"] + e["dur"]) for e in device_events(trace_path)]


def union_length(spans) -> float:
    """The length of the union of (start, end) intervals."""
    spans = sorted(spans)
    if not spans:
        return 0.0
    busy, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    return busy + hi - lo


class StepProfiler:
    """``record_profile``: ``torch.profiler`` over the steps from
    ``profile_steps`` to ``profile_steps + 5`` (the JAX package's
    ``jax.profiler`` window), a Chrome trace under ``<ckpt>/profile`` and
    one log line with the window's device-busy share.  The step before the
    window runs under the profiler's warm-up (tracing on, events dropped),
    so that the tracer's start-up cost falls outside the window; the
    device's timestamps are not slowed by the profiler, the host's are,
    so the busy milliseconds a step are logged beside the share."""

    def __init__(self, hp, checkpoint_dir: str, device, log):
        self.on = bool(hp.record_profile)
        self.first, self.last = hp.profile_steps, hp.profile_steps + 5
        self.warm = 1 if self.first > 0 else 0
        self.dir = os.path.join(checkpoint_dir, "profile")
        self.device, self.log = device, log
        self.prof, self.t0 = None, None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def before(self, step: int) -> None:
        if self.on and self.prof is None and step == self.first - self.warm:
            from torch.profiler import ProfilerActivity, profile, schedule
            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._sync()
            self.prof = profile(activities=activities, schedule=schedule(
                wait=0, warmup=self.warm, active=self.last - self.first))
            self.prof.__enter__()
            if not self.warm:
                self.t0 = time.perf_counter()

    def after(self, step: int, force: bool = False) -> None:
        if self.prof is None:
            return
        if self.t0 is None:      # the warm-up step ended
            if force:            # and so did the run
                self.prof.__exit__(None, None, None)
                self.log.info("profile: the run ended before step %d",
                              self.first)
                self.prof, self.on = None, False
                return
            self.prof.step()     # the window opens
            self._sync()
            self.t0 = time.perf_counter()
            return
        if not (force or step >= self.last):
            return
        self._sync()
        wall_us = (time.perf_counter() - self.t0) * 1e6
        self.prof.__exit__(None, None, None)
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, f"trace_step{step}.json")
        self.prof.export_chrome_trace(path)
        # the CPU's runs hold no device events: the trace is not read
        busy_us = (union_length(device_spans(path))
                   if self.device.type == "cuda" else 0.0)
        steps = max(step - self.first, 1)
        busy = (f"{100 * busy_us / wall_us:.2f} % ({busy_us / 1e3 / steps:.3f}"
                " ms a step)" if busy_us else
                "not measured (no device events)")
        self.log.info("profile of steps %d-%d: device busy %s of %.3f ms "
                      "wall on %s; trace %s", self.first, step - 1, busy,
                      wall_us / 1e3, self.device.type, path)
        self.prof, self.on = None, False


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
    from ..utils.metrics import MetricsLogger, MetricsSaver

    hp = load_hparams(args)
    log = setup_logging(hp, args.checkpoint_dir)
    log.info(hparams_debug_string(hp))
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

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
    # the plot steps' variant: the same update, and row 0's alignments and
    # outputs from the TRAIN forward itself
    train_step_plot = make_train_step(hp, with_alignments=True)
    eval_step = make_eval_step(hp)
    metrics_log = MetricsLogger(args.checkpoint_dir)
    throttle = EvalThrottle(hp.eval_start_delay_secs, hp.eval_throttle_secs)
    train_saver = MetricsSaver(
        os.path.join(args.checkpoint_dir, "alignments"),
        save_steps=hp.alignment_save_steps, mode="train", log=log)
    eval_saver = MetricsSaver(os.path.join(args.checkpoint_dir, "eval"),
                              save_steps=1, mode="eval",
                              keep_max=hp.keep_eval_results_max_epoch,
                              log=log)
    profiler = StepProfiler(hp, args.checkpoint_dir, device, log)

    def host(t):
        return t.float().cpu().numpy()

    def run_eval(step_no: int) -> None:
        t0 = time.perf_counter()
        n, acc = 0, {}
        for nb in dataset_factory(*val_files, hp, batch_size=1,
                                  shuffle=False, **kind_kw):
            if n >= hp.num_evaluation_steps:
                break
            metrics, out_free, _ = eval_step(state, to_model_batch(nb))
            for k, v in metrics.items():
                acc[k] = acc.get(k, 0.0) + float(v)
            if n == 0:
                meta = nb.meta[0]
                gt = nb.target[0] if nb.target is not None else None
                eval_saver.save(step_no, meta.key, meta.text,
                                [host(a[0]) for a in out_free.alignments],
                                gt, host(out_free.outputs[0]))
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
            profiler.before(state.step)
            will_plot = (hp.alignment_save_steps > 0 and
                         (state.step + 1) % hp.alignment_save_steps == 0)
            plot = None
            if will_plot:
                metrics, plot = train_step_plot(state, to_model_batch(nb))
            else:
                metrics = train_step(state, to_model_batch(nb))
            profiler.after(state.step)
            if state.step % hp.log_step_count_steps == 0:
                # float() waits for the device
                scalars = {k: float(v) for k, v in metrics.items()}
                scalars["sec_per_step"] = ((time.perf_counter() - t_last)
                                           / hp.log_step_count_steps)
                t_last = time.perf_counter()
                metrics_log.log(state.step, scalars)
                log.info("step %d loss %.5f (%.3fs)", state.step,
                         scalars["loss"], scalars["sec_per_step"])
            if plot is not None:
                try:
                    meta = nb.meta[0]
                    gt = nb.target[0] if nb.target is not None else None
                    train_saver.save(state.step, meta.key, meta.text,
                                     [host(a) for a in plot[0]], gt,
                                     host(plot[1]))
                except Exception as e:  # noqa: BLE001 - plots never stop
                    log.warning("alignment save failed: %s", e)  # training
            if ckpt.save(state.step, state):
                log.info("checkpoint @%d", state.step)
                if val_keys and throttle.should_eval():
                    run_eval(state.step)
        profiler.after(state.step, force=True)
        if ckpt.save(state.step, state, force=True):
            log.info("checkpoint @%d", state.step)
    finally:
        metrics_log.close()
    log.info("done at step %d", state.step)
    return 0


if __name__ == "__main__":
    sys.exit(main())
