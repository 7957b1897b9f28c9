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
``<checkpoint-dir>/<hp.logfile>``.  The targets are codes, mel
spectrograms or MGC/LF0 frames, by ``--dataset-kind`` or else by
``hp.dataset`` (the JAX package's rule): the VQ-code recipe, the LJSpeech
mel recipe (``examples/ljspeech/tacotron.json``, with the corpus
statistics that ``cli.preprocess`` writes to ``hparams.json`` merged in)
and the paper's pitch-accent configuration (``entry.PITCH_ACCENT``:
``--dataset-kind mgclf0``, source records with accent ids from
``cli.preprocess --accent-file``) train through the same CLI.  The alignment plots, on the JAX package's cadence and names:
every ``alignment_save_steps`` steps (``(step + 1) % alignment_save_steps
== 0``) the train step also returns row 0's TRAIN-forward alignments and
outputs (``make_train_step(hp, with_alignments=True)``), plotted as
``<checkpoint-dir>/alignments/train_step{N:09d}_{key}.png``; each
evaluation plots its first utterance's free-running alignments and outputs
as ``<checkpoint-dir>/eval/eval_step{N:09d}_{key}.png``, the newest
``keep_eval_results_max_epoch`` kept; for the MGC/LF0 model, as in the
JAX package, ``eval/alignment_eval_step{N:09d}_{key}.png``, the four
``mgc_lf0_...`` panels (the lf0 prediction as its softmax) and an
``MgcLf0PredictionRecord`` beside them.  A failed save only logs, and
without matplotlib each saver says once that it writes no PNG.  With
``apply_dropout_on_inference`` the evaluation's prenet dropout comes from
a generator seeded with ``hp.seed``.  With ``record_profile`` the steps from
``profile_steps`` to ``profile_steps + 5`` (or to the end of the run) run
under ``torch.profiler`` (CPU and CUDA activities), written as a Chrome
trace to ``<checkpoint-dir>/profile/trace_step{N}.json``, and one line
logs the window's device-busy share: the union of the device's activity
intervals (kernels, copies, sets) over the window's wall time, and the
busy milliseconds a step (the profiler slows the host, not the device).
The batches come from the training dataset's ``prefetch()``, read by the
native reader where a C++ compiler is found.

Data parallelism (the JAX package's ``--multi-gpus``,
``--coordinator-address``, ``--num-processes`` and ``--process-id``):
``--num-processes N --process-id I --coordinator-address HOST:PORT`` makes
this process rank I of N (``parallel/multihost.py``; torch's
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` serve in
the flags' absence); ``--num-processes N`` without ``--process-id``
spawns the N ranks here (on ``localhost`` at a free port unless a
coordinator is given), and ``--multi-gpus`` one rank per visible GPU (one
process on a one-GPU host), after building the kernels and the native
reader once.  Rank r runs on ``cuda:<r mod the GPUs>`` (``--device cpu``:
the CPU) over ``nccl`` where each rank has a GPU of its own and ``gloo``
where ranks share one.  Each rank reads ``shard_files`` of the train keys
with the data seed ``hp.seed + r``, batches of ``batch_size / N`` rows
(``batch_size`` must divide; ``--multi-gpus`` shrinks its rank count to
the largest divisor instead) in lockstep shapes: the shared bucket
schedule (``multihost_bucket_schedule``, ``multihost_bucket_weights``,
``multihost_bucket_buffer_cap``) or one fixed target pad
(``multihost_target_pad_length``), sources padded to
``multihost_source_pad_length``.  The step sums the gradient over the
ranks (``make_train_step(hp, mesh=...)``); rank 0 writes the checkpoints,
``metrics.jsonl``, the plots and the profile and runs the evaluation;
rank r > 0 logs to ``<hp.logfile>.p<r>``.  Each rank logs its training
kernels' launch counts at the end.

    python -m self_attention_tacotron_torch.cli.train \\
        --source-data-root DIR --target-data-root DIR --checkpoint-dir DIR \\
        --hparam-json-file examples/codes/self-attention-tacotron.json \\
        [--selected-list-dir DIR] [--hparams k=v,...] [--max-steps N] \\
        [--dataset-kind codes|mel|mgclf0] [--device cpu] [--multi-gpus] \\
        [--num-processes N [--process-id I --coordinator-address H:P]]
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
    p.add_argument("--dataset-kind", default=None,
                   choices=["codes", "mel", "mgclf0"],
                   help="the targets' kind (default: derived from "
                        "hp.dataset)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--multi-gpus", action="store_true",
                   help="one rank per visible GPU, spawned here")
    p.add_argument("--coordinator-address", default=None,
                   help="host:port of rank 0")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
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


def setup_logging(hp, checkpoint_dir: str,
                  process_index: int = 0) -> logging.Logger:
    os.makedirs(checkpoint_dir, exist_ok=True)
    name = os.path.basename(hp.logfile)
    if process_index:   # one log a rank under the shared directory
        name = f"{name}.p{process_index}"
    log = logging.getLogger("train")
    log.setLevel(logging.INFO)
    log.propagate = False
    for h in list(log.handlers):     # an earlier run in this process
        log.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    for h in (logging.StreamHandler(sys.stdout), logging.FileHandler(
            os.path.join(checkpoint_dir, name))):
        h.setFormatter(fmt)
        log.addHandler(h)
    return log


def _spawned_ranks(args) -> int:
    """How many ranks this command spawns (0: it runs as one process, the
    only one or the rank ``--process-id`` names)."""
    if args.process_id is not None:
        return 0
    if args.num_processes is not None and args.num_processes > 1:
        return args.num_processes
    if args.multi_gpus and args.device == "cuda":
        n = torch.cuda.device_count()
        return n if n > 1 else 0
    return 0


def _rank_main(rank: int, argv, coordinator: str, world: int) -> None:
    """One spawned rank: ``main`` as rank ``rank`` of ``world``."""
    rc = main([*argv, "--coordinator-address", coordinator,
               "--num-processes", str(world), "--process-id", str(rank)])
    if rc != 0:
        raise SystemExit(rc)


def _build_before_spawning(hp, device_type: str, log) -> None:
    """Build the native reader and the training kernels once, so that the
    ranks load them instead of racing to build them."""
    from ..data import native_reader
    log.info("native TFRecord reader: %s", "built" if native_reader.available()
             else native_reader.unavailable_reason())
    if device_type == "cuda":
        from ..ops import cuda_build
        names = ["fused_train_fwd", "fused_train_bwd"]
        if hp.use_pallas_attention:
            names += ["self_attention", "incremental_attention"]
        t0 = time.perf_counter()
        cuda_build.build_all(names)
        log.info("built %s in %.1f s", ", ".join(names),
                 time.perf_counter() - t0)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_argparser().parse_args(argv)
    from ..config import hparams_debug_string, load_hparams
    from ..parallel import multihost
    from ..parallel.mesh import check_mesh_shape

    hp = load_hparams(args)
    n_spawn = _spawned_ranks(args)
    if n_spawn:
        if args.multi_gpus and hp.batch_size % n_spawn:
            # the JAX CLI's rule: the largest rank count dividing the batch
            n_spawn = max(d for d in range(1, n_spawn + 1)
                          if hp.batch_size % d == 0)
        multihost.local_batch_size(hp.batch_size, n_spawn)
        check_mesh_shape(hp.mesh_shape, n_spawn)
        log = setup_logging(hp, args.checkpoint_dir)
        _build_before_spawning(hp, args.device, log)
        coordinator = (args.coordinator_address
                       or f"localhost:{multihost.free_port()}")
        log.info("spawning %d ranks, coordinator %s", n_spawn, coordinator)
        # each rank parses these flags again; the ones _rank_main adds win
        multihost.spawn(_rank_main, n_spawn, (argv, coordinator, n_spawn))
        return 0
    joined = multihost.initialize_distributed(
        args.coordinator_address, args.num_processes, args.process_id,
        device_type=torch.device(args.device).type)
    try:
        return _train(args, hp, hparams_debug_string(hp), joined)
    finally:
        if joined:
            import torch.distributed as dist
            dist.destroy_process_group()


def _train(args, hp, hparams_text: str, joined: bool) -> int:
    from ..data.dataset import (dataset_factory, find_dataset_files,
                                load_key_list, pad_model_batch_rows,
                                reader_in_use, to_model_batch)
    from ..data.records import (MgcLf0PredictionRecord,
                                write_mgc_lf0_prediction_record)
    from ..models import tacotron_model_factory
    from ..ops import fused_train as ft
    from ..ops.compute_dtype import softmax
    from ..parallel import create_train_state, make_eval_step, make_train_step
    from ..parallel import multihost
    from ..parallel.mesh import create_mesh
    from ..utils.checkpoint import CheckpointManager, warm_start
    from ..utils.convert import init_parameters
    from ..utils.metrics import MetricsLogger, MetricsSaver

    rank, world = multihost.process_index(), multihost.world_size()
    coordinator = multihost.is_coordinator()
    log = setup_logging(hp, args.checkpoint_dir, rank)
    log.info(hparams_text)
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device()) \
            if joined else device
        matmul = torch.backends.cuda.matmul
        matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        matmul.allow_bf16_reduced_precision_reduction = False
    mesh = create_mesh(hp.mesh_shape)
    if joined:
        log.info("rank %d of %d on %s, backend %s", rank, world, device,
                 mesh.backend)

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
    train_kw = dict(kind_kw, batch_size=hp.batch_size, seed=hp.seed)
    if world > 1:
        # lockstep shapes on every rank: the shared bucket schedule (drawn
        # from the common seed, filled from the rank's shard) or one fixed
        # target pad; the data seed differs by rank, the model's does not
        keys = multihost.shard_files(keys)
        train_kw.update(batch_size=multihost.local_batch_size(hp.batch_size),
                        seed=hp.seed + rank,
                        fixed_source_pad=hp.multihost_source_pad_length)
        if (hp.multihost_bucket_schedule
                and not hp.multihost_target_pad_length):
            train_kw.update(bucket_schedule_seed=hp.seed,
                            bucket_weights=hp.multihost_bucket_weights or None,
                            bucket_buffer_cap=hp.multihost_bucket_buffer_cap)
        else:
            train_kw["fixed_target_pad"] = (hp.multihost_target_pad_length
                                            or hp.max_iters
                                            * hp.outputs_per_step)
        log.info("rank %d shard: %d train keys, %d rows a batch", rank,
                 len(keys), train_kw["batch_size"])
    train_ds = dataset_factory(*files(keys), hp, shuffle=True, repeat=True,
                               drop_remainder=True, **train_kw)
    log.info("TFRecord reader: %s", reader_in_use())
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
    multihost.replicate(model, mesh)

    train_step = make_train_step(hp, mesh=mesh)
    # the plot steps' variant: the same update, and row 0's alignments and
    # outputs from the TRAIN forward itself
    train_step_plot = make_train_step(hp, with_alignments=True, mesh=mesh)
    eval_step = make_eval_step(hp)
    metrics_log = MetricsLogger(args.checkpoint_dir) if coordinator else None
    throttle = EvalThrottle(hp.eval_start_delay_secs, hp.eval_throttle_secs)
    train_saver = MetricsSaver(
        os.path.join(args.checkpoint_dir, "alignments"),
        save_steps=hp.alignment_save_steps, mode="train", log=log)
    eval_saver = MetricsSaver(os.path.join(args.checkpoint_dir, "eval"),
                              save_steps=1, mode="eval",
                              keep_max=hp.keep_eval_results_max_epoch,
                              log=log)
    profiler = StepProfiler(hp, args.checkpoint_dir, device, log)
    profiler.on = profiler.on and coordinator
    launched = (ft.fused_train_fwd.launches, ft.fused_train_bwd.launches)

    def host(t):
        return t.float().cpu().numpy()

    def save_eval(step_no: int, nb, out) -> None:
        """The first evaluation utterance's plot (and, for the MGC/LF0
        model, its panels and prediction record)."""
        meta = nb.meta[0]
        aligns = [host(a[0]) for a in out.alignments]
        pred = host(out.outputs[0])
        if not model.is_mgclf0:
            gt = nb.target[0] if nb.target is not None else None
            eval_saver.save(step_no, meta.key, meta.text, aligns, gt, pred)
            return
        lf0_pred = host(softmax(out.outputs2[0], -1))
        rec = MgcLf0PredictionRecord(
            id=meta.id, key=meta.key, mgc=pred, ground_truth_mgc=nb.target[0],
            lf0=lf0_pred, ground_truth_lf0=nb.target2[0], alignments=aligns,
            text=meta.text, source=nb.source[0][:int(nb.source_length[0])])
        eval_saver.save_mgc_lf0(
            step_no, meta.key, meta.text, aligns, nb.target[0], pred,
            nb.target2[0], lf0_pred, prediction_record_writer=lambda path: (
                write_mgc_lf0_prediction_record(rec, path)))

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
                save_eval(step_no, nb, out_free)
            n += 1
        if n:
            acc = {k: v / n for k, v in acc.items()}
            metrics_log.log(step_no, acc, prefix="eval/")
            log.info("eval @%d: %s (%d utterances, %.3fs)", step_no,
                     {k: round(v, 5) for k, v in acc.items()}, n,
                     time.perf_counter() - t0)

    t_last = time.perf_counter()
    batches = train_ds.prefetch()
    try:
        for nb in batches:
            if args.max_steps is not None and state.step >= args.max_steps:
                break
            mb = to_model_batch(nb)
            if nb.source.shape[0] < train_kw["batch_size"]:
                # a short batch: rows with empty loss masks, outside the
                # losses and the batch-norm statistics
                mb, _ = pad_model_batch_rows(mb, train_kw["batch_size"])
            profiler.before(state.step)
            # the same decision on every rank: the shared step counter
            will_plot = (hp.alignment_save_steps > 0 and
                         (state.step + 1) % hp.alignment_save_steps == 0)
            plot = None
            if will_plot:
                metrics, plot = train_step_plot(state, mb)
            else:
                metrics = train_step(state, mb)
            profiler.after(state.step)
            if state.step % hp.log_step_count_steps == 0:
                # float() waits for the device
                scalars = {k: float(v) for k, v in metrics.items()}
                scalars["sec_per_step"] = ((time.perf_counter() - t_last)
                                           / hp.log_step_count_steps)
                t_last = time.perf_counter()
                if metrics_log:
                    metrics_log.log(state.step, scalars)
                log.info("step %d loss %.5f (%.3fs)", state.step,
                         scalars["loss"], scalars["sec_per_step"])
            if plot is not None and coordinator:
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
                if coordinator and val_keys and throttle.should_eval():
                    run_eval(state.step)
        profiler.after(state.step, force=True)
        if ckpt.save(state.step, state, force=True):
            log.info("checkpoint @%d", state.step)
    finally:
        batches.close()
        if metrics_log:
            metrics_log.close()
    log.info("rank %d training kernel launches: fused_train_fwd %d, "
             "fused_train_bwd %d", rank,
             ft.fused_train_fwd.launches - launched[0],
             ft.fused_train_bwd.launches - launched[1])
    log.info("done at step %d", state.step)
    return 0


if __name__ == "__main__":
    sys.exit(main())
