"""Runs one cell of ``BENCHMARK.json`` once and prints its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with the cell's CUDA devices.
Set-up builds the kernels the cell's calls run on (into the checkout's
``build/``), makes the weights on the device from the seed, builds the
model and warms it up; then the cell's traffic runs for ``--seconds``
(under ``torch.profiler`` with ``--trace 1``); then the reference checks
a sample of the calls.  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, every number the
check compared beside its limit (also the last lines of standard error).
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# JAX and its relatives, and the JAX package the program was ported from:
# none may be loaded by the process that prints the result
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "self_attention_tacotron_tpu")


def cache_dirs() -> None:
    """Every compiler cache inside the checkout, at fixed paths."""
    base = ROOT / "build" / "bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(base / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(base / "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(base / "nv_compute"))


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name is one of ``FORBIDDEN``."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                          else modules)}
    return sorted(names & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


class Run:
    """What a metric reader sees: the configuration's hparams, the window's
    calls and length, the set-up time, the trace (or None), the kernel
    counts and the peaks."""

    def __init__(self, hp, calls, window_s, setup_s, trace, counts, peaks):
        self.hp, self.calls, self.window_s = hp, calls, window_s
        self.setup_s, self.trace = setup_s, trace
        self.counts, self.peaks = counts, peaks

    def work(self, name: str):
        """(bytes, FLOPs) that the count ``name`` gives over all calls."""
        total_b = total_f = 0
        for c in self.calls:
            b, f = self.counts[name].count(self.hp, c)
            total_b, total_f = total_b + b, total_f + f
        return total_b, total_f

    def roofline_pct(self, name: str):
        """The count's least time at the peaks over the time its kernels
        took on the device, in %; None where they took none."""
        if self.trace is None:
            return None
        seconds = self.trace.kernel_seconds(self.counts[name].SYMBOLS)
        if seconds <= 0:
            return None
        nbytes, flops = self.work(name)
        peak = self.peaks["flop_per_s"][self.counts[name].OPERANDS]
        least = max(nbytes / self.peaks["bytes_per_s"], flops / peak)
        return 100.0 * least / seconds


def execute(cell, seed: int, seconds: float, trace: bool, device,
            log=print, process_start: float = PROCESS_START,
            control: bool = False) -> dict:
    """One run of ``cell`` on ``device``: the result object.  With
    ``control`` it also reads the TF32 control on the same checked calls
    (``result["control"]``, for ``calibrate.py``)."""
    import torch

    from harness import check, serve
    from harness.trace import from_profiler, profiled
    from harness.weights import make_weights

    # one host thread for the program's CPU-side operations: an intra-op
    # pool would spin on the cores the serving thread runs on
    torch.set_num_threads(1)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    params = cell.params
    gen = cell.generator()
    warned = serve.WarningLog()
    logging.getLogger().addHandler(warned)
    stages = [("imports", time.perf_counter())]
    serve.build_kernels(device, cell.counts)
    stages.append(("kernels", time.perf_counter()))
    weights = make_weights(serve.model_shapes(cell.config), seed, device,
                           stop_bias=cell.config["stop_token_bias"])
    server = serve.Server(cell.config, weights, device)
    hp = server.hp.values()
    cap = hp["max_iters"]
    stages.append(("weights and model", time.perf_counter()))
    for req in gen.warmup(cell.mix, hp, seed):
        server(req, serve.no_span)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stages.append(("warm-up", time.perf_counter()))
    log("set-up s: " + ", ".join(
        f"{name} {t - prev:.3f}" for (name, t), prev in
        zip(stages, [process_start] + [t for _, t in stages])),
        file=sys.stderr)
    before = serve.kernel_counters(cell.counts)
    keep = check.Keep(params["sample"], seed, cap)
    reqs = gen.requests(cell.mix, hp, seed)
    # the serving thread on one fixed core for the window: a thread that
    # moves between cores reads another host time from run to run
    cores = os.sched_getaffinity(0)
    os.sched_setaffinity(0, {max(cores)})
    setup_s = time.perf_counter() - process_start
    prof_trace = None
    try:
        if trace:
            with profiled() as (prof, span):
                window = gen.run_window(server, reqs, seconds, keep, span)
            prof_trace = from_profiler(prof)
        else:
            window = gen.run_window(server, reqs, seconds, keep,
                                    serve.no_span)
    finally:
        os.sched_setaffinity(0, cores)
    after = serve.kernel_counters(cell.counts)
    calls = window["calls"]
    launches = {k: after[k] - before[k] for k in after}
    log(f"calls {len(calls)} in {window['window_s']:.3f} s; launch counters "
        f"over the window: " + ", ".join(f"{k} {v}"
                                         for k, v in launches.items())
        + f"; warnings logged: {len(warned.messages)}", file=sys.stderr)
    for message in warned.messages[:5]:
        log(f"warning: {message}", file=sys.stderr)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    server.close()
    del server
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checked_at = time.perf_counter()
    reference = cell.reference().make(weights, hp)
    logit_gaps, stop_gaps, stop_max = check.gaps(reference, keep.sample(),
                                                 device)
    check_s = time.perf_counter() - checked_at
    numbers = {"logit_gap": max(logit_gaps), "stop_gap": max(stop_gaps),
               "short_calls": keep.short_calls,
               "refusals": len(warned.messages)}
    limits = {"logit_gap": params["limits"]["logit_gap"],
              "stop_gap": params["limits"]["stop_gap"], "short_calls": 0,
              "refusals": 0}
    if device.type == "cuda" and launches:
        numbers["unserved_calls"] = len(calls) - min(launches.values())
        limits["unserved_calls"] = 0
    checks = check.judge(numbers, limits)
    logging.getLogger().removeHandler(warned)

    peaks = json.loads((HERE / "peaks.json").read_text())
    run = Run(hp, calls, window["window_s"], setup_s, prof_trace,
              cell.counts, peaks)
    metrics = {}
    for m in cell.metrics(trace):
        value = cell.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": check.is_correct(checks), "attempted": len(calls),
              "failed": 0, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = prof_trace.busy_s
        dev["window_s"] = prof_trace.window_s
        result["breakdown"] = prof_trace.breakdown()
    if device.type == "cuda":
        log(f"card: {power_limit()}; peaks {peaks['flop_per_s']} FLOP/s, "
            f"{peaks['bytes_per_s']} B/s", file=sys.stderr)
    log(f"the reference checked {len(logit_gaps)} calls in {check_s:.1f} s "
        f"(the highest stop logit {stop_max:.3f}); their logit gaps: "
        + " ".join(f"{g:.3e}" for g in logit_gaps) + "; stop gaps: "
        + " ".join(f"{g:.3e}" for g in stop_gaps), file=sys.stderr)
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}",
            file=sys.stderr)
    if control:
        tf32 = cell.reference().make(weights, hp, tf32=True)
        tf32_logit, tf32_stop, _ = check.gaps(tf32, keep.sample(), device)
        result["control"] = {"logit_gap": max(tf32_logit),
                             "stop_gap": max(tf32_stop), "stop_max": stop_max}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_dirs()
    sys.path.insert(0, str(ROOT))
    from harness.spec import load_cell, load_json
    cell = load_cell(load_json(ROOT / "BENCHMARK.json"), args.workload)
    import torch

    import self_attention_tacotron_torch  # noqa: F401  the system under test
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA devices, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark measures "
              "the PyTorch port alone", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
