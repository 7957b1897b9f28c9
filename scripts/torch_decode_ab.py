#!/usr/bin/env python3
"""A/B of the fused decode kernel (#2) against earlier versions of itself,
in one process on one card.

    git archive <commit> self_attention_tacotron_torch/ops | tar -x -C build/ab/<name>
    python3 scripts/torch_decode_ab.py [--variant NAME=build/ab/NAME ...]
                                       [--cases codes_b1,mel_b1,...] [--reps 7]
                                       [--bf16]

Each ``--variant`` directory holds a copy of the port's ``ops`` package
from another commit (under ``self_attention_tacotron_torch/ops``, as ``git
archive`` writes it; ``build/`` is git-ignored).  It is imported under a
name of its own, so its ``cuda_build`` builds its own ``csrc`` into
``<dir>/build/torch_kernels``; the working tree's package is the variant
``tree``.  For each variant the script prints what ``nvcc -Xptxas -v``
says of the kernel (registers, stack frame, spills).  For each case (the
rows of PERF.md's table for #2, random weights from seed 0, early stop
off) it checks every variant's outputs against the working tree's plain
version, then times the variants in turns (A B C, C B A, ...; CUDA events,
one launch each, median of ``--reps`` after a warm-up) and prints block 0's
per-stage split of a profiled launch in microseconds a step.  A variant
that does not take a case (an older kernel without batched rows, say) is
reported and skipped.  With ``--bf16`` every case also runs the working
tree's kernel in its bf16 storage mode (the variant ``tree_bf16``: the same
weights with the bf16 mode's rounding, ``merge_weights(...,
compute_dtype="bfloat16")``), checked against the plain bf16 version and
timed in turns beside its f32 twin ``tree``.  The card's name and power
limit come first.
"""

import argparse
import importlib
import os
import statistics
import subprocess
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = ("codes_b1", "mel_b1", "vctk_speaker_b1", "codes_b8",
         "location_b1", "location_cumulative_b4")


def load_variant(name: str, path: str):
    """The ``fused_decode`` module of the ops package copied under
    ``path``, imported as the package ``_ab_<name>``."""
    pkg = f"_ab_{name}"
    root = types.ModuleType(pkg)
    root.__path__ = [os.path.join(path, "self_attention_tacotron_torch")]
    sys.modules[pkg] = root
    return importlib.import_module(f"{pkg}.ops.fused_decode")


def make_case(name: str, device):
    """(steps, weights, memory, options) of a PERF.md row of #2."""
    import chip_smoke as cs
    if name == "codes_b1":
        hp = cs.recipe_hparams()
        model = cs.make_model(hp, device)
        case = cs.decoder_case(model, cs.T_IN, cs.T_IN, device)
    elif name == "mel_b1":
        hp = cs._hp_with(cs.MEL_RECIPE)
        model = cs.make_model(hp, device)
        case = cs.rows_case(model, [cs.T_IN], cs.T_IN, device, 15)
    elif name == "vctk_speaker_b1":
        hp = cs._hp_with(cs.VCTK_SA_RECIPE)
        model = cs.make_model(hp, device)
        case = cs.rows_case(model, [cs.VCTK_T_IN], cs.VCTK_T_IN, device, 17)
    else:
        import numpy as np
        hp = cs.recipe_hparams()
        rng = np.random.default_rng(cs.SEED + 16)
        lengths = [cs.T_IN] + rng.integers(40, cs.T_IN + 1, 7).tolist()
        if name.startswith("location"):
            hp = hp.replace(attention="location_sensitive",
                            cumulative_weights="cumulative" in name)
        B = int(name.rsplit("_b", 1)[1])
        model = cs.make_model(hp, device)
        case = cs.rows_case(model, lengths[:B], cs.T_IN, device, B)
    weights, memory, options = case
    options = dict(options, early_stop=False)
    if options.get("speaker_row") is None:
        options.pop("speaker_row", None)   # older kernels lack the option
    return hp.max_iters, weights, memory, options


def sass_sizes(library: str) -> dict:
    """Instructions of each kernel function in a built library, from
    ``cuobjdump -sass`` (16 bytes each on sm_90)."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", library], capture_output=True,
                          text=True).stdout
    sizes, fn = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            sizes[fn] = 0
        elif fn and line.strip().startswith("/*") and "*/" in line and \
                line.strip()[2:6].isalnum() and ";" in line:
            sizes[fn] += 1
    return sizes


def _ms(launch) -> float:
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=DIR of an earlier ops package")
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--bf16", action="store_true",
                    help="also time the bf16 storage mode (tree_bf16)")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    from self_attention_tacotron_torch.ops import fused_decode as tree
    variants = {"tree": tree}
    for spec in args.variant:
        name, path = spec.split("=", 1)
        variants[name] = load_variant(name, os.path.abspath(path))
    jobs = {name: mod.cuda_build._start_build("fused_decode")
            for name, mod in variants.items()}   # one nvcc each, at once
    for name, mod in variants.items():
        log = mod.cuda_build._finish_build("fused_decode", jobs[name])
        for line in log.splitlines():
            if any(k in line for k in ("registers", "stack", "spill")):
                print(f"ptxas {name}: {line.strip()}", flush=True)
        lib = str(mod.cuda_build._library_path("fused_decode"))
        for fn, n in sass_sizes(lib).items():
            print(f"sass {name}: {fn} {n} instructions ({16 * n} bytes)",
                  flush=True)
    runs = dict(variants)
    if args.bf16:
        runs["tree_bf16"] = tree
    for case in args.cases.split(","):
        steps, weights, memory, options = make_case(case, device)
        B = memory.keys[0].shape[0]
        launches, profiled = {}, {}
        for name, mod in runs.items():
            w = tree._bf16_storage(weights) if name == "tree_bf16" else weights
            ref = tree.fused_decode_reference(w, memory, num_steps=steps,
                                              **options)
            try:
                launch = mod.prepare_decode(w, memory, num_steps=steps,
                                            **options)
                prof = mod.prepare_decode(w, memory, num_steps=steps,
                                          profile=True, **options)
            except (ValueError, TypeError) as e:
                print(f"{case}: {name} does not take it ({e})", flush=True)
                continue
            out = launch()[0].reshape(B, steps, -1)
            torch.cuda.synchronize()
            err = max(float((out[..., :-1] - ref[0]).abs().max()),
                      float((out[..., -1] - ref[1]).abs().max()))
            print(f"{case}: {name} max abs err vs the plain version "
                  f"{err:.3e}", flush=True)
            launches[name], profiled[name] = launch, prof
        times = {name: [] for name in launches}
        for launch in launches.values():
            launch()                     # warm-up
        torch.cuda.synchronize()
        order = list(launches)
        for rep in range(args.reps):
            for name in (order if rep % 2 == 0 else order[::-1]):
                times[name].append(_ms(launches[name]))
        for name, ts in times.items():
            ms = statistics.median(ts)
            print(f"{case}: {name} {ms:.4f} ms (B={B}, {steps} steps, "
                  f"{ms * 1e3 / steps:.2f} us a step; runs "
                  f"{min(ts):.4f}-{max(ts):.4f})", flush=True)
            prof = profiled[name]
            prof()
            torch.cuda.synchronize()
            cycles = prof.stage_cycles.cpu().tolist()
            total = max(sum(cycles), 1)
            stages = runs[name].DEC_STAGES
            print(f"{case}: {name} stages (us a step): " + ", ".join(
                f"{s} {ms * 1e3 * c / total / steps:.2f}"
                for s, c in zip(stages, cycles) if c), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
