#!/usr/bin/env python3
"""A/B of the training trunk kernels (#3 forward, #4 backward) against
earlier versions of themselves, in one process on one card.

    git archive <commit> self_attention_tacotron_torch/ops | tar -x -C build/ab/<name>
    python3 scripts/torch_train_ab.py [--variant NAME=build/ab/NAME ...]
                                      [--cases codes,vctk,step] [--reps 5]
                                      [--bf16]

Each ``--variant`` directory holds a copy of the port's ``ops`` package
from another commit (under ``self_attention_tacotron_torch/ops``, as ``git
archive`` writes it; ``build/`` is git-ignored).  It is imported under a
name of its own, so its ``cuda_build`` builds its own ``csrc`` into
``<dir>/build/torch_kernels``; the working tree's package is the variant
``tree``.  For each variant the script prints what ``nvcc -Xptxas -v``
says of both kernels (registers, stack frame, spills).  The cases are the
rows of PERF.md's table for #3 and #4: ``codes`` (the codes recipe, B =
32, S = 256, masks on) and ``vctk`` (the VCTK recipe, B = 32, S = 160,
speaker rows, masks on), random weights from seed 0 (``chip_smoke.py``'s
``train_case``).  For each case it checks every variant against the
working tree's plain versions (forward: max abs error of y, the save rows
and the alignment columns; backward: the worst gradient's error relative
to its largest magnitude), then times the variants in turns (A B B A ...;
CUDA events, one launch each, median of ``--reps`` after a warm-up) and
prints each variant's per-stage split of one profiled launch in
microseconds a step (for kernels that split their stages: copying the
rows in, the product, the epilogue and the barrier wait, and the
attention items' time per source).  The case ``step`` times one
training step of the codes recipe at B = 32 (``chip_smoke.py`` phase 8's:
the first batch of its synthetic corpus, one model and optimizer state)
with each variant's ``fused_teacher_scan`` swapped into the working
tree's model, in turns: the end-to-end effect of the kernels on one host.
With ``--bf16`` the kernel cases also run the working tree's kernels in
their bf16 storage mode (the variant ``tree_bf16``, ``compute_dtype =
"bfloat16"`` on the same inputs), checked against the plain bf16 versions
and timed in turns beside their f32 twins ``tree``.  The card's name and
power limit come first.
"""

import argparse
import importlib
import os
import statistics
import subprocess
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("fused_train_fwd", "fused_train_bwd")


def load_variant(name: str, path: str):
    """The ``fused_train`` module of the ops package copied under ``path``,
    imported as the package ``_ab_<name>``."""
    pkg = f"_ab_{name}"
    root = types.ModuleType(pkg)
    root.__path__ = [os.path.join(path, "self_attention_tacotron_torch")]
    sys.modules[pkg] = root
    return importlib.import_module(f"{pkg}.ops.fused_train")


def make_case(name: str, device, compute_dtype: str = "float32"):
    """(spec, params, keys, values, masks, tf, loc_ws, ops, spk, seed) of a
    PERF.md row of #3 / #4 (masks on), in the storage mode
    ``compute_dtype``."""
    import chip_smoke as cs
    if name == "codes":
        model = cs.make_model(cs.recipe_hparams(), device)
        return (*cs.train_case(model, device, False, 1,
                               compute_dtype=compute_dtype), 1234)
    if name == "vctk":
        model = cs.make_model(cs._hp_with(cs.VCTK_SA_RECIPE), device)
        return (*cs.train_case(model, device, False, 2,
                               steps=cs.VCTK_TRAIN_S,
                               compute_dtype=compute_dtype), 4321)
    raise ValueError(f"unknown case {name}")


def step_case(variants, device, reps: int) -> None:
    """One codes training step (chip_smoke.py phase 8) with each variant's
    fused_teacher_scan, in turns (A B B A ...), median of ``reps`` after a
    warm-up, CUDA events around each step."""
    import tempfile
    import torch
    import chip_smoke as cs
    from self_attention_tacotron_torch.data.dataset import (
        dataset_factory, find_dataset_files, load_key_list, to_model_batch)
    from self_attention_tacotron_torch.models import tacotron_model_factory
    from self_attention_tacotron_torch.ops import fused_train as tree
    from self_attention_tacotron_torch.parallel import (create_train_state,
                                                        make_train_step)
    from self_attention_tacotron_torch.utils.convert import init_parameters
    hp = cs.recipe_hparams()
    with tempfile.TemporaryDirectory() as data:
        cs.write_train_corpus(hp, data)
        keys = load_key_list(os.path.join(data, "train.csv"))
        nb = next(iter(dataset_factory(
            find_dataset_files(data, keys, hp.source_file_extension),
            find_dataset_files(data, keys, hp.target_file_extension), hp,
            shuffle=False, drop_remainder=True)))
    batch = to_model_batch(nb).to(device)
    model = init_parameters(tacotron_model_factory(hp), cs.SEED).to(device)
    state, step = create_train_state(model, hp), make_train_step(hp)
    own = tree.fused_teacher_scan
    times = {name: [] for name in variants}
    order = list(variants)
    with torch.enable_grad():
        for rep in range(reps + 1):
            for name in (order if rep % 2 == 0 else order[::-1]):
                tree.fused_teacher_scan = variants[name].fused_teacher_scan
                t = cs._time_ms(lambda: step(state, batch), reps=1)
                if rep:                     # the first round warms up
                    times[name].append(t)
    tree.fused_teacher_scan = own
    frames = int(nb.target.shape[0] * nb.target.shape[1])
    for name, ts in times.items():
        ms = statistics.median(ts)
        print(f"step: {name} one training step B={nb.target.shape[0]} "
              f"S={nb.target.shape[1]} {ms:.3f} ms ({frames / ms * 1e3:.1f} "
              f"frames/s; runs {min(ts):.3f}-{max(ts):.3f})", flush=True)


def _ms(launch) -> float:
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def grads(mod, spec, raw):
    """A variant's raw backward buffers -> named flat gradients."""
    (d_pre, d_att, d_q, d_op, d_l1, d_l2, d_keys, d_values, d_v, d_loc,
     d_spk) = mod.split_grads(spec, raw)
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


def split_text(mod, launch, stages, spec, ms) -> str:
    """One profiled launch's per-stage microseconds a step."""
    import torch
    launch()
    torch.cuda.synchronize()
    cycles = launch.stage_cycles.cpu().tolist()
    if hasattr(mod, "profile_split"):
        return mod.format_split(*mod.profile_split(
            cycles, stages, len(spec.src_kinds), ms, spec.num_steps))
    total = max(sum(cycles), 1)
    return "; ".join(f"{s} {ms * 1e3 * c / total / spec.num_steps:.2f}"
                     for s, c in zip(stages, cycles) if c)


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=DIR of an earlier ops package")
    ap.add_argument("--cases", default="codes,vctk")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--bf16", action="store_true",
                    help="also time the bf16 storage mode (tree_bf16)")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    from self_attention_tacotron_torch.ops import fused_train as tree
    variants = {"tree": tree}
    for spec in args.variant:
        name, path = spec.split("=", 1)
        variants[name] = load_variant(name, os.path.abspath(path))
    jobs = {(name, k): mod.cuda_build._start_build(k)
            for name, mod in variants.items() for k in KERNELS}  # all at once
    for (name, k), job in jobs.items():
        log = variants[name].cuda_build._finish_build(k, job)
        for line in log.splitlines():
            if any(w in line for w in ("registers", "stack", "spill")):
                print(f"ptxas {name} {k}: {line.strip()}", flush=True)
    for case in args.cases.split(","):
        if case == "step":
            step_case(variants, device, args.reps)
            continue
        runs = dict(variants)
        if args.bf16:
            runs["tree_bf16"] = tree
        launches = {}
        for name, mod in runs.items():
            dtype = "bfloat16" if name == "tree_bf16" else "float32"
            (spec, params, keys, values, masks, tf, loc_ws, ops, spk,
             seed) = make_case(case, device, dtype)
            y_r, save_r, aux_r = tree.fused_train_fwd_reference(
                spec, params, keys, values, masks, tf, seed, spk, loc_ws)
            g = torch.randn(y_r.shape, generator=torch.Generator(device)
                            .manual_seed(7), device=device)
            d_params, d_keys, d_values, d_spk, d_loc = \
                tree.fused_train_bwd_reference(spec, params, keys, values,
                                               masks, tf, seed, spk, loc_ws,
                                               g, save_r, aux_r)
            plain = cs._grad_leaves(spec, d_params, d_keys, d_values, d_loc,
                                    d_spk)
            fwd = mod.prepare_train_fwd(spec, ops, seed)
            y, save, aux = fwd()
            bwd = mod.prepare_train_bwd(spec, ops, seed, g, save, aux)
            got = grads(mod, spec, bwd())
            torch.cuda.synchronize()
            f_err = max(cs._max_err(y, y_r), cs._max_err(save, save_r),
                        cs._max_err(aux, aux_r))
            rel = {k: cs._rel_err(got[k], plain[k].reshape(got[k].shape))
                   for k in plain}
            worst, err = max(rel.items(), key=lambda kv: kv[1])
            print(f"{case}: {name} fused_train_fwd max abs err {f_err:.3e}; "
                  f"fused_train_bwd worst gradient {worst} {err:.3e} of its "
                  f"max magnitude", flush=True)
            launches[name] = {
                "fused_train_fwd": (fwd, mod.prepare_train_fwd(
                    spec, ops, seed, profile=True), mod.FWD_STAGES),
                "fused_train_bwd": (bwd, mod.prepare_train_bwd(
                    spec, ops, seed, g, save, aux, profile=True),
                    mod.BWD_STAGES)}
        for k in KERNELS:
            times = {name: [] for name in launches}
            for name in launches:
                launches[name][k][0]()       # warm-up
            torch.cuda.synchronize()
            order = list(launches)
            for rep in range(args.reps):   # A B B A ...
                for name in (order if rep % 2 == 0 else order[::-1]):
                    times[name].append(_ms(launches[name][k][0]))
            for name, ts in times.items():
                ms = statistics.median(ts)
                print(f"{case}: {name} {k} {ms:.4f} ms (B={spec.batch}, "
                      f"S={spec.num_steps}, {ms * 1e3 / spec.num_steps:.2f}"
                      f" us a step; runs {min(ts):.4f}-{max(ts):.4f})",
                      flush=True)
                _, prof, stages = launches[name][k]
                print(f"{case}: {name} {k} stages (us a step): "
                      + split_text(runs[name], prof, stages, spec, ms),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
