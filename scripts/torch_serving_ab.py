#!/usr/bin/env python3
"""A/B of the serving kernels #1 (the batch-1 encoder, ``fused_encode``),
#6 (the KV-cache attention step, ``incremental_attention_step``) and #5
(the Pallas mode's full-sequence self-attention, ``fused_self_attention``)
against earlier versions of themselves, in one process on one card.

    git archive <commit> self_attention_tacotron_torch | tar -x -C build/ab/<name>
    python3 scripts/torch_serving_ab.py [--variant NAME=build/ab/NAME ...]
                                        [--cases encode,step,serve,attention,
                                         wide,wide-plan,bf16,step-bf16,
                                         spectrogram,sass,whole-serve,
                                         whole-mel,whole-pallas,whole-train]
                                        [--reps 5]

Each ``--variant`` directory holds a copy of the port's package from
another commit (under ``self_attention_tacotron_torch``, as ``git archive``
writes it; ``build/`` is git-ignored; the kernel cases need only its
``ops``).  It is imported under a name of its own, so its ``cuda_build``
builds its own ``csrc`` into ``<dir>/build/torch_kernels``; the working
tree's package is the variant ``tree``. The card's name and power limit come
first, then what ``nvcc -Xptxas -v`` says of each variant's two kernels
(registers, stack frame, spills). Random weights from seed 0
(``chip_smoke.py``'s models).

* ``encode``: #1 at the codes recipe's widths, at the VCTK recipe's and at
  ``chip_smoke.py``'s four widened encoders (widths of 130, 129 and 256
  LSTM units, more layers) (T = L = 64): each variant's max abs error
  against the working tree's plain
  version, its time (``step``'s queued loop of 20 calls; median and
  quartiles of ``--reps``, the variants in turns A B B A ...), each variant's
  time over the tree's round by round (median and quartiles of the
  ratios), and its per-stage
  split of one profiled launch in microseconds (load, product and barrier
  wait where the variant splits its stages, else the stages' shares).
* ``step``: #6 at B = 1 and 32, H = 2, D = 128, S = 250 and 450, t in {0,
  63, 249, S - 1}: the error against the plain version and the device time
  of one call in ``chip_smoke.py`` phase 12's queued loop (50 calls behind
  a sleep kernel, median of 5, per call), ``--reps`` rounds in turns;
  the floor (an empty
  kernel in the same loop) first; and, for a variant that can cut its
  kernel short (``STEP_PASSES``), the time of each cut.
* ``attention``: #5 at the serving shape (B = 1, H = 2, T = 64, D = 16)
  and at B = 32, T = 256, D = 128, causal and not: the empty-kernel floor
  first, then each variant's error against the working tree's plain
  version, and the device time of one call in the same queued loop as
  ``step``, the variants and one ``scaled_dot_product_attention`` call of
  the same function (the yardstick) in turns, beside the bound at the
  3xTF32 rate; for a variant that profiles its launch
  (``prepare_attention(profile=True)``), the split of its longest block
  into loads, scores, softmax and values.
  Each variant's output is also held against the working tree's kernel
  output bit for bit (max abs difference 0.0: the same kernel).
* ``wide``: the modes past the kernels' earlier plans: #5's wide kernel
  (B = 1, T = 64, D = 129, causal; B = 8, T = 256, D = 256), #6's (f32 S
  = 450, D = 257, the tree's narrow kernel at D = 256 in the same loop;
  f32 and bf16 S = 3000, D = 512, the tree's f32 wide kernel on the same
  values in the bf16 loop) and #1 at the codes widths at T =
  533 (the hop resident), 534 and 600 (streamed): errors (and whether two
  calls give the same bits) and times as ``attention`` and ``encode``
  (SDPA beside #5 and #6, each step's byte bound), in turns; the split of
  one profiled launch of #1 at T = 533 and 534, and of #5 for a variant
  whose wide kernel profiles.
* ``wide-plan``: the working tree's wide step kernel alone at the same
  three shapes under other plans (``STEP_WIDE_FILL`` 64 to 132), in
  turns, and each cut of it (``STEP_PASSES``): what chose the shipped
  plan.
* ``bf16``: #5's bf16 instances at ``chip_smoke.py`` phase 27's shapes
  (the serving hop, B = 32, T = 256, D = 128 causal and not, the wide B =
  1, T = 450, D = 256, causal): each variant's error against the working
  tree's plain version over its largest magnitude, its time and one
  scaled_dot_product_attention call in bf16, in turns, beside the bound
  at the bf16 rate, and the split of one profiled launch.
* ``step-bf16``: #6's bf16 instances (the serving cache S = 450, t =
  449, D = 128; S = 3000, t = 2999 at D = 128 and at D = 512, the wide
  kernel): each variant's error against the working tree's plain version
  over its largest magnitude, then its time, the working tree's f32 step
  on the same values (the f32 twin) and one scaled_dot_product_attention
  call in bf16, in turns in ``step``'s queued loop.
* ``spectrogram``: #7 from the signal, 10 s: the FFT at LJSpeech's n_fft
  2048 and VCTK's 4096 and the direct DFT at n_fft 1998 (22,050 Hz, a
  1102-tap window): each variant's outputs against the working tree's
  kernel's (max abs difference; 0.0: the same bits) and its errors against
  the plain version (magnitude over the frame's peak, dB), then its time
  and the ``torch.stft`` -> abs -> mel -> dB chain's in turns in the same
  queued loop.
* ``sass``: #5's and #6's float32 narrow kernels and #1's trunk and
  recurrent kernel with the hop resident, instance by instance (every
  width, ``key_warps``, load width, profiling flag, copy width and
  cluster size): each
  variant's SASS (``cuobjdump -sass`` of its built ``self_attention`` and
  ``incremental_attention``) against the working tree's, line by line
  with addresses, registers and constants as they are; only the names are
  made comparable (the anonymous namespace's tag dropped, and an
  element-type argument ``f`` of an older template with one).  Prints
  each instance's instruction count and how many lines differ (0: the
  same machine code), then each differing pair of lines and the
  instances it is in.
* ``serve``: the codes model's call per utterance on the host clock (what
  ``cli.predict.main_code`` prints as its wall), three synthetic sources of
  40-64 phones, fused paths (#1, #2) and the Pallas attention mode (#5,
  #6), each variant's kernels swapped into the working tree's model in
  turns, median of ``--reps``.
* ``whole-*``: the whole package of each variant end to end (its models,
  ops and kernels), each variant building its own model from the same
  recipe with weights from seed 0 (``utils.convert.init_parameters``), so
  the variants compute the same function and their outputs are compared;
  host clock, one warm-up, then ``--reps`` calls in turns.
  ``whole-serve``: the codes recipe's call per utterance at batch 1 (#1,
  #2), three sources of 40-64 phones; ``whole-mel``: the LJSpeech recipe
  with ``decoder_fused_inference`` (the module encoder and #2), one
  source of 64 characters, 500 steps; ``whole-pallas``: the codes recipe
  in the Pallas attention mode (#5, #6), one source; ``whole-train``: one
  codes training step at B = 32 on a synthetic batch of 250 steps
  (``parallel.make_train_step``: the encoder's module path, #3 and #4).
"""

import argparse
import importlib
import os
import re
import statistics
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("fused_encoder", "incremental_attention", "self_attention",
           "spectrogram")
WHOLE_KERNELS = KERNELS + ("fused_decode", "fused_train_fwd",
                           "fused_train_bwd")
CODES = os.path.join(ROOT, "examples", "codes", "self-attention-tacotron.json")
MEL = os.path.join(ROOT, "examples", "ljspeech", "tacotron.json")
SEED = 0
ATTENTION_SHAPES = [(1, 64, 16, False), (32, 256, 128, False),
                    (32, 256, 128, True)]
STEP_SHAPES = [(B, S, t) for B in (1, 32) for S in (250, 450)
               for t in sorted({0, 63, 249, S - 1})]
WIDE_SHAPES = [(1, 64, 129, True), (8, 256, 256, False)]
BF16_SHAPES = [(1, 64, 16, False), (32, 256, 128, False),
               (32, 256, 128, True), (1, 450, 256, True)]
WIDE_STEPS = [(450, 257, "f32"), (3000, 512, "f32"), (3000, 512, "bf16")]
BF16_STEPS = [(450, 128), (3000, 128), (3000, 512)]   # (S, D), t = S - 1
SPEC_CASES = [("LJSpeech", 22050, 1025, 50.0), ("VCTK", 48000, 2049, 50.0),
              ("DFT", 22050, 1000, 50.0)]  # name, sr, num_freq, window ms
WIDE_ENCODE_T = (533, 534, 600)
WIDE_PROFILE_T = (533, 534)


def load_variant(name: str, path: str):
    """The package copied under ``path``, as ``_ab_<name>`` (its modules
    import on first use)."""
    pkg = f"_ab_{name}"
    root = types.ModuleType(pkg)
    root.__path__ = [os.path.join(path, "self_attention_tacotron_torch")]
    sys.modules[pkg] = root
    return root


def sub(pkg, name: str):
    return importlib.import_module(f"{pkg.__name__}.{name}")


def _modules(pkg):
    return sub(pkg, "ops.fused_encoder"), sub(pkg, "ops.pallas_attention")


def _runs(ts) -> str:
    q1, _, q3 = statistics.quantiles(ts, n=4) if len(ts) > 1 else ts * 3
    return (f"{statistics.median(ts):.5f} ms (runs {min(ts):.5f}-"
            f"{max(ts):.5f}, quartiles {q1:.5f}-{q3:.5f})")


def _paired(times) -> str:
    """Each variant's time over the working tree's in the same round (the
    rounds are in turns): the median ratio and its quartiles."""
    out = []
    for name, ts in times.items():
        if name == "tree":
            continue
        ratios = [a / b for a, b in zip(ts, times["tree"])]
        q1, med, q3 = (statistics.quantiles(ratios, n=4)
                       if len(ratios) > 1 else ratios * 3)
        out.append(f"{name}/tree median {med:.4f} (quartiles {q1:.4f}-"
                   f"{q3:.4f}, {len(ratios)} rounds)")
    return "; ".join(out)


def encode_split(fe, launch, ms: float) -> str:
    """One profiled launch of a variant: microseconds of each stage, split
    into load, product and wait where the variant splits them
    (``profile_split``)."""
    import torch
    launch()
    torch.cuda.synchronize()
    cycles = launch.stage_cycles.cpu().tolist()
    if hasattr(fe, "profile_split"):
        return fe.format_split(fe.profile_split(cycles, ms))
    total = max(sum(cycles), 1)
    return "; ".join(f"{s} {ms * 1e3 * c / total:.2f}"
                     for s, c in zip(fe.ENC_STAGES, cycles) if c)


def encode_case(variants, device, reps: int) -> None:
    import torch
    import chip_smoke as cs
    from self_attention_tacotron_torch.ops import fused_encoder as tree
    for width, hp in (("codes", cs.recipe_hparams()),
                      ("vctk", cs._hp_with(cs.VCTK_SA_RECIPE)),
                      *((path, cs._hp_with(cs.RECIPE, extra))
                        for path, extra in cs.WIDE_ENCODERS)):
        model = cs.make_model(hp, device)
        params, x, kw = cs.encoder_case(model, cs.T_IN, cs.T_IN, device)
        ref = tree.fused_encode_reference(params, x, cs.T_IN, **kw)
        launches = {}
        for name, pkg in variants.items():
            fe, _ = _modules(pkg)
            launches[name] = fe.prepare_encode(params, x, cs.T_IN, **kw)
            got = launches[name]()
            torch.cuda.synchronize()
            err = max(cs._max_err(g, r) for g, r in zip(got, ref))
            print(f"encode {width}: {name} max abs err {err:.3e}",
                  flush=True)
            launches[name]()
        torch.cuda.synchronize()
        times = cs.in_turns(launches, reps)
        if len(times) > 1:
            print(f"encode {width}: {_paired(times)}", flush=True)
        for name, ts in times.items():
            print(f"encode {width}: {name} fused_encode T={cs.T_IN} "
                  f"{_runs(ts)}", flush=True)
            fe, _ = _modules(variants[name])
            ms = statistics.median(ts)
            prof = fe.prepare_encode(params, x, cs.T_IN, **kw, profile=True)
            print(f"encode {width}: {name} stages (us): "
                  + encode_split(fe, prof, ms), flush=True)


def step_case(variants, device, reps: int) -> None:
    import torch
    import chip_smoke as cs
    from self_attention_tacotron_torch.ops import pallas_attention as tree
    H, D = cs.ATTN_HEADS, cs.ATTN_D
    floor = cs._device_ms(tree.launch_floor(device))
    print(f"step: empty kernel in the queued loop {floor:.5f} ms",
          flush=True)
    for B, S, t in STEP_SHAPES:
        kc, vc = (cs._normal(device, B, H, S, D, seed=s) for s in (1, 2))
        q = cs._normal(device, B, H, D, seed=3 + t)
        ref = tree.incremental_attention_step_reference(q, kc, vc, t)
        fns = {}
        for name, pkg in variants.items():
            _, pa = _modules(pkg)
            got = pa.incremental_attention_step(q, kc, vc, t)
            torch.cuda.synchronize()
            print(f"step B={B} S={S} t={t}: {name} max abs err "
                  f"{cs._max_err(got, ref):.3e}", flush=True)
            fns[name] = (lambda pa=pa: pa.incremental_attention_step(
                q, kc, vc, t))
        times = cs.in_turns(fns, reps, cs._device_ms)
        bound = cs._bound_ms(cs.step_bound(B, t))
        for name, ts in times.items():
            _, pa = _modules(variants[name])
            cuts = ""
            for i, cut in enumerate(getattr(pa, "STEP_PASSES", ())[:-1]):
                launch = pa.prepare_step(q, kc, vc, t, passes=i + 1)
                cuts += f", {cut} {cs._device_ms(launch):.5f}"
            print(f"step B={B} S={S} t={t}: {name} {_runs(ts)}"
                  + (f"; cut short: {cuts[2:]} ms" if cuts else "")
                  + f"; bound {bound:.6f} ms",
                  flush=True)


def attention_case(variants, device, reps: int) -> None:
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    from self_attention_tacotron_torch.ops import pallas_attention as tree
    floor = cs._device_ms(tree.launch_floor(device))
    print(f"attention: empty kernel in the queued loop {floor:.5f} ms",
          flush=True)
    for B, T, D, causal in ATTENTION_SHAPES:
        tag = f"attention B={B} H={cs.ATTN_HEADS} T={T} D={D} causal={causal}"
        q, k, v = cs._attention_inputs(device, B, T, D)
        ref = tree.fused_self_attention_reference(q, k, v, causal)
        fns = {}
        mine = tree.fused_self_attention(q, k, v, causal)
        for name, pkg in variants.items():
            _, pa = _modules(pkg)
            got = pa.fused_self_attention(q, k, v, causal)
            torch.cuda.synchronize()
            print(f"{tag}: {name} max abs err {cs._max_err(got, ref):.3e}; "
                  f"against the tree's kernel {cs._max_err(got, mine):.3e}",
                  flush=True)
            fns[name] = (lambda pa=pa: pa.fused_self_attention(q, k, v,
                                                               causal))
        fns["sdpa"] = lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal)
        times = cs.in_turns(fns, reps, cs._device_ms)
        bound = cs._bound_ms(cs.attention_bound(B, T, D, causal),
                             cs.PEAK_3XTF32_FLOP_PER_S)
        for name, ts in times.items():
            print(f"{tag}: {name} {_runs(ts)}; bound {bound:.5f} ms",
                  flush=True)
        for name, pkg in variants.items():
            _, pa = _modules(pkg)
            if hasattr(pa, "prepare_attention"):
                print(f"{tag}: {name} " + cs.attention_split(
                    pa, q, k, v, causal, statistics.median(times[name])),
                    flush=True)


def wide_case(variants, device, reps: int) -> None:
    """The modes past the kernels' earlier plans: #5's wide kernel (D = 129
    and 256), #6's (f32 S = 450, D = 257 with the tree's narrow kernel at
    D = 256 on the same cache length in the loop; f32 and bf16 S = 3000,
    D = 512, the tree's f32 wide kernel in the bf16 loop) and #1 at the
    codes widths at T = 533 (the hop resident), 534 and 600 (streamed):
    each variant's error against the working tree's plain version (bf16:
    over its largest magnitude) and its time, in turns (#5 and #6 beside
    SDPA), with each step's bound; the profiled split of #1 at T = 533 and
    534 and of #5 for a variant whose wide kernel profiles."""
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    from self_attention_tacotron_torch.ops import fused_encoder as tree_fe
    from self_attention_tacotron_torch.ops import pallas_attention as tree
    cases, splits = [], []
    for B, T, D, causal in WIDE_SHAPES:
        q, k, v = cs._attention_inputs(device, B, T, D)
        tag = f"wide attention B={B} T={T} D={D} causal={causal}"
        cases.append((
            tag,
            lambda pa, q=q, k=k, v=v, c=causal:
                pa.fused_self_attention(q, k, v, c),
            tree.fused_self_attention_reference(q, k, v, causal),
            {"sdpa": lambda q=q, k=k, v=v, c=causal:
                F.scaled_dot_product_attention(q, k, v, is_causal=c)}, ""))
        splits.append((tag, q, k, v, causal))
    for S, D, dtype in WIDE_STEPS:
        t = S - 1
        q, kc, vc = cs._step_inputs(device, 1, t, S, D)
        if dtype == "bf16":
            q, kc, vc = q.bfloat16(), kc.bfloat16(), vc.bfloat16()
        beside = {"sdpa": lambda q=q, kc=kc, vc=vc:
                  F.scaled_dot_product_attention(q[:, :, None], kc, vc)}
        if dtype == "bf16":   # the f32 wide kernel on the same values
            q32, k32, v32 = q.float(), kc.float(), vc.float()
            beside["f32_wide"] = (lambda q=q32, kc=k32, vc=v32, t=t:
                                  tree.incremental_attention_step(q, kc, vc,
                                                                  t))
        elif D == 257:        # the narrow kernel one column narrower
            qn, kn, vn = (x[..., :256].contiguous() for x in (q, kc, vc))
            beside["narrow_D256"] = (lambda q=qn, kc=kn, vc=vn, t=t:
                                     tree.incremental_attention_step(
                                         q, kc, vc, t))
        bound = (cs.bf16_step_bound(1, t, D) if dtype == "bf16"
                 else cs.step_bound(1, t, D))
        cases.append((
            f"wide step {dtype} S={S} D={D} t={t}",
            lambda pa, q=q, kc=kc, vc=vc, t=t:
                pa.incremental_attention_step(q, kc, vc, t),
            tree.incremental_attention_step_reference(q, kc, vc, t),
            beside, f"; bound {cs._bound_ms(bound):.6f} ms (bytes)"))
    for tag, run, ref, beside, note in cases:
        fns = dict(beside)
        scale = float(ref.float().abs().max()) if ref.dtype != \
            torch.float32 else 1.0
        for name, pkg in variants.items():
            _, pa = _modules(pkg)
            got = run(pa)
            again = run(pa)
            torch.cuda.synchronize()
            err = cs._max_err(got.float(), ref.float()) / scale
            print(f"{tag}: {name} max abs err {err:.3e}"
                  + (" of the largest magnitude" if scale != 1.0 else "")
                  + f"; the same bits from call to call "
                  f"{bool(torch.equal(got, again))}", flush=True)
            fns[name] = (lambda pa=pa: run(pa))
        times = cs.in_turns(fns, reps, cs._device_ms)
        for name, ts in times.items():
            print(f"{tag}: {name} {_runs(ts)}{note}", flush=True)
        for stag, q, k, v, causal in splits:
            if stag == tag:
                attention_splits(variants, stag, q, k, v, causal, times)
    model = cs.make_model(cs.recipe_hparams(), device)
    for T in WIDE_ENCODE_T:
        params, x, kw = cs.encoder_case(model, T, T, device)
        ref = tree_fe.fused_encode_reference(params, x, T, **kw)
        launches = {}
        for name, pkg in variants.items():
            fe, _ = _modules(pkg)
            launches[name] = fe.prepare_encode(params, x, T, **kw)
            err = max(cs._max_err(g, r)
                      for g, r in zip(launches[name](), ref))
            hop = "streamed" if tree_fe.hop_streams(T, 128, 32) else \
                "resident"
            print(f"wide encode T={T}: {name} max abs err {err:.3e}; hop "
                  f"{hop}", flush=True)
        times = cs.in_turns(launches, reps)
        if len(times) > 1:
            print(f"wide encode T={T}: {_paired(times)}", flush=True)
        for name, ts in times.items():
            print(f"wide encode T={T}: {name} {_runs(ts)}", flush=True)
            if T in WIDE_PROFILE_T:
                fe, _ = _modules(variants[name])
                prof = fe.prepare_encode(params, x, T, **kw, profile=True)
                print(f"wide encode T={T}: {name} stages (us): "
                      + encode_split(fe, prof, statistics.median(ts)),
                      flush=True)


WIDE_PLAN_FILLS = (64, 80, 96, 112, 132)


def wide_plan_case(device, reps: int) -> None:
    """The working tree's wide step kernel (#6, D > 256) under other plans
    at ``WIDE_STEPS``: each ``STEP_WIDE_FILL`` of ``WIDE_PLAN_FILLS``, in
    turns, and each cut of the kernel (``STEP_PASSES``) under the shipped
    plan."""
    import chip_smoke as cs
    from self_attention_tacotron_torch.ops import pallas_attention as pa
    shipped = pa.STEP_WIDE_FILL
    for S, D, dtype in WIDE_STEPS:
        t = S - 1
        q, kc, vc = cs._step_inputs(device, 1, t, S, D)
        if dtype == "bf16":
            q, kc, vc = q.bfloat16(), kc.bfloat16(), vc.bfloat16()
        tag = f"wide plan {dtype} S={S} D={D} t={t}"
        fns, layouts = {}, {}
        for fill in WIDE_PLAN_FILLS:
            pa.STEP_WIDE_FILL = fill
            fns[fill] = pa.prepare_step(q, kc, vc, t)
            layouts[fill] = tuple(pa.step_plan_wide(
                q.shape[0] * q.shape[1], t, D))
        pa.STEP_WIDE_FILL = shipped
        times = cs.in_turns(fns, reps, cs._device_ms)
        for fill, ts in times.items():
            print(f"{tag}: fill {fill} plan {layouts[fill]} {_runs(ts)}",
                  flush=True)
        cuts = [cs._device_ms(pa.prepare_step(q, kc, vc, t, passes=i + 1))
                for i in range(len(pa.STEP_PASSES) - 1)]
        print(f"{tag}: fill {shipped} cut short: " + ", ".join(
            f"{c} {ms:.5f}" for c, ms in zip(pa.STEP_PASSES, cuts))
            + " ms", flush=True)


def attention_splits(variants, tag, q, k, v, causal, times) -> None:
    """The profiled split of #5 for each variant whose kernel at this
    width and dtype profiles (the wide kernel's from this slice on)."""
    import chip_smoke as cs
    for name, pkg in variants.items():
        _, pa = _modules(pkg)
        if q.shape[-1] <= pa.MAX_MMA_HEAD_DIM or hasattr(pa, "wide_plan"):
            print(f"{tag}: {name} " + cs.attention_split(
                pa, q, k, v, causal, statistics.median(times[name])),
                flush=True)


def bf16_case(variants, device, reps: int) -> None:
    """#5's bf16 instances against the tree's plain version, in turns with
    SDPA in bf16."""
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    from self_attention_tacotron_torch.ops import pallas_attention as tree
    for B, T, D, causal in BF16_SHAPES:
        tag = (f"bf16 attention B={B} H={cs.ATTN_HEADS} T={T} D={D} "
               f"causal={causal}")
        q, k, v = (x.bfloat16() for x in cs._attention_inputs(device, B, T,
                                                              D))
        ref = tree.fused_self_attention_reference(q, k, v, causal).float()
        scale = float(ref.abs().max())
        fns = {}
        for name, pkg in variants.items():
            _, pa = _modules(pkg)
            got = pa.fused_self_attention(q, k, v, causal)
            torch.cuda.synchronize()
            err = cs._max_err(got.float(), ref) / scale
            print(f"{tag}: {name} error {err:.3e} of the plain version's "
                  "largest magnitude", flush=True)
            fns[name] = (lambda pa=pa: pa.fused_self_attention(q, k, v,
                                                               causal))
        fns["sdpa"] = lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal)
        times = cs.in_turns(fns, reps, cs._device_ms)
        bound = cs._bound_ms(cs.bf16_attention_bound(B, T, D, causal),
                             cs.PEAK_BF16_FLOP_PER_S)
        for name, ts in times.items():
            print(f"{tag}: {name} {_runs(ts)}; bound {bound:.6f} ms",
                  flush=True)
        attention_splits(variants, tag, q, k, v, causal, times)


def kernel_sass(library: str) -> dict:
    """Each kernel function's instructions in a built library, from
    ``cuobjdump -sass``, keyed by its mangled name without the anonymous
    namespace's tag."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", library], capture_output=True,
                          text=True, check=True).stdout
    found, fn = {}, None
    for line in text.splitlines():
        head = re.match(r"\s+Function : (\S+)", line)
        if head:
            fn = re.sub(r"\d+_GLOBAL__N__\w+?_cu_\w+?"
                        r"(?=\d+(?:self_|incremental_))", "", head.group(1))
            found[fn] = []
            continue
        ins = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if fn and ins:
            found[fn].append(re.sub(r"\s+", " ", ins.group(1)))
    return found


SASS_KERNELS = (("self_attention", "self_attention_kernelI"),
                ("incremental_attention", "incremental_attention_kernelIf"),
                ("fused_encoder", "encoder_"))
# #1's recurrent kernel with the hop resident: the working tree's instance
# kStream = false under the name of an older one without that parameter;
# its streamed instances (kStream = true) are left out
RESIDENT_RNN = re.compile(r"(Li\d+E)Lb0E(Ev7EncArgs)")
STREAMED_RNN = re.compile(r"Li\d+ELb1EEv7EncArgs")


def sass_case(variants, builds) -> None:
    for library, prefix in SASS_KERNELS:
        names = {}
        for name in variants:
            lib = str(builds[name]._library_path(library))
            names[name] = {RESIDENT_RNN.sub(r"\1\2", re.sub(
                r"self_attention_kernelIf", "self_attention_kernelI", fn)):
                code for fn, code in kernel_sass(lib).items()
                if prefix in fn and "bfloat16" not in fn
                and not STREAMED_RNN.search(fn)}
        tree = names["tree"]
        print(f"sass tree: {len(tree)} instances of {library}'s f32 kernels "
              "held to an earlier design", flush=True)
        for name, found in names.items():
            if name == "tree":
                continue
            pairs = {}
            for fn in sorted(set(tree) | set(found)):
                a, b = found.get(fn), tree.get(fn)
                if a is None or b is None:
                    print(f"sass {name}: {fn} only in "
                          f"{'tree' if a is None else name}", flush=True)
                    continue
                differ = [(x, y) for x, y in zip(a, b) if x != y]
                for pair in differ:
                    pairs[pair] = pairs.get(pair, 0) + 1
                print(f"sass {name}: {fn} {len(a)} instructions, tree "
                      f"{len(b)}; {len(differ) + abs(len(a) - len(b))} lines "
                      "differ", flush=True)
            for (x, y), n in sorted(pairs.items(), key=lambda p: -p[1]):
                print(f"sass {name}: in {n} instances '{x}' where the tree "
                      f"has '{y}'", flush=True)


def step_bf16_case(variants, device, reps: int) -> None:
    """#6's bf16 instances against the tree's plain version, in turns with
    the f32 twin and SDPA in bf16."""
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    from self_attention_tacotron_torch.ops import pallas_attention as tree
    B, H = 1, cs.ATTN_HEADS
    for S, D in BF16_STEPS:
        t = S - 1
        tag = f"bf16 step B={B} H={H} S={S} t={t} D={D}"
        q, kc, vc = (x.bfloat16() for x in cs._step_inputs(device, B, t, S,
                                                           D))
        ref = tree.incremental_attention_step_reference(q, kc, vc, t).float()
        scale = float(ref.abs().max())
        fns = {}
        for name, pkg in variants.items():
            _, pa = _modules(pkg)
            got = pa.incremental_attention_step(q, kc, vc, t)
            torch.cuda.synchronize()
            print(f"{tag}: {name} error "
                  f"{cs._max_err(got.float(), ref) / scale:.3e} of the plain "
                  "version's largest magnitude", flush=True)
            fns[name] = (lambda pa=pa: pa.incremental_attention_step(
                q, kc, vc, t))
        q32, k32, v32 = q.float(), kc.float(), vc.float()
        fns["f32_twin"] = lambda: tree.incremental_attention_step(
            q32, k32, v32, t)
        fns["sdpa"] = lambda: F.scaled_dot_product_attention(
            q[:, :, None], kc, vc)
        times = cs.in_turns(fns, reps, cs._device_ms)
        bound = cs._bound_ms(cs.bf16_step_bound(B, t, D),
                             cs.PEAK_BF16_FLOP_PER_S)
        for name, ts in times.items():
            print(f"{tag}: {name} {_runs(ts)}; bound {bound:.6f} ms",
                  flush=True)


def spectrogram_case(variants, device, reps: int) -> None:
    """#7 from the signal: each variant against the tree's kernel and
    plain version, in turns with the torch.stft chain."""
    import torch
    import chip_smoke as cs
    from self_attention_tacotron_torch.ops import stft as tree
    for name_, sr, num_freq, win_ms in SPEC_CASES:
        args = (sr, num_freq, 80, win_ms, 12.5, 20.0)
        ex = tree.MelExtractor(*args, device=device)
        y = ex.signal(cs._wave(10 * sr, sr, seed=23))
        tag = f"spectrogram {name_} n_fft={ex.n_fft} 10 s"
        ref = tree.spectrograms_plain(y, ex.plan)
        mine = tree.spectrograms(y, ex.plan)
        fns = {}
        for name, pkg in variants.items():
            st = sub(pkg, "ops.stft")
            vx = st.MelExtractor(*args, device=device)
            got = st.spectrograms(y, vx.plan)
            torch.cuda.synchronize()
            same = max(cs._max_err(g, m) for g, m in zip(got, mine))
            errs = [cs.spec_errors(g, r) for g, r in zip(got, ref)]
            print(f"{tag}: {name} max abs difference from the tree's kernel "
                  f"{same:.3e}; against the plain version (magnitude / "
                  f"peak, dB) linear {errs[0]}, mel {errs[1]}", flush=True)
            fns[name] = (lambda st=st, vx=vx: st.spectrograms(y, vx.plan))
        fns["torch.stft"] = lambda: cs.library_spectrograms(ex, y)
        times = cs.in_turns(fns, reps,
                            lambda fn: cs._device_ms(fn, reps=20))
        for name, ts in times.items():
            print(f"{tag}: {name} {_runs(ts)}", flush=True)


def serve_case(variants, device, reps: int) -> None:
    """The codes model's call per utterance, host clock, in turns."""
    import torch
    import chip_smoke as cs
    from self_attention_tacotron_torch.models import Batch
    from self_attention_tacotron_torch.ops import attention_core
    from self_attention_tacotron_torch.ops import fused_encoder as tree_fe
    import numpy as np
    rng = np.random.default_rng(cs.SEED)
    lengths = [int(rng.integers(40, cs.T_IN + 1)) for _ in range(3)]
    own = (tree_fe.fused_encode, attention_core.incremental_attention_step,
           attention_core.fused_self_attention)
    for mode, extra in (("fused", ""), ("pallas", cs.PALLAS_SERVING)):
        hp = cs._hp_with(cs.RECIPE, extra)
        model = cs.make_model(hp, device)
        batches = [Batch(source=cs.source_ids(hp, L, L, cs.SEED + i, device),
                         source_length=torch.tensor([L], device=device),
                         speaker_id=torch.tensor([0], device=device))
                   for i, L in enumerate(lengths)]

        def call(name, b):
            fe, pa = _modules(variants[name])
            tree_fe.fused_encode = fe.fused_encode
            attention_core.incremental_attention_step = \
                pa.incremental_attention_step
            attention_core.fused_self_attention = pa.fused_self_attention
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model(b)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3, int(out.lengths[0])

        for i, b in enumerate(batches):
            steps = {name: call(name, b)[1] for name in variants}  # warm-up
            times = cs.in_turns({n: n for n in variants}, reps,
                             lambda n: call(n, b)[0])
            for name, ts in times.items():
                print(f"serve {mode} utterance {i} (L={lengths[i]}, "
                      f"{steps[name]} steps): {name} "
                      f"{statistics.median(ts):.3f} ms (runs {min(ts):.3f}-"
                      f"{max(ts):.3f})", flush=True)
    (tree_fe.fused_encode, attention_core.incremental_attention_step,
     attention_core.fused_self_attention) = own


def host_ms(fn) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def build_model(pkg, recipe: str, hparams: str, device):
    hp = sub(pkg, "config").default_hparams().parse_json_file(recipe)
    hp.parse(hparams)
    model = sub(pkg, "models").tacotron_model_factory(hp)
    sub(pkg, "utils.convert").init_parameters(model, SEED)
    return hp, model.to(device).eval()


def whole_report(case: str, fns, reps: int, outs) -> None:
    """One warm-up each, ``reps`` calls in turns, then each variant's
    median and range and the largest output difference between them."""
    import chip_smoke as cs
    for fn in fns.values():
        host_ms(fn)
    times = cs.in_turns(fns, reps, host_ms)
    names = list(outs)
    diff = max(float((outs[n] - outs[names[0]]).abs().max())
               for n in names[1:]) if len(names) > 1 else 0.0
    for name, ts in times.items():
        print(f"{case}: {name} {statistics.median(ts):.3f} ms (runs "
              f"{min(ts):.3f}-{max(ts):.3f})", flush=True)
    print(f"{case}: outputs max abs diff between variants {diff:.3e}",
          flush=True)


def whole_serve_case(variants, case: str, device, reps: int) -> None:
    import numpy as np
    import torch
    recipe, hparams, lengths = {
        "whole-serve": (CODES, "", None),
        "whole-mel": (MEL, "decoder_fused_inference=true", [64]),
        "whole-pallas": (CODES, "use_pallas_attention=true,"
                         "decoder_fused_inference=false,"
                         "encoder_fused_inference=false", [64])}[case]
    if lengths is None:
        rng = np.random.default_rng(SEED)
        lengths = [int(rng.integers(40, 65)) for _ in range(3)]
    models = {n: build_model(p, recipe, hparams, device)[1]
              for n, p in variants.items()}
    for i, L in enumerate(lengths):
        src = torch.from_numpy(np.random.default_rng(SEED + i).integers(
            1, 40, (1, L))).to(device)
        batches = {n: sub(p, "models").Batch(
            source=src, source_length=torch.tensor([L], device=device))
            for n, p in variants.items()}
        outs = {}

        def call(n):
            outs[n] = models[n](batches[n]).outputs
        whole_report(f"{case} utterance {i} (L={L})",
                     {n: (lambda n=n: call(n)) for n in variants}, reps,
                     outs)


def whole_train_case(variants, device, reps: int) -> None:
    import numpy as np
    import torch
    B, S, L = 32, 250, 64
    rng = np.random.default_rng(SEED + 1)
    lengths = rng.integers(40, L + 1, B)
    src = np.zeros((B, L), np.int64)
    for b, n in enumerate(lengths):
        src[b, :n] = rng.integers(1, 40, n)
    codes = None
    done = np.zeros((B, S), np.float32)
    done[:, -1] = 1.0
    steps = {}
    for n, p in variants.items():
        hp, model = build_model(p, CODES, "", device)
        step = sub(p, "parallel").make_train_step(hp)
        state = sub(p, "parallel").create_train_state(model, hp)
        if codes is None:
            codes = rng.integers(0, hp.num_mels, (B, S))
        target = np.eye(hp.num_mels, dtype=np.float32)[codes]
        batch = sub(p, "models").Batch(
            source=torch.from_numpy(src),
            source_length=torch.from_numpy(lengths),
            target=torch.from_numpy(target),
            target_length=torch.full((B,), S),
            done=torch.from_numpy(done),
            spec_loss_mask=torch.ones(B, S), binary_loss_mask=torch.ones(B, S))
        steps[n] = (step, state, batch)
    losses = {}

    def call(n):
        step, state, batch = steps[n]
        with torch.enable_grad():
            losses[n] = step(state, batch)["loss"].reshape(1)
    whole_report(f"whole-train step B={B} S={S}",
                 {n: (lambda n=n: call(n)) for n in variants}, reps, losses)


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=DIR of an earlier copy of the package")
    ap.add_argument("--cases", default="encode,step,serve")
    ap.add_argument("--reps", type=int, default=5)
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
    import self_attention_tacotron_torch as tree
    variants = {"tree": tree}
    for spec in args.variant:
        name, path = spec.split("=", 1)
        variants[name] = load_variant(name, os.path.abspath(path))
    cases = args.cases.split(",")
    kernels = (WHOLE_KERNELS if any(c.startswith("whole-") for c in cases)
               else KERNELS)
    builds = {name: sub(pkg, "ops.cuda_build")
              for name, pkg in variants.items()}
    jobs = {(name, k): b._start_build(k) for name, b in builds.items()
            for k in kernels}                       # all at once
    for (name, k), job in jobs.items():
        for line in builds[name]._finish_build(k, job).splitlines():
            if any(w in line for w in ("registers", "stack", "spill")):
                print(f"ptxas {name} {k}: {line.strip()}", flush=True)
    for case in cases:
        if case == "whole-train":
            whole_train_case(variants, device, args.reps)
        elif case in ("whole-serve", "whole-mel", "whole-pallas"):
            whole_serve_case(variants, case, device, args.reps)
        elif case == "encode":
            encode_case(variants, device, args.reps)
        elif case == "step":
            step_case(variants, device, args.reps)
        elif case == "serve":
            serve_case(variants, device, args.reps)
        elif case == "attention":
            attention_case(variants, device, args.reps)
        elif case == "wide":
            wide_case(variants, device, args.reps)
        elif case == "wide-plan":
            wide_plan_case(device, args.reps)
        elif case == "bf16":
            bf16_case(variants, device, args.reps)
        elif case == "step-bf16":
            step_bf16_case(variants, device, args.reps)
        elif case == "spectrogram":
            spectrogram_case(variants, device, args.reps)
        elif case == "sass":
            sass_case(variants, builds)
        else:
            raise ValueError(f"unknown case {case}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
