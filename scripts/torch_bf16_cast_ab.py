#!/usr/bin/env python3
"""A/B, in one process on one card, of the weight casts of model-wide bf16
(``compute_dtype=bfloat16``) in the Pallas serving mode.

    python3 scripts/torch_bf16_cast_ab.py [--reps 5]

``kept``: the port as it is, each module keeping its weights' bf16 copies
while autograd is off (``ops/compute_dtype.cast``).  ``fresh``: ``cast``
replaced by a cast at each use, as every call cast before the copies were
kept.  ``f32``: the same model in float32.  The codes recipe at full width
(``chip_smoke.py``'s model: random weights from seed 0), one 64-phone
utterance decoded for the recipe's 450 steps through #5 / #6, in the
order fresh kept f32, kept fresh f32, ...; host-clock ms of one call (the
card synchronised before and after), each variant's calls and median, and
how many pairs ``kept`` won.  Both bf16 variants must give equal outputs.
"""

import argparse
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from self_attention_tacotron_torch.models import Batch
    from self_attention_tacotron_torch.models import attention as mech
    from self_attention_tacotron_torch.ops import compute_dtype as cd
    from self_attention_tacotron_torch.ops import conv, cuda_build, rnn
    if not torch.cuda.is_available():
        print("torch_bf16_cast_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.set_grad_enabled(False)
    cuda_build.build_all(["self_attention", "incremental_attention"])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(f"{card}; torch {torch.__version__}", flush=True)
    device = torch.device("cuda", 0)
    models = {}
    for name, extra in (("f32", ""), ("bf16", "compute_dtype=bfloat16")):
        hp = cs.recipe_hparams()
        hp.parse(cs._join(cs.PALLAS_SERVING, extra))
        models[name] = cs.make_model(hp, device)
    batch = Batch(source=cs.source_ids(hp, cs.T_IN, cs.T_IN, 0, device),
                  source_length=torch.tensor([cs.T_IN], device=device))
    kept = cd.cast

    def fresh(owner, p, dtype):
        return p.to(dtype)

    def call(variant):
        for module in (cd, rnn, conv, mech):
            module.cast = fresh if variant == "fresh" else kept
        model = models["f32" if variant == "f32" else "bf16"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    outs = {v: call(v)[1] for v in ("f32", "fresh", "kept")}
    if not torch.equal(outs["fresh"].outputs, outs["kept"].outputs):
        print("torch_bf16_cast_ab: kept and fresh casts disagree",
              file=sys.stderr)
        return 1
    steps = int(outs["kept"].lengths[0])
    times = {v: [] for v in outs}
    for r in range(args.reps):
        order = ("fresh", "kept") if r % 2 == 0 else ("kept", "fresh")
        for v in order + ("f32",):
            times[v].append(call(v)[0])
    for v, ts in times.items():
        med = statistics.median(ts)
        print(f"{v}: ms a call {[round(t, 3) for t in ts]}; median "
              f"{med:.3f} = {med / steps:.4f} ms a step ({steps} steps); "
              f"card {card}", flush=True)
    wins = sum(k < f for k, f in zip(times["kept"], times["fresh"]))
    print(f"kept faster than fresh in {wins} of {args.reps} pairs",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
