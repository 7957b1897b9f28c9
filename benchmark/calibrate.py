"""The readings the check's limits are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1-12 \\
        [--seconds 3] [--control-seeds 3]

For each seed, in one process, one run of the cell for ``--seconds``
(weights, traffic and sample from that seed), then the check: the
program's ``logit_gap`` and ``stop_gap`` against the float32 reference
(the lower readings) and, on the first ``--control-seeds`` seeds, the TF32
control's on the same calls and served frames (the upper readings), with
the highest stop logit the reference read.  One JSON line a seed, then
each number's lower reading (the largest program gap) and upper (the
smallest control gap).
"""

from __future__ import annotations

import argparse
import json
import sys

import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="1-12")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control-seeds", type=int, default=3)
    args = p.parse_args(argv)
    run.cache_dirs()
    sys.path.insert(0, str(run.ROOT))
    import torch
    from harness.spec import load_cell, load_json
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    lo, _, hi = args.seeds.partition("-")
    seeds = range(int(lo), int(hi or lo) + 1)
    cell = load_cell(load_json(run.ROOT / "BENCHMARK.json"), args.workload)
    device = torch.device("cuda", 0)
    gaps = ("logit_gap", "stop_gap")
    program = {g: [] for g in gaps}
    controls = {g: [] for g in gaps}
    for i, seed in enumerate(seeds):
        r = run.execute(cell, seed, args.seconds, False, device,
                        log=lambda *a, **k: None,
                        control=i < args.control_seeds)
        line = {"seed": seed, "correct": r["correct"],
                "attempted": r["attempted"],
                **{k: v["value"] for k, v in r["checks"].items()}}
        for g in gaps:
            program[g].append(line[g])
            if "control" in r:
                line[f"control_{g}"] = r["control"][g]
                controls[g].append(r["control"][g])
        if "control" in r:
            line["stop_max"] = r["control"]["stop_max"]
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": args.workload, **{
        g: {"lower": max(program[g]),
            "upper": min(controls[g]) if controls[g] else None}
        for g in gaps}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
