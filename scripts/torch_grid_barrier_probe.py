#!/usr/bin/env python3
"""Cost of one grid-wide barrier on the card, for the port's cooperative
kernels (``self_attention_tacotron_torch/ops/csrc``): cooperative groups'
``this_grid().sync()`` beside hand-written ones: the ``GridBarrier`` of
``csrc/common.cuh`` (the one those kernels use: one counter,
atom.add.acq_rel and an ld.acquire spin) and the designs it was chosen
over (``csrc/grid_barrier_probe.cu`` lists them).

Builds ``csrc/grid_barrier_probe.cu`` through ``ops/cuda_build`` (into
``build/torch_kernels/``), runs 20000 barriers back to back in one
cooperative launch of 256-thread blocks, for one block per SM, half of that
and 16 blocks, the barriers in turns, and prints the card and
microseconds per barrier (CUDA events, median of 5 launches after a
warm-up).  ``chip_smoke.py`` calls ``barrier_costs`` for one block per SM.

    python3 scripts/torch_grid_barrier_probe.py
"""

import ctypes
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BARRIERS = 20000
KINDS = ("cooperative_groups", "counter+generation", "word a block",
         "GridBarrier", "red+fence", "red+acquire")


def barrier_costs(blocks: int, barriers: int = BARRIERS, reps: int = 5):
    """Microseconds per barrier of each of ``KINDS`` at ``blocks`` blocks:
    the median of ``reps`` timed launches after one warm-up, the kinds in
    turns."""
    import torch
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from self_attention_tacotron_torch.ops import cuda_build
    lib = cuda_build.load("grid_barrier_probe")
    launch = lib.grid_barrier_probe_launch
    launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    launch.restype = ctypes.c_int
    out = torch.zeros(blocks, device="cuda")
    words = torch.zeros(256, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    times = {k: [] for k in range(len(KINDS))}
    for rep in range(reps + 1):
        for kind in (range(len(KINDS)) if rep % 2 else
                     reversed(range(len(KINDS)))):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            err = launch(kind, blocks, barriers, out.data_ptr(),
                         words.data_ptr(), stream)
            end.record()
            if err:
                raise RuntimeError(f"probe launch failed: cudaError {err}")
            end.synchronize()
            if rep:                       # the first round is the warm-up
                times[kind].append(start.elapsed_time(end))
    return {KINDS[k]: statistics.median(v) * 1e3 / barriers
            for k, v in times.items()}


def main() -> int:
    import torch
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], check=False)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for blocks in (sms, sms // 2, 16):
        costs = barrier_costs(blocks)
        print(f"grid barrier, {blocks} blocks: " + ", ".join(
            f"{k} {v:.3f} us" for k, v in costs.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
