#!/usr/bin/env python3
"""Cost of one grid-wide barrier on the card, for the port's cooperative
kernels (``self_attention_tacotron_torch/ops/csrc``).

Builds ``csrc/grid_barrier_probe.cu`` through ``ops/cuda_build`` (into
``build/torch_kernels/``), runs 20000 ``cooperative_groups`` grid barriers
back to back in one cooperative launch of 256-thread blocks, for one block
per SM, half of that and 16 blocks, and prints the card and microseconds
per barrier (CUDA events, median of 5 launches after a warm-up).

    python3 scripts/torch_grid_barrier_probe.py
"""

import ctypes
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BARRIERS = 20000


def main() -> int:
    import torch
    sys.path.insert(0, ROOT)
    from self_attention_tacotron_torch.ops import cuda_build
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], check=False)
    lib = cuda_build.load("grid_barrier_probe")
    launch = lib.grid_barrier_probe_launch
    launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
    launch.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(sms, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for blocks in (sms, sms // 2, 16):
        times = []
        for rep in range(6):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            err = launch(blocks, BARRIERS, out.data_ptr(), stream)
            end.record()
            if err:
                raise RuntimeError(f"probe launch failed: cudaError {err}")
            end.synchronize()
            if rep:                       # the first launch is the warm-up
                times.append(start.elapsed_time(end))
        print(f"cooperative_groups grid barrier, {blocks} blocks: "
              f"{statistics.median(times) * 1e3 / BARRIERS:.3f} us per "
              "barrier", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
