#!/usr/bin/env python3
"""mma.sync m16n8k8 TF32 throughput on the card, for the port's kernels
that run their products in the 3xTF32 split (``csrc/mma.cuh``): 8
independent accumulators a warp (the throughput), and the split's own
pattern (``mma3``: three dependent mma from zero, summed in f32 outside
the tensor core), 8 a warp in program order (each mma waits for the one
before: the latency of one), at 4, 8 and 16 warps an SM.

Builds ``csrc/mma_probe.cu`` through ``ops/cuda_build`` (into
``build/torch_kernels/``), launches one block an SM, and prints the card,
then for each case the SM cycles of the slowest block, cycles an mma of
one warp (in program order at one warp a scheduler, 4 warps an SM: the
latency of one mma), mma a cycle an SM and TFLOP/s (CUDA events around
the launch, the second of two).

    python3 scripts/torch_mma_probe.py
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 4096
KINDS = ("independent", "mma3 in order")


def main() -> int:
    import torch
    sys.path.insert(0, ROOT)
    from self_attention_tacotron_torch.ops import cuda_build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    launch = cuda_build.load("mma_probe").mma_probe_launch
    launch.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    launch.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cycles = torch.zeros(sms, dtype=torch.int64, device="cuda")
    sink = torch.zeros(1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for kind, name in enumerate(KINDS):
        per_round = 8 * (1 if name == "independent" else 3)
        for warps in (4, 8, 16):
            for _ in range(2):                # the first is the warm-up
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                err = launch(kind, sms, warps, ITERS, cycles.data_ptr(),
                             sink.data_ptr(), stream)
                end.record()
                if err:
                    raise RuntimeError(f"probe launch failed: cudaError "
                                       f"{err}")
                end.synchronize()
            mmas = warps * ITERS * per_round
            worst = int(cycles.max())
            ms = start.elapsed_time(end)
            print(f"{name}: {warps} warps an SM: {worst} cycles, "
                  f"{worst / (ITERS * per_round):.1f} cycles an mma of a "
                  f"warp, {mmas / worst:.3f} mma a cycle an SM, "
                  f"{sms * mmas * 2048 / (ms * 1e-3) / 1e12:.1f} TFLOP/s",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
