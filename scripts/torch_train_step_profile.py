#!/usr/bin/env python3
"""Where one training step of the port goes on the card.

Builds the shipped VQ-code recipe (``examples/codes/self-attention-tacotron.json``)
with weights from seed 0 on ``cuda``, one synthetic batch of 32 utterances
(sources of 40..64 phones, 250 one-hot code frames, numpy seed 1), and
after two warm-up steps:

* times 5 whole steps of ``parallel.make_train_step`` (host clock around
  each step, synchronised), and the encoder's training forward + backward
  alone (CUDA events, median of 5);
* traces 3 steps with ``torch.profiler`` and prints the device's busy
  share of the traced wall time (the union of the kernels' intervals),
  the kernel launches a step, and the kernels with the most device time.

    python3 scripts/torch_train_step_profile.py
"""

import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(ROOT, "examples", "codes",
                      "self-attention-tacotron.json")
B, T_IN, S = 32, 64, 250


def make_batch(hp, device):
    import numpy as np
    import torch
    from self_attention_tacotron_torch.models import Batch
    rng = np.random.default_rng(1)
    lengths = rng.integers(40, T_IN + 1, B)
    src = np.zeros((B, T_IN), np.int64)
    for b, L in enumerate(lengths):
        src[b, :L] = rng.integers(1, hp.num_symbols, L)
    codes = rng.integers(0, hp.num_mels, (B, S))
    target = np.eye(hp.num_mels, dtype=np.float32)[codes]
    done = np.zeros((B, S), np.float32)
    done[:, -1] = 1.0
    ones = np.ones((B, S), np.float32)
    t = torch.from_numpy
    return Batch(source=t(src), source_length=t(lengths),
                 target=t(target), target_length=torch.full((B,), S),
                 done=t(done), spec_loss_mask=t(ones),
                 binary_loss_mask=t(ones.copy())).to(device)


def busy_ms(events) -> float:
    """The union of the kernels' device intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile
    sys.path.insert(0, ROOT)
    from self_attention_tacotron_torch.config import default_hparams
    from self_attention_tacotron_torch.models import tacotron_model_factory
    from self_attention_tacotron_torch.parallel import (create_train_state,
                                                        make_train_step)
    from self_attention_tacotron_torch.utils.convert import init_parameters
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], check=False)
    device = torch.device("cuda", 0)
    hp = default_hparams().parse_json_file(RECIPE)
    model = init_parameters(tacotron_model_factory(hp), 0).to(device)
    batch = make_batch(hp, device)
    state = create_train_state(model, hp)
    step = make_train_step(hp)
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()

    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"train step B={B} S={S}: median {statistics.median(walls):.3f} "
          f"ms of {['%.1f' % w for w in walls]} (host clock)", flush=True)

    gen = torch.Generator(device).manual_seed(0)
    enc_times = []
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        lstm_out, sa, _ = model.encoder(model.embedding(batch.source),
                                        batch.source_length, True, gen)
        (lstm_out.sum() + sa.sum()).backward()
        end.record()
        end.synchronize()
        enc_times.append(start.elapsed_time(end))
    model.zero_grad(set_to_none=True)
    print(f"encoder training forward + backward: median "
          f"{statistics.median(enc_times[1:]):.3f} ms", flush=True)

    n = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_ms(kernels)
    print(f"traced {n} steps: wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"({100.0 * busy / wall:.1f} %), {len(kernels) / n:.0f} kernel "
          "launches a step", flush=True)
    totals = {}
    for e in kernels:
        ms, count = totals.get(e.name, (0.0, 0))
        totals[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    top = sorted(totals.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (ms, count) in top:
        print(f"  {ms / n:9.3f} ms/step {count // n:6d} launches/step  "
              f"{name[:90]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
