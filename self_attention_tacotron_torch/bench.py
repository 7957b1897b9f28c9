"""Decoder throughput of the flagship model on the card.

The port's counterpart of the repo's ``bench.py``: the free-running decode
of the flagship configuration (1025-way codes, batch 1, a 64-phone source,
the 450-step cap with early stop off) through the model's fused path
(``encoder_fused_inference``, ``decoder_fused_inference``: kernels #1 and
#2), weights from seed 0.  After a warm-up it times ``reps`` back-to-back
decodes with CUDA events around them and prints one JSON line,
``{"metric": "decoder_frames_per_sec_per_chip", "value", "unit",
"vs_baseline"}``, with the same fields and the same 500 frames/s
denominator (an estimate for the TF1 reference's single-GPU decode) as
``bench.py``.  It needs a CUDA device; there is no CPU fallback.

    python -m self_attention_tacotron_torch.bench [--reps N]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

REFERENCE_ESTIMATE_FPS = 500.0
SOURCE_LENGTH = 64


def make_flagship(device, seed: int = 0):
    """``(hp, model, batch)``: the full-width flagship on the fused path,
    weights from ``seed``, and the benchmark's batch-1 source."""
    from .entry import _flagship_hparams
    from .models import Batch, tacotron_model_factory
    from .utils.convert import init_parameters
    hp = _flagship_hparams(tiny=False)
    hp.max_iters = 450
    hp.decoder_early_stop = False    # the whole 450 steps: random weights'
    hp.decoder_fused_inference = True    # stop tokens fire at once
    hp.encoder_fused_inference = True
    model = init_parameters(tacotron_model_factory(hp), seed)
    model = model.to(device).eval()
    rng = np.random.default_rng(seed)
    batch = Batch(
        source=torch.from_numpy(rng.integers(
            1, hp.num_symbols, (1, SOURCE_LENGTH))).to(device),
        source_length=torch.tensor([SOURCE_LENGTH], device=device))
    return hp, model, batch


def measure(reps: int = 20, warmup: int = 2, device="cuda") -> dict:
    """The benchmark's JSON line as a dict: ``reps`` back-to-back decodes
    timed with CUDA events after ``warmup`` of them."""
    if not torch.cuda.is_available():
        raise RuntimeError("the benchmark times the card: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    hp, model, batch = make_flagship(torch.device(device))

    @torch.no_grad()
    def decode():
        return model(batch)

    for _ in range(warmup):
        decode()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        decode()
    end.record()
    end.synchronize()
    per_decode_s = start.elapsed_time(end) / 1e3 / reps
    # every decode runs all max_iters steps (early stop off); the model's
    # lengths are its stop logits' post-hoc reading, not the steps run
    fps = hp.max_iters * hp.outputs_per_step / per_decode_s
    return {"metric": "decoder_frames_per_sec_per_chip",
            "value": round(fps, 2), "unit": "frames/s",
            "vs_baseline": round(fps / REFERENCE_ESTIMATE_FPS, 3)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    print(json.dumps(measure(args.reps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
