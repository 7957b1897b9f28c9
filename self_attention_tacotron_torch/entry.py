"""Entry point: the flagship model's teacher-forced loss as one function.

The port of the JAX package's ``__graft_entry__.py`` ``entry``:
``entry()`` returns ``(fn, args)``; ``fn(*args)`` is the teacher-forced
VALIDATION loss of the flagship model (``DualSourceSelfAttentionTacotron``
over VQ codes, r = 1) at tiny widths (``_flagship_hparams(tiny=True)``),
with weights from a seed and a batch of 2 made with numpy.  ``fn`` takes
the model or a state dict for it, and the batch.  It runs on ``cuda``
unless the caller passes ``device="cpu"``.

``dryrun_multichip(n)`` is the JAX module's: one data-parallel training
step of the tiny flagship on n ranks (spawned processes; on ``cuda`` rank
r on ``cuda:<r mod the GPUs>``, over gloo where ranks share a card),
held against the one-process step on the concatenated batch, first on the
plain trunk and then on the fused one, whose kernels each rank must
launch once on the card.  Both run deterministic (dropout and zoneout
off), since no rank split can draw the one-process step's masks, and the
rows' valid lengths differ, so that the two halves hold unequal counts.
``data_parallel_steps`` / ``single_process_step`` / ``step_errors`` are
its parts, for other configurations.

    python -m self_attention_tacotron_torch.entry [--device cpu] \
        [--multichip N]
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .config import HParams, default_hparams


# The paper's pitch-accent configuration (arXiv:1810.11960: Japanese pitch
# accent, MGC and LF0 for a WaveNet vocoder) as overrides of a codes
# recipe: accent-type encoder, MGC/LF0 model and decoder, mgclf0 targets;
# every other hparam stays at its default (60 mgcs, 256 lf0 classes over
# 66-529 Hz, 129 accent types of 32 dims, prenets (224, 112) and (32, 16),
# lf0_loss_factor 0.5).
PITCH_ACCENT = dict(
    tacotron_model="DualSourceSelfAttentionMgcLf0TacotronModel",
    encoder="SelfAttentionCBHGEncoderWithAccentType",
    decoder="DualSourceMgcLf0TransformerDecoder", use_accent_type=True,
    dataset="mgclf0.dataset.DatasetSource")


def _flagship_hparams(tiny: bool = False) -> HParams:
    """The flagship configuration: dual-source self-attention Tacotron over
    VQ codes, r = 1; full width with 1025 codes, or tiny widths."""
    hp = default_hparams()
    hp.tacotron_model = "DualSourceSelfAttentionTacotronModel"
    hp.encoder = "SelfAttentionCBHGEncoder"
    hp.decoder = "DualSourceTransformerDecoder"
    if tiny:
        for name, value in dict(
                num_symbols=40, embedding_dim=32, num_mels=32,
                cbhg_out_units=32, conv_channels=16, max_filter_width=4,
                projection1_out_channels=16, projection2_out_channels=16,
                encoder_prenet_out_units=(32, 16),
                self_attention_out_units=16, attention1_out_units=16,
                attention2_out_units=8, attention_out_units=32,
                decoder_prenet_out_units=(16, 8), decoder_out_units=32,
                decoder_self_attention_out_units=32,
                max_iters=8).items():
            hp.set_hparam(name, value)
    else:
        hp.num_mels = 1025
    hp.outputs_per_step = 1
    hp.n_feed_frame = 1
    return hp


def _make_batch(hp: HParams, B: int, T_in: int, T_out: int, seed: int = 0):
    """A batch of random phone ids and one-hot code targets, every row full
    length, the last step done."""
    from .models import Batch
    rng = np.random.default_rng(seed)
    source = torch.from_numpy(rng.integers(1, hp.num_symbols, (B, T_in)))
    target = torch.nn.functional.one_hot(
        torch.from_numpy(rng.integers(0, hp.num_mels, (B, T_out))),
        hp.num_mels).float()
    steps = T_out // hp.outputs_per_step
    done = torch.zeros(B, steps)
    done[:, -1] = 1.0
    return Batch(source=source, source_length=torch.full((B,), T_in),
                 target=target, target_length=torch.full((B,), T_out),
                 done=done, spec_loss_mask=torch.ones(B, T_out),
                 binary_loss_mask=torch.ones(B, steps),
                 speaker_id=torch.zeros(B, dtype=torch.long))


def entry(device: str = "cuda"):
    """``(fn, (model, batch))``: ``fn(model_or_state_dict, batch)`` is the
    teacher-forced VALIDATION loss (a 0-d tensor) of the tiny flagship."""
    from .models import compute_loss, tacotron_model_factory
    from .utils.convert import init_parameters
    hp = _flagship_hparams(tiny=True)
    model = init_parameters(tacotron_model_factory(hp), 0).to(device).eval()
    batch = _make_batch(hp, B=2, T_in=12, T_out=8).to(device)

    @torch.no_grad()
    def fn(params, batch):
        if isinstance(params, dict):
            model.load_state_dict(params)
            params = model
        out = params.validation_forward(batch, True)
        return compute_loss(hp, out, batch, params)["loss"]

    return fn, (model, batch)


DETERMINISTIC = dict(encoder_prenet_drop_rate=0.0, decoder_prenet_drop_rate=0.0,
                     self_attention_drop_rate=0.0,
                     decoder_self_attention_drop_rate=0.0,
                     zoneout_factor_cell=0.0, zoneout_factor_output=0.0)
# a gradient whose largest magnitude is at most this share of the model's
# largest is rounding noise (the key projections' biases: a softmax removes
# what they add, so their exact gradient is zero), and Adam's first update
# turns noise into steps of up to the learning rate, in either direction
NOISE_SHARE = 1e-6
TRAIN_KERNELS = ("fused_train_fwd", "fused_train_bwd")


def _launches() -> Dict[str, int]:
    from .ops import fused_train as ft
    return {n: getattr(ft, n).launches for n in TRAIN_KERNELS}


def _one_step(hp: HParams, batch, device, seed: int, mesh=None) -> dict:
    """One ``make_train_step`` update of the model from ``seed`` on this
    rank's rows of ``batch``: the state before and after, the (clipped,
    global) gradients, the metrics and the training kernels' launches."""
    from .models import tacotron_model_factory
    from .parallel import create_train_state, make_train_step
    from .parallel.mesh import shard_batch
    from .parallel.multihost import replicate
    from .utils.convert import init_parameters
    model = init_parameters(tacotron_model_factory(hp), seed).to(device)
    replicate(model, mesh)
    before = {k: v.detach().cpu().clone() for k, v in
              model.state_dict().items()}
    state = create_train_state(model, hp)
    counts = _launches()
    with torch.enable_grad():
        metrics = make_train_step(hp, mesh=mesh)(
            state, shard_batch(batch, mesh).to(device))
    launched = {k: v - counts[k] for k, v in _launches().items()}
    return {"before": before,
            "after": {k: v.detach().cpu() for k, v in
                      model.state_dict().items()},
            "grads": {k: p.grad.detach().cpu()
                      for k, p in model.named_parameters()},
            "metrics": {k: float(v) for k, v in metrics.items()},
            "launches": launched}


def single_process_step(hp: HParams, batch, device: str = "cuda",
                        seed: int = 0) -> dict:
    """``_one_step`` on the whole batch in this process."""
    return _one_step(hp, batch, torch.device(device), seed)


def _dp_rank(rank: int, world: int, port: int, cases, device_type: str,
             seed: int, out_dir: str) -> None:
    from .parallel import multihost
    from .parallel.mesh import create_mesh
    import torch.distributed as dist
    multihost.initialize_distributed(f"localhost:{port}", world, rank,
                                     device_type=device_type,
                                     local_world_size=world, timeout_s=300)
    try:
        device = multihost.rank_device(device_type, rank, world)
        if device.type == "cuda":
            matmul = torch.backends.cuda.matmul
            matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            matmul.allow_bf16_reduced_precision_reduction = False
        recs = [_one_step(hp, batch, device, seed,
                          create_mesh(hp.mesh_shape)) for hp, batch in cases]
        torch.save(recs, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def data_parallel_steps(cases: Sequence[Tuple[HParams, object]], n: int,
                        device: str = "cuda", seed: int = 0
                        ) -> List[List[dict]]:
    """For each (hp, global batch): ``_one_step`` on ``n`` spawned ranks,
    rank r on its rows of the batch.  Returns each case's records, one a
    rank.  On ``cuda`` the training kernels are built first."""
    from .parallel import multihost
    if device == "cuda":
        from .ops import cuda_build
        cuda_build.build_all(list(TRAIN_KERNELS))
    with tempfile.TemporaryDirectory() as out:
        multihost.spawn(_dp_rank, n, (n, multihost.free_port(),
                                      [(hp, b.to("cpu")) for hp, b in cases],
                                      device, seed, out))
        per_rank = [torch.load(os.path.join(out, f"rank{r}.pt"),
                               weights_only=False) for r in range(n)]
    return [[per_rank[r][c] for r in range(n)] for c in range(len(cases))]


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over the largest |b| (over 1 where b is all zero)."""
    if not b.numel():
        return 0.0
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / (scale if scale > 0 else 1.0)


def step_errors(single: dict, ranks: Sequence[dict],
                learning_rate: float) -> dict:
    """How far each rank's step is from the one-process step.  For the
    parameters (``params``), the (clipped, global) gradients (``grads``)
    and the batch-norm running statistics (``stats``): the largest error of
    a tensor over that tensor's largest magnitude, and (``*_global``) the
    largest error over the largest magnitude of them all; the loss and the
    gradient norm relative; whether the ranks' states are identical.  The
    noise tensors (``NOISE_SHARE``) stay out of ``params`` and ``grads``:
    their gradients must be noise on both sides and their updates within
    ``learning_rate`` (Adam's first step) of the initial values."""
    g_ref = single["grads"]
    largest = max(float(g.abs().max()) for g in g_ref.values() if g.numel())
    noise = sorted(k for k, g in g_ref.items()
                   if float(g.abs().max()) <= NOISE_SHARE * largest)
    kind = {k: "stats" if k.endswith(("running_mean", "running_var"))
            else "params" for k in single["after"]}
    scale = {w: max(float(v.abs().max()) for k, v in single["after"].items()
                    if kind[k] == w and v.numel()) for w in ("params", "stats")}
    scale["grads"] = largest
    errs = {"noise": noise, "noise_ok": True, "ranks_identical": True,
            **{w + sfx: 0.0 for w in ("params", "grads", "stats")
               for sfx in ("", "_global")}}

    def note(which, got, ref):
        diff = float((got - ref).abs().max()) if ref.numel() else 0.0
        errs[which] = max(errs[which], _rel(got, ref))
        errs[which + "_global"] = max(errs[which + "_global"],
                                      diff / scale[which])

    for rec in ranks:
        for k, ref in single["after"].items():
            if k in noise:
                errs["noise_ok"] &= bool(
                    float((rec["after"][k] - single["before"][k]).abs().max())
                    <= learning_rate * (1 + 1e-3)
                    and float(rec["grads"][k].abs().max())
                    <= NOISE_SHARE * largest)
            else:
                note(kind[k], rec["after"][k], ref)
        for k, ref in g_ref.items():
            if k not in noise:
                note("grads", rec["grads"][k], ref)
        errs["ranks_identical"] &= all(
            torch.equal(ranks[0]["after"][k], v)
            for k, v in rec["after"].items())
    for m in ("loss", "grad_norm"):
        ref = single["metrics"][m]
        errs[m] = max(abs(r["metrics"][m] - ref) for r in ranks) / abs(ref)
    return errs


def step_disagreements(errs: dict, tol: float) -> List[str]:
    """What of ``step_errors`` exceeds ``tol``: each gradient and running
    statistic against its tensor's largest magnitude, the parameters
    against the largest parameter magnitude (a tensor that starts at zero
    is, after one step, Adam's update lr * g / (|g| + 1e-8) alone, and its
    elements whose gradient is near 1e-8 carry that gradient's rounding,
    which the ranks' summation order sets, into the whole tensor), the
    loss and the gradient norm relative, the noise tensors and the ranks'
    agreement."""
    bad = [k for k in ("grads", "stats", "params_global", "loss",
                       "grad_norm") if not errs[k] <= tol]
    if not errs["noise_ok"]:
        bad.append("noise tensors")
    if not errs["ranks_identical"]:
        bad.append("ranks differ")
    return bad


def _dryrun_batch(hp: HParams, B: int):
    """The tiny flagship's batch with the valid lengths differing by row
    (so the ranks' halves hold unequal counts)."""
    batch = _make_batch(hp, B=B, T_in=10, T_out=8)
    lengths = torch.tensor([8 - (i % 3) * 2 for i in range(B)])
    steps = torch.arange(8)[None]
    spec = (steps < lengths[:, None]).float()
    done = (steps >= lengths[:, None] - 1).float()
    return batch._replace(target_length=lengths, spec_loss_mask=spec,
                          binary_loss_mask=spec.clone(), done=done)


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     tol: float = 1e-4) -> None:
    """One data-parallel step of the tiny flagship on ``n_devices`` ranks
    against the one-process step on the concatenated batch, on the plain
    trunk and on the fused one (on the card each rank launches each
    training kernel once); raises where ``step_disagreements`` finds an
    error beyond ``tol``."""
    hp = _flagship_hparams(tiny=True)
    for k, v in DETERMINISTIC.items():
        hp.set_hparam(k, v)
    batch = _dryrun_batch(hp, 2 * n_devices)
    cases = [(hp.replace(decoder_fused_train=fused), batch)
             for fused in (False, True)]
    ranked = data_parallel_steps(cases, n_devices, device)
    from .parallel.train_step import learning_rate
    for (case_hp, _), ranks in zip(cases, ranked):
        single = single_process_step(case_hp, batch, device)
        errs = step_errors(single, ranks, learning_rate(case_hp, 0))
        loss = ranks[0]["metrics"]["loss"]
        tag = "fused " if case_hp.decoder_fused_train else ""
        bad = step_disagreements(errs, tol)
        if bad or not math.isfinite(loss):
            raise AssertionError(f"dryrun_multichip({n_devices}) {tag}step "
                                 f"disagrees: {errs}")
        launches = [r["launches"] for r in ranks]
        if (case_hp.decoder_fused_train and device == "cuda"
                and any(c != {k: 1 for k in TRAIN_KERNELS}
                        for c in launches)):
            raise AssertionError(f"a rank did not launch each training "
                                 f"kernel once: {launches}")
        print(f"dryrun_multichip({n_devices}): {tag}OK loss={loss:.6f} "
              f"(single-process {single['metrics']['loss']:.6f}; max error "
              f"params {errs['params']:.2e} ({errs['params_global']:.2e} of "
              f"the largest), grads {errs['grads']:.2e}, stats "
              f"{errs['stats']:.2e}; launches a rank {launches})",
              flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda")
    p.add_argument("--multichip", type=int, default=0,
                   help="then dryrun_multichip(N)")
    args = p.parse_args(argv)
    fn, fn_args = entry(args.device)
    loss = float(fn(*fn_args))
    print(f"entry loss: {loss:.6f} on {args.device}")
    if args.multichip:
        dryrun_multichip(args.multichip, args.device)
    return 0 if np.isfinite(loss) else 1


if __name__ == "__main__":
    sys.exit(main())
