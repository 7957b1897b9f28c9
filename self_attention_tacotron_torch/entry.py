"""Entry point: the flagship model's teacher-forced loss as one function.

The port of the JAX package's ``__graft_entry__.py`` ``entry``:
``entry()`` returns ``(fn, args)``; ``fn(*args)`` is the teacher-forced
VALIDATION loss of the flagship model (``DualSourceSelfAttentionTacotron``
over VQ codes, r = 1) at tiny widths (``_flagship_hparams(tiny=True)``),
with weights from a seed and a batch of 2 made with numpy.  ``fn`` takes
the model or a state dict for it, and the batch.  It runs on ``cuda``
unless the caller passes ``device="cpu"``.  (The JAX module's
``dryrun_multichip`` comes with the port's data parallelism.)

    python -m self_attention_tacotron_torch.entry [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .config import HParams, default_hparams


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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    fn, fn_args = entry(args.device)
    loss = float(fn(*fn_args))
    print(f"entry loss: {loss:.6f} on {args.device}")
    return 0 if np.isfinite(loss) else 1


if __name__ == "__main__":
    sys.exit(main())
