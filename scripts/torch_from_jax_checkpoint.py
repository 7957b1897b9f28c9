#!/usr/bin/env python3
"""Convert a JAX package checkpoint into the PyTorch port's ``model-<n>.pt``.

    python scripts/torch_from_jax_checkpoint.py JAX_CKPT_DIR OUT_DIR \\
        --hparam-json-file examples/codes/self-attention-tacotron.json \\
        [--hparams k=v,...] [--step N]

Reads the orbax checkpoint that ``self_attention_tacotron_tpu.cli.train``
wrote in JAX_CKPT_DIR (the newest step, or ``--step``) through that
package's ``utils/checkpoint.py``, maps its parameters and batch
statistics to the port's state dict with ``utils/convert.from_flax``,
loads them into the port's model for the same hparams (strictly: every
name and shape must match) and writes ``OUT_DIR/model-<step>.pt``, which
``self_attention_tacotron_torch.cli.predict`` serves on the card.  It needs
JAX and orbax, so it runs where the JAX package runs, not on the card;
this script is the one module that imports both packages.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def jax_variables(ckpt_dir: str, step=None):
    """(step, {"params": ..., "batch_stats": ...}) of the JAX package's
    checkpoint, its leaves as numpy arrays."""
    import jax
    import numpy as np
    from self_attention_tacotron_tpu.utils.checkpoint import CheckpointManager
    mgr = CheckpointManager(ckpt_dir)
    step = mgr.latest_step() if step is None else int(step)
    if step is None:
        raise FileNotFoundError(f"no checkpoint found in {ckpt_dir}")
    restored = mgr.restore(None, step=step)
    mgr.close()
    if isinstance(restored, dict):       # a TrainState saved without a
        params = restored["params"]      # template comes back as a dict
        batch_stats = restored.get("batch_stats", {})
    else:                                # or in TrainState's field order
        params, batch_stats = restored[1], restored[2]
    return step, jax.tree_util.tree_map(
        np.asarray, {"params": params, "batch_stats": batch_stats or {}})


def convert(ckpt_dir: str, out_dir: str, hp, step=None) -> str:
    """Write the port's checkpoint of the JAX one; returns its path."""
    from self_attention_tacotron_torch.models import tacotron_model_factory
    from self_attention_tacotron_torch.utils.convert import (
        load_flax_variables, save_checkpoint)
    step, variables = jax_variables(ckpt_dir, step)
    model = load_flax_variables(tacotron_model_factory(hp), variables)
    return save_checkpoint(model, out_dir, step)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("jax_checkpoint_dir")
    p.add_argument("out_dir")
    p.add_argument("--hparam-json-file", default=None)
    p.add_argument("--hparams", default="")
    p.add_argument("--step", type=int, default=None)
    args = p.parse_args(argv)
    from self_attention_tacotron_torch.config import load_hparams
    path = convert(args.jax_checkpoint_dir, args.out_dir, load_hparams(args),
                   args.step)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
