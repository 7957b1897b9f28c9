"""Every shipped recipe (``examples/*/*.json``) built by the port and held
to the JAX package on CPU.

The counterpart of tests/test_examples_and_tools.py's
``test_example_configs_load_and_build``: each recipe's structure (model
kind, encoder, decoder, attention, zoneout, speakers, r, caps) at tiny
widths (``TINY``: 10 output channels, 16-unit CBHG, 8 decode steps), the
port's seeded parameters (``convert.init_parameters``) with random
batch-norm statistics carried to the JAX tree by ``convert.to_flax`` and
back by ``convert.from_flax``, the fused paths off on both sides (the kernels have
their own parity tests).  Compared, float32 on one batch of two rows (one
source shorter than the other, a speaker id in the recipe's table):

* INFERENCE: outputs, stop logits, alignments, lengths;
* VALIDATION free-running and teacher-forced: the same;
* TRAIN with dropout and zoneout off, teacher-forced (the port's rule for
  every decoder): the loss.

Outputs within 2e-4 (the raw-frame feedback of the mel-kind recipes, as
tests/test_torch_mel_model.py), alignments within 1e-5, the loss within
1e-5 relative.
"""

import test_torch_threads  # noqa: F401  (bounds torch's threads)
import functools
import glob
import os

import jax
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.config import \
    default_hparams as jax_default_hparams
from self_attention_tacotron_tpu.models import DecoderMode
from self_attention_tacotron_tpu.models import compute_loss as jax_loss
from self_attention_tacotron_tpu.models import \
    tacotron_model_factory as jax_factory
from self_attention_tacotron_tpu.models.tacotron import Batch as JaxBatch
from self_attention_tacotron_torch.config import default_hparams
from self_attention_tacotron_torch.models import (compute_loss,
                                                  tacotron_model_factory)
from self_attention_tacotron_torch.utils import convert

from test_torch_ops import ROOT
from test_torch_train_step import port_batch

RECIPES = sorted(glob.glob(os.path.join(ROOT, "examples", "*", "*.json")))
IDS = [os.path.relpath(p, os.path.join(ROOT, "examples"))[:-5]
       for p in RECIPES]
TINY = ("num_symbols=30,embedding_dim=16,num_mels=10,cbhg_out_units=16,"
        "conv_channels=8,max_filter_width=4,projection1_out_channels=8,"
        "projection2_out_channels=8,encoder_prenet_out_units=[16,8],"
        "self_attention_out_units=8,attention1_out_units=8,"
        "attention2_out_units=8,attention_out_units=12,"
        "decoder_prenet_out_units=[8,4],decoder_out_units=16,"
        "decoder_self_attention_out_units=16,speaker_embedding_dim=8,"
        "max_iters=8,decoder_min_iters=1,decoder_fused_inference=false,"
        "encoder_fused_inference=false,decoder_fused_train=false")
DET = ("encoder_prenet_drop_rate=0.0,decoder_prenet_drop_rate=0.0,"
       "self_attention_drop_rate=0.0,decoder_self_attention_drop_rate=0.0,"
       "zoneout_factor_cell=0.0,zoneout_factor_output=0.0")
TOL_OUT, TOL_ALIGN, TOL_LOSS = 2e-4, 1e-5, 1e-5
MODES = ("inference", "validation_free", "validation_teacher", "train_loss")


def recipe_hp(path, jax_side=False, deterministic=False):
    hp = (jax_default_hparams() if jax_side else default_hparams())
    hp.parse_json_file(path).parse(TINY)
    return hp.parse(DET) if deterministic else hp


def jax_batch(hp, B=2, T_in=7, seed=0):
    rng = np.random.default_rng(seed)
    r, steps = hp.outputs_per_step, 4
    T_out = r * steps
    return JaxBatch(
        source=rng.integers(1, hp.num_symbols, (B, T_in)).astype(np.int32),
        source_length=np.array([T_in, T_in - 2][:B], np.int32),
        target=rng.standard_normal((B, T_out, hp.num_mels)).astype(
            np.float32),
        target_length=np.full((B,), T_out, np.int32),
        done=np.tile(np.eye(steps, dtype=np.float32)[-1], (B, 1)),
        spec_loss_mask=np.ones((B, T_out), np.float32),
        binary_loss_mask=np.ones((B, steps), np.float32),
        speaker_id=(hp.speaker_embedding_offset
                    + np.arange(B) % hp.num_speakers).astype(np.int32),
        accent_type=np.zeros((B, T_in), np.int32))


@functools.lru_cache(maxsize=None)
def jax_case(path):
    """(variables, INFERENCE / VALIDATION outputs, the TRAIN loss)."""
    hp = recipe_hp(path, jax_side=True)
    model, batch = jax_factory(hp), jax_batch(hp)
    seeded = convert.init_parameters(tacotron_model_factory(recipe_hp(path)),
                                     seed=1)
    v = convert.to_flax(seeded.state_dict(), seeded)
    rng = np.random.default_rng(3)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda x: rng.uniform(0.5, 1.5, x.shape).astype(np.float32),
        v["batch_stats"])

    @jax.jit
    def decodes(v, b):
        return (model.apply(v, b._replace(done=None), DecoderMode.INFERENCE),
                model.apply(v, b, DecoderMode.VALIDATION, False),
                model.apply(v, b, DecoderMode.VALIDATION, True))

    hp_det = recipe_hp(path, jax_side=True, deterministic=True)
    det = jax_factory(hp_det)

    @jax.jit
    def train_loss(v, b):
        out, _ = det.apply(v, b, DecoderMode.TRAIN, True,
                           rngs={"dropout": jax.random.PRNGKey(1),
                                 "zoneout": jax.random.PRNGKey(2)},
                           mutable=["batch_stats"])
        return jax_loss(hp_det, out, b, v["params"])["loss"]

    outs = jax.tree_util.tree_map(np.asarray, decodes(v, batch))
    return v, outs, float(train_loss(v, batch))


def port_model(path, deterministic=False):
    model = tacotron_model_factory(recipe_hp(path,
                                             deterministic=deterministic))
    model.load_state_dict(convert.from_flax(jax_case(path)[0]), strict=True)
    return model


def _close(got, ref, tol, name):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0,
                               atol=tol, err_msg=name)


def _check(got, ref):
    _close(got.outputs, ref.outputs, TOL_OUT, "outputs")
    _close(got.stop_token, ref.stop_token, TOL_OUT, "stop_token")
    assert len(got.alignments) == len(ref.alignments)
    for g, r in zip(got.alignments, ref.alignments):
        _close(g, r, TOL_ALIGN, "alignments")
    np.testing.assert_array_equal(got.lengths.numpy(), ref.lengths)
    assert (got.code_output is None) == (ref.code_output is None)
    if got.code_output is not None:
        _close(got.code_output, ref.code_output, 0, "code_output")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("path", RECIPES, ids=IDS)
def test_recipe_matches_jax(path, mode):
    _, outs, loss_ref = jax_case(path)
    jb = jax_batch(recipe_hp(path))
    batch = port_batch(jb)._replace(
        speaker_id=torch.from_numpy(jb.speaker_id))
    if mode == "train_loss":
        model = port_model(path, deterministic=True).train()
        losses = compute_loss(model.hp, model.train_forward(batch), batch,
                              model)
        np.testing.assert_allclose(float(losses["loss"].detach()), loss_ref,
                                   rtol=TOL_LOSS)
        return
    model = port_model(path).eval()
    if mode == "inference":
        _check(model(batch), outs[0])
    else:
        _check(model.validation_forward(batch, mode == "validation_teacher"),
               outs[1 + (mode == "validation_teacher")])
