"""Forced-alignment prediction and the bi-GRU CBHG against the JAX package
on CPU.

* ``GRUCell`` and ``BiGRU`` (rows of ragged lengths, the backward cell over
  each row's length-reversed prefix) against the JAX package's, weights
  carried by ``utils/convert.from_flax``: tolerance 1e-6.
* The bridge round trip of the bi-GRU CBHG's tree
  (``examples/codes/tacotron.json``: ``ZoneoutEncoderV1`` without zoneout).
* ``parallel.make_predict_step`` with ``use_forced_alignment_mode``
  against the JAX package's ``make_predict_step``: the codes kind (the
  first pass through the fused kernels' plain versions at batch 1, the
  early-exit loop and the plain loop at batch 2) and the mel kind (the
  early-exit loop).  A stop bias fires every row right after
  ``min_iters``, and the target runs past the first pass's stop step and
  past ``max_iters``, so the second pass replays the rows the first pass
  left after its stop and the last row clipped.  Outputs, alignments and
  lengths of both passes within 1e-5.
* ``cli.predict.main_code`` with the flag on writes the second pass's
  one-hot codes: the ``.mfbsp`` dump equals the predict step's on the
  utterance's bucket-padded batch.
"""

import test_torch_threads  # noqa: F401  (bounds torch's threads)
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.models import \
    tacotron_model_factory as jax_factory
from self_attention_tacotron_tpu.models.tacotron import Batch as JaxBatch
from self_attention_tacotron_tpu.ops import rnn as jrnn
from self_attention_tacotron_tpu.parallel import \
    make_predict_step as jax_make_predict_step
from self_attention_tacotron_tpu.parallel.train_step import \
    TrainState as JaxTrainState
from self_attention_tacotron_torch import config
from self_attention_tacotron_torch.cli.predict import main_code
from self_attention_tacotron_torch.data.dataset import (Bucketing,
                                                        iter_utterances,
                                                        pad_batch,
                                                        to_model_batch)
from self_attention_tacotron_torch.models import tacotron_model_factory
from self_attention_tacotron_torch.ops import rnn as trnn
from self_attention_tacotron_torch.parallel import make_predict_step
from self_attention_tacotron_torch.utils import convert

from test_tacotron_model import tiny_hp
from test_torch_mel_model import MEL
from test_torch_ops import ROOT, load, randn, tiny_codes_hp
from test_torch_predict import RECIPE, TINY, _write_corpus
from test_torch_train_step import port_batch

TOL_GRU = 1e-6
TOL = 1e-5
STOP_BIAS = 6.0
MAX_ITERS, TARGET_STEPS = 6, 9   # the target outruns max_iters


def _jax_gru_vars(module, *args):
    v = module.init(jax.random.PRNGKey(0), *args)
    # non-zero biases: the gate bias starts at 1.0, the candidate's at 0
    return jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.1, v)


def test_gru_cell_matches_jax():
    x, h = randn(0, 3, 5), randn(1, 3, 4)
    cell = jrnn.GRUCell(4)
    v = _jax_gru_vars(cell, h, x)
    jh, jy = cell.apply(v, h, x)
    got = load(trnn.GRUCell(5, 4), v)
    with torch.no_grad():
        th, ty = got(torch.from_numpy(h), torch.from_numpy(x))
    np.testing.assert_allclose(th, jh, rtol=0, atol=TOL_GRU)
    np.testing.assert_allclose(ty, jy, rtol=0, atol=TOL_GRU)


def test_bigru_ragged_lengths_match_jax():
    xs, lengths = randn(2, 3, 9, 6), np.array([9, 5, 1], np.int32)
    mod = jrnn.BiGRU(4)
    v = _jax_gru_vars(mod, jnp.asarray(xs), jnp.asarray(lengths))
    ref = mod.apply(v, jnp.asarray(xs), jnp.asarray(lengths))
    got = load(trnn.BiGRU(6, 4), v)
    with torch.no_grad():
        out = got(torch.from_numpy(xs), torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL_GRU)
    assert not out[1, 5:].any() and not out[2, 1:].any()


def test_gru_gate_bias_starts_at_one():
    model = convert.init_parameters(tacotron_model_factory(
        config.default_hparams().parse_json_file(
            os.path.join(ROOT, "examples", "codes", "tacotron.json")).parse(
                TINY)), seed=0)
    bigru = model.encoder.cbhg.bigru
    for cell in (bigru.fw, bigru.bw):
        assert torch.equal(cell.gates.bias, torch.ones_like(cell.gates.bias))
        assert not cell.candidate.bias.any()


def test_bigru_cbhg_tree_round_trips():
    hp = config.default_hparams().parse_json_file(
        os.path.join(ROOT, "examples", "codes", "tacotron.json")).parse(TINY)
    model = convert.init_parameters(tacotron_model_factory(hp), seed=2)
    tree = convert.to_flax(model.state_dict(), model)
    fw = tree["params"]["encoder"]["cbhg"]["bigru"]["fw"]
    assert set(fw) == {"gates/kernel", "gates/bias", "candidate/kernel",
                       "candidate/bias"}
    assert fw["gates/kernel"].shape == (16, 16)      # (8 in + 8 units, 2u)
    back = convert.from_flax(tree)
    assert back.keys() == model.state_dict().keys()
    for k, t in model.state_dict().items():
        assert torch.equal(back[k], t), k
    paths = dict(convert.flax_param_paths(model))
    assert "encoder/cbhg/bigru/bw/candidate/kernel" in paths


# ----------------------------------------------------- forced alignment

CASES = {
    "codes_fused_b1": (dict(), 1),
    "codes_while_b2": (dict(decoder_fused_inference=False,
                            encoder_fused_inference=False), 2),
    "codes_plain_b2": (dict(decoder_fused_inference=False,
                            encoder_fused_inference=False,
                            decoder_early_stop=False), 2),
    "mel_while_b2": (dict(MEL, use_l2_regularization=False), 2),
}


def case_hp(name):
    kw, _ = CASES[name]
    base = dict(use_forced_alignment_mode=True, max_iters=MAX_ITERS,
                decoder_min_iters=1)
    if name.startswith("codes"):
        return tiny_codes_hp(**dict(base, **dict(
            dict(decoder_fused_inference=True, encoder_fused_inference=True),
            **kw)))
    return tiny_hp(**dict(base, **kw))


def case_batch(hp, B, seed=0):
    rng = np.random.default_rng(seed)
    r = hp.outputs_per_step
    T_in, T_out = 7, r * TARGET_STEPS
    if hp.tacotron_model == "DualSourceSelfAttentionTacotronModel":
        target = np.eye(hp.num_mels, dtype=np.float32)[
            rng.integers(0, hp.num_mels, (B, T_out))]
    else:
        target = rng.standard_normal((B, T_out, hp.num_mels)).astype(
            np.float32)
    return JaxBatch(
        source=rng.integers(1, hp.num_symbols, (B, T_in)).astype(np.int32),
        source_length=np.array([T_in, T_in - 2][:B], np.int32),
        target=target, target_length=np.full((B,), T_out, np.int32),
        done=np.tile(np.eye(TARGET_STEPS, dtype=np.float32)[-1], (B, 1)),
        spec_loss_mask=np.ones((B, T_out), np.float32),
        binary_loss_mask=np.ones((B, TARGET_STEPS), np.float32),
        speaker_id=np.zeros((B,), np.int32),
        accent_type=np.zeros((B, T_in), np.int32))


def seeded(hp, seed=1):
    """The port's seeded model, its stop bias raised so that every row
    fires right after min_iters, and its tree for the JAX package."""
    model = convert.init_parameters(tacotron_model_factory(hp), seed).eval()
    with torch.no_grad():
        model.decoder.stop_token_projection.bias += STOP_BIAS
        for name, b in model.named_buffers():
            if name.endswith("running_var"):
                b.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(
                    len(name)))
    return model, convert.to_flax(model.state_dict(), model)


@functools.lru_cache(maxsize=None)
def jax_passes(name):
    """The JAX predict step's output, and its first pass (INFERENCE)."""
    hp = case_hp(name)
    _, v = seeded(hp)
    model = jax_factory(hp)
    state = JaxTrainState(step=0, params=v["params"],
                          batch_stats=v["batch_stats"], constants={},
                          opt_state=None)
    batch = case_batch(hp, CASES[name][1])
    first = jax_make_predict_step(model, hp.replace(
        use_forced_alignment_mode=False))(state, batch)
    out = jax_make_predict_step(model, hp)(state, batch)
    return (jax.tree_util.tree_map(np.asarray, first),
            jax.tree_util.tree_map(np.asarray, out))


def _close(got, ref, name):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL, err_msg=name)


@pytest.mark.parametrize("name", list(CASES))
def test_predict_step_matches_jax(name):
    hp = case_hp(name)
    model, _ = seeded(hp)
    batch = port_batch(case_batch(hp, CASES[name][1]))
    passes = make_predict_step(hp)(model, batch)
    assert len(passes) == 2
    for got, ref, tag in zip(passes, jax_passes(name), ("first", "forced")):
        _close(got.outputs, ref.outputs, f"{tag} outputs")
        for g, r in zip(got.alignments, ref.alignments):
            _close(g, r, f"{tag} alignments")
        np.testing.assert_array_equal(got.lengths.numpy(), ref.lengths)
        if got.postnet_outputs is not None:
            _close(got.postnet_outputs, ref.postnet_outputs, f"{tag} postnet")
    first, forced = passes
    stop = int(first.lengths.max())
    assert stop < hp.max_iters < TARGET_STEPS    # replays past the stop
    assert forced.outputs.shape[1] == TARGET_STEPS * hp.outputs_per_step
    np.testing.assert_array_equal(forced.lengths.numpy(), TARGET_STEPS)
    # the second pass attends with the first's rows, the last one clipped
    for got, ref in zip(forced.alignments, first.alignments):
        torch.testing.assert_close(got[:, :, :hp.max_iters], ref, rtol=0,
                                   atol=0)
        torch.testing.assert_close(
            got[:, :, hp.max_iters:],
            ref[:, :, -1:].expand(-1, -1, TARGET_STEPS - hp.max_iters),
            rtol=0, atol=0)


def test_predict_step_without_the_flag_is_one_pass():
    hp = case_hp("codes_while_b2").replace(use_forced_alignment_mode=False)
    model, _ = seeded(hp)
    batch = port_batch(case_batch(hp, 2))
    (out,) = make_predict_step(hp)(model, batch)
    ref = model(batch)
    torch.testing.assert_close(out.outputs, ref.outputs, rtol=0, atol=0)
    with pytest.raises(ValueError):
        make_predict_step(hp.replace(use_forced_alignment_mode=True))(
            model, batch._replace(target=None))


def test_main_code_forced_alignment_writes_the_second_pass(tmp_path,
                                                           capsys):
    hp = config.default_hparams().parse_json_file(RECIPE).parse(TINY)
    hp.parse("use_forced_alignment_mode=true")
    data, ckpt, out = (str(tmp_path / d) for d in ("data", "ckpt", "out"))
    os.makedirs(data)
    keys = _write_corpus(hp, data)
    model = convert.init_parameters(tacotron_model_factory(hp), seed=1)
    convert.save_checkpoint(model, ckpt, 3)
    rc = main_code(["--source-data-root", data, "--target-data-root", data,
                    "--checkpoint-dir", ckpt, "--output-dir", out,
                    "--hparam-json-file", RECIPE, "--hparams",
                    TINY + ",use_forced_alignment_mode=true",
                    "--device", "cpu"])
    assert rc == 0
    printed = capsys.readouterr().out
    bucketing, step = Bucketing(hp), make_predict_step(hp)
    src = [os.path.join(data, f"{k}.{hp.source_file_extension}")
           for k in keys]
    tgt = [os.path.join(data, f"{k}.{hp.target_file_extension}")
           for k in keys]
    for u in iter_utterances(src, tgt, hp, "codes"):
        pad = bucketing.target_pad_length(bucketing.bucket_id(
            u.target_length))
        first, forced = step(model.eval(), to_model_batch(pad_batch(
            [u], hp, pad, target_kind="codes")))
        assert forced.lengths[0] == pad
        assert (f"predicted {u.meta.key}: {pad} decode steps (forced-"
                f"alignment pass after {int(first.lengths[0])} free-running "
                "steps)") in printed
        dump = np.fromfile(os.path.join(
            out, f"{u.meta.key}.{hp.predicted_mel_extension}"), "<f4")
        np.testing.assert_array_equal(
            dump, forced.code_output[0].numpy().reshape(-1))
