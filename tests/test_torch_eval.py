"""The port's evaluation path against the JAX package on CPU.

* VALIDATION decodes of the codes model (tests/test_tacotron_model.py's
  tiny sizes on the recipe's mechanisms), free-running (softmax feedback)
  and teacher-forced, with ``use_pallas_attention`` off and on (the JAX
  Pallas kernels in interpret mode, the port's plain versions), at B = 1
  and 2, against JAX ``model.apply(..., DecoderMode.VALIDATION, tf)``:
  outputs and stop logits within 2e-4, source and self-attention
  alignments within 1e-5 (zeros on both sides in the Pallas mode), equal
  predicted samples, code outputs and lengths.  The parameters come from a
  JAX model built with ``use_pallas_attention=True``; the weight bridge
  loads that tree strictly.
* ``make_eval_step``'s seven metrics against the JAX package's (rtol 1e-4).
* The train path equals the teacher-forced VALIDATION decode on the port
  (tests/test_decoder_parity.py's property), with the Pallas mode off and on.
* ``EvalThrottle`` (tests/test_train_cadence.py's cases) and a 2-step
  ``cli.train`` run on CPU whose checkpoint triggers one evaluation that
  writes ``eval/`` metrics.
"""

import test_torch_threads  # noqa: F401  (bounds torch's threads)
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.models import DecoderMode
from self_attention_tacotron_tpu.models import \
    tacotron_model_factory as jax_factory
from self_attention_tacotron_torch.cli.train import EvalThrottle
from self_attention_tacotron_torch.models import tacotron_model_factory
from self_attention_tacotron_torch.models.attention import AttentionOptions
from self_attention_tacotron_torch.models.decoder import TacotronDecoder
from self_attention_tacotron_torch.utils import convert

from test_tacotron_model import make_batch
from test_torch_ops import np_tree, tiny_codes_hp
from test_torch_train_step import port_batch, write_codes_corpus

TOL_OUT = 2e-4
TOL_ALIGN = 1e-5


def _hp(pallas, **kw):
    return tiny_codes_hp(use_pallas_attention=pallas,
                         use_l2_regularization=True, **kw)


def _jax_batch(B):
    jb = make_batch(_hp(True), B=B, T_in=7, T_out=6, seed=1)
    if B == 2:   # a shorter second source: masked attention memory
        jb = jb._replace(source_length=np.array([7, 5], np.int32))
    return jb


@functools.lru_cache(maxsize=None)
def _jax_variables():
    model = jax_factory(_hp(True))
    v = jax.jit(lambda key, batch: model.init(
        {"params": key}, batch, DecoderMode.VALIDATION, True))(
            jax.random.PRNGKey(0), _jax_batch(1))
    return np_tree(v)


@functools.lru_cache(maxsize=None)
def _jax_decodes(pallas, B):
    model = jax_factory(_hp(pallas))

    @jax.jit
    def run(v, batch):
        return tuple(model.apply(v, batch, DecoderMode.VALIDATION, tf)
                     for tf in (False, True))
    return jax.tree_util.tree_map(np.asarray,
                                  run(_jax_variables(), _jax_batch(B)))


def _port_model(pallas):
    model = tacotron_model_factory(_hp(pallas)).eval()
    model.load_state_dict(convert.from_flax(_jax_variables()), strict=True)
    return model


def test_bridge_loads_a_pallas_mode_tree():
    state = convert.from_flax(_jax_variables())
    model = tacotron_model_factory(_hp(True))
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state, strict=True)
    assert model.decoder.transformer_0.self_attention.attention.use_pallas
    assert model.encoder.self_attention_0.self_attention.attention.use_pallas


@pytest.mark.parametrize("teacher_forcing", [False, True],
                         ids=["free", "teacher"])
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("pallas", [False, True], ids=["einsum", "pallas"])
def test_validation_decode_matches_jax(pallas, B, teacher_forcing):
    ref = _jax_decodes(pallas, B)[int(teacher_forcing)]
    got = _port_model(pallas).validation_forward(port_batch(_jax_batch(B)),
                                                 teacher_forcing)
    for name in ("outputs", "stop_token"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(ref, name), rtol=0, atol=TOL_OUT,
                                   err_msg=name)
    pairs = [*zip(got.alignments, ref.alignments),
             *zip(got.decoder_self_attention_alignments,
                  ref.decoder_self_attention_alignments),
             *zip(got.encoder_self_attention_alignments,
                  ref.encoder_self_attention_alignments)]
    assert len(pairs) == 2 + 2 + 2
    for g, r in pairs:
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=TOL_ALIGN)
    if pallas:   # the kernels never materialise the probabilities
        assert all(not np.asarray(r).any() for _, r in pairs[2:])
    else:
        assert all(np.asarray(r).any() for _, r in pairs[2:])
    for name in ("predicted_samples", "code_output", "lengths"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(ref, name), err_msg=name)


def test_eval_step_metrics_match_jax():
    from self_attention_tacotron_tpu.parallel.train_step import \
        TrainState as JaxState
    from self_attention_tacotron_tpu.parallel.train_step import \
        make_eval_step as jax_make_eval_step
    from self_attention_tacotron_torch.parallel import (create_train_state,
                                                        make_eval_step)
    hp = _hp(True)
    v = _jax_variables()
    jb = _jax_batch(1)
    jstate = JaxState(step=0, params=v["params"],
                      batch_stats=v["batch_stats"], constants={},
                      opt_state=None)
    ref, _, _ = jax_make_eval_step(jax_factory(hp), hp)(jstate, jb)
    state = create_train_state(_port_model(True), hp)
    got, out_free, out_teacher = make_eval_step(hp)(state, port_batch(jb))
    assert set(got) == set(ref) == {
        "code_loss", "done_loss", "loss", "loss_with_teacher",
        "code_loss_with_teacher", "done_loss_with_teacher",
        "l2_regularization_loss"}
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4,
                                   err_msg=k)
    assert float(got["l2_regularization_loss"]) > 0
    assert float(got["loss"]) != float(got["loss_with_teacher"])
    assert out_free.outputs.shape == out_teacher.outputs.shape == (1, 6, 10)


@pytest.mark.parametrize("pallas", [False, True], ids=["einsum", "pallas"])
@pytest.mark.parametrize("r,B,T_factor,C,hops", [
    (1, 2, 6, 6, 1),
    (2, 1, 4, 4, 2),
    (2, 3, 5, 8, 1),
])
def test_train_path_equals_teacher_forced_validation(r, B, T_factor, C, hops,
                                                     pallas):
    T = T_factor * r
    dec = TacotronDecoder(
        (AttentionOptions(attention="additive", num_units=16),) * 2,
        source_dims=(12, 10), prenet_out_units=(16, 8),
        attention_rnn_out_units=16, decoder_out_units=24, num_mels=C,
        outputs_per_step=r, n_feed_frame=r, max_iters=20, min_iters=2,
        self_attention_out_units=24, self_attention_num_heads=2,
        self_attention_num_hop=hops, drop_rate=0.0,
        self_attention_drop_rate=0.0, use_pallas=pallas)
    convert.init_parameters(dec, seed=r * 10 + B)
    rng = np.random.default_rng(12345)
    target = torch.nn.functional.one_hot(
        torch.from_numpy(rng.integers(0, C, (B, T))), C).float()
    sources = (torch.from_numpy(rng.standard_normal((B, 7, 12)).astype(
        np.float32)), torch.from_numpy(rng.standard_normal(
            (B, 7, 10)).astype(np.float32)))
    lengths = (torch.full((B,), 7),) * 2
    with torch.no_grad():
        train = dec.train_forward(sources, lengths, target)
        val = dec.validation_forward(sources, lengths, target, True)
    for a, b in ((train.outputs, val.outputs),
                 (train.stop_token, val.stop_token),
                 *zip(train.alignments, val.alignments)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert torch.equal(train.predicted_samples, val.predicted_samples)


def test_start_delay_blocks_early_evals():
    th = EvalThrottle(start_delay_secs=120, throttle_secs=600, now=1000.0)
    assert not th.should_eval(now=1000.0)
    assert not th.should_eval(now=1119.9)
    assert th.should_eval(now=1120.0)


def test_throttle_rate_limits():
    th = EvalThrottle(start_delay_secs=0, throttle_secs=600, now=0.0)
    assert th.should_eval(now=0.0)
    assert not th.should_eval(now=100.0)
    assert not th.should_eval(now=599.9)
    assert th.should_eval(now=600.0)
    assert not th.should_eval(now=700.0)
    assert th.should_eval(now=1200.0)


def test_zero_cadence_always_evals():
    th = EvalThrottle(start_delay_secs=0, throttle_secs=0, now=0.0)
    assert all(th.should_eval(now=float(t)) for t in range(5))


def test_cli_train_evaluates_after_a_checkpoint(tmp_path, capsys):
    from self_attention_tacotron_torch.cli.train import main
    from self_attention_tacotron_torch.config import load_hparams
    from self_attention_tacotron_torch.utils.tb_events import read_events
    tiny = dict(num_symbols=30, embedding_dim=16, num_mels=10,
                cbhg_out_units=16, conv_channels=8, max_filter_width=4,
                projection1_out_channels=8, projection2_out_channels=8,
                encoder_prenet_out_units=[16, 8], self_attention_out_units=8,
                attention1_out_units=8, attention2_out_units=8,
                attention_out_units=12, decoder_prenet_out_units=[8, 4],
                decoder_out_units=16, decoder_self_attention_out_units=16,
                max_iters=12, decoder_min_iters=1, batch_size=2,
                approx_min_target_length=0, batch_bucket_width=16,
                save_checkpoints_steps=2, attention_kernel=4,
                decoder_version="v2")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "examples", "codes",
                           "self-attention-tacotron.json")) as f:
        hp_json = dict(json.load(f), **tiny)
    (tmp_path / "hp.json").write_text(json.dumps(hp_json))
    hp = load_hparams(type("A", (), {"hparam_json_file": str(
        tmp_path / "hp.json"), "hparams": ""}))
    data, ckpt = str(tmp_path / "data"), str(tmp_path / "ckpt")
    os.makedirs(data)
    keys = write_codes_corpus(hp, data, 6)
    with open(os.path.join(data, "validation.csv"), "w") as f:
        f.write("\n".join(keys[:3]) + "\n")
    assert main(["--source-data-root", data, "--target-data-root", data,
                 "--checkpoint-dir", ckpt, "--hparam-json-file",
                 str(tmp_path / "hp.json"), "--device", "cpu",
                 "--max-steps", "2", "--hparams",
                 "use_pallas_attention=true,eval_start_delay_secs=0,"
                 "eval_throttle_secs=0"]) == 0
    text = capsys.readouterr().out
    assert "train 6 validation 3" in text and "eval @2" in text
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        entries = [json.loads(line) for line in f]
    assert [e["step"] for e in entries] == [1, 2, 2]
    names = {"code_loss", "done_loss", "loss", "loss_with_teacher",
             "code_loss_with_teacher", "done_loss_with_teacher",
             "l2_regularization_loss"}
    assert {k for k in entries[2] if k.startswith("eval/")} == {
        "eval/" + k for k in names}
    assert all(np.isfinite(entries[2]["eval/" + k]) for k in names)
    assert "sec_per_step" in entries[0] and "grad_norm" in entries[1]
    events = [f for f in os.listdir(ckpt) if f.startswith("events.out")]
    assert len(events) == 1
    scalars = [e["scalars"] for e in read_events(os.path.join(ckpt,
                                                              events[0]))]
    assert "eval/loss_with_teacher" in scalars[-1]
    np.testing.assert_allclose(scalars[-1]["eval/loss"],
                               entries[2]["eval/loss"], rtol=1e-6)
