"""The port's decoder and whole codes model against the JAX package on CPU.

One JAX codes model (tests/test_tacotron_model.py's tiny sizes, forward +
additive attention, even location-conv width, decoder v2) is initialised
and carried over whole with the weight bridge.  At batch 1 in INFERENCE:

* the port's plain loop vs the JAX scan path (``decoder_early_stop`` off)
  and the JAX while path (early stop, a stop bias that fires early);
* the plain version of the fused-decode kernel (``fused_decode_reference``,
  what ``fused_decode`` runs for CPU tensors) vs both;
* energy vectors scaled so that sum|v| is far above the energies' row max
  (where the JAX kernel's static softmax shift underflows): the port stays
  finite and matches its plain loop and the JAX scan path;
* batch 2 and location-sensitive sources, which the fused decode's gate
  used to send to the plain path, run fused and match it.

Outputs, stop logits, alignments, predicted samples and lengths are
compared with tolerance 2e-4, as tests/test_fused_decode.py does.
"""

import test_torch_threads  # noqa: F401  (bounds torch's threads)
import functools

import jax
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.models import DecoderMode
from self_attention_tacotron_tpu.models import \
    tacotron_model_factory as jax_factory
from self_attention_tacotron_torch.models import Batch, tacotron_model_factory
from self_attention_tacotron_torch.utils import convert

from test_tacotron_model import make_batch
from test_torch_ops import jit_init, np_tree, tiny_codes_hp

TOL = 2e-4
STOP_BIAS = 5.0


@functools.lru_cache(maxsize=None)
def _jax_variables():
    hp = tiny_codes_hp()
    model = jax_factory(hp)
    v = jit_init(model, {"params": jax.random.PRNGKey(0)},
                 make_batch(hp, B=1), mode=DecoderMode.VALIDATION,
                 teacher_forcing=True)
    return np_tree(v)


def _variables(stop_bias=0.0, v_scale=1.0):
    v = jax.tree_util.tree_map(np.copy, _jax_variables())
    dec = v["params"]["decoder"]
    dec["stop_token_projection"]["bias"] = dec["stop_token_projection"][
        "bias"] + np.float32(stop_bias)
    dec["attention_mechanism_0"]["attention_variable"] *= np.float32(v_scale)
    dec["attention_mechanism_1"]["attention_v"] *= np.float32(v_scale)
    return v


def _batch(hp):
    return make_batch(hp, B=1, T_in=7, seed=1)._replace(target=None,
                                                        done=None)


@functools.lru_cache(maxsize=None)
def _jax_out(early_stop, stop_bias=0.0, v_scale=1.0):
    hp = tiny_codes_hp(decoder_early_stop=early_stop)
    out = jax_factory(hp).apply(_variables(stop_bias, v_scale), _batch(hp),
                                DecoderMode.INFERENCE)
    return jax.tree_util.tree_map(np.asarray, out)


def _port_out(early_stop, fused, stop_bias=0.0, v_scale=1.0, B=1):
    hp = tiny_codes_hp(decoder_early_stop=early_stop,
                       decoder_fused_inference=fused,
                       encoder_fused_inference=fused)
    model = tacotron_model_factory(hp).eval()
    model.load_state_dict(convert.from_flax(_variables(stop_bias, v_scale)),
                          strict=True)
    jb = _batch(hp)
    src = np.repeat(np.asarray(jb.source), B, 0)
    return model(Batch(torch.from_numpy(src),
                       torch.from_numpy(np.repeat(
                           np.asarray(jb.source_length), B, 0))))


def _assert_close(got, ref, tol=TOL):
    np.testing.assert_allclose(got.outputs.numpy(), ref.outputs, rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(got.stop_token.numpy(), ref.stop_token,
                               rtol=tol, atol=tol)
    for a, b in zip(got.alignments, ref.alignments):
        np.testing.assert_allclose(a.numpy(), b, rtol=tol, atol=tol)
    np.testing.assert_array_equal(got.predicted_samples.numpy(),
                                  ref.predicted_samples)
    np.testing.assert_array_equal(got.lengths.numpy(), ref.lengths)
    np.testing.assert_array_equal(got.code_output.numpy(), ref.code_output)


def test_bridge_converts_the_whole_codes_model_and_round_trips():
    v = _jax_variables()
    model = tacotron_model_factory(tiny_codes_hp())
    state = convert.from_flax(v)
    model.load_state_dict(state, strict=True)   # every entry, every shape
    assert state["decoder.attention_lstm.weight"].shape == (48, 40)
    assert state["encoder.cbhg.trunk.conv_bank.conv1d_K4.conv.weight"].shape \
        == (8, 8, 4)
    back = convert.to_flax(model.state_dict(), model)
    flat_a = dict(jax.tree_util.tree_flatten_with_path(v)[0])
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        np.testing.assert_array_equal(flat_a[k], flat_b[k])


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused_ref"])
def test_decode_matches_jax_scan_path(fused):
    _assert_close(_port_out(False, fused), _jax_out(False))


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused_ref"])
def test_early_stop_matches_jax_while_path(fused):
    ref = _jax_out(True, STOP_BIAS)
    assert int(ref.lengths[0]) < tiny_codes_hp().max_iters  # exited early
    got = _port_out(True, fused, STOP_BIAS)
    _assert_close(got, ref)
    n = int(ref.lengths[0])
    assert np.all(got.outputs.numpy()[:, n:] == 0)


def test_large_energy_vectors_stay_finite():
    """sum|v| >> the energies' row max: the JAX kernel's static shift
    would flush every exp to zero; the port shifts by the row max."""
    scale = 1e4
    v = _variables(v_scale=scale)["params"]["decoder"]
    bound = np.abs(v["attention_mechanism_0"]["attention_variable"]).sum()
    assert bound > 200.0   # exp(-bound) underflows in float32
    fused = _port_out(False, True, v_scale=scale)
    plain = _port_out(False, False, v_scale=scale)
    assert np.isfinite(fused.outputs.numpy()).all()
    _assert_close(fused, jax.tree_util.tree_map(
        lambda t: t.numpy() if isinstance(t, torch.Tensor) else t, plain))
    _assert_close(fused, _jax_out(False, 0.0, scale))


def test_fused_gate_falls_back_for_batch_two(caplog):
    """B = 2 used to be outside the ported kernel; since the batched row
    mode is ported, the gate lets it in (nothing logged) and the fused
    decode's plain version matches the plain path and, row by row, the
    JAX scan path."""
    from self_attention_tacotron_torch.models import decoder
    decoder._warned_fused_fallback.clear()
    with caplog.at_level("WARNING", logger=decoder.__name__):
        fused = _port_out(False, True, B=2)
    assert "using the plain path" not in caplog.text
    plain = _port_out(False, False, B=2)
    assert fused.outputs.shape[0] == 2
    for name in ("outputs", "stop_token"):
        np.testing.assert_allclose(getattr(fused, name).numpy(),
                                   getattr(plain, name).numpy(), rtol=TOL,
                                   atol=TOL)
    ref = _jax_out(False)
    for b in range(2):
        np.testing.assert_allclose(fused.outputs[b:b + 1].numpy(),
                                   ref.outputs, rtol=TOL, atol=TOL)
    assert all(bool((a == 0).all()) for a in fused.alignments)   # B > 1


def test_merged_weights_follow_parameter_updates():
    """The fused paths cache their merged weights; an in-place parameter
    update (as load_state_dict makes) must reach them."""
    hp = tiny_codes_hp(decoder_early_stop=False)
    fused = tacotron_model_factory(hp.replace(
        decoder_fused_inference=True, encoder_fused_inference=True)).eval()
    plain = tacotron_model_factory(hp).eval()
    batch = Batch(torch.arange(1, 8)[None], torch.tensor([7]))
    for model in (fused, plain):
        convert.init_parameters(model, seed=6)
    fused(batch)   # fills both caches
    with torch.no_grad():
        for model in (fused, plain):
            model.decoder.decoder_lstm2.bias.add_(0.3)
            model.encoder.cbhg.trunk.conv_bank.conv1d_K2.bn.running_mean \
                .add_(0.5)
    got, ref = fused(batch), plain(batch)
    np.testing.assert_allclose(got.outputs.numpy(), ref.outputs.numpy(),
                               rtol=TOL, atol=TOL)


def test_location_sensitive_takes_the_plain_path(caplog):
    """location_sensitive sources used to take the plain path; since the
    kernel's kind 1 is ported, the gate lets them in (nothing logged) and
    the fused decode's plain version matches the plain loop, with and
    without cumulative weights."""
    from self_attention_tacotron_torch.models import decoder
    decoder._warned_fused_fallback.clear()   # the reason is logged once
    for cumulative in (False, True):
        outs = []
        for fused in (False, True):
            hp = tiny_codes_hp(attention="location_sensitive",
                               cumulative_weights=cumulative,
                               decoder_fused_inference=fused)
            model = convert.init_parameters(tacotron_model_factory(hp),
                                            seed=4)
            with caplog.at_level("WARNING", logger=decoder.__name__):
                outs.append(model.eval()(Batch(torch.arange(1, 8)[None],
                                               torch.tensor([7]))))
        assert "using the plain path" not in caplog.text
        for a, b in ((outs[1].outputs, outs[0].outputs),
                     (outs[1].stop_token, outs[0].stop_token),
                     *zip(outs[1].alignments, outs[0].alignments)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL,
                                       atol=TOL)


def test_additive_only_fused_reference_matches_plain_loop():
    """Both sources additive (no location state)."""
    outs = []
    for fused in (False, True):
        hp = tiny_codes_hp(attention="additive", decoder_early_stop=False,
                           decoder_fused_inference=fused)
        model = convert.init_parameters(tacotron_model_factory(hp), seed=2)
        src = torch.from_numpy(np.arange(1, 8)[None])
        outs.append(model.eval()(Batch(src, torch.tensor([7]))))
    for a, b in zip(outs[0][:3], outs[1][:3]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL)
