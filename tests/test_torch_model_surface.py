"""The rest of the JAX package's model surface in the port, against the JAX
package on CPU.

Modules, with the same weights carried across by ``utils/convert.py``
(float32, 1e-5):

* ``ForwardAttention`` with the transition agent (``transition_factor_
  projection``), 5 steps; location-sensitive ``smoothing``;
* ``EncoderV2``, ``EncoderV1WithAccentType`` (bi-GRU and zoneout CBHG),
  ``SelfAttentionCBHGEncoderWithAccentType``; ``PostNetCBHG``.

Models (``check_model_matches_jax``): TRAIN deterministic (dropout and
zoneout off) and teacher-forced: the loss (rtol 1e-5), the outputs and
every gradient by flax path (rtol 2e-3, atol 2e-5, as
tests/test_torch_train_step.py); VALIDATION teacher-forced and
free-running and INFERENCE: outputs and stop logits within 2e-4,
alignments within 1e-5, equal lengths.  Here ``TransformerDecoder`` (one
source and a causal hop, the self-attention encoder's own output computed
and not attended to) and a transition-agent model; the MGC/LF0 models in
tests/test_torch_mgclf0.py.

Inference dropout (``apply_dropout_on_inference``): at drop rate 0 the
port equals the JAX package's INFERENCE; one generator seed gives one
output and two seeds differ; the fused gate logs its reason.  The JAX
package's own ``make_predict_step`` fails with that hparam (no dropout
key): a reference fault the port does not copy.  ``compute_dtype``:
``bfloat16`` builds and runs in bf16 on float32 parameters (its parity:
tests/test_torch_compute_dtype.py), ``float16`` builds and runs f32 as
there.
"""

import test_torch_threads  # noqa: F401  (bounds torch's threads)
import functools
import logging

import flax
import jax
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.models import DecoderMode
from self_attention_tacotron_tpu.models import attention as jmech
from self_attention_tacotron_tpu.models import encoders as jenc
from self_attention_tacotron_tpu.models import postnet as jpost
from self_attention_tacotron_tpu.models import \
    tacotron_model_factory as jax_factory
from self_attention_tacotron_tpu.models.tacotron import Batch as JaxBatch
from self_attention_tacotron_tpu.models.tacotron import \
    compute_loss as jax_loss
from self_attention_tacotron_torch.models import (Batch, compute_loss,
                                                  tacotron_model_factory)
from self_attention_tacotron_torch.models import attention as tmech
from self_attention_tacotron_torch.models import encoders as tenc
from self_attention_tacotron_torch.models import postnet as tpost
from self_attention_tacotron_torch.utils import convert

from test_tacotron_model import tiny_hp
from test_torch_ops import close, jit_init, load, random_batch_stats, randn

TOL_OUT = 2e-4
TOL_ALIGN = 1e-5
DET = dict(encoder_prenet_drop_rate=0.0, decoder_prenet_drop_rate=0.0,
           self_attention_drop_rate=0.0, decoder_self_attention_drop_rate=0.0,
           encoder_v2_drop_rate=0.0, zoneout_factor_cell=0.0,
           zoneout_factor_output=0.0, attention="forward",
           attention_kernel=4, decoder_version="v2")
# accent widths whose concatenation (6 + 2) is the CBHG's residual width
ACCENT = dict(use_accent_type=True, encoder_prenet_out_units_if_accent=(8, 6),
              accent_type_prenet_out_units=(4, 2),
              accent_type_embedding_dim=4, num_accent_type=9)


# ------------------------------------------------------------- modules

def _steps(m, memory, lengths, queries):
    pack = m.precompute(memory, lengths)
    state = m.initial_state(memory.shape[0], memory.shape[1])
    outs = []
    for q in queries:
        align, state = m.step(q, state, pack)
        outs.append((align, state[-1]))
    return outs


@pytest.mark.parametrize("kind,extra", [
    ("forward", dict(use_transition_agent=True, cumulative_weights=True)),
    ("forward", dict(use_transition_agent=True)),
    ("location_sensitive", dict(smoothing=True)),
    ("location_sensitive", dict(smoothing=True, cumulative_weights=True))],
    ids=["transition_cumulative", "transition", "smoothing",
         "smoothing_cumulative"])
def test_attention_options_match_jax(kind, extra):
    """Five steps (L < T, so the mask matters); the transition agent's u
    (the state's last entry) too."""
    B, T, C, A = 2, 9, 6, 5
    memory, queries = randn(1, B, T, C), randn(2, 5, B, A)
    lengths = np.array([9, 6], np.int32)
    opts = dict(attention=kind, num_units=7, attention_kernel=4,
                attention_filters=3, **extra)
    mod = jmech.attention_mechanism_factory(jmech.AttentionOptions(**opts))
    v = mod.init(jax.random.PRNGKey(3), memory, lengths, queries,
                 method=_steps)
    ref = mod.apply(v, memory, lengths, queries, method=_steps)
    tm = load(tmech.attention_mechanism_factory(
        tmech.AttentionOptions(**opts), C, A), v)
    if extra.get("use_transition_agent"):
        assert any("transition_factor_projection" in k
                   for k in tm.state_dict())
    with torch.no_grad():
        got = _steps(tm, torch.from_numpy(memory), torch.from_numpy(lengths),
                     torch.from_numpy(queries))
    moved = False
    for (a, last), (ra, rlast) in zip(got, ref):
        close(a, ra)
        close(last, rlast)
        moved |= bool(np.abs(np.asarray(rlast) - 0.5).max() > 1e-3) \
            if kind == "forward" else True
    assert moved   # the agent's u left 0.5


def _encoder_case(name):
    """(JAX module, its call's extra inputs, port module)."""
    E, A = 8, 4
    trunk = dict(cbhg_out_units=16, conv_channels=4, max_filter_width=3,
                 projection1_out_channels=8, projection2_out_channels=8,
                 num_highway=2)
    accent = dict(prenet_out_units=(10, 6), accent_type_prenet_out_units=(
        4, 2), drop_rate=0.0)
    if name == "EncoderV2":
        return (jenc.EncoderV2(num_conv_layers=2, kernel_size=5,
                               out_units=10, drop_rate=0.0), False,
                tenc.EncoderV2(E, 2, 5, 10, 0.0))
    if name.startswith("EncoderV1WithAccentType"):
        zoneout = name.endswith("zoneout")
        return (jenc.EncoderV1WithAccentType(use_zoneout=zoneout, **trunk,
                                             **accent), True,
                tenc.EncoderV1WithAccentType(E, A, use_zoneout=zoneout,
                                             **trunk, **accent))
    sa = dict(self_attention_out_units=8, self_attention_num_heads=2,
              self_attention_num_hop=2, self_attention_drop_rate=0.0)
    return (jenc.SelfAttentionCBHGEncoderWithAccentType(**trunk, **accent,
                                                        **sa), True,
            tenc.SelfAttentionCBHGEncoderWithAccentType(E, A, **trunk,
                                                        **accent, **sa))


@pytest.mark.parametrize("name", [
    "EncoderV2", "EncoderV1WithAccentType", "EncoderV1WithAccentType_zoneout",
    "SelfAttentionCBHGEncoderWithAccentType"])
def test_encoders_match_jax(name):
    """Inference (batch norm on random running statistics) with a masked
    row; every output and alignment within 1e-5."""
    jm, with_accent, tm = _encoder_case(name)
    xs, acc = randn(4, 2, 7, 8), randn(5, 2, 7, 4)
    lengths = np.array([7, 5], np.int32)
    args = (xs, acc) if with_accent else (xs,)
    v = random_batch_stats(jit_init(jm, jax.random.PRNGKey(0), *args,
                                    lengths), 6)
    ref = jm.apply(v, *args, lengths)
    tm = load(tm, v)
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, args), torch.from_numpy(lengths))
    if isinstance(ref, tuple):
        close(got[0], ref[0])
        close(got[1], ref[1])
        assert len(got[2]) == len(ref[2]) == 4
        for a, b in zip(got[2], ref[2]):
            close(a, b)
    else:
        close(got, ref)


def test_postnet_cbhg_matches_jax():
    jm = jpost.PostNetCBHG(out_dim=11, cbhg_out_units=12, conv_channels=4,
                           max_filter_width=3, projection1_out_channels=8,
                           projection2_out_channels=6, num_highway=2)
    xs, lengths = randn(7, 2, 9, 6), np.array([9, 4], np.int32)
    v = random_batch_stats(jit_init(jm, jax.random.PRNGKey(1), xs, lengths),
                           8)
    tm = load(tpost.PostNetCBHG(6, 11, 12, 4, 3, 8, 6, 2), v)
    assert {k.split(".")[0] for k in tm.state_dict()} == {
        "cbhg", "linear_projection"}
    with torch.no_grad():
        got = tm(torch.from_numpy(xs), torch.from_numpy(lengths))
    close(got, jm.apply(v, xs, lengths))


# -------------------------------------------------------------- models

def np_batch(hp, B=2, T_in=7, T_out=6, seed=0):
    """A JAX batch from numpy: one-hot codes, or (mgc, one-hot lf0) for
    the MGC/LF0 model; accent ids in the embedding's range; row 1 shorter."""
    rng = np.random.default_rng(seed)
    steps = T_out // hp.outputs_per_step
    if hp.tacotron_model == "DualSourceSelfAttentionMgcLf0TacotronModel":
        target = (rng.standard_normal((B, T_out, hp.num_mgcs)).astype(
            np.float32), np.eye(hp.num_lf0s, dtype=np.float32)[
                rng.integers(0, hp.num_lf0s, (B, T_out))])
    else:
        target = np.eye(hp.num_mels, dtype=np.float32)[
            rng.integers(0, hp.num_mels, (B, T_out))]
    done = np.zeros((B, steps), np.float32)
    done[:, -1] = 1.0
    return JaxBatch(
        source=rng.integers(1, hp.num_symbols, (B, T_in)).astype(np.int32),
        source_length=np.array([T_in, T_in - 2][:B], np.int32),
        target=target, target_length=np.full((B,), T_out, np.int32),
        done=done, spec_loss_mask=np.ones((B, T_out), np.float32),
        binary_loss_mask=np.ones((B, steps), np.float32),
        speaker_id=np.zeros((B,), np.int32),
        accent_type=(hp.accent_type_offset + rng.integers(
            0, hp.num_accent_type, (B, T_in))).astype(np.int32))


def to_port(jb) -> Batch:
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    target = (tuple(map(t, jb.target)) if isinstance(jb.target, tuple)
              else t(jb.target))
    return Batch(source=t(jb.source), source_length=t(jb.source_length),
                 target=target, target_length=t(jb.target_length),
                 done=t(jb.done), spec_loss_mask=t(jb.spec_loss_mask),
                 binary_loss_mask=t(jb.binary_loss_mask),
                 speaker_id=t(jb.speaker_id), accent_type=t(jb.accent_type))


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def jax_reference(hp):
    """(variables, batch, (INFERENCE, VALIDATION free, VALIDATION teacher),
    (TRAIN loss, outputs, outputs2, gradients))."""
    model, jb = jax_factory(hp), np_batch(hp)
    v = random_batch_stats(jit_init(model, {"params": jax.random.PRNGKey(0)},
                                    jb, mode=DecoderMode.VALIDATION,
                                    teacher_forcing=True), 3)
    rngs = {"dropout": jax.random.PRNGKey(1),
            "zoneout": jax.random.PRNGKey(2)}

    @jax.jit
    def run(v, b):
        def loss(params):
            out, _ = model.apply({"params": params,
                                  "batch_stats": v["batch_stats"]}, b,
                                 DecoderMode.TRAIN, True, rngs=rngs,
                                 mutable=["batch_stats"])
            return jax_loss(hp, out, b, params)["loss"], out
        (l, out), g = jax.value_and_grad(loss, has_aux=True)(v["params"])
        decodes = (model.apply(v, b._replace(done=None),
                               DecoderMode.INFERENCE),
                   model.apply(v, b, DecoderMode.VALIDATION, False),
                   model.apply(v, b, DecoderMode.VALIDATION, True))
        return decodes, (l, out.outputs, out.outputs2, g)
    decodes, train = jax.tree_util.tree_map(np.asarray, run(v, jb))
    return v, jb, decodes, train


def _check_decode(got, ref, name):
    for field, tol in (("outputs", TOL_OUT), ("outputs2", TOL_OUT),
                       ("stop_token", TOL_OUT)):
        a, b = getattr(got, field), getattr(ref, field)
        assert (a is None) == (b is None), (name, field)
        if a is not None:
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=tol,
                                       err_msg=f"{name} {field}")
    assert len(got.alignments) == len(ref.alignments)
    for a, b in zip(got.alignments, ref.alignments):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=TOL_ALIGN,
                                   err_msg=f"{name} alignments")
    np.testing.assert_array_equal(got.lengths.numpy(), ref.lengths)


def assert_round_trip(model, v):
    """``v`` into ``model`` by ``from_flax`` and back by ``to_flax``: the
    same leaves, bit for bit."""
    model.load_state_dict(convert.from_flax(v), strict=True)
    back = convert.to_flax(model.state_dict(), model)
    for coll in ("params", "batch_stats"):
        a, b = _flat(back[coll]), _flat(v[coll])
        assert a.keys() == b.keys()
        for name in b:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def check_model_matches_jax(hp, reference=None):
    """The port's model against the JAX package's in every mode
    (``reference``: ``jax_reference(hp)`` when the caller has it)."""
    v, jb, decodes, (l_ref, out_ref, out2_ref, g_ref) = (
        reference or jax_reference(hp))
    model = tacotron_model_factory(hp)
    assert_round_trip(model, v)
    model.eval()
    batch = to_port(jb)
    for got, ref, name in zip(
            (model(batch), model.validation_forward(batch, False),
             model.validation_forward(batch, True)), decodes,
            ("inference", "validation_free", "validation_teacher")):
        _check_decode(got, ref, name)
    model.train()
    out = model.train_forward(batch)
    losses = compute_loss(hp, out, batch, model)
    losses["loss"].backward()
    np.testing.assert_allclose(float(losses["loss"].detach()), l_ref,
                               rtol=1e-5)
    np.testing.assert_allclose(out.outputs.detach().numpy(), out_ref,
                               rtol=TOL_OUT, atol=2e-5)
    if out2_ref is not None:
        np.testing.assert_allclose(out.outputs2.detach().numpy(), out2_ref,
                                   rtol=TOL_OUT, atol=2e-5)
    # a parameter off the loss's path (TransformerDecoder: the encoder's
    # self-attention branch) has no gradient here and a zero one there
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
             for k, p in model.named_parameters()}
    got, ref = _flat(convert.to_flax(grads, model)["params"]), _flat(g_ref)
    assert got.keys() == ref.keys()
    unused = {name for name in ref if not np.any(ref[name])}
    assert unused == {name for name in got if not np.any(got[name])}
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], rtol=2e-3,
                                   atol=2e-5, err_msg=name)
    return model, losses


@pytest.mark.parametrize("kw,leaves", [
    (dict(encoder="EncoderV2", decoder="ExtendedDecoder",
          encoder_v2_num_conv_layers=2, encoder_v2_out_units=10),
     ("'conv_1'", "'bilstm'")),
    (dict(ACCENT, encoder="EncoderV1WithAccentType",
          decoder="ExtendedDecoder"),
     ("'accent_embedding'", "'prenets'", "'accent_type_prenets'"))],
    ids=["encoder_v2", "encoder_v1_accent"])
def test_weight_bridge_round_trips_the_new_leaves(kw, leaves):
    """The two encoders no model parity test builds: ``from_flax`` /
    ``to_flax`` carry every leaf both ways unchanged, under its flax name
    (the other new leaves: ``check_model_matches_jax``); ``init_parameters``
    draws each one from its seed, the same on every build."""
    hp = tiny_hp(**kw)
    model = jax_factory(hp)
    v = random_batch_stats(jax.jit(lambda key, b: model.init(
        {"params": key}, b, DecoderMode.VALIDATION, True))(
            jax.random.PRNGKey(0), np_batch(hp)), 3)
    assert_round_trip(tacotron_model_factory(hp), v)
    names = "/".join(_flat(v["params"]))
    for leaf in leaves:
        assert leaf in names, leaf
    a = convert.init_parameters(tacotron_model_factory(hp), 5).state_dict()
    b = convert.init_parameters(tacotron_model_factory(hp), 5).state_dict()
    assert all(torch.equal(a[k], b[k]) and bool(a[k].isfinite().all())
               for k in a)


@pytest.mark.parametrize("kw", [
    dict(decoder="TransformerDecoder"),
    dict(use_forward_attention_transition_agent=True, attention2="forward",
         decoder_fused_inference=True, decoder_fused_train=True)],
    ids=["transformer_decoder", "transition_agent"])
def test_model_matches_jax(kw):
    model, _ = check_model_matches_jax(tiny_hp(**dict(DET, **kw)))
    if kw.get("decoder") == "TransformerDecoder":
        dec = model.decoder
        assert dec.num_sources == 1 and len(dec.transformers) == 1
        # one source of cbhg_out_units, the hop at the decoder's width
        assert dec.attention_lstm.weight.shape[1] == (
            4 + 16 + 12)


def test_transformer_decoder_fused_inputs_take_one_source():
    """The fused decode's and the fused trunk's inputs for one source and
    a hop (their plain versions run here): the same outputs as the plain
    paths."""
    hp = tiny_hp(**dict(DET, decoder="TransformerDecoder",
                        decoder_fused_inference=True,
                        decoder_fused_train=True, decoder_early_stop=False))
    model = convert.init_parameters(tacotron_model_factory(hp), 2).eval()
    plain = convert.init_parameters(tacotron_model_factory(hp.replace(
        decoder_fused_inference=False, decoder_fused_train=False)), 2).eval()
    batch = to_port(np_batch(hp))
    fused, ref = model(batch), plain(batch)
    np.testing.assert_allclose(fused.outputs.numpy(), ref.outputs.numpy(),
                               atol=1e-5)
    weights, memory, _ = model.decoder.fused_inputs(
        model.decoder._packs(model._encode(batch)[0], (batch.source_length,)))
    assert len(memory.keys) == 1 and len(weights.hops) == 1
    model.train(), plain.train()
    a = model.train_forward(batch)
    b = plain.train_forward(batch)
    np.testing.assert_allclose(a.outputs.detach().numpy(),
                               b.outputs.detach().numpy(), atol=1e-5)


# --------------------------------------------------- inference dropout

@functools.lru_cache(maxsize=None)
def _dropout_case():
    hp = tiny_hp(**dict(DET, apply_dropout_on_inference=True,
                        decoder_early_stop=True))
    model = jax_factory(hp)
    jb = np_batch(hp)
    v = random_batch_stats(jit_init(model, {"params": jax.random.PRNGKey(0)},
                                    jb, mode=DecoderMode.VALIDATION,
                                    teacher_forcing=True), 3)
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda v, b: model.apply(v, b, DecoderMode.INFERENCE,
                                 rngs={"dropout": jax.random.PRNGKey(5)}))(
            v, jb._replace(done=None)))
    return hp, v, jb, ref


def test_inference_dropout_at_rate_zero_matches_jax():
    hp, v, jb, ref = _dropout_case()
    model = tacotron_model_factory(hp)
    model.load_state_dict(convert.from_flax(v), strict=True)
    gen = torch.Generator().manual_seed(0)
    _check_decode(model.eval()(to_port(jb), generator=gen), ref, "inference")


def test_inference_dropout_follows_the_generator(caplog):
    hp = tiny_hp(apply_dropout_on_inference=True, decoder_prenet_drop_rate=0.5,
                 decoder_fused_inference=True, decoder_early_stop=True)
    model = convert.init_parameters(tacotron_model_factory(hp), 1).eval()
    batch = to_port(np_batch(hp))

    def run(seed):
        return model(batch, generator=torch.Generator().manual_seed(seed))
    with caplog.at_level(logging.WARNING):
        a, b, c = run(7), run(7), run(8)
    assert torch.equal(a.outputs, b.outputs)
    assert float((a.outputs - c.outputs).abs().max()) > 1e-3
    assert "inference-time prenet dropout is not fused" in caplog.text
    # the scan path ran every step (no early exit), lengths post hoc
    assert a.outputs.shape[1] == hp.max_iters * hp.outputs_per_step
    # VALIDATION draws from it too; the encoder prenets never drop out
    v1 = model.validation_forward(batch, True,
                                  generator=torch.Generator().manual_seed(3))
    v2 = model.validation_forward(batch, True,
                                  generator=torch.Generator().manual_seed(4))
    assert not torch.equal(v1.outputs, v2.outputs)
    assert not model.encoder.prenets.prenet_0.apply_dropout_on_inference


def test_predict_step_seeds_inference_dropout_from_hp_seed():
    from self_attention_tacotron_torch.parallel import make_predict_step
    hp = tiny_hp(apply_dropout_on_inference=True, decoder_prenet_drop_rate=0.5)
    model = convert.init_parameters(tacotron_model_factory(hp), 1).eval()
    batch = to_port(np_batch(hp))
    a = make_predict_step(hp)(model, batch)[-1]
    b = make_predict_step(hp)(model, batch)[-1]
    c = make_predict_step(hp.replace(seed=hp.seed + 1))(model, batch)[-1]
    assert torch.equal(a.outputs, b.outputs)
    assert not torch.equal(a.outputs, c.outputs)


def test_jax_make_predict_step_fails_with_inference_dropout():
    """The reference fault the port does not copy: the JAX package's
    ``make_predict_step`` (and so its ``cli.predict``) passes no dropout
    key to a model with ``apply_dropout_on_inference``."""
    from self_attention_tacotron_tpu.parallel.train_step import (
        TrainState, make_predict_step)
    hp, v, jb, _ = _dropout_case()
    hp = hp.replace(decoder_prenet_drop_rate=0.5)  # at 0 flax draws nothing
    state = TrainState(step=0, params=v["params"],
                       batch_stats=v["batch_stats"], constants={},
                       opt_state=None)
    with pytest.raises(flax.errors.InvalidRngError):
        make_predict_step(jax_factory(hp), hp)(state, jb._replace(done=None))


def test_compute_dtype_refuses_bfloat16_only():
    """Nothing is refused any more: ``bfloat16`` computes in bf16 from
    float32 parameters; any other string, ``float16`` too, runs f32."""
    for name, dtype in (("bfloat16", torch.bfloat16),
                        ("float16", torch.float32)):
        model = tacotron_model_factory(tiny_hp(compute_dtype=name))
        out = convert.init_parameters(model, 0).eval()(to_port(np_batch(
            model.hp)))
        assert out.outputs.dtype == dtype
        assert {p.dtype for p in model.parameters()} == {torch.float32}
