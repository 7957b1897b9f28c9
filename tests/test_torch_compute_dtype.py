"""Model-wide bf16 (``compute_dtype=bfloat16``) in the port against the JAX
package on CPU.

The JAX reference rounds each op to bf16 as its program states it: it runs
op by op (the modules) or jitted with ``xla_allow_excess_precision`` off
(the models).  With that XLA option on (its default) a fusion may keep a
bf16 intermediate in float32, so the jitted reference's rounding points
would be XLA's choice and not the program's.  Inputs and weights come from
numpy seeds through the weight bridge (``utils/convert.py``); dropout is
off, zoneout off in TRAIN and by expectation elsewhere.

* Modules: each layer in bf16 (conv + batch norm in both modes, highway,
  the zoneout LSTM and GRU cells, the bi-LSTM, the self-attention full and
  causal, the three mechanisms, the prenet with a speaker) equals the JAX
  module's output bit for bit.
* Models, the codes kind (``SelfAttentionCBHGEncoder`` +
  ``DualSourceTransformerDecoder``), the mel kind (``ZoneoutEncoderV1`` +
  ``ExtendedDecoder`` + ``PostNetV2``) and the MGC/LF0 kind with accent
  types: TRAIN and VALIDATION teacher-forced, 4 INFERENCE steps with
  early stop off.  Every output within two bf16 ulps at its largest
  magnitude (``TOL_ULPS``: both sides round at the same points and the
  CPU's bf16 products sum in float32 on both; the headroom is for a
  library that sums in another order), the loss within 1e-5; and the port
  in bf16 at most a quarter as far from the JAX bf16 output as the port in
  float32 is, so a port that rounded elsewhere, or not at all, fails.
  Parameters, batch statistics and every gradient stay float32.
* The fused boundaries (batch-1 ``encoder_fused_inference`` and
  ``decoder_fused_inference``, ``decoder_fused_train``): the kernels'
  plain versions in float32 on the upcast operands against the JAX
  package's Pallas kernels in interpret mode, outputs cast back to bf16:
  within 2e-3 (relative L2; the kernels sum in another order in float32,
  which moves a value across a bf16 rounding boundary now and then), and
  the gates choose the fused path as in float32.
* Training: 12 Adam steps of the port in bf16 within 5 % of float32 from
  the same initialisation, both falling (the JAX package's
  tests/test_parallel.py test); the port's first 3 bf16 losses within
  1e-5 (relative) of the JAX package's ``make_train_step``: the forward is
  bit-equal and the float32 updates agree to float32 rounding.
* The cast copies: the bf16 copy of each weight that a module keeps
  without autograd (cast once a value, not once a use) gives the outputs
  of a fresh cast at every use, bit for bit, between Adam steps and after
  a ``load_state_dict``.
* The CLIs: ``cli.train`` for 2 steps and ``cli.predict`` for 1 utterance
  with ``--hparams compute_dtype=bfloat16`` write float32 records and
  ``.mfbsp`` files.
"""

import test_torch_threads  # noqa: F401  (bounds torch's threads)
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.models import DecoderMode
from self_attention_tacotron_tpu.models import attention as jmech
from self_attention_tacotron_tpu.models import compute_loss as jax_loss
from self_attention_tacotron_tpu.models import prenet as jprenet
from self_attention_tacotron_tpu.models import \
    tacotron_model_factory as jax_factory
from self_attention_tacotron_tpu.ops import attention_core as jattn
from self_attention_tacotron_tpu.ops import conv as jconv
from self_attention_tacotron_tpu.ops import rnn as jrnn
from self_attention_tacotron_torch.models import (compute_loss,
                                                  tacotron_model_factory)
from self_attention_tacotron_torch.models import attention as tmech
from self_attention_tacotron_torch.models import prenet as tprenet
from self_attention_tacotron_torch.ops import attention_core as tattn
from self_attention_tacotron_torch.ops import compute_dtype as tdtype
from self_attention_tacotron_torch.ops import conv as tconv
from self_attention_tacotron_torch.ops import rnn as trnn
from self_attention_tacotron_torch.ops.compute_dtype import (
    compute_dtype, set_compute_dtype)
from self_attention_tacotron_torch.utils import convert

from test_tacotron_model import tiny_hp
from test_torch_model_surface import ACCENT, DET, np_batch, to_port
from test_torch_ops import load, random_batch_stats, randn

BF = jnp.bfloat16
TOL_ULPS = 2
NO_EXCESS = {"xla_allow_excess_precision": False}
KINDS = {
    "codes": dict(),
    "mel": dict(tacotron_model="ExtendedTacotronV1Model",
                encoder="ZoneoutEncoderV1", decoder="ExtendedDecoder",
                use_zoneout_at_encoder=True, use_postnet_v2=True,
                num_postnet_v2_layers=2, postnet_v2_out_channels=8,
                postnet_v2_drop_rate=0.0),
    "mgclf0": dict(ACCENT,
                   tacotron_model="DualSourceSelfAttentionMgcLf0TacotronModel",
                   encoder="SelfAttentionCBHGEncoderWithAccentType",
                   decoder="DualSourceMgcLf0TransformerDecoder", num_mgcs=6,
                   num_lf0s=9),
}



def no_excess(fn, *args):
    """``fn(*args)`` as one XLA program, in place of a compile for each of
    its operations, with XLA's excess precision off: it then rounds where
    the op-by-op run does."""
    return jax.jit(fn).lower(*args).compile(compiler_options=NO_EXCESS)(
        *args)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def bf16_model(module: torch.nn.Module) -> torch.nn.Module:
    return set_compute_dtype(module, torch.bfloat16)


# ------------------------------------------------------------- modules

def _mech_steps(m, memory, lengths, queries):
    pack = m.precompute(memory, lengths)
    state = m.initial_state(memory.shape[0], memory.shape[1])
    outs = []
    for q in queries:
        align, state = m.step(q, state, pack)
        outs.append(align)
    return outs


def _module_case(name):
    """(JAX result in bf16, port result) of one layer on numpy inputs."""
    x = randn(0, 2, 9, 6)
    t = torch.from_numpy
    if name in ("conv_bn_eval", "conv_bn_train"):
        m = jconv.Conv1dBN(3, 5, jax.nn.relu, BF)
        v = random_batch_stats(m.init(jax.random.PRNGKey(0), x), 1)
        tm = bf16_model(load(tconv.Conv1dBN(6, 3, 5), v))
        if name == "conv_bn_eval":
            return m.apply(v, x), tm(t(x))
        ref, _ = m.apply(v, x, train=True, mutable=["batch_stats"])
        return ref, tm(t(x), True)
    if name == "highway":
        m = jconv.HighwayNet(6, BF)    # its residual: a bf16 input
        v = m.init(jax.random.PRNGKey(0), x)
        return (m.apply(v, jnp.asarray(x, BF)),
                bf16_model(load(tconv.HighwayNet(6, 6), v))(t(x).bfloat16()))
    if name in ("lstm_cell", "gru_cell"):
        xc, c, h = randn(1, 3, 5), randn(2, 3, 4), randn(3, 3, 4)
        if name == "gru_cell":
            m = jrnn.GRUCell(4, BF)
            v = m.init(jax.random.PRNGKey(0), jnp.asarray(h, BF), xc)
            ref, _ = m.apply(v, jnp.asarray(h, BF), xc)
            got, _ = bf16_model(load(trnn.GRUCell(5, 4), v))(
                t(h).bfloat16(), t(xc))
            return ref, got
        m = jrnn.ZoneoutLSTMCell(4, 0.1, 0.2, BF)
        v = m.init(jax.random.PRNGKey(0), (c, h), xc)
        (rc, rh), _ = m.apply(v, (jnp.asarray(c, BF), jnp.asarray(h, BF)),
                              xc)
        (gc, gh), _ = bf16_model(load(trnn.ZoneoutLSTMCell(5, 4, 0.1, 0.2),
                                      v))((t(c).bfloat16(), t(h).bfloat16()),
                                          t(xc))
        return jnp.concatenate([rc, rh], -1), torch.cat([gc, gh], -1)
    if name == "bilstm":
        xs, lengths = jnp.asarray(x), np.array([9, 6], np.int32)
        m = jrnn.BiZoneoutLSTM(4, 0.1, 0.1, BF)
        v = m.init(jax.random.PRNGKey(0), xs, jnp.asarray(lengths))
        tm = bf16_model(load(trnn.BiZoneoutLSTM(6, 4, 0.1, 0.1), v))
        return (m.apply(v, xs, jnp.asarray(lengths)),
                tm(t(x), t(lengths)))
    if name in ("self_attention", "self_attention_causal"):
        causal = name.endswith("causal")
        xm = randn(3, 2, 7, 8)
        m = jattn.SelfAttention(8, 2, 0.0, use_subsequent_mask=causal,
                                dtype=BF)
        v = m.init(jax.random.PRNGKey(0), xm)
        ref, ref_al = m.apply(v, xm)
        got, got_al = bf16_model(load(tattn.SelfAttention(8, 2, causal), v))(
            t(xm))
        return (jnp.concatenate([ref.reshape(-1), ref_al.reshape(-1)]),
                torch.cat([got.reshape(-1), got_al.reshape(-1)]))
    if name.startswith("mechanism_"):
        kind = name[len("mechanism_"):]
        memory, queries = randn(1, 2, 9, 6), randn(2, 5, 2, 5)
        lengths = np.array([9, 6], np.int32)
        opts = dict(attention=kind, num_units=7, attention_kernel=4,
                    attention_filters=3, cumulative_weights=True,
                    use_transition_agent=kind == "forward")
        m = jmech.attention_mechanism_factory(jmech.AttentionOptions(**opts),
                                              BF)
        v = m.init(jax.random.PRNGKey(3), memory, lengths, queries,
                   method=_mech_steps)
        ref = m.apply(v, jnp.asarray(memory, BF), lengths,
                      jnp.asarray(queries, BF), method=_mech_steps)
        tm = bf16_model(load(tmech.attention_mechanism_factory(
            tmech.AttentionOptions(**opts), 6, 5), v))
        got = _mech_steps(tm, t(memory).bfloat16(), t(lengths),
                          t(queries).bfloat16())
        return jnp.stack(ref), torch.stack(got)
    assert name == "speaker_prenet", name
    spk = randn(4, 2, 3)
    m = jprenet.PreNetStack((8, 4), 0.0, use_speaker_embed=True, dtype=BF)
    v = m.init(jax.random.PRNGKey(0), x, spk[:, None])
    tm = bf16_model(load(tprenet.PreNetStack(6, (8, 4), 0.0, 3), v))
    return (m.apply(v, x, jnp.asarray(spk, BF)[:, None]),
            tm(t(x), speaker_embed=t(spk).bfloat16()[:, None]))


@pytest.mark.parametrize("name", [
    "conv_bn_eval", "conv_bn_train", "highway", "lstm_cell", "gru_cell",
    "bilstm", "self_attention", "self_attention_causal",
    "mechanism_additive", "mechanism_location_sensitive",
    "mechanism_forward", "speaker_prenet"])
def test_modules_round_where_jax_does(name):
    """Op by op, the JAX modules round each op to bf16; the port's modules
    round at the same points, so the results are equal bit for bit."""
    ref, got = _module_case(name)
    assert got.dtype == torch.bfloat16 and jnp.asarray(ref).dtype == BF
    np.testing.assert_array_equal(f32(got), f32(ref))


# --------------------------------------------------------------- models

def model_hp(kind: str, dtype: str = "bfloat16", **kw):
    return tiny_hp(**dict(DET, **KINDS[kind], decoder_early_stop=False,
                          max_iters=4, compute_dtype=dtype, **kw))


def port_model(hp, variables) -> torch.nn.Module:
    model = tacotron_model_factory(hp)
    model.load_state_dict(convert.from_flax(variables), strict=True)
    return model


@functools.lru_cache(maxsize=None)
def jax_reference(kind: str):
    """(variables, batch, (INFERENCE, VALIDATION teacher-forced, TRAIN
    outputs, TRAIN loss)) of the JAX package's bf16 model, jitted with
    ``xla_allow_excess_precision`` off; the weights come from the port's
    seeded initialisation through the bridge."""
    hp = model_hp(kind)
    jb = np_batch(hp)
    seeded = convert.init_parameters(tacotron_model_factory(hp), 0)
    v = random_batch_stats(convert.to_flax(seeded.state_dict(), seeded), 3)
    model = jax_factory(hp)
    rngs = {"dropout": jax.random.PRNGKey(1),
            "zoneout": jax.random.PRNGKey(2)}

    def run(v, b):
        out, _ = model.apply(v, b, DecoderMode.TRAIN, True, rngs=rngs,
                             mutable=["batch_stats"])
        return (model.apply(v, b._replace(done=None), DecoderMode.INFERENCE),
                model.apply(v, b, DecoderMode.VALIDATION, True), out,
                jax_loss(hp, out, b, v["params"])["loss"])
    return v, jb, no_excess(run, v, jb)


def _fields(out):
    return {k: getattr(out, k) for k in ("outputs", "stop_token", "outputs2",
                                         "postnet_outputs")
            if getattr(out, k) is not None}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_model_bf16_matches_jax(kind):
    v, jb, (inf, val, train, loss) = jax_reference(kind)
    batch = to_port(jb)
    runs = {}
    for dtype in ("bfloat16", "float32"):
        model = port_model(model_hp(kind, dtype), v).eval()
        with torch.no_grad():
            decodes = (model(batch), model.validation_forward(batch, True))
        model.train()
        out = model.train_forward(batch)
        losses = compute_loss(model.hp, out, batch, model)
        losses["loss"].backward()
        runs[dtype] = (model, decodes + (out,), losses["loss"])
    model, outs, port_loss = runs["bfloat16"]
    assert model.dtype == torch.bfloat16
    refs = (inf, val, train)
    for mode, got, got32, ref in zip(("inference", "validation", "train"),
                                     outs, runs["float32"][1], refs):
        ref_fields, got_fields = _fields(ref), _fields(got)
        assert ref_fields.keys() == got_fields.keys(), mode
        for name, r in ref_fields.items():
            g, g32 = got_fields[name], _fields(got32)[name]
            assert g.dtype == torch.bfloat16, (mode, name)
            r = f32(r)
            scale = float(np.abs(r).max())
            d16 = float(np.abs(f32(g) - r).max())
            d32 = float(np.abs(f32(g32) - r).max())
            assert d16 <= TOL_ULPS * 2.0 ** -8 * scale, (mode, name, d16)
            assert d16 <= 0.25 * d32, (mode, name, d16, d32)
        np.testing.assert_array_equal(got.lengths.numpy(),
                                      np.asarray(ref.lengths))
    np.testing.assert_allclose(float(port_loss.detach()), float(loss),
                               rtol=1e-5)
    # float32 parameters, batch statistics and gradients; checkpoints keep
    # the float32 layout the converter reads
    assert {t.dtype for t in model.state_dict().values()
            if t.is_floating_point()} == {torch.float32}
    assert {p.grad.dtype for p in model.parameters()
            if p.grad is not None} == {torch.float32}
    assert any(p.grad is not None and bool(p.grad.any())
               for p in model.parameters())


# ---------------------------------------------------- fused boundaries

FUSED = dict(encoder_fused_inference=True, decoder_fused_inference=True,
             decoder_fused_train=True)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_fused_boundaries_bf16_match_jax(caplog):
    """Batch-1 INFERENCE through the fused encoder and decode and TRAIN
    through the fused trunk (their plain versions here; the JAX kernels in
    interpret mode), in bf16: outputs in bf16 within 2e-3
    (relative L2) of the JAX package's, the loss within 1e-4, every
    gradient float32, and no gate refusing the fused paths."""
    hp = model_hp("codes", **FUSED)
    jb = np_batch(hp, B=1)
    seeded = convert.init_parameters(tacotron_model_factory(hp), 0)
    v = random_batch_stats(convert.to_flax(seeded.state_dict(), seeded), 3)
    model = jax_factory(hp)

    def loss(params):
        out, _ = model.apply({"params": params,
                              "batch_stats": v["batch_stats"]}, jb,
                             DecoderMode.TRAIN, True,
                             rngs={"dropout": jax.random.PRNGKey(1),
                                   "zoneout": jax.random.PRNGKey(2)},
                             mutable=["batch_stats"])
        return jax_loss(hp, out, jb, params)["loss"], out
    def run(v, b):
        return (model.apply(v, b._replace(done=None),
                            DecoderMode.INFERENCE), loss(v["params"]))
    inf, (l_ref, train) = no_excess(run, v, jb)
    port = port_model(hp, v).eval()
    batch = to_port(jb)
    with caplog.at_level("WARNING"), torch.no_grad():
        got = port(batch)
    assert not [r for r in caplog.records if "fused kernel" in r.message]
    assert port.encoder._merged and port.decoder._merged
    port.train()
    out = port.train_forward(batch)
    losses = compute_loss(hp, out, batch, port)
    losses["loss"].backward()
    assert not [r for r in caplog.records if "fused kernel" in r.message]
    for g, r in ((got.outputs, inf.outputs), (got.stop_token, inf.stop_token),
                 (out.outputs, train.outputs)):
        assert g.dtype == torch.bfloat16 and r.dtype == BF
        assert _rel(f32(g), f32(r)) <= 2e-3
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(inf.lengths))
    np.testing.assert_allclose(float(losses["loss"].detach()), float(l_ref),
                               rtol=1e-4)
    assert {p.grad.dtype for p in port.parameters()
            if p.grad is not None} == {torch.float32}


# ------------------------------------------------------------- training

TRAJECTORY = dict(encoder_prenet_drop_rate=0.0, decoder_prenet_drop_rate=0.0,
                  self_attention_drop_rate=0.0,
                  decoder_self_attention_drop_rate=0.0,
                  zoneout_factor_cell=0.0, zoneout_factor_output=0.0,
                  batch_size=4, initial_learning_rate=2e-3)


def _port_losses(hp, init, batch, steps):
    from self_attention_tacotron_torch.parallel import (create_train_state,
                                                        make_train_step)
    model = tacotron_model_factory(hp)
    model.load_state_dict(init)
    state, step = create_train_state(model, hp), make_train_step(hp)
    return np.array([float(step(state, batch)["loss"])
                     for _ in range(steps)]), model


def test_bf16_training_tracks_f32_and_jax():
    """The JAX package's tests/test_parallel.py trajectory test on the
    port: 12 full train steps (clipping, Adam, noam) from one float32
    initialisation, every bf16 loss within 5 % of the float32 one and both
    runs falling; then the port's first 3 bf16 losses against the JAX
    package's ``make_train_step`` on the same weights and batch (jitted
    with ``xla_allow_excess_precision`` off) within 1e-5: the forward, the
    gradients' float32 sums and Adam agree to float32 rounding."""
    import optax  # noqa: F401  (the JAX optimizer's package)
    from self_attention_tacotron_tpu.parallel.train_step import (
        TrainState, make_optimizer)
    from self_attention_tacotron_tpu.parallel.train_step import \
        make_train_step as jax_make
    from test_tacotron_model import make_batch
    hp32 = tiny_hp(**TRAJECTORY)
    hp16 = tiny_hp(compute_dtype="bfloat16", **TRAJECTORY)
    jb = make_batch(hp32, B=4, T_in=9, T_out=8)
    batch = to_port(jb)
    init = convert.init_parameters(tacotron_model_factory(hp32),
                                   0).state_dict()
    l32, _ = _port_losses(hp32, init, batch, 12)
    l16, model = _port_losses(hp16, init, batch, 12)
    np.testing.assert_allclose(l16, l32, rtol=5e-2)
    assert l32[-1] < l32[0] and l16[-1] < l16[0]
    assert {p.dtype for p in model.parameters()} == {torch.float32}

    seeded = tacotron_model_factory(hp16)
    seeded.load_state_dict(init)
    v = convert.to_flax(seeded.state_dict(), seeded)
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"], constants={},
                       opt_state=make_optimizer(hp16).init(v["params"]))
    step = jax_make(jax_factory(hp16), hp16, donate=False).lower(
        state, jb, jax.random.PRNGKey(0)).compile(compiler_options=NO_EXCESS)
    ref = []
    for i in range(3):
        state, m = step(state, jb, jax.random.PRNGKey(i))
        ref.append(float(m["loss"]))
    np.testing.assert_allclose(l16[:3], ref, rtol=1e-5)


def _fresh_casts(monkeypatch):
    for module in (tdtype, trnn, tconv, tmech):
        monkeypatch.setattr(module, "cast", lambda owner, p, dt: p.to(dt))


def _steps_and_decodes(hp, init, batch, steps):
    """A teacher-forced decode without autograd before each of ``steps``
    train steps, and the losses."""
    from self_attention_tacotron_torch.parallel import (create_train_state,
                                                        make_train_step)
    model = tacotron_model_factory(hp)
    model.load_state_dict(init)
    state, step = create_train_state(model, hp), make_train_step(hp)
    seen = []
    for _ in range(steps):
        with torch.no_grad():
            seen.append(model.validation_forward(batch, True).outputs)
        seen.append(torch.tensor(float(step(state, batch)["loss"])))
    return seen, model


def test_cast_copies_equal_fresh_casts(monkeypatch):
    """The bf16 copies that ``cast`` keeps without autograd (one a weight
    value, not one a use) give the outputs of a fresh cast at every use,
    bit for bit, between Adam steps and after a ``load_state_dict``; the
    train steps' losses and updated parameters are those of fresh casts
    too (autograd casts at each use)."""
    from test_tacotron_model import make_batch
    hp = tiny_hp(compute_dtype="bfloat16", **TRAJECTORY)
    batch = to_port(make_batch(hp, B=4, T_in=9, T_out=8))
    init = convert.init_parameters(tacotron_model_factory(hp),
                                   0).state_dict()
    kept, model = _steps_and_decodes(hp, init, batch, 3)
    with monkeypatch.context() as m:
        _fresh_casts(m)
        fresh, fresh_model = _steps_and_decodes(hp, init, batch, 3)
    for a, b in zip(kept, fresh):
        assert torch.equal(a, b)
    for (name, a), b in zip(model.state_dict().items(),
                            fresh_model.state_dict().values()):
        assert torch.equal(a, b), name
    model.load_state_dict(init)
    fresh_model.load_state_dict(init)
    with torch.no_grad():
        got = model.validation_forward(batch, True)
        with monkeypatch.context() as m:
            _fresh_casts(m)
            ref = fresh_model.validation_forward(batch, True)
    assert torch.equal(got.outputs, ref.outputs)


# ---------------------------------------------------------------- CLIs

CLI_TINY = dict(num_symbols=30, embedding_dim=16, num_mels=10,
                cbhg_out_units=16, conv_channels=8, max_filter_width=4,
                projection1_out_channels=8, projection2_out_channels=8,
                encoder_prenet_out_units=[16, 8], self_attention_out_units=8,
                attention1_out_units=8, attention2_out_units=8,
                attention_out_units=12, decoder_prenet_out_units=[8, 4],
                decoder_out_units=16, decoder_self_attention_out_units=16,
                max_iters=12, decoder_min_iters=1, batch_size=2,
                approx_min_target_length=0, batch_bucket_width=16,
                save_checkpoints_steps=2, attention_kernel=4)

def test_cli_train_and_predict_in_bf16_write_float32(tmp_path, capsys):
    """``cli.train`` for 2 steps and ``cli.predict`` for one utterance with
    ``--hparams compute_dtype=bfloat16`` on the CPU: finite losses, a
    float32 checkpoint, and a float32 ``.mfbsp`` and prediction record."""
    import json
    from self_attention_tacotron_torch.cli.predict import main_code
    from self_attention_tacotron_torch.cli.train import main
    from self_attention_tacotron_torch.config import load_hparams
    from self_attention_tacotron_torch.data.records import read_first_example
    from test_torch_train_step import write_codes_corpus
    recipe = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "codes",
        "self-attention-tacotron.json")
    with open(recipe) as f:
        hp_json = dict(json.load(f), **CLI_TINY)
    (tmp_path / "hp.json").write_text(json.dumps(hp_json))
    hp = load_hparams(type("A", (), {"hparam_json_file": str(
        tmp_path / "hp.json"), "hparams": "compute_dtype=bfloat16"}))
    assert compute_dtype(hp.compute_dtype) == torch.bfloat16
    data, ckpt, out = (str(tmp_path / d) for d in ("data", "ckpt", "out"))
    os.makedirs(data)
    write_codes_corpus(hp, data, 4)
    common = ["--source-data-root", data, "--target-data-root", data,
              "--checkpoint-dir", ckpt, "--hparam-json-file",
              str(tmp_path / "hp.json"), "--device", "cpu", "--hparams",
              "compute_dtype=bfloat16"]
    assert main(common + ["--max-steps", "2"]) == 0
    text = capsys.readouterr().out
    losses = [float(line.split(" loss ")[1].split()[0])
              for line in text.splitlines() if " loss " in line]
    assert len(losses) == 2 and np.isfinite(losses).all()
    state = torch.load(os.path.join(ckpt, "model-2.pt"))
    assert {t.dtype for t in state.values()
            if t.is_floating_point()} == {torch.float32}
    assert main_code(common[:6] + ["--output-dir", out] + common[6:]
                     + ["--limit", "1"]) == 0
    dumps = [f for f in os.listdir(out) if f.endswith(".mfbsp")]
    records = [f for f in os.listdir(out) if f.endswith(".tfrecord")]
    assert len(dumps) == len(records) == 1
    codes = np.fromfile(os.path.join(out, dumps[0]), "<f4").reshape(
        -1, hp.num_mels)
    assert codes.shape[0] > 0 and set(codes.sum(-1)) == {1.0}
    ex = read_first_example(os.path.join(out, records[0]))
    payload = np.frombuffer(ex["codes"][1][0], np.float32)
    np.testing.assert_array_equal(payload, codes.ravel())
