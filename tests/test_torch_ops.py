"""The PyTorch port's primitives against the JAX package on CPU.

Inputs come from numpy seeds; the JAX modules are initialised, their
parameters carried over with ``utils/convert.py``, and both run on the same
inputs (tolerance 1e-5, float32).  Also: the weight bridge round trip and
the import guard (the port never imports JAX or the JAX package).
"""

import test_torch_threads  # noqa: F401  (bounds torch's threads)
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.models import attention as jmech
from self_attention_tacotron_tpu.ops import attention_core as jattn
from self_attention_tacotron_tpu.ops import conv as jconv
from self_attention_tacotron_tpu.ops import rnn as jrnn
from self_attention_tacotron_tpu.parallel.train_step import \
    create_train_state as jax_create_state
from self_attention_tacotron_torch.models import attention as tmech
from self_attention_tacotron_torch.ops import attention_core as tattn
from self_attention_tacotron_torch.ops import conv as tconv
from self_attention_tacotron_torch.ops import rnn as trnn
from self_attention_tacotron_torch.utils import convert

TOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def np_tree(variables):
    return jax.tree_util.tree_map(np.asarray, variables)


def load(module, variables):
    """Copy a JAX variable tree into a port module (strict)."""
    module.load_state_dict(convert.from_flax(np_tree(variables)), strict=True)
    return module.eval()


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def jit_init(module, rngs, *args, **kwargs):
    """``module.init(rngs, *args, **kwargs)`` as one jitted program, the
    arrays of ``args`` traced and ``kwargs`` static.  Flax's init runs the
    module's forward pass, and eagerly each of its operations compiles on
    its own: one compile of the whole costs less.  The variables are the
    eager init's, bit for bit (the initialisers' draws do not depend on the
    forward)."""
    return jax.jit(lambda r, *a: module.init(r, *a, **kwargs))(rngs, *args)


def jit_create_state(model, hp, batch, key):
    """The JAX package's ``create_train_state(model, hp, batch, key)``
    as one jitted program, as ``jit_init`` is: the eager state, bit for
    bit."""
    return jax.jit(lambda b, k: jax_create_state(model, hp, b, k))(
        batch, key)


def random_batch_stats(variables, seed):
    """Replace every BN running mean/var with non-trivial values."""
    rng = np.random.default_rng(seed)
    v = np_tree(variables)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda x: rng.uniform(0.5, 1.5, x.shape).astype(np.float32),
        v["batch_stats"])
    return v


def test_zoneout_lstm_cell_matches_jax():
    x, c, h = randn(0, 3, 5), randn(1, 3, 4), randn(2, 3, 4)
    cell = jrnn.ZoneoutLSTMCell(4, 0.1, 0.2)
    v = cell.init(jax.random.PRNGKey(0), (c, h), x)
    v = jax.tree_util.tree_map(lambda a: a + 0.1, v)  # non-zero bias
    (jc, jh), jy = cell.apply(v, (c, h), x, deterministic=True)
    tc = load(trnn.ZoneoutLSTMCell(5, 4, 0.1, 0.2), v)
    with torch.no_grad():
        (pc, ph), py = tc((torch.from_numpy(c), torch.from_numpy(h)),
                          torch.from_numpy(x))
    close(pc, jc)
    close(ph, jh)
    close(py, jy)


def test_bi_zoneout_lstm_short_lengths_matches_jax():
    xs = randn(3, 2, 9, 6)
    lengths = np.array([9, 5], np.int32)
    mod = jrnn.BiZoneoutLSTM(4, 0.1, 0.1)
    v = mod.init(jax.random.PRNGKey(1), jnp.asarray(xs), jnp.asarray(lengths))
    ref = mod.apply(v, jnp.asarray(xs), jnp.asarray(lengths),
                    deterministic=True)
    tm = load(trnn.BiZoneoutLSTM(6, 4, 0.1, 0.1), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(xs), torch.from_numpy(lengths))
    close(got, ref)
    assert np.all(got.numpy()[1, 5:] == 0)


def test_reverse_sequence_matches_jax():
    xs = randn(4, 2, 7, 3)
    lengths = np.array([7, 4], np.int32)
    close(trnn.reverse_sequence(torch.from_numpy(xs),
                                torch.from_numpy(lengths)),
          jrnn.reverse_sequence(xs, lengths), tol=0)


@pytest.mark.parametrize("K", [3, 4])
def test_conv1d_bn_same_padding_matches_jax(K):
    xs = randn(5, 2, 11, 6)
    mod = jconv.Conv1dBN(K, 5, jax.nn.relu)
    v = random_batch_stats(mod.init(jax.random.PRNGKey(2), xs, train=True),
                           K)
    ref = mod.apply(v, xs, train=False)
    tm = load(tconv.Conv1dBN(6, K, 5, torch.relu), v)
    with torch.no_grad():
        close(tm(torch.from_numpy(xs)), ref)


def test_conv_bank_even_width_matches_jax():
    xs = randn(6, 1, 13, 6)
    mod = jconv.ConvBank(4, 3)
    v = random_batch_stats(mod.init(jax.random.PRNGKey(3), xs, train=True),
                           7)
    ref = mod.apply(v, xs, train=False)
    tm = load(tconv.ConvBank(6, 4, 3), v)
    with torch.no_grad():
        close(tm(torch.from_numpy(xs)), ref)


def test_highway_matches_jax():
    xs = randn(7, 2, 5, 6)
    mod = jconv.HighwayNet(6)
    v = mod.init(jax.random.PRNGKey(4), xs)
    tm = load(tconv.HighwayNet(6, 6), v)
    with torch.no_grad():
        close(tm(torch.from_numpy(xs)), mod.apply(v, xs))


def test_mha_step_matches_jax():
    """Three KV-cache steps, and the full causal call."""
    D, H, S = 8, 2, 5
    xs = randn(8, 1, S, D)
    mod = jattn.MultiHeadAttention(D, H, use_subsequent_mask=True)
    v = mod.init(jax.random.PRNGKey(5), xs, xs, xs)
    tm = load(tattn.MultiHeadAttention(D, H, use_subsequent_mask=True), v)
    jcache = mod.apply(v, 1, S, method=mod.init_cache)
    tcache = tm.init_cache(1, S)
    with torch.no_grad():
        for t in range(3):
            jout, jcache, jrow = mod.apply(v, xs[:, t], t, jcache,
                                           method=mod.step)
            tout, tcache, trow = tm.step(torch.from_numpy(xs[:, t]), t,
                                         tcache)
            close(tout, jout)
            close(trow, jrow)
            close(tcache.key, jcache.key)
        jfull, jal = mod.apply(v, xs, xs, xs)
        tfull, tal = tm(*(torch.from_numpy(xs),) * 3)
    close(tfull, jfull)
    close(tal, jal)


@pytest.mark.parametrize("kind,cumulative", [
    ("additive", False), ("location_sensitive", False),
    ("location_sensitive", True), ("forward", False), ("forward", True)])
def test_attention_mechanism_steps_match_jax(kind, cumulative):
    """Three steps of each source-attention mechanism (even conv width 4,
    L < T so the mask matters)."""
    B, T, C, A = 2, 9, 6, 5
    memory, queries = randn(9, B, T, C), randn(10, 3, B, A)
    lengths = np.array([9, 6], np.int32)
    opts = dict(attention=kind, num_units=7, attention_kernel=4,
                attention_filters=3, cumulative_weights=cumulative)
    mod = jmech.attention_mechanism_factory(jmech.AttentionOptions(**opts))

    def run(m, memory, lengths, queries):
        pack = m.precompute(memory, lengths)
        state = m.initial_state(B, T)
        outs = []
        for q in queries:
            align, state = m.step(q, state, pack)
            outs.append(align)
        return outs

    v = mod.init(jax.random.PRNGKey(6), memory, lengths, queries, method=run)
    ref = mod.apply(v, memory, lengths, queries, method=run)
    tm = load(tmech.attention_mechanism_factory(
        tmech.AttentionOptions(**opts), C, A), v)
    with torch.no_grad():
        pack = tm.precompute(torch.from_numpy(memory),
                             torch.from_numpy(lengths))
        state = tm.initial_state(B, T)
        for q, r in zip(queries, ref):
            align, state = tm.step(torch.from_numpy(q), state, pack)
            close(align, r)


def test_positional_encoding_matches_jax():
    close(tattn.positional_encoding(9, 8), jattn.positional_encoding(9, 8))


def tiny_codes_hp(**kw):
    """tests/test_tacotron_model.py's tiny_hp on the codes recipe's
    mechanisms: forward + additive attention, an even location-conv width
    (asymmetric SAME pad), decoder v2 (zoneout in the decoder LSTMs)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_tacotron_model import tiny_hp
    return tiny_hp(**dict(dict(attention="forward", attention_kernel=4,
                               decoder_version="v2"), **kw))


def test_checkpoint_round_trip(tmp_path):
    from self_attention_tacotron_torch.models import tacotron_model_factory
    hp = tiny_codes_hp()
    a = convert.init_parameters(tacotron_model_factory(hp), seed=3)
    convert.save_checkpoint(a, str(tmp_path), step=7)
    b = tacotron_model_factory(hp)
    assert convert.load_checkpoint(b, str(tmp_path)) == 7
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert convert.load_checkpoint(b, str(tmp_path / "none")) is None


def test_port_imports_nothing_of_jax():
    """Every module of the package, the training ones included, and
    chip_smoke.py import with jax, flax, optax, orbax and the JAX package
    blocked."""
    code = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax",
             "self_attention_tacotron_tpu"):
    sys.modules[name] = None
import self_attention_tacotron_torch as pkg
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(info.name)
    print(info.name)
import chip_smoke
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    lines = res.stdout.split()
    assert res.returncode == 0 and lines[-1:] == ["ok"], res.stderr
    for mod in ("cli.train", "cli.predict", "parallel.train_step",
                "utils.checkpoint", "data.dataset", "ops.fused_train",
                "ops.losses", "ops.masks", "ops.fused_decode",
                "ops.fused_encoder", "ops.pallas_attention", "utils.metrics",
                "utils.tb_events", "ops.stft", "utils.audio", "models.postnet",
                "cli.preprocess", "data.preprocess.common",
                "data.preprocess.ljspeech", "data.preprocess.vctk",
                "data.preprocess.codes", "text.cleaners", "text.symbols",
                "text.numbers_norm", "text.phoneset", "text.flite",
                "cli.speaker_selection", "models.embedding",
                "models.prenet", "models.tacotron", "models.decoder",
                "ops.rnn", "ops.attention_core",
                "models.encoders", "models.attention", "utils.convert",
                "data.native_reader", "data.tfrecord", "ops.collectives",
                "parallel.mesh", "parallel.multihost", "entry"):
        assert f"self_attention_tacotron_torch.{mod}" in lines, mod
