"""The port's training ops against the JAX package on CPU.

* losses (codes / spec L1 and MSE, binary, classification, L2 over flax
  paths with the default blacklist), global-norm clipping and the noam
  schedule against ``ops/losses.py`` (tolerance 1e-6 relative: the same
  float32 sums in another order);
* training batch norm (batch statistics with the biased variance, running
  update at momentum 0.99, ``bn_valid_rows``) against flax
  ``Conv1dBN(train=True)`` with mutable ``batch_stats`` (1e-5);
* the statistics of training zoneout, prenet dropout and attention dropout
  (their draws come from ``torch.Generator``s, so only rates and scales
  can be compared), and of the counter-based mask generator that the
  training kernels share with their plain versions: the same bits every
  call, the bits of an independent numpy uint32 version of the hash, and
  a keep rate within 1 % of 1 - rate at 10^5 draws;
* the location-window helpers of the training trunk at K = 4 and 5 (the
  even K pads 1 left, 2 right), their adjoint identity included.
"""

import test_torch_threads  # noqa: F401  (bounds torch's threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.ops import conv as jconv
from self_attention_tacotron_tpu.ops import losses as jl
from self_attention_tacotron_torch.models.prenet import PreNet
from self_attention_tacotron_torch.ops import attention_core as tattn
from self_attention_tacotron_torch.ops import conv as tconv
from self_attention_tacotron_torch.ops import fused_train as ft
from self_attention_tacotron_torch.ops import losses as tl
from self_attention_tacotron_torch.ops import masks as tm
from self_attention_tacotron_torch.ops import rnn as trnn
from self_attention_tacotron_torch.utils import convert

from test_torch_ops import load, np_tree, randn, random_batch_stats


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("loss_type", ["l1", "mse"])
def test_spec_binary_and_classification_losses_match_jax(loss_type):
    out, tgt = randn(0, 3, 6, 5), randn(1, 3, 6, 5)
    mask = (np.arange(6)[None] < np.array([6, 4, 1])[:, None]).astype(
        np.float32)
    stop, done = randn(2, 3, 6, 1), (randn(3, 3, 6) > 0).astype(np.float32)
    onehot = np.eye(5, dtype=np.float32)[np.arange(18).reshape(3, 6) % 5]
    pairs = [
        (tl.codes_loss(_t(out), _t(tgt), _t(mask), loss_type),
         jl.codes_loss(out, tgt, mask, loss_type)),
        (tl.binary_loss(_t(stop), _t(done), _t(mask)),
         jl.binary_loss(stop, done, mask)),
        (tl.classification_loss(_t(out), _t(onehot), _t(mask)),
         jl.classification_loss(out, onehot, mask)),
    ]
    for got, ref in pairs:
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_l2_regularization_over_flax_paths_matches_jax():
    from test_torch_ops import tiny_codes_hp
    from self_attention_tacotron_torch.models import tacotron_model_factory
    model = convert.init_parameters(tacotron_model_factory(tiny_codes_hp()),
                                    seed=4)
    params = convert.to_flax(model.state_dict(), model)["params"]
    ref = jl.l2_regularization_loss(params, 1e-3, jl.DEFAULT_L2_BLACKLIST)
    got = tl.l2_regularization_loss(convert.flax_param_paths(model), 1e-3,
                                    tl.DEFAULT_L2_BLACKLIST)
    assert tl.DEFAULT_L2_BLACKLIST == jl.DEFAULT_L2_BLACKLIST
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-6)
    # the blacklist drops something and keeps something
    paths = [p for p, _ in convert.flax_param_paths(model)]
    assert any("lstm_cell" in p or "bias" in p for p in paths)
    assert float(got.detach()) > 0


@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["below", "above"])
def test_global_norm_clip_matches_jax(scale):
    grads = [randn(i, *s) * scale for i, s in enumerate([(4, 3), (5,), (2, 2)])]
    ref, ref_norm = jl.global_norm_clip(grads, 1.0)
    got = [_t(g.copy()) for g in grads]
    norm = tl.global_norm_clip(got, 1.0)
    np.testing.assert_allclose(float(norm), float(ref_norm), rtol=1e-6)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-9)


@pytest.mark.parametrize("step", [0, 1, 3999, 4000, 123456])
def test_noam_learning_rate_matches_jax(step):
    np.testing.assert_allclose(tl.noam_learning_rate(0.002, step, 1),
                               float(jl.noam_learning_rate(0.002, step, 1)),
                               rtol=1e-6)


@pytest.mark.parametrize("valid", [None, (True, True, False)],
                         ids=["all_rows", "valid_rows"])
def test_conv1d_bn_training_statistics_match_flax(valid):
    xs = randn(5, 3, 9, 6)
    if valid is not None:      # a padded duplicate of the last real row
        xs[2] = xs[1]
    mod = jconv.Conv1dBN(4, 5, jax.nn.relu)
    v = random_batch_stats(mod.init(jax.random.PRNGKey(0), jnp.asarray(xs)),
                           7)
    mask = None if valid is None else jnp.asarray(valid)
    with jconv.bn_valid_rows(mask):
        ref, mut = mod.apply(v, jnp.asarray(xs), train=True,
                             mutable=["batch_stats"])
    port = load(tconv.Conv1dBN(6, 4, 5, torch.relu), v)
    with tconv.bn_valid_rows(None if valid is None else torch.tensor(valid)):
        got = port(_t(xs), train=True)
    rows = slice(None) if valid is None else slice(0, 2)
    np.testing.assert_allclose(got.detach().numpy()[rows],
                               np.asarray(ref)[rows], rtol=1e-5, atol=1e-5)
    stats = np_tree(mut["batch_stats"])["bn"]
    np.testing.assert_allclose(port.bn.running_mean.numpy(), stats["mean"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port.bn.running_var.numpy(), stats["var"],
                               rtol=1e-5, atol=1e-6)
    if valid is not None:      # the duplicate moved nothing
        with tconv.bn_valid_rows(None):
            fresh = load(tconv.Conv1dBN(6, 4, 5, torch.relu), v)
            fresh(_t(xs[:2]), train=True)
        np.testing.assert_allclose(port.bn.running_mean.numpy(),
                                   fresh.bn.running_mean.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_training_zoneout_keeps_new_values_at_one_minus_rate():
    cell = trnn.ZoneoutLSTMCell(3, 200, 0.1, 0.3)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        cell.weight.copy_(0.1 * torch.rand(cell.weight.shape, generator=gen)
                          - 0.05)
    c, h = torch.zeros(500, 200), torch.full((500, 200), 0.7)
    x = torch.randn(500, 3, generator=gen)
    with torch.no_grad():
        (new_c, new_h), _ = cell((c - 0.5, h), x, True, gen)
    keep_c = float((new_c != -0.5).float().mean())
    keep_h = float((new_h != 0.7).float().mean())
    assert abs(keep_c - 0.9) < 0.01 and abs(keep_h - 0.7) < 0.01
    # at inference the mix is the expectation, with no draws
    with torch.no_grad():
        (inf_c, _), _ = cell((c - 0.5, h), x)
    (raw_c, _) = trnn.lstm_update(
        torch.cat([x, h], -1) @ cell.weight.t() + cell.bias, c - 0.5, h, 0.0,
        0.0, forget_bias=1.0)
    torch.testing.assert_close(inf_c, 0.9 * raw_c + 0.1 * (c - 0.5))


def test_prenet_and_attention_dropout_rates_and_scales():
    gen = torch.Generator().manual_seed(1)
    x = torch.ones(400, 250)
    dropped = tattn.dropout(x, 0.5, gen)
    assert abs(float((dropped == 0).float().mean()) - 0.5) < 0.01
    assert set(torch.unique(dropped).tolist()) == {0.0, 2.0}
    assert torch.equal(tattn.dropout(x, 0.0, gen), x)
    layer = PreNet(4, 300, drop_rate=0.5)
    inp = torch.rand(64, 4, generator=gen)
    with torch.no_grad():
        train = layer(inp, True, gen)
        plain = layer(inp)
    kept = train != 0
    torch.testing.assert_close(train[kept], 2.0 * plain[kept])
    assert abs(float((train == 0).float().mean())
               - 1 + 0.5 * float((plain > 0).float().mean())) < 0.02
    mha = tattn.MultiHeadAttention(8, 2, drop_rate=0.25)
    q = torch.randn(2, 50, 8, generator=gen)
    with torch.no_grad():
        out_t, probs_t = mha(q, q, q, True, gen)
        out_e, probs_e = mha(q, q, q)
    torch.testing.assert_close(probs_t, probs_e)   # alignments pre-dropout
    assert not torch.allclose(out_t, out_e)


def _mask_uniform_numpy(seed, step, mid, rows, cols):
    """The hash of ops/masks.py written over numpy uint32 (wrapping)."""
    def mix(x):
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(0x7FEB352D)
        x = x ^ (x >> np.uint32(15))
        x = x * np.uint32(0x846CA68B)
        return x ^ (x >> np.uint32(16))
    with np.errstate(over="ignore"):
        h = mix(np.uint32(seed) ^ np.uint32(0x9E3779B9))
        h = mix(h ^ np.uint32(step))
        h = mix(h ^ np.uint32(mid))
        r = np.arange(rows, dtype=np.uint32)[:, None]
        c = np.arange(cols, dtype=np.uint32)[None, :]
        h = mix(mix(h ^ r) ^ c)
    return (h >> np.uint32(8)).astype(np.float32) * np.float32(2.0 ** -24)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_mask_generator_bits_and_keep_rate(rate):
    seed, step = 0xDEADBEEF, 17
    a = tm.mask_uniform(seed, step, tm.MASK_ZC1, 250, 400)
    b = tm.mask_uniform(seed, step, tm.MASK_ZC1, 250, 400)
    assert torch.equal(a, b)
    np.testing.assert_array_equal(
        a.numpy(), _mask_uniform_numpy(seed, step, tm.MASK_ZC1, 250, 400))
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0
    keep = tm.keep_mask(seed, step, tm.MASK_ZC1, 250, 400, rate)
    assert abs(float(keep.mean()) - (1.0 - rate)) < 0.01
    # another step, mask id or row gives other bits
    for other in (tm.mask_uniform(seed, step + 1, tm.MASK_ZC1, 250, 400),
                  tm.mask_uniform(seed, step, tm.MASK_ZO1, 250, 400)):
        assert float((other == a).float().mean()) < 0.01


@pytest.mark.parametrize("K", [4, 5])
def test_window_helpers_and_their_adjoint(K):
    B, T = 3, 11
    cv = torch.from_numpy(randn(9, B, T))
    win = ft._windows(cv, K)
    # (B, T, K) windows of a SAME conv: tap k reads position tau + k - pad
    pad = (K - 1) // 2
    ref = torch.zeros(B, T, K)
    for k in range(K):
        for tau in range(T):
            j = tau + k - pad
            if 0 <= j < T:
                ref[:, tau, k] = cv[:, j]
    torch.testing.assert_close(win, ref)
    # the same windows through the port's SAME conv (flax's padding)
    w = torch.from_numpy(randn(10, K))
    conv = tconv.conv1d_same(cv[:, :, None], w[None, None, :])
    torch.testing.assert_close(conv[..., 0], win @ w, rtol=1e-5, atol=1e-6)
    d = torch.from_numpy(randn(11, B, T, K))
    lhs = float((win * d).sum())
    rhs = float((cv * ft._window_adjoint(d)).sum())
    np.testing.assert_allclose(lhs, rhs, rtol=1e-5)
