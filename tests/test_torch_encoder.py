"""The port's SelfAttentionCBHGEncoder against the JAX package on CPU.

The module path and the plain version of the fused-encoder kernel
(``fused_encode_reference``, what ``fused_encode`` runs for CPU tensors)
are held against the JAX XLA encoder (``fused_inference=False``) for
L = T and L < T, with an even max filter width (asymmetric SAME padding)
and non-trivial batch-norm statistics; one case goes against the JAX
Pallas kernel in interpret mode.  Tolerance 2e-4, as
tests/test_fused_encoder.py uses.
"""

import test_torch_threads  # noqa: F401  (bounds torch's threads)
import functools

import jax
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.models.encoders import \
    SelfAttentionCBHGEncoder as JaxEncoder
from self_attention_tacotron_torch.models.encoders import \
    SelfAttentionCBHGEncoder
from self_attention_tacotron_torch.ops import fused_encoder as fe

from test_torch_ops import jit_init, load, random_batch_stats, randn

TOL = 2e-4
CFG = dict(cbhg_out_units=16, conv_channels=8, max_filter_width=4,
           projection1_out_channels=8, projection2_out_channels=8,
           num_highway=2, self_attention_out_units=8,
           self_attention_num_heads=2, self_attention_num_hop=1,
           prenet_out_units=(16, 8), zoneout_factor_cell=0.1,
           zoneout_factor_output=0.1)


@functools.lru_cache(maxsize=None)
def _jax_encoder(T=13, E=12, seed=0, **kw):
    """(config, variables, input) of a JAX encoder, drawn once a module
    for each set of arguments."""
    cfg = dict(CFG, **kw)
    enc = JaxEncoder(drop_rate=0.5, **cfg)
    x = randn(seed, 1, T, E)
    v = jit_init(enc, {"params": jax.random.PRNGKey(seed)}, x,
                 np.full((1,), T, np.int32), is_training=True)
    return cfg, random_batch_stats(v, seed + 1), x


def _port(cfg, v, x, fused):
    enc = SelfAttentionCBHGEncoder(x.shape[-1], fused_inference=fused, **cfg)
    return load(enc, v)


def _run_port(enc, x, L):
    with torch.no_grad():
        lstm_out, sa, _ = enc(torch.from_numpy(x), torch.tensor([L]))
    return lstm_out.numpy(), sa.numpy()


def _run_jax(cfg, v, x, L, fused=False):
    enc = JaxEncoder(drop_rate=0.5, fused_inference=fused, **cfg)
    lstm_out, sa, _ = enc.apply(v, x, np.array([L], np.int32),
                                is_training=False)
    return np.asarray(lstm_out), np.asarray(sa)


@functools.lru_cache(maxsize=None)
def _jax_out(L):
    """The default JAX encoder's outputs at length ``L``, once a module
    for the module path and the fused reference both."""
    return _run_jax(*_jax_encoder(), L)


def _close(got, ref, tol=TOL):
    for g, r, name in zip(got, ref, ("lstm_out", "sa_out")):
        np.testing.assert_allclose(g, r, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("fused", [False, True], ids=["module", "fused_ref"])
@pytest.mark.parametrize("L", [13, 9])
def test_encoder_matches_jax_xla(fused, L):
    cfg, v, x = _jax_encoder()
    got = _run_port(_port(cfg, v, x, fused), x, L)
    _close(got, _jax_out(L))
    assert np.all(got[0][:, L:] == 0)


def test_fused_reference_with_adjust_layer_and_two_hops():
    """cbhg_out / 2 != proj2 width exercises the adjustment dense."""
    cfg, v, x = _jax_encoder(T=15, seed=3, cbhg_out_units=24,
                             self_attention_num_hop=2)
    _close(_run_port(_port(cfg, v, x, True), x, 11),
           _run_jax(cfg, v, x, 11))


def test_fused_reference_matches_jax_pallas_kernel():
    """Against the JAX fused encoder itself (Pallas, interpret mode)."""
    cfg, v, x = _jax_encoder(seed=5)
    _close(_run_port(_port(cfg, v, x, True), x, 10),
           _run_jax(cfg, v, x, 10, fused=True))


def test_fused_encode_takes_batch_one_only():
    cfg, v, x = _jax_encoder()
    enc = _port(cfg, v, x, True)
    with torch.no_grad():
        with pytest.raises(ValueError):
            fe.fused_encode(enc.fused_params(),
                            torch.from_numpy(np.concatenate([x, x])), 13,
                            max_filter_width=4, conv_channels=8, half=8,
                            sa_units=8, num_heads=2)
        # batch 2 through the module takes the module path instead
        lstm_out, _, _ = enc(torch.from_numpy(np.concatenate([x, x])),
                             torch.tensor([13, 13]))
    assert lstm_out.shape == (2, 13, 16)


# (T, E_in, prenet widths, K, C, P1, P2, W, H, SA, heads) -> (trunk,
# cluster) bytes of shared memory a block: the recipes' encoder widths (the
# codes and VCTK recipes share them; the first projection's item, 66 pooled
# and 67 raw rows of 256 channels and 3 taps of weights, sets the trunk's
# plan, the hop's projection from the 2 x 128 LSTM outputs the cluster's),
# the same at T = 600, where the hop streams its rows and the cluster's
# plan is the one of T = 64 (the resident rows would need 4 * (600 * 100
# + 8 * 600) bytes), and this file's tiny ones
SMEM_PLANS = {
    "recipe": ((64, 256, (256, 128), 16, 128, 128, 128, 128, 128, 32, 2),
               (4 * (133 * 260 + 3 * 256 * 8 + 512),
                4 * (64 * 260 + 256 * 8 + 8 + 512))),
    "recipe_long": ((600, 256, (256, 128), 16, 128, 128, 128, 128, 128, 32,
                     2),
                    (4 * (133 * 260 + 3 * 256 * 8 + 512),
                     4 * (64 * 260 + 256 * 8 + 8 + 512))),
    "tiny": ((32, 16, (16, 8), 4, 8, 8, 8, 8, 8, 8, 2), (24272, 11808)),
}


@pytest.mark.parametrize("name", list(SMEM_PLANS))
def test_fused_encode_smem_plan(name):
    """The kernel's shared-memory plan (held against the kernel's own
    figures in tests/test_torch_cuda.py) fits a block (227 KB)."""
    dims, want = SMEM_PLANS[name]
    assert fe.smem_bytes(*dims) == want
    assert max(want) <= 232448


def test_profile_split_scales_to_the_measured_time():
    n = len(fe.ENC_STAGES) * len(fe.ENC_PARTS)
    split = fe.profile_split(list(range(1, n + 1)), 0.25)
    assert list(split) == list(fe.ENC_STAGES)
    assert all(len(p) == len(fe.ENC_PARTS) for p in split.values())
    assert abs(sum(sum(p) for p in split.values()) - 250.0) < 1e-9
    assert fe.format_split(split).startswith("prenet ")


def tf32_split(x):
    """x ~= hi + lo, each rounded to TF32 (11 significant bits, nearest)
    by the integer add and mask of ``tf32_rn`` (csrc/mma.cuh)."""
    def rn(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    hi = rn(x)
    return hi, rn(x - hi)


def mma3(a, b):
    """(m, k) @ (k, n) in 8-deep steps of the 3xTF32 split (``mma3``): each
    step's three products (small ones first) from zero, added in float32
    to the running sum."""
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], 8):
        ah, al = tf32_split(a[:, k0:k0 + 8])
        bh, bl = tf32_split(b[k0:k0 + 8])
        acc = acc + ((al @ bh + ah @ bl) + ah @ bh)
    return acc


def stream_hop_mirror(kvq, SA, heads, blocks=8, rows=fe.HOP_ROWS,
                      keys=fe.HOP_KEYS, cols=fe.HOP_COLS):
    """The streamed hop's order of sums (``stream_hop`` in
    csrc/attention_rows.cuh) in float32 on (T, 3 SA) K | V | Q rows: each
    block's items of ``rows`` query rows (``fe.hop_stream_items``), the
    context a pass of ``cols`` columns at a time; in a pass each key
    tile's two halves folded online apart (their own row max, sum and
    context), the scores summed over the head's columns chunk by chunk
    and both products in the 3xTF32 split 8 deep at a time; at the pass's
    end the second half merged into the first and the row is o / l."""
    T, hd = kvq.shape[0], SA // heads
    scale = torch.rsqrt(torch.tensor(float(hd)))
    P, tiles, half = -(-hd // cols), -(-T // keys), keys // 2
    pad = torch.zeros(tiles * keys + rows, 3 * SA + P * cols)
    pad[:T, :3 * SA] = kvq
    ctx = torch.zeros(T, SA)
    floor = torch.tensor(-3.0e38)
    for items in fe.hop_stream_items(T, heads, blocks, rows):
        for hh, row0, n in items:
            q = torch.zeros(rows, P * cols)   # zero past the head
            q[:, :hd] = pad[row0:row0 + rows, 2 * SA + hh * hd:][:, :hd]
            for c in range(P):
                m = torch.full((2, rows), -3.0e38)
                l, o = torch.zeros(2, rows), torch.zeros(2, rows, cols)
                for tile in range(tiles):
                    for h in range(2):
                        k0 = tile * keys + h * half
                        k = torch.zeros(half, P * cols)
                        k[:, :hd] = pad[k0:k0 + half, hh * hd:][:, :hd]
                        sc = torch.zeros(rows, half)
                        for e in range(0, P * cols, cols):   # chunks
                            sc = sc + mma3(q[:, e:e + cols],
                                           k[:, e:e + cols].t())
                        pos = k0 + torch.arange(half)
                        sc = torch.where(pos[None] < T, sc * scale,
                                         torch.tensor(-float("inf")))
                        mn = torch.maximum(m[h], torch.maximum(
                            sc.amax(-1), floor))
                        keep = torch.exp(m[h] - mn)
                        p = torch.exp(sc - mn[:, None])
                        v = pad[k0:k0 + half, SA + hh * hd + c * cols:]
                        l[h] = l[h] * keep + p.sum(-1)
                        o[h] = o[h] * keep[:, None] + mma3(p, v[:, :cols])
                        m[h] = mn
                mm = torch.maximum(m[0], m[1])
                a, b = torch.exp(m[0] - mm), torch.exp(m[1] - mm)
                out = (a[:, None] * o[0] + b[:, None] * o[1]) / (
                    a * l[0] + b * l[1])[:, None]
                w = min(cols, hd - c * cols)
                ctx[row0:row0 + n, hh * hd + c * cols:][:, :w] = out[:n, :w]
    return ctx


@functools.lru_cache(maxsize=None)
def _jax_hop(T, SA, heads):
    """The JAX encoder kernel's hop attention (``_kernel``'s per-head
    softmax over all rows, with its ``_mm``), jitted once a shape."""
    import jax.numpy as jnp
    from self_attention_tacotron_tpu.ops import fused_encoder as jfe
    hd = SA // heads

    def hop(kvq):
        ctxs = []
        for hh in range(heads):
            k = kvq[:, hh * hd:(hh + 1) * hd]
            v = kvq[:, SA + hh * hd:SA + (hh + 1) * hd]
            q = kvq[:, 2 * SA + hh * hd:2 * SA + (hh + 1) * hd]
            s = jax.lax.dot_general(
                q, k, dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32) * (1.0 / hd ** 0.5)
            ex = jnp.exp(s - jnp.max(s, axis=1, keepdims=True))
            ctxs.append(jfe._mm(ex / jnp.sum(ex, axis=1, keepdims=True), v))
        return jnp.concatenate(ctxs, axis=1)
    return jax.jit(hop)


@pytest.mark.parametrize("T", [70, 200])
@pytest.mark.parametrize("hd", [16, 17, 32])
def test_streamed_hop_order_matches_jax_hop(hd, T):
    """The streamed hop's order of sums, with its tiles scaled down
    (16-row items over 8 blocks, 16-key tiles, 8-column chunks) so that
    the mirror streams several items, tiles, chunks and passes, within
    1e-5 of the JAX kernel's hop; at the kernel's own sizes too."""
    heads = 2
    SA = heads * hd
    kvq = randn(hd + T, T, 3 * SA) * 2.0
    ref = np.asarray(_jax_hop(T, SA, heads)(kvq))
    small = stream_hop_mirror(torch.from_numpy(kvq), SA, heads, rows=16,
                              keys=16, cols=8)
    np.testing.assert_allclose(small.numpy(), ref, rtol=1e-5, atol=1e-5)
    if hd == 17:
        full = stream_hop_mirror(torch.from_numpy(kvq), SA, heads)
        np.testing.assert_allclose(full.numpy(), ref, rtol=1e-5, atol=1e-5)
