"""The port's Pallas-mode attention against the JAX package on CPU.

* The plain versions of ``fused_self_attention`` and
  ``incremental_attention_step`` (what the wrappers run for CPU tensors,
  the functions the CUDA kernels are held to) against the JAX package's
  Pallas kernels in interpret mode, on tests/test_pallas.py's shapes,
  causal and not, and at t in {0, 5, T - 1}; inputs from numpy seeds,
  tolerance 1e-5 (float32; both sides sum in another order).
* ``MultiHeadAttention(use_pallas=True)`` against the JAX module with
  ``use_pallas=True``: the full-sequence call (causal and not) and three
  KV-cache steps, the zeroed alignments included; with dropout active in
  training the gate keeps the einsum path, as in the JAX package.
* The KV-cache step writes its row into the caches in place.
* The step kernel's plan (``step_plan``): the cache up to t in chunks of
  ``STEP_CHUNK`` positions, none past t, and the merge scratch.
* The full-sequence kernel's plan (``attention_plan``): the rows a block,
  the warps that split the keys and the grid at the serving, batched-
  encoder, training and long causal shapes, and shared memory that does
  not grow with T and lets two blocks share an SM at D = 128.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.ops import attention_core as jattn
from self_attention_tacotron_tpu.ops import pallas_attention as jpa
from self_attention_tacotron_torch.ops import attention_core as tattn
from self_attention_tacotron_torch.ops import pallas_attention as pa

from test_torch_ops import close, load, randn

TOL = 1e-5


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,H,T,D", [(2, 2, 37, 16), (1, 4, 128, 64),
                                     (1, 2, 200, 16)])
def test_plain_fused_self_attention_matches_jax_kernel(causal, B, H, T, D):
    q, k, v = (randn(s, B, H, T, D) for s in (0, 1, 2))
    ref = jpa.fused_self_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   interpret=True)
    launches = pa.fused_self_attention.launches
    got = pa.fused_self_attention(*map(torch.from_numpy, (q, k, v)),
                                  causal=causal)
    assert pa.fused_self_attention.launches == launches   # CPU: plain
    close(got, ref, TOL)


@pytest.mark.parametrize("bh,t,D,chunks", [
    (2, 0, 128, 1), (2, 31, 128, 1), (2, 32, 128, 2), (2, 249, 128, 8),
    (64, 449, 128, 15), (1, 33, 30, 2)])
def test_step_plan_chunks_the_cache(bh, t, D, chunks):
    """One block per STEP_CHUNK positions up to t (the first block of each
    head starts at 0, the last holds t); a single chunk needs no scratch,
    more write D + 2 floats each (max, sum, unnormalised row)."""
    got, floats = pa.step_plan(bh, t, D)
    assert pa.STEP_CHUNK == 32 and got == chunks
    assert (chunks - 1) * pa.STEP_CHUNK <= t < chunks * pa.STEP_CHUNK
    assert floats == (0 if chunks == 1 else bh * chunks * (D + 2))


# an H100 SM: 228 KB of shared memory, a block at most 227 KB, 1 KB of it
# reserved a block
SM_SMEM, BLOCK_SMEM, RESERVED = 233472, 232448, 1024


@pytest.mark.parametrize("B,H,T,D,causal,rows,key_warps", [
    (1, 2, 64, 16, False, 16, 4),      # the serving encoder's hop
    (8, 2, 64, 16, False, 16, 4),      # the batched encoder's hop
    (32, 2, 256, 128, False, 64, 1),
    (32, 2, 256, 128, True, 64, 1),
    (1, 2, 3000, 128, True, 32, 1),    # the SIWIS recipe's longest decode
    (1, 1, 1, 5, True, 16, 4),
    (2, 2, 37, 24, False, 16, 4),
    (66, 2, 16, 16, False, 16, 1),     # 132 one-warp blocks fill the card
    (64, 4, 500, 64, False, 64, 1)])
def test_attention_plan_fits_the_shape(B, H, T, D, causal, rows, key_warps):
    plan = pa.attention_plan(B, H, T, D, causal)
    blocks = -(-T // rows)
    assert (plan.rows, plan.key_warps, plan.warps, plan.grid) == (
        rows, key_warps, rows // 16 * key_warps, (blocks, B * H))
    assert plan.stages >= 2 and plan.keys in (16, 32, 64)
    assert 32 * plan.warps <= 128     # the kernel's launch bounds
    # fewer rows only where larger blocks would not fill the card, and
    # warps that split the keys only where 16-row blocks would not either
    if rows < pa.ATTN_ROWS[0] and 2 * rows < T + 16:
        assert -(-T // (2 * rows)) * B * H < pa.ATTN_FILL_BLOCKS
    assert (key_warps > 1) == (blocks * B * H < pa.ATTN_FILL_BLOCKS)
    # shared memory: the ring of K and V tiles only, whatever T
    dp = next(w for w in (16, 32, 64, 128) if D <= w)
    assert plan.smem_bytes == (plan.stages * 2 * plan.keys
                               * (dp + pa.ATTN_ROW_PAD) * 4)
    assert plan.smem_bytes <= BLOCK_SMEM
    if D > 64:
        assert 2 * (plan.smem_bytes + RESERVED) <= SM_SMEM
    assert plan == pa.attention_plan(B, H, T, D, not causal)
    if (B, T, D) == (1, 64, 16):   # spread: >= 8 warps on >= 4 SMs
        assert plan.grid[0] * plan.grid[1] >= 4
        assert plan.grid[0] * plan.grid[1] * plan.warps >= 8


@pytest.mark.parametrize("t", [0, 5, 23])
def test_plain_incremental_step_matches_jax_kernel(t):
    B, H, T, D = 2, 2, 24, 16
    kc, vc, q = randn(3, B, H, T, D), randn(4, B, H, T, D), randn(5 + t, B,
                                                                 H, D)
    ref = jpa.incremental_attention_step(jnp.asarray(q), jnp.asarray(kc),
                                         jnp.asarray(vc), jnp.asarray(t),
                                         interpret=True)
    got = pa.incremental_attention_step(torch.from_numpy(q),
                                        torch.from_numpy(kc),
                                        torch.from_numpy(vc), t)
    close(got, ref, TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_mha_pallas_mode_matches_jax(causal):
    """Full-sequence call and three steps, alignments zeroed on both
    sides."""
    D, H, S = 16, 2, 5
    xs = randn(8, 2, S, D)
    mod = jattn.MultiHeadAttention(D, H, use_subsequent_mask=causal,
                                   use_pallas=True)
    v = mod.init(jax.random.PRNGKey(5), xs, xs, xs)
    tm = load(tattn.MultiHeadAttention(D, H, use_subsequent_mask=causal,
                                       use_pallas=True), v)
    jout, jal = mod.apply(v, xs, xs, xs)
    with torch.no_grad():
        tout, tal = tm(*(torch.from_numpy(xs),) * 3)
    close(tout, jout)
    assert not np.asarray(jal).any() and not tal.any()
    assert tal.shape == jal.shape
    if not causal:
        return
    jcache = mod.apply(v, 2, S, method=mod.init_cache)
    tcache = tm.init_cache(2, S)
    with torch.no_grad():
        for t in range(3):
            jo, jcache, jrow = mod.apply(v, xs[:, t], t, jcache,
                                         method=mod.step)
            to, tcache, trow = tm.step(torch.from_numpy(xs[:, t]), t, tcache)
            close(to, jo)
            assert not np.asarray(jrow).any() and not trow.any()
            assert trow.shape == jrow.shape
            close(tcache.value, jcache.value)
    # column t of the full causal call
    close(to, tout[:, 2])


def test_dropout_in_training_keeps_the_einsum_path():
    D, H, S = 8, 2, 4
    tm = tattn.MultiHeadAttention(D, H, drop_rate=0.5, use_pallas=True)
    x = torch.from_numpy(randn(9, 1, S, D))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        _, train_al = tm(x, x, x, training=True, generator=gen)
        _, infer_al = tm(x, x, x)
    torch.testing.assert_close(train_al.sum(-1), torch.ones(1, H, S))
    assert not infer_al.any()


@pytest.mark.parametrize("use_pallas", [False, True])
def test_step_writes_the_caches_in_place(use_pallas):
    D, H, S = 8, 2, 4
    tm = tattn.MultiHeadAttention(D, H, use_subsequent_mask=True,
                                  use_pallas=use_pallas)
    xs = torch.from_numpy(randn(10, 1, S, D))
    cache = tm.init_cache(1, S)
    keys = cache.key
    with torch.no_grad():
        for t in range(S):
            out, cache, _ = tm.step(xs[:, t], t, cache)
        full, _ = tm(xs, xs, xs)
    assert cache.key is keys and keys.abs().sum(-1).all()
    torch.testing.assert_close(out, full[:, -1], rtol=TOL, atol=TOL)
