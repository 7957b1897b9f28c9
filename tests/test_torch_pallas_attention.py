"""The port's Pallas-mode attention against the JAX package on CPU.

* The plain versions of ``fused_self_attention`` and
  ``incremental_attention_step`` (what the wrappers run for CPU tensors,
  the functions the CUDA kernels are held to) against the JAX package's
  Pallas kernels in interpret mode, on tests/test_pallas.py's shapes,
  causal and not (a head of 160 among them, which the wide kernel
  takes), and at t in {0, 5, T - 1}; inputs from numpy seeds, tolerance
  1e-5 (float32; both sides sum in another order).
* ``MultiHeadAttention(use_pallas=True)`` against the JAX module with
  ``use_pallas=True``: the full-sequence call (causal and not) and three
  KV-cache steps, the zeroed alignments included; with dropout active in
  training the gate keeps the einsum path, as in the JAX package.
* The KV-cache step writes its row into the caches in place.
* The step kernel's plan (``step_plan``): the cache up to t in chunks of
  ``STEP_CHUNK`` positions, none past t, and the merge scratch; its bf16
  kernel's (``step_plan_bf16``): tiles of 64 positions over one cluster of
  at most 8 blocks a head, every position <= t once, no block empty, from
  t = 0 to SIWIS's 2999; a float32 mirror of that kernel's order (online
  over a block's tiles, then the first block's merge in rank order) on
  bf16 inputs against the plain version within 1e-2 of its largest
  magnitude.
* The full-sequence kernel's plan (``attention_plan``): the rows a block,
  the warps that split the keys and the grid at the serving, batched-
  encoder, training and long causal shapes, and shared memory that does
  not grow with T and lets two blocks share an SM at D = 128; at both
  element sizes (bf16's 64-key tiles and 128-row blocks) and for the
  wide kernel (two 16-row groups a block up to 512 wide, one past it, the
  largest key tile that fits 227 KB), within the launch bounds.
* bf16 operands (the model-wide bf16's hops): both plain versions, given
  bf16 inputs, within one bf16 ulp of the JAX kernels in interpret mode
  (both sum in float32 and round once; the sums' order may move a value
  across a rounding boundary), causal and not, at a wide head and with a
  cache at t < S - 1; ``MultiHeadAttention(use_pallas=True)`` in bf16
  (its bf16 KV cache) against the JAX module in bf16; any other dtype, or
  a mix, raises on the CPU as on the card.
"""

import test_torch_threads  # noqa: F401  (bounds torch's threads)
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
                                     (1, 2, 200, 16), (1, 2, 24, 160)])
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


@pytest.mark.parametrize("t", [0, 63, 64, 449, 511, 512, 2999])
def test_step_plan_bf16_covers_the_cache_in_one_cluster(t):
    """Every position <= t in exactly one tile of one block, tiles of
    STEP_BF16_TILE positions starting at multiples of it, no block empty,
    one cluster of at most STEP_BF16_CLUSTER blocks a head (8 from t = 448
    on), each block's tiles in increasing order."""
    plan = pa.step_plan_bf16(t)
    tiles = t // pa.STEP_BF16_TILE + 1
    assert pa.STEP_BF16_TILE == 64 and pa.STEP_BF16_CLUSTER == 8
    assert len(plan) == min(8, tiles) and all(plan)
    seen = [p for block in plan for lo, hi in block for p in range(lo, hi)]
    assert sorted(seen) == list(range(t + 1))
    for block in plan:
        assert all(lo % 64 == 0 and 0 < hi - lo <= 64 for lo, hi in block)
        assert [lo for lo, _ in block] == sorted(lo for lo, _ in block)


def step_bf16_mirror(q, kc, vc, t):
    """The bf16 kernel's order in float32 on (B, H, D) / (B, H, S, D) bf16
    inputs: each block of ``step_plan_bf16`` folds its tiles online (the
    tile's max and sum into (m, l), its p v rows into o after rescaling),
    then the first block merges the blocks' (m, l, o) in rank order; the
    output rounded once to bf16."""
    q, kc, vc = q.float(), kc.float(), vc.float()
    scale = 1.0 / np.sqrt(q.shape[-1])
    states = []
    for block in pa.step_plan_bf16(t):
        m = torch.full(q.shape[:2], -float("inf"))
        l, o = torch.zeros(q.shape[:2]), torch.zeros(q.shape)
        for lo, hi in block:
            s = torch.einsum("bhd,bhkd->bhk", q, kc[:, :, lo:hi]) * scale
            mn = torch.maximum(m, s.amax(-1))
            keep, p = torch.exp(m - mn), torch.exp(s - mn[..., None])
            l = l * keep + p.sum(-1)
            o = o * keep[..., None] + torch.einsum("bhk,bhkd->bhd", p,
                                                   vc[:, :, lo:hi])
            m = mn
        states.append((m, l, o))
    gm = torch.stack([m for m, _, _ in states]).amax(0)
    num, den = torch.zeros(q.shape), torch.zeros(q.shape[:2])
    for m, l, o in states:
        w = torch.exp(m - gm)
        den = den + w * l
        num = num + w[..., None] * o
    return (num / den[..., None]).bfloat16()


@pytest.mark.parametrize("S,t", [(450, 449), (450, 63), (600, 512),
                                 (3000, 2999)])
def test_step_bf16_merge_order_matches_plain(S, t):
    B, H, D = 1, 2, 128
    _, kc = _bf16(3, B, H, S, D)
    _, vc = _bf16(4, B, H, S, D)
    _, q = _bf16(5, B, H, D)
    got = step_bf16_mirror(q, kc, vc, t)
    ref = pa.incremental_attention_step_reference(q, kc, vc, t)
    scale = float(ref.float().abs().max())
    assert float((got.float() - ref.float()).abs().max()) <= 1e-2 * scale


@pytest.mark.parametrize("bh", [2, 64])
@pytest.mark.parametrize("D", [257, 512, 2050])
@pytest.mark.parametrize("t", [0, 31, 32, 63, 64, 449, 2999])
def test_step_plan_wide_covers_the_cache(t, D, bh):
    """The wide kernel's plan (B * H = 2, the serving heads, and 64, where
    the heads alone fill the card): every position <= t in exactly one
    tile of one block of each (head, slab), tiles of STEP_WIDE_TILE
    positions in increasing order, no block empty, and a scratch row (max,
    sum, a slab of context) for each block when there is more than one."""
    plan = pa.step_plan_wide(bh, t, D)
    tiles = pa.step_plan_wide_tiles(plan, t)
    assert pa.STEP_WIDE_TILE == 16 and pa.STEP_WIDE_SLAB == 512
    assert plan.slabs == -(-D // 512) and plan.tickets == bh * plan.slabs
    assert len(tiles) == plan.blocks and all(tiles)
    assert plan.blocks * bh * plan.slabs <= max(pa.STEP_WIDE_FILL,
                                                bh * plan.slabs)
    seen = [p for block in tiles for lo, hi in block for p in range(lo, hi)]
    assert sorted(seen) == list(range(t + 1))
    for block in tiles:
        assert all(lo % 16 == 0 and 0 < hi - lo <= 16 for lo, hi in block)
        assert [lo for lo, _ in block] == sorted(lo for lo, _ in block)
    assert plan.part_floats == (0 if plan.blocks == 1 else
                                bh * plan.slabs * plan.blocks * (512 + 2))


def _fold(states):
    """(m, l, o) states merged in order, max-shifted."""
    gm = torch.stack([m for m, _, _ in states]).amax(0)
    den, num = torch.zeros_like(gm), torch.zeros_like(states[0][2])
    for m, l, o in states:
        w = torch.exp(m - gm)
        den = den + w * l
        num = num + w[..., None] * o
    return gm, den, num


def step_wide_mirror(q, kc, vc, t):
    """The wide kernel's order of sums in float32 on (B, H, D) / (B, H, S,
    D) inputs (the bf16 ones upcast): for each (head, slab) of
    ``step_plan_wide``, each block's warps fold their two rows of each of
    the block's tiles online (warp w rows w and w + 8), the scores summed
    over every slab; the block merges its warps in order, and the last
    block the blocks' partials in order; the output rounded once to q's
    dtype."""
    dt = q.dtype
    q, kc, vc = q.float(), kc.float(), vc.float()
    B, H, D = q.shape
    plan = pa.step_plan_wide(B * H, t, D)
    tiles = pa.step_plan_wide_tiles(plan, t)
    scale = 1.0 / np.sqrt(D)
    out = torch.zeros(B, H, D)
    floor = torch.full((B, H), -3.0e38)
    for sl in range(plan.slabs):
        cols = slice(sl * 512, min(D, (sl + 1) * 512))
        blocks = []
        for block in tiles:
            warps = []
            for w in range(8):
                m, l = floor.clone(), torch.zeros(B, H)
                o = torch.zeros(B, H, cols.stop - cols.start)
                for lo, hi in block:
                    rows = [p for p in (lo + w, lo + w + 8) if p < hi]
                    if not rows:
                        continue
                    s = torch.einsum("bhd,bhkd->bhk", q, kc[:, :, rows])
                    s = s * scale
                    mn = torch.maximum(m, torch.maximum(s.amax(-1), floor))
                    keep, p = torch.exp(m - mn), torch.exp(s - mn[..., None])
                    l = l * keep + p.sum(-1)
                    o = o * keep[..., None] + torch.einsum(
                        "bhk,bhkd->bhd", p, vc[:, :, rows, cols])
                    m = mn
                warps.append((m, l, o))
            blocks.append(_fold(warps))
        _, den, num = _fold(blocks)
        out[..., cols] = num / den[..., None]
    return out.to(dt)


@pytest.mark.parametrize("B,H", [(1, 2), (2, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,D,t", [(450, 257, 449), (600, 300, 311),
                                   (3000, 512, 2999), (70, 1030, 65)])
def test_step_wide_merge_order_matches_plain(S, D, t, dtype, B, H):
    """The wide kernel's order (``step_wide_mirror``) against the plain
    version, at the serving heads and at B * H = 6 (fewer blocks a head):
    float32 within 1e-5, bf16 inputs within 1e-2 of the largest
    magnitude."""
    kc, vc = (torch.from_numpy(randn(s, B, H, S, D)).to(dtype)
              for s in (3, 4))
    q = torch.from_numpy(randn(5, B, H, D)).to(dtype)
    got = step_wide_mirror(q, kc, vc, t)
    ref = pa.incremental_attention_step_reference(q, kc, vc, t)
    assert got.dtype == ref.dtype == dtype
    err = float((got.float() - ref.float()).abs().max())
    if dtype == torch.float32:
        assert err <= TOL
    else:
        assert err <= 1e-2 * float(ref.float().abs().max())


# an H100 SM: 228 KB of shared memory, a block at most 227 KB, 1 KB of it
# reserved a block
SM_SMEM, BLOCK_SMEM, RESERVED = 233472, 232448, 1024


@pytest.mark.parametrize("B,H,T,D,causal,rows,key_warps,elem_bytes", [
    (1, 2, 64, 16, False, 16, 4, 4),      # the serving encoder's hop
    (8, 2, 64, 16, False, 16, 4, 4),      # the batched encoder's hop
    (32, 2, 256, 128, False, 64, 1, 4),
    (32, 2, 256, 128, True, 64, 1, 4),
    (1, 2, 3000, 128, True, 32, 1, 4),    # the SIWIS recipe's longest decode
    (1, 1, 1, 5, True, 16, 4, 4),
    (2, 2, 37, 24, False, 16, 4, 4),
    (66, 2, 16, 16, False, 16, 1, 4),     # 132 one-warp blocks fill the card
    (64, 4, 500, 64, False, 64, 1, 4),
    # bf16 operands: the serving hop, the training shape (8-warp blocks),
    # 4 key warps at 128 wide, a width that is not a multiple of 8
    (1, 2, 64, 16, False, 16, 4, 2),
    (32, 2, 256, 128, True, 128, 1, 2),
    (32, 2, 250, 64, False, 128, 1, 2), (8, 2, 256, 64, False, 16, 1, 2),
    (1, 2, 450, 128, True, 16, 4, 2),
    (2, 1, 45, 30, True, 16, 4, 2),
    # the wide kernel at both element sizes: 2 row groups a block to 512
    # wide, one past it
    (1, 2, 64, 129, True, 32, 1, 4), (1, 2, 64, 129, True, 32, 1, 2),
    (8, 2, 256, 256, False, 32, 1, 4), (1, 2, 450, 256, True, 32, 1, 2),
    (2, 2, 33, 1024, False, 16, 1, 4), (2, 2, 33, 1024, False, 16, 1, 2)])
def test_attention_plan_fits_the_shape(B, H, T, D, causal, rows, key_warps,
                                       elem_bytes):
    plan = pa.attention_plan(B, H, T, D, causal, elem_bytes)
    blocks = -(-T // rows)
    wide = D > pa.MAX_MMA_HEAD_DIM
    warps = pa.WIDE_WARPS if wide else rows // 16 * key_warps
    assert (plan.rows, plan.key_warps, plan.warps, plan.grid) == (
        rows, key_warps, warps, (blocks, B * H))
    assert plan.stages >= 2 and plan.keys in ((8, 16, 32) if wide
                                              else (16, 32, 64))
    # the kernels' launch bounds: 128 threads (two blocks an SM), 256 wide
    # and in bf16's 128-row blocks
    assert 32 * plan.warps <= (256 if wide or rows == 128 else 128)
    assert plan.smem_bytes <= BLOCK_SMEM
    assert plan == pa.attention_plan(B, H, T, D, not causal, elem_bytes)
    pad = pa.ATTN_ROW_PAD * 4 // elem_bytes
    ring = lambda dp, keys: plan.stages * 2 * keys * (dp + pad) * elem_bytes
    if wide:
        # the ring and each warp's 16 x keys float tile of partial scores;
        # 2 bf16 steps of 16 keys and 16-deep column slices
        dp = next(w for w in pa.WIDE_WIDTHS if D <= w)
        assert plan.smem_bytes == (ring(dp, plan.keys)
                                   + plan.warps * 16 * plan.keys * 4)
        assert rows == (32 if dp <= pa.WIDE_TWO_GROUPS else 16)
        if elem_bytes == 2:
            assert plan.keys % 16 == 0 and dp * rows // 128 % 16 == 0
        if plan.keys < 32:     # the next larger tile would not fit
            assert (ring(dp, 2 * plan.keys)
                    + plan.warps * 32 * plan.keys * 4) > BLOCK_SMEM
        return
    # bf16: 128 rows where those blocks fill half the card; else fewer rows
    # only where larger blocks would not fill the card, and warps that
    # split the keys only where 16-row blocks would not either
    big = elem_bytes == 2 and 128 < T + 16 and \
        -(-T // 128) * B * H >= pa.ATTN_FILL_BLOCKS // 2
    assert (rows == 128) == big
    if not big:
        if rows < pa.ATTN_ROWS[0] and 2 * rows < T + 16:
            assert -(-T // (2 * rows)) * B * H < pa.ATTN_FILL_BLOCKS
        assert (key_warps > 1) == (blocks * B * H < pa.ATTN_FILL_BLOCKS)
    # shared memory: the ring of K and V tiles (or the 4 key warps' merge,
    # when larger) only, whatever T; bf16 takes 64-key tiles, 16 per warp
    # of a 4-warp block
    dp = next(w for w in (16, 32, 64, 128) if D <= w)
    merge = key_warps * (dp // 8 * 4 + 4) * 32 * 4 if key_warps > 1 else 0
    assert plan.smem_bytes == max(ring(dp, plan.keys), merge)
    if elem_bytes == 2:
        assert plan.keys == 64
    if D > 64 and rows < 128:     # two blocks an SM
        assert 2 * (plan.smem_bytes + RESERVED) <= SM_SMEM
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


def test_jax_package_cannot_differentiate_the_pallas_kernel():
    """The reference: ``jax.grad`` through the JAX package's
    ``fused_self_attention`` (interpret mode, causal, (1, 2, 16, 16))
    fails, since its ``pallas_call`` has no transpose rule and the function
    no ``custom_vjp``; so the port owes no backward kernel for #5."""
    q, k, v = (jnp.asarray(randn(s, 1, 2, 16, 16)) for s in (0, 1, 2))

    def loss(q):
        return jpa.fused_self_attention(q, k, v, causal=True,
                                        interpret=True).sum()

    with pytest.raises(AssertionError):
        jax.grad(loss)(q)


@pytest.mark.parametrize("enc_rate,dec_rate,named", [
    (0.0, 0.05, ["self_attention_drop_rate"]),
    (0.05, 0.0, ["decoder_self_attention_drop_rate"]),
    (0.0, 0.0, ["self_attention_drop_rate",
                "decoder_self_attention_drop_rate"]),
    (0.05, 0.05, [])])
def test_port_refuses_pallas_training_without_dropout(enc_rate, dec_rate,
                                                      named):
    """The port refuses the configuration the reference cannot train, on
    the CPU as on the card, before the first step: the train step raises a
    ``NotImplementedError`` that names the hparams (and leaves the step
    count alone); under ``torch.no_grad`` and with dropout on each hop it
    does not."""
    from self_attention_tacotron_torch.models import tacotron_model_factory
    from self_attention_tacotron_torch.parallel import (create_train_state,
                                                        make_train_step)
    from test_torch_ops import tiny_codes_hp
    hp = tiny_codes_hp(use_pallas_attention=True,
                       self_attention_drop_rate=enc_rate,
                       decoder_self_attention_drop_rate=dec_rate)
    model = tacotron_model_factory(hp)
    state = create_train_state(model, hp)
    refusal = model.pallas_training_refusal()
    if not named:
        assert refusal is None
        return
    assert isinstance(refusal, NotImplementedError)
    with pytest.raises(NotImplementedError, match="use_pallas_attention") \
            as info:
        make_train_step(hp)(state, None)
    assert all(n + " = 0" in str(info.value) for n in named)
    assert "pallas_call" in str(info.value) and state.step == 0
    with torch.no_grad():
        assert model.pallas_training_refusal() is None


def test_hop_refuses_a_differentiated_pallas_call():
    """The hop itself: a training call in the Pallas mode without dropout
    raises where an input needs a gradient, and runs under no_grad."""
    tm = tattn.MultiHeadAttention(8, 2, drop_rate=0.0, use_pallas=True)
    x = torch.from_numpy(randn(4, 1, 5, 8))
    with pytest.raises(NotImplementedError, match="no backward"):
        tm(x, x, x, training=True)
    with torch.no_grad():
        out, align = tm(x, x, x, training=True)
    assert out.shape == (1, 5, 8) and not align.any()


def _bf16_ulps(got, ref) -> float:
    """The largest difference in units of the last place of bf16 at each
    reference element's magnitude (2^-7 of its binade)."""
    got = got.float().numpy()
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    binade = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -100))))
    return float((np.abs(got - ref) / (binade * 2.0 ** -7)).max())


def _bf16(seed, *shape):
    x = randn(seed, *shape)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()


@pytest.mark.parametrize("B,H,T,D,causal", [
    (1, 2, 20, 16, True), (2, 2, 37, 16, False), (1, 2, 24, 160, True)],
    ids=["causal", "full", "wide_causal"])
def test_plain_fused_self_attention_bf16_matches_jax_kernel(B, H, T, D,
                                                           causal):
    (jq, q), (jk, k), (jv, v) = (_bf16(s, B, H, T, D) for s in (0, 1, 2))
    ref = jpa.fused_self_attention(jq, jk, jv, causal=causal,
                                   interpret=True)
    launches = (pa.fused_self_attention.launches,
                pa.fused_self_attention.launches_bf16)
    got = pa.fused_self_attention(q, k, v, causal=causal)
    assert (pa.fused_self_attention.launches,
            pa.fused_self_attention.launches_bf16) == launches  # CPU: plain
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert _bf16_ulps(got, ref) <= 1.0


@pytest.mark.parametrize("S,D,t", [(24, 16, 0), (24, 16, 5), (24, 16, 17),
                                   (12, 300, 7)],
                         ids=["t0", "t5", "t17", "wide_t7"])
def test_plain_incremental_step_bf16_matches_jax_kernel(S, D, t):
    B, H = 2, 2
    (jk, kc), (jv, vc), (jq, q) = (_bf16(s, *shape) for s, shape in (
        (3, (B, H, S, D)), (4, (B, H, S, D)), (5 + t, (B, H, D))))
    ref = jpa.incremental_attention_step(jq, jk, jv, jnp.asarray(t),
                                         interpret=True)
    got = pa.incremental_attention_step(q, kc, vc, t)
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert _bf16_ulps(got, ref) <= 1.0


def test_attention_kernels_take_float32_or_bfloat16_only():
    q = torch.zeros(1, 2, 4, 8)
    for bad in ((q.half(),) * 3, (q, q.bfloat16(), q)):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            pa.fused_self_attention(*bad)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        pa.incremental_attention_step(q[:, :, 0].bfloat16(), q, q, 0)


def test_mha_pallas_mode_bf16_matches_jax():
    """The hop in the model-wide bf16: projections in bf16, the kernels'
    plain versions on bf16 q, k, v, a bf16 KV cache; the full causal call
    and three cache steps within one bf16 ulp of the JAX module's
    (``dtype=bfloat16``, its kernels in interpret mode); zero alignments in
    bf16."""
    from self_attention_tacotron_torch.ops.compute_dtype import \
        set_compute_dtype
    D, H, S = 16, 2, 5
    xs = randn(8, 2, S, D)
    mod = jattn.MultiHeadAttention(D, H, use_subsequent_mask=True,
                                   use_pallas=True, dtype=jnp.bfloat16)
    v = mod.init(jax.random.PRNGKey(5), xs, xs, xs)
    tm = set_compute_dtype(load(tattn.MultiHeadAttention(
        D, H, use_subsequent_mask=True, use_pallas=True), v), torch.bfloat16)
    jout, jal = mod.apply(v, xs, xs, xs)
    with torch.no_grad():
        tout, tal = tm(*(torch.from_numpy(xs),) * 3)
    assert tout.dtype == tal.dtype == torch.bfloat16
    assert _bf16_ulps(tout, jout) <= 1.0 and not tal.any()
    jcache = mod.apply(v, 2, S, method=mod.init_cache)
    tcache = tm.init_cache(2, S)
    assert tcache.key.dtype == torch.bfloat16
    assert jcache.key.dtype == jnp.bfloat16
    with torch.no_grad():
        for t in range(3):
            jo, jcache, jrow = mod.apply(v, xs[:, t], t, jcache,
                                         method=mod.step)
            to, tcache, trow = tm.step(torch.from_numpy(xs[:, t]), t, tcache)
            assert to.dtype == trow.dtype == torch.bfloat16
            assert _bf16_ulps(to, jo) <= 1.0 and not trow.any()
            np.testing.assert_array_equal(
                tcache.value.float().numpy(),
                np.asarray(jcache.value.astype(jnp.float32)))
