"""The training trunk's plain versions against the JAX package on CPU.

``ops/fused_train.py`` holds the plain forward and the plain reverse-time
VJP that the two training kernels are held against on the card.  Here:

* the plain forward against the JAX ``fused_teacher_scan`` (its Pallas
  kernels in interpret mode), deterministic: source kinds additive,
  location_sensitive and forward, cumulative conv inputs, the speaker row,
  zoneout by expectation; y and the alignments (rtol / atol 2e-5, the
  tolerance of tests/test_fused_train.py);
* the plain backward (``fused_train_bwd_reference``, which reads the
  forward's saves) against ``jax.grad`` of the same JAX function (rtol
  2e-3 / atol 2e-5, the gradient tolerance of tests/test_fused_train.py),
  and against ``torch.autograd`` of the plain forward with dropout 0.5 and
  zoneout 0.1 drawn from the shared counter-based masks (each gradient
  within 1e-5 of its largest magnitude);
* the model's fused TRAIN path (whose plain version runs on CPU) against
  its module path: loss, outputs and every gradient;
* the configuration gate's reasons, each logged once.
"""

import test_torch_threads  # noqa: F401  (bounds torch's threads)
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.ops import fused_train as jft
from self_attention_tacotron_torch.models import (Batch, compute_loss,
                                                  tacotron_model_factory)
from self_attention_tacotron_torch.models import decoder as tdec
from self_attention_tacotron_torch.ops import fused_train as ft
from self_attention_tacotron_torch.utils.convert import init_parameters

B, S, T = 2, 4, 6
CF, U, C, P, A, D = 9, (6, 4), (5, 3), (8, 6), 7, 5

CASES = {
    # source kinds, cumulative, K, speaker row, zoneout (by expectation)
    "fwd_add_k4": (("forward", "additive"), (False, False), 4, False, 0.0),
    "loc_fwd_k5_cum_zoneout": (("location_sensitive", "forward"),
                               (True, True), 5, False, 0.1),
    "fwd_fwd_k10_spk_zoneout": (("forward", "forward"), (False, True), 10,
                                True, 0.1),
}


def make_case(kinds, cum, K, spk, seed=0):
    """Numpy inputs of the trunk: (params as a FusedTrainParams of arrays,
    keys, values, masks, teacher (B, S, CF), speaker row, loc_ws)."""
    rng = np.random.default_rng(seed)

    def r(*s):
        return (rng.standard_normal(s) * 0.3).astype(np.float32)
    params = ft.FusedTrainParams(
        prenet=((r(CF, P[0]), r(1, P[0])), (r(P[0], P[1]), r(1, P[1]))),
        att_lstm=(r(P[1] + sum(C) + A, 4 * A), r(1, 4 * A)),
        query=tuple((r(A, u), r(u, 1)) for u in U),
        outproj=(r(A + sum(C), D), r(1, D)),
        lstm1=(r(2 * D, 4 * D), r(1, 4 * D)),
        lstm2=(r(2 * D, 4 * D), r(1, 4 * D)))
    keys = tuple(r(B, T, u) for u in U)
    values = tuple(r(B, T, c) for c in C)
    lens = np.array([T, T - 2])
    masks = tuple((np.arange(T)[None] < lens[:, None]).astype(np.float32)
                  for _ in U)
    loc_ws = tuple(r(K, u) if k != "additive" else None
                   for k, u in zip(kinds, U))
    return (params, keys, values, masks, r(B, S, CF),
            r(B, P[0]) if spk else None, loc_ws)


def _map(fn, tree):
    return jax.tree_util.tree_map(fn, tree)


def _kw(kinds, cum, K, zone, deterministic=True, drop=0.0):
    return dict(drop_rate=drop, zc_att=zone, zo_att=zone, zc_dec=zone,
                zo_dec=zone, deterministic=deterministic, src_kinds=kinds,
                cumulative=cum, loc_kernel=K)


def _weights(y):
    n = int(np.prod(y.shape))
    return np.cos(np.arange(n).reshape(y.shape) * 0.1).astype(np.float32)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_forward_and_backward_match_jax(case):
    kinds, cum, K, spk, zone = CASES[case]
    params, keys, values, masks, teacher, spk_row, loc_ws = make_case(
        kinds, cum, K, spk)
    kw = _kw(kinds, cum, K, zone)

    def scan(p, k, v, s, lw):
        return jft.fused_teacher_scan(
            jft.FusedTrainParams(*p), k, v, masks, jnp.asarray(teacher),
            jnp.int32(0), speaker_row=s, loc_ws=lw, save_align=True,
            interpret=True, **kw)
    jargs = (_map(jnp.asarray, tuple(params)), _map(jnp.asarray, keys),
             _map(jnp.asarray, values),
             None if spk_row is None else jnp.asarray(spk_row),
             _map(jnp.asarray, loc_ws))
    c = _weights(jax.eval_shape(scan, *jargs)[0])

    def reference(*a):
        """y, the alignments and the gradients of sum(y * c): one XLA
        program, in place of a compile for each operation."""
        return (*scan(*a), jax.grad(lambda *b: jnp.sum(scan(*b)[0] * c),
                                    argnums=(0, 1, 2, 3, 4))(*a))
    y_ref, al_ref, g_ref = jax.jit(reference)(*jargs)

    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    tp = ft.FusedTrainParams(*_map(t, tuple(params)))
    tk, tv, tmk = _map(t, keys), _map(t, values), _map(t, masks)
    y, aligns = ft.fused_teacher_scan(tp, tk, tv, tmk, t(teacher), 0,
                                      speaker_row=t(spk_row), loc_ws=_map(
                                          t, loc_ws), **kw)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               rtol=2e-5, atol=2e-5)
    for a, b in zip(aligns, al_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=2e-5)

    spec = ft.make_spec(tp, tk, tv, t(teacher), use_spk=spk, **kw)
    tf = t(teacher).transpose(0, 1).reshape(S * B, CF)
    lw = _map(t, loc_ws)
    with torch.no_grad():
        y_flat, save, aux = ft.fused_train_fwd_reference(
            spec, tp, tk, tv, tmk, tf, 0, t(spk_row), lw)
        g_y = torch.from_numpy(c).transpose(0, 1).reshape(S * B, D)
        d_params, d_keys, d_values, d_spk, d_loc = \
            ft.fused_train_bwd_reference(spec, tp, tk, tv, tmk, tf, 0,
                                         t(spk_row), lw, g_y, save, aux)
    got = (tuple(d_params), d_keys, d_values, d_spk, d_loc)
    leaves_ref = jax.tree_util.tree_leaves(g_ref)
    leaves_got = jax.tree_util.tree_leaves(got)
    assert len(leaves_ref) == len(leaves_got)
    for a, b in zip(leaves_got, leaves_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3,
                                   atol=2e-5)
    assert all(np.abs(np.asarray(x)).max() > 0 for x in leaves_ref)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_with_masks_matches_autograd(case):
    kinds, cum, K, spk, _ = CASES[case]
    params, keys, values, masks, teacher, spk_row, loc_ws = make_case(
        kinds, cum, K, spk, seed=1)
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    tp = ft.FusedTrainParams(*_map(lambda x: t(x).requires_grad_(),
                                   tuple(params)))
    tk = tuple(t(k).requires_grad_() for k in keys)
    tv = tuple(t(v).requires_grad_() for v in values)
    ts = None if spk_row is None else t(spk_row).requires_grad_()
    lw = tuple(None if x is None else t(x).requires_grad_() for x in loc_ws)
    tmk = _map(t, masks)
    kw = _kw(kinds, cum, K, 0.1, deterministic=False, drop=0.5)
    spec = ft.make_spec(tp, tk, tv, t(teacher), use_spk=spk, **kw)
    tf = t(teacher).transpose(0, 1).reshape(S * B, CF)
    y, save, aux = ft.fused_train_fwd_reference(spec, tp, tk, tv, tmk, tf,
                                                123, ts, lw)
    g = torch.from_numpy(_weights(y))
    mine = (tuple(tp), tk, tv, ts, lw)
    leaves = [x for x in jax.tree_util.tree_leaves(mine)]
    ref = torch.autograd.grad((y * g).sum(), leaves)
    with torch.no_grad():
        d_params, d_keys, d_values, d_spk, d_loc = \
            ft.fused_train_bwd_reference(spec, tp, tk, tv, tmk, tf, 123, ts,
                                         lw, g, save, aux)
    got = jax.tree_util.tree_leaves((tuple(d_params), d_keys, d_values,
                                     d_spk, d_loc))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        scale = max(float(b.abs().max()), 1e-12)
        assert float((a.reshape(b.shape) - b).abs().max()) <= 1e-5 * scale
    # the masks did something: a deterministic run gives another y
    y_det, _, _ = ft.fused_train_fwd_reference(
        spec._replace(deterministic=True), tp, tk, tv, tmk, tf, 123, ts, lw)
    assert not torch.allclose(y, y_det)


def _tiny_hp(**kw):
    from test_torch_train_step import train_hp
    return train_hp(**kw)


def _batch(hp):
    rng = np.random.default_rng(5)
    T_in, T_out = 7, 6
    src = rng.integers(1, hp.num_symbols, (3, T_in))
    target = np.eye(hp.num_mels, dtype=np.float32)[
        rng.integers(0, hp.num_mels, (3, T_out))]
    spec_mask = np.ones((3, T_out), np.float32)
    spec_mask[2] = 0.0          # a padded row: out of the BN statistics
    done = np.zeros((3, T_out), np.float32)
    done[:, -1] = 1.0
    return Batch(source=torch.from_numpy(src),
                 source_length=torch.tensor([T_in, T_in - 3, T_in - 1]),
                 target=torch.from_numpy(target),
                 target_length=torch.tensor([T_out] * 3),
                 done=torch.from_numpy(done),
                 spec_loss_mask=torch.from_numpy(spec_mask),
                 binary_loss_mask=torch.from_numpy(spec_mask.copy()))


def test_model_fused_train_path_matches_module_path():
    results = []
    for fused in (False, True):
        hp = _tiny_hp(decoder_fused_train=fused)
        model = init_parameters(tacotron_model_factory(hp), 3)
        before = ft.fused_train_fwd.launches
        out = model.train_forward(_batch(hp))
        losses = compute_loss(hp, out, _batch(hp), model)
        losses["loss"].backward()
        assert ft.fused_train_fwd.launches == before   # CPU: plain version
        results.append((float(losses["loss"].detach()), out.outputs.detach(),
                        [a.detach() for a in out.alignments],
                        {k: p.grad for k, p in model.named_parameters()}))
    (l0, o0, a0, g0), (l1, o1, a1, g1) = results
    np.testing.assert_allclose(l1, l0, rtol=1e-5)
    torch.testing.assert_close(o1, o0, rtol=2e-4, atol=2e-5)
    for x, y in zip(a1, a0):
        torch.testing.assert_close(x, y, rtol=2e-4, atol=2e-5)
    assert g0.keys() == g1.keys()
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=2e-3, atol=2e-5,
                                   msg=k)


def test_fused_train_gate_reasons_are_logged_once(caplog):
    tdec._warned_fused_fallback.clear()
    hp = _tiny_hp(decoder_fused_train=True, attention2="forward")
    model = init_parameters(tacotron_model_factory(hp), 3)
    dec = model.decoder
    packs = tuple(m.precompute(torch.randn(2, 7, d), torch.tensor([7, 5]))
                  for m, d in zip(dec.attention_mechanisms,
                                  (hp.cbhg_out_units,
                                   hp.self_attention_out_units)))
    teacher = torch.randn(2, 4, hp.num_mels)
    assert dec._fused_train_unsupported_reason(2, packs, teacher) is None
    short = (packs[0], packs[1]._replace(
        keys=packs[1].keys[:, :5], values=packs[1].values[:, :5],
        mask=packs[1].mask[:, :5]))
    assert "memory lengths" in dec._fused_train_unsupported_reason(
        2, short, teacher)
    wide = torch.randn(65, 4, hp.num_mels)
    wide_packs = tuple(p._replace(keys=p.keys[:1].expand(65, -1, -1),
                                  values=p.values[:1].expand(65, -1, -1),
                                  mask=p.mask[:1].expand(65, -1))
                       for p in packs)
    assert "batch 65" in dec._fused_train_unsupported_reason(65, wide_packs,
                                                             wide)
    dec.fused_train_dtype = "bfloat16"   # the kernels' bf16 storage mode
    assert dec._fused_train_unsupported_reason(2, packs, teacher) is None
    dec.fused_train_dtype = "float32"
    dec.attention_mechanisms[1].attention_kernel = 3   # mixed conv widths
    reason = dec._fused_train_unsupported_reason(2, packs, teacher)
    assert reason is not None and "kernel sizes" in reason
    dec.attention_mechanisms[1].attention_kernel = hp.attention_kernel
    # the capacity reason comes from the kernels' shared-memory plan
    spec = ft.make_spec(dec.fused_train_params(), [p.keys for p in packs],
        [p.values for p in packs], teacher, drop_rate=0.0, zc_att=0.0,
        zo_att=0.0, zc_dec=0.0, zo_dec=0.0, deterministic=False)
    big = spec._replace(a_units=2048, d_units=2048)
    assert "shared-memory plan" in ft.unsupported_reason(big)
    assert max(ft.smem_bytes(big)) > ft.SMEM_LIMIT

    # the training forward takes the plain path and logs its reason once
    # (a storage dtype the kernels do not have)
    dec.fused_train_dtype = "float16"
    with caplog.at_level(logging.WARNING):
        for _ in range(2):
            model.train_forward(_batch(hp))
    logged = [r for r in caplog.records if "decoder_fused_train" in
              r.getMessage()]
    assert len(logged) == 1 and "float16" in logged[0].getMessage()


def _spec(batch, steps, cf, t_mem, u, c, p, a, d, k=10, spk=False):
    return ft.TrainSpec(
        batch=batch, num_steps=steps, cf=cf, t_mem=t_mem, u_sizes=u,
        c_sizes=c, p_sizes=p, p_dropout=(True,) * len(p), use_spk=spk,
        src_kinds=(2, 0), cumulative=(False, False), loc_kernel=k,
        a_units=a, d_units=d, drop_rate=0.5, zc_att=0.1, zo_att=0.1,
        zc_dec=0.1, zo_dec=0.1, deterministic=False)


# the codes recipe's trunk (examples/codes/self-attention-tacotron.json) at
# B = 32, S = 256; the VCTK recipe's (three prenet layers, mel frames, the
# speaker row) at S = 160; this file's tiny widths
PLAN_SPECS = {
    "codes": (_spec(32, 256, 1025, 64, (224, 32), (256, 32), (256, 128),
                    256, 256), (228304, 200416)),
    "vctk": (_spec(32, 160, 80, 64, (224, 32), (256, 32), (256, 256, 128),
                   256, 256, spk=True), (228304, 200416)),
    "tiny": (_spec(B, S, CF, T, U, C, P, A, D, k=4), None),
}


@pytest.mark.parametrize("name", list(PLAN_SPECS))
def test_stash_and_smem_plans_hold_what_the_kernels_need(name):
    """The backward's stash rows carry d_ctx (the values' gradient is
    contracted from it after the loop); the shared-memory plan holds the
    resident slices at the mma-friendly padded strides and the staged rows,
    at the figures the CUDA test reads from the kernels themselves."""
    spec, want = PLAN_SPECS[name]
    Au, Du = spec.a_units, spec.d_units
    sumU, sumC = sum(spec.u_sizes), sum(spec.c_sizes)
    off, width = ft.stash_layout(spec)
    assert list(off) == ["d_gatt", "d_g1", "d_g2", "d_proj", "d_pq", "d_ctx"]
    assert [w for _, w in off.values()] == [4 * Au, 4 * Du, 4 * Du, Du, sumU,
                                           sumC]
    ends = [o + w for o, w in off.values()]
    assert [o for o, _ in off.values()] == [0] + ends[:-1]
    assert width == ends[-1]
    for n in (1, 4, 5, 32, 36, 37, 672, 1024):
        assert ft._pad(n) >= n and ft._pad(n) % 32 == 4 and ft._pad(n) - n < 32
    fwd, bwd = ft.smem_bytes(spec)
    zatt = spec.p_sizes[-1] + sumC + Au
    # at least the staged rows of the widest product (a block stages one
    # of two row groups above 16 rows)
    rows = -(-spec.batch // (2 if spec.batch > 16 else 1))
    assert fwd >= 4 * rows * ft._pad(zatt)
    assert bwd >= 4 * rows * ft._pad(4 * max(Au, Du))
    if want is not None:
        assert (fwd, bwd) == want
        assert all(o % 4 == 0 for o, _ in off.values())  # cp.async rows
        assert max(fwd, bwd) <= ft.SMEM_LIMIT
        assert ft.unsupported_reason(spec) is None
        big = spec._replace(batch=ft.MAX_BATCH)
        assert "shared-memory plan" in ft.unsupported_reason(big)


def test_bf16_plans_hold_the_weight_slices_in_half_the_space():
    """The bf16 storage mode's resident slices hold bf16 pairs (rows of
    ``_pad`` of their 32-bit words): at the codes recipe's trunk the plans
    shrink from 228,304 / 200,416 to 168,912 / 142,560 bytes a block, so
    the batch gate (64 rows) and not the plan bounds the bf16 kernels,
    while f32 fits 46 rows."""
    spec = PLAN_SPECS["codes"][0]
    bf = spec._replace(compute_dtype="bfloat16")
    assert ft.smem_bytes(bf) == (168912, 142560)
    assert ft._wpad(bf, 1025) == ft._pad(513) < ft._wpad(spec, 1025)
    assert ft.unsupported_reason(bf._replace(batch=ft.MAX_BATCH)) is None
    assert ft.unsupported_reason(spec._replace(batch=46)) is None
    assert "shared-memory plan" in ft.unsupported_reason(
        spec._replace(batch=47))
    assert "storage dtype" in ft.unsupported_reason(
        spec._replace(compute_dtype="float16"))
