"""The bf16 storage mode of the fused decode and training kernels against
the JAX package's, on CPU.

The JAX package's ``fused_decode(compute_dtype=bf16)`` and
``fused_teacher_scan(compute_dtype="bfloat16")`` (Pallas kernels in
interpret mode) store weights, keys and values as bf16 and round every
product's input to bf16 with f32 sums; the training VJP rounds the
gradients of those operands to bf16.  The port's plain versions (what its
wrappers run for CPU tensors and hold the kernels against on the card)
reproduce that rounding.  Each case compares, on the same numpy inputs:

* the port's bf16 result with the JAX bf16 result, within a stated
  tolerance; and
* the port's distance from JAX bf16 with JAX bf16's distance from JAX f32:
  at most a tenth of it (relative L2 norms), so a port that quietly stays
  in f32 (distance ~ the whole bf16 effect) fails.

Cases: (a) ``fused_decode`` at B = 1 (the JAX kernel's row path) and
B = 2, an additive and a location-sensitive source and a speaker row;
(b) ``fused_teacher_scan``: y and every gradient; (c) the model's
INFERENCE with ``decoder_fused_inference`` and ``decoder_fused_dtype =
bfloat16``, and the TRAIN loss and gradients with ``decoder_fused_train``
and ``decoder_fused_train_dtype = bfloat16`` (dropout off, zoneout by
expectation: the JAX kernels' in-kernel masks need a TPU).
"""

import test_torch_threads  # noqa: F401  (bounds torch's threads)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.ops import fused_decode as jfd
from self_attention_tacotron_torch.ops import fused_decode as fd

from test_torch_compute_dtype import no_excess

# the port's share of the bf16 effect it may miss (relative L2 norms)
RATIO = 0.1


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _close(got, ref_bf16, tol, name):
    err = _rel(got, ref_bf16)
    assert err <= tol, f"{name}: {err:.3e} from JAX bf16 (> {tol})"


def _check(got, ref_bf16, ref_f32, tol, name):
    """got within ``tol`` (relative L2) of JAX bf16, and its distance at
    most RATIO x JAX bf16's distance from JAX f32."""
    _close(got, ref_bf16, tol, name)
    err, effect = _rel(got, ref_bf16), _rel(ref_bf16, ref_f32)
    assert effect > 0, f"{name}: bf16 changes nothing"
    assert err <= RATIO * effect, (
        f"{name}: {err:.3e} from JAX bf16, > {RATIO} x the bf16 effect "
        f"{effect:.3e}")


# ------------------------------------------------------ (a) fused_decode
MELS, R, K_LOC, STEPS = 4, 2, 5, 12
P0, P1, A, D = 8, 6, 8, 8
U, C = (8, 6), (6, 4)          # an additive and a location-sensitive source
KINDS = ("additive", "location_sensitive")


def decode_case(B, T=7, seed=0):
    """Numpy weights and memory; the location source's conv bias is 0 and
    its location dense the identity, so that both packages' merged (K, U)
    product and key fold are the same numbers."""
    rng = np.random.default_rng(seed)

    def r(*s, scale=0.4):
        return (rng.standard_normal(s) * scale).astype(np.float32)
    hops = ((r(D, D), r(1, D), r(D, D), r(1, D), r(D, D), r(1, D), r(D, D),
             r(1, D), r(D, D), r(1, D)),)
    params = dict(
        prenet=((r(MELS, P0), r(1, P0)), (r(P0, P1), r(1, P1))),
        att_lstm=(r(P1 + sum(C) + A, 4 * A), r(1, 4 * A)),
        query=tuple((r(A, u), r(u, 1, scale=1.0)) for u in U),
        outproj=(r(A + sum(C), D), r(1, D)), lstm1=(r(2 * D, 4 * D),
                                                    r(1, 4 * D)),
        lstm2=(r(2 * D, 4 * D), r(1, 4 * D)), hops=hops,
        head=(r(D, MELS * R + 1), r(1, MELS * R + 1)))
    loc = r(K_LOC, U[1])
    fold = r(U[1])
    keys = [r(B, T, u) for u in U]
    values = [r(B, T, c) for c in C]
    lens = np.array([T, T - 2][:B])
    masks = [(np.arange(T)[None] < lens[:, None]).astype(np.float32)
             for _ in U]
    spk = r(B, P0)
    return params, loc, fold, keys, values, masks, spk


def jax_decode(case, dtype):
    params, loc, fold, keys, values, masks, spk = case
    jp = jfd.FusedDecodeParams(**jax.tree_util.tree_map(
        jnp.asarray, params), loc=(None, jnp.asarray(loc)))
    memory = jfd.FusedDecodeMemory(
        keys=(jnp.asarray(keys[0]), jnp.asarray(keys[1] + fold)),
        values=tuple(map(jnp.asarray, values)),
        masks=tuple(map(jnp.asarray, masks)))
    out, stop, aligns = no_excess(lambda jp, memory, spk: jfd.fused_decode(
        jp, memory, num_steps=STEPS, num_mels=MELS, outputs_per_step=R,
        num_heads=2, zoneout_cell=0.1, zoneout_output=0.1,
        dec_zoneout_cell=0.1, dec_zoneout_output=0.1, compute_dtype=dtype,
        interpret=True, speaker_row=spk, src_kinds=KINDS,
        cumulative=(False, True), loc_kernel=K_LOC), jp, memory,
        jnp.asarray(spk))
    return np.asarray(out), np.asarray(stop), [np.asarray(a) for a in aligns]


def port_decode(case, dtype):
    params, loc, fold, keys, values, masks, spk = case
    t = torch.from_numpy
    tp = fd.FusedDecodeParams(
        **jax.tree_util.tree_map(t, params),
        loc=(None, (t(loc), torch.zeros(U[1]), torch.eye(U[1]), t(fold))))
    w = fd.merge_weights(tp, num_mels=MELS, outputs_per_step=R,
                         src_kinds=KINDS, cumulative=(False, True),
                         loc_kernel=K_LOC, compute_dtype=dtype)
    memory = fd.FusedDecodeMemory(tuple(map(t, keys)),
                                  tuple(map(t, values)),
                                  tuple(map(t, masks)))
    out, stop, aligns = fd.fused_decode(
        w, memory, num_steps=STEPS, num_heads=2, zoneout_cell=0.1,
        zoneout_output=0.1, dec_zoneout_cell=0.1, dec_zoneout_output=0.1,
        speaker_row=t(spk))
    return out.numpy(), stop.numpy(), [a.numpy() for a in aligns]


@pytest.mark.parametrize("B", [1, 2])
def test_fused_decode_bf16_matches_jax(B):
    """Tolerance 2e-3 relative L2 over the 12 steps: both sides round the
    same inputs, their f32 sums differ in order, so a value near a bf16
    rounding boundary may round one ulp apart (2^-8 relative) and feed
    back."""
    case = decode_case(B)
    ref16, ref32 = jax_decode(case, jnp.bfloat16), jax_decode(case,
                                                              jnp.float32)
    got = port_decode(case, "bfloat16")
    for i, name in enumerate(("out", "stop")):
        _check(got[i], ref16[i], ref32[i], 2e-3, name)
    if B == 1:
        for i, (a, b, c) in enumerate(zip(got[2], ref16[2], ref32[2])):
            _check(a, b, c, 2e-3, f"alignments {i}")
    # the f32 mode is unchanged: still the JAX f32 kernel's numbers
    f32 = port_decode(case, "float32")
    np.testing.assert_allclose(f32[0], ref32[0], rtol=2e-4, atol=2e-4)


def test_fused_decode_bf16_weights_and_plan():
    """The bf16 mode stores every matrix as bf16 and rounds the vectors;
    the values are not folded into the weights; the shared-memory plan's
    weight regions halve, so more rows fit."""
    case = decode_case(1)
    params, loc, fold = case[:3]
    t = torch.from_numpy
    tp = fd.FusedDecodeParams(
        **jax.tree_util.tree_map(t, params),
        loc=(None, (t(loc), torch.zeros(U[1]), torch.eye(U[1]), t(fold))))
    kw = dict(num_mels=MELS, outputs_per_step=R, src_kinds=KINDS,
              cumulative=(False, True), loc_kernel=K_LOC)
    w32 = fd.merge_weights(tp, **kw)
    w16 = fd.merge_weights(tp, compute_dtype="bfloat16", **kw)
    assert w16.bf16 and not w32.bf16
    for a, b in ((w16.att_w, w32.att_w), (w16.big_w, w32.big_w),
                 (w16.head_w, w32.head_w), (w16.hops[0][2], w32.hops[0][2])):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b.to(torch.bfloat16))   # merged in f32 first
    for a, b in ((w16.big_b, w32.big_b), (w16.v, w32.v),
                 (w16.p0_init, w32.p0_init)):
        assert a.dtype == torch.float32 and torch.equal(a, fd.round_bf16(b))
    assert torch.equal(w16.key_fold, w32.key_fold)   # joins the keys first
    with pytest.raises(ValueError, match="compute_dtype"):
        fd.merge_weights(tp, compute_dtype="float16", **kw)
    t_sizes, c_sizes = [4, 4], [8, 8]
    assert fd.context_from_alignments(1, t_sizes, c_sizes)
    assert not fd.context_from_alignments(1, t_sizes, c_sizes, bf16=True)
    assert not fd.round_attention_inputs(w16, 1, t_sizes)
    assert fd.round_attention_inputs(w16, 2, t_sizes)
    assert fd.round_attention_inputs(w16, 1, [4, 5])
    assert not fd.round_attention_inputs(w32, 2, t_sizes)
    plan = dict(t_sizes=[7, 7], c_sizes=list(C), num_steps=450, num_heads=2)
    f32 = fd.smem_floats(w32, batch=2, **plan)
    bf = fd.smem_floats(w16, batch=2, **plan)
    assert bf < f32
    assert fd.max_batch(w16, **plan) >= fd.max_batch(w32, **plan)


# ----------------------------------------------- (b) fused_teacher_scan
from self_attention_tacotron_tpu.ops import fused_train as jft  # noqa: E402
from self_attention_tacotron_torch.ops import fused_train as ft  # noqa: E402
from test_torch_fused_train import CASES as TRAIN_CASES  # noqa: E402
from test_torch_fused_train import _kw, _weights, make_case  # noqa: E402

_map = jax.tree_util.tree_map


def jax_train(case, dtype):
    """y and the gradients of sum(y * c) w.r.t. params, keys, values, the
    speaker row and the location products (JAX, interpret mode)."""
    kinds, cum, K, spk, zone = TRAIN_CASES[case]
    params, keys, values, masks, teacher, spk_row, loc_ws = make_case(
        kinds, cum, K, spk)
    kw = _kw(kinds, cum, K, zone)

    def run(p, k, v, s, lw):
        y, _ = jft.fused_teacher_scan(
            jft.FusedTrainParams(*p), k, v, masks, jnp.asarray(teacher),
            jnp.int32(0), speaker_row=s, loc_ws=lw, save_align=True,
            interpret=True, compute_dtype=dtype, **kw)
        return y
    args = (_map(jnp.asarray, tuple(params)), _map(jnp.asarray, keys),
            _map(jnp.asarray, values),
            None if spk_row is None else jnp.asarray(spk_row),
            _map(jnp.asarray, loc_ws))
    c = jnp.asarray(_weights(jax.eval_shape(run, *args)))
    y, grads = no_excess(lambda *a: (run(*a), jax.grad(
        lambda *b: jnp.sum(run(*b) * c), argnums=(0, 1, 2, 3, 4))(*a)),
        *args)
    return np.asarray(y), [np.asarray(g) for g in
                           jax.tree_util.tree_leaves(grads)]


def port_train(case, dtype):
    kinds, cum, K, spk, zone = TRAIN_CASES[case]
    params, keys, values, masks, teacher, spk_row, loc_ws = make_case(
        kinds, cum, K, spk)
    t = lambda x: (None if x is None  # noqa: E731
                   else torch.from_numpy(x).requires_grad_())
    tp = ft.FusedTrainParams(*_map(t, tuple(params)))
    tk, tv = _map(t, keys), _map(t, values)
    ts, lw = t(spk_row), _map(t, loc_ws)
    y, _ = ft.fused_teacher_scan(
        tp, tk, tv, _map(torch.from_numpy, masks), torch.from_numpy(teacher),
        0, speaker_row=ts, loc_ws=lw, compute_dtype=dtype,
        **_kw(kinds, cum, K, zone))
    leaves = jax.tree_util.tree_leaves((tuple(tp), tk, tv, ts, lw))
    c = torch.from_numpy(_weights(y.detach().numpy()))
    grads = torch.autograd.grad((y * c).sum(), leaves)
    return y.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_fused_teacher_scan_bf16_matches_jax(case):
    """y within 1e-3 and every gradient within 5e-3 (relative L2) of the
    JAX package's bf16 mode: its f32 sums run in another order, so a
    product or a saved gate near a bf16 rounding boundary rounds one ulp
    apart now and then; and at most a tenth of the bf16 effect each."""
    y16, g16 = jax_train(case, "bfloat16")
    y32, g32 = jax_train(case, "float32")
    y, g = port_train(case, "bfloat16")
    _check(y, y16, y32, 1e-3, "y")
    assert len(g) == len(g16) == len(g32)
    for i, (a, b, c) in enumerate(zip(g, g16, g32)):
        _check(a.reshape(b.shape), b, c, 5e-3, f"gradient leaf {i}")


# ------------------------------------------------------ (c) the model
from self_attention_tacotron_tpu.models import DecoderMode  # noqa: E402
from self_attention_tacotron_tpu.models import \
    compute_loss as jax_loss  # noqa: E402
from self_attention_tacotron_tpu.models import \
    tacotron_model_factory as jax_factory  # noqa: E402
from self_attention_tacotron_torch.models import (  # noqa: E402
    Batch, compute_loss, tacotron_model_factory)
from self_attention_tacotron_torch.utils import convert  # noqa: E402
from test_tacotron_model import make_batch  # noqa: E402
from test_torch_ops import jit_init, np_tree, tiny_codes_hp  # noqa: E402
from test_torch_train_step import port_batch, train_hp  # noqa: E402


def _infer_hp(dtype):
    return tiny_codes_hp(decoder_early_stop=False,
                         decoder_fused_inference=True,
                         decoder_fused_dtype=dtype)


@functools.lru_cache(maxsize=None)
def _jax_variables(train: bool):
    """The JAX model's variables, drawn once for both storage dtypes (the
    dtype adds no variable and changes none)."""
    hp = train_hp(decoder_fused_train=True) if train else _infer_hp(
        "float32")
    batch = (make_batch(hp, B=2, T_in=7, T_out=6) if train
             else make_batch(hp, B=1))
    return np_tree(jit_init(jax_factory(hp), {"params": jax.random.PRNGKey(0)},
                            batch, mode=DecoderMode.VALIDATION,
                            teacher_forcing=True))


def _jax_model_inference(B, dtype):
    hp = _infer_hp(dtype)
    model = jax_factory(hp)
    v = _jax_variables(False)
    jb = make_batch(hp, B=B, T_in=7, seed=1)._replace(target=None,
                                                      done=None)
    out = no_excess(lambda v, jb: model.apply(v, jb, DecoderMode.INFERENCE),
                    v, jb)
    return v, jb, jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("B", [1, 2])
def test_model_inference_bf16_matches_jax(B):
    """INFERENCE through both models' fused decode in the bf16 mode (the
    port's plain version on CPU): outputs and stop logits within 2e-3
    (relative L2), alignments at B = 1, and at most a tenth of the bf16
    effect; the gate lets the mode through (no plain-path fallback)."""
    v, jb, ref16 = _jax_model_inference(B, "bfloat16")
    _, _, ref32 = _jax_model_inference(B, "float32")
    model = tacotron_model_factory(_infer_hp("bfloat16")).eval()
    model.load_state_dict(convert.from_flax(v), strict=True)
    assert model.decoder._fused_unsupported_reason(B) is None
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    with torch.no_grad():
        got = model(Batch(t(jb.source), t(jb.source_length)))
    assert model.decoder._merged[1].bf16
    for name in ("outputs", "stop_token"):
        _check(getattr(got, name).numpy(), getattr(ref16, name),
               getattr(ref32, name), 2e-3, name)
    if B == 1:
        for i, (a, b, c) in enumerate(zip(got.alignments, ref16.alignments,
                                          ref32.alignments)):
            _check(a.numpy(), b, c, 2e-3, f"alignments {i}")


def _jax_model_train(dtype):
    hp = train_hp(decoder_fused_train=True,
                  decoder_fused_train_dtype=dtype)
    batch = make_batch(hp, B=2, T_in=7, T_out=6)
    model = jax_factory(hp)
    v = _jax_variables(True)

    def loss(params):
        out, _ = model.apply({"params": params,
                              "batch_stats": v["batch_stats"]}, batch,
                             DecoderMode.TRAIN,
                             rngs={"dropout": jax.random.PRNGKey(1),
                                   "zoneout": jax.random.PRNGKey(2)},
                             mutable=["batch_stats"])
        return jax_loss(hp, out, batch, params)["loss"], out

    (l, out), g = no_excess(jax.value_and_grad(loss, has_aux=True),
                            v["params"])
    return v, batch, float(l), np.asarray(out.outputs), np_tree(g)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def test_model_train_bf16_loss_and_gradients_match_jax():
    """TRAIN with ``decoder_fused_train`` in the bf16 mode (dropout and
    zoneout off: the JAX kernels' in-kernel masks need a TPU), the port's
    plain version with its reverse-time VJP on CPU: the loss within 1e-4,
    the outputs within 2e-3 and every gradient within 5e-3 (relative L2)
    of the JAX package's; the outputs and all gradients together at most a
    tenth of the bf16 effect.  (A small leaf alone can miss that ratio: a
    few of its elements round one bf16 ulp apart after an upstream
    summation-order difference, which the leaf's norm does not average
    out; the kernel-level test holds each leaf to it.)"""
    v, jb, l16, out16, g16 = _jax_model_train("bfloat16")
    _, _, l32, out32, g32 = _jax_model_train("float32")
    model = tacotron_model_factory(train_hp(
        decoder_fused_train=True, decoder_fused_train_dtype="bfloat16"))
    model.load_state_dict(convert.from_flax(v), strict=True)
    model.train()
    batch = port_batch(jb)
    out = model.train_forward(batch)
    losses = compute_loss(model.hp, out, batch, model)
    losses["loss"].backward()
    assert abs(float(losses["loss"]) - l16) <= 1e-4 * abs(l16)
    _check(out.outputs.detach().numpy(), out16, out32, 2e-3, "outputs")
    got = _leaves(convert.to_flax(
        {k: p.grad for k, p in model.named_parameters()}, model)["params"])
    ref16, ref32 = _leaves(g16), _leaves(g32)
    assert got.keys() == ref16.keys()
    for name in ref16:
        if "key_projection" in name and "bias" in name:
            continue     # exactly zero: rounding noise on both sides
        _close(got[name], ref16[name], 5e-3, name)
    keep = sorted(k for k in ref16 if not ("key_projection" in k
                                           and "bias" in k))
    cat = lambda d: np.concatenate([d[k].ravel() for k in keep])  # noqa
    _check(cat(got), cat(ref16), cat(ref32), 5e-3, "all gradients")
