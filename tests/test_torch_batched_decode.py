"""The fused decode's plain version in its batched, speaker and kind-1
modes against the JAX package's INFERENCE, on CPU.

``fused_decode_reference`` (what ``fused_decode`` runs for CPU tensors,
and what the kernel is held against on the card) through the port's model
with ``decoder_fused_inference``, against the JAX model's scan path, at
tests/test_tacotron_model.py's tiny widths: the counterparts of
tests/test_fused_decode.py's batch-3 flagship, speaker prenet at B = 1 and
B = 3, location-sensitive cumulative, and batched forward attention
cases, with rows of different source lengths (7, 5 and 3), and the
location-sensitive kind without cumulative weights, each at B = 1 and
B = 3; early stop with rows whose stop tokens fire at different steps.
Outputs, stop logits, predicted samples and lengths within 2e-4
(alignments at B = 1; at B > 1 both packages' fused paths return zeros).
Also: sources of two memory lengths against the plain step loop, and the
configuration gate: a batch beyond the kernel's shared-memory plan takes
the plain path with its reason logged, and the largest batch at the
recipes' widths.
"""

import test_torch_threads  # noqa: F401  (bounds torch's threads)
import functools
import logging
import os

import jax
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.models import DecoderMode
from self_attention_tacotron_tpu.models import \
    tacotron_model_factory as jax_factory
from self_attention_tacotron_tpu.models.tacotron import Batch as JaxBatch
from self_attention_tacotron_torch.models import (Batch, decoder,
                                                  tacotron_model_factory)
from self_attention_tacotron_torch.ops import fused_decode as fd
from self_attention_tacotron_torch.utils import convert

from test_torch_cuda import stagger_stop_bias
from test_torch_ops import ROOT, np_tree, tiny_codes_hp

TOL = 2e-4
LENGTHS = (7, 5, 3)
# name: hparams.  Each runs at B = 3 (rows of source lengths 7, 5, 3) and at
# B = 1 (row 0, whose JAX outputs are row 0's of B = 3: rows never mix)
CASES = {
    # tests/test_fused_decode.py:121 (flagship B = 3), :145 and :154
    # (speaker prenet at B = 1 and B = 3)
    "flagship_speaker": {"use_speaker_embedding": True, "num_speakers": 3},
    # :171 (location-sensitive, cumulative)
    "location_cumulative": {"attention": "location_sensitive",
                            "cumulative_weights": True,
                            "attention_kernel": 7, "attention_filters": 4},
    # :179 (forward, batched; kernel 10, 5 filters) beside a
    # location-sensitive source without cumulative weights
    "location_and_forward": {"attention": "location_sensitive",
                             "attention2": "forward",
                             "cumulative_weights": False,
                             "attention_kernel": 10,
                             "attention_filters": 5},
}


def _hp(kw, **extra):
    return tiny_codes_hp(**dict(dict(decoder_early_stop=False), **kw,
                                **extra))


def jax_batch(B, T_in=7, seed=1):
    rng = np.random.default_rng(seed)
    return JaxBatch(
        source=rng.integers(1, 30, (B, T_in)).astype(np.int32),
        source_length=np.array(LENGTHS[:B], np.int32),
        speaker_id=np.array([2, 0, 1][:B], np.int32),
        accent_type=np.zeros((B, T_in), np.int32))


def port_batch(jb):
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return Batch(t(jb.source), t(jb.source_length),
                 speaker_id=t(jb.speaker_id))


@functools.lru_cache(maxsize=None)
def jax_variables(name):
    model = jax_factory(_hp(CASES[name]))
    return np_tree(jax.jit(lambda key, b: model.init(
        {"params": key}, b, DecoderMode.INFERENCE))(
            jax.random.PRNGKey(0), jax_batch(1)))


def jax_inference(hp, variables, jb):
    model = jax_factory(hp)
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda v, b: model.apply(v, b, DecoderMode.INFERENCE))(variables,
                                                                jb))


@functools.lru_cache(maxsize=None)
def jax_case(name):
    return jax_inference(_hp(CASES[name]), jax_variables(name),
                         jax_batch(3))


def port_model(hp, variables):
    model = tacotron_model_factory(hp.replace(decoder_fused_inference=True))
    model.load_state_dict(convert.from_flax(variables), strict=True)
    return model.eval()


def _assert_close(got, ref, B):
    for name in ("outputs", "stop_token"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(ref, name), rtol=TOL, atol=TOL,
                                   err_msg=name)
    for a, b in zip(got.alignments, ref.alignments):
        if B == 1:
            np.testing.assert_allclose(a.numpy(), b, rtol=TOL, atol=TOL)
        else:
            assert bool((a == 0).all())
    np.testing.assert_array_equal(got.predicted_samples.numpy(),
                                  ref.predicted_samples)
    np.testing.assert_array_equal(got.lengths.numpy(), ref.lengths)


def _row0(out):
    return jax.tree_util.tree_map(
        lambda x: x[:1] if isinstance(x, np.ndarray) and x.ndim else x, out)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("name", list(CASES))
def test_fused_reference_matches_jax_inference(name, B, caplog):
    hp, v = _hp(CASES[name]), jax_variables(name)
    ref = jax_case(name)
    if B == 1:
        ref = _row0(ref)
    with caplog.at_level(logging.WARNING, logger=decoder.__name__):
        got = port_model(hp, v)(port_batch(jax_batch(B)))
    assert "using the plain path" not in caplog.text   # the gate let it in
    _assert_close(got, ref, B)


@pytest.mark.parametrize("T_in", [7, 13])
def test_context_fold_at_batch_1_matches_jax_inference(T_in):
    """At B = 1 the fused decode feeds its products the alignment row in
    place of the context, with the values folded into the weights
    (``context_weights``), when the row is no wider than the context: two
    sources of T_in = 7 steps (14 <= 16 + 8 context columns) take the fold,
    T_in = 13 (26 > 24) the context.  Both against the JAX package's
    INFERENCE decode, through the plain version (TOL)."""
    name = "flagship_speaker"
    hp, v = _hp(CASES[name]), jax_variables(name)
    jb = jax_batch(1, T_in=T_in)
    assert fd.context_from_alignments(1, [T_in] * 2, [16, 8]) == (T_in == 7)
    ref = jax_inference(hp, v, jb)
    got = port_model(hp, v)(port_batch(jb))
    _assert_close(got, ref, 1)
    # the fold is exact: the same decode with the context products
    w, memory, opts = _fused_inputs(port_model(hp, v), port_batch(jb))
    vw = fd.context_weights(w, memory.values, [16, 8])
    alpha = torch.rand(1, 2 * T_in)
    ctx = torch.cat([a @ m[0] for a, m in zip(alpha.split(T_in, 1),
                                              memory.values)], 1)
    A = w.att_b.shape[0] // 4
    P = w.att_w.shape[1] - 24 - A
    for full, folded, lead in ((w.att_w, vw[0], P), (w.big_w, vw[1], A)):
        torch.testing.assert_close(folded[:, lead:lead + 2 * T_in] @ alpha[0],
                                   full[:, lead:lead + 24] @ ctx[0],
                                   rtol=1e-5, atol=1e-6)


def _fused_inputs(model, batch):
    """(weights, memory, options) the model hands the fused decode."""
    sources, lens, _, speaker = model._encode(batch)
    dec = model.decoder
    packs = tuple(m.precompute(s, ln) for m, s, ln in
                  zip(dec.attention_mechanisms, sources, lens))
    return dec.fused_inputs(packs, model._prenet_speaker(speaker))


def _stop_weights(variables, direction, bias):
    v = jax.tree_util.tree_map(np.copy, variables)
    stop = v["params"]["decoder"]["stop_token_projection"]
    stop["kernel"] = direction.reshape(stop["kernel"].shape)
    stop["bias"] = np.full_like(stop["bias"], bias)
    return v


def test_early_stop_rows_that_fire_apart_match_jax():
    """B = 3, early stop: the stop head drawn so that the rows fire at
    different steps; every row decodes on its own feedback until the last
    has fired, as the JAX package's while path does."""
    name = "flagship_speaker"
    jb = jax_batch(3)
    direction = np.random.default_rng(5).standard_normal(16).astype(
        np.float32)
    hp = _hp(CASES[name], max_iters=12)
    # logits with a bias that never fires (outputs past a row's length are
    # masked to zero), then the bias that staggers them
    v = _stop_weights(jax_variables(name), direction, -50.0)
    free = port_model(hp, v)(port_batch(jb)).stop_token[..., 0] + 50.0
    v = _stop_weights(v, direction,
                      stagger_stop_bias(free, hp.decoder_min_iters))
    hp = hp.replace(decoder_early_stop=True)
    ref = jax_inference(hp, v, jb)
    lengths = ref.lengths.tolist()
    assert len(set(lengths)) > 1 and max(lengths) < hp.max_iters
    got = port_model(hp, v)(port_batch(jb))
    _assert_close(got, ref, 3)
    for b, n in enumerate(lengths):   # zero past each row's own length
        assert bool((got.outputs[b, n:] == 0).all())


@torch.no_grad()
def test_sources_of_two_memory_lengths_match_the_plain_loop():
    """Each source with its own memory length (5 and 9 steps), B = 1 and
    B = 2: the fused decode's plain version against the decoder's step
    loop on the same sources."""
    hp = _hp({}, max_iters=10)
    model = convert.init_parameters(tacotron_model_factory(hp), 5).eval()
    dec = model.decoder
    rng = np.random.default_rng(2)
    srcs = [torch.from_numpy(rng.standard_normal((2, T, d), np.float32))
            for T, d in ((5, 16), (9, 8))]
    lens = [torch.tensor([5, 3]), torch.tensor([9, 6])]
    for B in (1, 2):
        sources = [s[:B] for s in srcs]
        lengths = [ln[:B] for ln in lens]
        dec.fused_inference = False
        plain = dec(sources, lengths)
        dec.fused_inference = True
        fused = dec(sources, lengths)
        for a, b in ((fused.outputs, plain.outputs),
                     (fused.stop_token, plain.stop_token)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL,
                                       atol=TOL)
        if B == 1:
            for a, b in zip(fused.alignments, plain.alignments):
                assert a.shape == b.shape
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL,
                                           atol=TOL)


def test_batch_beyond_the_kernel_plan_takes_the_plain_path(caplog):
    hp = _hp({})
    model = convert.init_parameters(tacotron_model_factory(
        hp.replace(decoder_fused_inference=True)), 3).eval()
    dec = model.decoder
    w, _, opts = dec.fused_inputs(tuple(
        m.precompute(torch.zeros(1, 7, d), torch.tensor([7]))
        for m, d in zip(dec.attention_mechanisms, (16, 8))))
    limit = fd.max_batch(w, t_sizes=[7, 7], c_sizes=[16, 8],
                         num_steps=hp.max_iters, num_heads=opts["num_heads"])
    decoder._warned_fused_fallback.clear()
    src = torch.from_numpy(np.random.default_rng(0).integers(
        1, 30, (limit + 1, 7)))
    with caplog.at_level(logging.WARNING, logger=decoder.__name__):
        model(Batch(src, torch.full((limit + 1,), 7)))
    assert f"batch {limit + 1}: the kernel's shared-memory plan" \
        in caplog.text


@pytest.mark.parametrize("recipe,T,limit", [
    ("codes", 64, 19), ("vctk", 64, 19), ("vctk", 150, 14)])
def test_largest_batch_at_the_recipe_widths(recipe, T, limit):
    from self_attention_tacotron_torch.config import default_hparams
    hp = default_hparams().parse_json_file(os.path.join(
        ROOT, "examples", recipe, "self-attention-tacotron.json"))
    dec = tacotron_model_factory(hp).decoder
    w = fd.merge_weights(
        dec.fused_params(), num_mels=hp.num_mels,
        outputs_per_step=hp.outputs_per_step, n_feed_frame=hp.n_feed_frame,
        src_kinds=dec._fused_attention_params()[0],
        loc_kernel=dec._loc_kernel())
    c_sizes = [hp.cbhg_out_units, hp.self_attention_out_units]
    plan = dict(num_steps=hp.max_iters,
                num_heads=hp.decoder_self_attention_num_heads)
    assert fd.max_batch(w, t_sizes=[T, T], c_sizes=c_sizes, **plan) == limit
    # at B = 1 the plan counts the folded products' sum T_i columns in
    # place of the context's sum C_i (288) where T_i are short enough
    folded = fd.context_from_alignments(1, [T, T], c_sizes)
    assert folded == (2 * T <= sum(c_sizes))
    one = fd.smem_floats(w, batch=1, t_sizes=[T, T], c_sizes=c_sizes, **plan)
    assert one == fd.smem_floats(w, batch=1, t_sizes=[T, T],
                                 c_sizes=[T, T] if folded else c_sizes,
                                 **plan)
