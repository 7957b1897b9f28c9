"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Marked ``cuda``; each test skips when there is no CUDA device.  Small
configurations that the recipe run in chip_smoke.py does not cover: odd
and even bank widths, the adjustment dense, two hops, three prenet
layers, r = 2, additive-only sources, cumulative location weights, early
stop.  This file imports no JAX, so on a machine without it run

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance 1e-4 (float32 both sides, TF32 off; the sums run in another
order than the plain version's matmuls).
"""

import os

import numpy as np
import pytest
import torch

from self_attention_tacotron_torch.config import default_hparams
from self_attention_tacotron_torch.models import Batch, tacotron_model_factory
from self_attention_tacotron_torch.ops import fused_decode as fd
from self_attention_tacotron_torch.ops import fused_encoder as fe
from self_attention_tacotron_torch.utils.convert import init_parameters

pytestmark = pytest.mark.cuda

TOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(num_symbols=30, embedding_dim=16, num_mels=10, cbhg_out_units=16,
            conv_channels=8, max_filter_width=4, projection1_out_channels=8,
            projection2_out_channels=8, encoder_prenet_out_units=(16, 8),
            self_attention_out_units=8, attention1_out_units=8,
            attention2_out_units=8, attention_out_units=12,
            decoder_prenet_out_units=(8, 4), decoder_out_units=16,
            decoder_self_attention_out_units=16, max_iters=30,
            decoder_min_iters=2, attention="forward", attention_kernel=4,
            decoder_version="v2", decoder_early_stop=False)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _model(device, seed=0, **kw):
    hp = default_hparams()
    for k, v in dict(TINY, **kw).items():
        hp.set_hparam(k, v)
    model = init_parameters(tacotron_model_factory(hp), seed)
    return model.to(device).eval()


def _source(T, L, device, seed=0):
    src = np.zeros((1, T), np.int64)
    src[0, :L] = np.random.default_rng(seed).integers(1, 30, L)
    return torch.from_numpy(src).to(device)


def _enc_case(model, T, L, device):
    enc = model.encoder
    x = model.embedding(_source(T, L, device))
    kw = dict(max_filter_width=enc.max_filter_width,
              conv_channels=enc.conv_channels, half=enc.cbhg_out_units // 2,
              sa_units=enc.self_attention_out_units,
              num_heads=enc.self_attention_num_heads,
              zoneout_cell=enc.zoneout_factor_cell,
              zoneout_output=enc.zoneout_factor_output)
    return enc.fused_params(), x, kw


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("kw,T,L", [
    ({}, 32, 32),
    ({}, 32, 13),
    ({"max_filter_width": 5, "cbhg_out_units": 24,
      "self_attention_num_hop": 2}, 40, 29),
])
@torch.no_grad()
def test_fused_encode_kernel_matches_plain(device, kw, T, L):
    params, x, kwargs = _enc_case(_model(device, **kw), T, L, device)
    before = fe.fused_encode.launches
    got = fe.fused_encode(params, x, L, **kwargs)
    ref = fe.fused_encode_reference(params, x, L, **kwargs)
    torch.cuda.synchronize()
    assert fe.fused_encode.launches == before + 1
    for g, r in zip(got, ref):
        _close(g, r)
    assert bool((got[0][0, L:] == 0).all())


def _dec_case(model, T, L, device):
    params, x, kw = _enc_case(model, T, L, device)
    lstm_out, sa = fe.fused_encode_reference(params, x, L, **kw)
    lengths = torch.tensor([L], device=device)
    dec = model.decoder
    packs = tuple(m.precompute(s, lengths)
                  for m, s in zip(dec.attention_mechanisms, (lstm_out, sa)))
    return dec.fused_inputs(packs)


@pytest.mark.parametrize("kw", [
    {},
    {"decoder_self_attention_num_hop": 2,
     "decoder_prenet_out_units": (8, 6, 4), "outputs_per_step": 2},
    {"attention": "additive"},
    {"cumulative_weights": True, "attention_kernel": 5},
    {"decoder": "DualSourceDecoder", "decoder_version": "v1"},
], ids=["recipe_mechanisms", "hops2_prenet3_r2", "additive", "cumulative",
        "no_hops"])
@torch.no_grad()
def test_fused_decode_kernel_matches_plain(device, kw):
    model = _model(device, seed=1, **kw)
    weights, memory, options = _dec_case(model, 24, 17, device)
    S = model.hp.max_iters
    before = fd.fused_decode.launches
    got = fd.fused_decode(weights, memory, num_steps=S, **options)
    ref = fd.fused_decode_reference(weights, memory, num_steps=S, **options)
    torch.cuda.synchronize()
    assert fd.fused_decode.launches == before + 1
    for g, r in zip(got[:2], ref[:2]):
        _close(g, r)
    for g, r in zip(got[2], ref[2]):
        _close(g, r)


@torch.no_grad()
def test_long_memory_kernels_match_plain(device):
    """A memory longer than a block's 256 threads and 32-step hop chunks
    that end mid-chunk (T = 288, L = 270, 45 steps)."""
    model = _model(device, seed=5, max_iters=45)
    params, x, kw = _enc_case(model, 288, 270, device)
    for g, r in zip(fe.fused_encode(params, x, 270, **kw),
                    fe.fused_encode_reference(params, x, 270, **kw)):
        _close(g, r)
    weights, memory, options = _dec_case(model, 288, 270, device)
    got = fd.fused_decode(weights, memory, num_steps=45, **options)
    ref = fd.fused_decode_reference(weights, memory, num_steps=45, **options)
    for g, r in zip((*got[:2], *got[2]), (*ref[:2], *ref[2])):
        _close(g, r)


@torch.no_grad()
def test_fused_decode_early_stop_matches_plain(device):
    model = _model(device, seed=2)
    weights, memory, options = _dec_case(model, 16, 16, device)
    head_b = weights.head_b.clone()
    head_b[weights.cr] += 5.0   # the stop logit fires after min_iters
    weights = weights._replace(head_b=head_b)
    options = dict(options, early_stop=True)
    got = fd.fused_decode(weights, memory, num_steps=30, **options)
    ref = fd.fused_decode_reference(weights, memory, num_steps=30, **options)
    torch.cuda.synchronize()
    _close(got[0], ref[0])
    stop = got[1][0].cpu().numpy()
    exit_step = options["min_iters"] + 1
    assert stop[exit_step] > 0 and not stop[exit_step + 1:].any()


@torch.no_grad()
def test_model_serves_through_both_kernels(device):
    """The codes model on cuda: the fused path launches both kernels and
    agrees with the plain module path."""
    outs = []
    counts = []
    for fused in (False, True):
        model = _model(device, seed=3, encoder_fused_inference=fused,
                       decoder_fused_inference=fused)
        fe.fused_encode.launches = fd.fused_decode.launches = 0
        outs.append(model(Batch(_source(32, 21, device),
                                torch.tensor([21], device=device))))
        counts.append((fe.fused_encode.launches, fd.fused_decode.launches))
    assert counts == [(0, 0), (1, 1)]
    _close(outs[1].outputs, outs[0].outputs)
    _close(outs[1].stop_token, outs[0].stop_token)
    assert torch.equal(outs[1].lengths, outs[0].lengths)


def test_wrappers_reject_what_the_kernels_do_not_take(device):
    model = _model(device)
    params, x, kw = _enc_case(model, 16, 16, device)
    with pytest.raises(ValueError):
        fe.fused_encode(params, x.double(), 16, **kw)
    with pytest.raises(ValueError):
        fe.fused_encode(params, x, 17, **kw)      # length past T
