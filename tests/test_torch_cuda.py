"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Marked ``cuda``; each test skips when there is no CUDA device.  Small
configurations that the recipe run in chip_smoke.py does not cover: odd
and even bank widths, the adjustment dense, two hops, three prenet
layers, r = 2, additive-only sources, cumulative location weights, early
stop; the Pallas-mode attention kernels at small and recipe shapes (head
widths 4 to 128, T not a multiple of 64, t at both ends of the cache; the
full-sequence kernel at the edges of its 16-row warp tiles, with 4-byte
copies, at T = 3000, with |q.k| ~ 1e3, its plan and its profile) and
the model's serving and VALIDATION decodes in that mode; the spectrogram
kernel from the signal at F = 1, a prime F, LJSpeech and VCTK widths and
signals shorter than the reflect pad, and the mel model's decode (one source, no hops, r = 2) through the
fused decode; the fused decode's speaker row, batched rows (per-row memory
lengths, sources of different lengths, early stop with rows that fire
apart) and location-sensitive sources, and its shared-memory plan.  This file imports
no JAX, so on a machine without it run

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance 1e-4 (float32 both sides, TF32 off; the sums run in another
order than the plain version's matmuls).  The bf16 storage mode of the
decode and training kernels against their plain bf16 versions: both round
the same inputs to bf16, but a value whose f32 sum lands near a bf16
rounding boundary rounds one ulp (2^-8 relative) apart now and then, and
the recurrence carries it on, so: the decode within 5e-3 over its first 10
steps and 5e-2 over all 30, finite, and the same code argmax at >= 90 % of
the frames; the training forward within 1e-2 and each gradient within
1e-2 of its largest magnitude.
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
    np.testing.assert_allclose(a.detach().cpu().numpy(),
                               b.detach().cpu().numpy(), rtol=tol, atol=tol)


# the encoder widths of the codes and VCTK recipes (examples/{codes,vctk}/
# self-attention-tacotron.json leave them at the defaults; VCTK differs in
# its symbol table only)
RECIPE_ENC = dict(embedding_dim=256, encoder_prenet_out_units=(256, 128),
                  cbhg_out_units=256, conv_channels=128, max_filter_width=16,
                  projection1_out_channels=128, projection2_out_channels=128,
                  self_attention_out_units=32)


@pytest.mark.parametrize("kw,T,L", [
    ({}, 32, 32),
    ({}, 32, 13),
    ({"max_filter_width": 5, "cbhg_out_units": 24,
      "self_attention_num_hop": 2}, 40, 29),
    ({}, 32, 1),
    (RECIPE_ENC, 64, 1),
    (RECIPE_ENC, 64, 64),
    (RECIPE_ENC, 64, 50),
    (RECIPE_ENC, 70, 33),
    (RECIPE_ENC, 100, 77),     # two 64-row tiles
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


# configurations the encoder kernel takes since it was widened: widths that
# are not multiples of 4 (the 4-byte copies), an odd LSTM half, 129 and 256
# units a direction (the 16-block cluster), more prenet, highway and hop
# layers than its earlier fixed arrays held
WIDE_ENC = {
    "odd_widths": dict(embedding_dim=18, encoder_prenet_out_units=(22, 10),
                       conv_channels=6, projection1_out_channels=7,
                       projection2_out_channels=10,
                       self_attention_out_units=10),
    "H7": dict(cbhg_out_units=14),
    "H129": dict(cbhg_out_units=258),
    "H256": dict(cbhg_out_units=512),
    "layers": dict(encoder_prenet_out_units=(16, 12, 8, 8, 8), num_highway=9,
                   self_attention_num_hop=5),
}


@pytest.mark.parametrize("kw,T", [({}, 32), (RECIPE_ENC, 64),
                                  ({"max_filter_width": 5,
                                    "cbhg_out_units": 24}, 40),
                                  (RECIPE_ENC, 600),
                                  (WIDE_ENC["odd_widths"], 40),
                                  (WIDE_ENC["H129"], 40),
                                  (WIDE_ENC["layers"], 40)])
def test_encode_smem_plan_matches_the_kernel(device, kw, T):
    import ctypes
    params, x, kwargs = _enc_case(_model(device, **kw), T, T, device)
    launch = fe.prepare_encode(params, x, T, **kwargs)
    lib = fe._lib()
    got = tuple(int(lib.fused_encoder_smem_bytes(ctypes.byref(launch.args),
                                                 which)) for which in (0, 1))
    a = launch.args
    assert got == fe.smem_bytes(T, a.E_in,
                                tuple(int(w.shape[1]) for w, _ in
                                      params.prenet),
                                a.K, a.C, a.P1, a.P2, a.W, a.H, a.SA,
                                a.n_heads)


@pytest.mark.parametrize("name,T,L", [
    ("odd_widths", 40, 33), ("H7", 40, 40), ("H129", 70, 51),
    ("H256", 40, 40), ("layers", 70, 64)])
@torch.no_grad()
def test_widened_encoder_matches_plain(device, name, T, L):
    """Each instance the widening added against the plain version: the
    4-byte copies (odd widths, an odd H), the 16-block cluster (H > 128),
    the layer table (5 prenet layers, 9 highway layers, 5 hops)."""
    kw = WIDE_ENC[name]
    params, x, kwargs = _enc_case(_model(device, **kw), T, L, device)
    launch = fe.prepare_encode(params, x, L, **kwargs)
    H = kwargs["half"]
    assert launch.args.v4 == (name in ("H256", "layers"))
    assert fe.dir_blocks(H) == (8 if H > 128 else 4)
    before = fe.fused_encode.launches
    got = launch()
    ref = fe.fused_encode_reference(params, x, L, **kwargs)
    torch.cuda.synchronize()
    assert fe.fused_encode.launches == before + 1
    for g, r in zip(got, ref):
        _close(g, r[0], 1e-5)
    assert bool((got[0][L:] == 0).all())


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


@pytest.mark.parametrize("T,L", [(8, 8), (12, 9), (24, 17)])
@torch.no_grad()
def test_fused_decode_context_fold_matches_plain(device, T, L):
    """B = 1 with the values folded into the products' weights (two
    sources of T = 8 or 12 steps against 16 + 8 context columns: no
    context stage) and without (T = 24); the kernel's shared-memory plan
    against ``smem_floats`` either way."""
    model = _model(device, seed=3)
    weights, memory, options = _dec_case(model, T, L, device)
    t_sizes = [k.shape[1] for k in memory.keys]
    c_sizes = [v.shape[2] for v in memory.values]
    assert fd.context_from_alignments(1, t_sizes, c_sizes) == (T < 24)
    S = model.hp.max_iters
    got = fd.fused_decode(weights, memory, num_steps=S, **options)
    ref = fd.fused_decode_reference(weights, memory, num_steps=S, **options)
    for g, r in zip((*got[:2], *got[2]), (*ref[:2], *ref[2])):
        _close(g, r)
    assert fd.smem_floats(weights, batch=1, t_sizes=t_sizes,
                          c_sizes=c_sizes, num_steps=S,
                          num_heads=options["num_heads"]) == \
        fd.kernel_smem_floats(weights, memory, num_steps=S, **options)


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


# ---------------- the fused decode's speaker, batched and kind-1 modes

def _rows_case(model, lengths, device, T=24, seed=0):
    """(weights, memory, options) of a batch of sources with per-row
    lengths through the model's module encoder, with the speaker row when
    the model has speakers (speaker ids 0, 1, 2, ...)."""
    B = len(lengths)
    src = np.zeros((B, T), np.int64)
    rng = np.random.default_rng(seed)
    for b, L in enumerate(lengths):
        src[b, :L] = rng.integers(1, 30, L)
    batch = Batch(torch.from_numpy(src).to(device),
                  torch.tensor(lengths, device=device),
                  speaker_id=torch.arange(B, device=device))
    sources, lens, _, speaker = model._encode(batch)
    dec = model.decoder
    packs = tuple(m.precompute(s, ln) for m, s, ln in
                  zip(dec.attention_mechanisms, sources, lens))
    return dec.fused_inputs(packs, model._prenet_speaker(speaker))


def stagger_stop_bias(stop, min_iters):
    """A stop-logit bias at which every row fires past ``min_iters``, the
    rows at as many different steps as can be and the last as late as can
    be before the last two steps (the stop logit feeds nothing back, so a
    bias shifts it exactly).  The threshold sits midway between two
    neighbouring logits, away from both."""
    late = stop[:, min_iters + 1:].detach().cpu().double()
    run = late.cummax(1).values
    vals = torch.unique(late.flatten())
    best = ((0, 0), None)
    for lo, hi in zip(vals[:-1].tolist(), vals[1:].tolist()):
        if hi - lo < 1e-5:
            continue
        theta = 0.5 * (lo + hi)
        fired = run > theta
        if not bool(fired.any(1).all()):
            continue
        steps = fired.int().argmax(1).tolist()
        if max(steps) >= late.shape[1] - 2:   # the loop must exit early
            continue
        key = (len(set(steps)), max(steps))   # spread, then a late exit
        if key > best[0]:
            best = (key, theta)
    return -best[1]


def staggered_stop(weights, memory, options, num_steps, seed=0):
    """``weights`` with the stop head's row drawn from ``seed`` and the bias
    of ``stagger_stop_bias`` (random weights give near-flat stop logits
    that cross any threshold together)."""
    head_w, head_b = weights.head_w.clone(), weights.head_b.clone()
    g = torch.Generator().manual_seed(seed)
    head_w[weights.cr] = torch.randn(head_w.shape[1], generator=g).to(
        head_w.device)
    head_b[weights.cr] = 0.0
    weights = weights._replace(head_w=head_w, head_b=head_b)
    free = fd.fused_decode_reference(weights, memory, num_steps=num_steps,
                                     **dict(options, early_stop=False))
    head_b[weights.cr] = stagger_stop_bias(free[1], options["min_iters"])
    return weights


def _first_fire(stop, min_iters):
    fired = stop > 0
    fired[:, :min_iters + 1] = False
    return [int(f.nonzero()[0]) if f.any() else -1 for f in fired]


ROW_CASES = {
    # (model options, row lengths)
    "speaker_b1": ({"use_speaker_embedding": True, "num_speakers": 3}, [17]),
    "speaker_b3": ({"use_speaker_embedding": True, "num_speakers": 3},
                   [24, 13, 19]),
    "batched_b8_recipe": ({}, [24, 20, 17, 9, 24, 11, 15, 22]),
    "location_b1": ({"attention": "location_sensitive"}, [21]),
    "location_cum_b4": ({"attention": "location_sensitive",
                         "cumulative_weights": True}, [24, 18, 7, 12]),
    "hops2_prenet3_b5": ({"decoder_self_attention_num_hop": 2,
                          "decoder_prenet_out_units": (8, 6, 4),
                          "outputs_per_step": 2}, [24, 3, 16, 10, 20]),
}


@pytest.mark.parametrize("case", list(ROW_CASES))
@torch.no_grad()
def test_fused_decode_row_modes_match_plain(device, case):
    kw, lengths = ROW_CASES[case]
    model = _model(device, seed=7, **kw)
    weights, memory, options = _rows_case(model, lengths, device)
    S = model.hp.max_iters
    before = fd.fused_decode.launches
    got = fd.fused_decode(weights, memory, num_steps=S, **options)
    ref = fd.fused_decode_reference(weights, memory, num_steps=S, **options)
    torch.cuda.synchronize()
    assert fd.fused_decode.launches == before + 1
    for g, r in zip((*got[:2], *got[2]), (*ref[:2], *ref[2])):
        _close(g, r)
    if len(lengths) > 1:
        assert all(bool((a == 0).all()) for a in got[2])


@torch.no_grad()
def test_fused_decode_sources_of_two_memory_lengths(device):
    """B = 1 and B = 2 with the sources' memories of different lengths
    (40 and 64 steps); padded steps of the shorter rows stay out of the
    softmax."""
    model = _model(device, seed=8)
    weights, memory, options = _rows_case(model, [24, 17], device)
    rng = np.random.default_rng(1)
    lens = ((40, 29), (64, 51))
    keys, values, masks = [], [], []
    for (k, v), (T, L) in zip(zip(memory.keys, memory.values), lens):
        keys.append(torch.from_numpy(rng.standard_normal(
            (2, T, k.shape[2]), np.float32)).to(device))
        values.append(torch.from_numpy(rng.standard_normal(
            (2, T, v.shape[2]), np.float32)).to(device))
        m = torch.zeros(2, T, device=device)
        m[0, :L], m[1, :T - 3] = 1.0, 1.0
        masks.append(m)
    for B in (1, 2):
        mem = fd.FusedDecodeMemory(tuple(k[:B] for k in keys),
                                   tuple(v[:B] for v in values),
                                   tuple(m[:B] for m in masks))
        got = fd.fused_decode(weights, mem, num_steps=30, **options)
        ref = fd.fused_decode_reference(weights, mem, num_steps=30,
                                        **options)
        for g, r in zip((*got[:2], *got[2]), (*ref[:2], *ref[2])):
            _close(g, r)


@torch.no_grad()
def test_fused_decode_batched_early_stop_rows_fire_apart(device):
    """B = 6, early stop: rows fire at different steps, every row decodes
    on its own feedback until all have fired, the steps after read 0."""
    model = _model(device, seed=9)
    weights, memory, options = _rows_case(model, [24, 5, 18, 11, 20, 9],
                                          device)
    S = model.hp.max_iters
    weights = staggered_stop(weights, memory, options, S)
    options = dict(options, early_stop=True)
    got = fd.fused_decode(weights, memory, num_steps=S, **options)
    ref = fd.fused_decode_reference(weights, memory, num_steps=S, **options)
    fire = _first_fire(ref[1].cpu(), options["min_iters"])
    assert min(fire) >= 0 and len(set(fire)) > 1 and max(fire) < S - 1
    _close(got[0], ref[0])
    _close(got[1], ref[1])
    assert bool((got[0][:, max(fire) + 1:] == 0).all())


@pytest.mark.parametrize("case", ["speaker_b3", "batched_b8_recipe"])
def test_decode_smem_plan_matches_the_kernel(device, case):
    kw, lengths = ROW_CASES[case]
    model = _model(device, **kw)
    weights, memory, options = _rows_case(model, lengths, device)
    S = model.hp.max_iters
    plan = fd.smem_floats(
        weights, batch=len(lengths),
        t_sizes=[k.shape[1] for k in memory.keys],
        c_sizes=[v.shape[2] for v in memory.values], num_steps=S,
        num_heads=options["num_heads"])
    assert plan == fd.kernel_smem_floats(weights, memory, num_steps=S,
                                         **options)


BF16_DECODE_CASES = {
    # (model options, row lengths): B = 1 two sources; batched with the
    # speaker row; location-sensitive at B = 1 (the f32 query path)
    "recipe_mechanisms_b1": ({}, [17]),
    "speaker_b3": ({"use_speaker_embedding": True, "num_speakers": 3},
                   [24, 13, 19]),
    "location_b1": ({"attention": "location_sensitive"}, [21]),
}


def _bf16_decode_close(got, ref, head=10):
    for g, r in zip((*got[:2], *got[2]), (*ref[:2], *ref[2])):
        assert bool(g.isfinite().all())
        _close(g[:, :head], r[:, :head], tol=5e-3)
        _close(g, r, tol=5e-2)
    agree = float((got[0].argmax(-1) == ref[0].argmax(-1)).float().mean())
    assert agree >= 0.9


@pytest.mark.parametrize("case", list(BF16_DECODE_CASES))
@torch.no_grad()
def test_fused_decode_bf16_kernel_matches_plain(device, case):
    """The bf16 instance of the decode kernel (bf16 weight slices, keys
    and values) against the plain bf16 version; one launch."""
    kw, lengths = BF16_DECODE_CASES[case]
    model = _model(device, seed=7, decoder_fused_dtype="bfloat16", **kw)
    weights, memory, options = _rows_case(model, lengths, device)
    assert weights.bf16 and weights.att_w.dtype == torch.bfloat16
    S = model.hp.max_iters
    before = fd.fused_decode.launches
    got = fd.fused_decode(weights, memory, num_steps=S, **options)
    ref = fd.fused_decode_reference(weights, memory, num_steps=S, **options)
    torch.cuda.synchronize()
    assert fd.fused_decode.launches == before + 1
    _bf16_decode_close(got, ref)


@pytest.mark.parametrize("case", ["speaker_b3", "batched_b8_recipe"])
def test_decode_bf16_smem_plan_matches_the_kernel(device, case):
    """The bf16 mode's shared-memory plan (weight regions of two bf16 a
    float) against the kernel's own dec_smem; it is smaller than f32's."""
    kw, lengths = ROW_CASES[case]
    model = _model(device, decoder_fused_dtype="bfloat16", **kw)
    weights, memory, options = _rows_case(model, lengths, device)
    S = model.hp.max_iters
    shape = dict(batch=len(lengths),
                 t_sizes=[k.shape[1] for k in memory.keys],
                 c_sizes=[v.shape[2] for v in memory.values], num_steps=S,
                 num_heads=options["num_heads"])
    plan = fd.smem_floats(weights, **shape)
    assert plan == fd.kernel_smem_floats(weights, memory, num_steps=S,
                                         **options)
    f32 = _model(device, **kw)
    w32, _, _ = _rows_case(f32, lengths, device)
    assert plan < fd.smem_floats(w32, **shape)


@torch.no_grad()
def test_fused_decode_f32_instance_unchanged(device):
    """The f32 instance still gives the plain f32 version's numbers at the
    f32 tolerance, and the bf16 mode's output differs from it (the modes
    are two instances, not one path)."""
    kw, lengths = ROW_CASES["speaker_b3"]
    outs = []
    for dtype in ("float32", "bfloat16"):
        model = _model(device, seed=7, decoder_fused_dtype=dtype, **kw)
        weights, memory, options = _rows_case(model, lengths, device)
        S = model.hp.max_iters
        outs.append((fd.fused_decode(weights, memory, num_steps=S,
                                     **options),
                     fd.fused_decode_reference(weights, memory, num_steps=S,
                                               **options)))
    (g32, r32), (g16, _) = outs
    torch.cuda.synchronize()
    for g, r in zip(g32[:2], r32[:2]):
        _close(g, r)
    assert float((g16[0] - g32[0]).abs().max()) > 1e-4


@torch.no_grad()
def test_model_serves_a_batch_through_the_kernel(device):
    """The speaker codes model at B = 4 on cuda: one fused decode launch,
    the same outputs as the plain module path."""
    outs, counts = [], []
    src = torch.from_numpy(np.random.default_rng(4).integers(
        1, 30, (4, 24))).to(device)
    for fused in (False, True):
        model = _model(device, seed=10, decoder_fused_inference=fused,
                       use_speaker_embedding=True, num_speakers=4)
        fd.fused_decode.launches = 0
        outs.append(model(Batch(src, torch.tensor([24, 9, 17, 21],
                                                  device=device),
                                speaker_id=torch.tensor([3, 0, 1, 2],
                                                        device=device))))
        counts.append(fd.fused_decode.launches)
    assert counts == [0, 1]
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
    # a source 4 bytes past 16-byte alignment and a width that is not a
    # multiple of 4 are taken, by the instance with 4-byte copies
    flat = torch.zeros(x.numel() + 1, device=device)
    shifted = flat[1:].view_as(x).copy_(x)
    assert fe.prepare_encode(params, shifted, 16, **kw).args.v4 == 0
    for g, r in zip(fe.fused_encode(params, shifted, 16, **kw),
                    fe.fused_encode_reference(params, x, 16, **kw)):
        _close(g, r)
    odd, xo, kwo = _enc_case(_model(device, embedding_dim=18), 16, 16, device)
    for g, r in zip(fe.fused_encode(odd, xo, 16, **kwo),
                    fe.fused_encode_reference(odd, xo, 16, **kwo)):
        _close(g, r)
    wide, xw, kww = _enc_case(_model(device, cbhg_out_units=514), 16, 16,
                              device)
    with pytest.raises(ValueError, match="cluster"):
        fe.fused_encode(wide, xw, 16, **kww)
    weights, memory, options = _rows_case(model, [16], device)
    big = fd.FusedDecodeMemory(*(tuple(t.expand(300, *t.shape[1:])
                                       for t in part) for part in memory))
    with pytest.raises(ValueError, match="shared-memory plan"):
        fd.fused_decode(weights, big, num_steps=30, **options)


# ------------------------------------------------------- training kernels

from self_attention_tacotron_torch.ops import fused_train as ft  # noqa: E402

TRAIN_CASES = {
    # (source kinds, cumulative, K, deterministic, speaker row)
    "fwd_add_k10_masks": (("forward", "additive"), (False, False), 10,
                          False, False),
    "loc_fwd_k5_cum_det": (("location_sensitive", "forward"), (True, True),
                           5, True, False),
    "fwd_fwd_k4_masks_spk": (("forward", "forward"), (False, True), 4, False,
                             True),
    "add_add_k4_masks": (("additive", "additive"), (False, False), 4, False,
                         False),
}


# Shapes at the edges of the kernels' tensor-core tiles (16-row and 8-column
# mma tiles, 128 x 64 weight-gradient tiles, 32-unit attention items):
# B = 20 is no multiple of 16, the widths no multiple of 8, U = 36 leaves a
# 4-unit item; and the recipe's B = 32 with T = 64 memory steps.
EDGE_CASES = {
    "edge_b20_masks": dict(B=20, S=5, T=33, U=(36, 12), C=(40, 8), A=40,
                           D=24, det=False),
    "edge_b20_det": dict(B=20, S=5, T=33, U=(36, 12), C=(40, 8), A=40, D=24,
                         det=True),
    "b32_t64_masks": dict(B=32, S=4, T=64, det=False),
    "b32_t64_det": dict(B=32, S=4, T=64, det=True),
}


def train_case(device, kinds, cum, K, det, spk, B=3, S=6, T=9, seed=0,
               U=(6, 4), C=(5, 3), A=7, D=5):
    """Random trunk weights and inputs (numpy seed) for the training
    kernels, at small widths."""
    rng = np.random.default_rng(seed)
    CF, P = 11, (8, 6)

    def r(*s):
        return torch.from_numpy(
            (rng.standard_normal(s) * 0.3).astype(np.float32)).to(device)
    params = ft.FusedTrainParams(
        prenet=((r(CF, P[0]), r(1, P[0])), (r(P[0], P[1]), r(1, P[1]))),
        att_lstm=(r(P[1] + sum(C) + A, 4 * A), r(1, 4 * A)),
        query=tuple((r(A, u), r(u, 1)) for u in U),
        outproj=(r(A + sum(C), D), r(1, D)),
        lstm1=(r(2 * D, 4 * D), r(1, 4 * D)),
        lstm2=(r(2 * D, 4 * D), r(1, 4 * D)))
    keys = tuple(r(B, T, u) for u in U)
    values = tuple(r(B, T, c) for c in C)
    lens = torch.tensor([T, T - 3, T - 1][:B] + [T] * max(0, B - 3),
                        device=device)
    masks = tuple((torch.arange(T, device=device)[None] < lens[:, None])
                  .float() for _ in U)
    teacher = r(B, S, CF)
    loc_ws = tuple(r(K, u) if k != "additive" else None
                   for k, u in zip(kinds, U))
    kw = dict(drop_rate=0.5, zc_att=0.1, zo_att=0.1, zc_dec=0.1, zo_dec=0.1,
              deterministic=det, src_kinds=kinds, cumulative=cum,
              loc_kernel=K)
    return params, keys, values, masks, teacher, (r(B, P[0]) if spk
                                                  else None), loc_ws, kw


@pytest.mark.parametrize("case", list(TRAIN_CASES))
@torch.no_grad()
def test_fused_train_kernels_match_plain(device, case):
    _check_train_kernels(device, *train_case(device, *TRAIN_CASES[case]))


@pytest.mark.parametrize("case", list(EDGE_CASES))
@torch.no_grad()
def test_fused_train_kernels_at_tile_edges(device, case):
    """Forward within 1e-4, each gradient within 1e-3 of its largest
    magnitude (the tolerances of chip_smoke.py at the recipe shape)."""
    kw = dict(EDGE_CASES[case])
    det = kw.pop("det")
    _check_train_kernels(device, *train_case(
        device, ("forward", "location_sensitive"), (False, True), 10, det,
        True, seed=3, **kw), grad_tol=1e-3)


def _check_train_kernels(device, params, keys, values, masks, teacher, spk,
                         loc_ws, kw, grad_tol=None, fwd_tol=TOL):
    """Both training kernels against their plain versions; the forward at
    ``fwd_tol``, gradients at TOL, or with ``grad_tol`` within grad_tol of
    each one's largest magnitude."""
    spec = ft.make_spec(params, keys, values, teacher, use_spk=spk is not None,
                        **kw)
    S, B = spec.num_steps, spec.batch
    tf = teacher.transpose(0, 1).reshape(S * B, spec.cf).contiguous()
    ops = ft.train_operands(spec, params, keys, values, masks, tf, spk,
                            loc_ws)
    before = (ft.fused_train_fwd.launches, ft.fused_train_bwd.launches)
    y, save, aux = ft.fused_train_fwd(spec, ops, 11)
    y_r, save_r, aux_r = ft.fused_train_fwd_reference(
        spec, params, keys, values, masks, tf, 11, spk, loc_ws)
    torch.cuda.synchronize()
    _close(y, y_r, fwd_tol)
    _close(save, save_r, fwd_tol)
    _close(aux, aux_r, fwd_tol)
    g = torch.randn(y.shape, generator=torch.Generator(device).manual_seed(1),
                    device=device)
    raw = ft.fused_train_bwd(spec, ops, 11, g, save_r, aux_r)
    torch.cuda.synchronize()
    assert (ft.fused_train_fwd.launches, ft.fused_train_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    (d_pre, d_att, d_q, d_op, d_l1, d_l2, d_keys, d_values, d_v, d_loc,
     d_spk) = ft.split_grads(spec, raw)
    dp, dk, dv, dspk, dloc = ft.fused_train_bwd_reference(
        spec, params, keys, values, masks, tf, 11, spk, loc_ws, g, save_r,
        aux_r)
    pairs = [(a, b) for (wa, ba), (wb, bb) in zip(d_pre, dp.prenet)
             for a, b in ((wa, wb), (ba, bb))]
    pairs += [(d_att[0], dp.att_lstm[0]), (d_att[1], dp.att_lstm[1]),
              (d_op[0], dp.outproj[0]), (d_op[1], dp.outproj[1]),
              (d_l1[0], dp.lstm1[0]), (d_l1[1], dp.lstm1[1]),
              (d_l2[0], dp.lstm2[0]), (d_l2[1], dp.lstm2[1]),
              (d_q, torch.cat([q for q, _ in dp.query], 1)),
              (d_v, torch.cat([v[:, 0] for _, v in dp.query]))]
    pairs += [(a, b.reshape(a.shape)) for a, b in zip(d_keys, dk)]
    pairs += [(a, b.reshape(a.shape)) for a, b in zip(d_values, dv)]
    u_off = np.cumsum([0, *spec.u_sizes])
    for i, lw in enumerate(dloc):
        if lw is not None:
            pairs.append((d_loc[:, u_off[i]:u_off[i + 1]], lw))
    if dspk is not None:
        pairs.append((d_spk, dspk))
    for a, b in pairs:
        _close(a, b.reshape(a.shape), tol=TOL if grad_tol is None else
               grad_tol * max(float(b.abs().max()), 1e-30))


@pytest.mark.parametrize("case", ["fwd_add_k10_masks", "fwd_fwd_k4_masks_spk",
                                  "loc_fwd_k5_cum_det"])
@torch.no_grad()
def test_fused_train_bf16_kernels_match_plain(device, case):
    """The bf16 storage mode of both training kernels against the plain
    bf16 versions: forward within 1e-2, each gradient within 1e-2 of its
    largest magnitude (see the module docstring)."""
    params, keys, values, masks, teacher, spk, loc_ws, kw = train_case(
        device, *TRAIN_CASES[case])
    _check_train_kernels(device, params, keys, values, masks, teacher, spk,
                         loc_ws, dict(kw, compute_dtype="bfloat16"),
                         grad_tol=1e-2, fwd_tol=1e-2)


def test_fused_train_bf16_at_tile_edges_and_plan(device):
    """B = 20 and widths off the tiles in the bf16 mode; the bf16 plans
    (slices of bf16 pairs) against the kernels' own."""
    kw = dict(EDGE_CASES["edge_b20_masks"])
    kw.pop("det")
    case = train_case(device, ("forward", "location_sensitive"),
                      (False, True), 10, False, True, seed=3, **kw)
    params, keys, values, masks, teacher, spk, loc_ws, tkw = case
    tkw = dict(tkw, compute_dtype="bfloat16")
    _check_train_kernels(device, params, keys, values, masks, teacher, spk,
                         loc_ws, tkw, grad_tol=1e-2, fwd_tol=1e-2)
    spec = ft.make_spec(params, keys, values, teacher, use_spk=True, **tkw)
    tf = teacher.transpose(0, 1).reshape(-1, spec.cf).contiguous()
    a = ft._args(spec, ft.train_operands(spec, params, keys, values, masks,
                                         tf, spk, loc_ws), 0, [])
    import ctypes
    got = tuple(int(getattr(ft._lib(n), f"{n}_smem_bytes")(
        ctypes.byref(a), 132)) for n in ("fused_train_fwd",
                                         "fused_train_bwd"))
    assert got == ft.smem_bytes(spec, 132)
    f32 = ft.smem_bytes(spec._replace(compute_dtype="float32"), 132)
    assert got[0] < f32[0] and got[1] < f32[1]


def test_fused_train_autograd_launches_both_kernels(device):
    """fused_teacher_scan on CUDA: one forward and one backward launch, and
    the gradients of autograd over the plain version on the CPU."""
    outs = []
    for dev in (torch.device("cpu"), device):
        params, keys, values, masks, teacher, spk, loc_ws, kw = train_case(
            dev, *TRAIN_CASES["fwd_add_k10_masks"])
        leaves = [t.requires_grad_() for t in
                  (*[x for p in params.prenet for x in p], *params.att_lstm,
                   *keys, *values, *[lw for lw in loc_ws if lw is not None])]
        before = (ft.fused_train_fwd.launches, ft.fused_train_bwd.launches)
        y, aligns = ft.fused_teacher_scan(params, keys, values, masks,
                                          teacher, 5, loc_ws=loc_ws, **kw)
        grads = torch.autograd.grad(y.square().sum(), leaves)
        after = (ft.fused_train_fwd.launches, ft.fused_train_bwd.launches)
        outs.append((y, aligns, grads, after[0] - before[0],
                     after[1] - before[1]))
    (y_c, al_c, g_c, *n_c), (y_g, al_g, g_g, *n_g) = outs
    assert n_c == [0, 0] and n_g == [1, 1]
    _close(y_g, y_c)
    for a, b in zip(al_g, al_c):
        _close(a, b)
    for a, b in zip(g_g, g_c):
        _close(a, b, tol=1e-3 * max(float(b.abs().max()), 1.0))


def test_train_smem_plan_matches_the_kernels(device):
    params, keys, values, masks, teacher, spk, loc_ws, kw = train_case(
        device, *TRAIN_CASES["fwd_add_k10_masks"])
    spec = ft.make_spec(params, keys, values, teacher, **kw)
    tf = teacher.transpose(0, 1).reshape(-1, spec.cf).contiguous()
    a = ft._args(spec, ft.train_operands(spec, params, keys, values, masks,
                                         tf, None, loc_ws), 0, [])
    import ctypes
    got = tuple(int(getattr(ft._lib(n), f"{n}_smem_bytes")(
        ctypes.byref(a), 132)) for n in ("fused_train_fwd",
                                         "fused_train_bwd"))
    assert got == ft.smem_bytes(spec, 132)


def test_train_wrappers_reject_what_the_kernels_do_not_take(device):
    params, keys, values, masks, teacher, spk, loc_ws, kw = train_case(
        device, *TRAIN_CASES["fwd_add_k10_masks"])
    with pytest.raises(ValueError):
        ft.fused_teacher_scan(params, keys, values, masks, teacher.double(),
                              0, loc_ws=loc_ws, **kw)
    with pytest.raises(ValueError):   # 65 rows a step
        big = train_case(device, *TRAIN_CASES["fwd_add_k10_masks"], B=65)
        ft.fused_teacher_scan(*big[:5], 0, loc_ws=big[6], **big[7])
    with pytest.raises(ValueError):   # a location conv wider than 32 taps
        wide = train_case(device, ("forward", "additive"), (False, False),
                          33, False, False)
        ft.fused_teacher_scan(*wide[:5], 0, loc_ws=wide[6], **wide[7])


# ------------------------------------------- Pallas-mode attention kernels

from self_attention_tacotron_torch.ops import pallas_attention as pa  # noqa: E402


def _normal(device, *shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)).to(device)


@pytest.mark.parametrize("B,H,T,D,causal", [
    (2, 2, 37, 16, False), (2, 2, 37, 16, True), (1, 2, 64, 16, False),
    (3, 2, 130, 64, True), (1, 1, 5, 4, True), (2, 2, 70, 24, False),
    (32, 2, 250, 128, False), (32, 2, 250, 128, True),
    # the edges of the 16-row warp tiles and 8-key products at D = 16
    *[(1, 2, T, 16, c) for T in (1, 15, 16, 17, 61) for c in (False, True)],
    (8, 2, 64, 16, False),        # the batched encoder's hop
    (1, 2, 3000, 128, True),      # the longest decode: 94 key tiles
    (2, 1, 45, 30, True), (1, 2, 33, 5, False)])   # 4-byte copies
@torch.no_grad()
def test_fused_self_attention_kernel_matches_plain(device, B, H, T, D,
                                                   causal):
    q, k, v = (_normal(device, B, H, T, D, seed=s) for s in range(3))
    before = pa.fused_self_attention.launches
    got = pa.fused_self_attention(q, k, v, causal)
    ref = pa.fused_self_attention_reference(q, k, v, causal)
    torch.cuda.synchronize()
    assert pa.fused_self_attention.launches == before + 1
    _close(got, ref, tol=1e-5)


def large_scores(device, B, H, T, D, seed=0):
    """q, k of small integers with a shared column of 32 (|q.k| ~ 1e3,
    exact in float32 and in the 3xTF32 split) and v normal: the running max
    moves by hundreds between tiles and exp without it overflows."""
    rng = np.random.default_rng(seed)
    q, k = (rng.integers(-16, 17, (B, H, T, D)).astype(np.float32)
            for _ in range(2))
    q[..., 0] = k[..., 0] = 32.0
    v = rng.standard_normal((B, H, T, D)).astype(np.float32)
    return (torch.from_numpy(x).to(device) for x in (q, k, v))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B", [2, 32])     # 4 warps split the keys; 1 warp
@torch.no_grad()
def test_fused_self_attention_kernel_keeps_large_scores(device, causal, B):
    q, k, v = large_scores(device, B, 2, 200, 16)
    got = pa.fused_self_attention(q, k, v, causal)
    ref = pa.fused_self_attention_reference(q, k, v, causal)
    torch.cuda.synchronize()
    assert got.isfinite().all()
    _close(got, ref, tol=1e-5)


@pytest.mark.parametrize("D", [1, 16, 24, 64, 100, 128])
@pytest.mark.parametrize("B", [1, 32])     # 4 warps split the keys; 1 warp
def test_attention_plan_matches_the_kernel(device, D, B):
    plan = pa.attention_plan(B, 2, 256, D, False)
    assert pa.kernel_plan(D, plan.key_warps) == (plan.keys, plan.stages,
                                                 plan.smem_bytes)


@torch.no_grad()
def test_fused_self_attention_profile_splits_the_stages(device):
    q, k, v = (_normal(device, 4, 2, 256, 128, seed=s) for s in range(3))
    launch = pa.prepare_attention(q, k, v, True, profile=True)
    got = launch()
    torch.cuda.synchronize()
    cycles = launch.stage_cycles.cpu().tolist()
    assert len(cycles) == len(pa.ATTN_STAGES) and min(cycles) > 0
    _close(got, pa.fused_self_attention_reference(q, k, v, True), tol=1e-5)


@pytest.mark.parametrize("B,H,S,D", [(1, 2, 250, 128), (32, 2, 250, 128),
                                     (2, 2, 24, 8), (1, 2, 3000, 16)])
@torch.no_grad()
def test_incremental_step_kernel_matches_plain(device, B, H, S, D):
    kc, vc = _normal(device, B, H, S, D, seed=1), _normal(device, B, H, S, D,
                                                          seed=2)
    for t in (0, S // 2, S - 1):
        q = _normal(device, B, H, D, seed=3 + t)
        before = pa.incremental_attention_step.launches
        got = pa.incremental_attention_step(q, kc, vc, t)
        ref = pa.incremental_attention_step_reference(q, kc, vc, t)
        torch.cuda.synchronize()
        assert pa.incremental_attention_step.launches == before + 1
        _close(got, ref, tol=1e-5)


P = pa.STEP_CHUNK


@pytest.mark.parametrize("D", [16, 30, 128, 256])
@pytest.mark.parametrize("B,H", [(1, 1), (1, 2), (32, 2)])
@torch.no_grad()
def test_incremental_step_kernel_at_chunk_edges(device, B, H, D):
    """t at the chunk edges (one chunk, two with one position in the
    second, the cache's end); D = 30 takes the scalar loads."""
    S = 3 * P + 5
    kc, vc = _normal(device, B, H, S, D, seed=1), _normal(device, B, H, S, D,
                                                          seed=2)
    for t in (0, P - 1, P, P + 1, S - 1):
        q = _normal(device, B, H, D, seed=3 + t)
        got = pa.incremental_attention_step(q, kc, vc, t)
        ref = pa.incremental_attention_step_reference(q, kc, vc, t)
        torch.cuda.synchronize()
        _close(got, ref, tol=1e-5)


@torch.no_grad()
def test_incremental_step_counters_reset_between_calls(device):
    """Calls with different t (so different chunk counts) queued on one
    stream without a sync between them: each merge sees only its own
    chunks, because the last chunk leaves its ticket word at 0; and a base
    that is not 16-byte aligned takes the scalar loads."""
    B, H, S, D = 2, 2, 300, 128
    kc, vc = _normal(device, B, H, S, D, seed=1), _normal(device, B, H, S, D,
                                                          seed=2)
    ts = (S - 1, 40, 3 * P, 0, S - 1, 2 * P + 7)
    qs = [_normal(device, B, H, D, seed=10 + i) for i in range(len(ts))]
    outs = [pa.incremental_attention_step(q, kc, vc, t)
            for q, t in zip(qs, ts)]
    torch.cuda.synchronize()
    for q, t, got in zip(qs, ts, outs):
        _close(got, pa.incremental_attention_step_reference(q, kc, vc, t),
               tol=1e-5)
    flat = _normal(device, 2 * B * H * S * D + 1, seed=4)
    ko = flat[1:1 + B * H * S * D].view(B, H, S, D)     # 4-byte offset
    vo = flat[1 + B * H * S * D:].view(B, H, S, D)
    assert ko.data_ptr() % 16 and ko.is_contiguous()
    got = pa.incremental_attention_step(qs[0], ko, vo, S - 1)
    _close(got, pa.incremental_attention_step_reference(qs[0], ko, vo,
                                                        S - 1), tol=1e-5)


def test_pallas_wrappers_reject_what_the_kernels_do_not_take(device):
    q = _normal(device, 1, 2, 8, 16)
    with pytest.raises(ValueError):
        pa.fused_self_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError):   # non-contiguous
        t = q.transpose(2, 3)
        pa.fused_self_attention(t, t, t)
    with pytest.raises(ValueError):   # head width past the wide kernel's
        w = _normal(device, 1, 2, 8, pa.MAX_HEAD_DIM + 8)
        pa.fused_self_attention(w, w, w)
    with pytest.raises(ValueError):   # no backward
        g = q.clone().requires_grad_()
        with torch.enable_grad():
            pa.fused_self_attention(g, g, g)
    cache = _normal(device, 1, 2, 8, 16)
    with pytest.raises(ValueError):
        pa.incremental_attention_step(q[:, :, 0], cache, cache, 8)   # t = S
    with pytest.raises(ValueError):
        pa.incremental_attention_step(q[:, :, 0].double(), cache, cache, 0)
    with pytest.raises(ValueError):   # non-contiguous cache
        pa.incremental_attention_step(q[:, :, 0], cache.transpose(0, 1),
                                      cache, 0)
    with pytest.raises(ValueError):   # B * H past the grid's 65535
        many = _normal(device, 1, 65536, 2, 4)
        pa.incremental_attention_step(many[:, :, 0], many, many, 1)


@torch.no_grad()
def test_model_serves_and_validates_in_pallas_mode(device):
    """The Pallas mode launches fused_self_attention once a serving call
    (the encoder's hop) and incremental_attention_step once a decode step
    (one decoder hop); its outputs agree with the einsum path, in serving
    and in both VALIDATION passes."""
    models = [_model(device, seed=3, use_pallas_attention=p)
              for p in (False, True)]
    batch = Batch(_source(32, 21, device), torch.tensor([21], device=device))
    pa.fused_self_attention.launches = 0
    pa.incremental_attention_step.launches = 0
    outs = [m(batch) for m in models]
    assert (pa.fused_self_attention.launches,
            pa.incremental_attention_step.launches) == (1, 30)
    _close(outs[1].outputs, outs[0].outputs)
    assert not outs[1].decoder_self_attention_alignments[0].any()
    src = torch.cat([_source(32, 21, device), _source(32, 21, device, 1)])
    target = torch.nn.functional.one_hot(torch.from_numpy(
        np.random.default_rng(4).integers(0, 10, (2, 12))), 10).float()
    vbatch = Batch(src, torch.tensor([21, 17], device=device),
                   target=target.to(device))
    for tf in (False, True):
        pa.incremental_attention_step.launches = 0
        got, ref = (m.validation_forward(vbatch, tf) for m in models[::-1])
        assert pa.incremental_attention_step.launches == 12
        _close(got.outputs, ref.outputs)
        _close(got.stop_token, ref.stop_token)


# ------------------------------------------------------- spectrogram kernel
TOL_MAG = 2e-5   # |mag - plain| over the frame's peak (tests/test_torch_stft.py)
TOL_DB = 1e-2    # dB within 60 dB of the frame's peak, above -80 dB


def _db_errors(got_db, ref_db):
    """(max magnitude error over the frame's peak, max dB error where the
    plain version is within 60 dB of its frame's peak and above -80 dB) of
    (F, bins) dB tensors."""
    got = got_db.double().cpu()
    ref = ref_db.double().cpu()
    mg, mr = 10.0 ** (got / 20.0), 10.0 ** (ref / 20.0)
    peak = mr.amax(1, keepdim=True).clamp(min=1e-5)
    loud = (ref > -80.0) & (ref > ref.amax(1, keepdim=True) - 60.0)
    db_err = float((got - ref).abs()[loud].max()) if bool(loud.any()) else 0.0
    return float(((mg - mr).abs() / peak).max()), db_err


def _plan(n_fft, mels, device, sr=22050):
    from self_attention_tacotron_torch.ops import stft as S
    from self_attention_tacotron_torch.utils.audio import (hann_window,
                                                           mel_filterbank)
    return S.spectrogram_plan(mel_filterbank(sr, n_fft, mels),
                              hann_window(n_fft // 2, n_fft), n_fft // 4,
                              device)


@pytest.mark.parametrize("F,n_fft,mels", [
    (1, 2048, 80), (37, 2048, 80), (65, 128, 8), (33, 256, 8),
    (802, 2048, 80), (97, 4096, 80)])
@torch.no_grad()
def test_spectrogram_kernel_matches_plain(device, F, n_fft, mels):
    """From the signal: F = 1 (a signal shorter than the reflect pad), a
    prime, 65 and 33 frames, 10 s at LJSpeech widths, VCTK's n_fft (log2
    of n_fft / 2 even and odd); noise with a quiet stretch near the
    floor."""
    from self_attention_tacotron_torch.ops import stft as S
    plan = _plan(n_fft, mels, device)
    T = (F - 1) * plan.hop_length + plan.hop_length // 2
    rng = np.random.default_rng(F)
    y = (0.1 * rng.standard_normal(T)).astype(np.float32)
    y[T // 3:T // 3 + n_fft] *= 1e-4
    y = torch.from_numpy(y).to(device)
    before = S.spectrograms.launches
    got = S.spectrograms(y, plan)
    ref = S.spectrograms_plain(y, plan)
    torch.cuda.synchronize()
    assert S.spectrograms.launches == before + 1
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.shape[0] == F
        mag_err, db_err = _db_errors(g, r)
        assert mag_err < TOL_MAG and db_err < TOL_DB, (mag_err, db_err)


@pytest.mark.parametrize("T", [1, 2, 300, 1023])
@torch.no_grad()
def test_spectrogram_kernel_folds_short_signals(device, T):
    """Signals shorter than the pad (n_fft / 2 = 1024) are reflected again
    by the kernel's own index arithmetic, as numpy does."""
    from self_attention_tacotron_torch.ops import stft as S
    plan = _plan(2048, 80, device)
    y = torch.from_numpy((0.3 + 0.1 * np.random.default_rng(T)
                          .standard_normal(T)).astype(np.float32)).to(device)
    got, ref = S.spectrograms(y, plan), S.spectrograms_plain(y, plan)
    for g, r in zip(got, ref):
        mag_err, db_err = _db_errors(g, r)
        assert mag_err < TOL_MAG and db_err < TOL_DB, (mag_err, db_err)


@torch.no_grad()
def test_mel_extractor_on_the_card_matches_the_cpu(device):
    from self_attention_tacotron_torch.ops import stft as S
    args = (22050, 1025, 80, 50.0, 12.5, 20.0)
    y = (0.1 * np.random.default_rng(0).standard_normal(30000)).astype(
        np.float32)
    got = S.MelExtractor(*args, device=device).spectrograms(y)
    ref = S.MelExtractor(*args, device="cpu").spectrograms(y)
    for g, r in zip(got, ref):
        mag_err, db_err = _db_errors(g.T + 20.0, r.T + 20.0)
        assert mag_err < TOL_MAG and db_err < TOL_DB, (mag_err, db_err)


def test_spectrogram_wrapper_rejects_what_the_kernel_does_not_take(device):
    from self_attention_tacotron_torch.ops import stft as S
    plan = _plan(128, 8, device)
    y = torch.ones(500, device=device)
    with pytest.raises(ValueError):
        S.spectrograms(y.double(), plan)
    with pytest.raises(ValueError):
        S.spectrograms(y[None], plan)
    with pytest.raises(ValueError):
        S.spectrograms(y[::2], plan)
    with pytest.raises(ValueError):
        S.spectrograms(y[:0], plan)
    with pytest.raises(ValueError):
        S.spectrograms(y, plan._replace(window=plan.window[:64]))
    with pytest.raises(ValueError):     # past the direct DFT's 32768
        S.spectrograms(y, _plan(S.MAX_DFT + 2, 8, device))


MEL = dict(tacotron_model="ExtendedTacotronV1Model",
           encoder="ZoneoutEncoderV1", decoder="ExtendedDecoder",
           use_zoneout_at_encoder=True, outputs_per_step=2, num_mels=8,
           attention_kernel=10, attention_filters=5)


@torch.no_grad()
def test_mel_model_serves_through_fused_decode(device):
    """The mel recipe's decode (one forward source, no hops, r = 2) through
    the fused decode kernel agrees with its plain module path."""
    outs, counts = [], []
    for fused in (False, True):
        model = _model(device, seed=6, decoder_fused_inference=fused,
                       use_postnet_v2=True, num_postnet_v2_layers=2,
                       postnet_v2_out_channels=8, **MEL)
        fd.fused_decode.launches = 0
        outs.append(model(Batch(_source(32, 21, device),
                                torch.tensor([21], device=device))))
        counts.append(fd.fused_decode.launches)
    assert counts == [0, 1]
    for name in ("outputs", "stop_token", "postnet_outputs"):
        _close(getattr(outs[1], name), getattr(outs[0], name))
    _close(outs[1].alignments[0], outs[0].alignments[0])
    assert torch.equal(outs[1].lengths, outs[0].lengths)


# ----------------------- the kernels at the edges of their earlier plans

@torch.no_grad()
@pytest.mark.parametrize("T,launches", [(533, 1), (534, 1), (600, 1)])
def test_encoder_gate_at_the_plan_edge_on_the_card(device, T, launches):
    """The recipe's encoder widths: up to T = 533 the hop's rows sit in
    shared memory, past it the kernel streams them; both launch the kernel
    and match the module path.  A configuration the kernel refuses raises
    on the card."""
    model = _model(device, seed=5, encoder_fused_inference=True,
                   **RECIPE_ENC)
    enc = model.encoder
    x = model.embedding(_source(T, T, device, seed=T))
    fe.fused_encode.launches = 0
    got = enc(x, torch.tensor([T], device=device))
    assert fe.fused_encode.launches == launches
    assert fe.hop_streams(T, enc.cbhg_out_units // 2,
                          enc.self_attention_out_units) == (T > 533)
    enc.fused_inference = False
    ref = enc(x, torch.tensor([T], device=device))
    for g, r in zip(got[:2], ref[:2]):
        _close(g, r)
    with pytest.raises(ValueError, match="divide"):
        fe.fused_encode(enc.fused_params(), x, T,
                        max_filter_width=enc.max_filter_width,
                        conv_channels=enc.conv_channels,
                        half=enc.cbhg_out_units // 2,
                        sa_units=enc.self_attention_out_units, num_heads=3)


@torch.no_grad()
@pytest.mark.parametrize("D", [128, 129, 257])
def test_pallas_gates_at_the_head_width_edges_on_the_card(device, D):
    """Head widths past the tensor-core templates (D > 128) and past the
    step's registers (D > 256) launch the wide kernels and match the
    einsum path; past 1024 the full-sequence wrapper raises."""
    from self_attention_tacotron_torch.ops import attention_core as ac
    from self_attention_tacotron_torch.ops import pallas_attention as pa
    torch.manual_seed(D)
    mha = ac.MultiHeadAttention(2 * D, 2, use_subsequent_mask=True,
                                use_pallas=True).to(device).eval()
    ref = ac.MultiHeadAttention(2 * D, 2, use_subsequent_mask=True).to(
        device).eval()
    ref.load_state_dict(mha.state_dict())
    x = _normal(device, 1, 40, 2 * D, seed=D)
    pa.fused_self_attention.launches = 0
    pa.incremental_attention_step.launches = 0
    _close(mha(x, x, x)[0], ref(x, x, x)[0], tol=1e-5)
    cache, cache_r = mha.init_cache(1, 40, device), ref.init_cache(1, 40,
                                                                  device)
    for t in range(40):
        y, cache, _ = mha.step(x[:, t], t, cache)
        y_r, cache_r, _ = ref.step(x[:, t], t, cache_r)
        _close(y, y_r, tol=1e-5)
    assert pa.fused_self_attention.launches == 1
    assert pa.incremental_attention_step.launches == 40
    q = _normal(device, 1, 2, 8, pa.MAX_HEAD_DIM + 1)
    with pytest.raises(ValueError, match="head width"):
        pa.fused_self_attention(q, q, q)


@torch.no_grad()
@pytest.mark.parametrize("D,T,causal", [(129, 1, False), (129, 70, True),
                                        (200, 33, False), (1024, 40, True),
                                        (300, 250, False)])
def test_wide_self_attention_kernel_matches_plain(device, D, T, causal):
    from self_attention_tacotron_torch.ops import pallas_attention as pa
    q, k, v = (_normal(device, 2, 2, T, D, seed=s) for s in range(3))
    before = pa.fused_self_attention.launches
    got = pa.fused_self_attention(q, k, v, causal)
    assert pa.fused_self_attention.launches == before + 1
    _close(got, pa.fused_self_attention_reference(q, k, v, causal),
           tol=1e-5)


@torch.no_grad()
@pytest.mark.parametrize("D,S,t", [(257, 40, 0), (257, 40, 39),
                                   (1000, 300, 250), (2050, 70, 65)])
def test_wide_step_kernel_matches_plain(device, D, S, t):
    from self_attention_tacotron_torch.ops import pallas_attention as pa
    q = _normal(device, 2, 2, D, seed=0)
    kc, vc = (_normal(device, 2, 2, S, D, seed=s) for s in (1, 2))
    before = pa.incremental_attention_step.launches
    got = pa.incremental_attention_step(q, kc, vc, t)
    assert pa.incremental_attention_step.launches == before + 1
    _close(got, pa.incremental_attention_step_reference(q, kc, vc, t),
           tol=1e-5)


@torch.no_grad()
@pytest.mark.parametrize("num_freq", [1025, 1000])      # n_fft 2048, 1998
def test_mel_extractor_gate_on_the_card(device, num_freq):
    """A power-of-two n_fft takes the kernel's FFT, any other its direct
    DFT: both launch and match the plain version."""
    from self_attention_tacotron_torch.ops import stft as S
    args = (22050, num_freq, 80, 50.0, 12.5, 20.0)
    y = (0.1 * np.random.default_rng(1).standard_normal(30000)).astype(
        np.float32)
    S.spectrograms.launches = 0
    got = S.MelExtractor(*args, device=device).spectrograms(y)
    assert S.spectrograms.launches == 1
    ref = S.MelExtractor(*args, device="cpu").spectrograms(y)
    for g, r in zip(got, ref):
        mag_err, db_err = _db_errors(g.T + 20.0, r.T + 20.0)
        assert mag_err < TOL_MAG and db_err < TOL_DB, (mag_err, db_err)


@torch.no_grad()
@pytest.mark.parametrize("n_fft", [2, 30, 1998, 6000])
def test_spectrogram_dft_matches_plain(device, n_fft):
    from self_attention_tacotron_torch.ops import stft as S
    from self_attention_tacotron_torch.utils.audio import (hann_window,
                                                           mel_filterbank)
    mel = mel_filterbank(22050, n_fft, 8)
    plan = S.spectrogram_plan(mel, hann_window(n_fft, n_fft),
                              max(1, n_fft // 4), device)
    y = torch.from_numpy((0.1 * np.random.default_rng(n_fft)
                          .standard_normal(3 * n_fft + 5))
                         .astype(np.float32)).to(device)
    before = S.spectrograms.launches
    got = S.spectrograms(y, plan)
    assert S.spectrograms.launches == before + 1
    for g, r in zip(got, S.spectrograms_plain(y, plan)):
        mag_err, db_err = _db_errors(g, r)
        assert mag_err < TOL_MAG and db_err < TOL_DB, (mag_err, db_err)
