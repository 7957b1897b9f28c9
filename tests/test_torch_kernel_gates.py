"""What kernels #1, #5, #6 and #7 take, on CPU.

Each used to raise on the card for configurations the JAX package serves:
the batch-1 encoder past T = 533 at the recipes' widths (its hop's rows
outgrew shared memory), for widths that are not multiples of 4, an odd
LSTM half or one over 128 units, more than 4 prenet, 8 highway or 4 hop
layers; the Pallas mode's attention past D = 128 and its step past D =
256, the spectrogram for an n_fft that is not a power of two.  The
kernels now take them (the encoder streams its hop, copies 4 bytes at a
time where rows are not 16-byte aligned, reads its layers from a table in
device memory and runs a 16-block cluster past 128 units; both attention
kernels have wide variants, the spectrogram a direct DFT), and each
module's pure-Python ``*unsupported_reason`` names what is left, which its
wrapper raises for on the card.  Here:

* the reasons at their edges: the encoder's layer counts (4 prenet layers
  and 5, 8 highway layers and 9, 4 hops and 5: none refused), widths that
  are not multiples of 4 and LSTM halves that are odd or over 128 (not
  refused; the 4-byte copies where a row is not 16-byte aligned), the
  heads that do not divide the self-attention width (refused, as the JAX
  kernel's shapes need), the recurrent cluster's edge (256 units a
  direction, 257 refused), and its hop's plan at the recipes' widths (T =
  533 resident, T = 534 streamed, neither refused); head widths 1024
  against 1025 (#5), any for #6; n_fft from 1 to 32768 (#7, the FFT for
  powers of two up to 16384);
* the wide full-sequence kernel's plan at 129 and 1024 wide, and its
  split of each row block's keys over several blocks where the row
  blocks would leave most SMs idle (and its scratch);
* the callers on CPU: the fused encoder, the Pallas mode and
  ``MelExtractor`` reach the kernels' wrappers, whose plain versions match
  the module path, the einsum path and ``spectrograms_plain``; a refused
  encoder raises before any launch.
"""

import test_torch_threads  # noqa: F401  (bounds torch's threads)
import logging

import numpy as np
import pytest
import torch

from self_attention_tacotron_torch.config import default_hparams
from self_attention_tacotron_torch.models import encoders
from self_attention_tacotron_torch.models.encoders import \
    SelfAttentionCBHGEncoder
from self_attention_tacotron_torch.ops import attention_core as ac
from self_attention_tacotron_torch.ops import fused_encoder as fe
from self_attention_tacotron_torch.ops import pallas_attention as pa
from self_attention_tacotron_torch.ops import stft
from self_attention_tacotron_torch.utils import convert

from test_torch_ops import ROOT

RECIPE = f"{ROOT}/examples/codes/self-attention-tacotron.json"
TINY_ENC = dict(cbhg_out_units=16, conv_channels=8, max_filter_width=4,
                projection1_out_channels=8, projection2_out_channels=8,
                num_highway=2, self_attention_out_units=8,
                self_attention_num_heads=2, self_attention_num_hop=1,
                prenet_out_units=(16, 8))


@pytest.fixture(autouse=True)
def fresh_logs(monkeypatch):
    monkeypatch.setattr(encoders, "_logged_paths", set())


def widths_of(hp=None, **kw) -> fe.EncoderWidths:
    """The encoder widths a configuration sets (the recipe's by default)."""
    hp = hp or default_hparams().parse_json_file(RECIPE)
    prenet = tuple(kw.pop("prenet", hp.encoder_prenet_out_units))
    half = hp.cbhg_out_units // 2
    return fe.EncoderWidths(
        hp.embedding_dim, prenet, hp.max_filter_width, hp.conv_channels,
        hp.projection1_out_channels, hp.projection2_out_channels,
        hp.projection2_out_channels, half, hp.self_attention_out_units,
        hp.self_attention_num_heads, kw.pop("num_highway", hp.num_highway),
        kw.pop("num_hop", hp.self_attention_num_hop))


@pytest.mark.parametrize("T,fits", [(1, True), (533, True), (534, False),
                                    (600, False)])
def test_encoder_plan_edge_at_the_recipe_widths(T, fits):
    """``fits``: the hop's K | V | Q rows and scores fit in a block's shared
    memory; past that the kernel streams them, so no length is refused."""
    w = widths_of()
    assert (w.H, w.SA, w.heads) == (128, 32, 2)
    assert fe.unsupported_reason(w, T) is None
    assert fe.hop_streams(T, w.H, w.SA) == (not fits)
    trunk, rnn = fe.smem_bytes(T, w.E_in, w.prenet, w.K, w.C, w.P1, w.P2,
                               w.W, w.H, w.SA, w.heads)
    assert max(trunk, rnn) <= fe.SMEM_LIMIT
    resident = 4 * (fe._hop_resident(T, w.SA) + fe.RED_FLOATS)
    assert (rnn == resident) == (T > 64 and fits)


# the encoder widths the streamed hop is checked at: the recipes', 129 and
# 256 LSTM units a direction (the 16-block cluster) and widths that are
# not multiples of 4 with a 5-wide head (tests/test_torch_cuda.py WIDE_ENC)
STREAM_WIDTHS = {
    "recipe": {},
    "H129": dict(H=129),
    "H256": dict(H=256),
    "odd_widths": dict(E_in=18, prenet=(22, 10), K=4, C=6, P1=7, P2=10, W=8,
                       H=8, SA=10),
}


@pytest.mark.parametrize("name", list(STREAM_WIDTHS))
def test_streamed_hop_plan(name):
    """Past the resident plan the recurrent block's shared memory is the
    same at every T (the streamed hop's buffers, ``hop_stream_floats``,
    grow with neither T nor the head width) and fits 227 KB; the hop's
    items cover every (head, query row) once over the cluster's blocks."""
    w = widths_of()._replace(**STREAM_WIDTHS[name])
    plans = set()
    for T in (534, 600, 2000, 10000):
        if not fe.hop_streams(T, w.H, w.SA):
            assert name == "odd_widths" and T < 2000   # 44 floats a row
            continue
        assert fe.unsupported_reason(w, T) is None
        trunk, rnn = fe.smem_bytes(T, w.E_in, w.prenet, w.K, w.C, w.P1,
                                   w.P2, w.W, w.H, w.SA, w.heads)
        assert 4 * (fe.hop_stream_floats() + fe.RED_FLOATS) <= rnn
        assert max(trunk, rnn) <= fe.SMEM_LIMIT
        plans.add(rnn)
        blocks = 2 * fe.dir_blocks(w.H)
        items = fe.hop_stream_items(T, w.heads, blocks)
        assert len(items) == blocks and all(items)
        seen = sorted((h, r) for block in items for h, r0, n in block
                      for r in range(r0, r0 + n))
        assert seen == [(h, r) for h in range(w.heads) for r in range(T)]
        assert all(0 < n <= fe.HOP_ROWS for b in items for _, _, n in b)
    assert len(plans) == 1
    assert fe.hop_stream_floats() == 16896


@pytest.mark.parametrize("kw", [
    dict(prenet=(256, 128, 128, 128)),
    dict(prenet=(256, 128, 128, 128, 128)),
    dict(num_highway=8),
    dict(num_highway=9),
    dict(num_hop=4),
    dict(num_hop=5),
], ids=["prenet4", "prenet5", "highway8", "highway9", "hops4", "hops5"])
def test_encoder_layer_counts(kw):
    """No layer count is refused: the kernel reads the layers' weights and
    widths from a table in device memory, as long as the configuration."""
    w = widths_of(**kw)
    assert fe.unsupported_reason(w, 64) is None
    assert fe.vector_copies(w)      # the recipes' 16-byte instance


@pytest.mark.parametrize("field,value,refused", [
    ("E_in", 30, None), ("C", 6, None), ("SA", 34, None), ("H", 7, None),
    ("H", 130, None), ("heads", 3, "divide")])
def test_encoder_widths(field, value, refused):
    """Widths that are not multiples of 4 and an odd LSTM half take the
    instance with 4-byte copies; 130 units a direction the 16-block
    cluster.  What stays refused is what the JAX kernel's shapes need too:
    heads that divide the self-attention width."""
    w = widths_of()
    changed = w._replace(**{field: value})
    reason = fe.unsupported_reason(changed, 64)
    if refused is None:
        assert reason is None, reason
        assert fe.vector_copies(changed) == (field == "H" and value % 2 == 0)
    else:
        assert reason is not None and refused in reason
    assert fe.unsupported_reason(w, 0) is not None
    assert fe.unsupported_reason(w, 64) is None


@pytest.mark.parametrize("H,blocks", [(1, 4), (128, 4), (129, 8), (256, 8),
                                      (257, None)])
def test_encoder_recurrent_cluster_edge(H, blocks):
    """32 units a block: 4 blocks a direction up to 128 units, 8 (a
    16-block cluster) up to 256; past that the reason names the cluster."""
    reason = fe.unsupported_reason(widths_of()._replace(H=H), 64)
    if blocks is None:
        assert reason is not None and "cluster" in reason
    else:
        assert reason is None, reason
        assert fe.dir_blocks(H) == blocks


def _tiny_encoder(E, **kw):
    enc = SelfAttentionCBHGEncoder(E, fused_inference=True,
                                   **dict(TINY_ENC, **kw))
    return convert.init_parameters(enc, seed=1).eval()


def _kernel_args(enc):
    return dict(max_filter_width=enc.max_filter_width,
                conv_channels=enc.conv_channels,
                half=enc.cbhg_out_units // 2,
                sa_units=enc.self_attention_out_units,
                num_heads=enc.self_attention_num_heads)


def test_encoder_widths_mirror_the_merged_weights():
    enc = _tiny_encoder(12)
    hp = default_hparams().parse_json_file(RECIPE)
    hp = hp.replace(embedding_dim=12, encoder_prenet_out_units=[16, 8],
                    **{k: v for k, v in TINY_ENC.items()
                       if k != "prenet_out_units"})
    k = _kernel_args(enc)
    got = fe.encoder_widths(enc.fused_params(), 12, k["max_filter_width"],
                            k["conv_channels"], k["half"], k["sa_units"],
                            k["num_heads"])
    assert got == widths_of(hp)


def _run(enc, T, E, seed=0):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (1, T, E)).astype(np.float32))
    with torch.no_grad():
        return enc(x, torch.tensor([T]))


def test_encoder_refused_widths_raise_before_a_launch():
    """257 LSTM units a direction are past the recurrent cluster:
    ``prepare_encode`` raises with the reason before it reads a tensor (so
    on the card, before any launch).  E_in = 10, not a multiple of 4, is
    taken (the 4-byte copies); on CPU the wrapper's plain version serves,
    as for any CPU tensor, and matches the module path."""
    wide = _tiny_encoder(12, cbhg_out_units=514)
    with pytest.raises(ValueError, match="cluster"):
        fe.prepare_encode(wide.fused_params(), torch.zeros(1, 9, 12), 9,
                          **_kernel_args(wide))
    enc = _tiny_encoder(10)
    assert fe.unsupported_reason(fe.encoder_widths(
        enc.fused_params(), 10, *_kernel_args(enc).values()), 9) is None
    got = _run(enc, 9, 10)
    plain = _tiny_encoder(10)
    plain.fused_inference = False
    for g, r in zip(got[:2], _run(plain, 9, 10)[:2]):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)


def test_encoder_gate_lets_the_kernel_take_what_fits(caplog):
    enc = _tiny_encoder(12)
    with caplog.at_level(logging.INFO):
        _, _, aligns = _run(enc, 9, 12)
    assert "encoder self-attention: fused_encode kernel" in caplog.text
    assert all(not a.any() for a in aligns)   # the kernel's zeros


@pytest.mark.parametrize("D,fits", [(1, True), (128, True), (129, True),
                                    (1024, True), (1025, False)])
def test_attention_reason_edge(D, fits):
    assert (pa.attention_unsupported_reason(1, 2, 64, D) is None) == fits
    assert pa.attention_unsupported_reason(1, 2, 0, 16) is not None
    assert pa.attention_unsupported_reason(40000, 2, 8, 16) is not None


@pytest.mark.parametrize("D,fits", [(1, True), (256, True), (257, True),
                                    (4096, True), (0, False)])
def test_step_reason_edge(D, fits):
    assert (pa.step_unsupported_reason(1, 2, 450, D) is None) == fits
    assert pa.step_unsupported_reason(1, 2, 0, 16) is not None


@pytest.mark.parametrize("D", [129, 1024])
def test_wide_attention_plan(D):
    """Past the narrow templates a block of 8 warps holds two 16-row groups
    (one past 512 wide), a ring of 3 stages of 32 keys (8 at 1024 wide in
    float32) and each warp's partial score tile, within 227 KB."""
    plan = pa.attention_plan(2, 3, 70, D, causal=True)
    rows, keys, dp = (32, 32, 192) if D == 129 else (16, 8, 1024)
    assert (plan.rows, plan.key_warps, plan.warps) == (rows, 1, 8)
    assert plan.grid == (-(-70 // rows), 6)
    assert (plan.keys, plan.stages) == (keys, 3)
    assert plan.smem_bytes == (3 * 2 * keys * (dp + 4) * 4
                               + 8 * 16 * keys * 4) <= 232448


@pytest.mark.parametrize("elem_bytes,B,T,D,causal,splits", [
    (4, 8, 256, 256, False, 1),    # 128 row blocks fill the card: no split
    (4, 1, 450, 256, True, 4),     # the bf16 row's shape: 30 row blocks
    (4, 1, 64, 129, True, 2), (4, 2, 70, 1024, True, 5),
    (4, 2, 1, 300, False, 1),
    # bf16 tiles hold twice the keys at 512 and 1024 wide, so the splits
    # follow the element size
    (2, 1, 450, 256, True, 4), (2, 2, 70, 129, False, 3),
    (2, 1, 100, 512, True, 4), (4, 1, 100, 512, True, 7),
    (2, 1, 200, 512, True, 7), (4, 1, 200, 512, True, 7),
    (2, 2, 40, 1024, False, 3), (4, 2, 40, 1024, False, 5)])
def test_wide_attention_plan_splits_small_grids(elem_bytes, B, T, D, causal,
                                                splits):
    """Where the wide kernel's row blocks leave most SMs idle, each row
    block's key tiles split into chunks (one block each) whose partial
    states, a thread's padded D / 8 or / 16, + 4 floats, the last
    merges."""
    plan = pa.attention_plan(B, 2, T, D, causal, elem_bytes)
    tiles = -(-T // plan.keys)
    blocks = plan.grid[0] * plan.grid[1]
    assert plan.splits == splits
    assert plan.splits * plan.chunk >= tiles > (plan.splits - 1) * plan.chunk
    assert blocks * plan.splits <= max(blocks, pa.ATTN_FILL_BLOCKS)
    dp = next(w for w in pa.WIDE_WIDTHS if D <= w)
    per_thread = dp * plan.rows // 128 // 2 + 4
    assert plan.part_floats == (blocks * splits * 256 * per_thread
                                if splits > 1 else 0)


@pytest.mark.parametrize("D,full_kernel,step_kernel", [
    (128, True, True), (129, True, True), (256, True, True),
    (257, True, True)])
def test_attention_core_gate(D, full_kernel, step_kernel, monkeypatch):
    """The Pallas mode's hop at head width D reaches both kernels' wrappers
    (their zero alignments; on CPU their plain versions), which match the
    einsum path."""
    calls = []
    for name in ("fused_self_attention", "incremental_attention_step"):
        fn = getattr(ac, name)
        monkeypatch.setattr(ac, name, lambda *a, _f=fn, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    torch.manual_seed(0)
    mha = ac.MultiHeadAttention(2 * D, 2, use_subsequent_mask=True,
                                use_pallas=True).eval()
    ref = ac.MultiHeadAttention(2 * D, 2, use_subsequent_mask=True).eval()
    ref.load_state_dict(mha.state_dict())
    x = torch.randn(1, 5, 2 * D)
    with torch.no_grad():
        out, al = mha(x, x, x)
        out_r, _ = ref(x, x, x)
        cache, cache_r = mha.init_cache(1, 5), ref.init_cache(1, 5)
        for t in range(5):
            y, cache, row = mha.step(x[:, t], t, cache)
            y_r, cache_r, _ = ref.step(x[:, t], t, cache_r)
            torch.testing.assert_close(y, y_r, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(out, out_r, rtol=1e-5, atol=1e-6)
    assert bool(al.any()) != full_kernel
    assert bool(row.any()) != step_kernel
    assert calls.count("fused_self_attention") == int(full_kernel)
    assert calls.count("incremental_attention_step") == 5 * int(step_kernel)


@pytest.mark.parametrize("n_fft,fits", [(8, True), (2048, True),
                                        (16384, True), (1998, True),
                                        (4, True), (32768, True),
                                        (0, False), (32769, False)])
def test_spectrogram_reason_edge(n_fft, fits):
    assert (stft.spectrogram_unsupported_reason(n_fft) is None) == fits
    assert stft.takes_fft(n_fft) == (n_fft in (8, 2048, 16384))


@pytest.mark.parametrize("num_freq", [1025, 1000])    # n_fft 2048, 1998
def test_mel_extractor_gate(num_freq, monkeypatch):
    """Both n_fft reach the kernel's wrapper (the FFT or the direct DFT on
    the card; the plain version here)."""
    ex = stft.MelExtractor(22050, num_freq, 80, 50.0, 12.5, 20.0,
                           device="cpu")
    y = np.random.default_rng(0).standard_normal(4000).astype(np.float32)
    calls = []
    kernel = stft.spectrograms
    monkeypatch.setattr(stft, "spectrograms",
                        lambda *a: calls.append(1) or kernel(*a))
    lin, mel = ex.spectrograms(y)
    ex(y)
    ref_lin, ref_mel = stft.spectrograms_plain(ex.signal(y), ex.plan)
    torch.testing.assert_close(lin, ref_lin.T - 20.0, rtol=0, atol=0)
    torch.testing.assert_close(mel, ref_mel.T - 20.0, rtol=0, atol=0)
    assert len(calls) == 2
    assert stft.takes_fft(ex.n_fft) == (num_freq == 1025)
