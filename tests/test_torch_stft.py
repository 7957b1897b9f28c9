"""The port's STFT / mel path against the JAX package and numpy, on CPU.

* ``spectrograms_reference`` (the arithmetic of the JAX kernel) against
  JAX ``pallas_spectrograms`` in interpret mode, with the JAX package's
  128-lane padding sliced off, and ``spectrograms`` from the signal (its
  plain version on the CPU) against JAX ``MelExtractor`` at LJSpeech and
  VCTK widths, a signal shorter than the pad included;
* the host side of the spectrogram kernel: the banded filterbank
  (``mel_bands``) against the dense product, and the float64 twiddle table
  (``twiddles``) through a Python mirror of the kernel's FFT plan (radix-4
  Stockham stages, a last radix-2 stage, the real-input split pass)
  against ``torch.fft.rfft`` at n_fft 128 to 4096, in float64 and in the
  kernel's float32;
* the direct DFT's arithmetic (an n_fft that is not a power of two): a
  float32 mirror of the kernel's tensor-core product (the window's
  non-zero taps only, folded in pairs t, n_fft - t, the twiddle table
  walked at k t mod N by an add and a compare, the 3xTF32 split with the
  kernel's add-and-mask rounding, each 8-deep step summed apart) against
  the float64 DFT at n_fft 30, 1998 (a 1102-tap window), 1999 (prime) and
  6000;
* the port's ``MelExtractor`` against JAX ``MelExtractor`` and against the
  port's numpy ``Audio`` path, at num_freq 65, 129 and 513 on a tone and on
  noise, and at num_freq 300 (n_fft 598, the direct DFT on the card) with
  a 400-tap window;
* frame counts F = 1, a prime F and F one above each kernel tile (65 and
  33 frames); a wav shorter than n_fft / 2 + 1 samples (reflected again,
  as numpy and jnp do) and an empty one (ValueError everywhere);
* the streaming ``mel_statistics_*``; the port's ``utils/audio.py``
  against ``tests/fixtures/audio_golden.npz``;
* ``--on-device`` with ``--device cuda`` and no card raises: nothing falls
  back to the CPU.

Tolerances.  A 2 n_fft-term float32 DFT sum carries an absolute error of
~1e-6 of the frame's peak, so bins near the 1e-5 floor can differ by dBs
between two right float32 implementations, and a bin 60 dB under its
frame's peak is good to ~0.01 dB.  The comparison is therefore made in the
magnitude domain relative to each frame's peak (``TOL_MAG``), and in dB
only where the reference is within 60 dB of its frame's peak and clears
the floor by 20 dB (``TOL_DB``).  Against the float64 numpy path the JAX
package's own checks are 0.1 dB (mel) and 0.15 dB (linear).
"""

import test_torch_threads  # noqa: F401  (bounds torch's threads)
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.ops import stft as jstft
from self_attention_tacotron_torch.config import default_hparams
from self_attention_tacotron_torch.ops import stft as S
from self_attention_tacotron_torch.utils import audio as A

TOL_MAG = 2e-5    # |mag - mag_ref| / the frame's peak magnitude
TOL_DB = 1e-2     # dB, within 60 dB of the frame's peak, above -80 dB
TOL_DB_NUMPY = 0.15   # dB against the float64 numpy path (JAX's own check)
FLOOR_DB = -100.0


def db_errors(got_db, ref_db, offset=0.0):
    """(max |mag - ref| over the frame's peak, max dB error where the
    reference is within 60 dB of its frame's peak and clears the floor by
    20 dB); frames along axis -1 of (bins, F) arrays, ``offset`` the
    ref_level_db already subtracted."""
    got = np.asarray(got_db, np.float64) + offset
    ref = np.asarray(ref_db, np.float64) + offset
    mg, mr = 10.0 ** (got / 20.0), 10.0 ** (ref / 20.0)
    peak = np.maximum(mr.max(axis=0, keepdims=True), 1e-5)
    loud = (ref > FLOOR_DB + 20.0) & (ref > ref.max(axis=0) - 60.0)
    db_err = float(np.abs(got - ref)[loud].max()) if loud.any() else 0.0
    return float((np.abs(mg - mr) / peak).max()), db_err


def _hp(num_freq, num_mels=8, sr=8000, **kw):
    return default_hparams().replace(**dict(
        dict(num_mels=num_mels, num_freq=num_freq, sample_rate=sr,
             frame_length_ms=16.0, frame_shift_ms=8.0,
             average_mel_level_db=[0.0] * num_mels,
             stddev_mel_level_db=[1.0] * num_mels), **kw))


def _extractors(hp):
    args = (hp.sample_rate, hp.num_freq, hp.num_mels, hp.frame_length_ms,
            hp.frame_shift_ms, hp.ref_level_db)
    return S.MelExtractor(*args, device="cpu"), jstft.MelExtractor(*args)


def _signal(kind, n, sr, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "tone":
        t = np.arange(n) / sr
        return (0.4 * np.sin(2 * np.pi * 440.0 * t)
                * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)
    return (0.1 * rng.randn(n)).astype(np.float32)


def test_plain_spectrograms_match_jax_pallas_kernel():
    n_fft, F, mels = 128, 37, 8
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((F, n_fft)).astype(np.float32)
    frames[3] *= 1e-4                      # a quiet frame near the floor
    wr, wi = S.dft_matrices(n_fft)
    bins = wr.shape[1]
    mel_t = np.abs(rng.standard_normal((bins, mels))).astype(np.float32)
    pb = pm = 128                          # the JAX package's lane pads
    pad = lambda a, r, c: np.pad(a, ((0, r - a.shape[0]),   # noqa: E731
                                     (0, c - a.shape[1])))
    lin_j, mel_j = jstft.pallas_spectrograms(
        jnp.asarray(frames), jnp.asarray(pad(wr, n_fft, pb)),
        jnp.asarray(pad(wi, n_fft, pb)), jnp.asarray(pad(mel_t, pb, pm)),
        interpret=True)
    lin_j, mel_j = np.asarray(lin_j)[:, :bins], np.asarray(mel_j)[:, :mels]
    lin, mel = S.spectrograms_reference(*(torch.from_numpy(a) for a in
                                          (frames, wr, wi, mel_t)))
    assert lin.shape == (F, bins) and mel.shape == (F, mels)
    for got, ref in ((lin, lin_j), (mel, mel_j)):
        mag_err, db_err = db_errors(got.numpy().T, ref.T)
        assert mag_err < TOL_MAG and db_err < TOL_DB, (mag_err, db_err)


@pytest.mark.parametrize("sr,num_freq,mels,T", [
    (22050, 1025, 80, 5000), (22050, 1025, 80, 500), (48000, 2049, 80, 6000),
    (48000, 2049, 80, 1000)])
def test_signal_plain_version_matches_jax_pallas(sr, num_freq, mels, T):
    """``spectrograms`` from the signal (frames_of -> the plain version on
    the CPU) against the JAX package's MelExtractor (pallas_spectrograms
    in interpret mode) at the recipes' widths; T = 500 and 1000 are
    shorter than the reflect pad (n_fft / 2 = 1024 and 2048)."""
    hp = _hp(num_freq, num_mels=mels, sr=sr, frame_length_ms=50.0,
             frame_shift_ms=12.5)
    port, jax_ex = _extractors(hp)
    y = _signal("tone", T, sr) + 0.01 * _signal("noise", T, sr)
    lin, mel = S.spectrograms(torch.from_numpy(y), port.plan)
    lin_j, mel_j = (np.asarray(a) for a in jax_ex.spectrograms(
        jnp.asarray(y)))
    assert lin.shape == (1 + T // port.hop_length, num_freq)
    off = hp.ref_level_db
    for got, ref in ((lin, lin_j), (mel, mel_j)):
        mag_err, db_err = db_errors(got.numpy().T - off, ref, off)
        assert mag_err < TOL_MAG and db_err < TOL_DB, (mag_err, db_err)


@pytest.mark.parametrize("sr,num_freq,mels", [
    (8000, 65, 8), (8000, 65, 40), (22050, 1025, 80), (48000, 2049, 80)])
def test_banded_filterbank_matches_dense(sr, num_freq, mels):
    """Each mel row's band (first and last non-zero bin, the weights in
    between) gives the dense ``mel_t`` product within 1e-6 on random
    magnitudes; every non-zero weight lies in its row's band.  (8000, 65,
    40) has rows without any bin."""
    basis = A.mel_filterbank(sr, (num_freq - 1) * 2, mels)
    band, w = S.mel_bands(basis)
    assert band.shape == (mels, 3) and band.dtype == np.int32
    mag = np.random.default_rng(0).uniform(0, 1, (50, num_freq)).astype(
        np.float32)
    banded = np.stack([mag[:, lo:lo + n] @ w[off:off + n]
                       for lo, n, off in band], 1)
    np.testing.assert_allclose(banded, mag @ basis.T, rtol=0, atol=1e-6)
    covered = np.zeros_like(basis, bool)
    for m, (lo, n, _) in enumerate(band):
        covered[m, lo:lo + n] = True
    assert not (basis != 0)[~covered].any()
    assert band[:, 1].sum() == len(w) <= 2 * num_freq


def fft_plan_mirror(x, tw):
    """The kernel's FFT plan in torch: (F, N) real frames and the (N, 2)
    twiddle table -> (F, N / 2 + 1) complex spectra, in the precision of
    ``x`` (complex128 for float64, complex64 for float32)."""
    N = x.shape[1]
    n = N // 2
    cdt = torch.complex128 if x.dtype == torch.float64 else torch.complex64
    w = torch.complex(tw[:, 0].to(x.dtype), tw[:, 1].to(x.dtype)).to(cdt)
    src = torch.complex(x[:, 0::2], x[:, 1::2]).to(cdt)
    p = 1
    while 4 * p <= n:
        q, step = n // 4, n // (2 * p)
        i = torch.arange(q)
        k = i & (p - 1)
        u = [src[:, i + r * q] * (w[r * k * step] if p > 1 else 1)
             for r in range(4)]
        a0, a1, a2 = u[0] + u[2], u[0] - u[2], u[1] + u[3]
        a3 = -1j * (u[1] - u[3])
        j = ((i - k) << 2) + k
        dst = torch.empty_like(src)
        dst[:, j], dst[:, j + p] = a0 + a2, a1 + a3
        dst[:, j + 2 * p], dst[:, j + 3 * p] = a0 - a2, a1 - a3
        src, p = dst, 4 * p
    if p < n:
        q, step = n // 2, n // p
        i = torch.arange(q)
        k = i & (p - 1)
        u0, u1 = src[:, i], src[:, i + q] * (w[k * step] if p > 1 else 1)
        j = ((i - k) << 1) + k
        dst = torch.empty_like(src)
        dst[:, j], dst[:, j + p] = u0 + u1, u0 - u1
        src = dst
    k = torch.arange(n + 1)
    zk, zc = src[:, k & (n - 1)], src[:, (n - k) & (n - 1)].conj()
    return (zk + zc) / 2 + w[k] * (-1j * (zk - zc) / 2)


@pytest.mark.parametrize("n_fft", [128, 256, 2048, 4096])
def test_fft_plan_with_the_twiddle_table_matches_rfft(n_fft):
    """log2(n_fft / 2) even (radix-4 stages only) and odd (a last radix-2
    stage).  In float64 the mirror with the float32-rounded table is
    within 1e-6 of each frame's peak of ``torch.fft.rfft``; in float32,
    as the kernel computes it, the magnitudes are within 2e-6 of each
    frame's peak of the float64 DFT, ten times inside the kernel's
    tolerance against its plain version (``TOL_MAG``)."""
    rng = np.random.default_rng(n_fft)
    win = A.hann_window(n_fft // 2, n_fft)
    x = torch.from_numpy(0.1 * rng.standard_normal((6, n_fft)) * win)
    x[2] += torch.from_numpy(np.sin(0.3 * np.arange(n_fft)) * win)
    tw = torch.from_numpy(S.twiddles(n_fft))
    assert tw.dtype == torch.float32 and tw.shape == (n_fft, 2)
    ref = torch.fft.rfft(x, dim=1)
    peak = ref.abs().amax(1, keepdim=True)
    got = fft_plan_mirror(x, tw)
    assert float(((got - ref).abs() / peak).max()) < 1e-6
    got32 = fft_plan_mirror(x.float(), tw)
    err = (got32.abs().double() - ref.abs()).abs() / peak
    assert float(err.max()) < 2e-6


def tf32_split(x: np.ndarray) -> tuple:
    """float32 -> (hi, lo) as mma.cuh's ``tf32_split``: hi = x rounded to
    TF32 by adding half a TF32 ulp and masking, lo = x - hi rounded the
    same way."""
    def rn(v):
        u = v.astype(np.float32).view(np.uint32).astype(np.uint64)
        return (((u + 0x1000) & 0xFFFFE000).astype(np.uint32)
                .view(np.float32))
    hi = rn(x)
    return hi, rn(x - hi)


def dft_plan_mirror(y: np.ndarray, plan) -> np.ndarray:
    """The direct DFT kernel's arithmetic in numpy: (F, K) magnitudes from
    the (T,) float32 signal.  A: the windowed frames (float32, as the
    kernel's loads form them) folded over the taps that cover the window's
    non-zero support, u[s] = x[s] + x[N - s] and v[s] = x[s] - x[N - s]
    (no partner for s = 0 or s = N / 2); B: each bin's cos and sin from
    the float32 twiddle table at index k s mod N, the index of taps s_lo
    + r (r < 8) stepped 8 taps at a time by an add and a compare; Re X = u
    cos, Im X = v (-sin), both split for 3xTF32; each 8-deep step's three
    products (lo hi, hi lo, hi hi, exact in float64) summed apart, rounded
    to float32 and added to the float32 sums."""
    N, hop = plan.n_fft, plan.hop_length
    s_lo, s_hi = S.folded_taps(N, plan.support)
    K = N // 2 + 1
    frames = S.frames_of(torch.from_numpy(y), N, hop, plan.window).numpy()
    steps = -(-(s_hi - s_lo + 1) // 8)
    s = s_lo + np.arange(8 * steps)
    p = N - s
    inside, pair = s <= s_hi, (s <= s_hi) & (p < N) & (p != s)
    xs = np.where(inside, frames[:, np.minimum(s, N - 1)], 0).astype(
        np.float32)
    xp = np.where(pair, frames[:, np.clip(p, 0, N - 1)], 0).astype(np.float32)
    u, v = xs + xp, xs - xp
    tw = plan.twiddles.numpy()
    k = np.arange(K, dtype=np.int64)
    idx = (k[None, :] * (s_lo + np.arange(8))[:, None]) % N     # (8, K)
    inc = 8 * k % N
    re = np.zeros((frames.shape[0], K), np.float32)
    im = np.zeros_like(re)
    for st in range(steps):
        assert (idx == k[None, :] * s[8 * st:8 * st + 8, None] % N).all()
        for acc, a, b in ((re, u, tw[idx, 0]), (im, v, tw[idx, 1])):
            ah, al = (x.astype(np.float64)
                      for x in tf32_split(a[:, 8 * st:8 * st + 8]))
            bh, bl = (x.astype(np.float64) for x in tf32_split(b))
            acc += (al @ bh + ah @ bl + ah @ bh).astype(np.float32)
        idx = idx + inc[None, :]
        idx = np.where(idx >= N, idx - N, idx)
    return np.hypot(re.astype(np.float64), im.astype(np.float64))


@pytest.mark.parametrize("n_fft,win", [(30, 30), (1998, 1102), (1999, 1999),
                                       (6000, 6000)])
def test_dft_plan_with_the_twiddle_table_matches_float64(n_fft, win):
    """The kernel's direct DFT on the tensor cores, mirrored in float32,
    against the float64 DFT of the same float32 frames: within 2e-6 of
    each frame's peak, ten times inside its tolerance against the plain
    version (``TOL_MAG``).  The plan's support is the window's non-zero
    taps (449 .. 1549 for a 1102-tap Hann in 1998, folded to 449 .. 999);
    the folded range covers a support on either side of n_fft / 2 too."""
    window = A.hann_window(win, n_fft)
    plan = S.spectrogram_plan(A.mel_filterbank(22050, n_fft, 8), window,
                              max(1, n_fft // 4), "cpu")
    nz = np.flatnonzero(window)
    assert plan.support == (nz[0], nz[-1] + 1)
    if (n_fft, win) == (1998, 1102):
        assert plan.support == (449, 1550)
        assert S.folded_taps(n_fft, plan.support) == (449, 999)
    for t0, t1 in ((0, n_fft), (1, n_fft // 2), (n_fft // 2 + 1, n_fft),
                   (3, 4), (0, 0)):
        lo, hi = S.folded_taps(n_fft, (t0, t1))
        folded = {min(t, n_fft - t) if t else 0 for t in range(t0, t1)}
        assert folded <= set(range(lo, hi + 1))
        assert not folded or (lo, hi) == (min(folded), max(folded))
    rng = np.random.default_rng(n_fft)
    T = 3 * n_fft + 5
    y = (0.1 * rng.standard_normal(T)
         + 0.3 * np.sin(0.05 * np.arange(T))).astype(np.float32)
    got = dft_plan_mirror(y, plan)
    frames = S.frames_of(torch.from_numpy(y), n_fft, plan.hop_length,
                         plan.window).double()
    ref = torch.fft.rfft(frames, dim=1).abs().numpy()
    peak = ref.max(1, keepdims=True)
    assert got.shape == ref.shape
    assert float((np.abs(got - ref) / peak).max()) < 2e-6


@pytest.mark.parametrize("kind", ["tone", "noise"])
@pytest.mark.parametrize("num_freq,sr,win_ms", [
    pytest.param(65, 8000, 16.0, id="65-8000"),
    pytest.param(129, 8000, 16.0, id="129-8000"),
    pytest.param(513, 16000, 16.0, id="513-16000"),
    pytest.param(300, 8000, 50.0, id="300-8000-window400")])
def test_mel_extractor_matches_jax_and_numpy(num_freq, sr, win_ms, kind):
    """num_freq 300: n_fft 598 is not a power of two (the card's direct
    DFT), its 400-tap window narrower than n_fft."""
    hp = _hp(num_freq, sr=sr, num_mels=8 if num_freq < 500 else 80,
             frame_length_ms=win_ms)
    port, jax_ex = _extractors(hp)
    y = _signal(kind, int(0.3 * sr), sr)
    lin, mel = port.spectrograms(y)
    lin_j, mel_j = (np.asarray(a) for a in jax_ex.spectrograms(
        jnp.asarray(y)))
    au = A.Audio(hp)
    lin_n, mel_n = au.spectrogram(y), au.melspectrogram(y)
    assert lin.shape == lin_j.shape == lin_n.shape == (num_freq,
                                                       1 + len(y) //
                                                       port.hop_length)
    assert mel.shape == mel_j.shape == mel_n.shape
    off = hp.ref_level_db
    for got, ref in ((lin, lin_j), (mel, mel_j)):
        mag_err, db_err = db_errors(got.numpy(), ref, off)
        assert mag_err < TOL_MAG and db_err < TOL_DB, (mag_err, db_err)
    for got, ref in ((lin, lin_n), (mel, mel_n)):
        mag_err, db_err = db_errors(got.numpy(), ref, off)
        assert mag_err < TOL_MAG and db_err < TOL_DB_NUMPY, (mag_err, db_err)


@pytest.mark.parametrize("F", [1, 2, 37, 65, 33, 97])
def test_frame_counts(F):
    """F = 1 + T // hop frames for T in [(F - 1) hop, F hop): 1, a prime,
    one above the DFT tile (64) and the mel tile (32)."""
    hp = _hp(65)
    port, _ = _extractors(hp)
    for T in ((F - 1) * port.hop_length + 1, F * port.hop_length - 1):
        y = _signal("noise", T, hp.sample_rate, seed=F)
        lin, mel = port.spectrograms(y)
        assert lin.shape == (65, F) and mel.shape == (8, F)
        mag_err, db_err = db_errors(mel.numpy(),
                                    A.Audio(hp).melspectrogram(y),
                                    hp.ref_level_db)
        assert mag_err < TOL_MAG and db_err < TOL_DB_NUMPY


@pytest.mark.parametrize("T", [1, 2, 10, 64, 65])
def test_short_wav_reflects_like_jax_and_numpy(T):
    """n_fft = 128: a wav of T <= n_fft / 2 samples is shorter than the
    reflect pad; numpy and jnp reflect it again, and so does the port."""
    hp = _hp(65)
    port, jax_ex = _extractors(hp)
    y = _signal("tone", T, hp.sample_rate) + 0.01
    idx = S.reflect_indices(T, 64)
    np.testing.assert_array_equal(y[idx], np.pad(y, 64, mode="reflect"))
    mel = port(y).numpy()
    mel_j = np.asarray(jax_ex(jnp.asarray(y)))
    assert mel.shape == mel_j.shape == (8, 1 + T // port.hop_length)
    mag_err, db_err = db_errors(mel, mel_j, hp.ref_level_db)
    assert mag_err < TOL_MAG and db_err < TOL_DB


def test_empty_wav_raises_everywhere():
    hp = _hp(65)
    port, jax_ex = _extractors(hp)
    y = np.zeros(0, np.float32)
    with pytest.raises(ValueError):
        port(y)
    with pytest.raises(ValueError):
        jax_ex(jnp.asarray(y))
    with pytest.raises(ValueError):
        A.Audio(hp).melspectrogram(y)


def test_stft_matches_numpy():
    sr = 16000
    y = _signal("tone", sr, sr)
    D = S.stft(torch.from_numpy(y), 1024, 200, 800).numpy()
    np.testing.assert_allclose(np.abs(D), np.abs(A.stft(y, 1024, 200, 800)),
                               atol=2e-3)


def test_mel_statistics_match_jax():
    rng = np.random.RandomState(0)
    frames = rng.randn(1000, 8).astype(np.float32) * 3 + 5
    carry, jcarry = S.mel_statistics_init(8), jstft.mel_statistics_init(8)
    for chunk in np.array_split(frames, 7):
        carry = S.mel_statistics_update(carry, chunk)
        jcarry = jstft.mel_statistics_update(jcarry, chunk)
    stats = S.mel_statistics_finalize(carry)
    assert stats == jstft.mel_statistics_finalize(jcarry)
    np.testing.assert_allclose(stats["average_mel_level_db"],
                               frames.mean(axis=0), rtol=1e-5)
    np.testing.assert_allclose(stats["stddev_mel_level_db"],
                               frames.std(axis=0), rtol=1e-4)


def test_audio_matches_golden_fixture():
    """tests/test_audio_golden.py's checks, on the port's copy."""
    import make_audio_fixtures as G
    golden = dict(np.load(G.FIXTURE))
    for key, sr in (("mel_filterbank_24k", 24000),
                    ("mel_filterbank_22k", 22050)):
        np.testing.assert_allclose(A.mel_filterbank(sr, G.N_FFT, G.N_MELS),
                                   golden[key], rtol=1e-6, atol=1e-8)
    sig = golden["signal"].astype(np.float64)
    D = A.stft(sig, G.N_FFT, G.HOP, G.WIN)
    np.testing.assert_allclose(D.real, golden["stft_real"], rtol=1e-4,
                               atol=2e-3)
    hp = default_hparams().replace(
        num_freq=1 + G.N_FFT // 2, sample_rate=G.SR, frame_shift_ms=12.5,
        frame_length_ms=50.0, num_mels=G.N_MELS, ref_level_db=G.REF_DB,
        average_mel_level_db=golden["norm_avg"].tolist(),
        stddev_mel_level_db=golden["norm_std"].tolist())
    for device_path in (False, True):
        audio = A.Audio(hp.replace(preprocess_on_device=device_path),
                        device="cpu")
        mel = audio.melspectrogram(sig)
        tol = 2e-3 if device_path else 2e-4   # float32 DFT vs float64 rfft
        np.testing.assert_allclose(mel, golden["mel_db"], rtol=1e-5, atol=tol)
        np.testing.assert_allclose(audio.normalize_mel(mel.T),
                                   golden["mel_normalized"].T, rtol=1e-5,
                                   atol=tol)
    np.testing.assert_array_equal(
        A.trim_interval(sig, top_db=30.0, frame_length=1024, hop_length=256),
        golden["trim_interval"])


def test_on_device_with_cuda_and_no_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import scipy.io.wavfile
    from self_attention_tacotron_torch.cli.preprocess import main_ljspeech
    root = tmp_path / "lj"
    (root / "wavs").mkdir(parents=True)
    scipy.io.wavfile.write(root / "wavs" / "LJ001-0001.wav", 8000,
                           (_signal("tone", 2000, 8000) * 32767).astype(
                               np.int16))
    (root / "metadata.csv").write_text("LJ001-0001|Hi|hi\n")
    hp_file = tmp_path / "hp.json"
    hp_file.write_text(json.dumps(dict(
        sample_rate=8000, num_freq=65, num_mels=8, frame_length_ms=16.0,
        frame_shift_ms=8.0)))
    with pytest.raises((RuntimeError, AssertionError)):
        main_ljspeech([str(root), str(tmp_path / "out"), "--hparam-json-file",
                       str(hp_file), "--on-device", "--device", "cuda",
                       "--target-only"])
    assert not list((tmp_path / "out").glob("*.target.tfrecord"))


def test_prepare_spectrograms_takes_only_a_cuda_signal():
    """The kernel's launch (and its profile) is laid out for a signal on
    the card only; ``spectrograms`` takes the plain version on the CPU."""
    plan = S.spectrogram_plan(A.mel_filterbank(22050, 1998, 8),
                              A.hann_window(1102, 1998), 275, "cpu")
    y = torch.zeros(3000)
    with pytest.raises(ValueError, match="CUDA"):
        S.prepare_spectrograms(y, plan, profile=True)
    lin, mel = S.spectrograms(y, plan)
    assert lin.shape == (1 + 3000 // 275, 1000) and mel.shape[1] == 8


def test_dft_timeline_reads_a_profiled_launch():
    """``chip_smoke.dft_timeline`` on the stamps of a profiled launch (ns;
    ``prepare_spectrograms(profile=True)``'s layout): two frame tiles of
    two bin tiles, one last block each, whose tail it reads."""
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    phases = np.array([0, 2000, 60000, 63000, 66000, 67000], np.int64)
    stamps = np.zeros((4, S.DFT_STAMPS), np.int64)
    for b in range(4):
        stamps[b, :6] = phases + 1000 * b
    for b in (1, 2):   # each frame tile's last block runs the tail
        stamps[b, 6], stamps[b, 7] = stamps[b, 5] + 2000, 1
    text = cs.dft_timeline(torch.from_numpy(stamps))
    assert text.startswith("4 blocks, median / largest us: prologue "
                           "2.00 / 2.00, loop 58.00 / 58.00, ")
    assert "tail 2.00 / 2.00; the last block ends 71.00 us after" in text
