"""The port's STFT / mel path against the JAX package and numpy, on CPU.

* ``spectrograms`` (the plain version of the spectrogram kernel) against
  JAX ``pallas_spectrograms`` in interpret mode, with the JAX package's
  128-lane padding sliced off;
* the port's ``MelExtractor`` against JAX ``MelExtractor`` and against the
  port's numpy ``Audio`` path, at num_freq 65, 129 and 513 on a tone and on
  noise;
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
    return default_hparams().replace(
        num_mels=num_mels, num_freq=num_freq, sample_rate=sr,
        frame_length_ms=16.0, frame_shift_ms=8.0,
        average_mel_level_db=[0.0] * num_mels,
        stddev_mel_level_db=[1.0] * num_mels, **kw)


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
    lin, mel = S.spectrograms(*(torch.from_numpy(a) for a in
                                (frames, wr, wi, mel_t)))
    assert lin.shape == (F, bins) and mel.shape == (F, mels)
    for got, ref in ((lin, lin_j), (mel, mel_j)):
        mag_err, db_err = db_errors(got.numpy().T, ref.T)
        assert mag_err < TOL_MAG and db_err < TOL_DB, (mag_err, db_err)


@pytest.mark.parametrize("kind", ["tone", "noise"])
@pytest.mark.parametrize("num_freq,sr", [(65, 8000), (129, 8000),
                                         (513, 16000)])
def test_mel_extractor_matches_jax_and_numpy(num_freq, sr, kind):
    hp = _hp(num_freq, sr=sr, num_mels=8 if num_freq < 500 else 80)
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
