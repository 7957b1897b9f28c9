"""Audio DSP: native (librosa-free) STFT / mel / trim / wav IO.

A copy of the JAX package's ``utils/audio.py`` (numpy and scipy only).
Behavioral parity with the reference's ``Audio`` class
(reference: utils/audio.py:23-73), which wraps librosa.  Every primitive is
re-implemented here with identical math so corpus mel statistics and training
targets match the reference bit-for-bit in float32 within rounding:

* STFT: centered, reflect-padded, periodic Hann window of ``win_length``
  zero-padded to ``n_fft`` (librosa.stft semantics).
* Mel filterbank: Slaney mel scale (htk=False) with Slaney area normalization
  (librosa.filters.mel defaults).
* Trim: RMS-energy based endpoint detection relative to signal peak
  (librosa.effects.trim semantics).

The on-device STFT lives in ``ops/stft.py`` (a hand-written CUDA kernel)
and shares the window/filter construction here.
"""

from __future__ import annotations

import numpy as np
import scipy.io.wavfile
import scipy.signal


# --------------------------------------------------------------------- scales

def hz_to_mel(frequencies: np.ndarray) -> np.ndarray:
    """Slaney mel scale (linear below 1 kHz, log above)."""
    frequencies = np.asanyarray(frequencies, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (frequencies - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = frequencies >= min_log_hz
    mels = np.where(log_t, min_log_mel + np.log(np.maximum(frequencies, 1e-10) / min_log_hz) / logstep, mels)
    return mels


def mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asanyarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = mels >= min_log_mel
    freqs = np.where(log_t, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)
    return freqs


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int,
                   fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape (n_mels, 1+n_fft//2)."""
    if fmax is None:
        fmax = sample_rate / 2.0
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    mel_f = mel_to_hz(mel_pts)

    fdiff = np.diff(mel_f)
    ramps = mel_f.reshape(-1, 1) - fftfreqs.reshape(1, -1)
    lower = -ramps[:-2] / fdiff[:-1].reshape(-1, 1)
    upper = ramps[2:] / fdiff[1:].reshape(-1, 1)
    weights = np.maximum(0.0, np.minimum(lower, upper))

    enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
    weights *= enorm.reshape(-1, 1)
    return weights.astype(np.float32)


def hann_window(win_length: int, n_fft: int) -> np.ndarray:
    """Periodic Hann of win_length, centered in an n_fft buffer (librosa)."""
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win_length) / win_length)
    if n_fft == win_length:
        return win
    pad = (n_fft - win_length) // 2
    out = np.zeros(n_fft)
    out[pad:pad + win_length] = win
    return out


# ----------------------------------------------------------------------- stft

def stft(y: np.ndarray, n_fft: int, hop_length: int, win_length: int,
         center: bool = True) -> np.ndarray:
    """Complex STFT, shape (1 + n_fft//2, n_frames).  librosa.stft semantics."""
    window = hann_window(win_length, n_fft)
    if center:
        y = np.pad(y, n_fft // 2, mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop_length
    # frame without copying: as_strided view
    frames = np.lib.stride_tricks.as_strided(
        y, shape=(n_fft, n_frames),
        strides=(y.strides[0], hop_length * y.strides[0]))
    return np.fft.rfft(frames * window[:, None], axis=0)


def istft(S: np.ndarray, hop_length: int, win_length: int, n_fft: int,
          length: int | None = None) -> np.ndarray:
    """Inverse STFT with squared-Hann overlap-add normalization."""
    window = hann_window(win_length, n_fft)
    n_frames = S.shape[1]
    expected = n_fft + hop_length * (n_frames - 1)
    y = np.zeros(expected)
    norm = np.zeros(expected)
    frames = np.fft.irfft(S, n=n_fft, axis=0)
    wsq = window ** 2
    for t in range(n_frames):
        s = t * hop_length
        y[s:s + n_fft] += frames[:, t] * window
        norm[s:s + n_fft] += wsq
    y = y / np.maximum(norm, 1e-10)
    y = y[n_fft // 2:]
    if length is not None:
        y = y[:length]
    else:
        y = y[:expected - n_fft]
    return y


# ----------------------------------------------------------------------- trim

def _frame_rms(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    y = np.pad(y, frame_length // 2, mode="constant")
    n_frames = 1 + (len(y) - frame_length) // hop_length
    frames = np.lib.stride_tricks.as_strided(
        y, shape=(frame_length, n_frames),
        strides=(y.strides[0], hop_length * y.strides[0]))
    return np.sqrt(np.mean(np.abs(frames) ** 2, axis=0))


def trim_interval(y: np.ndarray, top_db: float, frame_length: int,
                  hop_length: int) -> tuple:
    """Non-silent sample interval [start, end) — librosa.effects.trim."""
    rms = _frame_rms(y, frame_length, hop_length)
    power_db = 20.0 * np.log10(np.maximum(rms, 1e-10) / max(rms.max(), 1e-10))
    non_silent = power_db > -top_db
    nonzero = np.flatnonzero(non_silent)
    if len(nonzero) == 0:
        return 0, 0
    start = int(nonzero[0]) * hop_length
    end = min(len(y), (int(nonzero[-1]) + 1) * hop_length)
    return start, end


# ------------------------------------------------------------------------- io

def load_wav(path: str, sample_rate: int) -> np.ndarray:
    """Load a wav as float32 mono at ``sample_rate`` (librosa.core.load)."""
    sr, data = scipy.io.wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    if sr != sample_rate:
        g = np.gcd(int(sr), int(sample_rate))
        data = scipy.signal.resample_poly(data, sample_rate // g, sr // g).astype(np.float32)
    return data


def save_wav(wav: np.ndarray, path: str, sample_rate: int) -> None:
    scipy.io.wavfile.write(path, sample_rate, wav)


# ----------------------------------------------------------------- Audio view

class Audio:
    """Reference-compatible facade (reference: utils/audio.py:23-73).

    With ``hparams.preprocess_on_device`` the spectrogram/melspectrogram
    calls route through ``ops/stft.MelExtractor`` on ``device`` (``cuda``
    unless the caller asks for the CPU, where the kernel's plain version
    runs) — the same math as the numpy path, as a matmul-form DFT."""

    def __init__(self, hparams, device="cuda"):
        self.hparams = hparams
        self.device = device
        self._mel_basis = self._build_mel_basis()
        self.average_mel_level_db = np.array(hparams.average_mel_level_db, dtype=np.float32)
        self.stddev_mel_level_db = np.array(hparams.stddev_mel_level_db, dtype=np.float32)
        self._extractor = None

    def _device_extractor(self):
        if self._extractor is None:
            from ..ops.stft import MelExtractor
            hp = self.hparams
            self._extractor = MelExtractor(
                hp.sample_rate, hp.num_freq, hp.num_mels,
                hp.frame_length_ms, hp.frame_shift_ms, hp.ref_level_db,
                device=self.device)
        return self._extractor

    def _build_mel_basis(self) -> np.ndarray:
        n_fft = (self.hparams.num_freq - 1) * 2
        return mel_filterbank(self.hparams.sample_rate, n_fft, self.hparams.num_mels)

    def _stft_parameters(self):
        n_fft = (self.hparams.num_freq - 1) * 2
        hop_length = int(self.hparams.frame_shift_ms / 1000 * self.hparams.sample_rate)
        win_length = int(self.hparams.frame_length_ms / 1000 * self.hparams.sample_rate)
        return n_fft, hop_length, win_length

    def load_wav(self, path: str) -> np.ndarray:
        return load_wav(path, self.hparams.sample_rate)

    def save_wav(self, wav: np.ndarray, path: str) -> None:
        save_wav(wav, path, self.hparams.sample_rate)

    def trim(self, wav: np.ndarray) -> np.ndarray:
        start, end = trim_interval(wav, self.hparams.trim_top_db,
                                   self.hparams.trim_frame_length,
                                   self.hparams.trim_hop_length)
        num_sil_samples = int(self.hparams.num_silent_frames *
                              self.hparams.frame_shift_ms *
                              self.hparams.sample_rate / 1000)
        start_idx = max(start - num_sil_samples, 0)
        stop_idx = min(end + num_sil_samples, len(wav))
        return wav[start_idx:stop_idx]

    def _stft(self, y: np.ndarray) -> np.ndarray:
        n_fft, hop_length, win_length = self._stft_parameters()
        return stft(y, n_fft, hop_length, win_length)

    def _linear_to_mel(self, spectrogram: np.ndarray) -> np.ndarray:
        return np.dot(self._mel_basis, spectrogram)

    @staticmethod
    def _amp_to_db(x: np.ndarray) -> np.ndarray:
        return 20.0 * np.log10(np.maximum(1e-5, x))

    def spectrogram(self, y: np.ndarray) -> np.ndarray:
        """Linear-frequency log magnitude (dB re ref_level_db)."""
        if getattr(self.hparams, "preprocess_on_device", False):
            return self._device_extractor().linear(y).cpu().numpy()
        D = self._stft(y)
        return self._amp_to_db(np.abs(D)) - self.hparams.ref_level_db

    def melspectrogram(self, y: np.ndarray) -> np.ndarray:
        if getattr(self.hparams, "preprocess_on_device", False):
            return self._device_extractor()(y).cpu().numpy()
        D = self._stft(y)
        S = self._amp_to_db(self._linear_to_mel(np.abs(D))) - self.hparams.ref_level_db
        return S

    def normalize_mel(self, S: np.ndarray) -> np.ndarray:
        return (S - self.average_mel_level_db) / self.stddev_mel_level_db

    def denormalize_mel(self, S: np.ndarray) -> np.ndarray:
        return S * self.stddev_mel_level_db + self.average_mel_level_db
