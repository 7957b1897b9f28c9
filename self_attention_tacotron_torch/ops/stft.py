"""STFT and mel-spectrogram extraction on the card.

Counterpart of the JAX package's ``ops/stft.py``.  The STFT is a
matmul-form DFT: windowed frames against (n_fft, 1 + n_fft // 2) cos and
sin matrices give the real and imaginary parts, whose magnitude gives the
linear spectrogram in dB and, through the (bins, mels) filterbank, the mel
spectrogram in dB.  ``spectrograms`` is that chain; it replaces the
Pallas kernel ``_spectrogram_kernel`` (reached through
``pallas_spectrograms``) with a hand-written CUDA kernel for sm_90a
(``csrc/spectrogram.cu``), built by ``ops/cuda_build.py`` and called
through ``ctypes``.  Its plain PyTorch version (``spectrograms_reference``)
runs for CPU tensors only; a CUDA tensor launches the kernel or raises.
The outputs are those of the JAX package after its slicing: the TPU
kernel pads bins and mels to 128 lanes, a layout matter of the TPU that
is not copied here.

``MelExtractor`` has the JAX class's contract and orientation: (num_freq,
F) and (num_mels, F) in dB re ``ref_level_db``, on an explicit device.
Both centre-pad the signal by n_fft // 2 in reflect mode with numpy's
semantics (``reflect_indices``): a signal shorter than the pad is folded
again, an empty one raises ``ValueError``.  ``stft`` is the complex STFT
through ``torch.fft.rfft`` (the JAX package's jnp fallback), and
``mel_statistics_*`` the streaming corpus statistics.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..utils.audio import hann_window, mel_filterbank
from . import cuda_build

Tensor = torch.Tensor
_P = ctypes.c_void_p
_DB = 20.0 / math.log(10.0)
AMP_FLOOR = 1e-5


def reflect_indices(length: int, pad: int) -> np.ndarray:
    """Indices into a signal of ``length`` samples that pad it by ``pad``
    on both sides in numpy's (and jnp's) ``mode="reflect"``: a pad longer
    than the signal reflects again."""
    if length < 1:
        raise ValueError("can't extend empty axis 0 using modes other than "
                         "'constant' or 'empty'")
    i = np.arange(-pad, length + pad)
    if length == 1:
        return np.zeros_like(i)
    period = 2 * (length - 1)
    m = np.mod(i, period)
    return np.where(m < length, m, period - m)


def frames_of(y: Tensor, n_fft: int, hop_length: int,
              window: Tensor) -> Tensor:
    """(T,) signal -> (F, n_fft) windowed frames, centred and reflect-padded,
    F = 1 + T // hop_length."""
    idx = torch.from_numpy(reflect_indices(y.shape[0], n_fft // 2)).to(
        y.device)
    return y[idx].unfold(0, n_fft, hop_length) * window


def stft(y: Tensor, n_fft: int, hop_length: int, win_length: int) -> Tensor:
    """Complex STFT (1 + n_fft // 2, n_frames); centred, reflect-padded."""
    window = torch.as_tensor(hann_window(win_length, n_fft), dtype=y.dtype,
                             device=y.device)
    return torch.fft.rfft(frames_of(y, n_fft, hop_length, window), dim=1).T


def amp_to_db(x: Tensor) -> Tensor:
    return _DB * torch.log(torch.clamp(x, min=AMP_FLOOR))


def dft_matrices(n_fft: int) -> tuple:
    """Real-input DFT as two (n_fft, 1 + n_fft // 2) matrices: Re X[k] =
    frames @ cos, Im X[k] = -(frames @ sin); the magnitude needs only the
    squares, so the sign is immaterial."""
    n_bins = 1 + n_fft // 2
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


def spectrograms_reference(frames: Tensor, wr: Tensor, wi: Tensor,
                           mel_t: Tensor) -> tuple:
    """Plain PyTorch version: (F, n_fft) frames -> (linear dB (F, bins), mel
    dB (F, mels)), the arithmetic of ``_spectrogram_kernel``."""
    re = frames @ wr
    im = frames @ wi
    mag = torch.sqrt(re * re + im * im)
    return amp_to_db(mag), amp_to_db(mag @ mel_t)


class _SpecArgs(ctypes.Structure):
    """Mirror of ``SpecArgs`` in csrc/spectrogram.cu."""

    _fields_ = [("frames", _P), ("wr", _P), ("wi", _P), ("mel_t", _P),
                ("mag", _P), ("lin", _P), ("mel", _P),
                ("F", ctypes.c_int), ("N", ctypes.c_int),
                ("K", ctypes.c_int), ("M", ctypes.c_int)]


def _launcher():
    lib = cuda_build.load("spectrogram")
    fn = lib.spectrogram_launch
    if not getattr(lib, "_typed", False):
        fn.argtypes = [ctypes.POINTER(_SpecArgs), _P]
        fn.restype = ctypes.c_int
        lib._typed = True
    return fn


def _check(t: Tensor, shape, name: str, device) -> None:
    if t.dtype != torch.float32 or t.device != device:
        raise ValueError(f"{name}: expected a float32 tensor on {device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel reads contiguous tensors")
    if t.requires_grad and torch.is_grad_enabled():
        raise ValueError(f"{name}: the kernel has no backward")


def spectrograms(frames: Tensor, wr: Tensor, wi: Tensor,
                 mel_t: Tensor) -> tuple:
    """(F, n_fft) windowed frames -> (linear dB (F, bins), mel dB (F,
    mels)), ``20 log10(max(1e-5, .))`` of the DFT magnitude and of its mel
    projection.  CPU tensors take the plain version; CUDA tensors launch
    the kernel (or raise)."""
    if not frames.is_cuda:
        return spectrograms_reference(frames, wr, wi, mel_t)
    if frames.dim() != 2 or wr.dim() != 2 or mel_t.dim() != 2:
        raise ValueError("spectrograms: frames (F, n_fft), wr and wi (n_fft, "
                         "bins), mel_t (bins, mels)")
    F, N = frames.shape
    K, M = wr.shape[1], mel_t.shape[1]
    dev = frames.device
    _check(frames, (F, N), "frames", dev)
    _check(wr, (N, K), "wr", dev)
    _check(wi, (N, K), "wi", dev)
    _check(mel_t, (K, M), "mel_t", dev)
    if min(F, N, K, M) < 1:
        raise ValueError(f"spectrograms: an empty dimension: F={F}, "
                         f"n_fft={N}, bins={K}, mels={M}")
    mag = torch.empty(F, K, device=dev)
    lin = torch.empty(F, K, device=dev)
    mel = torch.empty(F, M, device=dev)
    args = _SpecArgs(frames.data_ptr(), wr.data_ptr(), wi.data_ptr(),
                     mel_t.data_ptr(), mag.data_ptr(), lin.data_ptr(),
                     mel.data_ptr(), F, N, K, M)
    return cuda_build.KernelLaunch(
        _launcher(), args, (frames, wr, wi, mel_t, mag, lin, mel),
        (lin, mel), dev, spectrograms)()


spectrograms.launches = 0


class MelExtractor:
    """Wav -> (linear dB, mel dB) on ``device`` (``cuda`` unless the caller
    asks for the CPU).  Orientation matches ``utils/audio.Audio``:
    (num_freq, n_frames) and (num_mels, n_frames)."""

    def __init__(self, sample_rate: int, num_freq: int, num_mels: int,
                 frame_length_ms: float, frame_shift_ms: float,
                 ref_level_db: float, device="cuda"):
        self.device = torch.device(device)
        self.n_fft = (num_freq - 1) * 2
        self.num_freq = num_freq
        self.num_mels = num_mels
        self.hop_length = int(frame_shift_ms / 1000 * sample_rate)
        self.win_length = int(frame_length_ms / 1000 * sample_rate)
        self.ref_level_db = ref_level_db
        self.mel_basis = mel_filterbank(sample_rate, self.n_fft, num_mels)
        self.window = torch.as_tensor(
            hann_window(self.win_length, self.n_fft), dtype=torch.float32,
            device=self.device)
        wr, wi = dft_matrices(self.n_fft)
        self._wr = torch.from_numpy(wr).to(self.device)
        self._wi = torch.from_numpy(wi).to(self.device)
        self._mel_t = torch.from_numpy(
            np.ascontiguousarray(self.mel_basis.T)).to(self.device)

    def frames(self, y) -> Tensor:
        y = torch.as_tensor(np.asarray(y, np.float32)).to(self.device)
        return frames_of(y, self.n_fft, self.hop_length,
                         self.window).contiguous()

    def spectrograms(self, y) -> tuple:
        """(T_samples,) -> (linear (num_freq, F), mel (num_mels, F)) dB."""
        lin, mel = spectrograms(self.frames(y), self._wr, self._wi,
                                self._mel_t)
        return lin.T - self.ref_level_db, mel.T - self.ref_level_db

    def __call__(self, y) -> Tensor:
        """(T_samples,) -> (num_mels, n_frames) log-mel in dB."""
        return self.spectrograms(y)[1]

    def linear(self, y) -> Tensor:
        """(T_samples,) -> (num_freq, n_frames) linear log-spectrogram."""
        return self.spectrograms(y)[0]


def mel_statistics_update(carry, mel_frames: np.ndarray):
    """Streaming per-bin corpus statistics (count, sum, sumsq, min, max)."""
    count, s, ss, mn, mx = carry
    return (count + mel_frames.shape[0],
            s + mel_frames.sum(axis=0),
            ss + np.square(mel_frames).sum(axis=0),
            np.minimum(mn, mel_frames.min(axis=0)),
            np.maximum(mx, mel_frames.max(axis=0)))


def mel_statistics_init(num_mels: int):
    return (0, np.zeros(num_mels), np.zeros(num_mels),
            np.full(num_mels, np.inf), np.full(num_mels, -np.inf))


def mel_statistics_finalize(carry):
    count, s, ss, mn, mx = carry
    mean = s / count
    var = ss / count - mean ** 2
    return {
        "average_mel_level_db": mean.tolist(),
        "stddev_mel_level_db": np.sqrt(np.maximum(var, 0.0)).tolist(),
        "min_mel_level_db": mn.tolist(),
        "max_mel_level_db": mx.tolist(),
    }
