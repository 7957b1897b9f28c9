"""STFT and mel-spectrogram extraction on the card.

Counterpart of the JAX package's ``ops/stft.py``: from a (T,) signal, the
linear spectrogram in dB (the magnitude of the centred, reflect-padded,
windowed STFT) and, through the (bins, mels) filterbank, the mel
spectrogram in dB.  ``spectrograms`` replaces the Pallas kernel
``_spectrogram_kernel`` (reached through ``pallas_spectrograms``) with a
hand-written CUDA kernel for sm_90a (``csrc/spectrogram.cu``), built by
``ops/cuda_build.py`` and called through ``ctypes``: one launch from the
signal to both outputs, a real FFT in shared memory for each frame (the
twiddles from ``twiddles``, a float64 table rounded to float32) and the
mel sums over each filter's band of bins only (``mel_bands``); an n_fft
that is not a power of two takes its direct DFT, one product on the tensor
cores over the window's non-zero taps (``SpecPlan.support``).  Its plain
PyTorch version is the JAX kernel's arithmetic: ``frames_of`` gathers the
frames and ``spectrograms_reference`` multiplies them with the
(n_fft, 1 + n_fft // 2) cos and sin matrices (``dft_matrices``); it runs
for CPU tensors only, and a CUDA tensor launches the kernel or raises.
The outputs are those of the JAX package after its slicing: the TPU
kernel pads bins and mels to 128 lanes, a layout matter of the TPU that
is not copied here.

``MelExtractor`` has the JAX class's contract and orientation: (num_freq,
F) and (num_mels, F) in dB re ``ref_level_db``, on an explicit device.
The kernel takes a power-of-two n_fft by its FFT and any other (``num_freq``
not 2^k + 1) by a direct DFT; ``spectrogram_unsupported_reason`` says what
it refuses (an n_fft past ``MAX_DFT``), and the wrapper raises for it.
Both centre-pad the signal by n_fft // 2 in reflect mode with numpy's
semantics (``reflect_indices``; the kernel does the same index arithmetic
itself): a signal shorter than the pad is folded again, an empty one
raises ``ValueError``.  ``stft`` is the complex STFT through
``torch.fft.rfft`` (the JAX package's jnp fallback), and
``mel_statistics_*`` the streaming corpus statistics.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

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


@functools.lru_cache(maxsize=4)
def _dense_dft(n_fft: int, device: torch.device) -> tuple:
    return tuple(torch.from_numpy(a).to(device) for a in dft_matrices(n_fft))


def spectrograms_plain(y: Tensor, plan: "SpecPlan") -> tuple:
    """The plain version of ``spectrograms``: frames gathered from the
    signal, then ``spectrograms_reference``."""
    wr, wi = _dense_dft(plan.n_fft, y.device)
    return spectrograms_reference(
        frames_of(y, plan.n_fft, plan.hop_length, plan.window), wr, wi,
        plan.mel_t)


def twiddles(n_fft: int) -> np.ndarray:
    """(n_fft, 2) float32: exp(-2 pi i k / n_fft), k < n_fft, computed in
    float64 and rounded once (the kernel's FFT stages read entry 2j for
    the (n_fft / 2)-point transform's W^j, and its real-input split
    pass entry k)."""
    ang = -2.0 * np.pi * np.arange(n_fft) / n_fft
    return np.stack([np.cos(ang), np.sin(ang)], 1).astype(np.float32)


def mel_bands(mel_basis: np.ndarray) -> tuple:
    """The (mels, bins) filterbank in banded form: (band (mels, 3) int32 of
    each row's first non-zero bin, number of bins up to its last non-zero
    one and offset into the weights; the weights of those spans, flat).
    A row without non-zero bins has an empty band."""
    band = np.zeros((mel_basis.shape[0], 3), np.int32)
    weights = []
    off = 0
    for m, row in enumerate(mel_basis):
        nz = np.flatnonzero(row)
        if len(nz):
            lo, hi = int(nz[0]), int(nz[-1]) + 1
            band[m] = (lo, hi - lo, off)
            weights.append(row[lo:hi])
            off += hi - lo
        else:
            band[m] = (0, 0, off)
    w = (np.concatenate(weights) if weights else np.zeros(0)).astype(
        np.float32)
    return band, w


class SpecPlan(NamedTuple):
    """The operands of ``spectrograms`` for one (sample rate, n_fft, hop,
    window, filterbank), on one device."""

    n_fft: int
    hop_length: int
    window: Tensor      # (n_fft,)
    twiddles: Tensor    # (n_fft, 2), see ``twiddles``
    mel_t: Tensor       # (bins, mels) the dense filterbank (plain version)
    band: Tensor        # (mels, 3) int32, see ``mel_bands``
    band_w: Tensor      # (band weights,)
    support: Tuple[int, int]   # the window's non-zero taps [first, end)


def window_support(window: np.ndarray) -> Tuple[int, int]:
    """[first, end) of the window's non-zero taps ((0, 0) for none): the
    direct DFT sums over them only, the others add exact zeros."""
    nz = np.flatnonzero(window)
    return (int(nz[0]), int(nz[-1]) + 1) if len(nz) else (0, 0)


def folded_taps(n_fft: int, support: Tuple[int, int]) -> Tuple[int, int]:
    """[s_lo, s_hi] of the direct DFT's folded taps (the kernel's own
    arithmetic): taps t and n_fft - t share a cos and, with opposite signs,
    a sin, so the kernel sums u = x[s] + x[n_fft - s] and v = x[s] -
    x[n_fft - s] over s <= n_fft / 2; tap t <= n_fft / 2 folds to s = t, a
    later one to n_fft - t, and the range covers every tap of the window's
    support [t0, t1).  (0, -1) for an empty support."""
    t0, t1 = support
    h = n_fft // 2
    low, high = t0 <= h and t0 < t1, t1 - 1 > h
    s_hi = max(min(t1 - 1, h) if low else -1,
               n_fft - max(t0, h + 1) if high else -1)
    if s_hi < 0:
        return 0, -1
    return min(t0 if low else n_fft, n_fft - t1 + 1 if high else n_fft), s_hi


def spectrogram_plan(mel_basis: np.ndarray, window: np.ndarray,
                     hop_length: int, device) -> SpecPlan:
    band, band_w = mel_bands(mel_basis)
    dev = torch.device(device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    return SpecPlan(int(window.shape[0]), int(hop_length),
                    t(window.astype(np.float32)),
                    t(twiddles(int(window.shape[0]))), t(mel_basis.T),
                    t(band), t(band_w), window_support(window))


class _SpecArgs(ctypes.Structure):
    """Mirror of ``SpecArgs`` in csrc/spectrogram.cu."""

    _fields_ = [("y", _P), ("window", _P), ("tw", _P), ("band", _P),
                ("band_w", _P), ("lin", _P), ("mel", _P),
                ("T", ctypes.c_int), ("F", ctypes.c_int),
                ("N", ctypes.c_int), ("hop", ctypes.c_int),
                ("M", ctypes.c_int), ("t0", ctypes.c_int),
                ("t1", ctypes.c_int), ("part", _P), ("tickets", _P),
                ("nw", ctypes.c_int), ("stamps", _P)]


def _launcher():
    lib = cuda_build.load("spectrogram")
    fn = lib.spectrogram_launch
    if not getattr(lib, "_typed", False):
        fn.argtypes = [ctypes.POINTER(_SpecArgs), _P]
        fn.restype = ctypes.c_int
        lib._typed = True
    return fn


def _check(t: Tensor, shape, name: str, device, dtype=torch.float32) -> None:
    if t.dtype != dtype or t.device != device:
        raise ValueError(f"{name}: expected a {dtype} tensor on {device}, "
                         f"got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel reads contiguous tensors")
    if t.requires_grad and torch.is_grad_enabled():
        raise ValueError(f"{name}: the kernel has no backward")


MAX_FFT = 16384   # the FFT: 8 n_fft bytes of shared memory a block
MAX_DFT = 32768   # the direct DFT's longest n_fft
# the direct DFT's block: 64 frames x 128 bins (DFT_FT, DFT_BT in the kernel)
DFT_FRAMES = 64
DFT_BINS = 128
# a profiled DFT launch's words a block (DFT_STAMPS in the kernel): the
# card's global timer (ns) at the block's start and at the end of each
# phase, then whether it was its frame tile's last block (the tail's)
DFT_PHASES = ("prologue", "loop", "magnitudes", "mel shares", "ticket",
              "tail")
DFT_STAMPS = len(DFT_PHASES) + 2


def takes_fft(n_fft: int) -> bool:
    """Whether the kernel's FFT takes ``n_fft`` (a power of two from 8 to
    ``MAX_FFT``, ``num_freq`` = 2^k + 1); any other n_fft up to ``MAX_DFT``
    takes its direct DFT."""
    return 8 <= n_fft <= MAX_FFT and not n_fft & (n_fft - 1)


def spectrogram_unsupported_reason(n_fft: int) -> Optional[str]:
    """Why ``spectrograms``' kernel cannot take ``n_fft``, or None: the
    FFT or the direct DFT takes every n_fft from 1 to ``MAX_DFT``."""
    if not 1 <= n_fft <= MAX_DFT:
        return f"n_fft {n_fft} outside [1, {MAX_DFT}]"
    return None


def spectrograms(y: Tensor, plan: SpecPlan) -> tuple:
    """(T,) signal -> (linear dB (F, bins), mel dB (F, mels)), F = 1 +
    T // hop: ``20 log10(max(1e-5, .))`` of the STFT magnitude and of its
    mel projection.  CPU tensors take the plain version; CUDA tensors
    launch the kernel (or raise): the FFT for a power-of-two n_fft from 8
    to ``MAX_FFT``, else the direct DFT up to ``MAX_DFT``."""
    if not y.is_cuda:
        return spectrograms_plain(y, plan)
    return prepare_spectrograms(y, plan)()


def prepare_spectrograms(y: Tensor, plan: SpecPlan,
                         profile: bool = False) -> cuda_build.KernelLaunch:
    """Check the operands (on the card) and lay out one launch of
    ``spectrograms``.  With ``profile`` (the direct DFT with its twiddle
    table in shared memory, n_fft up to ~14,000; past that the launch
    raises), its own instance of the kernel, in which thread 0 of each
    block writes the card's global timer (ns) at its start and at the
    end of each of ``DFT_PHASES`` (the tail's 0 but in the frame tile's
    last block), then 1 in that last block, into ``stage_cycles``: an int64
    (blocks, ``DFT_STAMPS``) tensor, block ``frame tile * bin tiles + bin
    tile``."""
    N, M = plan.n_fft, plan.band.shape[0]
    dev = y.device
    if not y.is_cuda:
        raise ValueError("prepare_spectrograms: the kernel takes a CUDA "
                         "signal")
    if profile and takes_fft(N):
        raise ValueError(f"spectrograms: n_fft {N} takes the FFT, which "
                         f"has no profile")
    if y.dim() != 1 or y.shape[0] < 1:
        raise ValueError(f"spectrograms: expected a non-empty (T,) signal, "
                         f"got shape {tuple(y.shape)}")
    reason = spectrogram_unsupported_reason(N)
    if reason is not None:
        raise ValueError(f"spectrograms: {reason}")
    T, K = int(y.shape[0]), N // 2 + 1
    _check(y, (T,), "y", dev)
    _check(plan.window, (N,), "window", dev)
    _check(plan.twiddles, (N, 2), "twiddles", dev)
    _check(plan.band, (M, 3), "band", dev, torch.int32)
    _check(plan.band_w, (plan.band_w.shape[0],), "band_w", dev)
    F = 1 + T // plan.hop_length
    lin = torch.empty(F, K, device=dev)
    mel = torch.empty(F, M, device=dev)
    part = tickets = stamps = None
    if not takes_fft(N):   # the direct DFT's mel shares and tickets
        part = torch.empty(-(-K // DFT_BINS) * F * M, device=dev)
        tickets = cuda_build.ticket_words(dev, -(-F // DFT_FRAMES),
                                          "spectrogram")
    if profile:
        stamps = torch.zeros(-(-K // DFT_BINS) * -(-F // DFT_FRAMES),
                             DFT_STAMPS, dtype=torch.int64, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    args = _SpecArgs(y.data_ptr(), plan.window.data_ptr(),
                     plan.twiddles.data_ptr(), plan.band.data_ptr(),
                     plan.band_w.data_ptr(), lin.data_ptr(), mel.data_ptr(),
                     T, F, N, plan.hop_length, M, *plan.support, ptr(part),
                     ptr(tickets), plan.band_w.numel(), ptr(stamps))
    return cuda_build.KernelLaunch(
        _launcher(), args, (y, *plan, part, tickets), (lin, mel), dev,
        spectrograms, stage_cycles=stamps)


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
        self.plan = spectrogram_plan(
            self.mel_basis, hann_window(self.win_length, self.n_fft),
            self.hop_length, self.device)

    def signal(self, y) -> Tensor:
        return torch.as_tensor(np.asarray(y, np.float32)).to(self.device)

    def spectrograms(self, y) -> tuple:
        """(T_samples,) -> (linear (num_freq, F), mel (num_mels, F)) dB."""
        lin, mel = spectrograms(self.signal(y), self.plan)
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
