// Linear and mel spectrograms in dB from the signal, in one launch.
// Replaces the JAX package's ops/stft.py ``_spectrogram_kernel`` (Pallas,
// reached through ``pallas_spectrograms`` and ``MelExtractor``): the STFT of
// ``preprocess --on-device``.  For frame f of the (T,) signal y (N = n_fft,
// hop h, K = N / 2 + 1 bins, M mels):
//
//   x[t]   = window[t] * y[reflect(f h + t - N / 2)]          t < N
//   X[k]   = sum_t x[t] exp(-2 pi i k t / N)                  k < K
//   lin[f] = 20 / ln 10 * ln(max(1e-5, |X|))                  (F, K)
//   mel[f] = 20 / ln 10 * ln(max(1e-5, |X| @ mel_t))          (F, M)
//
// reflect() is numpy's "reflect" padding, folded again for a signal shorter
// than the pad (the index arithmetic of ops/stft.py ``reflect_indices``).
//
// Design: one 256-thread block a frame.  The TPU kernel multiplies
// materialised frames with two dense (N, K) cos and sin matrices on the
// MXU; on the card that is 4 F N K FLOPs of FP32 FMAs over ~2 F (N + K)
// floats of frames read from device memory, the window's zero taps
// included.  Here a block reads its frame's samples straight from the
// signal (the frames overlap, so most reads hit L2), with the window
// applied as it loads, and computes a real-input FFT in shared memory: the
// N real samples as an (N / 2)-point complex FFT (even samples real, odd
// imaginary), radix-4 Stockham stages between two (N / 2)-point buffers
// (the first stage reads the signal itself; a last radix-2 stage when
// log2(N / 2) is odd), then the split pass X[k] = E[k] + W_N^k O[k].  Twiddles
// come from a table computed on the host in float64 and rounded to float32
// (``twiddles``; __sinf / __cosf would cost the 2e-5-of-the-peak
// tolerance).  The epilogue stays in the block: magnitude, linear dB
// written once (logf, not __logf), the magnitudes kept in the free buffer,
// then one warp a mel row sums the row's band of bins only (the triangular
// filters touch each bin at most twice; ``mel_bands``) and writes its dB.
// No frames, no magnitude scratch and no second launch.
//
// An n_fft that is not a power of two, or too long for the FFT's two
// buffers (N > 16384), takes ``spectrogram_dft_kernel`` instead: the
// windowed frame in shared memory, then a thread a bin sums the direct
// DFT X[k] = sum_t x[t] W^(k t) with W^(k t) taken from the same twiddle
// table (a float64 value rounded once, at index k t mod N kept by an add
// and a compare) every 16 samples and rotated by W^k in between (15
// complex products: a relative error of ~1e-6 at most), and the same
// epilogue, the magnitudes kept after the
// frame (6 N bytes of shared memory: N <= MAX_DFT).  O(N K) a frame
// instead of O(N log N): the JAX kernel's own arithmetic (its dense DFT
// products), on FP32 FMAs.
//
// Bound on an H100: bytes.  The signal in, lin and mel out, the band
// weights, window and twiddles (4.46 MB at LJSpeech widths, 10 s: F = 802,
// N = 2048, K = 1025, M = 80; 1.3 us at 3.35 TB/s) against ~5 (N / 2)
// log2(N / 2) + 10 N / 2 FLOPs a frame plus the epilogue (57 MFLOP, 0.9 us
// at 67 TFLOP/s).  Its time sits above the bound because a block's FFT
// stages are a chain of shared-memory passes and __syncthreads.
#include <cuda_runtime.h>
#include <math.h>

struct SpecArgs {      // mirrored by _SpecArgs in ops/stft.py
  const float* y;       // (T,)
  const float* window;  // (N,)
  const float2* tw;     // (N,) exp(-2 pi i k / N)
  const int* band;      // (M, 3): first bin, bins, offset into band_w
  const float* band_w;  // the bands' weights
  float* lin;           // (F, K)
  float* mel;           // (F, M)
  int T, F, N, hop, M;
};

namespace {

constexpr int NT = 256;
constexpr int NWARPS = NT / 32;
constexpr float kDb = 8.685889638065036f;   // 20 / ln 10
constexpr float kFloor = 1e-5f;
constexpr int MAX_FFT = 16384;   // the FFT's two buffers: 8 N bytes
constexpr int MAX_DFT = 32768;   // the DFT's frame and magnitudes: 6 N
constexpr int DFT_RESYNC = 16;   // samples between exact twiddles

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// numpy's mode="reflect" index of i (which may lie outside [0, T))
__device__ __forceinline__ int reflect(int i, int T) {
  if (T == 1) return 0;
  const int period = 2 * (T - 1);
  int m = i % period;
  if (m < 0) m += period;
  return m < T ? m : period - m;
}

// the epilogue of both kernels: mag[k] (k < K) in shared memory -> the mel
// rows' dB, a warp a row over its band of bins
__device__ void mel_rows(const SpecArgs& a, const float* mag, int f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < a.M; r += NWARPS) {
    const int first = __ldg(a.band + 3 * r), cnt = __ldg(a.band + 3 * r + 1);
    const float* w = a.band_w + __ldg(a.band + 3 * r + 2);
    float acc = 0.f;
    for (int j = lane; j < cnt; j += 32)
      acc = fmaf(__ldg(w + j), mag[first + j], acc);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) a.mel[(size_t)f * a.M + r] = kDb * logf(fmaxf(kFloor, acc));
  }
}

__global__ void __launch_bounds__(NT) spectrogram_kernel(SpecArgs a) {
  extern __shared__ float2 buf[];   // two buffers of n complex values
  const int n = a.N >> 1, f = blockIdx.x;
  const int tid = threadIdx.x;
  const int start = f * a.hop - n;  // the frame's first sample, unpadded
  // z[j] = x[2j] + i x[2j + 1]: the windowed frame, straight from y
  auto load = [&](int j) {
    const float w0 = __ldg(a.window + 2 * j);
    const float w1 = __ldg(a.window + 2 * j + 1);
    const int s = start + 2 * j;
    return make_float2(w0 != 0.f ? w0 * __ldg(a.y + reflect(s, a.T)) : 0.f,
                       w1 != 0.f ? w1 * __ldg(a.y + reflect(s + 1, a.T))
                                 : 0.f);
  };

  // Stockham stages: with p the product of the radices so far, input i of
  // a radix-R butterfly reads element i + r n / R, twiddles it by
  // exp(-2 pi i r k / (R p)) (k = i mod p; table entry r k N / (R p)) and
  // writes element ((i - k) R + k) + r p; the result is in natural order.
  float2* src = buf;
  float2* dst = buf + n;
  int p = 1;
  for (; 4 * p <= n; p *= 4) {
    const int q = n >> 2, step = (n >> 1) / p;  // r k N / (4 p) = r k step
    for (int i = tid; i < q; i += NT) {
      const int k = i & (p - 1);
      float2 u0, u1, u2, u3;
      if (p == 1) {
        u0 = load(i);
        u1 = load(i + q);
        u2 = load(i + 2 * q);
        u3 = load(i + 3 * q);
      } else {
        u0 = src[i];
        u1 = cmul(src[i + q], __ldg(a.tw + k * step));
        u2 = cmul(src[i + 2 * q], __ldg(a.tw + 2 * k * step));
        u3 = cmul(src[i + 3 * q], __ldg(a.tw + 3 * k * step));
      }
      const float2 a0 = cadd(u0, u2), a1 = csub(u0, u2);
      const float2 a2 = cadd(u1, u3), d = csub(u1, u3);
      const float2 a3 = make_float2(d.y, -d.x);   // -i (u1 - u3)
      const int j = ((i - k) << 2) + k;
      dst[j] = cadd(a0, a2);
      dst[j + p] = cadd(a1, a3);
      dst[j + 2 * p] = csub(a0, a2);
      dst[j + 3 * p] = csub(a1, a3);
    }
    __syncthreads();
    float2* t = src;
    src = dst;
    dst = t;
  }
  if (p < n) {  // n = 2 p: one radix-2 stage
    const int q = n >> 1, step = n / p;       // k N / (2 p) = k step
    for (int i = tid; i < q; i += NT) {
      const int k = i & (p - 1);
      const float2 u0 = p == 1 ? load(i) : src[i];
      const float2 u1 = p == 1 ? load(i + q)
                               : cmul(src[i + q], __ldg(a.tw + k * step));
      const int j = ((i - k) << 1) + k;
      dst[j] = cadd(u0, u1);
      dst[j + p] = csub(u0, u1);
    }
    __syncthreads();
    float2* t = src;
    src = dst;
    dst = t;
  }

  // split pass: E = (Z[k] + conj Z[n - k]) / 2 is the even samples' DFT,
  // O = -i (Z[k] - conj Z[n - k]) / 2 the odd ones', X[k] = E + W_N^k O;
  // the magnitudes go to the free buffer for the mel sums
  const int K = n + 1;
  float* mag = reinterpret_cast<float*>(dst);
  float* lin = a.lin + (size_t)f * K;
  for (int k = tid; k < K; k += NT) {
    const float2 zk = src[k & (n - 1)], zc = src[(n - k) & (n - 1)];
    const float er = 0.5f * (zk.x + zc.x), ei = 0.5f * (zk.y - zc.y);
    const float orr = 0.5f * (zk.y + zc.y), oi = -0.5f * (zk.x - zc.x);
    const float2 w = __ldg(a.tw + k);
    const float xr = er + w.x * orr - w.y * oi;
    const float xi = ei + w.x * oi + w.y * orr;
    const float m = sqrtf(xr * xr + xi * xi);
    mag[k] = m;
    lin[k] = kDb * logf(fmaxf(kFloor, m));
  }
  __syncthreads();
  mel_rows(a, mag, f);
}

__global__ void __launch_bounds__(NT) spectrogram_dft_kernel(SpecArgs a) {
  extern __shared__ float frame[];   // N samples, then K magnitudes
  const int N = a.N, K = N / 2 + 1, f = blockIdx.x;
  const int start = f * a.hop - N / 2;
  for (int t = threadIdx.x; t < N; t += NT) {
    const float w = __ldg(a.window + t);
    frame[t] = w != 0.f ? w * __ldg(a.y + reflect(start + t, a.T)) : 0.f;
  }
  __syncthreads();
  float* mag = frame + N;
  float* lin = a.lin + (size_t)f * K;
  for (int k = threadIdx.x; k < K; k += NT) {
    // twiddle W^(k t): the table's exact entry at every DFT_RESYNC-th
    // sample, rotated by W^k between them (a gather of scattered entries
    // a sample would bind the loop to L1's throughput)
    const float2 rot = __ldg(a.tw + k);
    const int jump = k * DFT_RESYNC % N;
    float re = 0.f, im = 0.f;
    int idx = 0;   // k t0 mod N
    for (int t0 = 0; t0 < N; t0 += DFT_RESYNC) {
      float2 w = __ldg(a.tw + idx);
      const int t1 = t0 + DFT_RESYNC < N ? t0 + DFT_RESYNC : N;
      for (int t = t0; t < t1; ++t) {
        re = fmaf(frame[t], w.x, re);
        im = fmaf(frame[t], w.y, im);
        w = cmul(w, rot);
      }
      idx += jump;
      if (idx >= N) idx -= N;
    }
    const float m = sqrtf(re * re + im * im);
    mag[k] = m;
    lin[k] = kDb * logf(fmaxf(kFloor, m));
  }
  __syncthreads();
  mel_rows(a, mag, f);
}

}  // namespace

extern "C" int spectrogram_launch(const SpecArgs* args, void* stream) {
  const SpecArgs a = *args;
  if (a.T < 1 || a.F < 1 || a.hop < 1 || a.M < 0 || a.N < 1 || a.N > MAX_DFT)
    return (int)cudaErrorInvalidValue;
  const bool fft = a.N >= 8 && a.N <= MAX_FFT && !(a.N & (a.N - 1));
  // the FFT: 2 x N / 2 complex; the DFT: N samples and K magnitudes
  const size_t smem = fft ? (size_t)a.N * sizeof(float2)
                          : (size_t)(a.N + a.N / 2 + 1) * sizeof(float);
  const void* fn = fft ? (const void*)spectrogram_kernel
                       : (const void*)spectrogram_dft_kernel;
  cudaError_t e;
  if (smem > 48 * 1024 &&
      (e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)) != cudaSuccess)
    return (int)e;
  if (fft)
    spectrogram_kernel<<<a.F, NT, smem, (cudaStream_t)stream>>>(a);
  else
    spectrogram_dft_kernel<<<a.F, NT, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
