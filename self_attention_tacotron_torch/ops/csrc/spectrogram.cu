// Linear and mel spectrograms in dB from windowed frames.  Replaces the JAX
// package's ops/stft.py ``_spectrogram_kernel`` (Pallas, reached through
// ``pallas_spectrograms`` and ``MelExtractor``): the STFT of
// ``preprocess --on-device``.
//
//   re  = frames @ wr,  im = frames @ wi          (F, N) x (N, K)
//   mag = sqrt(re^2 + im^2)
//   lin = 20 / ln 10 * ln(max(1e-5, mag))         (F, K)
//   mel = 20 / ln 10 * ln(max(1e-5, mag @ mel_t)) (F, K) x (K, M)
//
// Two launches on the caller's stream.  The first is a tile product: one
// 256-thread block per 64 frames x 64 bins, the frame tile and the cos and
// sin tiles staged through shared memory 16 taps at a time, each thread
// holding 4 x 4 real and 4 x 4 imaginary FP32 sums; its epilogue writes the
// magnitude (a scratch the mel product reads) and the linear dB.  The mel
// product needs a frame's whole magnitude row, which spans every bin tile,
// so it is the second launch: one block per 32 frames x 32 mels, 2 x 2 sums
// a thread, then the dB.
//
// Bound on an H100: operations.  4 F N K FLOPs for the two DFT products
// (plus 2 F K M for the mel one) against ~2 F (N + K) floats moved: at
// LJSpeech widths (N = 2048, K = 1025, M = 80) and F = 802 frames (10 s)
// that is 6.87 GFLOP, 0.10 ms at 67 TFLOP/s of FP32 FMAs.  This first
// version is simple and right, not fast: no tensor cores, no FFT, and it
// multiplies the window's zero taps too.
#include <cuda_runtime.h>
#include <math.h>

struct SpecArgs {
  const float* frames;  // (F, N)
  const float* wr;      // (N, K)
  const float* wi;      // (N, K)
  const float* mel_t;   // (K, M)
  float* mag;           // (F, K) scratch
  float* lin;           // (F, K)
  float* mel;           // (F, M)
  int F, N, K, M;
};

namespace {

constexpr int NT = 256;
constexpr float kDb = 8.685889638065036f;   // 20 / ln 10
constexpr float kFloor = 1e-5f;

// ------------------------------------------------------ DFT tile product
constexpr int BM = 64, BN = 64, BK = 16;

__global__ void __launch_bounds__(NT) dft_kernel(SpecArgs a) {
  __shared__ float sa[BK][BM + 1];   // frame tile, transposed
  __shared__ float sr[BK][BN];       // cos tile
  __shared__ float si[BK][BN];       // sin tile
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int f0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  float re[4][4], im[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.f;

  for (int k0 = 0; k0 < a.N; k0 += BK) {
#pragma unroll
    for (int e = 0; e < BM * BK / NT; ++e) {   // 16 taps of a frame row
      const int idx = threadIdx.x + e * NT;
      const int r = idx / BK, k = idx % BK;
      const int f = f0 + r, n = k0 + k;
      sa[k][r] = (f < a.F && n < a.N) ? __ldg(a.frames + (size_t)f * a.N + n)
                                      : 0.f;
    }
#pragma unroll
    for (int e = 0; e < BK * BN / NT; ++e) {   // 64 bins of a tap row
      const int idx = threadIdx.x + e * NT;
      const int k = idx / BN, c = idx % BN;
      const int n = k0 + k, col = n0 + c;
      const bool in = n < a.N && col < a.K;
      const size_t off = (size_t)n * a.K + col;
      sr[k][c] = in ? __ldg(a.wr + off) : 0.f;
      si[k][c] = in ? __ldg(a.wi + off) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float x[4], cr[4], ci[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = sa[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        cr[j] = sr[k][tx + 16 * j];
        ci[j] = si[k][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          re[i][j] = fmaf(x[i], cr[j], re[i][j]);
          im[i][j] = fmaf(x[i], ci[j], im[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = f0 + ty + 16 * i;
    if (f >= a.F) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col >= a.K) continue;
      const float m = sqrtf(re[i][j] * re[i][j] + im[i][j] * im[i][j]);
      const size_t off = (size_t)f * a.K + col;
      a.mag[off] = m;
      a.lin[off] = kDb * logf(fmaxf(kFloor, m));
    }
  }
}

// ----------------------------------------------------- mel tile product
constexpr int MM = 32, MN = 32, MK = 32;

__global__ void __launch_bounds__(NT) mel_kernel(SpecArgs a) {
  __shared__ float sm[MK][MM + 1];   // magnitude tile, transposed
  __shared__ float sb[MK][MN];       // filterbank tile
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int f0 = blockIdx.x * MM, m0 = blockIdx.y * MN;
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int k0 = 0; k0 < a.K; k0 += MK) {
#pragma unroll
    for (int e = 0; e < MM * MK / NT; ++e) {
      const int idx = threadIdx.x + e * NT;
      const int r = idx / MK, k = idx % MK;
      const int f = f0 + r, n = k0 + k;
      sm[k][r] = (f < a.F && n < a.K) ? a.mag[(size_t)f * a.K + n] : 0.f;
    }
#pragma unroll
    for (int e = 0; e < MK * MN / NT; ++e) {
      const int idx = threadIdx.x + e * NT;
      const int k = idx / MN, c = idx % MN;
      const int n = k0 + k, col = m0 + c;
      sb[k][c] = (n < a.K && col < a.M)
                     ? __ldg(a.mel_t + (size_t)n * a.M + col) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < MK; ++k) {
      const float x0 = sm[k][ty], x1 = sm[k][ty + 16];
      const float b0 = sb[k][tx], b1 = sb[k][tx + 16];
      acc[0][0] = fmaf(x0, b0, acc[0][0]);
      acc[0][1] = fmaf(x0, b1, acc[0][1]);
      acc[1][0] = fmaf(x1, b0, acc[1][0]);
      acc[1][1] = fmaf(x1, b1, acc[1][1]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int f = f0 + ty + 16 * i;
    if (f >= a.F) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = m0 + tx + 16 * j;
      if (col < a.M)
        a.mel[(size_t)f * a.M + col] = kDb * logf(fmaxf(kFloor, acc[i][j]));
    }
  }
}

}  // namespace

extern "C" int spectrogram_launch(const SpecArgs* args, void* stream) {
  const SpecArgs a = *args;
  if (a.F < 1 || a.N < 1 || a.K < 1 || a.M < 1)
    return (int)cudaErrorInvalidValue;
  const int bin_tiles = (a.K + BN - 1) / BN, mel_tiles = (a.M + MN - 1) / MN;
  if (bin_tiles > 65535 || mel_tiles > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dft_kernel<<<dim3((a.F + BM - 1) / BM, bin_tiles), NT, 0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  mel_kernel<<<dim3((a.F + MM - 1) / MM, mel_tiles), NT, 0, s>>>(a);
  return (int)cudaGetLastError();
}
