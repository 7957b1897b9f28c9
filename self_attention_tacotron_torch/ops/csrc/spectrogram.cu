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
// direct DFT as a product on the tensor cores.  Only the window's non-zero
// taps [t0, t1) count (the others add exact zeros), and taps t and N - t
// share a cos and, with opposite signs, a sin, so they are folded: Re X =
// U C and Im X = V S with U, V (F x Ns) the windowed frames' u[s] = x[s] +
// x[N - s] and v[s] = x[s] - x[N - s] over the Ns folded taps (551 for
// n_fft 1998 and a 1102-tap window, against 1998 taps) and C, S (Ns x K)
// each bin's cos and -sin.  A cos tile and a sin tile of the same 8 bins
// put Re X[k] and Im X[k] in the same accumulator slot of one thread.  A
// block of 8 warps owns 64 frames x 128 bins (13 x 8 = 104 blocks at
// n_fft 1998, 10 s), a warp 32 x 32, and walks the folded taps in chunks
// of 16: cp.async copies chunk c + 2's samples (a frame's x[s] and x[N -
// s], and the window, reflected as numpy pads) into a stage while chunk c
// + 1's fragments are built from the stage into shared memory, already in
// mma fragment order and split for 3xTF32 (U's and V's from the samples,
// C's and S's from the twiddle table, a float64 value rounded once, read
// at the exact index k s mod N, which is stepped along s by an add and a
// compare; the table in shared memory while it fits, else read through
// L1), and chunk c is multiplied (mma.cuh's m16n8k8: three products an
// 8-deep step, each step summed from zero and added in f32 outside the
// tensor core); warps w and w + 4 share a scheduler, so one builds while
// the other multiplies.  One barrier a chunk.  The epilogue: the linear dB
// stored from the registers, the magnitudes in shared memory, each mel
// row whose band lies in the tile summed and written there, a band across
// tiles leaving its share to a scratch of (bin tiles, F, M); then a ticket
// per frame tile (an acq_rel atomic, reset by the last arrival, as the
// attention kernels' tickets) and the last tile of a frame tile to finish
// adds those shares in tile order and writes their dB.  One launch, the
// same outputs from call to call (no sum depends on which block ends
// first).  The JAX kernel's dense DFT products, on the tensor cores over
// the folded taps: 2 F Ns 2K FLOPs (1.77 G at n_fft 1998, 10 s; 0.011 ms
// at 3xTF32's 165 TFLOP/s).
//
// Bound on an H100: bytes.  The signal in, lin and mel out, the band
// weights, window and twiddles (4.46 MB at LJSpeech widths, 10 s: F = 802,
// N = 2048, K = 1025, M = 80; 1.3 us at 3.35 TB/s) against ~5 (N / 2)
// log2(N / 2) + 10 N / 2 FLOPs a frame plus the epilogue (57 MFLOP, 0.9 us
// at 67 TFLOP/s).  Its time sits above the bound because a block's FFT
// stages are a chain of shared-memory passes and __syncthreads.
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "mma.cuh"

struct SpecArgs {      // mirrored by _SpecArgs in ops/stft.py
  const float* y;       // (T,)
  const float* window;  // (N,)
  const float2* tw;     // (N,) exp(-2 pi i k / N)
  const int* band;      // (M, 3): first bin, bins, offset into band_w
  const float* band_w;  // the bands' weights
  float* lin;           // (F, K)
  float* mel;           // (F, M)
  int T, F, N, hop, M;
  // the direct DFT only
  int t0, t1;           // the window's non-zero taps [t0, t1)
  float* part;          // (bin tiles, F, M): each tile's share of the mels
  unsigned* tickets;    // (frame tiles) zeroed words; each call leaves 0
  int nw;               // the band weights' count
  long long* stamps;    // nullptr, or DFT_STAMPS words a block (profile)
};

namespace {

constexpr int NT = 256;
constexpr int NWARPS = NT / 32;
constexpr float kDb = 8.685889638065036f;   // 20 / ln 10
constexpr float kFloor = 1e-5f;
constexpr int MAX_FFT = 16384;   // the FFT's two buffers: 8 N bytes
constexpr int MAX_DFT = 32768;   // the direct DFT's longest n_fft
// the direct DFT's tiles: 64 frames (4 m16 tiles) x 128 bins (16 n8 tiles
// of bins, each with a cos and a sin tile) a block, 16 folded taps (2
// 8-deep steps) a chunk; a warp takes 2 m16 tiles x 4 bin tiles
constexpr int DFT_FT = 64;
constexpr int DFT_BT = 128;
constexpr int DFT_KC = 16;
constexpr int DFT_STEPS = DFT_KC / 8;
constexpr int DFT_MT = DFT_FT / 16;
constexpr int DFT_OCT = DFT_BT / 8;
constexpr int DFT_A_SETS = DFT_STEPS * DFT_MT * 32;   // fragment sets a chunk
constexpr int DFT_B_SETS = DFT_STEPS * DFT_OCT * 32;
constexpr int DFT_MAG_LD = DFT_BT + 1;   // the magnitude tile's row
// shared memory: rings of two chunks, A's (U hi, U lo, V hi, V lo) and B's
// (cos, sin) fragment sets and the samples they are built from (a frame's
// x[s] then x[N - s] of the chunk's taps, rows padded to 36 floats, then
// the two window rows); the mel bands and, up to DFT_W_MAX, their
// weights; the twiddle table where the block still fits (DFT_SMEM_MAX)
constexpr int DFT_A_SLOT = 4 * DFT_A_SETS;            // uint4 a ring slot
constexpr int DFT_B_SLOT = 2 * DFT_B_SETS;
constexpr int DFT_ROW = 2 * DFT_KC + 4;               // floats a staged frame
constexpr int DFT_STAGE = DFT_FT * DFT_ROW + 2 * DFT_KC;
constexpr int DFT_RING_BYTES = 2 * (DFT_A_SLOT + DFT_B_SLOT) * 16 +
                               2 * DFT_STAGE * 4;
// an H100 block's most shared memory (227 KB), less 16 bytes for the
// kernel's static words (last, n_cross)
constexpr size_t DFT_SMEM_MAX = 232448 - 16;
constexpr int DFT_W_MAX = 4096;   // band weights held in shared memory
// a profiled launch's words a block: the global timer (ns) at its start and
// after its prologue, loop, magnitudes, mel shares, ticket and tail (0 but
// in the frame tile's last block), then whether it was that last block
constexpr int DFT_STAMPS = 8;
static_assert(DFT_FT * DFT_MAG_LD * 4 <= 2 * DFT_B_SLOT * 16,
              "the magnitude tile reuses the B ring");
static_assert(DFT_A_SETS == NT && DFT_B_SETS == 4 * NT &&
                  DFT_OCT == 2 * NWARPS,
              "a thread builds 1 A and 4 B fragment sets a chunk");

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

// 3xTF32 halves of four values: hi returned, lo through ``lo``
__device__ __forceinline__ uint4 tf32_split4(float a, float b, float c,
                                             float d, uint4& lo) {
  uint4 hi;
  tf32_split(a, hi.x, lo.x);
  tf32_split(b, hi.y, lo.y);
  tf32_split(c, hi.z, lo.z);
  tf32_split(d, hi.w, lo.w);
  return hi;
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// kTab: the twiddle table in shared memory; kProf: a profiled launch
// (a.stamps), thread 0 stamping the end of each phase
template <bool kTab, bool kProf>
__global__ void __launch_bounds__(NT, 1) spectrogram_dft_kernel(SpecArgs a) {
  extern __shared__ uint4 ring[];
  uint4* a_ring = ring;                        // [2][4][DFT_A_SETS]
  uint4* b_ring = a_ring + 2 * DFT_A_SLOT;     // [2][2][DFT_B_SETS]
  float* stage = reinterpret_cast<float*>(b_ring + 2 * DFT_B_SLOT);
  int* band_s = reinterpret_cast<int*>(stage + 2 * DFT_STAGE);
  float* w_s = reinterpret_cast<float*>(band_s + 3 * a.M);
  const bool w_in_smem = a.nw <= DFT_W_MAX;
  const int w_len = w_in_smem ? a.nw : 0;
  float2* tab_s = reinterpret_cast<float2*>(
      w_s + w_len + ((3 * a.M + w_len) & 1));
  __shared__ int last, n_cross;
  const int N = a.N, K = N / 2 + 1, F = a.F, T = a.T;
  const int k0 = blockIdx.x * DFT_BT, f0 = blockIdx.y * DFT_FT;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  long long* const stamps =
      kProf ? a.stamps + (blockIdx.y * (size_t)gridDim.x + blockIdx.x) *
                             DFT_STAMPS
            : nullptr;
  auto stamp = [&](int i) {
    if constexpr (kProf)
      if (tid == 0) stamps[i] = global_ns();
  };
  stamp(0);
  // the table and the bands by cp.async, waited for with the first stage
  if (kTab)
    for (int i = tid; i < 2 * N; i += NT)
      cp4(reinterpret_cast<float*>(tab_s) + i,
          reinterpret_cast<const float*>(a.tw) + i, true);
  for (int i = tid; i < 3 * a.M; i += NT)
    cp4(reinterpret_cast<float*>(band_s) + i,
        reinterpret_cast<const float*>(a.band) + i, true);
  for (int i = tid; i < w_len; i += NT) cp4(w_s + i, a.band_w + i, true);
  if (tid == 0) n_cross = 0;
  // the folded taps: x[s] and x[N - s] share cos(2 pi k s / N) and, with
  // opposite signs, sin, so Re X = sum_s u[s] cos, Im X = sum_s v[s] (-sin)
  // over s in [s_lo, s_hi] with u = x[s] + x[N - s], v = x[s] - x[N - s]
  // (no partner for s = 0 or s = N / 2): taps t <= N / 2 fold to s = t,
  // the others to s = N - t, so [s_lo, s_hi] covers every non-zero tap
  const int h = N / 2;
  const bool low = a.t0 <= h && a.t0 < a.t1, high = a.t1 - 1 > h;
  const int s_hi = max(low ? min(a.t1 - 1, h) : -1,
                       high ? N - max(a.t0, h + 1) : -1);
  const int s_lo = s_hi < 0 ? 0 : min(low ? a.t0 : N, high ? N - a.t1 + 1 : N);

  // the samples of chunk c into stage slot sl with cp.async (zeros past
  // s_hi, past the frames and without a partner): thread e of the block's
  // 64 x 32 copies takes frame e / 32, x[s] (e % 32 < 16) or x[N - s] of
  // folded tap e % 16; threads 0..31 also copy the window rows.  ``fold``:
  // 0 a tile inside the signal, 1 one reflection at its ends (a signal of
  // at least N / 2 + 1 samples), 2 reflect() (shorter ones)
  auto stage_copies = [&](int c, int sl, auto fold) {
    float* st = stage + sl * DFT_STAGE;
    const int j = lane & (DFT_KC - 1), s = s_lo + c * DFT_KC + j;
    const int p = N - s;
    const bool in = s <= s_hi, pair = in && p < N && p != s;
    const int t = lane < DFT_KC ? (in ? s : 0) : (pair ? p : 0);
    const bool tap_ok = lane < DFT_KC ? in : pair;
#pragma unroll
    for (int i = 0; i < DFT_FT / NWARPS; ++i) {
      const int fl = w + NWARPS * i, f = f0 + fl;
      const int x = min(f, F - 1) * a.hop - N / 2 + t;
      int ix = x;
      if constexpr (decltype(fold)::value == 1) {
        ix = x < 0 ? -x : x;
        ix = ix >= T ? 2 * (T - 1) - ix : ix;
      } else if constexpr (decltype(fold)::value == 2) {
        ix = (unsigned)x < (unsigned)T ? x : reflect(x, T);
      }
      cp4(st + fl * DFT_ROW + lane, a.y + ix, tap_ok && f < F);
    }
    if (w == 0) cp4(st + DFT_FT * DFT_ROW + lane, a.window + t, tap_ok);
    cp_commit();
  };
  // whether a frame of the tile reads past the signal's ends
  const bool edge = f0 * a.hop - N / 2 < 0 ||
                    (min(f0 + DFT_FT, F) - 1) * a.hop - N / 2 + N > T;
  const std::integral_constant<int, 0> inside{};
  const std::integral_constant<int, 1> once{};
  const std::integral_constant<int, 2> general{};
  if (s_hi >= s_lo) {
    stage_copies(0, 0, general);
    stage_copies(1, 1, general);
  }
  cp_wait();
  __syncthreads();

  // A: this thread's fragment set is m16 tile (tid / 32) % 4 of step
  // tid / 128: frames 16 mt + g (+ 8), folded taps 8 st + q (+ 4)
  const int a_mt = (tid >> 5) & (DFT_MT - 1), a_st = tid >> 7;
  const int a_row = (16 * a_mt + g) * DFT_ROW, a_tap = 8 * a_st + q;
  // B: this thread's fragment sets are bin tiles w and w + 8 of both
  // steps: bins k0 + 8 (w + 8 h) + g, folded taps q and q + 4; idx[h][r]
  // = bin * tap mod N, stepped 8 taps at a time
  int idx[2][2], inc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int bin = k0 + 8 * (w + NWARPS * h) + g;
    inc[h] = 8 * bin % N;
#pragma unroll
    for (int r = 0; r < 2; ++r) idx[h][r] = bin * (s_lo + q + 4 * r) % N;
  }
  auto twiddle = [&](int i) {
    return kTab ? tab_s[i] : __ldg(a.tw + i);
  };

  // chunk c from stage slot sl into ring slot sl, in mma.cuh's m16n8k8
  // fragment order
  auto build = [&](int sl) {
    // A: x = window * y; a0..a3 = (g, q), (g + 8, q), (g, q + 4), (g + 8,
    // q + 4)
    const float* st = stage + sl * DFT_STAGE;
    const float* wrow = st + DFT_FT * DFT_ROW;
    float u[4], v[4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = a_tap + 4 * r;
      const float ws = wrow[j], wp = wrow[DFT_KC + j];
#pragma unroll
      for (int fh = 0; fh < 2; ++fh) {
        const float* row = st + a_row + 8 * fh * DFT_ROW;
        const float xs = ws * row[j], xp = wp * row[DFT_KC + j];
        u[2 * r + fh] = xs + xp;
        v[2 * r + fh] = xs - xp;
      }
    }
    uint4* as = a_ring + sl * DFT_A_SLOT + tid;
    uint4 lo;
    as[0] = tf32_split4(u[0], u[1], u[2], u[3], lo);
    as[DFT_A_SETS] = lo;
    as[2 * DFT_A_SETS] = tf32_split4(v[0], v[1], v[2], v[3], lo);
    as[3 * DFT_A_SETS] = lo;
    // B: (cos, sin) of both taps, hi then lo
#pragma unroll
    for (int s = 0; s < DFT_STEPS; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 t0 = twiddle(idx[h][0]), t1 = twiddle(idx[h][1]);
        uint4 cs, sn;
        tf32_split(t0.x, cs.x, cs.z);
        tf32_split(t1.x, cs.y, cs.w);
        tf32_split(t0.y, sn.x, sn.z);
        tf32_split(t1.y, sn.y, sn.w);
        uint4* bs = b_ring + sl * DFT_B_SLOT +
                    (s * DFT_OCT + w + NWARPS * h) * 32 + lane;
        bs[0] = cs;
        bs[DFT_B_SETS] = sn;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          idx[h][r] += inc[h];
          if (idx[h][r] >= N) idx[h][r] -= N;
        }
      }
  };

  // warp w: frames 32 (w / 4) .. + 31 (m16 tiles 2 (w / 4) + m), bins
  // 32 (w % 4) .. + 31 (bin tiles 4 (w % 4) + j); re / im of each.  Chunk
  // c + 2's samples are copied while chunk c + 1 is built from the stage
  // and chunk c multiplied from the ring (the build and the products in
  // one straight run of code, past the last chunk too, where they are
  // never read, so that they interleave); one barrier a chunk
  const int mw = w >> 2, nw = w & 3;
  float re[2][4][4] = {}, im[2][4][4] = {};
  const int chunks = s_hi >= s_lo ? (s_hi - s_lo + DFT_KC) / DFT_KC : 0;
  if (chunks > 0) build(0);
  __syncthreads();
  stamp(1);
  auto products = [&](int sl) {
    const uint4* as = a_ring + sl * DFT_A_SLOT + lane;
    const uint4* bs = b_ring + sl * DFT_B_SLOT + lane;
#pragma unroll
    for (int st = 0; st < DFT_STEPS; ++st) {
      uint32_t uh[2][4], ul[2][4], vh[2][4], vl[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int set = (st * DFT_MT + 2 * mw + m) * 32;
        const uint4 x0 = as[set], x1 = as[DFT_A_SETS + set];
        const uint4 x2 = as[2 * DFT_A_SETS + set];
        const uint4 x3 = as[3 * DFT_A_SETS + set];
        uh[m][0] = x0.x; uh[m][1] = x0.y; uh[m][2] = x0.z; uh[m][3] = x0.w;
        ul[m][0] = x1.x; ul[m][1] = x1.y; ul[m][2] = x1.z; ul[m][3] = x1.w;
        vh[m][0] = x2.x; vh[m][1] = x2.y; vh[m][2] = x2.z; vh[m][3] = x2.w;
        vl[m][0] = x3.x; vl[m][1] = x3.y; vl[m][2] = x3.z; vl[m][3] = x3.w;
      }
      uint32_t ch[4][2], cl[4][2], nh[4][2], nl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int set = (st * DFT_OCT + 4 * nw + j) * 32;
        const uint4 cs = bs[set], sn = bs[DFT_B_SETS + set];
        ch[j][0] = cs.x; ch[j][1] = cs.y; cl[j][0] = cs.z; cl[j][1] = cs.w;
        nh[j][0] = sn.x; nh[j][1] = sn.y; nl[j][0] = sn.z; nl[j][1] = sn.w;
      }
      // mma3's three products (lo hi, hi lo, hi hi from zero, then added
      // to the sums in f32), each a pass over the 16 tiles so that no
      // product waits on the one before
      float d[2][4][2][4] = {};
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_tf32(d[m][j][0], ul[m], ch[j]);
          mma_tf32(d[m][j][1], vl[m], nh[j]);
        }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_tf32(d[m][j][0], uh[m], cl[j]);
          mma_tf32(d[m][j][1], vh[m], nl[j]);
        }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_tf32(d[m][j][0], uh[m], ch[j]);
          mma_tf32(d[m][j][1], vh[m], nh[j]);
        }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            re[m][j][e] += d[m][j][0][e];
            im[m][j][e] += d[m][j][1][e];
          }
    }
  };
  // warps w and w + 4 share a scheduler: one builds while the other
  // multiplies, then the other way round
  auto run = [&](auto fold) {
    for (int c = 0; c < chunks; ++c) {
      const int sl = c & 1;
      stage_copies(c + 2, sl, fold);
      if (w & 4) {
        products(sl);
        build(sl ^ 1);
      } else {
        build(sl ^ 1);
        products(sl);
      }
      cp_wait();
      __syncthreads();
    }
  };
  if (!edge)
    run(inside);
  else if (T >= 2 && T >= N / 2 + 1)
    run(once);
  else
    run(general);
  stamp(2);

  // the magnitudes of the block's 64 x 128 tile: lane (g, q) holds bins
  // 2 q, 2 q + 1 of its bin tiles at rows g and g + 8; their linear dB
  // stored from the registers (a row's four lanes write 32 bytes in a
  // run), the magnitudes kept in the free B ring for the mel sums
  float* mag = reinterpret_cast<float*>(b_ring);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int fl = 16 * (2 * mw + m) + g, bl = 8 * (4 * nw + j) + 2 * q;
      const float* xr = re[m][j];
      const float* xi = im[m][j];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = fl + 8 * (e >> 1), col = bl + (e & 1);
        const float v = sqrtf(xr[e] * xr[e] + xi[e] * xi[e]);
        mag[row * DFT_MAG_LD + col] = v;
        if (f0 + row < F && k0 + col < K)
          a.lin[(size_t)(f0 + row) * K + k0 + col] =
              kDb * __logf(fmaxf(kFloor, v));
      }
    }
  __syncthreads();
  stamp(3);
  // each mel row's share of this tile's bins, a thread a (frame, row): a
  // band inside the tile is the row's whole sum and its dB is written
  // here (an empty band by the tile of its first bin); a band across
  // tiles leaves its share to the scratch for the tail
  const int kend = min(k0 + DFT_BT, K), fl = tid % DFT_FT, fr = f0 + fl;
  auto spans = [&](int first, int cnt) {   // the band crosses a tile edge
    return cnt > 0 && first / DFT_BT != (first + cnt - 1) / DFT_BT;
  };
  for (int m0 = 0; m0 < a.M; m0 += NT / DFT_FT) {
    const int m = m0 + tid / DFT_FT;
    if (m >= a.M || fr >= F) continue;
    const int first = band_s[3 * m], cnt = band_s[3 * m + 1];
    const int lo = max(first, k0), hi = min(first + cnt, kend);
    if (lo >= hi && !(cnt == 0 && first / DFT_BT == (int)blockIdx.x))
      continue;
    const float* wt =
        (w_in_smem ? w_s : a.band_w) + band_s[3 * m + 2] - first;
    float share = 0.f;
#pragma unroll 4
    for (int k = lo; k < hi; ++k)
      share = fmaf(wt[k], mag[fl * DFT_MAG_LD + k - k0], share);
    if (spans(first, cnt))
      a.part[((size_t)blockIdx.x * F + fr) * a.M + m] = share;
    else
      a.mel[(size_t)fr * a.M + m] = kDb * __logf(fmaxf(kFloor, share));
  }

  // the ticket: thread 0's atom.add.acq_rel after the block barrier
  // releases the block's shares and, for the last bin tile, acquires the
  // others'; the second barrier hands that to the block
  __syncthreads();
  stamp(4);
  if (tid == 0) {
    unsigned v;
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;"
                 : "=r"(v) : "l"(a.tickets + blockIdx.y) : "memory");
    last = v == gridDim.x - 1;
    if (last) a.tickets[blockIdx.y] = 0u;   // every tile has its ticket
  }
  __syncthreads();
  stamp(5);
  if constexpr (kProf)
    if (tid == 0) {
      stamps[6] = 0;
      stamps[7] = last;
    }
  if (!last) return;
  // the tail: the frame tile's rows whose bands cross tiles (listed
  // first), the shares in tile order (each band's first two loaded at
  // once, any later after)
  int* cross = reinterpret_cast<int*>(a_ring);
  for (int m = tid; m < a.M; m += NT)
    if (spans(band_s[3 * m], band_s[3 * m + 1]))
      cross[atomicAdd(&n_cross, 1)] = m;
  __syncthreads();
  const int nc = n_cross, items = min(DFT_FT, F - f0) * nc;
  for (int e = tid; e < items; e += NT) {
    const int m = cross[e % nc], fe = f0 + e / nc;
    const int first = band_s[3 * m], cnt = band_s[3 * m + 1];
    const int b0 = first / DFT_BT, b1 = (first + cnt - 1) / DFT_BT;
    const float* src = a.part + ((size_t)b0 * F + fe) * a.M + m;
    const size_t tile = (size_t)F * a.M;
    float sum = __ldcg(src);
    sum += __ldcg(src + tile);
    for (int bt = b0 + 2; bt <= b1; ++bt)
      sum += __ldcg(src + (bt - b0) * tile);
    a.mel[(size_t)fe * a.M + m] = kDb * __logf(fmaxf(kFloor, sum));
  }
  if constexpr (kProf) {
    __syncthreads();
    stamp(6);
  }
}

}  // namespace

extern "C" int spectrogram_launch(const SpecArgs* args, void* stream) {
  const SpecArgs a = *args;
  if (a.T < 1 || a.F < 1 || a.hop < 1 || a.M < 0 || a.N < 1 || a.N > MAX_DFT)
    return (int)cudaErrorInvalidValue;
  const bool fft = a.N >= 8 && a.N <= MAX_FFT && !(a.N & (a.N - 1));
  if (!fft && (a.t0 < 0 || a.t1 < a.t0 || a.t1 > a.N ||
               (a.M > 0 && a.part == nullptr) || a.tickets == nullptr))
    return (int)cudaErrorInvalidValue;
  // the FFT: 2 x N / 2 complex; the DFT: its rings and stage, the bands
  // and weights, and the twiddle table (8-byte aligned) where the block
  // still fits, else the table is read through L1
  const int w_len = a.nw <= DFT_W_MAX ? a.nw : 0;
  const size_t ints = 3 * (size_t)a.M + w_len + ((3 * a.M + w_len) & 1);
  const size_t dft = DFT_RING_BYTES + 4 * ints;
  const bool tab = dft + 8 * (size_t)a.N <= DFT_SMEM_MAX;
  const size_t smem = fft ? (size_t)a.N * sizeof(float2)
                          : dft + (tab ? 8 * (size_t)a.N : 0);
  // a profile takes the table in shared memory only
  const bool prof = !fft && a.stamps != nullptr;
  if (prof && !tab) return (int)cudaErrorInvalidValue;
  const void* fn = fft    ? (const void*)spectrogram_kernel
                   : prof ? (const void*)spectrogram_dft_kernel<true, true>
                   : tab  ? (const void*)spectrogram_dft_kernel<true, false>
                          : (const void*)spectrogram_dft_kernel<false, false>;
  cudaError_t e;
  if (smem > 48 * 1024 &&
      (e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)) != cudaSuccess)
    return (int)e;
  const cudaStream_t st = (cudaStream_t)stream;
  if (fft) {
    spectrogram_kernel<<<a.F, NT, smem, st>>>(a);
  } else {
    const int K = a.N / 2 + 1;
    const dim3 grid((K + DFT_BT - 1) / DFT_BT, (a.F + DFT_FT - 1) / DFT_FT);
    if (prof)
      spectrogram_dft_kernel<true, true><<<grid, NT, smem, st>>>(a);
    else if (tab)
      spectrogram_dft_kernel<true, false><<<grid, NT, smem, st>>>(a);
    else
      spectrogram_dft_kernel<false, false><<<grid, NT, smem, st>>>(a);
  }
  return (int)cudaGetLastError();
}
