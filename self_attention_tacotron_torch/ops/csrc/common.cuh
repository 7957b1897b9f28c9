// Building blocks shared by the port's persistent cooperative kernels.
//
// Both serving kernels run as ONE cooperative launch with one block per SM;
// a grid-wide barrier separates dependent stages: cooperative_groups'
// this_grid().sync() in the encoder, the hand-written GridBarrier below in
// the decode.  Data another block wrote in an earlier stage is read
// with __ldcg (L2, never a stale L1 line); weights and inputs with __ldg.
//
//   warp_sum / warp_max, block_sum / block_max   reductions
//   lstm_cell                                    zoneout LSTM update (i,g,f,o)
//   gemm_stage                                   M x N tile product with an
//                                                A loader and an epilogue
//                                                functor (the encoder's
//                                                sequence-wide layers)
//   gemv_stage                                   one output column per warp
//                                                over rows held in shared
//                                                memory (the decoder's steps)
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

constexpr int NT = 256;             // threads per block
constexpr int NWARPS = NT / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Every thread of the block gets the total.  ``red`` holds NWARPS floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  __syncthreads();
  if (l == 0) red[w] = v;
  __syncthreads();
  return warp_sum(l < NWARPS ? red[l] : 0.f);
}

__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  __syncthreads();
  if (l == 0) red[w] = v;
  __syncthreads();
  return warp_max(l < NWARPS ? red[l] : -3.0e38f);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// Zoneout LSTM step from gate pre-activations (forget bias already folded),
// deterministic inference mix of the new and previous states.
__device__ __forceinline__ void lstm_cell(float gi, float gg, float gf,
                                          float go, float c_prev, float h_prev,
                                          float zc, float zo, float& c_new,
                                          float& h_new) {
  float c = c_prev * sigmoid(gf) + sigmoid(gi) * tanhf(gg);
  float h = tanhf(c) * sigmoid(go);
  if (zc > 0.f) c = (1.f - zc) * c + zc * c_prev;
  if (zo > 0.f) h = (1.f - zo) * h + zo * h_prev;
  c_new = c;
  h_new = h;
}

// A grid-wide barrier written by hand, for a cooperative launch (which
// guarantees that every block is resident): one arrival counter that only
// grows (a 32-bit word of the kernel's scratch, zeroed by the launcher
// before each launch; GRID_BAR_WORDS words, one 128-byte line, are
// reserved).  At its e-th barrier, after __syncthreads, thread 0 of each
// block adds 1 with atom.add.acq_rel.gpu and, unless the value it gets
// back shows that it arrived last, spins with ld.acquire.gpu until the
// counter reaches e * gridDim.x; a second __syncthreads extends the
// release and the acquire to the whole block (bar.sync orders a block's
// threads; release and acquire are cumulative).  The counter wraps after
// 2^32 / gridDim.x barriers (32 M at 132 blocks), far beyond one launch.
// On an H100 it costs 1.10 us against cooperative groups' 1.28 us
// (scripts/torch_grid_barrier_probe.py, which also times the designs that
// lost: a counter with a generation word, a word a block, red.release with
// a relaxed spin and a fence).
constexpr int GRID_BAR_WORDS = 32;

struct GridBarrier {
  unsigned* count;
  unsigned target;   // thread 0: e * gridDim.x at the e-th barrier
  __device__ explicit GridBarrier(void* w)
      : count(static_cast<unsigned*>(w)), target(0) {}
  __device__ void sync() {
    __syncthreads();
    if (threadIdx.x == 0) {
      target += gridDim.x;
      unsigned v;
      asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;"
                   : "=r"(v) : "l"(count) : "memory");
      for (++v; (int)(v - target) < 0;)
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                     : "=r"(v) : "l"(count) : "memory");
    }
    __syncthreads();
  }
};

// Optional per-stage profile: block 0's thread 0 reads its SM's cycle
// counter after each grid barrier and adds the cycles since the previous
// mark to counts[stage].  With counts == nullptr it does nothing.
struct StageClock {
  long long* counts;
  long long last;
  __device__ explicit StageClock(long long* c) : counts(c), last(0) {
    if (on()) last = clock64();
  }
  __device__ bool on() const {
    return counts != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  }
  __device__ void mark(int stage) {
    if (on()) {
      const long long now = clock64();
      counts[stage] += now - last;
      last = now;
    }
  }
};

// ------------------------------------------------------------ tile product
constexpr int TM = 32, TN = 32, TK = 128;

struct GemmSmem {
  float a[TK][TM + 1];  // A tile, transposed, padded against bank conflicts
  float w[TK][TN];
};

// Accumulate tile (m0, n0) of A (M x Kd) @ W (Kd x N, row-major, leading
// dim ldw) over k in [k_begin, k_end) into acc: thread (ty = warp,
// tx = lane) owns rows m0 + ty + 8 i of column n0 + tx.  ``aload(m, k)``
// gives A[m][k] (a window of a sequence, a pooled value, ...).
template <class ALoad>
__device__ void tile_product(int M, int N, int Kd, int m0, int n0,
                             int k_begin, int k_end, const ALoad& aload,
                             const float* __restrict__ W, int ldw,
                             float (&acc)[TM / NWARPS], GemmSmem& sm) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < TM / NWARPS; ++i) acc[i] = 0.f;
  for (int k0 = k_begin; k0 < k_end; k0 += TK) {
    __syncthreads();
#pragma unroll 4
    for (int e = threadIdx.x; e < TM * TK; e += NT) {
      const int mm = e / TK, kk = e % TK, m = m0 + mm, k = k0 + kk;
      sm.a[kk][mm] = (m < M && k < k_end) ? aload(m, k) : 0.f;
    }
#pragma unroll 4
    for (int e = threadIdx.x; e < TK * TN; e += NT) {
      const int kk = e / TN, nn = e % TN, k = k0 + kk, n = n0 + nn;
      sm.w[kk][nn] = (k < k_end && n < N) ? __ldg(W + (size_t)k * ldw + n)
                                          : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < TK; ++kk) {
      const float wv = sm.w[kk][tx];
#pragma unroll
      for (int i = 0; i < TM / NWARPS; ++i)
        acc[i] = fmaf(sm.a[kk][ty + NWARPS * i], wv, acc[i]);
    }
  }
}

// C (M x N) = A @ W, tiles of 32 x 32 spread over the blocks, then
// ``epi(m, n, acc, valid)``, called by all 32 lanes of a warp together
// (lanes may shuffle; ``valid`` marks m < M, n < N).
template <class ALoad, class Epi>
__device__ void gemm_stage(int M, int N, int Kd, const ALoad& aload,
                           const float* __restrict__ W, int ldw,
                           const Epi& epi, GemmSmem& sm) {
  const int tiles_n = (N + TN - 1) / TN;
  const int tiles = ((M + TM - 1) / TM) * tiles_n;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  float acc[TM / NWARPS];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_n) * TM, n0 = (tile % tiles_n) * TN;
    tile_product(M, N, Kd, m0, n0, 0, Kd, aload, W, ldw, acc, sm);
#pragma unroll
    for (int i = 0; i < TM / NWARPS; ++i) {
      const int m = m0 + ty + NWARPS * i, n = n0 + tx;
      epi(m, n, acc[i], m < M && n < N);
    }
  }
  __syncthreads();
}

// The same product for a deep K and few output tiles: the K chunks are
// split over up to ``max_splits`` blocks per tile, each writes its partial
// tile to ``part`` (max_splits * M * N floats), and after a grid barrier
// one warp per (row, 32 columns) sums the partials and runs ``epi``.
template <class ALoad, class Epi>
__device__ void gemm_stage_split_k(int M, int N, int Kd, const ALoad& aload,
                                   const float* __restrict__ W, int ldw,
                                   const Epi& epi, GemmSmem& sm, float* part,
                                   int max_splits, cg::grid_group& grid) {
  const int tiles_n = (N + TN - 1) / TN;
  const int tiles = ((M + TM - 1) / TM) * tiles_n;
  const int chunks = (Kd + TK - 1) / TK;
  int splits = gridDim.x / tiles;
  if (splits > max_splits) splits = max_splits;
  if (splits > chunks) splits = chunks;
  if (splits < 1) splits = 1;
  const int kper = ((chunks + splits - 1) / splits) * TK;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  float acc[TM / NWARPS];
  for (int item = blockIdx.x; item < tiles * splits; item += gridDim.x) {
    const int tile = item % tiles, sp = item / tiles;
    const int m0 = (tile / tiles_n) * TM, n0 = (tile % tiles_n) * TN;
    const int k_begin = sp * kper;
    const int k_end = k_begin + kper < Kd ? k_begin + kper : Kd;
    tile_product(M, N, Kd, m0, n0, k_begin, k_end, aload, W, ldw, acc, sm);
#pragma unroll
    for (int i = 0; i < TM / NWARPS; ++i) {
      const int m = m0 + ty + NWARPS * i, n = n0 + tx;
      if (m < M && n < N) part[((size_t)sp * M + m) * N + n] = acc[i];
    }
  }
  grid.sync();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int w = warp;; w += NWARPS) {
    const int item = blockIdx.x + gridDim.x * w;
    if (item >= M * tiles_n) break;
    const int m = item / tiles_n, n = (item % tiles_n) * TN + lane;
    const bool valid = n < N;
    float sum = 0.f;
    if (valid)
      for (int sp = 0; sp < splits; ++sp)
        sum += __ldcg(part + ((size_t)sp * M + m) * N + n);
    epi(m, n, sum, valid);
  }
  __syncthreads();
}

// Row-major A read through L2 (it was written earlier in the same kernel).
struct RowLoad {
  const float* p;
  int ld;
  __device__ float operator()(int m, int k) const {
    return __ldcg(p + (size_t)m * ld + k);
  }
};

// ------------------------------------------------- warp-per-column product
// Items n of a stage belong to block n % gridDim.x; that block's s-th item
// is n = blockIdx.x + gridDim.x * s and its R weight rows (rows r * N + n of
// the (R * N, Lr) matrix) sit at slice + s * R * Lr in shared memory.

__host__ __device__ inline int slice_items(int N, int nb) {
  return (N + nb - 1) / nb;
}

// Copy this block's rows of W (R * N, Lr) into ``dst``.
__device__ inline void load_slice(float* dst, const float* __restrict__ W,
                                  int N, int R, int Lr) {
  const int b = blockIdx.x, nb = gridDim.x;
  const int cnt = N > b ? (N - b + nb - 1) / nb : 0;
  const int total = cnt * R * Lr;
  for (int e = threadIdx.x; e < total; e += NT) {
    const int k = e % Lr, sr = e / Lr, r = sr % R, s = sr / R;
    const int n = b + nb * s;
    dst[e] = __ldg(W + ((size_t)r * N + n) * Lr + k);
  }
}

// The same block's bias entries b[r * N + n] of its items, at
// dst[s * R + r].
__device__ inline void load_bias_slice(float* dst, const float* __restrict__ b,
                                       int N, int R) {
  const int blk = blockIdx.x, nb = gridDim.x;
  const int cnt = N > blk ? (N - blk + nb - 1) / nb : 0;
  for (int e = threadIdx.x; e < cnt * R; e += NT) {
    const int r = e % R, s = e / R;
    dst[e] = __ldg(b + (size_t)r * N + blk + nb * s);
  }
}

// Each warp dots its item's R rows with ``x`` (shared memory, Lr floats);
// ``epi(n, s, acc)`` runs on lane 0 with the item, its slot s in this
// block, and the R sums.
template <int R, class Epi>
__device__ void gemv_stage(int N, int Lr, const float* slice, const float* x,
                           const Epi& epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int s = warp;; s += NWARPS) {
    const int n = blockIdx.x + gridDim.x * s;
    if (n >= N) break;
    const float* w = slice + (size_t)s * R * Lr;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int k = lane; k < Lr; k += 32) {
      const float xv = x[k];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(w[r * Lr + k], xv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = warp_sum(acc[r]);
    if (lane == 0) epi(n, s, acc);
  }
}
