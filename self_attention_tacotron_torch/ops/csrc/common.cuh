// Building blocks shared by the port's persistent cooperative kernels.
//
// The serving and training kernels run as cooperative launches with one
// block per SM; the hand-written GridBarrier below separates dependent
// stages.  Data another block wrote in an earlier stage is read with
// __ldcg (L2, never a stale L1 line); weights and inputs with __ldg.
//
//   warp_sum / warp_max, block_sum   reductions
//   lstm_cell                        zoneout LSTM update (i, g, f, o)
//   GridBarrier, StageClock          grid barrier, per-stage profile
//   load_slice / load_bias_slice     a block's weight rows of a
//                                    warp-per-column product (the decode)
//   wload / wstore / xround, kIsBf16 the bf16 conversions (storage mode,
//                                    bf16 attention operands)
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
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

// ------------------------------------------------- warp-per-column product
// Items n of a stage belong to block n % gridDim.x; that block's s-th item
// is n = blockIdx.x + gridDim.x * s and its R weight rows (rows r * N + n of
// the (R * N, Lr) matrix) sit at slice + s * R * Lr in shared memory.

__host__ __device__ inline int slice_items(int N, int nb) {
  return (N + nb - 1) / nb;
}

// ------------------------------------------------- bf16 storage mode
// A weight of type W (float or __nv_bfloat16) read as f32, and an f32
// activation rounded to W's precision before it enters a product (round
// to nearest even, as the JAX kernels' astype); both identities for f32.
template <class W>
constexpr bool kIsBf16 = false;
template <>
constexpr bool kIsBf16<__nv_bfloat16> = true;

__device__ __forceinline__ float wload(float x) { return x; }
__device__ __forceinline__ float wload(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// A float result stored as T (bf16: rounded to nearest even once).
__device__ __forceinline__ void wstore(float* p, float x) { *p = x; }
__device__ __forceinline__ void wstore(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <class W>
__device__ __forceinline__ float xround(float x) {
  if constexpr (kIsBf16<W>)
    return __bfloat162float(__float2bfloat16_rn(x));
  else
    return x;
}

// Copy this block's rows of W (R * N, Lr) into ``dst`` (elements of T).
template <class T>
__device__ inline void load_slice(T* dst, const T* __restrict__ W, int N,
                                  int R, int Lr) {
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
