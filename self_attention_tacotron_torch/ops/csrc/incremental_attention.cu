// One query (B, H, D) against (B, H, S, D) key and value caches masked to
// positions <= t.  Replaces the JAX package's ops/pallas_attention.py
// ``_incremental_kernel`` (Pallas, reached through
// ``incremental_attention_step``): the per-step self-attention of every
// decoder hop in the Pallas attention mode (the trainer's VALIDATION decodes
// and the early-exit serving decode).
//
// One block per (b * h).  q sits in shared memory; each warp takes positions
// p <= t four at a time, its lanes split the D-long dot products, and the
// scores stay in shared memory.  Block reductions give the max and the sum (the softmax
// shifted by the max, as the reference's); then the threads, in NT / D
// groups of D, accumulate p * v over interleaved positions and the first D
// threads add the groups' partial rows.  t is a kernel argument, so the
// caller never waits for the device, and positions > t are never read (the
// TPU kernel reads the whole padded cache and masks it with -1e9, which
// gives these positions a weight of exactly 0).
//
// Bound on an H100: bytes, the 2 (t + 1) D floats of K and V rows a (b, h)
// for 4 (t + 1) D FLOPs; at B = 1, H = 2, D = 128, t = 249 that is 0.51 MB,
// ~0.15 us at 3.35 TB/s, far below the cost of a launch, which dominates a
// step.  This first version is simple and right, not fast: one block per head
// leaves most SMs idle at batch 1.
#include <math.h>

#include "common.cuh"

struct StepArgs {
  const float* q;   // (B * H, D)
  const float* k;   // (B * H, S, D)
  const float* v;
  float* o;         // (B * H, D)
  int bh;           // B * H
  int S;
  int D;
  int t;
  float scale;      // 1 / sqrt(D)
};

namespace {

constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 200 * 1024;   // of the 227 KB a block may use

__global__ void __launch_bounds__(NT) incremental_attention_kernel(StepArgs a) {
  extern __shared__ float smem[];
  __shared__ float red[NWARPS];
  const int D = a.D, n = a.t + 1;
  float* sq = smem;         // [D]
  float* sp = sq + D;       // [n] scores, then exp(score - max)
  float* part = sp + n;     // [NT / D][D] partial contexts
  const size_t cache = (size_t)blockIdx.x * a.S * D;
  for (int d = threadIdx.x; d < D; d += NT)
    sq[d] = __ldg(a.q + (size_t)blockIdx.x * D + d);
  __syncthreads();

  // a warp takes 4 positions at a time, so that their loads are in flight
  // together
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int p0 = 4 * warp; p0 < n; p0 += 4 * NWARPS) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d = lane; d < D; d += 32) {
      const float qd = sq[d];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (p0 + j < n)
          acc[j] = fmaf(qd, __ldg(a.k + cache + (size_t)(p0 + j) * D + d),
                        acc[j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float dot = warp_sum(acc[j]);
      if (lane == 0 && p0 + j < n) sp[p0 + j] = dot * a.scale;
    }
  }
  __syncthreads();

  float mx = -INFINITY;
  for (int p = threadIdx.x; p < n; p += NT) mx = fmaxf(mx, sp[p]);
  mx = block_max(mx, red);
  float sum = 0.f;
  for (int p = threadIdx.x; p < n; p += NT) {
    const float e = expf(sp[p] - mx);
    sp[p] = e;
    sum += e;
  }
  sum = block_sum(sum, red);   // its barriers publish sp

  const int groups = NT / D;
  const int g = threadIdx.x / D, d = threadIdx.x - g * D;
  if (g < groups) {   // four independent sums keep four loads in flight
    const float* vc = a.v + cache + d;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    int p = g;
    for (; p + 3 * groups < n; p += 4 * groups) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[j] = fmaf(sp[p + j * groups],
                      __ldg(vc + (size_t)(p + j * groups) * D), acc[j]);
    }
    for (; p < n; p += groups)
      acc[0] = fmaf(sp[p], __ldg(vc + (size_t)p * D), acc[0]);
    part[g * D + d] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  }
  __syncthreads();
  if (threadIdx.x < D) {
    float acc = 0.f;
    for (int j = 0; j < groups; ++j) acc += part[j * D + threadIdx.x];
    a.o[(size_t)blockIdx.x * D + threadIdx.x] = acc / sum;
  }
}

}  // namespace

extern "C" int incremental_attention_launch(const StepArgs* args,
                                            void* stream) {
  const StepArgs a = *args;
  if (a.bh < 1 || a.D < 1 || a.D > NT || a.t < 0 || a.t >= a.S)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(a.D + a.t + 1 + NT) * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        incremental_attention_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  incremental_attention_kernel<<<a.bh, NT, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
