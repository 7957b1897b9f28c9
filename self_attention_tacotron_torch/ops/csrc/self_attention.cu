// softmax(Q K^T / sqrt(D)) V over (B, H, T, D) float32 tensors, optionally
// causal.  Replaces the JAX package's ops/pallas_attention.py
// ``_attention_kernel`` (Pallas, reached through ``fused_self_attention``):
// the Pallas attention mode's full-sequence self-attention hop.
//
// One block per (b * h, 64-row query tile).  K and V stream through shared
// memory in 64-key tiles with an online softmax in FP32 (a running max and
// sum per row), so no (rows, T) score row is kept: T may be thousands of
// steps (the SIWIS recipe decodes up to 3000).  Causal tiles past the
// diagonal are skipped.  Keys >= T and, when causal, keys past the query take
// the reference's -1e9 fill; key 0 is visible to every row, so each running
// max is a real score after the first tile and masked keys add exp(-1e9 - m)
// = 0.  The width D is padded to a template width DP in {16, 32, 64, 128}
// (zeros in q, k and v past D; only the first D output columns are written).
//
// Thread layout: 256 threads = 16 row groups (ty) x 16 lanes (tx); thread
// (ty, tx) owns query rows 4 ty .. 4 ty + 3 and, in each tile, keys tx + 16 j
// (j < 4) and output columns tx + 16 c (c < DP / 16).  K is stored
// transposed and rows are padded by one float, so the reads of both products
// are free of bank conflicts.  A row's max and sum reduce over its 16 lanes,
// which sit in one half of a warp.
//
// Bound on an H100: FP32 operations, 4 T^2 D FLOPs a (b, h) (2 T^2 D causal),
// e.g. 2.15 GFLOP at B = 32, H = 2, T = 256, D = 128, ~32 us at 67 TFLOP/s;
// at the serving shapes (B = 1, T <= 64) it is a few MFLOP and the launch
// dominates.  This first version runs both products on FP32 FMAs from shared
// memory (no tensor cores, no TMA): simple and right, not fast.
#include <math.h>

#include "common.cuh"

struct AttnArgs {
  const float* q;   // (B * H, T, D) each
  const float* k;
  const float* v;
  float* o;
  int bh;           // B * H
  int T;
  int D;
  int causal;
  float scale;      // 1 / sqrt(D)
};

namespace {

constexpr int BQ = 64;   // query rows a block
constexpr int BK = 64;   // keys a tile
constexpr float NEG_FILL = -1e9f;

template <int DP>
constexpr size_t smem_floats() {
  return (size_t)BQ * (DP + 1) + (size_t)DP * (BK + 1) + (size_t)BK * DP +
         (size_t)BQ * (BK + 1);
}

// max / sum over the 16 lanes of a half warp
__device__ __forceinline__ float lanes16_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float lanes16_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

template <int DP>
__global__ void __launch_bounds__(NT) self_attention_kernel(AttnArgs a) {
  constexpr int NC = DP / 16;            // output columns a thread
  extern __shared__ float smem[];
  float* sq = smem;                      // [BQ][DP + 1]
  float* skt = sq + BQ * (DP + 1);       // [DP][BK + 1]  K transposed
  float* sv = skt + DP * (BK + 1);       // [BK][DP]
  float* sp = sv + BK * DP;              // [BQ][BK + 1]  probabilities
  const int T = a.T, D = a.D;
  const size_t base = (size_t)blockIdx.y * T * D;
  const int q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  for (int e = threadIdx.x; e < BQ * DP; e += NT) {
    const int r = e / DP, d = e - r * DP;
    sq[r * (DP + 1) + d] = (q0 + r < T && d < D)
                               ? __ldg(a.q + base + (size_t)(q0 + r) * D + d)
                               : 0.f;
  }
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  const int last_row = min(q0 + BQ, T) - 1;
  const int k_end = a.causal ? last_row + 1 : T;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous tile's readers are done
    for (int e = threadIdx.x; e < BK * DP; e += NT) {
      const int r = e / DP, d = e - r * DP;
      const bool in = k0 + r < T && d < D;
      const size_t g = base + (size_t)(k0 + r) * D + d;
      skt[d * (BK + 1) + r] = in ? __ldg(a.k + g) : 0.f;
      sv[r * DP + d] = in ? __ldg(a.v + g) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = skt[d * (BK + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = sq[(ty * 4 + i) * (DP + 1) + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv, kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        float x = s[i][j] * a.scale;
        if (key >= T || (a.causal && key > row)) x = NEG_FILL;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], lanes16_max(mx));
      const float alpha = expf(m[i] - m_new);   // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sp[(ty * 4 + i) * (BK + 1) + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + lanes16_sum(sum);
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = sv[j * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sp[(ty * 4 + i) * (BK + 1) + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= T) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) a.o[base + (size_t)row * D + col] = acc[i][c] / l[i];
    }
  }
}

template <int DP>
int launch(const AttnArgs& a, cudaStream_t stream) {
  const size_t smem = smem_floats<DP>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      self_attention_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.T + BQ - 1) / BQ, a.bh);
  self_attention_kernel<DP><<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int self_attention_launch(const AttnArgs* args, void* stream) {
  const AttnArgs a = *args;
  if (a.T < 1 || a.bh < 1 || a.bh > 65535 || a.D < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (a.D <= 16) return launch<16>(a, s);
  if (a.D <= 32) return launch<32>(a, s);
  if (a.D <= 64) return launch<64>(a, s);
  if (a.D <= 128) return launch<128>(a, s);
  return (int)cudaErrorInvalidValue;
}
