// Softmax attention of up to NWARPS query rows of one head, on FP32 FMAs,
// for the shape the tensor-core path does not hold on chip: the encoder's
// hop once the source's K | V | Q rows no longer fit in a block's shared
// memory (csrc/fused_encoder.cu).
//
// Warp w of the block takes query row row0 + w (if w < nrows).  The keys
// stream through shared memory in tiles of ATT_TK rows, which all the
// block's warps share; a row's running max, sum and context (in shared
// memory, lanes over columns) follow the usual online softmax, so nothing
// grows with the number of keys.  A lane takes one key of a tile for the
// score (the tile's rows at an odd stride: free of bank conflicts), the
// warp its max and sum with shuffles, and lanes over the columns add p v
// from V's rows in device memory (coalesced, the same rows for every
// warp, so they come from L1).  Causal rows see keys <= their own index
// and never read past them; key 0 is visible to every row, so the running
// max is a real score after the first tile and a masked key weighs exactly
// 0, as the reference's -1e9 fill gives it.
//
// ``kL2``: the operands are read through L2 only (ld.global.cg), as the
// encoder needs, whose rows other blocks of its cluster wrote earlier in
// the same launch (an L1 line of an earlier hop would be stale); else
// through the read-only path, whose L1 serves V's rows to every warp.
// Called by every thread of the block (it has block barriers); ``smem``
// holds ``attend_rows_floats(D)`` floats.  ``T`` is the operands' element
// type: float, or __nv_bfloat16, read into the same float tiles and
// rounded once on the store.
#pragma once

#include <math.h>

#include "common.cuh"

constexpr int ATT_TK = 32;   // keys a tile: a lane a key

__host__ __device__ inline int att_ld(int D) { return D | 1; }

__host__ __device__ inline int attend_rows_floats(int D) {
  return ATT_TK * att_ld(D) + 2 * NWARPS * D + NWARPS * ATT_TK;
}

template <bool kL2, class T>
__device__ __forceinline__ float att_load(const T* p) {
  if constexpr (kL2) return wload(__ldcg(p));
  else return wload(__ldg(p));
}

template <bool kL2, class T>
__device__ inline void attend_rows(const T* q, int ldq, const T* k, int ldk,
                                   const T* v, int ldv, T* o, int ldo,
                                   int row0, int nrows, int Tk, int D,
                                   float scale, bool causal, float* smem) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ld = att_ld(D);
  float* sk = smem;
  float* sq = sk + ATT_TK * ld + warp * D;
  float* sacc = sk + ATT_TK * ld + NWARPS * D + warp * D;
  float* sp = sk + ATT_TK * ld + 2 * NWARPS * D + warp * ATT_TK;
  const int row = row0 + warp;
  const bool active = warp < nrows;
  __syncthreads();   // an earlier call's readers are done with the buffers
  if (active)
    for (int c = lane; c < D; c += 32) {
      sq[c] = att_load<kL2>(q + (size_t)row * ldq + c);
      sacc[c] = 0.f;
    }
  const int kend = causal && row0 + nrows < Tk ? row0 + nrows : Tk;
  float m = -INFINITY, l = 0.f;
  for (int j0 = 0; j0 < kend; j0 += ATT_TK) {
    const int nk = kend - j0 < ATT_TK ? kend - j0 : ATT_TK;
    __syncthreads();   // the last tile is consumed; sq is written
    for (int e = threadIdx.x; e < nk * D; e += NT) {
      const int r = e / D, c = e - r * D;
      sk[r * ld + c] = att_load<kL2>(k + (size_t)(j0 + r) * ldk + c);
    }
    __syncthreads();
    if (!active) continue;
    const int seen = causal ? row - j0 + 1 : nk;   // warp-uniform
    const int nv = seen < nk ? seen : nk;
    if (nv <= 0) continue;
    float s = -INFINITY;
    if (lane < nv) {
      const float* kr = sk + lane * ld;
      float d = 0.f;
      for (int c = 0; c < D; ++c) d = fmaf(sq[c], kr[c], d);
      s = d * scale;
    }
    const float mn = fmaxf(m, warp_max(s));
    const float p = lane < nv ? expf(s - mn) : 0.f;
    const float corr = expf(m - mn);   // 0 on the first tile
    l = fmaf(l, corr, warp_sum(p));
    sp[lane] = p;
    __syncwarp();
    for (int c = lane; c < D; c += 32) {
      float acc = sacc[c] * corr;
      const T* vc = v + (size_t)j0 * ldv + c;
      for (int j = 0; j < nv; ++j)
        acc = fmaf(sp[j], att_load<kL2>(vc + (size_t)j * ldv), acc);
      sacc[c] = acc;
    }
    __syncwarp();
    m = mn;
  }
  if (active) {
    const float inv = 1.f / l;
    for (int c = lane; c < D; c += 32)
      wstore(o + (size_t)row * ldo + c, sacc[c] * inv);
  }
}
