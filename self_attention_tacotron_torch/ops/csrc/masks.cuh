// Counter-based masks of the training kernels: the same bits as
// ops/masks.py ``mask_uniform`` (five lowbias32 rounds over seed, step,
// mask id, row, column; the top 24 bits times 2^-24, exact in float32).
#pragma once

#include <cstdint>

// mask ids (ops/masks.py): prenet layer i is id i, then the zoneout masks
constexpr int MASK_ZC_ATT = 4, MASK_ZO_ATT = 5, MASK_ZC1 = 6, MASK_ZO1 = 7,
              MASK_ZC2 = 8, MASK_ZO2 = 9;

__host__ __device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352dU;
  x ^= x >> 15;
  x *= 0x846ca68bU;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float mask_uniform(uint32_t seed, int step, int id,
                                              int row, int col) {
  uint32_t h = mix32(seed ^ 0x9e3779b9U);
  h = mix32(h ^ (uint32_t)step);
  h = mix32(h ^ (uint32_t)id);
  h = mix32(h ^ (uint32_t)row);
  h = mix32(h ^ (uint32_t)col);
  return (float)(h >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

// 1 where the unit keeps its new value (probability 1 - rate), else 0
__device__ __forceinline__ float mask_keep(uint32_t seed, int step, int id,
                                           int row, int col, float rate) {
  return mask_uniform(seed, step, id, row, col) >= rate ? 1.f : 0.f;
}
