// Throughput of mma.sync m16n8k8 TF32 on the card, for the port's kernels
// that run their products in the 3xTF32 split (csrc/mma.cuh ``mma3``):
//
//   kind 0  8 independent accumulators a warp, each mma adding in place
//           (8 dependent chains that never wait on anything else);
//   kind 1  the split's pattern: 8 ``mma3`` a warp, each three dependent
//           mma from zero whose sum is added in f32 outside the tensor core,
//           in program order (volatile asm): each mma waits for the one
//           before, so a round takes 24 of its latencies.
//
// Kind 1 takes operands that differ from chain to chain and round to round
// (an integer xor a round), or the compiler would share and hoist its
// products, which start from zero.  Each of ``blocks`` blocks of
// ``warps`` warps runs ``iters`` rounds; thread 0 of each block writes the
// SM cycles its block took to cycles[block].  scripts/torch_mma_probe.py
// launches one block an SM and reports mma a cycle an SM.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void mma_v(float (&d)[4], const uint32_t (&a)[4],
                                     const uint32_t (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
                 "r"(b[1]));
}

// mma3's pattern: three dependent products from zero, summed outside
__device__ __forceinline__ void mma3_v(float (&acc)[4], const uint32_t (&a)[4],
                                      const uint32_t (&b)[2]) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_v(d, a, b);
  mma_v(d, a, b);
  mma_v(d, a, b);
#pragma unroll
  for (int c = 0; c < 4; ++c) acc[c] += d[c];
}

template <int KIND>
__global__ void mma_probe_kernel(int iters, long long* cycles, float* sink) {
  uint32_t a[8][4], b[2];
  for (int j = 0; j < 8; ++j)
    for (int i = 0; i < 4; ++i)
      a[j][i] = __float_as_uint(1.f + 1e-3f * threadIdx.x + i + 8 * j);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(0.5f + i);
  float d[8][4];
  for (int j = 0; j < 8; ++j)
    for (int c = 0; c < 4; ++c) d[j][c] = 0.f;
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    const uint32_t bb[2] = {b[0] ^ (uint32_t)it, b[1] ^ (uint32_t)it};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (KIND == 0)
        mma_v(d[j], a[j], b);
      else
        mma3_v(d[j], a[j], bb);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) cycles[blockIdx.x] = clock64() - t0;
  float s = 0.f;
  for (int j = 0; j < 8; ++j)
    for (int c = 0; c < 4; ++c) s += d[j][c];
  if (s == 1234.5f) sink[0] = s;   // keeps the products
}

}  // namespace

extern "C" int mma_probe_launch(int kind, int blocks, int warps, int iters,
                                long long* cycles, float* sink,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == 0)
    mma_probe_kernel<0><<<blocks, 32 * warps, 0, s>>>(iters, cycles, sink);
  else
    mma_probe_kernel<1><<<blocks, 32 * warps, 0, s>>>(iters, cycles, sink);
  return (int)cudaGetLastError();
}
