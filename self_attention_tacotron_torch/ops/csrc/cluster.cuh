// Thread-block cluster exchanges shared by the port's kernels: the
// encoder's recurrence (fused_encoder.cu: h of a step to the direction's
// blocks) and the bf16 cache step's merge (incremental_attention.cu: each
// block's partial softmax state to the cluster's first block).  A block
// stores into another block's shared memory with st.async, each store
// completing its bytes on the destination's mbarrier; the destination
// waits on its own mbarrier only.  The mbarrier must be initialised before
// any store reaches it: the cluster's blocks arrive at a cluster barrier
// after the initialisation and wait on it before their first store.
#pragma once

#include "mma.cuh"

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0, spins = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (++spins > (1u << 22)) __trap();   // a lost store fails the launch
  }
}

// the address of this block's shared ``p`` in block ``rank`` of the cluster
__device__ __forceinline__ unsigned cluster_addr(const void* p, int rank) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ void st_async(unsigned dst, unsigned bar,
                                         float v) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32"
               " [%0], %1, [%2];\n"
               :: "r"(dst), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

// A cluster barrier split in two: every thread of the cluster arrives
// (release: what it wrote before, an mbarrier's initialisation included,
// is visible to the cluster after the wait) and later waits; work between
// the two overlaps the barrier.  Both are .aligned: every thread of a warp
// executes them together.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
