// Cost probe of grid-wide barriers between the dependent stages of the
// port's cooperative kernels, NT threads a block.  One cooperative launch
// runs ``n`` barriers back to back; thread 0 of each block touches
// ``out[blockIdx.x]`` between them so the loop is not empty.  Kinds:
//   0  cooperative groups' this_grid().sync() (the fused encoder's);
//   1  an arrival counter and a generation word: thread 0 does one
//      atom.add.acq_rel.gpu on the counter, the last to arrive resets it
//      and bumps the generation with st.release.gpu, the others spin on
//      the generation with ld.acquire.gpu;
//   2  a word a block, no atomics: lane 0 of warp 0 stores its epoch with
//      st.release.gpu, warp 0 polls every block's word;
//   3  GridBarrier of common.cuh (the fused decode's): a counter that only
//      grows, atom.add.acq_rel and an ld.acquire spin on the same word;
//   4  the same counter with red.release (nothing comes back), a relaxed
//      spin and fence.acq_rel;
//   5  the same counter with red.release and an ld.acquire spin.
// ``words`` holds PROBE_WORDS words, zeroed here before the launch.
// Timed by scripts/torch_grid_barrier_probe.py.
#include "common.cuh"

namespace {

struct CounterBarrier {
  unsigned* count;
  unsigned* gen;
  unsigned local;
  __device__ explicit CounterBarrier(unsigned* w)
      : count(w), gen(w + 32), local(0) {}
  __device__ void sync() {
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned old, g;
      asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;"
                   : "=r"(old) : "l"(count) : "memory");
      if (old == gridDim.x - 1) {
        asm volatile("st.relaxed.gpu.global.u32 [%0], 0;"
                     :: "l"(count) : "memory");
        asm volatile("st.release.gpu.global.u32 [%0], %1;"
                     :: "l"(gen), "r"(local + 1) : "memory");
      } else {
        do {
          asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                       : "=r"(g) : "l"(gen) : "memory");
        } while (g == local);
      }
      ++local;
    }
    __syncthreads();
  }
};

constexpr int PROBE_WORDS = 256;   // kind 2: a word for each of <= 256 blocks

struct FlagBarrier {
  unsigned* words;
  unsigned epoch;
  __device__ explicit FlagBarrier(unsigned* w) : words(w), epoch(0) {}
  __device__ void sync() {
    __syncthreads();
    if (threadIdx.x < 32) {
      ++epoch;
      if (threadIdx.x == 0)
        asm volatile("st.release.gpu.global.u32 [%0], %1;"
                     :: "l"(words + blockIdx.x), "r"(epoch) : "memory");
      bool all;
      do {
        bool mine = true;
        for (int b = threadIdx.x; b < (int)gridDim.x; b += 32) {
          unsigned v;
          asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
                       : "=r"(v) : "l"(words + b) : "memory");
          mine &= (int)(v - epoch) >= 0;
        }
        all = __all_sync(FULL, mine);
      } while (!all);
      asm volatile("fence.acq_rel.gpu;" ::: "memory");
    }
    __syncthreads();
  }
};

template <bool kFence>
struct RedCountBarrier {
  unsigned* count;
  unsigned target;
  __device__ explicit RedCountBarrier(unsigned* w) : count(w), target(0) {}
  __device__ void sync() {
    __syncthreads();
    if (threadIdx.x == 0) {
      target += gridDim.x;
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;"
                   :: "l"(count) : "memory");
      unsigned v;
      do {
        if (kFence)
          asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
                       : "=r"(v) : "l"(count) : "memory");
        else
          asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                       : "=r"(v) : "l"(count) : "memory");
      } while ((int)(v - target) < 0);
      if (kFence) asm volatile("fence.acq_rel.gpu;" ::: "memory");
    }
    __syncthreads();
  }
};

template <class Barrier>
__device__ void run(Barrier& bar, int n, float* out) {
  for (int i = 0; i < n; ++i) {
    if (threadIdx.x == 0) out[blockIdx.x] += 1.f;
    bar.sync();
  }
}

__global__ void probe_kernel(int kind, int n, float* out, unsigned* words) {
  if (kind == 0) {
    cg::grid_group grid = cg::this_grid();
    run(grid, n, out);
  } else if (kind == 1) {
    CounterBarrier bar(words);
    run(bar, n, out);
  } else if (kind == 2) {
    FlagBarrier bar(words);
    run(bar, n, out);
  } else if (kind == 3) {
    GridBarrier bar(words);
    run(bar, n, out);
  } else if (kind == 4) {
    RedCountBarrier<true> bar(words);
    run(bar, n, out);
  } else {
    RedCountBarrier<false> bar(words);
    run(bar, n, out);
  }
}

}  // namespace

extern "C" int grid_barrier_probe_launch(int kind, int blocks, int n,
                                         float* out, unsigned* words,
                                         void* stream) {
  if (blocks > PROBE_WORDS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e =
      cudaMemsetAsync(words, 0, PROBE_WORDS * sizeof(unsigned), s);
  if (e != cudaSuccess) return (int)e;
  void* params[] = {&kind, &n, &out, &words};
  e = cudaLaunchCooperativeKernel((void*)probe_kernel, dim3(blocks), dim3(NT),
                                  params, 0, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
