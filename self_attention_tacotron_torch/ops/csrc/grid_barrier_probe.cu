// Cost probe of the grid-wide barrier the port's cooperative kernels put
// between dependent stages (cooperative_groups::this_grid().sync(), NT
// threads a block).  One cooperative launch runs ``n`` barriers back to
// back; thread 0 of each block touches ``out[blockIdx.x]`` between them so
// the loop is not empty.  Timed by scripts/torch_grid_barrier_probe.py.
#include "common.cuh"

__global__ void grid_barrier_probe_kernel(int n, float* out) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) {
    if (threadIdx.x == 0) out[blockIdx.x] += 1.f;
    grid.sync();
  }
}

extern "C" int grid_barrier_probe_launch(int blocks, int n, float* out,
                                         void* stream) {
  void* params[] = {&n, &out};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (void*)grid_barrier_probe_kernel, dim3(blocks), dim3(NT), params, 0,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
