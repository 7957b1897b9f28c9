// Tensor-core and copy helpers shared by the port's kernels: the 3xTF32
// split product on mma.sync (f32 accuracy from TF32 tensor cores; the
// training kernels, fused_train_{fwd,bwd}.cu, and the encoder,
// fused_encoder.cu), the bf16 products of the training kernels' bf16
// storage mode and of the attention kernels' bf16 instances, ldmatrix
// fragment loads, and cp.async copies into shared memory.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// ------------------------------------------------- tensor-core products
// 3xTF32: x ~= hi + lo, hi = x rounded to TF32 (11 significant bits,
// nearest), lo = x - hi (exact) rounded the same way, so hi + lo holds x
// to ~2^-22; a b ~= a_hi b_hi + a_hi b_lo + a_lo b_hi with f32
// accumulation keeps ~f32 accuracy (plain TF32 keeps ~3 digits, which the
// recurrence over 256 steps would compound).  The rounding is an integer
// add of half a TF32 ulp and a mask: two instructions, where
// cvt.rna.tf32.f32 costs a longer sequence.
__device__ __forceinline__ uint32_t tf32_rn(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rn(x);
  lo = tf32_rn(x - __uint_as_float(hi));
}

// d += a b for one m16n8k8 tile: a (16 x 8, row) fragment a0 = A[g][t],
// a1 = A[g + 8][t], a2 = A[g][t + 4], a3 = A[g + 8][t + 4]; b (8 x 8, col)
// b0 = B[t][g], b1 = B[t + 4][g]; d0..d3 = C[g][2t], C[g][2t + 1],
// C[g + 8][2t], C[g + 8][2t + 1] (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += a b in the split: the three products, the small ones first,
// start from zero in the tensor core and their sum is added to acc in f32
// outside it.  The tensor core aligns its addends to the largest and drops
// the bits below, so a long sum kept inside it drifts (~1e-6 relative over
// a K = 80 product on an H100); one 8-deep step at a time it stays at f32
// rounding.
__device__ __forceinline__ void mma3(float (&acc)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
#pragma unroll
  for (int c = 0; c < 4; ++c) acc[c] += d[c];
}

// ------------------------------------------------- bf16 products
// Two f32 values rounded to bf16 (nearest even) and packed as one mma
// operand register: lo (the smaller k) in the low half.
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// d = a b for one m16n8k16 tile, from zero: a (16 x 16, row) a0 = A[g][2t,
// 2t+1], a1 = A[g + 8][2t, 2t+1], a2 = A[g][2t+8, 2t+9], a3 = A[g + 8][2t+8,
// 2t+9]; b (16 x 8, col) b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g]; d as
// mma_tf32's.  A bf16 x bf16 product is exact in f32; the caller adds d to
// its f32 sum outside the tensor core, one 16-deep step at a time, for the
// reason mma3 gives.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  d[0] = d[1] = d[2] = d[3] = 0.f;
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in the tensor core's f32 accumulator (fragments as mma_bf16's),
// for sums held to bf16's tolerance (the attention kernels' bf16
// instances), where the drift mma3 describes (~1e-6) does not count.
__device__ __forceinline__ void mma_bf16_acc(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 packed as one operand register, lo in the low half.
__device__ __forceinline__ uint32_t bf16_pair(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Four 8 x 8 tiles of 16-bit elements from shared memory: lanes 8i ..
// 8i + 7 give the addresses of tile i's rows (16 bytes each, 16-byte
// aligned) and r[i] is tile i's fragment: lane l holds row l / 4, elements
// 2 (l % 4) and 2 (l % 4) + 1 (``_trans``: of the transposed tile, i.e.
// rows 2 (l % 4) and 2 (l % 4) + 1 of column l / 4).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// 16 bytes from global to shared memory with cp.async (L2 only, no
// registers); valid == false writes 16 zero bytes and reads nothing (src
// must still be a global address).  cp_wait() waits for every copy this
// thread started; a block barrier after it publishes them.
__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 4 bytes the same way (cp.async.ca), for rows that are not 16-byte
// aligned; cp_commit() closes a group of copies and cp_wait_one() waits
// until at most the newest group is still in flight.
__device__ __forceinline__ void cp4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
