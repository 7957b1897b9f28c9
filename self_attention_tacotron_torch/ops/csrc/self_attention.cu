// softmax(Q K^T / sqrt(D)) V over (B, H, T, D) float32 or bfloat16 tensors,
// optionally causal.  Replaces the JAX package's ops/pallas_attention.py
// ``_attention_kernel`` (Pallas, reached through ``fused_self_attention``):
// the Pallas attention mode's full-sequence self-attention hop.
//
// Design.  A warp owns 16 query rows; a block of ``rows`` = 16, 32 or 64
// rows (``attention_plan`` in ops/pallas_attention.py picks it, the
// launcher checks it) streams K and V through shared memory in tiles of BK
// keys (64; 32 from DP = 64 on, where 64 keys spilled registers; 16 at DP
// = 128 with a warp a row group, 4 % faster than 32 there) with an online
// softmax, so nothing in shared memory scales with T (the SIWIS recipe
// decodes up to 3000 steps).  Where even 16-row blocks leave most
// SMs idle (``key_warps`` = 4: the serving shape), a 16-row block has 4
// warps that each take a quarter of every key tile with a softmax state of
// their own, merged through shared memory at the end: the dependent chain
// of loads, products, exponentials and products that a lone warp would run
// is cut to a quarter of its keys.
//   * Both products run on the tensor cores, mma.sync m16n8k8 TF32 in the
//     3xTF32 split of csrc/mma.cuh (``mma3``: each 8-deep step starts from
//     zero in the tensor core and is added in f32 outside it), which keeps
//     the f32 plain version's accuracy (1e-5).
//   * The scores of a tile stay in the accumulator registers: the row max
//     and sum reduce over the four lanes of a quad with shuffles, the
//     running max, sum and rescale as in any online softmax, and P feeds
//     the PV product as A fragments straight from those registers.  The
//     PV product takes its keys in the order the C fragment holds them
//     (A column t <-> key 2t, column t + 4 <-> key 2t + 1, and V's rows
//     read in the same order), so no shuffle and no shared memory is
//     needed between the two products.
//   * K and V tiles arrive by cp.async (16-byte vectors, 4-byte copies for
//     D % 4 != 0 or a base that is not 16-byte aligned) into a ring of NS
//     = 3 stages: tiles j + 1 and j + 2 are in flight while tile j is
//     multiplied, one block barrier a tile.  Both are stored row-major with
//     rows padded by 16 bytes (4 floats), which makes the fragment reads of
//     both products (K as the col-major B operand, V in the permuted key
//     order) free of bank conflicts.  The ragged edge is zero-filled by the copies
//     (keys >= T, columns >= D) and the keys >= T are masked in the scores.
//   * Q's fragments go from global memory to registers once and are split
//     again each tile (the split of all of Q held over the loop took 128
//     registers and left the products no room to overlap).  The split
//     itself is three instructions (``split3``).
//   * Causal blocks stop at the tile that holds their last row, and a warp
//     skips the products of tiles past its own last row.
// bf16 operands (``elem`` = 1: the model-wide bf16's q, k and v, the JAX
// kernel's bf16 call) take ``self_attention_bf16_kernel``: the same rows,
// ring, key warps and merge on the bf16 tensor cores.  The ring holds bf16
// rows (8 elements of padding, 16 bytes as in f32), Q's fragments are
// packed bf16 pairs from global memory, K's and V's come from the ring by
// ldmatrix (V's transposed, ``ldsm_x4_trans``), and each 16-deep step of
// both products is one mma.sync m16n8k16 (``mma_bf16_acc``) summing in
// f32 in the tensor core: bf16 x bf16 products are exact in f32, so Q K^T
// is the JAX kernel's f32 sum of the bf16 inputs.  P (f32 in the
// reference) is rounded once to bf16 for P V, as bf16 flash kernels do:
// its relative error 2^-9 a weight averages out over the keys (PERF.md has
// its measured size).  The softmax (in units of log2: one FFMA and an ex2
// a score), the merge and the sums stay f32; the store rounds once,
// staged through shared memory into 16-byte stores of whole rows.  Tiles
// of 64 keys at every width (the bf16 fragments take half the f32
// registers), and blocks of 128 rows on 8 warps where those fill half the
// card: at B = 32, T = 256 they read K and V from L2 twice, 16.8 MB, where
// 64-row blocks read them 4 times.  The 16-byte copies need D % 8 == 0;
// otherwise the tile is loaded element by element.
// Wider heads (128 < D <= MAX_WIDE_D) take ``self_attention_wide_kernel``,
// f32 and bf16 alike: D padded to a width of WIDE_WIDTHS, a block of 32
// query rows (16 past a width of 512) and 8 warps, each a 16-row group and
// a slice of D's columns.
//   * Q K^T: each warp sums its rows' scores over its own columns (Q's
//     fragments in registers, K from the ring), the 3xTF32 split (f32) or
//     one bf16 mma a 16-deep step, as above; the partial tiles meet in
//     shared memory (``xs``) behind a named barrier of the row group, and
//     each warp adds them in the same order, so all warps of a group hold
//     the same scores and run the same online softmax.
//   * P V: each warp multiplies P into its own columns of V, so O (16 rows
//     x D) is spread over the group's warps, D / 32 floats a thread.
//   * K and V tiles of 32, 16 or 8 keys (``wide_keys``: what fits 227 KB
//     with 3 ring stages) arrive by cp.async as in the narrow kernel; every
//     16-row group reads each tile from shared memory once.
//   * Where the row blocks would leave most SMs idle (the serving batch,
//     a causal head of a few hundred rows: each block a chain of up to T /
//     32 tiles), each row block's tiles split into ``chunk``-tile pieces,
//     one block each (grid z); each writes its rows' max, sum and O to
//     ``part``, and the last to finish (a ticket a row block) folds them
//     in chunk order, so the sums do not depend on which block is last.
// Keys >= T and, when causal, keys past the query take the reference's
// -1e9 fill; key 0 is visible to every row, so each running max is a real
// score after the first tile and masked keys add exp(-1e9 - m) = 0.
//
// Bound on an H100.  4 T^2 D FLOPs a (b, h) (about half of it causal) at
// the 3xTF32 rate (495 TFLOP/s dense TF32 over 3 products, 165 TFLOP/s;
// bf16: 989 TFLOP/s), against reading q, k, v and writing o once at 3.35
// TB/s.  At B = 32, H = 2, T = 256, D = 128: 2.15 GFLOP = 13.0 us against
// 33.5 MB = 10.0 us, the operations.  There the f32 kernel runs 64-row
// blocks of 4 warps, two an SM (51 KB of shared memory and 255 registers a
// thread each), and what holds it back is latency: each 8-deep step is a
// chain of three dependent mma.sync (~26 cycles each) behind its fragment
// loads and splits, and two warps a scheduler keep too few such chains in
// flight: the products reach ~0.2 mma a cycle an SM, where independent
// mma.sync reach ~0.65 at the same 8 warps an SM
// (scripts/torch_mma_probe.py).  wgmma, whose products run asynchronously
// from shared memory, is the way past it.  In bf16 the same shape is 16.8
// MB = 5.0 us of bytes and one mma a 16-deep step where f32 takes six.  At
// the serving shape (B = 1, H = 2, T = 64, D = 16) the work is 0.5 MFLOP
// and the launch and a chain of dependent steps bound it: 8 blocks of 16
// rows on 8 SMs, 4 warps each on a quarter of the keys, one round trip for
// Q, K and V, one tile, the merge.  The wide kernel at B = 8, T = 256, D =
// 256 (f32): 1.07 GFLOP = 6.5 us against 16.8 MB = 5.0 us; its 32-row
// blocks read K and V 8 times a head from L2 (67 MB).
#include <math.h>

#include "common.cuh"
#include "mma.cuh"

struct AttnArgs {
  const void* q;    // (B * H, T, D) each, float or bf16 (``elem``)
  const void* k;
  const void* v;
  void* o;
  long long* cycles;  // nullptr, or ATTN_STAGES counters (profile)
  int bh;           // B * H
  int T;
  int D;
  int causal;
  float scale;      // 1 / sqrt(D)
  int rows;         // query rows a block: 16, 32, 64 (bf16: or 128; wide:
                    // 32 or 16)
  int key_warps;    // warps that share a row group's key tiles: 1 or 4
  int elem;         // 0: float32 operands, 1: bfloat16
  // the wide kernel's split of each row block's key tiles: ``splits``
  // blocks of ``chunk`` tiles (1 and any: none); their partial softmax
  // states go to ``part`` and the last of a row block to finish, counted
  // in its word of ``tickets`` (zero, and left at zero), merges them
  int splits;
  int chunk;
  float* part;
  int* tickets;
};

namespace {

int padded_width(int D) {
  return D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 0;
}

constexpr int NS = 3;        // stages of the K / V ring
constexpr int PAD_BYTES = 16;   // after each shared-memory row
constexpr int MAX_ROWS = 64;
constexpr int BF16_ROWS = 128;   // the bf16 instances' 8-warp blocks
constexpr int MAX_MMA_D = 128;   // the widest narrow template
constexpr int MAX_WIDE_D = 1024;   // the wide kernel's widest plan
constexpr size_t BLOCK_SMEM = 232448;   // 227 KB, a block's most
constexpr int WIDE_WARPS = 8;
constexpr float NEG_FILL = -1e9f;
// profile counters: copy wait + barrier, QK^T, softmax, PV, the start (up
// to the loop), the end (merge and stores)
constexpr int ATTN_STAGES = 6;

// keys a tile at padded width dp with kw warps on a row group's keys and
// operands of es bytes (bf16: 64 everywhere)
__host__ __device__ constexpr int keys_a_tile(int dp, int kw, int es = 4) {
  return es == 2 ? 64 : dp == 128 && kw == 1 ? 16 : dp >= 64 ? 32 : 64;
}

// elements of padding after a ring row of element size ``es``
__host__ __device__ constexpr int pad_of(int es) { return PAD_BYTES / es; }

// the ring (element size es), or, when larger, the merge of kw > 1 warps
// (each of the 4 warps' o fragments and (max, sum) pairs, in floats)
__host__ __device__ constexpr size_t smem_bytes_of(int dp, int kw,
                                                   int es = 4) {
  const size_t ring =
      (size_t)NS * 2 * keys_a_tile(dp, kw, es) * (dp + pad_of(es)) * es;
  const size_t merge = kw > 1 ? (size_t)kw * (dp / 8 * 4 + 4) * 32 * 4 : 0;
  return ring > merge ? ring : merge;
}

// The wide kernel's plan: D padded to one of WIDE_WIDTHS, 16-row groups a
// block (2 up to 512 wide, 1 past it: O and Q's slices in a warp's
// registers), keys a tile (the most of 32, 16, 8 whose ring and partial
// score tiles fit 227 KB), and the dynamic shared memory.
__host__ __device__ constexpr int wide_width(int D) {
  return D <= 192 ? 192 : D <= 256 ? 256 : D <= 384 ? 384 : D <= 512 ? 512
       : D <= 768 ? 768 : 1024;
}

__host__ __device__ constexpr int wide_groups(int dp) {
  return dp <= 512 ? 2 : 1;
}

__host__ __device__ constexpr size_t wide_smem_of(int dp, int bk, int es) {
  return (size_t)NS * 2 * bk * (dp + pad_of(es)) * es +
         (size_t)WIDE_WARPS * 16 * bk * 4;
}

__host__ __device__ constexpr int wide_keys(int dp, int es) {
  return wide_smem_of(dp, 32, es) <= BLOCK_SMEM ? 32
       : wide_smem_of(dp, 16, es) <= BLOCK_SMEM ? 16 : 8;
}

static_assert(wide_keys(MAX_WIDE_D, 2) >= 16 &&
                  wide_smem_of(MAX_WIDE_D, wide_keys(MAX_WIDE_D, 4), 4) <=
                      BLOCK_SMEM,
              "wide plan past 227 KB");

// x ~= hi + lo for mma3: hi rounded to TF32 by an integer add of half an
// ulp and a mask, lo = x - hi exact and passed as it is.  The tensor core
// reads a TF32 operand's top 19 bits, so lo is truncated there: |error| <
// 2^-10 |lo| <= 2^-21 |x| (tf32_split of csrc/mma.cuh rounds lo too, two
// instructions more, for half of that).
__device__ __forceinline__ void split3(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rn(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

template <int N>
__device__ __forceinline__ void cp_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// a barrier of the ``n`` threads of one row group (ids 1.., 0 is
// __syncthreads')
__device__ __forceinline__ void group_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// e^x as 2^(x log2 e): MUFU.EX2 and a multiply, where expf takes eight
// instructions (2 ulp; exact for x = -inf)
__device__ __forceinline__ float exp_e(float x) {
  return exp2f(x * 1.4426950408889634f);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(FULL, v, 1));
  return fmaxf(v, __shfl_xor_sync(FULL, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

// One element from global into shared memory: cp.async for a float, a
// plain load and store for a bf16 (cp.async copies 4 bytes at least).
__device__ __forceinline__ void cp_elem(float* dst, const float* src,
                                        bool in) {
  cp4(dst, src, in);
}
__device__ __forceinline__ void cp_elem(__nv_bfloat16* dst,
                                        const __nv_bfloat16* src, bool in) {
  *dst = in ? __ldg(src) : __float2bfloat16_rn(0.f);
}

// Keys k0 .. k0 + BK - 1 of K and V into one ring stage (zeros past T and
// past D).
template <class T, int DP, int BK>
__device__ __forceinline__ void load_tile(T* ks, const AttnArgs& a,
                                          size_t base, int k0, bool vec) {
  constexpr int LD = DP + pad_of(sizeof(T));
  T* vs = ks + BK * LD;
  const T* gk = static_cast<const T*>(a.k);
  const T* gv = static_cast<const T*>(a.v);
  const int Tn = a.T, D = a.D;
  if (vec) {
    constexpr int EPC = 16 / sizeof(T);    // elements a 16-byte chunk
    constexpr int CH = DP / EPC;           // chunks a row
    for (int e = threadIdx.x; e < BK * CH; e += blockDim.x) {
      const int r = e / CH, c = (e - r * CH) * EPC;
      const bool in = k0 + r < Tn && c < D;
      const size_t g = in ? base + (size_t)(k0 + r) * D + c : 0;
      cp16(reinterpret_cast<float*>(ks + r * LD + c),
           reinterpret_cast<const float*>(gk + g), in);
      cp16(reinterpret_cast<float*>(vs + r * LD + c),
           reinterpret_cast<const float*>(gv + g), in);
    }
  } else {
    for (int e = threadIdx.x; e < BK * DP; e += blockDim.x) {
      const int r = e / DP, c = e - r * DP;
      const bool in = k0 + r < Tn && c < D;
      const size_t g = in ? base + (size_t)(k0 + r) * D + c : 0;
      cp_elem(ks + r * LD + c, gk + g, in);
      cp_elem(vs + r * LD + c, gv + g, in);
    }
  }
}

// Q's A fragments of a warp's 16 rows (row_a = its row g, row_b = g + 8)
// over NF columns from c0 (zeros past T and D).  f32, an m16n8k8 step a
// kk: qf[kk] = Q[g][c0 + 8kk + t], Q[g + 8][..], Q[g][.. + 4], Q[g + 8][..
// + 4].  bf16, an m16n8k16 step a kk, as packed pairs: qb[kk] = Q[g][c0 +
// 16kk + 2t, + 1], Q[g + 8][..], Q[g][.. + 8, + 9], Q[g + 8][..].
template <int NF>
__device__ __forceinline__ void load_q(float (&qf)[NF / 8][4],
                                       const float* gq, size_t base,
                                       int row_a, int row_b, int c0, int t,
                                       int T, int D) {
#pragma unroll
  for (int kk = 0; kk < NF / 8; ++kk) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = (c & 1) ? row_b : row_a;
      const int col = c0 + kk * 8 + t + ((c & 2) ? 4 : 0);
      qf[kk][c] = (row < T && col < D)
                      ? __ldg(gq + base + (size_t)row * D + col) : 0.f;
    }
  }
}

template <int NF>
__device__ __forceinline__ void load_q(uint32_t (&qb)[NF / 16][4],
                                       const __nv_bfloat16* gq, size_t base,
                                       int row_a, int row_b, int c0, int t,
                                       int T, int D) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  // a pair a 4-byte load where D is even and Q 4-byte aligned
  const bool pairs =
      (D & 1) == 0 && (reinterpret_cast<uintptr_t>(gq) & 3) == 0;
#pragma unroll
  for (int kk = 0; kk < NF / 16; ++kk) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = (c & 1) ? row_b : row_a;
      const int col = c0 + kk * 16 + 2 * t + ((c & 2) ? 8 : 0);
      const __nv_bfloat16* p = gq + base + (size_t)row * D + col;
      if (pairs)
        qb[kk][c] = row < T && col < D
                        ? __ldg(reinterpret_cast<const unsigned*>(p)) : 0u;
      else
        qb[kk][c] = bf16_pair(row < T && col < D ? __ldg(p) : zero,
                              row < T && col + 1 < D ? __ldg(p + 1) : zero);
    }
  }
}

// S (16 rows x 8 NB keys, C fragments) += Q K^T over this warp's NF
// columns: ks points at the tile's first key row and this warp's first
// column.  f32: the 3xTF32 split, Q split anew (see the design notes).
template <int NF, int NB, int LD>
__device__ __forceinline__ void scores(float (&s)[NB][4],
                                       float (&qf)[NF / 8][4],
                                       const float* ks, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < NF / 8; ++kk)
#pragma unroll
    for (int c = 0; c < 4; ++c) asm volatile("" : "+f"(qf[kk][c]));
#pragma unroll
  for (int kk = 0; kk < NF / 8; ++kk) {
    uint32_t ah[4], al[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) split3(qf[kk][c], ah[c], al[c]);
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const float* kr = ks + (n * 8 + g) * LD + kk * 8 + t;
      uint32_t bh[2], bl[2];
      split3(kr[0], bh[0], bl[0]);
      split3(kr[4], bh[1], bl[1]);
      mma3(s[n], ah, al, bh, bl);
    }
  }
}

// bf16: K's B fragments of two 8-key tiles a ldmatrix (tiles n, n + 1 x
// columns 16kk .. + 7, .. + 15), one mma a tile and 16-deep step.
template <int NF, int NB, int LD>
__device__ __forceinline__ void scores(float (&s)[NB][4],
                                       const uint32_t (&qb)[NF / 16][4],
                                       const __nv_bfloat16* ks, int g,
                                       int t) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* kl =
      ks + ((lane >> 4) * 8 + (lane & 7)) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < NF / 16; ++kk) {
#pragma unroll
    for (int n = 0; n < NB; n += 2) {
      uint32_t b[4];
      ldsm_x4(b, kl + n * 8 * LD + kk * 16);
      mma_bf16_acc(s[n], qb[kk], b[0], b[1]);
      mma_bf16_acc(s[n + 1], qb[kk], b[2], b[3]);
    }
  }
}

// O (16 rows x NF columns) += P V over 8 NB keys, P from the softmaxed
// scores s.  f32: the 3xTF32 split, P's A fragment from s[kk] in the key
// order 2t, 2t + 1 (V's rows read in that order); vs points at the tile's
// first V row and this warp's first column.
template <int NF, int NB, int LD>
__device__ __forceinline__ void values(float (&o)[NF / 8][4],
                                       const float (&s)[NB][4],
                                       const float* vs, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < NB; ++kk) {
    uint32_t ah[4], al[4];
    split3(s[kk][0], ah[0], al[0]);   // P[g][8kk + 2t]
    split3(s[kk][2], ah[1], al[1]);   // P[g + 8][8kk + 2t]
    split3(s[kk][1], ah[2], al[2]);   // P[g][8kk + 2t + 1]
    split3(s[kk][3], ah[3], al[3]);   // P[g + 8][8kk + 2t + 1]
    const float* v0 = vs + (kk * 8 + 2 * t) * LD + g;
#pragma unroll
    for (int jn = 0; jn < NF / 8; ++jn) {
      uint32_t bh[2], bl[2];
      split3(v0[jn * 8], bh[0], bl[0]);
      split3(v0[LD + jn * 8], bh[1], bl[1]);
      mma3(o[jn], ah, al, bh, bl);
    }
  }
}

// bf16: P rounded once to bf16 pairs (keys 16kk + 2t, + 1 from s[2kk],
// + 8, + 9 from s[2kk + 1]: the C fragments are the A fragment's layout),
// V's B fragments of two 8-column tiles a transposed ldmatrix.
template <int NF, int NB, int LD>
__device__ __forceinline__ void values(float (&o)[NF / 8][4],
                                       const float (&s)[NB][4],
                                       const __nv_bfloat16* vs, int g,
                                       int t) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* vl =
      vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    const uint32_t p[4] = {bf16x2(s[2 * kk][0], s[2 * kk][1]),
                           bf16x2(s[2 * kk][2], s[2 * kk][3]),
                           bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                           bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int jn = 0; jn < NF / 8; jn += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, vl + kk * 16 * LD + jn * 8);
      mma_bf16_acc(o[jn], p, b[0], b[1]);
      mma_bf16_acc(o[jn + 1], p, b[2], b[3]);
    }
  }
}

// Scale, mask and fold one tile's scores into the online softmax (s[n] =
// C[g][2t, 2t+1], C[g+8][2t, 2t+1] of keys k0 + 8n ..): s becomes P =
// 2^(x - m) with x = s scale log2 e (one FFMA and an ex2 each), m (in
// units of log2), l (this lane's share of each row sum) and O are
// rescaled; the row's max and sum as trees.
template <int NB, int NO>
__device__ __forceinline__ void online_softmax(
    float (&s)[NB][4], float (&o)[NO][4], float& m_a, float& m_b,
    float& l_a, float& l_b, const AttnArgs& a, int k0, int r0, int row_a,
    int row_b, int t) {
  const bool edge = k0 + NB * 8 > a.T || (a.causal && k0 + NB * 8 - 1 > r0);
  const float c2 = a.scale * 1.4426950408889634f;
  float ma[NB], mb[NB];
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    if (edge) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + n * 8 + 2 * t + (c & 1);
        const int row = c < 2 ? row_a : row_b;
        if (key >= a.T || (a.causal && key > row)) s[n][c] = NEG_FILL;
      }
    }
    ma[n] = fmaxf(s[n][0], s[n][1]);
    mb[n] = fmaxf(s[n][2], s[n][3]);
  }
#pragma unroll
  for (int w = 1; w < NB; w *= 2)
#pragma unroll
    for (int n = 0; n + w < NB; n += 2 * w) {
      ma[n] = fmaxf(ma[n], ma[n + w]);
      mb[n] = fmaxf(mb[n], mb[n + w]);
    }
  const float mn_a = fmaxf(m_a, quad_max(ma[0]) * c2);
  const float mn_b = fmaxf(m_b, quad_max(mb[0]) * c2);
  const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);  // 0 first
  m_a = mn_a;
  m_b = mn_b;
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    s[n][0] = exp2f(fmaf(s[n][0], c2, -mn_a));
    s[n][1] = exp2f(fmaf(s[n][1], c2, -mn_a));
    s[n][2] = exp2f(fmaf(s[n][2], c2, -mn_b));
    s[n][3] = exp2f(fmaf(s[n][3], c2, -mn_b));
    ma[n] = s[n][0] + s[n][1];
    mb[n] = s[n][2] + s[n][3];
  }
#pragma unroll
  for (int w = 1; w < NB; w *= 2)
#pragma unroll
    for (int n = 0; n + w < NB; n += 2 * w) {
      ma[n] += ma[n + w];
      mb[n] += mb[n + w];
    }
  l_a = l_a * al_a + ma[0];   // this lane's share; the quad's at the end
  l_b = l_b * al_b + mb[0];
#pragma unroll
  for (int jn = 0; jn < NO; ++jn) {
    o[jn][0] *= al_a;
    o[jn][1] *= al_a;
    o[jn][2] *= al_b;
    o[jn][3] *= al_b;
  }
}

// Two neighbouring columns stored at once (p even: 8 or 4 bytes aligned).
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x,
                                           float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// O / l of a warp's 16 rows and NO 8-column tiles from column c0 into
// global memory (rows < T, columns < D): two columns a store where D is
// even, else one.
template <class TE, int NO>
__device__ __forceinline__ void store_rows(TE* go, const float (&o)[NO][4],
                                           float l_a, float l_b, int row_a,
                                           int row_b, int c0, int t, int T,
                                           int D) {
  const float inv_a = __fdividef(1.f, l_a), inv_b = __fdividef(1.f, l_b);
#pragma unroll
  for (int jn = 0; jn < NO; ++jn) {
    const int col = c0 + jn * 8 + 2 * t;
    if (col >= D) continue;
    for (int h = 0; h < 2; ++h) {
      const int row = h ? row_b : row_a;
      const float inv = h ? inv_b : inv_a;
      if (row >= T) continue;
      TE* p = go + (size_t)row * D + col;
      if ((D & 1) == 0) {
        store_pair(p, o[jn][2 * h] * inv, o[jn][2 * h + 1] * inv);
      } else {
        wstore(p, o[jn][2 * h] * inv);
        if (col + 1 < D) wstore(p + 1, o[jn][2 * h + 1] * inv);
      }
    }
  }
}

// A warp's O / l (16 rows, NO 8-column tiles from column c0) into rows sr
// .. sr + 15 of a tile staged in shared memory at row stride lds.
template <class TE, int NO>
__device__ __forceinline__ void stage_rows(TE* st, int lds,
                                           const float (&o)[NO][4],
                                           float l_a, float l_b, int sr,
                                           int c0, int g, int t) {
  const float inv_a = __fdividef(1.f, l_a), inv_b = __fdividef(1.f, l_b);
#pragma unroll
  for (int jn = 0; jn < NO; ++jn) {
    TE* p = st + (sr + g) * lds + c0 + jn * 8 + 2 * t;
    store_pair(p, o[jn][0] * inv_a, o[jn][1] * inv_a);
    store_pair(p + 8 * lds, o[jn][2] * inv_b, o[jn][3] * inv_b);
  }
}

// Rows 0 .. n - 1 of a staged tile to the output's rows q0 .. (those < T),
// D columns (a multiple of 16 bytes), 16 bytes a store: thread i of nth.
template <class TE>
__device__ __forceinline__ void copy_out(TE* go, const TE* st, int lds,
                                         int n, int q0, int T, int D, int i,
                                         int nth) {
  constexpr int EPC = 16 / sizeof(TE);
  const int ch = D / EPC;
  for (int e = i; e < n * ch; e += nth) {
    const int r = e / ch, c = (e - r * ch) * EPC;
    if (q0 + r < T)
      *reinterpret_cast<float4*>(go + (size_t)(q0 + r) * D + c) =
          *reinterpret_cast<const float4*>(st + r * lds + c);
  }
}

// The profile's clock: thread 0 of the last row block of head 0 adds the
// SM cycles since its last mark to clk[stage].
struct Laps {
  bool on;
  long long mark;
  long long clk[ATTN_STAGES];
  __device__ explicit Laps(bool prof) : on(prof), mark(0) {
    for (int i = 0; i < ATTN_STAGES; ++i) clk[i] = 0;
    if (on) mark = clock64();
  }
  __device__ void lap(int stage) {
    if (on) {
      const long long now = clock64();
      clk[stage] += now - mark;
      mark = now;
    }
  }
  __device__ void flush(long long* cycles) {
    if (on)
      for (int i = 0; i < ATTN_STAGES; ++i) cycles[i] += clk[i];
  }
};

__device__ __forceinline__ bool profiled_thread() {
  return blockIdx.x == gridDim.x - 1 && blockIdx.y == 0 && blockIdx.z == 0 &&
         threadIdx.x == 0;
}

template <int N>
__device__ __forceinline__ void zero_tiles(float (&x)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) x[n][c] = 0.f;
}

// Q's fragments of NF columns in the element type's form
template <class TE, int NF>
struct QFrags {
  float f[NF / 8][4];
};
template <int NF>
struct QFrags<__nv_bfloat16, NF> {
  uint32_t f[NF / 16][4];
};

// KW warps share a row group's key tiles, each a KB-key slice of every
// tile (KW = 1: a warp a row group, all of each tile).  Float32 operands
// only (bf16 ones take self_attention_bf16_kernel).  Its products and
// softmax are written out here, not through ``scores`` / ``values`` /
// ``online_softmax`` as in the other two kernels, so that its machine
// code stays that of its measured design (``scripts/torch_serving_ab.py
// --cases sass`` holds it against an earlier build, instance by instance).
template <int DP, int KW, bool PROF>
__global__ void __launch_bounds__(128, 2)
self_attention_kernel(AttnArgs a, int vec) {
  constexpr int BK = keys_a_tile(DP, KW), LD = DP + pad_of(sizeof(float));
  constexpr int KD = DP / 8;     // 8-deep steps of QK^T, 8-wide tiles of PV
  constexpr int KB = BK / KW;    // keys of a tile that this warp takes
  constexpr int NK = KB / 8;     // ... in 8-key tiles
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);   // the merge's view
  float* ring = smem;
  const float* gq = static_cast<const float*>(a.q);
  float* go = static_cast<float*>(a.o);
  const int T = a.T, D = a.D;
  const size_t base = (size_t)blockIdx.y * T * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp / KW, kb = (warp % KW) * KB;   // row group, key slice
  const int q0 = blockIdx.x * a.rows;
  const int r0 = q0 + rw * 16;               // this warp's first row
  const int row_a = r0 + g, row_b = r0 + g + 8;
  const int k_end = a.causal ? min(q0 + a.rows, T) : T;
  const int nt = (k_end + BK - 1) / BK;
  const bool active = r0 < T;
  const int warp_last = min(r0 + 15, T - 1);
  const bool prof = PROF && blockIdx.x == gridDim.x - 1 && blockIdx.y == 0 &&
                    threadIdx.x == 0;
  long long clk[ATTN_STAGES] = {0, 0, 0, 0, 0, 0};
  long long mark = PROF ? clock64() : 0;
  auto lap = [&](int stage) {
    if (PROF) {
      const long long now = clock64();
      clk[stage] += now - mark;
      mark = now;
    }
  };

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < nt)
      load_tile<float, DP, BK>(ring + s * 2 * BK * LD, a, base, s * BK, vec);
    cp_commit();
  }

  // Q's A fragments: qf[kk] = Q[g][8kk + t], Q[g + 8][..], Q[g][.. + 4],
  // Q[g + 8][.. + 4] of this warp's 16 rows (zeros past T and D).
  float qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = (c & 1) ? row_b : row_a;
      const int col = kk * 8 + t + ((c & 2) ? 4 : 0);
      qf[kk][c] = (row < T && col < D)
                      ? __ldg(gq + base + (size_t)row * D + col) : 0.f;
    }
  }

  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  float o[KD][4];
#pragma unroll
  for (int j = 0; j < KD; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[j][c] = 0.f;
  lap(4);

  for (int j = 0; j < nt; ++j) {
    cp_wait_group<NS - 2>();   // tile j has landed (this thread's copies)
    __syncthreads();           // ... everyone's; tile j - 1's readers done
    if (j + NS - 1 < nt)
      load_tile<float, DP, BK>(ring + ((j + NS - 1) % NS) * 2 * BK * LD, a,
                            base, (j + NS - 1) * BK, vec);
    cp_commit();
    lap(0);
    const int k0 = j * BK + kb;     // this warp's first key of the tile
    if (!active || k0 >= T || (a.causal && k0 > warp_last)) continue;
    const float* ks = ring + (j % NS) * 2 * BK * LD + kb * LD;
    const float* vs = ks + BK * LD;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)   // split Q anew: see the design notes
#pragma unroll
      for (int c = 0; c < 4; ++c) asm volatile("" : "+f"(qf[kk][c]));

    // S = Q K^T for this warp's 16 rows and its KB keys of the tile
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) split3(qf[kk][c], ah[c], al[c]);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const float* kr = ks + (n * 8 + g) * LD + kk * 8 + t;
        uint32_t bh[2], bl[2];
        split3(kr[0], bh[0], bl[0]);
        split3(kr[4], bh[1], bl[1]);
        mma3(s[n], ah, al, bh, bl);
      }
    }
    lap(1);

    // scale, mask, online softmax; s[n] = C[g][2t, 2t+1], C[g+8][2t, 2t+1]
    // of keys k0 + 8n ..
    const bool edge = k0 + KB > T || (a.causal && k0 + KB - 1 > r0);
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[n][c] * a.scale;
        if (edge) {
          const int key = k0 + n * 8 + 2 * t + (c & 1);
          const int row = c < 2 ? row_a : row_b;
          if (key >= T || (a.causal && key > row)) x = NEG_FILL;
        }
        s[n][c] = x;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    const float al_a = exp_e(m_a - mn_a), al_b = exp_e(m_b - mn_b);  // 0 first
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      s[n][0] = exp_e(s[n][0] - mn_a);
      s[n][1] = exp_e(s[n][1] - mn_a);
      s[n][2] = exp_e(s[n][2] - mn_b);
      s[n][3] = exp_e(s[n][3] - mn_b);
      sum_a += s[n][0] + s[n][1];
      sum_b += s[n][2] + s[n][3];
    }
    l_a = l_a * al_a + sum_a;   // this lane's share; the quad's at the end
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int jn = 0; jn < KD; ++jn) {
      o[jn][0] *= al_a;
      o[jn][1] *= al_a;
      o[jn][2] *= al_b;
      o[jn][3] *= al_b;
    }
    lap(2);

    // O += P V, P's A fragment from s[kk] in the key order 2t, 2t + 1
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t ah[4], al[4];
      split3(s[kk][0], ah[0], al[0]);   // P[g][8kk + 2t]
      split3(s[kk][2], ah[1], al[1]);   // P[g + 8][8kk + 2t]
      split3(s[kk][1], ah[2], al[2]);   // P[g][8kk + 2t + 1]
      split3(s[kk][3], ah[3], al[3]);   // P[g + 8][8kk + 2t + 1]
      const float* v0 = vs + (kk * 8 + 2 * t) * LD + g;
#pragma unroll
      for (int jn = 0; jn < KD; ++jn) {
        uint32_t bh[2], bl[2];
        split3(v0[jn * 8], bh[0], bl[0]);
        split3(v0[LD + jn * 8], bh[1], bl[1]);
        mma3(o[jn], ah, al, bh, bl);
      }
    }
    lap(3);
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  if (KW > 1) {
    // Merge the KW slices of the row group into its first warp's registers
    // through the ring's memory: the other warps leave their o fragments
    // at so[warp][KD * 4][32] and their (max, sum) pairs at sml[warp][4][32]
    // (lane-minor: no bank conflicts); o = sum_w e^(m_w - M) o_w / sum_w
    // e^(m_w - M) l_w.  A slice that saw no key keeps m = -inf and weighs
    // 0; key 0 is in the first slice, so M is a real score.
    float* so = smem;
    float* sml = so + (blockDim.x >> 5) * KD * 4 * 32;
    __syncthreads();   // every warp is done with the ring
    if (kb > 0) {
#pragma unroll
      for (int jn = 0; jn < KD; ++jn)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          so[(warp * KD * 4 + jn * 4 + c) * 32 + lane] = o[jn][c];
      float* ml = sml + warp * 4 * 32 + lane;
      ml[0] = m_a;
      ml[32] = l_a;
      ml[64] = m_b;
      ml[96] = l_b;
    }
    __syncthreads();
    if (kb > 0) return;
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int w = 1; w < KW; ++w) {
      mx_a = fmaxf(mx_a, sml[(warp + w) * 4 * 32 + lane]);
      mx_b = fmaxf(mx_b, sml[(warp + w) * 4 * 32 + 64 + lane]);
    }
    float f_a = exp_e(m_a - mx_a), f_b = exp_e(m_b - mx_b);
    l_a *= f_a;
    l_b *= f_b;
#pragma unroll
    for (int jn = 0; jn < KD; ++jn) {
      o[jn][0] *= f_a;
      o[jn][1] *= f_a;
      o[jn][2] *= f_b;
      o[jn][3] *= f_b;
    }
#pragma unroll
    for (int w = 1; w < KW; ++w) {
      const float* ml = sml + (warp + w) * 4 * 32 + lane;
      f_a = exp_e(ml[0] - mx_a);
      f_b = exp_e(ml[64] - mx_b);
      l_a += f_a * ml[32];
      l_b += f_b * ml[96];
#pragma unroll
      for (int jn = 0; jn < KD; ++jn)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          o[jn][c] += (c < 2 ? f_a : f_b) *
                      so[((warp + w) * KD * 4 + jn * 4 + c) * 32 + lane];
    }
  }
  // the reciprocals here, not in each guarded store (2 ulp)
  const float inv_a = __fdividef(1.f, l_a), inv_b = __fdividef(1.f, l_b);
  if (active) {
#pragma unroll
    for (int jn = 0; jn < KD; ++jn) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = c < 2 ? row_a : row_b;
        const int col = jn * 8 + 2 * t + (c & 1);
        if (row < T && col < D)
          go[base + (size_t)row * D + col] =
              o[jn][c] * (c < 2 ? inv_a : inv_b);
      }
    }
  }
  lap(5);
  if (prof)
    for (int i = 0; i < ATTN_STAGES; ++i) a.cycles[i] += clk[i];
}


// The bf16 instances, on the bf16 tensor cores: the float32 kernel's
// blocks, ring, key warps and merge; Q's fragments as packed pairs, K's
// and V's by ldmatrix, the softmax in units of log2 (``online_softmax``).
// At most NW warps a block: 4, two blocks an SM; 8 for 128-row blocks
// (BF16_ROWS), one an SM, which read K and V from L2 half as often.
template <int DP, int KW, bool PROF, int NW>
__global__ void __launch_bounds__(NW * 32, 8 / NW)
self_attention_bf16_kernel(AttnArgs a, int vec) {
  using TE = __nv_bfloat16;
  constexpr int BK = keys_a_tile(DP, KW, 2);
  constexpr int LD = DP + pad_of(2);
  constexpr int KD = DP / 8;     // 8-wide tiles of PV (and of QK^T's depth)
  constexpr int KB = BK / KW;    // keys of a tile that this warp takes
  constexpr int NK = KB / 8;     // ... in 8-key tiles
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);   // the merge's view
  TE* ring = reinterpret_cast<TE*>(smem4);
  const TE* gq = static_cast<const TE*>(a.q);
  TE* go = static_cast<TE*>(a.o);
  const int T = a.T;
  const size_t base = (size_t)blockIdx.y * T * a.D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp / KW, kb = (warp % KW) * KB;   // row group, key slice
  const int q0 = blockIdx.x * a.rows;
  const int r0 = q0 + rw * 16;               // this warp's first row
  const int row_a = r0 + g, row_b = r0 + g + 8;
  const int k_end = a.causal ? min(q0 + a.rows, T) : T;
  const int nt = (k_end + BK - 1) / BK;
  const bool active = r0 < T;
  const int warp_last = min(r0 + 15, T - 1);
  Laps laps(PROF && profiled_thread());

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < nt)
      load_tile<TE, DP, BK>(ring + s * 2 * BK * LD, a, base, s * BK, vec);
    cp_commit();
  }

  QFrags<TE, DP> q;
  load_q<DP>(q.f, gq, base, row_a, row_b, 0, t, T, a.D);

  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  float o[KD][4];
  zero_tiles(o);
  laps.lap(4);

  for (int j = 0; j < nt; ++j) {
    cp_wait_group<NS - 2>();   // tile j has landed (this thread's copies)
    __syncthreads();           // ... everyone's; tile j - 1's readers done
    if (j + NS - 1 < nt)
      load_tile<TE, DP, BK>(ring + ((j + NS - 1) % NS) * 2 * BK * LD, a,
                            base, (j + NS - 1) * BK, vec);
    cp_commit();
    laps.lap(0);
    const int k0 = j * BK + kb;     // this warp's first key of the tile
    if (!active || k0 >= T || (a.causal && k0 > warp_last)) continue;
    const TE* ks = ring + (j % NS) * 2 * BK * LD + kb * LD;

    // S = Q K^T for this warp's 16 rows and its KB keys of the tile
    float s[NK][4];
    zero_tiles(s);
    scores<DP, NK, LD>(s, q.f, ks, g, t);
    laps.lap(1);
    online_softmax(s, o, m_a, m_b, l_a, l_b, a, k0, r0, row_a, row_b, t);
    laps.lap(2);
    values<DP, NK, LD>(o, s, ks + BK * LD, g, t);
    laps.lap(3);
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  if (KW > 1) {
    // Merge the KW slices of the row group into its first warp's registers
    // through the ring's memory, as the float32 kernel does (m in units of
    // log2 here): o = sum_w 2^(m_w - M) o_w / sum_w 2^(m_w - M) l_w.
    float* so = smem;
    float* sml = so + (blockDim.x >> 5) * KD * 4 * 32;
    __syncthreads();   // every warp is done with the ring
    if (kb > 0) {
#pragma unroll
      for (int jn = 0; jn < KD; ++jn)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          so[(warp * KD * 4 + jn * 4 + c) * 32 + lane] = o[jn][c];
      float* ml = sml + warp * 4 * 32 + lane;
      ml[0] = m_a;
      ml[32] = l_a;
      ml[64] = m_b;
      ml[96] = l_b;
    }
    __syncthreads();
    if (kb > 0) return;
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int w = 1; w < KW; ++w) {
      mx_a = fmaxf(mx_a, sml[(warp + w) * 4 * 32 + lane]);
      mx_b = fmaxf(mx_b, sml[(warp + w) * 4 * 32 + 64 + lane]);
    }
    float f_a = exp2f(m_a - mx_a), f_b = exp2f(m_b - mx_b);
    l_a *= f_a;
    l_b *= f_b;
#pragma unroll
    for (int jn = 0; jn < KD; ++jn) {
      o[jn][0] *= f_a;
      o[jn][1] *= f_a;
      o[jn][2] *= f_b;
      o[jn][3] *= f_b;
    }
#pragma unroll
    for (int w = 1; w < KW; ++w) {
      const float* ml = sml + (warp + w) * 4 * 32 + lane;
      f_a = exp2f(ml[0] - mx_a);
      f_b = exp2f(ml[64] - mx_b);
      l_a += f_a * ml[32];
      l_b += f_b * ml[96];
#pragma unroll
      for (int jn = 0; jn < KD; ++jn)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          o[jn][c] += (c < 2 ? f_a : f_b) *
                      so[((warp + w) * KD * 4 + jn * 4 + c) * 32 + lane];
    }
  }
  if (KW == 1 && a.D % 8 == 0) {
    // O through shared memory, 16-byte stores of whole rows (not worth it
    // for the one 16 x D tile of 4 key warps)
    __syncthreads();   // every warp is done with the ring
    TE* st = ring + rw * 16 * LD;
    stage_rows(st, LD, o, l_a, l_b, 0, 0, g, t);
    __syncwarp();
    if (active) copy_out(go + base, st, LD, 16, r0, T, a.D, lane, 32);
  } else if (active) {
    store_rows(go + base, o, l_a, l_b, row_a, row_b, 0, t, T, a.D);
  }
  laps.lap(5);
  laps.flush(a.cycles);
}

// Heads past the narrow templates: block (i, bh, c) takes 16 RG query rows
// from 16 RG i of head bh, 8 warps, and the c-th chunk of ``a.chunk`` of
// their key tiles; warp w takes row group w / CS and columns CW (w % CS)
// .. + CW - 1 of the DP-wide padded head.
template <class TE, int DP>
__global__ void __launch_bounds__(WIDE_WARPS * 32, 1)
self_attention_wide_kernel(AttnArgs a, int vec) {
  constexpr int RG = wide_groups(DP);
  constexpr int CS = WIDE_WARPS / RG;   // warps on a row group's columns
  constexpr int CW = DP / CS;           // columns a warp
  constexpr int BK = wide_keys(DP, sizeof(TE));
  constexpr int NB = BK / 8;            // 8-key tiles of S
  constexpr int LD = DP + pad_of(sizeof(TE));
  constexpr int NP = CW / 2 + 4;        // a thread's floats of a partial
  static_assert(!kIsBf16<TE> || (CW % 16 == 0 && NB % 2 == 0),
                "bf16 steps are 16 deep");
  extern __shared__ float4 smem4[];
  __shared__ int last;
  TE* ring = reinterpret_cast<TE*>(smem4);
  // the partial score tiles, [warp][NB][32 lanes] float4s
  float4* xs = smem4 + (size_t)NS * 2 * BK * LD * sizeof(TE) / 16;
  const TE* gq = static_cast<const TE*>(a.q);
  TE* go = static_cast<TE*>(a.o);
  const int T = a.T;
  const size_t base = (size_t)blockIdx.y * T * a.D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp / CS, c0 = (warp % CS) * CW;
  const int q0 = blockIdx.x * 16 * RG;
  const int r0 = q0 + rg * 16;               // this warp's first row
  const int row_a = r0 + g, row_b = r0 + g + 8;
  const int k_end = a.causal ? min(q0 + 16 * RG, T) : T;
  const int nt = (k_end + BK - 1) / BK;      // the row block's key tiles
  const int j0 = blockIdx.z * a.chunk;       // this block's chunk of them
  if (j0 >= nt) return;
  const int j1 = min(j0 + a.chunk, nt);
  const int parts = (nt + a.chunk - 1) / a.chunk;
  const bool active = r0 < T;
  const int group_last = min(r0 + 15, T - 1);
  Laps laps(a.cycles != nullptr && profiled_thread());

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (j0 + s < j1)
      load_tile<TE, DP, BK>(ring + s * 2 * BK * LD, a, base, (j0 + s) * BK,
                            vec);
    cp_commit();
  }

  QFrags<TE, CW> q;
  load_q<CW>(q.f, gq, base, row_a, row_b, c0, t, T, a.D);

  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  float o[CW / 8][4];
  zero_tiles(o);
  laps.lap(4);

  const TE* kc = ring + c0;   // this warp's columns of stage 0's K tile
  float4* xw = xs + warp * NB * 32 + lane;   // its partial score tile
  const float4* xr = xs + rg * CS * NB * 32 + lane;   // its group's
  for (int j = j0; j < j1; ++j) {
    cp_wait_group<NS - 2>();   // tile j has landed (this thread's)
    __syncthreads();           // ... everyone's; tile j - 1's readers done
    if (j + NS - 1 < j1)
      load_tile<TE, DP, BK>(
          ring + ((j - j0 + NS - 1) % NS) * 2 * BK * LD, a, base,
          (j + NS - 1) * BK, vec);
    cp_commit();
    laps.lap(0);
    if (!active || (a.causal && j * BK > group_last)) continue;
    const int stage = (j - j0) % NS;
    // this warp's share of S = Q K^T, then the row group's sum, added in
    // a fixed order, so every warp of the group has the same S (the last
    // tile's readers are past the block barrier; the group's warps skip
    // tiles alike, causal by the group's last row)
    float s[NB][4];
    zero_tiles(s);
    scores<CW, NB, LD>(s, q.f, kc + stage * 2 * BK * LD, g, t);
#pragma unroll
    for (int n = 0; n < NB; ++n)
      xw[n * 32] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
    group_sync(1 + rg, CS * 32);
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      float4 x = xr[n * 32];
#pragma unroll
      for (int w = 1; w < CS; ++w) {
        const float4 y = xr[(w * NB + n) * 32];
        x.x += y.x;
        x.y += y.y;
        x.z += y.z;
        x.w += y.w;
      }
      s[n][0] = x.x;
      s[n][1] = x.y;
      s[n][2] = x.z;
      s[n][3] = x.w;
    }
    laps.lap(1);
    online_softmax(s, o, m_a, m_b, l_a, l_b, a, j * BK, r0, row_a, row_b,
                   t);
    laps.lap(2);
    values<CW, NB, LD>(o, s, kc + (stage * 2 + 1) * BK * LD, g, t);
    laps.lap(3);
  }
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);

  if (parts > 1) {
    // Each chunk's (m, l, O) to ``part`` (a thread's NP floats at stride
    // 256: coalesced), then the last chunk to finish folds them all in
    // chunk order (the same sums whichever block is last):
    // O = sum_c 2^(m_c - M) O_c, l likewise.
    const size_t row_block = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    float* mine = a.part + (row_block * gridDim.z + blockIdx.z) * NP * 256 +
                  threadIdx.x;
#pragma unroll
    for (int jn = 0; jn < CW / 8; ++jn)
#pragma unroll
      for (int c = 0; c < 4; ++c) mine[(jn * 4 + c) * 256] = o[jn][c];
    mine[(NP - 4) * 256] = m_a;
    mine[(NP - 3) * 256] = l_a;
    mine[(NP - 2) * 256] = m_b;
    mine[(NP - 1) * 256] = l_b;
    __threadfence();           // the partial is visible before the ticket
    __syncthreads();
    if (threadIdx.x == 0) {
      const int ticket = atomicAdd(a.tickets + row_block, 1);
      last = ticket == parts - 1;
      if (last) a.tickets[row_block] = 0;   // for the next launch
    }
    __syncthreads();
    if (!last) {
      laps.lap(5);
      laps.flush(a.cycles);
      return;
    }
    __threadfence();
    const float* all = a.part + row_block * gridDim.z * NP * 256 +
                       threadIdx.x;
    m_a = m_b = -INFINITY;
    l_a = l_b = 0.f;
    zero_tiles(o);
    for (int c = 0; c < parts; ++c) {
      const float* p = all + (size_t)c * NP * 256;
      const float pm_a = __ldcg(p + (NP - 4) * 256);
      const float pm_b = __ldcg(p + (NP - 2) * 256);
      const float mx_a = fmaxf(m_a, pm_a), mx_b = fmaxf(m_b, pm_b);
      // 0 for the first, and for a row that saw no key of chunk c
      const float f_a = exp2f(m_a - mx_a), f_b = exp2f(m_b - mx_b);
      const float e_a = exp2f(pm_a - mx_a), e_b = exp2f(pm_b - mx_b);
      l_a = l_a * f_a + __ldcg(p + (NP - 3) * 256) * e_a;
      l_b = l_b * f_b + __ldcg(p + (NP - 1) * 256) * e_b;
      m_a = mx_a;
      m_b = mx_b;
#pragma unroll
      for (int jn = 0; jn < CW / 8; ++jn)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          o[jn][k] = o[jn][k] * (k < 2 ? f_a : f_b) +
                     __ldcg(p + (jn * 4 + k) * 256) * (k < 2 ? e_a : e_b);
    }
  }

  if (a.D % (16 / (int)sizeof(TE)) == 0) {
    // O through shared memory (the ring), 16-byte stores of whole rows
    __syncthreads();   // every warp is done with the ring
    stage_rows(ring, LD, o, l_a, l_b, rg * 16, c0, g, t);
    __syncthreads();
    copy_out(go + base, ring, LD, 16 * RG, q0, T, a.D, threadIdx.x,
             blockDim.x);
  } else if (active) {
    store_rows(go + base, o, l_a, l_b, row_a, row_b, c0, t, T, a.D);
  }
  laps.lap(5);
  laps.flush(a.cycles);
}

// 16-byte copies: D a multiple of a chunk and K, V 16-byte aligned
template <class TE>
int vec_copies(const AttnArgs& a) {
  return a.D % (16 / (int)sizeof(TE)) == 0 &&
         ((reinterpret_cast<uintptr_t>(a.k) |
           reinterpret_cast<uintptr_t>(a.v)) & 15) == 0;
}

template <class TE, int DP>
int launch_wide(const AttnArgs& a, cudaStream_t stream) {
  const size_t smem = wide_smem_of(DP, wide_keys(DP, sizeof(TE)),
                                   sizeof(TE));
  cudaError_t e = cudaFuncSetAttribute(
      self_attention_wide_kernel<TE, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.T + a.rows - 1) / a.rows, a.bh, a.splits);
  self_attention_wide_kernel<TE, DP><<<grid, WIDE_WARPS * 32, smem,
                                       stream>>>(a, vec_copies<TE>(a));
  return (int)cudaGetLastError();
}

template <class TE, int DP, int KW, bool PROF, int NW = 4>
int launch(const AttnArgs& a, cudaStream_t stream) {
  void (*kernel)(AttnArgs, int);
  if constexpr (kIsBf16<TE>)
    kernel = self_attention_bf16_kernel<DP, KW, PROF, NW>;
  else
    kernel = self_attention_kernel<DP, KW, PROF>;
  const size_t smem = smem_bytes_of(DP, KW, sizeof(TE));
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.T + a.rows - 1) / a.rows, a.bh);
  kernel<<<grid, 2 * a.rows * KW, smem, stream>>>(a, vec_copies<TE>(a));
  return (int)cudaGetLastError();
}

template <class TE, int DP>
int launch_dp(const AttnArgs& a, cudaStream_t stream) {
  if (a.key_warps == 4)
    return a.cycles ? launch<TE, DP, 4, true>(a, stream)
                    : launch<TE, DP, 4, false>(a, stream);
  if constexpr (kIsBf16<TE>)
    if (a.rows == BF16_ROWS)
      return a.cycles ? launch<TE, DP, 1, true, 8>(a, stream)
                      : launch<TE, DP, 1, false, 8>(a, stream);
  return a.cycles ? launch<TE, DP, 1, true>(a, stream)
                  : launch<TE, DP, 1, false>(a, stream);
}

template <class TE>
int launch_elem(const AttnArgs& a, cudaStream_t s) {
  if (a.D > MAX_MMA_D) {
    switch (wide_width(a.D)) {
      case 192: return launch_wide<TE, 192>(a, s);
      case 256: return launch_wide<TE, 256>(a, s);
      case 384: return launch_wide<TE, 384>(a, s);
      case 512: return launch_wide<TE, 512>(a, s);
      case 768: return launch_wide<TE, 768>(a, s);
      case 1024: return launch_wide<TE, 1024>(a, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (padded_width(a.D)) {
    case 16: return launch_dp<TE, 16>(a, s);
    case 32: return launch_dp<TE, 32>(a, s);
    case 64: return launch_dp<TE, 64>(a, s);
    case 128: return launch_dp<TE, 128>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int self_attention_launch(const AttnArgs* args, void* stream) {
  const AttnArgs a = *args;
  if (a.elem != 0 && a.elem != 1) return (int)cudaErrorInvalidValue;
  if (a.T < 1 || a.bh < 1 || a.bh > 65535 || a.D < 1 || a.D > MAX_WIDE_D)
    return (int)cudaErrorInvalidValue;
  if (a.D > MAX_MMA_D) {
    const int dp = wide_width(a.D);
    const int tiles = (a.T + wide_keys(dp, a.elem ? 2 : 4) - 1) /
                      wide_keys(dp, a.elem ? 2 : 4);
    if (a.rows != 16 * wide_groups(dp) || a.key_warps != 1 ||
        a.splits < 1 || a.splits > 65535 || a.chunk < 1 ||
        (long long)a.splits * a.chunk < tiles ||
        (a.splits > 1 && (a.part == nullptr || a.tickets == nullptr)))
      return (int)cudaErrorInvalidValue;
  } else if ((a.rows != 16 && a.rows != 32 && a.rows != MAX_ROWS &&
              (a.rows != BF16_ROWS || !a.elem)) ||
             (a.key_warps != 1 && (a.key_warps != 4 || a.rows != 16)) ||
             a.splits != 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  return a.elem ? launch_elem<__nv_bfloat16>(a, s) : launch_elem<float>(a, s);
}

// The launcher's plan for head width D, key_warps and element size
// ``elem_bytes`` (4 or 2; what ``attention_plan`` mirrors): keys a tile,
// ring stages and dynamic shared-memory bytes; 0 for a width the kernel
// does not take.
extern "C" int self_attention_plan(int D, int key_warps, int elem_bytes,
                                   int* keys, int* stages, int* smem_bytes) {
  if (elem_bytes != 4 && elem_bytes != 2) return 0;
  if (D > MAX_MMA_D && D <= MAX_WIDE_D && key_warps == 1) {
    const int dp = wide_width(D);
    *keys = wide_keys(dp, elem_bytes);
    *stages = NS;
    *smem_bytes = (int)wide_smem_of(dp, *keys, elem_bytes);
    return 1;
  }
  const int dp = padded_width(D);
  if (D < 1 || dp == 0) return 0;
  *keys = keys_a_tile(dp, key_warps, elem_bytes);
  *stages = NS;
  *smem_bytes = (int)smem_bytes_of(dp, key_warps, elem_bytes);
  return 1;
}
