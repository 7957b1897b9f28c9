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
//     rows padded by 16 bytes (4 floats), which makes the fragment reads of both
//     products (K as the col-major B operand, V in the permuted key order)
//     free of bank conflicts.  The ragged edge is zero-filled by the copies
//     (keys >= T, columns >= D) and the keys >= T are masked in the scores.
//   * Q's fragments go from global memory to registers once and are split
//     again each tile (the split of all of Q held over the loop took 128
//     registers and left the products no room to overlap).  The split
//     itself is three instructions (``split3``).
//   * Causal blocks stop at the tile that holds their last row, and a warp
//     skips the products of tiles past its own last row.
// bf16 operands (``elem`` = 1: the model-wide bf16's q, k and v, the JAX
// kernel's bf16 call) run the same kernels with the element type a
// template parameter: the ring holds bf16 rows (8 elements of padding,
// 16 bytes as in f32), every load converts to f32 (__bfloat162float) into
// the same fragments, the math is the f32 kernel's, and the store rounds
// once (__float2bfloat16_rn).  bf16 products are exact in f32, the
// accumulation and the softmax are f32: the JAX kernel's math on bf16
// inputs.  The 16-byte copies need D % 8 == 0; otherwise the tile is
// loaded element by element.
// Wider heads (128 < D <= MAX_WIDE_D) take ``self_attention_wide_kernel``:
// eight query rows a block on FP32 FMAs, the keys streamed through shared
// memory in tiles of 32 with an online softmax (csrc/attention_rows.cuh),
// so any T and causal or not; its plan is rows = 8, key_warps = 1.
// Keys >= T and, when causal, keys past the query take the reference's
// -1e9 fill; key 0 is visible to every row, so each running max is a real
// score after the first tile and masked keys add exp(-1e9 - m) = 0.
//
// Bound on an H100.  4 T^2 D FLOPs a (b, h) (about half of it causal) at
// the 3xTF32 rate (495 TFLOP/s dense TF32 over 3 products, 165 TFLOP/s),
// against reading q, k, v and writing o once at 3.35 TB/s.  At B = 32, H =
// 2, T = 256, D = 128: 2.15 GFLOP = 13.0 us against 33.5 MB = 10.0 us, the
// operations.  There the kernel runs 64-row blocks of 4 warps, two an SM
// (51 KB of shared memory and 255 registers a thread each), and what holds
// it back is latency: each 8-deep step is a chain of three dependent
// mma.sync (~26 cycles each) behind its fragment loads and splits, and two
// warps a scheduler keep too few such chains in flight: the products reach
// ~0.2 mma a cycle an SM, where independent mma.sync reach ~0.65 at the
// same 8 warps an SM (scripts/torch_mma_probe.py).  wgmma, whose products
// run asynchronously from shared memory, is the way past it.  At the
// serving shape (B = 1, H = 2, T = 64, D = 16) the work is 0.5 MFLOP and
// the launch and a chain of dependent steps bound it: 8 blocks of 16 rows
// on 8 SMs, 4 warps each on a quarter of the keys, one round trip for Q,
// K and V, one tile, the merge.
#include <math.h>

#include "attention_rows.cuh"
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
  int rows;         // query rows a block: 16, 32 or 64 (8: the wide kernel)
  int key_warps;    // warps that share a row group's key tiles: 1 or 4
  int elem;         // 0: float32 operands, 1: bfloat16
};

namespace {

int padded_width(int D) {
  return D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 0;
}

constexpr int NS = 3;        // stages of the K / V ring
constexpr int PAD_BYTES = 16;   // after each shared-memory row
constexpr int MAX_ROWS = 64;
constexpr int MAX_MMA_D = 128;   // the widest tensor-core template
// the wide kernel's limit: its tile, rows and contexts in 227 KB
constexpr int MAX_WIDE_D = 1024;
static_assert(4 * (ATT_TK * (MAX_WIDE_D + 1) + 2 * NWARPS * MAX_WIDE_D +
                   NWARPS * ATT_TK) <= 232448, "wide plan past 227 KB");
constexpr float NEG_FILL = -1e9f;
// profile counters: copy wait + barrier, QK^T, softmax, PV, the start (up
// to the loop), the end (merge and stores)
constexpr int ATTN_STAGES = 6;

// keys a tile at padded width dp with kw warps on a row group's keys
__host__ __device__ constexpr int keys_a_tile(int dp, int kw) {
  return dp == 128 && kw == 1 ? 16 : dp >= 64 ? 32 : 64;
}

// elements of padding after a ring row of element size ``es``
__host__ __device__ constexpr int pad_of(int es) { return PAD_BYTES / es; }

// the ring (element size es), or, when larger, the merge of kw > 1 warps
// (each of the 4 warps' o fragments and (max, sum) pairs, in floats)
__host__ __device__ constexpr size_t smem_bytes_of(int dp, int kw,
                                                   int es = 4) {
  const size_t ring =
      (size_t)NS * 2 * keys_a_tile(dp, kw) * (dp + pad_of(es)) * es;
  const size_t merge = kw > 1 ? (size_t)kw * (dp / 8 * 4 + 4) * 32 * 4 : 0;
  return ring > merge ? ring : merge;
}

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

// KW warps share a row group's key tiles, each a KB-key slice of every
// tile (KW = 1: a warp a row group, all of each tile).
template <class TE, int DP, int KW, bool PROF>
__global__ void __launch_bounds__(128, 2)
self_attention_kernel(AttnArgs a, int vec) {
  constexpr int BK = keys_a_tile(DP, KW), LD = DP + pad_of(sizeof(TE));
  constexpr int KD = DP / 8;     // 8-deep steps of QK^T, 8-wide tiles of PV
  constexpr int KB = BK / KW;    // keys of a tile that this warp takes
  constexpr int NK = KB / 8;     // ... in 8-key tiles
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);   // the merge's view
  TE* ring = reinterpret_cast<TE*>(smem4);
  const TE* gq = static_cast<const TE*>(a.q);
  TE* go = static_cast<TE*>(a.o);
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
      load_tile<TE, DP, BK>(ring + s * 2 * BK * LD, a, base, s * BK, vec);
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
                      ? wload(__ldg(gq + base + (size_t)row * D + col)) : 0.f;
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
      load_tile<TE, DP, BK>(ring + ((j + NS - 1) % NS) * 2 * BK * LD, a,
                            base, (j + NS - 1) * BK, vec);
    cp_commit();
    lap(0);
    const int k0 = j * BK + kb;     // this warp's first key of the tile
    if (!active || k0 >= T || (a.causal && k0 > warp_last)) continue;
    const TE* ks = ring + (j % NS) * 2 * BK * LD + kb * LD;
    const TE* vs = ks + BK * LD;
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
        const TE* kr = ks + (n * 8 + g) * LD + kk * 8 + t;
        uint32_t bh[2], bl[2];
        split3(wload(kr[0]), bh[0], bl[0]);
        split3(wload(kr[4]), bh[1], bl[1]);
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
      const TE* v0 = vs + (kk * 8 + 2 * t) * LD + g;
#pragma unroll
      for (int jn = 0; jn < KD; ++jn) {
        uint32_t bh[2], bl[2];
        split3(wload(v0[jn * 8]), bh[0], bl[0]);
        split3(wload(v0[LD + jn * 8]), bh[1], bl[1]);
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
          wstore(go + base + (size_t)row * D + col,
                 o[jn][c] * (c < 2 ? inv_a : inv_b));
      }
    }
  }
  lap(5);
  if (prof)
    for (int i = 0; i < ATTN_STAGES; ++i) a.cycles[i] += clk[i];
}

// Heads wider than the tensor-core templates: block (g, bh) takes query
// rows 8 g .. 8 g + 7 of head bh (attend_rows: a warp a row).
template <class TE>
__global__ void __launch_bounds__(NT) self_attention_wide_kernel(AttnArgs a) {
  extern __shared__ __align__(16) float wide_smem[];
  const size_t base = (size_t)blockIdx.y * a.T * a.D;
  const int row0 = blockIdx.x * NWARPS;
  attend_rows<false>(static_cast<const TE*>(a.q) + base, a.D,
                     static_cast<const TE*>(a.k) + base, a.D,
                     static_cast<const TE*>(a.v) + base, a.D,
                     static_cast<TE*>(a.o) + base, a.D, row0,
                     min(NWARPS, a.T - row0), a.T, a.D, a.scale,
                     a.causal != 0, wide_smem);
}

template <class TE>
int launch_wide(const AttnArgs& a, cudaStream_t stream) {
  const size_t smem = 4 * (size_t)attend_rows_floats(a.D);
  cudaError_t e = cudaFuncSetAttribute(
      self_attention_wide_kernel<TE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.T + NWARPS - 1) / NWARPS, a.bh);
  self_attention_wide_kernel<TE><<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <class TE, int DP, int KW, bool PROF>
int launch(const AttnArgs& a, cudaStream_t stream) {
  const size_t smem = smem_bytes_of(DP, KW, sizeof(TE));
  cudaError_t e = cudaFuncSetAttribute(
      self_attention_kernel<TE, DP, KW, PROF>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const bool vec = a.D % (16 / (int)sizeof(TE)) == 0 &&
                   ((reinterpret_cast<uintptr_t>(a.k) |
                     reinterpret_cast<uintptr_t>(a.v)) & 15) == 0;
  const dim3 grid((a.T + a.rows - 1) / a.rows, a.bh);
  self_attention_kernel<TE, DP, KW, PROF><<<grid, 2 * a.rows * KW, smem,
                                            stream>>>(a, (int)vec);
  return (int)cudaGetLastError();
}

template <class TE, int DP>
int launch_dp(const AttnArgs& a, cudaStream_t stream) {
  if (a.key_warps == 4)
    return a.cycles ? launch<TE, DP, 4, true>(a, stream)
                    : launch<TE, DP, 4, false>(a, stream);
  return a.cycles ? launch<TE, DP, 1, true>(a, stream)
                  : launch<TE, DP, 1, false>(a, stream);
}

template <class TE>
int launch_elem(const AttnArgs& a, cudaStream_t s) {
  if (a.D > MAX_MMA_D) return launch_wide<TE>(a, s);
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
  if (a.D > MAX_MMA_D) {   // no profile counters in the wide kernel
    if (a.D > MAX_WIDE_D || a.T < 1 || a.bh < 1 || a.bh > 65535 ||
        a.rows != NWARPS || a.key_warps != 1 || a.cycles != nullptr)
      return (int)cudaErrorInvalidValue;
  } else if (a.T < 1 || a.bh < 1 || a.bh > 65535 || a.D < 1 ||
             (a.rows != 16 && a.rows != 32 && a.rows != MAX_ROWS) ||
             (a.key_warps != 1 && (a.key_warps != 4 || a.rows != 16))) {
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
    *keys = ATT_TK;
    *stages = 1;
    *smem_bytes = 4 * attend_rows_floats(D);
    return 1;
  }
  const int dp = padded_width(D);
  if (D < 1 || dp == 0) return 0;
  *keys = keys_a_tile(dp, key_warps);
  *stages = NS;
  *smem_bytes = (int)smem_bytes_of(dp, key_warps, elem_bytes);
  return 1;
}
