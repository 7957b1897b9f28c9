// One query (B, H, D) against (B, H, S, D) key and value caches masked to
// positions <= t.  Replaces the JAX package's ops/pallas_attention.py
// ``_incremental_kernel`` (Pallas, reached through
// ``incremental_attention_step``): the per-step self-attention of every
// decoder hop in the Pallas attention mode (the trainer's VALIDATION decodes
// and the early-exit serving decode).
//
// Bound on an H100: bytes, the 2 (t + 1) D floats of K and V rows a (b, h)
// for 4 (t + 1) D FLOPs; at B = 1, H = 2, D = 128, t = 249 that is 0.51 MB,
// ~0.15 us at 3.35 TB/s.  What a call costs is latency: a load's round trip
// to L2 or HBM (~0.6-1 us), a launch, and whatever chain of such round
// trips the kernel makes.  The design keeps that chain short.
//
// The cache is split over blocks: block (c, bh) takes the chunk of P = 32
// positions c P .. min(c P + P, t + 1) - 1 of head bh, so at B = 1 and
// t = 249 sixteen blocks share a step (two heads x eight chunks) and at
// B = 32 five hundred.  Positions > t are never read (the TPU kernel reads
// the whole padded cache and masks it with -1e9, which gives them a weight
// of exactly 0).  Each of the 8 warps takes 4 rows; every lane issues all of
// its loads of K and V (16-byte vectors, 4 columns a lane and row at D = 128)
// before it uses the first, so a block waits one round trip.  A row's score
// is a warp sum; the chunk's max and sum come from the 32 scores in shared
// memory (every warp reduces them itself, so no further barrier); each warp
// sums p * v over its rows in registers and the warps add in shared memory.
// A single chunk writes the output.  Otherwise each chunk writes (m, l,
// o[D]), its max, sum and unnormalised p v row, to a scratch the wrapper
// allocates, and takes a ticket from a per-(b, h) counter (an acq_rel
// atomic, as GridBarrier's arrival); the last chunk to arrive resets the
// counter to 0 (so the next call on the stream starts clean), copies the
// chunks' partials into shared memory at once, merges them in max-shifted
// form, o = sum_i e^(m_i - m) o_i / sum_i e^(m_i - m) l_i, and writes the
// output: one launch a step.
// D % 4 != 0 or a base that is not 16-byte aligned takes the same kernel
// with scalar loads (one column a lane).  D > 256, past what the rows in
// registers hold, takes ``incremental_attention_wide_kernel``: the same
// chunks, tickets and merge, with the columns looped instead (a warp's
// rows' scores over strided columns, then a thread a column for p v and
// the merge), so no width limit and no shared memory that grows with D.
// bf16 operands (``elem`` = 1: the model-wide bf16's query and bf16 KV
// cache) run ``incremental_attention_bf16_kernel`` up to D = 256 and the
// wide kernel past it (the element type a template parameter).  The bf16
// kernel's rows are half as wide, so it takes tiles of 64 positions, a
// half-warp a row with one 16-byte load of 8 bf16 a lane (D % 8 == 0 and
// 16-byte aligned bases; else one element a lane), and puts a head's
// blocks in one thread-block cluster of at most 8: block r of nb = min(8,
// tiles) folds tiles r, r + nb, ... online in registers (so any t is one
// cluster a head), then pushes its (m, l, o[D]) into the first block's
// shared memory with st.async onto an mbarrier (cluster.cuh); the first
// block merges them in rank order and stores bf16.  No scratch, no global
// atomic and no reload from L2 (the mbarrier's initialisation is
// published by a split cluster barrier that the loads overlap); the same
// tiles merged by the f32 kernel's tickets took 4.90 against 4.41 us at S =
// 450 on an H100 80GB HBM3 at 700 W.
// Sums in f32, one rounding on the store; the cache is read as it is.
#include <math.h>
#include <stdint.h>

#include "cluster.cuh"
#include "common.cuh"

struct StepArgs {   // mirrored by _StepArgs in ops/pallas_attention.py
  const void* q;    // (B * H, D), float or bf16 (``elem``)
  const void* k;    // (B * H, S, D)
  const void* v;
  void* o;          // (B * H, D)
  float* part;      // (B * H, chunks, D + 2): m, l, o[D] of each chunk
  unsigned* tickets;  // (B * H) zeroed words; each call leaves them at 0
  int bh;           // B * H
  int S;
  int D;
  int t;
  int chunk;        // positions a block (STEP_CHUNK)
  float scale;      // 1 / sqrt(D)
  int passes;       // profile: 1 scores, 2 + softmax, 3 + p v, 0 all
  int elem;         // 0: float32 operands, 1: bfloat16
};

namespace {

constexpr int STEP_CHUNK = 32;   // = NWARPS x ROWS
constexpr int ROWS = STEP_CHUNK / NWARPS;
constexpr int MAX_D = 256;
constexpr int MERGE_LOADS = 8;   // the merge's loads in flight a thread
// the bf16 kernel: positions a tile (STEP_BF16_TILE), blocks a head at
// most (STEP_BF16_CLUSTER, the portable cluster size), rows a lane a tile
constexpr int BF_TILE = 64;
constexpr int BF_CLUSTER = 8;
constexpr int BF_ROWS = BF_TILE / (2 * NWARPS);

static_assert(STEP_CHUNK == 32, "a lane holds one position's score");

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&dst)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    dst[0] = x.x;
    dst[1] = x.y;
    dst[2] = x.z;
    dst[3] = x.w;
  } else {
    dst[0] = __ldg(p);
  }
}

// VEC elements a load (4: one vector, 1: scalar), CPL loads a lane and
// row: column of load j of a lane = (j * 32 + lane) * VEC.
template <class TE, int VEC, int CPL>
__global__ void __launch_bounds__(NT) incremental_attention_kernel(StepArgs a) {
  __shared__ float sc[STEP_CHUNK];
  __shared__ float red[NWARPS][MAX_D];
  __shared__ int last;
  const int D = a.D, bh = blockIdx.y, c = blockIdx.x;
  const int p0 = c * STEP_CHUNK;
  const int n = min(STEP_CHUNK, a.t + 1 - p0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t cache = (size_t)bh * a.S * D;
  const TE* gq = static_cast<const TE*>(a.q);
  const TE* gk = static_cast<const TE*>(a.k);
  const TE* gv = static_cast<const TE*>(a.v);
  TE* go = static_cast<TE*>(a.o);

  float qv[CPL][VEC], kv[ROWS][CPL][VEC], vv[ROWS][CPL][VEC];
  // every load of this lane first: q, then K and V of its rows
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int col = (j * 32 + lane) * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e) qv[j][e] = 0.f;
    if (col < D) load_vec<VEC>(gq + (size_t)bh * D + col, qv[j]);
  }
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = warp + NWARPS * i;
    const TE* krow = gk + cache + (size_t)(p0 + r) * D;
    const TE* vrow = gv + cache + (size_t)(p0 + r) * D;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int col = (j * 32 + lane) * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e) kv[i][j][e] = vv[i][j][e] = 0.f;
      if (r < n && col < D) {
        load_vec<VEC>(krow + col, kv[i][j]);
        if (a.passes != 1) load_vec<VEC>(vrow + col, vv[i][j]);
      }
    }
  }

  // scores of this warp's rows (a warp sum each)
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e) dot = fmaf(qv[j][e], kv[i][j][e], dot);
    dot = warp_sum(dot);
    const int r = warp + NWARPS * i;
    if (lane == 0 && r < n) sc[r] = dot * a.scale;
  }
  __syncthreads();
  if (a.passes == 1) return;

  // the chunk's max and sum, in every warp (lane l holds position l)
  const float s = lane < n ? sc[lane] : -INFINITY;
  const float m = warp_max(s);
  const float p = lane < n ? expf(s - m) : 0.f;
  const float l = warp_sum(p);
  if (a.passes == 2) return;

  // unnormalised p v over this warp's rows, then over the warps
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const float pr = __shfl_sync(FULL, p, warp + NWARPS * i);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fmaf(pr, vv[i][j][e], acc[e]);
    }
    const int col = (j * 32 + lane) * VEC;
    if (col < D)
#pragma unroll
      for (int e = 0; e < VEC; ++e) red[warp][col + e] = acc[e];
  }
  __syncthreads();
  const int d = threadIdx.x;
  float od = 0.f;
  if (d < D)
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) od += red[w][d];
  if (a.passes == 3) return;

  const int chunks = gridDim.x;
  if (chunks == 1) {
    if (d < D) wstore(go + (size_t)bh * D + d, od / l);
    return;
  }
  float* mine = a.part + ((size_t)bh * chunks + c) * (D + 2);
  if (d < D) mine[2 + d] = od;
  if (d == 0) {
    mine[0] = m;
    mine[1] = l;
  }
  // the ticket: thread 0's atom.add.acq_rel after the block barrier
  // releases the block's partial (bar.sync orders the block's writes
  // before it; release is cumulative) and, for the last chunk, acquires
  // every other chunk's; the second barrier hands that to the block
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned v;
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;"
                 : "=r"(v) : "l"(a.tickets + bh) : "memory");
    last = v == (unsigned)(chunks - 1);
    if (last) a.tickets[bh] = 0u;   // every chunk of bh has its ticket
  }
  __syncthreads();
  if (!last) return;
  // merge: the chunks' (m, l, o[D]) rows into shared memory, as many as
  // ``red`` holds a round, every load of a round issued before its first
  // store; then each column in max-shifted form, online across rounds
  const float* parts = a.part + (size_t)bh * chunks * (D + 2);
  float* rows = &red[0][0];
  const int per = NWARPS * MAX_D / (D + 2);
  float mx = -INFINITY, num = 0.f, den = 0.f;
  for (int i0 = 0; i0 < chunks; i0 += per) {
    const int n_i = min(per, chunks - i0), total = n_i * (D + 2);
    const float* src = parts + (size_t)i0 * (D + 2);
    for (int e0 = 0; e0 < total; e0 += NT * MERGE_LOADS) {
      float v[MERGE_LOADS];
#pragma unroll
      for (int k = 0; k < MERGE_LOADS; ++k) {
        const int e = e0 + k * NT + threadIdx.x;
        v[k] = e < total ? __ldcg(src + e) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < MERGE_LOADS; ++k) {
        const int e = e0 + k * NT + threadIdx.x;
        if (e < total) rows[e] = v[k];
      }
    }
    __syncthreads();
    float gm = mx;
    for (int i = 0; i < n_i; ++i) gm = fmaxf(gm, rows[i * (D + 2)]);
    const float keep = expf(mx - gm);   // 0 on the first round
    num *= keep;
    den *= keep;
    for (int i = 0; i < n_i; ++i) {
      const float* pi = rows + i * (D + 2);
      const float w = expf(pi[0] - gm);
      den = fmaf(w, pi[1], den);
      if (d < D) num = fmaf(w, pi[2 + d], num);
    }
    mx = gm;
    __syncthreads();
  }
  if (d < D) wstore(go + (size_t)bh * D + d, num / den);
}

// D > MAX_D: the chunk's scores by warps over its rows (lanes over the
// columns), its p in shared memory, then thread d of the block sums p v
// over the chunk's rows for columns d, d + NT, ... (coalesced rows); a
// single chunk writes the output, else the partials and the ticket as
// above, and the last chunk merges the chunks' (m, l) and rows column by
// column straight from the scratch.
template <class TE>
__global__ void __launch_bounds__(NT)
incremental_attention_wide_kernel(StepArgs a) {
  __shared__ float sc[STEP_CHUNK];
  __shared__ int last;
  const int D = a.D, bh = blockIdx.y, c = blockIdx.x;
  const int p0 = c * STEP_CHUNK;
  const int n = min(STEP_CHUNK, a.t + 1 - p0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t cache = (size_t)bh * a.S * D;
  const TE* q = static_cast<const TE*>(a.q) + (size_t)bh * D;
  TE* go = static_cast<TE*>(a.o);
  for (int i = 0; i < ROWS; ++i) {
    const int r = warp + NWARPS * i;
    float dot = 0.f;
    if (r < n) {
      const TE* krow = static_cast<const TE*>(a.k) + cache +
                       (size_t)(p0 + r) * D;
      for (int col = lane; col < D; col += 32)
        dot = fmaf(wload(__ldg(q + col)), wload(__ldg(krow + col)), dot);
    }
    dot = warp_sum(dot);
    if (lane == 0 && r < n) sc[r] = dot * a.scale;
  }
  __syncthreads();
  if (a.passes == 1) return;
  float m = -INFINITY;
  for (int r = 0; r < n; ++r) m = fmaxf(m, sc[r]);
  __syncthreads();   // every thread has read the scores
  if (threadIdx.x < n) sc[threadIdx.x] = expf(sc[threadIdx.x] - m);
  __syncthreads();
  float l = 0.f;
  for (int r = 0; r < n; ++r) l += sc[r];
  if (a.passes == 2) return;
  const int chunks = gridDim.x;
  float* mine = a.part + ((size_t)bh * chunks + c) * (D + 2);
  const TE* vbase = static_cast<const TE*>(a.v) + cache + (size_t)p0 * D;
  for (int d = threadIdx.x; d < D; d += NT) {
    float od = 0.f;
    for (int r = 0; r < n; ++r)
      od = fmaf(sc[r], wload(__ldg(vbase + (size_t)r * D + d)), od);
    if (a.passes == 3) continue;
    if (chunks == 1) wstore(go + (size_t)bh * D + d, od / l);
    else mine[2 + d] = od;
  }
  if (a.passes == 3 || chunks == 1) return;
  if (threadIdx.x == 0) {
    mine[0] = m;
    mine[1] = l;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned v;
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;"
                 : "=r"(v) : "l"(a.tickets + bh) : "memory");
    last = v == (unsigned)(chunks - 1);
    if (last) a.tickets[bh] = 0u;
  }
  __syncthreads();
  if (!last) return;
  const float* parts = a.part + (size_t)bh * chunks * (D + 2);
  float gm = -INFINITY;
  for (int i = 0; i < chunks; ++i)
    gm = fmaxf(gm, __ldcg(parts + (size_t)i * (D + 2)));
  float den = 0.f;
  for (int i = 0; i < chunks; ++i) {
    const float* pi = parts + (size_t)i * (D + 2);
    den = fmaf(expf(__ldcg(pi) - gm), __ldcg(pi + 1), den);
  }
  for (int d = threadIdx.x; d < D; d += NT) {
    float num = 0.f;
    for (int i = 0; i < chunks; ++i) {
      const float* pi = parts + (size_t)i * (D + 2);
      num = fmaf(expf(__ldcg(pi) - gm), __ldcg(pi + 2 + d), num);
    }
    wstore(go + (size_t)bh * D + d, num / den);
  }
}

// bf16, D <= MAX_D: VEC bf16 a load (8: one 16-byte vector, 1: scalar),
// CPL loads a lane and row; a half-warp a row (lane hl = lane % 16 of half
// lane / 16), load j of lane hl at column (16 j + hl) VEC.  Row 16 i + 2
// warp + half of a tile is lane hl's i-th row.
template <int VEC>
struct Bf16Raw {
  using T = uint4;
  __device__ static T load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static void widen(const T& x, float (&f)[VEC]) {
    const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
};

template <>
struct Bf16Raw<1> {
  using T = unsigned short;
  __device__ static T load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ static void widen(const T& x, float (&f)[1]) {
    f[0] = __bfloat162float(__ushort_as_bfloat16(x));
  }
};

template <int VEC, int CPL>
__global__ void __launch_bounds__(NT)
incremental_attention_bf16_kernel(StepArgs a) {
  using Raw = Bf16Raw<VEC>;
  __shared__ float sc[2][BF_TILE];
  __shared__ float red[2 * NWARPS][MAX_D];
  __shared__ float inbox[BF_CLUSTER][MAX_D + 2];   // the first block's
  __shared__ unsigned long long inbox_bar;
  const int D = a.D, bh = blockIdx.y, rank = blockIdx.x, nb = gridDim.x;
  const int tiles = a.t / BF_TILE + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int half = lane >> 4, hl = lane & 15;
  const size_t cache = (size_t)bh * a.S * D;
  const __nv_bfloat16* gq = static_cast<const __nv_bfloat16*>(a.q) +
                            (size_t)bh * D;
  const __nv_bfloat16* gk = static_cast<const __nv_bfloat16*>(a.k) + cache;
  const __nv_bfloat16* gv = static_cast<const __nv_bfloat16*>(a.v) + cache;
  // the first block's inbox, published by the barrier
  if (rank == 0 && threadIdx.x == 0) {
    mbar_init(&inbox_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_arrive();

  float qv[CPL][VEC], o[CPL][VEC];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int col = (16 * j + hl) * VEC;
    typename Raw::T x{};
    if (col < D) x = Raw::load(gq + col);
    Raw::widen(x, qv[j]);
#pragma unroll
    for (int e = 0; e < VEC; ++e) o[j][e] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  int buf = 0;
  for (int tile = rank; tile < tiles; tile += nb, buf ^= 1) {
    const int p0 = tile * BF_TILE, n = min(BF_TILE, a.t + 1 - p0);
    // every load of this lane first: K and V of its rows
    typename Raw::T kr[BF_ROWS][CPL], vr[BF_ROWS][CPL];
#pragma unroll
    for (int i = 0; i < BF_ROWS; ++i) {
      const int r = 16 * i + 2 * warp + half;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int col = (16 * j + hl) * VEC;
        kr[i][j] = vr[i][j] = typename Raw::T{};
        if (r < n && col < D) {
          kr[i][j] = Raw::load(gk + (size_t)(p0 + r) * D + col);
          vr[i][j] = Raw::load(gv + (size_t)(p0 + r) * D + col);
        }
      }
    }
    // the rows' scores, a half-warp sum each
#pragma unroll
    for (int i = 0; i < BF_ROWS; ++i) {
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        float kf[VEC];
        Raw::widen(kr[i][j], kf);
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot = fmaf(qv[j][e], kf[e], dot);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) dot += __shfl_xor_sync(FULL, dot, w);
      const int r = 16 * i + 2 * warp + half;
      if (hl == 0 && r < n) sc[buf][r] = dot * a.scale;
    }
    __syncthreads();
    // the tile's max and sum folded into (m, l) in every warp (lane l
    // holds positions l and l + 32), o rescaled
    const float s0 = lane < n ? sc[buf][lane] : -INFINITY;
    const float s1 = lane + 32 < n ? sc[buf][lane + 32] : -INFINITY;
    const float mn = fmaxf(m, warp_max(fmaxf(s0, s1)));
    const float keep = expf(m - mn);
    const float e0 = expf(s0 - mn), e1 = expf(s1 - mn);
    l = fmaf(l, keep, warp_sum(e0 + e1));
    m = mn;
    // p v over this lane's rows
#pragma unroll
    for (int i = 0; i < BF_ROWS; ++i) {
      const float pr = __shfl_sync(FULL, i < 2 ? e0 : e1,
                                   16 * (i & 1) + 2 * warp + half);
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        float vf[VEC];
        Raw::widen(vr[i][j], vf);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          o[j][e] = fmaf(pr, vf[e], i == 0 ? o[j][e] * keep : o[j][e]);
      }
    }
  }
  // the block's p v row: the 16 half-warps' partial rows added
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int col = (16 * j + hl) * VEC;
    if (col < D)
#pragma unroll
      for (int e = 0; e < VEC; ++e) red[2 * warp + half][col + e] = o[j][e];
  }
  __syncthreads();
  const int d = threadIdx.x;
  float od = 0.f;
  if (d < D)
#pragma unroll
    for (int r = 0; r < 2 * NWARPS; ++r) od += red[r][d];
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o) + (size_t)bh * D;
  cluster_wait();   // the inbox's mbarrier is initialised
  if (nb == 1) {
    if (d < D) out[d] = __float2bfloat16_rn(od / l);
    return;
  }

  if (rank > 0) {   // (m, l, o[D]) into the first block's inbox
    const unsigned dst = cluster_addr(inbox[rank], 0);
    const unsigned bar = cluster_addr(&inbox_bar, 0);
    if (d == 0) {
      st_async(dst, bar, m);
      st_async(dst + 4, bar, l);
    }
    if (d < D) st_async(dst + 4 * (2 + d), bar, od);
    return;
  }
  if (threadIdx.x == 0) mbar_expect(&inbox_bar, 4u * (nb - 1) * (D + 2));
  inbox[0][0] = m;      // the first block's own row, from registers
  inbox[0][1] = l;
  if (d < D) inbox[0][2 + d] = od;
  __syncthreads();
  mbar_wait(&inbox_bar, 0);
  float gm = -INFINITY;
  for (int r = 0; r < nb; ++r) gm = fmaxf(gm, inbox[r][0]);
  float num = 0.f, den = 0.f;
  for (int r = 0; r < nb; ++r) {
    const float wr = expf(inbox[r][0] - gm);
    den = fmaf(wr, inbox[r][1], den);
    if (d < D) num = fmaf(wr, inbox[r][2 + d], num);
  }
  if (d < D) out[d] = __float2bfloat16_rn(num / den);
}

__global__ void empty_kernel() {}

template <int VEC, int CPL>
cudaError_t launch(const StepArgs& a, int chunks, cudaStream_t stream) {
  incremental_attention_kernel<float, VEC, CPL>
      <<<dim3(chunks, a.bh), NT, 0, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_f32(const StepArgs& a, int chunks, cudaStream_t s) {
  const uintptr_t bases = (uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v;
  if (a.D % 4 == 0 && bases % 16 == 0)
    return a.D <= 128 ? launch<4, 1>(a, chunks, s)
                      : launch<4, 2>(a, chunks, s);
  return launch<1, MAX_D / 32>(a, chunks, s);
}

template <int VEC, int CPL>
cudaError_t launch_bf16(const StepArgs& a, int nb, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb, a.bh);
  cfg.blockDim = dim3(NT);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, incremental_attention_bf16_kernel<VEC, CPL>, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

cudaError_t launch_bf16_narrow(const StepArgs& a, cudaStream_t s) {
  const int nb = min(BF_CLUSTER, a.t / BF_TILE + 1);
  const uintptr_t bases = (uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v;
  if (a.D % 8 == 0 && bases % 16 == 0)
    return a.D <= 128 ? launch_bf16<8, 1>(a, nb, s)
                      : launch_bf16<8, 2>(a, nb, s);
  return launch_bf16<1, MAX_D / 16>(a, nb, s);
}

}  // namespace

extern "C" int incremental_attention_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" int incremental_attention_launch(const StepArgs* args,
                                            void* stream) {
  const StepArgs a = *args;
  const bool bf16_narrow = a.elem == 1 && a.D <= MAX_D;
  if (a.bh < 1 || a.bh > 65535 || a.D < 1 || a.t < 0 || a.t >= a.S ||
      a.chunk != (bf16_narrow ? BF_TILE : STEP_CHUNK) ||
      (a.elem != 0 && a.elem != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16_narrow) return (int)launch_bf16_narrow(a, s);
  const int chunks = (a.t + STEP_CHUNK) / STEP_CHUNK;
  if (chunks > 1 && (a.part == nullptr || a.tickets == nullptr))
    return (int)cudaErrorInvalidValue;
  if (a.D > MAX_D) {
    if (a.elem)
      incremental_attention_wide_kernel<__nv_bfloat16>
          <<<dim3(chunks, a.bh), NT, 0, s>>>(a);
    else
      incremental_attention_wide_kernel<float>
          <<<dim3(chunks, a.bh), NT, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  return (int)launch_f32(a, chunks, s);
}
