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
// registers hold, takes ``incremental_attention_wide_kernel`` (described
// above it): 16-position tiles folded online a warp at a time, the
// columns in slabs of 512, 16-byte loads of K and V issued together and a
// tile ahead, the blocks merged by tickets; any width, and no shared
// memory that grows with D (bound: the bytes again; at S = 3000, D = 512
// the 24.6 MB of K and V, 7.3 us).  bf16 operands (``elem`` = 1: the model-wide bf16's
// query and bf16 KV cache) run ``incremental_attention_bf16_kernel`` up
// to D = 256 and the wide kernel past it (the element type a template
// parameter, 8 bf16 a 16-byte load).  The bf16
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
  int blocks;       // the wide kernel: blocks a (head, slab)
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

// D > MAX_D (f32 and bf16): the cache up to t in tiles of WIDE_TILE = 16
// positions, tile j to block j mod nb of the head (nb = ``blocks``), and
// the columns in slabs of WIDE_SLAB = 512 (one slab up to D = 512, each
// slab a block column of the grid: a block's scores still sum over every
// slab of K, its values and context are its own slab's).  Each warp takes
// two rows of a tile and folds them online into its own (m, l, o) in
// registers, lanes over the slab's columns (VEC elements a load, CPL loads
// a lane and row: 16-byte loads of 4 f32 or 8 bf16 where D and the bases
// allow, else one element); K and V of a tile are loaded together, and the
// next tile's loads are issued before the current one is used (q sits in
// shared memory, so no register holds it).  No barrier until the block's 8
// warps merge in shared memory (in warp order).  Where a (head, slab) has
// more than one block, each block's (m, l, o[slab]) goes to the scratch,
// takes a ticket, and the last to arrive brings every block's (m, l) into
// shared memory while its loads of its columns of the partials fly,
// computes each partial's weight e^(m_i - m) once (a thread each) and
// folds them in block order, so two calls give the same bits.
// ``step_plan_wide`` in ops/pallas_attention.py gives the blocks.  S =
// 450, D = 257: 7.2 us, against 15.1 for the kernel this replaced, which
// took a 32-position chunk a block, one row's scores after another and V
// after them, and merged from L2 column by column; S = 3000, D = 512: 13.7
// us against 44.2 (H100 80GB HBM3 at 700.00 W, scripts/torch_serving_ab.py
// --cases wide).  Clusters of 8 merged first in their first block's shared
// memory (st.async, as the bf16 narrow kernel's) took 9.4 and 13.8 us in
// f32 and 11.6 against 12.0 in bf16 at S = 3000: too little to keep a
// second merge for.
constexpr int WIDE_ROWS = 2;                    // rows a warp a tile
constexpr int WIDE_TILE = NWARPS * WIDE_ROWS;   // positions a tile
constexpr int WIDE_SLAB = 512;                  // columns a block's slab
constexpr int WIDE_LD = WIDE_SLAB + 2;          // a partial: m, l, o[slab]
constexpr int WIDE_PER = WIDE_SLAB / NT;        // merge columns a thread
constexpr int WIDE_MERGE = 32;    // partials whose columns a thread loads
                                  // at a time in the last block's merge
// shared memory: the warps' context rows (q's slab before them)
constexpr int WIDE_POOL = NWARPS * WIDE_SLAB;

template <class TE, int VEC>
struct Raw;

template <>
struct Raw<float, 4> {
  using T = float4;
  __device__ static T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static void widen(const T& x, float (&f)[4]) {
    f[0] = x.x, f[1] = x.y, f[2] = x.z, f[3] = x.w;
  }
};

template <>
struct Raw<float, 1> {
  using T = float;
  __device__ static T load(const float* p) { return __ldg(p); }
  __device__ static void widen(const T& x, float (&f)[1]) { f[0] = x; }
};

template <int VEC>
struct Raw<__nv_bfloat16, VEC> : Bf16Raw<VEC> {};

template <class TE, int VEC, int CPL>
__global__ void __launch_bounds__(NT, 1)
incremental_attention_wide_kernel(StepArgs a) {
  using R = Raw<TE, VEC>;
  using RT = typename R::T;
  __shared__ __align__(16) float pool[WIDE_POOL];
  __shared__ float wm[NWARPS], wl[NWARPS];
  __shared__ int last;
  const int D = a.D, bh = blockIdx.y, nb = a.blocks;
  const int slab = blockIdx.x / nb, b = blockIdx.x % nb;
  const int slabs = (D + WIDE_SLAB - 1) / WIDE_SLAB;
  const int c0 = slab * WIDE_SLAB, width = min(WIDE_SLAB, D - c0);
  const int tiles = a.t / WIDE_TILE + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t cache = (size_t)bh * a.S * D;
  const TE* gq = static_cast<const TE*>(a.q) + (size_t)bh * D;
  const TE* gk = static_cast<const TE*>(a.k) + cache;
  const TE* gv = static_cast<const TE*>(a.v) + cache;
  float* sq = pool;                    // q's score slab, zero past D
  // K of score slab ks (and V of this block's slab with ks == 0) of the
  // warp's rows of tile j, zero past t and D
  auto load_tile = [&](int j, int ks, RT (&kr)[WIDE_ROWS][CPL],
                       RT (&vr)[WIDE_ROWS][CPL]) {
#pragma unroll
    for (int i = 0; i < WIDE_ROWS; ++i) {
      const int p = j * WIDE_TILE + warp + NWARPS * i;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int col = (32 * c + lane) * VEC;
        kr[i][c] = RT{};
        if (p <= a.t && ks * WIDE_SLAB + col < D)
          kr[i][c] = R::load(gk + (size_t)p * D + ks * WIDE_SLAB + col);
        if (ks == 0) {
          vr[i][c] = RT{};
          if (p <= a.t && col < width && a.passes != 1)
            vr[i][c] = R::load(gv + (size_t)p * D + c0 + col);
        }
      }
    }
  };
  auto stage_q = [&](int ks) {
    __syncthreads();   // the last slab's readers are done
    for (int e = threadIdx.x; e < WIDE_SLAB; e += NT) {
      const int col = ks * WIDE_SLAB + e;
      sq[e] = col < D ? wload(__ldg(gq + col)) : 0.f;
    }
    __syncthreads();
  };
  RT kr[WIDE_ROWS][CPL], vr[WIDE_ROWS][CPL];
  load_tile(b, 0, kr, vr);
  stage_q(0);   // its loads behind the first tile's
  float o[CPL][VEC];
#pragma unroll
  for (int c = 0; c < CPL; ++c)
#pragma unroll
    for (int e = 0; e < VEC; ++e) o[c][e] = 0.f;
  constexpr float FLOOR = -3.0e38f;   // finite: an empty warp weighs 0
  float m = FLOOR, l = 0.f;
  for (int tile = b; tile < tiles; tile += nb) {
    RT kn[WIDE_ROWS][CPL], vn[WIDE_ROWS][CPL];
    if (tile + nb < tiles) load_tile(tile + nb, 0, kn, vn);   // in flight
    float dot[WIDE_ROWS];
#pragma unroll
    for (int i = 0; i < WIDE_ROWS; ++i) dot[i] = 0.f;
    for (int ks = 0; ks < slabs; ++ks) {
      if (ks > 0) {   // D > WIDE_SLAB: the next slab of K and of q
        load_tile(tile, ks, kr, vr);
        stage_q(ks);
      }
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        float qf[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) qf[e] = sq[(32 * c + lane) * VEC + e];
#pragma unroll
        for (int i = 0; i < WIDE_ROWS; ++i) {
          float kf[VEC];
          R::widen(kr[i][c], kf);
#pragma unroll
          for (int e = 0; e < VEC; ++e) dot[i] = fmaf(qf[e], kf[e], dot[i]);
        }
      }
    }
    if (slabs > 1) stage_q(0);
    float s[WIDE_ROWS], mt = FLOOR;
#pragma unroll
    for (int i = 0; i < WIDE_ROWS; ++i) {
      s[i] = tile * WIDE_TILE + warp + NWARPS * i <= a.t
                 ? warp_sum(dot[i]) * a.scale
                 : -INFINITY;
      mt = fmaxf(mt, s[i]);
    }
    if (a.passes != 1) {
      // the tile's rows folded into this warp's (m, l, o)
      const float mn = fmaxf(m, mt), keep = expf(m - mn);
      float pr[WIDE_ROWS];
      l *= keep;
#pragma unroll
      for (int i = 0; i < WIDE_ROWS; ++i) {
        pr[i] = expf(s[i] - mn);
        l += pr[i];
      }
      m = mn;
      if (a.passes != 2)
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) o[c][e] *= keep;
#pragma unroll
          for (int i = 0; i < WIDE_ROWS; ++i) {
            float vf[VEC];
            R::widen(vr[i][c], vf);
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              o[c][e] = fmaf(pr[i], vf[e], o[c][e]);
          }
        }
    }
#pragma unroll
    for (int i = 0; i < WIDE_ROWS; ++i)
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        kr[i][c] = kn[i][c];
        vr[i][c] = vn[i][c];
      }
  }
  if (a.passes) return;

  // the block's 8 warps merged in warp order: (gm, den, num[k]) for
  // columns c = threadIdx.x + NT k of the slab
  __syncthreads();   // q's slab is read; its floats hold the warps' rows
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int col = (32 * c + lane) * VEC;
    if (col < width)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        pool[warp * WIDE_SLAB + col + e] = o[c][e];
  }
  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
  __syncthreads();
  float gm = FLOOR, den = 0.f, num[WIDE_PER];
  for (int w = 0; w < NWARPS; ++w) gm = fmaxf(gm, wm[w]);
#pragma unroll
  for (int k = 0; k < WIDE_PER; ++k) num[k] = 0.f;
  for (int w = 0; w < NWARPS; ++w) {
    const float wt = expf(wm[w] - gm);
    den = fmaf(wt, wl[w], den);
#pragma unroll
    for (int k = 0; k < WIDE_PER; ++k) {
      const int c = threadIdx.x + NT * k;
      if (c < width) num[k] = fmaf(wt, pool[w * WIDE_SLAB + c], num[k]);
    }
  }
  TE* out = static_cast<TE*>(a.o) + (size_t)bh * D + c0;
  if (nb == 1) {
#pragma unroll
    for (int k = 0; k < WIDE_PER; ++k) {
      const int c = threadIdx.x + NT * k;
      if (c < width) wstore(out + c, num[k] / den);
    }
    return;
  }
  // the partials of this (head, slab): rows of m, l, o[width]
  const int rl = width + 2;
  const size_t hs = (size_t)bh * slabs + slab;
  float* parts = a.part + hs * nb * WIDE_LD;
  float* mine = parts + (size_t)b * rl;
  if (threadIdx.x == 0) {
    mine[0] = gm;
    mine[1] = den;
  }
#pragma unroll
  for (int k = 0; k < WIDE_PER; ++k) {
    const int c = threadIdx.x + NT * k;
    if (c < width) mine[2 + c] = num[k];
  }
  // the ticket, as the narrow kernel's: the last of the nb partials merges
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned v;
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;"
                 : "=r"(v) : "l"(a.tickets + hs) : "memory");
    last = v == (unsigned)(nb - 1);
    if (last) a.tickets[hs] = 0u;
  }
  __syncthreads();
  if (!last) return;
  // thread i < nb brings partial i's (m, l) into shared memory while every
  // thread's loads of its columns of the first WIDE_MERGE partials fly;
  // each partial's weight e^(m_i - m) is computed once (by thread i), and
  // the columns are summed over the partials in order
  float* pw = pool;        // nb weights
  float* pl = pool + NT;   // nb sums
  float ov[WIDE_MERGE][WIDE_PER];
  auto load_o = [&](int i0) {
#pragma unroll
    for (int i = 0; i < WIDE_MERGE; ++i)
#pragma unroll
      for (int k = 0; k < WIDE_PER; ++k) {
        const int c = threadIdx.x + NT * k;
        ov[i][k] = i0 + i < nb && c < width
                       ? __ldcg(parts + (size_t)(i0 + i) * rl + 2 + c)
                       : 0.f;
      }
  };
  load_o(0);
  float mi = FLOOR;
  if (threadIdx.x < nb) {
    mi = __ldcg(parts + (size_t)threadIdx.x * rl);
    pl[threadIdx.x] = __ldcg(parts + (size_t)threadIdx.x * rl + 1);
    pw[threadIdx.x] = mi;
  }
  __syncthreads();
  gm = FLOOR;
  for (int i = 0; i < nb; ++i) gm = fmaxf(gm, pw[i]);
  __syncthreads();   // every thread has the max
  if (threadIdx.x < nb) pw[threadIdx.x] = expf(mi - gm);
  __syncthreads();
  den = 0.f;
  for (int i = 0; i < nb; ++i) den = fmaf(pw[i], pl[i], den);
#pragma unroll
  for (int k = 0; k < WIDE_PER; ++k) num[k] = 0.f;
  for (int i0 = 0; i0 < nb; i0 += WIDE_MERGE) {
    if (i0 > 0) load_o(i0);
#pragma unroll
    for (int i = 0; i < WIDE_MERGE; ++i)
      if (i0 + i < nb)
#pragma unroll
        for (int k = 0; k < WIDE_PER; ++k)
          num[k] = fmaf(pw[i0 + i], ov[i][k], num[k]);
  }
#pragma unroll
  for (int k = 0; k < WIDE_PER; ++k) {
    const int c = threadIdx.x + NT * k;
    if (c < width) wstore(out + c, num[k] / den);
  }
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

template <class TE, int VEC, int CPL>
cudaError_t launch_wide_instance(const StepArgs& a, cudaStream_t s) {
  const dim3 grid(a.blocks * ((a.D + WIDE_SLAB - 1) / WIDE_SLAB), a.bh);
  incremental_attention_wide_kernel<TE, VEC, CPL><<<grid, NT, 0, s>>>(a);
  return cudaGetLastError();
}

// the wide kernel's plan (``step_plan_wide`` in ops/pallas_attention.py):
// ``blocks`` a (head, slab), at most its tiles
cudaError_t launch_wide(const StepArgs& a, cudaStream_t s) {
  const int tiles = a.t / WIDE_TILE + 1;
  if (a.blocks < 1 || a.blocks > tiles || a.blocks > NT ||
      (a.blocks > 1 && (a.part == nullptr || a.tickets == nullptr)))
    return cudaErrorInvalidValue;
  // one element a lane where D or a base rules out 16-byte loads: 9 loads
  // a lane and row cover D <= 288 (the edge a 257-wide head sits at), 16
  // a slab
  const uintptr_t bases = (uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v;
  const bool vec = bases % 16 == 0 && a.D % (a.elem ? 8 : 4) == 0;
  const bool narrow = a.D <= 9 * 32;
  if (a.elem)
    return vec ? launch_wide_instance<__nv_bfloat16, 8, 2>(a, s)
           : narrow ? launch_wide_instance<__nv_bfloat16, 1, 9>(a, s)
                    : launch_wide_instance<__nv_bfloat16, 1, 16>(a, s);
  return vec ? launch_wide_instance<float, 4, 4>(a, s)
         : narrow ? launch_wide_instance<float, 1, 9>(a, s)
                  : launch_wide_instance<float, 1, 16>(a, s);
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
  const int chunk = a.D > MAX_D ? WIDE_TILE
                                : bf16_narrow ? BF_TILE : STEP_CHUNK;
  if (a.bh < 1 || a.bh > 65535 || a.D < 1 || a.t < 0 || a.t >= a.S ||
      a.chunk != chunk || (a.elem != 0 && a.elem != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16_narrow) return (int)launch_bf16_narrow(a, s);
  if (a.D > MAX_D) return (int)launch_wide(a, s);
  const int chunks = (a.t + STEP_CHUNK) / STEP_CHUNK;
  if (chunks > 1 && (a.part == nullptr || a.tickets == nullptr))
    return (int)cudaErrorInvalidValue;
  return (int)launch_f32(a, chunks, s);
}
