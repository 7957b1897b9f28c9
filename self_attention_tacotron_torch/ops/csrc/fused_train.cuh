// Pieces shared by the two training kernels (fused_train_fwd.cu,
// fused_train_bwd.cu): the argument struct, the shared-memory plans, the
// staging of rows with cp.async, the batched row product over resident
// weight slices and a 128 x 64 tile product, both on the tensor cores
// (mma.sync m16n8k8 TF32 in the 3xTF32 split of mma.cuh, f32 accuracy),
// the attention items' enumeration, the zoneout LSTM step and its VJP, the
// profile clock and the launcher.
//
// The bf16 storage mode (a.bf16, the kernels' bf16 instances; the JAX
// kernels' compute_dtype =
// "bfloat16"): the wrapper hands over weights, keys, values and the teacher
// already rounded to bf16 (in f32 words); the resident weight slices are
// held as bf16 pairs (half the shared memory) and the row and tile
// products run as mma.sync m16n8k16 bf16 with f32 sums, the input rows
// rounded to bf16 as their fragments are loaded (cvt.rn.bf16x2.f32): one
// mma a 16-deep step where the f32 mode's split runs six.  Each step's
// product starts from zero in the tensor core and is added in f32
// outside it, as in the f32 mode (the tensor core's own long sums drift).
#pragma once

#include <cstddef>
#include <cstdint>

#include "common.cuh"
#include "masks.cuh"
#include "mma.cuh"

constexpr int TR_MAX_SOURCES = 4, TR_MAX_PRENET = 4, TR_MAX_B = 64;

struct TrainArgs {  // mirrored by _TrainArgs in ops/fused_train.py
  int B, S, T, cf, ns, n_pre, A, D, K, use_spk, deterministic, save_w,
      stash_w, bf16;
  unsigned int seed;
  int kinds[TR_MAX_SOURCES], cumulative[TR_MAX_SOURCES];
  int u_off[TR_MAX_SOURCES + 1], c_off[TR_MAX_SOURCES + 1];
  int p_sizes[TR_MAX_PRENET], p_dropout[TR_MAX_PRENET];
  int off_p[TR_MAX_PRENET], off_pd[TR_MAX_PRENET];
  int off_gatt, off_catt, off_hatt, off_pq, off_ctx, off_proj, off_g1,
      off_c1, off_h1, off_o1, off_g2, off_c2, off_h2;
  int off_dgatt, off_dg1, off_dg2, off_dproj, off_dpq,
      off_dctxs;  // stash fields
  float drop_rate, drop_scale, zc_att, zo_att, zc_dec, zo_dec;
  const float* keys[TR_MAX_SOURCES];    // (B*T, U_i)
  const float* values[TR_MAX_SOURCES];  // (B*T, C_i)
  const float* mask;     // (ns, B, T)
  const float* loc_w;    // (K, sumU), zero columns for additive sources
  const float* v;        // (sumU)
  const float* teacher;  // (S*B, cf)
  const float* spk;      // (B, P0)
  const float* pre_w[TR_MAX_PRENET];  // (in, out)
  const float* pre_b[TR_MAX_PRENET];
  const float* att_w;  // (P + sumC + A, 4A)
  const float* att_b;
  const float* q_w;    // (A, sumU)
  const float* op_w;   // (A + sumC, D)
  const float* op_b;
  const float* l1_w;   // (2D, 4D)
  const float* l1_b;
  const float* l2_w;
  const float* l2_b;
  float* y;     // (S*B, D)
  float* save;  // (S*B, save_w)
  float* aux;   // (S, ns, 3, B, T): softmax, alignment, conv input
  const float* g_y;  // (S*B, D) backward input
  float* stash;      // (S*B, stash_w) backward cotangent rows
  float* d_pre_w[TR_MAX_PRENET];  // (in + 1, out): weights, then the bias
  float* d_att;     // (Zatt + 1, 4A)
  float* d_q;       // (A, sumU)
  float* d_op;      // (A + sumC + 1, D)
  float* d_l1;      // (2D + 1, 4D)
  float* d_l2;
  float* d_keys[TR_MAX_SOURCES];
  float* d_values[TR_MAX_SOURCES];
  float* d_v;       // (sumU)
  float* d_loc;     // (K, sumU)
  float* d_spk;     // (B, P0)
  float* scratch;
  long long* stage_cycles;  // optional profile (TrainClock)
};

// stages of the optional profile (FWD_STAGES / BWD_STAGES in
// ops/fused_train.py)
enum { F_PRENET, F_ATT_LSTM, F_QUERY, F_ENERGY, F_CONTEXT, F_PROJ, F_LSTM1,
       F_LSTM2, F_N };
enum { B_SETUP, B_LSTM2, B_DZ2_LSTM1, B_DZ1, B_DZOP, B_DW_ATT, B_ATTENTION,
       B_DQ_ATT_LSTM, B_DZATT, B_DW, B_PRENET, B_N };

// The optional profile (a.stage_cycles != nullptr).  Block 0's thread 0
// splits each stage's SM cycles into four parts, counts[stage * 4 + part]:
// P_COPY staging the input rows, P_PRODUCT the product, P_EPI the
// reduction and epilogue, P_WAIT the grid barrier.  Thread 0 of every
// block adds the cycles of each attention item it runs to
// counts[n_stages * 4 + blockIdx.x * TR_MAX_SOURCES + source].  The sums
// stay in the thread's own (L1-resident) memory until flush() at the end
// of the kernel: a read-modify-write through L2 at every mark would hold
// block 0 back by a round trip each time.
enum { P_COPY, P_PRODUCT, P_EPI, P_WAIT, N_PARTS };
constexpr int TR_MAX_PARTS = 12 * N_PARTS;

struct TrainClock {
  long long* counts;
  long long last, item;
  int n_stages;
  long long parts[TR_MAX_PARTS], items[TR_MAX_SOURCES];
  __device__ TrainClock(long long* c, int n)
      : counts(c), last(0), item(0), n_stages(n) {
    if (counts != nullptr && threadIdx.x % (NT / 2) == 0) {
      for (int i = 0; i < TR_MAX_PARTS; ++i) parts[i] = 0;
      for (int i = 0; i < TR_MAX_SOURCES; ++i) items[i] = 0;
      last = clock64();
    }
  }
  __device__ bool on() const {
    return counts != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  }
  __device__ void part(int stage, int p) {
    if (on()) {
      const long long now = clock64();
      parts[stage * N_PARTS + p] += now - last;
      last = now;
    }
  }
  // the first thread of each half block (items run a half block each)
  __device__ void item_begin() {
    if (counts != nullptr && threadIdx.x % (NT / 2) == 0) item = clock64();
  }
  __device__ void item_end(int src) {
    if (counts != nullptr && threadIdx.x % (NT / 2) == 0)
      items[src] += clock64() - item;
  }
  __device__ void flush() {
    if (counts == nullptr || threadIdx.x % (NT / 2) != 0) return;
    if (blockIdx.x == 0 && threadIdx.x == 0)
      for (int i = 0; i < n_stages * N_PARTS; ++i) counts[i] = parts[i];
    for (int i = 0; i < TR_MAX_SOURCES; ++i)
      atomicAdd(reinterpret_cast<unsigned long long*>(counts) + n_stages *
                    N_PARTS + blockIdx.x * TR_MAX_SOURCES + i,
                (unsigned long long)items[i]);
  }
};

__host__ __device__ inline int tr_sumU(const TrainArgs& a) {
  return a.u_off[a.ns];
}
__host__ __device__ inline int tr_sumC(const TrainArgs& a) {
  return a.c_off[a.ns];
}
__host__ __device__ inline int tr_plast(const TrainArgs& a) {
  return a.p_sizes[a.n_pre - 1];
}
__host__ __device__ inline int tr_zatt(const TrainArgs& a) {
  return tr_plast(a) + tr_sumC(a) + a.A;
}
__host__ __device__ inline int tr_max(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int tr_cdiv(int a, int b) { return (a + b - 1) / b; }
// the least stride >= n that is 4 mod 32: an mma fragment's 8 x 4 lanes
// then read 32 different banks, and rows stay 16-byte aligned
__host__ __device__ inline int tr_pad(int n) { return ((n + 27) / 32) * 32 + 4; }
__host__ __device__ inline size_t tr_al4(size_t n) { return (n + 3) & ~(size_t)3; }
// the row stride (floats) of a resident slice of n weights: tr_pad(n), or
// in the bf16 mode tr_pad of its 32-bit words (a bf16 pair a word, so the
// B fragments' 8 x 4 lanes still read 32 different banks)
__host__ __device__ inline int tr_wpad(const TrainArgs& a, int n) {
  return a.bf16 ? tr_pad((n + 1) / 2) : tr_pad(n);
}

// this block's share of N items (item n belongs to block n % nb)
__host__ __device__ inline int tr_items(int N, int nb) {
  return (N + nb - 1) / nb;
}

// ---------------------------------------------------------- row groups
// The product stages split the B rows into G groups (two above 16 rows):
// block b serves rows [r0, r0 + nr) of group b % G and the items n with
// n % nbg == b / G (nbg = gridDim / G).  Each block then stages only its
// group's rows (the copies from L2, which every block makes, halve) and
// holds G times as many resident columns.
__host__ __device__ inline int tr_groups(int B) { return B > 16 ? 2 : 1; }

struct RowGroup {
  int bi, nbg, r0, nr;
  // this block's items of N, and its item of slot s
  __device__ int items(int N) const {
    return bi < nbg && N > bi ? (N - bi + nbg - 1) / nbg : 0;
  }
  __device__ int item(int s) const { return bi + nbg * s; }
};

__device__ inline RowGroup row_group(int B) {
  const int G = tr_groups(B), Bh = tr_cdiv(B, G);
  RowGroup g;
  g.nbg = gridDim.x / G;
  g.bi = blockIdx.x / G;
  g.r0 = (blockIdx.x % G) * Bh;
  g.nr = g.bi < g.nbg ? min(Bh, B - g.r0) : 0;
  return g;
}

// ---------------------------------------------------- attention items
// The attention stages split each (source, row) pair into items of US
// units (energies, the VJP) or CS value columns (the context), so that the
// two sources' items cost about the same and >= 128 blocks share a stage
// at the recipe (2 sources x 32 rows -> 256 unit items).
constexpr int US = 32, CS = 64;

__host__ __device__ inline int tr_uslices(const TrainArgs& a, int src) {
  return tr_cdiv(a.u_off[src + 1] - a.u_off[src], US);
}
__host__ __device__ inline int tr_cslices(const TrainArgs& a, int src) {
  return tr_cdiv(a.c_off[src + 1] - a.c_off[src], CS);
}
__host__ __device__ inline int tr_max_uslices(const TrainArgs& a) {
  int m = 0;
  for (int i = 0; i < a.ns; ++i) m = tr_max(m, tr_uslices(a, i));
  return m;
}

struct AttItem {
  int src, b, slice;
};

// Item i of B * sum_src n(src): rows outermost, then sources, then slices.
template <bool UNITS>
__host__ __device__ inline int tr_att_items(const TrainArgs& a) {
  int per = 0;
  for (int i = 0; i < a.ns; ++i)
    per += UNITS ? tr_uslices(a, i) : tr_cslices(a, i);
  return per * a.B;
}

template <bool UNITS>
__device__ inline AttItem tr_att_item(const TrainArgs& a, int i) {
  int per = 0;
  for (int s = 0; s < a.ns; ++s)
    per += UNITS ? tr_uslices(a, s) : tr_cslices(a, s);
  AttItem it;
  it.b = i / per;
  int r = i % per;
  it.src = 0;
  for (;;) {
    const int n = UNITS ? tr_uslices(a, it.src) : tr_cslices(a, it.src);
    if (r < n) break;
    r -= n;
    ++it.src;
  }
  it.slice = r;
  return it;
}

// The attention items run two at a time, one on each half of the block
// (HT threads; named barrier 1 + half), so that one item's load latencies
// overlap the other's.  Half h runs the block's items of odd/even slot:
// items blockIdx.x + (2 j + h) gridDim.x.
constexpr int HT = NT / 2, HWARPS = HT / 32;

struct Half {
  int h, tid, warp, lane;
  __device__ Half()
      : h(threadIdx.x / HT), tid(threadIdx.x % HT),
        warp((threadIdx.x % HT) >> 5), lane(threadIdx.x & 31) {}
  __device__ void sync() const {
    asm volatile("bar.sync %0, %1;" :: "r"(1 + h), "r"(HT) : "memory");
  }
};

// ------------------------------------------------- shared-memory plan
// (floats, each region 16-byte aligned; ops/fused_train.py smem_bytes
// mirrors it for the gate)
constexpr int ROW_PART = NWARPS * 128;  // rows_mma's partial tiles
// tile product: A 128 x 32 and B 32 x 64, k-major or m/n-major
constexpr int TBM = 128, TBN = 64, TBK = 32;
constexpr int TA_MK = TBK + 4, TA_KM = TBM + 8, TB_NK = TBK + 4,
              TB_KN = TBN + 8;
constexpr int TILE_SMEM = TBM * TA_MK + TBN * TB_NK;

// offsets in floats (32 bits: they stay live in registers for the whole
// kernel)
struct FwdSmem {
  unsigned att, q, op, l1, l2, att_b, op_b, l1_b, l2_b, v, loc, cst, part,
      red, zs, zp, items, total;
  int ldz;
};

// a block's shared memory on an H100 (the launcher checks the device's)
constexpr size_t TR_SMEM_LIMIT = 232448;

__host__ __device__ inline size_t fwd_att_floats(const TrainArgs& a) {
  // a half block's item: energy item: conv window (T + K), query slice
  // (US); context item: the energies, recursion numerators, conv input,
  // alpha (T each) and 2 partial context rows (CS each)
  const size_t e = (size_t)a.T + a.K + US, c = 4 * (size_t)a.T + 2 * CS;
  return e > c ? e : c;
}

// (item slots of the widest LSTM) x (staged rows), one plane an LSTM
__host__ __device__ inline int fwd_cst_slots(const TrainArgs& a, int nb_all) {
  return tr_items(tr_max(a.A, a.D), nb_all / tr_groups(a.B));
}

__host__ __device__ inline size_t fwd_cst_floats(const TrainArgs& a,
                                                 int nb_all) {
  return 3 * (size_t)fwd_cst_slots(a, nb_all) * tr_cdiv(a.B, tr_groups(a.B));
}

__host__ __device__ inline FwdSmem fwd_smem(const TrainArgs& a, int nb_all) {
  const int A = a.A, D = a.D, sumU = tr_sumU(a), sumC = tr_sumC(a);
  const int nb = nb_all / tr_groups(a.B), rows = tr_cdiv(a.B, tr_groups(a.B));
  FwdSmem m;
  size_t o = 0;  // the plan fits in 32 bits (<= 227 KB); the sums are wide
  m.att = o;
  o = tr_al4(o + (size_t)tr_items(A, nb) * 4 * tr_wpad(a, tr_zatt(a)));
  m.q = o; o = tr_al4(o + (size_t)tr_items(sumU, nb) * tr_wpad(a, A));
  m.op = o; o = tr_al4(o + (size_t)tr_items(D, nb) * tr_wpad(a, A + sumC));
  m.l1 = o; o = tr_al4(o + (size_t)tr_items(D, nb) * 4 * tr_wpad(a, 2 * D));
  m.l2 = o; o = tr_al4(o + (size_t)tr_items(D, nb) * 4 * tr_wpad(a, 2 * D));
  m.att_b = o; o = tr_al4(o + (size_t)tr_items(A, nb) * 4);
  m.op_b = o; o = tr_al4(o + tr_items(D, nb));
  m.l1_b = o; o = tr_al4(o + (size_t)tr_items(D, nb) * 4);
  m.l2_b = o; o = tr_al4(o + (size_t)tr_items(D, nb) * 4);
  m.v = o; o = tr_al4(o + sumU);
  m.loc = o; o = tr_al4(o + (size_t)a.K * sumU);
  // the three LSTMs' cell states of the block's (item, row), kept from one
  // step to the next (the same block owns them every step)
  m.cst = o; o = tr_al4(o + fwd_cst_floats(a, nb_all));
  m.part = o; o = tr_al4(o + ROW_PART);
  m.red = o; o = tr_al4(o + 32);
  m.ldz = tr_pad(tr_max(tr_max(tr_zatt(a), A + sumC), 2 * D));
  // two buffers of staged rows (zs; zp, where the forward stages its next
  // products' step-old inputs while the current ones run; zp = zs when
  // two do not fit), the prenet's tiles reuse zs; the attention items'
  // own region
  const size_t rows_f = (size_t)rows * m.ldz;
  size_t zs = rows_f;
  if (zs < (size_t)TILE_SMEM) zs = TILE_SMEM;
  m.zs = o; o = tr_al4(o + zs);
  m.items = o; o = tr_al4(o + 2 * tr_al4(fwd_att_floats(a)));
  m.zp = o;
  if (tr_al4(o + rows_f) * sizeof(float) <= TR_SMEM_LIMIT)
    o = tr_al4(o + rows_f);
  else
    m.zp = m.zs;
  m.total = o;
  return m;
}

struct BwdSmem {
  unsigned w2, w1, wop, wq, watt, v, loc, part, red, iacc, zs, total;
  int ldz;
};

// d_v and d_loc of the block's attention items (item i runs on block
// i % nb at every step), summed over the steps in shared memory and added
// to the outputs once after the loop: US + K * US floats an item
__host__ __device__ inline size_t bwd_iacc_floats(const TrainArgs& a,
                                                  int nb) {
  return (size_t)tr_cdiv(tr_att_items<true>(a), nb) * (US + a.K * US);
}

__host__ __device__ inline size_t bwd_att_floats(const TrainArgs& a) {
  // a half block's item: softmax, alignment, previous alpha, d_w, d_e,
  // d_s, the recursion's and the conv adjoint's carries (T each), the conv
  // window (T + K), the query slice (US), d_pre (T x (US + 4)), the window
  // adjoint (T x K), two (HWARPS, US) partials
  return 8 * (size_t)a.T + a.T + a.K + US + (size_t)a.T * (US + 4) +
         (size_t)a.T * a.K + 2 * HWARPS * US;
}

__host__ __device__ inline BwdSmem bwd_smem(const TrainArgs& a, int nb_all) {
  const int A = a.A, D = a.D, sumU = tr_sumU(a), sumC = tr_sumC(a);
  const int nb = nb_all / tr_groups(a.B), rows = tr_cdiv(a.B, tr_groups(a.B));
  BwdSmem m;
  size_t o = 0;
  m.w2 = o; o = tr_al4(o + (size_t)tr_items(2 * D, nb) * tr_wpad(a, 4 * D));
  m.w1 = o; o = tr_al4(o + (size_t)tr_items(2 * D, nb) * tr_wpad(a, 4 * D));
  m.wop = o; o = tr_al4(o + (size_t)tr_items(A + sumC, nb) * tr_wpad(a, D));
  m.wq = o; o = tr_al4(o + (size_t)tr_items(A, nb) * tr_wpad(a, sumU));
  m.watt = o;
  o = tr_al4(o + (size_t)tr_items(sumC + A, nb) * tr_wpad(a, 4 * A));
  m.v = o; o = tr_al4(o + sumU);
  m.loc = o; o = tr_al4(o + (size_t)a.K * sumU);
  m.part = o; o = tr_al4(o + ROW_PART);
  m.red = o; o = tr_al4(o + 32);
  m.iacc = o; o = tr_al4(o + bwd_iacc_floats(a, nb_all));
  m.ldz = tr_pad(tr_max(tr_max(4 * D, 4 * A), tr_max(D, sumU)));
  size_t zs = (size_t)rows * m.ldz;
  if (zs < 2 * tr_al4(bwd_att_floats(a))) zs = 2 * tr_al4(bwd_att_floats(a));
  if (zs < (size_t)TILE_SMEM) zs = TILE_SMEM;
  m.zs = o; o = tr_al4(o + zs);
  m.total = o;
  return m;
}

// ------------------------------------------------- resident weight slices
// The block holds items n = rg.item(s).  Item n of an (in, out) matrix
// with R gate groups of N columns is the R columns r * N + n, stored as R
// rows of stride tr_pad(L) (transposed):
// dst[(s * R + r) * Lp + k] = W[k * R * N + r * N + n].
// BF (the bf16 instances): the same rows as bf16 pairs, word kw of a row
// holding weights 2 kw (low half) and 2 kw + 1 (zero past L), rows of
// stride tr_pad((L + 1) / 2) words; the weights arrive rounded to bf16, so
// the conversion is exact.
template <bool BF = false>
__device__ inline void load_cols(float* dst, const float* __restrict__ W,
                                 int N, int R, int L, const RowGroup& rg) {
  const int cnt = rg.items(N);
  if constexpr (BF) {
    const int Lw = (L + 1) / 2, Lp = tr_pad(Lw);
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
    for (int e = threadIdx.x; e < cnt * R * Lw; e += NT) {
      const int kw = e % Lw, sr = e / Lw, r = sr % R, s = sr / R, k = 2 * kw;
      const float* col = W + (size_t)r * N + rg.item(s);
      d[sr * Lp + kw] = bf16x2(
          __ldg(col + (size_t)k * R * N),
          k + 1 < L ? __ldg(col + (size_t)(k + 1) * R * N) : 0.f);
    }
  } else {
    const int Lp = tr_pad(L);
    for (int e = threadIdx.x; e < cnt * R * L; e += NT) {
      const int k = e % L, sr = e / L, r = sr % R, s = sr / R;
      dst[sr * Lp + k] = __ldg(W + (size_t)k * R * N + r * N + rg.item(s));
    }
  }
}

// Item n of a row-major (N, L) matrix is its row n (rows_mma with R = 1).
template <bool BF = false>
__device__ inline void load_rows(float* dst, const float* __restrict__ W,
                                 int N, int L, const RowGroup& rg) {
  const int cnt = rg.items(N);
  if constexpr (BF) {
    const int Lw = (L + 1) / 2, Lp = tr_pad(Lw);
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
    for (int e = threadIdx.x; e < cnt * Lw; e += NT) {
      const int kw = e % Lw, s = e / Lw, k = 2 * kw;
      const float* row = W + (size_t)rg.item(s) * L;
      d[s * Lp + kw] = bf16x2(__ldg(row + k),
                              k + 1 < L ? __ldg(row + k + 1) : 0.f);
    }
  } else {
    const int Lp = tr_pad(L);
    for (int e = threadIdx.x; e < cnt * L; e += NT) {
      const int k = e % L, s = e / L;
      dst[s * Lp + k] = __ldg(W + (size_t)rg.item(s) * L + k);
    }
  }
}

// The bias entries b[r * N + n] of the block's items, at dst[s * R + r].
__device__ inline void load_bias_items(float* dst, const float* __restrict__ b,
                                       int N, int R, const RowGroup& rg) {
  const int cnt = rg.items(N);
  for (int e = threadIdx.x; e < cnt * R; e += NT) {
    const int r = e % R, s = e / R;
    dst[e] = __ldg(b + (size_t)r * N + rg.item(s));
  }
}

// ------------------------------------------------------------ staging
// Copy a (B, width) block of rows (leading dimension ld, written by other
// blocks) to columns [col, col + width) of the staged rows.  Where rows
// and columns are 16-byte aligned, the first warp hands each row to the
// Tensor Memory Accelerator as one bulk copy (cp.async.bulk, L2 to shared
// memory) that completes on the block's mbarrier: the threads neither
// wait for the copies nor stall on a per-thread limit of copies in flight,
// so a stage can start the copies of a later stage and go on computing.
// Otherwise loads go through registers (__ldcg, STAGE_BATCH in flight a
// thread).  src == nullptr stages zeros.  wait() returns when every copy
// started so far has landed (one mbarrier phase a call), behind a block
// barrier.
constexpr int STAGE_BATCH = 8;

struct Stager {
  uint64_t* bar;   // in shared memory, 8-byte aligned
  unsigned phase;  // the parity of the phase the next wait() completes

  __device__ explicit Stager(uint64_t* b) : bar(b), phase(0) {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_u32(bar)) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }

  __device__ void rows(float* zs, int ldz, int col, int B, const float* src,
                       size_t ld, int width) {
    if (src == nullptr) {
      for (int e = threadIdx.x; e < B * width; e += NT)
        zs[(e / width) * ldz + col + e % width] = 0.f;
    } else if (width % 4 == 0 && ld % 4 == 0 && col % 4 == 0 &&
               ldz % 4 == 0 && reinterpret_cast<size_t>(src) % 16 == 0) {
      if (threadIdx.x < 32) {
        // lane 0 raises the phase's expected bytes before the copies go out
        // (its arrive in wait() comes after, so the phase cannot complete
        // early)
        if (threadIdx.x == 0)
          asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;"
                       :: "r"(smem_u32(bar)), "r"((unsigned)(B * width * 4))
                       : "memory");
        __syncwarp();
        // the buffer's earlier reads (generic proxy) before the copies'
        // writes (async proxy)
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        for (int r = threadIdx.x; r < B; r += 32)
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
              " [%0], [%1], %2, [%3];"
              :: "r"(smem_u32(zs + r * ldz + col)), "l"(src + (size_t)r * ld),
                 "r"((unsigned)(width * 4)), "r"(smem_u32(bar))
              : "memory");
      }
    } else {
      int r = threadIdx.x / width, k = threadIdx.x % width;
      while (r < B) {
        float v[STAGE_BATCH];
        int rr[STAGE_BATCH], kk[STAGE_BATCH];
#pragma unroll
        for (int i = 0; i < STAGE_BATCH; ++i) {
          rr[i] = r;
          kk[i] = k;
          if (r < B) v[i] = __ldcg(src + (size_t)r * ld + k);
          k += NT;
          while (k >= width) {
            k -= width;
            ++r;
          }
        }
#pragma unroll
        for (int i = 0; i < STAGE_BATCH; ++i)
          if (rr[i] < B) zs[rr[i] * ldz + col + kk[i]] = v[i];
      }
    }
  }

  // The group's rows [r0, r0 + nr) of a (B, width) block of rows, to staged
  // rows 0 .. nr - 1.
  __device__ void group(float* zs, int ldz, int col, const RowGroup& rg,
                        const float* src, size_t ld, int width) {
    rows(zs, ldz, col, rg.nr, src ? src + (size_t)rg.r0 * ld : nullptr, ld,
         width);
  }

  __device__ void wait() {
    if (threadIdx.x == 0)
      asm volatile("{\n .reg .b64 st;\n"
                   " mbarrier.arrive.shared::cta.b64 st, [%0];\n}"
                   :: "r"(smem_u32(bar)) : "memory");
    asm volatile("{\n .reg .pred done;\n"
                 "WAIT:\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
                 " @!done bra WAIT;\n}"
                 :: "r"(smem_u32(bar)), "r"(phase) : "memory");
    phase ^= 1;
    __syncthreads();
  }
};

// ----------------------------------------------------- batched row product
// For every item n of this block and every staged row rl < rg.nr (<= 32):
// acc[q] = sum_k slice_item[q * Lp + k] * zs[rl * ldz + k], q < R, on the
// tensor cores.  M is the staged rows (16-row tiles, rows >= nr read as
// 0), N the block's cnt * R slice rows (8-column tiles), K = L (8-deep
// steps, k >= L read as 0).  The warps share (tile, slice of k); the
// three products of two consecutive k steps are six independent mma, each
// from zero, added in f32 (see mma3).  Partial
// tiles meet in ``part``, then ``epi(n, s, r, rl, q, value)`` runs once
// per (item, row, gate q < R), s being the item's slot in this block, r =
// rg.r0 + rl the row; an item's R gates of a row go to R consecutive
// lanes (lstm_fwd4 gathers them).  R divides 8, so an item's R columns sit
// in one tile.
// BF (the bf16 instances): the slice holds bf16 pairs (load_cols<true> /
// load_rows<true>), the staged f32 rows are rounded to bf16 as their A
// fragments are packed, and one m16n8k16 mma runs a 16-deep step (two
// independent steps a loop), each from zero, summed in f32.
template <int R, bool BF = false, class Epi>
__device__ void rows_mma(int N, int L, const RowGroup& rg, const float* slice,
                         const float* zs, int ldz, float* part,
                         const Epi& epi, TrainClock& clk, int stage) {
  static_assert(8 % R == 0, "an item's columns must share a tile");
  const int cnt = rg.items(N), B = rg.nr;
  if (cnt == 0 || B == 0) return;  // block-uniform
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int Lp = BF ? tr_pad((L + 1) / 2) : tr_pad(L);
  const int Mt = (B + 15) >> 4, Nc = cnt * R, Nt = (Nc + 7) >> 3;
  const int tiles = Mt * Nt;
  const int splits = tiles >= NWARPS ? 1 : NWARPS / tiles;
  const int kstep = BF ? 16 : 8;
  const int per = tr_cdiv(tr_cdiv(L, kstep), splits) * kstep;
  const int round = NWARPS / splits;
  constexpr int IPT = 8 / R;  // items a tile
  for (int t0 = 0; t0 < tiles; t0 += round) {
    const int nt = min(round, tiles - t0);
    if (warp < nt * splits) {
      const int tile = t0 + warp / splits, sp = warp % splits;
      const int r0 = (tile % Mt) * 16 + g, col = (tile / Mt) * 8 + g;
      const bool v0 = r0 < B, v1 = r0 + 8 < B, vc = col < Nc;
      const float* z0 = zs + r0 * ldz;
      const float* z1 = z0 + 8 * ldz;
      const float* w = slice + (size_t)col * Lp;
      const int kb = sp * per, ke = min(L, kb + per);
      float c2[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 4; ++c) c2[h][c] = 0.f;
      if constexpr (BF) {
        // the staged value (row ok, k), 0 past the split's end
        auto zv = [&](const float* z, bool ok, int k) {
          return ok && k < ke ? z[k] : 0.f;
        };
        const uint32_t* wp = reinterpret_cast<const uint32_t*>(w);
        for (int k0 = kb; k0 < ke; k0 += 32) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int ka = k0 + 16 * h + 2 * t, kc = ka + 8;
            uint32_t af[4], bf[2];
            af[0] = bf16x2(zv(z0, v0, ka), zv(z0, v0, ka + 1));
            af[1] = bf16x2(zv(z1, v1, ka), zv(z1, v1, ka + 1));
            af[2] = bf16x2(zv(z0, v0, kc), zv(z0, v0, kc + 1));
            af[3] = bf16x2(zv(z1, v1, kc), zv(z1, v1, kc + 1));
            // a pair never straddles a split's end (kb, kb + per even);
            // past L the slice's pad half is 0
            bf[0] = vc && ka < ke ? wp[ka >> 1] : 0u;
            bf[1] = vc && kc < ke ? wp[kc >> 1] : 0u;
            float d[4];
            mma_bf16(d, af, bf);
#pragma unroll
            for (int c = 0; c < 4; ++c) c2[h][c] += d[c];
          }
        }
      } else {
        for (int k0 = kb; k0 < ke; k0 += 16) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int ka = k0 + 8 * h + t, kc = ka + 4;
            const bool ia = ka < ke, ic = kc < ke;
            uint32_t ah[4], al[4], bh[2], bl[2];
            tf32_split(v0 && ia ? z0[ka] : 0.f, ah[0], al[0]);
            tf32_split(v1 && ia ? z1[ka] : 0.f, ah[1], al[1]);
            tf32_split(v0 && ic ? z0[kc] : 0.f, ah[2], al[2]);
            tf32_split(v1 && ic ? z1[kc] : 0.f, ah[3], al[3]);
            tf32_split(vc && ia ? w[ka] : 0.f, bh[0], bl[0]);
            tf32_split(vc && ic ? w[kc] : 0.f, bh[1], bl[1]);
            // three independent products from zero (see mma3), summed
            // in f32
            float d1[4] = {0.f, 0.f, 0.f, 0.f},
                  d2[4] = {0.f, 0.f, 0.f, 0.f},
                  d3[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(d1, al, bh);
            mma_tf32(d2, ah, bl);
            mma_tf32(d3, ah, bh);
#pragma unroll
            for (int c = 0; c < 4; ++c)
              c2[h][c] += (d1[c] + d2[c]) + d3[c];
          }
        }
      }
      float acc[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] = c2[0][c] + c2[1][c];
      float* p = part + warp * 128;
      p[g * 8 + 2 * t] = acc[0];
      p[g * 8 + 2 * t + 1] = acc[1];
      p[(g + 8) * 8 + 2 * t] = acc[2];
      p[(g + 8) * 8 + 2 * t + 1] = acc[3];
    }
    __syncthreads();
    clk.part(stage, P_PRODUCT);
    for (int e = threadIdx.x; e < nt * 16 * 8; e += NT) {
      const int q = e % R, i = (e / R) % IPT, rl = (e / 8) % 16;
      const int tl = e / 128, tile = t0 + tl;
      const int r = (tile % Mt) * 16 + rl, s = (tile / Mt) * IPT + i;
      if (r < B && s < cnt) {
        float sum = 0.f;
        for (int sp = 0; sp < splits; ++sp)
          sum += part[(tl * splits + sp) * 128 + rl * 8 + i * R + q];
        epi(rg.item(s), s, rg.r0 + r, r, q, sum);
      }
    }
    __syncthreads();
    clk.part(stage, P_EPI);
  }
}

// ------------------------------------------- location term of an item
// The location term of one 16-step tile of an attention item: loc[tau][u]
// = sum_k cv[tau + k - pad] loc_w[k][u0 + u] for tau in [m0, m0 + 16) and
// the item's 32 units, a (16 x K) by (K x 32) product on the tensor cores
// (four 8-unit tiles, K padded to a multiple of 8).  cvw[i] = cv[i - pad]
// (zero outside), lw = loc_w's columns of the item (row stride sumU),
// taps k >= K and units u >= nu read as 0.  acc[j][c] is the C fragment of
// unit tile j: (tau, u) = (m0 + g + 8 (c / 2), 8 j + 2 t + c % 2).
__device__ __forceinline__ void loc_term(const float* cvw, const float* lw,
                                         int sumU, int K, int T, int nu,
                                         int m0, float (&acc)[4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
  const bool r0 = m0 + g < T, r1 = m0 + g + 8 < T;
  for (int k0 = 0; k0 < K; k0 += 8) {
    const int ka = k0 + t, kc = ka + 4;
    uint32_t ah[4], al[4];
    tf32_split(ka < K && r0 ? cvw[m0 + g + ka] : 0.f, ah[0], al[0]);
    tf32_split(ka < K && r1 ? cvw[m0 + g + 8 + ka] : 0.f, ah[1], al[1]);
    tf32_split(kc < K && r0 ? cvw[m0 + g + kc] : 0.f, ah[2], al[2]);
    tf32_split(kc < K && r1 ? cvw[m0 + g + 8 + kc] : 0.f, ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int u = 8 * j + g;
      uint32_t bh[2], bl[2];
      tf32_split(ka < K && u < nu ? lw[ka * sumU + u] : 0.f, bh[0], bl[0]);
      tf32_split(kc < K && u < nu ? lw[kc * sumU + u] : 0.f, bh[1], bl[1]);
      mma3(acc[j], ah, al, bh, bl);
    }
  }
}

// ---------------------------------------------------- 128 x 64 tile product
// C tile (m0.., n0..) = sum_{kb <= k < ke} A(m, k) B(k, n) on the tensor
// cores; ``epi(m, n, value)`` for m < M, n < N.  A_K / B_K say whether
// consecutive k are consecutive in memory: the loads run along the
// contiguous index (coalesced) and the shared tile keeps that index
// contiguous too (no bank conflicts on the stores; the fragment reads are
// conflict-free either way by the padded strides).  The next TBK-deep
// chunk is fetched into registers while the current one is multiplied.
// Eight warps of 32 x 32 each (2 x 4 mma tiles).  BF: the bf16 mode's
// product, the shared tiles' f32 values rounded to bf16 as their fragments
// are packed, one m16n8k16 mma a 16-deep step (from zero, summed in f32).
constexpr int TA_PER = TBM * TBK / NT, TB_PER = TBN * TBK / NT;

template <bool A_K, bool B_K, class AL, class BL>
__device__ __forceinline__ void tile_fetch(int M, int N, int ke, int m0,
                                           int n0, int k0, const AL& al,
                                           const BL& bl,
                                           float (&ra)[TA_PER],
                                           float (&rb)[TB_PER]) {
#pragma unroll
  for (int i = 0; i < TA_PER; ++i) {
    const int e = threadIdx.x + i * NT;
    const int am = A_K ? e / TBK : e % TBM, ak = A_K ? e % TBK : e / TBM;
    ra[i] = (m0 + am < M && k0 + ak < ke) ? al(m0 + am, k0 + ak) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < TB_PER; ++i) {
    const int e = threadIdx.x + i * NT;
    const int bn = B_K ? e / TBK : e % TBN, bk = B_K ? e % TBK : e / TBN;
    rb[i] = (n0 + bn < N && k0 + bk < ke) ? bl(k0 + bk, n0 + bn) : 0.f;
  }
}

template <bool A_K, bool B_K, bool BF = false, class AL, class BL, class Epi>
__device__ void mma_tile(int M, int N, int kb, int ke, int m0, int n0,
                         const AL& al, const BL& bl, const Epi& epi,
                         float* sm) {
  float* As = sm;
  float* Bs = sm + TBM * TA_MK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 32;
  auto A = [&](int m, int k) {
    return A_K ? As[m * TA_MK + k] : As[k * TA_KM + m];
  };
  auto Bv = [&](int k, int n) {
    return B_K ? Bs[n * TB_NK + k] : Bs[k * TB_KN + n];
  };
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
  float ra[TA_PER], rb[TB_PER];
  tile_fetch<A_K, B_K>(M, N, ke, m0, n0, kb, al, bl, ra, rb);
  for (int k0 = kb; k0 < ke; k0 += TBK) {
    __syncthreads();  // every read of the previous chunk is done
#pragma unroll
    for (int i = 0; i < TA_PER; ++i) {
      const int e = tid + i * NT;
      if (A_K) As[(e / TBK) * TA_MK + e % TBK] = ra[i];
      else As[(e / TBM) * TA_KM + e % TBM] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < TB_PER; ++i) {
      const int e = tid + i * NT;
      if (B_K) Bs[(e / TBK) * TB_NK + e % TBK] = rb[i];
      else Bs[(e / TBN) * TB_KN + e % TBN] = rb[i];
    }
    __syncthreads();
    if (k0 + TBK < ke)
      tile_fetch<A_K, B_K>(M, N, ke, m0, n0, k0 + TBK, al, bl, ra, rb);
    if constexpr (BF) {
#pragma unroll
      for (int kk = 0; kk < TBK; kk += 16) {
        uint32_t af[2][4], bf[4][2];
        const int ka = kk + 2 * t, kc = ka + 8;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int m = wm + i * 16 + g;
          af[i][0] = bf16x2(A(m, ka), A(m, ka + 1));
          af[i][1] = bf16x2(A(m + 8, ka), A(m + 8, ka + 1));
          af[i][2] = bf16x2(A(m, kc), A(m, kc + 1));
          af[i][3] = bf16x2(A(m + 8, kc), A(m + 8, kc + 1));
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = wn + j * 8 + g;
          bf[j][0] = bf16x2(Bv(ka, n), Bv(ka + 1, n));
          bf[j][1] = bf16x2(Bv(kc, n), Bv(kc + 1, n));
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float d[4];
            mma_bf16(d, af[i], bf[j]);
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[i][j][c] += d[c];
          }
      }
      continue;
    }
#pragma unroll
    for (int kk = 0; kk < TBK; kk += 8) {
      uint32_t ah[2][4], alo[2][4], bh[4][2], blo[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = wm + i * 16 + g;
        tf32_split(A(m, kk + t), ah[i][0], alo[i][0]);
        tf32_split(A(m + 8, kk + t), ah[i][1], alo[i][1]);
        tf32_split(A(m, kk + t + 4), ah[i][2], alo[i][2]);
        tf32_split(A(m + 8, kk + t + 4), ah[i][3], alo[i][3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn + j * 8 + g;
        tf32_split(Bv(kk + t, n), bh[j][0], blo[j][0]);
        tf32_split(Bv(kk + t + 4, n), bh[j][1], blo[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma3(acc[i][j], ah[i], alo[i], bh[j], blo[j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int m = m0 + wm + i * 16 + g + (c >> 1) * 8;
        const int n = n0 + wn + j * 8 + 2 * t + (c & 1);
        if (m < M && n < N) epi(m, n, acc[i][j][c]);
      }
  __syncthreads();
}

__host__ __device__ inline int tr_tiles(int M, int N) {
  return tr_cdiv(M, TBM) * tr_cdiv(N, TBN);
}

// Left operand of a weight gradient: row `row` of the concatenation of up
// to three (S*B, width) segments, segment i read at row + shift[i] (-B for
// the previous step; rows before 0 read 0), then a column of ones (the
// bias) at col == width.
struct SegLoad {
  int n, width;
  int kb[4];
  const float* base[3];
  size_t ld[3];
  int shift[3];
  __device__ float operator()(int row, int col) const {
    if (col >= width) return 1.f;
    int i = 0;
    while (i + 1 < n && col >= kb[i + 1]) ++i;
    const int r = row + shift[i];
    if (r < 0) return 0.f;
    return __ldcg(base[i] + (size_t)r * ld[i] + (col - kb[i]));
  }
};

// Ask L2 for rows of a later step ([rows, width) at p, leading dimension
// ld): a 32-float line a thread over the whole grid, no wait.
__device__ inline void l2_prefetch(const float* p, size_t ld, int rows,
                                   int width) {
  const int lpr = tr_cdiv(width, 32);
  for (int e = blockIdx.x * NT + threadIdx.x; e < rows * lpr;
       e += gridDim.x * NT)
    asm volatile("prefetch.global.L2 [%0];"
                 :: "l"(p + (size_t)(e / lpr) * ld + (e % lpr) * 32));
}

// A block's next item of a phase whose items are handed out in order by a
// counter (scratch word, zeroed by the launcher): blocks that finish early
// take more.  Every thread of the block gets the same item.
__device__ inline int next_item(unsigned* counter, int* slot) {
  __syncthreads();
  if (threadIdx.x == 0) *slot = (int)atomicAdd(counter, 1u);
  __syncthreads();
  return *slot;
}

// ---------------------------------------------------------- zoneout LSTM
__device__ __forceinline__ float zone(float nw, float prev, float z,
                                      float keep, bool det) {
  if (z <= 0.f) return nw;
  if (det) return (1.f - z) * nw + z * prev;
  return keep * nw + (1.f - keep) * prev;
}

// VJP of one step: d_gates, d_c_prev, d_h_prev (zoneout pass-through only)
__device__ __forceinline__ void lstm_train_bwd(const float* g, float c_prev,
                                               float d_h, float d_c,
                                               float zc, float zo,
                                               float keep_c, float keep_h,
                                               bool det, float* d_g,
                                               float& d_c_prev,
                                               float& d_h_prev) {
  const float si = sigmoid(g[0]), tg = tanhf(g[1]);
  const float sf = sigmoid(g[2] + 1.f), so = sigmoid(g[3]);
  const float tc = tanhf(c_prev * sf + si * tg);
  float dhr;
  if (zo <= 0.f) {
    dhr = d_h; d_h_prev = 0.f;
  } else if (det) {
    dhr = d_h * (1.f - zo); d_h_prev = d_h * zo;
  } else {
    dhr = d_h * keep_h; d_h_prev = d_h * (1.f - keep_h);
  }
  const float d_o = dhr * tc * so * (1.f - so);
  const float dcfh = dhr * so * (1.f - tc * tc);
  float dcr, dcp;
  if (zc <= 0.f) {
    dcr = d_c + dcfh; dcp = 0.f;
  } else if (det) {
    dcr = d_c * (1.f - zc) + dcfh; dcp = d_c * zc;
  } else {
    dcr = d_c * keep_c + dcfh; dcp = d_c * (1.f - keep_c);
  }
  d_c_prev = dcp + dcr * sf;
  d_g[0] = dcr * tg * si * (1.f - si);
  d_g[1] = dcr * si * (1.f - tg * tg);
  d_g[2] = dcr * c_prev * sf * (1.f - sf);
  d_g[3] = d_o;
}

// The zoneout LSTM step of one (unit, row) on the 4 consecutive lanes that
// hold its gates (i, g, f, o without the +1 forget bias; lane q: gate q, as
// rows_mma<4> hands them out): each lane applies its gate's activation,
// lanes 1 and 2 bring the zoneout masks (keep_q), and every lane gets c
// and h.
__device__ __forceinline__ void lstm_fwd4(float gq, int q, float c_prev,
                                          float h_prev, float zc, float zo,
                                          float keep_q, bool det, float& c,
                                          float& h) {
  const int base = threadIdx.x & 28;  // lane of gate 0
  const unsigned gm = 0xfu << base;
  const float act = q == 1 ? tanhf(gq) : sigmoid(q == 2 ? gq + 1.f : gq);
  const float si = __shfl_sync(gm, act, base);
  const float tg = __shfl_sync(gm, act, base + 1);
  const float sf = __shfl_sync(gm, act, base + 2);
  const float so = __shfl_sync(gm, act, base + 3);
  const float keep_c = __shfl_sync(gm, keep_q, base + 1);
  const float keep_h = __shfl_sync(gm, keep_q, base + 2);
  const float c_raw = c_prev * sf + si * tg;
  const float h_raw = tanhf(c_raw) * so;
  c = zone(c_raw, c_prev, zc, keep_c, det);
  h = zone(h_raw, h_prev, zo, keep_h, det);
}

// zoneout keep mask of (step, id, row, unit), 1 where off or deterministic
__device__ __forceinline__ float zkeep(const TrainArgs& a, int t, int id,
                                       int r, int n, float z) {
  if (a.deterministic || z <= 0.f) return 1.f;
  return mask_keep(a.seed, t, id, r, n, z);
}

// -------------------------------------------------------------- launching
// TR_SYNC_WORDS 32-bit words follow each kernel's scratch: the grid
// barrier's counter (GridBarrier, common.cuh) in the first 128-byte line,
// the work counters of next_item in the second.  The launcher zeroes them
// before every launch.  The launch stays cooperative for its co-residency
// guarantee (every block resident, or the launch fails).
constexpr int TR_SYNC_WORDS = 2 * GRID_BAR_WORDS;

template <class Kernel>
inline int tr_launch(Kernel kernel, const TrainArgs& args, size_t smem_floats,
                     size_t sync_off, int sms, void* stream) {
  TrainArgs a = args;
  int dev = 0, optin = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&optin,
                                  cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                  dev)) != cudaSuccess)
    return (int)e;
  const size_t smem = smem_floats * sizeof(float);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  if ((e = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                          smem)) !=
      cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  if ((e = cudaMemsetAsync(a.scratch + sync_off, 0,
                           TR_SYNC_WORDS * sizeof(unsigned),
                           (cudaStream_t)stream)) != cudaSuccess)
    return (int)e;
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel((void*)kernel, dim3(sms), dim3(NT), params,
                                  smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

inline int tr_sms(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                     dev);
}
