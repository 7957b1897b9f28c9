// Pieces shared by the two training kernels (fused_train_fwd.cu,
// fused_train_bwd.cu): the argument struct, the shared-memory plan, the
// batched row product over resident weight slices, a 64 x 64 tile product
// with loader functors, and the zoneout LSTM step and its VJP.
#pragma once

#include <cstddef>

#include "common.cuh"
#include "masks.cuh"

constexpr int TR_MAX_SOURCES = 4, TR_MAX_PRENET = 4, TR_MAX_B = 64;

struct TrainArgs {  // mirrored by _TrainArgs in ops/fused_train.py
  int B, S, T, cf, ns, n_pre, A, D, K, use_spk, deterministic, save_w,
      stash_w;
  unsigned int seed;
  int kinds[TR_MAX_SOURCES], cumulative[TR_MAX_SOURCES];
  int u_off[TR_MAX_SOURCES + 1], c_off[TR_MAX_SOURCES + 1];
  int p_sizes[TR_MAX_PRENET], p_dropout[TR_MAX_PRENET];
  int off_p[TR_MAX_PRENET], off_pd[TR_MAX_PRENET];
  int off_gatt, off_catt, off_hatt, off_pq, off_ctx, off_proj, off_g1,
      off_c1, off_h1, off_o1, off_g2, off_c2, off_h2;
  int off_dgatt, off_dg1, off_dg2, off_dproj, off_dpq;  // stash fields
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
  long long* stage_cycles;  // optional per-stage SM cycles (StageClock)
};

// stages of the optional profile (FWD_STAGES / BWD_STAGES in
// ops/fused_train.py)
enum { F_PRENET, F_ATT_LSTM, F_QUERY, F_ATTENTION, F_PROJ, F_LSTM1,
       F_LSTM2 };
enum { B_SETUP, B_LSTM2, B_DZ2_LSTM1, B_DZ1, B_DZOP, B_ATTENTION,
       B_DQ_ATT_LSTM, B_DZATT, B_DW, B_PRENET };

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
__host__ __device__ inline int tr_odd(int n) { return n | 1; }
__host__ __device__ inline int tr_max(int a, int b) { return a > b ? a : b; }

// this block's share of N items (item n belongs to block n % nb)
__host__ __device__ inline int tr_items(int N, int nb) {
  return (N + nb - 1) / nb;
}

// ------------------------------------------------- shared-memory plan
// (floats; ops/fused_train.py smem_bytes mirrors it for the gate)
constexpr int ROW_PART = NWARPS * 4 * TR_MAX_B;  // rows_stage partials
constexpr int GT = 64, GK = 32;                  // tile product
constexpr int GEMM_SMEM = 2 * GK * (GT + 4);

struct FwdSmem {
  size_t att, q, op, l1, l2, att_b, op_b, l1_b, l2_b, v, loc, part, red, zs,
      total;
  int ldz;
};

__host__ __device__ inline FwdSmem fwd_smem(const TrainArgs& a, int nb) {
  const int A = a.A, D = a.D, sumU = tr_sumU(a), sumC = tr_sumC(a);
  FwdSmem m;
  size_t o = 0;
  m.att = o; o += (size_t)tr_items(A, nb) * 4 * tr_zatt(a);
  m.q = o; o += (size_t)tr_items(sumU, nb) * A;
  m.op = o; o += (size_t)tr_items(D, nb) * (A + sumC);
  m.l1 = o; o += (size_t)tr_items(D, nb) * 4 * 2 * D;
  m.l2 = o; o += (size_t)tr_items(D, nb) * 4 * 2 * D;
  m.att_b = o; o += (size_t)tr_items(A, nb) * 4;
  m.op_b = o; o += tr_items(D, nb);
  m.l1_b = o; o += (size_t)tr_items(D, nb) * 4;
  m.l2_b = o; o += (size_t)tr_items(D, nb) * 4;
  m.v = o; o += sumU;
  m.loc = o; o += (size_t)a.K * sumU;
  m.part = o; o += ROW_PART;
  m.red = o; o += 32;
  m.ldz = tr_odd(tr_max(tr_max(tr_zatt(a), A + sumC), 2 * D));
  // the staged rows of a product stage; the prologue's tiles and the
  // attention stage's rows (energies, recursion, conv input: T each, the
  // query projection: U) reuse the space
  int umax = 0;
  for (int i = 0; i < a.ns; ++i)
    umax = tr_max(umax, a.u_off[i + 1] - a.u_off[i]);
  size_t zs = (size_t)a.B * m.ldz;
  if (zs < (size_t)GEMM_SMEM) zs = GEMM_SMEM;
  if (zs < (size_t)3 * a.T + umax) zs = 3 * a.T + umax;
  m.zs = o; o += zs;
  m.total = o;
  return m;
}

struct BwdSmem {
  size_t w2, w1, wop, wq, watt, v, loc, part, red, zs, total;
  int ldz;
};

__host__ __device__ inline BwdSmem bwd_smem(const TrainArgs& a, int nb) {
  const int A = a.A, D = a.D, sumU = tr_sumU(a), sumC = tr_sumC(a);
  BwdSmem m;
  size_t o = 0;
  m.w2 = o; o += (size_t)tr_items(2 * D, nb) * 4 * D;
  m.w1 = o; o += (size_t)tr_items(2 * D, nb) * 4 * D;
  m.wop = o; o += (size_t)tr_items(A + sumC, nb) * D;
  m.wq = o; o += (size_t)tr_items(A, nb) * sumU;
  m.watt = o; o += (size_t)tr_items(sumC + A, nb) * 4 * A;
  m.v = o; o += sumU;
  m.loc = o; o += (size_t)a.K * sumU;
  m.part = o; o += ROW_PART;
  m.red = o; o += 32;
  m.ldz = tr_odd(tr_max(tr_max(4 * D, 4 * A), tr_max(D, sumU)));
  int cmax = 0, umax = 0;
  for (int i = 0; i < a.ns; ++i) {
    cmax = tr_max(cmax, a.c_off[i + 1] - a.c_off[i]);
    umax = tr_max(umax, a.u_off[i + 1] - a.u_off[i]);
  }
  // attention VJP rows: d_ctx, then a, w, conv input, previous alpha,
  // d_a, d_e, d_s (T each), d_win (T x K) and d_pre (T x U)
  size_t zs = (size_t)a.B * m.ldz;
  const size_t att = (size_t)cmax + 7 * (size_t)a.T + (size_t)a.T * a.K +
                     (size_t)a.T * umax;
  if (zs < att) zs = att;
  if (zs < (size_t)GEMM_SMEM) zs = GEMM_SMEM;
  m.zs = o; o += zs;
  m.total = o;
  return m;
}

// ------------------------------------------------- resident weight slices
// Block b holds items n = b + nb * s.  Item n of an (in, out) matrix with
// R gate groups of N columns is the R columns r * N + n, stored as R rows
// of length L (transposed): dst[(s * R + r) * L + k] = W[k * R * N + r * N + n].
__device__ inline void load_cols(float* dst, const float* __restrict__ W,
                                 int N, int R, int L) {
  const int b = blockIdx.x, nb = gridDim.x;
  const int cnt = N > b ? (N - b + nb - 1) / nb : 0;
  for (int e = threadIdx.x; e < cnt * R * L; e += NT) {
    const int k = e % L, sr = e / L, r = sr % R, s = sr / R;
    dst[e] = __ldg(W + (size_t)k * R * N + r * N + b + nb * s);
  }
}

// Item n of a row-major (N, L) matrix is its row n (rows_stage with R = 1).
__device__ inline void load_rows(float* dst, const float* __restrict__ W,
                                 int N, int L) {
  const int b = blockIdx.x, nb = gridDim.x;
  const int cnt = N > b ? (N - b + nb - 1) / nb : 0;
  for (int e = threadIdx.x; e < cnt * L; e += NT) {
    const int k = e % L, s = e / L;
    dst[e] = __ldg(W + (size_t)(b + nb * s) * L + k);
  }
}

// Copy a (B, width) block of rows (leading dimension ld, written by other
// blocks: read through L2) to columns [col, col + width) of the staged
// rows; src == nullptr stages zeros.  The copy is bound by L2 latency, so
// each thread keeps STAGE_BATCH loads in flight, of float4 where the rows
// are 16-byte aligned.
constexpr int STAGE_BATCH = 8;

__device__ __forceinline__ void put(float* d, float x) { d[0] = x; }
__device__ __forceinline__ void put(float* d, float4 x) {
  d[0] = x.x;
  d[1] = x.y;
  d[2] = x.z;
  d[3] = x.w;
}

template <class V>
__device__ __forceinline__ void stage_rows_as(float* zs, int ldz, int col,
                                              int B, const float* src,
                                              size_t ld, int width) {
  constexpr int L = sizeof(V) / sizeof(float);
  const int wv = width / L;
  int r = threadIdx.x / wv, k = threadIdx.x % wv;
  while (r < B) {
    V v[STAGE_BATCH];
    int rr[STAGE_BATCH], kk[STAGE_BATCH];
#pragma unroll
    for (int i = 0; i < STAGE_BATCH; ++i) {
      rr[i] = r;
      kk[i] = k;
      if (r < B)
        v[i] = __ldcg(reinterpret_cast<const V*>(src + (size_t)r * ld) + k);
      k += NT;
      while (k >= wv) {
        k -= wv;
        ++r;
      }
    }
#pragma unroll
    for (int i = 0; i < STAGE_BATCH; ++i)
      if (rr[i] < B) put(zs + rr[i] * ldz + col + kk[i] * L, v[i]);
  }
}

__device__ inline void stage_rows(float* zs, int ldz, int col, int B,
                                  const float* src, size_t ld, int width) {
  if (src == nullptr) {
    for (int r = 0; r < B; ++r)
      for (int k = threadIdx.x; k < width; k += NT) zs[r * ldz + col + k] = 0.f;
  } else if (width % 4 == 0 && ld % 4 == 0 &&
             reinterpret_cast<size_t>(src) % 16 == 0) {
    stage_rows_as<float4>(zs, ldz, col, B, src, ld, width);
  } else {
    stage_rows_as<float>(zs, ldz, col, B, src, ld, width);
  }
}

// ----------------------------------------------------- batched row product
// For every item n of this block and every row r < B (<= 64):
// acc[q] = sum_k slice_item[q * L + k] * zs[r * ldz + k], q < R.  Lanes run
// over rows (row lane and lane + 32), the block's warps over (item, slice
// of k); partial sums meet in ``part``, then ``epi(n, s, r, acc)`` runs
// once per (item, row), s being the item's slot in this block.
template <int R, class Epi>
__device__ void rows_stage(int N, int L, int B, const float* slice,
                           const float* zs, int ldz, float* part,
                           const Epi& epi) {
  const int b = blockIdx.x, nb = gridDim.x;
  const int cnt = N > b ? (N - b + nb - 1) / nb : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int s0 = 0; s0 < cnt; s0 += NWARPS) {
    const int items = min(NWARPS, cnt - s0);
    const int splits = NWARPS / items;
    if (warp < items * splits) {
      const int s = s0 + warp / splits, sp = warp % splits;
      const int kper = (L + splits - 1) / splits;
      const int k0 = sp * kper, k1 = min(L, k0 + kper);
      const float* w = slice + (size_t)s * R * L;
      const bool r0 = lane < B, r1 = lane + 32 < B;
      const float* z0 = zs + lane * ldz;
      const float* z1 = zs + (lane + 32) * ldz;
      float acc0[R], acc1[R];
#pragma unroll
      for (int q = 0; q < R; ++q) acc0[q] = acc1[q] = 0.f;
      for (int k = k0; k < k1; ++k) {
        const float x0 = r0 ? z0[k] : 0.f;
        const float x1 = r1 ? z1[k] : 0.f;
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const float wq = w[q * L + k];
          acc0[q] = fmaf(wq, x0, acc0[q]);
          acc1[q] = fmaf(wq, x1, acc1[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        part[(warp * R + q) * TR_MAX_B + lane] = acc0[q];
        part[(warp * R + q) * TR_MAX_B + lane + 32] = acc1[q];
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < items * B; e += NT) {
      const int i = e / B, r = e % B;
      float sum[R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        sum[q] = 0.f;
        for (int p = 0; p < splits; ++p)
          sum[q] += part[(((i * splits) + p) * R + q) * TR_MAX_B + r];
      }
      epi(b + nb * (s0 + i), s0 + i, r, sum);
    }
    __syncthreads();
  }
}

// ------------------------------------------------------- 64 x 64 tile product
// C tile (m0.., n0..) = sum_k A(m, k) B(k, n) for k < Kd; each thread owns
// a 4 x 4 block; ``epi(m, n, value)`` for m < M, n < N.  A_K / B_K say
// whether consecutive k are consecutive in memory (so the loads coalesce).
// The next GK-deep chunk is fetched into registers while the current one
// is multiplied.
constexpr int GEMM_PER = GT * GK / NT;  // operand elements a thread loads

// Chunk k0 of both operands into registers.
template <bool A_K, bool B_K, class AL, class BL>
__device__ __forceinline__ void gemm_fetch(int M, int N, int Kd, int m0,
                                           int n0, int k0, const AL& al,
                                           const BL& bl,
                                           float (&ra)[GEMM_PER],
                                           float (&rb)[GEMM_PER]) {
#pragma unroll
  for (int i = 0; i < GEMM_PER; ++i) {
    const int e = threadIdx.x + i * NT;
    const int am = A_K ? e / GK : e % GT, ak = A_K ? e % GK : e / GT;
    ra[i] = (m0 + am < M && k0 + ak < Kd) ? al(m0 + am, k0 + ak) : 0.f;
    const int bn = B_K ? e / GK : e % GT, bk = B_K ? e % GK : e / GT;
    rb[i] = (n0 + bn < N && k0 + bk < Kd) ? bl(k0 + bk, n0 + bn) : 0.f;
  }
}

template <bool A_K, bool B_K, class AL, class BL, class Epi>
__device__ void gemm_tile(int M, int N, int Kd, int m0, int n0, const AL& al,
                          const BL& bl, const Epi& epi, float* sm) {
  float(*as)[GT + 4] = reinterpret_cast<float(*)[GT + 4]>(sm);
  float(*bs)[GT + 4] = reinterpret_cast<float(*)[GT + 4]>(sm + GK * (GT + 4));
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float acc[4][4], ra[GEMM_PER], rb[GEMM_PER];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  gemm_fetch<A_K, B_K>(M, N, Kd, m0, n0, 0, al, bl, ra, rb);
  for (int k0 = 0; k0 < Kd; k0 += GK) {
    __syncthreads();  // every read of the previous chunk is done
#pragma unroll
    for (int i = 0; i < GEMM_PER; ++i) {
      const int e = tid + i * NT;
      as[A_K ? e % GK : e / GT][A_K ? e / GK : e % GT] = ra[i];
      bs[B_K ? e % GK : e / GT][B_K ? e / GK : e % GT] = rb[i];
    }
    __syncthreads();
    if (k0 + GK < Kd)
      gemm_fetch<A_K, B_K>(M, N, Kd, m0, n0, k0 + GK, al, bl, ra, rb);
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
      if (m < M && n < N) epi(m, n, acc[i][j]);
    }
  __syncthreads();
}

__host__ __device__ inline int tr_tiles(int M, int N) {
  return ((M + GT - 1) / GT) * ((N + GT - 1) / GT);
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

// ---------------------------------------------------------- zoneout LSTM
__device__ __forceinline__ float zone(float nw, float prev, float z,
                                      float keep, bool det) {
  if (z <= 0.f) return nw;
  if (det) return (1.f - z) * nw + z * prev;
  return keep * nw + (1.f - keep) * prev;
}

// gates (i, g, f, o) without the +1 forget bias
__device__ __forceinline__ void lstm_train_fwd(const float* g, float c_prev,
                                               float h_prev, float zc,
                                               float zo, float keep_c,
                                               float keep_h, bool det,
                                               float& c, float& h) {
  const float c_raw = c_prev * sigmoid(g[2] + 1.f) + sigmoid(g[0]) * tanhf(g[1]);
  const float h_raw = tanhf(c_raw) * sigmoid(g[3]);
  c = zone(c_raw, c_prev, zc, keep_c, det);
  h = zone(h_raw, h_prev, zo, keep_h, det);
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

// zoneout keep mask of (step, id, row, unit), 1 where off or deterministic
__device__ __forceinline__ float zkeep(const TrainArgs& a, int t, int id,
                                       int r, int n, float z) {
  if (a.deterministic || z <= 0.f) return 1.f;
  return mask_keep(a.seed, t, id, r, n, z);
}

// -------------------------------------------------------------- launching
template <class Kernel>
inline int tr_launch(Kernel kernel, const TrainArgs& args, size_t smem_floats,
                     int sms, void* stream) {
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
