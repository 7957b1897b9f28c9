// The whole autoregressive decode loop in one cooperative kernel.
//
// Replaces: self_attention_tacotron_tpu/ops/fused_decode.py `_kernel`
// (Pallas, reached through `fused_decode`) in all its modes: B = 1 and
// batched rows (each source with its own memory length), source attention
// kinds additive (0), location-sensitive (1) and forward (2), and the
// MultiSpeakerPreNet speaker row.
//
// What bounds it on the H100: each step is a chain of ~11 dependent
// matrix-vector products and reductions over ~3.0 M merged f32 weights
// (12 MB at the codes recipe: attention LSTM 672 x 1024, merged
// projection+lstm1 800 x 1280, lstm2 512 x 1024, hop 256 x 768 and
// 256 x 256, head 256 x 1282, ...), ~6 MFLOP a step and row.  Streamed
// from device memory every step, the weights alone would take ~3.6 us a
// step (1.6 ms for 450 steps); the FLOPs are ~0.1 us a row.  Held on chip,
// what is left is the serial chain: the stage latencies and the grid
// barriers between them, which a batch shares.
//
// Design: one block per SM (132 blocks), launched cooperatively.  Every
// product stage gives one output column (or one LSTM unit: its four gate
// rows, plus the projection row of the merged lstm1 stage) to one warp,
// and column n belongs to block n % 132 for the whole call, so each block
// copies its rows of every weight matrix into shared memory once (~92 KB
// a block at the codes recipe) and never reads them from device memory
// again -- the Hopper counterpart of the TPU kernel's VMEM-resident
// weights.  A warp applies its resident rows to all B input rows of the
// stage (up to 8 at a time, each lane ending with one row's sums), which
// is why a batch costs little more than one row.  The per-step state
// vectors (a few K floats a row) go through global memory, which stays in
// L2; a grid barrier separates the dependent stages: the hand-written
// GridBarrier of common.cuh (one arrival counter, 1.11 us against
// cooperative groups' 1.28 us on an H100).  The TPU kernel's
// flattened (B*T) rows, block-indicator matmuls and (S, B*D) concatenated
// caches are a layout for its lanes and are not carried over: rows are
// indexed directly here.  Source attention: energies one block per (row,
// source, memory step), threads over the attention units, while the items
// fit the grid (B = 1), else one warp per item; then every block
// computes every (row, source) masked softmax (shifted by the row max, NOT
// the static bound sum |v| of the JAX kernel, over that source's own
// memory length), the forward recursion and the conv-input state
// redundantly in its own shared memory (T floats a row and source), which
// removes a barrier and keeps each block's state local (one warp per
// (row, source), shuffles only); the context is one warp per (row,
// column).  Each block also keeps its items' bias entries and its LSTM
// units' cell states (per row) in shared memory.  Hops: one block per
// (row, head, chunk of 32 cached steps) computes the chunk's scores, max,
// sum of exps and unnormalized context, and the next stage combines the
// chunks while staging its input (split-K attention), so no block walks a
// whole cache.  The loop exits once every row's stop logit has been > 0
// past min_iters; steps after the exit read 0.  At B = 1, when the
// alignment row is no wider than the context (alpha_ctx), the wrapper
// folds the values into the weights of the two products that read the
// context (ctx @ W = alpha @ (V @ W)), so they read the alignment row that
// every block already holds and the context stage and its barrier go:
// 10 barriers a step at the codes recipe instead of 11.  Plain FP32 FMA
// throughout.
//
// The bf16 storage mode (the JAX kernel's compute_dtype=bf16) is the
// instance W = __nv_bfloat16 of the same template (W = float is the f32
// mode): the weight slices sit in shared memory as bf16 (half the bytes,
// so the batch capacity grows), keys and values are read as bf16, and
// every product rounds its input row to bf16 as it reads it (xround) and
// sums the exact bf16 x bf16 products in f32, which is the JAX kernel's
// _mm up to summation order.  The query projection and the location taps
// round their inputs only where the JAX kernel's B = 1 row path does not
// run (a.round_att).  Softmax, state, caches and outputs stay f32, and the
// wrapper never folds the values into the weights in this mode.
#include <cstddef>

#include "common.cuh"

constexpr int MAX_SOURCES = 4, MAX_PRENET = 4, MAX_HOPS = 4;
// scratch of the split products (gemv_rows): NWARPS warps x R rows x BB
// input rows
constexpr int GEMV_R = 5, GEMV_BB = 8;
constexpr int GEMV_PART = NWARPS * GEMV_R * GEMV_BB;

struct DecArgs {  // mirrored by _DecArgs in ops/fused_decode.py
  int B, S, ns, cr, P0, A, D, n_pre, n_hops, n_heads, K_loc, early_stop,
      min_iters, use_spk;
  // B = 1 only: the products read the alignment row (sumT) in place of the
  // context (c_off == t_off), the values folded into att_w and big_w
  int alpha_ctx;
  // bf16 storage: the matrices, keys and values below are __nv_bfloat16;
  // round_att: the query projection and location taps round their inputs
  int bf16, round_att;
  int kinds[MAX_SOURCES];
  int cumulative[MAX_SOURCES];
  int u_off[MAX_SOURCES + 1];
  int c_off[MAX_SOURCES + 1];
  int t_off[MAX_SOURCES + 1];       // memory steps, summed over sources
  long long k_off[MAX_SOURCES + 1];  // source i's keys (B, T_i, U_i) here
  long long v_off[MAX_SOURCES + 1];  // source i's values (B, T_i, C_i)
  float zc_att, zo_att, zc_dec, zo_dec;
  // float, or __nv_bfloat16 in the bf16 mode: keys, values and matrices
  const void* keys;     // attention and conv biases folded
  const void* values;
  const float* mask;    // (B, sumT)
  const float* loc_w;   // (K, sumU)
  const float* v;       // (sumU)
  const float* p0_init; // (P0)
  const float* spk;     // (B, P0) speaker row, or null
  const void* pre_w[MAX_PRENET];  // layers 1..n_pre-1: (out, in)
  const float* pre_b[MAX_PRENET];
  int pre_in[MAX_PRENET];
  int pre_out[MAX_PRENET];
  const void* att_w;  // (4A, P + Cctx + A)
  const float* att_b;
  const void* q_w;    // (sumU, A)
  const void* big_w;  // (5D, A + Cctx + D)
  const float* big_b;
  const void* l2_w;   // (4D, 2D)
  const float* l2_b;
  const void* kvq_w[MAX_HOPS];  // (3D, D)
  const float* kvq_b[MAX_HOPS];
  const void* ot_w[MAX_HOPS];   // (D, D)
  const float* ot_b[MAX_HOPS];
  const void* head_w;  // (cr + 1 + P0, D)
  const float* head_b;
  float* out;     // (B, S, cr + 1): logits and the stop logit
  float* aligns;  // (S, sumT) for B == 1, else null
  float* scratch;
  long long* stage_cycles;  // optional (DEC_STAGES), see StageClock
};

// stages of one step, in order (the StageClock slots)
enum DecStage { ST_PRENET, ST_ATT_LSTM, ST_QUERY, ST_ENERGY, ST_SOFTMAX_CTX,
                ST_PROJ_LSTM1, ST_LSTM2, ST_HOP_KVQ, ST_HOP_ATTN, ST_HOP_OUT,
                ST_HEAD, ST_SETUP, DEC_STAGES };

__host__ __device__ inline int dec_plast(const DecArgs& a) {
  return a.n_pre > 1 ? a.pre_out[a.n_pre - 2] : a.P0;
}

// ---- global scratch (per-row state vectors, energies, KV caches)
constexpr int CHUNK = 32;  // cached steps per hop-attention block

__host__ __device__ inline int dec_max_chunks(const DecArgs& a) {
  return (a.S + CHUNK - 1) / CHUNK;
}

struct DecLayout {
  size_t h_att, h1, o1, h2, y, pbuf, p0, ctx, pq, e, q, pm, ps, pc, kc, vc,
      total;
  int maxp;
};

__host__ __device__ inline DecLayout dec_layout(const DecArgs& a) {
  const int sumU = a.u_off[a.ns], Cctx = a.c_off[a.ns], sumT = a.t_off[a.ns];
  const size_t B = a.B;
  DecLayout l;
  l.maxp = a.P0;
  for (int i = 0; i + 1 < a.n_pre; ++i)
    if (a.pre_out[i] > l.maxp) l.maxp = a.pre_out[i];
  size_t o = 0;
  l.h_att = o; o += 2 * B * a.A;   // [parity][row][unit]
  l.h1 = o; o += 2 * B * a.D;
  l.o1 = o; o += B * a.D;
  l.h2 = o; o += 2 * B * a.D;
  l.y = o; o += B * a.D;
  l.pbuf = o; o += 2 * B * l.maxp;  // [parity][row][unit]
  l.p0 = o; o += B * a.P0;
  l.ctx = o; o += B * Cctx;
  l.pq = o; o += B * sumU;
  l.e = o; o += B * sumT;
  l.q = o; o += B * a.D;
  // per (row, head, chunk): running max, sum of exps; per (row, chunk):
  // the unnormalized context of every head
  const size_t hc = B * a.n_heads * dec_max_chunks(a);
  l.pm = o; o += hc;
  l.ps = o; o += hc;
  l.pc = o; o += B * dec_max_chunks(a) * a.D;
  l.kc = o; o += (size_t)a.n_hops * B * a.S * a.D;  // [hop][row][step][D]
  l.vc = o; o += (size_t)a.n_hops * B * a.S * a.D;
  l.total = o;  // the grid barrier's words follow (GRID_BAR_WORDS)
  return l;
}

// the widest stage input of one row (the row stride of xin)
__host__ __device__ inline int dec_xw(const DecArgs& a) {
  const int Cctx = a.c_off[a.ns], P = dec_plast(a), D = a.D, A = a.A;
  int xw = P + Cctx + A;
  if (A + Cctx + D > xw) xw = A + Cctx + D;
  if (2 * D > xw) xw = 2 * D;
  for (int i = 0; i + 1 < a.n_pre; ++i)
    if (a.pre_in[i] > xw) xw = a.pre_in[i];
  return xw;
}

// floats that n weights take (two bf16 weights a float in the bf16 mode)
__host__ __device__ inline size_t dec_wf(const DecArgs& a, size_t n) {
  return a.bf16 ? (n + 1) / 2 : n;
}

// ---- shared memory of one block (offsets in floats) for a grid of nb;
// mirrored by smem_floats in ops/fused_decode.py
struct DecSmem {
  size_t pre[MAX_PRENET], att, q, big, l2, kvq[MAX_HOPS], ot[MAX_HOPS], head,
      pre_b[MAX_PRENET], att_b, big_b, l2_b, kvq_b[MAX_HOPS], ot_b[MAX_HOPS],
      head_b, c_att, c1, c2, y, v, loc, mask, conv, alpha, erow, xin, pq, sc,
      cstat,
      part, gpart, red, fired, total;
};

__host__ __device__ inline DecSmem dec_smem(const DecArgs& a, int nb) {
  const int sumU = a.u_off[a.ns], Cctx = a.c_off[a.ns], sumT = a.t_off[a.ns];
  const int P = dec_plast(a), D = a.D, A = a.A, B = a.B;
  const int Zatt = P + Cctx + A, Zbig = A + Cctx + D;
  DecSmem m;
  size_t o = 0;
  for (int i = 0; i + 1 < a.n_pre; ++i) {
    m.pre[i] = o;
    o += dec_wf(a, (size_t)slice_items(a.pre_out[i], nb) * a.pre_in[i]);
  }
  m.att = o; o += dec_wf(a, (size_t)slice_items(A, nb) * 4 * Zatt);
  m.q = o; o += dec_wf(a, (size_t)slice_items(sumU, nb) * A);
  m.big = o; o += dec_wf(a, (size_t)slice_items(D, nb) * 5 * Zbig);
  m.l2 = o; o += dec_wf(a, (size_t)slice_items(D, nb) * 4 * 2 * D);
  for (int i = 0; i < a.n_hops; ++i) {
    m.kvq[i] = o; o += dec_wf(a, (size_t)slice_items(3 * D, nb) * D);
    m.ot[i] = o; o += dec_wf(a, (size_t)slice_items(D, nb) * D);
  }
  m.head = o; o += dec_wf(a, (size_t)slice_items(a.cr + 1 + a.P0, nb) * D);
  // this block's bias entries, and the state its LSTM units own ([slot][row])
  for (int i = 0; i + 1 < a.n_pre; ++i) {
    m.pre_b[i] = o;
    o += slice_items(a.pre_out[i], nb);
  }
  m.att_b = o; o += (size_t)slice_items(A, nb) * 4;
  m.big_b = o; o += (size_t)slice_items(D, nb) * 5;
  m.l2_b = o; o += (size_t)slice_items(D, nb) * 4;
  for (int i = 0; i < a.n_hops; ++i) {
    m.kvq_b[i] = o; o += slice_items(3 * D, nb);
    m.ot_b[i] = o; o += slice_items(D, nb);
  }
  m.head_b = o; o += slice_items(a.cr + 1 + a.P0, nb);
  m.c_att = o; o += (size_t)slice_items(A, nb) * B;
  m.c1 = o; o += (size_t)slice_items(D, nb) * B;
  m.c2 = o; o += (size_t)slice_items(D, nb) * B;
  m.y = o; o += (size_t)slice_items(D, nb) * B;
  m.v = o; o += sumU;
  m.loc = o; o += (size_t)a.K_loc * sumU;
  const size_t BT = (size_t)B * sumT;  // [row][source offset + step]
  m.mask = o; o += BT;
  m.conv = o; o += BT;
  m.alpha = o; o += BT;
  m.erow = o; o += BT;
  m.xin = o; o += (size_t)B * dec_xw(a);
  m.pq = o; o += (size_t)B * sumU;
  m.sc = o; o += CHUNK;
  m.cstat = o; o += 2 * (size_t)B * a.n_heads * dec_max_chunks(a);
  m.part = o; o += NT > D ? NT : D;
  m.gpart = o; o += GEMV_PART;
  m.red = o; o += 32;
  m.fired = o; o += B;
  m.total = o;
  return m;
}

// stage input: copy n floats from global (written by other blocks) to smem
__device__ __forceinline__ void stage_in(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += NT) dst[i] = __ldcg(src + i);
}

// the same for B rows of n floats (source rows contiguous) into columns
// [off, off + n) of the xs-strided destination rows
__device__ __forceinline__ void stage_rows(float* dst, int xs, int off,
                                           const float* src, int n, int B) {
  if (B == 1) {
    stage_in(dst + off, src, n);
    return;
  }
  for (int i = threadIdx.x; i < B * n; i += NT) {
    const int b = i / n, k = i - b * n;
    dst[b * xs + off + k] = __ldcg(src + i);
  }
}

// Sum each of the BB accumulators of every lane over the warp, scattered:
// afterwards lane l holds in out[r] the sum of acc[r][l % BB] (BB a power
// of two).  Halving exchanges, then the lanes' high bits: R * (BB - 1 + 5 -
// log2 BB) shuffles instead of R * BB * 5.
template <int R, int BB>
__device__ __forceinline__ void reduce_scatter(float (&acc)[R][BB],
                                               float (&out)[R]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = BB / 2; h >= 1; h /= 2) {
    const bool upper = lane & h;
#pragma unroll
    for (int j = 0; j < h; ++j) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float send = upper ? acc[r][j] : acc[r][j + h];
        const float keep = upper ? acc[r][j + h] : acc[r][j];
        acc[r][j] = keep + __shfl_xor_sync(FULL, send, h);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float v = acc[r][0];
#pragma unroll
    for (int o = BB; o < 32; o <<= 1) v += __shfl_xor_sync(FULL, v, o);
    out[r] = v;
  }
}

// The block's items of a stage (item n = blockIdx.x + gridDim.x * s has
// its R weight rows at slice + s * R * Lr), applied to the B input rows of
// x (row stride xs), BB input rows at a time.  When the block has fewer
// items than warps, each item's depth Lr is split over NWARPS / items
// warps (split-K) and the partial sums meet in ``part`` (GEMV_PART
// floats).  Lane j of the item's first warp then runs ``epi(n, s, b,
// acc)`` for input row b = b0 + j with the R sums.  Every thread of the
// block must call it (it may hold block barriers).  Weights of type W;
// with kRnd the inputs are rounded to W's precision as they are read.
template <int R, int BB, class W, bool kRnd, class Epi>
__device__ __forceinline__ void gemv_rows(int N, int Lr, const W* slice,
                                          const float* x, int xs, int B,
                                          float* part, const Epi& epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int items = N > (int)blockIdx.x
                        ? (N - blockIdx.x + gridDim.x - 1) / gridDim.x
                        : 0;
  if (items == 0) return;  // uniform over the block
  // one input row (BB = 1) takes the plain loop: no split, no predicate
  const int split = BB > 1 && items < NWARPS ? NWARPS / items : 1;
  for (int b0 = 0; b0 < B; b0 += BB) {
    const int nr = B - b0 < BB ? B - b0 : BB;
    const float* xb = x + (size_t)b0 * xs;
    for (int s0 = 0; s0 < items; s0 += NWARPS / split) {
      const int s = s0 + warp / split, piece = warp % split;
      const bool active = s < items && warp / split < NWARPS / split;
      float acc[R][BB];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < BB; ++j) acc[r][j] = 0.f;
      if (active) {
        const W* w = slice + (size_t)s * R * Lr;
        for (int k = piece * 32 + lane; k < Lr; k += 32 * split) {
          float wv[R];
#pragma unroll
          for (int r = 0; r < R; ++r) wv[r] = wload(w[r * Lr + k]);
#pragma unroll
          for (int j = 0; j < BB; ++j) {
            if (BB == 1 || j < nr) {
              const float xv =
                  kRnd ? xround<W>(xb[j * xs + k]) : xb[j * xs + k];
#pragma unroll
              for (int r = 0; r < R; ++r)
                acc[r][j] = fmaf(wv[r], xv, acc[r][j]);
            }
          }
        }
      }
      float mine[R];
      reduce_scatter<R, BB>(acc, mine);
      const int n = blockIdx.x + gridDim.x * s;
      if (split == 1) {
        if (active && lane < nr) epi(n, s, b0 + lane, mine);
        continue;
      }
      if (lane < BB) {
#pragma unroll
        for (int r = 0; r < R; ++r) part[(warp * R + r) * BB + lane] = mine[r];
      }
      __syncthreads();
      if (active && piece == 0 && lane < nr) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          for (int q = 1; q < split; ++q)
            mine[r] += part[((warp + q) * R + r) * BB + lane];
        epi(n, s, b0 + lane, mine);
      }
      __syncthreads();
    }
  }
}

template <int R, class W, bool kRnd = true, class Epi>
__device__ __forceinline__ void gemv_b(int N, int Lr, const W* slice,
                                       const float* x, int xs, int B,
                                       float* part, const Epi& epi) {
  static_assert(R <= GEMV_R, "gemv scratch holds GEMV_R rows");
  if (B == 1)
    gemv_rows<R, 1, W, kRnd>(N, Lr, slice, x, xs, B, part, epi);
  else
    gemv_rows<R, GEMV_BB, W, kRnd>(N, Lr, slice, x, xs, B, part, epi);
}

__device__ __forceinline__ int source_of(const int* off, int ns, int x) {
  int src = 0;
  while (src + 1 < ns && x >= off[src + 1]) ++src;
  return src;
}

// kOneRow: the B = 1 instance, where the row loops, the row predicates
// and the batched paths fold away at compile time.  W: the weight, key and
// value type (float, or __nv_bfloat16 in the bf16 mode).
// The arguments are __grid_constant__, so the per-source arrays that the
// kernel indexes at run time are read in place from the parameter space
// (2 % faster at B = 1 on an H100, scripts/torch_decode_ab.py; ptxas
// reports the same ~0.8 KB stack frame either way).
template <bool kOneRow, class W>
__global__ void __launch_bounds__(NT, 1)
    fused_decode_kernel(const __grid_constant__ DecArgs a) {
  extern __shared__ float sm[];
  // this block's weight slices in shared memory, and the memory, as W
  auto ws = [&](size_t off) { return reinterpret_cast<W*>(sm + off); };
  auto wg = [](const void* p) { return static_cast<const W*>(p); };
  // the query projection and location taps round their inputs (bf16 only)
  const bool rq = kIsBf16<W> && a.round_att;
  const DecLayout l = dec_layout(a);
  GridBarrier grid(a.scratch + l.total);
  const DecSmem m = dec_smem(a, gridDim.x);
  float* g = a.scratch;
  const int B = kOneRow ? 1 : a.B;
  const int S = a.S, ns = a.ns, A = a.A, D = a.D, cr = a.cr;
  const int sumU = a.u_off[ns], Cctx = a.c_off[ns], sumT = a.t_off[ns];
  const int P = dec_plast(a);
  const int Zatt = P + Cctx + A, Zbig = A + Cctx + D;
  const int xw = dec_xw(a);
  const bool alpha_ctx = kOneRow && a.alpha_ctx;
  const int nhead = cr + 1 + a.P0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gtid = blockIdx.x * NT + tid, gstride = gridDim.x * NT;
  StageClock clk(a.stage_cycles);

  // ---- zero outputs and state; step-0 prenet pre-activation = b0
  for (size_t i = gtid; i < (size_t)B * S * (cr + 1); i += gstride)
    a.out[i] = 0.f;
  if (a.aligns != nullptr)
    for (size_t i = gtid; i < (size_t)S * sumT; i += gstride)
      a.aligns[i] = 0.f;
  for (size_t i = gtid; i < l.total; i += gstride) g[i] = 0.f;
  grid.sync();
  for (int i = gtid; i < B * a.P0; i += gstride)
    g[l.p0 + i] = __ldg(a.p0_init + i % a.P0);

  // ---- this block's weight rows, and the small replicated operands
  for (int i = 0; i + 1 < a.n_pre; ++i)
    load_slice(ws(m.pre[i]), wg(a.pre_w[i]), a.pre_out[i], 1, a.pre_in[i]);
  load_slice(ws(m.att), wg(a.att_w), A, 4, Zatt);
  load_slice(ws(m.q), wg(a.q_w), sumU, 1, A);
  load_slice(ws(m.big), wg(a.big_w), D, 5, Zbig);
  load_slice(ws(m.l2), wg(a.l2_w), D, 4, 2 * D);
  for (int i = 0; i < a.n_hops; ++i) {
    load_slice(ws(m.kvq[i]), wg(a.kvq_w[i]), 3 * D, 1, D);
    load_slice(ws(m.ot[i]), wg(a.ot_w[i]), D, 1, D);
  }
  load_slice(ws(m.head), wg(a.head_w), nhead, 1, D);
  for (int i = 0; i + 1 < a.n_pre; ++i)
    load_bias_slice(sm + m.pre_b[i], a.pre_b[i], a.pre_out[i], 1);
  load_bias_slice(sm + m.att_b, a.att_b, A, 4);
  load_bias_slice(sm + m.big_b, a.big_b, D, 5);
  load_bias_slice(sm + m.l2_b, a.l2_b, D, 4);
  for (int i = 0; i < a.n_hops; ++i) {
    load_bias_slice(sm + m.kvq_b[i], a.kvq_b[i], 3 * D, 1);
    load_bias_slice(sm + m.ot_b[i], a.ot_b[i], D, 1);
  }
  load_bias_slice(sm + m.head_b, a.head_b, nhead, 1);
  for (size_t i = tid; i < m.v - m.c_att; i += NT) sm[m.c_att + i] = 0.f;
  for (int i = tid; i < sumU; i += NT) sm[m.v + i] = __ldg(a.v + i);
  for (int i = tid; i < a.K_loc * sumU; i += NT)
    sm[m.loc + i] = __ldg(a.loc_w + i);
  for (int i = tid; i < B * sumT; i += NT) {
    const int x = i % sumT;
    const int src = source_of(a.t_off, ns, x);
    sm[m.mask + i] = __ldg(a.mask + i);
    sm[m.conv + i] = 0.f;
    sm[m.alpha + i] = (a.kinds[src] == 2 && x == a.t_off[src]) ? 1.f : 0.f;
    sm[m.erow + i] = 0.f;
  }
  for (int i = tid; i < B; i += NT) sm[m.fired + i] = 0.f;
  grid.sync();
  clk.mark(ST_SETUP);

  float* xin = sm + m.xin;
  float* red = sm + m.red;
  float* gpart = sm + m.gpart;
  const int pad = (a.K_loc - 1) / 2;
  const int hd = D / a.n_heads;
  const float sa_scale = rsqrtf((float)hd);

  for (int t = 0; t < S; ++t) {
    const int par = t & 1;
    float* h_att_in = g + l.h_att + (size_t)par * B * A;
    float* h_att_out = g + l.h_att + (size_t)(1 - par) * B * A;
    float* h1_in = g + l.h1 + (size_t)par * B * D;
    float* h1_out = g + l.h1 + (size_t)(1 - par) * B * D;
    float* h2_in = g + l.h2 + (size_t)par * B * D;
    float* h2_out = g + l.h2 + (size_t)(1 - par) * B * D;

    // ---- prenet: relu(pre-activation from the previous head) (+ the
    // speaker row), then Dense + ReLU for the remaining layers
    const float* p_last = g + l.p0;
    int p_stride = a.P0;
    for (int i = 0; i + 1 < a.n_pre; ++i) {
      const int n_in = a.pre_in[i];
      for (int e = tid; e < B * n_in; e += NT) {
        const int b = e / n_in, k = e - b * n_in;
        float v = __ldcg(p_last + (size_t)b * p_stride + k);
        if (i == 0) {
          v = fmaxf(v, 0.f);
          if (a.use_spk) v += __ldg(a.spk + (size_t)b * a.P0 + k);
        }
        xin[b * xw + k] = v;
      }
      __syncthreads();
      float* pout = g + l.pbuf + (size_t)(i % 2) * B * l.maxp;
      const float* bias = sm + m.pre_b[i];
      const int maxp = l.maxp;
      gemv_b<1>(a.pre_out[i], n_in, ws(m.pre[i]), xin, xw, B, gpart,
                [&](int n, int s, int b, const float* acc) {
                  pout[(size_t)b * maxp + n] = fmaxf(acc[0] + bias[s], 0.f);
                });
      grid.sync();
      clk.mark(ST_PRENET);
      p_last = pout;
      p_stride = l.maxp;
    }

    // ---- attention LSTM over [prenet, prev context, h_att]
    for (int e = tid; e < B * P; e += NT) {
      const int b = e / P, k = e - b * P;
      float v = __ldcg(p_last + (size_t)b * p_stride + k);
      if (a.n_pre == 1) {
        v = fmaxf(v, 0.f);
        if (a.use_spk) v += __ldg(a.spk + (size_t)b * a.P0 + k);
      }
      xin[b * xw + k] = v;
    }
    if (alpha_ctx)  // the previous step's alignments (zeros at t = 0)
      for (int i = tid; i < sumT; i += NT) xin[P + i] = sm[m.erow + i];
    else
      stage_rows(xin, xw, P, g + l.ctx, Cctx, B);
    stage_rows(xin, xw, P + Cctx, h_att_in, A, B);
    __syncthreads();
    {
      const float* bias = sm + m.att_b;
      float* c = sm + m.c_att;
      const float zc = a.zc_att, zo = a.zo_att;
      gemv_b<4>(A, Zatt, ws(m.att), xin, xw, B, gpart,
                [&](int n, int s, int b, const float* acc) {
        const float* bs = bias + 4 * s;
        float c_new, h_new;
        lstm_cell(acc[0] + bs[0], acc[1] + bs[1], acc[2] + bs[2],
                  acc[3] + bs[3], c[s * B + b], xin[b * xw + P + Cctx + n],
                  zc, zo, c_new, h_new);
        c[s * B + b] = c_new;
        h_att_out[(size_t)b * A + n] = h_new;
      });
    }
    grid.sync();
    clk.mark(ST_ATT_LSTM);

    // ---- query projections of all sources
    stage_rows(xin, xw, 0, h_att_out, A, B);
    __syncthreads();
    {
      float* pq = g + l.pq;
      auto epi = [&](int n, int, int b, const float* acc) {
        pq[(size_t)b * sumU + n] = acc[0];
      };
      if (kIsBf16<W> && !rq)  // the B = 1 row path: an f32 query input
        gemv_b<1, W, false>(sumU, A, ws(m.q), xin, xw, B, gpart, epi);
      else
        gemv_b<1>(sumU, A, ws(m.q), xin, xw, B, gpart, epi);
    }
    grid.sync();
    clk.mark(ST_QUERY);

    // ---- energies of each (row, source, memory step): v . tanh(key +
    // query + location taps).  One block an item, threads over the
    // attention units, while the items fit the grid (B = 1); else one warp
    // an item, lanes over the units
    stage_in(sm + m.pq, g + l.pq, B * sumU);
    __syncthreads();
    {
      auto term = [&](int it, int u0_lane, int stride) {
        const int b = it / sumT, x = it - b * sumT;
        const int src = source_of(a.t_off, ns, x);
        const int T = a.t_off[src + 1] - a.t_off[src];
        const int tau = x - a.t_off[src];
        const int u0 = a.u_off[src], U = a.u_off[src + 1] - u0;
        const bool loc = a.kinds[src] != 0;
        const W* krow = wg(a.keys) + a.k_off[src] + ((size_t)b * T + tau) * U;
        const float* conv = sm + m.conv + (size_t)b * sumT + a.t_off[src];
        const float* pq = sm + m.pq + (size_t)b * sumU + u0;
        float acc = 0.f;
        if (stride == NT) {  // a block an item: one unit a thread
          for (int u = u0_lane; u < U; u += NT) {
            float pre = wload(__ldg(krow + u)) + pq[u];
            if (loc) {
              for (int k = 0; k < a.K_loc; ++k) {
                const int j = tau + k - pad;
                if (j >= 0 && j < T)
                  pre = fmaf(sm[m.loc + k * sumU + u0 + u],
                             rq ? xround<W>(conv[j]) : conv[j], pre);
              }
            }
            acc = fmaf(sm[m.v + u0 + u], tanhf(pre), acc);
          }
          return acc;
        }
        for (int base = u0_lane; base < U; base += 8 * stride) {
          float key[8];  // the loads issued together, then the math
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int u = base + i * stride;
            key[i] = u < U ? wload(__ldg(krow + u)) : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int u = base + i * stride;
            if (u < U) {
              float pre = key[i] + pq[u];
              if (loc) {
                for (int k = 0; k < a.K_loc; ++k) {
                  const int j = tau + k - pad;
                  if (j >= 0 && j < T)
                    pre = fmaf(sm[m.loc + k * sumU + u0 + u],
                               rq ? xround<W>(conv[j]) : conv[j], pre);
                }
              }
              acc = fmaf(sm[m.v + u0 + u], tanhf(pre), acc);
            }
          }
        }
        return acc;
      };
      if (B * sumT <= (int)gridDim.x) {
        for (int it = blockIdx.x; it < B * sumT; it += gridDim.x) {
          const float acc = block_sum(term(it, tid, NT), red);
          if (tid == 0) g[l.e + it] = acc;
        }
      } else {
        for (int it = blockIdx.x + gridDim.x * warp; it < B * sumT;
             it += gridDim.x * NWARPS) {
          const float acc = warp_sum(term(it, lane, 32));
          if (lane == 0) g[l.e + it] = acc;
        }
      }
    }
    grid.sync();
    clk.mark(ST_ENERGY);

    // ---- every block: masked softmax (row-max shift), forward recursion,
    // conv-input state, alignment rows; then context columns
    float* erow = sm + m.erow;
    stage_in(erow, g + l.e, B * sumT);
    __syncthreads();
    for (int task = warp; task < B * ns; task += NWARPS) {
      // one warp per (row, source): shuffles, no block barrier
      const int b = task / ns, src = task - b * ns;
      const int T = a.t_off[src + 1] - a.t_off[src];
      const size_t base = (size_t)b * sumT + a.t_off[src];
      float* er = erow + base;
      const float* mk = sm + m.mask + base;
      float mx = -3.0e38f;
      for (int tau = lane; tau < T; tau += 32) {
        const float e = mk[tau] > 0.5f ? er[tau] : -1e9f;
        er[tau] = e;
        mx = fmaxf(mx, e);
      }
      mx = warp_max(mx);
      float sum = 0.f;
      for (int tau = lane; tau < T; tau += 32) {
        const float e = expf(er[tau] - mx);
        er[tau] = e;
        sum += e;
      }
      const float inv = 1.f / warp_sum(sum);
      const int kind = a.kinds[src];
      float* cv = sm + m.conv + base;
      if (kind == 2) {
        float* al = sm + m.alpha + base;
        float part = 0.f;
        for (int tau = lane; tau < T; tau += 32) {
          const float p = er[tau] * inv;
          const float shifted = tau > 0 ? al[tau - 1] : 0.f;
          const float z = (0.5f * al[tau] + 0.5f * shifted + 1e-7f) * p;
          er[tau] = z;
          part += z;
          cv[tau] = a.cumulative[src] ? cv[tau] + p : p;
        }
        const float zinv = 1.f / warp_sum(part);
        __syncwarp();  // every lane's reads of al are done
        for (int tau = lane; tau < T; tau += 32) {
          const float z = er[tau] * zinv;
          al[tau] = z;
          er[tau] = z;
        }
      } else {
        for (int tau = lane; tau < T; tau += 32) {
          const float p = er[tau] * inv;
          if (kind == 1) cv[tau] = a.cumulative[src] ? cv[tau] + p : p;
          er[tau] = p;
        }
      }
    }
    __syncthreads();
    if (a.aligns != nullptr && blockIdx.x == 0)
      for (int i = tid; i < sumT; i += NT)
        a.aligns[(size_t)t * sumT + i] = erow[i];
    if (!alpha_ctx) {
      // one warp per (row, context column), lanes over the memory steps
      float* ctx = g + l.ctx;
      for (int s8 = warp;; s8 += NWARPS) {
        const int item = blockIdx.x + gridDim.x * s8;
        if (item >= B * Cctx) break;
        const int b = item / Cctx, c = item - b * Cctx;
        const int src = source_of(a.c_off, ns, c);
        const int T = a.t_off[src + 1] - a.t_off[src];
        const int C = a.c_off[src + 1] - a.c_off[src];
        const float* er = erow + (size_t)b * sumT + a.t_off[src];
        const W* vcol = wg(a.values) + a.v_off[src] + (size_t)b * T * C +
                        (c - a.c_off[src]);
        float acc = 0.f;
        for (int tau = lane; tau < T; tau += 32)
          acc = fmaf(er[tau], wload(__ldg(vcol + (size_t)tau * C)), acc);
        acc = warp_sum(acc);
        if (lane == 0) ctx[item] = acc;
      }
      grid.sync();
      clk.mark(ST_SOFTMAX_CTX);
    }

    // ---- merged projection + lstm1 over [h_att, ctx, h1]
    stage_rows(xin, xw, 0, h_att_out, A, B);
    if (alpha_ctx)  // this step's alignments, from the softmax above
      for (int i = tid; i < sumT; i += NT) xin[A + i] = erow[i];
    else
      stage_rows(xin, xw, A, g + l.ctx, Cctx, B);
    stage_rows(xin, xw, A + Cctx, h1_in, D, B);
    __syncthreads();
    {
      const float* bias = sm + m.big_b;
      float* c = sm + m.c1;
      float* o1 = g + l.o1;
      const float zc = a.zc_dec, zo = a.zo_dec;
      gemv_b<5>(D, Zbig, ws(m.big), xin, xw, B, gpart,
                [&](int n, int s, int b, const float* acc) {
        const float* bs = bias + 5 * s;
        float c_new, h_new;
        lstm_cell(acc[0] + bs[0], acc[1] + bs[1], acc[2] + bs[2],
                  acc[3] + bs[3], c[s * B + b], xin[b * xw + A + Cctx + n],
                  zc, zo, c_new, h_new);
        c[s * B + b] = c_new;
        h1_out[(size_t)b * D + n] = h_new;
        o1[(size_t)b * D + n] = acc[4] + bs[4] + h_new;
      });
    }
    grid.sync();
    clk.mark(ST_PROJ_LSTM1);

    // ---- lstm2 over [o1, h2]; y = o1 + h2
    stage_rows(xin, xw, 0, g + l.o1, D, B);
    stage_rows(xin, xw, D, h2_in, D, B);
    __syncthreads();
    {
      const float* bias = sm + m.l2_b;
      float* c = sm + m.c2;
      float* y = g + l.y;
      float* ys = sm + m.y;
      const float zc = a.zc_dec, zo = a.zo_dec;
      gemv_b<4>(D, 2 * D, ws(m.l2), xin, xw, B, gpart,
                [&](int n, int s, int b, const float* acc) {
        const float* bs = bias + 4 * s;
        float c_new, h_new;
        lstm_cell(acc[0] + bs[0], acc[1] + bs[1], acc[2] + bs[2],
                  acc[3] + bs[3], c[s * B + b], xin[b * xw + D + n], zc, zo,
                  c_new, h_new);
        c[s * B + b] = c_new;
        h2_out[(size_t)b * D + n] = h_new;
        ys[s * B + b] = y[(size_t)b * D + n] = xin[b * xw + n] + h_new;
      });
    }
    grid.sync();
    clk.mark(ST_LSTM2);

    // ---- causal self-attention hops over the per-row KV caches
    for (int hop = 0; hop < a.n_hops; ++hop) {
      float* kc = g + l.kc + (size_t)hop * B * S * D;
      float* vc = g + l.vc + (size_t)hop * B * S * D;
      stage_rows(xin, xw, 0, g + l.y, D, B);
      __syncthreads();
      {
        const float* bias = sm + m.kvq_b[hop];
        float* q = g + l.q;
        gemv_b<1>(3 * D, D, ws(m.kvq[hop]), xin, xw, B, gpart,
                  [&](int n, int s, int b, const float* acc) {
                    const float v = acc[0] + bias[s];
                    const size_t row = ((size_t)b * S + t) * D;
                    if (n < D)
                      kc[row + n] = v;
                    else if (n < 2 * D)
                      vc[row + n - D] = v;
                    else
                      q[(size_t)b * D + n - 2 * D] = v;
                  });
      }
      grid.sync();
      clk.mark(ST_HOP_KVQ);

      // one block per (row, head, chunk of CHUNK cached steps): scores,
      // the chunk's max and sum of exps, and its unnormalized context
      const int nchunk = (t + CHUNK) / CHUNK;
      const int maxch = dec_max_chunks(a);
      const int groups = NT / hd > 0 ? NT / hd : 1;
      const int per_row = a.n_heads * nchunk;
      for (int item = blockIdx.x; item < B * per_row; item += gridDim.x) {
        const int b = item / per_row, r = item - b * per_row;
        const int hh = r / nchunk, ck = r % nchunk;
        const int tau0 = ck * CHUNK, ntau = min(CHUNK, t + 1 - tau0);
        const float* kcb = kc + (size_t)b * S * D;
        const float* vcb = vc + (size_t)b * S * D;
        float* es = sm + m.sc;
        stage_in(xin, g + l.q + (size_t)b * D + hh * hd, hd);
        __syncthreads();
        float part[CHUNK / NWARPS];
#pragma unroll
        for (int j = 0; j < CHUNK / NWARPS; ++j) {
          const int i = warp + NWARPS * j;
          float acc = 0.f;
          if (i < ntau) {
            const float* krow = kcb + (size_t)(tau0 + i) * D + hh * hd;
#pragma unroll 4
            for (int d = lane; d < hd; d += 32)
              acc = fmaf(xin[d], __ldcg(krow + d), acc);
          }
          part[j] = acc;
        }
#pragma unroll
        for (int j = 0; j < CHUNK / NWARPS; ++j) {
          const float sc = warp_sum(part[j]);
          if (lane == 0) es[warp + NWARPS * j] = sc * sa_scale;
        }
        __syncthreads();
        const size_t stat = ((size_t)b * a.n_heads + hh) * maxch + ck;
        if (warp == 0) {
          const float sc = lane < ntau ? es[lane] : -3.0e38f;
          const float mx = warp_max(sc);
          const float e = lane < ntau ? expf(sc - mx) : 0.f;
          es[lane] = e;
          const float sum = warp_sum(e);
          if (lane == 0) {
            g[l.pm + stat] = mx;
            g[l.ps + stat] = sum;
          }
        }
        __syncthreads();
        for (int idx = tid; idx < hd * groups; idx += NT) {
          const int col = idx % hd, grp = idx / hd;
          const float* vcol = vcb + hh * hd + col;
          float acc = 0.f;
#pragma unroll
          for (int j = 0; j < CHUNK; ++j) {  // loads issued together
            const int i = grp + j * groups;
            if (i < ntau)
              acc = fmaf(es[i], __ldcg(vcol + (size_t)(tau0 + i) * D), acc);
          }
          sm[m.part + idx] = acc;
        }
        __syncthreads();
        for (int col = tid; col < hd; col += NT) {
          float acc = 0.f;
          for (int grp = 0; grp < groups; ++grp)
            acc += sm[m.part + grp * hd + col];
          g[l.pc + ((size_t)b * maxch + ck) * D + hh * hd + col] = acc;
        }
        __syncthreads();
      }
      grid.sync();
      clk.mark(ST_HOP_ATTN);

      // combine the chunks (shift by the max over chunks), then the merged
      // output * transform dense: y += tanh(hctx @ Wot + b).  B > 1: one
      // block per (row, head) combines into hctx (B, D) in the q buffer,
      // behind a barrier; B = 1: every block combines its input itself
      if (B > 1) {
        float* wt = sm + m.cstat;
        float* ws = wt + nchunk;
        for (int item = blockIdx.x; item < B * a.n_heads;
             item += gridDim.x) {
          const int b = item / a.n_heads, hh = item - b * a.n_heads;
          const size_t st = (size_t)item * maxch;
          for (int ck = tid; ck < nchunk; ck += NT) {
            wt[ck] = __ldcg(g + l.pm + st + ck);
            ws[ck] = __ldcg(g + l.ps + st + ck);
          }
          __syncthreads();
          if (warp == 0) {
            float mx = -3.0e38f;
            for (int ck = lane; ck < nchunk; ck += 32) mx = fmaxf(mx, wt[ck]);
            mx = warp_max(mx);
            float den = 0.f;
            for (int ck = lane; ck < nchunk; ck += 32)
              den = fmaf(expf(wt[ck] - mx), ws[ck], den);
            den = warp_sum(den);
            __syncwarp();
            for (int ck = lane; ck < nchunk; ck += 32)
              wt[ck] = expf(wt[ck] - mx) / den;
          }
          __syncthreads();
          for (int col = tid; col < hd; col += NT) {
            const float* pc =
                g + l.pc + (size_t)b * maxch * D + hh * hd + col;
            float num = 0.f;
#pragma unroll 4
            for (int ck = 0; ck < nchunk; ++ck)
              num = fmaf(wt[ck], __ldcg(pc + (size_t)ck * D), num);
            g[l.q + (size_t)b * D + hh * hd + col] = num;
          }
          __syncthreads();
        }
        grid.sync();
        stage_rows(xin, xw, 0, g + l.q, D, B);
        __syncthreads();
      } else {
        float* cm = sm + m.cstat;
        float* cs = cm + per_row;
        for (int i = tid; i < per_row; i += NT) {
          const size_t stat = (size_t)(i / nchunk) * maxch + i % nchunk;
          cm[i] = __ldcg(g + l.pm + stat);
          cs[i] = __ldcg(g + l.ps + stat);
        }
        __syncthreads();
        // one warp per head: the chunks' weights exp(max_ck - max) / sum,
        // in place of the maxes
        for (int hh = warp; hh < a.n_heads; hh += NWARPS) {
          float* hm = cm + hh * nchunk;
          const float* hs = cs + hh * nchunk;
          float mx = -3.0e38f;
          for (int ck = lane; ck < nchunk; ck += 32) mx = fmaxf(mx, hm[ck]);
          mx = warp_max(mx);
          float den = 0.f;
          for (int ck = lane; ck < nchunk; ck += 32)
            den = fmaf(expf(hm[ck] - mx), hs[ck], den);
          den = warp_sum(den);
          __syncwarp();
          for (int ck = lane; ck < nchunk; ck += 32)
            hm[ck] = expf(hm[ck] - mx) / den;
        }
        __syncthreads();
        for (int d = tid; d < D; d += NT) {
          const float* wt = cm + (d / hd) * nchunk;
          float num = 0.f;
#pragma unroll 4
          for (int ck = 0; ck < nchunk; ++ck)
            num = fmaf(wt[ck], __ldcg(g + l.pc + (size_t)ck * D + d), num);
          xin[d] = num;
        }
        __syncthreads();
      }
      {
        // item n of this stage is item n of lstm2: the same block and slot
        // own y[., n], so it is read from shared memory
        const float* bias = sm + m.ot_b[hop];
        float* y = g + l.y;
        float* ys = sm + m.y;
        gemv_b<1>(D, D, ws(m.ot[hop]), xin, xw, B, gpart,
                  [&](int n, int s, int b, const float* acc) {
                    ys[s * B + b] = y[(size_t)b * D + n] =
                        ys[s * B + b] + tanhf(acc[0] + bias[s]);
                  });
      }
      grid.sync();
      clk.mark(ST_HOP_OUT);
    }

    // ---- output + stop + next-step first-prenet pre-activation
    stage_rows(xin, xw, 0, g + l.y, D, B);
    __syncthreads();
    {
      const float* bias = sm + m.head_b;
      float* p0 = g + l.p0;
      const int P0 = a.P0;
      gemv_b<1>(nhead, D, ws(m.head), xin, xw, B, gpart,
                [&](int n, int s, int b, const float* acc) {
        const float v = acc[0] + bias[s];
        if (n <= cr)
          a.out[((size_t)b * S + t) * (cr + 1) + n] = v;
        else
          p0[(size_t)b * P0 + n - cr - 1] = v;
      });
    }
    grid.sync();
    clk.mark(ST_HEAD);
    if (a.early_stop && t > a.min_iters) {
      // every block reads the same logits, so all of them leave together
      if (tid == 0) {
        int all = 1;
        for (int b = 0; b < B; ++b) {
          if (__ldcg(a.out + ((size_t)b * S + t) * (cr + 1) + cr) > 0.f)
            sm[m.fired + b] = 1.f;
          all &= sm[m.fired + b] > 0.5f;
        }
        red[0] = all ? 1.f : 0.f;
      }
      __syncthreads();
      const bool stop = red[0] > 0.5f;
      __syncthreads();
      if (stop) break;
    }
  }
}

// ------------------------------------------------------------------- host
extern "C" long long fused_decode_scratch_floats(const DecArgs* a) {
  return (long long)dec_layout(*a).total + GRID_BAR_WORDS;
}

extern "C" long long fused_decode_smem_floats(const DecArgs* a, int nb) {
  return (long long)dec_smem(*a, nb).total;
}

extern "C" int fused_decode_launch(const DecArgs* args, void* stream) {
  DecArgs a = *args;
  void (*kernel)(const DecArgs) =
      a.bf16 ? (a.B == 1 ? fused_decode_kernel<true, __nv_bfloat16>
                         : fused_decode_kernel<false, __nv_bfloat16>)
             : (a.B == 1 ? fused_decode_kernel<true, float>
                         : fused_decode_kernel<false, float>);
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaDeviceGetAttribute(&optin,
                                  cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                  dev)) != cudaSuccess)
    return (int)e;
  const size_t smem = dec_smem(a, sms).total * sizeof(float);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, NT, smem)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  if ((e = cudaMemsetAsync(a.scratch + dec_layout(a).total, 0,
                           GRID_BAR_WORDS * sizeof(unsigned),
                           (cudaStream_t)stream)) != cudaSuccess)
    return (int)e;
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel((void*)kernel, dim3(sms),
                                  dim3(NT), params, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
