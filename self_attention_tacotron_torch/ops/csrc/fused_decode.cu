// The whole batch-1 autoregressive decode loop in one cooperative kernel.
//
// Replaces: self_attention_tacotron_tpu/ops/fused_decode.py `_kernel`
// (Pallas, reached through `fused_decode`), its B = 1 row mode with
// additive (kind 0) and forward (kind 2) source attention.
//
// What bounds it on the H100: each step is a chain of ~11 dependent
// matrix-vector products and reductions over ~3.0 M merged f32 weights
// (12 MB at the recipe: attention LSTM 672 x 1024, merged projection+lstm1
// 800 x 1280, lstm2 512 x 1024, hop 256 x 768 and 256 x 256, head
// 256 x 1282, ...), ~6 MFLOP a step.  Streamed from device memory every
// step, the weights alone would take ~3.6 us a step (1.6 ms for 450 steps);
// the FLOPs are ~0.1 us.  Held on chip, what is left is the serial chain:
// the stage latencies and the grid barriers between them.
//
// Design: one block per SM (132 blocks), launched cooperatively.  Every
// product stage gives one output column (or one LSTM unit: its four gate
// rows, plus the projection row of the merged lstm1 stage) to one warp,
// and column n belongs to block n % 132 for the whole call, so each block
// copies its rows of every weight matrix into shared memory once (~92 KB
// a block at the recipe) and never reads them from device memory again --
// the Hopper counterpart of the TPU kernel's VMEM-resident weights.  The
// per-step state vectors (< 1.5 K floats) go through global memory, which
// stays in L2; a grid barrier separates the dependent stages.  Source
// attention: energies one block per (source, memory step), its threads
// over the attention units; then every block
// computes the masked softmax (shifted by the row max, NOT the static
// bound sum |v| of the JAX kernel), the forward recursion and the
// alignment rows redundantly in its own shared memory (they are T floats
// a source), which removes a barrier and keeps each block's conv-input
// and alpha state local (one warp per source, shuffles only); the context
// is one warp per column.  Each block also keeps its items' bias entries
// and its LSTM units' cell states in shared memory.  Hops: one
// block per (head, chunk of 32 cached steps) computes the chunk's scores,
// max, sum of exps and unnormalized context, and the next stage combines
// the chunks while staging its input (split-K attention), so no block
// walks the whole cache.  The loop exits once the stop logit is > 0 past
// min_iters; rows after the exit read 0.  Plain FP32 FMA throughout;
// later work: fewer barriers (fused stages), bf16 weights.
#include <cstddef>

#include "common.cuh"

constexpr int MAX_SOURCES = 4, MAX_PRENET = 4, MAX_HOPS = 4;

struct DecArgs {  // mirrored by _DecArgs in ops/fused_decode.py
  int S, T, ns, cr, P0, A, D, n_pre, n_hops, n_heads, K_loc, early_stop,
      min_iters;
  int kinds[MAX_SOURCES];
  int cumulative[MAX_SOURCES];
  int u_off[MAX_SOURCES + 1];
  int c_off[MAX_SOURCES + 1];
  float zc_att, zo_att, zc_dec, zo_dec;
  const float* keys;    // (T, sumU), attention and conv biases folded
  const float* values;  // (T, Cctx)
  const float* mask;    // (ns, T)
  const float* loc_w;   // (K, sumU)
  const float* v;       // (sumU)
  const float* p0_init; // (P0)
  const float* pre_w[MAX_PRENET];  // layers 1..n_pre-1: (out, in)
  const float* pre_b[MAX_PRENET];
  int pre_in[MAX_PRENET];
  int pre_out[MAX_PRENET];
  const float* att_w;  // (4A, P + Cctx + A)
  const float* att_b;
  const float* q_w;    // (sumU, A)
  const float* big_w;  // (5D, A + Cctx + D)
  const float* big_b;
  const float* l2_w;   // (4D, 2D)
  const float* l2_b;
  const float* kvq_w[MAX_HOPS];  // (3D, D)
  const float* kvq_b[MAX_HOPS];
  const float* ot_w[MAX_HOPS];   // (D, D)
  const float* ot_b[MAX_HOPS];
  const float* head_w;  // (cr + 1 + P0, D)
  const float* head_b;
  float* out;     // (S, cr + 1): logits and the stop logit
  float* aligns;  // (S, ns, T)
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

// ---- global scratch (state vectors, energies, KV caches)
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
  const int sumU = a.u_off[a.ns], Cctx = a.c_off[a.ns];
  DecLayout l;
  l.maxp = a.P0;
  for (int i = 0; i + 1 < a.n_pre; ++i)
    if (a.pre_out[i] > l.maxp) l.maxp = a.pre_out[i];
  size_t o = 0;
  l.h_att = o; o += 2 * a.A;   // [parity][unit]
  l.h1 = o; o += 2 * a.D;
  l.o1 = o; o += a.D;
  l.h2 = o; o += 2 * a.D;
  l.y = o; o += a.D;
  l.pbuf = o; o += 2 * l.maxp;
  l.p0 = o; o += a.P0;
  l.ctx = o; o += Cctx;
  l.pq = o; o += sumU;
  l.e = o; o += (size_t)a.ns * a.T;
  l.q = o; o += a.D;
  // per (head, chunk): running max, sum of exps, unnormalized context
  const size_t hc = (size_t)a.n_heads * dec_max_chunks(a);
  l.pm = o; o += hc;
  l.ps = o; o += hc;
  l.pc = o; o += (size_t)dec_max_chunks(a) * a.D;
  l.kc = o; o += (size_t)a.n_hops * a.S * a.D;
  l.vc = o; o += (size_t)a.n_hops * a.S * a.D;
  l.total = o;
  return l;
}

// ---- shared memory of one block (offsets in floats) for a grid of nb
struct DecSmem {
  size_t pre[MAX_PRENET], att, q, big, l2, kvq[MAX_HOPS], ot[MAX_HOPS], head,
      pre_b[MAX_PRENET], att_b, big_b, l2_b, kvq_b[MAX_HOPS], ot_b[MAX_HOPS],
      head_b, c_att, c1, c2, y, v, loc, mask, conv, alpha, erow, tmp, xin, pq,
      sc, cstat, part, red, total;
};

__host__ __device__ inline DecSmem dec_smem(const DecArgs& a, int nb) {
  const int sumU = a.u_off[a.ns], Cctx = a.c_off[a.ns];
  const int P = dec_plast(a), D = a.D, A = a.A;
  const int Zatt = P + Cctx + A, Zbig = A + Cctx + D;
  DecSmem m;
  size_t o = 0;
  for (int i = 0; i + 1 < a.n_pre; ++i) {
    m.pre[i] = o;
    o += (size_t)slice_items(a.pre_out[i], nb) * a.pre_in[i];
  }
  m.att = o; o += (size_t)slice_items(A, nb) * 4 * Zatt;
  m.q = o; o += (size_t)slice_items(sumU, nb) * A;
  m.big = o; o += (size_t)slice_items(D, nb) * 5 * Zbig;
  m.l2 = o; o += (size_t)slice_items(D, nb) * 4 * 2 * D;
  for (int i = 0; i < a.n_hops; ++i) {
    m.kvq[i] = o; o += (size_t)slice_items(3 * D, nb) * D;
    m.ot[i] = o; o += (size_t)slice_items(D, nb) * D;
  }
  m.head = o; o += (size_t)slice_items(a.cr + 1 + a.P0, nb) * D;
  // this block's bias entries, and the state its LSTM units own
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
  m.c_att = o; o += slice_items(A, nb);
  m.c1 = o; o += slice_items(D, nb);
  m.c2 = o; o += slice_items(D, nb);
  m.y = o; o += slice_items(D, nb);
  m.v = o; o += sumU;
  m.loc = o; o += (size_t)a.K_loc * sumU;
  const size_t nsT = (size_t)a.ns * a.T;
  m.mask = o; o += nsT;
  m.conv = o; o += nsT;
  m.alpha = o; o += nsT;
  m.erow = o; o += nsT;
  m.tmp = o; o += nsT;
  int xin = Zatt > Zbig ? Zatt : Zbig;
  if (2 * D > xin) xin = 2 * D;
  for (int i = 0; i + 1 < a.n_pre; ++i)
    if (a.pre_in[i] > xin) xin = a.pre_in[i];
  m.xin = o; o += xin;
  m.pq = o; o += sumU;
  m.sc = o; o += CHUNK;
  m.cstat = o; o += 2 * (size_t)a.n_heads * dec_max_chunks(a);
  m.part = o; o += NT > D ? NT : D;
  m.red = o; o += 32;
  m.total = o;
  return m;
}

// stage input: copy n floats from global (written by other blocks) to smem
__device__ __forceinline__ void stage_in(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += NT) dst[i] = __ldcg(src + i);
}

__global__ void __launch_bounds__(NT, 1) fused_decode_kernel(DecArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float sm[];
  const DecLayout l = dec_layout(a);
  const DecSmem m = dec_smem(a, gridDim.x);
  float* g = a.scratch;
  const int S = a.S, T = a.T, ns = a.ns, A = a.A, D = a.D, cr = a.cr;
  const int sumU = a.u_off[ns], Cctx = a.c_off[ns];
  const int P = dec_plast(a);
  const int Zatt = P + Cctx + A, Zbig = A + Cctx + D;
  const int nhead = cr + 1 + a.P0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gtid = blockIdx.x * NT + tid, gstride = gridDim.x * NT;
  StageClock clk(a.stage_cycles);

  // ---- zero outputs and state; step-0 prenet pre-activation = b0
  for (size_t i = gtid; i < (size_t)S * (cr + 1); i += gstride) a.out[i] = 0.f;
  for (size_t i = gtid; i < (size_t)S * ns * T; i += gstride)
    a.aligns[i] = 0.f;
  for (size_t i = gtid; i < l.total; i += gstride) g[i] = 0.f;
  grid.sync();
  for (int i = gtid; i < a.P0; i += gstride) g[l.p0 + i] = __ldg(a.p0_init + i);

  // ---- this block's weight rows, and the small replicated operands
  for (int i = 0; i + 1 < a.n_pre; ++i)
    load_slice(sm + m.pre[i], a.pre_w[i], a.pre_out[i], 1, a.pre_in[i]);
  load_slice(sm + m.att, a.att_w, A, 4, Zatt);
  load_slice(sm + m.q, a.q_w, sumU, 1, A);
  load_slice(sm + m.big, a.big_w, D, 5, Zbig);
  load_slice(sm + m.l2, a.l2_w, D, 4, 2 * D);
  for (int i = 0; i < a.n_hops; ++i) {
    load_slice(sm + m.kvq[i], a.kvq_w[i], 3 * D, 1, D);
    load_slice(sm + m.ot[i], a.ot_w[i], D, 1, D);
  }
  load_slice(sm + m.head, a.head_w, nhead, 1, D);
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
  for (int i = tid; i < ns * T; i += NT) {
    const int src = i / T, tau = i % T;
    sm[m.mask + i] = __ldg(a.mask + i);
    sm[m.conv + i] = 0.f;
    sm[m.alpha + i] = (a.kinds[src] == 2 && tau == 0) ? 1.f : 0.f;
  }
  grid.sync();
  clk.mark(ST_SETUP);

  float* xin = sm + m.xin;
  float* red = sm + m.red;
  const int pad = (a.K_loc - 1) / 2;
  const int hd = D / a.n_heads;
  const float sa_scale = rsqrtf((float)hd);

  for (int t = 0; t < S; ++t) {
    const int par = t & 1;
    float* h_att_in = g + l.h_att + par * A;
    float* h_att_out = g + l.h_att + (1 - par) * A;
    float* h1_in = g + l.h1 + par * D;
    float* h1_out = g + l.h1 + (1 - par) * D;
    float* h2_in = g + l.h2 + par * D;
    float* h2_out = g + l.h2 + (1 - par) * D;

    // ---- prenet: relu(pre-activation from the previous head), then
    // Dense + ReLU for the remaining layers
    const float* p_last = g + l.p0;
    for (int i = 0; i + 1 < a.n_pre; ++i) {
      const int n_in = a.pre_in[i];
      for (int k = tid; k < n_in; k += NT) {
        const float v = __ldcg(p_last + k);
        xin[k] = i == 0 ? fmaxf(v, 0.f) : v;
      }
      __syncthreads();
      float* pout = g + l.pbuf + (i % 2) * l.maxp;
      const float* b = sm + m.pre_b[i];
      gemv_stage<1>(a.pre_out[i], n_in, sm + m.pre[i], xin,
                    [&](int n, int s, const float* acc) {
                      pout[n] = fmaxf(acc[0] + b[s], 0.f);
                    });
      grid.sync();
      clk.mark(ST_PRENET);
      p_last = pout;
    }

    // ---- attention LSTM over [prenet, prev context, h_att]
    for (int k = tid; k < P; k += NT) {
      const float v = __ldcg(p_last + k);
      xin[k] = a.n_pre == 1 ? fmaxf(v, 0.f) : v;
    }
    stage_in(xin + P, g + l.ctx, Cctx);
    stage_in(xin + P + Cctx, h_att_in, A);
    __syncthreads();
    {
      const float* b = sm + m.att_b;
      float* c = sm + m.c_att;
      const float* hprev = xin + P + Cctx;
      const float zc = a.zc_att, zo = a.zo_att;
      gemv_stage<4>(A, Zatt, sm + m.att, xin,
                    [&](int n, int s, const float* acc) {
        const float* bs = b + 4 * s;
        float c_new, h_new;
        lstm_cell(acc[0] + bs[0], acc[1] + bs[1], acc[2] + bs[2],
                  acc[3] + bs[3], c[s], hprev[n], zc, zo, c_new, h_new);
        c[s] = c_new;
        h_att_out[n] = h_new;
      });
    }
    grid.sync();
    clk.mark(ST_ATT_LSTM);

    // ---- query projections of all sources
    stage_in(xin, h_att_out, A);
    __syncthreads();
    {
      float* pq = g + l.pq;
      gemv_stage<1>(sumU, A, sm + m.q, xin,
                    [&](int n, int, const float* acc) { pq[n] = acc[0]; });
    }
    grid.sync();
    clk.mark(ST_QUERY);

    // ---- energies: one block per (source, memory step), threads over the
    // attention units
    stage_in(sm + m.pq, g + l.pq, sumU);
    __syncthreads();
    for (int n = blockIdx.x; n < ns * T; n += gridDim.x) {
      const int src = n / T, tau = n % T;
      const int u0 = a.u_off[src], U = a.u_off[src + 1] - u0;
      const bool loc = a.kinds[src] == 2;
      const float* krow = a.keys + (size_t)tau * sumU + u0;
      const float* conv = sm + m.conv + src * T;
      float acc = 0.f;
      for (int u = tid; u < U; u += NT) {
        float pre = __ldg(krow + u) + sm[m.pq + u0 + u];
        if (loc) {
          for (int k = 0; k < a.K_loc; ++k) {
            const int j = tau + k - pad;
            if (j >= 0 && j < T)
              pre = fmaf(sm[m.loc + k * sumU + u0 + u], conv[j], pre);
          }
        }
        acc = fmaf(sm[m.v + u0 + u], tanhf(pre), acc);
      }
      acc = block_sum(acc, red);
      if (tid == 0) g[l.e + n] = acc;
    }
    grid.sync();
    clk.mark(ST_ENERGY);

    // ---- every block: masked softmax (row-max shift), forward recursion,
    // conv-input state, alignment rows; then context columns
    float* erow = sm + m.erow;
    stage_in(erow, g + l.e, ns * T);
    __syncthreads();
    if (warp < ns) {  // one warp per source: shuffles, no block barrier
      const int src = warp;
      float* er = erow + src * T;
      const float* mk = sm + m.mask + src * T;
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
      if (a.kinds[src] == 2) {
        float* al = sm + m.alpha + src * T;
        float* cv = sm + m.conv + src * T;
        float* tmp = sm + m.tmp + src * T;
        float part = 0.f;
        for (int tau = lane; tau < T; tau += 32) {
          const float p = er[tau] * inv;
          const float shifted = tau > 0 ? al[tau - 1] : 0.f;
          const float z = (0.5f * al[tau] + 0.5f * shifted + 1e-7f) * p;
          tmp[tau] = z;
          part += z;
          cv[tau] = a.cumulative[src] ? cv[tau] + p : p;
        }
        const float zinv = 1.f / warp_sum(part);
        __syncwarp();  // every lane's reads of al are done
        for (int tau = lane; tau < T; tau += 32) {
          const float z = tmp[tau] * zinv;
          al[tau] = z;
          er[tau] = z;
        }
      } else {
        for (int tau = lane; tau < T; tau += 32) er[tau] *= inv;
      }
    }
    __syncthreads();
    if (blockIdx.x == 0)
      for (int i = tid; i < ns * T; i += NT)
        a.aligns[(size_t)t * ns * T + i] = erow[i];
    {
      // one warp per context column, lanes over the memory steps
      float* ctx = g + l.ctx;
      for (int s8 = warp;; s8 += NWARPS) {
        const int c = blockIdx.x + gridDim.x * s8;
        if (c >= Cctx) break;
        int src = 0;
        while (c >= a.c_off[src + 1]) ++src;
        const float* er = erow + src * T;
        float acc = 0.f;
        for (int tau = lane; tau < T; tau += 32)
          acc = fmaf(er[tau], __ldg(a.values + (size_t)tau * Cctx + c), acc);
        acc = warp_sum(acc);
        if (lane == 0) ctx[c] = acc;
      }
    }
    grid.sync();
    clk.mark(ST_SOFTMAX_CTX);

    // ---- merged projection + lstm1 over [h_att, ctx, h1]
    stage_in(xin, h_att_out, A);
    stage_in(xin + A, g + l.ctx, Cctx);
    stage_in(xin + A + Cctx, h1_in, D);
    __syncthreads();
    {
      const float* b = sm + m.big_b;
      float* c = sm + m.c1;
      float* o1 = g + l.o1;
      const float* hprev = xin + A + Cctx;
      const float zc = a.zc_dec, zo = a.zo_dec;
      gemv_stage<5>(D, Zbig, sm + m.big, xin,
                    [&](int n, int s, const float* acc) {
        const float* bs = b + 5 * s;
        float c_new, h_new;
        lstm_cell(acc[0] + bs[0], acc[1] + bs[1], acc[2] + bs[2],
                  acc[3] + bs[3], c[s], hprev[n], zc, zo, c_new, h_new);
        c[s] = c_new;
        h1_out[n] = h_new;
        o1[n] = acc[4] + bs[4] + h_new;
      });
    }
    grid.sync();
    clk.mark(ST_PROJ_LSTM1);

    // ---- lstm2 over [o1, h2]; y = o1 + h2
    stage_in(xin, g + l.o1, D);
    stage_in(xin + D, h2_in, D);
    __syncthreads();
    {
      const float* b = sm + m.l2_b;
      float* c = sm + m.c2;
      float* y = g + l.y;
      float* ys = sm + m.y;
      const float* hprev = xin + D;
      const float zc = a.zc_dec, zo = a.zo_dec;
      gemv_stage<4>(D, 2 * D, sm + m.l2, xin,
                    [&](int n, int s, const float* acc) {
        const float* bs = b + 4 * s;
        float c_new, h_new;
        lstm_cell(acc[0] + bs[0], acc[1] + bs[1], acc[2] + bs[2],
                  acc[3] + bs[3], c[s], hprev[n], zc, zo, c_new, h_new);
        c[s] = c_new;
        h2_out[n] = h_new;
        ys[s] = y[n] = xin[n] + h_new;
      });
    }
    grid.sync();
    clk.mark(ST_LSTM2);

    // ---- causal self-attention hops over the KV caches
    for (int hop = 0; hop < a.n_hops; ++hop) {
      float* kc = g + l.kc + (size_t)hop * S * D;
      float* vc = g + l.vc + (size_t)hop * S * D;
      stage_in(xin, g + l.y, D);
      __syncthreads();
      {
        const float* b = sm + m.kvq_b[hop];
        float* q = g + l.q;
        gemv_stage<1>(3 * D, D, sm + m.kvq[hop], xin,
                      [&](int n, int s, const float* acc) {
                        const float v = acc[0] + b[s];
                        if (n < D)
                          kc[(size_t)t * D + n] = v;
                        else if (n < 2 * D)
                          vc[(size_t)t * D + n - D] = v;
                        else
                          q[n - 2 * D] = v;
                      });
      }
      grid.sync();
      clk.mark(ST_HOP_KVQ);

      // one block per (head, chunk of CHUNK cached steps): scores, the
      // chunk's max and sum of exps, and its unnormalized context
      const int nchunk = (t + CHUNK) / CHUNK;
      const int maxch = dec_max_chunks(a);
      const int groups = NT / hd > 0 ? NT / hd : 1;
      for (int item = blockIdx.x; item < a.n_heads * nchunk;
           item += gridDim.x) {
        const int hh = item / nchunk, ck = item % nchunk;
        const int tau0 = ck * CHUNK, ntau = min(CHUNK, t + 1 - tau0);
        float* es = sm + m.sc;
        stage_in(xin, g + l.q + hh * hd, hd);
        __syncthreads();
        float part[CHUNK / NWARPS];
#pragma unroll
        for (int j = 0; j < CHUNK / NWARPS; ++j) {
          const int i = warp + NWARPS * j;
          float acc = 0.f;
          if (i < ntau) {
            const float* krow = kc + (size_t)(tau0 + i) * D + hh * hd;
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
        if (warp == 0) {
          const float sc = lane < ntau ? es[lane] : -3.0e38f;
          const float mx = warp_max(sc);
          const float e = lane < ntau ? expf(sc - mx) : 0.f;
          es[lane] = e;
          const float sum = warp_sum(e);
          if (lane == 0) {
            g[l.pm + hh * maxch + ck] = mx;
            g[l.ps + hh * maxch + ck] = sum;
          }
        }
        __syncthreads();
        for (int idx = tid; idx < hd * groups; idx += NT) {
          const int col = idx % hd, grp = idx / hd;
          const float* vcol = vc + hh * hd + col;
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
          g[l.pc + (size_t)ck * D + hh * hd + col] = acc;
        }
        __syncthreads();
      }
      grid.sync();
      clk.mark(ST_HOP_ATTN);

      // combine the chunks (shift by the max over chunks), then the merged
      // output * transform dense: y += tanh(hctx @ Wot + b)
      float* cm = sm + m.cstat;
      float* cs = cm + a.n_heads * nchunk;
      for (int i = tid; i < a.n_heads * nchunk; i += NT) {
        const int hh = i / nchunk, ck = i % nchunk;
        cm[i] = __ldcg(g + l.pm + hh * maxch + ck);
        cs[i] = __ldcg(g + l.ps + hh * maxch + ck);
      }
      __syncthreads();
      for (int d = tid; d < D; d += NT) {
        const int hh = d / hd;
        const float* hm = cm + hh * nchunk;
        float mx = -3.0e38f;
        for (int ck = 0; ck < nchunk; ++ck) mx = fmaxf(mx, hm[ck]);
        float num = 0.f, den = 0.f;
#pragma unroll 4
        for (int ck = 0; ck < nchunk; ++ck) {
          const float w = expf(hm[ck] - mx);
          num = fmaf(w, __ldcg(g + l.pc + (size_t)ck * D + d), num);
          den = fmaf(w, cs[hh * nchunk + ck], den);
        }
        xin[d] = num / den;
      }
      __syncthreads();
      {
        // item n of this stage is item n of lstm2: the same block and slot
        // own y[n], so it is read from shared memory
        const float* b = sm + m.ot_b[hop];
        float* y = g + l.y;
        float* ys = sm + m.y;
        gemv_stage<1>(D, D, sm + m.ot[hop], xin,
                      [&](int n, int s, const float* acc) {
                        ys[s] = y[n] = ys[s] + tanhf(acc[0] + b[s]);
                      });
      }
      grid.sync();
      clk.mark(ST_HOP_OUT);
    }

    // ---- output + stop + next-step first-prenet pre-activation
    stage_in(xin, g + l.y, D);
    __syncthreads();
    {
      const float* b = sm + m.head_b;
      float* orow = a.out + (size_t)t * (cr + 1);
      float* p0 = g + l.p0;
      gemv_stage<1>(nhead, D, sm + m.head, xin,
                    [&](int n, int s, const float* acc) {
        const float v = acc[0] + b[s];
        if (n <= cr)
          orow[n] = v;
        else
          p0[n - cr - 1] = v;
      });
    }
    grid.sync();
    clk.mark(ST_HEAD);
    if (a.early_stop && t > a.min_iters &&
        __ldcg(a.out + (size_t)t * (cr + 1) + cr) > 0.f)
      break;
  }
}

// ------------------------------------------------------------------- host
extern "C" long long fused_decode_scratch_floats(const DecArgs* a) {
  return (long long)dec_layout(*a).total;
}

extern "C" int fused_decode_launch(const DecArgs* args, void* stream) {
  DecArgs a = *args;
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
  e = cudaFuncSetAttribute(fused_decode_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fused_decode_kernel, NT, smem)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel((void*)fused_decode_kernel, dim3(sms),
                                  dim3(NT), params, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
