// Backward of the teacher-forced training trunk in one cooperative kernel.
//
// Replaces: self_attention_tacotron_tpu/ops/fused_train.py `_bwd_kernel`
// (with `_lstm_bwd`; Pallas, reached through `_bwd_call` and `_core_bwd`).
//
// What bounds it on the H100: two parts.  The reverse-time chain is serial:
// per step the three LSTM VJPs, the projection and the attention VJP, each
// product a multiply by W^T over 32 rows, separated by 7 grid barriers
// (~2.2 ms of barriers for 256 steps).  The weight gradients are parallel:
// contractions of depth S*B = 8192 over every trunk and prenet matrix.
// In all ~75 GFLOP at the recipe, ~1.1 ms of FP32 peak.
//
// Design: one 256-thread block per SM, launched cooperatively.  The serial
// products multiply by W^T, so this kernel keeps ROWS of each (in, out)
// matrix resident (block n % 132 owns input row n: the row-partitioned
// copy, ~55 KB a block), the forward kernel keeps columns.  Per step:
// lstm2 VJP (elementwise) | d z2 = d_gates2 W2^T, whose epilogue runs the
// lstm1 VJP of the same unit | d z1 | d zop | attention VJP, one block per
// (source, row): the context and recursion VJPs on one warp, then a thread
// per unit recomputes the energies from the saved query and conv input
// and writes d_pre (T x U) to shared memory with d_keys / d_pq / d_v;
// d_loc (a thread per unit) and d_win (a warp per memory step) read that
// tile; the conv adjoint is a gather | d h_att via Wq^T, whose epilogue
// runs the attention-LSTM VJP | d z_att over the [ctx | h_att] rows of
// W_att (the prenet rows are deferred).  Each step's cotangents go to a
// stash; after the loop 64 x 64 tile products contract stash and save rows
// into the weight gradients (biases as a column of ones), then the
// deferred prenet backward runs layer by layer over all S*B rows.  Masks
// are regenerated from masks.cuh.  Plain FP32 FMA; later work: tensor
// cores, fewer barriers, split-K for the weight gradients.
#include "fused_train.cuh"

struct BwdScratch {
  size_t dc_att, dh_att, dc1, dh1, dc2, dh2, dctx, dA, dCV, dh2_zo, d_o1,
      dh1_zo, dhatt_part, dctx_tot, dhatt_zo, dv_part, dloc_part, state_end,
      bufA, bufB, total;
};

__host__ __device__ inline BwdScratch bwd_scratch(const TrainArgs& a) {
  const size_t B = a.B, A = a.A, D = a.D, C = tr_sumC(a), U = tr_sumU(a);
  const size_t nbt = (size_t)a.ns * a.B * a.T;
  int pmax = 0;
  for (int i = 0; i < a.n_pre; ++i) pmax = tr_max(pmax, a.p_sizes[i]);
  BwdScratch s;
  size_t o = 0;
  s.dc_att = o; o += B * A;
  s.dh_att = o; o += B * A;
  s.dc1 = o; o += B * D;
  s.dh1 = o; o += B * D;
  s.dc2 = o; o += B * D;
  s.dh2 = o; o += B * D;
  s.dctx = o; o += B * C;
  s.dA = o; o += nbt;
  s.dCV = o; o += nbt;
  s.dh2_zo = o; o += B * D;
  s.d_o1 = o; o += B * D;
  s.dh1_zo = o; o += B * D;
  s.dhatt_part = o; o += B * A;
  s.dctx_tot = o; o += B * C;
  s.dhatt_zo = o; o += B * A;
  s.dv_part = o; o += B * U;
  s.dloc_part = o; o += B * a.K * U;
  s.state_end = o;
  s.bufA = o; o += (size_t)a.S * B * pmax;
  s.bufB = o; o += (size_t)a.S * B * pmax;
  s.total = o;
  return s;
}

// The attention VJP of one (source, row) at step t; see
// fused_train_bwd_reference in ops/fused_train.py for the same math.
// Global read-modify-writes (d_values, d_keys) go in chunks of RB memory
// steps, their loads issued together.
constexpr int RB = 8;

__device__ void attention_vjp(const TrainArgs& a, const BwdSmem& m,
                              const BwdScratch& sc, float* sm, int t,
                              int src, int b) {
  const int B = a.B, T = a.T, K = a.K, W = a.save_w, sumU = tr_sumU(a);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int u0 = a.u_off[src], U = a.u_off[src + 1] - u0;
  const int c0 = a.c_off[src], C = a.c_off[src + 1] - c0;
  const int kind = a.kinds[src], pad = (K - 1) / 2;
  float* g = a.scratch;
  float* dctx = sm + m.zs;
  float* ar = dctx + C;      // softmax
  float* wr = ar + T;        // alignment
  float* cvr = wr + T;       // conv input of the step
  float* apr = cvr + T;      // previous alpha
  float* da = apr + T;       // d_w, then d_a
  float* de = da + T;        // d_e
  float* ds = de + T;        // d_s
  float* dwin = ds + T;      // (T, K)
  float* dpre = dwin + T * K;  // (T, U) d of the energies' tanh inputs
  const size_t plane = (size_t)B * T;
  const float* aux = a.aux + ((size_t)(t * a.ns + src) * 3) * plane +
                     (size_t)b * T;
  const float* auxp = t > 0 ? a.aux + ((size_t)((t - 1) * a.ns + src) * 3 + 1)
                                      * plane + (size_t)b * T
                            : nullptr;
  const size_t col = (size_t)(src * B + b) * T;
  for (int c = tid; c < C; c += NT)
    dctx[c] = __ldcg(g + sc.dctx_tot + (size_t)b * tr_sumC(a) + c0 + c);
  for (int tau = tid; tau < T; tau += NT) {
    ar[tau] = __ldg(aux + tau);
    wr[tau] = __ldg(aux + plane + tau);
    cvr[tau] = __ldg(aux + 2 * plane + tau);
    apr[tau] = auxp ? __ldg(auxp + tau) : (tau == 0 ? 1.f : 0.f);
  }
  __syncthreads();
  // d_values += w d_ctx; d_w = values . d_ctx (a warp per memory step)
  const float* vals = a.values[src] + (size_t)b * T * C;
  float* dvals = a.d_values[src] + (size_t)b * T * C;
  for (int c = tid; c < C; c += NT) {
    const float dc = dctx[c];
    for (int t0 = 0; t0 < T; t0 += RB) {
      float old[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i)
        if (t0 + i < T) old[i] = dvals[(size_t)(t0 + i) * C + c];
#pragma unroll
      for (int i = 0; i < RB; ++i)
        if (t0 + i < T)
          dvals[(size_t)(t0 + i) * C + c] = fmaf(wr[t0 + i], dc, old[i]);
    }
  }
  for (int tau = warp; tau < T; tau += NWARPS) {
    float acc = 0.f;
    for (int cb = 0; cb < C; cb += 32 * RB) {   // RB loads in flight
      float x[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int c = cb + lane + 32 * i;
        x[i] = c < C ? __ldg(vals + (size_t)tau * C + c) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int c = cb + lane + 32 * i;
        if (c < C) acc = fmaf(dctx[c], x[i], acc);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) da[tau] = acc;
  }
  __syncthreads();
  // recursion and softmax VJPs (one warp)
  if (warp == 0) {
    float* dA = g + sc.dA + col;
    float* dCV = g + sc.dCV + col;
    if (kind == 2) {
      float sa = 0.f, zs = 0.f;
      for (int tau = lane; tau < T; tau += 32) {
        const float dal = da[tau] + __ldcg(dA + tau);
        da[tau] = dal;
        sa += dal * wr[tau];
        const float s = 0.5f * apr[tau] + 0.5f * (tau > 0 ? apr[tau - 1] : 0.f)
                        + 1e-7f;
        ds[tau] = s;
        zs += s * ar[tau];
      }
      sa = warp_sum(sa);
      const float zinv = 1.f / warp_sum(zs);
      __syncwarp();
      for (int tau = lane; tau < T; tau += 32) {
        const float dz = (da[tau] - sa) * zinv;
        const float s = ds[tau];
        da[tau] = dz * s + __ldcg(dCV + tau);
        ds[tau] = dz * ar[tau];
      }
      __syncwarp();
      for (int tau = lane; tau < T; tau += 32)
        dA[tau] = 0.5f * ds[tau] + 0.5f * (tau + 1 < T ? ds[tau + 1] : 0.f);
    } else if (kind == 1) {
      for (int tau = lane; tau < T; tau += 32) da[tau] += __ldcg(dCV + tau);
    }
    __syncwarp();
    float sab = 0.f;
    for (int tau = lane; tau < T; tau += 32) sab += ar[tau] * da[tau];
    sab = warp_sum(sab);
    for (int tau = lane; tau < T; tau += 32)
      de[tau] = ar[tau] * (da[tau] - sab);
  }
  __syncthreads();
  // d_pre = d_e v (1 - e^2) with the energies recomputed from the saved
  // query projection and conv input; d_keys, d_pq, d_v: a thread per unit
  const float* keys = a.keys[src] + (size_t)b * T * U;
  const float* pq = a.save + ((size_t)t * B + b) * W + a.off_pq + u0;
  const float* v = sm + m.v + u0;
  const float* locw = sm + m.loc + u0;
  float* dkeys = a.d_keys[src] + (size_t)b * T * U;
  float* dvp = g + sc.dv_part + (size_t)b * sumU + u0;
  float* dlp = g + sc.dloc_part + (size_t)b * K * sumU + u0;
  float* stash_pq = a.stash + ((size_t)t * B + b) * a.stash_w + a.off_dpq + u0;
  for (int u = tid; u < U; u += NT) {
    float dpq = 0.f, dv = 0.f;
    const float vu = v[u], pqu = __ldg(pq + u);
    for (int t0 = 0; t0 < T; t0 += RB) {   // RB memory steps side by side
      float pre[RB], old[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i)
        if (t0 + i < T) {
          pre[i] = __ldg(keys + (size_t)(t0 + i) * U + u) + pqu;
          old[i] = dkeys[(size_t)(t0 + i) * U + u];
        }
      if (kind != 0)
        for (int k = 0; k < K; ++k) {
          const float lwk = locw[k * sumU + u];
#pragma unroll
          for (int i = 0; i < RB; ++i) {
            const int j = t0 + i + k - pad;
            if (t0 + i < T && j >= 0 && j < T)
              pre[i] = fmaf(cvr[j], lwk, pre[i]);
          }
        }
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int tau = t0 + i;
        if (tau >= T) break;
        const float e = tanhf(pre[i]);
        const float dp = de[tau] * vu * (1.f - e * e);
        dkeys[(size_t)tau * U + u] = old[i] + dp;
        dpre[tau * U + u] = dp;
        dpq += dp;
        dv = fmaf(e, de[tau], dv);
      }
    }
    stash_pq[u] = dpq;
    dvp[u] += dv;
  }
  __syncthreads();
  if (kind != 0) {
    // d_loc[k][u] += sum_tau cv[tau + k - pad] d_pre[tau][u]: a thread per
    // unit, RB taps side by side
    for (int u = tid; u < U; u += NT)
      for (int k0 = 0; k0 < K; k0 += RB) {
        float acc[RB];
#pragma unroll
        for (int i = 0; i < RB; ++i) acc[i] = 0.f;
        for (int tau = 0; tau < T; ++tau) {
          const float dp = dpre[tau * U + u];
#pragma unroll
          for (int i = 0; i < RB; ++i) {
            const int j = tau + k0 + i - pad;
            if (k0 + i < K && j >= 0 && j < T) acc[i] = fmaf(cvr[j], dp, acc[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < RB; ++i)
          if (k0 + i < K) dlp[(size_t)(k0 + i) * sumU + u] += acc[i];
      }
    // d_win[tau][k] = sum_u d_pre[tau][u] loc_w[k][u]: a warp per memory
    // step, RB taps side by side
    for (int tau = warp; tau < T; tau += NWARPS)
      for (int k0 = 0; k0 < K; k0 += RB) {
        float acc[RB];
#pragma unroll
        for (int i = 0; i < RB; ++i) acc[i] = 0.f;
        for (int u = lane; u < U; u += 32) {
          const float d = dpre[tau * U + u];
#pragma unroll
          for (int i = 0; i < RB; ++i)
            if (k0 + i < K) acc[i] = fmaf(d, locw[(k0 + i) * sumU + u], acc[i]);
        }
#pragma unroll
        for (int i = 0; i < RB; ++i)
          if (k0 + i < K) {
            const float sum = warp_sum(acc[i]);
            if (lane == 0) dwin[tau * K + k0 + i] = sum;
          }
      }
  }
  __syncthreads();
  // conv adjoint: d_cv[j] = sum_k d_win[j - k + pad][k]
  if (kind != 0) {
    float* dCV = g + sc.dCV + col;
    for (int j = tid; j < T; j += NT) {
      float acc = 0.f;
      for (int k = 0; k < K; ++k) {
        const int tau = j - k + pad;
        if (tau >= 0 && tau < T) acc += dwin[tau * K + k];
      }
      dCV[j] = a.cumulative[src] ? acc + __ldcg(dCV + j) : acc;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NT, 1) fused_train_bwd_kernel(TrainArgs a) {
  cg::grid_group grid = cg::this_grid();
  StageClock clk(a.stage_cycles);
  extern __shared__ float sm[];
  const BwdSmem m = bwd_smem(a, gridDim.x);
  const BwdScratch sc = bwd_scratch(a);
  const int B = a.B, S = a.S, T = a.T, A = a.A, D = a.D, K = a.K;
  const int sumU = tr_sumU(a), sumC = tr_sumC(a), P = tr_plast(a);
  const int Zatt = tr_zatt(a), ldz = m.ldz, W = a.save_w, WS = a.stash_w;
  const bool det = a.deterministic != 0;
  const int tid = threadIdx.x;
  const int gtid = blockIdx.x * NT + tid, gstride = gridDim.x * NT;
  float* zs = sm + m.zs;
  float* part = sm + m.part;
  float* g = a.scratch;
  const float* save = a.save;

  // ---- resident rows of the (in, out) matrices
  load_rows(sm + m.w2, a.l2_w, 2 * D, 4 * D);
  load_rows(sm + m.w1, a.l1_w, 2 * D, 4 * D);
  load_rows(sm + m.wop, a.op_w, A + sumC, D);
  load_rows(sm + m.wq, a.q_w, A, sumU);
  load_rows(sm + m.watt, a.att_w + (size_t)P * 4 * A, sumC + A, 4 * A);
  for (int i = tid; i < sumU; i += NT) sm[m.v + i] = __ldg(a.v + i);
  for (int i = tid; i < K * sumU; i += NT) sm[m.loc + i] = __ldg(a.loc_w + i);
  for (size_t i = gtid; i < sc.state_end; i += gstride) g[i] = 0.f;
  for (int s = 0; s < a.ns; ++s) {
    const size_t nk = (size_t)B * T * (a.u_off[s + 1] - a.u_off[s]);
    const size_t nv = (size_t)B * T * (a.c_off[s + 1] - a.c_off[s]);
    for (size_t i = gtid; i < nk; i += gstride) a.d_keys[s][i] = 0.f;
    for (size_t i = gtid; i < nv; i += gstride) a.d_values[s][i] = 0.f;
  }
  grid.sync();
  clk.mark(B_SETUP);

  for (int t = S - 1; t >= 0; --t) {
    const float* cur = save + (size_t)t * B * W;
    const float* prev = t > 0 ? save + (size_t)(t - 1) * B * W : nullptr;
    float* st = a.stash + (size_t)t * B * WS;
    const float* gy = a.g_y + (size_t)t * B * D;

    // ---- lstm2 VJP, elementwise over (row, unit)
    for (int e = gtid; e < B * D; e += gstride) {
      const int r = e / D, j = e % D;
      float gt[4], dg[4], dcp, dhp;
      for (int q = 0; q < 4; ++q)
        gt[q] = __ldg(cur + (size_t)r * W + a.off_g2 + q * D + j);
      const float c_prev = prev ? __ldg(prev + (size_t)r * W + a.off_c2 + j)
                                : 0.f;
      lstm_train_bwd(gt, c_prev, __ldg(gy + e) + __ldcg(g + sc.dh2 + e),
                     __ldcg(g + sc.dc2 + e), a.zc_dec, a.zo_dec,
                     zkeep(a, t, MASK_ZC2, r, j, a.zc_dec),
                     zkeep(a, t, MASK_ZO2, r, j, a.zo_dec), det, dg, dcp,
                     dhp);
      for (int q = 0; q < 4; ++q)
        st[(size_t)r * WS + a.off_dg2 + q * D + j] = dg[q];
      g[sc.dc2 + e] = dcp;
      g[sc.dh2_zo + e] = dhp;
    }
    grid.sync();
    clk.mark(B_LSTM2);

    // ---- d z2 = d_gates2 W2^T; its epilogue runs the lstm1 VJP
    stage_rows(zs, ldz, 0, B, st + a.off_dg2, WS, 4 * D);
    __syncthreads();
    rows_stage<1>(2 * D, 4 * D, B, sm + m.w2, zs, ldz, part,
                  [&](int n, int, int r, const float* acc) {
      if (n >= D) {
        const size_t e = (size_t)r * D + n - D;
        g[sc.dh2 + e] = __ldcg(g + sc.dh2_zo + e) + acc[0];
        return;
      }
      const size_t e = (size_t)r * D + n;
      const float d_o1 = __ldg(gy + e) + acc[0];
      g[sc.d_o1 + e] = d_o1;
      float gt[4], dg[4], dcp, dhp;
      for (int q = 0; q < 4; ++q)
        gt[q] = __ldg(cur + (size_t)r * W + a.off_g1 + q * D + n);
      const float c_prev = prev ? __ldg(prev + (size_t)r * W + a.off_c1 + n)
                                : 0.f;
      lstm_train_bwd(gt, c_prev, d_o1 + __ldcg(g + sc.dh1 + e),
                     __ldcg(g + sc.dc1 + e), a.zc_dec, a.zo_dec,
                     zkeep(a, t, MASK_ZC1, r, n, a.zc_dec),
                     zkeep(a, t, MASK_ZO1, r, n, a.zo_dec), det, dg, dcp,
                     dhp);
      for (int q = 0; q < 4; ++q)
        st[(size_t)r * WS + a.off_dg1 + q * D + n] = dg[q];
      g[sc.dc1 + e] = dcp;
      g[sc.dh1_zo + e] = dhp;
    });
    grid.sync();
    clk.mark(B_DZ2_LSTM1);

    // ---- d z1 = d_gates1 W1^T -> d_proj, d h1
    stage_rows(zs, ldz, 0, B, st + a.off_dg1, WS, 4 * D);
    __syncthreads();
    rows_stage<1>(2 * D, 4 * D, B, sm + m.w1, zs, ldz, part,
                  [&](int n, int, int r, const float* acc) {
      if (n < D) {
        st[(size_t)r * WS + a.off_dproj + n] =
            __ldcg(g + sc.d_o1 + (size_t)r * D + n) + acc[0];
      } else {
        const size_t e = (size_t)r * D + n - D;
        g[sc.dh1 + e] = __ldcg(g + sc.dh1_zo + e) + acc[0];
      }
    });
    grid.sync();
    clk.mark(B_DZ1);

    // ---- d zop = d_proj Wop^T -> d h_att (part), d ctx
    stage_rows(zs, ldz, 0, B, st + a.off_dproj, WS, D);
    __syncthreads();
    rows_stage<1>(A + sumC, D, B, sm + m.wop, zs, ldz, part,
                  [&](int n, int, int r, const float* acc) {
      if (n < A) {
        g[sc.dhatt_part + (size_t)r * A + n] = acc[0];
      } else {
        const size_t e = (size_t)r * sumC + n - A;
        g[sc.dctx_tot + e] = acc[0] + __ldcg(g + sc.dctx + e);
      }
    });
    grid.sync();
    clk.mark(B_DZOP);

    // ---- attention VJP, one block per (source, row)
    for (int item = blockIdx.x; item < a.ns * B; item += gridDim.x)
      attention_vjp(a, m, sc, sm, t, item / B, item % B);
    grid.sync();
    clk.mark(B_ATTENTION);

    // ---- d h_att += d_pq Wq^T; its epilogue runs the attention-LSTM VJP
    stage_rows(zs, ldz, 0, B, st + a.off_dpq, WS, sumU);
    __syncthreads();
    rows_stage<1>(A, sumU, B, sm + m.wq, zs, ldz, part,
                  [&](int n, int, int r, const float* acc) {
      const size_t e = (size_t)r * A + n;
      float gt[4], dg[4], dcp, dhp;
      for (int q = 0; q < 4; ++q)
        gt[q] = __ldg(cur + (size_t)r * W + a.off_gatt + q * A + n);
      const float c_prev = prev ? __ldg(prev + (size_t)r * W + a.off_catt + n)
                                : 0.f;
      const float dh = __ldcg(g + sc.dhatt_part + e) + acc[0] +
                       __ldcg(g + sc.dh_att + e);
      lstm_train_bwd(gt, c_prev, dh, __ldcg(g + sc.dc_att + e), a.zc_att,
                     a.zo_att, zkeep(a, t, MASK_ZC_ATT, r, n, a.zc_att),
                     zkeep(a, t, MASK_ZO_ATT, r, n, a.zo_att), det, dg, dcp,
                     dhp);
      for (int q = 0; q < 4; ++q)
        st[(size_t)r * WS + a.off_dgatt + q * A + n] = dg[q];
      g[sc.dc_att + e] = dcp;
      g[sc.dhatt_zo + e] = dhp;
    });
    grid.sync();
    clk.mark(B_DQ_ATT_LSTM);

    // ---- d z_att over the [ctx | h_att] rows of W_att
    stage_rows(zs, ldz, 0, B, st + a.off_dgatt, WS, 4 * A);
    __syncthreads();
    rows_stage<1>(sumC + A, 4 * A, B, sm + m.watt, zs, ldz, part,
                  [&](int n, int, int r, const float* acc) {
      if (n < sumC) {
        g[sc.dctx + (size_t)r * sumC + n] = acc[0];
      } else {
        const size_t e = (size_t)r * A + n - sumC;
        g[sc.dh_att + e] = __ldcg(g + sc.dhatt_zo + e) + acc[0];
      }
    });
    grid.sync();
    clk.mark(B_DZATT);
  }

  // ---- weight gradients over all S*B rows, and d_v, d_loc
  const int M = S * B;
  const float* st = a.stash;
  SegLoad l_att{3, Zatt, {0, P, P + sumC, Zatt},
                {save + a.off_pd[a.n_pre - 1], save + a.off_ctx,
                 save + a.off_hatt},
                {(size_t)W, (size_t)W, (size_t)W}, {0, -B, -B}};
  SegLoad l_1{2, 2 * D, {0, D, 2 * D, 0}, {save + a.off_proj, save + a.off_h1,
                                           nullptr},
              {(size_t)W, (size_t)W, 0}, {0, -B, 0}};
  SegLoad l_2{2, 2 * D, {0, D, 2 * D, 0}, {save + a.off_o1, save + a.off_h2,
                                           nullptr},
              {(size_t)W, (size_t)W, 0}, {0, -B, 0}};
  SegLoad l_op{2, A + sumC, {0, A, A + sumC, 0},
               {save + a.off_hatt, save + a.off_ctx, nullptr},
               {(size_t)W, (size_t)W, 0}, {0, 0, 0}};
  SegLoad l_q{1, A, {0, A, 0, 0}, {save + a.off_hatt, nullptr, nullptr},
              {(size_t)W, 0, 0}, {0, 0, 0}};
  float* bufA = g + sc.bufA;
  float* bufB = g + sc.bufB;
  {
    // jobs: dW_att, dW_l1, dW_l2, dW_op, dW_q, d_out = d_gatt W_att[:P]^T
    const int cnt[6] = {tr_tiles(Zatt + 1, 4 * A), tr_tiles(2 * D + 1, 4 * D),
                        tr_tiles(2 * D + 1, 4 * D), tr_tiles(A + sumC + 1, D),
                        tr_tiles(A, sumU), tr_tiles(M, P)};
    int total = 0;
    for (int j = 0; j < 6; ++j) total += cnt[j];
    for (int item = blockIdx.x; item < total; item += gridDim.x) {
      int job = 0, loc = item;
      while (loc >= cnt[job]) loc -= cnt[job++];
      auto dw = [&](const SegLoad& L, int Mo, int N, int off_r, float* out) {
        const int tn = (N + GT - 1) / GT;
        gemm_tile<false, false>(
            Mo, N, M, (loc / tn) * GT, (loc % tn) * GT,
            [&](int mm, int k) { return L(k, mm); },
            [&](int k, int n) {
              return __ldcg(st + (size_t)k * WS + off_r + n);
            },
            [&](int mm, int n, float v) { out[(size_t)mm * N + n] = v; }, zs);
      };
      switch (job) {
        case 0: dw(l_att, Zatt + 1, 4 * A, a.off_dgatt, a.d_att); break;
        case 1: dw(l_1, 2 * D + 1, 4 * D, a.off_dg1, a.d_l1); break;
        case 2: dw(l_2, 2 * D + 1, 4 * D, a.off_dg2, a.d_l2); break;
        case 3: dw(l_op, A + sumC + 1, D, a.off_dproj, a.d_op); break;
        case 4: dw(l_q, A, sumU, a.off_dpq, a.d_q); break;
        default: {
          const int tn = (P + GT - 1) / GT;
          const float* watt = a.att_w;
          gemm_tile<true, true>(
              M, P, 4 * A, (loc / tn) * GT, (loc % tn) * GT,
              [&](int r, int k) {
                return __ldcg(st + (size_t)r * WS + a.off_dgatt + k);
              },
              [&](int k, int n) { return __ldg(watt + (size_t)n * 4 * A + k); },
              [&](int r, int n, float v) { bufA[(size_t)r * P + n] = v; },
              zs);
        }
      }
    }
    for (int e = gtid; e < sumU; e += gstride) {
      float acc = 0.f;
      for (int b = 0; b < B; ++b) acc += __ldcg(g + sc.dv_part + b * sumU + e);
      a.d_v[e] = acc;
    }
    for (int e = gtid; e < K * sumU; e += gstride) {
      float acc = 0.f;
      for (int b = 0; b < B; ++b)
        acc += __ldcg(g + sc.dloc_part + (size_t)b * K * sumU + e);
      a.d_loc[e] = acc;
    }
  }
  grid.sync();
  clk.mark(B_DW);

  // ---- the deferred prenet backward, last layer first; bufA holds the
  // cotangent of layer li's output
  for (int li = a.n_pre - 1; li >= 0; --li) {
    const int N = a.p_sizes[li];
    const bool drop = a.drop_rate > 0.f && !det && a.p_dropout[li];
    if (a.use_spk && li == 0)
      for (int e = gtid; e < B * N; e += gstride) {
        float acc = 0.f;
        for (int t = 0; t < S; ++t) acc += __ldcg(bufA + (size_t)t * B * N + e);
        a.d_spk[e] = acc;
      }
    for (size_t e = gtid; e < (size_t)M * N; e += gstride) {
      const int r = (int)(e / N), n = (int)(e % N);
      const float act = __ldg(save + (size_t)r * W + a.off_p[li] + n);
      float mr = act > 0.f ? 1.f : 0.f;
      if (drop)
        mr *= mask_keep(a.seed, r / B, li, r % B, n, a.drop_rate) > 0.f
                  ? a.drop_scale : 0.f;
      bufB[e] = __ldcg(bufA + e) * mr;
    }
    grid.sync();
    const int Kin = li == 0 ? a.cf : a.p_sizes[li - 1];
    SegLoad lp{1, Kin, {0, Kin, 0, 0},
               {li == 0 ? a.teacher : save + a.off_pd[li - 1], nullptr,
                nullptr},
               {li == 0 ? (size_t)a.cf : (size_t)W, 0, 0}, {0, 0, 0}};
    const int cw = tr_tiles(Kin + 1, N);
    const int cx = li > 0 ? tr_tiles(M, Kin) : 0;
    float* dwo = a.d_pre_w[li];
    const float* wl = a.pre_w[li];
    for (int item = blockIdx.x; item < cw + cx; item += gridDim.x) {
      if (item < cw) {
        const int tn = (N + GT - 1) / GT;
        gemm_tile<false, false>(
            Kin + 1, N, M, (item / tn) * GT, (item % tn) * GT,
            [&](int mm, int k) { return lp(k, mm); },
            [&](int k, int n) { return __ldcg(bufB + (size_t)k * N + n); },
            [&](int mm, int n, float v) { dwo[(size_t)mm * N + n] = v; }, zs);
      } else {
        const int loc = item - cw, tn = (Kin + GT - 1) / GT;
        gemm_tile<true, true>(
            M, Kin, N, (loc / tn) * GT, (loc % tn) * GT,
            [&](int r, int k) { return __ldcg(bufB + (size_t)r * N + k); },
            [&](int k, int n) { return __ldg(wl + (size_t)n * N + k); },
            [&](int r, int n, float v) { bufA[(size_t)r * Kin + n] = v; }, zs);
      }
    }
    grid.sync();
    clk.mark(B_PRENET);
  }
}

// ------------------------------------------------------------------- host
extern "C" long long fused_train_bwd_scratch_floats(const TrainArgs* a) {
  return (long long)bwd_scratch(*a).total;
}

extern "C" long long fused_train_bwd_smem_bytes(const TrainArgs* a, int nb) {
  return (long long)(bwd_smem(*a, nb).total * sizeof(float));
}

extern "C" int fused_train_bwd_launch(const TrainArgs* args, void* stream) {
  int sms = 0, e = tr_sms(&sms);
  if (e) return e;
  return tr_launch(fused_train_bwd_kernel, *args, bwd_smem(*args, sms).total,
                   sms, stream);
}
