// Forward of the teacher-forced training trunk in one cooperative kernel.
//
// Replaces: self_attention_tacotron_tpu/ops/fused_train.py `_fwd_kernel`
// (Pallas, reached through `_fwd_call` and `fused_teacher_scan`).
//
// What bounds it on the H100: the serial chain.  At the recipe (B = 32,
// S = 256 steps, T = 64, A = D = 256, U = 224 + 32, C = 256 + 32) a step
// multiplies 32 rows by ~1.9 M trunk weights (7.6 MB f32) in five dependent
// products, plus the attention over 2 x 32 x 64 memory rows: ~0.14 GFLOP
// a step, ~40 GFLOP with the prenet, ~0.6 ms of FP32 peak.  Streaming the
// weights from HBM every step would take ~2.3 us a step; held on chip the
// floor is the 6 dependent stages a step, each at least one grid barrier
// (~1.25 us on this card) -- ~1.9 ms for 256 steps.
//
// Design: one 256-thread block per SM, launched cooperatively, grid
// barriers between dependent stages.  Each product stage gives output
// column n (an LSTM unit: its four gate columns) to block n % 132 for the
// whole call, so every block keeps its columns of the five trunk matrices
// in shared memory (~59 KB a block at the recipe).  A stage copies its
// B input rows from global memory (L2) into shared memory, several loads
// in flight a thread; lanes run over the rows, the warps over (column,
// slice of k).  The prenet does not depend on the recurrence: it runs
// first over all S*B rows as 64 x 64 tile products.  The attention is one
// block per (source, row): energies (a warp per memory step), softmax,
// forward recursion and context.  The recurrent state lives in the save
// rows (step t reads step t - 1's row), the conv-input and alpha columns
// in scratch.  Dropout and zoneout masks come from masks.cuh.  Plain FP32
// FMA; later work: tensor cores, fewer barriers.
#include "fused_train.cuh"

constexpr int UB = 8;  // attention units a lane loads at once (32 * UB a warp)

struct FwdScratch {
  size_t cv, alpha, total;
};

__host__ __device__ inline FwdScratch fwd_scratch(const TrainArgs& a) {
  FwdScratch s;
  const size_t nbt = (size_t)a.ns * a.B * a.T;
  s.cv = 0;
  s.alpha = nbt;
  s.total = 2 * nbt;
  return s;
}

__global__ void __launch_bounds__(NT, 1) fused_train_fwd_kernel(TrainArgs a) {
  cg::grid_group grid = cg::this_grid();
  StageClock clk(a.stage_cycles);
  extern __shared__ float sm[];
  const FwdSmem m = fwd_smem(a, gridDim.x);
  const FwdScratch sc = fwd_scratch(a);
  const int B = a.B, S = a.S, T = a.T, A = a.A, D = a.D, K = a.K;
  const int sumU = tr_sumU(a), sumC = tr_sumC(a), P = tr_plast(a);
  const int Zatt = tr_zatt(a), ldz = m.ldz, W = a.save_w;
  const bool det = a.deterministic != 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gtid = blockIdx.x * NT + tid, gstride = gridDim.x * NT;
  float* zs = sm + m.zs;
  float* part = sm + m.part;
  float* save = a.save;

  // ---- resident columns, biases, energy vectors, location weights
  load_cols(sm + m.att, a.att_w, A, 4, Zatt);
  load_cols(sm + m.q, a.q_w, sumU, 1, A);
  load_cols(sm + m.op, a.op_w, D, 1, A + sumC);
  load_cols(sm + m.l1, a.l1_w, D, 4, 2 * D);
  load_cols(sm + m.l2, a.l2_w, D, 4, 2 * D);
  load_bias_slice(sm + m.att_b, a.att_b, A, 4);
  load_bias_slice(sm + m.op_b, a.op_b, D, 1);
  load_bias_slice(sm + m.l1_b, a.l1_b, D, 4);
  load_bias_slice(sm + m.l2_b, a.l2_b, D, 4);
  for (int i = tid; i < sumU; i += NT) sm[m.v + i] = __ldg(a.v + i);
  for (int i = tid; i < K * sumU; i += NT) sm[m.loc + i] = __ldg(a.loc_w + i);
  // conv inputs start at 0, forward-attention alpha at [1, 0, ...]
  for (size_t i = gtid; i < (size_t)a.ns * B * T; i += gstride) {
    a.scratch[sc.cv + i] = 0.f;
    a.scratch[sc.alpha + i] = (i % T) == 0 ? 1.f : 0.f;
  }

  // ---- prenet over all S*B rows (rows t*B + b)
  for (int li = 0; li < a.n_pre; ++li) {
    const int N = a.p_sizes[li], Kin = li == 0 ? a.cf : a.p_sizes[li - 1];
    const float* in = li == 0 ? a.teacher : save + a.off_pd[li - 1];
    const size_t ldin = li == 0 ? (size_t)a.cf : (size_t)W;
    const float* w = a.pre_w[li];
    const float* bias = a.pre_b[li];
    const bool drop = a.drop_rate > 0.f && !det && a.p_dropout[li];
    const bool spk = a.use_spk && li == 0;
    const int M = S * B, tn = (N + GT - 1) / GT;
    for (int tile = blockIdx.x; tile < tr_tiles(M, N); tile += gridDim.x) {
      gemm_tile<true, false>(
          M, N, Kin, (tile / tn) * GT, (tile % tn) * GT,
          [&](int r, int k) { return __ldcg(in + (size_t)r * ldin + k); },
          [&](int k, int n) { return __ldg(w + (size_t)k * N + n); },
          [&](int r, int n, float acc) {
            const float act = fmaxf(acc + __ldg(bias + n), 0.f);
            const int t = r / B, row = r % B;
            float pd = act;
            if (drop)
              pd = act * (mask_keep(a.seed, t, li, row, n, a.drop_rate) > 0.f
                              ? a.drop_scale : 0.f);
            if (spk) pd += __ldg(a.spk + (size_t)row * N + n);
            save[(size_t)r * W + a.off_p[li] + n] = act;
            save[(size_t)r * W + a.off_pd[li] + n] = pd;
          },
          zs);
    }
    grid.sync();
    clk.mark(F_PRENET);
  }

  const int pad = (K - 1) / 2;
  for (int t = 0; t < S; ++t) {
    float* cur = save + (size_t)t * B * W;
    const float* prev = t > 0 ? save + (size_t)(t - 1) * B * W : nullptr;
    auto pf = [&](int off) { return prev ? prev + off : nullptr; };

    // ---- attention LSTM over [pd_last, ctx_prev, h_att_prev]
    stage_rows(zs, ldz, 0, B, cur + a.off_pd[a.n_pre - 1], W, P);
    stage_rows(zs, ldz, P, B, pf(a.off_ctx), W, sumC);
    stage_rows(zs, ldz, P + sumC, B, pf(a.off_hatt), W, A);
    __syncthreads();
    rows_stage<4>(A, Zatt, B, sm + m.att, zs, ldz, part,
                  [&](int n, int s, int r, const float* acc) {
      const float* bs = sm + m.att_b + 4 * s;
      float g[4];
      for (int q = 0; q < 4; ++q) g[q] = acc[q] + bs[q];
      const float c_prev = prev ? __ldcg(prev + (size_t)r * W + a.off_catt + n)
                                : 0.f;
      const float h_prev = zs[r * ldz + P + sumC + n];
      float c, h;
      lstm_train_fwd(g, c_prev, h_prev, a.zc_att, a.zo_att,
                     zkeep(a, t, MASK_ZC_ATT, r, n, a.zc_att),
                     zkeep(a, t, MASK_ZO_ATT, r, n, a.zo_att), det, c, h);
      float* row = cur + (size_t)r * W;
      for (int q = 0; q < 4; ++q) row[a.off_gatt + q * A + n] = g[q];
      row[a.off_catt + n] = c;
      row[a.off_hatt + n] = h;
    });
    grid.sync();
    clk.mark(F_ATT_LSTM);

    // ---- query projections of all sources
    stage_rows(zs, ldz, 0, B, cur + a.off_hatt, W, A);
    __syncthreads();
    rows_stage<1>(sumU, A, B, sm + m.q, zs, ldz, part,
                  [&](int n, int, int r, const float* acc) {
                    cur[(size_t)r * W + a.off_pq + n] = acc[0];
                  });
    grid.sync();
    clk.mark(F_QUERY);

    // ---- attention: one block per (source, row): energies (a warp per
    // memory step, lanes over units), masked softmax, forward recursion,
    // conv-input state, context
    for (int item = blockIdx.x; item < a.ns * B; item += gridDim.x) {
      const int src = item / B, b = item % B;
      const int u0 = a.u_off[src], U = a.u_off[src + 1] - u0;
      const size_t col = (size_t)item * T;
      float* er = zs;            // energies, softmax, then the alignment
      float* tmp = zs + T;       // forward-recursion numerators
      float* cvs = zs + 2 * T;   // conv input of the step
      float* pqs = zs + 3 * T;   // query projection of the source
      const float* mk = a.mask + col;
      float* cv = a.scratch + sc.cv + col;
      float* al = a.scratch + sc.alpha + col;
      float* aux = a.aux + ((size_t)(t * a.ns + src) * 3) * B * T +
                   (size_t)b * T;
      const size_t plane = (size_t)B * T;
      const int kind = a.kinds[src];
      for (int i = tid; i < T; i += NT) cvs[i] = __ldcg(cv + i);
      for (int i = tid; i < U; i += NT)
        pqs[i] = __ldcg(cur + (size_t)b * W + a.off_pq + u0 + i);
      __syncthreads();
      const float* krow = a.keys[src] + (size_t)b * T * U;
      const float* vv = sm + m.v + u0;
      const float* lw = sm + m.loc + u0;
      for (int tau = warp; tau < T; tau += NWARPS) {
        float acc = 0.f;
        // UB units a lane, their key loads and tap chains side by side
        for (int ub = 0; ub < U; ub += 32 * UB) {
          float pre[UB];
#pragma unroll
          for (int i = 0; i < UB; ++i) {
            const int u = ub + lane + 32 * i;
            pre[i] = u < U ? __ldg(krow + (size_t)tau * U + u) + pqs[u] : 0.f;
          }
          if (kind != 0)
            for (int k = 0; k < K; ++k) {
              const int j = tau + k - pad;
              if (j < 0 || j >= T) continue;
              const float c = cvs[j];
              const float* lk = lw + k * sumU + ub + lane;
#pragma unroll
              for (int i = 0; i < UB; ++i)
                if (ub + lane + 32 * i < U) pre[i] = fmaf(c, lk[32 * i], pre[i]);
            }
#pragma unroll
          for (int i = 0; i < UB; ++i) {
            const int u = ub + lane + 32 * i;
            if (u < U) acc = fmaf(vv[u], tanhf(pre[i]), acc);
          }
        }
        acc = warp_sum(acc);
        if (lane == 0) er[tau] = __ldg(mk + tau) > 0.5f ? acc : -1e9f;
      }
      __syncthreads();
      if (warp == 0) {
        float mx = -3.0e38f;
        for (int tau = lane; tau < T; tau += 32) mx = fmaxf(mx, er[tau]);
        mx = warp_max(mx);
        float sum = 0.f;
        for (int tau = lane; tau < T; tau += 32) {
          const float e = expf(er[tau] - mx);
          er[tau] = e;
          sum += e;
        }
        const float inv = 1.f / warp_sum(sum);
        float zpart = 0.f;
        for (int tau = lane; tau < T; tau += 32) {
          const float p = er[tau] * inv;
          er[tau] = p;
          aux[tau] = p;
          const float cvo = cvs[tau];
          aux[2 * plane + tau] = cvo;
          if (kind != 0) cv[tau] = a.cumulative[src] ? cvo + p : p;
          if (kind == 2) {
            const float ap = __ldcg(al + tau);
            const float sh = tau > 0 ? __ldcg(al + tau - 1) : 0.f;
            const float z = (0.5f * ap + 0.5f * sh + 1e-7f) * p;
            tmp[tau] = z;
            zpart += z;
          }
        }
        if (kind == 2) {
          const float zinv = 1.f / warp_sum(zpart);
          __syncwarp();   // every lane's reads of alpha are done
          for (int tau = lane; tau < T; tau += 32) {
            const float w = tmp[tau] * zinv;
            er[tau] = w;
            al[tau] = w;
          }
        }
        __syncwarp();
        for (int tau = lane; tau < T; tau += 32) aux[plane + tau] = er[tau];
      }
      __syncthreads();
      const int c0 = a.c_off[src], C = a.c_off[src + 1] - c0;
      const float* vals = a.values[src] + (size_t)b * T * C;
      for (int c = tid; c < C; c += NT) {
        float acc = 0.f;
#pragma unroll 16
        for (int tau = 0; tau < T; ++tau)
          acc = fmaf(er[tau], __ldg(vals + (size_t)tau * C + c), acc);
        cur[(size_t)b * W + a.off_ctx + c0 + c] = acc;
      }
      __syncthreads();
    }
    grid.sync();
    clk.mark(F_ATTENTION);

    // ---- output projection over [h_att, ctx]
    stage_rows(zs, ldz, 0, B, cur + a.off_hatt, W, A);
    stage_rows(zs, ldz, A, B, cur + a.off_ctx, W, sumC);
    __syncthreads();
    rows_stage<1>(D, A + sumC, B, sm + m.op, zs, ldz, part,
                  [&](int n, int s, int r, const float* acc) {
                    cur[(size_t)r * W + a.off_proj + n] =
                        acc[0] + sm[m.op_b + s];
                  });
    grid.sync();
    clk.mark(F_PROJ);

    // ---- lstm1 over [proj, h1_prev]; o1 = proj + h1
    stage_rows(zs, ldz, 0, B, cur + a.off_proj, W, D);
    stage_rows(zs, ldz, D, B, pf(a.off_h1), W, D);
    __syncthreads();
    rows_stage<4>(D, 2 * D, B, sm + m.l1, zs, ldz, part,
                  [&](int n, int s, int r, const float* acc) {
      const float* bs = sm + m.l1_b + 4 * s;
      float g[4];
      for (int q = 0; q < 4; ++q) g[q] = acc[q] + bs[q];
      const float c_prev = prev ? __ldcg(prev + (size_t)r * W + a.off_c1 + n)
                                : 0.f;
      float c, h;
      lstm_train_fwd(g, c_prev, zs[r * ldz + D + n], a.zc_dec, a.zo_dec,
                     zkeep(a, t, MASK_ZC1, r, n, a.zc_dec),
                     zkeep(a, t, MASK_ZO1, r, n, a.zo_dec), det, c, h);
      float* row = cur + (size_t)r * W;
      for (int q = 0; q < 4; ++q) row[a.off_g1 + q * D + n] = g[q];
      row[a.off_c1 + n] = c;
      row[a.off_h1 + n] = h;
      row[a.off_o1 + n] = zs[r * ldz + n] + h;
    });
    grid.sync();
    clk.mark(F_LSTM1);

    // ---- lstm2 over [o1, h2_prev]; y = o1 + h2
    stage_rows(zs, ldz, 0, B, cur + a.off_o1, W, D);
    stage_rows(zs, ldz, D, B, pf(a.off_h2), W, D);
    __syncthreads();
    rows_stage<4>(D, 2 * D, B, sm + m.l2, zs, ldz, part,
                  [&](int n, int s, int r, const float* acc) {
      const float* bs = sm + m.l2_b + 4 * s;
      float g[4];
      for (int q = 0; q < 4; ++q) g[q] = acc[q] + bs[q];
      const float c_prev = prev ? __ldcg(prev + (size_t)r * W + a.off_c2 + n)
                                : 0.f;
      float c, h;
      lstm_train_fwd(g, c_prev, zs[r * ldz + D + n], a.zc_dec, a.zo_dec,
                     zkeep(a, t, MASK_ZC2, r, n, a.zc_dec),
                     zkeep(a, t, MASK_ZO2, r, n, a.zo_dec), det, c, h);
      float* row = cur + (size_t)r * W;
      for (int q = 0; q < 4; ++q) row[a.off_g2 + q * D + n] = g[q];
      row[a.off_c2 + n] = c;
      row[a.off_h2 + n] = h;
      a.y[((size_t)t * B + r) * D + n] = zs[r * ldz + n] + h;
    });
    grid.sync();
    clk.mark(F_LSTM2);
  }
}

// ------------------------------------------------------------------- host
extern "C" long long fused_train_fwd_scratch_floats(const TrainArgs* a) {
  return (long long)fwd_scratch(*a).total;
}

extern "C" long long fused_train_fwd_smem_bytes(const TrainArgs* a, int nb) {
  return (long long)(fwd_smem(*a, nb).total * sizeof(float));
}

extern "C" int fused_train_fwd_launch(const TrainArgs* args, void* stream) {
  int sms = 0, e = tr_sms(&sms);
  if (e) return e;
  return tr_launch(fused_train_fwd_kernel, *args, fwd_smem(*args, sms).total,
                   sms, stream);
}
