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
// floor is the 7 dependent stages a step, each at least one grid barrier
// (~1.1 us on this card) and one L2 round trip for its inputs -- ~4 ms for
// 256 steps.
//
// Design: one 256-thread block per SM, launched cooperatively, the
// hand-written GridBarrier (common.cuh) between dependent stages.  The
// product stages split the 32 rows into two groups of 16: a block serves
// one group and owns output columns n (an LSTM unit: its four gate
// columns) with n % 66 == its index, keeping its columns of the five trunk
// matrices in shared memory (~122 KB a block at the recipe).  A stage has
// the TMA copy its group's input rows from L2 into shared memory (one bulk
// copy a row segment, completing on an mbarrier), then multiplies them by
// the resident columns on the tensor cores (rows_mma: mma.sync TF32 in the
// 3xTF32 split, f32 accuracy; the rows are the M dimension); the LSTM
// epilogues run a (unit, row) on four lanes, one gate each, with the cell
// states kept in shared memory from step to step.  Rows that are final a
// stage or more before they are needed (the next step's attention-LSTM
// inputs, h1 and h2 of the previous step) are copied into a second buffer
// while other stages run.  The prenet does not depend on the recurrence:
// it runs first over all S*B rows as 128 x 64 tile products on the tensor
// cores.  The attention takes two stages, each spread over (source, row,
// slice) items of about equal cost, two at a time on the two half blocks:
// the energies (items of 32 units: the location term as a small product on
// the tensor cores, keys + query, tanh, v dot, a partial energy per memory
// step), then the softmax, forward recursion and context (items of 64
// value columns, each recomputing its pair's softmax from the partials).
// The recurrent state lives in the save rows (step t reads step t - 1's
// row), the conv-input and alpha columns in scratch (alpha in two buffers
// by step parity).  Dropout and zoneout masks come from masks.cuh.  The
// bf16 storage mode (fused_train.cuh) changes only the products: the
// resident slices as bf16 pairs, rows_mma and the prenet's tiles on
// bf16 tensor cores; the save rows, the recurrent state and the attention
// stay f32, as the JAX kernel keeps its state (its bf16 save rows are the
// backward's reading of these).
#include "fused_train.cuh"

struct FwdScratch {  // offsets in floats (32 bits, as FwdSmem's)
  unsigned cv, alpha, epart, total;
};

__host__ __device__ inline FwdScratch fwd_scratch(const TrainArgs& a) {
  FwdScratch s;
  const size_t nbt = (size_t)a.ns * a.B * a.T;
  s.cv = 0;
  s.alpha = nbt;       // two buffers: step t reads alpha[t % 2]
  s.epart = 3 * nbt;   // (ns, B, max unit slices, T) partial energies
  s.total = s.epart + nbt * tr_max_uslices(a);
  return s;
}

// Partial energies of one (source, row, 32 units) item at step t on half
// a block: warp w takes the 16-step tiles w, w + HWARPS, ...; the location
// term is a small product on the tensor cores (loc_term), and its C
// fragments' (step, unit) pairs get the key and the query added, then
// v tanh(.) is summed over the units (in registers, then over the quad's
// lanes).  The keys do not depend on the step: the warp's first tile's are
// loaded before the step's inputs, so their latencies overlap.
constexpr int VB = 32;

__device__ __forceinline__ void energy_item(const TrainArgs& a,
                                            const FwdSmem& m,
                                            const FwdScratch& sc, float* sm,
                                            int t, AttItem it,
                                            const Half& hf, TrainClock& clk) {
  const int B = a.B, T = a.T, K = a.K, W = a.save_w, sumU = tr_sumU(a);
  const int warp = hf.warp, lane = hf.lane, g = lane >> 2, tq = lane & 3;
  const int src = it.src, b = it.b, pad = (K - 1) / 2, kind = a.kinds[src];
  const int U = a.u_off[src + 1] - a.u_off[src], ul = it.slice * US;
  const int u0 = a.u_off[src] + ul, nu = min(US, U - ul);
  const size_t col = (size_t)(src * B + b) * T;
  // cvw[i] = cv[i - pad], zero outside
  float* cvw = sm + m.items + hf.h * tr_al4(fwd_att_floats(a));
  float* pqs = cvw + T + K;
  const float* cv = a.scratch + sc.cv + col;
  const float* krow = a.keys[src] + (size_t)b * T * U + ul;
  float key[4][4];
  auto load_keys = [&](int m0) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int tau = m0 + g + 8 * (c >> 1), u = 8 * j + 2 * tq + (c & 1);
        key[j][c] = tau < T && u < nu ? __ldg(krow + (size_t)tau * U + u)
                                      : 0.f;
      }
  };
  load_keys(16 * warp);
  for (int i = hf.tid; i < T + K - 1; i += HT) {
    const int j = i - pad;
    cvw[i] = kind != 0 && j >= 0 && j < T ? __ldcg(cv + j) : 0.f;
  }
  for (int i = hf.tid; i < nu; i += HT)
    pqs[i] = __ldcg(a.save + ((size_t)t * B + b) * W + a.off_pq + u0 + i);
  hf.sync();
  clk.part(F_ENERGY, P_COPY);
  float vv[4][2], pq[4][2];  // this lane's units 8 j + 2 tq + (0, 1)
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int u = 8 * j + 2 * tq + c;
      vv[j][c] = u < nu ? sm[m.v + u0 + u] : 0.f;
      pq[j][c] = u < nu ? pqs[u] : 0.f;
    }
  float* ep = a.scratch + sc.epart +
              ((size_t)(src * B + b) * tr_max_uslices(a) + it.slice) * T;
  for (int m0 = 16 * warp; m0 < T; m0 += 16 * HWARPS) {
    if (m0 != 16 * warp) load_keys(m0);
    float loc[4][4];
    if (kind != 0) {
      loc_term(cvw, sm + m.loc + u0, sumU, K, T, nu, m0, loc);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) loc[j][c] = 0.f;
    }
    float e0 = 0.f, e1 = 0.f;  // steps m0 + g, m0 + g + 8
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float e = vv[j][c & 1] *
                        tanhf(loc[j][c] + key[j][c] + pq[j][c & 1]);
        if (c < 2) e0 += e;
        else e1 += e;
      }
    e0 += __shfl_xor_sync(FULL, e0, 1);
    e0 += __shfl_xor_sync(FULL, e0, 2);
    e1 += __shfl_xor_sync(FULL, e1, 1);
    e1 += __shfl_xor_sync(FULL, e1, 2);
    if (tq == 0) {
      if (m0 + g < T) ep[m0 + g] = e0;
      if (m0 + g + 8 < T) ep[m0 + g + 8] = e1;
    }
  }
  clk.part(F_ENERGY, P_PRODUCT);
  hf.sync();
}

// Softmax, forward recursion and context columns of one (source, row, 64
// value columns) item at step t on half a block; each thread's first VB
// values are loaded before the step's inputs.  Every item of a pair
// recomputes the softmax from the partial energies; slice 0 writes the
// alignment columns (aux), the next conv input and the next alpha.
__device__ __forceinline__ void context_item(const TrainArgs& a,
                                             const FwdSmem& m,
                                             const FwdScratch& sc, float* sm,
                                             int t, AttItem it,
                                             const Half& hf, TrainClock& clk) {
  const int B = a.B, T = a.T, W = a.save_w;
  const int tid = hf.tid, warp = hf.warp, lane = hf.lane;
  const int src = it.src, b = it.b, kind = a.kinds[src];
  const int C = a.c_off[src + 1] - a.c_off[src], cb = it.slice * CS;
  const int nc = min(CS, C - cb), nsl = tr_uslices(a, src);
  const bool first = it.slice == 0;
  const size_t col = (size_t)(src * B + b) * T, plane = (size_t)B * T;
  // energies, softmax, then the alignment
  float* er = sm + m.items + hf.h * tr_al4(fwd_att_floats(a));
  float* tmp = er + T;     // forward-recursion numerators
  float* cvs = tmp + T;    // conv input of the step (slice 0)
  float* als = cvs + T;    // alpha of the step (forward sources)
  float* cpart = als + T;  // (2, CS) partial contexts
  float* cv = a.scratch + sc.cv + col;
  const float* al = a.scratch + sc.alpha + (size_t)(t & 1) * a.ns * plane + col;
  float* al_next = a.scratch + sc.alpha +
                   (size_t)((t + 1) & 1) * a.ns * plane + col;
  const float* ep = a.scratch + sc.epart +
                    (size_t)(src * B + b) * tr_max_uslices(a) * T;
  float* aux = a.aux + ((size_t)(t * a.ns + src) * 3) * plane + (size_t)b * T;
  // the values of this thread's column c and half q of the memory steps:
  // step-independent, so their loads go first
  constexpr int NQ = HT / CS;
  const int c = tid % CS, q = tid / CS, tq = tr_cdiv(T, NQ);
  const int tau0 = q * tq, tau1 = min(T, tau0 + tq);
  const float* vals = a.values[src] + (size_t)b * T * C + cb + c;
  float vr[VB];
#pragma unroll
  for (int i = 0; i < VB; ++i)
    vr[i] = c < nc && tau0 + i < tau1 ? __ldg(vals + (size_t)(tau0 + i) * C)
                                      : 0.f;
  for (int tau = tid; tau < T; tau += HT) {
    float e = 0.f;
    for (int s = 0; s < nsl; ++s) e += __ldcg(ep + (size_t)s * T + tau);
    er[tau] = __ldg(a.mask + col + tau) > 0.5f ? e : -1e9f;
    if (first) cvs[tau] = __ldcg(cv + tau);
    if (kind == 2) als[tau] = __ldcg(al + tau);
  }
  hf.sync();
  clk.part(F_CONTEXT, P_COPY);
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
      if (first) {
        aux[tau] = p;
        const float cvo = cvs[tau];
        aux[2 * plane + tau] = cvo;
        if (kind != 0) cv[tau] = a.cumulative[src] ? cvo + p : p;
      }
      if (kind == 2) {
        const float ap = als[tau];
        const float sh = tau > 0 ? als[tau - 1] : 0.f;
        const float z = (0.5f * ap + 0.5f * sh + 1e-7f) * p;
        tmp[tau] = z;
        zpart += z;
      }
    }
    if (kind == 2) {
      const float zinv = 1.f / warp_sum(zpart);
      __syncwarp();
      for (int tau = lane; tau < T; tau += 32) {
        const float w = tmp[tau] * zinv;
        er[tau] = w;
        if (first) al_next[tau] = w;
      }
    }
    __syncwarp();
    if (first)
      for (int tau = lane; tau < T; tau += 32) aux[plane + tau] = er[tau];
  }
  hf.sync();
  // context: thread (column c, half q of the memory steps)
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < VB; ++i)
    if (tau0 + i < tau1) acc = fmaf(er[tau0 + i], vr[i], acc);
  if (c < nc)
    for (int tau = tau0 + VB; tau < tau1; ++tau)
      acc = fmaf(er[tau], __ldg(vals + (size_t)tau * C), acc);
  cpart[q * CS + c] = acc;
  hf.sync();
  clk.part(F_CONTEXT, P_PRODUCT);
  if (tid < nc) {
    float s = 0.f;
    for (int i = 0; i < NQ; ++i) s += cpart[i * CS + tid];
    a.save[((size_t)t * B + b) * W + a.off_ctx + a.c_off[src] + cb + tid] = s;
  }
  hf.sync();
}

// BF: the bf16 storage mode's instance (a.bf16)
template <bool BF>
__global__ void __launch_bounds__(NT, 1) fused_train_fwd_kernel(
    const __grid_constant__ TrainArgs a) {
  TrainClock clk(a.stage_cycles, F_N);
  extern __shared__ __align__(16) float sm[];
  const FwdSmem m = fwd_smem(a, gridDim.x);
  const FwdScratch sc = fwd_scratch(a);
  GridBarrier grid(a.scratch + sc.total);
  const int B = a.B, S = a.S, T = a.T, A = a.A, D = a.D, K = a.K;
  const int sumU = tr_sumU(a), sumC = tr_sumC(a), P = tr_plast(a);
  const int Zatt = tr_zatt(a), ldz = m.ldz, W = a.save_w;
  const bool det = a.deterministic != 0;
  const int tid = threadIdx.x;
  const int gtid = blockIdx.x * NT + tid, gstride = gridDim.x * NT;
  float* zs = sm + m.zs;
  float* zp = sm + m.zp;
  const bool pre = m.zp != m.zs;  // the second buffer of staged rows fits
  float* part = sm + m.part;
  float* save = a.save;
  const RowGroup rg = row_group(B);
  const int cst_slots = fwd_cst_slots(a, gridDim.x);
  Stager stg(reinterpret_cast<uint64_t*>(sm + m.red));
  const Half hf;

  // ---- resident columns, biases, energy vectors, location weights
  load_cols<BF>(sm + m.att, a.att_w, A, 4, Zatt, rg);
  load_cols<BF>(sm + m.q, a.q_w, sumU, 1, A, rg);
  load_cols<BF>(sm + m.op, a.op_w, D, 1, A + sumC, rg);
  load_cols<BF>(sm + m.l1, a.l1_w, D, 4, 2 * D, rg);
  load_cols<BF>(sm + m.l2, a.l2_w, D, 4, 2 * D, rg);
  load_bias_items(sm + m.att_b, a.att_b, A, 4, rg);
  load_bias_items(sm + m.op_b, a.op_b, D, 1, rg);
  load_bias_items(sm + m.l1_b, a.l1_b, D, 4, rg);
  load_bias_items(sm + m.l2_b, a.l2_b, D, 4, rg);
  for (int i = tid; i < sumU; i += NT) sm[m.v + i] = __ldg(a.v + i);
  for (int i = tid; i < K * sumU; i += NT) sm[m.loc + i] = __ldg(a.loc_w + i);
  // conv inputs start at 0, forward-attention alpha at [1, 0, ...]
  for (size_t i = gtid; i < (size_t)a.ns * B * T; i += gstride) {
    a.scratch[sc.cv + i] = 0.f;
    a.scratch[sc.alpha + i] = (i % T) == 0 ? 1.f : 0.f;
  }

  // ---- prenet over all S*B rows (rows t*B + b), 128 x 64 tiles
  for (int li = 0; li < a.n_pre; ++li) {
    const int N = a.p_sizes[li], Kin = li == 0 ? a.cf : a.p_sizes[li - 1];
    const float* in = li == 0 ? a.teacher : save + a.off_pd[li - 1];
    const size_t ldin = li == 0 ? (size_t)a.cf : (size_t)W;
    const float* w = a.pre_w[li];
    const float* bias = a.pre_b[li];
    const bool drop = a.drop_rate > 0.f && !det && a.p_dropout[li];
    const bool spk = a.use_spk && li == 0;
    const int M = S * B, tn = tr_cdiv(N, TBN);
    auto ld_in = [&](int r, int k) {
      return __ldcg(in + (size_t)r * ldin + k);
    };
    auto ld_w = [&](int k, int n) { return __ldg(w + (size_t)k * N + n); };
    auto epi = [&](int r, int n, float acc) {
      const float act = fmaxf(acc + __ldg(bias + n), 0.f);
      const int t = r / B, row = r % B;
      float pd = act;
      if (drop)
        pd = act * (mask_keep(a.seed, t, li, row, n, a.drop_rate) > 0.f
                        ? a.drop_scale : 0.f);
      if (spk) pd += __ldg(a.spk + (size_t)row * N + n);
      save[(size_t)r * W + a.off_p[li] + n] = act;
      save[(size_t)r * W + a.off_pd[li] + n] = pd;
    };
    for (int tile = blockIdx.x; tile < tr_tiles(M, N); tile += gridDim.x) {
      const int m0 = (tile / tn) * TBM, n0 = (tile % tn) * TBN;
      mma_tile<true, false, BF>(M, N, 0, Kin, m0, n0, ld_in, ld_w, epi, zs);
    }
    clk.part(F_PRENET, P_EPI);
    grid.sync();
    clk.part(F_PRENET, P_WAIT);
  }
  if (pre) {  // step 0's attention-LSTM rows (see the lstm2 stage)
    stg.group(zp, ldz, 0, rg, save + a.off_pd[a.n_pre - 1], W, P);
    stg.group(zp, ldz, P, rg, nullptr, W, sumC);
    stg.group(zp, ldz, P + sumC, rg, nullptr, W, A);
  }

  const int n_eitems = tr_att_items<true>(a), n_citems = tr_att_items<false>(a);
  for (int t = 0; t < S; ++t) {
    float* cur = save + (size_t)t * B * W;
    const float* prev = t > 0 ? save + (size_t)(t - 1) * B * W : nullptr;
    auto pf = [&](int off) { return prev ? prev + off : nullptr; };
    // the next step's prenet rows into L2 (written by the prologue, long
    // evicted at the recipe's 8192 rows)
    if (t + 1 < S)
      l2_prefetch(cur + (size_t)B * W + a.off_pd[a.n_pre - 1], W, B, P);

    // ---- attention LSTM over [pd_last, ctx_prev, h_att_prev], in zp: with
    // two buffers these rows were copied during step t - 1's lstm2 stage
    if (!pre) {
      stg.group(zp, ldz, 0, rg, cur + a.off_pd[a.n_pre - 1], W, P);
      stg.group(zp, ldz, P, rg, pf(a.off_ctx), W, sumC);
      stg.group(zp, ldz, P + sumC, rg, pf(a.off_hatt), W, A);
    }
    stg.wait();
    clk.part(F_ATT_LSTM, P_COPY);
    rows_mma<4, BF>(A, Zatt, rg, sm + m.att, zp, ldz, part,
                [&](int n, int s, int r, int rl, int q, float acc) {
      const float gq = acc + sm[m.att_b + 4 * s + q];
      float& cs = sm[m.cst + (0 * cst_slots + s) * rg.nr + rl];
      const float c_prev = prev ? cs : 0.f;
      const float keep =
          q == 1 ? zkeep(a, t, MASK_ZC_ATT, r, n, a.zc_att)
                 : q == 2 ? zkeep(a, t, MASK_ZO_ATT, r, n, a.zo_att) : 1.f;
      float c, h;
      lstm_fwd4(gq, q, c_prev, zp[rl * ldz + P + sumC + n], a.zc_att,
                a.zo_att, keep, det, c, h);
      float* row = cur + (size_t)r * W;
      row[a.off_gatt + q * A + n] = gq;
      if (q == 0) {
        row[a.off_catt + n] = c;
        cs = c;
      } else if (q == 1) {
        row[a.off_hatt + n] = h;
      }
    }, clk, F_ATT_LSTM);
    grid.sync();
    clk.part(F_ATT_LSTM, P_WAIT);

    // ---- query projections of all sources; zs keeps h_att for the
    // projection stage, and lstm1's step-old half goes to zp (free now)
    stg.group(zs, ldz, 0, rg, cur + a.off_hatt, W, A);
    stg.wait();
    if (pre) stg.group(zp, ldz, D, rg, pf(a.off_h1), W, D);
    clk.part(F_QUERY, P_COPY);
    rows_mma<1, BF>(sumU, A, rg, sm + m.q, zs, ldz, part,
                [&](int n, int, int r, int, int, float acc) {
                  cur[(size_t)r * W + a.off_pq + n] = acc;
                }, clk, F_QUERY);
    grid.sync();
    clk.part(F_QUERY, P_WAIT);

    // ---- attention energies, (source, row, 32 units) items, two at once
    for (int i = blockIdx.x + hf.h * gridDim.x; i < n_eitems;
         i += 2 * gridDim.x) {
      const AttItem it = tr_att_item<true>(a, i);
      clk.item_begin();
      energy_item(a, m, sc, sm, t, it, hf, clk);
      clk.item_end(it.src);
    }
    __syncthreads();
    clk.part(F_ENERGY, P_EPI);
    grid.sync();
    clk.part(F_ENERGY, P_WAIT);

    // ---- softmax, recursion and context, (source, row, 64 columns) items,
    // two at once
    for (int i = blockIdx.x + hf.h * gridDim.x; i < n_citems;
         i += 2 * gridDim.x)
      context_item(a, m, sc, sm, t, tr_att_item<false>(a, i), hf, clk);
    __syncthreads();
    clk.part(F_CONTEXT, P_EPI);
    grid.sync();
    clk.part(F_CONTEXT, P_WAIT);

    // ---- output projection over [h_att (staged by the query stage), ctx]
    stg.group(zs, ldz, A, rg, cur + a.off_ctx, W, sumC);
    stg.wait();
    clk.part(F_PROJ, P_COPY);
    rows_mma<1, BF>(D, A + sumC, rg, sm + m.op, zs, ldz, part,
                [&](int n, int s, int r, int, int, float acc) {
                  cur[(size_t)r * W + a.off_proj + n] = acc + sm[m.op_b + s];
                }, clk, F_PROJ);
    grid.sync();
    clk.part(F_PROJ, P_WAIT);

    // ---- lstm1 over [proj, h1_prev] in zp; o1 = proj + h1; lstm2's
    // step-old half goes to zs (free now)
    stg.group(zp, ldz, 0, rg, cur + a.off_proj, W, D);
    if (!pre) stg.group(zp, ldz, D, rg, pf(a.off_h1), W, D);
    stg.wait();
    if (pre) stg.group(zs, ldz, D, rg, pf(a.off_h2), W, D);
    clk.part(F_LSTM1, P_COPY);
    rows_mma<4, BF>(D, 2 * D, rg, sm + m.l1, zp, ldz, part,
                [&](int n, int s, int r, int rl, int q, float acc) {
      const float gq = acc + sm[m.l1_b + 4 * s + q];
      float& cs = sm[m.cst + (1 * cst_slots + s) * rg.nr + rl];
      const float c_prev = prev ? cs : 0.f;
      const float keep =
          q == 1 ? zkeep(a, t, MASK_ZC1, r, n, a.zc_dec)
                 : q == 2 ? zkeep(a, t, MASK_ZO1, r, n, a.zo_dec) : 1.f;
      float c, h;
      lstm_fwd4(gq, q, c_prev, zp[rl * ldz + D + n], a.zc_dec, a.zo_dec, keep,
                det, c, h);
      float* row = cur + (size_t)r * W;
      row[a.off_g1 + q * D + n] = gq;
      if (q == 0) {
        row[a.off_c1 + n] = c;
        cs = c;
      } else if (q == 1) {
        row[a.off_h1 + n] = h;
      } else if (q == 2) {
        row[a.off_o1 + n] = zp[rl * ldz + n] + h;
      }
    }, clk, F_LSTM1);
    grid.sync();
    clk.part(F_LSTM1, P_WAIT);

    // ---- lstm2 over [o1, h2_prev] in zs; y = o1 + h2; the next step's
    // attention-LSTM rows (all final now) go to zp
    stg.group(zs, ldz, 0, rg, cur + a.off_o1, W, D);
    if (!pre) stg.group(zs, ldz, D, rg, pf(a.off_h2), W, D);
    stg.wait();
    if (pre && t + 1 < S) {
      stg.group(zp, ldz, 0, rg, cur + (size_t)B * W + a.off_pd[a.n_pre - 1],
                  W, P);
      stg.group(zp, ldz, P, rg, cur + a.off_ctx, W, sumC);
      stg.group(zp, ldz, P + sumC, rg, cur + a.off_hatt, W, A);
    }
    clk.part(F_LSTM2, P_COPY);
    rows_mma<4, BF>(D, 2 * D, rg, sm + m.l2, zs, ldz, part,
                [&](int n, int s, int r, int rl, int q, float acc) {
      const float gq = acc + sm[m.l2_b + 4 * s + q];
      float& cs = sm[m.cst + (2 * cst_slots + s) * rg.nr + rl];
      const float c_prev = prev ? cs : 0.f;
      const float keep =
          q == 1 ? zkeep(a, t, MASK_ZC2, r, n, a.zc_dec)
                 : q == 2 ? zkeep(a, t, MASK_ZO2, r, n, a.zo_dec) : 1.f;
      float c, h;
      lstm_fwd4(gq, q, c_prev, zs[rl * ldz + D + n], a.zc_dec, a.zo_dec, keep,
                det, c, h);
      float* row = cur + (size_t)r * W;
      row[a.off_g2 + q * D + n] = gq;
      if (q == 0) {
        row[a.off_c2 + n] = c;
        cs = c;
      } else if (q == 1) {
        row[a.off_h2 + n] = h;
      } else if (q == 2) {
        a.y[((size_t)t * B + r) * D + n] = zs[rl * ldz + n] + h;
      }
    }, clk, F_LSTM2);
    grid.sync();
    clk.part(F_LSTM2, P_WAIT);
  }
  clk.flush();
}

// ------------------------------------------------------------------- host
extern "C" long long fused_train_fwd_scratch_floats(const TrainArgs* a) {
  return (long long)fwd_scratch(*a).total + TR_SYNC_WORDS;
}

extern "C" long long fused_train_fwd_smem_bytes(const TrainArgs* a, int nb) {
  return (long long)(fwd_smem(*a, nb).total * sizeof(float));
}

extern "C" int fused_train_fwd_launch(const TrainArgs* args, void* stream) {
  int sms = 0, e = tr_sms(&sms);
  if (e) return e;
  return tr_launch(args->bf16 ? fused_train_fwd_kernel<true>
                              : fused_train_fwd_kernel<false>,
                   *args, fwd_smem(*args, sms).total,
                   fwd_scratch(*args).total, sms, stream);
}
