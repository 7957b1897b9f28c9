// Backward of the teacher-forced training trunk in one cooperative kernel.
//
// Replaces: self_attention_tacotron_tpu/ops/fused_train.py `_bwd_kernel`
// (with `_lstm_bwd`; Pallas, reached through `_bwd_call` and `_core_bwd`).
//
// What bounds it on the H100: two parts.  The reverse-time chain is serial:
// per step the three LSTM VJPs, the projection and the attention VJP, each
// product a multiply by W^T over 32 rows, separated by 8 grid barriers
// (~2.3 ms of barriers for 256 steps, and as much again of L2 round trips
// for the stages' inputs).  The weight gradients are parallel:
// contractions of depth S*B = 8192 over every trunk and prenet matrix.
// In all ~75 GFLOP at the recipe, ~1.1 ms of FP32 peak (~0.45 ms of the
// tensor cores' TF32 peak in the 3xTF32 split this kernel uses).
//
// Design: one 256-thread block per SM, launched cooperatively, the
// hand-written GridBarrier (common.cuh) between dependent stages.  The
// serial products multiply by W^T, so this kernel keeps ROWS of each
// (in, out) matrix resident (the row-partitioned copy; the forward keeps
// columns); as there, a block serves one of two 16-row groups and owns the
// matrix rows n with n % 66 == its index (~116 KB a block at the recipe),
// and a stage has the TMA copy its rows in and multiplies them on the
// tensor cores (rows_mma, 3xTF32).  Per step: lstm2 VJP (elementwise) |
// d z2 = d_gates2 W2^T, whose epilogue runs the lstm1 VJP of the same unit
// | d z1 | d zop (d ctx goes to the stash) | d_w = values . d_ctx, a warp
// per (source, row, memory step) | the attention VJP in (source, row, 32
// units) items of about equal cost, two at a time on the two half blocks:
// each recomputes its pair's recursion and softmax VJP (T floats), then on
// 16-step tiles the energies' location term as a small product on the
// tensor cores, tanh, d_pre, d_keys (read-modify-write of the item's own
// units), the d_pq and d_v sums over steps; d_loc and the window adjoint
// as two more small products; its share of the conv adjoint is added with
// atomics into the buffer that step t - 1 reads (two buffers by step
// parity, each zeroed after its last read); d_v and d_loc stay in the
// block's shared memory until the loop ends | d h_att via Wq^T, whose
// epilogue runs the attention-LSTM VJP | d z_att over the [ctx | h_att]
// rows of W_att (the prenet rows are deferred).  The save rows, alignment
// columns and output cotangents a step reads are asked into L2 a step or
// two ahead.  After the loop, 128 x 64 tile products on the tensor cores
// contract stash and save rows into the weight gradients (biases as a
// column of ones; split in two along the 8192 rows, summed with atomics
// onto zero, so the sum is the same in any order) and the alignments with
// the stashed d ctx into d_values (no per-step read-modify-write of the
// values' gradient), handed out to the blocks by a counter; then the
// deferred prenet backward runs layer by layer over all S*B rows.  Masks
// are regenerated from masks.cuh.
//
// The bf16 storage mode (fused_train.cuh): the resident rows as bf16 pairs
// and the serial and weight-gradient products on bf16 tensor cores; the
// save rows read as the JAX kernel's bf16 save rows: the LSTM VJPs round
// the gates and cells they read, the left operands of lstm2's and the
// attention LSTM's weight gradients and the prenet's inputs are rebuilt
// before the loop from the bf16 values (o1 = bf16(proj) + bf16(h1); a
// prenet output = bf16(ReLU output) x dropout (+ the speaker row)), and
// the products round their operands as the JAX kernel's bf16 stash does.
// The location terms, d_values and the prenet bias gradients stay f32.
#include "fused_train.cuh"

struct BwdScratch {  // offsets in floats (32 bits, as BwdSmem's)
  unsigned dc_att, dh_att, dc1, dh1, dc2, dh2, dctx, dh2_zo, d_o1, dh1_zo,
      dhatt_part, dhatt_zo, dA, dCV, dw, state_end, bufA, bufB, total;
};

__host__ __device__ inline BwdScratch bwd_scratch(const TrainArgs& a) {
  const size_t B = a.B, A = a.A, D = a.D, C = tr_sumC(a);
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
  s.dh2_zo = o; o += B * D;
  s.d_o1 = o; o += B * D;
  s.dh1_zo = o; o += B * D;
  s.dhatt_part = o; o += B * A;
  s.dhatt_zo = o; o += B * A;
  s.dA = o; o += 2 * nbt;    // step t reads buffer t % 2
  s.dCV = o; o += 2 * nbt;
  s.dw = o; o += nbt;
  s.state_end = o;
  s.bufA = o; o += (size_t)a.S * B * pmax;
  s.bufB = o; o += (size_t)a.S * B * pmax;
  s.total = o;
  return s;
}

// The bf16 instance's rebuilt left operands, past the sync words (so that
// the f32 layout stays as it is): o1 (S*B, D), then each prenet layer's
// output (S*B, p_i).
__host__ __device__ inline size_t bwd_bf16_floats(const TrainArgs& a) {
  size_t n = (size_t)a.D;
  for (int i = 0; i < a.n_pre; ++i) n += a.p_sizes[i];
  return a.bf16 ? (size_t)a.S * a.B * n : 0;
}

__device__ inline float* bwd_o1b(const TrainArgs& a, const BwdScratch& sc) {
  return a.scratch + sc.total + TR_SYNC_WORDS;
}

__device__ inline float* bwd_pdb(const TrainArgs& a, const BwdScratch& sc,
                                 int li) {
  size_t o = (size_t)a.S * a.B * a.D;
  for (int i = 0; i < li; ++i) o += (size_t)a.S * a.B * a.p_sizes[i];
  return bwd_o1b(a, sc) + o;
}

// The attention VJP of one (source, row, 32 units) item at step t on half
// a block; see fused_train_bwd_reference in ops/fused_train.py for the
// same math.  Warp w takes the 16-step tiles w, w + HWARPS, ...: the
// energies' location term is a small product on the tensor cores
// (loc_term), and each (step, unit) pair of its C fragments recomputes
// tanh and gives d_pre, d_keys, and the d_pq and d_v sums over steps; the
// keys and d_keys of the warp's first tile are loaded before anything
// else, so their latencies overlap with the recursion's.

// d_pre's row stride in shared memory (4 mod 32: the adjoints' fragment
// reads below hit different banks)
constexpr int DS = US + 4;

// d_loc of an item: ia[US + k US + u] += sum_tau cvw[tau + k] d_pre[tau][u]
// (cvw[i] = cv[i - pad]), a (K x T) by (T x 32) product on the tensor
// cores; warp w of the half block takes the 8-unit tile w.  Taps k >= K,
// steps tau >= T and units u >= nu read as 0.
__device__ __forceinline__ void dloc_mma(const float* cvw, const float* dpre,
                                         float* ia, int K, int T, int nu,
                                         int warp) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int u = 8 * warp + g;
  for (int m0 = 0; m0 < K; m0 += 16) {
    const int k0 = m0 + g, k1 = k0 + 8;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int kk = 0; kk < T; kk += 8) {
      const int ta = kk + t, tc = ta + 4;
      uint32_t ah[4], al[4], bh[2], bl[2];
      tf32_split(k0 < K && ta < T ? cvw[ta + k0] : 0.f, ah[0], al[0]);
      tf32_split(k1 < K && ta < T ? cvw[ta + k1] : 0.f, ah[1], al[1]);
      tf32_split(k0 < K && tc < T ? cvw[tc + k0] : 0.f, ah[2], al[2]);
      tf32_split(k1 < K && tc < T ? cvw[tc + k1] : 0.f, ah[3], al[3]);
      tf32_split(ta < T && u < nu ? dpre[ta * DS + u] : 0.f, bh[0], bl[0]);
      tf32_split(tc < T && u < nu ? dpre[tc * DS + u] : 0.f, bh[1], bl[1]);
      mma3(acc, ah, al, bh, bl);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = k0 + 8 * (c >> 1), uc = 8 * warp + 2 * t + (c & 1);
      if (k < K && uc < nu) ia[US + k * US + uc] += acc[c];
    }
  }
}

// The window adjoint of an item: gw[tau][k] = sum_u d_pre[tau][u]
// loc_w[k][u0 + u] (lw = loc_w's columns of the item, row stride sumU), a
// (T x 32) by (32 x K) product on the tensor cores; warp w of the half
// block takes the 16-step tiles w, w + HWARPS, ...
__device__ __forceinline__ void gw_mma(const float* dpre, const float* lw,
                                       int sumU, float* gw, int K, int T,
                                       int nu, int warp) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int m0 = 16 * warp; m0 < T; m0 += 16 * HWARPS) {
    const int r0 = m0 + g, r1 = r0 + 8;
    for (int n0 = 0; n0 < K; n0 += 8) {
      const int kb = n0 + g;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < US; kk += 8) {
        const int ua = kk + t, uc = ua + 4;
        uint32_t ah[4], al[4], bh[2], bl[2];
        tf32_split(r0 < T && ua < nu ? dpre[r0 * DS + ua] : 0.f, ah[0], al[0]);
        tf32_split(r1 < T && ua < nu ? dpre[r1 * DS + ua] : 0.f, ah[1], al[1]);
        tf32_split(r0 < T && uc < nu ? dpre[r0 * DS + uc] : 0.f, ah[2], al[2]);
        tf32_split(r1 < T && uc < nu ? dpre[r1 * DS + uc] : 0.f, ah[3], al[3]);
        tf32_split(kb < K && ua < nu ? lw[kb * sumU + ua] : 0.f, bh[0], bl[0]);
        tf32_split(kb < K && uc < nu ? lw[kb * sumU + uc] : 0.f, bh[1], bl[1]);
        mma3(acc, ah, al, bh, bl);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int tau = r0 + 8 * (c >> 1), k = n0 + 2 * t + (c & 1);
        if (tau < T && k < K) gw[tau * K + k] = acc[c];
      }
    }
  }
}

__device__ __forceinline__ void vjp_item(const TrainArgs& a,
                                         const BwdSmem& m,
                                         const BwdScratch& sc, float* sm,
                                         int t, AttItem it, float* ia,
                                         const Half& hf, TrainClock& clk) {
  const int B = a.B, T = a.T, K = a.K, W = a.save_w, sumU = tr_sumU(a);
  const int tid = hf.tid, warp = hf.warp, lane = hf.lane;
  const int lg = lane >> 2, tq = lane & 3;  // mma fragment row, column
  const int src = it.src, b = it.b, kind = a.kinds[src], pad = (K - 1) / 2;
  const int U = a.u_off[src + 1] - a.u_off[src], ul = it.slice * US;
  const int u0 = a.u_off[src] + ul, nu = min(US, U - ul);
  const bool first = it.slice == 0;
  const size_t nbt = (size_t)a.ns * B * T, plane = (size_t)B * T;
  const size_t col = (size_t)(src * B + b) * T;
  float* g = a.scratch;
  float* ar = sm + m.zs + hf.h * tr_al4(bwd_att_floats(a));  // softmax
  float* wr = ar + T;        // alignment
  float* apr = wr + T;       // previous alpha
  float* da = apr + T;       // d_w, then d_a
  float* de = da + T;        // d_e
  float* ds = de + T;        // d_s
  float* dAs = ds + T;       // the recursion's carry from step t + 1
  float* dCVs = dAs + T;     // the conv adjoint's carry from step t + 1
  float* cvw = dCVs + T;     // cvw[i] = cv[i - pad], zero outside (T + K)
  float* pqs = cvw + T + K;  // query projection of the units (US)
  float* dpre = pqs + US;    // (T, DS) d of the energies' tanh inputs
  float* gw = dpre + T * DS;  // (T, K) window adjoint
  float* pdq = gw + T * K;          // (HWARPS, US) partial d_pq, then d_v
  float* pdv = pdq + HWARPS * US;
  const float* aux = a.aux + ((size_t)(t * a.ns + src) * 3) * plane +
                     (size_t)b * T;
  const float* auxp = t > 0 ? a.aux + ((size_t)((t - 1) * a.ns + src) * 3 + 1)
                                      * plane + (size_t)b * T
                            : nullptr;
  const float* dA_t = g + sc.dA + (size_t)(t & 1) * nbt + col;
  float* dA_n = g + sc.dA + (size_t)((t + 1) & 1) * nbt + col;
  const float* dCV_t = g + sc.dCV + (size_t)(t & 1) * nbt + col;
  float* dCV_n = g + sc.dCV + (size_t)((t + 1) & 1) * nbt + col;
  const float* keys = a.keys[src] + (size_t)b * T * U + ul;
  float* dkeys = a.d_keys[src] + (size_t)b * T * U + ul;
  float key[4][4], old[4][4];
  auto load_tile = [&](int m0) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int tau = m0 + lg + 8 * (c >> 1), u = 8 * j + 2 * tq + (c & 1);
        const bool ok = tau < T && u < nu;
        key[j][c] = ok ? __ldg(keys + (size_t)tau * U + u) : 0.f;
        old[j][c] = ok ? __ldcg(dkeys + (size_t)tau * U + u) : 0.f;
      }
  };
  load_tile(16 * warp);
  for (int tau = tid; tau < T; tau += HT) {
    ar[tau] = __ldg(aux + tau);
    wr[tau] = __ldg(aux + plane + tau);
    apr[tau] = auxp ? __ldg(auxp + tau) : (tau == 0 ? 1.f : 0.f);
    da[tau] = __ldcg(g + sc.dw + col + tau);
    if (kind == 2) dAs[tau] = __ldcg(dA_t + tau);
    if (kind != 0) dCVs[tau] = __ldcg(dCV_t + tau);
  }
  for (int i = tid; i < T + K - 1; i += HT) {
    const int j = i - pad;
    cvw[i] = kind != 0 && j >= 0 && j < T ? __ldg(aux + 2 * plane + j) : 0.f;
  }
  for (int i = tid; i < nu; i += HT)
    pqs[i] = __ldg(a.save + ((size_t)t * B + b) * W + a.off_pq + u0 + i);
  hf.sync();
  clk.part(B_ATTENTION, P_COPY);
  // recursion and softmax VJPs (one warp)
  if (warp == 0) {
    if (kind == 2) {
      float sa = 0.f, zs = 0.f;
      for (int tau = lane; tau < T; tau += 32) {
        const float dal = da[tau] + dAs[tau];
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
        da[tau] = dz * s + dCVs[tau];
        ds[tau] = dz * ar[tau];
      }
      __syncwarp();
      if (first)
        for (int tau = lane; tau < T; tau += 32)
          dA_n[tau] = 0.5f * ds[tau] + 0.5f * (tau + 1 < T ? ds[tau + 1] : 0.f);
    } else if (kind == 1) {
      for (int tau = lane; tau < T; tau += 32) da[tau] += dCVs[tau];
    }
    if (first && kind != 0 && a.cumulative[src])
      for (int tau = lane; tau < T; tau += 32)
        atomicAdd(dCV_n + tau, dCVs[tau]);
    __syncwarp();
    float sab = 0.f;
    for (int tau = lane; tau < T; tau += 32) sab += ar[tau] * da[tau];
    sab = warp_sum(sab);
    for (int tau = lane; tau < T; tau += 32)
      de[tau] = ar[tau] * (da[tau] - sab);
  }
  hf.sync();
  // d_pre = d_e v (1 - e^2) with the energies recomputed from the saved
  // query projection and conv input; d_keys, d_pq, d_v
  float vv[4][2], pq[4][2], dq[4][2], dvs[4][2];  // units 8 j + 2 tq + c
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int u = 8 * j + 2 * tq + c;
      vv[j][c] = u < nu ? sm[m.v + u0 + u] : 0.f;
      pq[j][c] = u < nu ? pqs[u] : 0.f;
      dq[j][c] = dvs[j][c] = 0.f;
    }
  for (int m0 = 16 * warp; m0 < T; m0 += 16 * HWARPS) {
    if (m0 != 16 * warp) load_tile(m0);
    float loc[4][4];
    if (kind != 0) {
      loc_term(cvw, sm + m.loc + u0, sumU, K, T, nu, m0, loc);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) loc[j][c] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int tau = m0 + lg + 8 * (c >> 1), u = 8 * j + 2 * tq + (c & 1);
        if (tau >= T || u >= nu) continue;
        const float e = tanhf(loc[j][c] + key[j][c] + pq[j][c & 1]);
        const float dp = de[tau] * vv[j][c & 1] * (1.f - e * e);
        dkeys[(size_t)tau * U + u] = old[j][c] + dp;
        dpre[tau * DS + u] = dp;
        dq[j][c & 1] += dp;
        dvs[j][c & 1] = fmaf(e, de[tau], dvs[j][c & 1]);
      }
  }
  // the sums over the warp's steps: over the 8 lanes of a unit column
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        dq[j][c] += __shfl_xor_sync(FULL, dq[j][c], o);
        dvs[j][c] += __shfl_xor_sync(FULL, dvs[j][c], o);
      }
  if (lg == 0)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        pdq[warp * US + 8 * j + 2 * tq + c] = dq[j][c];
        pdv[warp * US + 8 * j + 2 * tq + c] = dvs[j][c];
      }
  hf.sync();
  clk.part(B_ATTENTION, P_PRODUCT);
  if (tid < nu) {
    float s1 = 0.f, s2 = 0.f;
    for (int w = 0; w < HWARPS; ++w) {
      s1 += pdq[w * US + tid];
      s2 += pdv[w * US + tid];
    }
    a.stash[((size_t)t * B + b) * a.stash_w + a.off_dpq + u0 + tid] = s1;
    ia[tid] += s2;
  }
  if (kind != 0) {
    // d_loc and the window adjoint, small products on the tensor cores
    dloc_mma(cvw, dpre, ia, K, T, nu, warp);
    gw_mma(dpre, sm + m.loc + u0, sumU, gw, K, T, nu, warp);
    hf.sync();
    // this item's share of the conv adjoint, into step t - 1's buffer
    for (int j = tid; j < T; j += HT) {
      float acc = 0.f;
      for (int k = 0; k < K; ++k) {
        const int tau = j - k + pad;
        if (tau >= 0 && tau < T) acc += gw[tau * K + k];
      }
      atomicAdd(dCV_n + j, acc);
    }
  }
  hf.sync();
}

// After the step loop: the weight gradients, d_values, d_v and d_loc, then
// the deferred prenet backward layer by layer.  A function of its own, so
// that the tile product's registers are allocated apart from the loop's.
template <bool BF>
__device__ __noinline__ void bwd_tail(const TrainArgs& a, const BwdSmem& m,
                                      const BwdScratch& sc, float* sm,
                                      TrainClock& clk, GridBarrier& grid) {
  const int B = a.B, S = a.S, T = a.T, A = a.A, D = a.D, K = a.K;
  const int sumU = tr_sumU(a), sumC = tr_sumC(a), P = tr_plast(a);
  const int Zatt = tr_zatt(a), W = a.save_w, WS = a.stash_w;
  const bool det = a.deterministic != 0;
  const int tid = threadIdx.x;
  const int gtid = blockIdx.x * NT + tid, gstride = gridDim.x * NT;
  float* zs = sm + m.zs;
  float* g = a.scratch;
  const float* save = a.save;
  int* slot = reinterpret_cast<int*>(sm + m.red);  // next_item's broadcast
  unsigned* counters =
      reinterpret_cast<unsigned*>(a.scratch + sc.total) + GRID_BAR_WORDS;
  const int n_items = tr_att_items<true>(a);
  const size_t ia_floats = US + (size_t)K * US;
  // ---- weight gradients over all S*B rows, d_values over the steps, and
  // d_v, d_loc
  const int M = S * B;
  const float* st = a.stash;
  float* bufA = g + sc.bufA;
  float* bufB = g + sc.bufB;
  {
    // the attention items' d_v and d_loc, summed over the steps
    for (int i = blockIdx.x, j = 0; i < n_items; i += gridDim.x, ++j) {
      const AttItem it = tr_att_item<true>(a, i);
      const int U = a.u_off[it.src + 1] - a.u_off[it.src];
      const int u0 = a.u_off[it.src] + it.slice * US;
      const int nu = min(US, U - it.slice * US);
      const float* ia = sm + m.iacc + j * ia_floats;
      for (int e = tid; e < (K + 1) * US; e += NT) {
        const int k = e / US - 1, u = e % US;
        if (u >= nu) continue;
        if (k < 0) atomicAdd(a.d_v + u0 + u, ia[u]);
        else if (a.kinds[it.src] != 0)
          atomicAdd(a.d_loc + (size_t)k * sumU + u0 + u, ia[US + k * US + u]);
      }
    }
    // jobs, largest first: dW_att, dW_l1, dW_l2, dW_op, dW_q (each tile
    // split in two halves of the rows), d_out = d_gatt W_att[:P]^T, then
    // d_values per (source, row)
    int cnt[7] = {2 * tr_tiles(Zatt + 1, 4 * A), 2 * tr_tiles(2 * D + 1, 4 * D),
                  2 * tr_tiles(2 * D + 1, 4 * D),
                  2 * tr_tiles(A + sumC + 1, D), 2 * tr_tiles(A, sumU),
                  tr_tiles(M, P), 0};
    for (int s = 0; s < a.ns; ++s)
      cnt[6] += B * tr_tiles(T, a.c_off[s + 1] - a.c_off[s]);
    int total = 0;
    for (int j = 0; j < 7; ++j) total += cnt[j];
    const int kper = tr_cdiv(tr_cdiv(M, 2), TBK) * TBK;
    for (int item = next_item(counters, slot); item < total;
         item = next_item(counters, slot)) {
      int job = 0, loc = item;
      while (loc >= cnt[job]) loc -= cnt[job++];
      auto dw = [&](const SegLoad& L, int Mo, int N, int off_r, float* out) {
        const int tn = tr_cdiv(N, TBN), tile = loc >> 1;
        const int kb = (loc & 1) * kper, ke = min(M, kb + kper);
        auto ll = [&](int mm, int k) { return L(k, mm); };
        auto rl = [&](int k, int n) {
          return __ldcg(st + (size_t)k * WS + off_r + n);
        };
        auto ep = [&](int mm, int n, float v) {
          atomicAdd(out + (size_t)mm * N + n, v);
        };
        const int m0 = (tile / tn) * TBM, n0 = (tile % tn) * TBN;
        mma_tile<false, false, BF>(Mo, N, kb, ke, m0, n0, ll, rl, ep, zs);
      };
      // the bf16 mode reads o1 and the last prenet output rebuilt
      const float* pd_last = BF ? bwd_pdb(a, sc, a.n_pre - 1)
                                : save + a.off_pd[a.n_pre - 1];
      const size_t ld_pd = BF ? (size_t)P : (size_t)W;
      switch (job) {
        // the left operands, made where used (one lives at a time)
        case 0:
          dw(SegLoad{3, Zatt, {0, P, P + sumC, Zatt},
                     {pd_last, save + a.off_ctx, save + a.off_hatt},
                     {ld_pd, (size_t)W, (size_t)W}, {0, -B, -B}},
             Zatt + 1, 4 * A, a.off_dgatt, a.d_att);
          break;
        case 1:
          dw(SegLoad{2, 2 * D, {0, D, 2 * D, 0},
                     {save + a.off_proj, save + a.off_h1, nullptr},
                     {(size_t)W, (size_t)W, 0}, {0, -B, 0}},
             2 * D + 1, 4 * D, a.off_dg1, a.d_l1);
          break;
        case 2:
          dw(SegLoad{2, 2 * D, {0, D, 2 * D, 0},
                     {BF ? bwd_o1b(a, sc) : save + a.off_o1,
                      save + a.off_h2, nullptr},
                     {BF ? (size_t)D : (size_t)W, (size_t)W, 0},
                     {0, -B, 0}},
             2 * D + 1, 4 * D, a.off_dg2, a.d_l2);
          break;
        case 3:
          dw(SegLoad{2, A + sumC, {0, A, A + sumC, 0},
                     {save + a.off_hatt, save + a.off_ctx, nullptr},
                     {(size_t)W, (size_t)W, 0}, {0, 0, 0}},
             A + sumC + 1, D, a.off_dproj, a.d_op);
          break;
        case 4:
          dw(SegLoad{1, A, {0, A, 0, 0}, {save + a.off_hatt, nullptr, nullptr},
                     {(size_t)W, 0, 0}, {0, 0, 0}},
             A, sumU, a.off_dpq, a.d_q);
          break;
        case 5: {
          const int tn = tr_cdiv(P, TBN);
          const float* watt = a.att_w;
          auto ll = [&](int r, int k) {
            return __ldcg(st + (size_t)r * WS + a.off_dgatt + k);
          };
          auto rl = [&](int k, int n) {
            return __ldg(watt + (size_t)n * 4 * A + k);
          };
          auto ep = [&](int r, int n, float v) { bufA[(size_t)r * P + n] = v; };
          const int m0 = (loc / tn) * TBM, n0 = (loc % tn) * TBN;
          mma_tile<true, true, BF>(M, P, 0, 4 * A, m0, n0, ll, rl, ep, zs);
          break;
        }
        default: {
          // d_values[src][b] (T, C) = sum_t w_t[b]^T d_ctx_t[b]
          int src = 0, per = B * tr_tiles(T, a.c_off[1] - a.c_off[0]);
          while (loc >= per) {
            loc -= per;
            ++src;
            per = B * tr_tiles(T, a.c_off[src + 1] - a.c_off[src]);
          }
          const int C = a.c_off[src + 1] - a.c_off[src];
          const int tiles = tr_tiles(T, C), b = loc / tiles, tl = loc % tiles;
          const int tn = tr_cdiv(C, TBN);
          const size_t plane = (size_t)B * T;
          const float* wcol = a.aux + ((size_t)src * 3 + 1) * plane +
                              (size_t)b * T;
          const float* dc = st + (size_t)b * WS + a.off_dctxs + a.c_off[src];
          float* out = a.d_values[src] + (size_t)b * T * C;
          mma_tile<false, false>(
              T, C, 0, S, (tl / tn) * TBM, (tl % tn) * TBN,
              [&](int tau, int s) {
                return __ldg(wcol + (size_t)s * a.ns * 3 * plane + tau);
              },
              [&](int s, int c) {
                return __ldcg(dc + (size_t)s * B * WS + c);
              },
              [&](int tau, int c, float v) { out[(size_t)tau * C + c] = v; },
              zs);
        }
      }
    }
  }
  clk.part(B_DW, P_EPI);
  grid.sync();
  clk.part(B_DW, P_WAIT);

  // ---- the deferred prenet backward, last layer first; bufA holds the
  // cotangent of layer li's output
  for (int li = a.n_pre - 1; li >= 0; --li) {
    const int N = a.p_sizes[li];
    const bool drop = a.drop_rate > 0.f && !det && a.p_dropout[li];
    // the bf16 stash holds the dropout multiplier in bf16
    const float scale = BF ? xround<__nv_bfloat16>(a.drop_scale)
                           : a.drop_scale;
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
                  ? scale : 0.f;
      bufB[e] = __ldcg(bufA + e) * mr;
    }
    grid.sync();
    const int Kin = li == 0 ? a.cf : a.p_sizes[li - 1];
    const float* pin = li == 0 ? a.teacher
                       : BF ? bwd_pdb(a, sc, li - 1)
                                : save + a.off_pd[li - 1];
    const size_t ld_in = li == 0 ? (size_t)a.cf
                         : BF ? (size_t)Kin : (size_t)W;
    SegLoad lp{1, Kin, {0, Kin, 0, 0}, {pin, nullptr, nullptr},
               {ld_in, 0, 0}, {0, 0, 0}};
    if constexpr (BF) {
      // the bias gradient, an f32 sum of d_pre (the JAX kernel's), each
      // block over its share of the rows; the tile product below leaves
      // out the bias row
      const int rows = tr_cdiv(M, gridDim.x), rb0 = blockIdx.x * rows;
      const int rb1 = min(M, rb0 + rows);
      for (int n = tid; n < N; n += NT) {
        float acc = 0.f;
        for (int r = rb0; r < rb1; ++r) acc += __ldcg(bufB + (size_t)r * N + n);
        if (rb0 < rb1) atomicAdd(a.d_pre_w[li] + (size_t)Kin * N + n, acc);
      }
    }
    // the weight gradient's few tiles are split along the rows until the
    // blocks have work (partials summed with atomics)
    const int Mo = BF ? Kin : Kin + 1;   // rows of the tile product
    const int cw_tiles = tr_tiles(Mo, N);
    int split = (int)gridDim.x / cw_tiles;
    split = split < 1 ? 1 : (split > tr_cdiv(M, 1024) ? tr_cdiv(M, 1024)
                                                      : split);
    const int kper = tr_cdiv(tr_cdiv(M, split), TBK) * TBK;
    const int cw = cw_tiles * split;
    const int cx = li > 0 ? tr_tiles(M, Kin) : 0;
    float* dwo = a.d_pre_w[li];
    const float* wl = a.pre_w[li];
    for (int item = next_item(counters + 1 + li, slot); item < cw + cx;
         item = next_item(counters + 1 + li, slot)) {
      if (item < cw) {
        const int tn = tr_cdiv(N, TBN), tile = item / split;
        const int kb = (item % split) * kper, ke = min(M, kb + kper);
        auto ll = [&](int mm, int k) { return lp(k, mm); };
        auto rl = [&](int k, int n) {
          return __ldcg(bufB + (size_t)k * N + n);
        };
        auto ep = [&](int mm, int n, float v) {
          atomicAdd(dwo + (size_t)mm * N + n, v);
        };
        const int m0 = (tile / tn) * TBM, n0 = (tile % tn) * TBN;
        mma_tile<false, false, BF>(Mo, N, kb, ke, m0, n0, ll, rl, ep, zs);
      } else {
        const int loc = item - cw, tn = tr_cdiv(Kin, TBN);
        auto ll = [&](int r, int k) {
          return __ldcg(bufB + (size_t)r * N + k);
        };
        auto rl = [&](int k, int n) { return __ldg(wl + (size_t)n * N + k); };
        auto ep = [&](int r, int n, float v) { bufA[(size_t)r * Kin + n] = v; };
        const int m0 = (loc / tn) * TBM, n0 = (loc % tn) * TBN;
        mma_tile<true, true, BF>(M, Kin, 0, N, m0, n0, ll, rl, ep, zs);
      }
    }
    clk.part(B_PRENET, P_EPI);
    grid.sync();
    clk.part(B_PRENET, P_WAIT);
  }
}

// BF: the bf16 storage mode's instance (a.bf16)
template <bool BF>
__global__ void __launch_bounds__(NT, 1) fused_train_bwd_kernel(
    const __grid_constant__ TrainArgs a) {
  TrainClock clk(a.stage_cycles, B_N);
  extern __shared__ __align__(16) float sm[];
  const BwdSmem m = bwd_smem(a, gridDim.x);
  const BwdScratch sc = bwd_scratch(a);
  GridBarrier grid(a.scratch + sc.total);
  const int B = a.B, S = a.S, T = a.T, A = a.A, D = a.D, K = a.K;
  const int sumU = tr_sumU(a), sumC = tr_sumC(a), P = tr_plast(a);
  const int Zatt = tr_zatt(a), ldz = m.ldz, W = a.save_w, WS = a.stash_w;
  const bool det = a.deterministic != 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gtid = blockIdx.x * NT + tid, gstride = gridDim.x * NT;
  const size_t nbt = (size_t)a.ns * B * T;
  float* zs = sm + m.zs;
  float* part = sm + m.part;
  float* g = a.scratch;
  const float* save = a.save;
  const RowGroup rg = row_group(B);
  Stager stg(reinterpret_cast<uint64_t*>(sm + m.red + 2));
  const Half hf;

  // ---- resident rows of the (in, out) matrices; zeroed state and the
  // outputs that are summed into
  load_rows<BF>(sm + m.w2, a.l2_w, 2 * D, 4 * D, rg);
  load_rows<BF>(sm + m.w1, a.l1_w, 2 * D, 4 * D, rg);
  load_rows<BF>(sm + m.wop, a.op_w, A + sumC, D, rg);
  load_rows<BF>(sm + m.wq, a.q_w, A, sumU, rg);
  load_rows<BF>(sm + m.watt, a.att_w + (size_t)P * 4 * A, sumC + A,
                    4 * A, rg);
  // a gate or cell of the save rows as the bf16 mode's save holds it
  auto sv = [](float x) { return BF ? xround<__nv_bfloat16>(x) : x; };
  if constexpr (BF) {
    // the weight gradients' left operands rebuilt from the bf16 values
    auto rnd = [](float x) { return xround<__nv_bfloat16>(x); };
    float* o1b = bwd_o1b(a, sc);
    for (size_t e = gtid; e < (size_t)S * B * D; e += gstride) {
      const size_t r = e / D, n = e % D;
      o1b[e] = rnd(__ldg(save + r * W + a.off_proj + n)) +
               rnd(__ldg(save + r * W + a.off_h1 + n));
    }
    for (int li = 0; li < a.n_pre; ++li) {
      const int N = a.p_sizes[li];
      const bool drop = a.drop_rate > 0.f && !det && a.p_dropout[li];
      for (size_t e = gtid; e < (size_t)S * B * N; e += gstride) {
        const int r = (int)(e / N), n = (int)(e % N);
        float v = rnd(__ldg(save + (size_t)r * W + a.off_p[li] + n));
        if (drop)
          v *= mask_keep(a.seed, r / B, li, r % B, n, a.drop_rate) > 0.f
                   ? a.drop_scale : 0.f;
        if (a.use_spk && li == 0) v += __ldg(a.spk + (size_t)(r % B) * N + n);
        bwd_pdb(a, sc, li)[e] = v;
      }
    }
  }
  for (int i = tid; i < sumU; i += NT) sm[m.v + i] = __ldg(a.v + i);
  for (int i = tid; i < K * sumU; i += NT) sm[m.loc + i] = __ldg(a.loc_w + i);
  for (size_t i = gtid; i < sc.state_end; i += gstride) g[i] = 0.f;
  for (int s = 0; s < a.ns; ++s) {
    const size_t nk = (size_t)B * T * (a.u_off[s + 1] - a.u_off[s]);
    for (size_t i = gtid; i < nk; i += gstride) a.d_keys[s][i] = 0.f;
  }
  const size_t n_iacc = bwd_iacc_floats(a, gridDim.x);
  for (size_t i = tid; i < n_iacc; i += NT) sm[m.iacc + i] = 0.f;
  {
    float* outs[7] = {a.d_att, a.d_l1, a.d_l2, a.d_op, a.d_q, a.d_v, a.d_loc};
    const size_t n[7] = {(size_t)(Zatt + 1) * 4 * A, (size_t)(2 * D + 1) * 4 * D,
                         (size_t)(2 * D + 1) * 4 * D,
                         (size_t)(A + sumC + 1) * D, (size_t)A * sumU,
                         (size_t)sumU, (size_t)K * sumU};
    for (int j = 0; j < 7; ++j)
      for (size_t i = gtid; i < n[j]; i += gstride) outs[j][i] = 0.f;
    int width = a.cf;
    for (int li = 0; li < a.n_pre; ++li) {
      const size_t np = (size_t)(width + 1) * a.p_sizes[li];
      for (size_t i = gtid; i < np; i += gstride) a.d_pre_w[li][i] = 0.f;
      width = a.p_sizes[li];
    }
  }
  // the last two steps' save rows, and the last step's alignment columns
  // and output cotangents, into L2 (the forward wrote them long ago)
  l2_prefetch(save + (size_t)(S > 1 ? S - 2 : 0) * B * W, W, (S > 1 ? 2 : 1) * B,
              W);
  l2_prefetch(a.aux + (size_t)(S - 1) * a.ns * 3 * B * T, 0, 1,
              a.ns * 3 * B * T);
  l2_prefetch(a.g_y + (size_t)(S - 1) * B * D, 0, 1, B * D);
  clk.part(B_SETUP, P_EPI);
  grid.sync();
  clk.part(B_SETUP, P_WAIT);

  const int n_items = tr_att_items<true>(a);
  const size_t ia_floats = US + (size_t)K * US;
  for (int t = S - 1; t >= 0; --t) {
    const float* cur = save + (size_t)t * B * W;
    const float* prev = t > 0 ? save + (size_t)(t - 1) * B * W : nullptr;
    float* st = a.stash + (size_t)t * B * WS;
    const float* gy = a.g_y + (size_t)t * B * D;
    // ahead of their reads: the save rows of step t - 2, the alignment
    // columns and output cotangents of step t - 1
    if (t >= 2) l2_prefetch(save + (size_t)(t - 2) * B * W, 0, 1, B * W);
    if (t >= 1) {
      l2_prefetch(a.aux + (size_t)(t - 1) * a.ns * 3 * B * T, 0, 1,
                  a.ns * 3 * B * T);
      l2_prefetch(a.g_y + (size_t)(t - 1) * B * D, 0, 1, B * D);
    }

    // ---- lstm2 VJP, elementwise over (row, unit); the conv-adjoint
    // buffer that step t - 1 reads starts at 0 (last read at step t + 1)
    for (size_t i = gtid; i < nbt; i += gstride)
      g[sc.dCV + (size_t)((t + 1) & 1) * nbt + i] = 0.f;
    for (int e = gtid; e < B * D; e += gstride) {
      const int r = e / D, j = e % D;
      float gt[4], dg[4], dcp, dhp;
      for (int q = 0; q < 4; ++q)
        gt[q] = sv(__ldg(cur + (size_t)r * W + a.off_g2 + q * D + j));
      const float c_prev =
          prev ? sv(__ldg(prev + (size_t)r * W + a.off_c2 + j)) : 0.f;
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
    clk.part(B_LSTM2, P_EPI);
    grid.sync();
    clk.part(B_LSTM2, P_WAIT);

    // ---- d z2 = d_gates2 W2^T; its epilogue runs the lstm1 VJP
    stg.group(zs, ldz, 0, rg, st + a.off_dg2, WS, 4 * D);
    stg.wait();
    clk.part(B_DZ2_LSTM1, P_COPY);
    rows_mma<1, BF>(2 * D, 4 * D, rg, sm + m.w2, zs, ldz, part,
                [&](int n, int, int r, int, int, float acc) {
      if (n >= D) {
        const size_t e = (size_t)r * D + n - D;
        g[sc.dh2 + e] = __ldcg(g + sc.dh2_zo + e) + acc;
        return;
      }
      const size_t e = (size_t)r * D + n;
      const float d_o1 = __ldg(gy + e) + acc;
      g[sc.d_o1 + e] = d_o1;
      float gt[4], dg[4], dcp, dhp;
      for (int q = 0; q < 4; ++q)
        gt[q] = sv(__ldg(cur + (size_t)r * W + a.off_g1 + q * D + n));
      const float c_prev =
          prev ? sv(__ldg(prev + (size_t)r * W + a.off_c1 + n)) : 0.f;
      lstm_train_bwd(gt, c_prev, d_o1 + __ldcg(g + sc.dh1 + e),
                     __ldcg(g + sc.dc1 + e), a.zc_dec, a.zo_dec,
                     zkeep(a, t, MASK_ZC1, r, n, a.zc_dec),
                     zkeep(a, t, MASK_ZO1, r, n, a.zo_dec), det, dg, dcp,
                     dhp);
      for (int q = 0; q < 4; ++q)
        st[(size_t)r * WS + a.off_dg1 + q * D + n] = dg[q];
      g[sc.dc1 + e] = dcp;
      g[sc.dh1_zo + e] = dhp;
    }, clk, B_DZ2_LSTM1);
    grid.sync();
    clk.part(B_DZ2_LSTM1, P_WAIT);

    // ---- d z1 = d_gates1 W1^T -> d_proj, d h1
    stg.group(zs, ldz, 0, rg, st + a.off_dg1, WS, 4 * D);
    stg.wait();
    clk.part(B_DZ1, P_COPY);
    rows_mma<1, BF>(2 * D, 4 * D, rg, sm + m.w1, zs, ldz, part,
                [&](int n, int, int r, int, int, float acc) {
      if (n < D) {
        st[(size_t)r * WS + a.off_dproj + n] =
            __ldcg(g + sc.d_o1 + (size_t)r * D + n) + acc;
      } else {
        const size_t e = (size_t)r * D + n - D;
        g[sc.dh1 + e] = __ldcg(g + sc.dh1_zo + e) + acc;
      }
    }, clk, B_DZ1);
    grid.sync();
    clk.part(B_DZ1, P_WAIT);

    // ---- d zop = d_proj Wop^T -> d h_att (part), d ctx (to the stash)
    stg.group(zs, ldz, 0, rg, st + a.off_dproj, WS, D);
    stg.wait();
    clk.part(B_DZOP, P_COPY);
    rows_mma<1, BF>(A + sumC, D, rg, sm + m.wop, zs, ldz, part,
                [&](int n, int, int r, int, int, float acc) {
      if (n < A) {
        g[sc.dhatt_part + (size_t)r * A + n] = acc;
      } else {
        st[(size_t)r * WS + a.off_dctxs + n - A] =
            acc + __ldcg(g + sc.dctx + (size_t)r * sumC + n - A);
      }
    }, clk, B_DZOP);
    grid.sync();
    clk.part(B_DZOP, P_WAIT);

    // ---- d_w[src][b][tau] = values[tau] . d_ctx, a warp per memory row
    // (rows of both sources, source-major, spread over all warps), DR rows
    // of a warp at once with all their loads issued first
    {
      constexpr int DR = 4, DL = 8;
      const int nw = gridDim.x * NWARPS;
      for (int j0 = blockIdx.x * NWARPS + warp; j0 < (int)nbt; j0 += DR * nw) {
        float x[DR][DL], y[DR][DL], acc[DR];
        int C[DR], cmax = 0;
        const float* vals[DR];
        const float* dc[DR];
#pragma unroll
        for (int r = 0; r < DR; ++r) {
          const int j = j0 + r * nw;
          const int src = j < (int)nbt ? j / (B * T) : 0;
          const int b = (j / T) % B, tau = j % T;
          C[r] = j < (int)nbt ? a.c_off[src + 1] - a.c_off[src] : 0;
          vals[r] = a.values[src] + ((size_t)b * T + tau) * C[r];
          dc[r] = st + (size_t)b * WS + a.off_dctxs + a.c_off[src];
          acc[r] = 0.f;
          cmax = max(cmax, C[r]);
        }
        for (int c0 = 0; c0 < cmax; c0 += 32 * DL) {
#pragma unroll
          for (int r = 0; r < DR; ++r)
#pragma unroll
            for (int i = 0; i < DL; ++i) {
              const int c = c0 + lane + 32 * i;
              x[r][i] = c < C[r] ? __ldg(vals[r] + c) : 0.f;
              y[r][i] = c < C[r] ? __ldcg(dc[r] + c) : 0.f;
            }
#pragma unroll
          for (int r = 0; r < DR; ++r)
#pragma unroll
            for (int i = 0; i < DL; ++i) acc[r] = fmaf(x[r][i], y[r][i], acc[r]);
        }
#pragma unroll
        for (int r = 0; r < DR; ++r) {
          const float sum = warp_sum(acc[r]);
          if (lane == 0 && j0 + r * nw < (int)nbt) g[sc.dw + j0 + r * nw] = sum;
        }
      }
    }
    clk.part(B_DW_ATT, P_EPI);
    grid.sync();
    clk.part(B_DW_ATT, P_WAIT);

    // ---- attention VJP, (source, row, 32 units) items
    for (int i = blockIdx.x + hf.h * gridDim.x, j = hf.h; i < n_items;
         i += 2 * gridDim.x, j += 2) {   // two at once, a half block each
      const AttItem it = tr_att_item<true>(a, i);
      clk.item_begin();
      vjp_item(a, m, sc, sm, t, it, sm + m.iacc + j * ia_floats, hf, clk);
      clk.item_end(it.src);
    }
    __syncthreads();
    clk.part(B_ATTENTION, P_EPI);
    grid.sync();
    clk.part(B_ATTENTION, P_WAIT);

    // ---- d h_att += d_pq Wq^T; its epilogue runs the attention-LSTM VJP
    stg.group(zs, ldz, 0, rg, st + a.off_dpq, WS, sumU);
    stg.wait();
    clk.part(B_DQ_ATT_LSTM, P_COPY);
    rows_mma<1, BF>(A, sumU, rg, sm + m.wq, zs, ldz, part,
                [&](int n, int, int r, int, int, float acc) {
      const size_t e = (size_t)r * A + n;
      float gt[4], dg[4], dcp, dhp;
      for (int q = 0; q < 4; ++q)
        gt[q] = sv(__ldg(cur + (size_t)r * W + a.off_gatt + q * A + n));
      const float c_prev =
          prev ? sv(__ldg(prev + (size_t)r * W + a.off_catt + n)) : 0.f;
      const float dh = __ldcg(g + sc.dhatt_part + e) + acc +
                       __ldcg(g + sc.dh_att + e);
      lstm_train_bwd(gt, c_prev, dh, __ldcg(g + sc.dc_att + e), a.zc_att,
                     a.zo_att, zkeep(a, t, MASK_ZC_ATT, r, n, a.zc_att),
                     zkeep(a, t, MASK_ZO_ATT, r, n, a.zo_att), det, dg, dcp,
                     dhp);
      for (int q = 0; q < 4; ++q)
        st[(size_t)r * WS + a.off_dgatt + q * A + n] = dg[q];
      g[sc.dc_att + e] = dcp;
      g[sc.dhatt_zo + e] = dhp;
    }, clk, B_DQ_ATT_LSTM);
    grid.sync();
    clk.part(B_DQ_ATT_LSTM, P_WAIT);

    // ---- d z_att over the [ctx | h_att] rows of W_att
    stg.group(zs, ldz, 0, rg, st + a.off_dgatt, WS, 4 * A);
    stg.wait();
    clk.part(B_DZATT, P_COPY);
    rows_mma<1, BF>(sumC + A, 4 * A, rg, sm + m.watt, zs, ldz, part,
                [&](int n, int, int r, int, int, float acc) {
      if (n < sumC) {
        g[sc.dctx + (size_t)r * sumC + n] = acc;
      } else {
        const size_t e = (size_t)r * A + n - sumC;
        g[sc.dh_att + e] = __ldcg(g + sc.dhatt_zo + e) + acc;
      }
    }, clk, B_DZATT);
    grid.sync();
    clk.part(B_DZATT, P_WAIT);
  }

  bwd_tail<BF>(a, m, sc, sm, clk, grid);
  clk.flush();
}

// ------------------------------------------------------------------- host
extern "C" long long fused_train_bwd_scratch_floats(const TrainArgs* a) {
  return (long long)(bwd_scratch(*a).total + TR_SYNC_WORDS +
                     bwd_bf16_floats(*a));
}

extern "C" long long fused_train_bwd_smem_bytes(const TrainArgs* a, int nb) {
  return (long long)(bwd_smem(*a, nb).total * sizeof(float));
}

extern "C" int fused_train_bwd_launch(const TrainArgs* args, void* stream) {
  int sms = 0, e = tr_sms(&sms);
  if (e) return e;
  return tr_launch(args->bf16 ? fused_train_bwd_kernel<true>
                              : fused_train_bwd_kernel<false>,
                   *args, bwd_smem(*args, sms).total,
                   bwd_scratch(*args).total, sms, stream);
}
