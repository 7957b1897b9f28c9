// The whole batch-1 inference encoder: prenet -> conv bank -> max pool ->
// two projections -> residual -> highway layers -> zoneout bi-LSTM ->
// self-attention projection and hops.
//
// Replaces: self_attention_tacotron_tpu/ops/fused_encoder.py `_kernel`
// (Pallas, reached through `fused_encode`).
//
// What bounds it on the H100: at the recipe (T = 64 phones, E = 128,
// K = 16 bank widths of 128 channels, a 128-unit bi-LSTM, one 32-unit
// self-attention hop) the function needs ~0.46 GFLOP, ~60 % of it the
// conv bank, and ~14.4 MB of f32 operands read once (width k of the bank
// has k taps: 8.9 MB).  Those are ~4.3 us of bytes and ~6.8 us of FP32
// FMA at the card's peaks.  What a call costs beyond that is latency: the
// bi-LSTM's 64 dependent steps, the barriers between layers, and each
// layer's round trip to L2 for its operands.
//
// Design: two launches on the stream, one call.
//
// 1. The trunk, prenet to the LSTM's input products, is one cooperative
//    launch, one block per SM, with the hand-written GridBarrier of
//    common.cuh between dependent layers.  Every layer is a set of items,
//    64 rows x 8 output columns each, spread over the blocks.  An item
//    copies its operands into shared memory at once with cp.async (the
//    rows of its input as a slab, and its weight columns), so it waits
//    one round trip, then multiplies on the tensor cores: mma.sync m16n8k8
//    TF32 in the 3xTF32 split of mma.cuh, each 8-deep step from zero and
//    added in f32 (f32 accuracy).  Eight warps: four 16-row tiles times two
//    halves of the depth, added in shared memory before the epilogue.
//    A convolution is the same product over shifted slab rows: tap j of
//    an output row reads slab row (m + j + offset).  The bank walks its
//    widths in pairs (k, K + 1 - k), so an item does K + 1 taps and 128
//    items cover it; width k reads only its k taps of the stacked weight
//    (its SAME offsets), never the zero blocks of the narrower widths.
//    The max pool is a pass in shared memory once the first projection's
//    rows have arrived; that projection splits its 3 x K x C depth over
//    channel chunks (128 items) whose partial sums meet in L2 (atomics);
//    the second projection adds the bias and the ReLU in its slab.
// 2. The bi-LSTM and the self-attention hop are one launch of a cluster
//    of 8 blocks, 4 a direction.  Each block holds its 32 units' rows of
//    the recurrent weight for the whole loop, half a row in each of two
//    threads' registers, so a step reads no weight at all; the steps'
//    input halves arrive by cp.async 32 steps ahead.  A step is that
//    block's 128 dot products with h, each gate activated on its own lane,
//    the cell on the unit's first lane, and the new h sent into the
//    shared memory of the direction's 4 blocks with st.async, which
//    completes on each destination's mbarrier: a block waits for its
//    direction's h only, and there is no grid or cluster barrier in the
//    loop.  The hop's products use the same items on the cluster's
//    blocks; its 64 x 64 attention (0.1 MFLOP) stays on FP32 FMAs, one
//    warp a (head, query row), from K | V | Q rows in shared memory.  A
//    source whose rows do not fit there (T > 533 at the recipes' widths,
//    ``hop_streams``) streams them instead: a block takes a head's 64
//    query rows at a time and folds every 64-key tile online in registers,
//    both products on mma.sync in the 3xTF32 split, the rows staged by
//    cp.async in a ring of HOP_STAGES = 4 buffers (stream_hop,
//    csrc/attention_rows.cuh), so the kernel takes any source length.
//
// Any configuration the JAX kernel takes (its only bound is VMEM):
// * widths that are not multiples of 4 (or operands not 16-byte aligned)
//   take the instance kV4 = false, whose copies move 4 bytes a thread
//   (cp4) where the recipes' instance moves 16 (cp16); the epilogues write
//   a last odd column alone.  The wrapper chooses (``vector_copies``).
// * the layers' weights and widths come from a table in device memory
//   (pointers and widths, as many as the configuration has), so prenet,
//   highway and hop counts are not bounded.
// * the recurrence holds 32 units a block: a cluster of 8 blocks (4 a
//   direction) up to 128 units, of 16 (8 a direction, a non-portable
//   cluster size) up to 256.  An odd H is the same code (h is padded to 8
//   with zeros); only its rows are not 16-byte aligned (kV4 = false).
#include <cstddef>
#include <cstdint>

#include "attention_rows.cuh"
#include "cluster.cuh"
#include "common.cuh"
#include "mma.cuh"

constexpr int MT = 64;          // rows an item
constexpr int NI = 8;           // output columns an item
constexpr int DENSE_C = 256;    // channels a dense layer's slab holds
constexpr int BANK_C = 128;     // channels the bank's slab holds
constexpr int PROJ1_C = 256;    // channels of a first-projection split
constexpr int RED_FLOATS = 4 * 32 * 4;  // the depth halves' partial tiles
// The recurrent cluster holds both directions, DIRB blocks each; a block's
// 4 x units gate rows, two threads a row: H <= DIRB * 32.
constexpr int UNITS_A_BLOCK = NT / 8;
__host__ __device__ inline int dir_blocks(int H) {
  return H <= 4 * UNITS_A_BLOCK ? 4 : 8;
}
constexpr int MAX_H = 8 * UNITS_A_BLOCK;   // a 16-block cluster: 256 units

struct EncArgs {  // mirrored by _EncArgs in ops/fused_encoder.py
  const float* x;
  int T, L, E_in, n_prenet;
  int pre_max;  // the widest of E_in and the prenet layers (host plans)
  // device tables, n_prenet entries each
  const float* const* pre_w;
  const float* const* pre_b;
  const int* pre_out;
  const float* bank_w;
  const float* bank_b;
  int K, C;
  const float* p1_w;
  const float* p1_b;
  int P1;
  const float* p2_w;
  const float* p2_b;
  int P2;
  const float* adj_w;
  const float* adj_b;
  int n_highway;
  const float* const* hw_w;   // device tables, n_highway entries each
  const float* const* hw_b;
  int W, H;
  const float* lstm_wx[2];
  const float* lstm_whT[2];
  const float* lstm_b[2];
  float zc, zo;
  const float* sa_w;
  const float* sa_b;
  int SA;
  int n_hops, n_heads;
  const float* const* kvq_w;  // device tables, n_hops entries each
  const float* const* kvq_b;
  const float* const* ot_w;
  const float* const* ot_b;
  float* lstm_out;  // (T, 2H)
  float* sa_out;    // (T, SA)
  float* scratch;
  long long* stage_cycles;  // optional (ENC_STAGES x ENC_PARTS), EncClock
  int v4;           // every width a multiple of 4, every operand 16-byte
                    // aligned: the instance with 16-byte copies
};

// the profile's slots: stage x part
enum EncStage { ES_PRENET, ES_BANK, ES_PROJ, ES_HIGHWAY, ES_LSTM_INPUT,
                ES_LSTM_STEPS, ES_SELF_ATTENTION, ENC_STAGES };
enum EncPart { P_LOAD, P_PRODUCT, P_WAIT, ENC_PARTS };

// Optional profile: block 0's thread 0 sums the SM cycles since its last
// mark into sums[stage * ENC_PARTS + part] (thread-local, so a mark costs
// no round trip) and adds them to ``counts`` when the kernel ends: P_LOAD
// copying an item's operands in, P_PRODUCT its product and epilogue (a
// recurrent step's dot products and cell), P_WAIT the barrier after a
// layer or step.
struct EncClock {
  long long* counts;
  long long last;
  int stage;
  long long sums[ENC_STAGES * ENC_PARTS];
  __device__ explicit EncClock(long long* c) : counts(c), last(0), stage(0) {
    if (on()) {
      for (int i = 0; i < ENC_STAGES * ENC_PARTS; ++i) sums[i] = 0;
      last = clock64();
    }
  }
  __device__ bool on() const {
    return counts != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  }
  __device__ void part(int p) {
    if (on()) {
      const long long now = clock64();
      sums[stage * ENC_PARTS + p] += now - last;
      last = now;
    }
  }
  __device__ void flush() {
    if (on())
      for (int i = 0; i < ENC_STAGES * ENC_PARTS; ++i) counts[i] += sums[i];
  }
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int round8(int n) { return (n + 7) & ~7; }
// a slab's row stride: 4 mod 32, so an mma fragment's 8 x 4 lanes read 32
// banks
__host__ __device__ inline int slab_ld(int cp) { return ((cp + 31) & ~31) + 4; }
// floats a dense layer of depth K stages
__host__ __device__ inline int dense_floats(int K) {
  const int cw = imin(round8(K), DENSE_C);
  return MT * slab_ld(cw) + cw * NI + NI;
}
__host__ __device__ inline int proj1_chunk(const EncArgs& a) {
  return imin(round8(a.K * a.C), PROJ1_C);
}
__host__ __device__ inline int proj1_splits(const EncArgs& a) {
  return cdiv(a.K * a.C, proj1_chunk(a));
}
// The recurrent block's plan: h by parity (H rounded up to 8, zeros past
// H), RNN_GX_STEPS steps of its gate rows' (R = 4 x units) input halves by
// group parity, and the two h buffers' mbarriers.
constexpr int RNN_GX_STEPS = 32;
__host__ __device__ inline int rnn_rows(int H) {
  return 4 * cdiv(H, dir_blocks(H));
}
__host__ __device__ inline int rnn_floats(int H) {
  return 2 * round8(H) + 2 * RNN_GX_STEPS * rnn_rows(H) + 4;
}

struct EncLayout {
  size_t pre0, pre1, banked, p1, hwA, hwB, gx0, gx1, sa0, sa1, kvq, ctx,
      bar, total;
};

__host__ __device__ inline EncLayout enc_layout(const EncArgs& a) {
  const int maxw = imax(imax(a.P2, a.W), a.pre_max);
  const size_t T = a.T;
  EncLayout l;
  size_t o = 0;   // each region a multiple of 4 floats where the widths are
  l.pre0 = o; o += T * maxw;
  l.pre1 = o; o += T * maxw;
  l.banked = o; o += T * a.K * a.C;
  l.p1 = o; o += T * a.P1;
  l.hwA = o; o += T * maxw;
  l.hwB = o; o += T * maxw;
  l.gx0 = o; o += T * 4 * a.H;
  l.gx1 = o; o += T * 4 * a.H;
  l.sa0 = o; o += T * a.SA;
  l.sa1 = o; o += T * a.SA;
  l.kvq = o; o += T * 3 * a.SA;
  l.ctx = o; o += T * a.SA;
  l.bar = o; o += GRID_BAR_WORDS;
  l.total = o;
  return l;
}

// shared memory (floats) of the trunk's block and of the recurrent one
__host__ __device__ inline int trunk_smem_floats(const EncArgs& a) {
  // every prenet layer's input, and the last one's output, which the
  // residual makes P2 (dense_floats grows with its width)
  int f = dense_floats(a.pre_max);
  const int cb = imin(round8(a.P2), BANK_C);
  f = imax(f, (MT + a.K - 1) * slab_ld(cb) + (a.K + 1) * cb * NI + 2 * NI);
  const int c1 = proj1_chunk(a);
  f = imax(f, (2 * MT + 5) * slab_ld(c1) + 3 * c1 * NI);
  const int c2 = imin(round8(a.P1), DENSE_C);
  f = imax(f, (MT + 2) * slab_ld(c2) + 3 * c2 * NI + c2 + NI + MT * NI);
  f = imax(f, dense_floats(a.P2));
  f = imax(f, dense_floats(a.W));
  return f + RED_FLOATS;
}

// The hop's attention holds the source's K | V | Q rows and each warp's
// scores in shared memory while they fit beside the rest of the recurrent
// block's plan in the 227 KB a block may opt in to (T <= 533 at the
// recipes' widths); past that it streams them (stream_hop), whose buffers
// grow with neither T nor the head width.
constexpr int SMEM_OPT_IN = 232448;
__host__ __device__ inline int hop_resident_floats(const EncArgs& a) {
  return a.T * (round8(3 * a.SA) + 4) + NWARPS * a.T;
}
__host__ __device__ inline bool hop_streams(const EncArgs& a) {
  const int f = imax(imax(rnn_floats(a.H), dense_floats(2 * a.H)),
                     dense_floats(a.SA));
  return 4LL * (imax(f, hop_resident_floats(a)) + RED_FLOATS) > SMEM_OPT_IN;
}

__host__ __device__ inline int rnn_smem_floats(const EncArgs& a) {
  int f = rnn_floats(a.H);
  f = imax(f, dense_floats(2 * a.H));
  f = imax(f, dense_floats(a.SA));
  f = imax(f, hop_streams(a) ? hop_stream_floats() : hop_resident_floats(a));
  return f + RED_FLOATS;
}

// ------------------------------------------------------------ the items

// Rows r < rows of the slab: sequence row row0 + r of X (leading dim ldx;
// zero outside [0, M)), channels [c0, c0 + cw), zero-padded to cp.  kV4:
// 16 bytes a copy (ldx, c0 and cw multiples of 4), else 4.
template <bool kV4>
__device__ void cp_slab(float* slab, int ld, int rows, int cp,
                        const float* X, int ldx, int M, int row0, int c0,
                        int cw) {
  constexpr int S = kV4 ? 4 : 1;
  const int n4 = cp / S;
  for (int e = threadIdx.x; e < rows * n4; e += NT) {
    const int r = e / n4, c = (e - r * n4) * S, row = row0 + r;
    const bool ok = row >= 0 && row < M && c < cw;
    const float* src = ok ? X + (size_t)row * ldx + c0 + c : X;
    if constexpr (kV4) cp16(slab + r * ld + c, src, ok);
    else cp4(slab + r * ld + c, src, ok);
  }
}

// Rows i < rows of the weight tile: row row_of(i) of W (-1: zero),
// columns [col, col + NI) (zero at or past col_end).
template <bool kV4, class RowOf>
__device__ void cp_wtile(float* sw, int rows, const float* W, int ldw,
                         int col, int col_end, const RowOf& row_of) {
  constexpr int S = kV4 ? 4 : 1, PER = NI / S;
  for (int e = threadIdx.x; e < rows * PER; e += NT) {
    const int i = e / PER, n = col + (e % PER) * S, wr = row_of(i);
    const bool ok = wr >= 0 && n < col_end;
    const float* src = ok ? W + (size_t)wr * ldw + n : W;
    if constexpr (kV4) cp16(sw + e * S, src, ok);
    else cp4(sw + e, src, ok);
  }
}

// A row of n floats from global into shared memory, zero from cw on.
template <bool kV4>
__device__ __forceinline__ void cp_row(float* dst, const float* src, int n,
                                       int cw, int tid, int nthreads) {
  constexpr int S = kV4 ? 4 : 1;
  for (int e = tid; e < n / S; e += nthreads) {
    const bool ok = e * S < cw;
    if constexpr (kV4) cp16(dst + 4 * e, ok ? src + 4 * e : src, ok);
    else cp4(dst + e, ok ? src + e : src, ok);
  }
}

// acc += the item's product over taps j < taps: slab row (m + roff + j)
// against weight rows j * cp .. j * cp + cp - 1, on this warp's 16-row
// tile and half of the channel steps.  Fragments: a0 = A[g][t], a1 =
// A[g + 8][t], a2 = A[g][t + 4], a3 = A[g + 8][t + 4]; b0 = B[t][g], b1 =
// B[t + 4][g] (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void item_mma(float (&acc)[4], const float* slab,
                                         int ld, int roff, const float* sw,
                                         int taps, int cp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, mi = warp & 3, half = warp >> 2;
  const int steps = cp / 8, split = (steps + 1) / 2;
  const int sb = half ? split : 0, se = half ? steps : split;
  for (int j = 0; j < taps; ++j) {
    const float* a0 = slab + (mi * 16 + g + roff + j) * ld + t;
    const float* a1 = a0 + 8 * ld;
    const float* b = sw + ((size_t)j * cp + t) * NI + g;
#pragma unroll 4
    for (int s = sb; s < se; ++s) {
      const int c = s * 8;
      uint32_t ah[4], al[4], bh[2], bl[2];
      tf32_split(a0[c], ah[0], al[0]);
      tf32_split(a1[c], ah[1], al[1]);
      tf32_split(a0[c + 4], ah[2], al[2]);
      tf32_split(a1[c + 4], ah[3], al[3]);
      tf32_split(b[c * NI], bh[0], bl[0]);
      tf32_split(b[(c + 4) * NI], bh[1], bl[1]);
      mma3(acc, ah, al, bh, bl);
    }
  }
}

// The 8 bias entries of an item's columns [col, col + NI) into shared
// memory (zero at or past col_end), with its operands.
template <bool kV4>
__device__ __forceinline__ void cp_bias(float* sb, const float* b, int col,
                                        int col_end) {
  if (threadIdx.x < NI)
    cp_row<kV4>(sb, b + col, NI, col_end - col, threadIdx.x, NI);
}

// Adds the two depth halves (through ``red``) and the bias (``sb``, the
// item's 8 entries in shared memory, or nullptr) and runs ``epi(m, n, v,
// w, xs)`` for columns n, n + 1 of rows m < M: n = n0 + 2 t, rows g and
// g + 8 of the warp's tile (the accumulator layout of m16n8); xs = xs0 +
// (m - m0) xld, a row of operands in shared memory (or nullptr).  Ends
// with a block barrier, so ``red`` is free again.
template <class Epi>
__device__ void item_finish(float (&acc)[4], float* red, int m0, int n0,
                            int M, const Epi& epi, const float* sb,
                            const float* xs0 = nullptr, int xld = 0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mi = warp & 3, half = warp >> 2;
  float* mine = red + (mi * 32 + lane) * 4;
  if (half)
#pragma unroll
    for (int c = 0; c < 4; ++c) mine[c] = acc[c];
  __syncthreads();
  if (!half) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] += mine[c];
    const int r = mi * 16 + (lane >> 2), t2 = 2 * (lane & 3);
    const float b0 = sb ? sb[t2] : 0.f, b1 = sb ? sb[t2 + 1] : 0.f;
    const int m = m0 + r, n = n0 + t2;
    if (m < M)
      epi(m, n, acc[0] + b0, acc[1] + b1, xs0 ? xs0 + r * xld : nullptr);
    if (m + 8 < M)
      epi(m + 8, n, acc[2] + b0, acc[3] + b1,
          xs0 ? xs0 + (r + 8) * xld : nullptr);
  }
  __syncthreads();
}

// C = epi(X (M, K) @ W (K, N) + b) over items (64 rows, 8 columns), item i
// on block i % nblk counted from ``first`` (so two layers of one stage can
// start on different blocks); the depth in slabs of DENSE_C channels.
// With K <= DENSE_C the epilogue gets the item's input row (xs).
template <bool kV4, class Epi>
__device__ void dense_stage(int M, int N, int K, const float* X, int ldx,
                            const float* W, int ldw, const float* b,
                            const Epi& epi, float* smem, int bid, int nblk,
                            EncClock& clk, int first = 0) {
  const int nt = cdiv(N, NI), items = cdiv(M, MT) * nt;
  const int cmax = imin(round8(K), DENSE_C), ld = slab_ld(cmax);
  float* slab = smem;
  float* sw = slab + MT * ld;
  float* sb = sw + cmax * NI;
  float* red = sb + NI;
  for (int it = (bid - first % nblk + nblk) % nblk; it < items; it += nblk) {
    const int m0 = (it / nt) * MT, n0 = (it % nt) * NI;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    cp_bias<kV4>(sb, b, n0, N);
    for (int c0 = 0; c0 < K; c0 += DENSE_C) {
      const int cw = imin(K - c0, DENSE_C), cp = round8(cw);
      cp_slab<kV4>(slab, ld, MT, cp, X, ldx, M, m0, c0, cw);
      cp_wtile<kV4>(sw, cp, W, ldw, n0, N,
               [&](int i) { return i < cw ? c0 + i : -1; });
      cp_wait();
      __syncthreads();
      clk.part(P_LOAD);
      item_mma(acc, slab, ld, 0, sw, 1, cp);
      __syncthreads();
    }
    item_finish(acc, red, m0, n0, M, epi, sb, K <= DENSE_C ? slab : nullptr,
                ld);
    clk.part(P_PRODUCT);
  }
}

// ------------------------------------------------------------- epilogues
// Each gets the biased sums v, w of columns n, n + 1 of row m (n even;
// column n + 1 is past an odd width's last).
struct EpiBias {  // out = act(v)
  float* out;
  int ld, N;
  bool relu;
  __device__ void operator()(int m, int n, float v, float w,
                             const float*) const {
    if (n >= N) return;
    out[(size_t)m * ld + n] = relu ? fmaxf(v, 0.f) : v;
    if (n + 1 < N) out[(size_t)m * ld + n + 1] = relu ? fmaxf(w, 0.f) : w;
  }
};

struct EpiBank {  // width k's columns: out = relu(v), base (k-1) C
  float* out;
  int ld, C, base;
  __device__ void operator()(int m, int n, float v, float w,
                             const float*) const {
    if (n >= C) return;
    out[(size_t)m * ld + base + n] = fmaxf(v, 0.f);
    if (n + 1 < C) out[(size_t)m * ld + base + n + 1] = fmaxf(w, 0.f);
  }
};

struct EpiAdd {  // a first-projection chunk's partial sums, added
  float* out;
  int ld;
  __device__ void operator()(int m, int n, float v, float w,
                             const float*) const {
    if (n >= ld) return;
    atomicAdd(out + (size_t)m * ld + n, v);
    if (n + 1 < ld) atomicAdd(out + (size_t)m * ld + n + 1, w);
  }
};

struct EpiResidual {  // out = v + res  (proj2 + prenet output, res = xs)
  float* out;
  int ld;
  __device__ void operator()(int m, int n, float v, float w,
                             const float* xs) const {
    if (n >= ld) return;
    out[(size_t)m * ld + n] = v + xs[n];
    if (n + 1 < ld) out[(size_t)m * ld + n + 1] = w + xs[n + 1];
  }
};

// Interleaved highway columns: 2j = H gate, 2j + 1 = T gate of unit j, the
// two columns one thread holds; the input x from xs (the item's slab row)
// or, for a layer deeper than one slab, from L2.
struct EpiHighway {
  float* out;
  int W;
  const float* xin;
  __device__ void operator()(int m, int n, float v, float w,
                             const float* xs) const {
    if (n >= 2 * W) return;
    const int j = n >> 1;
    const float x = xs ? xs[j] : __ldcg(xin + (size_t)m * W + j);
    const float tg = sigmoid(w);
    out[(size_t)m * W + j] = fmaxf(v, 0.f) * tg + x * (1.f - tg);
  }
};

struct EpiHop {  // out = prev + tanh(v)
  float* out;
  int ld;
  const float* prev;
  __device__ void operator()(int m, int n, float v, float w,
                             const float*) const {
    if (n >= ld) return;
    const size_t o = (size_t)m * ld + n;
    out[o] = __ldcg(prev + o) + tanhf(v);
    if (n + 1 < ld) out[o + 1] = __ldcg(prev + o + 1) + tanhf(w);
  }
};

// ------------------------------------------------------ the trunk stages

// The bank: items (64 rows, width pair (k, K + 1 - k), 8 columns), width
// k's output columns (k - 1) C .. k C - 1 from its k taps only.  The slab
// holds rows m0 - pad .. m0 + 63 + (K - 1 - pad) of h (pad = (K - 1) / 2,
// the stacked window's), so width k's tap j of row m is slab row
// (m - m0) + first_k + j, first_k = pad - (k - 1) / 2 (its SAME offset).
template <bool kV4>
__device__ void bank_stage(const EncArgs& a, const float* h, int E,
                           float* banked, float* smem, EncClock& clk) {
  const int T = a.T, K = a.K, C = a.C, KC = K * C;
  const int pad = K > 1 ? (K - 1) / 2 : 0, pairs = (K + 1) / 2;
  const int nt = cdiv(C, NI), items = cdiv(T, MT) * pairs * nt;
  const int cmax = imin(round8(E), BANK_C), ld = slab_ld(cmax);
  const int rows = MT + K - 1;
  float* slab = smem;
  float* sw = slab + rows * ld;
  float* sb = sw + (K + 1) * cmax * NI;   // the two widths' bias entries
  float* red = sb + 2 * NI;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int n0 = (it % nt) * NI, p = (it / nt) % pairs;
    const int m0 = (it / (nt * pairs)) * MT;
    const int k1 = p + 1, k2 = K - p;
    const bool two = k2 != k1;
    const int f1 = pad - (k1 - 1) / 2, f2 = pad - (k2 - 1) / 2;
    float acc1[4] = {0.f, 0.f, 0.f, 0.f}, acc2[4] = {0.f, 0.f, 0.f, 0.f};
    cp_bias<kV4>(sb, a.bank_b, (k1 - 1) * C + n0, k1 * C);
    cp_bias<kV4>(sb + NI, a.bank_b, (k2 - 1) * C + n0, k2 * C);
    for (int c0 = 0; c0 < E; c0 += BANK_C) {
      const int cw = imin(E - c0, BANK_C), cp = round8(cw);
      float* sw2 = sw + k1 * cp * NI;
      cp_slab<kV4>(slab, ld, rows, cp, h, E, T, m0 - pad, c0, cw);
      cp_wtile<kV4>(sw, k1 * cp, a.bank_w, KC, (k1 - 1) * C + n0, k1 * C,
               [&](int i) {
                 const int j = i / cp, c = i - j * cp;
                 return c < cw ? (f1 + j) * E + c0 + c : -1;
               });
      if (two)
        cp_wtile<kV4>(sw2, k2 * cp, a.bank_w, KC, (k2 - 1) * C + n0,
                      k2 * C,
                 [&](int i) {
                   const int j = i / cp, c = i - j * cp;
                   return c < cw ? (f2 + j) * E + c0 + c : -1;
                 });
      cp_wait();
      __syncthreads();
      clk.part(P_LOAD);
      item_mma(acc1, slab, ld, f1, sw, k1, cp);
      if (two) item_mma(acc2, slab, ld, f2, sw2, k2, cp);
      __syncthreads();
    }
    item_finish(acc1, red, m0, n0, T, EpiBank{banked, KC, C, (k1 - 1) * C},
                sb);
    if (two)
      item_finish(acc2, red, m0, n0, T,
                  EpiBank{banked, KC, C, (k2 - 1) * C}, sb + NI);
    clk.part(P_PRODUCT);
  }
}

// The first projection over the width-2 stride-1 max pool of ``banked``
// (width-3 windows, pad 1): items (64 rows, 8 columns, a chunk of the K C
// channels).  The raw rows m0 - 1 .. m0 + 65 of the chunk arrive by
// cp.async; a pass in shared memory pools them (max(banked[r],
// banked[r + 1]), the last row alone since banked >= 0 and rows past T
// are copied as zeros; rows outside [0, T) zero) into the slab.  Each item
// adds its partial sums into ``p1`` (zeroed before the bank) with atomics.
template <bool kV4>
__device__ void proj1_stage(const EncArgs& a, const float* banked,
                            float* p1, float* smem, EncClock& clk) {
  const int T = a.T, KC = a.K * a.C, P1 = a.P1;
  const int chunk = proj1_chunk(a), splits = proj1_splits(a);
  const int nt = cdiv(P1, NI), items = cdiv(T, MT) * nt * splits;
  const int ld = slab_ld(chunk), rows = MT + 2;
  float* slab = smem;
  float* sw = slab + rows * ld;
  float* raw = sw + 3 * chunk * NI;
  float* red = raw + (rows + 1) * ld;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int sp = it % splits, n0 = ((it / splits) % nt) * NI;
    const int m0 = (it / (splits * nt)) * MT;
    const int c0 = sp * chunk, cw = imin(KC - c0, chunk), cp = round8(cw);
    cp_slab<kV4>(raw, ld, rows + 1, cp, banked, KC, T, m0 - 1, c0, cw);
    cp_wtile<kV4>(sw, 3 * cp, a.p1_w, P1, n0, P1, [&](int i) {
      const int j = i / cp, c = i - j * cp;
      return c < cw ? j * KC + c0 + c : -1;
    });
    cp_wait();
    __syncthreads();
    const int n4 = cp / 4;
    for (int e = threadIdx.x; e < rows * n4; e += NT) {
      const int r = e / n4, c = (e - r * n4) * 4, row = m0 - 1 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row >= 0 && row < T) {
        const float4 x = *reinterpret_cast<const float4*>(raw + r * ld + c);
        const float4 y =
            *reinterpret_cast<const float4*>(raw + (r + 1) * ld + c);
        v = make_float4(fmaxf(x.x, y.x), fmaxf(x.y, y.y), fmaxf(x.z, y.z),
                        fmaxf(x.w, y.w));
      }
      *reinterpret_cast<float4*>(slab + r * ld + c) = v;
    }
    __syncthreads();
    clk.part(P_LOAD);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    item_mma(acc, slab, ld, 0, sw, 3, cp);
    __syncthreads();
    item_finish(acc, red, m0, n0, T, EpiAdd{p1, P1}, nullptr);
    clk.part(P_PRODUCT);
  }
}

// The second projection (width-3 windows, pad 1) + bias + the prenet
// output: its slab, rows m0 - 1 .. m0 + 64 of p1 by cp.async, becomes
// relu(p1 + b1) in a pass in shared memory (rows outside [0, T) zero).
template <bool kV4>
__device__ void proj2_stage(const EncArgs& a, const float* p1,
                            const float* h, float* out, float* smem,
                            EncClock& clk) {
  const int T = a.T, P1 = a.P1, P2 = a.P2;
  const int nt = cdiv(P2, NI), items = cdiv(T, MT) * nt;
  const int cmax = imin(round8(P1), DENSE_C), ld = slab_ld(cmax);
  const int rows = MT + 2;
  float* slab = smem;
  float* sw = slab + rows * ld;
  float* sb = sw + 3 * cmax * NI;      // b1's chunk
  float* sb2 = sb + cmax;              // b2's item entries
  float* sres = sb2 + NI;              // the residual's rows (64 x 8)
  float* red = sres + MT * NI;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int n0 = (it % nt) * NI, m0 = (it / nt) * MT;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    cp_bias<kV4>(sb2, a.p2_b, n0, P2);
    // the residual's rows: 64 rows x 8 columns, as a weight tile is laid
    cp_wtile<kV4>(sres, MT, h, P2, n0, P2,
                  [&](int r) { return m0 + r < T ? m0 + r : -1; });
    for (int c0 = 0; c0 < P1; c0 += DENSE_C) {
      const int cw = imin(P1 - c0, DENSE_C), cp = round8(cw), n4 = cp / 4;
      cp_slab<kV4>(slab, ld, rows, cp, p1, P1, T, m0 - 1, c0, cw);
      cp_wtile<kV4>(sw, 3 * cp, a.p2_w, P2, n0, P2, [&](int i) {
        const int j = i / cp, c = i - j * cp;
        return c < cw ? j * P1 + c0 + c : -1;
      });
      cp_row<kV4>(sb, a.p1_b + c0, cp, cw, threadIdx.x, NT);
      cp_wait();
      __syncthreads();
      for (int e = threadIdx.x; e < rows * n4; e += NT) {
        const int r = e / n4, c = (e - r * n4) * 4, row = m0 - 1 + r;
        if (row < 0 || row >= T) continue;
        float4* x = reinterpret_cast<float4*>(slab + r * ld + c);
        const float4 b = *reinterpret_cast<const float4*>(sb + c);
        const float4 v = *x;
        *x = make_float4(fmaxf(v.x + b.x, 0.f), fmaxf(v.y + b.y, 0.f),
                         fmaxf(v.z + b.z, 0.f), fmaxf(v.w + b.w, 0.f));
      }
      __syncthreads();
      clk.part(P_LOAD);
      item_mma(acc, slab, ld, 0, sw, 3, cp);
      __syncthreads();
    }
    item_finish(acc, red, m0, n0, T, EpiResidual{out, P2}, sb2, sres - n0,
                NI);
    clk.part(P_PRODUCT);
  }
}

// ----------------------------------------------------------- the trunk
template <bool kV4>
__global__ void __launch_bounds__(NT, 1) encoder_trunk_kernel(EncArgs a) {
  extern __shared__ __align__(16) float smem[];
  const EncLayout l = enc_layout(a);
  float* s = a.scratch;
  const int T = a.T, W = a.W, H = a.H, bid = blockIdx.x, nb = gridDim.x;
  GridBarrier barrier(s + l.bar);
  EncClock clk(a.stage_cycles);
  auto sync = [&]() {
    barrier.sync();
    clk.part(P_WAIT);
  };

  // the first projection adds its chunks into p1
  for (int i = bid * NT + threadIdx.x; i < T * a.P1; i += nb * NT)
    s[l.p1 + i] = 0.f;

  // ---- prenet: Dense + ReLU per layer
  const float* h = a.x;
  int E = a.E_in;
  clk.stage = ES_PRENET;
  for (int i = 0; i < a.n_prenet; ++i) {
    float* out = s + (i % 2 ? l.pre1 : l.pre0);
    const int n = a.pre_out[i];
    dense_stage<kV4>(T, n, E, h, E, a.pre_w[i], n, a.pre_b[i],
                EpiBias{out, n, n, true}, smem, bid, nb, clk);
    sync();
    h = out;
    E = n;
  }

  // ---- conv bank (BN folded), ReLU
  float* banked = s + l.banked;
  clk.stage = ES_BANK;
  bank_stage<kV4>(a, h, E, banked, smem, clk);
  sync();

  // ---- max pool + two width-3 projections + residual (+ adjustment)
  clk.stage = ES_PROJ;
  proj1_stage<kV4>(a, banked, s + l.p1, smem, clk);
  sync();
  float* hw = s + l.hwA;
  float* hw_other = s + l.hwB;
  proj2_stage<kV4>(a, s + l.p1, h, hw, smem, clk);
  sync();
  if (a.adj_w != nullptr) {
    dense_stage<kV4>(T, W, a.P2, hw, a.P2, a.adj_w, W, a.adj_b,
                EpiBias{hw_other, W, W, false}, smem, bid, nb, clk);
    sync();
    float* t = hw; hw = hw_other; hw_other = t;
  }

  // ---- highway layers
  clk.stage = ES_HIGHWAY;
  for (int i = 0; i < a.n_highway; ++i) {
    dense_stage<kV4>(T, 2 * W, W, hw, W, a.hw_w[i], 2 * W, a.hw_b[i],
                     EpiHighway{hw_other, W, hw}, smem, bid, nb, clk);
    sync();
    float* t = hw; hw = hw_other; hw_other = t;
  }

  // ---- the LSTM's input halves of the gates, every step at once; the
  // second direction's items start on the blocks after the first's
  clk.stage = ES_LSTM_INPUT;
  const int first = cdiv(T, MT) * cdiv(4 * H, NI);
  for (int d = 0; d < 2; ++d)
    dense_stage<kV4>(T, 4 * H, W, hw, W, a.lstm_wx[d], 4 * H, a.lstm_b[d],
                     EpiBias{s + (d ? l.gx1 : l.gx0), 4 * H, 4 * H, false},
                     smem, bid, nb, clk, d * first);
  clk.flush();
}

// ----------------------------------------------- the recurrent cluster
// The recurrence's exchange: h of a step goes to the direction's blocks
// with st.async onto the destination's mbarrier (cluster.cuh); a block
// waits on its own mbarrier only (on an H100 a cluster barrier a step
// cost 0.6 us more).  kStream: the hop streamed (``hop_streams``), an
// instance of its own, so that the resident instance's code (and its
// LSTM loop's registers) is the one it had before the streamed hop was
// redesigned.
template <bool kV4, int DIRB, bool kStream>
__global__ void __launch_bounds__(NT, 1) encoder_rnn_kernel(EncArgs a) {
  constexpr int NB = 2 * DIRB;                // the cluster's blocks
  constexpr int MH = DIRB * UNITS_A_BLOCK;    // the units it holds
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const EncLayout l = enc_layout(a);
  float* s = a.scratch;
  const int T = a.T, L = a.L, H = a.H, SA = a.SA;
  const int d = rank / DIRB, q = rank % DIRB;
  const int U = cdiv(H, DIRB), u0 = q * U, Hp = round8(H);
  const int R = 4 * imax(0, imin(H - u0, U));   // this block's gate rows
  const int G = RNN_GX_STEPS;
  float* hb = smem;                    // this direction's h, [parity][Hp]
  float* gxs = hb + 2 * Hp;            // [group parity][step][row]
  unsigned long long* mb = reinterpret_cast<unsigned long long*>(
      gxs + 2 * G * rnn_rows(H));      // h buffer p's arrivals
  EncClock clk(a.stage_cycles);
  clk.stage = ES_LSTM_STEPS;

  // rows past L stay zero
  for (int i = rank * NT + threadIdx.x; i < (T - L) * 2 * H;
       i += NB * NT)
    a.lstm_out[(size_t)L * 2 * H + i] = 0.f;
  // thread: row r = 16 warp + lane % 16 (unit r / 4, gate r % 4), columns
  // 8 i + 4 (lane / 16) as 16-byte pieces; the unit's gate-0 lane runs the
  // cell (lstm_cell's arithmetic, its gates activated on four lanes)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = warp * 16 + (lane & 15), kp = lane >> 4;
  const bool owner = kp == 0 && (lane & 3) == 0 && r < R;
  const int j = u0 + (r >> 2);
  // this thread's half of its row of Wh (whT row gate * H + j) stays in
  // registers for the whole loop, zero past H
  float4 wr[MH / 8];
  {
    const float* wrow = a.lstm_whT[d] + (size_t)((r & 3) * H + j) * H;
#pragma unroll
    for (int i = 0; i < MH / 8; ++i) {
      const int k0 = 8 * i + 4 * kp;
      float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < R && k0 < H) {
        if ((H & 3) == 0) {   // 16-byte rows
          w = __ldg(reinterpret_cast<const float4*>(wrow + k0));
        } else {
          w.x = __ldg(wrow + k0);
          w.y = k0 + 1 < H ? __ldg(wrow + k0 + 1) : 0.f;
          w.z = k0 + 2 < H ? __ldg(wrow + k0 + 2) : 0.f;
          w.w = k0 + 3 < H ? __ldg(wrow + k0 + 3) : 0.f;
        }
      }
      wr[i] = w;
    }
  }
  for (int i = threadIdx.x; i < 2 * Hp; i += NT) hb[i] = 0.f;
  // the input halves (the trunk's x W_x + b) of steps g G .. g G + G - 1,
  // copied a group ahead: row r of step t is gx[row(t)][gate * H + j]
  const float* gx = s + (d ? l.gx1 : l.gx0);
  auto gx_row = [&](int t) { return d == 0 ? t : L - 1 - t; };
  auto fill = [&](int grp) {
    float* dst = gxs + (grp & 1) * G * R;
    for (int e = threadIdx.x; e < G * R; e += NT) {
      const int i = e / R, row = e - i * R, t = grp * G + i;
      const bool ok = t < L;
      cp4(dst + e,
          ok ? gx + (size_t)gx_row(t) * 4 * H + (row & 3) * H + u0 +
                   (row >> 2)
             : gx,
          ok);
    }
    cp_commit();
  };
  fill(0);
  fill(1);
  if (threadIdx.x == 0) {
    mbar_init(mb, 1);
    mbar_init(mb + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();
  clk.part(P_LOAD);

  // the unit's lanes send its h to the direction's DIRB blocks, the lane
  // of gate b and column half kp to block b + 4 kp (4 blocks: the first
  // half's lanes only): h buffer p at dst + 4 Hp p, its mbarrier at
  // bar + 8 p
  const int to_q = (r & 3) + 4 * kp;
  const bool sender = to_q < DIRB && r < R;
  const int to = d * DIRB + (sender ? to_q : 0);
  const unsigned dst = cluster_addr(hb + j, to), bar = cluster_addr(mb, to);
  float c = 0.f;
  for (int t = 0; t < L; ++t) {
    if (t % G == 0) {
      if (t > 0) fill(t / G + 1);   // into the group that ended at t - 1
      cp_wait_one();                // group t / G has landed
      __syncthreads();
    }
    if (t > 0) {   // h of step t - 1, from the direction's blocks
      if (threadIdx.x == 0) mbar_expect(mb + (t & 1), 4u * H);
      mbar_wait(mb + (t & 1), ((t - 1) >> 1) & 1);
    }
    clk.part(P_WAIT);
    const float gin = r < R ? gxs[((t / G) & 1) * G * R + (t % G) * R + r]
                            : 0.f;
    const float4* hp = reinterpret_cast<const float4*>(hb + (t & 1) * Hp) + kp;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < MH / 8; ++i) {
      if (i < Hp / 8) {
        const float4 x = hp[2 * i];
        acc[0] = fmaf(wr[i].x, x.x, acc[0]);
        acc[1] = fmaf(wr[i].y, x.y, acc[1]);
        acc[2] = fmaf(wr[i].z, x.z, acc[2]);
        acc[3] = fmaf(wr[i].w, x.w, acc[3]);
      }
    }
    // each lane of a unit's four rows activates its own gate (i, g, f, o:
    // sigmoid, tanh, sigmoid, sigmoid; sigmoid(x) = (1 + tanh(x / 2)) / 2,
    // so the warp does not diverge); the unit's first lane gathers them
    float z = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    z += __shfl_xor_sync(FULL, z, 16) + gin;
    const bool g_gate = (r & 3) == 1;
    const float th = tanhf(g_gate ? z : 0.5f * z);
    z = g_gate ? th : fmaf(0.5f, th, 0.5f);
    const float tg = __shfl_down_sync(FULL, z, 1);
    const float fg = __shfl_down_sync(FULL, z, 2);
    const float og = __shfl_down_sync(FULL, z, 3);
    float h_new = 0.f;
    if (owner) {
      const float h_prev = hb[(t & 1) * Hp + j];
      float cn = c * fg + z * tg;
      h_new = tanhf(cn) * og;
      if (a.zc > 0.f) cn = (1.f - a.zc) * cn + a.zc * c;
      if (a.zo > 0.f) h_new = (1.f - a.zo) * h_new + a.zo * h_prev;
      c = cn;
      a.lstm_out[(size_t)gx_row(t) * 2 * H + d * H + j] = h_new;
    }
    h_new = __shfl_sync(FULL, h_new, lane & 12);   // the unit's owner
    if (sender && t + 1 < L)
      st_async(dst + 4 * Hp * ((t + 1) & 1), bar + 8 * ((t + 1) & 1), h_new);
    clk.part(P_PRODUCT);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n"
                 :: "r"(smem_u32(mb)) : "memory");
    asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n"
                 :: "r"(smem_u32(mb + 1)) : "memory");
  }
  cp_wait();        // no copy of a later group lands in the region below
  cluster.sync();   // every block's lstm_out rows are written

  // ---- self-attention projection and hops (unmasked, as the JAX kernel)
  clk.stage = ES_SELF_ATTENTION;
  float* sa = a.n_hops ? s + l.sa0 : a.sa_out;
  dense_stage<kV4>(T, SA, 2 * H, a.lstm_out, 2 * H, a.sa_w, SA, a.sa_b,
                   EpiBias{sa, SA, SA, false}, smem, rank, NB, clk);
  cluster.sync();
  clk.part(P_WAIT);
  const int hd = SA / a.n_heads;
  const float scale = rsqrtf((float)hd);
  float* kvq = s + l.kvq;
  float* ctx = s + l.ctx;
  for (int i = 0; i < a.n_hops; ++i) {
    dense_stage<kV4>(T, 3 * SA, SA, sa, SA, a.kvq_w[i], 3 * SA, a.kvq_b[i],
                     EpiBias{kvq, 3 * SA, 3 * SA, false}, smem, rank, NB,
                     clk);
    cluster.sync();
    clk.part(P_WAIT);
    if constexpr (kStream) {
      // a long source: items of 64 query rows of a head, the keys streamed
      // through shared memory in a ring of tiles (attention_rows.cuh)
      stream_hop<kV4>(kvq, ctx, T, SA, a.n_heads, smem, rank, NB);
    } else {
      // kvq into shared memory at once, then one warp per (head, query row):
      // scores, softmax, context with lanes over the head's columns
      const int lq = round8(3 * SA) + 4;   // 4 mod 8: fewer bank conflicts
      float* skvq = smem;
      float* sc = smem + T * lq + warp * T;
      cp_slab<kV4>(skvq, lq, T, lq, kvq, 3 * SA, T, 0, 0, 3 * SA);
      cp_wait();
      __syncthreads();
      clk.part(P_LOAD);
      for (int w8 = warp;; w8 += NWARPS) {
        const int n = rank + NB * w8;
        if (n >= a.n_heads * T) break;
        const int hh = n / T, tq = n % T;
        const float* qr = skvq + tq * lq + 2 * SA + hh * hd;
        float m = -3.0e38f;
        for (int tk = lane; tk < T; tk += 32) {
          const float* kr = skvq + tk * lq + hh * hd;
          float v = 0.f;
          for (int e = 0; e < hd; ++e) v = fmaf(qr[e], kr[e], v);
          v *= scale;
          sc[tk] = v;
          m = fmaxf(m, v);
        }
        m = warp_max(m);
        float sum = 0.f;
        for (int tk = lane; tk < T; tk += 32) {
          const float e = expf(sc[tk] - m);
          sc[tk] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        __syncwarp();
        for (int e = lane; e < hd; e += 32) {
          const float* vr = skvq + SA + hh * hd + e;
          float acc = 0.f;
          for (int tk = 0; tk < T; ++tk)
            acc = fmaf(sc[tk], vr[tk * lq], acc);
          ctx[(size_t)tq * SA + hh * hd + e] = acc / sum;
        }
        __syncwarp();
      }
    }
    clk.part(P_PRODUCT);
    cluster.sync();
    clk.part(P_WAIT);
    float* next = i == a.n_hops - 1 ? a.sa_out
                                    : (sa == s + l.sa0 ? s + l.sa1 : s + l.sa0);
    dense_stage<kV4>(T, SA, SA, ctx, SA, a.ot_w[i], SA, a.ot_b[i],
                     EpiHop{next, SA, sa}, smem, rank, NB, clk);
    cluster.sync();
    clk.part(P_WAIT);
    sa = next;
  }
  clk.flush();
}

// ------------------------------------------------------------------- host
extern "C" long long fused_encoder_scratch_floats(const EncArgs* a) {
  return (long long)enc_layout(*a).total;
}

// shared memory of a block: which 0 the trunk, 1 the recurrent cluster
extern "C" long long fused_encoder_smem_bytes(const EncArgs* a, int which) {
  return 4LL * (which ? rnn_smem_floats(*a) : trunk_smem_floats(*a));
}

// The two launches of one instance: the trunk (cooperative, a block per SM)
// and the recurrent cluster of 2 DIRB blocks (16: a non-portable size).
template <bool kV4, int DIRB>
static cudaError_t launch_instance(EncArgs& a, cudaStream_t st) {
  auto trunk = encoder_trunk_kernel<kV4>;
  auto rnn = hop_streams(a) ? encoder_rnn_kernel<kV4, DIRB, true>
                            : encoder_rnn_kernel<kV4, DIRB, false>;
  const size_t smem_t = 4 * (size_t)trunk_smem_floats(a);
  const size_t smem_r = 4 * (size_t)rnn_smem_floats(a);
  cudaError_t e = cudaFuncSetAttribute(
      trunk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_t);
  if (e != cudaSuccess) return e;
  if ((e = cudaFuncSetAttribute(rnn,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem_r)) != cudaSuccess)
    return e;
  if (2 * DIRB > 8 &&
      (e = cudaFuncSetAttribute(
           rnn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
          cudaSuccess)
    return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, trunk, NT, smem_t)) != cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const EncLayout l = enc_layout(a);
  if ((e = cudaMemsetAsync(a.scratch + l.bar, 0,
                           GRID_BAR_WORDS * sizeof(unsigned), st)) !=
      cudaSuccess)
    return e;
  void* params[] = {&a};
  if ((e = cudaLaunchCooperativeKernel((void*)trunk, dim3(sms), dim3(NT),
                                       params, smem_t, st)) != cudaSuccess)
    return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * DIRB);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem_r;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2 * DIRB;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((e = cudaLaunchKernelEx(&cfg, rnn, a)) != cudaSuccess) return e;
  return cudaGetLastError();
}

extern "C" int fused_encoder_launch(const EncArgs* args, void* stream) {
  EncArgs a = *args;
  const cudaStream_t st = (cudaStream_t)stream;
  if (a.H < 1 || a.H > MAX_H || a.T < 1 || a.L < 1 || a.L > a.T)
    return (int)cudaErrorInvalidValue;
  const bool four = dir_blocks(a.H) == 4;
  if (a.v4)
    return (int)(four ? launch_instance<true, 4>(a, st)
                      : launch_instance<true, 8>(a, st));
  return (int)(four ? launch_instance<false, 4>(a, st)
                    : launch_instance<false, 8>(a, st));
}
