// The whole batch-1 inference encoder in one cooperative kernel.
//
// Replaces: self_attention_tacotron_tpu/ops/fused_encoder.py `_kernel`
// (Pallas, reached through `fused_encode`).
//
// What bounds it on the H100: at the recipe (T = 64 phones, E = 128,
// K = 16 bank widths of 128 channels, a 128-unit bi-LSTM, one 32-unit
// self-attention hop) the function needs ~0.46 GFLOP, ~60 % of it the
// conv bank, and ~14.4 MB of f32 operands read once (width k of the bank
// has k taps: 8.9 MB).  Those are ~4.3 us of bytes and ~6.8 us of FP32
// FMA at the card's peaks.  This kernel stacks the bank into one
// (64 x 2048) @ (2048 x 2048) im2col product whose 16.8 MB weight is 47 %
// zero blocks of the narrower widths, read and multiplied too.  The rest
// is latency: the bi-LSTM's 64 dependent steps, and the stage barriers
// between layers.
//
// Design: one block per SM, a grid-wide barrier between dependent stages.
// The sequence-wide layers are 32 x 32 tile products (`gemm_stage`, K in
// chunks of 128) whose A-loaders build the conv windows, the max pool and
// the length-reversed rows on the fly, so no im2col matrix is
// materialized; the first projection (8 output tiles, K = 6144 at the
// recipe) splits K over 16 blocks per tile (`gemm_stage_split_k`) so 128
// SMs share it instead of 8; epilogues fuse the
// bias, activation, residual and highway gating (the merged weights
// interleave the highway [H | T] columns so each output's two gates sit in
// adjacent lanes).  The LSTM's input half (x_t @ Wx + b) is one product over all
// steps before the loop; each of the L loop steps then does only h @ Wh,
// one warp per (direction, unit), with one barrier per step.  Products are
// plain FP32 FMA, no tensor cores (later work: bf16/TF32 wgmma tiles, the
// bank's zero blocks skipped, fewer barriers).
#include <cstddef>

#include "common.cuh"

constexpr int MAX_PRENET = 4, MAX_HIGHWAY = 8, MAX_HOPS = 4;

struct EncArgs {  // mirrored by _EncArgs in ops/fused_encoder.py
  const float* x;
  int T, L, E_in, n_prenet;
  const float* pre_w[MAX_PRENET];
  const float* pre_b[MAX_PRENET];
  int pre_out[MAX_PRENET];
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
  const float* hw_w[MAX_HIGHWAY];
  const float* hw_b[MAX_HIGHWAY];
  int W, H;
  const float* lstm_wx[2];
  const float* lstm_whT[2];
  const float* lstm_b[2];
  float zc, zo;
  const float* sa_w;
  const float* sa_b;
  int SA;
  int n_hops, n_heads;
  const float* kvq_w[MAX_HOPS];
  const float* kvq_b[MAX_HOPS];
  const float* ot_w[MAX_HOPS];
  const float* ot_b[MAX_HOPS];
  float* lstm_out;  // (T, 2H)
  float* sa_out;    // (T, SA)
  float* scratch;
  long long* stage_cycles;  // optional (ENC_STAGES), see StageClock
};

// the StageClock slots
enum EncStage { ES_PRENET, ES_BANK, ES_PROJ, ES_HIGHWAY, ES_LSTM_INPUT,
                ES_LSTM_STEPS, ES_SELF_ATTENTION, ENC_STAGES };

struct EncLayout {
  size_t pre0, pre1, banked, p1, hwA, hwB, gx0, gx1, hs, cs, sa0, sa1, kvq,
      ctx, part, total;
};

// split-K partials of the first projection live in `part` (T * K * C
// floats): at most K * C / P1 splits
__host__ __device__ inline int enc_proj1_splits(const EncArgs& a) {
  return a.K * a.C / a.P1 > 0 ? a.K * a.C / a.P1 : 1;
}

__host__ __device__ inline EncLayout enc_layout(const EncArgs& a) {
  int maxw = a.P2 > a.W ? a.P2 : a.W;
  for (int i = 0; i < a.n_prenet; ++i)
    if (a.pre_out[i] > maxw) maxw = a.pre_out[i];
  const size_t T = a.T;
  EncLayout l;
  size_t o = 0;
  l.pre0 = o; o += T * maxw;
  l.pre1 = o; o += T * maxw;
  l.banked = o; o += T * a.K * a.C;
  l.p1 = o; o += T * a.P1;
  l.hwA = o; o += T * maxw;
  l.hwB = o; o += T * maxw;
  l.gx0 = o; o += T * 4 * a.H;
  l.gx1 = o; o += T * 4 * a.H;
  l.hs = o; o += 4 * a.H;  // [parity][direction][unit]
  l.cs = o; o += 2 * a.H;
  l.sa0 = o; o += T * a.SA;
  l.sa1 = o; o += T * a.SA;
  l.kvq = o; o += T * 3 * a.SA;
  l.ctx = o; o += T * a.SA;
  l.part = o; o += T * a.K * a.C;
  l.total = o;
  return l;
}

__host__ __device__ inline size_t enc_smem_bytes(const EncArgs& a) {
  size_t b = sizeof(GemmSmem);
  const size_t lstm = (2 * a.H + NWARPS) * sizeof(float);
  const size_t att = ((size_t)NWARPS * a.T + a.SA) * sizeof(float);
  if (lstm > b) b = lstm;
  if (att > b) b = att;
  return b;
}

// --------------------------------------------------------------- loaders
struct InputLoad {  // the kernel's input, never written
  const float* p;
  int ld;
  __device__ float operator()(int m, int k) const {
    return __ldg(p + (size_t)m * ld + k);
  }
};

// im2col row m of a (T, E) sequence: block k / E is row m + k / E - pad.
struct WindowLoad {
  const float* p;
  int E, T, pad;
  __device__ float operator()(int m, int k) const {
    const int src = m + k / E - pad;
    return (src >= 0 && src < T) ? __ldcg(p + (size_t)src * E + k % E) : 0.f;
  }
};

// Width-3 windows (pad 1) over the width-2 stride-1 max pool of `banked`.
struct PoolWindowLoad {
  const float* p;
  int E, T;
  __device__ float operator()(int m, int k) const {
    const int src = m + k / E - 1;
    if (src < 0 || src >= T) return 0.f;
    const int c = k % E;
    const float v = __ldcg(p + (size_t)src * E + c);
    return src + 1 < T ? fmaxf(v, __ldcg(p + (size_t)(src + 1) * E + c)) : v;
  }
};

// ------------------------------------------------------------- epilogues
struct EpiBias {  // out = act(acc + b)
  float* out;
  const float* b;
  int ld;
  bool relu;
  __device__ void operator()(int m, int n, float acc, bool valid) const {
    if (!valid) return;
    float v = acc + __ldg(b + n);
    out[(size_t)m * ld + n] = relu ? fmaxf(v, 0.f) : v;
  }
};

struct EpiResidual {  // out = acc + b + res  (proj2 + prenet output)
  float* out;
  const float* b;
  int ld;
  const float* res;
  __device__ void operator()(int m, int n, float acc, bool valid) const {
    if (!valid) return;
    out[(size_t)m * ld + n] =
        acc + __ldg(b + n) + __ldcg(res + (size_t)m * ld + n);
  }
};

// Interleaved highway columns: 2j = H gate, 2j + 1 = T gate of unit j.
struct EpiHighway {
  float* out;
  const float* b;
  int W;
  const float* xin;
  __device__ void operator()(int m, int n, float acc, bool valid) const {
    const float v = acc + (valid ? __ldg(b + n) : 0.f);
    const float partner = __shfl_xor_sync(FULL, v, 1);
    if (!valid || (n & 1)) return;
    const int j = n >> 1;
    const float t = sigmoid(partner);
    const float x = __ldcg(xin + (size_t)m * W + j);
    out[(size_t)m * W + j] = fmaxf(v, 0.f) * t + x * (1.f - t);
  }
};

struct EpiHop {  // out = prev + tanh(acc + b)
  float* out;
  const float* b;
  int ld;
  const float* prev;
  __device__ void operator()(int m, int n, float acc, bool valid) const {
    if (!valid) return;
    out[(size_t)m * ld + n] =
        __ldcg(prev + (size_t)m * ld + n) + tanhf(acc + __ldg(b + n));
  }
};

// ----------------------------------------------------------------- kernel
__global__ void __launch_bounds__(NT, 1) fused_encoder_kernel(EncArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  GemmSmem& gs = *reinterpret_cast<GemmSmem*>(smem);
  const EncLayout l = enc_layout(a);
  float* s = a.scratch;
  const int T = a.T, L = a.L, H = a.H, W = a.W, SA = a.SA;
  const int gtid = blockIdx.x * NT + threadIdx.x, gstride = gridDim.x * NT;
  StageClock clk(a.stage_cycles);

  // outputs past L stay zero; LSTM state starts at zero
  for (int i = gtid; i < T * 2 * H; i += gstride) a.lstm_out[i] = 0.f;
  for (int i = gtid; i < 4 * H; i += gstride) s[l.hs + i] = 0.f;
  for (int i = gtid; i < 2 * H; i += gstride) s[l.cs + i] = 0.f;

  // ---- prenet: Dense + ReLU per layer
  const float* h = a.x;
  int E = a.E_in;
  for (int i = 0; i < a.n_prenet; ++i) {
    float* out = s + (i % 2 ? l.pre1 : l.pre0);
    const int n = a.pre_out[i];
    const EpiBias epi{out, a.pre_b[i], n, true};
    if (i == 0)
      gemm_stage(T, n, E, InputLoad{h, E}, a.pre_w[i], n, epi, gs);
    else
      gemm_stage(T, n, E, RowLoad{h, E}, a.pre_w[i], n, epi, gs);
    grid.sync();
    clk.mark(ES_PRENET);
    h = out;
    E = n;
  }

  // ---- conv bank (BN folded) as one windows product, then ReLU
  const int KC = a.K * a.C;
  float* banked = s + l.banked;
  gemm_stage(T, KC, a.K * E, WindowLoad{h, E, T, a.K > 1 ? (a.K - 1) / 2 : 0},
             a.bank_w, KC, EpiBias{banked, a.bank_b, KC, true}, gs);
  grid.sync();
  clk.mark(ES_BANK);

  // ---- max pool (in the loader) + two width-3 projections + residual
  float* p1 = s + l.p1;
  gemm_stage_split_k(T, a.P1, 3 * KC, PoolWindowLoad{banked, KC, T}, a.p1_w,
                     a.P1, EpiBias{p1, a.p1_b, a.P1, true}, gs, s + l.part,
                     enc_proj1_splits(a), grid);
  grid.sync();
  clk.mark(ES_PROJ);
  float* hw = s + l.hwA;
  float* hw_other = s + l.hwB;
  gemm_stage(T, a.P2, 3 * a.P1, WindowLoad{p1, a.P1, T, 1}, a.p2_w, a.P2,
             EpiResidual{hw, a.p2_b, a.P2, h}, gs);
  grid.sync();
  clk.mark(ES_PROJ);
  if (a.adj_w != nullptr) {
    gemm_stage(T, W, a.P2, RowLoad{hw, a.P2}, a.adj_w, W,
               EpiBias{hw_other, a.adj_b, W, false}, gs);
    grid.sync();
    clk.mark(ES_PROJ);
    float* t = hw; hw = hw_other; hw_other = t;
  }

  // ---- highway layers
  for (int i = 0; i < a.n_highway; ++i) {
    gemm_stage(T, 2 * W, W, RowLoad{hw, W}, a.hw_w[i], 2 * W,
               EpiHighway{hw_other, a.hw_b[i], W, hw}, gs);
    grid.sync();
    clk.mark(ES_HIGHWAY);
    float* t = hw; hw = hw_other; hw_other = t;
  }

  // ---- bi-LSTM: input halves of the gates for every step at once
  float* gx[2] = {s + l.gx0, s + l.gx1};
  for (int d = 0; d < 2; ++d)
    gemm_stage(T, 4 * H, W, RowLoad{hw, W}, a.lstm_wx[d], 4 * H,
               EpiBias{gx[d], a.lstm_b[d], 4 * H, false}, gs);
  grid.sync();
  clk.mark(ES_LSTM_INPUT);

  // forward at t and backward at L-1-t in the same step; carries freeze
  // past L, so the loop simply ends there
  float* hsm = smem;  // (2H) previous h of both directions
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = 0; t < L; ++t) {
    const float* hin = s + l.hs + (t & 1) * 2 * H;
    float* hout = s + l.hs + ((t + 1) & 1) * 2 * H;
    for (int i = threadIdx.x; i < 2 * H; i += NT) hsm[i] = __ldcg(hin + i);
    __syncthreads();
    for (int w8 = warp;; w8 += NWARPS) {
      const int n = blockIdx.x + gridDim.x * w8;
      if (n >= 2 * H) break;
      const int d = n / H, j = n % H;
      const float* wh = a.lstm_whT[d];
      const float* hp = hsm + d * H;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = lane; k < H; k += 32) {
        const float hv = hp[k];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[r] = fmaf(__ldg(wh + (size_t)(r * H + j) * H + k), hv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r] = warp_sum(acc[r]);
      if (lane == 0) {
        const int row = d == 0 ? t : L - 1 - t;
        const float* g = gx[d] + (size_t)row * 4 * H;
        float c_new, h_new;
        lstm_cell(acc[0] + __ldcg(g + j), acc[1] + __ldcg(g + H + j),
                  acc[2] + __ldcg(g + 2 * H + j),
                  acc[3] + __ldcg(g + 3 * H + j), __ldcg(s + l.cs + d * H + j),
                  hp[j], a.zc, a.zo, c_new, h_new);
        s[l.cs + d * H + j] = c_new;
        hout[d * H + j] = h_new;
        a.lstm_out[(size_t)row * 2 * H + d * H + j] = h_new;
      }
    }
    grid.sync();
    clk.mark(ES_LSTM_STEPS);
  }

  // ---- self-attention projection and hops (unmasked, as the JAX kernel)
  float* sa = a.n_hops ? s + l.sa0 : a.sa_out;
  gemm_stage(T, SA, 2 * H, RowLoad{a.lstm_out, 2 * H}, a.sa_w, SA,
             EpiBias{sa, a.sa_b, SA, false}, gs);
  grid.sync();
  clk.mark(ES_SELF_ATTENTION);
  const int hd = SA / a.n_heads;
  const float scale = rsqrtf((float)hd);
  float* kvq = s + l.kvq;
  float* ctx = s + l.ctx;
  for (int i = 0; i < a.n_hops; ++i) {
    gemm_stage(T, 3 * SA, SA, RowLoad{sa, SA}, a.kvq_w[i], 3 * SA,
               EpiBias{kvq, a.kvq_b[i], 3 * SA, false}, gs);
    grid.sync();
    clk.mark(ES_SELF_ATTENTION);
    // one warp per (head, query row): scores in shared memory, softmax,
    // context with lanes over the head's columns
    float* sc = smem + warp * T;
    for (int w8 = warp;; w8 += NWARPS) {
      const int n = blockIdx.x + gridDim.x * w8;
      if (n >= a.n_heads * T) break;
      const int hh = n / T, tq = n % T;
      const float* q = kvq + (size_t)tq * 3 * SA + 2 * SA + hh * hd;
      float m = -3.0e38f;
      for (int tk = lane; tk < T; tk += 32) {
        const float* k = kvq + (size_t)tk * 3 * SA + hh * hd;
        float v = 0.f;
        for (int d = 0; d < hd; ++d) v = fmaf(__ldcg(q + d), __ldcg(k + d), v);
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
      for (int d = lane; d < hd; d += 32) {
        const float* v = kvq + SA + hh * hd + d;
        float acc = 0.f;
        for (int tk = 0; tk < T; ++tk)
          acc = fmaf(sc[tk], __ldcg(v + (size_t)tk * 3 * SA), acc);
        ctx[(size_t)tq * SA + hh * hd + d] = acc / sum;
      }
      __syncwarp();
    }
    grid.sync();
    clk.mark(ES_SELF_ATTENTION);
    float* next = i == a.n_hops - 1 ? a.sa_out
                                    : (sa == s + l.sa0 ? s + l.sa1 : s + l.sa0);
    gemm_stage(T, SA, SA, RowLoad{ctx, SA}, a.ot_w[i], SA,
               EpiHop{next, a.ot_b[i], SA, sa}, gs);
    grid.sync();
    clk.mark(ES_SELF_ATTENTION);
    sa = next;
  }
}

// ------------------------------------------------------------------- host
extern "C" long long fused_encoder_scratch_floats(const EncArgs* a) {
  return (long long)enc_layout(*a).total;
}

extern "C" int fused_encoder_launch(const EncArgs* args, void* stream) {
  EncArgs a = *args;
  const size_t smem = enc_smem_bytes(a);
  cudaError_t e = cudaFuncSetAttribute(
      fused_encoder_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fused_encoder_kernel, NT, smem)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel((void*)fused_encoder_kernel, dim3(sms),
                                  dim3(NT), params, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
