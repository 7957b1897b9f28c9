// The encoder's self-attention hop streamed through shared memory:
// softmax(q k^T / sqrt(hd)) v of every head over all T rows, unmasked, for
// a source whose K | V | Q rows no longer fit in a block's shared memory
// (csrc/fused_encoder.cu, ``hop_streams``: T > 533 at the recipes'
// widths).  The rows sit in L2, written earlier in the same launch by the
// recurrent cluster's blocks; every block of the cluster calls this with
// its rank.
//
// What bounds it on an H100: at the codes recipe (hd = 16, 2 heads) and T
// = 600 the hop is 2 x 600^2 x 16 x 2 x 2 = 46 MFLOP: 0.28 us at 165
// TFLOP/s (the 3xTF32 rate) on the whole card, ~4.6 us on the cluster's 8
// SMs; the 0.6 MB of K | V | Q rows are nothing.  What cost the first
// streamed design (8 query rows an item, one warp a row on FP32 FMAs, a
// synchronous L2 round trip and two barriers every 32-key tile, V read
// from L2 element by element in a dependent chain) was latency: ~0.4 ms
// over the resident hop at T = 534.  This design:
//
// * Items of HOP_ROWS = 64 query rows of one head, item n on block n % NB:
//   K and V pass through a block once an item.
// * Warp w takes the 16-row tile w % 4 of the item and the key half w / 4
//   of every HOP_KEYS-key tile; both products on the tensor cores
//   (mma.sync m16n8k8 in the 3xTF32 split of mma.cuh, f32 accuracy), the
//   scores' fragment turned into P's as the next product's A operand (its
//   keys taken in the order 2 t, 2 t + 1 -> t, t + 4, V's rows alike), the
//   rows' running max, sum and context online in registers.  At the end
//   of a pass the second key half hands its lanes' states to the first
//   through shared memory, which merges them and writes the rows.
// * A step stages the item's q rows and the tile's K rows, 16 columns of
//   each (HOP_COLS), and on a tile's last chunk the 16 V columns of the
//   pass, in one buffer of a ring of HOP_STAGES (cp.async, L2 only at 16
//   bytes; 4-byte copies where a head's columns are not 16-byte aligned,
//   as the kernel's other copies of the kV4 = false instance), issued
//   HOP_STAGES - 1 steps ahead; one block barrier a step.  The fragments'
//   shared loads are free of bank conflicts (rows 20 floats apart).
// * Any head width: the scores sum over column chunks of 16 (one at hd <=
//   16), the context a pass of 16 columns at a time (each pass recomputes
//   the scores); the plan (``hop_stream_floats``) grows with neither T nor
//   hd.
//
// Measured on an H100 80GB HBM3 at 700.00 W (scripts/torch_serving_ab.py
// --cases wide): the whole encoder at T = 534 0.84 ms against the first
// design's 1.35 and the resident hop's T = 533 0.92; the same items on
// FP32 FMAs (a thread a row and a share of each tile's keys) took 0.87
// where this design took 0.84.
#pragma once

#include <math.h>

#include "common.cuh"
#include "mma.cuh"

constexpr int HOP_ROWS = 64;     // query rows an item: 4 x 16
constexpr int HOP_KEYS = 64;     // keys a tile: 2 halves of 32
constexpr int HOP_COLS = 16;     // columns a chunk and a pass
constexpr int HOP_LD = HOP_COLS + 4;   // a staged row: 4 mod 8 floats
constexpr int HOP_HALF = HOP_KEYS / 2;
constexpr int HOP_BUF = (HOP_ROWS + 2 * HOP_KEYS) * HOP_LD;
constexpr int HOP_STAGES = 4;    // buffers in the ring
constexpr int HOP_STATE = 12;    // a lane's (m, l) of two rows and o[8]
constexpr int HOP_SWAP = 4 * 32 * HOP_STATE;   // the second key half's
static_assert(NWARPS == 8 && HOP_ROWS == 16 * 4, "4 row tiles x 2 halves");

__host__ __device__ inline int hop_stream_floats() {
  return HOP_STAGES * HOP_BUF + HOP_SWAP;
}

// A block's step: its item k, then the pass, key tile and column chunk.
struct HopStep {
  int k = 0, pass = 0, tile = 0, chunk = 0;
  __device__ void next(int P, int tiles) {
    if (++chunk < P) return;
    chunk = 0;
    if (++tile < tiles) return;
    tile = 0;
    if (++pass < P) return;
    pass = 0;
    ++k;
  }
};

template <int N>
__device__ __forceinline__ void hop_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows r < rows of src (row r at src + (r0 + r) ld, zero from row T and
// from column cw on) into dst at HOP_LD floats a row, HOP_COLS columns
template <bool kV4>
__device__ __forceinline__ void hop_cp_rows(float* dst, const float* src,
                                            int ld, int rows, int r0, int T,
                                            int cw, bool vec) {
  if (kV4 && vec) {
    constexpr int PER = HOP_COLS / 4;
    for (int e = threadIdx.x; e < rows * PER; e += NT) {
      const int r = e / PER, c = (e % PER) * 4;
      const bool ok = r0 + r < T && c < cw;
      cp16(dst + r * HOP_LD + c, ok ? src + (size_t)(r0 + r) * ld + c : src,
           ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * HOP_COLS; e += NT) {
      const int r = e / HOP_COLS, c = e % HOP_COLS;
      const bool ok = r0 + r < T && c < cw;
      cp4(dst + r * HOP_LD + c, ok ? src + (size_t)(r0 + r) * ld + c : src,
          ok);
    }
  }
}

// kvq: (T, 3 SA) rows K | V | Q; ctx: (T, SA).  Called by every thread of
// the block; ``smem`` holds hop_stream_floats() floats.  Not inlined: the
// recurrent kernel's LSTM loop runs slower beside it inlined (the whole
// encoder at T = 534 0.931 against 0.835 ms, scripts/torch_serving_ab.py
// --cases wide, H100 80GB HBM3 at 700.00 W).
template <bool kV4>
__device__ __noinline__ void stream_hop(const float* kvq, float* ctx, int T,
                                        int SA, int heads, float* smem,
                                        int rank, int NB) {
  const int hd = SA / heads, ld = 3 * SA;
  const float scale = rsqrtf((float)hd);
  const int groups = (T + HOP_ROWS - 1) / HOP_ROWS, items = heads * groups;
  const int P = (hd + HOP_COLS - 1) / HOP_COLS;       // chunks and passes
  const int tiles = (T + HOP_KEYS - 1) / HOP_KEYS;
  const int per_item = P * tiles * P;
  const int mine = items > rank ? (items - rank + NB - 1) / NB : 0;
  const int steps = mine * per_item;
  const bool vec = hd % 4 == 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int rt = warp & 3, half = warp >> 2;   // row tile, key half
  float* swap = smem + HOP_STAGES * HOP_BUF + (rt * 32 + lane) * HOP_STATE;
  // step i of the block: item rank + NB k, head and first row of it
  HopStep at, ahead;   // the step computed, the step copied
  auto item = [&](const HopStep& st, int& hh, int& row0) {
    const int n = rank + NB * st.k;
    hh = n / groups;
    row0 = (n % groups) * HOP_ROWS;
  };
  auto issue = [&](int i) {   // step i's rows into its buffer
    if (i < steps) {
      int hh, row0;
      item(ahead, hh, row0);
      float* buf = smem + (i % HOP_STAGES) * HOP_BUF;
      const int c0 = hh * hd + ahead.chunk * HOP_COLS;
      const int cw = hd - ahead.chunk * HOP_COLS;
      hop_cp_rows<kV4>(buf, kvq + 2 * SA + c0, ld, HOP_ROWS, row0, T, cw,
                       vec);
      hop_cp_rows<kV4>(buf + HOP_ROWS * HOP_LD, kvq + c0, ld, HOP_KEYS,
                       ahead.tile * HOP_KEYS, T, cw, vec);
      if (ahead.chunk == P - 1)
        hop_cp_rows<kV4>(buf + (HOP_ROWS + HOP_KEYS) * HOP_LD,
                         kvq + SA + hh * hd + ahead.pass * HOP_COLS, ld,
                         HOP_KEYS, ahead.tile * HOP_KEYS, T,
                         hd - ahead.pass * HOP_COLS, vec);
      ahead.next(P, tiles);
    }
    cp_commit();
  };
  // a finite floor, so that a row half whose keys are all past T keeps
  // weights of exactly 0 and no 0 * inf
  constexpr float FLOOR = -3.0e38f;
  // sc: the 16 rows x 32 keys of scores, n-tile nt (keys 8 nt ..), as
  // mma's C fragment (rows g, g + 8; keys 2 tq, 2 tq + 1); o: the 16 x 16
  // context, n-tile n (columns 8 n ..); m, l: rows g and g + 8 (l this
  // lane's share of the sum)
  float sc[4][4], o[2][4], m[2] = {FLOOR, FLOOR}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
  __syncthreads();   // the buffers' earlier users are done
  for (int i = 0; i < HOP_STAGES - 1; ++i) issue(i);
  for (int i = 0; i < steps; ++i, at.next(P, tiles)) {
    hop_wait<HOP_STAGES - 2>();   // step i's copies have landed
    __syncthreads();   // every thread's; step i - 1's buffer is free
    issue(i + HOP_STAGES - 1);
    int hh, row0;
    item(at, hh, row0);
    const int pass = at.pass, tile = at.tile, chunk = at.chunk;
    const float* buf = smem + (i % HOP_STAGES) * HOP_BUF;
    const float* sq = buf + 16 * rt * HOP_LD;
    const float* sk = buf + (HOP_ROWS + half * HOP_HALF) * HOP_LD;
    const float* sv = sk + HOP_KEYS * HOP_LD;
    if (chunk == 0)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[nt][c] = 0.f;
    // the chunk's two 8-deep steps of Q K^T in the 3xTF32 split
#pragma unroll
    for (int kk = 0; kk < HOP_COLS; kk += 8) {
      uint32_t ah[4], al[4];
      tf32_split(sq[g * HOP_LD + kk + tq], ah[0], al[0]);
      tf32_split(sq[(g + 8) * HOP_LD + kk + tq], ah[1], al[1]);
      tf32_split(sq[g * HOP_LD + kk + tq + 4], ah[2], al[2]);
      tf32_split(sq[(g + 8) * HOP_LD + kk + tq + 4], ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* kr = sk + (8 * nt + g) * HOP_LD + kk + tq;
        uint32_t bh[2], bl[2];
        tf32_split(kr[0], bh[0], bl[0]);
        tf32_split(kr[4], bh[1], bl[1]);
        mma3(sc[nt], ah, al, bh, bl);
      }
    }
    if (chunk != P - 1) continue;
    // the tile's keys folded into the rows' (m, l, o)
    float mt[2] = {FLOOR, FLOOR};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = tile * HOP_KEYS + half * HOP_HALF + 8 * nt +
                        2 * tq + (c & 1);
        sc[nt][c] = key < T ? sc[nt][c] * scale : -INFINITY;
        mt[c >> 1] = fmaxf(mt[c >> 1], sc[nt][c]);
      }
    float keep[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(FULL, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(FULL, mt[r], 2));
      const float mn = fmaxf(m[r], mt[r]);
      keep[r] = expf(m[r] - mn);
      m[r] = mn;
      l[r] *= keep[r];
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[n][c] *= keep[c >> 1];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      // P's fragment as mma's A over keys 8 nt .. 8 nt + 7, in the order
      // 2 tq -> k = tq, 2 tq + 1 -> k = tq + 4 (V's rows taken alike)
      float p[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[c] = expf(sc[nt][c] - m[c >> 1]);
        l[c >> 1] += p[c];
      }
      uint32_t ah[4], al[4];
      tf32_split(p[0], ah[0], al[0]);
      tf32_split(p[2], ah[1], al[1]);
      tf32_split(p[1], ah[2], al[2]);
      tf32_split(p[3], ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float* vr = sv + (8 * nt + 2 * tq) * HOP_LD + 8 * n + g;
        uint32_t bh[2], bl[2];
        tf32_split(vr[0], bh[0], bl[0]);
        tf32_split(vr[HOP_LD], bh[1], bl[1]);
        mma3(o[n], ah, al, bh, bl);
      }
    }
    if (tile != tiles - 1) continue;
    // the pass is done: each row's sum over its 4 lanes, then the second
    // key half's states merged into the first's, which writes the rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(FULL, l[r], 1);
      l[r] += __shfl_xor_sync(FULL, l[r], 2);
    }
    if (half == 1) {
      swap[0] = m[0], swap[1] = m[1], swap[2] = l[0], swap[3] = l[1];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) swap[4 + 4 * n + c] = o[n][c];
    }
    __syncthreads();
    if (half == 0) {
      float a[2], b[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mm = fmaxf(m[r], swap[r]);
        a[r] = expf(m[r] - mm);
        b[r] = expf(swap[r] - mm);
        l[r] = 1.f / fmaf(a[r], l[r], b[r] * swap[2 + r]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = pass * HOP_COLS + 8 * n + 2 * tq;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = row0 + 16 * rt + g + 8 * (c >> 1);
          const float v = fmaf(a[c >> 1], o[n][c],
                               b[c >> 1] * swap[4 + 4 * n + c]);
          if (row < T && col + (c & 1) < hd)
            ctx[(size_t)row * SA + hh * hd + col + (c & 1)] =
                v * l[c >> 1];
        }
      }
    }
    m[0] = m[1] = FLOOR;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
  }
  cp_wait();   // the empty last groups
}
