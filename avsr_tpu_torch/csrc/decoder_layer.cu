// One decoder layer's whole beam-search decode step in one cooperative
// launch: LN1 + QKV, self-attention over the lazy-reorder K|V cache with the
// step's fresh row, out-projection, LN2 + cross-attention over the shared
// source K/V, LN3 + ReLU FFN, and the K|V row write, for every lane of the
// batch (beams of up to kMaxLanes = 32 lanes; one launch per layer and step
// at any batch).
//
// Replaces the Pallas TPU kernel avsr_tpu/ops/pallas/decoder_layer.py
// `decoder_layer_step` (`_kernel`). Its rounding points are kept: the
// residual stream is fp32 inside the layer and rounded to the parameter
// dtype once at the end; every product against a weight takes its operand
// rounded to the weight dtype and accumulates in fp32, bias added in fp32;
// LayerNorm eps 1e-12 with the parameters in the parameter dtype; q is
// scaled by dh^-0.5 in fp32, rounded to the weight dtype and then to the
// cache dtype; softmax in fp32 with the denominator clamped at 1e-30, the
// probabilities rounded to the cache dtype before P.V. The step's own K|V
// row enters the self-attention from the QKV product, not from the cache:
// the stale cache row at `pos` is masked while pos < S; at pos >= S (a
// capped cache) every stored row is attended, the stale row S-1 included,
// and the fresh row besides. The fresh row is written at min(pos, S-1)
// only after every block has finished reading the cache.
//
// What bounds it on the card: the bytes. Per layer and step it reads the
// layer's weights once (12 C^2 elements, ~25 MB in bf16 at C=1024, F=3072),
// the valid prefix of the K|V cache (~19 MB at 24 lanes, S=192) and the
// source K/V (~12 MB at S_enc=377): ~17 us at 3.35 TB/s at B=8. At these
// sizes every phase is a few memory round trips, so the design counts
// round trips as much as bytes.
//
// Design. A grid of as many blocks as fit on the card at once (cooperative
// launch), eleven phases separated by grid syncs (~1 us each on the H100):
//   0 LN1 into the operand, the fp32 residual
//   1 QKV                GEMV
//   2 self-attention     one block per (utterance, head)
//   3 out-proj + resid   GEMV; LN2 statistics of each row group
//   4 LN2 into the operand
//   5 q2                 GEMV
//   6 cross-attention    one block per (utterance, head)
//   7 out2 + resid       GEMV; LN3 statistics of each row group
//   8 LN3 into the operand
//   9 W1 + ReLU          GEMV
//  10 W2 + resid, cast; the K|V row write
// A GEMV phase (out = act W^T + b, W (O, K)) is cut into items of R output
// rows (a multiple of 8) x one K slice of KS columns, walked over the grid;
// the launch plan (ops/kernels/decoder_layer.py) picks R and KS of each
// GEMV from the grid, so that ~every block takes one item (C=1024 rows:
// 128 items of 8 rows on the H100's 132 blocks). The shared memory and the
// grid are this file's: the plan asks for them (avsr_decoder_layer_config). A block stages the operand of
// its slice for every lane in shared memory (16-byte cp.async, each block
// starting at its own offset, since all of them read the same rows), in
// stages of up to max_ks columns; its 8 warps split each stage's 32-column
// chunks. The weights run on the tensor cores: 16 lanes of the operand as
// the A operand and 8 weight rows as the B operand, the weights loaded
// straight from global memory 16 bytes a lane and issued before the block
// waits for its operand stage, the same k permutation on both operands;
// bf16 on mma.sync m16n8k16 (a lane's 8 consecutive k feed two products),
// fp32 in split TF32 on mma.sync m16n8k8 (mma_tf32.cuh: x = hi + lo,
// three tf32 products, ~2^-21 of a product dropped; a lane's 8
// consecutive k feed four products), not as one TF32 product, which keeps
// ~3 decimal digits. The warps' sums are added in a fixed order. With S > 1 each item writes its partial and the last
// block of a row group to arrive (a counter) sums the slices in slice order
// and applies the epilogue: deterministic, no atomics on values. The
// LayerNorms are computed once per row and column unit by the grid's warps
// into an operand buffer in the weight dtype: LN1 from the row, LN2 and LN3
// from each row group's (sum, centred sum of squares), which the residual
// phases leave.
//
// The attention phases take one (utterance, head) a block: its keys and
// values staged in shared memory with cp.async, all issued at once where
// they fit; with 64-wide heads q.k and P.V on the tensor cores (the keys
// and the values as the A operand, the queries and P as up to four 8-wide
// B operands: kMaxLanes = 32 lanes an utterance), bf16 caches on
// m16n8k16, fp32 caches in split TF32 on m16n8k8; else on the CUDA
// cores. Where the scores of every lane's
// rows do not fit a block's shared memory (beams above 16 over a full
// 192-row cache), the attention takes two passes over tiles of its rows:
// the statistics first, then the same scores again, p and P.V.
//
// An optional trace (a pointer in the arguments) records each block's
// global timer at the start and end of every phase, and at the steps of
// one phase (kTraceSub), for tools/layer_variants.py.
//
// The numbered phase comments of the kernel are where the variants tool
// (tools/layer_variants.py) cuts a copy of it short, to time the phases
// apart.
#include <cooperative_groups.h>
#include <stdint.h>

#include <mutex>
#include <vector>

#include "common.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 1;  // __launch_bounds__: blocks an SM
constexpr int kMaxRowTiles = 4;    // 8-row tiles of an item at most
constexpr int kMaxRows = 8 * kMaxRowTiles;
constexpr int kMaxN = 96;          // lanes of one pass over an item
constexpr int kMTiles = kMaxN / 16;
constexpr int kMaxKsBytes = 2048;  // a bf16 operand stage's bytes a lane
constexpr int kBatch = 2;          // chunks of weights loaded at once a warp
// the same for fp32 weights: the same 16-byte loads in flight a lane (one
// 32-column chunk is two a row tile); two chunks spilled registers and
// took 10% longer on the H100 (PERF.md)
constexpr int kBatchF32 = 1;
constexpr int kMaxLanes = 32;      // beam lanes K of one utterance
constexpr int kMmaDh = 64;  // the head width whose bf16 products use mma
constexpr int kStageBytes = 163840;  // an attention stage's keys and values
constexpr int kMaxSmem = 232448;  // 227 KB, the opt-in limit of a block
constexpr int kGemvs = 6;
constexpr int kPhases = 11;
constexpr int kSteps = 6;      // marks within one phase, where traced
constexpr int kTraceSub = 99;  // the phase whose steps a trace marks (99: none)
constexpr unsigned kFull = 0xffffffffu;

using avsr::cp_async16;
using avsr::cp_async_commit;
using avsr::cp_async_wait;
using bf16 = __nv_bfloat16;

template <typename TW, typename TC>
struct Args {
  const TW* x;          // (N, C) the layer's input, in the parameter dtype
  TC* kv;               // (N, S, 2C) K|V cache, row min(pos, S-1) written
  const TC* src_k;      // (B, S_enc, C)
  const TC* src_v;      // (B, S_enc, C)
  const float* mem_bias;   // (B, S_enc) additive, 0 or -1e30
  const float* lane_bias;  // (B, K, S, J) additive ancestry bias
  const TW* ln_w;       // (3, C)
  const TW* ln_b;       // (3, C)
  const TW* w_qkv;      // (3C, C)
  const TW* b_qkv;      // (3C,)
  const TW* w_out;      // (C, C)
  const TW* b_out;
  const TW* w_q2;       // (C, C)
  const TW* b_q2;
  const TW* w_out2;     // (C, C)
  const TW* b_out2;
  const TW* w_1;        // (F, C)
  const TW* b_1;        // (F,)
  const TW* w_2;        // (C, F)
  const TW* b_2;        // (C,)
  float* xres;          // (N, C) fp32 residual stream
  float* qkv;           // (N, 3C) fp32
  float* q2;            // (N, C) fp32, scaled
  TW* opnd;             // (N, max(C, F)) GEMV operands, in the weight dtype
  TW* lnop;             // (N, C) the LayerNorms' outputs, in the weight dtype
  float* stats;         // 2 x (C / 8 at most, N, 2): LN2's and LN3's groups
  float* part;          // split-K partials (slices, O, N) of one GEMV
  int* counters;        // one a row group of each GEMV, zero between calls
  TW* out;              // (N, C)
  // null, or (grid, 2 * kPhases + kSteps) global-timer marks: each block's
  // start of every phase and its arrival at the phase's end, then the
  // steps of phase kTraceSub
  unsigned long long* trace;
  // the step pos, one int32 in device memory: read as the kernel starts
  // (a launch captured in a CUDA graph reads each replay's)
  const int* step;
  int n, lanes, heads, dh, c, f, s_dec, s_enc;
  int rows[kGemvs];     // rows of an item of QKV, out, q2, out2, W1, W2
  int ks[kGemvs];       // their K slices' columns
  float scale;  // dh^-0.5 rounded to fp32
};

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return avsr::to_float(avsr::from_float<T>(x));
}

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// a shared-memory operand row's elements for a stage of `cols` columns:
// bf16 rows 64 bytes past a multiple of 128 (the 8 rows of a 16-byte load
// phase hit distinct banks); fp32 rows a 16-byte pad (rows g, g + 1 of a
// phase 4 banks apart, each lane's 16 bytes 8 floats from the next's)
template <typename TW>
__host__ __device__ constexpr int act_ld(int cols) {
  return sizeof(TW) == 2 ? cdiv(cols, 64) * 64 + 32 : cols + 4;
}

// the most K columns of an operand stage: kMaxKsBytes a lane (the warps'
// sums alias the stage)
__host__ __device__ constexpr int max_ks(int wsize) {
  return kMaxKsBytes / wsize;
}

// the 16 bytes at p, read once (not kept in L1)
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// the 16-byte chunk of a cache row at p, as floats
template <typename TC>
__device__ __forceinline__ void load_chunk(const TC* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const TC* e = reinterpret_cast<const TC*>(&raw);
#pragma unroll
  for (int i = 0; i < static_cast<int>(16 / sizeof(TC)); ++i)
    out[i] = avsr::to_float(e[i]);
}

// One GEMV of a phase: out = act W^T + b over `in` columns, items of
// `rows` output rows x one K slice of `ks` columns (a multiple of 32), so
// `slices` of them; `cnt` its counters (one a row group).
template <typename TW>
struct Gemv {
  const TW* w;
  const TW* b;
  int out, in, rows, ks, slices;
  int* cnt;

  __device__ int groups() const { return cdiv(out, rows); }
  __device__ int items() const { return groups() * slices; }
};

// The operand stage act[r][k - k0] = src[n0 + r][k] for k in [k0, k1), as
// 16-byte copies, zeros up to k0 + w32.
template <typename TW>
__device__ void copy_operand(TW* act, int ld, const TW* src, int src_ld,
                             int n0, int nn, int k0, int k1, int w32) {
  constexpr int kV = 16 / sizeof(TW);
  const int per_row = w32 / kV, total = nn * per_row;
  // every block reads the same operand: each starts at its own offset, so
  // that the blocks' requests spread over the L2's lines
  const int off = static_cast<int>((blockIdx.x * 128ull) % total);
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int e = i + off < total ? i + off : i + off - total;
    const int r = e / per_row, col = k0 + (e - r * per_row) * kV;
    const bool ok = col < k1;
    cp_async16(act + r * ld + col - k0,
               ok ? src + static_cast<size_t>(n0 + r) * src_ld + col : src,
               ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// kN consecutive values at p (16-byte aligned) as floats: 16-byte loads,
// through L2 only (`cg`: data written earlier in the launch) or read-only
template <int kN>
__device__ __forceinline__ void load_floats(const float* p, float (&out)[kN],
                                            bool cg) {
#pragma unroll
  for (int i = 0; i < kN / 4; ++i) {
    const float4* q = reinterpret_cast<const float4*>(p) + i;
    const float4 v = cg ? __ldcg(q) : __ldg(q);
    out[4 * i] = v.x;
    out[4 * i + 1] = v.y;
    out[4 * i + 2] = v.z;
    out[4 * i + 3] = v.w;
  }
}
template <int kN>
__device__ __forceinline__ void load_floats(const bf16* p, float (&out)[kN],
                                            bool cg) {
#pragma unroll
  for (int i = 0; i < kN / 8; ++i) {
    const uint4* q = reinterpret_cast<const uint4*>(p) + i;
    const uint4 raw = cg ? __ldcg(q) : __ldg(q);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int k = 0; k < 8; ++k) out[8 * i + k] = __bfloat162float(e[k]);
  }
}

// The LayerNorm of every lane's row of src (the TPU kernel's _layer_norm,
// eps 1e-12, fp32) into dst, rounded to TW, in units of (lane, 256
// columns) over the grid's warps: LN1 (gst null) from the row's mean and
// centred variance; LN2 and LN3 from the row groups' (sum s_g, centred sum
// of squares m_g) that the residual phase before left (groups of `rows`
// columns), combined pairwise (Chan et al.) once the mean is known: the
// row's centred sum of squares is sum m_g + n_g (s_g / n_g - mean)^2, a sum
// of terms >= 0, exact also where |mean| is far above the row's spread.
template <typename TW, typename TS>
__device__ void normalize(const TS* src, int c, int n, const float* gst,
                          int rows, const TW* g, const TW* b, TW* dst) {
  constexpr int kV = 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int units = cdiv(c, 32 * kV);
  for (int u = blockIdx.x * kWarps + warp; u < n * units;
       u += gridDim.x * kWarps) {
    const int nl = u / units, k = (u - nl * units) * 32 * kV + lane * kV;
    const TS* row = src + static_cast<size_t>(nl) * c;
    float mean, m2;
    if (gst == nullptr) {
      float sum = 0.f;
#pragma unroll 4
      for (int kk = lane * kV; kk < c; kk += 32 * kV) {
        float xs[kV];
        load_floats<kV>(row + kk, xs, false);
#pragma unroll
        for (int i = 0; i < kV; ++i) sum += xs[i];
      }
      mean = avsr::warp_sum(sum) / c;
      m2 = 0.f;
#pragma unroll 4
      for (int kk = lane * kV; kk < c; kk += 32 * kV) {
        float xs[kV];
        load_floats<kV>(row + kk, xs, false);
#pragma unroll
        for (int i = 0; i < kV; ++i) {
          const float d = __fsub_rn(xs[i], mean);
          m2 = fmaf(d, d, m2);
        }
      }
      m2 = avsr::warp_sum(m2);
    } else {
      const float2* st = reinterpret_cast<const float2*>(gst);
      const int groups = cdiv(c, rows);
      float sum = 0.f;
#pragma unroll 4
      for (int gi = lane; gi < groups; gi += 32)
        sum += __ldcg(st + gi * n + nl).x;
      mean = avsr::warp_sum(sum) / c;
      m2 = 0.f;
#pragma unroll 4
      for (int gi = lane; gi < groups; gi += 32) {
        const float2 v = __ldcg(st + gi * n + nl);
        const float cnt = static_cast<float>(min(rows, c - gi * rows));
        const float d = __fsub_rn(v.x / cnt, mean);
        m2 += fmaf(cnt * d, d, v.y);
      }
      m2 = avsr::warp_sum(m2);
    }
    const float rs = rsqrtf(m2 / c + 1e-12f);
    if (k < c) {
      float xs[kV], gs[kV], bs[kV];
      load_floats<kV>(row + k, xs, sizeof(TS) == 4);
      load_floats<kV>(g + k, gs, false);
      load_floats<kV>(b + k, bs, false);
      alignas(16) TW v[kV];
#pragma unroll
      for (int i = 0; i < kV; ++i)
        v[i] = avsr::from_float<TW>(__fadd_rn(
            __fmul_rn(__fmul_rn(__fsub_rn(xs[i], mean), rs), gs[i]), bs[i]));
#pragma unroll
      for (int i = 0; i < kV * static_cast<int>(sizeof(TW)) / 16; ++i)
        reinterpret_cast<uint4*>(dst + static_cast<size_t>(nl) * c + k)[i] =
            reinterpret_cast<const uint4*>(v)[i];
    }
  }
}

// A warp's chunks of an operand stage of `cols` columns: 32-column chunks
// split over the block's warps
__device__ __forceinline__ void warp_chunks(int cols, int* c0, int* c1) {
  const int chunks = cdiv(cols, 32);
  const int per = cdiv(chunks, kWarps);
  *c0 = min(threadIdx.x / 32 * per, chunks);
  *c1 = min(*c0 + per, chunks);
}

// A warp's mma accumulators (lanes mt * 16 + .. x rows nt * 8 + .., the C
// fragment of m16n8k16 and m16n8k8) into wres[warp][lane][row], once
// every warp has read the operand stage that wres aliases
__device__ __forceinline__ void warp_sums(
    const float (&acc)[kMTiles][kMaxRowTiles][4], int mt_n, int rt, int nn,
    int nn16, float* wres) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, t = lane & 3;
  const int rows = rt * 8;
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
    if (mt >= mt_n) break;
#pragma unroll
    for (int nt = 0; nt < kMaxRowTiles; ++nt) {
      if (nt >= rt) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int nl = mt * 16 + gq + (e >> 1) * 8;
        const int r = nt * 8 + 2 * t + (e & 1);
        if (nl < nn) wres[(warp * nn16 + nl) * rows + r] = acc[mt][nt][e];
      }
    }
  }
  __syncthreads();
}

// One item's products over the operand stages of [k0, k1), bf16 on the
// tensor cores: the warp's sums over its chunks of every stage, lanes
// n0..n0+nn-1 x rows o0..o0+rt*8-1, land in wres[warp][lane][row] (which
// aliases the operand stage: written after every warp has read it).
// stage(act, ld, kb, ke, w32) stages the operand of columns [kb, ke).
template <typename Stage>
__device__ void item_products(const bf16* __restrict__ w, int out, int in,
                              int o0, int rt, int k0, int k1, int nn,
                              bf16* act, float* wres, int nn16,
                              Stage stage) {
  const int lane = threadIdx.x % 32;
  const int gq = lane >> 2, t = lane & 3;
  const int mt_n = nn16 / 16;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  float acc[kMTiles][kMaxRowTiles][4];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int nt = 0; nt < kMaxRowTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  const int most = max_ks(2);
  for (int kb = k0; kb < k1; kb += most) {
    const int ke = min(kb + most, k1);
    const int w32 = cdiv(ke - kb, 32) * 32;
    const int ld = act_ld<bf16>(w32);
    int c0, c1;
    warp_chunks(ke - kb, &c0, &c1);
    // the weights of chunks c0 .. c0 + kBatch - 1 of the warp, for every
    // 8-row tile: lane (g, t) holds k 8t..8t+7 of row g
    uint4 wv[kBatch][kMaxRowTiles];
    auto load_w = [&](int cb) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
#pragma unroll
        for (int nt = 0; nt < kMaxRowTiles; ++nt) {
          const int row = o0 + nt * 8 + gq;
          const int col = kb + (cb + u) * 32 + 8 * t;
          wv[u][nt] = cb + u < c1 && nt < rt && row < out && col < ke
                          ? ld_stream(w + static_cast<size_t>(row) * in + col)
                          : zero;
        }
    };
    load_w(c0);  // in flight while the block stages the operand
    stage(act, ld, kb, ke, w32);
    for (int cb = c0; cb < c1; cb += kBatch) {
      if (cb != c0) load_w(cb);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (cb + u >= c1) break;  // uniform over the warp
        const bf16* arow = act + gq * ld + (cb + u) * 32 + 8 * t;
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) {
          if (mt >= mt_n) break;
          // lanes g and g + 8 of the m-tile: logical k pairs (2t, 2t+1)
          // and (2t+8, 2t+9) of the first product are physical k
          // 8t..8t+3, of the second 8t+4..8t+7; the weights' likewise
          const uint4 r0 =
              *reinterpret_cast<const uint4*>(arow + mt * 16 * ld);
          const uint4 r8 =
              *reinterpret_cast<const uint4*>(arow + (mt * 16 + 8) * ld);
          const uint32_t a1[4] = {r0.x, r8.x, r0.y, r8.y};
          const uint32_t a2[4] = {r0.z, r8.z, r0.w, r8.w};
#pragma unroll
          for (int nt = 0; nt < kMaxRowTiles; ++nt) {
            if (nt < rt) {
              avsr::mma::mma16816(acc[mt][nt], a1, wv[u][nt].x, wv[u][nt].y);
              avsr::mma::mma16816(acc[mt][nt], a2, wv[u][nt].z, wv[u][nt].w);
            }
          }
        }
      }
    }
    __syncthreads();  // every warp has read the stage
  }
  warp_sums(acc, mt_n, rt, nn, nn16, wres);
}

// The same for fp32 weights, on the tensor cores in split TF32
// (mma_tf32.cuh): mma.sync m16n8k8 tf32, 16 lanes of the operand as the A
// operand and 8 weight rows as the B operand, each value x = hi + lo and
// three products (lo_a hi_b, hi_a lo_b, hi_a hi_b) into the fp32
// accumulators. The k permutation: lane (g, t) holds physical k
// 8t..8t+7 of a 32-column chunk, of its weight row g (two 16-byte loads
// straight from global memory, issued before the block waits for its
// operand stage) and of its operand rows g and g + 8 (two 16-byte shared
// loads a row); the chunk's four k8 products p = 2h + j take physical k
// 8t + 4h + 2j as logical k = t and 8t + 4h + 2j + 1 as k = t + 4, on both
// operands, so every column enters one product once and no value is
// shuffled. A weight value is split once and serves every m-tile; an
// operand value once and serves every row tile (mma_split_rows, the three
// terms each issued across the row tiles). Stage rows of w32 + 4 floats:
// the 8 lanes of a 16-byte load phase read rows g, g + 1 at k 8t (+4),
// banks 4g + 8t.. (mod 32), all distinct. Not inlined into its six GEMV
// phases: inlined, nvcc took 1.7x as long on this file, the build's
// longest step, for a kernel 3.5% faster (PERF.md).
template <typename Stage>
__device__ __noinline__ void item_products(const float* __restrict__ w,
                                           int out, int in,
                              int o0, int rt, int k0, int k1, int nn,
                              float* act, float* wres, int nn16,
                              Stage stage) {
  const int lane = threadIdx.x % 32;
  const int gq = lane >> 2, t = lane & 3;
  const int mt_n = nn16 / 16;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  float acc[kMTiles][kMaxRowTiles][4];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int nt = 0; nt < kMaxRowTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  const int most = max_ks(4);
  for (int kb = k0; kb < k1; kb += most) {
    const int ke = min(kb + most, k1);
    const int w32 = cdiv(ke - kb, 32) * 32;
    const int ld = act_ld<float>(w32);
    int c0, c1;
    warp_chunks(ke - kb, &c0, &c1);
    // the weights of chunks c0 .. c0 + kBatchF32 - 1 of the warp, for
    // every 8-row tile: lane (g, t) holds k 8t..8t+3 (h = 0) and
    // 8t+4..8t+7 (h = 1) of row g (ke is a multiple of 8: each 4 lie all
    // below it or all past it)
    uint4 wv[kBatchF32][kMaxRowTiles][2];
    auto load_w = [&](int cb) {
#pragma unroll
      for (int u = 0; u < kBatchF32; ++u)
#pragma unroll
        for (int nt = 0; nt < kMaxRowTiles; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = o0 + nt * 8 + gq;
            const int col = kb + (cb + u) * 32 + 8 * t + 4 * h;
            wv[u][nt][h] =
                cb + u < c1 && nt < rt && row < out && col < ke
                    ? ld_stream(w + static_cast<size_t>(row) * in + col)
                    : zero;
          }
    };
    load_w(c0);  // in flight while the block stages the operand
    stage(act, ld, kb, ke, w32);
    for (int cb = c0; cb < c1; cb += kBatchF32) {
      if (cb != c0) load_w(cb);
#pragma unroll
      for (int u = 0; u < kBatchF32; ++u) {
        if (cb + u >= c1) break;  // uniform over the warp
        const float* arow = act + gq * ld + (cb + u) * 32 + 8 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // the weights of products 2h and 2h + 1, split once for every
          // m-tile: (k = t, t + 4) of product 2h + j are .x/.y (j = 0)
          // and .z/.w (j = 1)
          uint32_t bhi[2][kMaxRowTiles][2], blo[2][kMaxRowTiles][2];
#pragma unroll
          for (int nt = 0; nt < kMaxRowTiles; ++nt) {
            const uint4 v = wv[u][nt][h];
            avsr::tf32::split_tf32(__uint_as_float(v.x), bhi[0][nt][0],
                                   blo[0][nt][0]);
            avsr::tf32::split_tf32(__uint_as_float(v.y), bhi[0][nt][1],
                                   blo[0][nt][1]);
            avsr::tf32::split_tf32(__uint_as_float(v.z), bhi[1][nt][0],
                                   blo[1][nt][0]);
            avsr::tf32::split_tf32(__uint_as_float(v.w), bhi[1][nt][1],
                                   blo[1][nt][1]);
          }
#pragma unroll
          for (int mt = 0; mt < kMTiles; ++mt) {
            if (mt >= mt_n) break;
            // rows g and g + 8 of the m-tile at physical k 8t + 4h ..
            const float4 r0 =
                *reinterpret_cast<const float4*>(arow + mt * 16 * ld + 4 * h);
            const float4 r8 = *reinterpret_cast<const float4*>(
                arow + (mt * 16 + 8) * ld + 4 * h);
            uint32_t ahi[4], alo[4];
            avsr::tf32::split_a(ahi, alo, r0.x, r8.x, r0.y, r8.y);
            avsr::tf32::mma_split_rows<kMaxRowTiles>(acc[mt], ahi, alo,
                                                     bhi[0], blo[0], rt);
            avsr::tf32::split_a(ahi, alo, r0.z, r8.z, r0.w, r8.w);
            avsr::tf32::mma_split_rows<kMaxRowTiles>(acc[mt], ahi, alo,
                                                     bhi[1], blo[1], rt);
          }
        }
      }
    }
    __syncthreads();  // every warp has read the stage
  }
  warp_sums(acc, mt_n, rt, nn, nn16, wres);
}

// The GEMV region of a block's shared memory: the operand stage of one
// pass of up to kMaxN lanes, whatever the lanes in all, which the warps'
// sums alias
__host__ __device__ inline size_t gemv_bytes(int n, int wsize) {
  const size_t nn16 = cdiv(n < kMaxN ? n : kMaxN, 16) * 16;
  const int ks = max_ks(wsize);
  const size_t act =
      nn16 * (wsize == 2 ? act_ld<bf16>(ks) : act_ld<float>(ks)) * wsize;
  const size_t wres = sizeof(float) * kWarps * nn16 * kMaxRows;
  const size_t body = act > wres ? act : wres;
  return (body + 15) / 16 * 16;
}

// One GEMV phase over the grid. load(act, ld, n0, nn, kb, ke, w32) stages
// the operand of columns [kb, ke) for lanes n0..n0+nn-1 (ending in
// __syncthreads); epi(lane, o, value) takes each finished output, bias
// added; step(k) marks the item's steps in a trace. With `xres` (row
// stride c), a residual phase: each output is added to xres instead (its
// old value read through L2 as the output is finished; the item's biases
// fetched as it starts), and the block that finishes a row group leaves
// each lane's (sum, centred sum of squares) of the group's new residual
// columns at gst[(group, lane)].
template <typename TW, typename Load, typename Epi, typename Step>
__device__ void gemv_phase(const Gemv<TW>& g, int n, float* part,
                           unsigned char* smem, Load load, Epi epi,
                           Step step, float* xres = nullptr, int c = 0,
                           float* gst = nullptr) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ks = g.ks, rows = g.rows, rt = rows / 8;
  __shared__ int last;
  __shared__ float bias[kMaxRows];
  for (int it = blockIdx.x; it < g.items(); it += gridDim.x) {
    const int rg = it / g.slices, s = it - rg * g.slices;
    const int o0 = rg * rows;
    const int k0 = s * ks, k1 = min(k0 + ks, g.in);
    const int c1 = min(o0 + rows, g.out);
    // the item's biases, in flight while it works (read after the
    // products' barriers)
    for (int r = threadIdx.x; r < rows; r += kThreads)
      bias[r] = o0 + r < g.out ? avsr::to_float(g.b[o0 + r]) : 0.f;
    auto finish = [&](int nl, int r, float v) {
      const int o = o0 + r;
      v = __fadd_rn(v, bias[r]);
      if (xres != nullptr) {
        float* x = xres + static_cast<size_t>(nl) * c + o;
        *x = __fadd_rn(__ldcg(x), v);
      } else {
        epi(nl, o, v);
      }
    };
    for (int n0 = 0; n0 < n; n0 += kMaxN) {
      const int nn = min(kMaxN, n - n0), nn16 = cdiv(nn, 16) * 16;
      TW* act = reinterpret_cast<TW*>(smem);
      float* wres = reinterpret_cast<float*>(smem);
      item_products(g.w, g.out, g.in, o0, rt, k0, k1, nn, act, wres, nn16,
                    [&](TW* a, int ld, int kb, int ke, int w32) {
                      load(a, ld, n0, nn, kb, ke, w32);
                      step(0);
                    });
      step(1);
      // the warps' sums, in order
      for (int e = threadIdx.x; e < rows * nn; e += kThreads) {
        const int nl = e / rows, r = e - nl * rows;
        if (o0 + r >= g.out) continue;
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v += wres[(w * nn16 + nl) * rows + r];
        if (g.slices == 1)
          finish(n0 + nl, r, v);
        else
          part[(static_cast<size_t>(s) * g.out + o0 + r) * n + n0 + nl] = v;
      }
      __syncthreads();
      step(2);
    }
    bool done = g.slices == 1;
    if (!done) {
      // the last block of the row group to arrive sums the slices in order
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0)
        last = atomicAdd(g.cnt + rg, 1) == g.slices - 1;
      __syncthreads();
      done = last;
      if (done) {
        __threadfence();
        for (int e = threadIdx.x; e < rows * n; e += kThreads) {
          const int nl = e / rows, r = e - nl * rows;
          const int o = o0 + r;
          if (o >= g.out) continue;
          float v = 0.f;
#pragma unroll 4
          for (int s2 = 0; s2 < g.slices; ++s2)
            v += __ldcg(part + (static_cast<size_t>(s2) * g.out + o) * n + nl);
          finish(nl, r, v);
        }
        if (threadIdx.x == 0) g.cnt[rg] = 0;  // zero for the next call
      }
    }
    step(3);
    if (done && gst != nullptr) {
      __syncthreads();  // the block's new residual values, in xres
#pragma unroll 4
      for (int nl = warp; nl < n; nl += kWarps) {
        const bool mine = o0 + lane < c1;  // rows <= 32: a column a lane
        const float v =
            mine ? __ldcg(xres + static_cast<size_t>(nl) * c + o0 + lane)
                 : 0.f;
        const float sum = avsr::warp_sum(v);
        const float d = mine ? v - sum / (c1 - o0) : 0.f;
        const float m2 = avsr::warp_sum(d * d);
        if (lane == 0) {
          gst[(rg * n + nl) * 2] = sum;
          gst[(rg * n + nl) * 2 + 1] = m2;
        }
      }
    }
    __syncthreads();
    step(4);
  }
}

// The rows an attention reads: row r = j * per_lane + s (lane j of the
// utterance, position s) lies at base + j * lane_stride + s * row_stride, the
// value half `half` elements after the key; its bias for query kq at
// bias + kq * bias_q + s * bias_s + j * bias_j.
template <typename TC>
struct Rows {
  const TC* base;
  int per_lane;
  size_t lane_stride, row_stride;
  ptrdiff_t half;
  const float* bias;
  size_t bias_q, bias_s, bias_j;
};

// The attention scratch at the start of a block's shared memory, offsets in
// floats: the queries, the fresh keys and values ((lanes, dh) each), the
// fresh scores, the joint (m, den) of each query, `red` (the warps' softmax
// statistics, then the P.V's sums), the scores (lanes x span); then, in
// bytes, the key and value stages of `tile` rows each (rounded up to 16, a
// row dh elements and a 16-byte pad). span: every row of the longer
// attention (`rows`: one pass) where their scores and stages of 16 rows
// fit, the stages then of up to kStageBytes; else a tile, as large as the
// tile's scores and its stages fit (two passes).
struct AttnLayout {
  int qs, kn, vn, cur, joint, red, sc;
  int span, tile;
  size_t kbuf, vbuf, bytes;
};

__host__ __device__ inline int round4(int x) { return (x + 3) / 4 * 4; }

__host__ __device__ inline AttnLayout attn_layout(int lanes, int dh,
                                                  int rows, int csize) {
  AttnLayout l;
  const size_t ld = static_cast<size_t>(dh) * csize + 16;  // a stage row
  l.qs = 0;
  l.kn = lanes * dh;
  l.vn = 2 * lanes * dh;
  l.cur = 3 * lanes * dh;
  l.joint = l.cur + round4(lanes);
  l.red = l.joint + round4(2 * lanes);
  // red: the warps' statistics, then the P.V's sums: the warps' partials
  // of one query tile, or (lanes, dh)
  int red = lanes * dh > 2 * kWarps * lanes ? lanes * dh : 2 * kWarps * lanes;
  if (lanes <= 8 && kWarps * lanes * dh > red) red = kWarps * lanes * dh;
  l.sc = l.red + round4(red);
  const size_t head = sizeof(float) * l.sc;
  const size_t all = sizeof(float) * ((static_cast<size_t>(lanes) * rows + 3) /
                                      4 * 4);
  const size_t most_stage = kStageBytes / (2 * ld) / 16 * 16;
  if (head + all + 2 * 16 * ld <= kMaxSmem) {
    size_t most = (kMaxSmem - head - all) / (2 * ld) / 16 * 16;
    most = most < most_stage ? most : most_stage;
    l.span = rows;
    l.tile = static_cast<size_t>(rows) <= most ? rows : static_cast<int>(most);
  } else {
    size_t most = (kMaxSmem - head) / (2 * ld + sizeof(float) * lanes) / 16 *
                  16;
    l.span = l.tile = static_cast<int>(most < most_stage ? most : most_stage);
  }
  l.kbuf = head + sizeof(float) * ((static_cast<size_t>(lanes) * l.span + 3) /
                                   4 * 4);
  l.vbuf = l.kbuf + static_cast<size_t>(cdiv(l.tile, 16) * 16) * ld;
  l.bytes = l.vbuf + static_cast<size_t>(cdiv(l.tile, 16) * 16) * ld;
  return l;
}

// Attention of `lanes` (<= kMaxLanes) queries qs (lanes, dh) over `rows`
// stored rows of one (utterance, head): scores = q . key(r) + bias(kq, r),
// plus, with `fresh`, one more score cur[kq] and value vn[kq] per query (its
// own fresh row). Softmax in fp32, denominator clamped at 1e-30,
// probabilities rounded to TC; out(kq, d, value). The scratch is `lay`'s,
// from `smf`. The rows' keys and values are copied into shared memory with
// cp.async (positions stepped by additions, not divisions), issued all at
// once where they fit one stage of `lay.tile` rows (the serving shapes),
// else tile by tile, the bias copied into the scores beside them. Where the
// scores of every row fit (rows <= lay.span) one pass: all the scores, their
// statistics, p, then P.V over the values' tiles. Else two passes over the
// tiles: the tile's scores and their statistics folded into the joint
// (max, shifted sum) in tile order; then each tile's keys, bias and values
// again, the same scores (the same products in the same order), p and
// P.V. With dh = kMmaDh, q.k and P.V run on the tensor cores: with a bf16
// cache mma.sync m16n8k16, the queries as up to kMaxLanes / 8 8-wide
// operands fed by the same ldmatrix'd keys and transposed values, P exact
// in bf16 since it is rounded already, as decode_attention.cu does; with
// an fp32 cache mma.sync m16n8k8 in split TF32 (mma_tf32.cuh), the same
// roles, keys, values, queries and P each split hi + lo at use; either
// way the P.V's warps take (16 head dims, every other 16 rows) with more
// than one query tile and the two row halves add in order, and with one
// each warp's rows, its partials added in warp order. Otherwise on the
// CUDA cores, a thread a (query, 16-byte chunk) of the P.V summing the
// rows in order. The softmax's statistics are taken by all warps over row
// ranges and combined in warp order (expf, exact). step(k) marks the
// steps in a trace.
template <typename TC, typename Out, typename Step>
__device__ void attend(int lanes, int rows, int dh, float* smf,
                       const AttnLayout& lay, const Rows<TC>& rw, bool fresh,
                       Out out, Step step) {
  constexpr int kVec = 16 / sizeof(TC);
  constexpr bool kBf16 = sizeof(TC) == 2;
  constexpr int kQTiles = kMaxLanes / 8;  // query tiles of the mma path
  const bool mma = dh == kMmaDh;
  const int tid = threadIdx.x, warp = tid / 32, lane_id = tid % 32;
  const int gq = lane_id >> 2, cq = 2 * (lane_id & 3), c4 = lane_id & 3;
  const int nq = cdiv(lanes, 8);  // query tiles
  const int cpr = dh / kVec;          // threads per row, a power of two
  const int groups = kThreads / cpr;  // rows in flight
  const int chunk = tid % cpr, grp = tid / cpr;
  const int ld = dh + kVec;           // a stage row and its 16-byte pad
  const int tile = lay.tile;
  const bool one = rows <= lay.span;  // every row's scores at once
  const int stride = one ? rows : tile;  // a query's scores
  const int ntiles = cdiv(rows, tile);
  const float* qs = smf + lay.qs;
  const float* vn = smf + lay.vn;
  const float* cur = smf + lay.cur;
  float* joint = smf + lay.joint;
  float* red = smf + lay.red;
  float* sc = smf + lay.sc;
  TC* kbuf = reinterpret_cast<TC*>(reinterpret_cast<char*>(smf) + lay.kbuf);
  TC* vbuf = reinterpret_cast<TC*>(reinterpret_cast<char*>(smf) + lay.vbuf);
  // copies of rows r0 .. r0 + nr - 1 (keys, or values with `half`) into
  // buf, zeros up to a multiple of 16 rows
  auto copy_rows = [&](TC* buf, ptrdiff_t half, int r0, int nr) {
    const int n16 = cdiv(nr, 16) * 16;
    int j = (r0 + grp) / rw.per_lane, s = (r0 + grp) % rw.per_lane;
    for (int r = grp; r < n16; r += groups) {
      const bool ok = r < nr;
      const TC* src = rw.base + half + j * rw.lane_stride + s * rw.row_stride +
                      chunk * kVec;
      cp_async16(buf + r * ld + chunk * kVec, ok ? src : rw.base, ok);
      for (s += groups; s >= rw.per_lane; s -= rw.per_lane) ++j;
    }
  };
  // the bias of rows r0 .. r0 + nr - 1 into the scores at `at`
  auto copy_bias = [&](float* at, int r0, int nr) {
    for (int kq = 0; kq < lanes; ++kq) {
      int j = (r0 + tid) / rw.per_lane, s = (r0 + tid) % rw.per_lane;
      for (int r = tid; r < nr; r += kThreads) {
        avsr::cp_async4(at + kq * stride + r, rw.bias + kq * rw.bias_q +
                                                  s * rw.bias_s +
                                                  j * rw.bias_j);
        for (s += kThreads; s >= rw.per_lane; s -= rw.per_lane) ++j;
      }
    }
  };
  // the queries as bf16 pairs in the fresh keys' place (read before the
  // attention), rows of kQb words (a 16-byte pad: the 8 queries of a
  // fragment hit distinct banks): the 8-wide B operands (query 8 nt + gq,
  // dims cq, cq+1 and cq+8, cq+9 of each 16) one 32-bit load each,
  // rounded to bf16 as qs holds them
  constexpr int kQb = kMmaDh / 2 + 4;
  uint32_t* qb = reinterpret_cast<uint32_t*>(smf + lay.kn);
  if (mma && kBf16) {
    for (int e = tid; e < lanes * kMmaDh / 2; e += kThreads) {
      const int kq = e / (kMmaDh / 2), d = 2 * (e % (kMmaDh / 2));
      qb[kq * kQb + d / 2] =
          avsr::mma::pack_bf16(qs[kq * dh + d], qs[kq * dh + d + 1]);
    }
    __syncthreads();
  }
  // the scores of the nr rows in kbuf added into theirs at `at` (the bias)
  auto scores = [&](float* at, int nr) {
    if (mma && !kBf16) {
      // fp32: S = K q^T in split TF32, a warp's 16 rows at a time, every
      // query tile from the same split K fragments (mma_split_rows); the
      // GEMV's k permutation over each 32 of the head's dims: lane (g, c)
      // reads dims 8c..8c+7 of rows g and g + 8 (16-byte loads, rows of
      // dh + 4 floats: conflict-free) and of its query g, product p
      // taking dims 8c + 2p and 8c + 2p + 1 as k = c and c + 4
      const float* kf = reinterpret_cast<const float*>(kbuf);
      for (int t16 = warp * 16; t16 < nr; t16 += kWarps * 16) {
        float acc[kQTiles][4];
#pragma unroll
        for (int nt = 0; nt < kQTiles; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
        for (int hf = 0; hf < kMmaDh / 32; ++hf) {
          const float* k0 = kf + (t16 + gq) * ld + 32 * hf + 8 * c4;
          float r0[8], r8[8];
#pragma unroll
          for (int i = 0; i < 8; i += 4) {
            const float4 x0 = *reinterpret_cast<const float4*>(k0 + i);
            const float4 x8 =
                *reinterpret_cast<const float4*>(k0 + 8 * ld + i);
            r0[i] = x0.x, r0[i + 1] = x0.y, r0[i + 2] = x0.z,
            r0[i + 3] = x0.w;
            r8[i] = x8.x, r8[i + 1] = x8.y, r8[i + 2] = x8.z,
            r8[i + 3] = x8.w;
          }
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            uint32_t ahi[4], alo[4], bhi[kQTiles][2], blo[kQTiles][2];
            avsr::tf32::split_a(ahi, alo, r0[2 * p], r8[2 * p],
                                r0[2 * p + 1], r8[2 * p + 1]);
#pragma unroll
            for (int nt = 0; nt < kQTiles; ++nt) {
              const int kq = nt * 8 + gq;
              const float2 q =
                  kq < lanes ? *reinterpret_cast<const float2*>(
                                   qs + kq * dh + 32 * hf + 8 * c4 + 2 * p)
                             : make_float2(0.f, 0.f);
              avsr::tf32::split_tf32(q.x, bhi[nt][0], blo[nt][0]);
              avsr::tf32::split_tf32(q.y, bhi[nt][1], blo[nt][1]);
            }
            avsr::tf32::mma_split_rows<kQTiles>(acc, ahi, alo, bhi, blo,
                                                nq);
          }
        }
#pragma unroll
        for (int nt = 0; nt < kQTiles; ++nt) {
          if (nt >= nq) break;  // uniform over the block
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = t16 + gq + (e >> 1) * 8;
            const int kq = nt * 8 + cq + (e & 1);
            if (kq < lanes && row < nr) {
              float* sp = at + kq * stride + row;
              *sp = __fadd_rn(acc[nt][e], *sp);
            }
          }
        }
      }
    } else if (mma) {
      // a warp's 16 rows at a time: S (16 rows x 8 queries) = K q^T for
      // every query tile from the same K fragments
      for (int t16 = warp * 16; t16 < nr; t16 += kWarps * 16) {
        uint32_t af[kMmaDh / 16][4];
#pragma unroll
        for (int kk = 0; kk < kMmaDh / 16; ++kk)
          avsr::mma::load_a<kMmaDh>(
              af[kk], reinterpret_cast<const bf16*>(kbuf) + t16 * ld, kk,
              lane_id);
#pragma unroll
        for (int nt = 0; nt < kQTiles; ++nt) {
          if (nt * 8 >= lanes) break;  // uniform over the block
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          const bool live = nt * 8 + gq < lanes;  // zeros past the lanes
          const uint32_t* qrow = qb + (nt * 8 + gq) * kQb + cq / 2;
#pragma unroll
          for (int kk = 0; kk < kMmaDh / 16; ++kk)
            avsr::mma::mma16816(acc, af[kk], live ? qrow[kk * 8] : 0u,
                                live ? qrow[kk * 8 + 4] : 0u);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = t16 + gq + (e >> 1) * 8;
            const int kq = nt * 8 + cq + (e & 1);
            if (kq < lanes && row < nr) {
              float* sp = at + kq * stride + row;
              *sp = __fadd_rn(acc[e], *sp);
            }
          }
        }
      }
    } else {
      // cpr threads a row, one query after another, a shuffle summing
      // their chunks; the pass and query counts are uniform over the
      // block, so every lane reaches the shuffles
#pragma unroll 2
      for (int q0 = 0; q0 < nr; q0 += groups) {
        const int r = q0 + grp;
        const bool ok = r < nr;
        float kv[kVec];
        if (ok) {
          load_chunk(kbuf + r * ld + chunk * kVec, kv);
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) kv[e] = 0.f;
        }
        for (int kq = 0; kq < lanes; ++kq) {
          const float* qrow = qs + kq * dh + chunk * kVec;
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < kVec; ++e) part = fmaf(qrow[e], kv[e], part);
          for (int off = 1; off < cpr; off <<= 1)
            part += __shfl_xor_sync(kFull, part, off);
          if (ok && chunk == 0) {
            float* sp = at + kq * stride + r;
            *sp = __fadd_rn(part, *sp);
          }
        }
      }
    }
  };
  // the statistics of the nr scores at `at`: each warp's (max, sum) over
  // its row range for every query, folded into the joint in warp order
  auto fold = [&](const float* at, int nr) {
    const int per = cdiv(nr, kWarps);
    const int b0 = warp * per, b1 = min(b0 + per, nr);
    for (int kq = 0; kq < lanes; ++kq) {
      const float* srow = at + kq * stride;
      float mx = -INFINITY;
      for (int e = b0 + lane_id; e < b1; e += 32) mx = fmaxf(mx, srow[e]);
      mx = avsr::warp_max(mx);
      const float safe = fmaxf(mx, -3.0e38f);
      float sum = 0.f;
      for (int e = b0 + lane_id; e < b1; e += 32) sum += expf(srow[e] - safe);
      sum = avsr::warp_sum(sum);
      if (lane_id == 0) {
        red[(warp * lanes + kq) * 2] = mx;
        red[(warp * lanes + kq) * 2 + 1] = sum;
      }
    }
    __syncthreads();
    if (tid < lanes) {
      float m = joint[2 * tid], den = joint[2 * tid + 1];
      for (int w = 0; w < kWarps; ++w)
        avsr::combine_lse(m, den, red[(w * lanes + tid) * 2],
                          red[(w * lanes + tid) * 2 + 1]);
      joint[2 * tid] = m;
      joint[2 * tid + 1] = den;
    }
    __syncthreads();
  };
  // p of the nr scores at `at`, normalised, in the cache dtype
  auto probs = [&](float* at, int nr) {
    for (int kq = 0; kq < lanes; ++kq) {
      const float m = joint[2 * kq], den = joint[2 * kq + 1];
      const float inv = __frcp_rn(den);
      for (int r = tid; r < nr; r += kThreads) {
        float* sp = at + kq * stride + r;
        *sp = round_to<TC>(avsr::mma::div_rn(expf(*sp - m), den, inv));
      }
    }
  };

  // pass 1: the scores and the joint statistics, the fresh score first
  if (tid < lanes) {
    joint[2 * tid] = fresh ? cur[tid] : -INFINITY;
    joint[2 * tid + 1] = fresh ? 1.f : 0.f;
  }
  if (one && rows > 0) copy_bias(sc, 0, rows);
  for (int t = 0; t < ntiles; ++t) {
    const int r0 = t * tile, nr = min(tile, rows - r0);
    if (!one) copy_bias(sc, r0, nr);
    copy_rows(kbuf, 0, r0, nr);
    cp_async_commit();
    if (ntiles == 1) {  // the values' copies fly during the scores
      copy_rows(vbuf, rw.half, 0, rows);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    step(0);
    scores(one ? sc + r0 : sc, nr);
    __syncthreads();
    if (!one) fold(sc, nr);
  }
  step(1);
  if (one) fold(sc, rows);
  if (tid < lanes) joint[2 * tid + 1] = fmaxf(joint[2 * tid + 1], 1e-30f);
  if (!mma)  // red becomes the P.V's sums
    for (int e = tid; e < lanes * dh; e += kThreads) red[e] = 0.f;
  __syncthreads();

  // pass 2: p and P.V (in two passes, each tile's scores again first)
  if (one) {
    probs(sc, rows);
    __syncthreads();
  }
  step(2);
  // the mma P.V's accumulators: with one query tile, the warp's rows for
  // all four 16-dim head slices (the warps split the rows); with more,
  // head slice mt of every query tile over the row groups of one half
  const bool one_tile = lanes <= 8;
  const int mt = warp & 3, half = warp >> 2;
  float oacc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[i][e] = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    const int r0 = t * tile, nr = min(tile, rows - r0);
    if (!one) {
      copy_bias(sc, r0, nr);
      copy_rows(kbuf, 0, r0, nr);
      copy_rows(vbuf, rw.half, r0, nr);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      scores(sc, nr);
      __syncthreads();
      probs(sc, nr);
    } else {
      if (ntiles > 1) {
        copy_rows(vbuf, rw.half, r0, nr);
        cp_async_commit();
      }
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* pt = one ? sc + r0 : sc;
    const float* vf = reinterpret_cast<const float*>(vbuf);
    // fp32: P's split pair (rows r, r + 1 of query kq; zeros past the
    // lanes and the rows, whose V rows are zeros too)
    auto p_split = [&](int kq, int r, uint32_t (&hi)[2], uint32_t (&lo)[2]) {
      const bool live = kq < lanes;
      avsr::tf32::split_tf32(live && r < nr ? pt[kq * stride + r] : 0.f,
                             hi[0], lo[0]);
      avsr::tf32::split_tf32(live && r + 1 < nr ? pt[kq * stride + r + 1]
                                                : 0.f,
                             hi[1], lo[1]);
    };
    if (mma && !kBf16 && one_tile) {
      // fp32, out^T (dh x 8 queries) = V^T P^T in split TF32, a warp's 16
      // rows at a time as two k8 steps; a step's k = c and c + 4 are rows
      // 2c and 2c + 1 (V^T's A fragment then reads banks 8c + g + ..:
      // conflict-free), P's pair split once for the four head slices,
      // each term issued across them
      for (int t16 = warp * 16; t16 < nr; t16 += kWarps * 16) {
#pragma unroll
        for (int s8 = 0; s8 < 16; s8 += 8) {
          const int r = t16 + s8 + 2 * c4;
          uint32_t bhi[2], blo[2], ahi[4][4], alo[4][4];
          p_split(gq, r, bhi, blo);
#pragma unroll
          for (int m4 = 0; m4 < 4; ++m4) {
            const float* v = vf + r * ld + m4 * 16 + gq;
            avsr::tf32::split_a(ahi[m4], alo[m4], v[0], v[8], v[ld],
                                v[ld + 8]);
          }
#pragma unroll
          for (int m4 = 0; m4 < 4; ++m4)
            avsr::tf32::mma_tf32(oacc[m4], alo[m4], bhi[0], bhi[1]);
#pragma unroll
          for (int m4 = 0; m4 < 4; ++m4)
            avsr::tf32::mma_tf32(oacc[m4], ahi[m4], blo[0], blo[1]);
#pragma unroll
          for (int m4 = 0; m4 < 4; ++m4)
            avsr::tf32::mma_tf32(oacc[m4], ahi[m4], bhi[0], bhi[1]);
        }
      }
    } else if (mma && !kBf16) {
      // fp32, warp (mt, half): head dims 16 mt.. of every query tile over
      // the tile's row groups half, half + 2, ...; V^T's split fragment
      // shared by the query tiles (mma_split_rows)
      for (int t16 = half * 16; t16 < nr; t16 += 32) {
#pragma unroll
        for (int s8 = 0; s8 < 16; s8 += 8) {
          const int r = t16 + s8 + 2 * c4;
          const float* v = vf + r * ld + mt * 16 + gq;
          uint32_t ahi[4], alo[4], bhi[4][2], blo[4][2];
          avsr::tf32::split_a(ahi, alo, v[0], v[8], v[ld], v[ld + 8]);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) p_split(nt * 8 + gq, r, bhi[nt],
                                                 blo[nt]);
          avsr::tf32::mma_split_rows<4>(oacc, ahi, alo, bhi, blo, nq);
        }
      }
    } else if (mma && one_tile) {
      // out^T (dh x 8 queries) = V^T P^T, a warp's 16 rows at a time
      for (int t16 = warp * 16; t16 < nr; t16 += kWarps * 16) {
        auto p = [&](int row) {
          return gq < lanes && row < nr ? pt[gq * stride + row] : 0.f;
        };
        const uint32_t b0 = avsr::mma::pack_bf16(p(t16 + cq), p(t16 + cq + 1));
        const uint32_t b1 =
            avsr::mma::pack_bf16(p(t16 + cq + 8), p(t16 + cq + 9));
        const bf16* v16 = reinterpret_cast<const bf16*>(vbuf) +
                          (t16 + ((lane_id >> 4) & 1) * 8 + (lane_id & 7)) *
                              ld +
                          ((lane_id >> 3) & 1) * 8;
#pragma unroll
        for (int m4 = 0; m4 < 4; ++m4) {
          uint32_t af[4];
          avsr::mma::ldsm_x4_t(af, v16 + m4 * 16);
          avsr::mma::mma16816(oacc[m4], af, b0, b1);
        }
      }
    } else if (mma) {
      // out^T (dh x 8 queries) = V^T P^T: warp (mt, half) takes head dims
      // 16 mt..16 mt + 15 of every query tile over the tile's row groups
      // half, half + 2, ...; zero p past the tile's rows, whose V rows are
      // zeros too
      const bf16* v16 = reinterpret_cast<const bf16*>(vbuf) +
                        (((lane_id >> 4) & 1) * 8 + (lane_id & 7)) * ld +
                        ((lane_id >> 3) & 1) * 8 + mt * 16;
      for (int t16 = half * 16; t16 < nr; t16 += 32) {
        uint32_t af[4];
        avsr::mma::ldsm_x4_t(af, v16 + t16 * ld);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt * 8 >= lanes) break;  // uniform over the block
          const int kq = nt * 8 + gq;
          auto p = [&](int row) {
            return kq < lanes && row < nr ? pt[kq * stride + row] : 0.f;
          };
          const uint32_t b0 =
              avsr::mma::pack_bf16(p(t16 + cq), p(t16 + cq + 1));
          const uint32_t b1 =
              avsr::mma::pack_bf16(p(t16 + cq + 8), p(t16 + cq + 9));
          avsr::mma::mma16816(oacc[nt], af, b0, b1);
        }
      }
    } else {
      // thread (query, 16-byte chunk) outputs, the rows summed in order
      for (int e = tid; e < lanes * cpr; e += kThreads) {
        const int kq = e / cpr, ch = e - kq * cpr;
        float* o = red + kq * dh + ch * kVec;
        float acc[kVec];
#pragma unroll
        for (int x = 0; x < kVec; ++x) acc[x] = o[x];
        for (int r = 0; r < nr; ++r) {
          float vv[kVec];
          load_chunk(vbuf + r * ld + ch * kVec, vv);
          const float pr = pt[kq * stride + r];
#pragma unroll
          for (int x = 0; x < kVec; ++x) acc[x] = fmaf(pr, vv[x], acc[x]);
        }
#pragma unroll
        for (int x = 0; x < kVec; ++x) o[x] = acc[x];
      }
    }
    __syncthreads();
  }
  step(3);
  if (mma && one_tile) {
    // the warps' partials, summed in warp order below
#pragma unroll
    for (int m4 = 0; m4 < 4; ++m4)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kq = cq + (e & 1);
        if (kq < lanes)
          red[(warp * lanes + kq) * dh + m4 * 16 + gq + (e >> 1) * 8] =
              oacc[m4][e];
      }
    __syncthreads();
  } else if (mma) {
    // the second row half's sums into red, then the first half's added
    for (int h2 = 1; h2 >= 0; --h2) {
      if (half == h2) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt * 8 >= lanes) break;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kq = nt * 8 + cq + (e & 1);
            float* o = red + kq * dh + mt * 16 + gq + (e >> 1) * 8;
            if (kq < lanes) *o = h2 ? oacc[nt][e] : oacc[nt][e] + *o;
          }
        }
      }
      __syncthreads();
    }
  }
  // and the fresh row's share
  for (int e = tid; e < lanes * dh; e += kThreads) {
    const int kq = e / dh, d = e % dh;
    float tot = red[e];
    if (mma && one_tile)
      for (int w = 1; w < kWarps; ++w) tot += red[w * lanes * dh + e];
    if (fresh) {
      const float pc = round_to<TC>(expf(cur[kq] - joint[2 * kq]) /
                                    joint[2 * kq + 1]);
      tot = __fadd_rn(tot, __fmul_rn(pc, vn[kq * dh + d]));
    }
    out(kq, d, tot);
  }
  __syncthreads();
  step(4);
}

// shared-memory bytes of one block: the GEMV operand stage (which the
// warps' sums alias), or the attention scratch and its key and value
// stages (the plan's, through avsr_decoder_layer_config)
__host__ __device__ inline size_t smem_bytes(int n, int lanes, int dh,
                                             int s_dec, int s_enc, int wsize,
                                             int csize) {
  const size_t gemv = gemv_bytes(n, wsize);
  const int rows = lanes * s_dec > s_enc ? lanes * s_dec : s_enc;
  const size_t attn = attn_layout(lanes, dh, rows, csize).bytes;
  const size_t body = gemv > attn ? gemv : attn;
  return (body + 15) / 16 * 16;
}

// the global timer (ns) into this block's trace slot, where a trace is
// asked for
template <typename TW, typename TC>
__device__ __forceinline__ void mark(const Args<TW, TC>& a, int slot) {
  if (a.trace != nullptr && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    a.trace[blockIdx.x * (2 * kPhases + kSteps) + slot] = t;
  }
}

// GEMV i of the layer (QKV, out, q2, out2, W1, W2), built where a phase
// uses it (from the kernel's parameters, not held in registers across the
// phases); its counters follow those of the GEMVs before it (room for
// items of 8 rows)
template <typename TW, typename TC>
__device__ __forceinline__ Gemv<TW> gemv_of(const Args<TW, TC>& a, int i) {
  const int c = a.c, f = a.f;
  const TW* const ws[kGemvs] = {a.w_qkv, a.w_out, a.w_q2, a.w_out2, a.w_1,
                                a.w_2};
  const TW* const bs[kGemvs] = {a.b_qkv, a.b_out, a.b_q2, a.b_out2, a.b_1,
                                a.b_2};
  const int outs[kGemvs] = {3 * c, c, c, c, f, c};
  const int ins[kGemvs] = {c, c, c, c, c, f};
  int* cnt = a.counters;
#pragma unroll
  for (int j = 0; j < kGemvs; ++j)
    if (j < i) cnt += cdiv(outs[j], 8);
  return Gemv<TW>{ws[i],   bs[i],   outs[i],
                  ins[i],  a.rows[i], a.ks[i],
                  cdiv(ins[i], a.ks[i]), cnt};
}

// the LayerNorm statistics of the residual phases' row groups: LN2's (ln
// 1) and LN3's (ln 2), each (C / 8 at most, N, 2)
template <typename TW, typename TC>
__device__ __forceinline__ float* stats_of(const Args<TW, TC>& a, int ln) {
  return a.stats + (ln - 1) * 2 * a.n * cdiv(a.c, 8);
}

template <typename TW, typename TC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    decoder_layer_kernel(const Args<TW, TC> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int n = a.n, c = a.c, f = a.f, dh = a.dh, lanes = a.lanes;
  const int s_dec = a.s_dec, s_enc = a.s_enc;
  const int n_utt = n / lanes;
  const int c3 = 3 * c;
  const int kf = max(c, f);  // the operands' row stride
  const float scale = a.scale;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t gtid = static_cast<size_t>(blockIdx.x) * kThreads + tid;
  const size_t gstride = static_cast<size_t>(gridDim.x) * kThreads;
  const int pos = max(__ldg(a.step), 0);
  const int s_lim = min(pos, s_dec);  // the cache rows attended
  // attention scratch (attn_layout): q (lanes, dh), fresh k and v and
  // their scores, then attend's own
  float* smf = reinterpret_cast<float*>(smem);
  const AttnLayout lay =
      attn_layout(lanes, dh, max(lanes * s_dec, s_enc), sizeof(TC));
  float* qs = smf + lay.qs;
  float* kn = smf + lay.kn;
  float* vn = smf + lay.vn;
  float* cur = smf + lay.cur;
  // the steps of phase p, marked where p is the traced one
  auto steps = [&](int p) {
    return [&a, p](int k) {
      if (p == kTraceSub) mark(a, 2 * kPhases + k);
    };
  };
  // the GEMV operands: the LayerNorms' outputs, and the attention outputs
  // and FFN hidden rows
  auto from_lnop = [&](TW* act, int ld, int n0, int nn, int kb, int ke,
                       int w32) {
    copy_operand<TW>(act, ld, a.lnop, c, n0, nn, kb, ke, w32);
  };
  auto from_opnd = [&](TW* act, int ld, int n0, int nn, int kb, int ke,
                       int w32) {
    copy_operand<TW>(act, ld, a.opnd, kf, n0, nn, kb, ke, w32);
  };
  auto no_epi = [](int, int, float) {};  // the residual phases' own

  mark(a, 0);
  // 0. LN1 into the operand; the residual stream starts as x in fp32
  for (size_t e = gtid; e < static_cast<size_t>(n) * c; e += gstride)
    a.xres[e] = avsr::to_float(a.x[e]);
  normalize<TW, TW>(a.x, c, n, nullptr, 0, a.ln_w, a.ln_b, a.lnop);
  mark(a, 1);
  grid.sync();
  mark(a, 2);

  // 1. QKV
  gemv_phase<TW>(
      gemv_of(a, 0), n, a.part, smem, from_lnop,
      [&](int r, int o, float v) {
        a.qkv[static_cast<size_t>(r) * c3 + o] = v;
      },
      steps(1));
  mark(a, 3);
  grid.sync();
  mark(a, 4);

  // 2. self-attention, one block per (utterance, head): the cache rows
  // s < min(pos, S) (rows past pos carry -1e30 on every lane, the caller's
  // contract; the stale row at pos < S is masked) and the fresh row
  for (int item = blockIdx.x; item < n_utt * a.heads; item += gridDim.x) {
    const int b = item / a.heads, h = item % a.heads;
    const size_t lane0 = static_cast<size_t>(b) * lanes;
    for (int e = tid; e < lanes * dh; e += kThreads) {
      const int kq = e / dh, d = e % dh;
      const float* row = a.qkv + (lane0 + kq) * c3 + h * dh + d;
      qs[e] = round_to<TC>(round_to<TW>(__ldcg(row) * scale));
      kn[e] = round_to<TC>(__ldcg(row + c));
      vn[e] = round_to<TC>(__ldcg(row + 2 * c));
    }
    __syncthreads();
    for (int kq = warp; kq < lanes; kq += kWarps) {
      float part = 0.f;
      for (int d = lane; d < dh; d += 32)
        part = fmaf(kn[kq * dh + d], qs[kq * dh + d], part);
      part = avsr::warp_sum(part);
      if (lane == 0) cur[kq] = part;
    }
    __syncthreads();
    const int c2 = 2 * c;
    const Rows<TC> rw{a.kv + lane0 * s_dec * c2 + h * dh,
                      s_lim,
                      static_cast<size_t>(s_dec) * c2,
                      static_cast<size_t>(c2),
                      static_cast<ptrdiff_t>(c),
                      a.lane_bias + lane0 * s_dec * lanes,
                      static_cast<size_t>(s_dec) * lanes,
                      static_cast<size_t>(lanes),
                      1};
    attend<TC>(lanes, lanes * s_lim, dh, smf, lay, rw, true,
               [&](int kq, int d, float v) {
                 a.opnd[(lane0 + kq) * kf + h * dh + d] =
                     avsr::from_float<TW>(v);
               },
               steps(2));
  }
  mark(a, 5);
  grid.sync();
  mark(a, 6);

  // 3. out-projection + residual; LN2's statistics of each row group
  gemv_phase<TW>(gemv_of(a, 1), n, a.part, smem, from_opnd, no_epi,
                 steps(3), a.xres, c, stats_of(a, 1));
  mark(a, 7);
  grid.sync();
  mark(a, 8);

  // 4. LN2 into the operand
  normalize<TW, float>(a.xres, c, n, stats_of(a, 1), a.rows[1], a.ln_w + c,
                       a.ln_b + c, a.lnop);
  mark(a, 9);
  grid.sync();
  mark(a, 10);

  // 5. source-attention query, scaled by dh^-0.5
  gemv_phase<TW>(
      gemv_of(a, 2), n, a.part, smem, from_lnop,
      [&](int r, int o, float v) {
        a.q2[static_cast<size_t>(r) * c + o] = v * scale;
      },
      steps(5));
  mark(a, 11);
  grid.sync();
  mark(a, 12);

  // 6. cross-attention over the utterance's source rows
  for (int item = blockIdx.x; item < n_utt * a.heads; item += gridDim.x) {
    const int b = item / a.heads, h = item % a.heads;
    const size_t lane0 = static_cast<size_t>(b) * lanes;
    const size_t src0 = static_cast<size_t>(b) * s_enc;
    for (int e = tid; e < lanes * dh; e += kThreads) {
      const int kq = e / dh, d = e % dh;
      qs[e] = round_to<TC>(
          round_to<TW>(__ldcg(a.q2 + (lane0 + kq) * c + h * dh + d)));
    }
    __syncthreads();
    const Rows<TC> rw{a.src_k + src0 * c + h * dh,
                      s_enc,
                      0,
                      static_cast<size_t>(c),
                      a.src_v - a.src_k,
                      a.mem_bias + src0,
                      0,
                      1,
                      0};
    attend<TC>(lanes, s_enc, dh, smf, lay, rw, false,
               [&](int kq, int d, float v) {
                 a.opnd[(lane0 + kq) * kf + h * dh + d] =
                     avsr::from_float<TW>(v);
               },
               steps(6));
  }
  mark(a, 13);
  grid.sync();
  mark(a, 14);

  // 7. source out-projection + residual; LN3's statistics
  gemv_phase<TW>(gemv_of(a, 3), n, a.part, smem, from_opnd, no_epi,
                 steps(7), a.xres, c, stats_of(a, 2));
  mark(a, 15);
  grid.sync();
  mark(a, 16);

  // 8. LN3 into the operand
  normalize<TW, float>(a.xres, c, n, stats_of(a, 2), a.rows[3],
                       a.ln_w + 2 * c, a.ln_b + 2 * c, a.lnop);
  mark(a, 17);
  grid.sync();
  mark(a, 18);

  // 9. W1 + ReLU, rounded to the weight dtype (W2's operand)
  gemv_phase<TW>(
      gemv_of(a, 4), n, a.part, smem, from_lnop,
      [&](int r, int o, float v) {
        a.opnd[static_cast<size_t>(r) * kf + o] =
            avsr::from_float<TW>(fmaxf(v, 0.f));
      },
      steps(9));
  mark(a, 19);
  grid.sync();
  mark(a, 20);

  // 10. W2 + residual, the layer's output; the fresh K|V row (every block
  // finished reading the cache before the sync after phase 2)
  gemv_phase<TW>(
      gemv_of(a, 5), n, a.part, smem, from_opnd,
      [&](int r, int o, float v) {
        const size_t i = static_cast<size_t>(r) * c + o;
        a.out[i] = avsr::from_float<TW>(__fadd_rn(__ldcg(a.xres + i), v));
      },
      steps(10));
  const int row_c = min(pos, s_dec - 1);
  const int c2 = 2 * c;
  for (size_t e = gtid; e < static_cast<size_t>(n) * c2; e += gstride) {
    const size_t ln = e / c2, col = e % c2;
    a.kv[(ln * s_dec + row_c) * c2 + col] =
        avsr::from_float<TC>(__ldcg(a.qkv + ln * c3 + c + col));
  }
  mark(a, 2 * kPhases - 1);
}

// The grid of a cooperative launch: as many blocks as fit on the card at
// once. The occupancy query is made once per device and shared-memory size,
// and the kernel's shared-memory limit is only ever raised (it is one value
// per device, which launches of every size share), so neither is repeated
// at every launch (the beam launches the kernel thousands of times a
// batch).
template <typename K>
cudaError_t cooperative_grid(K kernel, size_t smem, int* grid) {
  struct Grid {
    int dev;
    size_t smem;
    int blocks;
  };
  struct Limit {
    int dev;
    size_t smem;
  };
  static std::mutex mu;
  static std::vector<Grid> known;
  static std::vector<Limit> limits;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (const Grid& e : known) {
    if (e.dev == dev && e.smem == smem) {
      *grid = e.blocks;
      return cudaSuccess;
    }
  }
  Limit* limit = nullptr;
  for (Limit& e : limits)
    if (e.dev == dev) limit = &e;
  if (limit == nullptr || limit->smem < smem) {
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             static_cast<int>(smem))) != cudaSuccess)
      return err;
    if (limit == nullptr)
      limits.push_back({dev, smem});
    else
      limit->smem = smem;
  }
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  known.push_back({dev, smem, sms * per_sm});
  *grid = sms * per_sm;
  return cudaSuccess;
}

template <typename TW, typename TC>
cudaError_t config_typed(const int* shape, int* out) {
  const int n = shape[0], lanes = shape[1], dh = shape[2], s_dec = shape[3],
            s_enc = shape[4];
  if (n <= 0 || lanes <= 0 || dh <= 0 || s_dec <= 0 || s_enc <= 0)
    return cudaErrorInvalidValue;
  const size_t smem =
      smem_bytes(n, lanes, dh, s_dec, s_enc, sizeof(TW), sizeof(TC));
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  out[0] = static_cast<int>(smem);
  out[2] = kMaxRows;
  return cooperative_grid(decoder_layer_kernel<TW, TC>, smem, out + 1);
}

template <typename TW, typename TC>
cudaError_t launch_typed(void* const* ptrs, const int* dims, float scale,
                         cudaStream_t stream) {
  Args<TW, TC> a;
  a.x = static_cast<const TW*>(ptrs[0]);
  a.kv = static_cast<TC*>(ptrs[1]);
  a.src_k = static_cast<const TC*>(ptrs[2]);
  a.src_v = static_cast<const TC*>(ptrs[3]);
  a.mem_bias = static_cast<const float*>(ptrs[4]);
  a.lane_bias = static_cast<const float*>(ptrs[5]);
  const TW** w[] = {&a.ln_w, &a.ln_b, &a.w_qkv, &a.b_qkv, &a.w_out,
                    &a.b_out, &a.w_q2, &a.b_q2, &a.w_out2, &a.b_out2,
                    &a.w_1, &a.b_1, &a.w_2, &a.b_2};
  for (int i = 0; i < 14; ++i) *w[i] = static_cast<const TW*>(ptrs[6 + i]);
  a.xres = static_cast<float*>(ptrs[20]);
  a.qkv = static_cast<float*>(ptrs[21]);
  a.q2 = static_cast<float*>(ptrs[22]);
  a.opnd = static_cast<TW*>(ptrs[23]);
  a.lnop = static_cast<TW*>(ptrs[24]);
  a.stats = static_cast<float*>(ptrs[25]);
  a.part = static_cast<float*>(ptrs[26]);
  a.counters = static_cast<int*>(ptrs[27]);
  a.out = static_cast<TW*>(ptrs[28]);
  a.trace = static_cast<unsigned long long*>(ptrs[29]);
  a.step = static_cast<const int*>(ptrs[30]);
  a.n = dims[0];
  a.lanes = dims[1];
  a.heads = dims[2];
  a.dh = dims[3];
  a.c = dims[4];
  a.f = dims[5];
  a.s_dec = dims[6];
  a.s_enc = dims[7];
  const int grid = dims[8];
  for (int i = 0; i < kGemvs; ++i) {
    a.rows[i] = dims[9 + i];
    a.ks[i] = dims[9 + kGemvs + i];
  }
  a.scale = scale;
  constexpr int kVec = 16 / sizeof(TC);
  const int cpr = a.dh / kVec;
  if (a.n <= 0 || a.lanes <= 0 || a.lanes > kMaxLanes || a.n % a.lanes ||
      a.heads * a.dh != a.c || a.c % 8 || a.f % 8 || a.dh % kVec ||
      cpr > 32 || (cpr & (cpr - 1)) || a.s_dec <= 0 || a.s_enc <= 0 ||
      a.step == nullptr)
    return cudaErrorInvalidValue;
  for (int i = 0; i < kGemvs; ++i) {
    if (a.ks[i] < 32 || a.ks[i] % 32 || a.rows[i] < 8 ||
        a.rows[i] > kMaxRows || a.rows[i] % 8)
      return cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(a.n, a.lanes, a.dh, a.s_dec, a.s_enc,
                                 sizeof(TW), sizeof(TC));
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  // the operands read with 16-byte loads: x, the cache, the source K/V,
  // the LayerNorm parameters, the weight matrices, the residual and the
  // operand scratch
  for (int i : {0, 1, 2, 3, 6, 7, 8, 10, 12, 14, 16, 18, 20, 23, 24})
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0)
      return cudaErrorMisalignedAddress;
  auto kernel = decoder_layer_kernel<TW, TC>;
  int most = 0;
  cudaError_t err = cooperative_grid(kernel, smem, &most);
  if (err != cudaSuccess) return err;
  if (grid < 1 || grid > most) return cudaErrorCooperativeLaunchTooLarge;
  // cudaLaunchKernelEx with the cooperative attribute, which a stream
  // capture records as a cooperative kernel node (the beam's device loop
  // replays it in a CUDA graph)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

}  // namespace

// The launch's layout, for the launch plan (ops/kernels/decoder_layer.py):
// shape = {n, lanes, dh, s_dec, s_enc}; out = {the dynamic shared memory of
// a block (bytes), the most blocks a cooperative launch holds with it (the
// grid), the most rows of a GEMV item}.
extern "C" int avsr_decoder_layer_config(int param_dtype, int cache_dtype,
                                         const int* shape, int* out) {
  using bf16 = __nv_bfloat16;
  cudaError_t err;
  if (param_dtype == avsr::kBFloat16 && cache_dtype == avsr::kBFloat16)
    err = config_typed<bf16, bf16>(shape, out);
  else if (param_dtype == avsr::kFloat32 && cache_dtype == avsr::kFloat32)
    err = config_typed<float, float>(shape, out);
  else if (param_dtype == avsr::kFloat32 && cache_dtype == avsr::kBFloat16)
    err = config_typed<float, bf16>(shape, out);
  else if (param_dtype == avsr::kBFloat16 && cache_dtype == avsr::kFloat32)
    err = config_typed<bf16, float>(shape, out);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// ptrs (host array of 31 device pointers): x, kv, src_k, src_v, mem_bias,
// lane_bias, the 14 packed parameters (ln_w, ln_b, w_qkv, b_qkv, w_out,
// b_out, w_q2, b_q2, w_out2, b_out2, w_1, b_1, w_2, b_2), then the scratch
// xres (N*C fp32), qkv (N*3C fp32), q2 (N*C fp32), opnd (N*max(C,F)) and
// lnop (N*C) in param_dtype, stats (fp32), part (fp32), counters (int32,
// zero), the output (N, C), and a trace (null, or int64 (grid, 2 * kPhases
// + kSteps): each block's global timer at the start and end of each phase,
// then at the steps of phase kTraceSub), and the step pos (one int32,
// which the kernel reads). dims: n, lanes, heads, dh, c, f,
// s_dec, s_enc, grid, then the rows of an item of the six GEMVs (QKV,
// out, q2, out2, W1, W2) and their K slices' columns; scale: dh^-0.5 in
// fp32. x, the parameters and the output are in param_dtype; kv, src_k and
// src_v in cache_dtype.
extern "C" int avsr_decoder_layer(void* const* ptrs, const int* dims,
                                  float scale, int param_dtype,
                                  int cache_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  cudaError_t err;
  if (param_dtype == avsr::kBFloat16 && cache_dtype == avsr::kBFloat16)
    err = launch_typed<bf16, bf16>(ptrs, dims, scale, s);
  else if (param_dtype == avsr::kFloat32 && cache_dtype == avsr::kFloat32)
    err = launch_typed<float, float>(ptrs, dims, scale, s);
  else if (param_dtype == avsr::kFloat32 && cache_dtype == avsr::kBFloat16)
    err = launch_typed<float, bf16>(ptrs, dims, scale, s);
  else if (param_dtype == avsr::kBFloat16 && cache_dtype == avsr::kFloat32)
    err = launch_typed<bf16, float>(ptrs, dims, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
