// One decoder layer's whole beam-search decode step in one cooperative
// launch: LN1 + QKV, self-attention over the lazy-reorder K|V cache with the
// step's fresh row, out-projection, LN2 + cross-attention over the shared
// source K/V, LN3 + ReLU FFN, and the K|V row write.
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
// the valid prefix of the K|V cache (up to ~19 MB at B*K=24, S=192) and the
// source K/V (~12 MB at S_enc=377): ~17 us at 3.35 TB/s. The products are
// GEMVs with N = B*K <= 32 rows, 2 N FLOPs a weight element, so the weights
// are streamed once with 16-byte loads and each element is used for all N
// rows (held in fp32 in shared memory), accumulating in fp32 registers.
//
// Structure: a grid of as many blocks as fit on the card at once, launched
// with cudaLaunchCooperativeKernel, eight phases separated by grid syncs:
//   1 LN1 + QKV          GEMV rows over the blocks; LN recomputed per block
//   2 self-attention     one block per (utterance, head)
//   3 out-proj + resid   GEMV
//   4 LN2 + q2           GEMV
//   5 cross-attention    one block per (utterance, head)
//   6 out2 + resid       GEMV
//   7 LN3 + W1 + ReLU    GEMV
//   8 W2 + resid, cast; the K|V row write
// Intermediates (the fp32 residual, QKV, q2, the GEMV operands) live in
// global scratch given by the caller; a phase's outputs are visible to the
// next after the grid sync.
#include <cooperative_groups.h>
#include <stdint.h>

#include <mutex>
#include <vector>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 32;  // N = B*K lanes held in GEMV registers
constexpr int kMaxLanes = 8;  // beam lanes K of one utterance
constexpr int kLnPerLane = 32;  // LayerNorm width <= 32 * 32 = 1024
constexpr unsigned kFull = 0xffffffffu;

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
  float* act;           // (N, max(C, F)) GEMV operands, rounded to TW
  TW* out;              // (N, C)
  int n, lanes, heads, dh, c, f, s_dec, s_enc, pos;
  float scale;  // dh^-0.5 rounded to fp32
};

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return avsr::to_float(avsr::from_float<T>(x));
}

// 8 consecutive elements at p (16-byte aligned) as floats
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(e[i]);
}
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
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

// tile[r][k] = round_TW(LN(src[r]) * g + b) for the n rows of width c
// (c <= 32 * kLnPerLane), one warp a row; the row is loaded into registers
// once, all its loads in flight together (the TPU kernel's _layer_norm:
// mean, centred variance, eps 1e-12, fp32)
template <typename TW, typename TS>
__device__ void ln_tile(const TS* __restrict__ src, const TW* __restrict__ g,
                        const TW* __restrict__ b, int n, int c, float* tile) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < n; r += kWarps) {
    const TS* row = src + static_cast<size_t>(r) * c;
    float v[kLnPerLane];
#pragma unroll
    for (int i = 0; i < kLnPerLane; ++i) {
      const int k = lane + 32 * i;
      v[i] = k < c ? avsr::to_float(row[k]) : 0.f;
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kLnPerLane; ++i) s += v[i];
    const float mean = avsr::warp_sum(s) / c;
    float var = 0.f;
#pragma unroll
    for (int i = 0; i < kLnPerLane; ++i) {
      if (lane + 32 * i < c) {
        const float d = __fsub_rn(v[i], mean);
        var = fmaf(d, d, var);
      }
    }
    const float rs = rsqrtf(avsr::warp_sum(var) / c + 1e-12f);
#pragma unroll
    for (int i = 0; i < kLnPerLane; ++i) {
      const int k = lane + 32 * i;
      if (k < c) {
        const float y = __fadd_rn(
            __fmul_rn(__fmul_rn(__fsub_rn(v[i], mean), rs),
                      avsr::to_float(g[k])),
            avsr::to_float(b[k]));
        tile[r * c + k] = round_to<TW>(y);
      }
    }
  }
  __syncthreads();
}

// out[r][o] = sum_k tile[r][k] w[o][k] + bias[o] for the n rows, each output
// row o owned by one warp, store(r, o, value). The operand is read from
// `src` (n rows of stride src_ld, fp32) in chunks of the tile's width
// tile_w, or, with src == nullptr, is already the whole tile (in_dim <=
// tile_w). The rows a block owns depend on the block alone, so every warp
// of a block passes the same __syncthreads.
template <typename TW, typename Store>
__device__ void gemv(const TW* __restrict__ w, const TW* __restrict__ bias,
                     int out_dim, int in_dim, int n, float* tile, int tile_w,
                     const float* src, int src_ld, Store store) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int row0 = blockIdx.x * kWarps; row0 < out_dim;
       row0 += gridDim.x * kWarps) {
    const int row = row0 + warp;
    float acc[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) acc[r] = 0.f;
    for (int k0 = 0; k0 < in_dim; k0 += tile_w) {
      const int width = min(tile_w, in_dim - k0);
      if (src != nullptr) {
        // 16-byte copies, several in flight per thread (width % 8 == 0)
        const int w4 = width / 4;
        __syncthreads();
#pragma unroll 4
        for (int e = threadIdx.x; e < n * w4; e += kThreads) {
          const int r = e / w4, k4 = e - r * w4;
          reinterpret_cast<float4*>(tile + r * width)[k4] =
              *reinterpret_cast<const float4*>(
                  src + static_cast<size_t>(r) * src_ld + k0 + 4 * k4);
        }
        __syncthreads();
      }
      if (row >= out_dim) continue;
      const TW* wrow = w + static_cast<size_t>(row) * in_dim + k0;
#pragma unroll 4
      for (int k = lane * 8; k < width; k += 32 * 8) {
        float wv[8];
        load8(wrow + k, wv);
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          if (r < n) {
            float xv[8];
            load8(tile + r * width + k, xv);
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[r] = fmaf(xv[i], wv[i], acc[r]);
          }
        }
      }
    }
    if (row >= out_dim) continue;
    // lane r keeps row r's sum, then all lanes store at once (one memory
    // round trip for the read-modify-write stores, not n)
    float mine = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r < n) {
        const float s = avsr::warp_sum(acc[r]);
        if (lane == r) mine = s;
      }
    }
    if (lane < n)
      store(lane, row, __fadd_rn(mine, avsr::to_float(bias[row])));
  }
}

// Attention of `lanes` queries qs (lanes, dh) over `rows` stored rows of one
// (utterance, head): scores = q . key(r) + bias(kq, r), plus, with `fresh`,
// one more score cur[kq] and value vn[kq] per query (its own fresh row).
// Softmax in fp32, denominator clamped at 1e-30, probabilities rounded to
// TC; out(kq, d, value). Shared memory: sc (lanes * rows), red (kWarps *
// lanes * dh).
template <typename TC, typename KeyRow, typename ValRow, typename Bias,
          typename Out>
__device__ void attend(int lanes, int rows, int dh, const float* qs,
                       KeyRow key_row, ValRow val_row, Bias bias, bool fresh,
                       const float* cur, const float* vn, float* sc,
                       float* red, Out out) {
  constexpr int kVec = 16 / sizeof(TC);
  const int tid = threadIdx.x, warp = tid / 32, lane_id = tid % 32;
  const int cpr = dh / kVec;          // threads per row, a power of two
  const int groups = kThreads / cpr;  // rows in flight
  const int chunk = tid % cpr, grp = tid / cpr;
#pragma unroll 2
  for (int r0 = 0; r0 < rows; r0 += groups) {
    const int r = r0 + grp;
    const bool ok = r < rows;
    float kv[kVec];
    if (ok) {
      load_chunk(key_row(r) + chunk * kVec, kv);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) kv[e] = 0.f;
    }
#pragma unroll
    for (int kq = 0; kq < kMaxLanes; ++kq) {
      if (kq < lanes) {
        const float* qrow = qs + kq * dh + chunk * kVec;
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) part = fmaf(qrow[e], kv[e], part);
        for (int off = 1; off < cpr; off <<= 1)
          part += __shfl_xor_sync(kFull, part, off);
        if (ok && chunk == 0) sc[kq * rows + r] = __fadd_rn(part, bias(kq, r));
      }
    }
  }
  __syncthreads();
  __shared__ float pcur[kMaxLanes];
  for (int kq = warp; kq < lanes; kq += kWarps) {
    float* srow = sc + kq * rows;
    float mx = fresh ? cur[kq] : -INFINITY;
    for (int e = lane_id; e < rows; e += 32) mx = fmaxf(mx, srow[e]);
    mx = avsr::warp_max(mx);
    float sum = 0.f;
    for (int e = lane_id; e < rows; e += 32) {
      const float p = expf(srow[e] - mx);
      srow[e] = p;
      sum += p;
    }
    sum = avsr::warp_sum(sum);
    const float pc = fresh ? expf(cur[kq] - mx) : 0.f;
    const float den = fmaxf(sum + pc, 1e-30f);
    for (int e = lane_id; e < rows; e += 32)
      srow[e] = round_to<TC>(srow[e] / den);
    if (lane_id == 0) pcur[kq] = round_to<TC>(pc / den);
  }
  __syncthreads();
  float acc[kMaxLanes][kVec];
#pragma unroll
  for (int kq = 0; kq < kMaxLanes; ++kq)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[kq][e] = 0.f;
#pragma unroll 2
  for (int r = grp; r < rows; r += groups) {
    float vv[kVec];
    load_chunk(val_row(r) + chunk * kVec, vv);
#pragma unroll
    for (int kq = 0; kq < kMaxLanes; ++kq) {
      if (kq < lanes) {
        const float p = sc[kq * rows + r];
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[kq][e] = fmaf(p, vv[e], acc[kq][e]);
      }
    }
  }
  // the row groups of a warp (lanes that share a chunk), then the warps
#pragma unroll
  for (int kq = 0; kq < kMaxLanes; ++kq) {
    if (kq < lanes) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        for (int off = cpr; off < 32; off <<= 1)
          acc[kq][e] += __shfl_xor_sync(kFull, acc[kq][e], off);
        if (lane_id < cpr)
          red[(warp * lanes + kq) * dh + chunk * kVec + e] = acc[kq][e];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < lanes * dh; e += kThreads) {
    const int kq = e / dh, d = e % dh;
    float tot = 0.f;
    for (int w = 0; w < kWarps; ++w) tot += red[(w * lanes + kq) * dh + d];
    if (fresh) tot = __fadd_rn(tot, __fmul_rn(pcur[kq], vn[kq * dh + d]));
    out(kq, d, tot);
  }
  __syncthreads();
}

template <typename TW, typename TC>
__global__ void __launch_bounds__(kThreads)
    decoder_layer_kernel(const Args<TW, TC> a) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int n = a.n, c = a.c, f = a.f, dh = a.dh, lanes = a.lanes;
  const int s_dec = a.s_dec, s_enc = a.s_enc;
  const int n_utt = n / lanes;
  const int c3 = 3 * c;
  const float scale = a.scale;
  const int tid = threadIdx.x;
  const size_t gtid = static_cast<size_t>(blockIdx.x) * kThreads + tid;
  const size_t gstride = static_cast<size_t>(gridDim.x) * kThreads;
  const bool gemv_c = blockIdx.x * kWarps < c;  // the block owns C rows
  // attention scratch: q (lanes, dh), fresh k and v, scores, P.V partials
  float* qs = smem;
  float* kn = qs + kMaxLanes * dh;
  float* vn = kn + kMaxLanes * dh;
  float* cur = vn + kMaxLanes * dh;
  float* red = cur + kMaxLanes;
  float* sc = red + kWarps * kMaxLanes * dh;

  // 1. LN1 + QKV; the residual stream starts as x in fp32
  for (size_t e = gtid; e < static_cast<size_t>(n) * c; e += gstride)
    a.xres[e] = avsr::to_float(a.x[e]);
  if (blockIdx.x * kWarps < c3) {
    ln_tile<TW>(a.x, a.ln_w, a.ln_b, n, c, smem);
    gemv<TW>(a.w_qkv, a.b_qkv, c3, c, n, smem, c, nullptr, 0,
             [&](int r, int o, float v) { a.qkv[r * c3 + o] = v; });
  }
  grid.sync();

  // 2. self-attention, one block per (utterance, head): the cache rows
  // s < min(pos, S) (rows past pos carry -1e30 on every lane, the caller's
  // contract; the stale row at pos < S is masked) and the fresh row
  const int s_lim = min(a.pos, s_dec);
  for (int item = blockIdx.x; item < n_utt * a.heads; item += gridDim.x) {
    const int b = item / a.heads, h = item % a.heads;
    const size_t lane0 = static_cast<size_t>(b) * lanes;
    for (int e = tid; e < lanes * dh; e += kThreads) {
      const int kq = e / dh, d = e % dh;
      const float* row = a.qkv + (lane0 + kq) * c3 + h * dh + d;
      qs[e] = round_to<TC>(round_to<TW>(row[0] * scale));
      kn[e] = round_to<TC>(row[c]);
      vn[e] = round_to<TC>(row[2 * c]);
    }
    __syncthreads();
    for (int kq = tid / 32; kq < lanes; kq += kWarps) {
      float part = 0.f;
      for (int d = tid % 32; d < dh; d += 32)
        part = fmaf(kn[kq * dh + d], qs[kq * dh + d], part);
      part = avsr::warp_sum(part);
      if (tid % 32 == 0) cur[kq] = part;
    }
    __syncthreads();
    const int c2 = 2 * c;
    attend<TC>(
        lanes, lanes * s_lim, dh, qs,
        [&](int r) {
          return a.kv + ((lane0 + r / s_lim) * s_dec + r % s_lim) * c2 + h * dh;
        },
        [&](int r) {
          return a.kv + ((lane0 + r / s_lim) * s_dec + r % s_lim) * c2 + c +
                 h * dh;
        },
        [&](int kq, int r) {
          return a.lane_bias[((lane0 + kq) * s_dec + r % s_lim) * lanes +
                             r / s_lim];
        },
        true, cur, vn, sc, red,
        [&](int kq, int d, float v) {
          a.act[(lane0 + kq) * c + h * dh + d] = round_to<TW>(v);
        });
  }
  grid.sync();

  // 3. out-projection + residual
  if (gemv_c)
    gemv<TW>(a.w_out, a.b_out, c, c, n, smem, c, a.act, c,
             [&](int r, int o, float v) { a.xres[r * c + o] += v; });
  grid.sync();

  // 4. LN2 + source-attention query, scaled by dh^-0.5
  if (gemv_c) {
    ln_tile<TW>(a.xres, a.ln_w + c, a.ln_b + c, n, c, smem);
    gemv<TW>(a.w_q2, a.b_q2, c, c, n, smem, c, nullptr, 0,
             [&](int r, int o, float v) { a.q2[r * c + o] = v * scale; });
  }
  grid.sync();

  // 5. cross-attention over the utterance's source rows
  for (int item = blockIdx.x; item < n_utt * a.heads; item += gridDim.x) {
    const int b = item / a.heads, h = item % a.heads;
    const size_t lane0 = static_cast<size_t>(b) * lanes;
    const size_t src0 = static_cast<size_t>(b) * s_enc;
    for (int e = tid; e < lanes * dh; e += kThreads) {
      const int kq = e / dh, d = e % dh;
      qs[e] = round_to<TC>(round_to<TW>(a.q2[(lane0 + kq) * c + h * dh + d]));
    }
    __syncthreads();
    attend<TC>(
        lanes, s_enc, dh, qs,
        [&](int r) { return a.src_k + (src0 + r) * c + h * dh; },
        [&](int r) { return a.src_v + (src0 + r) * c + h * dh; },
        [&](int, int r) { return a.mem_bias[src0 + r]; }, false, cur, vn,
        sc, red,
        [&](int kq, int d, float v) {
          a.act[(lane0 + kq) * c + h * dh + d] = round_to<TW>(v);
        });
  }
  grid.sync();

  // 6. source out-projection + residual
  if (gemv_c)
    gemv<TW>(a.w_out2, a.b_out2, c, c, n, smem, c, a.act, c,
             [&](int r, int o, float v) { a.xres[r * c + o] += v; });
  grid.sync();

  // 7. LN3 + W1 + ReLU, rounded to the weight dtype (W2's operand)
  if (blockIdx.x * kWarps < f) {
    ln_tile<TW>(a.xres, a.ln_w + 2 * c, a.ln_b + 2 * c, n, c, smem);
    gemv<TW>(a.w_1, a.b_1, f, c, n, smem, c, nullptr, 0,
             [&](int r, int o, float v) {
               a.act[r * f + o] = round_to<TW>(fmaxf(v, 0.f));
             });
  }
  grid.sync();

  // 8. W2 + residual, the layer's output; the fresh K|V row (every block
  // finished reading the cache before the sync after phase 2)
  if (gemv_c)
    gemv<TW>(a.w_2, a.b_2, c, f, n, smem, c, a.act, f,
             [&](int r, int o, float v) {
               a.out[r * c + o] =
                   avsr::from_float<TW>(__fadd_rn(a.xres[r * c + o], v));
             });
  const int row_c = min(a.pos, s_dec - 1);
  const int c2 = 2 * c;
  for (size_t e = gtid; e < static_cast<size_t>(n) * c2; e += gstride) {
    const size_t lane = e / c2, col = e % c2;
    a.kv[(lane * s_dec + row_c) * c2 + col] =
        avsr::from_float<TC>(a.qkv[lane * c3 + c + col]);
  }
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
  a.act = static_cast<float*>(ptrs[23]);
  a.out = static_cast<TW*>(ptrs[24]);
  a.n = dims[0];
  a.lanes = dims[1];
  a.heads = dims[2];
  a.dh = dims[3];
  a.c = dims[4];
  a.f = dims[5];
  a.s_dec = dims[6];
  a.s_enc = dims[7];
  a.pos = dims[8];
  a.scale = scale;
  constexpr int kVec = 16 / sizeof(TC);
  const int cpr = a.dh / kVec;
  if (a.n <= 0 || a.n > kMaxRows || a.lanes <= 0 || a.lanes > kMaxLanes ||
      a.n % a.lanes || a.heads * a.dh != a.c || a.c % 8 || a.f % 8 ||
      a.dh % kVec || cpr > 32 || (cpr & (cpr - 1)) || a.s_dec <= 0 ||
      a.s_enc <= 0 || a.pos < 0 || a.c > 32 * kLnPerLane)
    return cudaErrorInvalidValue;
  // the operands read with 16-byte loads: the cache, the source K/V and
  // the weight matrices
  for (int i : {1, 2, 3, 8, 10, 12, 14, 16, 18})
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0)
      return cudaErrorMisalignedAddress;
  const size_t attn = 3 * kMaxLanes * a.dh + kMaxLanes +
                      kWarps * kMaxLanes * a.dh +
                      static_cast<size_t>(a.lanes) *
                          max(a.lanes * a.s_dec, a.s_enc);
  const size_t smem =
      sizeof(float) * max(static_cast<size_t>(a.n) * a.c, attn);
  auto kernel = decoder_layer_kernel<TW, TC>;
  int grid = 0;
  cudaError_t err = cooperative_grid(kernel, smem, &grid);
  if (err != cudaSuccess) return err;
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                     dim3(grid), dim3(kThreads), args, smem,
                                     stream);
}

}  // namespace

// ptrs (host array of 25 device pointers): x, kv, src_k, src_v, mem_bias,
// lane_bias, the 14 packed parameters (ln_w, ln_b, w_qkv, b_qkv, w_out,
// b_out, w_q2, b_q2, w_out2, b_out2, w_1, b_1, w_2, b_2), then the fp32
// scratch xres (N*C), qkv (N*3C), q2 (N*C), act (N*max(C,F)) and the output
// (N, C). dims: n, lanes,
// heads, dh, c, f, s_dec, s_enc, pos; scale: dh^-0.5 in fp32. x, the
// parameters and the output are in param_dtype; kv, src_k and src_v in
// cache_dtype.
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
