// One beam-search decode step of the decoder's self-attention, with the
// step's K|V row written into the cache by the kernel itself.
//
// Replaces the Pallas TPU kernels avsr_tpu/ops/pallas/decode_attention.py
// `_kernel_resident` (v3, the default) and `_kernel` (v2 grid): for every
// utterance b, lane k and head h, attend query q[b,k,h] over all J stored
// lanes and S positions of the fused (N = B*K, S, 2C) K|V cache, with beam
// ancestry resolved by the additive lane_bias[b,k,s,j] (lazy reorder: the
// cache is never reshuffled), one joint softmax over (j, s).
//
// What bounds it on the card: the bytes of the cache's valid prefix, read
// cold. Each step moves B*K*(pos+1) rows of 2C cache elements (19 MB a
// layer at B=8, K=3, S=192, C=1024 in bf16, 5.7 us at 3.35 TB/s; the six
// layers' caches, 113 MB, do not stay in the 50 MB L2) for ~2 FLOP an
// element. At B=8 there are only B*H = 128 (utterance, head) pairs: one
// block a pair leaves the SMs few loads in flight, and the time is the
// loads' latency, not the card's rate.
//
// Design: the rows of one (b, h) are split over a thread-block cluster of G
// blocks (grid (H*G, B), cluster (G, 1, 1), launched with cudaLaunchKernelEx
// so that G is chosen at run time by the caller's launch plan: G=2 at B=8
// and B=32, the fastest measured). Rank r takes a contiguous chunk of the
// prefix's rows = K*(pos_c+1) (j, s) rows, pos_c = min(pos, S-1). It
// issues all of its chunk's loads up front with cp.async, the bias rows
// 4 bytes and the K and V rows 16 bytes a copy, into two stage buffers
// (tiles of `tile` rows, double-buffered when the chunk is larger), so V's
// copies overlap the scores and the softmax, and the card keeps the whole
// prefix in flight. The copies step through (j, s) by additions, not two
// integer divisions each, and no copy waits on a load's result. Row
// pos_c is never read from the cache: every rank copies it from kv_row,
// and the rank whose chunk holds (j, pos_c) writes it into the cache from
// its shared-memory copy, so no block reads a row another is writing.
//
// The TPU kernel's rounding points survive the split. q is rounded to the
// cache dtype before q.k. Each rank publishes, per query, its local (max
// m_r, sum l_r of exp(s - m_r)) in shared memory; after cluster.sync()
// every rank combines all G pairs through distributed shared memory in
// rank order with the (max, shifted sum) monoid and its -3e38 guard (a
// rank with no row contributes (-inf, 0)), so every rank derives the same
// m and den. Then p = round_to_cache_dtype(exp(s - m) / max(den, 1e-30)),
// the partial P.V in fp32, and the G partial outputs are summed through
// distributed shared memory in rank order: deterministic.
//
// Products: with a bf16 cache and dh = 64 (the model's heads) q.k and P.V
// run on the tensor cores, mma.sync m16n8k16 with the lanes' (<= 8)
// queries as the 8-wide operand: S (16 rows x 8 queries) = K q^T from
// ldmatrix rows, out^T (dh x 8) = V^T P^T from transposed ldmatrix, P
// exact in bf16 since it is rounded already. Otherwise (fp32 caches, other
// head widths) a row's Dh slice is read by gw (the next power of two >=
// its 16-byte chunks) adjacent threads, each holding its chunk of all K
// queries in registers; a shuffle over the gw threads sums a score.
//
// The numbered phase comments of the kernel are where the variants tool
// (tools/decode_variants.py) cuts a copy of it short, to time the phases
// apart.
//
// More than kMaxLanes lanes (beams of 9 and more): decode_attention_wide_
// kernel, one block of kWideThreads a (head, query lane, utterance), with
// the same rounding points and row write. Its warps take the prefix's
// (j, s) rows in turn (the row pos_c from kv_row), a 16-byte chunk a lane
// and shuffles the sum, into fp32 scores in shared memory; block-wide max
// and sum give p = round_to_cache_dtype(exp(s - m) / max(den, 1e-30));
// the P.V splits the rows into groups of a thread a chunk, whose partials
// add in group order. The block writes its (lane, head) slice of the step's row
// into the cache; no block reads that row from the cache. Each query lane
// reads the whole prefix, so the cache is read K times over (from L2
// where it fits): simple and right; sharing the reads between the lanes
// is later work.
#include <cooperative_groups.h>
#include <stdint.h>

#include <mutex>
#include <vector>

#include "common.cuh"
#include "mma_bf16.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLanes = 8;
constexpr int kMaxCluster = 8;
constexpr int kMmaDh = 64;  // the head width whose bf16 products use mma
constexpr int kMaxSmem = 232448;  // 227 KB, the opt-in limit of a block
constexpr unsigned kFull = 0xffffffffu;

using avsr::combine_lse;
using avsr::cp_async16;
using avsr::cp_async4;
using avsr::cp_async_commit;
using avsr::cp_async_wait;

// the 16 bytes at p as floats
template <typename TC>
__device__ __forceinline__ void load_chunk(const TC* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const TC* e = reinterpret_cast<const TC*>(&raw);
#pragma unroll
  for (int i = 0; i < static_cast<int>(16 / sizeof(TC)); ++i)
    out[i] = avsr::to_float(e[i]);
}

// shared-memory bytes of one block (two stage buffers of tile rows rounded
// up to 16, each row dh elements and a 16-byte pad; the scores; the local
// and joint (m, l); the warps' and the rank's partial outputs); the launch
// plan computes the same
__host__ __device__ inline size_t smem_bytes(int lanes, int dh, int esize,
                                             int rows_per_rank, int tile) {
  return 2 * static_cast<size_t>((tile + 15) & ~15) * (dh * esize + 16) +
         sizeof(float) * (static_cast<size_t>(lanes) * rows_per_rank +
                          4 * static_cast<size_t>(lanes) +
                          static_cast<size_t>(kWarps + 1) * lanes * dh);
}

// kLanes >= lanes sizes the SIMT path's per-thread arrays at compile time.
// kMma: a bf16 cache with dh = kMmaDh, whose q.k and P.V run on the tensor
// cores (mma.sync m16n8k16, the lanes' queries as the 8-wide operand).
template <typename TQ, typename TC, int kLanes, bool kMma>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const TQ* __restrict__ q, TC* cache,
                            const float* __restrict__ lane_bias,
                            const TC* __restrict__ kv_row, TQ* __restrict__ out,
                            int lanes, int heads, int dh, int s_max, int pos,
                            int rows_per_rank, int tile) {
  constexpr int kVec = 16 / sizeof(TC);  // elements per 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int g = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.x / g;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane_id = tid % 32;
  const int c_dim = heads * dh;
  const int c2 = 2 * c_dim;
  const int pos_c = min(pos, s_max - 1);
  const int s_lim = pos_c + 1;
  const int rows = lanes * s_lim;
  const int r_begin = min(rank * rows_per_rank, rows);
  const int my_rows = min(r_begin + rows_per_rank, rows) - r_begin;
  const int n_tiles = (my_rows + tile - 1) / tile;
  const int ld = dh + kVec;  // a stage row: dh elements and a 16-byte pad
  const int tile_rows = (tile + 15) & ~15;
  const int cpr = dh / kVec;  // 16-byte chunks a row
  // threads a row: gw = 2^lg >= cpr, <= 32; shifts, not divisions, place
  // a thread, and (j, s) steps along without dividing
  const int lg = cpr <= 1 ? 0 : 32 - __clz(cpr - 1);
  const int gw = 1 << lg;
  const int rows_per_pass = kThreads >> lg;
  const int chunk = tid & (gw - 1);  // threads with chunk >= cpr idle
  const int grp = tid >> lg;
  const bool has_chunk = chunk < cpr;
  const size_t lane0 = static_cast<size_t>(b) * lanes;
  // mma fragment coordinates: row (or query) gq, column pair cq
  const int gq = lane_id >> 2;
  const int cq = 2 * (lane_id & 3);

  TC* stage = reinterpret_cast<TC*>(smem_raw);  // 2 x (tile_rows, ld)
  float* sc = reinterpret_cast<float*>(
      stage + 2 * static_cast<size_t>(tile_rows) * ld);
  float* stat = sc + lanes * rows_per_rank;  // (2, lanes): local m, l
  float* joint = stat + 2 * lanes;           // (2, lanes): joint m, den
  float* red = joint + 2 * lanes;            // (kWarps, lanes, dh)
  float* part = red + kWarps * lanes * dh;   // (lanes, dh): this rank's P.V

  // 1. the queries, rounded to the cache dtype, in registers: on the mma
  // path the B fragments of q^T (query gq, dims cq, cq+1 and cq+8, cq+9 of
  // each 16), else this thread's chunk of every query. Their loads go out
  // before the copies queue behind them.
  constexpr int kQk = kMma ? kMmaDh / 16 : 1;
  uint32_t qb[kQk][2];
  float qr[kMma ? 1 : kLanes][kVec];
  if constexpr (kMma) {
#pragma unroll
    for (int kk = 0; kk < kQk; ++kk)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float q0 = 0.f, q1 = 0.f;
        if (gq < lanes) {
          const TQ* qp = q + (lane0 + gq) * c_dim + h * kMmaDh + kk * 16 +
                         hf * 8 + cq;
          q0 = avsr::to_float(qp[0]);
          q1 = avsr::to_float(qp[1]);
        }
        qb[kk][hf] = avsr::mma::pack_bf16(q0, q1);
      }
  } else {
#pragma unroll
    for (int kq = 0; kq < kLanes; ++kq)
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        float v = 0.f;
        if (kq < lanes && has_chunk)
          v = avsr::to_float(avsr::from_float<TC>(avsr::to_float(
              q[(lane0 + kq) * c_dim + h * dh + chunk * kVec + e])));
        qr[kq][e] = v;
      }
  }

  // 2. copies into shared memory: the ancestry bias of the chunk's rows
  // into the scores (with load 0), then load i of the chunk (K tiles
  // 0..n_tiles-1, then V tiles) into stage buffer i % 2, zeros up to a
  // multiple of 16 rows; one commit group a load, empty past the last.
  // Row pos_c comes from kv_row.
  {
    int j = (r_begin + tid) / s_lim;
    int s = (r_begin + tid) % s_lim;
    for (int lr = tid; lr < my_rows; lr += kThreads) {
      for (int kq = 0; kq < lanes; ++kq)
        cp_async4(sc + kq * rows_per_rank + lr,
                  lane_bias + ((lane0 + kq) * s_max + s) * lanes + j);
      for (s += kThreads; s >= s_lim; s -= s_lim) ++j;
    }
  }
  auto issue = [&](int i) {
    if (i < 2 * n_tiles && has_chunk) {
      const int half = i / n_tiles;  // 0: K, 1: V
      const int base = (i % n_tiles) * tile;
      const int n = min(tile, my_rows - base);
      TC* buf = stage + static_cast<size_t>(i % 2) * tile_rows * ld;
      const int col = half * c_dim + h * dh + chunk * kVec;
      int j = (r_begin + base + grp) / s_lim;
      int s = (r_begin + base + grp) % s_lim;
      const int n16 = (n + 15) & ~15;
      for (int lr = grp; lr < n16; lr += rows_per_pass) {
        const bool ok = lr < n;
        const size_t lane = lane0 + j;
        const TC* src = !ok         ? cache
                        : s == pos_c ? kv_row + lane * c2 + col
                                     : cache + (lane * s_max + s) * c2 + col;
        cp_async16(buf + lr * ld + chunk * kVec, src, ok);
        for (s += rows_per_pass; s >= s_lim; s -= s_lim) ++j;
      }
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);

  // the cache's row pos_c of each lane j whose (j, pos_c) lies in the tile
  // just landed in buf: its K or V half of this head, from shared memory
  auto write_row = [&](const TC* buf, int base, int n, int half) {
    for (int e = tid; e < lanes * cpr; e += kThreads) {
      const int j = e / cpr;
      const int lr = j * s_lim + pos_c - r_begin - base;
      if (lr < 0 || lr >= n) continue;
      const int ch = e % cpr;
      *reinterpret_cast<uint4*>(
          cache + ((lane0 + j) * s_max + pos_c) * c2 + half * c_dim +
          h * dh + ch * kVec) =
          *reinterpret_cast<const uint4*>(buf + lr * ld + ch * kVec);
    }
  };

  // 3. scores of the chunk's rows, added to their bias
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<1>();
    __syncthreads();
    const TC* buf = stage + static_cast<size_t>(i % 2) * tile_rows * ld;
    const int base = i * tile;
    const int n = min(tile, my_rows - base);
    write_row(buf, base, n, 0);
    if constexpr (kMma) {
      // a warp's 16 rows at a time: S (16 rows x 8 queries) = K q^T
      for (int t = warp * 16; t < n; t += kWarps * 16) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < kQk; ++kk) {
          uint32_t a[4];
          avsr::mma::load_a<kMmaDh>(
              a, reinterpret_cast<const __nv_bfloat16*>(buf) + t * ld, kk,
              lane_id);
          avsr::mma::mma16816(acc, a, qb[kk][0], qb[kk][1]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = t + gq + (e >> 1) * 8;
          const int kq = cq + (e & 1);
          if (kq < lanes && row < n)
            sc[kq * rows_per_rank + base + row] += acc[e];
        }
      }
    } else {
      // gw threads a row, a shuffle sums their chunks; the pass count is
      // uniform over the block, so every lane reaches the shuffles
      for (int r0 = 0; r0 < n; r0 += rows_per_pass) {
        const int lr = r0 + grp;
        float kv[kVec];
        if (lr < n && has_chunk) {
          load_chunk(buf + lr * ld + chunk * kVec, kv);
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) kv[e] = 0.f;
        }
#pragma unroll
        for (int kq = 0; kq < kLanes; ++kq) {
          if (kq < lanes) {
            float acc = 0.f;
#pragma unroll
            for (int e = 0; e < kVec; ++e) acc = fmaf(qr[kq][e], kv[e], acc);
            for (int off = 1; off < gw; off <<= 1)
              acc += __shfl_xor_sync(kFull, acc, off);
            if (lr < n && chunk == 0)
              sc[kq * rows_per_rank + base + lr] += acc;
          }
        }
      }
    }
    __syncthreads();
    issue(i + 2);
  }

  // 4. the joint softmax's statistics: local (m, l) per query, combined
  // over the cluster's ranks in rank order
  for (int kq = warp; kq < lanes; kq += kWarps) {
    const float* srow = sc + kq * rows_per_rank;
    float mx = -INFINITY;
    for (int e = lane_id; e < my_rows; e += 32) mx = fmaxf(mx, srow[e]);
    mx = avsr::warp_max(mx);
    const float safe = fmaxf(mx, -3.0e38f);
    float sum = 0.f;
    for (int e = lane_id; e < my_rows; e += 32) sum += expf(srow[e] - safe);
    sum = avsr::warp_sum(sum);
    if (lane_id == 0) {
      stat[kq] = mx;
      stat[lanes + kq] = sum;
    }
  }
  cluster.sync();
  if (tid < lanes) {
    float ms[kMaxCluster], ls[kMaxCluster];  // all loads in flight at once
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < g) {
        const float* rs = cluster.map_shared_rank(stat, r);
        ms[r] = rs[tid];
        ls[r] = rs[lanes + tid];
      }
    }
    float m = -INFINITY;
    float den = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < g) combine_lse(m, den, ms[r], ls[r]);
    joint[tid] = m;
    joint[lanes + tid] = fmaxf(den, 1e-30f);
  }
  __syncthreads();
  // 5. p of the chunk's rows, normalised, in the cache dtype
  for (int kq = 0; kq < lanes; ++kq) {
    const float m = joint[kq];
    const float den = joint[lanes + kq];
    for (int lr = tid; lr < my_rows; lr += kThreads) {
      float* p = sc + kq * rows_per_rank + lr;
      *p = avsr::to_float(avsr::from_float<TC>(expf(*p - m) / den));
    }
  }
  __syncthreads();

  // 6. this rank's partial P.V over its rows, in fp32, into red
  if constexpr (kMma) {
    // out^T (dh x 8 queries) = V^T P^T, a warp's 16 rows at a time: V^T
    // by transposed ldmatrix, P^T (exact in bf16: p is rounded already)
    // zero past the tile's rows, whose V rows are zeros too
    constexpr int kMt = kMmaDh / 16;
    float oacc[kMt][4];
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[mt][e] = 0.f;
    for (int i = n_tiles; i < 2 * n_tiles; ++i) {
      cp_async_wait<1>();
      __syncthreads();
      const TC* buf = stage + static_cast<size_t>(i % 2) * tile_rows * ld;
      const int base = (i - n_tiles) * tile;
      const int n = min(tile, my_rows - base);
      write_row(buf, base, n, 1);
      for (int t = warp * 16; t < n; t += kWarps * 16) {
        auto p = [&](int row) {
          return gq < lanes && row < n ? sc[gq * rows_per_rank + base + row]
                                       : 0.f;
        };
        const uint32_t b0 = avsr::mma::pack_bf16(p(t + cq), p(t + cq + 1));
        const uint32_t b1 =
            avsr::mma::pack_bf16(p(t + cq + 8), p(t + cq + 9));
        const __nv_bfloat16* v16 =
            reinterpret_cast<const __nv_bfloat16*>(buf) +
            (t + ((lane_id >> 4) & 1) * 8 + (lane_id & 7)) * ld +
            ((lane_id >> 3) & 1) * 8;
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt) {
          uint32_t a[4];
          avsr::mma::ldsm_x4_t(a, v16 + mt * 16);
          avsr::mma::mma16816(oacc[mt], a, b0, b1);
        }
      }
      __syncthreads();
      issue(i + 2);
    }
    cp_async_wait<0>();
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kq = cq + (e & 1);
        if (kq < lanes)
          red[(warp * lanes + kq) * dh + mt * 16 + gq + (e >> 1) * 8] =
              oacc[mt][e];
      }
  } else {
    float acc[kLanes][kVec];
#pragma unroll
    for (int kq = 0; kq < kLanes; ++kq)
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[kq][e] = 0.f;
    for (int i = n_tiles; i < 2 * n_tiles; ++i) {
      cp_async_wait<1>();
      __syncthreads();
      const TC* buf = stage + static_cast<size_t>(i % 2) * tile_rows * ld;
      const int base = (i - n_tiles) * tile;
      const int n = min(tile, my_rows - base);
      write_row(buf, base, n, 1);
      if (has_chunk) {
        for (int lr = grp; lr < n; lr += rows_per_pass) {
          float vv[kVec];
          load_chunk(buf + lr * ld + chunk * kVec, vv);
#pragma unroll
          for (int kq = 0; kq < kLanes; ++kq) {
            if (kq < lanes) {
              const float p = sc[kq * rows_per_rank + base + lr];
#pragma unroll
              for (int e = 0; e < kVec; ++e)
                acc[kq][e] = fmaf(p, vv[e], acc[kq][e]);
            }
          }
        }
      }
      __syncthreads();
      issue(i + 2);
    }
    cp_async_wait<0>();
    // the row groups of a warp (lanes that share a chunk)
#pragma unroll
    for (int kq = 0; kq < kLanes; ++kq) {
      if (kq < lanes) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          for (int off = gw; off < 32; off <<= 1)
            acc[kq][e] += __shfl_xor_sync(kFull, acc[kq][e], off);
          if (lane_id < gw && has_chunk)
            red[(warp * lanes + kq) * dh + chunk * kVec + e] = acc[kq][e];
        }
      }
    }
  }
  __syncthreads();
  // the warps in order, into this rank's partial
  for (int e = tid; e < lanes * dh; e += kThreads) {
    float tot = 0.f;
    for (int w = 0; w < kWarps; ++w) tot += red[w * lanes * dh + e];
    part[e] = tot;
  }

  // 7. out = the ranks' partials summed in rank order; rank r writes its
  // share of the (lanes, dh) outputs
  cluster.sync();
  const int per = (lanes * dh + g - 1) / g;
  const int e_end = min((rank + 1) * per, lanes * dh);
  for (int e = rank * per + tid; e < e_end; e += kThreads) {
    float v[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < g) v[r] = cluster.map_shared_rank(part, r)[e];
    float tot = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < g) tot += v[r];
    const int kq = e / dh;
    out[(lane0 + kq) * c_dim + h * dh + e % dh] = avsr::from_float<TQ>(tot);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// Raises a kernel's dynamic shared-memory limit to smem where smem is above
// the default 48 KB. The limit is one value per kernel and device, which
// every launch shares, so it is set once and only ever raised, not at
// every launch (the beam launches the kernel thousands of times a batch).
template <typename K>
cudaError_t raise_smem_limit(K kernel, int smem) {
  struct Limit {
    const void* fn;
    int dev;
    int smem;
  };
  static std::mutex mu;
  static std::vector<Limit> limits;
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  Limit* limit = nullptr;
  for (Limit& e : limits)
    if (e.fn == fn && e.dev == dev) limit = &e;
  if (limit != nullptr && limit->smem >= smem) return cudaSuccess;
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
      cudaSuccess)
    return err;
  if (limit == nullptr)
    limits.push_back({fn, dev, smem});
  else
    limit->smem = smem;
  return cudaSuccess;
}

template <typename TQ, typename TC, int kLanes, bool kMma>
cudaError_t launch_typed(const void* q, void* cache, const float* lane_bias,
                         const void* kv_row, void* out, int b, int lanes,
                         int heads, int dh, int s_max, int pos, int cluster,
                         int rows_per_rank, int tile, int smem,
                         cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(TC);
  const int rows = lanes * (min(pos, s_max - 1) + 1);
  // 1-32 16-byte chunks a row, 16-byte aligned; a plan that covers every
  // row with the shared memory it states
  if (dh % kVec != 0 || dh / kVec > 32 ||
      reinterpret_cast<uintptr_t>(cache) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(kv_row) % 16 != 0 ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      rows_per_rank < 1 ||
      static_cast<long long>(rows_per_rank) * cluster < rows || tile < 1 ||
      tile > rows_per_rank || smem > kMaxSmem ||
      static_cast<size_t>(smem) !=
          smem_bytes(lanes, dh, sizeof(TC), rows_per_rank, tile) ||
      static_cast<long long>(heads) * cluster > 0x7fffffff)
    return cudaErrorInvalidValue;
  auto kernel = decode_attention_kernel<TQ, TC, kLanes, kMma>;
  if (cudaError_t err = raise_smem_limit(kernel, smem); err != cudaSuccess)
    return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(heads * cluster, b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const TQ*>(q), static_cast<TC*>(cache),
      lane_bias, static_cast<const TC*>(kv_row), static_cast<TQ*>(out), lanes,
      heads, dh, s_max, pos, rows_per_rank, tile);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

constexpr int kWideThreads = 128;
constexpr int kWideWarps = kWideThreads / 32;

// the wide kernel's shared memory: q (dh), the scores (lanes * rows of a
// lane), the warps' partial max and sum, and the row groups' partial
// outputs (kWideThreads / chunks a row groups of dh)
__host__ __device__ inline size_t wide_smem_bytes(int lanes, int dh, int esize,
                                                  int s_lim) {
  const int cpr = dh * esize / 16;
  return sizeof(float) *
         (static_cast<size_t>(dh) + static_cast<size_t>(lanes) * s_lim +
          kWideWarps + static_cast<size_t>(kWideThreads / cpr) * dh);
}

template <typename TQ, typename TC>
__global__ void __launch_bounds__(kWideThreads)
    decode_attention_wide_kernel(const TQ* __restrict__ q, TC* cache,
                                 const float* __restrict__ lane_bias,
                                 const TC* __restrict__ kv_row,
                                 TQ* __restrict__ out, int lanes, int heads,
                                 int dh, int s_max, int pos) {
  constexpr int kVec = 16 / sizeof(TC);  // elements per 16-byte chunk
  extern __shared__ __align__(16) float wsm[];
  const int h = blockIdx.x, k = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = heads * dh, s_lim = min(pos, s_max - 1) + 1;
  const int pc = s_lim - 1, rows = lanes * s_lim;
  const int cpr = dh / kVec;  // 16-byte chunks a row, 1-32
  int gw = 1;  // lanes of a warp that share a row: a power of two >= cpr
  while (gw < cpr) gw <<= 1;
  const int groups = kWideThreads / cpr;  // row groups of the P.V
  const size_t n0 = static_cast<size_t>(b) * lanes;  // the utterance's lane 0
  const size_t c2 = 2 * static_cast<size_t>(c);
  float* qs = wsm;
  float* sc = qs + dh;
  float* red = sc + rows;
  float* part = red + kWideWarps;

  // q rounded to the cache dtype; this block's slice of the step's row
  for (int e = tid; e < dh; e += kWideThreads) {
    const size_t at = (n0 + k) * c2 + static_cast<size_t>(h) * dh + e;
    qs[e] = avsr::to_float(avsr::from_float<TC>(
        avsr::to_float(q[(n0 + k) * c + static_cast<size_t>(h) * dh + e])));
    const size_t dst = ((n0 + k) * s_max + pc) * c2 +
                       static_cast<size_t>(h) * dh + e;
    cache[dst] = kv_row[at];
    cache[dst + c] = kv_row[at + c];
  }
  __syncthreads();

  // row r = (j, s) of the prefix: its K (at 0) or V (at c) slice of head h
  auto row_at = [&](int r, size_t half) -> const TC* {
    const int j = r / s_lim, s = r - j * s_lim;
    const size_t off = static_cast<size_t>(h) * dh + half;
    return s == pc ? kv_row + (n0 + j) * c2 + off
                   : cache + ((n0 + j) * s_max + s) * c2 + off;
  };
  // scores: gw lanes a row (a 16-byte chunk each), 32 / gw rows a warp at a
  // time, the chunk's products summed by shuffles within the gw lanes
  const int sub = lane / gw, ch = lane % gw, rpw = 32 / gw;
#pragma unroll 4
  for (int r0 = warp * rpw; r0 < rows; r0 += kWideWarps * rpw) {
    const int r = r0 + sub;
    float dot = 0.f;
    if (r < rows && ch < cpr) {
      float kf[kVec];
      load_chunk(row_at(r, 0) + ch * kVec, kf);
#pragma unroll
      for (int i = 0; i < kVec; ++i) dot += qs[ch * kVec + i] * kf[i];
    }
    for (int off = gw / 2; off > 0; off >>= 1)
      dot += __shfl_xor_sync(kFull, dot, off);
    if (ch == 0 && r < rows) {
      const int j = r / s_lim, s = r - j * s_lim;
      sc[r] = dot + lane_bias[((n0 + k) * s_max + s) * lanes + j];
    }
  }
  __syncthreads();
  // the joint max and the sum of exp(s - m) over the prefix
  float m = -INFINITY;
  for (int r = tid; r < rows; r += kWideThreads) m = fmaxf(m, sc[r]);
  m = avsr::warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
  for (int w = 1; w < kWideWarps; ++w) m = fmaxf(m, red[w]);
  __syncthreads();
  float sum = 0.f;
  for (int r = tid; r < rows; r += kWideThreads) {
    const float p = expf(sc[r] - m);
    sc[r] = p;
    sum += p;
  }
  sum = avsr::warp_sum(sum);
  if (lane == 0) red[warp] = sum;
  __syncthreads();
  float den = 0.f;
  for (int w = 0; w < kWideWarps; ++w) den += red[w];
  den = fmaxf(den, 1e-30f);
  for (int r = tid; r < rows; r += kWideThreads)
    sc[r] = avsr::to_float(avsr::from_float<TC>(sc[r] / den));
  __syncthreads();
  // P.V: thread (g, chunk) sums rows g, g + groups, ... of its chunk's
  // columns; the groups' partials then add in group order
  const int g = tid / cpr, gc = tid - g * cpr;
  if (g < groups) {
    float acc[kVec] = {};
#pragma unroll 4
    for (int r = g; r < rows; r += groups) {
      float vf[kVec];
      load_chunk(row_at(r, c) + gc * kVec, vf);
      const float p = sc[r];
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] += p * vf[i];
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) part[g * dh + gc * kVec + i] = acc[i];
  }
  __syncthreads();
  for (int d = tid; d < dh; d += kWideThreads) {
    float tot = 0.f;
    for (int gg = 0; gg < groups; ++gg) tot += part[gg * dh + d];
    out[(n0 + k) * c + static_cast<size_t>(h) * dh + d] =
        avsr::from_float<TQ>(tot);
  }
}

template <typename TQ, typename TC>
cudaError_t launch_wide(const void* q, void* cache, const float* lane_bias,
                        const void* kv_row, void* out, int b, int lanes,
                        int heads, int dh, int s_max, int pos,
                        cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(TC);
  // 1-32 16-byte chunks a row, 16-byte aligned
  if (dh % kVec != 0 || dh / kVec > 32 ||
      reinterpret_cast<uintptr_t>(cache) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(kv_row) % 16 != 0)
    return cudaErrorInvalidValue;
  const size_t smem =
      wide_smem_bytes(lanes, dh, sizeof(TC), min(pos, s_max - 1) + 1);
  if (smem > kMaxSmem || lanes > 65535) return cudaErrorInvalidValue;
  auto kernel = decode_attention_wide_kernel<TQ, TC>;
  if (cudaError_t err = raise_smem_limit(kernel, static_cast<int>(smem));
      err != cudaSuccess)
    return err;
  kernel<<<dim3(heads, lanes, b), kWideThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<TC*>(cache), lane_bias,
      static_cast<const TC*>(kv_row), static_cast<TQ*>(out), lanes, heads,
      dh, s_max, pos);
  return cudaGetLastError();
}

template <typename TQ, typename TC>
cudaError_t launch_lanes(const void* q, void* cache, const float* lane_bias,
                         const void* kv_row, void* out, int b, int lanes,
                         int heads, int dh, int s_max, int pos, int cluster,
                         int rows_per_rank, int tile, int smem,
                         cudaStream_t stream) {
  if constexpr (sizeof(TC) == 2) {
    if (dh == kMmaDh)
      return launch_typed<TQ, TC, kMaxLanes, true>(
          q, cache, lane_bias, kv_row, out, b, lanes, heads, dh, s_max, pos,
          cluster, rows_per_rank, tile, smem, stream);
  }
  if (lanes <= 2)
    return launch_typed<TQ, TC, 2, false>(
        q, cache, lane_bias, kv_row, out, b, lanes, heads, dh, s_max, pos,
        cluster, rows_per_rank, tile, smem, stream);
  if (lanes <= 4)
    return launch_typed<TQ, TC, 4, false>(
        q, cache, lane_bias, kv_row, out, b, lanes, heads, dh, s_max, pos,
        cluster, rows_per_rank, tile, smem, stream);
  return launch_typed<TQ, TC, kMaxLanes, false>(
      q, cache, lane_bias, kv_row, out, b, lanes, heads, dh, s_max, pos,
      cluster, rows_per_rank, tile, smem, stream);
}

}  // namespace

// q, out: (b*lanes, heads*dh) dtype q_dtype; cache: (b*lanes, s_max,
// 2*heads*dh) dtype cache_dtype, updated in place at row min(pos, s_max-1);
// kv_row: (b*lanes, 2*heads*dh) cache_dtype; lane_bias: (b, lanes, s_max,
// lanes) fp32. The launch plan (ops/kernels/decode_attention.py
// `launch_plan`): `cluster` blocks of one (b, h), rank r taking rows
// [r*rows_per_rank, (r+1)*rows_per_rank) of the lanes*(pos_c+1) prefix,
// in tiles of `tile` rows, with `smem` bytes of dynamic shared memory.
extern "C" int avsr_decode_attention(const void* q, void* cache,
                                     const float* lane_bias, const void* kv_row,
                                     void* out, int b, int lanes, int heads,
                                     int dh, int s_max, int pos, int q_dtype,
                                     int cache_dtype, int cluster,
                                     int rows_per_rank, int tile, int smem,
                                     void* stream) {
  if (b <= 0 || b > 65535 || lanes <= 0 || lanes > kMaxLanes || heads <= 0 ||
      dh <= 0 || s_max <= 0 || pos < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  cudaError_t err;
  if (q_dtype == avsr::kBFloat16 && cache_dtype == avsr::kBFloat16)
    err = launch_lanes<bf16, bf16>(q, cache, lane_bias, kv_row, out, b, lanes,
                                   heads, dh, s_max, pos, cluster,
                                   rows_per_rank, tile, smem, s);
  else if (q_dtype == avsr::kFloat32 && cache_dtype == avsr::kFloat32)
    err = launch_lanes<float, float>(q, cache, lane_bias, kv_row, out, b,
                                     lanes, heads, dh, s_max, pos, cluster,
                                     rows_per_rank, tile, smem, s);
  else if (q_dtype == avsr::kFloat32 && cache_dtype == avsr::kBFloat16)
    err = launch_lanes<float, bf16>(q, cache, lane_bias, kv_row, out, b, lanes,
                                    heads, dh, s_max, pos, cluster,
                                    rows_per_rank, tile, smem, s);
  else if (q_dtype == avsr::kBFloat16 && cache_dtype == avsr::kFloat32)
    err = launch_lanes<bf16, float>(q, cache, lane_bias, kv_row, out, b, lanes,
                                    heads, dh, s_max, pos, cluster,
                                    rows_per_rank, tile, smem, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// lanes > kMaxLanes: the same operands, a block a (head, query lane,
// utterance), no launch plan
extern "C" int avsr_decode_attention_wide(const void* q, void* cache,
                                          const float* lane_bias,
                                          const void* kv_row, void* out, int b,
                                          int lanes, int heads, int dh,
                                          int s_max, int pos, int q_dtype,
                                          int cache_dtype, void* stream) {
  if (b <= 0 || b > 65535 || lanes <= kMaxLanes || heads <= 0 || dh <= 0 ||
      s_max <= 0 || pos < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  cudaError_t err;
  if (q_dtype == avsr::kBFloat16 && cache_dtype == avsr::kBFloat16)
    err = launch_wide<bf16, bf16>(q, cache, lane_bias, kv_row, out, b, lanes,
                                  heads, dh, s_max, pos, s);
  else if (q_dtype == avsr::kFloat32 && cache_dtype == avsr::kFloat32)
    err = launch_wide<float, float>(q, cache, lane_bias, kv_row, out, b,
                                    lanes, heads, dh, s_max, pos, s);
  else if (q_dtype == avsr::kFloat32 && cache_dtype == avsr::kBFloat16)
    err = launch_wide<float, bf16>(q, cache, lane_bias, kv_row, out, b, lanes,
                                   heads, dh, s_max, pos, s);
  else if (q_dtype == avsr::kBFloat16 && cache_dtype == avsr::kFloat32)
    err = launch_wide<bf16, float>(q, cache, lane_bias, kv_row, out, b, lanes,
                                   heads, dh, s_max, pos, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
