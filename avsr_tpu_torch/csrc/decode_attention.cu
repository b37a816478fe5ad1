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
// layers' caches, 113 MB, do not stay in the 50 MB L2) for ~2K FLOP an
// element (every lane's query meets every stored row). At B=8 there are
// only B*H = 128 (utterance, head) pairs: one block a pair leaves the SMs
// few loads in flight, and the time is the loads' latency, not the card's
// rate. An fp32 cache (the conformer decoder's C=768: 28 MB a layer at
// B=8) is bound the same way; on the CUDA cores its q.k and P.V took ~27
// of its 39 us there, on the tensor cores in split TF32 (three tf32
// products a step, 3x the FLOPs, still ~30x under the bytes) they do not.
// Its copies then run at ~1.75 TB/s (256-byte head slices of 6 KB rows);
// a ring of four half-length stages, to put the V tiles in flight beside
// the K tiles, only slowed the K tiles (PERF.md).
//
// Design: the rows of one (b, h) are split over a thread-block cluster of G
// blocks (grid (H*G, B, query groups), cluster (G, 1, 1), launched with
// cudaLaunchKernelEx so that G is chosen at run time by the caller's launch
// plan). The plan is sized for all K*S rows and is the same at every step:
// the step pos is read from device memory, as the TPU kernel reads it from
// SMEM, so one launch captured in a CUDA graph serves every replay. Rank r
// takes a contiguous chunk of the prefix's K*(pos_c+1) live rows (an even
// share, a multiple of 4), row r = (s, j) = s * K + j (position s of
// stored lane j; pos_c = min(pos, S-1)), and reads it once for all the
// lanes' queries of its group (every lane up to kGroupLanes = 64 of them: beams of
// up to 64 read the prefix once; more lanes split into even query groups,
// each a grid slice that reads the prefix again). It issues its chunk's
// loads with cp.async, the bias 4 bytes a copy (in the rows' (s, j) order
// each query's bias is one contiguous run of lane_bias) and the K and V
// rows 16 bytes a copy, into two stage buffers (tiles of `tile` rows,
// double-buffered), so that the next tile's copies overlap this tile's
// products. The copies step through (s, j) by additions, not two integer
// divisions each, and no copy waits on a load's result. Row pos_c is never
// read from the cache: every rank copies it from kv_row, and the rank
// whose chunk holds (pos_c, j) writes it into the cache from its
// shared-memory copy (query group 0 only), so no block reads a row another
// is writing.
//
// The fp32 scores of the rank's rows stay in shared memory where they fit
// (`chunk` >= the rank's rows: one pass, the bias staged into the scores
// with the first load). Where lanes x rows do not fit (many lanes over a
// long cache), the rank walks its rows in chunks of `chunk` rows twice:
// pass 1 takes each chunk's scores and folds its (max, shifted sum) into
// the rank's; pass 2 loads each chunk's keys again, recomputes the same
// scores (the same products in the same order, bias read from global
// memory: bit for bit the scores of pass 1), and then its values.
//
// The TPU kernel's rounding points survive the split. q is rounded to the
// cache dtype before q.k. Each rank publishes, per query, its local (max
// m_r, sum l_r of exp(s - m_r)) in shared memory; after cluster.sync()
// every rank combines all G pairs through distributed shared memory in
// rank order with the (max, shifted sum) monoid and its -3e38 guard (a
// rank with no row contributes (-inf, 0)), so every rank derives the same
// m and den. Then p = round_to_cache_dtype(exp(s - m) / max(den, 1e-30)),
// the partial P.V in fp32, and the G partial outputs are summed through
// distributed shared memory in rank order: deterministic. With a bf16
// cache the softmax's exp is __expf (ex2.approx: a few fp32 ulps, against
// the 2^16 fp32 ulps of one bf16 step that p is rounded to), taken once a
// score: the rank's exp(s - m_rank) replaces the held score, and p is it
// times exp(m_rank - m) / den (a few fp32 ulps from exp(s - m) / den).
// Such fp32 differences, like the sums' order, move an output only by the
// p that round the other way, which decode_attention.output_bound counts
// (ROADMAP C27). fp32 caches keep expf and IEEE-exact division (div_rn).
//
// Products: with dh = 64 (every model's heads) q.k and P.V run on the
// tensor cores, with the group's queries as ceil(lanes / 8) 8-wide
// operands (kNt tiles, a template: 1, 2, 4 or 8): S (16 rows x 8 queries)
// = K q^T, every K fragment feeding every query tile; out^T (dh x 8) =
// V^T P^T, warp w taking head dims 16 (w % 4)..+15 of every query tile
// over one half of the tile's 16-row groups, the two halves' partials
// added in order. A bf16 cache takes mma.sync m16n8k16: the queries' B
// fragments bf16 pairs in shared memory, K from ldmatrix rows, V^T from
// transposed ldmatrix, P exact in bf16 since it is rounded already (the
// softmax leaves each pair of rows' p as the bf16 pair the B operand
// loads). An fp32 cache takes m16n8k8 in split TF32 (mma_tf32.cuh: x = hi
// + lo, three tf32 products a step, lo hi, hi lo, hi hi, ~2^-21 of a
// product dropped, never one TF32 product): the queries split once into
// their B fragments in shared memory (one 16-byte load a lane, a query
// tile and a k-step); q.k takes lane (g, c) dims 8c..8c+7 of each 32 of
// rows g and g + 8 (two 16-byte loads, rows of dh + 4 floats:
// conflict-free), product p of the 32 taking dims 8c + 2p and the next as
// k = c and c + 4, each K fragment split once for every query tile
// (mma_split_rows); P.V takes rows 2c and 2c + 1 of each 8 as k = c and
// c + 4 (V^T's fragment reads banks 8c + g: conflict-free), V^T's
// fragment split once for every query tile, P's pair split at use. The
// softmax's elementwise passes keep four rows in flight a thread; eight
// warps a block, two blocks an SM where the plan fits. Otherwise (other
// head widths) a row's Dh slice is read by gw (the next power of two >=
// its 16-byte chunks) adjacent threads, one query after another against
// the queries in shared memory, a shuffle over the gw threads summing a
// score; the P.V gives each thread (query, 16-byte chunk) outputs, which
// it accumulates over the tile's rows in shared memory.
//
// The numbered phase comments of the kernel are where the variants tool
// (tools/decode_variants.py) cuts a copy of it short, to time the phases
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
constexpr int kTileLanes = 8;  // queries of one mma operand tile
constexpr int kGroupLanes = 64;  // queries of one block: 8 operand tiles
constexpr int kMaxCluster = 8;
constexpr int kMmaDh = 64;  // the head width whose products use mma
constexpr int kMaxSmem = 232448;  // 227 KB, the opt-in limit of a block
constexpr unsigned kFull = 0xffffffffu;
// the mma path's P.V gives warp w head dims 16 (w % 4).. of row half w / 4
static_assert(kWarps == 2 * kMmaDh / 16, "two warps a 16-wide head slice");

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

// 32-bit words of the queries in shared memory: (lanes, dh) fp32 values,
// or on the split-TF32 path (an fp32 cache, dh = kMmaDh) each 8-query
// tile's split B fragments, hi and lo of (8, dh) values
__host__ __device__ inline size_t query_words(int lanes, int dh, int esize) {
  return esize == 4 && dh == kMmaDh
             ? 2 * static_cast<size_t>((lanes + kTileLanes - 1) /
                                       kTileLanes * kTileLanes) * dh
             : static_cast<size_t>(lanes) * dh;
}

// shared-memory bytes of one block: two stage buffers of tile rows rounded
// up to 16, each row dh elements and a 16-byte pad; the fp32 scores of
// `chunk` rows for each of the group's `lanes` queries (rounded up to 4
// floats); the local and joint (m, l) per query; the queries
// (query_words) and the rank's partial outputs (lanes, dh). The launch
// plan computes the same.
__host__ __device__ inline size_t smem_bytes(int lanes, int dh, int esize,
                                             int chunk, int tile) {
  const size_t scores = (static_cast<size_t>(lanes) * chunk + 3) / 4 * 4;
  return 2 * static_cast<size_t>((tile + 15) & ~15) * (dh * esize + 16) +
         sizeof(float) * (scores + 4 * static_cast<size_t>(lanes) +
                          query_words(lanes, dh, esize) +
                          static_cast<size_t>(lanes) * dh);
}

// exp(x) of the softmax: on the bf16 mma path __expf (ex2.approx, a few
// fp32 ulps off; p is rounded to bf16 after it, 2^16 fp32 ulps a step),
// else expf
template <bool kFast>
__device__ __forceinline__ float soft_exp(float x) {
  return kFast ? __expf(x) : expf(x);
}

// kNt: query tiles of 8 of the mma path (the group's lanes <= 8 kNt).
// kMma: dh = kMmaDh, whose q.k and P.V run on the tensor cores: a bf16
// cache on m16n8k16 (kBf), an fp32 one in split TF32 on m16n8k8 (kTf).
template <typename TQ, typename TC, int kNt, bool kMma>
__global__ void __launch_bounds__(kThreads, 2)
    decode_attention_kernel(const TQ* __restrict__ q, TC* cache,
                            const float* __restrict__ lane_bias,
                            const TC* __restrict__ kv_row, TQ* __restrict__ out,
                            const int* __restrict__ step, int lanes,
                            int heads, int dh, int s_max, int tile, int chunk,
                            int group_lanes) {
  constexpr int kVec = 16 / sizeof(TC);  // elements per 16-byte chunk
  constexpr bool kBf = kMma && sizeof(TC) == 2;
  constexpr bool kTf = kMma && sizeof(TC) == 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int g = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.x / g;
  const int b = blockIdx.y;
  const int kq0 = blockIdx.z * group_lanes;  // the group's first query lane
  const int nq = min(group_lanes, lanes - kq0);  // its queries
  const bool writer = blockIdx.z == 0;  // writes the step's row
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane_id = tid % 32;
  const int c_dim = heads * dh;
  const int c2 = 2 * c_dim;
  // the step from device memory (a captured launch reads each replay's);
  // its live rows split evenly over the cluster, a multiple of 4 a rank
  const int pos_c = min(max(__ldg(step), 0), s_max - 1);
  const int s_lim = pos_c + 1;
  const int rows = lanes * s_lim;  // row r = (s, j): s = r / lanes
  const int rows_per_rank = (rows + 4 * g - 1) / (4 * g) * 4;
  const int r_begin = min(rank * rows_per_rank, rows);
  const int my_rows = min(r_begin + rows_per_rank, rows) - r_begin;
  const int n_tiles = (my_rows + tile - 1) / tile;
  const int tpc = (chunk + tile - 1) / tile;  // tiles a chunk
  const int n_chunks = (my_rows + chunk - 1) / chunk;
  const bool staged = n_chunks <= 1;  // the scores of every row at once
  const int n_loads = (staged ? 2 : 3) * n_tiles;
  const int ld = dh + kVec;  // a stage row: dh elements and a 16-byte pad
  const int tile_rows = (tile + 15) & ~15;
  const int cpr = dh / kVec;  // 16-byte chunks a row
  // threads a row: gw = 2^lg >= cpr, <= 32; shifts, not divisions, place
  // a thread, and (s, j) steps along without dividing
  const int lg = cpr <= 1 ? 0 : 32 - __clz(cpr - 1);
  const int gw = 1 << lg;
  const int rows_per_pass = kThreads >> lg;
  const int chunk16 = tid & (gw - 1);  // threads with chunk16 >= cpr idle
  const int grp = tid >> lg;
  const bool has_chunk = chunk16 < cpr;
  const int ds = rows_per_pass / lanes, dj = rows_per_pass % lanes;
  const size_t lane0 = static_cast<size_t>(b) * lanes;
  // mma fragment coordinates: row (or query) gq, column pair cq
  const int gq = lane_id >> 2;
  const int c4 = lane_id & 3;
  const int cq = 2 * c4;
  const int nqt = (nq + kTileLanes - 1) / kTileLanes;  // the query tiles
  // the mma P.V's share: head dims 16 mt..16 mt + 15, row groups half,
  // half + 2, ...
  const int mt = warp & 3, half = warp >> 2;

  TC* stage = reinterpret_cast<TC*>(smem_raw);  // 2 x (tile_rows, ld)
  float* sc = reinterpret_cast<float*>(
      stage + 2 * static_cast<size_t>(tile_rows) * ld);  // (lanes, chunk)
  float* stat = sc + (group_lanes * chunk + 3) / 4 * 4;  // (2, lanes): m, l
  float* joint = stat + 2 * group_lanes;  // (2, lanes): m, p's factor
  float* qs = joint + 2 * group_lanes;    // the queries (query_words)
  // (lanes, dh): this rank's P.V
  float* part = qs + query_words(group_lanes, dh, sizeof(TC));
  // the bf16 mma path's queries: bf16 pairs, rows of kQb words (a 16-byte
  // pad: the 8 queries of a fragment hit distinct banks)
  constexpr int kQb = kMmaDh / 2 + 4;
  uint32_t* qb = reinterpret_cast<uint32_t*>(qs);
  // the split-TF32 path's: qf[(8 nt + s) * 32 + lane] holds lane (g, c)'s
  // B fragment of k-step s = 4 hf + p of query tile nt (query 8 nt + g,
  // dims 32 hf + 8 c + 2 p and the next): (hi, hi, lo, lo)
  uint4* qf = reinterpret_cast<uint4*>(qs);

  // 1. the queries, rounded to the cache dtype, in shared memory (on the
  // bf16 mma path as bf16 pairs, eight dims a thread in 16-byte loads; on
  // the split-TF32 path as their split B fragments, zeros past the
  // group's queries); the rank's (m, l) start empty
  if constexpr (kTf) {
    for (int e = tid; e < nqt * kTileLanes * kMmaDh / 2; e += kThreads) {
      const int ln = e & 31, st = (e >> 5) & 7, nt = e >> 8;
      const int kq = nt * kTileLanes + (ln >> 2);
      const int d = 32 * (st >> 2) + 8 * (ln & 3) + 2 * (st & 3);
      float x0 = 0.f, x1 = 0.f;
      if (kq < nq) {
        const TQ* qp = q + (lane0 + kq0 + kq) * c_dim + h * dh + d;
        x0 = avsr::to_float(qp[0]);
        x1 = avsr::to_float(qp[1]);
      }
      uint4 f;
      avsr::tf32::split_tf32(x0, f.x, f.z);
      avsr::tf32::split_tf32(x1, f.y, f.w);
      qf[e] = f;
    }
  } else if constexpr (kBf) {
    constexpr int kQv = 16 / sizeof(TQ);  // q elements a 16-byte load
    for (int e = tid; e < group_lanes * dh / 8; e += kThreads) {
      const int kq = e / (dh / 8), d = (e - kq * (dh / 8)) * 8;
      uint4 raw[8 / kQv];
      const TQ* qp = q + (lane0 + kq0 + kq) * c_dim + h * dh + d;
#pragma unroll
      for (int i = 0; i < 8 / kQv; ++i)
        raw[i] = kq < nq ? *reinterpret_cast<const uint4*>(qp + i * kQv)
                         : make_uint4(0u, 0u, 0u, 0u);
      const TQ* v = reinterpret_cast<const TQ*>(raw);
      uint4 packed;
      uint32_t* pw = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pw[i] = avsr::mma::pack_bf16(avsr::to_float(v[2 * i]),
                                     avsr::to_float(v[2 * i + 1]));
      *reinterpret_cast<uint4*>(qb + kq * kQb + d / 2) = packed;
    }
  } else {
    for (int e = tid; e < group_lanes * dh; e += kThreads) {
      const int kq = e / dh, d = e - kq * dh;
      qs[e] = kq < nq ? avsr::to_float(avsr::from_float<TC>(avsr::to_float(
                            q[(lane0 + kq0 + kq) * c_dim + h * dh + d])))
                      : 0.f;
      part[e] = 0.f;
    }
  }
  for (int kq = tid; kq < group_lanes; kq += kThreads) {
    stat[kq] = -INFINITY;
    stat[group_lanes + kq] = 0.f;
  }

  // 2. copies into shared memory: where the scores of every row fit, the
  // ancestry bias of the rank's rows into the scores (with load 0): in the
  // (s, j) order of the rows, each query's rows are one contiguous run of
  // lane_bias (B, K, S, J); then load i (K tiles 0..n_tiles-1; then V
  // tiles, or, chunk by chunk, the chunk's K tiles again and its V tiles)
  // into stage buffer i % 2, zeros up to a multiple of 16 rows; one commit
  // group a load, empty past the last. Row pos_c comes from kv_row.
  // Where every run starts 16-byte aligned (the plan's rows a rank are a
  // multiple of 4) it goes 16 bytes a copy, its tail 4.
  if (staged && my_rows > 0) {
    const bool vec = (s_max * lanes) % 4 == 0 && r_begin % 4 == 0 &&
                     chunk % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(lane_bias) % 16 == 0;
    const int n4 = vec ? my_rows / 4 : 0;  // whole 16-byte copies a query
    if (n4 > 0) {
      int kq = tid / n4, v = tid - kq * n4;
      for (; kq < nq;) {
        cp_async16(sc + kq * chunk + 4 * v,
                   lane_bias + (lane0 + kq0 + kq) * s_max * lanes + r_begin +
                       4 * v,
                   true);
        for (v += kThreads; v >= n4 && kq < nq; v -= n4) ++kq;
      }
    }
    const int tail = my_rows - 4 * n4;
    int kq = tail > 0 ? tid / tail : nq, lr = tid - kq * tail;
    for (; kq < nq;) {
      cp_async4(sc + kq * chunk + 4 * n4 + lr,
                lane_bias + (lane0 + kq0 + kq) * s_max * lanes + r_begin +
                    4 * n4 + lr);
      for (lr += kThreads; lr >= tail && kq < nq; lr -= tail) ++kq;
    }
  }
  // load i: (0 keys / 1 values, its tile)
  auto load_of = [&](int i, int* hf, int* t) {
    if (i < n_tiles) {
      *hf = 0;
      *t = i;
      return;
    }
    const int k = i - n_tiles;
    if (staged) {
      *hf = 1;
      *t = k;
      return;
    }
    const int c = k / (2 * tpc), r = k - c * 2 * tpc;
    const int cnt = min(tpc, n_tiles - c * tpc);
    *hf = r >= cnt;
    *t = c * tpc + (r < cnt ? r : r - cnt);
  };
  auto issue = [&](int i) {
    if (i < n_loads && has_chunk) {
      int hf, t;
      load_of(i, &hf, &t);
      const int base = t * tile;
      const int n = min(tile, my_rows - base);
      TC* buf = stage + static_cast<size_t>(i % 2) * tile_rows * ld;
      const int col = hf * c_dim + h * dh + chunk16 * kVec;
      int s = (r_begin + base + grp) / lanes;
      int j = (r_begin + base + grp) % lanes;
      const int n16 = (n + 15) & ~15;
      for (int lr = grp; lr < n16; lr += rows_per_pass) {
        const bool ok = lr < n;
        const size_t lane = lane0 + j;
        const TC* src = !ok         ? cache
                        : s == pos_c ? kv_row + lane * c2 + col
                                     : cache + (lane * s_max + s) * c2 + col;
        cp_async16(buf + lr * ld + chunk16 * kVec, src, ok);
        s += ds;
        j += dj;
        if (j >= lanes) {
          j -= lanes;
          ++s;
        }
      }
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);

  // the cache's row pos_c of each lane j whose (pos_c, j) lies in the tile
  // just landed in buf: its K or V half of this head, from shared memory
  auto write_row = [&](const TC* buf, int base, int n, int hf) {
    if (!writer) return;
    for (int e = tid; e < lanes * cpr; e += kThreads) {
      const int j = e / cpr;
      const int lr = pos_c * lanes + j - r_begin - base;
      if (lr < 0 || lr >= n) continue;
      const int ch = e % cpr;
      *reinterpret_cast<uint4*>(
          cache + ((lane0 + j) * s_max + pos_c) * c2 + hf * c_dim +
          h * dh + ch * kVec) =
          *reinterpret_cast<const uint4*>(buf + lr * ld + ch * kVec);
    }
  };

  // the scores of tile t (in buf) into its chunk's rows of sc, added to
  // their bias: staged in sc already, else read here
  auto score_tile = [&](const TC* buf, int t) {
    const int base = t * tile;
    const int n = min(tile, my_rows - base);
    float* st = sc + (t % tpc) * tile;
    auto put = [&](int kq, int row, float acc) {
      float* sp = st + kq * chunk + row;
      if (staged)
        *sp += acc;
      else
        *sp = acc + __ldg(lane_bias + (lane0 + kq0 + kq) * s_max * lanes +
                          r_begin + base + row);
    };
    if constexpr (kTf) {
      // a warp's 16 rows at a time: S (16 rows x 8 queries) = K q^T in
      // split TF32, each K fragment split once for every query tile
      const float* kf = reinterpret_cast<const float*>(buf);
      for (int t16 = warp * 16; t16 < n; t16 += kWarps * 16) {
        float acc[kNt][4];
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt)
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
            uint32_t ahi[4], alo[4], bhi[kNt][2], blo[kNt][2];
            avsr::tf32::split_a(ahi, alo, r0[2 * p], r8[2 * p],
                                r0[2 * p + 1], r8[2 * p + 1]);
#pragma unroll
            for (int nt = 0; nt < kNt; ++nt) {
              const uint4 f =
                  nt < nqt ? qf[(nt * 8 + 4 * hf + p) * 32 + lane_id]
                           : make_uint4(0u, 0u, 0u, 0u);
              bhi[nt][0] = f.x, bhi[nt][1] = f.y;
              blo[nt][0] = f.z, blo[nt][1] = f.w;
            }
            avsr::tf32::mma_split_rows<kNt>(acc, ahi, alo, bhi, blo, nqt);
          }
        }
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
          if (nt >= nqt) break;  // uniform over the block
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = t16 + gq + (e >> 1) * 8;
            const int kq = nt * kTileLanes + cq + (e & 1);
            if (kq < nq && row < n) put(kq, row, acc[nt][e]);
          }
        }
      }
    } else if constexpr (kBf) {
      // a warp's 16 rows at a time: S (16 rows x 8 queries) = K q^T for
      // every query tile from the same K fragments
      for (int t16 = warp * 16; t16 < n; t16 += kWarps * 16) {
        uint32_t a[kMmaDh / 16][4];
#pragma unroll
        for (int kk = 0; kk < kMmaDh / 16; ++kk)
          avsr::mma::load_a<kMmaDh>(
              a[kk], reinterpret_cast<const __nv_bfloat16*>(buf) + t16 * ld,
              kk, lane_id);
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
          if (nt * kTileLanes >= nq) break;  // uniform over the block
          const uint32_t* qrow = qb + (nt * kTileLanes + gq) * kQb + cq / 2;
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kk = 0; kk < kMmaDh / 16; ++kk)
            avsr::mma::mma16816(acc, a[kk], qrow[kk * 8], qrow[kk * 8 + 4]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = t16 + gq + (e >> 1) * 8;
            const int kq = nt * kTileLanes + cq + (e & 1);
            if (kq < nq && row < n) put(kq, row, acc[e]);
          }
        }
      }
    } else {
      // gw threads a row, a shuffle sums their chunks; the pass and query
      // counts are uniform over the block, so every lane reaches the
      // shuffles
      for (int r0 = 0; r0 < n; r0 += rows_per_pass) {
        const int lr = r0 + grp;
        const bool ok = lr < n && has_chunk;
        float kv[kVec];
        if (ok) {
          load_chunk(buf + lr * ld + chunk16 * kVec, kv);
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) kv[e] = 0.f;
        }
        for (int kq = 0; kq < nq; ++kq) {
          float acc = 0.f;
          if (ok) {
            const float* qr = qs + kq * dh + chunk16 * kVec;
#pragma unroll
            for (int e = 0; e < kVec; ++e) acc = fmaf(qr[e], kv[e], acc);
          }
          for (int off = 1; off < gw; off <<= 1)
            acc += __shfl_xor_sync(kFull, acc, off);
          if (lr < n && chunk16 == 0) put(kq, lr, acc);
        }
      }
    }
  };

  // the (max, shifted sum) of the chunk's n rows per query, folded into
  // the rank's (m, l) in chunk order, four rows in flight a lane
  // (independent chains, summed in a fixed order); on the bf16 mma path
  // with every row's scores held, each score becomes its exp(s - m_rank)
  auto fold = [&](int n) {
    const bool keep = kBf && staged;
    for (int kq = warp; kq < nq; kq += kWarps) {
      float* srow = sc + kq * chunk;
      float m4[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
      for (int e = lane_id; e < n; e += 128)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (e + 32 * u < n) m4[u] = fmaxf(m4[u], srow[e + 32 * u]);
      const float mx =
          avsr::warp_max(fmaxf(fmaxf(m4[0], m4[1]), fmaxf(m4[2], m4[3])));
      const float safe = fmaxf(mx, -3.0e38f);
      float s4[4] = {0.f, 0.f, 0.f, 0.f};
      for (int e = lane_id; e < n; e += 128)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (e + 32 * u < n) {
            const float x = soft_exp<kBf>(srow[e + 32 * u] - safe);
            if (keep) srow[e + 32 * u] = x;
            s4[u] += x;
          }
      const float sum = avsr::warp_sum((s4[0] + s4[1]) + (s4[2] + s4[3]));
      if (lane_id == 0) combine_lse(stat[kq], stat[group_lanes + kq], mx, sum);
    }
  };

  // 3. scores of the chunk's rows, added to their bias, and their
  // statistics chunk by chunk
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<1>();
    __syncthreads();
    const TC* buf = stage + static_cast<size_t>(i % 2) * tile_rows * ld;
    const int base = i * tile;
    write_row(buf, base, min(tile, my_rows - base), 0);
    score_tile(buf, i);
    __syncthreads();
    issue(i + 2);
    // (the next tile's scores wait behind the barrier that opens it)
    if (i % tpc == tpc - 1 || i == n_tiles - 1)
      fold(min(chunk, my_rows - (i / tpc) * chunk));
  }

  // 4. the joint softmax's statistics: the ranks' (m, l) per query,
  // combined over the cluster in rank order; p's factor: den, or, on the
  // bf16 mma path, 1 / den or, with every row's exp held, exp(m_rank - m)
  // / den
  cluster.sync();
  if (tid < nq) {
    float ms[kMaxCluster], ls[kMaxCluster];  // all loads in flight at once
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < g) {
        const float* rs = cluster.map_shared_rank(stat, r);
        ms[r] = rs[tid];
        ls[r] = rs[group_lanes + tid];
      }
    }
    float m = -INFINITY;
    float den = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < g) combine_lse(m, den, ms[r], ls[r]);
    den = fmaxf(den, 1e-30f);
    joint[tid] = m;
    joint[group_lanes + tid] =
        !kBf     ? den
        : staged ? soft_exp<true>(fmaxf(stat[tid], -3.0e38f) - m) / den
                 : 1.f / den;
  }
  __syncthreads();

  // 5. chunk by chunk (the scores again where they did not all fit): p of
  // the chunk's rows, normalised, in the cache dtype; then the warps' P.V
  // over them, in fp32
  constexpr int kOt = kMma ? kNt : 1;
  float oacc[kOt][4];
#pragma unroll
  for (int nt = 0; nt < kOt; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[nt][e] = 0.f;
  int li = n_tiles;  // the next load
  for (int c = 0; c < max(n_chunks, 1); ++c) {
    const int t0 = c * tpc, t1 = min(n_tiles, t0 + tpc);
    const int nrc = min(chunk, my_rows - c * chunk);
    if (!staged) {
      for (int t = t0; t < t1; ++t, ++li) {
        cp_async_wait<1>();
        __syncthreads();
        score_tile(stage + static_cast<size_t>(li % 2) * tile_rows * ld, t);
        __syncthreads();
        issue(li + 2);
      }
    }
    // p of the chunk's rows, four units a thread at a time: on the bf16 mma
    // path a unit is a (query, even row) pair, p = the held exp times p's
    // factor, or exp(s - m) times 1 / den, the pair's two p rounded to
    // bf16 into one 32-bit word in the even row's place (the P.V's B
    // operand as it loads; a pair past the chunk's rows takes 0); else a
    // (query, row), p = div_rn(expf(s - m), den) (IEEE's division wherever
    // p is normal, with no slow path for the masked rows' p = 0)
    if (nrc > 0) {
      constexpr int kRows = kBf ? 2 : 1;  // rows a unit
      const int per_q = (nrc + kRows - 1) / kRows;
      const int total = nq * per_q;
      int kq = tid / per_q, lu = tid - kq * per_q;
      for (int e = tid; e < total; e += 4 * kThreads) {
        float* pp[4];
        float x[4][kRows], f[4];
        bool two[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool ok = e + u * kThreads < total;
          const int lr = kRows * lu;
          pp[u] = sc + (ok ? kq * chunk + lr : 0);
          two[u] = lr + 1 < nrc;
          const float m = ok && !(kBf && staged) ? joint[kq] : 0.f;
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            x[u][i] = ok && (i == 0 || two[u]) ? pp[u][i] - m : -INFINITY;
          f[u] = ok ? joint[group_lanes + kq] : 1.f;
          for (lu += kThreads; lu >= per_q && kq < nq; lu -= per_q) ++kq;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (e + u * kThreads >= total) continue;
          if constexpr (kBf) {
            float p[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
              p[i] = i == 1 && !two[u] ? 0.f
                     : staged          ? x[u][i] * f[u]
                                       : soft_exp<true>(x[u][i]) * f[u];
            *reinterpret_cast<uint32_t*>(pp[u]) =
                avsr::mma::pack_bf16(p[0], p[1]);
          } else {
            *pp[u] = avsr::to_float(avsr::from_float<TC>(avsr::mma::div_rn(
                expf(x[u][0]), f[u], __frcp_rn(f[u]))));
          }
        }
      }
    }
    __syncthreads();
    for (int t = t0; t < t1; ++t, ++li) {
      cp_async_wait<1>();
      __syncthreads();
      const TC* buf = stage + static_cast<size_t>(li % 2) * tile_rows * ld;
      const int base = t * tile;
      const int n = min(tile, my_rows - base);
      const float* pt = sc + (t % tpc) * tile;
      write_row(buf, base, n, 1);
      if constexpr (kTf) {
        // out^T (dh x 8 queries) = V^T P^T in split TF32: warp (mt, half)
        // takes head dims 16 mt..16 mt + 15 of every query tile over the
        // row groups of its half, each 16 rows as two k8 steps whose k = c
        // and c + 4 are rows 2c and 2c + 1; V^T's fragment split once for
        // every query tile, P's pair split at use, zero past the tile's
        // rows (whose V rows are zeros too)
        const float* vf =
            reinterpret_cast<const float*>(buf) + mt * 16 + gq;
        for (int t16 = half * 16; t16 < n; t16 += 32) {
#pragma unroll
          for (int s8 = 0; s8 < 16; s8 += 8) {
            const int r = t16 + s8 + 2 * c4;
            const float* v = vf + r * ld;
            uint32_t ahi[4], alo[4], bhi[kNt][2], blo[kNt][2];
            avsr::tf32::split_a(ahi, alo, v[0], v[8], v[ld], v[ld + 8]);
#pragma unroll
            for (int nt = 0; nt < kNt; ++nt) {
              const int kq = nt * kTileLanes + gq;
              const float* pr = pt + kq * chunk + r;
              const bool live = nt < nqt && kq < nq;
              avsr::tf32::split_tf32(live && r < n ? pr[0] : 0.f, bhi[nt][0],
                                     blo[nt][0]);
              avsr::tf32::split_tf32(live && r + 1 < n ? pr[1] : 0.f,
                                     bhi[nt][1], blo[nt][1]);
            }
            avsr::tf32::mma_split_rows<kNt>(oacc, ahi, alo, bhi, blo, nqt);
          }
        }
      } else if constexpr (kBf) {
        // out^T (dh x 8 queries) = V^T P^T: warp (mt, half) takes head
        // dims 16 mt..16 mt + 15 of every query tile over the row groups
        // of its half; V^T by transposed ldmatrix, P^T (exact in bf16: p
        // is rounded already) zero past the tile's rows, whose V rows are
        // zeros too
        const __nv_bfloat16* v16 =
            reinterpret_cast<const __nv_bfloat16*>(buf) +
            (((lane_id >> 4) & 1) * 8 + (lane_id & 7)) * ld +
            ((lane_id >> 3) & 1) * 8 + mt * 16;
        for (int t16 = half * 16; t16 < n; t16 += 32) {
          uint32_t a[4];
          avsr::mma::ldsm_x4_t(a, v16 + t16 * ld);
#pragma unroll
          for (int nt = 0; nt < kNt; ++nt) {
            if (nt * kTileLanes >= nq) break;  // uniform over the block
            const int kq = nt * kTileLanes + gq;
            // rows (row, row + 1) of p in the even row's word, zero past
            // the tile
            auto p2 = [&](int row) {
              return kq < nq && row < n
                         ? *reinterpret_cast<const uint32_t*>(
                               pt + kq * chunk + row)
                         : 0u;
            };
            avsr::mma::mma16816(oacc[nt], a, p2(t16 + cq), p2(t16 + cq + 8));
          }
        }
      } else {
        // thread (query, 16-byte chunk) outputs, summed over the rows in
        // order into the rank's partial
        for (int e = tid; e < nq * cpr; e += kThreads) {
          const int kq = e / cpr, ch = e - kq * cpr;
          float* o = part + kq * dh + ch * kVec;
          float acc[kVec];
#pragma unroll
          for (int x = 0; x < kVec; ++x) acc[x] = o[x];
          for (int r = 0; r < n; ++r) {
            float vv[kVec];
            load_chunk(buf + r * ld + ch * kVec, vv);
            const float p = pt[kq * chunk + r];
#pragma unroll
            for (int x = 0; x < kVec; ++x) acc[x] = fmaf(p, vv[x], acc[x]);
          }
#pragma unroll
          for (int x = 0; x < kVec; ++x) o[x] = acc[x];
        }
      }
      __syncthreads();
      issue(li + 2);
    }
  }
  // 6. the rank's partial P.V: on the mma path the second row half's sums,
  // then the first half's added to them
  cp_async_wait<0>();
  if constexpr (kMma) {
    for (int h2 = 1; h2 >= 0; --h2) {
      if (half == h2) {
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kq = nt * kTileLanes + cq + (e & 1);
            float* o = part + kq * dh + mt * 16 + gq + (e >> 1) * 8;
            if (kq < nq) *o = h2 ? oacc[nt][e] : oacc[nt][e] + *o;
          }
      }
      __syncthreads();
    }
  }

  // 7. out = the ranks' partials summed in rank order; rank r writes its
  // share of the (lanes, dh) outputs
  cluster.sync();
  const int per = (nq * dh + g - 1) / g;
  const int e_end = min((rank + 1) * per, nq * dh);
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
    out[(lane0 + kq0 + kq) * c_dim + h * dh + e % dh] =
        avsr::from_float<TQ>(tot);
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

template <typename TQ, typename TC, int kNt, bool kMma>
cudaError_t launch_typed(const void* q, void* cache, const float* lane_bias,
                         const void* kv_row, void* out, const int* step,
                         int b, int lanes, int heads, int dh, int s_max,
                         int cluster, int rows_per_rank, int tile, int chunk,
                         int group_lanes, int smem, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(TC);
  const int rows = lanes * s_max;  // the most rows of any step
  const int groups = (lanes + group_lanes - 1) / group_lanes;
  // 1-32 16-byte chunks a row, 16-byte aligned; a plan that covers every
  // row and query lane with the shared memory it states, chunks of whole
  // tiles where there are more than one
  if (dh % kVec != 0 || dh / kVec > 32 ||
      reinterpret_cast<uintptr_t>(cache) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(kv_row) % 16 != 0 ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      rows_per_rank < 1 ||
      static_cast<long long>(rows_per_rank) * cluster < rows || tile < 1 ||
      tile > rows_per_rank || chunk < tile ||
      (chunk % tile != 0 && chunk < rows_per_rank) ||
      group_lanes < 1 || group_lanes > kGroupLanes ||
      (kMma && group_lanes > kTileLanes * kNt) || groups > 65535 ||
      smem > kMaxSmem ||
      static_cast<size_t>(smem) !=
          smem_bytes(group_lanes, dh, sizeof(TC), chunk, tile) ||
      static_cast<long long>(heads) * cluster > 0x7fffffff)
    return cudaErrorInvalidValue;
  auto kernel = decode_attention_kernel<TQ, TC, kNt, kMma>;
  if (cudaError_t err = raise_smem_limit(kernel, smem); err != cudaSuccess)
    return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(heads * cluster, b, groups);
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
      lane_bias, static_cast<const TC*>(kv_row), static_cast<TQ*>(out), step,
      lanes, heads, dh, s_max, tile, chunk, group_lanes);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// mma: the tensor-core instances where the heads are kMmaDh wide; else the
// CUDA-core instance at any head width
template <typename TQ, typename TC>
cudaError_t launch_lanes(const void* q, void* cache, const float* lane_bias,
                         const void* kv_row, void* out, const int* step,
                         int b, int lanes, int heads, int dh, int s_max,
                         int cluster, int rows_per_rank, int tile, int chunk,
                         int group_lanes, int smem, bool mma,
                         cudaStream_t stream) {
#define AVSR_DECODE_LAUNCH(NT, MMA)                                           \
  launch_typed<TQ, TC, NT, MMA>(q, cache, lane_bias, kv_row, out, step, b,    \
                                lanes, heads, dh, s_max, cluster,            \
                                rows_per_rank, tile, chunk, group_lanes, smem, \
                                stream)
  if (mma && dh == kMmaDh) {  // bf16 on m16n8k16, fp32 in split TF32
    if (group_lanes <= kTileLanes) return AVSR_DECODE_LAUNCH(1, true);
    if (group_lanes <= 2 * kTileLanes) return AVSR_DECODE_LAUNCH(2, true);
    if (group_lanes <= 4 * kTileLanes) return AVSR_DECODE_LAUNCH(4, true);
    return AVSR_DECODE_LAUNCH(8, true);
  }
  return AVSR_DECODE_LAUNCH(1, false);
#undef AVSR_DECODE_LAUNCH
}

}  // namespace

// q, out: (b*lanes, heads*dh) dtype q_dtype; cache: (b*lanes, s_max,
// 2*heads*dh) dtype cache_dtype, updated in place at row min(pos, s_max-1);
// kv_row: (b*lanes, 2*heads*dh) cache_dtype; lane_bias: (b, lanes, s_max,
// lanes) fp32; step: pos, one int32 in device memory, which the kernel
// reads (a graph's replays each read theirs). The launch plan
// (ops/kernels/decode_attention.py `launch_plan`), the same at every
// step: `cluster` blocks of one (b, h), rows_per_rank rows a rank enough
// for all lanes*s_max rows (the kernel splits the step's lanes*(pos_c+1)
// live rows evenly, 4 a rank at a time), in tiles of `tile` rows, the
// scores of `chunk` rows at once (all of the rank's, or a multiple of the
// tile); query groups of `group_lanes` lanes; `smem` bytes of dynamic
// shared memory. cuda_cores != 0 launches the CUDA-core instance
// even where the heads take the tensor cores (the yardstick that the
// tensor-core instances are timed against).
extern "C" int avsr_decode_attention(const void* q, void* cache,
                                     const float* lane_bias, const void* kv_row,
                                     void* out, const int* step, int b,
                                     int lanes, int heads, int dh, int s_max,
                                     int q_dtype,
                                     int cache_dtype, int cluster,
                                     int rows_per_rank, int tile, int chunk,
                                     int group_lanes, int smem,
                                     int cuda_cores, void* stream) {
  if (b <= 0 || b > 65535 || lanes <= 0 || heads <= 0 || dh <= 0 ||
      s_max <= 0 || step == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  cudaError_t err;
#define AVSR_DECODE_TYPED(TQ, TC)                                           \
  launch_lanes<TQ, TC>(q, cache, lane_bias, kv_row, out, step, b, lanes,   \
                       heads, dh, s_max, cluster, rows_per_rank, tile, chunk, \
                       group_lanes, smem, cuda_cores == 0, s)
  if (q_dtype == avsr::kBFloat16 && cache_dtype == avsr::kBFloat16)
    err = AVSR_DECODE_TYPED(bf16, bf16);
  else if (q_dtype == avsr::kFloat32 && cache_dtype == avsr::kFloat32)
    err = AVSR_DECODE_TYPED(float, float);
  else if (q_dtype == avsr::kFloat32 && cache_dtype == avsr::kBFloat16)
    err = AVSR_DECODE_TYPED(float, bf16);
  else if (q_dtype == avsr::kBFloat16 && cache_dtype == avsr::kFloat32)
    err = AVSR_DECODE_TYPED(bf16, float);
  else
    err = cudaErrorInvalidValue;
#undef AVSR_DECODE_TYPED
  return static_cast<int>(err);
}
