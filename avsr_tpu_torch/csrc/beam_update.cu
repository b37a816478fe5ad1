// One beam step's bookkeeping after scoring: candidate weighting, the flat
// top-k over each utterance's (K, S'+1) candidates, the successor gathers of
// the token buffer and the lazy-reorder ancestry, eos retirement,
// running-best tracking and end detection.
//
// Replaces the Pallas TPU kernel avsr_tpu/ops/pallas/beam_update.py
// `_kernel` (entry `beam_update`), which loads every operand into VMEM and
// runs the whole update as one program instead of ~100 scalar-shaped XLA
// ops.
//
// What bounds it on the card: latency. At B=8, K=3, S'=4, L=377 and a
// 192-row ancestry it reads and writes under 0.35 MB (the int64 token
// buffers and ancestry dominate), about 0.1 us at 3.35 TB/s, with a few
// hundred arithmetic operations. So its time is the launch and the chain of
// dependent steps after it. Its worth is the ~100 launches a step of the
// unfused step that it replaces.
//
// Design: one memory round trip, then register work. A grid of (B, G)
// blocks, G enough that a thread owns kItems items of its utterance: a
// column l < L (its K token-buffer elements, the best row's, the ended
// statistics') or a row of the ancestry (its K entries). Every thread first
// issues the loads of everything it will write, all K source rows of each;
// warp 0 of every block loads the utterance's candidates, 4 a lane (K*(S'+1)
// <= 128), and its scalars, in the same round trip. Warp 0 then runs the k
// rounds of the top-k: the largest value by __reduce_max_sync over an
// order-preserving key, the lowest flat index holding it by
// __reduce_min_sync, that candidate set to -inf. Lane r keeps round r, so
// retirement, the best slot, the running best and end detection are
// lane-parallel over K (ballots and one warp max). Each block redoes this
// from the same tiny inputs and gets the same answer; block 0 of an
// utterance writes the per-hypothesis and per-utterance outputs. After one
// __syncthreads every thread selects its outputs by `prev` from registers
// and stores them; no load follows a store.
//
// Exactness: every output is bit-identical to beam_update_plain and to the
// unfused step in decode/beam.py. torch rounds each operation on its own,
// but nvcc would contract w_dec*a + w_ctc*(psi - s) into fused
// multiply-adds, which round once and could flip a near-tie in the top-k.
// So the weighting uses the __fmul_rn / __fadd_rn / __fsub_rn intrinsics,
// which are never contracted, in the unfused step's order; every other
// output is a selection or a copy. The top-k's rule is the twin's: the
// largest value, the lowest flat index among equals; a round whose maximum
// is -inf takes the lowest index holding -inf, which may be one chosen
// before (chosen candidates hold -inf).
//
// Beyond the warp's limits (K > kMaxK or K*(S'+1) > kMaxCand: a beam of 10
// has 160 candidates, a beam of 22 has 748) beam_update_wide_kernel runs
// the same update with a block of kWideThreads, in the same shape: one
// memory round trip, then work in registers and shared memory, no load
// after a store. A grid of (B, G) blocks, kWideItems items (columns or
// ancestry rows) a block: B=32 at L=98 and a 128-row ancestry gives 128
// blocks. Every thread first starts cp.async copies of its share of the
// block's items, all K source values of each, into a tile that lands while
// the top-k runs; each warp loads a chunk of kChunk candidates, a run of 4
// consecutive ones a lane, in the same round trip. The top-k has no block
// barrier a round, and no round at all: each warp sorts its chunk's order
// words (the value's order key above the complement of the flat index) by
// a bitonic network over its lanes and keeps the first min(K, 128) above
// -inf as a list in shared memory, with the chunk's lowest index holding
// -inf beside it. After one barrier each listed candidate's place is the
// count of listed words above its own, so the first K places are the
// twin's rounds; from the first round whose maximum is -inf on, each round
// takes the twin's -inf rule: the lower of the lowest index holding -inf
// and the lowest index chosen before. NaN is never chosen. Warp 0 then
// runs the bookkeeping lane-parallel over K (32 hypotheses a trip):
// ballots and warp maxima for the ended count, the step's best and its
// first slot, any alive; the running best and end detection. After one
// more barrier every thread writes its share of the block's items from the
// tile, consecutive threads on consecutive addresses. Five block barriers
// in all, whatever K. Past 8 chunks (1024 candidates) the warps take
// further chunks in turn, loading each when they come to it. Shared memory
// holds the tile (8 bytes a source value), 24 bytes a list entry (at most
// 128 a chunk), ~40 bytes a hypothesis and each warp's 512-byte place
// map; where the tile of kWideItems items does not fit, a block takes
// fewer items, and the launch refuses what does not fit a block's 227 KB
// with one item (some 9,000 candidates at K >= 128).
#include <string.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // a block; warp 0 runs the top-k
constexpr int kItems = 1;      // columns or ancestry rows a thread
constexpr int kMaxCand = 128;  // K * (S'+1): 4 a lane of warp 0
constexpr int kMaxK = 16;
constexpr unsigned kFull = 0xffffffffu;
// 1: thread 0 of block (0, 0) marks the end of each phase in trace_marks
// (either kernel's), for tools/bookkeeping_apply_variants.py; 0 (shipped):
// no marks
constexpr int kTrace = 0;
constexpr int kMarks = 7;

// the SM clock (row 0) and the global timer in ns (row 1) at each mark:
// entry, the item loads issued, the candidates' loads consumed, the k
// rounds, the bookkeeping, the block's barrier, the item stores issued
__device__ long long trace_marks[2][kMarks];

__device__ __forceinline__ void mark(int at) {
  if constexpr (kTrace != 0) {
    if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {
      long long clk, ns;
      asm volatile("mov.u64 %0, %%clock64;" : "=l"(clk)::"memory");
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns)::"memory");
      trace_marks[0][at] = clk;
      trace_marks[1][at] = ns;
    }
  }
}

struct Ptrs {
  // inputs
  const long long* __restrict__ xlens;      // (B,)
  const float* __restrict__ dec_top;        // (B, K, S')
  const float* __restrict__ dec_eos;        // (B, K)
  const float* __restrict__ psi_cand;       // (B, K, S'), null without CTC
  const float* __restrict__ psi_eos;        // (B, K), null without CTC
  const float* __restrict__ ctc_s;          // (B, K), null without CTC
  const long long* __restrict__ part_ids;   // (B, K, S')
  const float* __restrict__ score;          // (B, K)
  const unsigned char* __restrict__ alive;  // (B, K) bool
  const unsigned char* __restrict__ stop;   // (B,) bool
  const long long* __restrict__ yseq;       // (B, K, L)
  const long long* __restrict__ anc;        // (S, B, K)
  const float* __restrict__ ended_best;     // (B, L)
  const long long* __restrict__ ended_cnt;  // (B, L)
  const float* __restrict__ best_score;     // (B,)
  const long long* __restrict__ best_yseq;  // (B, L)
  const long long* __restrict__ best_len;   // (B,)
  // outputs, in the order of beam_update.py _OUT
  long long* __restrict__ token;            // (B, K)
  long long* __restrict__ prev;             // (B, K)
  long long* __restrict__ slot;             // (B, K)
  float* __restrict__ psi_sel;              // (B, K)
  float* __restrict__ score_o;              // (B, K)
  unsigned char* __restrict__ alive_o;      // (B, K)
  long long* __restrict__ yseq_o;           // (B, K, L)
  long long* __restrict__ anc_o;            // (S, B, K)
  float* __restrict__ ended_best_o;         // (B, L)
  long long* __restrict__ ended_cnt_o;      // (B, L)
  float* __restrict__ best_score_o;         // (B,)
  long long* __restrict__ best_yseq_o;      // (B, L)
  long long* __restrict__ best_len_o;       // (B,)
  unsigned char* __restrict__ stop_o;       // (B,)
};

struct Dims {
  int i;  // the step: read from `step` in device memory as the kernel starts
  int b, k, sp, l, s, eos, m_end, use_ctc;
  float w_dec, w_ctc, neg, d_end;
  int items;  // the wide kernel's columns or ancestry rows a block
};

// v[j] for a j < KM known only at run time, without indexing registers
template <int KM>
__device__ __forceinline__ long long pick(const long long (&v)[KM], int j) {
  long long out = v[0];
#pragma unroll
  for (int q = 1; q < KM; ++q)
    if (q == j) out = v[q];
  return out;
}

// KM: the most hypotheses the instantiation holds in registers (K <= KM)
template <int KM>
__global__ void __launch_bounds__(kThreads)
    beam_update_kernel(const Ptrs p, const Dims dims,
                       const int* __restrict__ step) {
  // the step from device memory (a captured launch reads each replay's)
  Dims d = dims;
  d.i = max(__ldg(step), 0);
  __shared__ float cand_w[kMaxCand];
  __shared__ long long cand_tok[kMaxCand];
  __shared__ float cand_psi[kMaxCand];
  __shared__ int prev_s[KM];
  __shared__ long long tok_s[KM];
  __shared__ float step_best_s;
  __shared__ int best_slot_s, better_s, n_ended_s;

  mark(0);
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int k = d.k, sp = d.sp, c = sp + 1, nc = k * c, ll = d.l;
  const size_t bk = static_cast<size_t>(b) * k;
  const size_t row = static_cast<size_t>(b) * ll;

  // 1. every load, issued before any dependent work. This thread's items:
  //    e < L a column of the token buffers, the best row and the ended
  //    statistics; L <= e < L + S a row of the ancestry. All K source rows
  //    of each, since `prev` is not known yet.
  const long long xlen = p.xlens[b];
  const bool stopped = p.stop[b];
  long long src[kItems][KM] = {}, best_row[kItems] = {};
  long long cnt_row[kItems] = {};
  float eb_row[kItems] = {};
  int item[kItems];
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int e = (u * gridDim.y + blockIdx.y) * kThreads + tid;
    item[u] = e;
    if (e < ll) {
#pragma unroll
      for (int j = 0; j < KM; ++j)
        if (j < k) src[u][j] = p.yseq[(bk + j) * ll + e];
      best_row[u] = p.best_yseq[row + e];
      eb_row[u] = p.ended_best[row + e];
      cnt_row[u] = p.ended_cnt[row + e];
    } else if (e < ll + d.s) {
      const size_t base = (static_cast<size_t>(e - ll) * d.b + b) * k;
#pragma unroll
      for (int j = 0; j < KM; ++j)
        if (j < k) src[u][j] = p.anc[base + j];
    }
  }
  mark(1);
  const bool lane_active = !stopped && d.i < xlen;
  const bool forced = d.i >= xlen - 1;

  // 2. warp 0: the candidates f = lane + 32t, the top-k, the bookkeeping
  if (tid < 32) {
    // the candidates' operands, loaded before any of them is used; lane
    // r < K: hypothesis r's score and alive, for the freeze; lane mm <
    // m_end: end detection's column max(i - mm - 2, 0) (any beyond the
    // first 32 after the top-k)
    float dec[4], psi[4] = {}, ctc[4] = {}, sc[4];
    long long ctok[4];
    bool live[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int f = lane + 32 * t;
      if (f >= nc) continue;
      const int j = f / c, q = f % c;
      const bool eos_slot = q == sp;
      const size_t at = (bk + j) * sp + q;
      dec[t] = eos_slot ? p.dec_eos[bk + j] : p.dec_top[at];
      if (d.use_ctc) {
        psi[t] = eos_slot ? p.psi_eos[bk + j] : p.psi_cand[at];
        ctc[t] = p.ctc_s[bk + j];
      }
      sc[t] = p.score[bk + j];
      live[t] = p.alive[bk + j];
      ctok[t] = eos_slot ? static_cast<long long>(d.eos) : p.part_ids[at];
    }
    const float score_r = lane < k ? p.score[bk + lane] : 0.0f;
    const bool alive_r = lane < k && p.alive[bk + lane];
    const float best_in = p.best_score[b];
    const long long best_len_in = p.best_len[b];
    const int col0 = max(d.i - lane - 2, 0);
    const long long cnt0 = lane < d.m_end ? p.ended_cnt[row + col0] : 0;
    const float eb0 = lane < d.m_end ? p.ended_best[row + col0] : 0.0f;

    // eos among hypothesis j's pre-beam ids: bits of the 128 flat indices
    // whose pre-beam id is eos, tested over [j (S'+1), j (S'+1) + S')
    unsigned eos_at[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int f = lane + 32 * t;
      eos_at[t] =
          __ballot_sync(kFull, f < nc && f % c != sp && ctok[t] == d.eos);
    }
    auto eos_among = [&](int lo, int hi) {
      bool any = false;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int a = max(lo - 32 * t, 0), z = min(hi - 32 * t, 32);
        if (a < z)
          any |= (eos_at[t] & (z == 32 ? ~0u : (1u << z) - 1) &
                  ~((1u << a) - 1)) != 0;
      }
      return any;
    };

    unsigned key[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int f = lane + 32 * t;
      key[t] = 0u;  // below every value's key: never chosen
      if (f >= nc) continue;
      const int j = f / c;
      // the unfused step's order: w_dec*dec (+ w_ctc*(psi - s)), the
      // eos-slot dedup, + score, dead lanes to neg
      float wv = __fmul_rn(d.w_dec, dec[t]);
      if (d.use_ctc)
        wv = __fadd_rn(wv, __fmul_rn(d.w_ctc, __fsub_rn(psi[t], ctc[t])));
      if (f - j * c == sp && eos_among(j * c, j * c + sp)) wv = d.neg;
      wv = __fadd_rn(wv, sc[t]);
      if (!live[t]) wv = d.neg;
      cand_w[f] = wv;
      cand_tok[f] = ctok[t];
      cand_psi[f] = psi[t];
      key[t] = avsr::order_key(wv);
    }

    mark(2);
    // k rounds: the largest key, then the lowest flat index holding it;
    // that candidate then holds -inf. Lane r keeps round r's index.
    const unsigned neg_inf = avsr::order_key(-INFINITY);
    int sel_r = 0;
    bool inf_round_r = false;
    for (int r = 0; r < k; ++r) {
      unsigned kb = key[0];
      int tb = 0;
#pragma unroll
      for (int t = 1; t < 4; ++t)
        if (key[t] > kb) {
          kb = key[t];
          tb = t;
        }
      const unsigned mk = __reduce_max_sync(kFull, kb);
      const unsigned sel =
          __reduce_min_sync(kFull, kb == mk ? lane + 32 * tb : 0xffffffffu);
      if (lane == static_cast<int>(sel & 31)) {
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (t == static_cast<int>(sel >> 5)) key[t] = neg_inf;
      }
      if (lane == r) {
        sel_r = static_cast<int>(sel);
        inf_round_r = mk == neg_inf;
      }
    }
    __syncwarp();

    // lane r < K: round r's candidate; a round whose maximum is -inf
    // scores -inf whatever its index held before it was chosen
    mark(3);
    const bool mine = lane < k;
    const int pj = sel_r / c;
    const float top = inf_round_r ? -INFINITY : cand_w[sel_r];
    const long long tok = cand_tok[sel_r];
    const bool ended = mine && (tok == d.eos || forced) && lane_active;
    const int n_ended = __popc(__ballot_sync(kFull, ended));
    const float step_best =
        avsr::warp_max(mine ? (ended ? top : d.neg) : -INFINITY);
    const unsigned at_best = __ballot_sync(
        kFull, mine && (ended ? top : d.neg) == step_best);
    const int best_slot = at_best ? __ffs(at_best) - 1 : 0;
    const bool better = step_best > best_in && lane_active;
    const float best_score = better ? step_best : best_in;
    const bool alive_new = !ended && lane_active;
    const bool alive_o = lane_active ? alive_new : alive_r;
    const bool any_alive = __ballot_sync(kFull, mine && alive_o) != 0;

    // end detection on the updated statistics (column i is this step's)
    int count = 0;
    for (int m0 = 0; m0 < d.m_end; m0 += 32) {
      const int mm = m0 + lane;
      const int j = d.i - mm - 2;
      const int jc = j > 0 ? j : 0;
      long long cnt = cnt0;
      float eb = eb0;
      if (m0 > 0) {
        cnt = mm < d.m_end ? p.ended_cnt[row + jc] : 0;
        eb = mm < d.m_end ? p.ended_best[row + jc] : 0.0f;
      }
      if (jc == d.i) {
        cnt += n_ended;
        eb = fmaxf(eb, step_best);
      }
      const bool ok = j >= 0 && cnt > 0;
      const bool worse = __fsub_rn(eb, best_score) < d.d_end;
      count += __popc(__ballot_sync(kFull, mm < d.m_end && ok && worse));
    }
    const bool newly = count >= d.m_end || !any_alive;

    if (mine) {
      prev_s[lane] = pj;
      tok_s[lane] = tok;
      if (blockIdx.y == 0) {
        p.token[bk + lane] = tok;
        p.prev[bk + lane] = pj;
        p.slot[bk + lane] = sel_r - pj * c;
        p.psi_sel[bk + lane] = cand_psi[sel_r];
        p.score_o[bk + lane] =
            lane_active ? (alive_new ? top : d.neg) : score_r;
        p.alive_o[bk + lane] = alive_o;
      }
    }
    if (lane == 0) {
      step_best_s = step_best;
      best_slot_s = best_slot;
      better_s = better;
      n_ended_s = n_ended;
      if (blockIdx.y == 0) {
        p.best_score_o[b] = best_score;
        p.best_len_o[b] = better ? d.i + (forced ? 3 : 2) : best_len_in;
        p.stop_o[b] = stopped || (newly && lane_active);
      }
    }
  }
  mark(4);
  __syncthreads();
  mark(5);

  // 3. this thread's items from registers: token buffers (the source row
  //    prev[j], then this step's writes), the best row, the ended
  //    statistics, the ancestry
  int prev[KM];
  long long toks[KM];
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    prev[j] = j < k ? prev_s[j] : 0;
    toks[j] = j < k ? tok_s[j] : 0;
  }
  const int bs = best_slot_s;
  auto successor = [&](const long long (&v)[KM], int pj, long long tok,
                       int l) {
    long long out = pick<KM>(v, pj);
    if (l == d.i + 1) out = tok;
    if (l == d.i + 2 && forced) out = d.eos;
    return out;
  };
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int e = item[u];
    if (e < ll) {
#pragma unroll
      for (int j = 0; j < KM; ++j)
        if (j < k)
          p.yseq_o[(bk + j) * ll + e] =
              lane_active ? successor(src[u], prev[j], toks[j], e)
                          : src[u][j];
      p.best_yseq_o[row + e] =
          better_s ? successor(src[u], prev_s[bs], tok_s[bs], e)
                   : best_row[u];
      p.ended_best_o[row + e] =
          e == d.i ? fmaxf(eb_row[u], step_best_s) : eb_row[u];
      p.ended_cnt_o[row + e] = cnt_row[u] + (e == d.i ? n_ended_s : 0);
    } else if (e < ll + d.s) {
      const size_t base = (static_cast<size_t>(e - ll) * d.b + b) * k;
#pragma unroll
      for (int j = 0; j < KM; ++j)
        if (j < k) p.anc_o[base + j] = pick<KM>(src[u], prev[j]);
    }
  }
  mark(6);
}

constexpr int kWideThreads = 256;  // a block of the wide kernel
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWidePer = 4;             // candidates a lane holds of a chunk
constexpr int kChunk = 32 * kWidePer;   // candidates a warp's list covers
constexpr int kLogChunk = 7;
static_assert(kChunk == 1 << kLogChunk, "a chunk is sorted by a network");
constexpr int kWideItems = 64;  // columns or ancestry rows a block, at most
// a block's shared memory on sm_90, less the wide kernel's static part
constexpr int kMaxSmem = 232448 - 1024;

// The wide kernel's dynamic shared memory, in bytes from its start: the
// block's item tile (K source values of each of `items` columns or
// ancestry rows; the best row, the ended count and best of each column),
// the chunks' lists (kc = min(K, kChunk) entries each: order word, value,
// psi, token) and their -inf records, the K chosen entries, the
// hypotheses' arrays, and each warp's list places of its chunk's
// candidates. 8-byte members first.
struct WideLayout {
  size_t tile, best, cnt, lw, ltok, itok, stok, tok;  // 8 bytes
  size_t eb, lv, lpsi, ln, ifl, ipsi, sv, sf, spsi, score, es, prev, place;
  size_t alive, dup;  // bytes
  size_t total;
};

// the offset of a member of `bytes`, and the next one's
__host__ __device__ inline size_t take(size_t& at, size_t bytes) {
  const size_t field = at;
  at += bytes;
  return field;
}

__host__ __device__ inline WideLayout wide_layout(int k, int nc, int items) {
  const size_t kk = k, n = (nc + kChunk - 1) / kChunk;
  const size_t nl = n * (k < kChunk ? kk : kChunk), w = items;
  WideLayout a;
  size_t at = 0;
  a.tile = take(at, 8 * kk * w);
  a.best = take(at, 8 * w);
  a.cnt = take(at, 8 * w);
  a.lw = take(at, 8 * nl);
  a.ltok = take(at, 8 * nl);
  a.itok = take(at, 8 * n);
  a.stok = take(at, 8 * kk);
  a.tok = take(at, 8 * kk);
  a.eb = take(at, 4 * w);
  a.lv = take(at, 4 * nl);
  a.lpsi = take(at, 4 * nl);
  a.ln = take(at, 4 * n);
  a.ifl = take(at, 4 * n);
  a.ipsi = take(at, 4 * n);
  a.sv = take(at, 4 * kk);
  a.sf = take(at, 4 * kk);
  a.spsi = take(at, 4 * kk);
  a.score = take(at, 4 * kk);
  a.es = take(at, 4 * kk);
  a.prev = take(at, 4 * kk);
  a.place = take(at, 4 * kWideWarps * kChunk);
  a.alive = take(at, kk);
  a.dup = take(at, kk);
  a.total = at;
  return a;
}

// a word in the top-k's order, larger first: the value's order key, then
// the lower flat index; 0 for no candidate
__device__ __forceinline__ unsigned long long order_word(unsigned key,
                                                         int f) {
  return static_cast<unsigned long long>(key) << 32 |
         (0xffffffffu - static_cast<unsigned>(f));
}

// a chunk's candidates f = ch * kChunk + kWidePer * lane + t (a lane's
// run of consecutive indices), in registers, as loaded: each value through
// a pointer chosen first, so that no select waits for a load and every
// load of the chunk is in flight at once; the eos slot's id is the
// hypothesis' last pre-beam id until it is used; hypothesis j and slot q
// of each (q < 0: past the candidates)
struct Chunk {
  float dec[kWidePer] = {}, psi[kWidePer] = {}, ctc[kWidePer] = {};
  float sc[kWidePer] = {};
  long long tok[kWidePer] = {};
  unsigned char live[kWidePer] = {};
  int j[kWidePer] = {}, q[kWidePer] = {};
};

struct Cands {  // the candidates' operands
  const float *dec_top, *dec_eos, *psi_cand, *psi_eos, *ctc_s, *score;
  const unsigned char* alive;
  const long long* part_ids;
  int sp, nc, use_ctc;
};

__device__ __forceinline__ void load_chunk(Chunk& x, const Cands a,
                                           size_t bk, int ch, int lane) {
  const int c = a.sp + 1, f0 = ch * kChunk + kWidePer * lane;
  int j = f0 / c, q = f0 - j * c;
#pragma unroll
  for (int t = 0; t < kWidePer; ++t, ++q) {
    if (q == c) {
      ++j;
      q = 0;
    }
    x.j[t] = j;
    x.q[t] = f0 + t < a.nc ? q : -1;
    if (f0 + t >= a.nc) continue;
    const bool eos_slot = q == a.sp;
    const size_t at = (bk + j) * a.sp + (eos_slot ? a.sp - 1 : q);
    x.dec[t] = *(eos_slot ? a.dec_eos + bk + j : a.dec_top + at);
    if (a.use_ctc) {
      x.psi[t] = *(eos_slot ? a.psi_eos + bk + j : a.psi_cand + at);
      x.ctc[t] = a.ctc_s[bk + j];
    }
    x.sc[t] = a.score[bk + j];
    x.live[t] = a.alive[bk + j];
    x.tok[t] = a.part_ids[at];
  }
}

__global__ void __launch_bounds__(kWideThreads)
    beam_update_wide_kernel(const Ptrs p, const Dims dims,
                            const int* __restrict__ step) {
  // the step from device memory (a captured launch reads each replay's)
  Dims d = dims;
  d.i = max(__ldg(step), 0);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float step_best_s;
  __shared__ int best_slot_s, better_s, n_ended_s;
  __shared__ long long f0_tok;  // candidate 0's token and psi: the -inf
  __shared__ float f0_psi;      // rule's fallback where nothing is -inf

  mark(0);
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5;
  const int k = d.k, sp = d.sp, c = sp + 1, nc = k * c, ll = d.l;
  const int w_items = d.items;
  const int nchunk = (nc + kChunk - 1) / kChunk;
  const int kc = min(k, kChunk);
  const size_t bk = static_cast<size_t>(b) * k;
  const size_t row = static_cast<size_t>(b) * ll;
  const WideLayout lay = wide_layout(k, nc, w_items);
  long long* tile = reinterpret_cast<long long*>(smem + lay.tile);
  long long* best = reinterpret_cast<long long*>(smem + lay.best);
  long long* cnt = reinterpret_cast<long long*>(smem + lay.cnt);
  unsigned long long* lw =
      reinterpret_cast<unsigned long long*>(smem + lay.lw);
  long long* ltok = reinterpret_cast<long long*>(smem + lay.ltok);
  long long* itok = reinterpret_cast<long long*>(smem + lay.itok);
  long long* stok = reinterpret_cast<long long*>(smem + lay.stok);
  long long* tok_s = reinterpret_cast<long long*>(smem + lay.tok);
  float* eb = reinterpret_cast<float*>(smem + lay.eb);
  float* lv = reinterpret_cast<float*>(smem + lay.lv);
  float* lpsi = reinterpret_cast<float*>(smem + lay.lpsi);
  int* ln = reinterpret_cast<int*>(smem + lay.ln);
  int* ifl = reinterpret_cast<int*>(smem + lay.ifl);
  float* ipsi = reinterpret_cast<float*>(smem + lay.ipsi);
  float* sv = reinterpret_cast<float*>(smem + lay.sv);
  int* sf = reinterpret_cast<int*>(smem + lay.sf);
  float* spsi = reinterpret_cast<float*>(smem + lay.spsi);
  float* score_s = reinterpret_cast<float*>(smem + lay.score);
  float* es_s = reinterpret_cast<float*>(smem + lay.es);
  int* prev_s = reinterpret_cast<int*>(smem + lay.prev);
  int* place = reinterpret_cast<int*>(smem + lay.place) + warp * kChunk;
  unsigned char* alive_s = smem + lay.alive;
  unsigned char* dup = smem + lay.dup;

  // 1. this block's items (e0 <= e < e1: columns e < L of the token
  //    buffers, the best row and the ended statistics, then rows e - L of
  //    the ancestry) copied into the tile, all K source values of each
  //    since `prev` is not known yet; the copies land while the top-k runs
  const int e0 = blockIdx.y * w_items;
  const int e1 = min(e0 + w_items, ll + d.s);
  const int cols = max(0, min(e1, ll) - e0);
  const int a0 = max(e0, ll) - ll, arows = max(0, e1 - max(e0, ll));
  for (int j = warp; j < k; j += kWideWarps)
    for (int u = lane; u < cols; u += 32)
      avsr::cp_async8(tile + j * w_items + u,
                      p.yseq + (bk + j) * ll + e0 + u);
  for (int u = tid; u < cols; u += kWideThreads) {
    avsr::cp_async8(best + u, p.best_yseq + row + e0 + u);
    avsr::cp_async8(cnt + u, p.ended_cnt + row + e0 + u);
    avsr::cp_async4(eb + u, p.ended_best + row + e0 + u);
  }
  for (int u = warp; u < arows; u += kWideWarps)
    for (int j = lane; j < k; j += 32)
      avsr::cp_async8(tile + j * w_items + cols + u,
                      p.anc + (static_cast<size_t>(a0 + u) * d.b + b) * k +
                          j);
  avsr::cp_async_commit();

  // the scalars, and warp 0's end-detection columns max(i - lane - 2, 0)
  const long long xlen = p.xlens[b];
  const bool stopped = p.stop[b];
  const bool lane_active = !stopped && d.i < xlen;
  const bool forced = d.i >= xlen - 1;
  float best_in = 0.0f, eb0 = 0.0f;
  long long best_len_in = 0, cnt0 = 0;
  if (warp == 0) {
    best_in = p.best_score[b];
    best_len_in = p.best_len[b];
    const int col0 = max(d.i - lane - 2, 0);
    if (lane < d.m_end) {
      cnt0 = p.ended_cnt[row + col0];
      eb0 = p.ended_best[row + col0];
    }
  }

  // 2. the candidates of this warp's first chunk, in the same round trip
  const Cands ops{p.dec_top, p.dec_eos, p.psi_cand, p.psi_eos, p.ctc_s,
                  p.score,   p.alive,   p.part_ids, sp,       nc,
                  d.use_ctc};
  Chunk cand;
  if (warp < nchunk) load_chunk(cand, ops, bk, warp, lane);
  mark(1);

  // eos among hypothesis j's pre-beam ids: flags cleared while the loads
  // are in flight, then set from the ids (chunks past the first pass read
  // theirs)
  for (int j = tid; j < k; j += kWideThreads) dup[j] = 0;
  __syncthreads();
  if (warp < nchunk) {
#pragma unroll
    for (int t = 0; t < kWidePer; ++t)
      if (cand.q[t] >= 0 && cand.q[t] != sp && cand.tok[t] == d.eos)
        dup[cand.j[t]] = 1;
  }
  for (int f = kWideWarps * kChunk + tid; f < nc; f += kWideThreads) {
    const int j = f / c, q = f - j * c;
    if (q != sp && p.part_ids[(bk + j) * sp + q] == d.eos) dup[j] = 1;
  }
  __syncthreads();
  mark(2);

  // 3. each chunk: the weights, in the unfused step's order (w_dec*dec
  //    (+ w_ctc*(psi - s)), the eos-slot dedup, + score, dead lanes to
  //    neg), then the chunk's order words (the value's order key above
  //    the complement of the flat index: larger first, then the lower
  //    index) sorted by a bitonic network over the warp, 4 a lane (the
  //    strides below 4 in registers, the others by __shfl_xor_sync); its
  //    first min(K, 128) words above 0 are its list, each candidate's
  //    value, psi and token written by its own lane at its place. Only
  //    values above -inf enter the list (NaN never); the chunk's lowest
  //    index holding -inf is kept beside it.
  for (int ch = warp; ch < nchunk; ch += kWideWarps) {
    if (ch != warp) load_chunk(cand, ops, bk, ch, lane);
    unsigned long long word[kWidePer];
    float wv[kWidePer], ps[kWidePer];
    long long tk[kWidePer];
    int lowest = INT_MAX;
#pragma unroll
    for (int t = 0; t < kWidePer; ++t) {
      const int f = ch * kChunk + kWidePer * lane + t;
      const int j = cand.j[t], q = cand.q[t];
      word[t] = 0ull;  // never chosen
      wv[t] = 0.0f;
      ps[t] = cand.psi[t];
      tk[t] = cand.tok[t];
      if (q < 0) continue;
      float w = __fmul_rn(d.w_dec, cand.dec[t]);
      if (d.use_ctc)
        w = __fadd_rn(w, __fmul_rn(d.w_ctc,
                                   __fsub_rn(cand.psi[t], cand.ctc[t])));
      if (q == sp) {
        if (dup[j]) w = d.neg;
        tk[t] = d.eos;
        score_s[j] = cand.sc[t];
        alive_s[j] = cand.live[t];
      }
      w = __fadd_rn(w, cand.sc[t]);
      if (!cand.live[t]) w = d.neg;
      wv[t] = w;
      if (w == -INFINITY) lowest = min(lowest, f);
      if (w == w && w != -INFINITY)
        word[t] = order_word(avsr::order_key(w), f);
    }
    if (ch == 0 && lane == 0) {
      f0_tok = tk[0];
      f0_psi = ps[0];
    }
    const int inf_f = __reduce_min_sync(kFull, lowest);
    if (lane == 0) ifl[ch] = inf_f;
    if (inf_f != INT_MAX && (inf_f - ch * kChunk) / kWidePer == lane) {
      const int ti = (inf_f - ch * kChunk) % kWidePer;
#pragma unroll
      for (int t = 0; t < kWidePer; ++t)
        if (t == ti) {
          itok[ch] = tk[t];
          ipsi[ch] = ps[t];
        }
    }
    unsigned long long* w_out = lw + ch * kc;
#pragma unroll
    for (int t = 0; t < kWidePer; ++t) place[kWidePer * lane + t] = kc;
#pragma unroll
    for (int ls = 1; ls <= kLogChunk; ++ls) {
#pragma unroll
      for (int lt = ls - 1; lt >= 0; --lt) {
        const int size = 1 << ls, stride = 1 << lt;
#pragma unroll
        for (int t = 0; t < kWidePer; ++t) {
          // element e = kWidePer * lane + t, partner e ^ stride; a run
          // whose bit `size` is 0 ends descending
          const bool desc = ((kWidePer * lane + t) & size) == 0;
          if (stride < kWidePer) {
            const int x = t | stride;
            if (!(t & stride) && (word[x] > word[t]) == desc) {
              const unsigned long long tw = word[t];
              word[t] = word[x];
              word[x] = tw;
            }
          } else {
            const int m = stride / kWidePer;
            const unsigned long long other =
                __shfl_xor_sync(kFull, word[t], m);
            const bool larger = ((lane & m) == 0) == desc;
            if (larger ? other > word[t] : other < word[t]) word[t] = other;
          }
        }
      }
    }
    int n = 0;
#pragma unroll
    for (int t = 0; t < kWidePer; ++t)
      n += __popc(__ballot_sync(kFull, word[t] != 0ull));
    n = min(n, kc);
    __syncwarp();
#pragma unroll
    for (int t = 0; t < kWidePer; ++t) {
      const int at = kWidePer * lane + t;
      if (at < n) {
        w_out[at] = word[t];
        const int f = static_cast<int>(0xffffffffu -
                                       static_cast<unsigned>(word[t]));
        place[f - ch * kChunk] = at;
      }
    }
    __syncwarp();
    float* v_out = lv + ch * kc;
    float* psi_out = lpsi + ch * kc;
    long long* tok_out = ltok + ch * kc;
#pragma unroll
    for (int t = 0; t < kWidePer; ++t) {
      const int at = place[kWidePer * lane + t];
      if (at < n) {
        v_out[at] = wv[t];
        psi_out[at] = ps[t];
        tok_out[at] = tk[t];
      }
    }
    __syncwarp();
    if (lane == 0) ln[ch] = n;
    for (int m = n + lane; m < kc; m += 32) w_out[m] = 0ull;  // no entry
  }
  __syncthreads();
  mark(3);

  // 4. each listed candidate's place: the count of listed candidates
  //    ahead of it in the order (independent loads, no early exit); the
  //    first K places are the top-k's rounds in order
  const int listed_slots = nchunk * kc;
  for (int x = tid; x < listed_slots; x += kWideThreads) {
    const unsigned long long mine = lw[x];
    if (mine == 0ull) continue;
    int part[4] = {};  // four sums, so the adds do not wait on each other
    int y = 0;
    for (; y + 4 <= listed_slots; y += 4) {
#pragma unroll
      for (int z = 0; z < 4; ++z) part[z] += lw[y + z] > mine;
    }
    for (; y < listed_slots; ++y) part[0] += lw[y] > mine;
    const int rank = part[0] + part[1] + part[2] + part[3];
    if (rank < k) {
      sv[rank] = lv[x];
      sf[rank] = static_cast<int>(0xffffffffu - static_cast<unsigned>(mine));
      spsi[rank] = lpsi[x];
      stok[rank] = ltok[x];
    }
  }
  __syncthreads();
  mark(4);

  // 5. warp 0: hypothesis r in lane r (32 a trip): round r's candidate,
  //    retirement, and over K with ballots and warp maxima the ended
  //    count, the step's best and its first slot, any alive; then the
  //    running best and end detection
  if (warp == 0) {
    int listed = 0, jf = INT_MAX;
    for (int ch = lane; ch < nchunk; ch += 32) {
      listed += ln[ch];
      jf = min(jf, ifl[ch]);
    }
    listed = __reduce_add_sync(kFull, listed);
    const int n_valid = min(k, listed);
    // where fewer than K are listed, the -inf rule's index: the lower of
    // the lowest index holding -inf and the lowest index chosen, with its
    // token and psi
    long long jtok = f0_tok;
    float jpsi = f0_psi;
    if (n_valid < k) {
      for (int r = lane; r < n_valid; r += 32) jf = min(jf, sf[r]);
      jf = __reduce_min_sync(kFull, jf);
    }
    if (n_valid == k) {
      jf = 0;  // no round takes the rule
    } else if (jf == INT_MAX) {
      jf = 0;  // every candidate NaN: no rule applies
    } else {
      int from = -1;  // a chunk's -inf record, or a round (+nchunk)
      for (int ch = lane; ch < nchunk; ch += 32)
        if (ifl[ch] == jf) from = ch;
      for (int r = lane; r < n_valid; r += 32)
        if (sf[r] == jf) from = nchunk + r;
      from = __reduce_max_sync(kFull, from);
      jtok = from < nchunk ? itok[from] : stok[from - nchunk];
      jpsi = from < nchunk ? ipsi[from] : spsi[from - nchunk];
    }

    int n_ended = 0;
    float step_best = -INFINITY;
    bool any_alive = false;
    for (int r0 = 0; r0 < k; r0 += 32) {
      const int r = r0 + lane;
      const bool mine = r < k;
      const bool listed_r = r < n_valid;
      const int f = listed_r ? sf[r] : jf;
      // a round whose maximum is -inf scores -inf
      const float top = listed_r ? sv[r] : -INFINITY;
      const long long tok = listed_r ? stok[r] : jtok;
      const int pj = f / c;
      const bool ended = mine && (tok == d.eos || forced) && lane_active;
      const float es = ended ? top : d.neg;
      n_ended += __popc(__ballot_sync(kFull, ended));
      step_best = fmaxf(step_best, avsr::warp_max(mine ? es : -INFINITY));
      const bool alive_new = !ended && lane_active;
      const bool alive_o = lane_active ? alive_new : (mine && alive_s[r]);
      any_alive |= __ballot_sync(kFull, mine && alive_o) != 0;
      if (mine) {
        prev_s[r] = pj;
        tok_s[r] = tok;
        es_s[r] = es;
        if (blockIdx.y == 0) {
          p.token[bk + r] = tok;
          p.prev[bk + r] = pj;
          p.slot[bk + r] = f - pj * c;
          p.psi_sel[bk + r] = listed_r ? spsi[r] : jpsi;
          p.score_o[bk + r] =
              lane_active ? (alive_new ? top : d.neg) : score_s[r];
          p.alive_o[bk + r] = alive_o;
        }
      }
    }
    int best_slot = 0;
    for (int r0 = 0; r0 < k; r0 += 32) {
      const int r = r0 + lane;
      const unsigned at_best = __ballot_sync(kFull, r < k &&
                                                        es_s[r] == step_best);
      if (at_best) {
        best_slot = r0 + __ffs(at_best) - 1;
        break;
      }
    }
    const bool better = step_best > best_in && lane_active;
    const float best_score = better ? step_best : best_in;

    // end detection on the updated statistics (column i is this step's)
    int count = 0;
    for (int m0 = 0; m0 < d.m_end; m0 += 32) {
      const int mm = m0 + lane;
      const int j = d.i - mm - 2;
      const int jc = j > 0 ? j : 0;
      long long cn = cnt0;
      float e = eb0;
      if (m0 > 0) {
        cn = mm < d.m_end ? p.ended_cnt[row + jc] : 0;
        e = mm < d.m_end ? p.ended_best[row + jc] : 0.0f;
      }
      if (jc == d.i) {
        cn += n_ended;
        e = fmaxf(e, step_best);
      }
      const bool ok = j >= 0 && cn > 0;
      const bool worse = __fsub_rn(e, best_score) < d.d_end;
      count += __popc(__ballot_sync(kFull, mm < d.m_end && ok && worse));
    }
    const bool newly = count >= d.m_end || !any_alive;
    if (lane == 0) {
      step_best_s = step_best;
      best_slot_s = best_slot;
      better_s = better;
      n_ended_s = n_ended;
      if (blockIdx.y == 0) {
        p.best_score_o[b] = best_score;
        p.best_len_o[b] = better ? d.i + (forced ? 3 : 2) : best_len_in;
        p.stop_o[b] = stopped || (newly && lane_active);
      }
    }
  }
  mark(5);
  avsr::cp_async_wait<0>();
  __syncthreads();

  // 6. this block's items from the tile: the token buffers (the source row
  //    prev[j], then this step's writes), the best row, the ended
  //    statistics, the ancestry; consecutive threads on consecutive
  //    addresses
  const int bs = best_slot_s;
  auto successor = [&](int j, int u, int e) {
    long long out = tile[prev_s[j] * w_items + u];
    if (e == d.i + 1) out = tok_s[j];
    if (e == d.i + 2 && forced) out = d.eos;
    return out;
  };
  for (int j = warp; j < k; j += kWideWarps)
    for (int u = lane; u < cols; u += 32) {
      const int e = e0 + u;
      p.yseq_o[(bk + j) * ll + e] =
          lane_active ? successor(j, u, e) : tile[j * w_items + u];
    }
  for (int u = tid; u < cols; u += kWideThreads) {
    const int e = e0 + u;
    p.best_yseq_o[row + e] = better_s ? successor(bs, u, e) : best[u];
    p.ended_best_o[row + e] = e == d.i ? fmaxf(eb[u], step_best_s) : eb[u];
    p.ended_cnt_o[row + e] = cnt[u] + (e == d.i ? n_ended_s : 0);
  }
  for (int u = warp; u < arows; u += kWideWarps)
    for (int j = lane; j < k; j += 32)
      p.anc_o[(static_cast<size_t>(a0 + u) * d.b + b) * k + j] =
          tile[prev_s[j] * w_items + cols + u];
  mark(6);
}

}  // namespace

// ptrs: the 17 inputs then the 14 outputs of beam_update.py, in that
// order (the CTC inputs 0 when use_ctc is 0); step: the step i, one int32
// in device memory, read by the kernel (a graph's replays each read theirs).
extern "C" int avsr_beam_update(void* const* ptrs, const int* step, int b,
                                int k, int sp, int l, int s, int eos, int m_end,
                                int use_ctc, float w_dec, float w_ctc,
                                float neg, float d_end, void* stream) {
  if (b <= 0 || k <= 0 || sp <= 0 || l <= 0 || s <= 0 || m_end < 0 ||
      static_cast<long long>(k) * (sp + 1) > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  static_assert(sizeof(Ptrs) == 31 * sizeof(void*), "Ptrs layout");
  Ptrs p;
  memcpy(&p, ptrs, sizeof(Ptrs));
  if (step == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Dims d{0, b, k, sp, l, s, eos, m_end, use_ctc,
         w_dec, w_ctc, neg, d_end, kWideItems};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k > kMaxK || k * (sp + 1) > kMaxCand) {
    // kWideItems items a block, fewer where K source values of each do not
    // fit beside the lists
    size_t smem = wide_layout(k, k * (sp + 1), d.items).total;
    while (smem > kMaxSmem && d.items > 1) {
      d.items /= 2;
      smem = wide_layout(k, k * (sp + 1), d.items).total;
    }
    const long long g = (static_cast<long long>(l) + s + d.items - 1) /
                        d.items;
    if (smem > kMaxSmem || g > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          beam_update_wide_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    beam_update_wide_kernel<<<dim3(b, static_cast<unsigned>(g)),
                              kWideThreads, smem, st>>>(p, d, step);
    return static_cast<int>(cudaGetLastError());
  }
  // blocks an utterance: every column and ancestry row an item
  const long long per = static_cast<long long>(kThreads) * kItems;
  const long long g = (static_cast<long long>(l) + s + per - 1) / per;
  if (g > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(b, static_cast<unsigned>(g));
  if (k <= 4)
    beam_update_kernel<4><<<grid, kThreads, 0, st>>>(p, d, step);
  else
    beam_update_kernel<kMaxK><<<grid, kThreads, 0, st>>>(p, d, step);
  return static_cast<int>(cudaGetLastError());
}

// the last traced launch's marks (2 x 7 int64; zeros where kTrace is 0)
extern "C" int avsr_beam_update_trace(long long* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, trace_marks, sizeof(trace_marks)));
}
