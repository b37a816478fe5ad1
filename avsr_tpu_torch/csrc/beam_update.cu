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
// the same update with a block. Its threads weight the candidates into
// shared memory (the same intrinsics in the same order), then K rounds of
// a block-wide arg-max (avsr::block_best) take, each, the best candidate
// after the previous round's winner in the order "larger value, then
// lower flat index": exactly the twin's rounds, without masking; the first
// round whose best is -inf starts the twin's -inf rule (that round's
// index is the lowest holding -inf, later rounds the lower of it and the
// lowest index chosen before). Hypothesis r's bookkeeping runs in thread
// r, the reductions over K in thread 0, then every thread writes its items
// (columns and ancestry rows), gathering each source row by prev. Shared
// memory grows with K*(S'+1) (4 bytes a candidate and 23 a hypothesis);
// the launch refuses more than a block's 227 KB (some 56,000 candidates). Only right here: making it fast (fewer
// barriers a round, the warp kernel's single memory round trip) is later
// work.
#include <string.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // a block; warp 0 runs the top-k
constexpr int kItems = 1;      // columns or ancestry rows a thread
constexpr int kMaxCand = 128;  // K * (S'+1): 4 a lane of warp 0
constexpr int kMaxK = 16;
constexpr unsigned kFull = 0xffffffffu;
// 1: thread 0 of block (0, 0) marks the end of each phase in trace_marks,
// for tools/bookkeeping_apply_variants.py; 0 (shipped): no marks
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
  int i, b, k, sp, l, s, eos, m_end, use_ctc;
  float w_dec, w_ctc, neg, d_end;
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
    beam_update_kernel(const Ptrs p, const Dims d) {
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
// a block's shared memory on sm_90, less the wide kernel's static arrays
constexpr int kMaxSmem = 232448 - 1024;

// the wide kernel's dynamic shared memory: tok[K] (int64), w[nc] and
// es[K] (fp32), sel[K] and prev[K] (int32), dup[K], ended[K], alive[K]
__host__ __device__ inline size_t wide_smem(int k, int nc) {
  return 8 * static_cast<size_t>(k) + 4 * static_cast<size_t>(nc) +
         4 * static_cast<size_t>(k) + 8 * static_cast<size_t>(k) +
         3 * static_cast<size_t>(k);
}

__global__ void __launch_bounds__(kWideThreads)
    beam_update_wide_kernel(const Ptrs p, const Dims d) {
  extern __shared__ __align__(8) unsigned char smem[];
  __shared__ unsigned skey[kWideThreads / 32];
  __shared__ int sidx[kWideThreads / 32];
  __shared__ float step_best_s;
  __shared__ int best_slot_s, better_s, n_ended_s, c_fin_s;

  const int b = blockIdx.x, tid = threadIdx.x;
  const int k = d.k, sp = d.sp, c = sp + 1, nc = k * c, ll = d.l;
  const size_t bk = static_cast<size_t>(b) * k;
  const size_t row = static_cast<size_t>(b) * ll;
  long long* tok_s = reinterpret_cast<long long*>(smem);
  float* w = reinterpret_cast<float*>(tok_s + k);
  float* es = w + nc;
  int* sel = reinterpret_cast<int*>(es + k);
  int* prev_s = sel + k;
  unsigned char* dup = reinterpret_cast<unsigned char*>(prev_s + k);
  unsigned char* ended_s = dup + k;
  unsigned char* alive_s = ended_s + k;

  const long long xlen = p.xlens[b];
  const bool stopped = p.stop[b];
  const bool lane_active = !stopped && d.i < xlen;
  const bool forced = d.i >= xlen - 1;

  // eos among hypothesis j's pre-beam ids
  for (int j = tid; j < k; j += kWideThreads) {
    bool any = false;
    for (int q = 0; q < sp; ++q) any |= p.part_ids[(bk + j) * sp + q] == d.eos;
    dup[j] = any;
  }
  __syncthreads();
  // the candidates' weights, in the unfused step's order: w_dec*dec
  // (+ w_ctc*(psi - s)), the eos-slot dedup, + score, dead lanes to neg
  for (int f = tid; f < nc; f += kWideThreads) {
    const int j = f / c, q = f - j * c;
    const bool eos_slot = q == sp;
    const size_t at = (bk + j) * sp + q;
    float wv = __fmul_rn(d.w_dec, eos_slot ? p.dec_eos[bk + j] : p.dec_top[at]);
    if (d.use_ctc) {
      const float psi = eos_slot ? p.psi_eos[bk + j] : p.psi_cand[at];
      wv = __fadd_rn(wv, __fmul_rn(d.w_ctc, __fsub_rn(psi, p.ctc_s[bk + j])));
    }
    if (eos_slot && dup[j]) wv = d.neg;
    wv = __fadd_rn(wv, p.score[bk + j]);
    if (!p.alive[bk + j]) wv = d.neg;
    w[f] = wv;
  }
  __syncthreads();

  // K rounds: the best candidate after the previous winner; from the
  // first round whose best is -inf on, the -inf rule
  const unsigned key_neg_inf = avsr::order_key(-INFINITY);
  unsigned pk = 0xffffffffu;
  int pi = -1, lowest = INT_MAX, c_fin = k;
  for (int r = 0; r < k; ++r) {
    unsigned bkey = 0u;  // a NaN's key: "none"
    int bi = INT_MAX;
    for (int f = tid; f < nc; f += kWideThreads) {
      const float wv = w[f];
      if (wv != wv) continue;
      const unsigned key = avsr::order_key(wv);
      if ((key < pk || (key == pk && f > pi)) && key > bkey) {
        bkey = key;
        bi = f;
      }
    }
    avsr::block_best(bkey, bi, skey, sidx);
    if (bkey <= key_neg_inf) {
      const int j = min(bi, lowest);
      for (int q = r + tid; q < k; q += kWideThreads) sel[q] = j;
      c_fin = r;
      break;
    }
    if (tid == 0) sel[r] = bi;
    pk = bkey;
    pi = bi;
    lowest = min(lowest, bi);
  }
  if (tid == 0) c_fin_s = c_fin;
  __syncthreads();

  // hypothesis r in thread r: round r's candidate; a round whose maximum
  // is -inf scores -inf whatever its index held before it was chosen
  for (int r = tid; r < k; r += kWideThreads) {
    const int f = sel[r];
    const int pj = f / c, q = f - pj * c;
    const float top = r >= c_fin_s ? -INFINITY : w[f];
    const long long tok =
        q == sp ? static_cast<long long>(d.eos) : p.part_ids[(bk + pj) * sp + q];
    const bool ended = (tok == d.eos || forced) && lane_active;
    const bool alive_new = !ended && lane_active;
    tok_s[r] = tok;
    prev_s[r] = pj;
    es[r] = ended ? top : d.neg;
    ended_s[r] = ended;
    alive_s[r] = lane_active ? alive_new : p.alive[bk + r];
    if (blockIdx.y == 0) {
      p.token[bk + r] = tok;
      p.prev[bk + r] = pj;
      p.slot[bk + r] = q;
      p.psi_sel[bk + r] =
          d.use_ctc ? (q == sp ? p.psi_eos[bk + pj]
                               : p.psi_cand[(bk + pj) * sp + q])
                    : 0.0f;
      p.score_o[bk + r] =
          lane_active ? (alive_new ? top : d.neg) : p.score[bk + r];
      p.alive_o[bk + r] = alive_s[r];
    }
  }
  __syncthreads();

  // the utterance's reductions over K, retirement, running best and end
  // detection, in thread 0
  if (tid == 0) {
    int n_ended = 0, best_slot = 0;
    float step_best = -INFINITY;
    bool any_alive = false;
    for (int r = 0; r < k; ++r) {
      n_ended += ended_s[r];
      step_best = fmaxf(step_best, es[r]);
      any_alive |= alive_s[r] != 0;
    }
    for (int r = k - 1; r >= 0; --r)
      if (es[r] == step_best) best_slot = r;
    const float best_in = p.best_score[b];
    const bool better = step_best > best_in && lane_active;
    const float best_score = better ? step_best : best_in;
    int count = 0;
    for (int mm = 0; mm < d.m_end; ++mm) {
      const int j = d.i - mm - 2;
      const int jc = j > 0 ? j : 0;
      long long cnt = p.ended_cnt[row + jc];
      float eb = p.ended_best[row + jc];
      if (jc == d.i) {
        cnt += n_ended;
        eb = fmaxf(eb, step_best);
      }
      count += j >= 0 && cnt > 0 && __fsub_rn(eb, best_score) < d.d_end;
    }
    const bool newly = count >= d.m_end || !any_alive;
    step_best_s = step_best;
    best_slot_s = best_slot;
    better_s = better;
    n_ended_s = n_ended;
    if (blockIdx.y == 0) {
      p.best_score_o[b] = best_score;
      p.best_len_o[b] = better ? d.i + (forced ? 3 : 2) : p.best_len[b];
      p.stop_o[b] = stopped || (newly && lane_active);
    }
  }
  __syncthreads();

  // this block's items: columns e < L of the token buffers, the best row
  // and the ended statistics; ancestry rows L <= e < L + S
  auto successor = [&](int j, int e) {
    long long out = p.yseq[(bk + prev_s[j]) * ll + e];
    if (e == d.i + 1) out = tok_s[j];
    if (e == d.i + 2 && forced) out = d.eos;
    return out;
  };
  const int stride = gridDim.y * kWideThreads;
  for (int e = blockIdx.y * kWideThreads + tid; e < ll + d.s; e += stride) {
    if (e < ll) {
      for (int j = 0; j < k; ++j)
        p.yseq_o[(bk + j) * ll + e] =
            lane_active ? successor(j, e) : p.yseq[(bk + j) * ll + e];
      p.best_yseq_o[row + e] =
          better_s ? successor(best_slot_s, e) : p.best_yseq[row + e];
      const float eb = p.ended_best[row + e];
      p.ended_best_o[row + e] = e == d.i ? fmaxf(eb, step_best_s) : eb;
      p.ended_cnt_o[row + e] =
          p.ended_cnt[row + e] + (e == d.i ? n_ended_s : 0);
    } else {
      const size_t base = (static_cast<size_t>(e - ll) * d.b + b) * k;
      for (int j = 0; j < k; ++j) p.anc_o[base + j] = p.anc[base + prev_s[j]];
    }
  }
}

}  // namespace

// ptrs: the 17 inputs then the 14 outputs of beam_update.py, in that
// order (the CTC inputs 0 when use_ctc is 0).
extern "C" int avsr_beam_update(void* const* ptrs, int i, int b, int k,
                                int sp, int l, int s, int eos, int m_end,
                                int use_ctc, float w_dec, float w_ctc,
                                float neg, float d_end, void* stream) {
  if (b <= 0 || k <= 0 || sp <= 0 || l <= 0 || s <= 0 || m_end < 0 ||
      static_cast<long long>(k) * (sp + 1) > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  static_assert(sizeof(Ptrs) == 31 * sizeof(void*), "Ptrs layout");
  Ptrs p;
  memcpy(&p, ptrs, sizeof(Ptrs));
  const Dims d{i, b, k, sp, l, s, eos, m_end, use_ctc,
               w_dec, w_ctc, neg, d_end};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k > kMaxK || k * (sp + 1) > kMaxCand) {
    const size_t smem = wide_smem(k, k * (sp + 1));
    const long long g = (static_cast<long long>(l) + s + kWideThreads - 1) /
                        kWideThreads;
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
                              kWideThreads, smem, st>>>(p, d);
    return static_cast<int>(cudaGetLastError());
  }
  // blocks an utterance: every column and ancestry row an item
  const long long per = static_cast<long long>(kThreads) * kItems;
  const long long g = (static_cast<long long>(l) + s + per - 1) / per;
  if (g > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(b, static_cast<unsigned>(g));
  if (k <= 4)
    beam_update_kernel<4><<<grid, kThreads, 0, st>>>(p, d);
  else
    beam_update_kernel<kMaxK><<<grid, kThreads, 0, st>>>(p, d);
  return static_cast<int>(cudaGetLastError());
}

// the last traced launch's marks (2 x 7 int64; zeros where kTrace is 0)
extern "C" int avsr_beam_update_trace(long long* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, trace_marks, sizeof(trace_marks)));
}
