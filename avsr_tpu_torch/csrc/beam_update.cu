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
// What bounds it on the card: at B=8, K=3, S'=4, L=377 and a 192-row
// ancestry it reads and writes under 0.35 MB (the int64 token buffers and
// ancestry dominate), about 0.1 us at 3.35 TB/s, with a few hundred
// arithmetic operations. The launch bounds it. Its worth is the ~100
// launches a step of the unfused step that it replaces, which only the
// beam's wall time shows.
//
// Design: one block per utterance. Its threads weight the K*(S'+1)
// candidates into shared memory; one thread then runs the k rounds of
// (max, lowest flat index, mask) and the per-utterance scalars (retirement,
// best slot, end detection), all O(K*(S'+1)) work; then all threads write
// the gathered token rows, the best row, the ended statistics and the
// ancestry, with neighbouring threads on neighbouring elements.
//
// Exactness: every output is bit-identical to beam_update_plain and to the
// unfused step in decode/beam.py. torch rounds each operation on its own,
// but nvcc would contract w_dec*a + w_ctc*(psi - s) into fused
// multiply-adds, which round once and could flip a near-tie in the top-k.
// So the weighting uses the __fmul_rn / __fadd_rn / __fsub_rn intrinsics,
// which are never contracted, in the unfused step's order; every other
// output is a selection or a copy.
#include <string.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxCand = 128;  // K * (S'+1)
constexpr int kMaxK = 16;

struct Ptrs {
  // inputs
  const long long* xlens;      // (B,)
  const float* dec_top;        // (B, K, S')
  const float* dec_eos;        // (B, K)
  const float* psi_cand;       // (B, K, S'), null without CTC
  const float* psi_eos;        // (B, K), null without CTC
  const float* ctc_s;          // (B, K), null without CTC
  const long long* part_ids;   // (B, K, S')
  const float* score;          // (B, K)
  const unsigned char* alive;  // (B, K) bool
  const unsigned char* stop;   // (B,) bool
  const long long* yseq;       // (B, K, L)
  const long long* anc;        // (S, B, K)
  const float* ended_best;     // (B, L)
  const long long* ended_cnt;  // (B, L)
  const float* best_score;     // (B,)
  const long long* best_yseq;  // (B, L)
  const long long* best_len;   // (B,)
  // outputs, in the order of beam_update.py _OUT
  long long* token;            // (B, K)
  long long* prev;             // (B, K)
  long long* slot;             // (B, K)
  float* psi_sel;              // (B, K)
  float* score_o;              // (B, K)
  unsigned char* alive_o;      // (B, K)
  long long* yseq_o;           // (B, K, L)
  long long* anc_o;            // (S, B, K)
  float* ended_best_o;         // (B, L)
  long long* ended_cnt_o;      // (B, L)
  float* best_score_o;         // (B,)
  long long* best_yseq_o;      // (B, L)
  long long* best_len_o;       // (B,)
  unsigned char* stop_o;       // (B,)
};

struct Dims {
  int i, b, k, sp, l, s, eos, m_end, use_ctc;
  float w_dec, w_ctc, neg, d_end;
};

// token buffer row j of the successor of lane j, element l (before the
// lane_active freeze): the source row prev[j], then this step's writes
__device__ __forceinline__ long long successor(const Ptrs& p, const Dims& d,
                                               int b, int prev_j,
                                               long long tok_j, bool forced,
                                               int l) {
  long long v = p.yseq[(static_cast<size_t>(b) * d.k + prev_j) * d.l + l];
  if (l == d.i + 1) v = tok_j;
  if (l == d.i + 2 && forced) v = d.eos;
  return v;
}

__global__ void __launch_bounds__(kThreads)
    beam_update_kernel(const Ptrs p, const Dims d) {
  __shared__ float w[kMaxCand];
  __shared__ long long cand_tok[kMaxCand];
  __shared__ float cand_psi[kMaxCand];
  __shared__ int prev_s[kMaxK];
  __shared__ long long tok_s[kMaxK];
  __shared__ float step_best_s;
  __shared__ int best_slot_s, better_s, n_ended_s;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int k = d.k, sp = d.sp, c = sp + 1, nc = k * c;
  const long long xlen = p.xlens[b];
  const bool lane_active = !p.stop[b] && d.i < xlen;
  const bool forced = d.i >= xlen - 1;
  const size_t bk = static_cast<size_t>(b) * k;

  // 1. candidate scores: w_dec*dec (+ w_ctc*(psi - s)), eos-slot dedup,
  //    + score, dead lanes to neg
  for (int f = tid; f < nc; f += kThreads) {
    const int j = f / c, q = f % c;
    const bool eos_slot = q == sp;
    const size_t at = (bk + j) * sp + q;
    const float dec = eos_slot ? p.dec_eos[bk + j] : p.dec_top[at];
    float wv = __fmul_rn(d.w_dec, dec);
    float psi = 0.0f;
    if (d.use_ctc) {
      psi = eos_slot ? p.psi_eos[bk + j] : p.psi_cand[at];
      const float gain = __fsub_rn(psi, p.ctc_s[bk + j]);
      wv = __fadd_rn(wv, __fmul_rn(d.w_ctc, gain));
    }
    if (eos_slot) {
      bool dup = false;
      for (int qq = 0; qq < sp; ++qq)
        dup |= p.part_ids[(bk + j) * sp + qq] == d.eos;
      if (dup) wv = d.neg;
    }
    wv = __fadd_rn(wv, p.score[bk + j]);
    if (!p.alive[bk + j]) wv = d.neg;
    w[f] = wv;
    cand_tok[f] = eos_slot ? static_cast<long long>(d.eos) : p.part_ids[at];
    cand_psi[f] = psi;
  }
  __syncthreads();

  // 2. one thread: top-k, retirement, best tracking, end detection
  if (tid == 0) {
    float top[kMaxK];
    bool ended[kMaxK];
    float step_best = -INFINITY;
    int n_ended = 0;
    for (int r = 0; r < k; ++r) {
      // largest value, lowest flat index among equals
      float m = -INFINITY;
      int sel = 0;
      for (int f = 0; f < nc; ++f)
        if (w[f] > m) {
          m = w[f];
          sel = f;
        }
      const int pj = sel / c;
      top[r] = m;
      prev_s[r] = pj;
      tok_s[r] = cand_tok[sel];
      p.token[bk + r] = cand_tok[sel];
      p.prev[bk + r] = pj;
      p.slot[bk + r] = sel - pj * c;
      p.psi_sel[bk + r] = cand_psi[sel];
      w[sel] = -INFINITY;
      ended[r] = (cand_tok[sel] == d.eos || forced) && lane_active;
      n_ended += ended[r];
      step_best = fmaxf(step_best, ended[r] ? m : d.neg);
    }
    int best_slot = 0;
    for (int r = k - 1; r >= 0; --r)
      if ((ended[r] ? top[r] : d.neg) == step_best) best_slot = r;
    const bool better = step_best > p.best_score[b] && lane_active;
    const float best_score = better ? step_best : p.best_score[b];
    p.best_score_o[b] = best_score;
    p.best_len_o[b] = better ? d.i + (forced ? 3 : 2) : p.best_len[b];

    bool any_alive = false;
    for (int r = 0; r < k; ++r) {
      const bool alive_new = !ended[r] && lane_active;
      const float score_new = alive_new ? top[r] : d.neg;
      const bool alive_o = lane_active ? alive_new : p.alive[bk + r];
      p.score_o[bk + r] = lane_active ? score_new : p.score[bk + r];
      p.alive_o[bk + r] = alive_o;
      any_alive |= alive_o;
    }
    // end detection on the updated statistics (column i is this step's)
    int count = 0;
    for (int mm = 0; mm < d.m_end; ++mm) {
      const int j = d.i - mm - 2;
      const int jc = j > 0 ? j : 0;
      const size_t at = static_cast<size_t>(b) * d.l + jc;
      const long long cnt = p.ended_cnt[at] + (jc == d.i ? n_ended : 0);
      const float eb = jc == d.i ? fmaxf(p.ended_best[at], step_best)
                                 : p.ended_best[at];
      const bool ok = j >= 0 && cnt > 0;
      const bool worse = __fsub_rn(eb, best_score) < d.d_end;
      count += ok && worse;
    }
    const bool newly = count >= d.m_end || !any_alive;
    p.stop_o[b] = p.stop[b] || (newly && lane_active);
    step_best_s = step_best;
    best_slot_s = best_slot;
    better_s = better;
    n_ended_s = n_ended;
  }
  __syncthreads();

  // 3. all threads: token buffers, best row, ended statistics, ancestry
  for (int e = tid; e < k * d.l; e += kThreads) {
    const int j = e / d.l, l = e % d.l;
    const size_t at = (bk + j) * d.l + l;
    p.yseq_o[at] = lane_active
                       ? successor(p, d, b, prev_s[j], tok_s[j], forced, l)
                       : p.yseq[at];
  }
  const size_t row = static_cast<size_t>(b) * d.l;
  for (int l = tid; l < d.l; l += kThreads) {
    const int bs = best_slot_s;
    p.best_yseq_o[row + l] =
        better_s ? successor(p, d, b, prev_s[bs], tok_s[bs], forced, l)
                 : p.best_yseq[row + l];
    p.ended_best_o[row + l] = l == d.i
                                  ? fmaxf(p.ended_best[row + l], step_best_s)
                                  : p.ended_best[row + l];
    p.ended_cnt_o[row + l] =
        p.ended_cnt[row + l] + (l == d.i ? n_ended_s : 0);
  }
  for (int e = tid; e < d.s * k; e += kThreads) {
    const int srow = e / k, j = e % k;
    const size_t base = (static_cast<size_t>(srow) * d.b + b) * k;
    p.anc_o[base + j] = p.anc[base + prev_s[j]];
  }
}

}  // namespace

// ptrs: the 17 inputs then the 14 outputs of beam_update.py, in that
// order (the CTC inputs 0 when use_ctc is 0).
extern "C" int avsr_beam_update(void* const* ptrs, int i, int b, int k,
                                int sp, int l, int s, int eos, int m_end,
                                int use_ctc, float w_dec, float w_ctc,
                                float neg, float d_end, void* stream) {
  if (b <= 0 || k <= 0 || k > kMaxK || sp <= 0 || k * (sp + 1) > kMaxCand ||
      l <= 0 || s <= 0 || m_end < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static_assert(sizeof(Ptrs) == 31 * sizeof(void*), "Ptrs layout");
  Ptrs p;
  memcpy(&p, ptrs, sizeof(Ptrs));
  const Dims d{i, b, k, sp, l, s, eos, m_end, use_ctc,
               w_dec, w_ctc, neg, d_end};
  beam_update_kernel<<<b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, d);
  return static_cast<int>(cudaGetLastError());
}
