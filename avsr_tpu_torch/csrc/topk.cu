// Exact small-k top-k over the last axis, sorted descending, ties toward
// the lower index.
//
// Replaces the Pallas TPU kernel avsr_tpu/ops/pallas/topk.py `_topk_kernel`
// with its exact semantics: k rounds of (m = max over the row, idx = the
// lowest index whose value equals m, then that index counts as -inf). The
// beam search needs this tie order (torch.topk does not document one on
// CUDA).
//
// What bounds it on the card: latency. The beam calls it twice a decode
// step on small buffers ((B*3, 5049) and (B, 15) fp32, 485 KB and 480 B at
// B=8), so the bytes take 0.15 us and the time is the launch, one round
// trip to memory and the dependent steps of the merge.
//
// Design: each row is read once. A thread keeps the best k (value, index)
// pairs of its own elements in registers, sorted under "larger value, then
// smaller index" (a list of K >= k slots; K is 4, 8, 16 or 32, chosen by k
// alone). k rounds merge a warp's lists: a round's winner is the largest
// head value (one __reduce_max_sync over an order-preserving integer key),
// then the smallest index holding it (one __reduce_min_sync), and the lane
// holding it pops its head; a second merge does the same over the warps'
// lists in shared memory.
// - Vocabulary rows (v > kWarpRowMax): a block of kThreads a row, the row
//   body in 16-byte loads from its first 16-byte boundary (rows start at
//   row * v * 4 bytes), head and tail in scalar loads. (A cluster of 2 or
//   4 blocks a row, merged through distributed shared memory, measured
//   slower at the beam's 24 rows: its cluster syncs cost more than the
//   shorter scans save.)
// - Short rows (the beam's flat (B, 15) top-k): a warp a row, kFlatWarps
//   rows a block, scalar loads.
//
// The rounds' rule when a row has fewer than k entries above -inf: once the
// finite entries are used up (after c rounds), a round's max is -inf and
// its index the lowest index whose current value is -inf, which counts the
// c indices already chosen. That index does not change between such rounds:
// it is min(lowest index holding -inf, indices of the c rounds), and the
// merged list holds both (its entry c is the lowest index holding -inf).
// `finish` writes it. NaN entries are never chosen.
//
// k > kMaxK (a pre-beam of 1.5 x beam over 32, beams of 22 and more, and
// the flat top-k of beams above 32): a block of kWideThreads a row, a radix
// select over the row staged once in shared memory (topk_wide_kernel): a
// few 8-bit digit passes find the k-th largest key, one compaction in
// index order takes the keys above it and the lowest-index keys equal to
// it, and a bitonic sort of next_pow2(k) entries orders them by (value
// descending, index ascending). The rule is C1's, exact: the same
// selection as k rounds of (max, lowest index holding it); a row with
// fewer than k entries above -inf fills the rest with the -inf rule above;
// NaN is never chosen. Bound: the row's 20 KB read once at V=5049 and a
// few barriers a pass; rows up to kWideSmemMax / 4 entries (~57,000 at
// k=33).
//
// The CTC candidate rows in the same launch (avsr_topk_gather_rows): the
// beam's pre-beam top-k picks, for each (utterance, hypothesis) row r, the
// ids whose columns of the CTC log-prob table the prefix scorer reads next.
// Gathered by a launch of their own (csrc/row_gather.cu, the TPU kernel
// avsr_tpu/ops/pallas/row_gather.py `_kernel`), those rows cost a launch
// and the elementwise add that builds their indices, two launch floors for
// 0.3 MB of copies at B=8. So each kernel above, once its row's ids are
// chosen, puts them in shared memory (one barrier; a warp's own
// __syncwarp in the warp-a-row kernel) and copies table row
// (r / lanes) * v + id[q] to output row r * k + q for every q: 16-byte
// loads and stores where the row length tp is a multiple of 4 and both
// buffers are 16-byte aligned, single floats otherwise. An id outside
// [0, v), which only a row without a value that is not NaN gives, writes a
// row of NaN. Bytes are copied, so the rows are exact; the selection is
// the same code with or without the copy.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 32;
constexpr int kChunks = 8;     // 16-byte loads in flight a thread
constexpr int kFlatWarps = 4;  // rows a block of the warp-a-row kernel
constexpr int kWarpRowMax = 1024;  // longest row taken a warp a row
constexpr int kWideThreads = 256;  // a row of the k > kMaxK kernel
// the k > kMaxK kernel's dynamic shared memory at most: 227 KB less its
// static 1.1 KB
constexpr int kWideSmemMax = 230400;
static_assert(kWideThreads == 256, "a thread a digit bin");

// "a before b": the larger value, then the smaller index
__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// where the chosen ids' CTC rows go; table null: no gather
struct Gather {
  const float* __restrict__ table;  // (rows / lanes * v, tp)
  float* __restrict__ out;          // (rows * k, tp)
  int lanes, tp;
  bool vec;  // 16-byte copies
};

// output rows r*k .. r*k+k-1: table rows (r / lanes) * v + id[q] for the
// k ids of row r (in shared memory), copied by `threads` threads from `t`
__device__ __forceinline__ void gather_rows(const Gather& g, const int* id,
                                            int k, size_t r, int v, int t,
                                            int threads) {
  const size_t base = r / g.lanes * static_cast<size_t>(v);
  if (g.vec) {
    const int n4 = g.tp / 4;
    float4* out = reinterpret_cast<float4*>(g.out + r * k * g.tp);
    for (int e = t; e < k * n4; e += threads) {
      const int q = e / n4;
      const int j = id[q];
      float4 val = make_float4(NAN, NAN, NAN, NAN);
      if (j >= 0 && j < v)
        val = __ldg(reinterpret_cast<const float4*>(
                        g.table + (base + j) * g.tp) + (e - q * n4));
      out[e] = val;
    }
  } else {
    float* out = g.out + r * k * g.tp;
    for (int e = t; e < k * g.tp; e += threads) {
      const int q = e / g.tp;
      const int j = id[q];
      out[e] = j >= 0 && j < v ? __ldg(g.table + (base + j) * g.tp +
                                       (e - q * g.tp))
                               : NAN;
    }
  }
}

// the best K (value, index) pairs seen, sorted; empty slots are (-inf,
// INT_MAX), which every element (-inf included) beats
template <int K>
struct List {
  float v[K];
  int i[K];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int p = 0; p < K; ++p) {
      v[p] = -INFINITY;
      i[p] = INT_MAX;
    }
  }

  __device__ __forceinline__ void insert(float x, int idx) {
    if (!better(x, idx, v[K - 1], i[K - 1])) return;
    v[K - 1] = x;
    i[K - 1] = idx;
#pragma unroll
    for (int p = K - 1; p > 0; --p) {
      if (better(v[p], i[p], v[p - 1], i[p - 1])) {
        const float tv = v[p];
        const int ti = i[p];
        v[p] = v[p - 1];
        i[p] = i[p - 1];
        v[p - 1] = tv;
        i[p - 1] = ti;
      }
    }
  }

  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int p = 0; p + 1 < K; ++p) {
      v[p] = v[p + 1];
      i[p] = i[p + 1];
    }
    v[K - 1] = -INFINITY;
    i[K - 1] = INT_MAX;
  }

  // slots [0, k) from shared memory (the rest empty)
  __device__ __forceinline__ void load(const float* sv, const int* si,
                                       int k) {
#pragma unroll
    for (int p = 0; p < K; ++p) {
      v[p] = p < k ? sv[p] : -INFINITY;
      i[p] = p < k ? si[p] : INT_MAX;
    }
  }
};

// k rounds over the warp's lists: every lane learns each round's winner;
// lane 0 writes it to (ov[r], oi[r]). An index lives in one lane's list, so
// one lane pops a real winner (empty slots tie, and popping one is a no-op).
template <int K>
__device__ __forceinline__ void merge_warp(List<K>& l, int k, float* ov,
                                           int* oi) {
  for (int r = 0; r < k; ++r) {
    const unsigned head = avsr::order_key(l.v[0]);
    const unsigned best = __reduce_max_sync(0xffffffffu, head);
    const int bi =
        __reduce_min_sync(0xffffffffu, head == best ? l.i[0] : INT_MAX);
    if (l.i[0] == bi) l.pop();
    if ((threadIdx.x & 31) == 0) {
      ov[r] = avsr::key_value(best);
      oi[r] = bi;
    }
  }
}

// writes output slot r < k of a row from its merged list (sv, si): the
// list itself while its values are above -inf, then the rounds' -inf rule;
// returns the id written
__device__ __forceinline__ int finish(const float* sv, const int* si, int k,
                                      int r, float* vals, long long* ids) {
  int c = 0;
  while (c < k && sv[c] > -INFINITY) ++c;
  if (r < c) {
    vals[r] = sv[r];
    ids[r] = si[r];
    return si[r];
  }
  int j = si[c];
  for (int p = 0; p < c; ++p) j = min(j, si[p]);
  vals[r] = -INFINITY;
  ids[r] = j;
  return j;
}

// a block a row
template <int K>
__global__ void __launch_bounds__(kThreads)
    topk_row_kernel(const float* __restrict__ x, float* __restrict__ vals,
                    long long* __restrict__ ids, int v, int k,
                    const Gather g) {
  __shared__ float wv[kWarps * K];
  __shared__ int wi[kWarps * K];
  __shared__ float bv[K];
  __shared__ int bi[K];
  __shared__ int chosen[K];
  const float* row = x + static_cast<size_t>(blockIdx.x) * v;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // head: the scalars before the row's first 16-byte boundary
  const int head = min(v, static_cast<int>(
                              (16 - reinterpret_cast<uintptr_t>(row) % 16) %
                              16 / 4));
  const int nvec = (v - head) / 4;
  const int body_end = head + 4 * nvec;
  List<K> l;
  l.clear();
  if (tid < head) l.insert(__ldg(row + tid), tid);
  if (tid < v - body_end) l.insert(__ldg(row + body_end + tid), body_end + tid);
  const float4* body = reinterpret_cast<const float4*>(row + head);
  for (int q0 = tid; q0 < nvec; q0 += kChunks * kThreads) {
    float4 c[kChunks];
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int q = q0 + u * kThreads;
      if (q < nvec) c[u] = __ldg(body + q);
    }
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int q = q0 + u * kThreads;
      if (q < nvec) {
        const int e = head + 4 * q;
        l.insert(c[u].x, e);
        l.insert(c[u].y, e + 1);
        l.insert(c[u].z, e + 2);
        l.insert(c[u].w, e + 3);
      }
    }
  }
  merge_warp<K>(l, k, wv + warp * K, wi + warp * K);
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? lane : 0;
    l.load(wv + w * K, wi + w * K, lane < kWarps ? k : 0);
    merge_warp<K>(l, k, bv, bi);
    __syncwarp();
    if (tid < k)
      chosen[tid] = finish(bv, bi, k, tid,
                           vals + static_cast<size_t>(blockIdx.x) * k,
                           ids + static_cast<size_t>(blockIdx.x) * k);
  }
  if (g.table != nullptr) {  // the same for every thread of the launch
    __syncthreads();
    gather_rows(g, chosen, k, blockIdx.x, v, tid, kThreads);
  }
}

// a warp a row, kFlatWarps rows a block
template <int K>
__global__ void __launch_bounds__(kFlatWarps * 32)
    topk_warp_kernel(const float* __restrict__ x, float* __restrict__ vals,
                     long long* __restrict__ ids, int rows, int v, int k,
                     const Gather g) {
  __shared__ float wv[kFlatWarps * K];
  __shared__ int wi[kFlatWarps * K];
  __shared__ int chosen[kFlatWarps * K];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row_id = blockIdx.x * kFlatWarps + warp;
  if (row_id >= rows) return;  // a whole warp: no shuffle misses a lane
  const float* row = x + static_cast<size_t>(row_id) * v;
  List<K> l;
  l.clear();
  for (int e = lane; e < v; e += 32) l.insert(__ldg(row + e), e);
  float* ov = wv + warp * K;
  int* oi = wi + warp * K;
  merge_warp<K>(l, k, ov, oi);
  __syncwarp();
  int* mine = chosen + warp * K;
  if (lane < k)
    mine[lane] = finish(ov, oi, k, lane,
                        vals + static_cast<size_t>(row_id) * k,
                        ids + static_cast<size_t>(row_id) * k);
  if (g.table != nullptr) {
    __syncwarp();
    gather_rows(g, mine, k, row_id, v, lane, 32);
  }
}

// The k > kMaxK kernel's dynamic shared memory: the row's keys (v, 8-byte
// aligned) and the sort buffer (next_pow2(k) 64-bit entries)
__host__ __device__ inline size_t wide_smem_bytes(int v, int k) {
  int n = 1;
  while (n < k) n <<= 1;
  return (static_cast<size_t>(v) + 1) / 2 * 8 + static_cast<size_t>(n) * 8;
}

// (exclusive prefix, total) of x over the block's threads in thread order
__device__ __forceinline__ unsigned block_scan(unsigned x, unsigned* total,
                                               unsigned* tmp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) tmp[warp] = inc;
  __syncthreads();
  unsigned before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWideThreads / 32; ++w) {
    before += w < warp ? tmp[w] : 0u;
    all += tmp[w];
  }
  __syncthreads();  // tmp free again
  *total = all;
  return before + inc - x;
}

// k > kMaxK: a block a row, a radix select. The row is staged once in
// shared memory as order keys (NaN and -inf as 0, below every other key);
// if more than k keys lie above 0, 8-bit digit passes, most significant
// first (a histogram of the keys that share the prefix so far, with
// warp-aggregated shared-memory atomics, then a block scan from the top
// digit), find the k-th largest key T and how many keys lie above it (a
// pass stops early where all keys of the chosen digit are taken). Then
// every key above T and the lowest-index keys equal to T, up to k, are
// compacted in index order (each thread a contiguous range, a block scan
// of the threads' counts) and sorted by (key descending, index ascending)
// with a bitonic sort of next_pow2(k) entries. Where c <= k keys lie above
// 0, all c are taken and slots c..k-1 get C1's -inf rule: -inf at the
// lower of the lowest index holding -inf and the lowest index chosen.
__global__ void __launch_bounds__(kWideThreads)
    topk_wide_kernel(const float* __restrict__ x, float* __restrict__ vals,
                     long long* __restrict__ ids, int v, int k,
                     const Gather g) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  __shared__ unsigned hist[256];
  __shared__ unsigned tmp[kWideThreads / 32];
  __shared__ unsigned s_digit, s_above, s_count;
  __shared__ int s_neg_inf, s_lowest;
  unsigned* keys = reinterpret_cast<unsigned*>(wide_smem);
  unsigned long long* sel = reinterpret_cast<unsigned long long*>(
      wide_smem + (static_cast<size_t>(v) + 1) / 2 * 8);
  const int tid = threadIdx.x, lane = tid & 31;
  const size_t r0 = blockIdx.x;
  const float* row = x + r0 * v;
  if (tid == 0) {
    s_neg_inf = INT_MAX;
    s_lowest = INT_MAX;
  }

  // the row into shared memory as keys: its body in 16-byte loads from its
  // first 16-byte boundary, head and tail in scalar loads; the count of
  // keys above 0 and the lowest index holding -inf
  const int head = min(v, static_cast<int>(
                              (16 - reinterpret_cast<uintptr_t>(row) % 16) %
                              16 / 4));
  const int nvec = (v - head) / 4;
  const int body_end = head + 4 * nvec;
  unsigned above = 0;
  int neg_inf = INT_MAX;
  auto put = [&](float xv, int e) {
    const bool none = xv != xv || xv == -INFINITY;
    keys[e] = none ? 0u : avsr::order_key(xv);
    above += !none;
    if (xv == -INFINITY) neg_inf = min(neg_inf, e);
  };
  if (tid < head) put(__ldg(row + tid), tid);
  if (tid < v - body_end) put(__ldg(row + body_end + tid), body_end + tid);
  const float4* body = reinterpret_cast<const float4*>(row + head);
  for (int q = tid; q < nvec; q += kWideThreads) {
    const float4 c = __ldg(body + q);
    const int e = head + 4 * q;
    put(c.x, e);
    put(c.y, e + 1);
    put(c.z, e + 2);
    put(c.w, e + 3);
  }
  neg_inf = __reduce_min_sync(0xffffffffu, neg_inf);
  if (lane == 0 && neg_inf != INT_MAX) atomicMin(&s_neg_inf, neg_inf);
  unsigned c_above;
  block_scan(above, &c_above, tmp);  // its barriers publish the keys too

  // the digit passes: keys with (key & mask) > prefix are taken, and
  // `need` of those with (key & mask) == prefix, the lowest indices first
  unsigned prefix = 0, mask = 0xffffffffu;
  unsigned need = 0;  // c <= k: every key above 0, none equal to 0
  if (c_above > static_cast<unsigned>(k)) {
    need = k;
    mask = 0;
    for (int shift = 24; shift >= 0; shift -= 8) {
      hist[tid] = 0;  // kWideThreads == 256 bins
      __syncthreads();
      for (int e0 = 0; e0 < v; e0 += kWideThreads) {
        const int e = e0 + tid;
        const unsigned key = e < v ? keys[e] : 0u;
        const bool in = e < v && (key & mask) == prefix;
        const unsigned digit = in ? (key >> shift) & 255u : 256u;
        const unsigned peers = __match_any_sync(0xffffffffu, digit);
        if (in && lane == __ffs(peers) - 1)
          atomicAdd(&hist[digit], __popc(peers));
      }
      __syncthreads();
      // thread t takes digit 255 - t: the keys of the digits above it
      const unsigned cnt = hist[255 - tid];
      unsigned total;
      const unsigned higher = block_scan(cnt, &total, tmp);
      if (higher < need && higher + cnt >= need) {
        s_digit = 255 - tid;
        s_above = higher;
        s_count = cnt;
      }
      __syncthreads();
      need -= s_above;
      prefix |= s_digit << shift;
      mask |= 255u << shift;
      if (s_count == need) break;  // every key of the digit is taken
    }
  }

  // compaction in index order, thread t taking elements [t per, (t+1) per)
  const int per = (v + kWideThreads - 1) / kWideThreads;
  const int e0 = min(v, tid * per), e1 = min(v, e0 + per);
  unsigned n_gt = 0, n_eq = 0;
  for (int e = e0; e < e1; ++e) {
    const unsigned km = keys[e] & mask;
    n_gt += km > prefix;
    n_eq += km == prefix;
  }
  unsigned tot_gt, tot_eq;
  unsigned at_gt = block_scan(n_gt, &tot_gt, tmp);
  unsigned at_eq = block_scan(n_eq, &tot_eq, tmp);
  const unsigned m = tot_gt + min(need, tot_eq);  // entries chosen
  int lowest = INT_MAX;
  for (int e = e0; e < e1; ++e) {
    const unsigned key = keys[e];
    const unsigned km = key & mask;
    unsigned slot;
    if (km > prefix) {
      slot = at_gt++;
    } else if (km == prefix && at_eq < need) {
      slot = tot_gt + at_eq++;
    } else {
      continue;
    }
    sel[slot] = (static_cast<unsigned long long>(key) << 32) |
                (0xffffffffu - static_cast<unsigned>(e));
    lowest = min(lowest, e);
  }
  lowest = __reduce_min_sync(0xffffffffu, lowest);
  if (lane == 0 && lowest != INT_MAX) atomicMin(&s_lowest, lowest);
  int n = 1;
  while (n < static_cast<int>(m)) n <<= 1;
  for (int i = m + tid; i < n; i += kWideThreads) sel[i] = 0ull;
  __syncthreads();

  // bitonic sort of the n entries, descending
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < n / 2; i += kWideThreads) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long a = sel[lo], b = sel[hi];
        const bool down = (lo & size) == 0;
        if (down ? a < b : a > b) {
          sel[lo] = b;
          sel[hi] = a;
        }
      }
      __syncthreads();
    }
  }

  float* ov = vals + r0 * k;
  long long* oi = ids + r0 * k;
  const int j = min(s_neg_inf, s_lowest);  // the -inf rule's index
  // the keys are read no more: the chosen ids go there (k <= v)
  int* chosen = reinterpret_cast<int*>(keys);
  for (int r = tid; r < k; r += kWideThreads) {
    int id = j;
    if (r < static_cast<int>(m)) {
      ov[r] = avsr::key_value(static_cast<unsigned>(sel[r] >> 32));
      id = static_cast<int>(0xffffffffu - static_cast<unsigned>(sel[r]));
    } else {
      ov[r] = -INFINITY;
    }
    oi[r] = id;
    chosen[r] = id;
  }
  if (g.table != nullptr) {
    __syncthreads();
    gather_rows(g, chosen, k, r0, v, tid, kWideThreads);
  }
}

template <int K>
cudaError_t launch(const float* x, float* vals, long long* ids, int rows,
                   int v, int k, const Gather& g, cudaStream_t stream) {
  if (v <= kWarpRowMax)
    topk_warp_kernel<K><<<(rows + kFlatWarps - 1) / kFlatWarps,
                          kFlatWarps * 32, 0, stream>>>(x, vals, ids, rows,
                                                        v, k, g);
  else
    topk_row_kernel<K><<<rows, kThreads, 0, stream>>>(x, vals, ids, v, k, g);
  return cudaGetLastError();
}

int topk(const float* x, float* vals, long long* ids, int rows, int v, int k,
         const Gather& g, cudaStream_t s) {
  if (rows <= 0 || v <= 0 || k <= 0 || k > v ||
      reinterpret_cast<uintptr_t>(x) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (k > kMaxK) {
    const size_t smem = wide_smem_bytes(v, k);
    if (smem > kWideSmemMax) return static_cast<int>(cudaErrorInvalidValue);
    if (smem > 48 * 1024 &&
        (err = cudaFuncSetAttribute(
             topk_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             kWideSmemMax)) != cudaSuccess)
      return static_cast<int>(err);
    topk_wide_kernel<<<rows, kWideThreads, smem, s>>>(x, vals, ids, v, k, g);
    err = cudaGetLastError();
  } else if (k <= 4)
    err = launch<4>(x, vals, ids, rows, v, k, g, s);
  else if (k <= 8)
    err = launch<8>(x, vals, ids, rows, v, k, g, s);
  else if (k <= 16)
    err = launch<16>(x, vals, ids, rows, v, k, g, s);
  else
    err = launch<kMaxK>(x, vals, ids, rows, v, k, g, s);
  return static_cast<int>(err);
}

}  // namespace

// x: (rows, v) fp32 contiguous, 4-byte aligned; vals: (rows, k) fp32; ids:
// (rows, k) int64.
extern "C" int avsr_topk_lastdim(const float* x, float* vals, long long* ids,
                                 int rows, int v, int k, void* stream) {
  return topk(x, vals, ids, rows, v, k, Gather{nullptr, nullptr, 1, 1, false},
              static_cast<cudaStream_t>(stream));
}

// avsr_topk_lastdim, and in the same launch the table rows of the chosen
// ids: table (rows / lanes * v, tp) fp32, out (rows * k, tp) fp32, both
// contiguous; rows a multiple of lanes.
extern "C" int avsr_topk_gather_rows(const float* x, float* vals,
                                     long long* ids, int rows, int v, int k,
                                     const float* table, float* out,
                                     int lanes, int tp, void* stream) {
  if (table == nullptr || out == nullptr || lanes <= 0 || tp <= 0 ||
      rows % lanes != 0 || reinterpret_cast<uintptr_t>(table) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = tp % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return topk(x, vals, ids, rows, v, k, Gather{table, out, lanes, tp, vec},
              static_cast<cudaStream_t>(stream));
}
