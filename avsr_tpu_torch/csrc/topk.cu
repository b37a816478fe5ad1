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
// k > kMaxK (a pre-beam of 1.5 x beam over 32, beams of 22 and more): a
// block of kWideThreads a row, k rounds of a block-wide arg-max. Round r
// takes the best element that comes after round r-1's winner in the total
// order "larger value, then lower index" (each thread its own best over
// its strided elements, then avsr::block_best), so nothing is masked or
// written back and the row is only read; the rule is C1's, exact. The
// first round whose best is -inf starts the -inf rule above: its element
// is the lowest index holding -inf, and every later slot takes the lower
// of it and the lowest index chosen before. The rounds re-read the row
// from L1/L2 (20 KB at V=5049); k rounds of two block barriers bound it,
// which is later work to shorten.
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

// "a before b": the larger value, then the smaller index
__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
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
// list itself while its values are above -inf, then the rounds' -inf rule
__device__ __forceinline__ void finish(const float* sv, const int* si, int k,
                                       int r, float* vals, long long* ids) {
  int c = 0;
  while (c < k && sv[c] > -INFINITY) ++c;
  if (r < c) {
    vals[r] = sv[r];
    ids[r] = si[r];
    return;
  }
  int j = si[c];
  for (int p = 0; p < c; ++p) j = min(j, si[p]);
  vals[r] = -INFINITY;
  ids[r] = j;
}

// a block a row
template <int K>
__global__ void __launch_bounds__(kThreads)
    topk_row_kernel(const float* __restrict__ x, float* __restrict__ vals,
                    long long* __restrict__ ids, int v, int k) {
  __shared__ float wv[kWarps * K];
  __shared__ int wi[kWarps * K];
  __shared__ float bv[K];
  __shared__ int bi[K];
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
      finish(bv, bi, k, tid, vals + static_cast<size_t>(blockIdx.x) * k,
             ids + static_cast<size_t>(blockIdx.x) * k);
  }
}

// a warp a row, kFlatWarps rows a block
template <int K>
__global__ void __launch_bounds__(kFlatWarps * 32)
    topk_warp_kernel(const float* __restrict__ x, float* __restrict__ vals,
                     long long* __restrict__ ids, int rows, int v, int k) {
  __shared__ float wv[kFlatWarps * K];
  __shared__ int wi[kFlatWarps * K];
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
  if (lane < k)
    finish(ov, oi, k, lane, vals + static_cast<size_t>(row_id) * k,
           ids + static_cast<size_t>(row_id) * k);
}

// k > kMaxK: a block a row, k rounds of a block-wide arg-max after the
// previous round's winner
__global__ void __launch_bounds__(kWideThreads)
    topk_wide_kernel(const float* __restrict__ x, float* __restrict__ vals,
                     long long* __restrict__ ids, int v, int k) {
  __shared__ unsigned skey[kWideThreads / 32];
  __shared__ int sidx[kWideThreads / 32];
  const size_t r0 = blockIdx.x;
  const float* row = x + r0 * v;
  float* ov = vals + r0 * k;
  long long* oi = ids + r0 * k;
  const unsigned key_neg_inf = avsr::order_key(-INFINITY);
  unsigned pk = 0xffffffffu;  // the previous winner: nothing comes before
  int pi = -1;
  int lowest = INT_MAX;  // the lowest index chosen so far
  for (int r = 0; r < k; ++r) {
    // key 0 (a NaN's bits) is below every value's key: "none"
    unsigned bk = 0u;
    int bi = INT_MAX;
    for (int e = threadIdx.x; e < v; e += kWideThreads) {
      const float xv = __ldg(row + e);
      if (xv != xv) continue;
      const unsigned key = avsr::order_key(xv);
      // after (pk, pi) in the order, and better than this thread's best
      // (its e rise, so an equal key never beats it)
      if ((key < pk || (key == pk && e > pi)) && key > bk) {
        bk = key;
        bi = e;
      }
    }
    avsr::block_best(bk, bi, skey, sidx);
    if (bk <= key_neg_inf) {
      // the -inf rule for rounds r..k-1 (bi: the lowest index holding -inf)
      const int j = min(bi, lowest);
      for (int q = r + threadIdx.x; q < k; q += kWideThreads) {
        ov[q] = -INFINITY;
        oi[q] = j;
      }
      return;
    }
    if (threadIdx.x == 0) {
      ov[r] = avsr::key_value(bk);
      oi[r] = bi;
    }
    pk = bk;
    pi = bi;
    lowest = min(lowest, bi);
  }
}

template <int K>
cudaError_t launch(const float* x, float* vals, long long* ids, int rows,
                   int v, int k, cudaStream_t stream) {
  if (v <= kWarpRowMax)
    topk_warp_kernel<K><<<(rows + kFlatWarps - 1) / kFlatWarps,
                          kFlatWarps * 32, 0, stream>>>(x, vals, ids, rows,
                                                        v, k);
  else
    topk_row_kernel<K><<<rows, kThreads, 0, stream>>>(x, vals, ids, v, k);
  return cudaGetLastError();
}

}  // namespace

// x: (rows, v) fp32 contiguous, 4-byte aligned; vals: (rows, k) fp32; ids:
// (rows, k) int64.
extern "C" int avsr_topk_lastdim(const float* x, float* vals, long long* ids,
                                 int rows, int v, int k, void* stream) {
  if (rows <= 0 || v <= 0 || k <= 0 || k > v ||
      reinterpret_cast<uintptr_t>(x) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (k > kMaxK) {
    topk_wide_kernel<<<rows, kWideThreads, 0, s>>>(x, vals, ids, v, k);
    err = cudaGetLastError();
  } else if (k <= 4)
    err = launch<4>(x, vals, ids, rows, v, k, s);
  else if (k <= 8)
    err = launch<8>(x, vals, ids, rows, v, k, s);
  else if (k <= 16)
    err = launch<16>(x, vals, ids, rows, v, k, s);
  else
    err = launch<kMaxK>(x, vals, ids, rows, v, k, s);
  return static_cast<int>(err);
}
