// Exact small-k top-k over the last axis, sorted descending, ties toward
// the lower index.
//
// Replaces the Pallas TPU kernel avsr_tpu/ops/pallas/topk.py `_topk_kernel`
// with its exact semantics: k rounds of (m = max over the row, idx = the
// lowest index whose value equals m, then that index counts as -inf). The
// beam search needs this tie order (torch.topk does not document one on
// CUDA).
//
// What bounds it on the card: nothing in the arithmetic. The beam calls it
// twice per decode step on small buffers ((B*3, 5049) and (B, 15) fp32), so
// its cost is launch latency plus k dependent block reductions; the row
// (20 KB at V = 5049) stays in L1/L2 across the k passes.
//
// Design: one block of 256 threads per row. Each round every thread scans a
// strided slice for its best (value, index) pair under the order "larger
// value, then smaller index", treating the indices chosen in earlier rounds
// (kept in shared memory) as -inf; a warp-shuffle reduction and a second
// one over the warps' winners pick the round's element.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 32;

__device__ __forceinline__ void better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kThreads)
    topk_kernel(const float* __restrict__ x, float* __restrict__ vals,
                long long* __restrict__ ids, int v, int k) {
  __shared__ int sel[kMaxK];
  __shared__ float wv[kThreads / 32];
  __shared__ int wi[kThreads / 32];
  const float* row = x + static_cast<size_t>(blockIdx.x) * v;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane_id = tid % 32;

  for (int r = 0; r < k; ++r) {
    float best = -INFINITY;
    int bi = INT_MAX;
    for (int i = tid; i < v; i += kThreads) {
      float xv = row[i];
      for (int p = 0; p < r; ++p)
        if (sel[p] == i) xv = -INFINITY;
      better(best, bi, xv, i);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      better(best, bi, ov, oi);
    }
    if (lane_id == 0) {
      wv[warp] = best;
      wi[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane_id < kThreads / 32 ? wv[lane_id] : -INFINITY;
      bi = lane_id < kThreads / 32 ? wi[lane_id] : INT_MAX;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        better(best, bi, ov, oi);
      }
      if (lane_id == 0) {
        sel[r] = bi;
        vals[static_cast<size_t>(blockIdx.x) * k + r] = best;
        ids[static_cast<size_t>(blockIdx.x) * k + r] = bi;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// x: (rows, v) fp32 contiguous; vals: (rows, k) fp32; ids: (rows, k) int64.
extern "C" int avsr_topk_lastdim(const float* x, float* vals, long long* ids,
                                 int rows, int v, int k, void* stream) {
  if (rows <= 0 || v <= 0 || k <= 0 || k > kMaxK || k > v)
    return static_cast<int>(cudaErrorInvalidValue);
  topk_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, vals, ids, v, k);
  return static_cast<int>(cudaGetLastError());
}
