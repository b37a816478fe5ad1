// Inclusive cumulative logsumexp down axis 0 of a row-major (T, C) fp32
// array: out[t, c] = log(sum_{j <= t} exp(x[j, c])).
//
// Replaces the Pallas TPU kernel avsr_tpu/ops/pallas/scan_logsumexp.py
// `_kernel` (entry `cumlogsumexp`), which runs a Kogge-Stone scan over
// (running max, shifted sum) pairs on a whole (T, C) block in VMEM.
//
// What bounds it on the card: the CTC prefix scorer calls it twice a decode
// step at (T, C) = (384, B*K*S') = (384, 96) at B=8: 2 x 147 KB, about
// 0.09 us of HBM traffic at 3.35 TB/s. The bytes do not bound it: a column
// walked by one thread is a chain of T dependent steps (two expf, a logf,
// a load and a store each), so the time is that chain's latency.
//
// Design: a parallel scan over the same monoid. A block takes kCols
// columns and walks T in chunks of 32 * kLaneRows rows. It copies a chunk
// with cp.async, all of a thread's loads in flight at once, coalesced
// (consecutive threads, consecutive columns of a row) into
// shared memory, column-major, with one pad word after every kLaneRows
// rows and a column stride of 32 * (kLaneRows + 1) + 32 / kCols words:
// lane i's reads of rows i * kLaneRows + k (an odd 13 words apart), and a
// warp's accesses to 32 / kCols rows of kCols columns, then hit distinct
// banks. Warp w scans column w: lane i combines its
// kLaneRows consecutive rows in order, keeping every inclusive (m, s) pair
// in registers; a 5-level __shfl_up_sync Kogge-Stone over the lanes'
// totals gives each lane its exclusive prefix, which the chunk carry from
// the earlier chunks precedes; each pair combined with it gives
// logf(fmaxf(s, 1e-37f)) + m. The chain of roundings of an output falls
// from T steps to at most kLaneRows + 5 + 2 a chunk.
//
// Numerics are the TPU kernel's: every prefix is shifted by its own
// running max (a column-global max underflows at T=375), the shift is
// guarded with max(m, -3.0e38) so that -inf - -inf never occurs, and an
// all -inf prefix gives -inf.
#include "common.cuh"

namespace {

constexpr int kCols = 8;       // columns of a block, one warp each
constexpr int kLaneRows = 12;  // consecutive rows of a lane
constexpr int kThreads = 32 * kCols;
constexpr int kChunk = 32 * kLaneRows;         // rows of a chunk
constexpr int kStride = 32 * (kLaneRows + 1) + 32 / kCols;  // a column
constexpr unsigned kFull = 0xffffffffu;

using avsr::combine_lse;

__device__ __forceinline__ int at(int col, int row) {
  return col * kStride + row + row / kLaneRows;
}

__global__ void __launch_bounds__(kThreads)
    cumlogsumexp_kernel(const float* __restrict__ x, float* __restrict__ out,
                        int t, int c) {
  __shared__ float buf[kCols * kStride];
  const int c0 = blockIdx.x * kCols;
  const int cols = min(kCols, c - c0);
  const int tid = threadIdx.x;
  const int w = tid / 32;
  const int lane = tid % 32;
  float carry_m = -INFINITY;  // the column's scan over earlier chunks
  float carry_s = 0.0f;
  for (int t0 = 0; t0 < t; t0 += kChunk) {
    const int n = min(kChunk, t - t0);
    for (int e = tid; e < n * kCols; e += kThreads) {  // all in flight
      const int r = e / kCols;
      const int col = e % kCols;
      if (col < cols)
        avsr::cp_async4(&buf[at(col, r)],
                        x + static_cast<size_t>(t0 + r) * c + c0 + col);
    }
    avsr::cp_async_commit();
    avsr::cp_async_wait<0>();
    __syncthreads();
    if (w < cols) {  // warp-uniform
      float pm[kLaneRows], ps[kLaneRows];
      float m = -INFINITY;
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < kLaneRows; ++k) {
        const int r = lane * kLaneRows + k;
        if (r < n) combine_lse(m, s, buf[at(w, r)], 1.0f);
        pm[k] = m;
        ps[k] = s;
      }
      // inclusive scan of the lanes' totals, then shift by one lane
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float m2 = __shfl_up_sync(kFull, m, off);
        const float s2 = __shfl_up_sync(kFull, s, off);
        if (lane >= off) combine_lse(m, s, m2, s2);
      }
      float em = __shfl_up_sync(kFull, m, 1);
      float es = __shfl_up_sync(kFull, s, 1);
      if (lane == 0) {
        em = -INFINITY;
        es = 0.0f;
      }
      float pre_m = carry_m;
      float pre_s = carry_s;
      combine_lse(pre_m, pre_s, em, es);
#pragma unroll
      for (int k = 0; k < kLaneRows; ++k) {
        const int r = lane * kLaneRows + k;
        if (r < n) {
          float om = pre_m;
          float os = pre_s;
          combine_lse(om, os, pm[k], ps[k]);
          buf[at(w, r)] = logf(fmaxf(os, 1e-37f)) + om;
        }
      }
      combine_lse(carry_m, carry_s, __shfl_sync(kFull, m, 31),
                  __shfl_sync(kFull, s, 31));
    }
    __syncthreads();
    for (int e = tid; e < n * kCols; e += kThreads) {
      const int r = e / kCols;
      const int col = e % kCols;
      if (col < cols)
        out[static_cast<size_t>(t0 + r) * c + c0 + col] = buf[at(col, r)];
    }
    __syncthreads();
  }
}

}  // namespace

// x, out: (t, c) fp32 contiguous, distinct buffers.
extern "C" int avsr_cumlogsumexp(const float* x, float* out, int t, int c,
                                 void* stream) {
  if (t <= 0 || c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (c + kCols - 1) / kCols;
  cumlogsumexp_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(x, out, t, c);
  return static_cast<int>(cudaGetLastError());
}
