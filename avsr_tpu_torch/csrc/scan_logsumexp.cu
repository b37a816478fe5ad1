// Inclusive cumulative logsumexp down axis 0 of a row-major (T, C) fp32
// array: out[t, c] = log(sum_{j <= t} exp(x[j, c])).
//
// Replaces the Pallas TPU kernel avsr_tpu/ops/pallas/scan_logsumexp.py
// `_kernel` (entry `cumlogsumexp`), which runs a Kogge-Stone scan over
// (running max, shifted sum) pairs on a whole (T, C) block in VMEM.
//
// What bounds it on the card: the CTC prefix scorer calls it twice a decode
// step at (T, C) = (384, B*K*S') = (384, 96) at B=8: 2 x 147 KB, about
// 0.09 us of HBM traffic at 3.35 TB/s. The bytes do not bound it. A column
// is a chain of T dependent steps (each an expf and a multiply-add on the
// running sum), so the time is the chain's latency plus the launch: the
// kernel is launch- and latency-bound at these shapes.
//
// Design: columns are independent, so one thread owns one column and walks
// T in order, keeping the running max m and the sum s of exp(x_j - m). The
// threads of a warp own neighbouring columns, so every row's loads and
// stores coalesce. The TPU scan's numerics are kept: the shift is the
// prefix's own running max (a column-global max underflows at T=375), the
// shift is guarded with max(m, -3.0e38) so that -inf - -inf never occurs,
// and the output is logf(fmaxf(s, 1e-37f)) + m, so an all -inf prefix gives
// -inf. The sum is accumulated in sequential order, the twin's in a tree of
// depth log2(T): results differ by a few ulps (see chip_smoke.py).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    cumlogsumexp_kernel(const float* __restrict__ x, float* __restrict__ out,
                        int t, int c) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= c) return;
  float m = -INFINITY;
  float s = 0.0f;
  for (int i = 0; i < t; ++i) {
    const size_t at = static_cast<size_t>(i) * c + col;
    const float xv = x[at];
    const float mm = fmaxf(m, xv);
    const float safe = fmaxf(mm, -3.0e38f);
    s = s * expf(m - safe) + expf(xv - safe);
    m = mm;
    out[at] = logf(fmaxf(s, 1e-37f)) + m;
  }
}

}  // namespace

// x, out: (t, c) fp32 contiguous, distinct buffers.
extern "C" int avsr_cumlogsumexp(const float* x, float* out, int t, int c,
                                 void* stream) {
  if (t <= 0 || c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (c + kThreads - 1) / kThreads;
  cumlogsumexp_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(x, out, t, c);
  return static_cast<int>(cudaGetLastError());
}
