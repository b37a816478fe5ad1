// Scattered-row gather: out[i, :] = src[idx[i], :] for a row-major fp32
// (R, C) table.
//
// Replaces the Pallas TPU kernel avsr_tpu/ops/pallas/row_gather.py `_kernel`
// (entry `row_gather`), which starts one async DMA per requested row. That
// kernel copies the whole 8-row block around each row, because a TPU
// memref tile is (8, 128), and the wrapper picks the row out with a one-hot
// contraction. A CUDA block can read any row, so this kernel copies exactly
// the rows asked for.
//
// What bounds it on the card: the beam gathers B*K*S' = 96 rows of
// Tp = 384 floats a step at B=8, 2 x 147 KB moved, about 0.09 us at
// 3.35 TB/s. That is far below the launch latency, so the kernel is
// launch-bound; the rows are read once each and written once each.
//
// Design: one block per output row; its threads copy the row with 16-byte
// loads and stores (4 floats a thread per trip) when the row length is a
// multiple of 4 and both buffers are 16-byte aligned, else one float at a
// time. Bytes are copied, so the result is bit-exact. An index outside
// [0, R) writes a row of NaN instead of reading out of bounds.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    row_gather_kernel(const float* __restrict__ src,
                      const long long* __restrict__ idx,
                      float* __restrict__ out, int r, int c, bool vec) {
  const long long row = idx[blockIdx.x];
  float* dst = out + static_cast<size_t>(blockIdx.x) * c;
  if (row < 0 || row >= r) {
    for (int j = threadIdx.x; j < c; j += kThreads) dst[j] = NAN;
    return;
  }
  const float* from = src + static_cast<size_t>(row) * c;
  if (vec) {
    const float4* from4 = reinterpret_cast<const float4*>(from);
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int j = threadIdx.x; j < c / 4; j += kThreads) dst4[j] = from4[j];
  } else {
    for (int j = threadIdx.x; j < c; j += kThreads) dst[j] = from[j];
  }
}

}  // namespace

// src: (r, c) fp32; idx: (n,) int64; out: (n, c) fp32; all contiguous.
extern "C" int avsr_row_gather(const float* src, const long long* idx,
                               float* out, int r, int c, int n,
                               void* stream) {
  if (r <= 0 || c <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  row_gather_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, idx, out, r, c, vec);
  return static_cast<int>(cudaGetLastError());
}
