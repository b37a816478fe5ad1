// Counter-based dropout bits for the flash-attention kernels.
//
// Philox4x32-10 (Salmon, Moraes, Dror, Shaw, SC'11; the constants of
// Random123 and cuRAND). The keep decision of attention element (head n,
// query row i, key column j) is word (j & 3) of
//   Philox4x32-10(counter = (j >> 2, i, n, 0), key = (seed0, seed1))
// kept iff that word is below `threshold` = round(keep * 2^32). The counter
// is the element's absolute position, so the forward and both backward
// kernels draw the same bits whatever tile each one works on, and nothing
// of size (N, T, T) is ever stored. The plain twin of this draw is
// `dropout_keep_mask_plain` in ops/kernels/flash_attention.py.
#pragma once

#include <stdint.h>

namespace avsr {

struct Philox4 {
  uint32_t x[4];
};

__device__ __forceinline__ Philox4 philox4x32_10(uint32_t c0, uint32_t c1,
                                                 uint32_t c2, uint32_t c3,
                                                 uint32_t k0, uint32_t k1) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = kM0 * c0, hi0 = __umulhi(kM0, c0);
    const uint32_t lo1 = kM1 * c2, hi1 = __umulhi(kM1, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
    k0 += kW0;
    k1 += kW1;
  }
  return Philox4{{c0, c1, c2, c3}};
}

// Dropout arguments shared by the three kernels.
struct DropArgs {
  uint32_t threshold;  // keep iff bits < threshold
  float inv_keep;      // fp32(1 / keep): the pre-scale of a kept element
  uint32_t seed0, seed1;
};

// Fills keep[r][c] (row stride `ld` bytes) for the rows x cols tile whose
// top-left element is (query row0, key col0) of head n: 1 = kept. col0 and
// cols are multiples of 4, so each Philox call fills four neighbours.
// Every thread of the block takes part; the caller synchronises.
__device__ __forceinline__ void fill_keep_tile(uint8_t* keep, int ld, int rows,
                                               int cols, int n, int row0,
                                               int col0, const DropArgs& a) {
  const int groups = cols / 4;
  for (int e = threadIdx.x; e < rows * groups; e += blockDim.x) {
    const int r = e / groups;
    const int g = e % groups;
    const Philox4 b = philox4x32_10(
        static_cast<uint32_t>((col0 >> 2) + g),
        static_cast<uint32_t>(row0 + r), static_cast<uint32_t>(n), 0u, a.seed0,
        a.seed1);
    uint8_t* dst = keep + r * ld + 4 * g;
#pragma unroll
    for (int w = 0; w < 4; ++w) dst[w] = b.x[w] < a.threshold ? 1 : 0;
  }
}

}  // namespace avsr
