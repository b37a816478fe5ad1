// Counter-based dropout bits for the flash-attention kernels.
//
// Philox4x32-10 (Salmon, Moraes, Dror, Shaw, SC'11; the constants of
// Random123 and cuRAND). The keep decision of attention element (head n,
// query row i, key column j; n is the row's global head, DropArgs::head)
// is word (j & 3) of
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
  // head map: rows n = (batch, local head) of a call that holds heads
  // head_base .. head_base + heads_local - 1 of heads_total (a tensor-
  // parallel rank's heads) draw at the counter of their global head;
  // (1, 1, 0) is the identity
  int heads_local, heads_total, head_base;

  __device__ __forceinline__ uint32_t head(int n) const {
    return static_cast<uint32_t>((n / heads_local) * heads_total +
                                 head_base + n % heads_local);
  }
};

}  // namespace avsr
