// Split-TF32 building blocks of the fp32 tensor-core kernels (sm_90a):
// the flash-attention forward `flash_fwd_tf32` (flash_attention.cu), the
// backward pair `flash_bwd_dq_tf32` / `flash_bwd_dkv_tf32`
// (flash_attention_bwd.cu) and the one-launch decoder layer's fp32 GEMVs
// and attention products (decoder_layer.cu).
//
// A TF32 product keeps ~3 decimal digits, so each fp32 operand is split,
// x = hi + lo, with hi = x rounded to TF32 and lo = x - hi truncated to
// TF32, and a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b: three
// `mma.sync.m16n8k8` tf32 products into one fp32 accumulator (the two
// small terms first), dropping lo_a lo_b and lo's cut bits (~2^-21 of the
// product), as CUTLASS's OpMultiplyAddFastF32 does.
#pragma once

#include <stdint.h>

namespace avsr {
namespace tf32 {

// x = hi + lo as TF32 values (the low 13 bits zero): hi = x rounded as
// cvt.rna.tf32.f32 rounds a finite x (to nearest, ties away from zero:
// half the dropped range added to the magnitude's bits, then cleared),
// lo = x - hi (exact in fp32) truncated. Integer operations, not the cvt:
// with the cvt the kernel took 18-24% longer on the H100 (PERF.md). lo
// truncated, not rounded: one operation fewer (4% of the kernel's time),
// and a NaN x stays a NaN in lo, where rounding carries an all-ones NaN
// into the sign bit.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi))) & 0xffffe000u;
}

// d += a b (m16n8k8, tf32 operands, fp32 accumulators). Fragments (PTX
// ISA, "Matrix Fragments for mma.m16n8k8", .tf32), g = lane >> 2, c =
// lane & 3: A a0 = (g, c), a1 = (g+8, c), a2 = (g, c+4), a3 = (g+8, c+4);
// B b0 = (k = c, n = g), b1 = (k = c+4, n = g); C/D as for m16n8k16.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in split TF32, from a's split fragments and b's fp32 values:
// lo_a hi_b and hi_a lo_b first, then hi_a hi_b
__device__ __forceinline__ void mma_split(float (&d)[4],
                                          const uint32_t (&ahi)[4],
                                          const uint32_t (&alo)[4], float b0,
                                          float b1) {
  uint32_t h0, l0, h1, l1;
  split_tf32(b0, h0, l0);
  split_tf32(b1, h1, l1);
  mma_tf32(d, alo, h0, h1);
  mma_tf32(d, ahi, l0, l1);
  mma_tf32(d, ahi, h0, h1);
}

// d[i] += a b_i in split TF32 for the first n (default kN) of kN
// accumulators d[0 .. kN - 1] that share one split A operand, given each
// b_i split: bhi[i] / blo[i] hold its k = c and c + 4 halves. Each
// accumulator sums lo_a hi_b, hi_a lo_b and hi_a hi_b in mma_split's
// order, so its bits are mma_split's, but each term is issued across the
// accumulators before the next term: no mma waits on the one issued just
// before it. n, where given, is uniform over the warp.
template <int kN>
__device__ __forceinline__ void mma_split_rows(
    float (*d)[4], const uint32_t (&ahi)[4], const uint32_t (&alo)[4],
    const uint32_t (&bhi)[kN][2], const uint32_t (&blo)[kN][2],
    int n = kN) {
#pragma unroll
  for (int i = 0; i < kN; ++i)
    if (i < n) mma_tf32(d[i], alo, bhi[i][0], bhi[i][1]);
#pragma unroll
  for (int i = 0; i < kN; ++i)
    if (i < n) mma_tf32(d[i], ahi, blo[i][0], blo[i][1]);
#pragma unroll
  for (int i = 0; i < kN; ++i)
    if (i < n) mma_tf32(d[i], ahi, bhi[i][0], bhi[i][1]);
}

// the A fragment's four fp32 values, split
__device__ __forceinline__ void split_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                        float a0, float a1, float a2,
                                        float a3) {
  split_tf32(a0, hi[0], lo[0]);
  split_tf32(a1, hi[1], lo[1]);
  split_tf32(a2, hi[2], lo[2]);
  split_tf32(a3, hi[3], lo[3]);
}

// kVec (2 or 4) consecutive fp32 values by one 8- or 16-byte load
template <int kVec>
__device__ __forceinline__ void load_vec(float (&x)[kVec], const float* p) {
  if constexpr (kVec == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
  } else {
    const float2 f = *reinterpret_cast<const float2*>(p);
    x[0] = f.x, x[1] = f.y;
  }
}

}  // namespace tf32
}  // namespace avsr
