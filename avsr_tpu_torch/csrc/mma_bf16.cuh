// Tensor-core building blocks of the bf16 flash-attention kernels (sm_90a).
//
// Warp-level `mma.sync.aligned.m16n8k16` bf16 -> fp32 products with their
// operands brought from shared memory by `ldmatrix`, 16-byte `cp.async`
// tile loads (common.cuh) into padded shared-memory rows, and the Philox
// keep bits of an m16n8 accumulator fragment.
//
// Fragment layout (PTX ISA, "Matrix Fragments for mma.m16n8k16"), with
// g = lane >> 2 and c = 2 * (lane & 3):
//  - A (16 x 16, row-major): a0 = (g, c..c+1), a1 = (g+8, c..c+1),
//    a2 = (g, c+8..c+9), a3 = (g+8, c+8..c+9), two bf16 a register;
//  - B (16 x 8): b0 = (k = c..c+1, n = g), b1 = (k = c+8..c+9, n = g);
//  - C/D (16 x 8, fp32): d0, d1 = (g, c..c+1), d2, d3 = (g+8, c..c+1).
// So the accumulators of two neighbouring n8 tiles are, once rounded to
// bf16 pairs, the A operand of the next product over those 16 columns:
// P = softmax(S) and dS never leave the registers.
//
// Shared-memory tiles keep a row of D bf16 in D + 8 elements: the 16-byte
// pad shifts consecutive rows by four banks, so the eight row addresses of
// one ldmatrix phase hit distinct banks for every D in {16, 32, 64, 128}.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "philox.cuh"

namespace avsr {
namespace mma {

using bf16 = __nv_bfloat16;

// the cp.async helpers of common.cuh, under the names the kernels use
using avsr::cp_async16;
using avsr::cp_async_commit;
using avsr::cp_async_wait;
using avsr::smem_addr;

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b (m16n8k16, bf16 operands, fp32 accumulators)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the SFU (ex2.approx.ftz: ~2 ulp, subnormal results flushed to
// zero); for the probabilities that need not match the twin bit for bit
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// a / b rounded to nearest, given r = __frcp_rn(b): the product and one
// Markstein correction (exact residual by FMA), which matches IEEE
// division wherever a / b is a normal number
__device__ __forceinline__ float div_rn(float a, float b, float r) {
  const float q = __fmul_rn(a, r);
  return __fmaf_rn(__fmaf_rn(-q, b, a), r, q);
}

// two fp32 -> one register of two bf16 (round to nearest even), lo first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A operand over accumulator columns 16 kk .. 16 kk + 15, rounded.
template <int kTiles>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&x)[kTiles][4], int kk) {
  a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
  a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
  a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}

// Copies rows row0 .. row0 + kRows - 1 of a (t_len, D) matrix of T (bf16
// or fp32) into a shared tile of row stride kLd elements (the padded bf16
// rows, D + 8, by default), 16 bytes a copy, all threads of the block
// taking part; rows at or past t_len become zeros, so they add nothing to
// a product (and no NaN from stale memory).
template <int D, int kRows, int kLd = D + 8, typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int row0,
                                          int t_len) {
  constexpr int kPer = 16 / sizeof(T);  // elements a copy
  constexpr int kChunks = D / kPer;
  for (int e = threadIdx.x; e < kRows * kChunks; e += blockDim.x) {
    const int r = e / kChunks;
    const int c = e % kChunks;
    const int row = row0 + r;
    const bool ok = row < t_len;
    const T* g = ok ? src + static_cast<size_t>(row) * D + c * kPer : src;
    cp_async16(dst + r * kLd + c * kPer, g, ok);
  }
}

// A fragments (16 x 16 slice kk) of a warp's 16 rows of a padded tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* rows16,
                                       int kk, int lane) {
  ldsm_x4(a, rows16 + (lane & 15) * (D + 8) + kk * 16 + (lane >> 4) * 8);
}

// acc (16 x kN) += A (16 x D) B^T, with B a padded (kN x D) tile whose rows
// are the product's columns: Q K^T, dO V^T, K Q^T, V dO^T. `a` holds the
// warp's A fragments if kRegA, else they are read from `a_rows`.
template <int D, int kN, bool kRegA>
__device__ __forceinline__ void mma_abt(float (&acc)[kN / 8][4],
                                        const uint32_t (&a)[kRegA ? D / 16 : 1]
                                                           [4],
                                        const bf16* a_rows, const bf16* b,
                                        int lane) {
  const int brow = (lane & 7) + ((lane >> 4) & 1) * 8;
  const int bcol = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    if (kRegA) {
#pragma unroll
      for (int i = 0; i < 4; ++i) af[i] = a[kRegA ? kk : 0][i];
    } else {
      load_a<D>(af, a_rows, kk, lane);
    }
#pragma unroll
    for (int nn = 0; nn < kN / 16; ++nn) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (nn * 16 + brow) * (D + 8) + kk * 16 + bcol);
      mma16816(acc[2 * nn], af, bf[0], bf[1]);
      mma16816(acc[2 * nn + 1], af, bf[2], bf[3]);
    }
  }
}

// out (16 x D) += X (16 x kN, fp32 accumulators, rounded to bf16 here) B,
// with B a padded (kN x D) tile: P V, dS K, P~^T dO, dS^T Q.
template <int D, int kN>
__device__ __forceinline__ void mma_xb(float (&out)[D / 8][4],
                                       const float (&x)[kN / 8][4],
                                       const bf16* b, int lane) {
  const int brow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int bcol = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk) {
    uint32_t af[4];
    acc_to_a<kN / 8>(af, x, kk);
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t bf[4];
      ldsm_x4_t(bf, b + (kk * 16 + brow) * (D + 8) + dn * 16 + bcol);
      mma16816(out[2 * dn], af, bf[0], bf[1]);
      mma16816(out[2 * dn + 1], af, bf[2], bf[3]);
    }
  }
}

// Keep bits of one m16n8 fragment whose rows are queries and columns keys
// (forward, dq). Element (head n, query i, key j) is kept iff word j & 3
// of Philox4x32-10 at counter (j >> 2, i, n, 0) is below the threshold
// (philox.cuh); `head` is the row's n, DropArgs::head of its row. A lane holds keys c, c+1 of rows g and g+8, which lie in
// one 4-key group, and so does its partner lane ^ 1: the even lane draws
// the group for row g, the odd lane for row g+8, and one shuffle swaps
// the halves each needs, so every word is drawn once. `q0` is the
// fragment's first query, `k0` its first key (a multiple of 8).
// Returns bits 0/1 = (row g, keys c/c+1), bits 2/3 = (row g+8, keys c/c+1).
__device__ __forceinline__ uint32_t keep_bits_qk(uint32_t head, int q0,
                                                 int k0, int lane,
                                                 const DropArgs& a) {
  const bool odd = lane & 1;
  const int row = q0 + (lane >> 2) + (odd ? 8 : 0);
  const int group = (k0 >> 2) + ((lane & 3) >> 1);
  const Philox4 w =
      philox4x32_10(static_cast<uint32_t>(group), static_cast<uint32_t>(row),
                    head, 0u, a.seed0, a.seed1);
  const uint32_t lo = (w.x[0] < a.threshold) | ((w.x[1] < a.threshold) << 1);
  const uint32_t hi = (w.x[2] < a.threshold) | ((w.x[3] < a.threshold) << 1);
  // even lane: keys c, c+1 are words 0, 1; odd lane: words 2, 3
  const uint32_t mine = odd ? hi : lo;
  const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? lo : hi, 1);
  return odd ? (got | (mine << 2)) : (mine | (got << 2));
}

// Keep bits of one m16n8 fragment whose rows are keys and columns queries
// (dkv). The fragment's 16 keys x 8 queries need 4 x 8 draws: lane L draws
// key group L >> 3 for query L & 7, and each lane collects its four bits
// with four shuffles. `k0` is the fragment's first key (a multiple of 16),
// `q0` its first query. Bits as in keep_bits_qk with rows = keys:
// bits 0/1 = (key g, queries c/c+1), bits 2/3 = (key g+8, queries c/c+1).
__device__ __forceinline__ uint32_t keep_bits_kq(uint32_t head, int k0,
                                                 int q0, int lane,
                                                 const DropArgs& a) {
  const Philox4 w = philox4x32_10(
      static_cast<uint32_t>((k0 >> 2) + (lane >> 3)),
      static_cast<uint32_t>(q0 + (lane & 7)), head, 0u, a.seed0, a.seed1);
  uint32_t nib = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) nib |= (w.x[i] < a.threshold ? 1u : 0u) << i;
  // key g lies in group g >> 2 = lane >> 4, word g & 3; key g+8 two
  // groups on; query c + e is the source lane's column
  const int src = (lane >> 4) * 8 + 2 * (lane & 3);
  const int bit = (lane >> 2) & 3;
  const uint32_t b0 = __shfl_sync(0xffffffffu, nib, src);
  const uint32_t b1 = __shfl_sync(0xffffffffu, nib, src + 1);
  const uint32_t b2 = __shfl_sync(0xffffffffu, nib, src + 16);
  const uint32_t b3 = __shfl_sync(0xffffffffu, nib, src + 17);
  return ((b0 >> bit) & 1) | (((b1 >> bit) & 1) << 1) |
         (((b2 >> bit) & 1) << 2) | (((b3 >> bit) & 1) << 3);
}

}  // namespace mma
}  // namespace avsr
