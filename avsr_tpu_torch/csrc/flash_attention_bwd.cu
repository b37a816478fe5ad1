// Flash-attention backward for the AV-HuBERT encoder's self-attention.
//
// Replaces the Pallas TPU kernels avsr_tpu/ops/pallas/flash_attention.py
// `_resident_bwd_kernel` (:335, T <= 512, one kernel for dQ, dK, dV) and
// the streaming pair `_flash_bwd_dq_kernel` / `_flash_bwd_dkv_kernel`
// (:152, :202), with the in-kernel dropout of `_seed_prng` /
// `_rng_keep_mask` (:58, :80) redrawn from philox.cuh at the same
// absolute (head, query, key) counters as the forward. Per head n of
// (N = B*H, T, D), with P = exp(S - lse) recomputed from the forward's row
// logsumexp, M the pre-scaled keep mask (all ones without dropout) and
// delta = rowsum(dO * O):
//   dV = (P o M)^T dO,  dP = (dO V^T) o M,  dS = P o (dP - delta),
//   dQ = scale * dS K,  dK = scale * dS^T Q.
// As in the TPU kernels, P o M and dS are rounded to the operand dtype
// before their products (a no-op in fp32), and every sum accumulates in
// fp32.
//
// Two kernels a dtype, so that every output element is written by exactly
// one block and no sum needs atomics: dQ, dK and dV are bit-deterministic.
//  - dq: one block per (head, 64-query tile); it also writes delta.
//  - dkv: one block per (head, 64-key tile), over all queries.
// Both dtypes run on the tensor cores (`mma.sync`), four warps a block,
// 16 owned rows a warp (queries in dq, keys in dkv), the other side
// streaming through shared memory two stages deep by cp.async.
//
// bf16 operands (the training path): `flash_bwd_dq_mma` and
// `flash_bwd_dkv_mma`. What bounds them: at the
// training shape (N = 6*16, T = 384, D = 64) dq runs three T x T x D
// products (S and dP recomputed, dS K; 5.4 GFLOP, 5.5 us at the 989
// TFLOP/s bf16 peak) and dkv four (7.2 GFLOP, 7.3 us), against ~29 MB of
// operands each (8.6 us at 3.35 TB/s), so the bound is bytes; an exp and,
// with dropout, a quarter of a Philox call per score make the CUDA cores'
// work rival the products in practice.
//
// Design: the owned rows' A fragments stay in registers (D <= 64) while K and
// V stream in 64-key tiles for dq (32 at D = 128), Q and dO in 32-query tiles
// for dkv. All five products are `mma.sync.m16n8k16` bf16 -> fp32
// (mma_bf16.cuh): S = Q K^T and dP = dO V^T (or their transposes in dkv) into
// accumulators, P (by the SFU's 2^x) and dS formed in the registers in the
// twin's order and rounded to bf16 as the A operand of dS K (dq), P~^T dO and
// dS^T Q (dkv), whose B operands come from the same shared tiles by
// ldmatrix.trans. dq computes delta from O and dO while its first tiles load.
// At T <= 512 a head's K and V (48 KB each at T = 384, D = 64) would fit in
// shared memory whole; the two-stage ring needs 55 KB (dq) or 37 KB (dkv) a
// block instead, so three blocks share an SM, and the tiles are L2 hits either
// way (128-row blocks, which halve those reads, measured slower).
//
// fp32 operands (fp32 fine-tuning, `--compute_dtype float32`, and the
// fp32 tests and parity runs): `flash_bwd_dq_tf32` and
// `flash_bwd_dkv_tf32`, in split TF32 (mma_tf32.cuh): each operand
// x = hi + lo, both TF32, and a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b,
// three `mma.sync.m16n8k8` tf32 products a step into fp32 accumulators
// (~2^-21 of a product dropped; one TF32 product would keep ~3 digits).
// What bounds them: at the training shape (N = 96, T = 384, D = 64) a
// T x T x D product is 2 N T^2 D = 1.81 GFLOP; dq's three (S, dP, dS K)
// take 0.0811 ms at the 67 TFLOP/s of fp32 outside the tensor cores and
// dkv's four (S, dP, P~^T dO, dS^T Q) 0.1082 ms; in split TF32
// three TF32 products each, at the 495 TFLOP/s TF32 peak, 0.0330 ms (dq)
// and 0.0439 ms (dkv): the bounds these kernels are held to. Their bytes
// (q, k, v, O or nothing, dO, the outputs) take ~0.017 ms at 3.35 TB/s.
// At the muavic encoder's shape (N = 32*4, T = 375) the split-TF32
// bounds are 0.0419 ms (dq) and 0.0559 ms (dkv). In practice the CUDA
// cores' work bounds them: every B value is split (four integer and
// float operations) as a warp reads it, P takes the exact expf, and
// dropout a quarter of a Philox call a score.
//
// Design, from the fp32 forward's (`flash_fwd_tf32`): every operand stays fp32
// in shared memory and is split where a warp reads it (a second, split plane
// would double the shared memory). A block's 64 owned rows (Q and dO in dq, K
// and V in dkv) load once; dq streams K and V in 32-key tiles, dkv Q and dO in
// 32-query tiles with their queries' lse and delta (16 at D = 128), two stages
// deep: 70 KB a block at D = 64, three blocks an SM (101 KB and two at D =
// 128). Owned rows held fp32 in the registers instead (the forward's choice
// for Q) took 168-255 registers with spills or two blocks an SM, and measured
// 4-9% slower on the H100; 64-wide tiles were no faster (two blocks an SM).
// Every streamed tile is read in two patterns (`dim_a`, `mma_abt_f32`: the
// contraction over dims, 16-byte reads of a row's dims 8c .. 8c + 7 of each
// 32-dim group, for S and dP or their transposes; `mma_xb_f32`: the
// contraction over the tile's rows, reads of rows 2c and 2c + 1, for dS K or
// P~^T dO and dS^T Q), so a row holds D floats in D + 4: 4 mod 32 words, which
// keeps both patterns' reads on distinct banks. The m16n8 accumulator holds
// its columns 2c, 2c + 1, which the tf32 k8 A operand takes as k = c and c +
// 4, so P~ and dS go from the accumulators to the A operand with no shuffle.
// Each of a product's three TF32 terms is issued across four accumulators
// before the next (`mma_split_rows`), so no mma waits on the one issued just
// before it: 4-7% faster than accumulator by accumulator where the two were
// compared on the H100 (the register layout).
//
// Dropout (kDrop): the keep bits come from philox.cuh at the absolute
// counters, one draw per four scores (mma_bf16.cuh): in dq as in the
// forward (`keep_bits_qk`, a lane pair and one shuffle); in dkv, whose
// fragments hold 16 keys x 8 queries, a lane draws the 4-key group of one
// query and each lane gathers its four bits by shuffles (`keep_bits_kq`).
// The tf32 m16n8 accumulator has the bf16 one's layout, so both kernels
// of a dtype use the same draws. Keys past T and queries past T
// contribute nothing.
#include "common.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "philox.cuh"

namespace {

// ------------------------------------------------- bf16, tensor cores

namespace mm = avsr::mma;
using avsr::mma::bf16;

constexpr int kRowsMma = 64;  // owned rows a block: 16 a warp
constexpr int kThreadsMma = 2 * kRowsMma;
// blocks an SM the registers must allow (<= 168 a thread; dkv spills a
// few words with dropout): of 1 to 5, three were fastest on the H100 at
// the training and serving shapes
constexpr int kDqMinBlocks = 3;
constexpr int kDkvMinBlocks = 3;

// columns of a streamed tile: keys (dq), queries (dkv)
template <int D>
__host__ __device__ constexpr int dq_cols() {
  return D <= 64 ? 64 : 32;
}
constexpr int kDkvCols = 32;

template <int D>
constexpr int dq_smem_bytes() {  // Q, dO, two stages of K and V
  return (2 * kRowsMma + 4 * dq_cols<D>()) * (D + 8) * 2;
}

template <int D>
constexpr int dkv_smem_bytes() {  // K, V, two stages of Q and dO
  return (2 * kRowsMma + 4 * kDkvCols) * (D + 8) * 2;
}

// delta = rowsum(dO * O) in fp32 for the warp's 16 rows from device
// memory, two lanes a row (16-byte loads); returns the row of lane / 2
template <int D>
__device__ __forceinline__ float row_delta(const bf16* o, const bf16* dout,
                                           int row, int t_len, int lane) {
  float sum = 0.f;
  if (row < t_len) {
    const size_t off = static_cast<size_t>(row) * D + (lane & 1) * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 2; c += 8) {
      const uint4 ov = *reinterpret_cast<const uint4*>(o + off + c);
      const uint4 gv = *reinterpret_cast<const uint4*>(dout + off + c);
      const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 a = __bfloat1622float2(op[i]);
        const float2 b = __bfloat1622float2(gp[i]);
        sum = fmaf(b.x, a.x, sum);
        sum = fmaf(b.y, a.y, sum);
      }
    }
  }
  return sum + __shfl_xor_sync(0xffffffffu, sum, 1);
}

template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreadsMma, kDqMinBlocks)
    flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const float* __restrict__ bias,
                     const bf16* __restrict__ o,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse, bf16* __restrict__ dq,
                     float* __restrict__ delta_out, int t_len, float scale,
                     avsr::DropArgs drop) {
  namespace mm = avsr::mma;
  constexpr int kN = dq_cols<D>();
  constexpr int kLd = D + 8;
  constexpr int kTiles = kN / 8;
  constexpr bool kRegA = D <= 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + kRowsMma * kLd;
  bf16* ks = dos + kRowsMma * kLd;  // 2 stages
  bf16* vs = ks + 2 * kN * kLd;     // 2 stages

  const int n = blockIdx.y;
  const uint32_t head = drop.head(n);  // the row's dropout counter
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRowsMma;
  const int wrow = row0 + warp * 16;
  const size_t base = static_cast<size_t>(n) * t_len * D;
  const bf16* kg = k + base;
  const bf16* vg = v + base;
  const float* brow = bias + static_cast<size_t>(n) * t_len;
  const bf16* qw = qs + warp * 16 * kLd;
  const bf16* dw = dos + warp * 16 * kLd;
  const int tiles = (t_len + kN - 1) / kN;

  mm::load_rows<D, kRowsMma>(qs, q + base, row0, t_len);
  mm::load_rows<D, kRowsMma>(dos, dout + base, row0, t_len);
  mm::load_rows<D, kN>(ks, kg, 0, t_len);
  mm::load_rows<D, kN>(vs, vg, 0, t_len);
  mm::cp_async_commit();

  // delta while the tiles load; lanes 2r, 2r+1 hold row wrow + r
  const float dsum =
      row_delta<D>(o + base, dout + base, wrow + (lane >> 1), t_len, lane);
  if ((lane & 1) == 0 && wrow + (lane >> 1) < t_len)
    delta_out[static_cast<size_t>(n) * t_len + wrow + (lane >> 1)] = dsum;
  const int ra = wrow + (lane >> 2);  // row g; row g+8 is ra + 8
  const float delta[2] = {__shfl_sync(0xffffffffu, dsum, 2 * (lane >> 2)),
                          __shfl_sync(0xffffffffu, dsum, 2 * (lane >> 2) + 16)};
  // P = 2^(S scale log2e + (bias - lse) log2e) by the SFU
  const float sl2 = scale * mm::kLog2e;
  const float* lrow = lse + static_cast<size_t>(n) * t_len;
  const float lr2[2] = {ra < t_len ? lrow[ra] * mm::kLog2e : 0.f,
                        ra + 8 < t_len ? lrow[ra + 8] * mm::kLog2e : 0.f};

  uint32_t qa[kRegA ? D / 16 : 1][4];
  uint32_t da[kRegA ? D / 16 : 1][4];
  float acc[D / 8][4] = {};
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      const int st = ((t + 1) & 1) * kN * kLd;
      mm::load_rows<D, kN>(ks + st, kg, (t + 1) * kN, t_len);
      mm::load_rows<D, kN>(vs + st, vg, (t + 1) * kN, t_len);
    }
    mm::cp_async_commit();
    mm::cp_async_wait<1>();
    __syncthreads();
    if (kRegA && t == 0) {
#pragma unroll
      for (int kk = 0; kk < (kRegA ? D / 16 : 0); ++kk) {
        mm::load_a<D>(qa[kk], qw, kk, lane);
        mm::load_a<D>(da[kk], dw, kk, lane);
      }
    }
    const int k0 = t * kN;
    const bf16* kt = ks + (t & 1) * kN * kLd;
    float s[kTiles][4] = {};
    float dp[kTiles][4] = {};
    mm::mma_abt<D, kN, kRegA>(s, qa, qw, kt, lane);
    mm::mma_abt<D, kN, kRegA>(dp, da, dw, vs + (t & 1) * kN * kLd, lane);
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      uint32_t keep = 0xfu;
      if (kDrop) keep = mm::keep_bits_qk(head, wrow, k0 + j * 8, lane, drop);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + j * 8 + 2 * (lane & 3) + e;
        const bool ok = key < t_len;
        const float b2 = ok ? __ldg(brow + key) * mm::kLog2e : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = e + 2 * h;
          const float p =
              ok ? mm::exp2_approx(fmaf(s[j][i], sl2, b2 - lr2[h])) : 0.f;
          float dpv = dp[j][i];
          if (kDrop)
            dpv = __fmul_rn(dpv, (keep >> i) & 1 ? drop.inv_keep : 0.f);
          s[j][i] = __fmul_rn(p, __fsub_rn(dpv, delta[h]));  // dS
        }
      }
    }
    mm::mma_xb<D, kN>(acc, s, kt, lane);
    __syncthreads();  // the stage is overwritten two tiles on
  }

  bf16* qg = dq + base;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int d = j * 8 + 2 * (lane & 3);
    if (ra < t_len)
      *reinterpret_cast<__nv_bfloat162*>(qg + static_cast<size_t>(ra) * D +
                                         d) =
          __floats2bfloat162_rn(__fmul_rn(acc[j][0], scale),
                                __fmul_rn(acc[j][1], scale));
    if (ra + 8 < t_len)
      *reinterpret_cast<__nv_bfloat162*>(
          qg + static_cast<size_t>(ra + 8) * D + d) =
          __floats2bfloat162_rn(__fmul_rn(acc[j][2], scale),
                                __fmul_rn(acc[j][3], scale));
  }
}

template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreadsMma, kDkvMinBlocks)
    flash_bwd_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const float* __restrict__ bias,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      bf16* __restrict__ dk, bf16* __restrict__ dv,
                      int t_len, float scale, avsr::DropArgs drop) {
  namespace mm = avsr::mma;
  constexpr int kN = kDkvCols;
  constexpr int kLd = D + 8;
  constexpr int kTiles = kN / 8;
  constexpr bool kRegA = D <= 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kRowsMma * kLd;
  bf16* qs = vs + kRowsMma * kLd;  // 2 stages
  bf16* dos = qs + 2 * kN * kLd;   // 2 stages

  const int n = blockIdx.y;
  const uint32_t head = drop.head(n);  // the row's dropout counter
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int key0 = blockIdx.x * kRowsMma;
  const int wkey = key0 + warp * 16;  // the warp's first key
  const size_t base = static_cast<size_t>(n) * t_len * D;
  const bf16* qg = q + base;
  const bf16* dg = dout + base;
  const float* lrow = lse + static_cast<size_t>(n) * t_len;
  const float* drow = delta + static_cast<size_t>(n) * t_len;
  const bf16* kw = ks + warp * 16 * kLd;
  const bf16* vw = vs + warp * 16 * kLd;
  const int tiles = (t_len + kN - 1) / kN;

  mm::load_rows<D, kRowsMma>(ks, k + base, key0, t_len);
  mm::load_rows<D, kRowsMma>(vs, v + base, key0, t_len);
  mm::load_rows<D, kN>(qs, qg, 0, t_len);
  mm::load_rows<D, kN>(dos, dg, 0, t_len);
  mm::cp_async_commit();

  const int ra = wkey + (lane >> 2);  // key g; key g+8 is ra + 8
  // P = 2^(S scale log2e + (bias - lse) log2e) by the SFU
  const float sl2 = scale * mm::kLog2e;
  const float* brow = bias + static_cast<size_t>(n) * t_len;
  const float kb2[2] = {ra < t_len ? brow[ra] * mm::kLog2e : 0.f,
                        ra + 8 < t_len ? brow[ra + 8] * mm::kLog2e : 0.f};

  uint32_t ka[kRegA ? D / 16 : 1][4];
  uint32_t va[kRegA ? D / 16 : 1][4];
  float dka[D / 8][4] = {};
  float dva[D / 8][4] = {};
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      const int st = ((t + 1) & 1) * kN * kLd;
      mm::load_rows<D, kN>(qs + st, qg, (t + 1) * kN, t_len);
      mm::load_rows<D, kN>(dos + st, dg, (t + 1) * kN, t_len);
    }
    mm::cp_async_commit();
    mm::cp_async_wait<1>();
    __syncthreads();
    if (kRegA && t == 0) {
#pragma unroll
      for (int kk = 0; kk < (kRegA ? D / 16 : 0); ++kk) {
        mm::load_a<D>(ka[kk], kw, kk, lane);
        mm::load_a<D>(va[kk], vw, kk, lane);
      }
    }
    const int q0 = t * kN;
    const bf16* qt = qs + (t & 1) * kN * kLd;
    const bf16* dt = dos + (t & 1) * kN * kLd;
    float s[kTiles][4] = {};   // S^T, then P~^T
    float dp[kTiles][4] = {};  // dP^T, then dS^T
    mm::mma_abt<D, kN, kRegA>(s, ka, kw, qt, lane);
    mm::mma_abt<D, kN, kRegA>(dp, va, vw, dt, lane);
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      uint32_t keep = 0xfu;
      if (kDrop) keep = mm::keep_bits_kq(head, wkey, q0 + j * 8, lane, drop);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = q0 + j * 8 + 2 * (lane & 3) + e;
        const bool ok = qi < t_len;
        const float lq2 = ok ? __ldg(lrow + qi) * mm::kLog2e : 0.f;
        const float dl = ok ? __ldg(drow + qi) : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = e + 2 * h;
          const float p =
              ok ? mm::exp2_approx(fmaf(s[j][i], sl2, kb2[h] - lq2)) : 0.f;
          float pm = p;
          float dpv = dp[j][i];
          if (kDrop) {
            const float mk = (keep >> i) & 1 ? drop.inv_keep : 0.f;
            pm = __fmul_rn(p, mk);
            dpv = __fmul_rn(dpv, mk);
          }
          s[j][i] = pm;
          dp[j][i] = __fmul_rn(p, __fsub_rn(dpv, dl));
        }
      }
    }
    mm::mma_xb<D, kN>(dva, s, dt, lane);
    mm::mma_xb<D, kN>(dka, dp, qt, lane);
    __syncthreads();
  }

  bf16* kgo = dk + base;
  bf16* vgo = dv + base;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int d = j * 8 + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = ra + 8 * h;
      if (key >= t_len) continue;
      const size_t off = static_cast<size_t>(key) * D + d;
      *reinterpret_cast<__nv_bfloat162*>(kgo + off) = __floats2bfloat162_rn(
          __fmul_rn(dka[j][2 * h], scale), __fmul_rn(dka[j][2 * h + 1], scale));
      *reinterpret_cast<__nv_bfloat162*>(vgo + off) =
          __floats2bfloat162_rn(dva[j][2 * h], dva[j][2 * h + 1]);
    }
  }
}

// ------------------------------------------------ fp32, tensor cores

using avsr::tf32::load_vec;
using avsr::tf32::mma_split_rows;
using avsr::tf32::split_a;
using avsr::tf32::split_tf32;

constexpr int kRowsF32 = 64;  // owned rows a block: 16 a warp
constexpr int kThreadsF32 = 2 * kRowsF32;
// columns of a streamed tile at D <= 64 (half at D = 128): keys (dq),
// queries (dkv); 64 measured slower in both (two blocks an SM)
constexpr int kDqKeysF32 = 32;
constexpr int kDkvQueriesF32 = 32;
// blocks an SM the registers must allow at D <= 64 (one at D = 128;
// shared memory allows three at D = 64, two at D = 128)
constexpr int kDqF32MinBlocks = 3;
constexpr int kDkvF32MinBlocks = 3;

// The fp32 kernels' tiles, shared memory and dim orders (header).
template <int D>
struct BwdF32 {
  static constexpr int kDqCols = D <= 64 ? kDqKeysF32 : kDqKeysF32 / 2;
  static constexpr int kDkvCols =
      D <= 64 ? kDkvQueriesF32 : kDkvQueriesF32 / 2;
  // a shared row of D floats in D + 4: 4 mod 32 words at D >= 32, so the
  // two read patterns below hit distinct banks
  static constexpr int kLd = D + 4;
  static constexpr int kVec = D >= 32 ? 4 : 2;  // out's n8 tiles a B read
  static constexpr int kDqSmem =  // bytes: Q, dO rows; K, V 2 stages
      (2 * kRowsF32 + 4 * kDqCols) * kLd * 4;
  static constexpr int kDkvSmem =  // K, V rows; Q, dO, lse, delta 2 stages
      (2 * kRowsF32 + 4 * kDkvCols) * kLd * 4 + 4 * kDkvCols * 4;
  static constexpr int kDqBlocks = D <= 64 ? kDqF32MinBlocks : 1;
  static constexpr int kDkvBlocks = D <= 64 ? kDkvF32MinBlocks : 1;
};

// Read pattern A (the contraction over dims, S = Q K^T, dP = dO V^T and
// their transposes): a lane (g, c) holds of rows g and g + 8 the dims
// 32 i + 8 c .. + 7 of each 32-dim group i (4 c .. + 3 at D = 16), float4
// v of them at dim_a(v, c). A float4's (x, y) and (z, w) are the A
// fragments' k = c, c + 4 of two k-steps, and the same float4 of a B row
// (n = g) their B fragments. With rows 4 mod 32 words apart, the 16-byte
// reads of lanes 0-7 (rows g = 0, 1; chunks 2c or 2c + 1) hit distinct
// banks.
template <int D>
__device__ __forceinline__ int dim_a(int v, int c) {
  constexpr int kW = D >= 32 ? 8 : 4;  // dims a lane holds a group
  return (v / (kW / 4)) * 4 * kW + kW * c + 4 * (v % (kW / 4));
}

// acc (16 x 8 kTiles) += A (16 x D) B^T in split TF32: A the warp's 16
// shared rows `a` (rows g and g + 8), B's rows (n8 tile j: rows 8 j .. +
// 7) the shared tile `b`, both read in pattern A. Each A value is split
// once a call; the products go out four n8 tiles at a time
// (mma_split_rows).
template <int D, int kTiles, int kLd>
__device__ __forceinline__ void mma_abt_f32(float (&acc)[kTiles][4],
                                            const float* a, const float* b,
                                            int g, int c) {
  constexpr int kJ = kTiles < 4 ? kTiles : 4;
#pragma unroll
  for (int v = 0; v < D / 16; ++v) {
    const int off = dim_a<D>(v, c);
    const float4 a0 = *reinterpret_cast<const float4*>(a + g * kLd + off);
    const float4 a1 =
        *reinterpret_cast<const float4*>(a + (g + 8) * kLd + off);
    uint32_t ah[2][4], al[2][4];
    split_a(ah[0], al[0], a0.x, a1.x, a0.y, a1.y);
    split_a(ah[1], al[1], a0.z, a1.z, a0.w, a1.w);
#pragma unroll
    for (int j0 = 0; j0 < kTiles; j0 += kJ) {
      uint32_t bh[2][kJ][2], bl[2][kJ][2];  // [k-step][tile][k = c, c+4]
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        const float4 bf = *reinterpret_cast<const float4*>(
            b + (8 * (j0 + jj) + g) * kLd + off);
        split_tf32(bf.x, bh[0][jj][0], bl[0][jj][0]);
        split_tf32(bf.y, bh[0][jj][1], bl[0][jj][1]);
        split_tf32(bf.z, bh[1][jj][0], bl[1][jj][0]);
        split_tf32(bf.w, bh[1][jj][1], bl[1][jj][1]);
      }
      mma_split_rows<kJ>(acc + j0, ah[0], al[0], bh[0], bl[0]);
      mma_split_rows<kJ>(acc + j0, ah[1], al[1], bh[1], bl[1]);
    }
  }
}

// Read pattern B (the contraction over a tile's rows: dS K, P~^T dO,
// dS^T Q): out (16 x D) += X (16 x 8 kTiles, accumulators) B, B the
// shared tile `b` of 8 kTiles rows. The m16n8 accumulator holds X's
// columns 2c and 2c + 1, which the tf32 k8 A operand takes as k = c and
// c + 4, so X goes to the A operand with no shuffle and the lane reads B
// rows 2c and 2c + 1; out's column n of n8 tile dn is dim
// 8 w (dn / w) + w n + dn % w (w = kVec), so one 16-byte read (8 at
// D = 16) holds w tiles' B values, whose products go out together
// (mma_split_rows). Lanes 0-7 read rows 2c (or 2c + 1) at chunk g:
// distinct banks with rows 4 mod 32 words apart.
template <int D, int kTiles, int kLd>
__device__ __forceinline__ void mma_xb_f32(float (&out)[D / 8][4],
                                           const float (&x)[kTiles][4],
                                           const float* b, int g, int c) {
  constexpr int kVec = BwdF32<D>::kVec;
  const float* bt = b + 2 * c * kLd + g * kVec;
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    uint32_t xh[4], xl[4];
    split_a(xh, xl, x[j][0], x[j][2], x[j][1], x[j][3]);
    const float* bj = bt + 8 * j * kLd;
#pragma unroll
    for (int gr = 0; gr < D / (8 * kVec); ++gr) {
      float b0[kVec], b1[kVec];
      load_vec<kVec>(b0, bj + gr * 8 * kVec);
      load_vec<kVec>(b1, bj + kLd + gr * 8 * kVec);
      uint32_t bh[kVec][2], bl[kVec][2];
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        split_tf32(b0[e], bh[e][0], bl[e][0]);
        split_tf32(b1[e], bh[e][1], bl[e][1]);
      }
      mma_split_rows<kVec>(out + gr * kVec, xh, xl, bh, bl);
    }
  }
}

// rows g and g + 8 of out (pattern B's dim order) times `mul` into the
// (t_len, D) rows `dst` from row `row0`; rows at or past t_len are not
// written
template <int D>
__device__ __forceinline__ void store_rows_f32(float* dst,
                                               const float (&o)[D / 8][4],
                                               int row0, int t_len,
                                               float mul, int g, int c) {
  constexpr int kVec = BwdF32<D>::kVec;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= t_len) continue;
#pragma unroll
    for (int gr = 0; gr < D / (8 * kVec); ++gr) {
      float x[2 * kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        x[e] = __fmul_rn(o[gr * kVec + e][2 * h], mul);
        x[kVec + e] = __fmul_rn(o[gr * kVec + e][2 * h + 1], mul);
      }
      float4* d4 = reinterpret_cast<float4*>(
          dst + static_cast<size_t>(row) * D + 8 * kVec * gr + 2 * c * kVec);
#pragma unroll
      for (int e = 0; e < kVec / 2; ++e)
        d4[e] = make_float4(x[4 * e], x[4 * e + 1], x[4 * e + 2],
                            x[4 * e + 3]);
    }
  }
}

// P = exp(S scale + bias - lse), as the twin orders it
__device__ __forceinline__ float prob_f32(float s, float scale, float b,
                                          float l) {
  return expf(__fsub_rn(__fadd_rn(__fmul_rn(s, scale), b), l));
}

template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreadsF32, BwdF32<D>::kDqBlocks)
    flash_bwd_dq_tf32(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ bias,
                      const float* __restrict__ o,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ dq,
                      float* __restrict__ delta_out, int t_len, float scale,
                      avsr::DropArgs drop) {
  using L = BwdF32<D>;
  constexpr int kN = L::kDqCols;
  constexpr int kTiles = kN / 8;
  constexpr int kLd = L::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // the block's Q rows
  float* dos = qs + kRowsF32 * kLd;                // its dO rows
  float* ks = dos + kRowsF32 * kLd;                // 2 stages
  float* vs = ks + 2 * kN * kLd;                   // 2 stages

  const int n = blockIdx.y;
  const uint32_t head = drop.head(n);  // the row's dropout counter
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int row0 = blockIdx.x * kRowsF32;
  const int wrow = row0 + warp * 16;  // the warp's first query
  const size_t base = static_cast<size_t>(n) * t_len * D;
  const float* kg = k + base;
  const float* vg = v + base;
  const float* brow = bias + static_cast<size_t>(n) * t_len;
  const int tiles = (t_len + kN - 1) / kN;

  mm::load_rows<D, kRowsF32, kLd>(qs, q + base, row0, t_len);
  mm::load_rows<D, kRowsF32, kLd>(dos, dout + base, row0, t_len);
  mm::load_rows<D, kN, kLd>(ks, kg, 0, t_len);
  mm::load_rows<D, kN, kLd>(vs, vg, 0, t_len);
  avsr::cp_async_commit();

  // while they load: delta = rowsum(dO o O) of rows g and g + 8 (the
  // quad's four lanes read a row's dims in pattern A), and their lse
  float delta[2], lr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wrow + g + 8 * h;
    const bool ok = row < t_len;
    const size_t roff = base + static_cast<size_t>(row) * D;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < D / 16; ++i) {
      const int off = dim_a<D>(i, c);
      const float4 d4 =
          ok ? __ldg(reinterpret_cast<const float4*>(dout + roff + off))
             : zero;
      const float4 o4 =
          ok ? __ldg(reinterpret_cast<const float4*>(o + roff + off)) : zero;
      sum = fmaf(d4.x, o4.x, sum);
      sum = fmaf(d4.y, o4.y, sum);
      sum = fmaf(d4.z, o4.z, sum);
      sum = fmaf(d4.w, o4.w, sum);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    delta[h] = sum;
    lr[h] = ok ? lse[static_cast<size_t>(n) * t_len + row] : 0.f;
    if (ok && c == 0) delta_out[static_cast<size_t>(n) * t_len + row] = sum;
  }

  float acc[D / 8][4] = {};
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      const int st = ((t + 1) & 1) * kN * kLd;
      mm::load_rows<D, kN, kLd>(ks + st, kg, (t + 1) * kN, t_len);
      mm::load_rows<D, kN, kLd>(vs + st, vg, (t + 1) * kN, t_len);
    }
    avsr::cp_async_commit();
    avsr::cp_async_wait<1>();
    __syncthreads();
    const int k0 = t * kN;
    const float* kt = ks + (t & 1) * kN * kLd;
    float s[kTiles][4] = {};   // S, then dS
    float dp[kTiles][4] = {};  // dP
    mma_abt_f32<D, kTiles, kLd>(s, qs + warp * 16 * kLd, kt, g, c);
    mma_abt_f32<D, kTiles, kLd>(dp, dos + warp * 16 * kLd,
                                vs + (t & 1) * kN * kLd, g, c);
    // dS = P o (dP o M - delta); the lane holds keys 2c, 2c + 1 of n8
    // tile j for rows g (i = 0, 1) and g + 8 (i = 2, 3)
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      uint32_t keep = 0xfu;
      if (kDrop) keep = mm::keep_bits_qk(head, wrow, k0 + 8 * j, lane, drop);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * c + e;
        const bool ok = key < t_len;
        const float b = ok ? __ldg(brow + key) : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = e + 2 * h;
          const float p = ok ? prob_f32(s[j][i], scale, b, lr[h]) : 0.f;
          float dpv = dp[j][i];
          if (kDrop)
            dpv = __fmul_rn(dpv, (keep >> i) & 1 ? drop.inv_keep : 0.f);
          s[j][i] = __fmul_rn(p, __fsub_rn(dpv, delta[h]));
        }
      }
    }
    mma_xb_f32<D, kTiles, kLd>(acc, s, kt, g, c);  // dQ += dS K
    __syncthreads();  // the stage is overwritten two tiles on
  }
  store_rows_f32<D>(dq + base, acc, wrow, t_len, scale, g, c);
}

template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreadsF32, BwdF32<D>::kDkvBlocks)
    flash_bwd_dkv_tf32(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ bias,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv,
                       int t_len, float scale, avsr::DropArgs drop) {
  using L = BwdF32<D>;
  constexpr int kN = L::kDkvCols;
  constexpr int kTiles = kN / 8;
  constexpr int kLd = L::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);  // the block's K rows
  float* vs = ks + kRowsF32 * kLd;                 // its V rows
  float* qs = vs + kRowsF32 * kLd;                 // 2 stages
  float* dos = qs + 2 * kN * kLd;                  // 2 stages
  float* ls = dos + 2 * kN * kLd;                  // lse, 2 stages
  float* dls = ls + 2 * kN;                        // delta, 2 stages

  const int n = blockIdx.y;
  const uint32_t head = drop.head(n);  // the row's dropout counter
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int key0 = blockIdx.x * kRowsF32;
  const int wkey = key0 + warp * 16;  // the warp's first key
  const size_t base = static_cast<size_t>(n) * t_len * D;
  const float* qg = q + base;
  const float* dg = dout + base;
  const float* lrow = lse + static_cast<size_t>(n) * t_len;
  const float* drow = delta + static_cast<size_t>(n) * t_len;
  const int tiles = (t_len + kN - 1) / kN;

  // a tile's Q and dO rows, and its queries' lse and delta (a query past
  // t_len reads the last one's: its P is zero)
  auto load_tile = [&](int st, int q0) {
    mm::load_rows<D, kN, kLd>(qs + st * kN * kLd, qg, q0, t_len);
    mm::load_rows<D, kN, kLd>(dos + st * kN * kLd, dg, q0, t_len);
    const int i = threadIdx.x;
    if (i < 2 * kN) {
      const int qi = min(q0 + (i % kN), t_len - 1);
      avsr::cp_async4((i < kN ? ls : dls) + st * kN + i % kN,
                      (i < kN ? lrow : drow) + qi);
    }
  };
  mm::load_rows<D, kRowsF32, kLd>(ks, k + base, key0, t_len);
  mm::load_rows<D, kRowsF32, kLd>(vs, v + base, key0, t_len);
  load_tile(0, 0);
  avsr::cp_async_commit();

  float kb[2];  // the bias of keys g and g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = wkey + g + 8 * h;
    kb[h] = key < t_len ? bias[static_cast<size_t>(n) * t_len + key] : 0.f;
  }

  float dka[D / 8][4] = {};
  float dva[D / 8][4] = {};
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) load_tile((t + 1) & 1, (t + 1) * kN);
    avsr::cp_async_commit();
    avsr::cp_async_wait<1>();
    __syncthreads();
    const int q0 = t * kN;
    const float* qt = qs + (t & 1) * kN * kLd;
    const float* dt = dos + (t & 1) * kN * kLd;
    const float* lt = ls + (t & 1) * kN;
    const float* dlt = dls + (t & 1) * kN;
    float s[kTiles][4] = {};   // S^T, then P~^T
    float dp[kTiles][4] = {};  // dP^T, then dS^T
    mma_abt_f32<D, kTiles, kLd>(s, ks + warp * 16 * kLd, qt, g, c);
    mma_abt_f32<D, kTiles, kLd>(dp, vs + warp * 16 * kLd, dt, g, c);
    // the lane holds queries 2c, 2c + 1 of n8 tile j for keys g (i = 0,
    // 1) and g + 8 (i = 2, 3)
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      uint32_t keep = 0xfu;
      if (kDrop) keep = mm::keep_bits_kq(head, wkey, q0 + 8 * j, lane, drop);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * c + e;
        const bool ok = q0 + col < t_len;
        const float lq = lt[col];
        const float dl = dlt[col];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = e + 2 * h;
          const float p = ok ? prob_f32(s[j][i], scale, kb[h], lq) : 0.f;
          float pm = p;
          float dpv = dp[j][i];
          if (kDrop) {
            const float mk = (keep >> i) & 1 ? drop.inv_keep : 0.f;
            pm = __fmul_rn(p, mk);
            dpv = __fmul_rn(dpv, mk);
          }
          s[j][i] = pm;
          dp[j][i] = __fmul_rn(p, __fsub_rn(dpv, dl));
        }
      }
    }
    mma_xb_f32<D, kTiles, kLd>(dva, s, dt, g, c);   // dV += P~^T dO
    mma_xb_f32<D, kTiles, kLd>(dka, dp, qt, g, c);  // dK += dS^T Q
    __syncthreads();  // the stage is overwritten two tiles on
  }
  store_rows_f32<D>(dk + base, dka, wkey, t_len, scale, g, c);
  store_rows_f32<D>(dv + base, dva, wkey, t_len, 1.f, g, c);
}

struct Args {
  const void *q, *k, *v;
  const float* bias;
  const void* o;  // dq: the forward's output
  const void* dout;
  const float* lse;
  const float* delta;  // dkv: input
  void *g0, *g1;       // dq: dq and delta; dkv: dk and dv
  int n, t;
  float scale;
  bool dropout;
  avsr::DropArgs drop;
};

dim3 grid_of(const Args& a, int rows) {
  return dim3((a.t + rows - 1) / rows, a.n);
}

// lifts the 48 KB default where a kernel's dynamic shared memory needs it
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <bool kDkv, int D, bool kDrop>
cudaError_t launch_mma(const Args& a, cudaStream_t s) {
  const dim3 grid = grid_of(a, kRowsMma);
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  cudaError_t err;
  if (kDkv) {
    constexpr int kSmem = dkv_smem_bytes<D>();
    auto kernel = &flash_bwd_dkv_mma<D, kDrop>;
    err = allow_smem(kernel, kSmem);
    if (err == cudaSuccess)
      kernel<<<grid, kThreadsMma, kSmem, s>>>(
          q, k, v, a.bias, dout, a.lse, a.delta, static_cast<bf16*>(a.g0),
          static_cast<bf16*>(a.g1), a.t, a.scale, a.drop);
  } else {
    constexpr int kSmem = dq_smem_bytes<D>();
    auto kernel = &flash_bwd_dq_mma<D, kDrop>;
    err = allow_smem(kernel, kSmem);
    if (err == cudaSuccess)
      kernel<<<grid, kThreadsMma, kSmem, s>>>(
          q, k, v, a.bias, static_cast<const bf16*>(a.o), dout, a.lse,
          static_cast<bf16*>(a.g0), static_cast<float*>(a.g1), a.t, a.scale,
          a.drop);
  }
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool kDkv, int D, bool kDrop>
cudaError_t launch_tf32(const Args& a, cudaStream_t s) {
  using L = BwdF32<D>;
  const dim3 grid = grid_of(a, kRowsF32);
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  cudaError_t err;
  if (kDkv) {
    auto kernel = &flash_bwd_dkv_tf32<D, kDrop>;
    err = allow_smem(kernel, L::kDkvSmem);
    if (err == cudaSuccess)
      kernel<<<grid, kThreadsF32, L::kDkvSmem, s>>>(
          q, k, v, a.bias, dout, a.lse, a.delta, static_cast<float*>(a.g0),
          static_cast<float*>(a.g1), a.t, a.scale, a.drop);
  } else {
    auto kernel = &flash_bwd_dq_tf32<D, kDrop>;
    err = allow_smem(kernel, L::kDqSmem);
    if (err == cudaSuccess)
      kernel<<<grid, kThreadsF32, L::kDqSmem, s>>>(
          q, k, v, a.bias, static_cast<const float*>(a.o), dout, a.lse,
          static_cast<float*>(a.g0), static_cast<float*>(a.g1), a.t, a.scale,
          a.drop);
  }
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool kDkv, bool kBf16, int D>
cudaError_t launch_dim(const Args& a, cudaStream_t s) {
  if (kBf16)
    return a.dropout ? launch_mma<kDkv, D, true>(a, s)
                     : launch_mma<kDkv, D, false>(a, s);
  return a.dropout ? launch_tf32<kDkv, D, true>(a, s)
                   : launch_tf32<kDkv, D, false>(a, s);
}

template <bool kDkv, bool kBf16>
cudaError_t launch_typed(const Args& a, int d, cudaStream_t s) {
  switch (d) {
    case 16:
      return launch_dim<kDkv, kBf16, 16>(a, s);
    case 32:
      return launch_dim<kDkv, kBf16, 32>(a, s);
    case 64:
      return launch_dim<kDkv, kBf16, 64>(a, s);
    case 128:
      return launch_dim<kDkv, kBf16, 128>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// bf16 as bf16, fp32 in split TF32, both on the tensor cores
template <bool kDkv>
int launch(const Args& a, int d, int dtype, void* stream) {
  if (a.n <= 0 || a.t <= 0 || a.n > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == avsr::kFloat32)
    err = launch_typed<kDkv, false>(a, d, s);
  else if (dtype == avsr::kBFloat16)
    err = launch_typed<kDkv, true>(a, d, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

bool head_map_ok(int heads_local, int heads_total, int head_base) {
  return heads_local >= 1 && head_base >= 0 &&
         head_base + heads_local <= heads_total;
}

}  // namespace

// q, k, v, o, dout, dq: (n, t, d) contiguous, dtype `dtype`, 16-byte
// aligned; bias, lse and the written delta: (n, t) fp32. Dropout
// arguments as in avsr_flash_attention_fwd.
extern "C" int avsr_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const float* bias,
    const void* o, const void* dout, const float* lse, void* dq, float* delta,
    int n, int t, int d, float scale, int dropout, uint32_t threshold,
    float inv_keep, uint32_t seed0, uint32_t seed1, int heads_local,
    int heads_total, int head_base, int dtype, void* stream) {
  if (!head_map_ok(heads_local, heads_total, head_base))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, bias, o, dout, lse, nullptr, dq, delta, n, t, scale,
               dropout != 0,
               {threshold, inv_keep, seed0, seed1, heads_local, heads_total,
                head_base}};
  return launch<false>(a, d, dtype, stream);
}

// q, k, v, dout, dk, dv: (n, t, d) contiguous, dtype `dtype`, 16-byte
// aligned; bias, lse and delta (from avsr_flash_attention_bwd_dq): (n, t)
// fp32.
extern "C" int avsr_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const float* bias,
    const void* dout, const float* lse, const float* delta, void* dk,
    void* dv, int n, int t, int d, float scale, int dropout,
    uint32_t threshold, float inv_keep, uint32_t seed0, uint32_t seed1,
    int heads_local, int heads_total, int head_base, int dtype,
    void* stream) {
  if (!head_map_ok(heads_local, heads_total, head_base))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, bias, nullptr, dout, lse, delta, dk, dv, n, t, scale,
               dropout != 0,
               {threshold, inv_keep, seed0, seed1, heads_local, heads_total,
                head_base}};
  return launch<true>(a, d, dtype, stream);
}
