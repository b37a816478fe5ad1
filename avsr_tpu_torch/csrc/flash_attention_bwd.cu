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
// before their products, and every sum accumulates in fp32.
//
// Two kernels, so that every output element is written by exactly one
// block and no sum needs atomics: dQ, dK and dV are bit-deterministic.
//  - dq: one block per (head, 64-query tile); it also writes delta.
//  - dkv: one block per (head, 64-key tile), over all queries.
//
// bf16 operands (the training path): `flash_bwd_dq_mma` and
// `flash_bwd_dkv_mma`, on the tensor cores. What bounds them: at the
// training shape (N = 6*16, T = 384, D = 64) dq runs three T x T x D
// products (S and dP recomputed, dS K; 5.4 GFLOP, 5.5 us at the 989
// TFLOP/s bf16 peak) and dkv four (7.2 GFLOP, 7.3 us), against ~29 MB of
// operands each (8.6 us at 3.35 TB/s), so the bound is bytes; an exp and,
// with dropout, a quarter of a Philox call per score make the CUDA cores'
// work rival the products in practice.
//
// Design: four warps a block, 16 owned rows a warp (queries in dq, keys
// in dkv), whose A fragments stay in registers (D <= 64) while the other
// side streams through shared memory two stages deep by cp.async: K and
// V in 64-key tiles for dq (32 at D = 128), Q and dO in 32-query tiles
// for dkv. All five products are `mma.sync.m16n8k16` bf16 -> fp32
// (mma_bf16.cuh): S = Q K^T and dP = dO V^T (or their transposes in dkv)
// into accumulators, P (by the SFU's 2^x) and dS formed in the registers
// in the twin's order and rounded to bf16 as the A operand of dS K (dq),
// P~^T dO and dS^T Q (dkv), whose B operands come from the same shared
// tiles by ldmatrix.trans. dq computes delta from O and dO
// while its first tiles load. At T <= 512 a head's K and V (48 KB each
// at T = 384, D = 64) would fit in shared memory whole; the two-stage
// ring needs 55 KB (dq) or 37 KB (dkv) a block instead, so three blocks
// share an SM, and the tiles are L2 hits either way (128-row blocks,
// which halve those reads, measured slower).
//
// Dropout (kDrop): the keep bits come from philox.cuh at the absolute
// counters, one draw per four scores (mma_bf16.cuh): in dq as in the
// forward (`keep_bits_qk`, a lane pair and one shuffle); in dkv, whose
// fragments hold 16 keys x 8 queries, a lane draws the 4-key group of one
// query and each lane gathers its four bits by shuffles (`keep_bits_kq`).
//
// fp32 operands (the fp32 tests and parity runs): `flash_bwd_dq_simt` and
// `flash_bwd_dkv_simt`, the CUDA-core kernels of the port's first
// version, since on the tensor cores fp32 would run as TF32. Four threads
// a row in registers, the other side's 32-row tiles (16 at D = 128) in
// shared memory, dropout bits drawn into shared memory a tile at a time.
// Keys past T and queries past T contribute nothing.
#include "common.cuh"
#include "mma_bf16.cuh"
#include "philox.cuh"

namespace {

// ------------------------------------------------------------- fp32, SIMT

constexpr int kRows = 64;   // rows a block owns: queries (dq) or keys (dkv)
constexpr int kTile = 32;   // columns of a streamed tile: keys or queries
constexpr int kSub = 4;     // threads per owned row
constexpr int kThreads = kRows * kSub;
constexpr int kPerThread = kTile / kSub;  // tile columns a thread handles

template <int D>
__device__ __forceinline__ float dot_row(const float (&r)[D], const float* s) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) acc = fmaf(r[d], s[d], acc);
  return acc;
}

template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_simt(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ bias,
                      const float* __restrict__ o,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ dq,
                      float* __restrict__ delta_out, int t_len, float scale,
                      avsr::DropArgs drop) {
  constexpr int kDims = D / kSub;
  __shared__ float ks[kTile][D + 1];
  __shared__ float vs[kTile][D + 1];
  __shared__ float dss[kRows][kTile + 1];
  __shared__ uint8_t keep[kDrop ? kRows : 1][kTile];

  const int n = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = tid / kSub;
  const int c = tid % kSub;
  const int row = blockIdx.x * kRows + r;
  const bool row_ok = row < t_len;
  const size_t base = static_cast<size_t>(n) * t_len * D;
  const size_t roff = base + static_cast<size_t>(row) * D;
  const float* brow = bias + static_cast<size_t>(n) * t_len;

  float qr[D], dor[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = row_ok ? q[roff + d] : 0.f;
    dor[d] = row_ok ? dout[roff + d] : 0.f;
  }
  // delta = rowsum(dO * O): a quarter of the dims a sub-lane, then summed
  float delta = 0.f;
#pragma unroll
  for (int i = 0; i < kDims; ++i) {
    const int d = c + kSub * i;
    delta += row_ok ? dor[d] * o[roff + d] : 0.f;
  }
  delta += __shfl_xor_sync(0xffffffffu, delta, 1);
  delta += __shfl_xor_sync(0xffffffffu, delta, 2);
  const float row_lse =
      row_ok ? lse[static_cast<size_t>(n) * t_len + row] : 0.f;
  float acc[kDims];
#pragma unroll
  for (int i = 0; i < kDims; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < t_len; k0 += kTile) {
    for (int e = tid; e < kTile * D; e += kThreads) {
      const int j = e / D;
      const int d = e % D;
      const int key = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < t_len) {
        const size_t off = base + static_cast<size_t>(key) * D + d;
        kv = k[off];
        vv = v[off];
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    if (kDrop)
      avsr::fill_keep_tile(&keep[0][0], kTile, kRows, kTile, n,
                           blockIdx.x * kRows, k0, drop);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int j = c + kSub * i;
      const int key = k0 + j;
      float ds = 0.f;
      if (key < t_len && row_ok) {
        const float s = dot_row<D>(qr, ks[j]) * scale + brow[key];
        const float p = expf(s - row_lse);
        float dp = dot_row<D>(dor, vs[j]);
        if (kDrop) dp = keep[r][j] ? dp * drop.inv_keep : 0.f;
        ds = p * (dp - delta);
      }
      dss[r][j] = ds;
    }
    __syncwarp();  // dss[r][*] is read only by the row's own kSub lanes

#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float ds = dss[r][j];
#pragma unroll
      for (int i = 0; i < kDims; ++i)
        acc[i] = fmaf(ds, ks[j][c + kSub * i], acc[i]);
    }
    __syncthreads();  // tiles are overwritten by the next iteration
  }

  if (row_ok) {
#pragma unroll
    for (int i = 0; i < kDims; ++i)
      dq[roff + c + kSub * i] = acc[i] * scale;
    if (c == 0) delta_out[static_cast<size_t>(n) * t_len + row] = delta;
  }
}

template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_simt(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ bias,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv,
                       int t_len, float scale, avsr::DropArgs drop) {
  constexpr int kDims = D / kSub;
  // 16-query tiles at D = 128 keep the block under 48 KB of shared memory
  constexpr int kQ = D >= 128 ? kTile / 2 : kTile;
  constexpr int kPer = kQ / kSub;
  __shared__ float qs[kQ][D + 1];
  __shared__ float dos[kQ][D + 1];
  __shared__ float lse_s[kQ];
  __shared__ float delta_s[kQ];
  __shared__ float pms[kRows][kQ + 1];
  __shared__ float dss[kRows][kQ + 1];
  // keep bits of the tile, query-major as the Philox counters run
  __shared__ uint8_t keep[kDrop ? kQ : 1][kRows];

  const int n = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = tid / kSub;  // key row within the block
  const int c = tid % kSub;
  const int key = blockIdx.x * kRows + r;
  const bool key_ok = key < t_len;
  const size_t base = static_cast<size_t>(n) * t_len * D;
  const size_t koff = base + static_cast<size_t>(key) * D;
  const float* stat = lse + static_cast<size_t>(n) * t_len;
  const float* dstat = delta + static_cast<size_t>(n) * t_len;
  const float key_bias = key_ok ? bias[static_cast<size_t>(n) * t_len + key]
                                : 0.f;

  float kr[D], vr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kr[d] = key_ok ? k[koff + d] : 0.f;
    vr[d] = key_ok ? v[koff + d] : 0.f;
  }
  float dk_acc[kDims], dv_acc[kDims];
#pragma unroll
  for (int i = 0; i < kDims; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int q0 = 0; q0 < t_len; q0 += kQ) {
    for (int e = tid; e < kQ * D; e += kThreads) {
      const int j = e / D;
      const int d = e % D;
      const int qi = q0 + j;
      float qv = 0.f, dov = 0.f;
      if (qi < t_len) {
        const size_t off = base + static_cast<size_t>(qi) * D + d;
        qv = q[off];
        dov = dout[off];
      }
      qs[j][d] = qv;
      dos[j][d] = dov;
    }
    if (tid < kQ) {
      const bool ok = q0 + tid < t_len;
      lse_s[tid] = ok ? stat[q0 + tid] : 0.f;
      delta_s[tid] = ok ? dstat[q0 + tid] : 0.f;
    }
    if (kDrop)
      avsr::fill_keep_tile(&keep[0][0], kRows, kQ, kRows, n, q0,
                           blockIdx.x * kRows, drop);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = c + kSub * i;  // query within the tile
      float pm = 0.f, ds = 0.f;
      if (q0 + j < t_len && key_ok) {
        const float s = dot_row<D>(kr, qs[j]) * scale + key_bias;
        const float p = expf(s - lse_s[j]);
        float dp = dot_row<D>(vr, dos[j]);
        pm = p;
        if (kDrop) {
          const float mk = keep[j][r] ? drop.inv_keep : 0.f;
          pm = p * mk;
          dp = dp * mk;
        }
        ds = p * (dp - delta_s[j]);
      }
      pms[r][j] = pm;
      dss[r][j] = ds;
    }
    __syncwarp();

#pragma unroll 4
    for (int j = 0; j < kQ; ++j) {
      const float pm = pms[r][j];
      const float ds = dss[r][j];
#pragma unroll
      for (int i = 0; i < kDims; ++i) {
        dv_acc[i] = fmaf(pm, dos[j][c + kSub * i], dv_acc[i]);
        dk_acc[i] = fmaf(ds, qs[j][c + kSub * i], dk_acc[i]);
      }
    }
    __syncthreads();
  }

  if (key_ok) {
#pragma unroll
    for (int i = 0; i < kDims; ++i) {
      dk[koff + c + kSub * i] = dk_acc[i] * scale;
      dv[koff + c + kSub * i] = dv_acc[i];
    }
  }
}


// ------------------------------------------------- bf16, tensor cores

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
      if (kDrop) keep = mm::keep_bits_qk(n, wrow, k0 + j * 8, lane, drop);
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
      if (kDrop) keep = mm::keep_bits_kq(n, wkey, q0 + j * 8, lane, drop);
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
cudaError_t launch_simt(const Args& a, cudaStream_t s) {
  const dim3 grid = grid_of(a, kRows);
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  if (kDkv)
    flash_bwd_dkv_simt<D, kDrop><<<grid, kThreads, 0, s>>>(
        q, k, v, a.bias, dout, a.lse, a.delta, static_cast<float*>(a.g0),
        static_cast<float*>(a.g1), a.t, a.scale, a.drop);
  else
    flash_bwd_dq_simt<D, kDrop><<<grid, kThreads, 0, s>>>(
        q, k, v, a.bias, static_cast<const float*>(a.o), dout, a.lse,
        static_cast<float*>(a.g0), static_cast<float*>(a.g1), a.t, a.scale,
        a.drop);
  return cudaGetLastError();
}

template <bool kDkv, bool kMma, int D>
cudaError_t launch_dim(const Args& a, cudaStream_t s) {
  if (kMma)
    return a.dropout ? launch_mma<kDkv, D, true>(a, s)
                     : launch_mma<kDkv, D, false>(a, s);
  return a.dropout ? launch_simt<kDkv, D, true>(a, s)
                   : launch_simt<kDkv, D, false>(a, s);
}

template <bool kDkv, bool kMma>
cudaError_t launch_typed(const Args& a, int d, cudaStream_t s) {
  switch (d) {
    case 16:
      return launch_dim<kDkv, kMma, 16>(a, s);
    case 32:
      return launch_dim<kDkv, kMma, 32>(a, s);
    case 64:
      return launch_dim<kDkv, kMma, 64>(a, s);
    case 128:
      return launch_dim<kDkv, kMma, 128>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// bf16 on the tensor cores, fp32 on the CUDA cores
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

}  // namespace

// q, k, v, o, dout, dq: (n, t, d) contiguous, dtype `dtype` (bf16: 16-byte
// aligned); bias, lse and the written delta: (n, t) fp32. Dropout
// arguments as in avsr_flash_attention_fwd.
extern "C" int avsr_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const float* bias,
    const void* o, const void* dout, const float* lse, void* dq, float* delta,
    int n, int t, int d, float scale, int dropout, uint32_t threshold,
    float inv_keep, uint32_t seed0, uint32_t seed1, int dtype, void* stream) {
  const Args a{q, k, v, bias, o, dout, lse, nullptr, dq, delta, n, t, scale,
               dropout != 0, {threshold, inv_keep, seed0, seed1}};
  return launch<false>(a, d, dtype, stream);
}

// q, k, v, dout, dk, dv: (n, t, d) contiguous, dtype `dtype` (bf16: 16-byte
// aligned); bias, lse and delta (from avsr_flash_attention_bwd_dq): (n, t)
// fp32.
extern "C" int avsr_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const float* bias,
    const void* dout, const float* lse, const float* delta, void* dk,
    void* dv, int n, int t, int d, float scale, int dropout,
    uint32_t threshold, float inv_keep, uint32_t seed0, uint32_t seed1,
    int dtype, void* stream) {
  const Args a{q, k, v, bias, nullptr, dout, lse, delta, dk, dv, n, t, scale,
               dropout != 0, {threshold, inv_keep, seed0, seed1}};
  return launch<true>(a, d, dtype, stream);
}
