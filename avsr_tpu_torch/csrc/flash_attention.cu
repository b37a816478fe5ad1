// Flash-attention forward for the AV-HuBERT encoder's self-attention.
//
// Replaces the Pallas TPU kernels avsr_tpu/ops/pallas/flash_attention.py
// `_resident_fwd_kernel` (:296, T <= 512) and `_flash_fwd_kernel` (:96,
// streaming), with the in-kernel dropout of `_seed_prng` / `_rng_keep_mask`
// (:58, :80): out = softmax(q k^T * scale + key_bias) v per row n of
// (N = B*H, T, D), plus the per-query logsumexp `lse` that the backward
// pass needs. One kernel a dtype serves any T; both run on the tensor
// cores, one block of four warps per (row n, 64-query tile), a warp owning
// 16 query rows, K and V streaming through shared memory in 64-key tiles,
// two stages deep, by cp.async: the next tile loads while this one
// computes. Keys past T score -inf and load as zeros.
//
// bf16 operands (the serving and training paths): `flash_fwd_mma`. What
// bounds it: at the training shape (N = 6*16, T = 384, D = 64) the
// function is 3.6 GFLOP of score and value products (3.7 us at the 989
// TFLOP/s bf16 peak) against ~19 MB of q/k/v/bias/out/lse (5.7 us at 3.35
// TB/s), so the bound is bytes; the kernel does 1.5x the products (below)
// and two exps, a division and, with dropout, a quarter of a Philox call
// per score, so in practice the CUDA cores' exp, division and integer work
// and the mma issue rate bound it, not memory.
//
// Its design: Q's fragments stay in registers (D <= 64) and every product
// is `mma.sync.m16n8k16` bf16 -> fp32 (mma_bf16.cuh). The TPU kernel
// normalises the probabilities and only then rounds them to bf16 for the
// value product (flash_attention.py:328); to compute the same numbers the
// kernel makes two passes over the keys:
//  1. S = Q K^T tile by tile, keeping only the row max m and the row sum
//     l of exp(S - m) (online: l is rescaled when m grows; the SFU's
//     2^x, since l only has to be near the twin's);
//  2. S again, P = expf(S - m), times the pre-scaled keep mask M (0 or
//     1/keep) and divided by l in that order (the twin's, ops/kernels/
//     flash_attention.py `flash_attention_plain`; the division correctly
//     rounded from one reciprocal a row and an FMA correction), rounded to
//     bf16 in the registers, then O += P V.
// That is 1.5x the products of an online softmax; in exchange P is the
// twin's P to the last bit wherever S and l agree, where an online
// softmax would round unnormalised P and rescale afterwards. S is formed
// with explicitly rounded intrinsics (no fused multiply-add), as the twin
// rounds it.
//
// fp32 operands (the eval CLI's default fp32 encode, fp32 training):
// `flash_fwd_tf32`. What bounds it: at the muavic encoder's shape (N =
// 32*4, T = 375, D = 64) the function is 4.61 GFLOP (0.0688 ms at the 67
// TFLOP/s of fp32 outside the tensor cores) against 49 MB (0.0147 ms at
// 3.35 TB/s); at the flagship eval shape (N = 32*16, T = 384, D = 64)
// 19.3 GFLOP (0.2885 ms) against 201 MB (0.060 ms). A TF32 product keeps
// ~3 decimal digits, so the kernel forms every product in split TF32:
// x = hi + lo with hi = x rounded to TF32 and lo = x - hi truncated to
// TF32, and a b ~ hi_a hi_b + hi_a lo_b + lo_a hi_b, three
// `mma.sync.m16n8k8` tf32 products into one fp32 accumulator (the two
// small terms first), dropping lo_a lo_b and lo's cut bits (~2^-21 of the
// product), as CUTLASS's OpMultiplyAddFastF32 does (mma_tf32.cuh, which
// the fp32 backward shares). Three products a step
// at the 495 TFLOP/s TF32 peak bound it at 0.0279 ms (muavic) and 0.1171
// ms (flagship eval): the bound this kernel is held to. In practice the
// CUDA cores' work bounds it, not the tensor cores: per 64-key tile a
// warp issues 384 mma against ~4 integer and float operations for each
// of the 256 K and V values it splits, 32 exact expf and the loads
// (with cvt.rna in place of the integer split it took 18-24% longer).
//
// Its design: Q stays fp32 in registers, split where the tile loop uses
// it (at D = 64 in the registers, spills and time of splitting it once
// before the loop, the split being loop-invariant). K and V stay fp32 in
// shared memory and every warp splits its fragments as it loads them,
// which costs four times the conversions of hi and lo planes split once
// a block but no second plane's shared memory or reads: at D = 64 two
// stages of 64-key K and V tiles take 74 KB, so three blocks share an SM,
// and Q's split fragments (64 registers), S (32) and O (32) fit the 168
// registers that allows (with a few spilled words); at D = 128 Q (64 fp32
// registers) and O (64) leave room for 32-key tiles (69 KB, 255).
// The contraction index of S = Q K^T walks the dims in the order 16i+4c,
// +1 (k-step 2i) and 16i+4c+2, +3 (k-step 2i+1), so one 16-byte read of
// a K row is the B fragments of two k-steps. The softmax is online and
// single-pass: fp32 rounds no P, so the bf16 kernel's second pass is not
// needed; exp is the exact expf (the lse feeds the fp32 backward). The
// m16n8 accumulator holds P at keys
// (g, 2c), (g, 2c+1), which the tf32 k8 A operand takes as k = c and
// c + 4: V's rows 2c and 2c+1 are B's k = c and c + 4, so P goes from
// the accumulator to the A operand with no shuffle. O's column n of n8
// tile dn is dim 8 w (dn / w) + w n + dn % w (w = 4, 2 at D = 16), so a
// lane reads w dims of a V row at once and writes 2 w dims of an out row.
// K rows are padded to 16 mod 32 words and V rows to 4 mod 8, so those
// 16-byte reads hit distinct banks.
//
// Dropout (kDrop, both kernels): the keep bit of (n, i, j) is word j & 3
// of Philox4x32-10 at counter (j >> 2, i, n, 0) (philox.cuh). In an m16n8
// fragment a lane holds keys c, c+1 of rows g and g+8; the even lane of a
// pair draws the 4-key group for row g, the odd lane for row g+8, and one
// shuffle swaps the halves (mma_bf16.cuh `keep_bits_qk`): one draw per
// four scores. As in the TPU kernel, l sums the undropped p.
#include "common.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "philox.cuh"

namespace {

// ------------------------------------------------- bf16, tensor cores

namespace mm = avsr::mma;
using avsr::mma::bf16;

constexpr int kRowsMma = 64;  // query rows a block: 16 a warp
constexpr int kKeysMma = 64;  // keys a streamed tile
constexpr int kThreadsMma = 2 * kRowsMma;
// blocks an SM the registers must allow (<= 168 a thread): of 1 to 5,
// three were fastest on the H100 at the training and serving shapes
constexpr int kFwdMinBlocks = 3;

template <int D>
constexpr int fwd_smem_bytes() {
  // the Q tile and two stages of K and V tiles, rows padded to D + 8
  return (kRowsMma + 4 * kKeysMma) * (D + 8) * 2;
}

// s <- S * scale + bias of the fragment's keys; -inf past t_len
template <int kTiles>
__device__ __forceinline__ void scale_and_bias(float (&s)[kTiles][4],
                                               const float* brow, int k0,
                                               int t_len, float scale,
                                               int lane) {
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = k0 + j * 8 + 2 * (lane & 3) + e;
      const bool ok = key < t_len;
      const float b = ok ? __ldg(brow + key) : 0.f;
      s[j][e] = ok ? __fadd_rn(__fmul_rn(s[j][e], scale), b) : -INFINITY;
      s[j][e + 2] =
          ok ? __fadd_rn(__fmul_rn(s[j][e + 2], scale), b) : -INFINITY;
    }
  }
}

template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreadsMma, kFwdMinBlocks)
    flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ bias,
                  bf16* __restrict__ out, float* __restrict__ lse, int t_len,
                  float scale, avsr::DropArgs drop) {
  constexpr int kLd = D + 8;
  constexpr int kTiles = kKeysMma / 8;  // n8 fragments of a key tile
  constexpr bool kRegA = D <= 64;       // Q fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kRowsMma * kLd;         // 2 stages
  bf16* vs = ks + 2 * kKeysMma * kLd;     // 2 stages

  const int n = blockIdx.y;
  const uint32_t head = drop.head(n);  // the row's dropout counter
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRowsMma;
  const int wrow = row0 + warp * 16;  // the warp's first query
  const size_t base = static_cast<size_t>(n) * t_len * D;
  const bf16* qg = q + base;
  const bf16* kg = k + base;
  const bf16* vg = v + base;
  const float* brow = bias + static_cast<size_t>(n) * t_len;
  const bf16* qw = qs + warp * 16 * kLd;
  const int tiles = (t_len + kKeysMma - 1) / kKeysMma;

  uint32_t qa[kRegA ? D / 16 : 1][4];

  // pass 1: the row max m and row sum l of exp(S - m); rows g and g+8
  mm::load_rows<D, kRowsMma>(qs, qg, row0, t_len);
  mm::load_rows<D, kKeysMma>(ks, kg, 0, t_len);
  mm::cp_async_commit();
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's share, against the quad's m
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles)
      mm::load_rows<D, kKeysMma>(ks + ((t + 1) & 1) * kKeysMma * kLd, kg,
                                 (t + 1) * kKeysMma, t_len);
    mm::cp_async_commit();
    mm::cp_async_wait<1>();
    __syncthreads();
    if (kRegA && t == 0) {
#pragma unroll
      for (int kk = 0; kk < (kRegA ? D / 16 : 0); ++kk)
        mm::load_a<D>(qa[kk], qw, kk, lane);
    }
    float s[kTiles][4] = {};
    mm::mma_abt<D, kKeysMma, kRegA>(s, qa, qw,
                                    ks + (t & 1) * kKeysMma * kLd, lane);
    scale_and_bias<kTiles>(s, brow, t * kKeysMma, t_len, scale, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kTiles; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[h], mx);  // finite: key 0 is in tile 0
      const float ml = mn * mm::kLog2e;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kTiles; ++j)
        sum += mm::exp2_approx(fmaf(s[j][2 * h], mm::kLog2e, -ml)) +
               mm::exp2_approx(fmaf(s[j][2 * h + 1], mm::kLog2e, -ml));
      l[h] = l[h] * mm::exp2_approx((m[h] - mn) * mm::kLog2e) + sum;
      m[h] = mn;
    }
    __syncthreads();  // the stage is overwritten two tiles on
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
  }
  const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
  const int ra = wrow + (lane >> 2);  // row g; row g+8 is ra + 8
  if ((lane & 3) == 0) {
    float* lrow = lse + static_cast<size_t>(n) * t_len;
    if (ra < t_len) lrow[ra] = m[0] + logf(l[0]);
    if (ra + 8 < t_len) lrow[ra + 8] = m[1] + logf(l[1]);
  }

  // pass 2: P = (exp(S - m) * M) / l rounded to bf16, O += P V
  mm::load_rows<D, kKeysMma>(ks, kg, 0, t_len);
  mm::load_rows<D, kKeysMma>(vs, vg, 0, t_len);
  mm::cp_async_commit();
  float o[D / 8][4] = {};
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      const int st = ((t + 1) & 1) * kKeysMma * kLd;
      mm::load_rows<D, kKeysMma>(ks + st, kg, (t + 1) * kKeysMma, t_len);
      mm::load_rows<D, kKeysMma>(vs + st, vg, (t + 1) * kKeysMma, t_len);
    }
    mm::cp_async_commit();
    mm::cp_async_wait<1>();
    __syncthreads();
    const int k0 = t * kKeysMma;
    float s[kTiles][4] = {};
    mm::mma_abt<D, kKeysMma, kRegA>(s, qa, qw,
                                    ks + (t & 1) * kKeysMma * kLd, lane);
    scale_and_bias<kTiles>(s, brow, k0, t_len, scale, lane);
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      uint32_t keep = 0xfu;
      if (kDrop) keep = mm::keep_bits_qk(head, wrow, k0 + j * 8, lane, drop);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = expf(__fsub_rn(s[j][e], m[e >> 1]));
        if (kDrop) p = __fmul_rn(p, (keep >> e) & 1 ? drop.inv_keep : 0.f);
        s[j][e] = mm::div_rn(p, l[e >> 1], rl[e >> 1]);
      }
    }
    mm::mma_xb<D, kKeysMma>(o, s, vs + (t & 1) * kKeysMma * kLd, lane);
    __syncthreads();
  }

  bf16* og = out + base;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int d = j * 8 + 2 * (lane & 3);
    if (ra < t_len)
      *reinterpret_cast<__nv_bfloat162*>(og + static_cast<size_t>(ra) * D +
                                         d) =
          __floats2bfloat162_rn(o[j][0], o[j][1]);
    if (ra + 8 < t_len)
      *reinterpret_cast<__nv_bfloat162*>(
          og + static_cast<size_t>(ra + 8) * D + d) =
          __floats2bfloat162_rn(o[j][2], o[j][3]);
  }
}

template <int D>
cudaError_t launch_mma(int n, int t, cudaStream_t stream, const void* q,
                       const void* k, const void* v, const float* bias,
                       void* out, float* lse, float scale, bool dropout,
                       const avsr::DropArgs& drop) {
  const dim3 grid((t + kRowsMma - 1) / kRowsMma, n);
  constexpr int kSmem = fwd_smem_bytes<D>();
  auto kernel =
      dropout ? &flash_fwd_mma<D, true> : &flash_fwd_mma<D, false>;
  if (kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreadsMma, kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), bias, static_cast<bf16*>(out), lse, t,
      scale, drop);
  return cudaGetLastError();
}

// ------------------------------------------------ fp32, tensor cores

constexpr int kRowsF32 = 64;  // query rows a block: 16 a warp
constexpr int kKeysF32 = 64;  // keys a streamed tile at D <= 64
constexpr int kThreadsF32 = 2 * kRowsF32;
// blocks an SM the registers must allow at D <= 64 (<= 168 a thread;
// shared memory allows three at D = 64)
constexpr int kF32MinBlocks = 3;

// The fp32 kernel's shared-memory rows and O's dim order (header).
template <int D>
struct F32Layout {
  // keys a tile: at D = 128 the fp32 Q (64 registers) and O (64) leave
  // room for 32 keys' scores, not 64
  static constexpr int kKeys = D <= 64 ? kKeysF32 : kKeysF32 / 2;
  static constexpr int kLdK = D % 32 == 0 ? D + 16 : D + 32;  // 16 mod 32
  static constexpr int kLdV = D + 4;                          // 4 mod 8
  static constexpr int kVec = D >= 32 ? 4 : 2;  // O's n8 tiles a V read
  static constexpr int kSmem = 2 * kKeys * (kLdK + kLdV) * 4;  // bytes
  static constexpr int kMinBlocks = D <= 64 ? kF32MinBlocks : 1;
};

using avsr::tf32::load_vec;
using avsr::tf32::mma_split;
using avsr::tf32::split_a;

template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreadsF32, F32Layout<D>::kMinBlocks)
    flash_fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ bias,
                   float* __restrict__ out, float* __restrict__ lse, int t_len,
                   float scale, avsr::DropArgs drop) {
  using L = F32Layout<D>;
  constexpr int kTiles = L::kKeys / 8;  // n8 tiles of S, k8 slices of P V
  constexpr int kQuads = D / 16;        // 16 dims: two k-steps of Q K^T
  constexpr int kGroups = D / (8 * L::kVec);  // V reads a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);  // 2 stages
  float* vs = ks + 2 * L::kKeys * L::kLdK;         // 2 stages

  const int n = blockIdx.y;
  const uint32_t head = drop.head(n);  // the row's dropout counter
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int wrow = blockIdx.x * kRowsF32 + warp * 16;  // the warp's first
  const size_t base = static_cast<size_t>(n) * t_len * D;
  const float* kg = k + base;
  const float* vg = v + base;
  const float* brow = bias + static_cast<size_t>(n) * t_len;
  const int tiles = (t_len + L::kKeys - 1) / L::kKeys;

  mm::load_rows<D, L::kKeys, L::kLdK>(ks, kg, 0, t_len);
  mm::load_rows<D, L::kKeys, L::kLdV>(vs, vg, 0, t_len);
  avsr::cp_async_commit();

  // Q rows g and g+8, dims 16 i + 4 c .. + 3: the A fragments of k-steps
  // 2i (dims 16i+4c, +1) and 2i+1 (+2, +3); rows past t_len are zeros
  float4 qf[2][kQuads];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wrow + g + 8 * h;
#pragma unroll
    for (int i = 0; i < kQuads; ++i)
      qf[h][i] = row < t_len
                     ? __ldg(reinterpret_cast<const float4*>(
                                 q + base + static_cast<size_t>(row) * D) +
                             4 * i + c)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  float m[2] = {-INFINITY, -INFINITY};  // rows g, g+8
  float l[2] = {0.f, 0.f};  // this lane's share, against the quad's m
  float o[D / 8][4] = {};
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      const int st = (t + 1) & 1;
      mm::load_rows<D, L::kKeys, L::kLdK>(ks + st * L::kKeys * L::kLdK,
                                          kg, (t + 1) * L::kKeys, t_len);
      mm::load_rows<D, L::kKeys, L::kLdV>(vs + st * L::kKeys * L::kLdV,
                                          vg, (t + 1) * L::kKeys, t_len);
    }
    avsr::cp_async_commit();
    avsr::cp_async_wait<1>();
    __syncthreads();
    const int k0 = t * L::kKeys;
    const float* kt =
        ks + (t & 1) * L::kKeys * L::kLdK + g * L::kLdK + 4 * c;
    const float* vt = vs + (t & 1) * L::kKeys * L::kLdV +
                      2 * c * L::kLdV + g * L::kVec;

    // S = Q K^T: n8 tile j is keys k0 + 8 j .. + 7, B's n = g its key 8j+g
    float s[kTiles][4] = {};
#pragma unroll
    for (int i = 0; i < kQuads; ++i) {
      uint32_t ah[2][4], al[2][4];
      split_a(ah[0], al[0], qf[0][i].x, qf[1][i].x, qf[0][i].y, qf[1][i].y);
      split_a(ah[1], al[1], qf[0][i].z, qf[1][i].z, qf[0][i].w, qf[1][i].w);
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        const float4 kf =
            *reinterpret_cast<const float4*>(kt + 8 * j * L::kLdK + 16 * i);
        mma_split(s[j], ah[0], al[0], kf.x, kf.y);
        mma_split(s[j], ah[1], al[1], kf.z, kf.w);
      }
    }
    scale_and_bias<kTiles>(s, brow, k0, t_len, scale, lane);

    // online softmax: P = expf(S - m), l and O rescaled when m grows
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kTiles; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[h], mx);  // finite: key 0 is in tile 0
      const float alpha = expf(m[h] - mn);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          s[j][e] = expf(__fsub_rn(s[j][e], mn));
          sum += s[j][e];
        }
      }
      l[h] = l[h] * alpha + sum;
      m[h] = mn;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        o[dn][2 * h] *= alpha;
        o[dn][2 * h + 1] *= alpha;
      }
    }

    // O += P V: k8 slice j is keys k0 + 8 j .. + 7, k = c and c + 4 the
    // keys 2c and 2c+1 that the lane's accumulators hold
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      if (kDrop) {
        const uint32_t keep = mm::keep_bits_qk(head, wrow, k0 + 8 * j, lane,
                                               drop);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = __fmul_rn(s[j][e], (keep >> e) & 1 ? drop.inv_keep : 0.f);
      }
      uint32_t ph[4], pl[4];
      split_a(ph, pl, s[j][0], s[j][2], s[j][1], s[j][3]);
      const float* vj = vt + 8 * j * L::kLdV;
#pragma unroll
      for (int gr = 0; gr < kGroups; ++gr) {
        float b0[L::kVec], b1[L::kVec];
        load_vec<L::kVec>(b0, vj + gr * 8 * L::kVec);
        load_vec<L::kVec>(b1, vj + L::kLdV + gr * 8 * L::kVec);
#pragma unroll
        for (int e = 0; e < L::kVec; ++e)
          mma_split(o[gr * L::kVec + e], ph, pl, b0[e], b1[e]);
      }
    }
    __syncthreads();  // the stage is overwritten two tiles on
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
  }
  float* og = out + base;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wrow + g + 8 * h;
    if (row >= t_len) continue;
    if (c == 0)
      lse[static_cast<size_t>(n) * t_len + row] = m[h] + logf(l[h]);
    const float inv = 1.f / l[h];
    // O's columns 2c and 2c+1 of tiles dn = gr w .. gr w + w - 1 are dims
    // 8 w gr + 2 c w .. + 2 w - 1, in that order
#pragma unroll
    for (int gr = 0; gr < kGroups; ++gr) {
      float x[2 * L::kVec];
#pragma unroll
      for (int e = 0; e < L::kVec; ++e) {
        x[e] = o[gr * L::kVec + e][2 * h] * inv;
        x[L::kVec + e] = o[gr * L::kVec + e][2 * h + 1] * inv;
      }
      float4* dst = reinterpret_cast<float4*>(
          og + static_cast<size_t>(row) * D + 8 * L::kVec * gr +
          2 * c * L::kVec);
#pragma unroll
      for (int e = 0; e < L::kVec / 2; ++e)
        dst[e] = make_float4(x[4 * e], x[4 * e + 1], x[4 * e + 2],
                             x[4 * e + 3]);
    }
  }
}

template <int D>
cudaError_t launch_tf32(int n, int t, cudaStream_t stream, const void* q,
                        const void* k, const void* v, const float* bias,
                        void* out, float* lse, float scale, bool dropout,
                        const avsr::DropArgs& drop) {
  constexpr int kSmem = F32Layout<D>::kSmem;
  const dim3 grid((t + kRowsF32 - 1) / kRowsF32, n);
  auto kernel =
      dropout ? &flash_fwd_tf32<D, true> : &flash_fwd_tf32<D, false>;
  if (kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreadsF32, kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bias, static_cast<float*>(out), lse, t,
      scale, drop);
  return cudaGetLastError();
}

template <bool kBf16, int D>
cudaError_t launch_dim(int n, int t, cudaStream_t stream, const void* q,
                       const void* k, const void* v, const float* bias,
                       void* out, float* lse, float scale, bool dropout,
                       const avsr::DropArgs& drop) {
  if (kBf16)
    return launch_mma<D>(n, t, stream, q, k, v, bias, out, lse, scale,
                         dropout, drop);
  return launch_tf32<D>(n, t, stream, q, k, v, bias, out, lse, scale,
                        dropout, drop);
}

template <bool kBf16>
cudaError_t launch(int n, int t, int d, cudaStream_t s, const void* q,
                   const void* k, const void* v, const float* bias, void* out,
                   float* lse, float scale, bool dropout,
                   const avsr::DropArgs& drop) {
  switch (d) {
    case 16:
      return launch_dim<kBf16, 16>(n, t, s, q, k, v, bias, out, lse, scale,
                                   dropout, drop);
    case 32:
      return launch_dim<kBf16, 32>(n, t, s, q, k, v, bias, out, lse, scale,
                                   dropout, drop);
    case 64:
      return launch_dim<kBf16, 64>(n, t, s, q, k, v, bias, out, lse, scale,
                                   dropout, drop);
    case 128:
      return launch_dim<kBf16, 128>(n, t, s, q, k, v, bias, out, lse, scale,
                                    dropout, drop);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: (n, t, d) contiguous, dtype `dtype`, 16-byte aligned;
// bias, lse: (n, t) fp32. dropout != 0: drop at the Philox draw of
// (seed0, seed1), keeping an element iff its bits are below `threshold`,
// and scale kept ones by `inv_keep`; row n draws as head
// (n / heads_local) * heads_total + head_base + n % heads_local (1, 1, 0:
// as head n). Both dtypes run on the tensor cores:
// bf16 as bf16, fp32 in split TF32.
extern "C" int avsr_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, const float* bias,
                                        void* out, float* lse, int n, int t,
                                        int d, float scale, int dropout,
                                        uint32_t threshold, float inv_keep,
                                        uint32_t seed0, uint32_t seed1,
                                        int heads_local, int heads_total,
                                        int head_base, int dtype,
                                        void* stream) {
  if (n <= 0 || t <= 0 || n > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (heads_local < 1 || head_base < 0 ||
      head_base + heads_local > heads_total)
    return static_cast<int>(cudaErrorInvalidValue);
  const avsr::DropArgs drop{threshold,   inv_keep,    seed0,    seed1,
                            heads_local, heads_total, head_base};
  cudaError_t err;
  if (dtype == avsr::kFloat32)
    err = launch<false>(n, t, d, s, q, k, v, bias, out, lse, scale,
                        dropout != 0, drop);
  else if (dtype == avsr::kBFloat16)
    err = launch<true>(n, t, d, s, q, k, v, bias, out, lse, scale,
                       dropout != 0, drop);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
