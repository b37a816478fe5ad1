// Flash-attention forward for the AV-HuBERT encoder's self-attention.
//
// Replaces the Pallas TPU kernels avsr_tpu/ops/pallas/flash_attention.py
// `_resident_fwd_kernel` (:296, T <= 512) and `_flash_fwd_kernel` (:96,
// streaming), with the in-kernel dropout of `_seed_prng` / `_rng_keep_mask`
// (:58, :80): out = softmax(q k^T * scale + key_bias) v per row n of
// (N = B*H, T, D), plus the per-query logsumexp `lse` that the backward
// pass needs. One kernel serves any T.
//
// bf16 operands (the serving and training paths): `flash_fwd_mma`, on the
// tensor cores. What bounds it: at the training shape (N = 6*16, T = 384,
// D = 64) the function is 3.6 GFLOP of score and value products (3.7 us
// at the 989 TFLOP/s bf16 peak) against ~19 MB of q/k/v/bias/out/lse
// (5.7 us at 3.35 TB/s), so the bound is bytes; the kernel does 1.5x the
// products (below) and two exps, a division and, with dropout, a quarter
// of a Philox call per score, so in practice the CUDA cores' exp,
// division and integer work and the mma issue rate bound it, not memory.
//
// Design: one block of four warps per (row n, 64-query tile); a warp owns
// 16 query rows, keeps their Q fragments in registers (D <= 64) and runs
// `mma.sync.m16n8k16` bf16 -> fp32 (mma_bf16.cuh). K and V stream through
// shared memory in 64-key tiles, two stages deep, by cp.async: the next
// tile loads while this one computes. The TPU kernel normalises the
// probabilities and only then rounds them to bf16 for the value product
// (flash_attention.py:328); to compute the same numbers the kernel makes
// two passes over the keys:
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
// rounds it. Keys past T score -inf and load as zeros.
//
// Dropout (kDrop): the keep bit of (n, i, j) is word j & 3 of Philox4x32-10
// at counter (j >> 2, i, n, 0) (philox.cuh). In an m16n8 fragment a lane
// holds keys c, c+1 of rows g and g+8; the even lane of a pair draws the
// 4-key group for row g, the odd lane for row g+8, and one shuffle swaps
// the halves (mma_bf16.cuh `keep_bits_qk`): one draw per four scores,
// made in pass 2 only. As in the TPU kernel, l sums the undropped p.
//
// fp32 operands (the fp32 tests and full-width parity runs): `flash_fwd_simt`,
// the CUDA-core kernel of the port's first version. On the tensor cores
// fp32 would run as TF32 (about three decimal digits); on the CUDA cores
// it keeps fp32 throughout. One block per (row n, 64-query tile), four
// threads a query row holding the q row in registers, 32-key K/V tiles
// in shared memory, the online softmax; it never rounds p (fp32 needs no
// rounding); dropout draws the tile's keep bits into shared memory.
#include "common.cuh"
#include "mma_bf16.cuh"
#include "philox.cuh"

namespace {

// ------------------------------------------------------------- fp32, SIMT

constexpr int kBlockQ = 64;  // query rows per block
constexpr int kBlockK = 32;  // keys per shared-memory tile
constexpr int kSub = 4;      // threads per query row
constexpr int kThreads = kBlockQ * kSub;

template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_simt(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ bias,
                   float* __restrict__ out, float* __restrict__ lse, int t_len,
                   float scale, avsr::DropArgs drop) {
  static_assert(D % kSub == 0, "head dim must split over the sub-lanes");
  constexpr int kDimsPerThread = D / kSub;
  constexpr int kKeysPerThread = kBlockK / kSub;
  __shared__ float ks[kBlockK][D + 1];
  __shared__ float vs[kBlockK][D + 1];
  __shared__ float ps[kBlockQ][kBlockK + 1];
  __shared__ uint8_t keep[kDrop ? kBlockQ : 1][kBlockK];

  const int n = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = tid / kSub;  // query row within the tile
  const int c = tid % kSub;  // sub-lane within the row
  const int row = blockIdx.x * kBlockQ + r;
  const bool row_ok = row < t_len;
  const size_t base = static_cast<size_t>(n) * t_len * D;
  const float* brow = bias + static_cast<size_t>(n) * t_len;

  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d)
    qr[d] = row_ok ? q[base + static_cast<size_t>(row) * D + d] : 0.f;
  float acc[kDimsPerThread];
#pragma unroll
  for (int i = 0; i < kDimsPerThread; ++i) acc[i] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  for (int k0 = 0; k0 < t_len; k0 += kBlockK) {
    for (int e = tid; e < kBlockK * D; e += kThreads) {
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
      avsr::fill_keep_tile(&keep[0][0], kBlockK, kBlockQ, kBlockK, n,
                           blockIdx.x * kBlockQ, k0, drop);
    __syncthreads();

    float s[kKeysPerThread];
    float tile_max = -INFINITY;
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) {
      const int j = c + kSub * i;
      const int key = k0 + j;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[j][d], dot);
      const float sv = key < t_len ? dot * scale + brow[key] : -INFINITY;
      s[i] = sv;
      tile_max = fmaxf(tile_max, sv);
    }
    // the kSub threads of a row are adjacent lanes of one warp
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    const float shift = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = expf(m - shift);
    float rsum = 0.f;
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) {
      const float p = expf(s[i] - shift);
      if (kDrop)
        ps[r][c + kSub * i] = keep[r][c + kSub * i] ? p * drop.inv_keep : 0.f;
      else
        ps[r][c + kSub * i] = p;
      rsum += p;
    }
    rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
    rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
    l = l * alpha + rsum;
    m = m_new;
    __syncwarp();  // ps[r][*] is read only by the row's own kSub lanes

#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) acc[i] *= alpha;
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      const float p = ps[r][j];
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i)
        acc[i] = fmaf(p, vs[j][c + kSub * i], acc[i]);
    }
    __syncthreads();  // tiles are overwritten by the next iteration
  }

  if (row_ok) {
    const float lc = fmaxf(l, 1e-30f);
    const float inv = 1.f / lc;
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i)
      out[base + static_cast<size_t>(row) * D + c + kSub * i] = acc[i] * inv;
    if (c == 0) lse[static_cast<size_t>(n) * t_len + row] = m + logf(lc);
  }
}

template <int D>
void launch_simt(dim3 grid, cudaStream_t stream, const float* q,
                 const float* k, const float* v, const float* bias, float* out,
                 float* lse, int t, float scale, bool dropout,
                 const avsr::DropArgs& drop) {
  if (dropout)
    flash_fwd_simt<D, true><<<grid, kThreads, 0, stream>>>(
        q, k, v, bias, out, lse, t, scale, drop);
  else
    flash_fwd_simt<D, false><<<grid, kThreads, 0, stream>>>(
        q, k, v, bias, out, lse, t, scale, drop);
}

// ------------------------------------------------- bf16, tensor cores

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
  namespace mm = avsr::mma;
  constexpr int kLd = D + 8;
  constexpr int kTiles = kKeysMma / 8;  // n8 fragments of a key tile
  constexpr bool kRegA = D <= 64;       // Q fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kRowsMma * kLd;         // 2 stages
  bf16* vs = ks + 2 * kKeysMma * kLd;     // 2 stages

  const int n = blockIdx.y;
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
      if (kDrop) keep = mm::keep_bits_qk(n, wrow, k0 + j * 8, lane, drop);
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

template <bool kMma, int D>
cudaError_t launch_dim(int n, int t, cudaStream_t stream, const void* q,
                       const void* k, const void* v, const float* bias,
                       void* out, float* lse, float scale, bool dropout,
                       const avsr::DropArgs& drop) {
  if (kMma)
    return launch_mma<D>(n, t, stream, q, k, v, bias, out, lse, scale,
                         dropout, drop);
  const dim3 grid((t + kBlockQ - 1) / kBlockQ, n);
  launch_simt<D>(grid, stream, static_cast<const float*>(q),
                 static_cast<const float*>(k), static_cast<const float*>(v),
                 bias, static_cast<float*>(out), lse, t, scale, dropout,
                 drop);
  return cudaGetLastError();
}

template <bool kMma>
cudaError_t launch(int n, int t, int d, cudaStream_t s, const void* q,
                   const void* k, const void* v, const float* bias, void* out,
                   float* lse, float scale, bool dropout,
                   const avsr::DropArgs& drop) {
  switch (d) {
    case 16:
      return launch_dim<kMma, 16>(n, t, s, q, k, v, bias, out, lse, scale,
                                  dropout, drop);
    case 32:
      return launch_dim<kMma, 32>(n, t, s, q, k, v, bias, out, lse, scale,
                                  dropout, drop);
    case 64:
      return launch_dim<kMma, 64>(n, t, s, q, k, v, bias, out, lse, scale,
                                  dropout, drop);
    case 128:
      return launch_dim<kMma, 128>(n, t, s, q, k, v, bias, out, lse, scale,
                                   dropout, drop);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: (n, t, d) contiguous, dtype `dtype` (bf16: 16-byte
// aligned); bias, lse: (n, t) fp32. dropout != 0: drop at the Philox draw
// of (seed0, seed1), keeping an element iff its bits are below
// `threshold`, and scale kept ones by `inv_keep`. bf16 runs on the tensor
// cores, fp32 on the CUDA cores.
extern "C" int avsr_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, const float* bias,
                                        void* out, float* lse, int n, int t,
                                        int d, float scale, int dropout,
                                        uint32_t threshold, float inv_keep,
                                        uint32_t seed0, uint32_t seed1,
                                        int dtype, void* stream) {
  if (n <= 0 || t <= 0 || n > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const avsr::DropArgs drop{threshold, inv_keep, seed0, seed1};
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
