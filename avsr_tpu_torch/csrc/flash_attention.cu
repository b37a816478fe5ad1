// Flash-attention forward for the AV-HuBERT encoder's self-attention.
//
// Replaces the Pallas TPU kernels avsr_tpu/ops/pallas/flash_attention.py
// `_resident_fwd_kernel` (T <= 512) and `_flash_fwd_kernel` (streaming):
// out = softmax(q k^T * scale + key_bias) v per row n of (N = B*H, T, D),
// plus the per-query logsumexp `lse` that the backward pass needs, with
// optional attention-prob dropout drawn inside the kernel (philox.cuh).
//
// What bounds it on the card: at the serving shape (N = 8*16, T = 384,
// D = 64) one layer is ~4.8 GFLOP of score and value products against
// ~19 MB of q/k/v/out traffic, so it is compute bound. This first version
// runs the products on the CUDA cores in fp32 (no tensor cores), which puts
// its ceiling near the 67 TFLOP/s fp32 rate, not the 989 TFLOP/s bf16 one;
// wgmma tiles are a later change.
//
// Design: one block per (row n, 64-query tile). Four threads own one query
// row: each keeps the whole q row in registers, scores a quarter of every
// 32-key tile, and accumulates a quarter of the output dims. K and V tiles
// stream through shared memory as fp32 (rows padded by one float so the
// four sub-lanes hit distinct banks). The softmax is the online (running
// max m, running sum l, rescaled accumulator) form, all in fp32, so the
// (T, T) score matrix never exists and any T works with one kernel. The
// probabilities are not rounded to v's dtype before the value product
// (the TPU kernel rounds them); the difference is within bf16 tolerance.
//
// Dropout (kDrop): the block draws the keep bits of its 64 x 32 tile into
// shared memory (two Philox calls a thread) while the K/V tile loads. As
// in the TPU kernel, the normaliser l sums the undropped p and only the
// value product sees p * mask / keep, which equals softmax -> dropout ->
// matmul. Without dropout the kernel is the same code as before it had any.
#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kBlockQ = 64;   // query rows per block
constexpr int kBlockK = 32;   // keys per shared-memory tile
constexpr int kSub = 4;       // threads per query row
constexpr int kThreads = kBlockQ * kSub;

template <typename T, int D, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     T* __restrict__ out, float* __restrict__ lse, int t_len,
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
    qr[d] = row_ok ? avsr::to_float(q[base + static_cast<size_t>(row) * D + d])
                   : 0.f;
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
        kv = avsr::to_float(k[off]);
        vv = avsr::to_float(v[off]);
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
      out[base + static_cast<size_t>(row) * D + c + kSub * i] =
          avsr::from_float<T>(acc[i] * inv);
    if (c == 0) lse[static_cast<size_t>(n) * t_len + row] = m + logf(lc);
  }
}

template <typename T, int D>
void launch_dim(dim3 grid, cudaStream_t stream, const T* q, const T* k,
                const T* v, const float* bias, T* out, float* lse, int t,
                float scale, bool dropout, const avsr::DropArgs& drop) {
  if (dropout)
    flash_fwd_kernel<T, D, true><<<grid, kThreads, 0, stream>>>(
        q, k, v, bias, out, lse, t, scale, drop);
  else
    flash_fwd_kernel<T, D, false><<<grid, kThreads, 0, stream>>>(
        q, k, v, bias, out, lse, t, scale, drop);
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const float* bias, void* out, float* lse, int n,
                         int t, int d, float scale, bool dropout,
                         const avsr::DropArgs& drop, cudaStream_t stream) {
  const dim3 grid((t + kBlockQ - 1) / kBlockQ, n);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  switch (d) {
    case 16:
      launch_dim<T, 16>(grid, stream, qp, kp, vp, bias, op, lse, t, scale,
                        dropout, drop);
      break;
    case 32:
      launch_dim<T, 32>(grid, stream, qp, kp, vp, bias, op, lse, t, scale,
                        dropout, drop);
      break;
    case 64:
      launch_dim<T, 64>(grid, stream, qp, kp, vp, bias, op, lse, t, scale,
                        dropout, drop);
      break;
    case 128:
      launch_dim<T, 128>(grid, stream, qp, kp, vp, bias, op, lse, t, scale,
                         dropout, drop);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: (n, t, d) contiguous, dtype `dtype`; bias, lse: (n, t) fp32.
// dropout != 0: drop at the Philox draw of (seed0, seed1), keeping an
// element iff its bits are below `threshold`, and scale kept ones by
// `inv_keep`.
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
    err = launch_typed<float>(q, k, v, bias, out, lse, n, t, d, scale,
                              dropout != 0, drop, s);
  else if (dtype == avsr::kBFloat16)
    err = launch_typed<__nv_bfloat16>(q, k, v, bias, out, lse, n, t, d, scale,
                                      dropout != 0, drop, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
