// Flash-attention backward for the AV-HuBERT encoder's self-attention.
//
// Replaces the Pallas TPU kernels avsr_tpu/ops/pallas/flash_attention.py
// `_resident_bwd_kernel` (T <= 512, one kernel for dQ, dK, dV) and the
// streaming pair `_flash_bwd_dq_kernel` / `_flash_bwd_dkv_kernel`, with the
// in-kernel dropout of `_seed_prng` / `_rng_keep_mask` redrawn from
// philox.cuh at the same absolute (head, query, key) counters as the
// forward. Per head n of (N = B*H, T, D), with P = exp(S - lse) recomputed
// from the forward's row logsumexp, M the pre-scaled keep mask (all ones
// without dropout) and delta = rowsum(dO * O):
//   dV = (P o M)^T dO,  dP = (dO V^T) o M,  dS = P o (dP - delta),
//   dQ = scale * dS K,  dK = scale * dS^T Q.
// As in the TPU kernels, P o M and dS are rounded to the operand dtype
// before their products, and every sum accumulates in fp32.
//
// What bounds it on the card: at the training shape (N = 6*16, T = 384,
// D = 64) one layer's backward is ~12.7 GFLOP (five T x T x D products,
// the two recomputed ones twice) against ~38 MB of operand traffic, so it
// is compute bound. Like the forward, this first version runs the
// products on the CUDA cores in fp32 (no tensor cores), so its ceiling is
// the 67 TFLOP/s fp32 rate; wgmma tiles are a later change.
//
// Design: two kernels, so that every output element is written by exactly
// one block and no sum needs atomics (deterministic dQ, dK, dV):
//  - dq: one block per (head, 64-query tile), four threads a query row
//    (the forward's layout). Each thread keeps its row of q and dO in
//    registers, computes the row's delta from dO and O itself (and writes
//    it for the dkv kernel), and streams 32-key K/V tiles through shared
//    memory; each sub-lane scores and differentiates a quarter of a tile's
//    keys, then accumulates a quarter of dQ's dims over the tile's dS.
//  - dkv: one block per (head, 64-key tile), four threads a key row, the
//    same layout with the roles of queries and keys swapped: k and v rows
//    in registers, 32-query Q/dO tiles (16 at D = 128) plus their lse and
//    delta streamed through shared memory, dK and dV accumulated over all
//    queries.
// With dropout each block draws the keep bits of its current tile into
// shared memory (two Philox calls a thread a tile) while the tile loads.
// Keys past T and queries past T contribute nothing.
#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kRows = 64;   // rows a block owns: queries (dq) or keys (dkv)
constexpr int kTile = 32;   // columns of a streamed tile: keys or queries
constexpr int kSub = 4;     // threads per owned row
constexpr int kThreads = kRows * kSub;
constexpr int kPerThread = kTile / kSub;  // tile columns a thread handles

// fp32 value after rounding to the operand type (identity for fp32).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return avsr::to_float(avsr::from_float<T>(x));
}

template <int D>
__device__ __forceinline__ float dot_row(const float (&r)[D], const float* s) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) acc = fmaf(r[d], s[d], acc);
  return acc;
}

template <typename T, int D, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ bias,
                        const T* __restrict__ o, const T* __restrict__ dout,
                        const float* __restrict__ lse, T* __restrict__ dq,
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
    qr[d] = row_ok ? avsr::to_float(q[roff + d]) : 0.f;
    dor[d] = row_ok ? avsr::to_float(dout[roff + d]) : 0.f;
  }
  // delta = rowsum(dO * O): a quarter of the dims a sub-lane, then summed
  float delta = 0.f;
#pragma unroll
  for (int i = 0; i < kDims; ++i) {
    const int d = c + kSub * i;
    delta += row_ok ? dor[d] * avsr::to_float(o[roff + d]) : 0.f;
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
        kv = avsr::to_float(k[off]);
        vv = avsr::to_float(v[off]);
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
        ds = round_to<T>(p * (dp - delta));
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
      dq[roff + c + kSub * i] = avsr::from_float<T>(acc[i] * scale);
    if (c == 0) delta_out[static_cast<size_t>(n) * t_len + row] = delta;
  }
}

template <typename T, int D, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const float* __restrict__ bias,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int t_len,
                         float scale, avsr::DropArgs drop) {
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
    kr[d] = key_ok ? avsr::to_float(k[koff + d]) : 0.f;
    vr[d] = key_ok ? avsr::to_float(v[koff + d]) : 0.f;
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
        qv = avsr::to_float(q[off]);
        dov = avsr::to_float(dout[off]);
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
        pm = round_to<T>(pm);
        ds = round_to<T>(p * (dp - delta_s[j]));
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
      dk[koff + c + kSub * i] = avsr::from_float<T>(dk_acc[i] * scale);
      dv[koff + c + kSub * i] = avsr::from_float<T>(dv_acc[i]);
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
  void *g0, *g1;       // dq, -: dq and delta; dkv: dk and dv
  int n, t;
  float scale;
  bool dropout;
  avsr::DropArgs drop;
};

template <typename T, int D, bool kDrop>
void launch_dq(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.t + kRows - 1) / kRows, a.n);
  flash_bwd_dq_kernel<T, D, kDrop><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.bias, static_cast<const T*>(a.o),
      static_cast<const T*>(a.dout), a.lse, static_cast<T*>(a.g0),
      static_cast<float*>(a.g1), a.t, a.scale, a.drop);
}

template <typename T, int D, bool kDrop>
void launch_dkv(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.t + kRows - 1) / kRows, a.n);
  flash_bwd_dkv_kernel<T, D, kDrop><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.bias, static_cast<const T*>(a.dout),
      a.lse, a.delta, static_cast<T*>(a.g0), static_cast<T*>(a.g1), a.t,
      a.scale, a.drop);
}

template <bool kDkv, typename T, int D>
void launch_dim(const Args& a, cudaStream_t stream) {
  if (kDkv) {
    if (a.dropout)
      launch_dkv<T, D, true>(a, stream);
    else
      launch_dkv<T, D, false>(a, stream);
  } else {
    if (a.dropout)
      launch_dq<T, D, true>(a, stream);
    else
      launch_dq<T, D, false>(a, stream);
  }
}

template <bool kDkv, typename T>
cudaError_t launch_typed(const Args& a, int d, cudaStream_t stream) {
  switch (d) {
    case 16:
      launch_dim<kDkv, T, 16>(a, stream);
      break;
    case 32:
      launch_dim<kDkv, T, 32>(a, stream);
      break;
    case 64:
      launch_dim<kDkv, T, 64>(a, stream);
      break;
    case 128:
      launch_dim<kDkv, T, 128>(a, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <bool kDkv>
int launch(const Args& a, int d, int dtype, void* stream) {
  if (a.n <= 0 || a.t <= 0 || a.n > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == avsr::kFloat32)
    err = launch_typed<kDkv, float>(a, d, s);
  else if (dtype == avsr::kBFloat16)
    err = launch_typed<kDkv, __nv_bfloat16>(a, d, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace

// q, k, v, o, dout, dq: (n, t, d) contiguous, dtype `dtype`; bias, lse and
// the written delta: (n, t) fp32. Dropout arguments as in
// avsr_flash_attention_fwd.
extern "C" int avsr_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const float* bias,
    const void* o, const void* dout, const float* lse, void* dq, float* delta,
    int n, int t, int d, float scale, int dropout, uint32_t threshold,
    float inv_keep, uint32_t seed0, uint32_t seed1, int dtype, void* stream) {
  const Args a{q, k, v, bias, o, dout, lse, nullptr, dq, delta, n, t, scale,
               dropout != 0, {threshold, inv_keep, seed0, seed1}};
  return launch<false>(a, d, dtype, stream);
}

// q, k, v, dout, dk, dv: (n, t, d) contiguous, dtype `dtype`; bias, lse and
// delta (from avsr_flash_attention_bwd_dq): (n, t) fp32.
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
