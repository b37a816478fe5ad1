// One beam-search decode step of the decoder's self-attention, with the
// step's K|V row written into the cache by the kernel itself.
//
// Replaces the Pallas TPU kernels avsr_tpu/ops/pallas/decode_attention.py
// `_kernel_resident` (v3, the default) and `_kernel` (v2 grid): for every
// utterance b, lane k and head h, attend query q[b,k,h] over all J stored
// lanes and S positions of the fused (N = B*K, S, 2C) K|V cache, with beam
// ancestry resolved by the additive lane_bias[b,k,s,j] (lazy reorder: the
// cache is never reshuffled), one joint softmax over (j, s).
//
// What bounds it on the card: the cache read. Each step moves the valid
// prefix of B*K*S*2C cache elements (up to 19 MB per layer at B=8, S=192,
// C=1024 in bf16, ~6 us at 3.35 TB/s) for ~2 FLOP per element, so it is
// bandwidth bound in principle; at B=8 there are only B*H = 128 (utterance,
// head) pairs, one per SM, so what sets its time is how many loads each SM
// keeps in flight.
//
// Design: one block per (head h, utterance b), 512 threads. The block first
// stores its head's Dh-wide column slice of kv_row for its K lanes at row
// pos_c = min(pos, S-1), for K and for V; blocks own disjoint columns, so
// they never race, and __syncthreads makes the row visible to the block's
// own reads. Reads are prefix bounded: rows s > pos_c carry -1e30 on every
// lane (the caller's contract), contribute exp(-1e30 - m) = 0, and are
// skipped, as the TPU kernel skips its unread chunks. A stored (j, s) row's
// Dh slice is read by Dh/8 adjacent threads (bf16; Dh/4 in fp32), 16 bytes
// each, so a warp reads whole 128-byte lines and the block has 64 rows in
// flight. Scores: each thread dots its chunk with all K queries (kept in
// shared memory), a shuffle sums the chunk partials. The softmax over (j, s)
// runs in fp32 in shared memory, one warp per query; q and the normalised
// probabilities are rounded to the cache dtype before their products (fp32
// accumulation), the rounding points of the TPU kernel. P.V: each thread
// accumulates its 16-byte V chunk for all K queries over a strided subset of
// rows; shuffles, then shared memory, sum the row subsets.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLanes = 8;
constexpr unsigned kFull = 0xffffffffu;

// the 16-byte chunk of a cache row at p, as floats
template <typename TC>
__device__ __forceinline__ void load_chunk(const TC* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const TC* e = reinterpret_cast<const TC*>(&raw);
#pragma unroll
  for (int i = 0; i < static_cast<int>(16 / sizeof(TC)); ++i)
    out[i] = avsr::to_float(e[i]);
}

template <typename TQ, typename TC>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const TQ* __restrict__ q, TC* cache,
                            const float* __restrict__ lane_bias,
                            const TC* __restrict__ kv_row, TQ* __restrict__ out,
                            int lanes, int heads, int dh, int s_max, int pos) {
  constexpr int kVec = 16 / sizeof(TC);  // elements per 16-byte chunk
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane_id = tid % 32;
  const int c_dim = heads * dh;
  const int c2 = 2 * c_dim;
  const int pos_c = min(pos, s_max - 1);
  const int s_lim = pos_c + 1;
  const int rows = lanes * s_lim;
  const int cpr = dh / kVec;          // threads per row: a power of two <= 32
  const int groups = kThreads / cpr;  // rows in flight per pass
  const int chunk = tid % cpr;
  const int grp = tid / cpr;
  const size_t lane0 = static_cast<size_t>(b) * lanes;

  float* qs = smem;                         // (lanes, dh)
  float* sc = qs + lanes * dh;              // (lanes, rows)
  float* red = sc + lanes * lanes * s_max;  // (kWarps, lanes, dh)

  // 1. this step's K|V row, this head's columns, all lanes of utterance b
  for (int e = tid; e < lanes * 2 * dh; e += kThreads) {
    const int j = e / (2 * dh);
    const int rem = e % (2 * dh);
    const int col = (rem / dh) * c_dim + h * dh + rem % dh;
    const size_t lane = lane0 + j;
    cache[(lane * s_max + pos_c) * c2 + col] = kv_row[lane * c2 + col];
  }
  // queries rounded to the cache dtype
  for (int e = tid; e < lanes * dh; e += kThreads) {
    const int kq = e / dh;
    const int d = e % dh;
    const float qv = avsr::to_float(q[(lane0 + kq) * c_dim + h * dh + d]);
    qs[e] = avsr::to_float(avsr::from_float<TC>(qv));
  }
  __syncthreads();

  // 2. scores (+ ancestry bias) for every stored row (j, s <= pos_c); the
  // pass count is uniform over the block, so every lane reaches the shuffles
  for (int r0 = 0; r0 < rows; r0 += groups) {
    const int r = r0 + grp;
    const bool ok = r < rows;
    const int j = ok ? r / s_lim : 0;
    const int s = ok ? r % s_lim : 0;
    float kv[kVec];
    if (ok) {
      load_chunk(cache + ((lane0 + j) * s_max + s) * c2 + h * dh + chunk * kVec,
                 kv);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) kv[e] = 0.f;
    }
#pragma unroll
    for (int kq = 0; kq < kMaxLanes; ++kq) {
      if (kq < lanes) {
        const float* qrow = qs + kq * dh + chunk * kVec;
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) part = fmaf(qrow[e], kv[e], part);
        for (int off = 1; off < cpr; off <<= 1)  // the row's cpr lanes
          part += __shfl_xor_sync(kFull, part, off);
        if (ok && chunk == 0)
          sc[kq * rows + r] =
              part + lane_bias[((lane0 + kq) * s_max + s) * lanes + j];
      }
    }
  }
  __syncthreads();

  // 3. joint softmax over (j, s) per query, probabilities in the cache dtype
  for (int kq = warp; kq < lanes; kq += kWarps) {
    float* srow = sc + kq * rows;
    float mx = -INFINITY;
    for (int e = lane_id; e < rows; e += 32) mx = fmaxf(mx, srow[e]);
    mx = avsr::warp_max(mx);
    float sum = 0.f;
    for (int e = lane_id; e < rows; e += 32) {
      const float p = expf(srow[e] - mx);
      srow[e] = p;
      sum += p;
    }
    const float den = fmaxf(avsr::warp_sum(sum), 1e-30f);
    for (int e = lane_id; e < rows; e += 32)
      srow[e] = avsr::to_float(avsr::from_float<TC>(srow[e] / den));
  }
  __syncthreads();

  // 4. out = P . V
  float acc[kMaxLanes][kVec];
#pragma unroll
  for (int kq = 0; kq < kMaxLanes; ++kq)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[kq][e] = 0.f;
  for (int r = grp; r < rows; r += groups) {
    const int j = r / s_lim;
    const int s = r % s_lim;
    float vv[kVec];
    load_chunk(cache + ((lane0 + j) * s_max + s) * c2 + c_dim + h * dh +
                   chunk * kVec,
               vv);
#pragma unroll
    for (int kq = 0; kq < kMaxLanes; ++kq) {
      if (kq < lanes) {
        const float p = sc[kq * rows + r];
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[kq][e] = fmaf(p, vv[e], acc[kq][e]);
      }
    }
  }
  // sum the row groups of this warp (lanes that share a chunk), then the
  // warps' partials in shared memory
#pragma unroll
  for (int kq = 0; kq < kMaxLanes; ++kq) {
    if (kq < lanes) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        for (int off = cpr; off < 32; off <<= 1)
          acc[kq][e] += __shfl_xor_sync(kFull, acc[kq][e], off);
        if (lane_id < cpr)
          red[(warp * lanes + kq) * dh + chunk * kVec + e] = acc[kq][e];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < lanes * dh; e += kThreads) {
    const int kq = e / dh;
    const int dd = e % dh;
    float tot = 0.f;
    for (int w = 0; w < kWarps; ++w) tot += red[(w * lanes + kq) * dh + dd];
    out[(lane0 + kq) * c_dim + h * dh + dd] = avsr::from_float<TQ>(tot);
  }
}

template <typename TQ, typename TC>
cudaError_t launch_typed(const void* q, void* cache, const float* lane_bias,
                         const void* kv_row, void* out, int b, int lanes,
                         int heads, int dh, int s_max, int pos,
                         cudaStream_t stream) {
  // a row's Dh slice splits into 16-byte chunks over a power-of-two number
  // of adjacent lanes, and the chunks are 16-byte aligned
  constexpr int kVec = 16 / sizeof(TC);
  const int cpr = dh / kVec;
  if (dh % kVec != 0 || cpr > 32 || (cpr & (cpr - 1)) != 0 ||
      reinterpret_cast<uintptr_t>(cache) % 16 != 0)
    return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(lanes) * dh +
                       static_cast<size_t>(lanes) * lanes * s_max +
                       static_cast<size_t>(kWarps) * lanes * dh);
  auto kernel = decode_attention_kernel<TQ, TC>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(heads, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<TC*>(cache), lane_bias,
      static_cast<const TC*>(kv_row), static_cast<TQ*>(out), lanes, heads, dh,
      s_max, pos);
  return cudaGetLastError();
}

}  // namespace

// q, out: (b*lanes, heads*dh) dtype q_dtype; cache: (b*lanes, s_max,
// 2*heads*dh) dtype cache_dtype, updated in place at row min(pos, s_max-1);
// kv_row: (b*lanes, 2*heads*dh) cache_dtype; lane_bias: (b, lanes, s_max,
// lanes) fp32.
extern "C" int avsr_decode_attention(const void* q, void* cache,
                                     const float* lane_bias, const void* kv_row,
                                     void* out, int b, int lanes, int heads,
                                     int dh, int s_max, int pos, int q_dtype,
                                     int cache_dtype, void* stream) {
  if (b <= 0 || b > 65535 || lanes <= 0 || lanes > kMaxLanes || dh <= 0 ||
      s_max <= 0 || pos < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  cudaError_t err;
  if (q_dtype == avsr::kBFloat16 && cache_dtype == avsr::kBFloat16)
    err = launch_typed<bf16, bf16>(q, cache, lane_bias, kv_row, out, b, lanes,
                                   heads, dh, s_max, pos, s);
  else if (q_dtype == avsr::kFloat32 && cache_dtype == avsr::kFloat32)
    err = launch_typed<float, float>(q, cache, lane_bias, kv_row, out, b, lanes,
                                     heads, dh, s_max, pos, s);
  else if (q_dtype == avsr::kFloat32 && cache_dtype == avsr::kBFloat16)
    err = launch_typed<float, bf16>(q, cache, lane_bias, kv_row, out, b, lanes,
                                    heads, dh, s_max, pos, s);
  else if (q_dtype == avsr::kBFloat16 && cache_dtype == avsr::kFloat32)
    err = launch_typed<bf16, float>(q, cache, lane_bias, kv_row, out, b, lanes,
                                    heads, dh, s_max, pos, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
