// The lip stem's tail, BatchNorm + PReLU + 3x3/s2/p1 max-pool, forward and
// backward, over channels-last frames: x is (N, H, W, C) in memory (N = B*T,
// C = 64, H = W = 44). That is the TPU kernel's own NHWC and the layout of
// cuDNN's Conv3d output, which the stem folds into frames without a copy.
//
// Replaces the Pallas TPU kernels of avsr_tpu/ops/pallas/stem_fuse.py
// `bn_prelu_pool`: `_stats_kernel` (per-channel sum and sum of squares),
// `_apply_kernel` (normalise, PReLU, pool), `_bwd1_kernel` (recompute y,
// route the pool gradient to the first maximum, dz and the three channel
// sums) and `_bwd2_kernel` (dx from dz and the sums).
//
// What bounds them on the card: the bytes. Each pass reads the stem output
// once (bf16, 571 MB at the training shape N = 2304) and does a few FLOPs an
// element; the backward also writes dz and dx of the same size. A thread
// owns V consecutive channels of a position (4 in `stats`, `apply` and
// `bwd2`: 8- or 16-byte accesses; 2 in `bwd1`, which holds a 5x5
// neighbourhood of them in registers) and consecutive threads walk the
// channels, so a warp's accesses are contiguous. The pool's windows
// overlap: `apply` reads an input position up to 4 times and `bwd1` (a
// thread per 2x2 block of positions) up to 9 times; the repeats hit L1 and
// L2, not memory. Indices are 32-bit (a frame batch below 2^31 elements).
//
// Determinism: the channel sums of `stats` and `bwd1` use no float atomics.
// Each block owns a fixed range of positions; a thread keeps its own sums,
// the block adds its threads' sums in a fixed order into its partials, and
// the last block to finish (an integer counter, zeroed by the caller) adds
// the blocks' partials in block order. The ranges depend on the shape
// alone, so a sum never depends on the blocks' schedule.
//
// Rounding: products and sums that the plain PyTorch twin rounds one by one
// are written with __fmul_rn / __fadd_rn / __fsub_rn, so nvcc cannot contract
// them into fused multiply-adds; with the same statistics the forward equals
// the twin bit for bit.
#include <stdint.h>

#include <algorithm>
#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;  // of the reducing kernels (partial rows)
constexpr int kMaxGrid = 4096;    // of the elementwise kernels (grid-stride)

// V consecutive channels of one position
template <typename T, int V>
struct alignas(sizeof(T) * V) Chunk {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&out)[V]) {
  const Chunk<T, V> c = *reinterpret_cast<const Chunk<T, V>*>(p);
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = avsr::to_float(c.v[i]);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&in)[V]) {
  Chunk<T, V> c;
#pragma unroll
  for (int i = 0; i < V; ++i) c.v[i] = avsr::from_float<T>(in[i]);
  *reinterpret_cast<Chunk<T, V>*>(p) = c;
}

// Rows of `channels` floats in shared memory from p = (mean, rstd, scale,
// bias, alpha): g = scale * rstd, b = bias - mean * scale * rstd (the TPU
// kernel's form of z = x * g + b), alpha, mean, rstd.
__device__ void stage_affine(const float* p, int channels, float* s) {
  for (int c = threadIdx.x; c < channels; c += kThreads) {
    const float mean = p[c], rstd = p[channels + c];
    const float scale = p[2 * channels + c], bias = p[3 * channels + c];
    s[c] = __fmul_rn(scale, rstd);
    s[channels + c] = __fsub_rn(bias, __fmul_rn(__fmul_rn(mean, scale), rstd));
    s[2 * channels + c] = p[4 * channels + c];
    s[3 * channels + c] = mean;
    s[4 * channels + c] = rstd;
  }
  __syncthreads();
}

// The K channel sums of a reducing kernel: acc[k][i] is this thread's sum k
// of channel ch * V + i (zeros where lane >= lanes). The block adds its
// lanes in lane order into partial[(block * K + k) * channels + c]; the last
// block to finish adds the blocks' partials in block order into
// out[k * channels + c]. red: K * lanes * channels floats.
template <int K, int V>
__device__ void reduce_channels(const float (&acc)[K][V], int ch, int lane,
                                int lanes, int channels, float* red,
                                float* partial, int* counter, float* out) {
  if (lane < lanes) {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int i = 0; i < V; ++i)
        red[(k * lanes + lane) * channels + ch * V + i] = acc[k][i];
  }
  __syncthreads();
  const size_t row = static_cast<size_t>(K) * channels;
  for (int j = threadIdx.x; j < K * channels; j += kThreads) {
    const int k = j / channels, c = j % channels;
    float s = 0.f;
    for (int l = 0; l < lanes; ++l) s += red[(k * lanes + l) * channels + c];
    partial[blockIdx.x * row + j] = s;
  }
  __threadfence();
  __syncthreads();
  __shared__ bool last;
  if (threadIdx.x == 0)
    last = atomicAdd(counter, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int j = threadIdx.x; j < K * channels; j += kThreads) {
    float s = 0.f;
    for (unsigned b = 0; b < gridDim.x; ++b) s += __ldcg(partial + b * row + j);
    out[j] = s;
  }
}

// the position range [p0, p1) of this block out of `positions`
__device__ __forceinline__ void block_range(int positions, int& p0,
                                            int& p1) {
  const int per = (positions + gridDim.x - 1) / gridDim.x;
  p0 = blockIdx.x * per;
  p1 = min(positions, p0 + per);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    stats_kernel(const T* __restrict__ x, float* partial, int* counter,
                 float* sums, int positions, int channels) {
  __shared__ float red[2 * kThreads * V];
  const int cpr = channels / V, lanes = kThreads / cpr;
  const int ch = threadIdx.x % cpr, lane = threadIdx.x / cpr;
  float acc[2][V] = {};
  int p0, p1;
  block_range(positions, p0, p1);
  if (lane < lanes) {
#pragma unroll 4
    for (int p = p0 + lane; p < p1; p += lanes) {
      float v[V];
      load<T, V>(x + static_cast<size_t>(p) * channels + ch * V, v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        acc[0][i] += v[i];
        acc[1][i] = fmaf(v[i], v[i], acc[1][i]);
      }
    }
  }
  reduce_channels<2, V>(acc, ch, lane, lanes, channels, red, partial, counter,
                        sums);
}

// one item = V channels of one output position
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    apply_kernel(const T* __restrict__ x, const float* __restrict__ p,
                 T* __restrict__ out, int items, int channels, int h,
                 int w) {
  extern __shared__ float prm[];  // g, b, alpha, mean, rstd rows
  stage_affine(p, channels, prm);
  const int cpr = channels / V, ho = h / 2, wo = w / 2;
  for (int it = blockIdx.x * kThreads + threadIdx.x; it < items;
       it += gridDim.x * kThreads) {
    const int c0 = it % cpr * V, q = it / cpr;
    const int ow = q % wo, oh = q / wo % ho, n = q / wo / ho;
    float m[V];
#pragma unroll
    for (int e = 0; e < V; ++e) m[e] = -INFINITY;  // padding never wins
    for (int i = 0; i < 3; ++i) {
      const int r = 2 * oh + i - 1;
      if (r < 0 || r >= h) continue;
      for (int j = 0; j < 3; ++j) {
        const int col = 2 * ow + j - 1;
        if (col < 0 || col >= w) continue;
        float v[V];
        load<T, V>(x + (static_cast<size_t>(n * h + r) * w + col) * channels +
                       c0,
                   v);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int c = c0 + e;
          const float z = __fadd_rn(__fmul_rn(v[e], prm[c]), prm[channels + c]);
          m[e] = fmaxf(m[e],
                       z >= 0.f ? z : __fmul_rn(prm[2 * channels + c], z));
        }
      }
    }
    store<T, V>(out + static_cast<size_t>(it) * V, m);
  }
}

// One item = V channels of the 2x2 block of positions (2oh + a, 2ow + b),
// a, b in {0, 1}: the windows (oh + da, ow + db), da, db in {0, 1}, are the
// only ones that hold them, and their candidates are the 5x5 neighbourhood
// rows 2oh - 1 .. 2oh + 3, columns 2ow - 1 .. 2ow + 3. Two blocks an SM at
// least: the neighbourhood is held in registers.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 2)
    bwd1_kernel(const T* __restrict__ x, const float* __restrict__ p,
                const T* __restrict__ dout, T* __restrict__ dz_out,
                float* partial, int* counter, float* red_out, int blocks2x2,
                int channels, int h, int w) {
  extern __shared__ float prm[];  // g, b, alpha, mean, rstd rows
  __shared__ float red[3 * kThreads * V];
  stage_affine(p, channels, prm);
  const int cpr = channels / V, lanes = kThreads / cpr;
  const int ch = threadIdx.x % cpr, lane = threadIdx.x / cpr;
  const int c0 = ch * V, ho = h / 2, wo = w / 2;
  float acc[3][V] = {};  // dbeta, dgamma, dalpha
  int q0, q1;
  block_range(blocks2x2, q0, q1);
  for (int q = q0 + lane; lane < lanes && q < q1; q += lanes) {
    const int ow = q % wo, oh = q / wo % ho, n = q / wo / ho;
    const bool win_r = oh + 1 < ho, win_c = ow + 1 < wo;  // windows da/db = 1
    // the neighbourhood's rows and columns inside the frame: only the first
    // (at oh = 0, ow = 0) and the last (without window 1) can fall outside
    bool in_r[5], in_c[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      in_r[i] = (i > 0 || oh > 0) && (i < 4 || win_r);
      in_c[i] = (i > 0 || ow > 0) && (i < 4 || win_c);
    }
    Chunk<T, V> raw[5][5];
#pragma unroll
    for (int i = 0; i < 5; ++i)
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        if (in_r[i] && in_c[j]) {
          raw[i][j] = *reinterpret_cast<const Chunk<T, V>*>(
              x +
              (static_cast<size_t>(n * h + 2 * oh - 1 + i) * w + 2 * ow - 1 +
               j) * channels +
              c0);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) raw[i][j].v[e] = avsr::from_float<T>(0.f);
        }
      }
    float gs[2][2][V];  // the windows' cotangents
#pragma unroll
    for (int da = 0; da < 2; ++da)
#pragma unroll
      for (int db = 0; db < 2; ++db) {
        if ((da == 0 || win_r) && (db == 0 || win_c)) {
          load<T, V>(dout +
                         (static_cast<size_t>(n * ho + oh + da) * wo + ow +
                          db) * channels +
                         c0,
                     gs[da][db]);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) gs[da][db][e] = 0.f;
        }
      }
    float dzs[2][2][V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int c = c0 + e;
      const float g = prm[c], b = prm[channels + c], al = prm[2 * channels + c];
      const float mean = prm[3 * channels + c], rstd = prm[4 * channels + c];
      float y[5][5];
#pragma unroll
      for (int i = 0; i < 5; ++i)
#pragma unroll
        for (int j = 0; j < 5; ++j) {
          const float z =
              __fadd_rn(__fmul_rn(avsr::to_float(raw[i][j].v[e]), g), b);
          // a padded position never wins
          y[i][j] = !(in_r[i] && in_c[j]) ? -INFINITY
                    : z < 0.f             ? __fmul_rn(al, z)
                                          : z;
        }
      // each window's first maximum in row-major order (k = 3i + j): a
      // later candidate wins only if strictly greater
      int kbest[2][2];
#pragma unroll
      for (int da = 0; da < 2; ++da)
#pragma unroll
        for (int db = 0; db < 2; ++db) {
          float best = -INFINITY;
          kbest[da][db] = -1;
#pragma unroll
          for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 3; ++j)
              if (y[2 * da + i][2 * db + j] > best) {
                best = y[2 * da + i][2 * db + j];
                kbest[da][db] = 3 * i + j;
              }
        }
      // dy of each owned position: the cotangents of the windows it won,
      // added in ascending k as the TPU kernel's scatter adds them
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int bb = 0; bb < 2; ++bb) {
          float dy = 0.f;
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const int dr = 1 + a - i;  // 2 * da
            if (dr < 0 || (dr & 1) || (dr == 2 && !win_r)) continue;
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              const int dc = 1 + bb - j;  // 2 * db
              if (dc < 0 || (dc & 1) || (dc == 2 && !win_c)) continue;
              if (kbest[dr / 2][dc / 2] == 3 * i + j)
                dy = __fadd_rn(dy, gs[dr / 2][dc / 2][e]);
            }
          }
          const float xv = avsr::to_float(raw[1 + a][1 + bb].v[e]);
          const float zv = __fadd_rn(__fmul_rn(xv, g), b);
          const bool neg = zv < 0.f;
          const float dzv = neg ? __fmul_rn(al, dy) : dy;
          const float xhat = __fmul_rn(__fsub_rn(xv, mean), rstd);
          dzs[a][bb][e] = dzv;
          acc[0][e] += dzv;
          acc[1][e] = fmaf(dzv, xhat, acc[1][e]);
          if (neg) acc[2][e] = fmaf(dy, zv, acc[2][e]);
        }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int bb = 0; bb < 2; ++bb)
        store<T, V>(dz_out +
                        (static_cast<size_t>(n * h + 2 * oh + a) * w + 2 * ow +
                         bb) * channels +
                        c0,
                    dzs[a][bb]);
  }
  reduce_channels<3, V>(acc, ch, lane, lanes, channels, red, partial, counter,
                        red_out);
}

// p2 rows: mean, rstd, scale * rstd, dbeta / M, dgamma / M; one item = V
// channels of one position
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    bwd2_kernel(const T* __restrict__ x, const float* __restrict__ p2,
                const T* __restrict__ dz, T* __restrict__ dx, int items,
                int channels) {
  extern __shared__ float prm[];
  for (int e = threadIdx.x; e < 5 * channels; e += kThreads) prm[e] = p2[e];
  __syncthreads();
  const int cpr = channels / V;
  for (int it = blockIdx.x * kThreads + threadIdx.x; it < items;
       it += gridDim.x * kThreads) {
    const int c0 = it % cpr * V;
    const size_t e0 = static_cast<size_t>(it) * V;
    float xv[V], dv[V], o[V];
    load<T, V>(x + e0, xv);
    load<T, V>(dz + e0, dv);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int c = c0 + e;
      const float xhat = __fmul_rn(__fsub_rn(xv[e], prm[c]), prm[channels + c]);
      o[e] = __fmul_rn(prm[2 * channels + c],
                       __fsub_rn(__fsub_rn(dv[e], prm[3 * channels + c]),
                                 __fmul_rn(xhat, prm[4 * channels + c])));
    }
    store<T, V>(dx + e0, o);
  }
}

template <typename T, int V>
struct Tag {
  using type = T;
  static constexpr int vec = V;
};

// f(Tag<T, V>) for x's dtype, with V = W channels a thread where the
// channels and every pointer allow it, else 1
template <int W, typename F>
cudaError_t dispatch(int dtype, int channels,
                     std::initializer_list<const void*> ptrs, F f) {
  const size_t elem = dtype == avsr::kBFloat16 ? 2 : 4;
  bool vec = channels % W == 0 && channels / W <= kThreads;
  for (const void* q : ptrs)
    vec = vec && reinterpret_cast<uintptr_t>(q) % (W * elem) == 0;
  if (!vec && channels > kThreads) return cudaErrorInvalidValue;
  if (dtype == avsr::kBFloat16)
    return vec ? f(Tag<__nv_bfloat16, W>{}) : f(Tag<__nv_bfloat16, 1>{});
  if (dtype == avsr::kFloat32)
    return vec ? f(Tag<float, W>{}) : f(Tag<float, 1>{});
  return cudaErrorInvalidValue;
}

// the kernels index positions and items with 32-bit integers: the elements,
// and a grid stride beyond them, stay below 2^31
constexpr long long kMaxIndex = (1LL << 31) - kMaxGrid * kThreads;

bool bad_dims(int n, int channels, int h, int w) {
  return n <= 0 || channels <= 0 || h <= 0 || w <= 0 || (h % 2) ||
         (w % 2) || static_cast<long long>(n) * h * w * channels >= kMaxIndex;
}

// blocks of a reducing kernel over `positions`: no more than kMaxBlocks,
// and none without a position for each of its lanes
template <int V>
int reduce_grid(int positions, int channels) {
  const int lanes = kThreads / (channels / V);
  return std::min(kMaxBlocks, (positions + lanes - 1) / lanes);
}

int elementwise_grid(int items) {
  return std::min(kMaxGrid, (items + kThreads - 1) / kThreads);
}

}  // namespace

// x: (n, h, w, channels) in dtype; partial: 1024 * 2 * channels fp32
// scratch; counter: one int32, zeroed; sums: (2, channels) fp32 out, the
// per-channel sum and sum of squares.
extern "C" int avsr_bn_stats(const void* x, float* partial, int* counter,
                             float* sums, int n, int channels, int h, int w,
                             int dtype, void* stream) {
  if (bad_dims(n, channels, h, w)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int positions = n * h * w;
  return dispatch<4>(dtype, channels, {x}, [&](auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int V = decltype(tag)::vec;
    stats_kernel<T, V><<<reduce_grid<V>(positions, channels), kThreads, 0, s>>>(
        static_cast<const T*>(x), partial, counter, sums, positions, channels);
    return cudaGetLastError();
  });
}

// p: (5, channels) fp32 rows mean, rstd, scale, bias, alpha; out: (n, h/2,
// w/2, channels) in x's dtype.
extern "C" int avsr_bn_apply(const void* x, const float* p, void* out, int n,
                             int channels, int h, int w, int dtype,
                             void* stream) {
  if (bad_dims(n, channels, h, w)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int outputs = n * (h / 2) * (w / 2);
  return dispatch<4>(dtype, channels, {x, out}, [&](auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int V = decltype(tag)::vec;
    const int items = outputs * (channels / V);
    apply_kernel<T, V><<<elementwise_grid(items), kThreads,
                         5 * channels * sizeof(float), s>>>(
        static_cast<const T*>(x), p, static_cast<T*>(out), items, channels, h,
        w);
    return cudaGetLastError();
  });
}

// dout: (n, h/2, w/2, channels) in x's dtype; dz: (n, h, w, channels) out;
// partial: 1024 * 3 * channels fp32 scratch; counter: one int32, zeroed;
// red: (3, channels) fp32 out, the sums of dz, dz * xhat and dy * z where
// z < 0.
extern "C" int avsr_bn_bwd1(const void* x, const float* p, const void* dout,
                            void* dz, float* partial, int* counter, float* red,
                            int n, int channels, int h, int w, int dtype,
                            void* stream) {
  if (bad_dims(n, channels, h, w)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks2x2 = n * (h / 2) * (w / 2);
  return dispatch<2>(dtype, channels, {x, dout, dz}, [&](auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int V = decltype(tag)::vec;
    bwd1_kernel<T, V><<<reduce_grid<V>(blocks2x2, channels), kThreads,
                        5 * channels * sizeof(float), s>>>(
        static_cast<const T*>(x), p, static_cast<const T*>(dout),
        static_cast<T*>(dz), partial, counter, red, blocks2x2, channels, h, w);
    return cudaGetLastError();
  });
}

// p2: (5, channels) fp32 rows mean, rstd, scale * rstd, dbeta / M,
// dgamma / M; dx: (n, h, w, channels) out in x's dtype.
extern "C" int avsr_bn_bwd2(const void* x, const float* p2, const void* dz,
                            void* dx, int n, int channels, int h, int w,
                            int dtype, void* stream) {
  if (bad_dims(n, channels, h, w)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int positions = n * h * w;
  return dispatch<4>(dtype, channels, {x, dz, dx}, [&](auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int V = decltype(tag)::vec;
    const int items = positions * (channels / V);
    bwd2_kernel<T, V><<<elementwise_grid(items), kThreads,
                        5 * channels * sizeof(float), s>>>(
        static_cast<const T*>(x), p2, static_cast<const T*>(dz),
        static_cast<T*>(dx), items, channels);
    return cudaGetLastError();
  });
}
