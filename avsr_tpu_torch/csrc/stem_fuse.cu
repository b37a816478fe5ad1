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
// element; the backward also writes dz and dx of the same size. In `stats`
// and `bwd2` a thread owns 4 consecutive channels of a position (8- or
// 16-byte accesses) and consecutive threads walk the channels, so a warp's
// accesses are contiguous. `apply` and `bwd1` walk strips of a frame (all
// channels, full width, a few rows and their halo) staged in shared memory
// by 1-D bulk copies (TMA), two strips in flight (`StripWalk`, one plan and
// one staging ring for both), and work from there. `apply` computes y once
// an element (and again across a window column's left edge), the max of
// each input row's three columns, each window's max down the column, and
// stores the pooled rows in one bulk store a strip. `bwd1` computes y the
// same way, each window's argmax once, and stores dz in one bulk store a
// strip. A strip takes its first row (apply: the input row's maxima; bwd1:
// the window row's argmax) from the strip before where one block walked
// both. Indices are 32-bit (a frame batch below 2^31 elements).
//
// Determinism: the channel sums of `stats` and `bwd1` use no float atomics.
// Each block owns a fixed set of positions (a range of positions in
// `stats`, of strips in `bwd1`); a thread keeps its own sums, the block adds
// its threads' sums in a fixed order into its partials, and the last block
// to finish (an integer counter, zeroed by the caller) adds the blocks'
// partials in block order. The sets depend on the shape and the grid (the
// card's SM count for `bwd1`) alone, so a sum never depends on the blocks'
// schedule.
//
// Rounding: products and sums that the plain PyTorch twin rounds one by one
// are written with __fmul_rn / __fadd_rn / __fsub_rn, so nvcc cannot contract
// them into fused multiply-adds; a max is exact and is rounded to x's dtype
// once, so with the same statistics the forward equals the twin bit for bit.
#include <stdint.h>

#include <algorithm>
#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;  // of the reducing kernels (partial rows)
constexpr int kMaxGrid = 4096;    // of the elementwise kernels (grid-stride)
constexpr int kStripThreads = 768;  // apply, bwd1: 24 warps, a block an SM
constexpr int kStripRows = 6;       // apply, bwd1: output rows a strip, most
constexpr int kMaxSmem = 227 * 1024;

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
  for (int c = threadIdx.x; c < channels; c += blockDim.x) {
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
  for (int j = threadIdx.x; j < K * channels; j += blockDim.x) {
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
  for (int j = threadIdx.x; j < K * channels; j += blockDim.x) {
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

// Strips of a frame in shared memory, walked by `apply` and `bwd1`. A strip
// is R output rows o0 .. o1 - 1 of one frame (o1 = o0 + R, or the frame's
// end). Its input row r sits at row r - 2o0 + 1 of its stage buffer; the
// pass keeps rows of output width after the input rows, at `aux_off` bytes.
// In NHWC each range of rows is one contiguous run of bytes.
struct StripArgs {
  int n, channels, h, w;
  int rows;         // R, output rows a strip
  int stages;       // strip buffers, 1 or 2
  int stage_bytes;  // one buffer: input rows, then rows of output width
  int aux_off;      // byte offset of the rows of output width in a buffer
  int bulk;         // rows move by 1-D bulk copies, else by the threads
};

// One block an SM walks a run [first, last) of consecutive strips. The last
// thread, whose warp has no window column at the stem's widths (22 columns
// of 24 lanes at C = 64), keeps the next `stages` strips' rows in flight:
// cp.async.bulk into the stage buffers, completing on an mbarrier each;
// where the rows are not 16-byte multiples, every thread copies them. A
// strip whose block walked the strip before it in its frame takes its first
// row (of windows in bwd1, of input in apply) from the pass's `carry`.
// Shared memory: 128 bytes of barriers, the stage buffers, then the pass's
// own buffers (`own`).
template <typename T>
struct StripWalk {
  StripArgs a;
  int ho, wo, per_frame, rx, rd, first, last;
  uint64_t* bars;
  unsigned char* stage0;
  bool producer;

  // the barriers are ready after the block's next __syncthreads
  __device__ StripWalk(const StripArgs& args, unsigned char* smem)
      : a(args) {
    ho = a.h / 2;
    wo = a.w / 2;
    per_frame = (ho + a.rows - 1) / a.rows;
    rx = a.w * a.channels;  // elements a row of input and of output
    rd = wo * a.channels;
    const long long strips = static_cast<long long>(a.n) * per_frame;
    first = static_cast<int>(strips * blockIdx.x / gridDim.x);
    last = static_cast<int>(strips * (blockIdx.x + 1) / gridDim.x);
    bars = reinterpret_cast<uint64_t*>(smem);
    stage0 = smem + 128;
    producer = threadIdx.x == blockDim.x - 1;
    if (a.bulk && producer) {
      avsr::mbar_init(&bars[0], 1);
      avsr::mbar_init(&bars[1], 1);
      avsr::mbar_init_fence();
    }
  }

  __device__ unsigned char* own() const {
    return stage0 + a.stages * a.stage_bytes;
  }
  __device__ T* rows(int st) const {
    return reinterpret_cast<T*>(stage0 + st * a.stage_bytes);
  }
  __device__ T* aux(int st) const {
    return reinterpret_cast<T*>(stage0 + st * a.stage_bytes + a.aux_off);
  }
  // strip s: frame f, output rows [o0, o1)
  __device__ void locate(int s, int& f, int& o0, int& o1) const {
    f = s / per_frame;
    o0 = s % per_frame * a.rows;
    o1 = min(o0 + a.rows, ho);
  }
  __device__ bool carried(int s, int o0) const { return s > first && o0 > 0; }

  // runs of n0 and n1 elements into stage st: by the producer as bulk
  // copies on the stage's barrier, or by every thread (the caller
  // synchronises)
  __device__ void fetch(int st, T* d0, const T* s0, int n0, T* d1 = nullptr,
                        const T* s1 = nullptr, int n1 = 0) const {
    if (a.bulk) {
      const uint32_t b0 = static_cast<uint32_t>(n0 * sizeof(T));
      const uint32_t b1 = static_cast<uint32_t>(n1 * sizeof(T));
      avsr::mbar_expect_tx(&bars[st], b0 + b1);
      avsr::bulk_load(d0, s0, b0, &bars[st]);
      if (n1 > 0) avsr::bulk_load(d1, s1, b1, &bars[st]);
    } else {
      for (int e = threadIdx.x; e < n0; e += blockDim.x) d0[e] = s0[e];
      for (int e = threadIdx.x; e < n1; e += blockDim.x) d1[e] = s1[e];
    }
  }
  // the first `stages` strips in flight; fetch(s, st) fetches strip s
  template <typename F>
  __device__ void prime(F fetch_strip) const {
    if (a.bulk && producer)
      for (int st = 0; st < a.stages && first + st < last; ++st)
        fetch_strip(first + st, st);
  }
  // until the rows of strip s (the run's it-th) are in stage st
  template <typename F>
  __device__ void acquire(int it, int s, int st, F fetch_strip) const {
    if (a.bulk) {
      avsr::mbar_wait(&bars[st], (it / a.stages) & 1);
    } else {
      fetch_strip(s, st);
      __syncthreads();
    }
  }
  // n elements of the strip's output from shared src to dst (one bulk
  // store), then stage st takes strip s + stages
  template <typename F>
  __device__ void release(int s, int st, T* dst, const T* src, int n,
                          F fetch_strip) const {
    if (a.bulk) {
      avsr::fence_proxy_async();
      __syncthreads();
      if (producer) {
        avsr::bulk_store(dst, src, static_cast<uint32_t>(n * sizeof(T)));
        if (s + a.stages < last) {
          avsr::bulk_wait_read();
          fetch_strip(s + a.stages, st);
        }
      }
    } else {
      __syncthreads();
      for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = src[e];
      __syncthreads();
    }
  }
  // until the run's stores are complete; the stage buffers are free after
  __device__ void drain() const {
    if (a.bulk && producer) avsr::bulk_wait();
    __syncthreads();
  }
};

template <typename T>
struct ApplyArgs {
  const T* x;
  const float* p;
  T* out;
  StripArgs s;
};

// apply over strips: the strip's input rows 2o0 - 1 .. 2o1 - 1 in a stage
// (row 2o0 - 1 not fetched where it is carried), thread (ch, lane) owning V
// channels and walking window columns ow = lane, + lanes, ...: y =
// PReLU(x * g + b) once for each input element of the column's three
// columns (twice across a column's left edge), the max over the three
// columns of each input row, each window's max down the column (a window's
// bottom row is the next one's top), rounded to T once into the stage's
// output rows, which leave in one bulk store. The strip's last input row's
// maxima are the next strip's first, kept in `carry` (fp32, a window column
// and channel).
template <typename T, int V>
__global__ void __launch_bounds__(kStripThreads, 1)
    apply_kernel(const ApplyArgs<T> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const StripWalk<T> walk(a.s, smem);
  const int chans = a.s.channels, h = a.s.h, wo = walk.wo;
  const int rx = walk.rx, rd = walk.rd;
  float* carry = reinterpret_cast<float*>(walk.own());
  float* prm = carry + ((rd + 3) & ~3);
  stage_affine(a.p, chans, prm);  // ends in __syncthreads
  const int cpr = chans / V, lanes = kStripThreads / cpr;
  const int tid = threadIdx.x, ch = tid % cpr, lane = tid / cpr, c0 = ch * V;
  float g[V], b[V], al[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    g[e] = prm[c0 + e];
    b[e] = prm[chans + c0 + e];
    al[e] = prm[2 * chans + c0 + e];
  }
  auto fetch = [&](int s, int st) {
    int f, o0, o1;
    walk.locate(s, f, o0, o1);
    const int r0 = walk.carried(s, o0) ? 2 * o0 : max(2 * o0 - 1, 0);
    walk.fetch(st, walk.rows(st) + (r0 - 2 * o0 + 1) * rx,
               a.x + (static_cast<size_t>(f) * h + r0) * rx,
               (2 * o1 - r0) * rx);
  };
  // the max of y over the window column's three input columns at stage
  // row sr (column 2ow - 1 is padding at ow = 0); offsets are 32-bit and
  // relative to the stage
  auto row_max = [&](const T* xs, int sr, int off, bool left, float(&m)[V]) {
#pragma unroll
    for (int e = 0; e < V; ++e) m[e] = -INFINITY;  // padding never wins
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (j == 0 && !left) continue;
      float v[V];
      load<T, V>(xs + sr * rx + off + j * chans, v);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float z = __fadd_rn(__fmul_rn(v[e], g[e]), b[e]);
        m[e] = fmaxf(m[e], z >= 0.f ? z : __fmul_rn(al[e], z));
      }
    }
  };

  walk.prime(fetch);
  int it = 0;
  for (int s = walk.first; s < walk.last; ++s, ++it) {
    const int st = it % a.s.stages;
    int f, o0, o1;
    walk.locate(s, f, o0, o1);
    walk.acquire(it, s, st, fetch);
    const T* xs = walk.rows(st);
    T* os = walk.aux(st);
    const bool carried = walk.carried(s, o0);
    for (int ow = lane; lane < lanes && ow < wo; ow += lanes) {
      const bool left = ow > 0;
      const int off = (2 * ow - 1) * chans + c0;
      float* cw = carry + ow * chans + c0;
      float top[V];  // the row maxima of the window's top input row
      if (carried) {
#pragma unroll
        for (int e = 0; e < V; ++e) top[e] = cw[e];
      } else if (o0 > 0) {
        row_max(xs, 0, off, left, top);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) top[e] = -INFINITY;
      }
      for (int q = 0; q < o1 - o0; ++q) {
        float mid[V], bot[V], o[V];
        row_max(xs, 2 * q + 1, off, left, mid);
        row_max(xs, 2 * q + 2, off, left, bot);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          o[e] = fmaxf(fmaxf(top[e], mid[e]), bot[e]);
          top[e] = bot[e];
        }
        store<T, V>(os + q * rd + ow * chans + c0, o);
      }
#pragma unroll
      for (int e = 0; e < V; ++e) cw[e] = top[e];
    }
    walk.release(s, st, a.out + (static_cast<size_t>(f) * walk.ho + o0) * rd,
                 os, (o1 - o0) * rd, fetch);
  }
  walk.drain();
}

// bwd1 over strips: a strip owns input rows 2o0 .. 2o1 - 1 and needs the
// windows o0 .. o1 (window o1 holds its last row), that is input rows
// 2o0 - 1 .. 2o1 + 1 and cotangent rows o0 .. o1, the cotangent rows at
// stage row oh - o0 of the rows of output width.
template <typename T>
struct Bwd1Args {
  const T* x;
  const float* p;
  const T* dout;
  T* dz;
  float* partial;
  int* counter;
  float* red;
  StripArgs s;
};

// For each strip, with thread (ch, lane) owning V channels and walking
// window columns ow = lane, + lanes, ...:
//   A. each window's first maximum (k = 3i + j of its 3x3 candidates, a
//      later candidate winning only if strictly greater), down the column:
//      y of a window's bottom row is the next window's top row; a byte a
//      window and channel in `wins`; the strip's last window row is the
//      next strip's first, kept in `carry`;
//   B. each owned 2x2 block (rows 2oh, 2oh + 1, columns 2ow, 2ow + 1): dy
//      from the <= 4 windows holding each position, added in ascending k
//      as the TPU kernel's scatter adds them (the order of the position's
//      candidates i, then j), dz and the three sums; dz overwrites x in
//      the stage buffer;
//   C. the owned rows of dz leave in one bulk store (or by the threads).
template <typename T, int V>
__global__ void __launch_bounds__(kStripThreads, 1)
    bwd1_kernel(const Bwd1Args<T> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const StripWalk<T> walk(a.s, smem);
  const int chans = a.s.channels, h = a.s.h, ho = walk.ho, wo = walk.wo;
  const int R = a.s.rows, rx = walk.rx, rd = walk.rd;
  // wins: (R + 1) window rows; carry: the last window row of the strip
  // before, which is this strip's first where both are of one frame
  unsigned char* wins = walk.own();
  unsigned char* carry = wins + (((R + 1) * rd + 15) & ~15);
  float* prm = reinterpret_cast<float*>(carry + ((rd + 15) & ~15));
  const int tid = threadIdx.x;
  stage_affine(a.p, chans, prm);  // ends in __syncthreads
  const int cpr = chans / V, lanes = kStripThreads / cpr;
  const int ch = tid % cpr, lane = tid / cpr, c0 = ch * V;
  float g[V], b[V], al[V], mean[V], rstd[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int c = c0 + e;
    g[e] = prm[c];
    b[e] = prm[chans + c];
    al[e] = prm[2 * chans + c];
    mean[e] = prm[3 * chans + c];
    rstd[e] = prm[4 * chans + c];
  }

  // the x and cotangent rows of strip s into stage st
  auto fetch = [&](int s, int st) {
    int f, o0, o1;
    walk.locate(s, f, o0, o1);
    const int nwin = min(o1 + 1, ho) - o0;
    const int r0 = max(2 * o0 - 1, 0), r1 = 2 * (o0 + nwin);
    walk.fetch(st, walk.rows(st) + (r0 - 2 * o0 + 1) * rx,
               a.x + (static_cast<size_t>(f) * h + r0) * rx, (r1 - r0) * rx,
               walk.aux(st), a.dout + (static_cast<size_t>(f) * ho + o0) * rd,
               nwin * rd);
  };
  auto yv = [&](float xv, int e) {
    const float z = __fadd_rn(__fmul_rn(xv, g[e]), b[e]);
    return z < 0.f ? __fmul_rn(al[e], z) : z;
  };

  walk.prime(fetch);
  float acc[3][V] = {};  // dbeta, dgamma, dalpha
  int it = 0;
  for (int s = walk.first; s < walk.last; ++s, ++it) {
    const int st = it % a.s.stages;
    int f, o0, o1;
    walk.locate(s, f, o0, o1);
    const int nwin = min(o1 + 1, ho) - o0;
    walk.acquire(it, s, st, fetch);
    T* xs = walk.rows(st);
    const T* ds = walk.aux(st);

    // A. each window's first maximum. Offsets are 32-bit and relative to
    // the stage: x at (stage row, column 2ow - 1, channel c0) is
    // xs[row * rx + off], its right neighbours at + chans and + 2 chans.
    // Window row 0 is carried where the strip before (this block's, of the
    // same frame) computed it: this thread wrote its part of `carry`
    const int q0 = walk.carried(s, o0) ? 1 : 0;
    for (int ow = lane; lane < lanes && ow < wo; ow += lanes) {
      const bool left = ow > 0;  // column 2ow - 1 lies inside the frame
      const int off = (2 * ow - 1) * chans + c0;
      if (q0 == 1) {
#pragma unroll
        for (int e = 0; e < V; ++e)
          wins[ow * chans + c0 + e] = carry[ow * chans + c0 + e];
      }
      float top[3][V];  // y of window row q0's top row; padding never wins
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        float v[V];
        const bool in = o0 + q0 > 0 && (j > 0 || left);
        if (in) load<T, V>(xs + 2 * q0 * rx + off + j * chans, v);
#pragma unroll
        for (int e = 0; e < V; ++e) top[j][e] = in ? yv(v[e], e) : -INFINITY;
      }
      int row = off + (2 * q0 + 1) * rx;  // stage row 2q + 1, input row 2oh
      int win = (q0 * wo + ow) * chans + c0;
      for (int q = q0; q < nwin; ++q, row += 2 * rx, win += wo * chans) {
        float best[V];
        int kb[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          best[e] = -INFINITY;
          kb[e] = -1;
#pragma unroll
          for (int j = 0; j < 3; ++j)
            if (top[j][e] > best[e]) {
              best[e] = top[j][e];
              kb[e] = j;
            }
        }
#pragma unroll
        for (int i = 1; i < 3; ++i)
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            float v[V];
            if (j > 0 || left)
              load<T, V>(xs + row + (i - 1) * rx + j * chans, v);
#pragma unroll
            for (int e = 0; e < V; ++e) {
              const float y = j > 0 || left ? yv(v[e], e) : -INFINITY;
              if (y > best[e]) {
                best[e] = y;
                kb[e] = 3 * i + j;
              }
              if (i == 2) top[j][e] = y;
            }
          }
        auto put = [&](unsigned char* dst) {
          if constexpr (V == 2) {
            *reinterpret_cast<uint16_t*>(dst) =
                static_cast<uint16_t>((kb[0] & 0xff) | (kb[1] & 0xff) << 8);
          } else {
            *dst = static_cast<unsigned char>(kb[0]);
          }
        };
        put(wins + win);
        if (q == nwin - 1) put(carry + ow * chans + c0);
      }
    }
    __syncthreads();

    // B. dz of the owned 2x2 blocks and the sums; dz replaces x
    for (int ow = lane; lane < lanes && ow < wo; ow += lanes) {
      const bool right = ow + 1 < wo;
      // window row q at columns ow (c = 0) and ow + 1 (c = 1): its first
      // maximum's k (-1 where there is no such window) and cotangent
      int kc[2][V], kn[2][V];
      float gc[2][V], gn[2][V];
      auto window_row = [&](int q, int (&k)[2][V], float (&gd)[2][V]) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int off = (q * wo + ow + c) * chans + c0;
          const bool in = q < nwin && (c == 0 || right);
          if (in) load<T, V>(ds + off, gd[c]);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            k[c][e] = in ? wins[off + e] : -1;
            if (!in) gd[c][e] = 0.f;
          }
        }
      };
      window_row(0, kc, gc);
      int row = rx + 2 * ow * chans + c0;  // stage row 2q + 1, column 2ow
      for (int q = 0; q < o1 - o0; ++q, row += 2 * rx) {
        window_row(q + 1, kn, gn);
#pragma unroll
        for (int pa = 0; pa < 2; ++pa)
#pragma unroll
          for (int pb = 0; pb < 2; ++pb) {
            T* px = xs + row + pa * rx + pb * chans;
            float xv[V], dzs[V];
            load<T, V>(px, xv);
#pragma unroll
            for (int e = 0; e < V; ++e) {
              // the position's windows in ascending k: candidate row i
              // (0: the window below, 1 or 2: this one), then column j
              float dy = 0.f;
              auto take = [&](int kw, float gw, int k) {
                if (kw == k) dy = __fadd_rn(dy, gw);
              };
              if (pa == 0 && pb == 0) {
                take(kc[0][e], gc[0][e], 4);
              } else if (pa == 0) {
                take(kc[1][e], gc[1][e], 3);
                take(kc[0][e], gc[0][e], 5);
              } else if (pb == 0) {
                take(kn[0][e], gn[0][e], 1);
                take(kc[0][e], gc[0][e], 7);
              } else {
                take(kn[1][e], gn[1][e], 0);
                take(kn[0][e], gn[0][e], 2);
                take(kc[1][e], gc[1][e], 6);
                take(kc[0][e], gc[0][e], 8);
              }
              const float zv = __fadd_rn(__fmul_rn(xv[e], g[e]), b[e]);
              const bool neg = zv < 0.f;
              const float dzv = neg ? __fmul_rn(al[e], dy) : dy;
              const float xhat = __fmul_rn(__fsub_rn(xv[e], mean[e]), rstd[e]);
              dzs[e] = dzv;
              acc[0][e] += dzv;
              acc[1][e] = fmaf(dzv, xhat, acc[1][e]);
              if (neg) acc[2][e] = fmaf(dy, zv, acc[2][e]);
            }
            store<T, V>(px, dzs);
          }
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int e = 0; e < V; ++e) {
            kc[c][e] = kn[c][e];
            gc[c][e] = gn[c][e];
          }
      }
    }

    // C. the owned rows of dz (stage rows 1 .. 2 (o1 - o0)) out; then the
    // stage takes strip s + stages
    walk.release(s, st, a.dz + (static_cast<size_t>(f) * h + 2 * o0) * rx,
                 xs + rx, 2 * (o1 - o0) * rx, fetch);
  }
  walk.drain();
  // the stage buffers are free: they hold the block's sums
  reduce_channels<3, V>(acc, ch, lane, lanes, chans,
                        reinterpret_cast<float*>(walk.rows(0)), a.partial,
                        a.counter, a.red);
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

// The strips of a pass (`StripWalk`): the most output rows R <= kStripRows
// whose buffers fit in shared memory, that is `stages` buffers of 2R + xr
// input rows and R + dr rows of output width, after 128 bytes of barriers,
// then the pass's own buffers (own(R) bytes), and at least `least` bytes in
// all. Two buffers where the rows move by bulk copies (every row a 16-byte
// multiple, every pointer 16-byte aligned), else one. False where no strip
// of one output row fits.
struct StripPlan {
  int rows, stages, stage_bytes, aux_off, smem, bulk;
};

template <typename Own>
bool strip_plan(int channels, int h, int w, size_t elem, bool aligned, int xr,
                int dr, Own own, size_t least, StripPlan& plan) {
  const auto up = [](size_t b, size_t to) { return (b + to - 1) / to * to; };
  const size_t rowx = static_cast<size_t>(w) * channels * elem;
  const size_t rowd = rowx / 2;
  plan.bulk = aligned && rowx % 16 == 0 && rowd % 16 == 0;
  for (int stages = plan.bulk ? 2 : 1; stages >= 1; --stages)
    for (int r = std::min(kStripRows, h / 2); r >= 1; --r) {
      const size_t aux_off = up((2 * r + xr) * rowx, 16);
      const size_t stage = up(aux_off + (r + dr) * rowd, 128);
      const size_t smem = std::max(least, 128 + stages * stage + own(r));
      if (smem <= static_cast<size_t>(kMaxSmem)) {
        plan.rows = r;
        plan.stages = stages;
        plan.stage_bytes = static_cast<int>(stage);
        plan.aux_off = static_cast<int>(aux_off);
        plan.smem = static_cast<int>(smem);
        return true;
      }
    }
  return false;
}

// a strip pass's kernel on `plan`: one block an SM (no more blocks than
// strips or kMaxBlocks), each walking a run of strips
template <typename Args>
cudaError_t launch_strips(void (*kernel)(Args), const StripPlan& plan,
                          Args args, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           plan.smem)) != cudaSuccess ||
      (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kStripThreads, plan.smem)) != cudaSuccess)
    return err;
  const StripArgs& a = args.s;
  const int strips = a.n * ((a.h / 2 + plan.rows - 1) / plan.rows);
  const int grid = std::min({strips, std::max(1, sms * per_sm), kMaxBlocks});
  kernel<<<grid, kStripThreads, plan.smem, stream>>>(args);
  return cudaGetLastError();
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  bool ok = true;
  for (const void* q : ptrs)
    ok = ok && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  return ok;
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
  return dispatch<2>(dtype, channels, {x, out}, [&](auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int V = decltype(tag)::vec;
    // own buffers: the carried row maxima (fp32) and the parameters
    const size_t carry = (static_cast<size_t>(w / 2) * channels + 3) / 4 * 16;
    StripPlan plan;
    if (!strip_plan(channels, h, w, sizeof(T), aligned16({x, out}), 1, 0,
                    [&](int) { return carry + 5 * channels * sizeof(float); },
                    0, plan))
      return cudaErrorInvalidValue;
    const ApplyArgs<T> args{
        static_cast<const T*>(x), p, static_cast<T*>(out),
        {n, channels, h, w, plan.rows, plan.stages, plan.stage_bytes,
         plan.aux_off, plan.bulk}};
    return launch_strips(apply_kernel<T, V>, plan, args,
                         static_cast<cudaStream_t>(stream));
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
  return dispatch<2>(dtype, channels, {x, dout, dz}, [&](auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int V = decltype(tag)::vec;
    // own buffers: wins ((R + 1) window rows, a byte a window and channel),
    // carry (one window row), the parameters; the block's sums at the end
    const size_t rowd = static_cast<size_t>(w / 2) * channels;
    const auto up16 = [](size_t b) { return (b + 15) / 16 * 16; };
    StripPlan plan;
    if (!strip_plan(channels, h, w, sizeof(T), aligned16({x, dout, dz}), 3, 1,
                    [&](int r) {
                      return up16((r + 1) * rowd) + up16(rowd) +
                             5 * channels * sizeof(float);
                    },
                    128 + sizeof(float) * 3 * kStripThreads * V, plan))
      return cudaErrorInvalidValue;
    const Bwd1Args<T> args{
        static_cast<const T*>(x), p, static_cast<const T*>(dout),
        static_cast<T*>(dz), partial, counter, red,
        {n, channels, h, w, plan.rows, plan.stages, plan.stage_bytes,
         plan.aux_off, plan.bulk}};
    return launch_strips(bwd1_kernel<T, V>, plan, args,
                         static_cast<cudaStream_t>(stream));
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
