// The CTC loss: the per-sample negative log-likelihood of log-probs
// (B, T, V) fp32 under labels (B, L), and its gradient with respect to the
// logits, with the lengths (B,) read on the card.
//
// Replaces no Pallas kernel: the JAX package computes the loss with
// optax.ctc_loss (avsr_tpu/ops/ctc.py:35), a scan inside the compiled step
// whose lengths are device operands. The port had called F.ctc_loss, which
// reads its CUDA length tensors on the host in the forward and the
// backward (the training step's only host syncs), and whose fp32 gradient
// forms each posterior as exp(log alpha + log beta + nll - lp): a sum of
// numbers of the size of the NLL (thousands of nats at T=384), so the
// posterior carries the NLL's ulp (2.4e-4 at 3,000) as relative error.
//
// What bounds it on the card: the forward is two chains of T dependent
// frame steps (alpha and beta), each step a logsumexp over three states,
// a block-wide max and one barrier, so its time is the chain's latency,
// not its bytes (it reads T * S emissions and writes 2 * T * S values).
// The backward reads the log-probs and writes the gradient, (B, T, V)
// fp32 each: 93 MB at B=6, T=384, V=5049, 28 us at 3.35 TB/s; the bytes
// bound it.
//
// Design.
// - ctc_forward_kernel, grid (2, B): block (0, b) runs sample b's alpha
//   recursion, block (1, b) its beta recursion, side by side, so the chain
//   is T steps, not 2T. A thread holds states tid + k * kThreads (up to
//   kMaxChunks of them, S = 2L+1 <= 1024). Each frame's values are
//   exchanged through a double-buffered row in shared memory, with the
//   block's largest value of the frame reduced by warp shuffles into one
//   slot a warp: one __syncthreads a frame. The emissions a thread needs
//   (its states' labels' columns) are copied kRing - 1 frames ahead with
//   cp.async into a ring of frames in shared memory, so the chain does not
//   wait on memory.
// - Precision: the recursions run in float64, each frame shifted by the
//   largest entry of the frame before (alpha: log alpha less the shifts;
//   beta: log beta less the largest entry of beta + emission a frame
//   later), so no value grows with T; the shifts are summed apart, in
//   float64, for the loss. alpha is stored less its own frame's largest
//   entry (known one step later), beta as computed, both O(1) and in
//   float64 (2 * B * T * S * 8 bytes, 3.6 MB at B=6, L=48): the
//   posterior exp(z - logsumexp_s z), z = alpha + beta, then carries no
//   rounding of its own beyond fp32's last exp, and the gradient's error
//   is about that of the fp32 log-probs (~2e-7 relative L2), not the
//   NLL's ulp.
// - ctc_grad_kernel, grid (T, B): a block a (frame, sample) normalises the
//   frame's posteriors (block max and sum in float64, fixed order), writes
//   the row grad_nll * softmax densely, and after a barrier the first
//   state of each label (in state order) sums that label's posteriors in
//   state order and rewrites its column as grad_nll * (softmax - sum):
//   every value written by one thread, in a fixed order, so two calls are
//   bit-equal. Frames past a sample's length, and samples that are
//   infeasible (T < L + repeats) or whose NLL is not finite, get zeros.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // the forward's block: states a chunk
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunks = 8;  // S = 2L+1 <= kThreads * kMaxChunks
constexpr int kRing = 6;       // frames of emissions in shared memory
constexpr int kGradThreads = 256;
constexpr int kGradWarps = kGradThreads / 32;
constexpr double kGuard = -3.0e38;  // so that -inf - -inf never occurs
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int clamp_len(int64_t n, int hi) {
  return static_cast<int>(n < 0 ? 0 : (n > hi ? hi : n));
}

__device__ __forceinline__ int label_at(const int64_t* lab, int i, int v) {
  const int64_t x = lab[i];
  return static_cast<int>(x < 0 ? 0 : (x >= v ? v - 1 : x));
}

// the extended label of state s < 2L+1: blank at even states
__device__ __forceinline__ int ext_label(const int64_t* lab, int s,
                                         int blank, int v) {
  return (s & 1) ? label_at(lab, (s - 1) / 2, v) : blank;
}

// log(e^a + e^b + e^c): shifted by the guarded largest, summed left to
// right (the twin's _lse3)
__device__ __forceinline__ double lse3(double a, double b, double c) {
  const double m = fmax(fmax(fmax(a, b), c), kGuard);
  return m + log(exp(a - m) + exp(b - m) + exp(c - m));
}

__device__ __forceinline__ double warp_max_d(double x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmax(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ double warp_sum_d(double x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__global__ void __launch_bounds__(kThreads)
    ctc_forward_kernel(const float* __restrict__ logp,
                       const int64_t* __restrict__ labels,
                       const int64_t* __restrict__ logit_lengths,
                       const int64_t* __restrict__ label_lengths,
                       float* __restrict__ nll, float* __restrict__ keep,
                       double* __restrict__ alpha,
                       double* __restrict__ beta, int T, int V, int L,
                       int blank) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = 2 * L + 1;
  const int stride = S + 4;  // state s at s + 2: two -inf pads each side
  double* val = reinterpret_cast<double*>(smem);  // [2][stride]
  double* wmax = val + 2 * stride;                // [2][kWarps]
  float* ring = reinterpret_cast<float*>(wmax + 2 * kWarps);  // [kRing][S]
  const int b = blockIdx.y;
  const bool fwd = blockIdx.x == 0;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int w = tid / 32;
  const int tb = clamp_len(logit_lengths[b], T);
  const int ln = clamp_len(label_lengths[b], L);
  const int sv = 2 * ln + 1;  // the sample's states
  const int nc = (S + kThreads - 1) / kThreads;
  const int64_t* lab = labels + static_cast<size_t>(b) * L;
  const float* lp = logp + static_cast<size_t>(b) * T * V;
  double* out = (fwd ? alpha : beta) + static_cast<size_t>(b) * T * S;

  // a thread's states: their columns, and whether the skip transition
  // (s - 2 -> s for alpha, s -> s + 2 for beta) is open: into a label
  // state that differs from the label before it
  int col[kMaxChunks];
  bool skp[kMaxChunks];
#pragma unroll
  for (int k = 0; k < kMaxChunks; ++k) {
    const int s = tid + k * kThreads;
    col[k] = s < S ? ext_label(lab, s, blank, V) : blank;
    const int into = fwd ? s : s + 2;
    skp[k] = (into & 1) && into >= 3 && into < sv &&
             label_at(lab, (into - 1) / 2, V) !=
                 label_at(lab, (into - 3) / 2, V);
  }
  for (int i = tid; i < 2 * (stride + kWarps); i += kThreads)
    val[i] = -INFINITY;  // wmax too
  int repeats = 0;  // equal neighbours in the valid labels (alpha block)
  if (fwd) {
    for (int base = 0; base < ln - 1; base += kThreads) {
      const int j = base + tid;
      repeats += __syncthreads_count(
          j < ln - 1 && label_at(lab, j, V) == label_at(lab, j + 1, V));
    }
  }

  // step i works on frame i (alpha) or tb - 1 - i (beta); its emissions
  // are copied kRing - 1 steps ahead, one commit group a step
  auto fetch = [&](int i) {
    if (i < tb) {
      const float* row = lp + static_cast<size_t>(fwd ? i : tb - 1 - i) * V;
      float* dst = ring + (i % kRing) * S;
#pragma unroll
      for (int k = 0; k < kMaxChunks; ++k) {
        const int s = tid + k * kThreads;
        if (k < nc && s < S) avsr::cp_async4(dst + s, row + col[k]);
      }
    }
    avsr::cp_async_commit();
  };
#pragma unroll 1
  for (int i = 0; i < kRing - 1; ++i) fetch(i);
  __syncthreads();

  double u[kMaxChunks];  // alpha: this thread's states at the last frame
#pragma unroll
  for (int k = 0; k < kMaxChunks; ++k) u[k] = -INFINITY;
  double shift = 0.0;
  int cur = 0;
#pragma unroll 1
  for (int i = 0; i < tb; ++i) {
    fetch(i + kRing - 1);
    avsr::cp_async_wait<kRing - 1>();
    const float* em = ring + (i % kRing) * S;
    const double* prev = val + cur * stride + 2;
    double* next = val + (cur ^ 1) * stride + 2;
    double d = -INFINITY;  // the largest entry of the frame before
#pragma unroll
    for (int j = 0; j < kWarps; ++j) d = fmax(d, wmax[cur * kWarps + j]);
    d = fmax(d, kGuard);
    if (fwd && i > 0) shift += d;
    const int t = fwd ? i : tb - 1 - i;
    double m = -INFINITY;
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k) {
      const int s = tid + k * kThreads;
      if (k < nc && s < S) {
        double nv = -INFINITY;
        if (fwd) {
          if (s < sv) {
            if (i == 0)
              nv = s < 2 ? static_cast<double>(em[s]) : -INFINITY;
            else
              nv = (lse3(prev[s], prev[s - 1],
                         skp[k] ? prev[s - 2] : -INFINITY) - d) +
                   static_cast<double>(em[s]);
          }
          // the frame before, less its largest entry (known now)
          if (i > 0) out[static_cast<size_t>(i - 1) * S + s] = u[k] - d;
          u[k] = nv;
        } else {
          double vb = -INFINITY;
          if (s < sv) {
            if (i == 0)
              vb = (s == sv - 1 || s == sv - 2) ? 0.0 : -INFINITY;
            else
              vb = lse3(prev[s], prev[s + 1],
                        skp[k] ? prev[s + 2] : -INFINITY) - d;
          }
          out[static_cast<size_t>(t) * S + s] = vb;
          nv = vb + static_cast<double>(em[s]);
        }
        next[s] = nv;
        m = fmax(m, nv);
      }
    }
    m = warp_max_d(m);
    if (lane == 0) wmax[(cur ^ 1) * kWarps + w] = m;
    __syncthreads();
    cur ^= 1;
  }
  avsr::cp_async_wait<0>();
  if (!fwd) return;
  if (tb > 0) {
    double d = -INFINITY;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) d = fmax(d, wmax[cur * kWarps + j]);
    d = fmax(d, kGuard);
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k) {
      const int s = tid + k * kThreads;
      if (k < nc && s < S) out[static_cast<size_t>(tb - 1) * S + s] = u[k] - d;
    }
  }
  if (tid == 0) {
    const double* last = val + cur * stride + 2;
    double logp_seq;
    if (tb > 0)
      logp_seq = shift + lse3(last[sv - 1], ln > 0 ? last[sv - 2] : -INFINITY,
                              -INFINITY);
    else
      logp_seq = ln == 0 ? 0.0 : -INFINITY;
    const double n = -logp_seq;
    const bool ok = tb >= ln + repeats && isfinite(n);
    nll[b] = ok ? static_cast<float>(n) : 0.0f;
    keep[b] = ok ? 1.0f : 0.0f;
  }
}

// deterministic block reductions of one double a thread, the result in
// every thread; `red` holds kGradWarps doubles, reused only after a barrier
__device__ __forceinline__ double block_max_d(double x, double* red) {
  x = warp_max_d(x);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  double r = red[0];
#pragma unroll
  for (int j = 1; j < kGradWarps; ++j) r = fmax(r, red[j]);
  return r;
}

__device__ __forceinline__ double block_sum_d(double x, double* red) {
  x = warp_sum_d(x);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  double r = red[0];
#pragma unroll
  for (int j = 1; j < kGradWarps; ++j) r += red[j];
  return r;
}

__global__ void __launch_bounds__(kGradThreads)
    ctc_grad_kernel(const float* __restrict__ logp,
                    const double* __restrict__ alpha,
                    const double* __restrict__ beta,
                    const int64_t* __restrict__ labels,
                    const int64_t* __restrict__ logit_lengths,
                    const int64_t* __restrict__ label_lengths,
                    const float* __restrict__ keep,
                    const float* __restrict__ grad_nll,
                    float* __restrict__ grad, int T, int V, int L,
                    int blank) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = 2 * L + 1;
  double* red = reinterpret_cast<double*>(smem);  // [2][kGradWarps]
  float* gam = reinterpret_cast<float*>(red + 2 * kGradWarps);  // [S]
  int* ext = reinterpret_cast<int*>(gam + S);                    // [S]
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t row_at = (static_cast<size_t>(b) * T + t) * V;
  float* row = grad + row_at;
  const int tb = clamp_len(logit_lengths[b], T);
  if (t >= tb || keep[b] == 0.0f) {
    for (int v = tid; v < V; v += kGradThreads) row[v] = 0.0f;
    return;
  }
  const float g = grad_nll[b];
  const float* lrow = logp + row_at;
  const int ln = clamp_len(label_lengths[b], L);
  const int sv = 2 * ln + 1;
  const int64_t* lab = labels + static_cast<size_t>(b) * L;
  const size_t at = (static_cast<size_t>(b) * T + t) * S;
  double zmax = -INFINITY;
  for (int s = tid; s < sv; s += kGradThreads) {
    ext[s] = ext_label(lab, s, blank, V);
    zmax = fmax(zmax, alpha[at + s] + beta[at + s]);
  }
  zmax = fmax(block_max_d(zmax, red), kGuard);
  double sum = 0.0;
  for (int s = tid; s < sv; s += kGradThreads)
    sum += exp(alpha[at + s] + beta[at + s] - zmax);
  const double norm = zmax + log(block_sum_d(sum, red + kGradWarps));
  for (int s = tid; s < sv; s += kGradThreads)
    gam[s] = expf(static_cast<float>(alpha[at + s] + beta[at + s] - norm));
  // the dense row: grad_nll * softmax
  for (int v = tid; v < V; v += kGradThreads) row[v] = g * expf(lrow[v]);
  __syncthreads();
  // each label's column, rewritten by its first state
  for (int s = tid; s < sv; s += kGradThreads) {
    const int c = ext[s];
    bool first = true;
    for (int j = 0; j < s && first; ++j) first = ext[j] != c;
    if (!first) continue;
    float post = 0.0f;
    for (int j = s; j < sv; ++j)
      if (ext[j] == c) post += gam[j];
    row[c] = g * (expf(lrow[c]) - post);
  }
}

}  // namespace

// logp (b, t, v) fp32, labels (b, l) int64, the lengths (b,) int64, all
// contiguous on the card; writes nll and keep (b,) fp32, alpha and beta
// (b, t, 2l+1) float64 (entries past a sample's length unwritten).
extern "C" int avsr_ctc_loss_fwd(const float* logp, const int64_t* labels,
                                 const int64_t* logit_lengths,
                                 const int64_t* label_lengths, float* nll,
                                 float* keep, double* alpha, double* beta,
                                 int b, int t, int v, int l, int blank,
                                 void* stream) {
  const int s = 2 * l + 1;
  if (b <= 0 || b > 65535 || t <= 0 || v <= 0 || l < 0 ||
      s > kThreads * kMaxChunks || blank < 0 || blank >= v)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (2 * (s + 4) + 2 * kWarps) * sizeof(double) +
                      static_cast<size_t>(kRing) * s * sizeof(float);
  ctc_forward_kernel<<<dim3(2, b), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      logp, labels, logit_lengths, label_lengths, nll, keep, alpha, beta, t,
      v, l, blank);
  return static_cast<int>(cudaGetLastError());
}

// the logits' gradient (b, t, v) fp32 from the forward's alpha, beta and
// keep and the upstream gradient grad_nll (b,) fp32
extern "C" int avsr_ctc_loss_bwd(const float* logp, const double* alpha,
                                 const double* beta, const int64_t* labels,
                                 const int64_t* logit_lengths,
                                 const int64_t* label_lengths,
                                 const float* keep, const float* grad_nll,
                                 float* grad, int b, int t, int v, int l,
                                 int blank, void* stream) {
  const int s = 2 * l + 1;
  if (b <= 0 || b > 65535 || t <= 0 || v <= 0 || l < 0 ||
      s > kThreads * kMaxChunks || blank < 0 || blank >= v)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * kGradWarps * sizeof(double) +
                      static_cast<size_t>(s) * (sizeof(float) + sizeof(int));
  ctc_grad_kernel<<<dim3(t, b), kGradThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      logp, alpha, beta, labels, logit_lengths, label_lengths, keep,
      grad_nll, grad, t, v, l, blank);
  return static_cast<int>(cudaGetLastError());
}
