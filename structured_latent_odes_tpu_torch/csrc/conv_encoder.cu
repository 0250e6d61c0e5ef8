// The conv encoder's front end: a VALID conv1d, its bias, an average pool of
// stride 1 and the filter-major flatten, forward (conv_pool_fwd) and its
// weight gradient (conv_pool_wgrad). Per trajectory, K channels of T steps,
// F filters of width W, a pool of width P (n_conv = T - W + 1 conv outputs,
// n_pool = n_conv - P + 1 pooled):
//
//     c[f, t]   = sum_{k, j} w[f, k, j] * x[k, t + j] + b[f]
//     out[f, p] = (c[f, p] + ... + c[f, p + P - 1]) / P
//     out is written flat, f * n_pool + p
//
// and backward, from the flat output's gradient g:
//
//     gc[f, t]     = sum_{p = max(0, t-P+1)}^{min(t, n_pool-1)} g[f, p] / P
//     dw[f, k, j]  = sum_b sum_t gc[b, f, t] * x[b, k, t + j]
//     db[f]        = sum_b sum_t gc[b, f, t]
//
// It replaces no TPU kernel: the JAX package leaves this to XLA
// (structured_latent_odes_tpu/nn/layers.py::conv_encoder_apply,
// lax.conv_general_dilated and the pool). Under torch.func.vmap over an
// ensemble's members cuDNN ran it as a grouped convolution, one group a
// member, and its deterministic weight gradient for that took milliseconds a
// dual step; these kernels take the members on blockIdx.y instead.
//
// Bound on this card: neither. At proc (S = 10 members x B = 36, K = 4,
// T = 100, F = W = 10, P = 5) the forward is 2*S*B*F*K*W*n_conv = 26 MFLOP
// and reads 576 KB (x) and writes 1.25 MB: well under a microsecond at 67
// TFLOP/s float32 or 3.35 TB/s. A launch is latency: one block's loads of its
// trajectory, its (k, j) chain of FMAs, the stores.
//
// Design.
//   Forward: one block a trajectory (blockIdx.x) of one member (blockIdx.y).
//   The block copies x's K rows, the member's weights and bias into shared
//   memory, a thread per conv output (f, t) runs the K*W FMAs in (k, j)
//   order and adds the bias, and a thread per pooled output sums its P conv
//   outputs in order and divides by P: conv, then the average, as F.conv1d
//   and F.avg_pool1d compute them (no folding of the pool into a wider
//   filter). Threads write the pooled outputs in the flat order, coalesced.
//   Weight gradient: blockIdx.x owns a fixed run of `per_block` trajectories
//   of member blockIdx.y. For each it copies x and g into shared memory,
//   applies the pool's backward there (gc, each sum over p ascending), and a
//   thread per weight or bias element sums its n_conv products in t order,
//   then adds that trajectory's sum to its own slot in shared memory. The
//   block writes its slots as one row of an (S, n_blocks, F*K*W + F)
//   partial buffer, and a second kernel (conv_pool_wgrad_sum) adds each
//   column's rows in block order. No atomics: the sums' order is fixed by B
//   alone, so launches are bit-identical, and a member's gradients are
//   bit-equal to a single-member launch on its slices.
//
// Each member's x, g, weights and bias are its slice of an array with a
// leading member axis, `*_ms` floats apart (0 for an array all members
// share, such as the val ELBO's observations). Within a member every array
// is contiguous: x (B, K, T), w (F, K, W), b (F,), out and g (B, F*n_pool).
//
// float32 FMAs throughout: the configurations state float32 with TF32 off,
// and the products are far below a tensor-core tile.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kFwdThreads = 256;
constexpr int kSumThreads = 128;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kSmemLimit = 232448;  // 227 KB, a block's most on an H100

struct Shape {
  int B, K, T, F, W, P;
  __host__ __device__ int n_conv() const { return T - W + 1; }
  __host__ __device__ int n_pool() const { return n_conv() - P + 1; }
  __host__ __device__ int n_params() const { return F * K * W + F; }
};

// shared memory, in floats, of a forward and of a weight-gradient block;
// ops/conv_encoder.py::smem_bytes mirrors both, and refuses a shape past
// kSmemLimit before any launch
size_t fwd_smem_floats(const Shape& s) {
  return static_cast<size_t>(s.K) * s.T + s.F * s.K * s.W + s.F + static_cast<size_t>(s.F) * s.n_conv();
}

size_t wgrad_smem_floats(const Shape& s) {
  return static_cast<size_t>(s.K) * s.T + static_cast<size_t>(s.F) * s.n_pool() +
         static_cast<size_t>(s.F) * s.n_conv() + s.n_params();
}

bool valid(const Shape& s) {
  return s.B >= 0 && s.K > 0 && s.F > 0 && s.W > 0 && s.P > 0 && s.n_pool() > 0;
}

__global__ void __launch_bounds__(kFwdThreads)
conv_pool_fwd_kernel(const float* __restrict__ x, long long x_ms, const float* __restrict__ w, long long w_ms,
                     const float* __restrict__ bias, long long b_ms, float* __restrict__ out, Shape s) {
  const int n_conv = s.n_conv();
  const int n_pool = s.n_pool();
  const int kw = s.K * s.W;
  extern __shared__ float smem[];
  float* xs = smem;               // K * T
  float* ws = xs + s.K * s.T;     // F * K * W
  float* bs = ws + s.F * kw;      // F
  float* cs = bs + s.F;           // F * n_conv
  const int m = blockIdx.y;
  const int b = blockIdx.x;
  x += m * x_ms + static_cast<size_t>(b) * s.K * s.T;
  w += m * w_ms;
  bias += m * b_ms;
  out += (static_cast<size_t>(m) * s.B + b) * s.F * n_pool;
  for (int i = threadIdx.x; i < s.K * s.T; i += blockDim.x) xs[i] = x[i];
  for (int i = threadIdx.x; i < s.F * kw; i += blockDim.x) ws[i] = w[i];
  for (int i = threadIdx.x; i < s.F; i += blockDim.x) bs[i] = bias[i];
  __syncthreads();
  for (int o = threadIdx.x; o < s.F * n_conv; o += blockDim.x) {
    const int f = o / n_conv;
    const int t = o - f * n_conv;
    const float* wf = ws + f * kw;
    float acc = 0.f;
    for (int k = 0; k < s.K; ++k) {
      const float* xk = xs + k * s.T + t;
      const float* wk = wf + k * s.W;
      for (int j = 0; j < s.W; ++j) acc = fmaf(wk[j], xk[j], acc);
    }
    cs[o] = acc + bs[f];
  }
  __syncthreads();
  const float pool = static_cast<float>(s.P);
  for (int o = threadIdx.x; o < s.F * n_pool; o += blockDim.x) {
    const int f = o / n_pool;
    const float* c = cs + f * n_conv + (o - f * n_pool);
    float sum = c[0];
    for (int i = 1; i < s.P; ++i) sum += c[i];
    out[o] = sum / pool;
  }
}

__global__ void __launch_bounds__(1024)
conv_pool_wgrad_kernel(const float* __restrict__ x, long long x_ms, const float* __restrict__ g, long long g_ms,
                       float* __restrict__ partial, Shape s, int per_block) {
  const int n_conv = s.n_conv();
  const int n_pool = s.n_pool();
  const int kw = s.K * s.W;
  const int n_w = s.F * kw;
  const int n_params = s.n_params();
  extern __shared__ float smem[];
  float* xs = smem;                 // K * T
  float* gs = xs + s.K * s.T;       // F * n_pool
  float* gc = gs + s.F * n_pool;    // F * n_conv
  float* acc = gc + s.F * n_conv;   // n_params: slot o is thread (o mod blockDim)'s alone
  const int m = blockIdx.y;
  x += m * x_ms;
  g += m * g_ms;
  for (int o = threadIdx.x; o < n_params; o += blockDim.x) acc[o] = 0.f;
  const float pool = static_cast<float>(s.P);
  const int b0 = blockIdx.x * per_block;
  const int b1 = min(s.B, b0 + per_block);
  for (int b = b0; b < b1; ++b) {
    const float* xb = x + static_cast<size_t>(b) * s.K * s.T;
    const float* gb = g + static_cast<size_t>(b) * s.F * n_pool;
    __syncthreads();  // the previous trajectory's reads are done
    for (int i = threadIdx.x; i < s.K * s.T; i += blockDim.x) xs[i] = xb[i];
    for (int i = threadIdx.x; i < s.F * n_pool; i += blockDim.x) gs[i] = gb[i];
    __syncthreads();
    // the pool's backward: conv output t takes g[p] / P of each window p over it
    for (int o = threadIdx.x; o < s.F * n_conv; o += blockDim.x) {
      const int f = o / n_conv;
      const int t = o - f * n_conv;
      const float* gf = gs + f * n_pool;
      float sum = 0.f;
      for (int p = max(0, t - s.P + 1); p <= min(t, n_pool - 1); ++p) sum += gf[p] / pool;
      gc[o] = sum;
    }
    __syncthreads();
    for (int o = threadIdx.x; o < n_params; o += blockDim.x) {
      float sum = 0.f;
      if (o < n_w) {
        const int f = o / kw;
        const int r = o - f * kw;
        const int k = r / s.W;
        const float* gf = gc + f * n_conv;
        const float* xk = xs + k * s.T + (r - k * s.W);
        for (int t = 0; t < n_conv; ++t) sum = fmaf(gf[t], xk[t], sum);
      } else {
        const float* gf = gc + (o - n_w) * n_conv;
        for (int t = 0; t < n_conv; ++t) sum += gf[t];
      }
      acc[o] += sum;
    }
  }
  float* row = partial + (static_cast<size_t>(m) * gridDim.x + blockIdx.x) * n_params;
  for (int o = threadIdx.x; o < n_params; o += blockDim.x) row[o] = acc[o];
}

// grads[m, o] = the sum of partial[m, :, o] in block order
__global__ void __launch_bounds__(kSumThreads)
conv_pool_wgrad_sum(const float* __restrict__ partial, float* __restrict__ grads, int n_blocks, int n_params) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  const int m = blockIdx.y;
  if (o >= n_params) return;
  const float* p = partial + static_cast<size_t>(m) * n_blocks * n_params + o;
  float sum = 0.f;
  for (int i = 0; i < n_blocks; ++i) sum += p[static_cast<size_t>(i) * n_params];
  grads[static_cast<size_t>(m) * n_params + o] = sum;
}

template <typename Kernel>
int opt_in(Kernel kernel, size_t bytes) {
  if (bytes > static_cast<size_t>(kSmemLimit)) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes <= static_cast<size_t>(kDefaultSmem)) return static_cast<int>(cudaSuccess);
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace

// S members, each: x (B, K, T) every x_ms floats, w (F, K, W) every w_ms,
// b (F,) every b_ms; out (S, B, F * n_pool), contiguous. All float32 on one
// device.
extern "C" int conv_pool_fwd(const float* x, long long x_ms, const float* w, long long w_ms, const float* b,
                             long long b_ms, float* out, int S, int B, int K, int T, int F, int W, int P,
                             void* stream) {
  const Shape s{B, K, T, F, W, P};
  if (!valid(s) || S > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (S <= 0 || B <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = sizeof(float) * fwd_smem_floats(s);
  const int err = opt_in(conv_pool_fwd_kernel, smem);
  if (err != 0) return err;
  conv_pool_fwd_kernel<<<dim3(B, S), kFwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, x_ms, w, w_ms, b, b_ms, out, s);
  return static_cast<int>(cudaGetLastError());
}

// S members, each: x (B, K, T) every x_ms floats and g (B, F * n_pool) every
// g_ms; partial (S, n_blocks, F*K*W + F) scratch, n_blocks = ceil(B /
// per_block); grads (S, F*K*W + F): dw flat, then db. All float32 on one
// device.
extern "C" int conv_pool_wgrad(const float* x, long long x_ms, const float* g, long long g_ms, float* partial,
                               float* grads, int S, int B, int K, int T, int F, int W, int P, int per_block,
                               void* stream) {
  const Shape s{B, K, T, F, W, P};
  if (!valid(s) || S > 65535 || per_block < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (S <= 0 || B <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * wgrad_smem_floats(s);
  int err = opt_in(conv_pool_wgrad_kernel, smem);
  if (err != 0) return err;
  const int n_params = s.n_params();
  const int n_blocks = (B + per_block - 1) / per_block;
  const int threads = std::min(1024, (n_params + 31) / 32 * 32);
  conv_pool_wgrad_kernel<<<dim3(n_blocks, S), threads, smem, st>>>(x, x_ms, g, g_ms, partial, s, per_block);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  conv_pool_wgrad_sum<<<dim3((n_params + kSumThreads - 1) / kSumThreads, S), kSumThreads, 0, st>>>(
      partial, grads, n_blocks, n_params);
  return static_cast<int>(cudaGetLastError());
}
