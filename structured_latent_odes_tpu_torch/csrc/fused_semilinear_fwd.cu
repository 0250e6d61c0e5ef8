// Kernel K2, fused_semilinear_fwd: the whole semilinear Runge-Kutta solve of
// the decoder ODE  dx/dt = a(t, z) - d(t, z) * x  in one launch. Per step t
// and RK stage i (stage time tau = sts[t][i]):
//
//     h = relu(u + tau * w_t)                 (H)
//     a = sigmoid(W_a h + b_a)                (D)
//     d = sigmoid(W_d h + b_d)                (D)
//
// then the step's affine map (A, B) from the RK recurrence run at x = 0 and
// x = 1 (B = run(0), A = run(1) - B), and x_{t+1} = A * x_t + B.
//
// Replaces the Pallas TPU kernel structured_latent_odes_tpu/ops/fused_step.py
// ::_fwd_kernel, launched by _fwd_call (forward only: _bwd_kernel is the
// training slice's work).
//
// Design: one trajectory per thread. The thread keeps its row of u (H floats)
// and its state (D floats) in registers for the whole solve; the head weights
// and biases (H + 2DH + 2D floats) and the stage-time and step tables live in
// shared memory, read by every thread of the block at the same address (a
// broadcast). The stages are unrolled at compile time from the tableau: one
// template instance per method. H and D are compile-time constants
// (-DSLODE_H, -DSLODE_D) so the per-thread arrays stay in registers;
// ops/_build.py compiles one library per (H, D).
//
// Output layout: time-major (T, D, B). Thread b writes element b of each
// (t, d) row, so a warp's stores are 32 neighbouring floats and coalesce; the
// wrapper permutes to (B, T, D). The inputs u and x0 arrive feature-major,
// (H, B) and (D, B), for the same reason.
//
// Bound on this card: operations. Each trajectory-step costs about
// S * (4*D*H + 2*H) flops (1.1 kflop at midpoint, H = 25, D = 5) against
// 4*(H + D + T*D) bytes per trajectory for the whole solve. At B = 100 there
// are 100 busy threads, so the time is the serial chain of one thread through
// (T-1)*S stages; throughput matters only at large B.
//
// No tensor cores: the products are 5 x 25, far below an MMA tile.

#include <cuda_runtime.h>

#ifndef SLODE_H
#error "compile with -DSLODE_H=<hidden width> -DSLODE_D=<state width>"
#endif

namespace {

constexpr int H = SLODE_H;
constexpr int D = SLODE_D;
constexpr int kParams = H + 2 * D * H + 2 * D;  // w_t, W_a, b_a, W_d, b_d
constexpr int kThreads = 128;
constexpr int kDefaultSmem = 48 * 1024;

// The order of the methods is the wrapper's METHODS tuple.
enum Method { kEuler = 0, kMidpoint = 1, kHeun = 2, kRk4 = 3 };

// Butcher tableaus (structured_latent_odes_tpu_torch/ode/tableaus.py). Stage
// times are not needed here: they come precomputed in the sts table.
template <int M> struct Tableau;
template <> struct Tableau<kEuler> {
  static constexpr int S = 1;
  __host__ __device__ static constexpr float a(int, int) { return 0.f; }
  __host__ __device__ static constexpr float b(int) { return 1.f; }
};
template <> struct Tableau<kMidpoint> {
  static constexpr int S = 2;
  __host__ __device__ static constexpr float a(int i, int j) {
    return (i == 1 && j == 0) ? 0.5f : 0.f;
  }
  __host__ __device__ static constexpr float b(int i) { return i == 1 ? 1.f : 0.f; }
};
template <> struct Tableau<kHeun> {
  static constexpr int S = 2;
  __host__ __device__ static constexpr float a(int i, int j) {
    return (i == 1 && j == 0) ? 1.f : 0.f;
  }
  __host__ __device__ static constexpr float b(int) { return 0.5f; }
};
template <> struct Tableau<kRk4> {
  static constexpr int S = 4;
  __host__ __device__ static constexpr float a(int i, int j) {
    return j == i - 1 ? (i == 3 ? 1.f : 0.5f) : 0.f;
  }
  __host__ __device__ static constexpr float b(int i) {
    return (i == 0 || i == 3) ? static_cast<float>(1.0 / 6.0)
                              : static_cast<float>(1.0 / 3.0);
  }
};

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// One dynamics-net stage at time tau for this thread's trajectory.
__device__ __forceinline__ void stage(const float (&u)[H], float tau,
                                      const float* __restrict__ w,
                                      float (&a)[D], float (&d)[D]) {
  const float* wt = w;
  const float* wa = wt + H;
  const float* ba = wa + D * H;
  const float* wd = ba + D;
  const float* bd = wd + D * H;
  // Compiler barriers: read the weights from shared memory afresh, one head
  // row at a time. Without them nvcc hoists the loads of all 285 weights out
  // of the loops into registers and spills at every method (euler: 255
  // registers, 256 bytes of spill stores; with them 83 and none, -Xptxas -v
  // for sm_90a). Midpoint, heun and rk4 still reach 255 registers with 48 to
  // 360 bytes of spill stores: nvcc interleaves their independent stages.
  asm volatile("" ::: "memory");
  float h[H];
#pragma unroll
  for (int j = 0; j < H; ++j) h[j] = fmaxf(u[j] + tau * wt[j], 0.f);
#pragma unroll
  for (int i = 0; i < D; ++i) {
    asm volatile("" ::: "memory");
    float sa = 0.f;
    float sd = 0.f;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      sa = fmaf(wa[i * H + j], h[j], sa);
      sd = fmaf(wd[i * H + j], h[j], sd);
    }
    a[i] = sigmoid(sa + ba[i]);
    d[i] = sigmoid(sd + bd[i]);
  }
}

// The RK update of state element i started from the constant x0c, with the
// stage rates k_s = a_s - d_s * y_s (ode/semilinear.py::rk_affine_coeffs).
template <int M>
__device__ __forceinline__ float rk_run(float x0c, float hstep, int i,
                                        const float (&a)[Tableau<M>::S][D],
                                        const float (&d)[Tableau<M>::S][D]) {
  using Tab = Tableau<M>;
  float k[Tab::S];
#pragma unroll
  for (int s = 0; s < Tab::S; ++s) {
    float y = x0c;
#pragma unroll
    for (int j = 0; j < s; ++j) {
      if (Tab::a(s, j) != 0.f) y = y + (hstep * Tab::a(s, j)) * k[j];
    }
    k[s] = a[s][i] - d[s][i] * y;
  }
  float out = x0c;
#pragma unroll
  for (int s = 0; s < Tab::S; ++s) {
    if (Tab::b(s) != 0.f) out = out + (hstep * Tab::b(s)) * k[s];
  }
  return out;
}

template <int M>
__global__ void __launch_bounds__(kThreads)
fused_semilinear_fwd_kernel(const float* __restrict__ u, const float* __restrict__ x0,
                            const float* __restrict__ w, const float* __restrict__ sts,
                            const float* __restrict__ hs, float* __restrict__ out,
                            int B, int T) {
  constexpr int S = Tableau<M>::S;
  extern __shared__ float smem[];
  float* w_s = smem;                // kParams
  float* sts_s = w_s + kParams;     // (T-1) * S
  float* hs_s = sts_s + (T - 1) * S;  // T-1
  for (int i = threadIdx.x; i < kParams; i += kThreads) w_s[i] = w[i];
  for (int i = threadIdx.x; i < (T - 1) * S; i += kThreads) sts_s[i] = sts[i];
  for (int i = threadIdx.x; i < T - 1; i += kThreads) hs_s[i] = hs[i];
  __syncthreads();

  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const size_t Bs = static_cast<size_t>(B);

  float ur[H];
#pragma unroll
  for (int j = 0; j < H; ++j) ur[j] = u[j * Bs + b];
  float x[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    x[i] = x0[i * Bs + b];
    out[i * Bs + b] = x[i];
  }

  for (int t = 0; t < T - 1; ++t) {
    const float hstep = hs_s[t];
    float a[S][D];
    float d[S][D];
#pragma unroll
    for (int s = 0; s < S; ++s) stage(ur, sts_s[t * S + s], w_s, a[s], d[s]);
    float* row = out + static_cast<size_t>(t + 1) * D * Bs + b;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float Bc = rk_run<M>(0.f, hstep, i, a, d);
      const float Ac = rk_run<M>(1.f, hstep, i, a, d) - Bc;
      x[i] = Ac * x[i] + Bc;
      row[i * Bs] = x[i];
    }
  }
}

template <int M>
int launch(const float* u, const float* x0, const float* w, const float* sts,
           const float* hs, float* out, int B, int T, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kParams + static_cast<size_t>(T - 1) * (Tableau<M>::S + 1));
  if (smem > static_cast<size_t>(kDefaultSmem)) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_semilinear_fwd_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (B + kThreads - 1) / kThreads;
  fused_semilinear_fwd_kernel<M><<<blocks, kThreads, smem, stream>>>(
      u, x0, w, sts, hs, out, B, T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// u: (H, B); x0: (D, B); w: packed [w_t (H), W_a (D, H), b_a (D), W_d (D, H),
// b_d (D)]; sts: (T-1, S) stage times; hs: (T-1,) steps; out: (T, D, B).
// All float32, row-major, on one device.
extern "C" int fused_semilinear_fwd(int method, const float* u, const float* x0,
                                    const float* w, const float* sts, const float* hs,
                                    float* out, int B, int T, void* stream) {
  if (B <= 0 || T <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (method) {
    case kEuler: return launch<kEuler>(u, x0, w, sts, hs, out, B, T, s);
    case kMidpoint: return launch<kMidpoint>(u, x0, w, sts, hs, out, B, T, s);
    case kHeun: return launch<kHeun>(u, x0, w, sts, hs, out, B, T, s);
    case kRk4: return launch<kRk4>(u, x0, w, sts, hs, out, B, T, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
