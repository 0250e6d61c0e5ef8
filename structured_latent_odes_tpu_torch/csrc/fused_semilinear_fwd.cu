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
// ::_fwd_kernel, launched by _fwd_call. Its backward is K3
// (fused_semilinear_bwd.cu).
//
// Design: one trajectory per thread. The thread keeps its row of u (H floats)
// and its state (D floats) in registers for the whole solve; the head weights
// and biases (H + 2DH + 2D floats) and the stage-time and step tables live in
// shared memory, read by every thread of the block at the same address (a
// broadcast). The stages are unrolled at compile time from the tableau: one
// template instance per method. The widths, tableaus and the stage code are in
// fused_semilinear.cuh, shared with K3.
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

#include "fused_semilinear.cuh"

namespace {

using namespace slode;

constexpr int kThreads = 128;

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
      float ys[S];  // unused here: the forward needs only the run's result
      const float Bc = rk_run<M>(0.f, hstep, i, a, d, ys);
      const float Ac = rk_run<M>(1.f, hstep, i, a, d, ys) - Bc;
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
