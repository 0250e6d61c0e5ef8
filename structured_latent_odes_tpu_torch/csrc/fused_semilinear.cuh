// Shared by K2 (fused_semilinear_fwd.cu) and K3 (fused_semilinear_bwd.cu):
// the widths, the RK tableaus, one dynamics-net stage and one RK run of the
// semilinear solve  dx/dt = a(t, z) - d(t, z) * x.
//
// H and D are compile-time constants (-DSLODE_H, -DSLODE_D) so the
// per-thread arrays stay in registers; ops/_build.py compiles one library per
// (H, D).

#pragma once

#include <cuda_runtime.h>

#ifndef SLODE_H
#error "compile with -DSLODE_H=<hidden width> -DSLODE_D=<state width>"
#endif

namespace slode {

constexpr int H = SLODE_H;
constexpr int D = SLODE_D;
// packed parameters: w_t (H), W_a (D, H), b_a (D), W_d (D, H), b_d (D)
constexpr int kWt = 0;
constexpr int kWa = kWt + H;
constexpr int kBa = kWa + D * H;
constexpr int kWd = kBa + D;
constexpr int kBd = kWd + D * H;
constexpr int kParams = kBd + D;
constexpr int kDefaultSmem = 48 * 1024;

// The order of the methods is the wrappers' METHODS tuple (ops/fused_step.py).
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

// u + tau * w_t, the product and the sum rounded separately as the plain
// PyTorch versions compute them (no FMA contraction): the relu's mask
// (pre > 0) then agrees bit for bit with theirs. A contracted FMA moves a
// pre-activation within one rounding of 0 across it, and the relu's
// derivative jumps there, which K3's du and dw_t would show in full.
__device__ __forceinline__ float preactivation(float u, float tau, float wt) {
  return __fadd_rn(u, __fmul_rn(tau, wt));
}

// One dynamics-net stage at time tau for this thread's trajectory:
// h = relu(u + tau * w_t), a = sigmoid(W_a h + b_a), d = sigmoid(W_d h + b_d).
__device__ __forceinline__ void stage(const float (&u)[H], float tau,
                                      const float* __restrict__ w,
                                      float (&a)[D], float (&d)[D]) {
  const float* wt = w + kWt;
  const float* wa = w + kWa;
  const float* ba = w + kBa;
  const float* wd = w + kWd;
  const float* bd = w + kBd;
  // Compiler barriers: read the weights from shared memory afresh, one head
  // row at a time. Without them nvcc hoists the loads of all 285 weights out
  // of the loops into registers and spills at every method (euler: 255
  // registers, 256 bytes of spill stores; with them 83 and none, -Xptxas -v
  // for sm_90a). Midpoint, heun and rk4 still reach 255 registers with 48 to
  // 360 bytes of spill stores: nvcc interleaves their independent stages.
  asm volatile("" ::: "memory");
  float h[H];
#pragma unroll
  for (int j = 0; j < H; ++j) h[j] = fmaxf(preactivation(u[j], tau, wt[j]), 0.f);
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
// ys receives the stage states y_s, which the backward needs.
template <int M>
__device__ __forceinline__ float rk_run(float x0c, float hstep, int i,
                                        const float (&a)[Tableau<M>::S][D],
                                        const float (&d)[Tableau<M>::S][D],
                                        float (&ys)[Tableau<M>::S]) {
  using Tab = Tableau<M>;
  float k[Tab::S];
#pragma unroll
  for (int s = 0; s < Tab::S; ++s) {
    float y = x0c;
#pragma unroll
    for (int j = 0; j < s; ++j) {
      if (Tab::a(s, j) != 0.f) y = y + (hstep * Tab::a(s, j)) * k[j];
    }
    ys[s] = y;
    k[s] = a[s][i] - d[s][i] * y;
  }
  float out = x0c;
#pragma unroll
  for (int s = 0; s < Tab::S; ++s) {
    if (Tab::b(s) != 0.f) out = out + (hstep * Tab::b(s)) * k[s];
  }
  return out;
}

}  // namespace slode
