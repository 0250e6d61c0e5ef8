// Kernel K3, fused_semilinear_bwd: the reverse sweep of K2's whole semilinear
// RK solve. Per step t = T-2 .. 0 it recomputes the stages of step t, runs the
// adjoint
//
//     lam_{T-1} = g_{T-1},   lam_t = A_t * lam_{t+1} + g_t,   dx0 = lam_0,
//
// and the hand-derived VJP of the step (dA_t = lam_{t+1} * x_t,
// dB_t = lam_{t+1}) back through both RK runs (B = run(0), A = run(1) - B),
// the sigmoid heads and the relu, into u, w_t, W_a, b_a, W_d and b_d.
//
// Replaces the Pallas TPU kernel structured_latent_odes_tpu/ops/fused_step.py
// ::_bwd_kernel (launched by _bwd_call), with its helper _rk_runs_bwd and the
// partial sums that _fused_bwd takes in XLA.
//
// Design: K2's layout. One trajectory per thread: its row of u, its adjoint
// lam and its du in registers; the weights, stage times and steps in shared
// memory (a broadcast); the tableau a template parameter, so the stage loops
// unroll and zero coefficients drop out. x_t and g_t are read from the
// time-major (T, D, B) tensors, so a warp's reads coalesce as K2's writes do.
//
// The weight gradients are sums over every trajectory and stage. The TPU
// kernel keeps one tile's partials in VMEM; one thread here cannot keep its
// 2DH + 2D + H = 285 partial sums in registers on top of the stage state. So
// each thread accumulates its own partials in dynamic shared memory, laid out
// [k][thread] with a row stride of kThreads + 1 floats: a warp's accesses to
// one k are 32 neighbouring banks, and the block's final reduction (thread k
// sums row k over the block's threads, in a fixed order) is conflict-free
// too. At 64 threads that is 74 KB, above the 48 KB default, so the launch
// opts in with cudaFuncSetAttribute. Each block writes one partial vector to
// an (n_blocks, 285) buffer that the wrapper sums with torch.sum, as the JAX
// package sums its per-tile partials: deterministic, no atomics. du (H) and
// dx0 (D) belong to one trajectory and are written directly, feature-major
// (H, B) and (D, B).
//
// Bound on this card: operations. The stage recompute is S*(4*D*H + 2*H) flops
// per trajectory-step and the VJP about S*(8*D*H + 4*H) more; at the training
// shape (B = 128, midpoint) that is 36 Mflop, far below what one thread's
// serial chain through (T-1)*S stages takes, as for K2.
//
// Registers: -Xptxas -v for sm_90a is printed by chip_smoke.py's build phase.

#include <cuda_runtime.h>

#include "fused_semilinear.cuh"

namespace {

using namespace slode;

constexpr int kThreads = 64;
constexpr int kStride = kThreads + 1;  // row stride of the partial-sum slab

// The VJP of the two RK runs of element i onto the stages' (a, d), for one
// run with output cotangent dout and stage states ys (ops/fused_step.py
// _rk_runs_bwd in the JAX package): out = x0 + h sum_s b_s k_s,
// k_s = a_s - d_s y_s, y_s = x0 + h sum_{j<s} a_sj k_j, reverse-accumulated.
template <int M>
__device__ __forceinline__ void rk_run_bwd(float dout, float hstep, int i,
                                           const float (&d)[Tableau<M>::S][D],
                                           const float (&ys)[Tableau<M>::S],
                                           float (&da)[Tableau<M>::S],
                                           float (&dd)[Tableau<M>::S]) {
  using Tab = Tableau<M>;
  float dk[Tab::S];
#pragma unroll
  for (int s = 0; s < Tab::S; ++s) dk[s] = Tab::b(s) != 0.f ? dout * (hstep * Tab::b(s)) : 0.f;
#pragma unroll
  for (int s = Tab::S - 1; s >= 0; --s) {
    da[s] = da[s] + dk[s];
    dd[s] = dd[s] - ys[s] * dk[s];
    const float dy = -d[s][i] * dk[s];
#pragma unroll
    for (int j = 0; j < s; ++j) {
      if (Tab::a(s, j) != 0.f) dk[j] = dk[j] + (hstep * Tab::a(s, j)) * dy;
    }
  }
}

template <int M>
__global__ void __launch_bounds__(kThreads)
fused_semilinear_bwd_kernel(const float* __restrict__ u, const float* __restrict__ xs,
                            const float* __restrict__ g, const float* __restrict__ w,
                            const float* __restrict__ sts, const float* __restrict__ hs,
                            float* __restrict__ du, float* __restrict__ dx0,
                            float* __restrict__ partial, int B, int T) {
  constexpr int S = Tableau<M>::S;
  extern __shared__ float smem[];
  float* acc = smem;                     // kParams x kStride partial sums
  float* w_s = acc + kParams * kStride;  // kParams
  float* sts_s = w_s + kParams;          // (T-1) * S
  float* hs_s = sts_s + (T - 1) * S;     // T-1
  const int tid = threadIdx.x;
  for (int i = tid; i < kParams; i += kThreads) w_s[i] = w[i];
  for (int i = tid; i < (T - 1) * S; i += kThreads) sts_s[i] = sts[i];
  for (int i = tid; i < T - 1; i += kThreads) hs_s[i] = hs[i];
  for (int k = 0; k < kParams; ++k) acc[k * kStride + tid] = 0.f;
  __syncthreads();

  const int b = blockIdx.x * kThreads + tid;
  if (b < B) {  // no early return: the whole block meets the final reduction
    const size_t Bs = static_cast<size_t>(B);
    float* my = acc + tid;
    float ur[H];
    float dur[H];
#pragma unroll
    for (int j = 0; j < H; ++j) {
      ur[j] = u[j * Bs + b];
      dur[j] = 0.f;
    }
    float lam[D];
#pragma unroll
    for (int i = 0; i < D; ++i) lam[i] = g[(static_cast<size_t>(T - 1) * D + i) * Bs + b];

    for (int t = T - 2; t >= 0; --t) {
      const float hstep = hs_s[t];
      float a[S][D];
      float d[S][D];
#pragma unroll
      for (int s = 0; s < S; ++s) stage(ur, sts_s[t * S + s], w_s, a[s], d[s]);

      // adjoint step and the VJP of both RK runs, element by element
      const float* xt = xs + static_cast<size_t>(t) * D * Bs + b;
      const float* gt = g + static_cast<size_t>(t) * D * Bs + b;
      float da[S][D];
      float dd[S][D];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        float ys0[S];
        float ys1[S];
        const float out0 = rk_run<M>(0.f, hstep, i, a, d, ys0);
        const float Ac = rk_run<M>(1.f, hstep, i, a, d, ys1) - out0;
        const float dA = lam[i] * xt[i * Bs];
        float dai[S];
        float ddi[S];
#pragma unroll
        for (int s = 0; s < S; ++s) dai[s] = ddi[s] = 0.f;
        rk_run_bwd<M>(dA, hstep, i, d, ys1, dai, ddi);          // d run(1) = dA
        rk_run_bwd<M>(lam[i] - dA, hstep, i, d, ys0, dai, ddi);  // d run(0) = dB - dA
#pragma unroll
        for (int s = 0; s < S; ++s) {
          da[s][i] = dai[s];
          dd[s][i] = ddi[s];
        }
        lam[i] = Ac * lam[i] + gt[i * Bs];
      }

      // through the sigmoid heads and the relu, per stage
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float tau = sts_s[t * S + s];
        float sa[D];
        float sd[D];
#pragma unroll
        for (int i = 0; i < D; ++i) {
          sa[i] = a[s][i] * (1.f - a[s][i]) * da[s][i];
          sd[i] = d[s][i] * (1.f - d[s][i]) * dd[s][i];
          my[(kBa + i) * kStride] += sa[i];
          my[(kBd + i) * kStride] += sd[i];
        }
        asm volatile("" ::: "memory");
#pragma unroll  // fully: ur and dur are indexed by j and must stay registers
        for (int j = 0; j < H; ++j) {
          const float pre = preactivation(ur[j], tau, w_s[kWt + j]);
          const float hj = fmaxf(pre, 0.f);
          float dh = 0.f;
#pragma unroll
          for (int i = 0; i < D; ++i) {
            dh = fmaf(w_s[kWa + i * H + j], sa[i], dh);
            dh = fmaf(w_s[kWd + i * H + j], sd[i], dh);
            my[(kWa + i * H + j) * kStride] += sa[i] * hj;
            my[(kWd + i * H + j) * kStride] += sd[i] * hj;
          }
          const float dpre = pre > 0.f ? dh : 0.f;
          dur[j] += dpre;
          my[(kWt + j) * kStride] += tau * dpre;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < H; ++j) du[j * Bs + b] = dur[j];
#pragma unroll
    for (int i = 0; i < D; ++i) dx0[i * Bs + b] = lam[i];
  }
  __syncthreads();
  for (int k = tid; k < kParams; k += kThreads) {
    const float* row = acc + k * kStride;
    float sum = 0.f;
    for (int j = 0; j < kThreads; ++j) sum += row[j];
    partial[static_cast<size_t>(blockIdx.x) * kParams + k] = sum;
  }
}

template <int M>
int launch(const float* u, const float* xs, const float* g, const float* w,
           const float* sts, const float* hs, float* du, float* dx0, float* partial,
           int B, int T, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(kParams) * kStride + kParams +
                                       static_cast<size_t>(T - 1) * (Tableau<M>::S + 1));
  if (smem > static_cast<size_t>(kDefaultSmem)) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_semilinear_bwd_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (B + kThreads - 1) / kThreads;
  fused_semilinear_bwd_kernel<M><<<blocks, kThreads, smem, stream>>>(
      u, xs, g, w, sts, hs, du, dx0, partial, B, T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The block size, so the wrapper can size the partial-sum buffer.
extern "C" int fused_semilinear_bwd_threads() { return kThreads; }

// u: (H, B); xs, g: (T, D, B) the forward trajectory (x0 in row 0) and its
// cotangent; w: packed [w_t (H), W_a (D, H), b_a (D), W_d (D, H), b_d (D)];
// sts: (T-1, S); hs: (T-1,); du: (H, B); dx0: (D, B); partial:
// (ceil(B / threads), H + 2DH + 2D) per-block sums of the packed gradients.
// All float32, row-major, on one device.
extern "C" int fused_semilinear_bwd(int method, const float* u, const float* xs,
                                    const float* g, const float* w, const float* sts,
                                    const float* hs, float* du, float* dx0, float* partial,
                                    int B, int T, void* stream) {
  if (B <= 0 || T <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (method) {
    case kEuler: return launch<kEuler>(u, xs, g, w, sts, hs, du, dx0, partial, B, T, s);
    case kMidpoint: return launch<kMidpoint>(u, xs, g, w, sts, hs, du, dx0, partial, B, T, s);
    case kHeun: return launch<kHeun>(u, xs, g, w, sts, hs, du, dx0, partial, B, T, s);
    case kRk4: return launch<kRk4>(u, xs, g, w, sts, hs, du, dx0, partial, B, T, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
