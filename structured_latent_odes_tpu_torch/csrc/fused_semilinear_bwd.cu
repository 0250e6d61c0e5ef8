// Kernel K3, fused_semilinear_bwd: the reverse sweep of K2's whole semilinear
// RK solve. It recomputes each step's stages, runs the adjoint
//
//     lam_{T-1} = g_{T-1},   lam_t = A_t * lam_{t+1} + g_t,   dx0 = lam_0,
//
// and the hand-derived VJP of each step (dA_t = lam_{t+1} * x_t,
// dB_t = lam_{t+1}) back through both RK runs (B = run(0), A = run(1) - B),
// the sigmoid heads and the relu, into u, w_t, W_a, b_a, W_d and b_d.
//
// Replaces the Pallas TPU kernel structured_latent_odes_tpu/ops/fused_step.py
// ::_bwd_kernel (launched by _bwd_call), with its helper _rk_runs_bwd and the
// partial sums that _fused_bwd takes in XLA.
//
// Bound on this card: operations. The stage recompute is S*(4*D*H + 2*H)
// flops per trajectory-step and the VJP about S*(8*D*H + 4*H) more, plus the
// sigmoids' instructions as in K2. At the training batch (B = 128, midpoint)
// that is 36 Mflop, half a microsecond of the card, so the time there is
// latency, as for K2.
//
// Design: K2's (fused_semilinear_fwd.cu). A block owns one trajectory at a
// time and walks its steps in passes of up to kMaxSteps, last pass first:
//   1. one thread per step recomputes the step's S stages (all at once,
//      sharing the weight loads) and A_t into shared memory, and keeps the
//      stages' (a, d) and x_t in registers; the block stages g_t;
//   2. D threads run the adjoint over the pass in reverse, from shared
//      memory, leaving lam_{t+1} where g_t was: one fmaf a step in
//      descending time, so dx0 does not depend on the launch geometry;
//   3. one thread per step again: the VJP of its step (the two RK runs'
//      backward, sigmoid', then dL/dh = W_a^T sa + W_d^T sd for every hidden
//      unit), writing per (step, stage) the row [sa, sd, tau] and dL/dh;
//   4. every warp reduces its share of the pass's rows (steps n-1-w,
//      n-1-w-warps, ..., stages ascending) into sums of its own: lane j owns
//      hidden unit j's du[j], dw_t[j], W_a[:, j] and W_d[:, j], the relu mask
//      recomputed from the pre-activation u[j] + tau * w_t[j]; lanes j < 2D
//      also b_a and b_d.
// The sums stay in shared memory, one owner lane each: no atomics. du and
// dx0 belong to the trajectory and are written when it is done (du summed
// over the warps in warp order); each block writes its weight-gradient sums
// (over its trajectories, the warps in warp order) as one row of an
// (n_blocks, H + 2DH + 2D) buffer that the wrapper sums with torch.sum, as the
// JAX package sums its per-tile partials: deterministic for a given grid.
//
// Layout: trajectory-major, as K2: u (B, H), xs and g (B, T, D), du (B, H),
// dx0 (B, D). Shared memory grows with the pass length and S (rk4 at 85
// steps: 59 KB), so the launch opts in above 48 KB.
//
// No tensor cores, as K2: the products are 25 -> 5 per stage, and TF32 would
// not keep the 1e-5 float32 tolerances.

#include <cuda_runtime.h>

#include "fused_semilinear.cuh"

namespace {

using namespace slode;

// a (step, stage) row of the reduction: sa (D), sd (D), tau, padded to float4s
constexpr int kCoefTau = 2 * D;
constexpr int kCoef = (kCoefTau + 1 + 3) / 4 * 4;
// threads of the reduction: one per hidden unit, and one per bias element
constexpr int kRed = H > 2 * D ? H : 2 * D;

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

template <int S>
constexpr size_t smem_floats(int chunk, int warps) {
  return static_cast<size_t>(H) * kRow + static_cast<size_t>(chunk) * S * kCoef +
         static_cast<size_t>(S) * H * (chunk | 1) + 2 * static_cast<size_t>(chunk) * D + 2 * D +
         static_cast<size_t>(warps) * (kParams + H);
}

// Blocks per SM that ptxas must leave room for. At D = 5, 4 caps it at 128
// registers a thread, which euler needs to build without spills and midpoint
// and heun reach anyway. At D = 8 (proc) midpoint and heun spilled 92-96
// bytes under that cap; 3 (168 registers) leaves room for them. rk4's stages
// need more (at D = 8 it spills 28 bytes at the 255-register limit).
template <int M>
constexpr int kBwdMinBlocks = M == kRk4 ? 1 : (D <= 5 ? 4 : 3);

template <int M>
__global__ void __launch_bounds__(kMaxThreads, kBwdMinBlocks<M>)
fused_semilinear_bwd_kernel(const float* __restrict__ u, const float* __restrict__ xs,
                            const float* __restrict__ g, const float* __restrict__ ts,
                            const Weights w, float* __restrict__ du,
                            float* __restrict__ dx0, float* __restrict__ partial, int B, int T) {
  constexpr int S = Tableau<M>::S;
  const int steps = T - 1;
  const int chunk = min(steps, kMaxSteps);
  const int cpad = chunk | 1;  // odd stride: dh's writes and reads are conflict-free
  const bool one_pass = steps <= kMaxSteps;  // then each thread's step is the same for every trajectory
  const int warps = blockDim.x / 32;
  extern __shared__ float4 smem4[];
  float* rows = reinterpret_cast<float*>(smem4);  // H * kRow
  float* coef = rows + H * kRow;                  // chunk * S * kCoef: [sa, sd, tau] per (step, stage)
  float* dh = coef + chunk * S * kCoef;           // S * H * cpad: dL/dh, [stage][j][step]
  float* Ac = dh + S * H * cpad;                  // chunk * D: A_t of the pass
  float* lam = Ac + chunk * D;                    // chunk * D: g_t, then lam_{t+1}
  float* bias = lam + chunk * D;                  // 2D
  float* acc = bias + 2 * D;                      // warps * kParams: each warp's weight-gradient sums
  float* dus = acc + warps * kParams;             // warps * H: each warp's du of the trajectory
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // u[b, tid] and g[b, T-1, tid] of the block's next trajectory, loaded while
  // the block works on the current one
  float u_next = 0.f;
  float l_next = 0.f;
  if (tid < H) u_next = u[static_cast<size_t>(blockIdx.x) * H + tid];
  if (tid < D) l_next = g[(static_cast<size_t>(blockIdx.x) * T + T - 1) * D + tid];
  load_weights(w, rows, bias);
  for (int k = tid; k < warps * (kParams + H); k += blockDim.x) acc[k] = 0.f;  // acc and dus
  float tau[S];
  float hstep = 0.f;
  if (one_pass && tid < steps) load_step<M>(ts, tid, tau, hstep);

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const int next = b + gridDim.x;
    const size_t row0 = static_cast<size_t>(b) * T;
    if (tid < H) {
      rows[tid * kRow + kRowU] = u_next;
      if (next < B) u_next = u[static_cast<size_t>(next) * H + tid];
    }
    float l = 0.f;  // threads tid < D: component tid of the adjoint
    if (tid < D) {
      l = l_next;
      if (next < B) l_next = g[(static_cast<size_t>(next) * T + T - 1) * D + tid];
    }
    __syncthreads();

    for (int t1 = steps; t1 > 0; t1 -= chunk) {
      const int t0 = max(0, t1 - chunk);
      const int n = t1 - t0;
      const bool item = tid < n;
      // 1. stages and A_t of step t0 + tid, kept for 3; g of the pass staged
      // (n * D <= D * blockDim values: at most D a thread)
      float gv[D];
#pragma unroll
      for (int q = 0; q < D; ++q) {
        const int k = tid + q * blockDim.x;
        if (k < n * D) gv[q] = g[(row0 + t0) * D + k];
      }
      float a[S][D];
      float d[S][D];
      float x[D];
      if (item) {
        const int t = t0 + tid;
        if (!one_pass) load_step<M>(ts, t, tau, hstep);
#pragma unroll
        for (int i = 0; i < D; ++i) x[i] = xs[(row0 + t) * D + i];
        stages<S>(tau, rows, bias, a, d);
#pragma unroll
        for (int i = 0; i < D; ++i) {
          float ys[S];
          const float b0 = rk_run<M>(0.f, hstep, i, a, d, ys);
          Ac[tid * D + i] = rk_run<M>(1.f, hstep, i, a, d, ys) - b0;
        }
      }
#pragma unroll
      for (int q = 0; q < D; ++q) {
        const int k = tid + q * blockDim.x;
        if (k < n * D) lam[k] = gv[q];
      }
      __syncthreads();
      // 2. the adjoint over the pass, in reverse
      if (tid < D) scan_reverse(Ac, lam, n, tid, l);
      __syncthreads();
      // 3. the VJP of step t down to the heads' pre-sigmoid sums and dL/dh
      if (item) {
        float sa[S][D];
        float sd[S][D];
#pragma unroll
        for (int i = 0; i < D; ++i) {
          float ys0[S];
          float ys1[S];
          rk_run<M>(0.f, hstep, i, a, d, ys0);
          rk_run<M>(1.f, hstep, i, a, d, ys1);
          const float li = lam[tid * D + i];
          const float dA = li * x[i];
          float dai[S];
          float ddi[S];
#pragma unroll
          for (int s = 0; s < S; ++s) dai[s] = ddi[s] = 0.f;
          rk_run_bwd<M>(dA, hstep, i, d, ys1, dai, ddi);       // d run(1) = dA
          rk_run_bwd<M>(li - dA, hstep, i, d, ys0, dai, ddi);  // d run(0) = dB - dA
#pragma unroll
          for (int s = 0; s < S; ++s) {  // through the sigmoids
            sa[s][i] = a[s][i] * (1.f - a[s][i]) * dai[s];
            sd[s][i] = d[s][i] * (1.f - d[s][i]) * ddi[s];
          }
        }
#pragma unroll
        for (int s = 0; s < S; ++s) {
          float c[kCoef];
#pragma unroll
          for (int i = 0; i < D; ++i) {
            c[i] = sa[s][i];
            c[D + i] = sd[s][i];
          }
          c[kCoefTau] = tau[s];
#pragma unroll
          for (int q = kCoefTau + 1; q < kCoef; ++q) c[q] = 0.f;
          float4* dst = reinterpret_cast<float4*>(coef + (tid * S + s) * kCoef);
#pragma unroll
          for (int q = 0; q < kCoef / 4; ++q) {
            dst[q] = make_float4(c[4 * q], c[4 * q + 1], c[4 * q + 2], c[4 * q + 3]);
          }
        }
#pragma unroll
        for (int j = 0; j < H; ++j) {
          float r[kRow];
          load_row(rows, j, r);
#pragma unroll
          for (int s = 0; s < S; ++s) {
            float dhj = 0.f;
#pragma unroll
            for (int i = 0; i < D; ++i) {
              dhj = fmaf(r[kRowWa + i], sa[s][i], dhj);
              dhj = fmaf(r[kRowWd + i], sd[s][i], dhj);
            }
            dh[(s * H + j) * cpad + tid] = dhj;
          }
        }
      }
      __syncthreads();
      // 4. this pass's rows into the sums: warp w takes the steps k = n-1-w,
      // n-1-w-warps, ... (stages ascending) into its own sums; lane j owns
      // hidden unit j's sums and bias element j
      if (lane < kRed) {
        const int j = lane;
        const bool hid = j < H;
        const bool bel = j < 2 * D;
        float* wacc = acc + warp * kParams;
        float* wdu = dus + warp * H;
        const int bslot = j < D ? kBa + j : kBd + (j - D);
        float uj = 0.f, wtj = 0.f, duj = 0.f, dwt = 0.f, db = 0.f;
        float dwa[D];
        float dwd[D];
#pragma unroll
        for (int i = 0; i < D; ++i) dwa[i] = dwd[i] = 0.f;
        if (hid) {
          uj = rows[j * kRow + kRowU];
          wtj = rows[j * kRow];
          duj = wdu[j];
          dwt = wacc[kWt + j];
#pragma unroll
          for (int i = 0; i < D; ++i) {
            dwa[i] = wacc[kWa + i * H + j];
            dwd[i] = wacc[kWd + i * H + j];
          }
        }
        if (bel) db = wacc[bslot];
#pragma unroll 2
        for (int k = n - 1 - warp; k >= 0; k -= warps) {
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const float* crow = coef + (k * S + s) * kCoef;
            if (hid) {
              float c[kCoef];
              const float4* c4 = reinterpret_cast<const float4*>(crow);
#pragma unroll
              for (int q = 0; q < kCoef / 4; ++q) {
                const float4 v = c4[q];
                c[4 * q] = v.x;
                c[4 * q + 1] = v.y;
                c[4 * q + 2] = v.z;
                c[4 * q + 3] = v.w;
              }
              const float dhv = dh[(s * H + j) * cpad + k];
              const float tau_s = c[kCoefTau];
              const float pre = preactivation(uj, tau_s, wtj);
              const float hj = fmaxf(pre, 0.f);
              const float dpre = pre > 0.f ? dhv : 0.f;
              duj += dpre;
              dwt += tau_s * dpre;
#pragma unroll
              for (int i = 0; i < D; ++i) {
                dwa[i] += c[i] * hj;
                dwd[i] += c[D + i] * hj;
              }
            }
            if (bel) db += crow[j];
          }
        }
        if (hid) {
          wdu[j] = duj;
          wacc[kWt + j] = dwt;
#pragma unroll
          for (int i = 0; i < D; ++i) {
            wacc[kWa + i * H + j] = dwa[i];
            wacc[kWd + i * H + j] = dwd[i];
          }
        }
        if (bel) wacc[bslot] = db;
      }
      __syncthreads();
    }
    if (tid < D) dx0[static_cast<size_t>(b) * D + tid] = l;
    if (tid < H) {  // the warps' du, in warp order; reset for the next trajectory
      float sum = 0.f;
      for (int v = 0; v < warps; ++v) {
        sum += dus[v * H + tid];
        dus[v * H + tid] = 0.f;
      }
      du[static_cast<size_t>(b) * H + tid] = sum;
    }
  }
  __syncthreads();
  for (int k = tid; k < kParams; k += blockDim.x) {  // the warps' sums, in warp order
    float sum = 0.f;
    for (int v = 0; v < warps; ++v) sum += acc[v * kParams + k];
    partial[static_cast<size_t>(blockIdx.x) * kParams + k] = sum;
  }
}

template <int M>
size_t smem_bytes(int T) {
  return sizeof(float) * smem_floats<Tableau<M>::S>(chunk_for(T), threads_for(T) / 32);
}

template <int M>
int blocks(int B, int T) {
  int n = 0;
  const int err = blocks_for(fused_semilinear_bwd_kernel<M>, threads_for(T), smem_bytes<M>(T), B, &n);
  return err != 0 ? -err : n;
}

template <int M>
int launch(const float* u, const float* xs, const float* g, const float* ts, const Weights& w,
           float* du, float* dx0, float* partial, int B, int T, int n_blocks,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<M>(T);
  const int err = opt_in(fused_semilinear_bwd_kernel<M>, smem);
  if (err != 0) return err;
  fused_semilinear_bwd_kernel<M><<<n_blocks, threads_for(T), smem, stream>>>(
      u, xs, g, ts, w, du, dx0, partial, B, T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The grid fused_semilinear_bwd should be launched with for (method, B, T) on
// the current device (blocks_for in fused_semilinear.cuh), so the wrapper can
// size the partial-sum buffer once per shape; minus a CUDA error code on
// failure.
extern "C" int fused_semilinear_bwd_blocks(int method, int B, int T) {
  if (B <= 0 || T <= 0) return -static_cast<int>(cudaErrorInvalidValue);
  switch (method) {
    case kEuler: return blocks<kEuler>(B, T);
    case kMidpoint: return blocks<kMidpoint>(B, T);
    case kHeun: return blocks<kHeun>(B, T);
    case kRk4: return blocks<kRk4>(B, T);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// u: (B, H); xs, g: (B, T, D) the forward trajectory (x0 in row 0) and its
// cotangent; ts, wt (every wt_stride floats), wa, ba, wd, bd: as for
// fused_semilinear_fwd; du: (B, H); dx0: (B, D); partial: (n_blocks,
// H + 2DH + 2D) per-block sums of the packed gradients [w_t, W_a, b_a, W_d,
// b_d], n_blocks >= 1 (any grid is correct; fused_semilinear_bwd_blocks gives
// the one that fills the card). All float32, row-major, on one device.
extern "C" int fused_semilinear_bwd(int method, const float* u, const float* xs, const float* g,
                                    const float* ts, const float* wt, int wt_stride,
                                    const float* wa, const float* ba, const float* wd,
                                    const float* bd, float* du, float* dx0, float* partial, int B,
                                    int T, int n_blocks, void* stream) {
  if (B <= 0 || T <= 0) return static_cast<int>(cudaSuccess);
  if (n_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Weights w{wt, wt_stride, wa, ba, wd, bd};
  switch (method) {
    case kEuler: return launch<kEuler>(u, xs, g, ts, w, du, dx0, partial, B, T, n_blocks, s);
    case kMidpoint: return launch<kMidpoint>(u, xs, g, ts, w, du, dx0, partial, B, T, n_blocks, s);
    case kHeun: return launch<kHeun>(u, xs, g, ts, w, du, dx0, partial, B, T, n_blocks, s);
    case kRk4: return launch<kRk4>(u, xs, g, ts, w, du, dx0, partial, B, T, n_blocks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
