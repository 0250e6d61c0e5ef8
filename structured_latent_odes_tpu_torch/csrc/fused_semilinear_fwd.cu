// Kernel K2, fused_semilinear_fwd: the whole semilinear Runge-Kutta solve of
// the decoder ODE  dx/dt = a(t, z) - d(t, z) * x  in one launch. Per step t
// and RK stage i (stage time tau = ts[t] + c_i * (ts[t+1] - ts[t])):
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
// Bound on this card: operations. Each trajectory-step costs
// S * (4*D*H + 2*H) flops of products (1.1 kflop at midpoint, H = 25, D = 5)
// against 4*(H + D + T*D) bytes per trajectory for the whole solve. The
// sigmoids (an exact expf and a correctly rounded reciprocal, about 20
// instructions each) and the relu's separately rounded pre-activation add
// about as many instructions again, so at large batch the kernel is bound by
// instruction issue. At the training batch (B = 128) the work is a fraction
// of a microsecond of the card and the time is latency: the launch, one
// step's stage chain and the T-1 dependent FMAs of the recurrence.
//
// Design: parallel over steps, then a short scan (fused_semilinear.cuh). The
// heads never read x, so the steps' affine maps are independent. A block owns
// one trajectory at a time (blocks loop over trajectories, as many blocks as
// fit on the card) and walks its steps in passes of up to 128 steps (fewer
// where the pass's shared memory would pass 227 KB: fwd_max_steps):
//   1. one thread per step evaluates all S stages of its step at once, so
//      each float4 load of a weight row from shared memory feeds 2*D*S FMAs,
//      and writes (A_t, B_t) to shared memory;
//   2. after one __syncthreads, a thread per state component (past the
//      block's threads, several in turn) runs x = A*x + B over the pass,
//      writing each x_{t+1} over B_t;
//   3. the block copies the pass's rows of x to the output, contiguous.
// The next trajectory's u row and x0 are loaded while the block works on the
// current one. Each element's arithmetic has one fixed order: the head sums
// over j ascending, one fmaf a term; the stage times and pre-activations
// rounded as the plain version rounds them; one fmaf a step of the
// recurrence. The output therefore does not depend on the launch geometry.
//
// Layout: trajectory-major. u (B, H), x0 (B, D) and the output (B, T, D) are
// read and written as they lie; one trajectory's T*D outputs are contiguous,
// so the copy-out coalesces whatever the batch size. An ensemble's S members
// share one launch on arrays with a leading member axis, member m on
// blockIdx.y (fused_semilinear.cuh).
//
// Replaces, for the ensemble, the same Pallas kernel under the JAX package's
// vmap over members, which adds a grid dimension over them.
//
// No tensor cores: the head products are 25 -> 5 per stage, far below an MMA
// tile, and TF32 would not keep the 1e-5 float32 tolerance of the plain
// version.

#include <cuda_runtime.h>

#include "fused_semilinear.cuh"

namespace {

using namespace slode;

// Blocks per SM that ptxas must leave room for. At D = 5, 6 caps it at 85
// registers a thread: euler, midpoint and heun then build without spills, 8
// blocks of the CVS grid's 96 threads fit on an SM, and that was the fastest
// setting tried on the H100 (against 1, 7 and none). A wider state needs
// more: at D = 8 (proc) the cap of 80 that 6 gives spilled 12-44 bytes, and 4
// (128 registers) spills none. rk4's and dopri5's stages need more registers,
// as does any state wider than 8: they get the full 255.
template <int M>
constexpr int kFwdMinBlocks = (M == kRk4 || M == kDopri5 || D > 8) ? 1 : (D <= 5 ? 6 : 4);

template <int M>
__global__ void __launch_bounds__(kMaxThreads, kFwdMinBlocks<M>)
fused_semilinear_fwd_kernel(const float* __restrict__ u, const float* __restrict__ x0,
                            const float* __restrict__ ts, const Weights weights,
                            float* __restrict__ out, int B, int T) {
  constexpr int S = Tableau<M>::S;
  constexpr int kSteps = fwd_max_steps();
  const int steps = T - 1;
  const int chunk = min(steps, kSteps);
  const bool one_pass = steps <= kSteps;  // then each thread's step is the same for every trajectory
  extern __shared__ float4 smem4[];
  float* rows = reinterpret_cast<float*>(smem4);  // H * kRow
  float* bias = rows + H * kRow;                  // 2D
  float* Ac = bias + 2 * D;                       // chunk * D: A_t of the pass
  float* Bc = Ac + chunk * D;                     // chunk * D: B_t, then x_{t+1}
  const int tid = threadIdx.x;
  // the block's member: its slices of the arrays
  const int m = blockIdx.y;
  u += static_cast<size_t>(m) * B * H;
  x0 += static_cast<size_t>(m) * B * D;
  out += static_cast<size_t>(m) * B * T * D;
  const Weights w = member_weights(weights, m);
  // u[b, j] and x0[b, i] of the block's next trajectory for the thread's
  // hidden units j = tid + q * blockDim.x and state components i (one each up
  // to 32), loaded while the block works on the current one
  float u_next[kPerH];
  float x_next[kPerD];
#pragma unroll
  for (int q = 0; q < kPerH; ++q) {
    const int j = tid + q * blockDim.x;
    u_next[q] = j < H ? u[static_cast<size_t>(blockIdx.x) * H + j] : 0.f;
  }
#pragma unroll
  for (int q = 0; q < kPerD; ++q) {
    const int i = tid + q * blockDim.x;
    x_next[q] = i < D ? x0[static_cast<size_t>(blockIdx.x) * D + i] : 0.f;
  }
  load_weights(w, rows, bias);
  float tau[S];
  float hstep = 0.f;
  if (one_pass && tid < steps) load_step<M>(ts, tid, tau, hstep);

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const int next = b + gridDim.x;
    const size_t row0 = static_cast<size_t>(b) * T;
#pragma unroll
    for (int q = 0; q < kPerH; ++q) {
      const int j = tid + q * blockDim.x;
      if (j < H) {
        rows[j * kRow + kRowU] = u_next[q];
        if (next < B) u_next[q] = u[static_cast<size_t>(next) * H + j];
      }
    }
    float x[kPerD];  // the thread's state components
#pragma unroll
    for (int q = 0; q < kPerD; ++q) {
      const int i = tid + q * blockDim.x;
      x[q] = 0.f;
      if (i < D) {
        x[q] = x_next[q];
        out[row0 * D + i] = x[q];
        if (next < B) x_next[q] = x0[static_cast<size_t>(next) * D + i];
      }
    }
    __syncthreads();

    for (int t0 = 0; t0 < steps; t0 += chunk) {
      const int n = min(chunk, steps - t0);
      // 1. the affine map of step t0 + tid
      if (tid < n) {
        if (!one_pass) load_step<M>(ts, t0 + tid, tau, hstep);
        float a[S][D];
        float d[S][D];
        stages<S>(tau, rows, bias, a, d);
#pragma unroll
        for (int i = 0; i < D; ++i) {
          float ys[S];  // unused here: the forward needs only the run's result
          const float b0 = rk_run<M>(0.f, hstep, i, a, d, ys);
          Ac[tid * D + i] = rk_run<M>(1.f, hstep, i, a, d, ys) - b0;
          Bc[tid * D + i] = b0;
        }
      }
      __syncthreads();
      // 2. the recurrence, one thread per state component
#pragma unroll
      for (int q = 0; q < kPerD; ++q) {
        const int i = tid + q * blockDim.x;
        if (i < D) scan_forward(Ac, Bc, n, i, x[q]);
      }
      __syncthreads();
      // 3. rows t0+1 .. t0+n of the trajectory
      float* dst = out + (row0 + t0 + 1) * D;
      for (int k = tid; k < n * D; k += blockDim.x) dst[k] = Bc[k];
      __syncthreads();
    }
  }
}

template <int M>
int launch(const float* u, const float* x0, const float* ts, const Weights& w, float* out,
           int S, int B, int T, cudaStream_t stream) {
  constexpr int kSteps = fwd_max_steps();
  if (kSteps < 1) return static_cast<int>(cudaErrorInvalidValue);  // not one step fits (the wrapper raises first)
  const int threads = threads_for(T, kSteps);
  const size_t smem = sizeof(float) * fwd_smem_floats(chunk_for(T, kSteps));
  int blocks = 0;
  const int err = blocks_for(fused_semilinear_fwd_kernel<M>, threads, smem, B, &blocks);
  if (err != 0) return err;
  fused_semilinear_fwd_kernel<M><<<dim3(blocks, S), threads, smem, stream>>>(u, x0, ts, w, out, B, T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The steps one pass of K2 takes in this library at method (fwd_max_steps:
// the same at every method), so that the wrapper's mirror of the shared-memory
// layout (ops/fused_step.py::kernel_max_steps) can be held against it; minus
// a CUDA error code for an unknown method.
extern "C" int fused_semilinear_fwd_max_steps(int method) {
  if (method < kEuler || method > kDopri5) return -static_cast<int>(cudaErrorInvalidValue);
  return fwd_max_steps();
}

// S members, each: u: (B, H); x0: (B, D); wt: (H,) every wt_stride floats,
// member m's m * wt_mstride floats on; wa, wd: (D, H); ba, bd: (D,); out:
// (B, T, D); and ts: (T,) the time grid, shared. Every array but wt and ts
// has a leading member axis (S, ...). All float32, row-major, on one device.
extern "C" int fused_semilinear_fwd(int method, const float* u, const float* x0, const float* ts,
                                    const float* wt, int wt_stride, int wt_mstride, const float* wa,
                                    const float* ba, const float* wd, const float* bd, float* out,
                                    int S, int B, int T, void* stream) {
  if (S <= 0 || B <= 0 || T <= 0) return static_cast<int>(cudaSuccess);
  if (S > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Weights w{wt, wt_stride, wt_mstride, wa, ba, wd, bd};
  switch (method) {
    case kEuler: return launch<kEuler>(u, x0, ts, w, out, S, B, T, s);
    case kMidpoint: return launch<kMidpoint>(u, x0, ts, w, out, S, B, T, s);
    case kHeun: return launch<kHeun>(u, x0, ts, w, out, S, B, T, s);
    case kRk4: return launch<kRk4>(u, x0, ts, w, out, S, B, T, s);
    case kDopri5: return launch<kDopri5>(u, x0, ts, w, out, S, B, T, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
