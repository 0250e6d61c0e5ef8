// Shared by K2 (fused_semilinear_fwd.cu) and K3 (fused_semilinear_bwd.cu):
// the widths, the RK tableaus, the shared-memory weight layout, the dynamics
// net's stages of one step, one RK run of the semilinear solve
// dx/dt = a(t, z) - d(t, z) * x, the scans, and the launch geometry.
//
// The design both kernels share. The dynamics heads read only the latent
// projection u, the stage time and the weights, never the state x, so every
// step's affine map x_{t+1} = A_t x_t + B_t can be computed independently of
// every other step. A block owns one trajectory at a time and walks its steps
// in passes of at most fwd_max_steps / bwd_max_steps steps: first one thread
// per step computes the step's stages and (A_t, B_t) in parallel (stages()
// and rk_run() below), then the block's threads run the short serial
// recurrence of each state component over the pass from shared memory
// (scan_forward, scan_reverse). Blocks loop over trajectories; the grid is as
// many blocks as fit on the card at once (blocks_for), each taking an equal
// share of the batch, and each block loads the weights once.
//
// An ensemble's members (train/ensemble.py: S models of one shape, each with
// its own weights and batch) share a launch: member m is blockIdx.y, and its
// u, x0, trajectories, weights and gradients are the m-th slices of arrays
// with a leading member axis. gridDim.x and the order of a member's
// trajectories and steps are those of a single-member launch, so every output
// of member m is bit-equal to a launch on member m's slices alone.
//
// H and D are compile-time constants (-DSLODE_H, -DSLODE_D) so the per-thread
// arrays stay in registers where they fit; ops/_build.py compiles one library
// per (H, D). Any width builds: a loop over hidden units or state components
// strides by the block (at least one warp), so a thread owns kPerH units and
// kPerD components (one each up to 32). Past the registers the arrays spill
// to local memory (slow, right). The hard limit is shared memory: a pass of
// one step must fit in kSmemLimit (fwd_max_steps, bwd_max_steps; the
// wrappers in ops/fused_step.py refuse a wider model before any build).

#pragma once

#include <cuda_runtime.h>

#include <algorithm>

#ifndef SLODE_H
#error "compile with -DSLODE_H=<hidden width> -DSLODE_D=<state width>"
#endif

namespace slode {

constexpr int H = SLODE_H;
constexpr int D = SLODE_D;
// K3's packed weight gradients: w_t (H), W_a (D, H), b_a (D), W_d (D, H), b_d (D)
constexpr int kWt = 0;
constexpr int kWa = kWt + H;
constexpr int kBa = kWa + D * H;
constexpr int kWd = kBa + D;
constexpr int kBd = kWd + D * H;
constexpr int kParams = kBd + D;
constexpr int kDefaultSmem = 48 * 1024;

// Shared memory holds the weights as H rows of kRow floats, row j =
// [w_t[j], W_a[0..D-1][j], W_d[0..D-1][j], u[j], 0...]: everything one hidden
// unit j needs, so a thread reads it with kRow / 4 float4 loads (a broadcast:
// every thread of a warp reads the same row) and each load feeds 2*D*S FMAs.
// u[j] is the latent projection of the block's current trajectory.
constexpr int kRowWa = 1;
constexpr int kRowWd = 1 + D;
constexpr int kRowU = 1 + 2 * D;
constexpr int kRow = (kRowU + 1 + 3) / 4 * 4;

// Steps per pass at most: one thread per step, in whole warps. A pass is
// shorter where its shared memory would exceed kSmemLimit (fwd_max_steps,
// bwd_max_steps below).
constexpr int kMaxSteps = 128;
constexpr int kMaxThreads = kMaxSteps;
// the shared memory one block may opt in to on an H100 (227 KB)
constexpr size_t kSmemLimit = 232448;
// hidden units and state components per thread where a loop strides over
// them by the block's threads (at least 32)
constexpr int kPerH = (H + 31) / 32;
constexpr int kPerD = (D + 31) / 32;

// The loops over the H hidden units: unrolled in full up to one warp's worth
// (the repo's widths), by 4 past it, where full unrolling multiplies the
// code by H for no register it could keep.
#if SLODE_H <= 32
#define SLODE_UNROLL_H _Pragma("unroll")
#else
#define SLODE_UNROLL_H _Pragma("unroll 4")
#endif

// The order of the methods is the wrappers' METHODS tuple (ops/fused_step.py).
enum Method { kEuler = 0, kMidpoint = 1, kHeun = 2, kRk4 = 3, kDopri5 = 4 };

// Butcher tableaus (structured_latent_odes_tpu_torch/ode/tableaus.py). Each
// coefficient is the tableau's double rounded once to float, as the plain
// versions' float32 arithmetic takes a Python float.
template <int M> struct Tableau;
template <> struct Tableau<kEuler> {
  static constexpr int S = 1;
  __host__ __device__ static constexpr float c(int) { return 0.f; }
  __host__ __device__ static constexpr float a(int, int) { return 0.f; }
  __host__ __device__ static constexpr float b(int) { return 1.f; }
};
template <> struct Tableau<kMidpoint> {
  static constexpr int S = 2;
  __host__ __device__ static constexpr float c(int i) { return i == 1 ? 0.5f : 0.f; }
  __host__ __device__ static constexpr float a(int i, int j) {
    return (i == 1 && j == 0) ? 0.5f : 0.f;
  }
  __host__ __device__ static constexpr float b(int i) { return i == 1 ? 1.f : 0.f; }
};
template <> struct Tableau<kHeun> {
  static constexpr int S = 2;
  __host__ __device__ static constexpr float c(int i) { return i == 1 ? 1.f : 0.f; }
  __host__ __device__ static constexpr float a(int i, int j) {
    return (i == 1 && j == 0) ? 1.f : 0.f;
  }
  __host__ __device__ static constexpr float b(int) { return 0.5f; }
};
template <> struct Tableau<kRk4> {
  static constexpr int S = 4;
  __host__ __device__ static constexpr float c(int i) {
    return i == 0 ? 0.f : (i == 3 ? 1.f : 0.5f);
  }
  __host__ __device__ static constexpr float a(int i, int j) {
    return j == i - 1 ? (i == 3 ? 1.f : 0.5f) : 0.f;
  }
  __host__ __device__ static constexpr float b(int i) {
    return (i == 0 || i == 3) ? static_cast<float>(1.0 / 6.0)
                              : static_cast<float>(1.0 / 3.0);
  }
};
// Dormand-Prince 5(4) at a fixed step: only b (the 5th-order weights) enters;
// the embedded error weights and the dense output belong to the adaptive
// solver (ode/solvers.py), not to these kernels.
template <> struct Tableau<kDopri5> {
  static constexpr int S = 7;
  __host__ __device__ static constexpr float c(int i) {
    return static_cast<float>(i == 1   ? 1.0 / 5.0
                              : i == 2 ? 3.0 / 10.0
                              : i == 3 ? 4.0 / 5.0
                              : i == 4 ? 8.0 / 9.0
                              : i >= 5 ? 1.0
                                       : 0.0);
  }
  __host__ __device__ static constexpr double a64(int i, int j) {
    switch (i * 8 + j) {
      case 1 * 8 + 0: return 1.0 / 5.0;
      case 2 * 8 + 0: return 3.0 / 40.0;
      case 2 * 8 + 1: return 9.0 / 40.0;
      case 3 * 8 + 0: return 44.0 / 45.0;
      case 3 * 8 + 1: return -56.0 / 15.0;
      case 3 * 8 + 2: return 32.0 / 9.0;
      case 4 * 8 + 0: return 19372.0 / 6561.0;
      case 4 * 8 + 1: return -25360.0 / 2187.0;
      case 4 * 8 + 2: return 64448.0 / 6561.0;
      case 4 * 8 + 3: return -212.0 / 729.0;
      case 5 * 8 + 0: return 9017.0 / 3168.0;
      case 5 * 8 + 1: return -355.0 / 33.0;
      case 5 * 8 + 2: return 46732.0 / 5247.0;
      case 5 * 8 + 3: return 49.0 / 176.0;
      case 5 * 8 + 4: return -5103.0 / 18656.0;
      case 6 * 8 + 0: return 35.0 / 384.0;
      case 6 * 8 + 2: return 500.0 / 1113.0;
      case 6 * 8 + 3: return 125.0 / 192.0;
      case 6 * 8 + 4: return -2187.0 / 6784.0;
      case 6 * 8 + 5: return 11.0 / 84.0;
      default: return 0.0;
    }
  }
  __host__ __device__ static constexpr float a(int i, int j) { return static_cast<float>(a64(i, j)); }
  // b is the last row of a (the FSAL property), with b_6 = 0
  __host__ __device__ static constexpr float b(int i) { return i < 6 ? a(6, i) : 0.f; }
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

// Row j of the shared weights, kRow floats, into registers.
__device__ __forceinline__ void load_row(const float* __restrict__ rows, int j, float (&r)[kRow]) {
  const float4* p = reinterpret_cast<const float4*>(rows + j * kRow);
#pragma unroll
  for (int q = 0; q < kRow / 4; ++q) {
    const float4 v = p[q];
    r[4 * q] = v.x;
    r[4 * q + 1] = v.y;
    r[4 * q + 2] = v.z;
    r[4 * q + 3] = v.w;
  }
}

// The dynamics heads' weights as the wrappers pass them, for every member of
// an ensemble (the launch's blockIdx.y; one member outside an ensemble): w_t
// (H, every wt_stride floats: a column of the hidden layer's weight; member m's
// m * wt_mstride floats on), W_a and W_d (D, H), b_a and b_d (D), each
// contiguous over the members, in device memory.
struct Weights {
  const float* wt;
  int wt_stride;
  int wt_mstride;
  const float* wa;
  const float* ba;
  const float* wd;
  const float* bd;
};

// Member m's weights.
__device__ __forceinline__ Weights member_weights(Weights w, int m) {
  w.wt += static_cast<size_t>(m) * w.wt_mstride;
  w.wa += static_cast<size_t>(m) * D * H;
  w.wd += static_cast<size_t>(m) * D * H;
  w.ba += static_cast<size_t>(m) * D;
  w.bd += static_cast<size_t>(m) * D;
  return w;
}

// The weights into the shared rows, and b_a, b_d into bias (2D floats). The u
// column is the kernels' to fill, per trajectory.
__device__ __forceinline__ void load_weights(const Weights w, float* rows, float* bias) {
  for (int k = threadIdx.x; k < H * kRow; k += blockDim.x) {
    const int j = k / kRow;
    const int c = k % kRow;
    if (c == kRowU) continue;
    float v = 0.f;
    if (c == 0) {
      v = w.wt[j * w.wt_stride];
    } else if (c < kRowWd) {
      v = w.wa[(c - kRowWa) * H + j];
    } else if (c < kRowU) {
      v = w.wd[(c - kRowWd) * H + j];
    }
    rows[k] = v;
  }
  for (int k = threadIdx.x; k < D; k += blockDim.x) {
    bias[k] = w.ba[k];
    bias[D + k] = w.bd[k];
  }
}

// Step t's stage times and step size from the time grid ts, rounded as the
// plain versions' stage_time_grid (ode/semilinear.py) computes them:
// h = ts[t+1] - ts[t], tau_s = ts[t] + h * c_s, each operation on its own.
template <int M>
__device__ __forceinline__ void load_step(const float* __restrict__ ts, int t,
                                          float (&tau)[Tableau<M>::S], float& hstep) {
  const float t_lo = ts[t];
  hstep = __fsub_rn(ts[t + 1], t_lo);
#pragma unroll
  for (int s = 0; s < Tableau<M>::S; ++s) tau[s] = __fadd_rn(t_lo, __fmul_rn(hstep, Tableau<M>::c(s)));
}

// All S stages of one step at stage times tau, for the block's trajectory:
// h = relu(u + tau * w_t), a = sigmoid(W_a h + b_a), d = sigmoid(W_d h + b_d).
// The stages share each weight row: one row load feeds 2 * D * S FMAs. Each
// head sum runs over j in ascending order from 0, one fmaf per term, as the
// plain version's stage-by-stage loop does.
template <int S>
__device__ __forceinline__ void stages(const float (&tau)[S], const float* __restrict__ rows,
                                       const float* __restrict__ bias, float (&a)[S][D],
                                       float (&d)[S][D]) {
  float sa[S][D];
  float sd[S][D];
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int i = 0; i < D; ++i) sa[s][i] = sd[s][i] = 0.f;
  }
  SLODE_UNROLL_H
  for (int j = 0; j < H; ++j) {
    float r[kRow];
    load_row(rows, j, r);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float h = fmaxf(preactivation(r[kRowU], tau[s], r[0]), 0.f);
#pragma unroll
      for (int i = 0; i < D; ++i) {
        sa[s][i] = fmaf(r[kRowWa + i], h, sa[s][i]);
        sd[s][i] = fmaf(r[kRowWd + i], h, sd[s][i]);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      a[s][i] = sigmoid(sa[s][i] + bias[i]);
      d[s][i] = sigmoid(sd[s][i] + bias[D + i]);
    }
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

// The recurrences of one state component i over a pass of n steps, from
// shared memory: each batch of kScan steps loads its coefficients before the
// first FMA, so the serial chain waits on shared memory once per batch, not
// once per step.
constexpr int kScan = 8;

// Forward, x_{t+1} = A_t x_t + B_t from x, over k = 0 .. n-1, each x_{t+1}
// written over B_t.
__device__ __forceinline__ void scan_forward(const float* A, float* Bx, int n, int i, float& x) {
  for (int k0 = 0; k0 < n; k0 += kScan) {
    float av[kScan];
    float bv[kScan];
#pragma unroll
    for (int q = 0; q < kScan; ++q) {
      if (k0 + q < n) {
        av[q] = A[(k0 + q) * D + i];
        bv[q] = Bx[(k0 + q) * D + i];
      }
    }
#pragma unroll
    for (int q = 0; q < kScan; ++q) {
      if (k0 + q < n) {
        x = av[q] * x + bv[q];
        Bx[(k0 + q) * D + i] = x;
      }
    }
  }
}

// Reverse, the adjoint lam_t = A_t lam_{t+1} + g_t from lam = lam_{t1}, over
// k = n-1 .. 0, each lam_{t+1} written over g_t.
__device__ __forceinline__ void scan_reverse(const float* A, float* Gl, int n, int i, float& lam) {
  for (int k1 = n - 1; k1 >= 0; k1 -= kScan) {
    float av[kScan];
    float gv[kScan];
#pragma unroll
    for (int q = 0; q < kScan; ++q) {
      if (k1 - q >= 0) {
        av[q] = A[(k1 - q) * D + i];
        gv[q] = Gl[(k1 - q) * D + i];
      }
    }
#pragma unroll
    for (int q = 0; q < kScan; ++q) {
      if (k1 - q >= 0) {
        Gl[(k1 - q) * D + i] = lam;
        lam = av[q] * lam + gv[q];
      }
    }
  }
}

// K3's (step, stage) rows of the reduction: sa (D), sd (D), tau, padded to
// float4s
constexpr int kCoefTau = 2 * D;
constexpr int kCoef = (kCoefTau + 1 + 3) / 4 * 4;

// Threads per block for passes of chunk steps: one per step, whole warps.
__host__ __device__ constexpr int threads_for_chunk(int chunk) { return ((chunk > 1 ? chunk : 1) + 31) / 32 * 32; }

// The shared memory, in floats, of a K2 block walking passes of chunk steps:
// the weight rows, the biases, and the pass's A_t and B_t.
__host__ __device__ constexpr size_t fwd_smem_floats(int chunk) {
  return static_cast<size_t>(H) * kRow + 2 * D + 2 * static_cast<size_t>(chunk) * D;
}

// The same for K3 at S stages: the weight rows, the (step, stage) rows of
// the reduction, dL/dh (S * H * (chunk | 1)), the pass's A_t and adjoint, the
// biases, and each warp's weight-gradient sums and du.
template <int S>
__host__ __device__ constexpr size_t bwd_smem_floats(int chunk) {
  return static_cast<size_t>(H) * kRow + static_cast<size_t>(chunk) * S * kCoef +
         static_cast<size_t>(S) * H * (chunk | 1) + 2 * static_cast<size_t>(chunk) * D + 2 * D +
         static_cast<size_t>(threads_for_chunk(chunk) / 32) * (kParams + H);
}

// The longest pass (at most kMaxSteps) whose shared memory fits in
// kSmemLimit; 0 where not even one step fits, and the C entry points refuse
// the launch (ops/fused_step.py::kernel_max_steps computes the same and
// raises first; fused_semilinear_{fwd,bwd}_max_steps report these values, and
// chip_smoke.py's build phase holds the mirror to them). At the repo's widths (H = 25, D <= 8) every method takes
// kMaxSteps.
__host__ __device__ constexpr int fwd_max_steps() {
  int c = kMaxSteps;
  while (c > 0 && fwd_smem_floats(c) * sizeof(float) > kSmemLimit) --c;
  return c;
}

template <int S>
__host__ __device__ constexpr int bwd_max_steps() {
  int c = kMaxSteps;
  while (c > 0 && bwd_smem_floats<S>(c) * sizeof(float) > kSmemLimit) --c;
  return c;
}

// Steps per pass and threads per block for a grid of T times, with passes of
// at most max_steps.
inline int chunk_for(int T, int max_steps) { return std::min(T - 1, max_steps); }
inline int threads_for(int T, int max_steps) { return threads_for_chunk(chunk_for(T, max_steps)); }

// Opts the kernel in to smem bytes of dynamic shared memory where that is
// above the default. Returns a CUDA error code.
template <typename Kernel>
int opt_in(Kernel kernel, size_t smem) {
  if (smem <= static_cast<size_t>(kDefaultSmem)) return static_cast<int>(cudaSuccess);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

// opt_in, then sets *blocks to the grid: no more blocks than fit on the card
// at once (each loops over trajectories), each with an equal share of the B
// trajectories. Returns a CUDA error code.
template <typename Kernel>
int blocks_for(Kernel kernel, int threads, size_t smem, int B, int* blocks) {
  cudaError_t err = static_cast<cudaError_t>(opt_in(kernel, smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int per_block = (B + sms * per_sm - 1) / (sms * per_sm);
  *blocks = (B + per_block - 1) / per_block;
  return static_cast<int>(cudaSuccess);
}

}  // namespace slode
