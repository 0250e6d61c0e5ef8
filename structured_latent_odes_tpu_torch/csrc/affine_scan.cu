// Kernels K1 and K1-bwd: the first-order affine recurrence
//
//     x_t = A_t * x_{t-1} + B_t      (elementwise over M lanes, t = 1..T)
//
// over a time-major (T, M) slab, and its reverse (adjoint) sweep.
//
// affine_scan_fwd (K1) replaces the Pallas TPU kernel
// structured_latent_odes_tpu/ops/recurrence.py::_scan_kernel, launched by
// _affine_scan_raw; its output (T+1, M) holds x0 in row 0.
//
// affine_scan_bwd (K1-bwd) replaces the same _scan_kernel as the JAX
// package's custom VJP (_bwd) runs it, on time-reversed A and cotangent g,
// followed by the products that _bwd leaves to XLA. With lam_T = g_T:
//
//     dA_t = lam_t * x_{t-1},  dB_t = lam_t,  lam_{t-1} = A_t * lam_t + g_{t-1},
//     dx0 = lam_0.
//
// Design: one thread per lane m, the loop over t inside the thread. Lanes are
// independent, so there is no cross-thread communication; neighbouring
// threads read and write neighbouring addresses in every row, so each warp's
// loads and stores coalesce. The ragged tail of M is masked per thread. The
// backward walks the rows of A, g and the saved trajectory in reverse order
// itself, so the wrapper builds no flipped copies, and writes dA, dB and dx0
// directly.
//
// Bound on this card: bytes, each array read or written once. Forward:
// 4*(2*T*M + M + (T+1)*M). Backward: 4*(T*M [A] + (T+1)*M [g] + T*M [xs,
// rows 0..T-1; row T is never read] + 2*T*M [dA, dB] + M [dx0]). At the
// training shape (T = 85, M = 640) either
// is about 1 MB, so a launch is latency, not bandwidth.
//
// The products and the sums are rounded separately (no FMA contraction), as
// the plain PyTorch versions compute them, so kernels and plain versions agree
// bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
affine_scan_fwd_kernel(const float* __restrict__ A, const float* __restrict__ B,
                       const float* __restrict__ x0, float* __restrict__ out,
                       int T, long long M) {
  const long long m = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (m >= M) return;
  float x = x0[m];
  out[m] = x;
#pragma unroll 4
  for (int t = 0; t < T; ++t) {
    const long long i = static_cast<long long>(t) * M + m;
    x = __fadd_rn(__fmul_rn(A[i], x), B[i]);
    out[i + M] = x;
  }
}

__global__ void __launch_bounds__(kThreads)
affine_scan_bwd_kernel(const float* __restrict__ A, const float* __restrict__ xs,
                       const float* __restrict__ g, float* __restrict__ dA,
                       float* __restrict__ dB, float* __restrict__ dx0,
                       int T, long long M) {
  const long long m = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (m >= M) return;
  float lam = g[static_cast<long long>(T) * M + m];
#pragma unroll 4
  for (int t = T - 1; t >= 0; --t) {
    const long long i = static_cast<long long>(t) * M + m;
    dA[i] = __fmul_rn(lam, xs[i]);
    dB[i] = lam;
    lam = __fadd_rn(__fmul_rn(A[i], lam), g[i]);
  }
  dx0[m] = lam;
}

int grid_for(long long M, unsigned* blocks) {
  const long long n = (M + kThreads - 1) / kThreads;
  if (n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = static_cast<unsigned>(n);
  return static_cast<int>(cudaSuccess);
}

}  // namespace

// A, B: (T, M) row-major; x0: (M,); out: (T+1, M). All float32 on one device.
extern "C" int affine_scan_fwd(const float* A, const float* B, const float* x0,
                               float* out, int T, long long M, void* stream) {
  if (M <= 0) return static_cast<int>(cudaSuccess);
  unsigned blocks = 0;
  const int err = grid_for(M, &blocks);
  if (err != 0) return err;
  affine_scan_fwd_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      A, B, x0, out, T, M);
  return static_cast<int>(cudaGetLastError());
}

// A: (T, M); xs: (T+1, M) the forward trajectory with x0 in row 0; g: (T+1, M)
// the cotangent of xs; dA, dB: (T, M); dx0: (M,). All float32 on one device.
extern "C" int affine_scan_bwd(const float* A, const float* xs, const float* g,
                               float* dA, float* dB, float* dx0, int T, long long M,
                               void* stream) {
  if (M <= 0) return static_cast<int>(cudaSuccess);
  unsigned blocks = 0;
  const int err = grid_for(M, &blocks);
  if (err != 0) return err;
  affine_scan_bwd_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      A, xs, g, dA, dB, dx0, T, M);
  return static_cast<int>(cudaGetLastError());
}
