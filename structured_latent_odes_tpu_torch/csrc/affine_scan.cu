// Kernel K1, affine_scan_fwd: the forward first-order affine recurrence
//
//     x_t = A_t * x_{t-1} + B_t      (elementwise over M lanes, t = 1..T)
//
// over a time-major (T, M) slab; the output (T+1, M) holds x0 in row 0.
//
// Replaces the Pallas TPU kernel structured_latent_odes_tpu/ops/recurrence.py
// ::_scan_kernel, launched by _affine_scan_raw (forward only: the backward
// sweep is the training slice's work).
//
// Design: one thread per lane m, the loop over t inside the thread. Lanes are
// independent, so there is no cross-thread communication; neighbouring
// threads read and write neighbouring addresses in every row, so each warp's
// loads and stores coalesce. The ragged tail of M is masked per thread.
//
// Bound on this card: bytes. The kernel reads A and B once and writes the
// trajectory once, 4*(2*T*M + M + (T+1)*M) bytes, against 2*T*M flops.
// At the serving shape (T = 85, M = 500) that is about 0.5 MB, so a launch
// is latency, not bandwidth.
//
// The product and the sum are rounded separately (no FMA contraction), as
// the plain PyTorch version computes them, so kernel and plain version agree
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

}  // namespace

// A, B: (T, M) row-major; x0: (M,); out: (T+1, M). All float32 on one device.
extern "C" int affine_scan_fwd(const float* A, const float* B, const float* x0,
                               float* out, int T, long long M, void* stream) {
  if (M <= 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (M + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  affine_scan_fwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(A, B, x0, out, T, M);
  return static_cast<int>(cudaGetLastError());
}
