// Kernels K1 and K1-bwd: the first-order affine recurrence
//
//     x_t = A_t * x_{t-1} + B_t      (elementwise, t = 1..T)
//
// over batch-major trajectories, and its reverse (adjoint) sweep. Trajectory
// b has D independent components: its coefficients A[b] and B[b] are each one
// contiguous (T, D) run, and its output one contiguous (T+1, D) run with
// x0[b] in row 0. That is the layout the model holds, (Bt, T, D).
//
// affine_scan_fwd (K1) replaces the Pallas TPU kernel
// structured_latent_odes_tpu/ops/recurrence.py::_scan_kernel, launched by
// _affine_scan_raw (entry affine_scan_pallas, which takes this layout and
// transposes it to time-major for the TPU).
//
// affine_scan_bwd (K1-bwd) replaces the same _scan_kernel as the JAX
// package's custom VJP (_bwd) runs it, on time-reversed A and cotangent g,
// with lam_T = g_T:
//
//     dA_t = lam_t * x_{t-1},  dB_t = lam_t,  lam_{t-1} = A_t * lam_t + g_{t-1},
//     dx0 = lam_0.
//
// Bound on this card. Bytes, each array read or written once: forward
// 4*(2*T + 1 + (T+1))*D per trajectory, backward 4*(T [A] + (T+1) [g] + T
// [xs, rows 0..T-1] + 2*T [dA, dB] + 1 [dx0])*D. At the training shape
// (Bt = 128, T = 85, D = 5) either is under 1 MB, so a launch is latency: one
// round trip for the coefficients, the T dependent multiply-add pairs of a
// component, the stores. At Bt = 16,411 it is the bytes.
//
// Design. A block owns a tile of kTile = 4 whole trajectories. In the
// batch-major layout a tile of any of the arrays is one contiguous run, and a
// run of four trajectories starts and ends on 16 bytes.
//   1. Thread 0 copies each input run into shared memory with one bulk copy
//      of the Tensor Memory Accelerator, completing on an mbarrier. No thread
//      spends instructions on the loads (16-byte cp.async copies by all
//      threads took longer to start than to arrive), and a run's bytes are
//      all in flight at once. A run that does not start on 16 bytes (a view
//      into a larger tensor) and the last tile's ragged end are copied by the
//      threads.
//   2. One thread per component runs the sequential chain from shared memory,
//      in the runs' own row order: step t of a component is t*D floats on. It
//      holds kGroup steps' coefficients in registers and reads the next
//      kGroup while it chains these. The offsets i*D of a group's steps are
//      computed once and kept opaque to the compiler, which otherwise derives
//      each address from the previous one: a chain of dependent integer
//      operations that the in-order warp interleaves with the dependent
//      multiply-add chain. x_t goes to a staged output run.
//   3. All threads store the output run with 16-byte stores, coalesced.
// The backward stages A, xs (all T+1 rows: one row more than it needs) and g,
// runs the chain from step T-1 down to 0 with the group below read ahead,
// stages dA and dB in row order and stores them the same way; dx0 goes from
// the chain to device memory. Shared memory holds whole runs plus kGroup rows
// of read-ahead (fwd_smem, bwd_smem: 20.3 KB forward and 33.8 KB backward at
// T = 85, D = 5), so T is capped by a block's 227 KB (at D = 5, 966 steps
// forward and 579 backward; CVS and proc have T = 85, challenge 141).
// affine_scan_max_steps reports the cap, and the wrappers raise above it. D
// is a runtime argument up to 32. At the training batch the 32 blocks reach
// 32 SMs; at Bt = 16,411 several blocks share an SM, so one block's copies
// overlap another's chain.
//
// Built with -DAFFINE_SCAN_STAMPS=1 (scripts/k1_phase_probe.py), thread 0 of
// each block records the SM's clock at the start, when the inputs have
// landed, after the chain and at the end; otherwise STAMP is empty.
//
// Each component keeps its own sequential chain, the product and the sum
// rounded separately (no FMA contraction), as the plain PyTorch versions
// compute them: the kernels agree with them bit for bit, whatever the launch
// geometry.

#include <cuda_runtime.h>

#include <cstdint>

#if AFFINE_SCAN_STAMPS
constexpr int kStampBlocks = 4096;
__device__ long long g_stamps[kStampBlocks * 4];
#define STAMP(k) \
  if (threadIdx.x == 0 && blockIdx.x < kStampBlocks) g_stamps[blockIdx.x * 4 + (k)] = clock64();
#else
#define STAMP(k)
#endif

namespace {

constexpr int kTile = 4;      // trajectories per block
constexpr int kThreads = 128;
constexpr int kMaxD = kThreads / kTile;  // a thread per component
constexpr int kGroup = 8;     // steps a chain thread holds in registers
constexpr int kHeader = 4;    // floats before the runs: the mbarrier, 16 bytes
constexpr long long kMaxSmem = 232448;  // shared memory a block can have (227 KB)
constexpr long long kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }
// Room for a tile's input run of `rows` rows per trajectory and kGroup rows
// read past its end, a whole number of 16-byte pieces.
__host__ __device__ constexpr int run_room(int rows, int D) { return round4((kTile * rows + kGroup) * D); }
// Shared memory of a launch, in bytes: the mbarrier, the input runs, the
// output runs.
constexpr long long fwd_smem(int T, int D) {
  return 4LL * (kHeader + 2LL * run_room(T, D) + round4(kTile * (T + 1) * D));
}
constexpr long long bwd_smem(int T, int D) {
  return 4LL * (kHeader + run_room(T, D) + 2LL * run_room(T + 1, D) + 2LL * round4(kTile * T * D));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The block's mbarrier for the input copies: one arrival (thread 0's, with
// the bytes to expect); every thread waits for phase 0 to complete.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "wait:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
      "@!done bra wait;\n"
      "}\n" ::"r"(smem_addr(bar))
      : "memory");
}

// Bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// global to shared, completing on bar.
__device__ __forceinline__ void bulk_load(float* dst, const float* src, unsigned bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

// The floats of an n-float run at p that one bulk copy moves: its whole
// 16-byte pieces when p is 16-byte aligned, else none.
__device__ __forceinline__ int bulk_part(const float* p, int n) { return aligned16(p) ? n & ~3 : 0; }

// The rest of a run, floats bulk..n-1, by all threads.
__device__ __forceinline__ void load_rest(float* dst, const float* __restrict__ src, int bulk, int n) {
  for (int i = bulk + threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

// n floats from shared src (16-byte aligned) to global dst, all threads:
// 16-byte stores when dst is aligned too.
__device__ __forceinline__ void store_run(float* __restrict__ dst, const float* src, int n) {
  const int n4 = aligned16(dst) ? n >> 2 : 0;
  for (int i = threadIdx.x; i < n4; i += kThreads)
    reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
  for (int i = 4 * n4 + threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

// The offsets i*D of a group's steps, opaque to the compiler.
__device__ __forceinline__ void group_offsets(int (&off)[kGroup], int D) {
#pragma unroll
  for (int i = 0; i < kGroup; ++i) asm("mov.b32 %0, %1;" : "=r"(off[i]) : "r"(i * D));
}

// One component: a and b at its step 0, steps D floats apart (read up to
// kGroup - 1 steps past T-1); x_t to xo[t * D] for t = 1..T.
__device__ __forceinline__ void scan_lane(const float* a, const float* b, float* xo, float x, int T, int D) {
  int off[kGroup];
  group_offsets(off, D);
  float av[kGroup], bv[kGroup];
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    av[i] = a[off[i]];
    bv[i] = b[off[i]];
  }
  int t = 0;
  for (; t + kGroup <= T; t += kGroup) {
    const float* an_p = a + (t + kGroup) * D;
    const float* bn_p = b + (t + kGroup) * D;
    float an[kGroup], bn[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      an[i] = an_p[off[i]];
      bn[i] = bn_p[off[i]];
    }
    float* xt = xo + (t + 1) * D;
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      x = __fadd_rn(__fmul_rn(av[i], x), bv[i]);
      xt[off[i]] = x;
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      av[i] = an[i];
      bv[i] = bn[i];
    }
  }
  float* xt = xo + (t + 1) * D;
#pragma unroll
  for (int i = 0; i < kGroup - 1; ++i) {
    if (t + i < T) {
      x = __fadd_rn(__fmul_rn(av[i], x), bv[i]);
      xt[off[i]] = x;
    }
  }
}

// One component's reverse sweep from lam = lam_T, t = T-1 down to 0, steps D
// floats apart: da[t] = lam * xs[t], db[t] = lam, lam = a[t] * lam + g[t];
// returns lam_0. Groups of kGroup steps at multiples of kGroup, the top
// (partial) one first (read up to kGroup - 2 steps past T-1), the next lower
// group read ahead. T >= 1.
__device__ __forceinline__ float adjoint_lane(const float* a, const float* xs, const float* g, float* da,
                                              float* db, float lam, int T, int D) {
  int off[kGroup];
  group_offsets(off, D);
  int t0 = (T - 1) & ~(kGroup - 1);
  float av[kGroup], xv[kGroup], gv[kGroup];
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    av[i] = a[t0 * D + off[i]];
    xv[i] = xs[t0 * D + off[i]];
    gv[i] = g[t0 * D + off[i]];
  }
#pragma unroll
  for (int i = kGroup - 1; i >= 0; --i) {
    if (t0 + i < T) {
      da[t0 * D + off[i]] = __fmul_rn(lam, xv[i]);
      db[t0 * D + off[i]] = lam;
      lam = __fadd_rn(__fmul_rn(av[i], lam), gv[i]);
    }
  }
  if (t0 == 0) return lam;
  t0 -= kGroup;
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    av[i] = a[t0 * D + off[i]];
    xv[i] = xs[t0 * D + off[i]];
    gv[i] = g[t0 * D + off[i]];
  }
  for (; t0 >= 0; t0 -= kGroup) {
    const int nt = max(t0 - kGroup, 0) * D;
    float an[kGroup], xn[kGroup], gn[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      an[i] = a[nt + off[i]];
      xn[i] = xs[nt + off[i]];
      gn[i] = g[nt + off[i]];
    }
    float* dat = da + t0 * D;
    float* dbt = db + t0 * D;
#pragma unroll
    for (int i = kGroup - 1; i >= 0; --i) {
      dat[off[i]] = __fmul_rn(lam, xv[i]);
      dbt[off[i]] = lam;
      lam = __fadd_rn(__fmul_rn(av[i], lam), gv[i]);
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      av[i] = an[i];
      xv[i] = xn[i];
      gv[i] = gn[i];
    }
  }
  return lam;
}

__global__ void __launch_bounds__(kThreads, 8)
affine_scan_fwd_kernel(const float* __restrict__ A, const float* __restrict__ B,
                       const float* __restrict__ x0, float* __restrict__ out, long long Bt, int T, int D) {
  extern __shared__ __align__(16) float smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  STAMP(0)
  const int TD = T * D;
  float* s_a = smem + kHeader;        // the A run, row order
  float* s_b = s_a + run_room(T, D);  // the B run
  float* s_x = s_b + run_room(T, D);  // the output run
  const long long b0 = static_cast<long long>(blockIdx.x) * kTile;
  const int nb = static_cast<int>(min(static_cast<long long>(kTile), Bt - b0));
  const float* a_run = A + b0 * TD;
  const float* b_run = B + b0 * TD;
  const int n = nb * TD, bulk_a = bulk_part(a_run, n), bulk_b = bulk_part(b_run, n);
  if (threadIdx.x == 0) {
    mbar_init(bar);
    mbar_expect(bar, 4u * (bulk_a + bulk_b));
    if (bulk_a > 0) bulk_load(s_a, a_run, 4u * bulk_a, bar);
    if (bulk_b > 0) bulk_load(s_b, b_run, 4u * bulk_b, bar);
  }
  load_rest(s_a, a_run, bulk_a, n);
  load_rest(s_b, b_run, bulk_b, n);
  const int l = threadIdx.x;  // the thread's component: trajectory l / D, component l % D
  const bool chain = l < nb * D;
  const float x = chain ? x0[b0 * D + l] : 0.0f;
  __syncthreads();
  mbar_wait(bar);
  STAMP(1)
  if (chain) {
    const int j = l / D, c = j * TD + l - j * D;
    float* xo = s_x + c + j * D;
    xo[0] = x;
    scan_lane(s_a + c, s_b + c, xo, x, T, D);
  }
  __syncthreads();
  STAMP(2)
  store_run(out + b0 * (TD + D), s_x, nb * (TD + D));
  STAMP(3)
}

__global__ void __launch_bounds__(kThreads, 6)
affine_scan_bwd_kernel(const float* __restrict__ A, const float* __restrict__ xs,
                       const float* __restrict__ g, float* __restrict__ dA,
                       float* __restrict__ dB, float* __restrict__ dx0, long long Bt, int T, int D) {
  extern __shared__ __align__(16) float smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  STAMP(0)
  const int TD = T * D;
  float* s_a = smem + kHeader;              // the A run, row order
  float* s_x = s_a + run_room(T, D);        // the xs run
  float* s_g = s_x + run_room(T + 1, D);    // the g run
  float* s_da = s_g + run_room(T + 1, D);   // the dA run
  float* s_db = s_da + round4(kTile * TD);  // the dB run
  const long long b0 = static_cast<long long>(blockIdx.x) * kTile;
  const int nb = static_cast<int>(min(static_cast<long long>(kTile), Bt - b0));
  const float* a_run = A + b0 * TD;
  const float* x_run = xs + b0 * (TD + D);
  const float* g_run = g + b0 * (TD + D);
  const int n = nb * TD, nx = nb * (TD + D);
  const int bulk_a = bulk_part(a_run, n), bulk_x = bulk_part(x_run, nx), bulk_g = bulk_part(g_run, nx);
  if (threadIdx.x == 0) {
    mbar_init(bar);
    mbar_expect(bar, 4u * (bulk_a + bulk_x + bulk_g));
    if (bulk_a > 0) bulk_load(s_a, a_run, 4u * bulk_a, bar);
    if (bulk_x > 0) bulk_load(s_x, x_run, 4u * bulk_x, bar);
    if (bulk_g > 0) bulk_load(s_g, g_run, 4u * bulk_g, bar);
  }
  load_rest(s_a, a_run, bulk_a, n);
  load_rest(s_x, x_run, bulk_x, nx);
  load_rest(s_g, g_run, bulk_g, nx);
  __syncthreads();
  mbar_wait(bar);
  STAMP(1)
  const int l = threadIdx.x;
  if (l < nb * D) {
    const int j = l / D, c = j * TD + l - j * D, cx = c + j * D;
    const float* gl = s_g + cx;
    dx0[b0 * D + l] = T > 0 ? adjoint_lane(s_a + c, s_x + cx, gl, s_da + c, s_db + c, gl[TD], T, D) : gl[0];
  }
  __syncthreads();
  STAMP(2)
  store_run(dA + b0 * TD, s_da, nb * TD);
  store_run(dB + b0 * TD, s_db, nb * TD);
  STAMP(3)
}

// Opens a kernel's shared memory past the default 48 KB, once per device.
int open_smem(const void* kernel, long long smem, long long (&opened)[kMaxDevices]) {
  if (smem <= kDefaultSmem) return static_cast<int>(cudaSuccess);
  int device = 0;
  const cudaError_t got = cudaGetDevice(&device);
  if (got != cudaSuccess) return static_cast<int>(got);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem <= opened[device]) return static_cast<int>(cudaSuccess);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) opened[device] = smem;
  return static_cast<int>(err);
}

// The grid for Bt trajectories; cudaErrorInvalidValue for shapes the kernels
// do not take.
int grid(long long Bt, int T, int D, long long smem, unsigned* blocks) {
  if (Bt < 0 || T < 0 || D < 1 || D > kMaxD || smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = (Bt + kTile - 1) / kTile;
  if (n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = static_cast<unsigned>(n);
  return static_cast<int>(cudaSuccess);
}

#if AFFINE_SCAN_STAMPS
__global__ void empty_kernel() {}
#endif

}  // namespace

#if AFFINE_SCAN_STAMPS
// The stamps of the first n / 4 blocks of the last launch, four per block.
extern "C" int affine_scan_read_stamps(long long* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_stamps, n * sizeof(long long)));
}

// An empty kernel of `blocks` blocks of the kernels' size: the floor of a
// launch.
extern "C" int affine_scan_launch_empty(unsigned blocks, void* stream) {
  empty_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
#endif

// The most steps a launch takes at width D, forward (backward == 0) or
// backward: the largest T whose tile fits in a block's shared memory. -1 for
// a D outside 1..32.
extern "C" int affine_scan_max_steps(int D, int backward) {
  if (D < 1 || D > kMaxD) return -1;
  int T = 0;
  while ((backward ? bwd_smem(T + 1, D) : fwd_smem(T + 1, D)) <= kMaxSmem) ++T;
  return T;
}

// A, B: (Bt, T, D); x0: (Bt, D); out: (Bt, T+1, D). All float32, contiguous,
// on one device; 1 <= D <= 32 and fwd_smem within a block's shared memory.
extern "C" int affine_scan_fwd(const float* A, const float* B, const float* x0, float* out,
                               long long Bt, int T, int D, void* stream) {
  static long long opened[kMaxDevices] = {};
  const long long smem = fwd_smem(T, D);
  unsigned blocks = 0;
  int err = grid(Bt, T, D, smem, &blocks);
  if (err == 0) err = open_smem(reinterpret_cast<const void*>(affine_scan_fwd_kernel), smem, opened);
  if (err != 0 || blocks == 0) return err;
  affine_scan_fwd_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(A, B, x0, out, Bt, T, D);
  return static_cast<int>(cudaGetLastError());
}

// A: (Bt, T, D); xs: (Bt, T+1, D) the forward trajectory with x0 in row 0;
// g: (Bt, T+1, D) the cotangent of xs; dA, dB: (Bt, T, D); dx0: (Bt, D). All
// float32, contiguous, on one device; 1 <= D <= 32 and bwd_smem within a
// block's shared memory.
extern "C" int affine_scan_bwd(const float* A, const float* xs, const float* g, float* dA,
                               float* dB, float* dx0, long long Bt, int T, int D, void* stream) {
  static long long opened[kMaxDevices] = {};
  const long long smem = bwd_smem(T, D);
  unsigned blocks = 0;
  int err = grid(Bt, T, D, smem, &blocks);
  if (err == 0) err = open_smem(reinterpret_cast<const void*>(affine_scan_bwd_kernel), smem, opened);
  if (err != 0 || blocks == 0) return err;
  affine_scan_bwd_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      A, xs, g, dA, dB, dx0, Bt, T, D);
  return static_cast<int>(cudaGetLastError());
}
