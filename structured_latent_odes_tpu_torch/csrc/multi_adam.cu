// One Adam update of many leaves in one launch (multi_adam): the shared
// per-parameter Adam of train/svi.py::shared_adam_update, bit for bit.
//
// For each stepped leaf, with its float32 params p, gradient g and moments
// m, n, the bias corrections c1, c2 of its column of the update's (2, L)
// corrections, and its step size s:
//
//     m' = b1 * m + (1 - b1) * g
//     n' = b2 * n + ((1 - b2) * g) * g
//     p' = p - (s * (m' / c1)) / (sqrt(n' / c2) + eps)
//
// The plain version (train/svi.py::adam_plain) is those lines in float32
// tensor arithmetic: each operation one ATen elementwise kernel, each
// rounded to nearest, the Python scalars b1, 1 - b1, b2, 1 - b2 and eps
// rounded to float32 first (as ATen's kernels take a scalar), s the float32
// of the host's lr * scale or, with the lr a 0-d float32 tensor on the card,
// the float32 product lr * float32(scale). Here each of those operations is
// its __f*_rn intrinsic, in the same order, so nvcc contracts none of them
// into an FMA, and nothing is built with fast math: params and moments are
// bit-equal to the plain version's on the card.
//
// It replaces no TPU kernel: the JAX package's optimizer is jnp arithmetic
// that XLA fuses with the step. The plain version is 15 elementwise kernels
// a leaf, each a launch slot of about 1.5 us inside the replayed step graph;
// a dual step steps 46 leaves at CVS and 78 at proc (ten members stacked).
//
// Bound on this card: bytes. An element reads p, g, m and n and writes p', m'
// and n': 28 bytes, about 40 operations. A proc update (549,430 floats)
// moves 15.4 MB, about 4.6 us at 3.35 TB/s; a CVS one (40,300) is latency.
//
// Design. The leaves' table travels by value in the launch's parameters
// (__grid_constant__: read in place, never copied to the stack), filled
// from host arrays by the C entry point, so a CUDA graph's capture bakes in
// the addresses and captures no copy. Each leaf owns ceil(count / kChunk)
// consecutive blocks; block_start is the prefix of those counts, and a
// block finds its leaf by a binary search of it (uniform over the block).
// A thread updates four consecutive elements: one 16-byte access on each of
// the seven arrays where all seven are 16-byte aligned and the four lie
// inside the leaf, else element by element up to the leaf's end. A leaf's
// leading member axis (a sweep's stacked members) is only more elements.
// The table holds at most kMaxLeaves leaves (its size within the 4 KB of a
// launch's classic parameter space); the wrapper splits a longer tree over
// several launches.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kChunk = kThreads * kPerThread;  // elements a block
constexpr int kMaxLeaves = 52;

struct Leaf {
  const float* p;
  const float* g;
  const float* m;
  const float* n;
  float* p_out;
  float* m_out;
  float* n_out;
};

struct Table {
  const float* lr;          // 0-d lr on the card, or nullptr: scale holds the whole step
  const float* corr;        // the update's corrections: c1 at corr[col * cs], c2 at corr[rs + col * cs]
  long long rs, cs;
  float b1, omb1, b2, omb2, eps;
  int leaves;
  int block_start[kMaxLeaves + 1];
  int col[kMaxLeaves];
  float scale[kMaxLeaves];
  long long count[kMaxLeaves];
  Leaf leaf[kMaxLeaves];
};

static_assert(sizeof(Table) <= 4096, "the table must fit a launch's 4 KB of parameters");

struct Consts {
  float b1, omb1, b2, omb2, eps, c1, c2, step;
};

__device__ __forceinline__ void adam(const Consts& k, float p, float g, float m, float n, float& p2, float& m2,
                                     float& n2) {
  m2 = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.omb1, g));
  n2 = __fadd_rn(__fmul_rn(k.b2, n), __fmul_rn(__fmul_rn(k.omb2, g), g));
  const float m_hat = __fdiv_rn(m2, k.c1);
  const float n_hat = __fdiv_rn(n2, k.c2);
  p2 = __fsub_rn(p, __fdiv_rn(__fmul_rn(k.step, m_hat), __fadd_rn(__fsqrt_rn(n_hat), k.eps)));
}

__global__ void __launch_bounds__(kThreads) multi_adam_kernel(const __grid_constant__ Table t) {
  const int b = blockIdx.x;
  int lo = 0, hi = t.leaves - 1;  // the last leaf whose first block is at or before b
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.block_start[mid] <= b) lo = mid;
    else hi = mid - 1;
  }
  const Leaf& L = t.leaf[lo];
  const long long count = t.count[lo];
  const long long e = static_cast<long long>(b - t.block_start[lo]) * kChunk + threadIdx.x * kPerThread;
  if (e >= count) return;
  const long long c = t.col[lo];
  Consts k{t.b1, t.omb1, t.b2, t.omb2, t.eps, t.corr[c * t.cs], t.corr[t.rs + c * t.cs],
           t.lr ? __fmul_rn(*t.lr, t.scale[lo]) : t.scale[lo]};
  const uintptr_t bits = reinterpret_cast<uintptr_t>(L.p) | reinterpret_cast<uintptr_t>(L.g) |
                         reinterpret_cast<uintptr_t>(L.m) | reinterpret_cast<uintptr_t>(L.n) |
                         reinterpret_cast<uintptr_t>(L.p_out) | reinterpret_cast<uintptr_t>(L.m_out) |
                         reinterpret_cast<uintptr_t>(L.n_out);
  if ((bits & 15) == 0 && e + kPerThread <= count) {
    const float4 p = *reinterpret_cast<const float4*>(L.p + e);
    const float4 g = *reinterpret_cast<const float4*>(L.g + e);
    const float4 m = *reinterpret_cast<const float4*>(L.m + e);
    const float4 n = *reinterpret_cast<const float4*>(L.n + e);
    float4 p2, m2, n2;
    adam(k, p.x, g.x, m.x, n.x, p2.x, m2.x, n2.x);
    adam(k, p.y, g.y, m.y, n.y, p2.y, m2.y, n2.y);
    adam(k, p.z, g.z, m.z, n.z, p2.z, m2.z, n2.z);
    adam(k, p.w, g.w, m.w, n.w, p2.w, m2.w, n2.w);
    *reinterpret_cast<float4*>(L.p_out + e) = p2;
    *reinterpret_cast<float4*>(L.m_out + e) = m2;
    *reinterpret_cast<float4*>(L.n_out + e) = n2;
    return;
  }
  for (long long i = e; i < e + kPerThread && i < count; ++i)
    adam(k, L.p[i], L.g[i], L.m[i], L.n[i], L.p_out[i], L.m_out[i], L.n_out[i]);
}

}  // namespace

// One launch over `leaves` leaves (1 to kMaxLeaves). ptrs: seven a leaf, in
// the order p, g, m, n, p_out, m_out, n_out; counts: each leaf's elements;
// block_start: leaves + 1 block offsets, block_start[i + 1] - block_start[i]
// = ceil(counts[i] / kChunk), from 0; cols: each leaf's column of the
// corrections `corr` (c1 at corr[col * cs], c2 at corr[rs + col * cs]);
// scales: each leaf's float32 step, or its lr multiplier when `lr` (a 0-d
// float32 on the card) is given. The table is checked against kChunk and
// copied into the launch's parameters.
extern "C" int multi_adam(int leaves, const void* const* ptrs, const long long* counts, const int* block_start,
                          const int* cols, const float* scales, const float* lr, const float* corr, long long rs,
                          long long cs, float b1, float omb1, float b2, float omb2, float eps, void* stream) {
  if (leaves < 1 || leaves > kMaxLeaves || block_start[0] != 0) return static_cast<int>(cudaErrorInvalidValue);
  Table t{};
  t.lr = lr;
  t.corr = corr;
  t.rs = rs;
  t.cs = cs;
  t.b1 = b1;
  t.omb1 = omb1;
  t.b2 = b2;
  t.omb2 = omb2;
  t.eps = eps;
  t.leaves = leaves;
  t.block_start[0] = 0;
  for (int i = 0; i < leaves; ++i) {
    const long long blocks = (counts[i] + kChunk - 1) / kChunk;
    if (counts[i] < 0 || cols[i] < 0 ||
        static_cast<long long>(block_start[i + 1]) - block_start[i] != blocks)
      return static_cast<int>(cudaErrorInvalidValue);
    t.block_start[i + 1] = block_start[i + 1];
    t.col[i] = cols[i];
    t.scale[i] = scales[i];
    t.count[i] = counts[i];
    void* const* q = const_cast<void* const*>(ptrs + 7 * i);
    t.leaf[i] = Leaf{static_cast<const float*>(q[0]), static_cast<const float*>(q[1]),
                     static_cast<const float*>(q[2]), static_cast<const float*>(q[3]),
                     static_cast<float*>(q[4]), static_cast<float*>(q[5]), static_cast<float*>(q[6])};
  }
  const int grid = block_start[leaves];
  if (grid == 0) return static_cast<int>(cudaSuccess);
  multi_adam_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}
