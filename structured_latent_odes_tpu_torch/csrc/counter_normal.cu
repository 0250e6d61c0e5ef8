// The draws' counter hash and Box-Muller in one launch a draw site
// (counter_normal), and the seed folds of a seed held on the card
// (counter_fold): prob/distributions.py's arithmetic, bit for bit.
//
// For a 64-bit seed s, a site's crc32 c, a sample id i and an element j:
//
//     mix32(x)        = the 'lowbias32' finalizer: x ^= x >> 16; x *= 0x7FEB352D;
//                       x ^= x >> 15; x *= 0x846CA68B; x ^= x >> 16  (uint32)
//     site_word(s, c) = h = 0x9E3779B9, then h = mix32(h ^ w) for w in
//                       (low 32 bits of s, high 32 bits of s, c)
//     fold(s, w)      = site_word(s, crc32("fold/w")) << 32 | site_word(s, crc32("fold/w/lo"))
//     key             = mix32((i mod 2^32) ^ site_word(s, c))
//     u_k             = ((mix32(key ^ k) >> 8) + 0.5) / 2^24,  k = 2j, 2j + 1
//     eps_j           = float(sqrt(-2 log u_2j) * cos(2 pi u_2j+1))
//
// The plain version computes the hash in int64 tensors with each 32-bit
// product emulated (_mul32: the low 32 bits of the product), which is uint32
// arithmetic here, and Box-Muller in float64 tensors, which is each step
// here in double: (w + 0.5) and the scale by 2^-24 are exact, -2 * log(u)
// exact, (2 pi) * u one rounding with the double nearest 2 pi (Python's
// 2.0 * math.pi), the product one rounding, the cast to float round to
// nearest; log, cos and sqrt are the CUDA math library's, which ATen's
// float64 kernels call. Each of this file's own double operations is a
// __d*_rn intrinsic, so nvcc cannot contract two of them into an FMA (the
// library's own code is compiled as it is for ATen), and nothing is built
// with fast math. Words and draws are therefore bit-equal to the plain
// version's on the card.
//
// It replaces no TPU kernel: the JAX package draws with jax.random
// (threefry) inside XLA's fusions. The port's plain version is about 115
// int64 and float64 elementwise kernels a draw site on a seed held on the
// card (the graphed eval functions and the stacked steps' seeds), each a
// launch slot on a few thousand elements; this is one.
//
// Bound on this card: neither. A CVS site is B = 128 rows of n = 5 draws:
// 640 threads, each about 60 integer operations, two float64 transcendentals
// and one 4-byte store; a launch is latency.
//
// Design. A thread an output element: blockIdx.y is the member (S of them,
// each with its seed seeds[s * seed_ms] and its sample ids sids + s * sid_ms;
// a stride of 0 shares one among all members), blockIdx.x * blockDim.x +
// threadIdx.x runs over the member's B * n elements, row-major. Each thread
// works out its member's site word and its row's key itself (four mix32),
// which costs less than a pass through shared memory would. A seed given on
// the host arrives as its site word (seeds == nullptr), worked out in Python.
// counter_fold is elementwise over any number of 64-bit seeds, with up to
// kMaxFolds words' crc32 pairs as kernel arguments, applied in order.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFolds = 8;
constexpr double kTwoPi = 2.0 * 3.141592653589793;  // the double nearest 2 pi, Python's 2.0 * math.pi
constexpr double kScale = 1.0 / 16777216.0;          // 2^-24, exact

struct Folds {
  int count;
  uint32_t hi[kMaxFolds];  // crc32("fold/<w>")
  uint32_t lo[kMaxFolds];  // crc32("fold/<w>/lo")
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

__device__ __forceinline__ uint32_t site_word(uint64_t seed, uint32_t crc) {
  uint32_t h = 0x9E3779B9u;
  h = mix32(h ^ static_cast<uint32_t>(seed));
  h = mix32(h ^ static_cast<uint32_t>(seed >> 32));
  return mix32(h ^ crc);
}

__device__ __forceinline__ double uniform(uint32_t key, uint32_t counter) {
  const double w = static_cast<double>(mix32(key ^ counter) >> 8);
  return __dmul_rn(__dadd_rn(w, 0.5), kScale);
}

// S members, each B rows of n draws: out (S, B, n) float32. seeds: S int64
// seeds, seed_ms apart, or nullptr, with `site` then the site word of a seed
// given on the host; else `site` is the site's crc32. sids: each member's B
// sample ids (int32 if sid_bytes is 4, else int64), sid_ms elements apart.
__global__ void __launch_bounds__(kThreads)
counter_normal_kernel(const long long* __restrict__ seeds, long long seed_ms, uint32_t site,
                      const void* __restrict__ sids, int sid_bytes, long long sid_ms, float* __restrict__ out,
                      int B, int n) {
  const int s = blockIdx.y;
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= static_cast<long long>(B) * n) return;
  const int b = static_cast<int>(e / n);
  const int j = static_cast<int>(e - static_cast<long long>(b) * n);
  const uint32_t word = seeds ? site_word(static_cast<uint64_t>(seeds[s * seed_ms]), site) : site;
  const long long r = s * sid_ms + b;
  const uint32_t sid = sid_bytes == 4 ? static_cast<uint32_t>(static_cast<const int*>(sids)[r])
                                      : static_cast<uint32_t>(static_cast<const long long*>(sids)[r]);
  const uint32_t key = mix32(sid ^ word);
  const double u1 = uniform(key, 2u * static_cast<uint32_t>(j));
  const double u2 = uniform(key, 2u * static_cast<uint32_t>(j) + 1u);
  const double radius = __dsqrt_rn(__dmul_rn(-2.0, log(u1)));
  const double eps = __dmul_rn(radius, cos(__dmul_rn(kTwoPi, u2)));
  out[static_cast<long long>(s) * B * n + e] = __double2float_rn(eps);
}

__global__ void __launch_bounds__(kThreads)
counter_fold_kernel(const long long* __restrict__ seeds, long long* __restrict__ out, long long count, Folds f) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= count) return;
  uint64_t seed = static_cast<uint64_t>(seeds[i]);
  for (int k = 0; k < f.count; ++k)
    seed = (static_cast<uint64_t>(site_word(seed, f.hi[k])) << 32) | site_word(seed, f.lo[k]);
  out[i] = static_cast<long long>(seed);
}

}  // namespace

// The draws of one site for S members: see counter_normal_kernel. n, an int,
// is below 2^31, so a row's counters 2j and 2j + 1 fit 32 bits; the B * n
// threads must fit grid.x's 2^31 - 1 blocks and S grid.y's 65535.
extern "C" int counter_normal(const long long* seeds, long long seed_ms, unsigned int site, const void* sids,
                              int sid_bytes, long long sid_ms, float* out, int S, int B, int n, void* stream) {
  const long long elems = static_cast<long long>(B) * n;
  if (S > 65535 || S < 0 || B < 0 || n < 0 || (elems + kThreads - 1) / kThreads > INT_MAX ||
      (sid_bytes != 4 && sid_bytes != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0 || elems == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned>((elems + kThreads - 1) / kThreads), S);
  counter_normal_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      seeds, seed_ms, site, sids, sid_bytes, sid_ms, out, B, n);
  return static_cast<int>(cudaGetLastError());
}

// `count` int64 seeds, each folded by the `n_folds` words whose crc32 pairs
// are crcs[2k] (hi) and crcs[2k + 1] (lo), in order; n_folds at most
// kMaxFolds. The pairs travel as kernel arguments.
extern "C" int counter_fold(const long long* seeds, long long* out, long long count, const unsigned int* crcs,
                            int n_folds, void* stream) {
  if (n_folds < 0 || n_folds > kMaxFolds || count < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (count == 0) return static_cast<int>(cudaSuccess);
  Folds f{};
  f.count = n_folds;
  for (int k = 0; k < n_folds; ++k) {
    f.hi[k] = crcs[2 * k];
    f.lo[k] = crcs[2 * k + 1];
  }
  const unsigned blocks = static_cast<unsigned>((count + kThreads - 1) / kThreads);
  counter_fold_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(seeds, out, count, f);
  return static_cast<int>(cudaGetLastError());
}
