// Fused joint latent draw: Box-Muller Gaussian and Gumbel-softmax, f32.
//
// Replaces fused_joint_sample (shotvae_tpu/ops/pallas/fused_sample.py:57,
// kernel _sample_kernel :38, launched :62):
//
//     z = mean + exp(log_sigma) * sqrt(-2 log(u1 + 1e-12)) * cos(2 pi u2)
//     y = softmax((log_alpha - log(-log(u + 1e-12) + 1e-12)) / T)
//
// written as out = [z ; y], (B, Dc + Dd) f32, row-major.
//
// What bounds it on the H100: the launch. Its bytes (mean, log_sigma and
// log_alpha read once, out written once: 0.37 us at (768, 128, 10) over
// 3.35 TB/s) and its arithmetic (one Philox-4x32-10 call and a few
// transcendentals per pair of elements) are far below what one launch
// takes. So the design is one launch whose blocks all start in the first
// wave, each thread running one short dependent chain.
//
// Random numbers: Philox-4x32-10 (Salmon et al., "Parallel random numbers:
// as easy as 1, 2, 3", the Random123 generator) keyed by (seed, 0), seed
// the wrapper's 31-bit draw. The counters (c0, c1, c2, c3) are
//
//     Gaussian pair j of row r (columns 2j, 2j + 1):  (j, 0, r, 0)
//     Gumbel group q of row r (columns 4q .. 4q + 3): (q, 1, r, 0)
//
// The two streams differ in c1, so no counter is used twice. One call's
// four words (x, y, z, w) give u1, u2 of column 2j (x, y) and of column
// 2j + 1 (z, w), or u of columns 4q .. 4q + 3: nothing is discarded. A
// word w becomes u = (w >> 8) * 2^-24, the TPU kernel's uniform (_uniform
// :29): exact in f32, in [0, 1 - 2^-24]. The plain version
// (ops/kernels/fused_sample.py: sample_counters, philox_uniforms) states
// the same layout, so one seed gives one draw on the CPU and on the card,
// up to the rounding of logf, cosf, expf and the softmax's sum.
//
// Grid: one launch of 256-thread blocks, the Gumbel blocks first.
//   * Gumbel: one warp per row, 8 rows a block. Lane l owns groups l,
//     l + 32, ...; warp shuffles give the row's max and sum, so Dd = 10 and
//     Dd = 100 take one path. The logits of a lane's first group stay in
//     registers; where Dd is above 128 the later groups' logits are drawn
//     again from their counters in each pass rather than stored.
//   * Gaussian: one thread per pair of columns, with float2 loads and
//     stores where Dc and Dc + Dd are even and the pointers 8-byte aligned,
//     else scalar accesses (and an odd Dc's last pair of one column).
//   At (768, 128, 10): 96 Gumbel and 192 Gaussian blocks, 73,728 threads,
//   all resident at once on 132 SMs. Each thread starts its loads before
//   its Philox rounds. What is left above an empty launch is mostly the
//   loads, the stores and the Gumbel rows' shuffles, not the arithmetic
//   (PERF.md, scripts/torch_kernel_study.py sample).
//
// Arithmetic: the precise logf, cosf and expf. The fast __logf is off by up
// to 2^-21.4 near 1, more than log(1 - 2^-24) itself, so -2 log(u1) could
// turn negative and its square root NaN. z is rounded as the plain version
// rounds it (the product, then the sum: no FMA contraction).
//
// Plain C interface, loaded with ctypes: each launcher runs on the caller's
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr unsigned kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;  // round multipliers
constexpr unsigned kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;  // key increments
constexpr unsigned kGaussStream = 0u, kGumbelStream = 1u;  // counter word c1
constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;  // Gumbel: a warp a row
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kEps = 1e-12f;                 // sampling.GUMBEL_EPS
constexpr float kInv2To24 = 5.9604644775390625e-8f;  // 2^-24

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, unsigned k0,
                                               unsigned k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const unsigned hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const unsigned hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += kW0;
    k1 += kW1;
  }
  return c;
}

__device__ __forceinline__ float uniform(unsigned w) {
  return static_cast<float>(w >> 8) * kInv2To24;  // exact: 24 bits
}

__device__ __forceinline__ float gaussian(float mean, float log_sigma,
                                          unsigned w1, unsigned w2) {
  const float eps = sqrtf(-2.f * logf(uniform(w1) + kEps)) *
                    cosf(kTwoPi * uniform(w2));
  return __fadd_rn(mean, __fmul_rn(expf(log_sigma), eps));
}

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(static_cast<int>(0xff800000u));
}

struct Group {
  float v[4];
};

// The logits of Gumbel group q of a row (columns 4q .. 4q + 3), -inf past
// Dd. log_alpha is loaded before the Philox rounds, which hide its latency.
__device__ __forceinline__ Group group_logits(const float* __restrict__ la,
                                              int Dd, int q, unsigned row,
                                              unsigned seed,
                                              float temperature) {
  float alpha[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    alpha[k] = 4 * q + k < Dd ? __ldg(la + 4 * q + k) : 0.f;
  const uint4 w = philox4x32_10(
      make_uint4(static_cast<unsigned>(q), kGumbelStream, row, 0u), seed, 0u);
  const unsigned words[4] = {w.x, w.y, w.z, w.w};
  Group g;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float gumbel = -logf(-logf(uniform(words[k]) + kEps) + kEps);
    g.v[k] = 4 * q + k < Dd ? (alpha[k] + gumbel) / temperature : neg_inf();
  }
  return g;
}

__device__ __forceinline__ float group_max(const Group& g) {
  return fmaxf(fmaxf(g.v[0], g.v[1]), fmaxf(g.v[2], g.v[3]));
}

__device__ __forceinline__ float group_sum(const Group& g, float m) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) s += expf(g.v[k] - m);  // exp(-inf) = 0
  return s;
}

__device__ __forceinline__ void group_store(const Group& g, float m, float s,
                                            float* __restrict__ y, int Dd,
                                            int q) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (4 * q + k < Dd) y[4 * q + k] = expf(g.v[k] - m) / s;
}

// y of one row, by one warp
__device__ void gumbel_row(const float* __restrict__ log_alpha,
                           float* __restrict__ out, int Dc, int Dd,
                           unsigned row, unsigned seed, float temperature) {
  const int lane = threadIdx.x & 31;
  const int groups = (Dd + 3) / 4;
  const float* la = log_alpha + static_cast<size_t>(row) * Dd;
  float* y = out + static_cast<size_t>(row) * (Dc + Dd) + Dc;
  Group first;
  if (lane < groups) {
    first = group_logits(la, Dd, lane, row, seed, temperature);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) first.v[k] = neg_inf();
  }
  float m = group_max(first);
  for (int q = lane + 32; q < groups; q += 32)
    m = fmaxf(m, group_max(group_logits(la, Dd, q, row, seed, temperature)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float s = group_sum(first, m);
  for (int q = lane + 32; q < groups; q += 32)
    s += group_sum(group_logits(la, Dd, q, row, seed, temperature), m);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane < groups) group_store(first, m, s, y, Dd, lane);
  for (int q = lane + 32; q < groups; q += 32)
    group_store(group_logits(la, Dd, q, row, seed, temperature), m, s, y, Dd,
                q);
}

// z of one pair of columns (one column where it is an odd Dc's last). The
// loads start before the Philox rounds, which hide their latency.
__device__ __forceinline__ void gaussian_pair(
    const float* __restrict__ mean, const float* __restrict__ log_sigma,
    float* __restrict__ out, int Dc, int Dd, int pairs, long long p,
    unsigned seed, bool vec) {
  const unsigned row = static_cast<unsigned>(p / pairs);
  const int j = static_cast<int>(p - static_cast<long long>(row) * pairs);
  const int c = 2 * j;
  const bool two = c + 1 < Dc;
  const size_t in = static_cast<size_t>(row) * Dc + c;
  const size_t o = static_cast<size_t>(row) * (Dc + Dd) + c;
  float2 m, s;
  if (vec) {
    m = __ldg(reinterpret_cast<const float2*>(mean + in));
    s = __ldg(reinterpret_cast<const float2*>(log_sigma + in));
  } else {
    m = make_float2(__ldg(mean + in), two ? __ldg(mean + in + 1) : 0.f);
    s = make_float2(__ldg(log_sigma + in),
                    two ? __ldg(log_sigma + in + 1) : 0.f);
  }
  const uint4 w = philox4x32_10(
      make_uint4(static_cast<unsigned>(j), kGaussStream, row, 0u), seed, 0u);
  const float z0 = gaussian(m.x, s.x, w.x, w.y);
  const float z1 = gaussian(m.y, s.y, w.z, w.w);
  if (vec) {
    *reinterpret_cast<float2*>(out + o) = make_float2(z0, z1);
  } else {
    out[o] = z0;
    if (two) out[o + 1] = z1;
  }
}

__global__ void __launch_bounds__(kThreads)
fused_joint_sample_kernel(const float* __restrict__ mean,
                          const float* __restrict__ log_sigma,
                          const float* __restrict__ log_alpha,
                          float* __restrict__ out, int B, int Dc, int Dd,
                          int gumbel_blocks, unsigned seed, float temperature,
                          bool vec) {
  if (static_cast<int>(blockIdx.x) < gumbel_blocks) {
    const unsigned row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
    if (row < static_cast<unsigned>(B))  // the same for the whole warp
      gumbel_row(log_alpha, out, Dc, Dd, row, seed, temperature);
    return;
  }
  const int pairs = (Dc + 1) / 2;
  const long long p =
      static_cast<long long>(blockIdx.x - gumbel_blocks) * kThreads +
      threadIdx.x;
  if (p < static_cast<long long>(B) * pairs)
    gaussian_pair(mean, log_sigma, out, Dc, Dd, pairs, p, seed, vec);
}

__global__ void empty_kernel() {}

bool aligned8(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 8 == 0;
}

}  // namespace

// mean, log_sigma: (B, Dc); log_alpha: (B, Dd); out: (B, Dc + Dd); all f32,
// contiguous; B, Dc, Dd >= 1.
extern "C" int fused_joint_sample_f32(const float* mean,
                                      const float* log_sigma,
                                      const float* log_alpha, float* out,
                                      int B, int Dc, int Dd, unsigned seed,
                                      float temperature, void* stream) {
  if (B < 1 || Dc < 1 || Dd < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = Dc % 2 == 0 && (Dc + Dd) % 2 == 0 && aligned8(mean) &&
                   aligned8(log_sigma) && aligned8(out);
  const long long gumbel_blocks = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long pair_threads = static_cast<long long>(B) * ((Dc + 1) / 2);
  const long long blocks =
      gumbel_blocks + (pair_threads + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  fused_joint_sample_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      mean, log_sigma, log_alpha, out, B, Dc, Dd,
      static_cast<int>(gumbel_blocks), seed, temperature, vec);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel of `blocks` 256-thread blocks: the floor of one launch
extern "C" int fused_sample_empty(int blocks, void* stream) {
  empty_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
