// Fused eval-BN affine + LeakyReLU + 3x3 SAME convolution, stride 1, bf16
// on the tensor cores.
//
// Replaces the bf16 forward of fused_bn_act_conv (shotvae_tpu/ops/pallas/
// fused_conv.py:230, kernel _kernel :101, launched by _fwd_pallas :170):
//
//     y = bf16(conv3x3_SAME(bf16(leaky(x * scale[c] + shift[c])), w))
//
// x, w and y bf16; scale, shift f32; the affine and the activation in f32,
// rounded once to bf16 before the product (:113-115); f32 accumulation
// (:152); y rounded to bf16 (:154). The activated tensor never reaches
// device memory.
//
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s: about 295 flops
// per byte). Per output pixel it does 2*9*Cin*Cout flops against
// 2*(Cin + Cout) bytes of x in and y out. The C = 32 stage (32x32, 32->32)
// is at 144 flops per byte, and the 16->32 site at 96: bytes-bound. The
// 16x16 C = 64 stage is at 288, about the line. The 8x8 C = 128 stage is
// at 576: operations-bound.
//
// Design (implicit GEMM, one pass, mma.sync):
//   * a block owns an 8x8 tile of output pixels of one image (M = 64) by
//     BN output channels (BN = 32 or 64), with 4 warps; warp w owns the
//     tile rows 2w and 2w+1, i.e. one m16 row block, by all BN channels;
//   * for each chunk of CK = 16 input channels (one k16 step per tap) it
//     stages the activated 10x10 halo tile once in shared memory, 16 bytes
//     (8 bf16 channels) per load, applying the affine + LeakyReLU in f32
//     and rounding to bf16 while staging. A halo position outside the image
//     is stored as 0 AFTER the activation: SAME padding pads the activated
//     tensor, not x. Channels past Cin are stored as 0;
//   * it stages the chunk's (9, CK, BN) weights beside it, from the
//     (9*Cin, Cout) matrix the wrapper reorders once per call;
//   * each tap (dy, dx) is one m16n8k16 product per n8 tile:
//     `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`. ldmatrix takes
//     one row address per lane, so the A fragment of a tap is read straight
//     from the staged halo tile at the shifted window (no im2col copy); the
//     B fragments come from the staged weights with ldmatrix.trans;
//   * shared-memory rows are padded by 16 bytes so that the 8 rows of each
//     ldmatrix fall in distinct bank groups.
// Not here yet: wgmma, TMA, warp specialisation, double buffering of the
// chunks and larger tiles (the weights are staged again by every block).
// Measured on the card, the staging and the products each take about half
// of the time and do not overlap within a block; two tiles per block with
// double-buffered chunks, or four m16 blocks per warp (fewer ldmatrix per
// product, more registers), did not beat this form by enough to keep. The
// next form overlaps them: producer warps stage, consumer warps multiply.
//
// Plain C interface, loaded with ctypes: the launcher runs on the caller's
// stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int TILE = 8;              // output tile edge, pixels
constexpr int HALO = TILE + 2;       // staged input tile edge
constexpr int POS = HALO * HALO;     // staged positions
constexpr int CK = 16;               // input channels staged per chunk (k16)
constexpr int IN_PITCH = CK + 8;     // bf16 per staged position (48 bytes)
constexpr int NT = 128;              // 4 warps

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// leaky(v * s + h) in f32, with the product and the sum rounded separately
// (no FMA contraction), as the plain version computes it
__device__ __forceinline__ float act(float v, float s, float h, float slope) {
  const float pre = __fadd_rn(__fmul_rn(v, s), h);
  return pre > 0.f ? pre : __fmul_rn(slope, pre);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BN>
__global__ void __launch_bounds__(NT)
fused_bn_act_conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                                 const float* __restrict__ scale,
                                 const float* __restrict__ shift,
                                 const __nv_bfloat16* __restrict__ w,
                                 __nv_bfloat16* __restrict__ y, int H, int W,
                                 int Cin, int Cout, int tiles_x,
                                 int tiles_per_image, float slope) {
  constexpr int W_PITCH = BN + 8;  // bf16 per staged weight row
  constexpr int NB = BN / 8;       // n8 tiles per warp
  __shared__ __align__(16) __nv_bfloat16 in_s[POS * IN_PITCH];
  __shared__ __align__(16) __nv_bfloat16 w_s[9 * CK * W_PITCH];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / tiles_per_image;
  const int t = blockIdx.x % tiles_per_image;
  const int y0 = (t / tiles_x) * TILE;
  const int x0 = (t % tiles_x) * TILE;
  const int n0 = blockIdx.y * BN;
  const __nv_bfloat16* xb = x + static_cast<size_t>(b) * H * W * Cin;

  // ldmatrix row addresses of this lane. A (x4): matrix lane/8 holds rows
  // 0-7 / 8-15 of the m16 block at k 0-7 / 8-15, so the lane's row is
  // lane & 15, a pixel of tile row 2*warp + row/8, column row % 8, and its
  // k offset 8 * (lane >> 4). B (x4.trans over k16 x n16): k row
  // (lane & 7) + 8 * ((lane >> 3) & 1), n offset 8 * (lane >> 4).
  const int a_row = lane & 15;
  const int a_pos = (2 * warp + (a_row >> 3)) * HALO + (a_row & 7);
  const int a_k = 8 * (lane >> 4);
  const int b_k = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int b_n = 8 * (lane >> 4);

  float acc[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += CK) {
    // activated halo tile, 8 channels (16 bytes of NHWC x) per load
    for (int i = tid; i < POS * (CK / 8); i += NT) {
      const int q = i % (CK / 8), p = i / (CK / 8);
      const int iy = y0 + p / HALO - 1, ix = x0 + p % HALO - 1;
      const int ci = c0 + 8 * q;
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (iy >= 0 && iy < H && ix >= 0 && ix < W && ci < Cin) {
        const uint4 raw = load16(xb + (static_cast<size_t>(iy) * W + ix) * Cin + ci);
        const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float4 s0 = load4(scale + ci), s1 = load4(scale + ci + 4);
        const float4 h0 = load4(shift + ci), h1 = load4(shift + ci + 4);
        const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
        const float sh[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
        __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 v = __bfloat1622float2(xv[e]);
          out[e] = __floats2bfloat162_rn(
              act(v.x, sc[2 * e], sh[2 * e], slope),
              act(v.y, sc[2 * e + 1], sh[2 * e + 1], slope));
        }
      }
      *reinterpret_cast<uint4*>(&in_s[p * IN_PITCH + 8 * q]) = packed;
    }
    // weights: w is (9*Cin, Cout), row tap*Cin + ci; staged as [tap][k][n]
    for (int i = tid; i < 9 * CK * NB; i += NT) {
      const int q = i % NB, r = i / NB;  // r = tap * CK + k
      const int k = r % CK, tap = r / CK;
      const int ci = c0 + k, co = n0 + 8 * q;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (ci < Cin && co < Cout)
        v = load16(w + (static_cast<size_t>(tap) * Cin + ci) * Cout + co);
      *reinterpret_cast<uint4*>(&w_s[r * W_PITCH + 8 * q]) = v;
    }
    __syncthreads();

#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        uint32_t a[4];
        ldmatrix_x4(a, &in_s[(a_pos + dy * HALO + dx) * IN_PITCH + a_k]);
        const __nv_bfloat16* wt = &w_s[((dy * 3 + dx) * CK + b_k) * W_PITCH + b_n];
#pragma unroll
        for (int j = 0; j < NB; j += 2) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, wt + 8 * j);
          mma_bf16(acc[j], a, bf[0], bf[1]);
          mma_bf16(acc[j + 1], a, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();
  }

  // accumulator e of n8 tile j: row lane/4 (+8 for e >= 2) of the warp's
  // m16 block, channel 2*(lane%4) (+1 for odd e)
  const int ox = x0 + (lane >> 2);
  if (ox >= W) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int oy = y0 + 2 * warp + half;
    if (oy >= H) continue;
    __nv_bfloat16* dst = y + ((static_cast<size_t>(b) * H + oy) * W + ox) * Cout;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int co = n0 + 8 * j + 2 * (lane & 3);
      if (co < Cout)
        *reinterpret_cast<__nv_bfloat162*>(dst + co) = __floats2bfloat162_rn(
            acc[j][2 * half], acc[j][2 * half + 1]);
    }
  }
}

}  // namespace

// x: (B, H, W, Cin) bf16; scale, shift: (Cin,) f32; w: (9*Cin, Cout) bf16;
// y: (B, H, W, Cout) bf16. Cin and Cout must be multiples of 8 and every
// pointer 16-byte aligned (16-byte loads).
extern "C" int fused_bn_act_conv3x3_bf16(const void* x, const float* scale,
                                         const float* shift, const void* w,
                                         void* y, int B, int H, int W,
                                         int Cin, int Cout, float slope,
                                         void* stream) {
  const int tiles_x = (W + TILE - 1) / TILE;
  const int tiles_per_image = tiles_x * ((H + TILE - 1) / TILE);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  if (Cout <= 32) {
    dim3 grid(B * tiles_per_image, (Cout + 31) / 32);
    fused_bn_act_conv3x3_bf16_kernel<32><<<grid, NT, 0, s>>>(
        xb, scale, shift, wb, yb, H, W, Cin, Cout, tiles_x, tiles_per_image,
        slope);
  } else {
    dim3 grid(B * tiles_per_image, (Cout + 63) / 64);
    fused_bn_act_conv3x3_bf16_kernel<64><<<grid, NT, 0, s>>>(
        xb, scale, shift, wb, yb, H, W, Cin, Cout, tiles_x, tiles_per_image,
        slope);
  }
  return static_cast<int>(cudaGetLastError());
}
