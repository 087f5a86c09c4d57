// Fused eval-BN affine + LeakyReLU + 3x3 SAME convolution, stride 1, f32.
//
// Replaces the forward of fused_bn_act_conv (shotvae_tpu/ops/pallas/
// fused_conv.py:230, kernel _kernel :101, launched by _fwd_pallas :170):
//
//     y = conv3x3_SAME(leaky(x * scale[c] + shift[c]), w)
//
// with the activated tensor never written to device memory.
//
// What bounds it on the H100: operations. A WRN unit's conv at batch 768
// does 2*9*Cin*Cout flops per output pixel against 4*(Cin+Cout) bytes of
// input and output, 48 to 288 flops per byte in f32, above the line of
// 67 TFLOP/s (f32, no tensor cores) over 3.35 TB/s = 20 flops per byte.
//
// Design (direct convolution, one pass):
//   * a block owns an 8x8 tile of output pixels of one image by BN output
//     channels (BN = 32 or 64);
//   * for each chunk of CK input channels it stages the 10x10 input tile
//     (the 8x8 tile and its 1-pixel halo) into shared memory, applying the
//     affine + LeakyReLU while staging. A halo position outside the image
//     is stored as 0 AFTER the activation: SAME padding pads the activated
//     tensor, not x (the TPU kernel masks after activating, :115-150);
//   * it stages the chunk's (9, CK, BN) weights beside it;
//   * each thread owns one output column of the tile (8 pixels) by TN
//     output channels: for each channel and each dx it reads the 10-pixel
//     input column once into registers and reuses it over the 3 dy taps,
//     so a thread issues 30 + 9*TN/4 shared-memory loads per 72*TN FMAs;
//   * staging moves 16 bytes per load (4 channels of x, 4 output channels
//     of w), with the index arithmetic on powers of two.
// f32 in, f32 accumulate. wgmma, TMA and bf16 are later work. The staged
// input is kept channel-major ([c][position]) so that the 8 threads of a
// tile row read 8 neighbouring words.
//
// Plain C interface, loaded with ctypes: the launcher runs on the caller's
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TILE = 8;          // output tile edge, pixels
constexpr int HALO = TILE + 2;   // staged input tile edge
constexpr int POS = HALO * HALO; // staged positions per channel
constexpr int POS_PITCH = 101;   // odd pitch: the transposed stores spread over banks
constexpr int CK = 16;           // input channels staged per step
constexpr int TN = 4;            // output channels per thread

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float leaky(float v, float slope) {
  return v > 0.f ? v : slope * v;
}

template <int BN>
__global__ void __launch_bounds__(TILE * (BN / TN))
fused_bn_act_conv3x3_kernel(const float* __restrict__ x,
                            const float* __restrict__ scale,
                            const float* __restrict__ shift,
                            const float* __restrict__ w,
                            float* __restrict__ y, int H, int W, int Cin,
                            int Cout, int tiles_x, int tiles_per_image,
                            float slope) {
  constexpr int NT = TILE * (BN / TN);
  constexpr int CK4 = CK / 4, BN4 = BN / 4;
  __shared__ float in_s[CK * POS_PITCH];
  __shared__ __align__(16) float w_s[9 * CK * BN];

  const int tid = threadIdx.x;
  const int tx = tid % TILE;  // output column within the tile
  const int tn = tid / TILE;  // output channel group
  const int b = blockIdx.x / tiles_per_image;
  const int t = blockIdx.x % tiles_per_image;
  const int y0 = (t / tiles_x) * TILE;
  const int x0 = (t % tiles_x) * TILE;
  const int n0 = blockIdx.y * BN;
  const float* xb = x + static_cast<size_t>(b) * H * W * Cin;

  float acc[TILE][TN];
#pragma unroll
  for (int r = 0; r < TILE; ++r)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[r][j] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += CK) {
    // activated input tile, 4 channels (16 bytes of NHWC x) per load
    for (int i = tid; i < POS * CK4; i += NT) {
      const int q = i % CK4, p = i / CK4;
      const int iy = y0 + p / HALO - 1, ix = x0 + p % HALO - 1;
      const int ci = c0 + 4 * q;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (iy >= 0 && iy < H && ix >= 0 && ix < W && ci < Cin) {
        const float4 xv = load4(xb + (static_cast<size_t>(iy) * W + ix) * Cin + ci);
        const float4 sc = load4(scale + ci), sh = load4(shift + ci);
        v = make_float4(leaky(xv.x * sc.x + sh.x, slope),
                        leaky(xv.y * sc.y + sh.y, slope),
                        leaky(xv.z * sc.z + sh.z, slope),
                        leaky(xv.w * sc.w + sh.w, slope));
      }
      float* dst = in_s + 4 * q * POS_PITCH + p;
      dst[0] = v.x;
      dst[POS_PITCH] = v.y;
      dst[2 * POS_PITCH] = v.z;
      dst[3 * POS_PITCH] = v.w;
    }
    // weights: w is (9*Cin, Cout), row tap*Cin + ci; staged as [tap][c][n]
    for (int i = tid; i < 9 * CK * BN4; i += NT) {
      const int q = i % BN4, r = i / BN4;  // r = tap * CK + c
      const int c = r % CK, tap = r / CK;
      const int ci = c0 + c, co = n0 + 4 * q;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ci < Cin && co < Cout)
        v = load4(w + (static_cast<size_t>(tap) * Cin + ci) * Cout + co);
      *reinterpret_cast<float4*>(&w_s[r * BN + 4 * q]) = v;
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < CK; ++c) {
      const float* col_base = in_s + c * POS_PITCH + tx;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float col[HALO];
#pragma unroll
        for (int r = 0; r < HALO; ++r) col[r] = col_base[r * HALO + dx];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          float wv[TN];
#pragma unroll
          for (int j = 0; j < TN; j += 4) {
            const float4 w4 = *reinterpret_cast<const float4*>(
                &w_s[((dy * 3 + dx) * CK + c) * BN + tn * TN + j]);
            wv[j] = w4.x;
            wv[j + 1] = w4.y;
            wv[j + 2] = w4.z;
            wv[j + 3] = w4.w;
          }
#pragma unroll
          for (int r = 0; r < TILE; ++r)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[r][j] += col[r + dy] * wv[j];
        }
      }
    }
    __syncthreads();
  }

  const int ox = x0 + tx;
  if (ox >= W) return;
#pragma unroll
  for (int r = 0; r < TILE; ++r) {
    const int oy = y0 + r;
    if (oy >= H) continue;
    float* dst = y + ((static_cast<size_t>(b) * H + oy) * W + ox) * Cout;
#pragma unroll
    for (int j = 0; j < TN; j += 4) {
      const int co = n0 + tn * TN + j;
      if (co < Cout)
        *reinterpret_cast<float4*>(dst + co) = make_float4(
            acc[r][j], acc[r][j + 1], acc[r][j + 2], acc[r][j + 3]);
    }
  }
}

}  // namespace

// x: (B, H, W, Cin) f32; scale, shift: (Cin,); w: (9*Cin, Cout);
// y: (B, H, W, Cout). Cin and Cout must be multiples of 4 and every
// pointer 16-byte aligned (float4 loads and stores).
extern "C" int fused_bn_act_conv3x3_f32(const float* x, const float* scale,
                                        const float* shift, const float* w,
                                        float* y, int B, int H, int W,
                                        int Cin, int Cout, float slope,
                                        void* stream) {
  const int tiles_x = (W + TILE - 1) / TILE;
  const int tiles_per_image = tiles_x * ((H + TILE - 1) / TILE);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cout <= 32) {
    dim3 grid(B * tiles_per_image, (Cout + 31) / 32);
    fused_bn_act_conv3x3_kernel<32><<<grid, TILE * (32 / TN), 0, s>>>(
        x, scale, shift, w, y, H, W, Cin, Cout, tiles_x, tiles_per_image,
        slope);
  } else {
    dim3 grid(B * tiles_per_image, (Cout + 63) / 64);
    fused_bn_act_conv3x3_kernel<64><<<grid, TILE * (64 / TN), 0, s>>>(
        x, scale, shift, w, y, H, W, Cin, Cout, tiles_x, tiles_per_image,
        slope);
  }
  return static_cast<int>(cudaGetLastError());
}
