// Fused eval-BN affine + LeakyReLU + 3x3 SAME convolution, stride 1, f32.
//
// Replaces the forward of fused_bn_act_conv (shotvae_tpu/ops/pallas/
// fused_conv.py:230, kernel _kernel :101, launched by _fwd_pallas :170):
//
//     y = conv3x3_SAME(leaky(x * scale[c] + shift[c]), w)
//
// with the activated tensor never written to device memory.
//
// What bounds it on the H100: operations. A conv at batch 768 does
// 2*9*Cin*Cout flops per output pixel against 4*(Cin+Cout) bytes of input
// and output, 48 to 1,152 flops per byte in f32, above the line of 67
// TFLOP/s (f32, no tensor cores) over 3.35 TB/s = 20 flops per byte. So
// the design keeps the FFMA pipes fed and spends few instructions on
// anything else.
//
// Design (an implicit GEMM over packed pixel rows):
//   * a block owns T = BM / WS whole image rows of the flattened (B*H, W)
//     pixel rows (WS = W rounded up to 4, at most MAX_WS and BM; wider rows
//     are cut into segments), so a 4x4 map packs 8 images (BM 128) or 16
//     (BM 256) into one tile and only the grid's last tile has idle rows;
//     by a slice of BN output channels. Grid: (row tiles x segments, N
//     slices);
//   * K = 9*Cin is walked in chunks of CK = 8 input channels, all 9 taps
//     of a chunk in one step. Each step's x rows (the tile's T rows, the
//     row above and below, one column each side) and its 9 x CK x BN
//     weights come in by cp.async (LDGSTS) through a ring of STAGES = 2
//     stages, zero-filled (src-size 0) outside the tensor or past Cin and
//     Cout; step k+1's copies are in flight while step k is multiplied.
//     Which 16-byte pieces a thread copies, and where their activated
//     values go, is the same for every step: it is worked out once;
//   * once a step's x rows have landed, the thread that copied each
//     4-channel piece applies x * scale + shift and leaky(., slope) to it,
//     ONCE for all 9 taps, and writes it, transposed to [k][position],
//     into one of two activated buffers laid out as padded image rows:
//     each row has a zero column at both ends and consecutive images are
//     separated by a zero row. A piece outside the image is written as 0
//     AFTER the activation: SAME pads the ACTIVATED tensor, and
//     leaky(0 * scale + shift) is not 0 (the TPU kernel masks after
//     activating, :115-150). So every tap of every output pixel reads its
//     input, or a padding zero, at a fixed shift, with no mask;
//   * 256 threads, each with RUNS runs of 4 neighbouring output pixels of
//     an image row (RUNS = 2, or 1 for maps too small to give the card
//     enough 2-run tiles) by TN = 4 output channels. For each k and each
//     tap row dy a thread reads the 6 activated inputs under each run (a
//     float4 and a float2) and reuses them over the 3 taps dx: per k, 6
//     reads of x a run and 9 float4 reads of weights per 9 x 16 FFMAs a
//     run. f32 products, f32 sums (FFMA, no TF32). Slices of 64 channels
//     give 128-pixel tiles (2 runs), slices of 32 (Cout <= 32) 256-pixel
//     ones; measured, wider thread tiles (8 channels) were no faster
//     overall and a 128 slice spilled registers
//     (scripts/torch_kernel_study.py f32);
//   * one __syncthreads() per step: after step k's products, the thread
//     waits for its own copies of step k+1, activates them into the other
//     activated buffer, and the block syncs.
// The launch plan (slice, runs, rows per tile, segment width, stages,
// shared-memory bytes, grid) is computed by conv_f32_plan() in
// ops/kernels/fused_conv.py; the launcher derives it again from the shape
// and refuses (-1) a plan that differs.
//
// Plain C interface, loaded with ctypes: the launcher runs on the caller's
// stream and returns cudaGetLastError() or -1.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int CK = 8;             // input channels per step
constexpr int STAGES = 2;         // cp.async ring depth
constexpr int THREADS = 256;
constexpr int TN = 4;             // output channels per thread
constexpr int MAX_PIECES = 4;     // 16-byte x pieces a thread copies a step
constexpr int MAX_WS = 124;       // widest row segment: keeps the pieces
                                  // of a step within MAX_PIECES * THREADS
constexpr int SMEM_LIMIT = 232448;  // shared memory a block can use

// The block's geometry, the same for every block of a launch.
struct Geometry {
  int H, W, Cin, Cout;
  int BH;       // B * H: flattened image rows
  int T;        // image rows per tile
  int WS;       // pixels of a row segment (a multiple of 4)
  int nseg;     // segments per row
  int NS;       // slots (padded rows) of an activated buffer
};

__host__ __device__ constexpr int pitch(int ws) { return ws + 4; }

// floats of each region of dynamic shared memory
__host__ __device__ constexpr int b_stage(int bn) { return 9 * CK * bn; }
__host__ __device__ constexpr int x_stage(int t, int ws) {
  return (t + 2) * (ws + 2) * CK;
}
__host__ __device__ constexpr int act_floats(int ns, int ws) {
  return CK * ns * pitch(ws);
}
__host__ __device__ constexpr int smem_floats(int bn, int t, int ws,
                                              int ns) {
  return STAGES * (b_stage(bn) + x_stage(t, ws)) + 2 * act_floats(ns, ws);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared through L2; src_bytes 0 fills them with zeros
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float leaky(float v, float slope) {
  return v > 0.f ? v : slope * v;
}

// floor(a / b) for a >= -b, b > 0
__device__ __forceinline__ int floordiv(int a, int b) {
  return (a + b) / b - 1;
}

template <int BN, int RUNS>
__global__ void __launch_bounds__(THREADS, 2)
fused_bn_act_conv3x3_kernel(const float* __restrict__ x,
                            const float* __restrict__ scale,
                            const float* __restrict__ shift,
                            const float* __restrict__ w,
                            float* __restrict__ y, const Geometry g,
                            float slope) {
  constexpr int NT = BN / TN;       // threads along N
  constexpr int MT = THREADS / NT;  // threads along M
  constexpr int WN = NT / 8;        // warps along N (8 threads each)
  constexpr int TM = 4 * RUNS;      // output pixels per thread
  static_assert(NT % 8 == 0 && THREADS % NT == 0, "bad register tile");

  const int RP = pitch(g.WS);
  const int XS = x_stage(g.T, g.WS);
  const int ACT = act_floats(g.NS, g.WS);
  extern __shared__ __align__(16) float smem[];
  float* b_s = smem;                          // [STAGES][9][CK][BN]
  float* x_s = b_s + STAGES * b_stage(BN);    // [STAGES][T+2][WS+2][CK]
  float* act = x_s + STAGES * XS;             // [2][CK][NS][RP]

  const int tid = threadIdx.x;
  const int g0 = (blockIdx.x / g.nseg) * g.T;   // first image row
  const int x0 = (blockIdx.x % g.nseg) * g.WS;  // first column
  const int n0 = blockIdx.y * BN;

  // padding: what no activation pass writes stays 0
  for (int i = tid; i < 2 * ACT; i += THREADS) act[i] = 0.f;

  const int nk = (g.Cin + CK - 1) / CK;
  const int b_first = floordiv(g0 - 1, g.H);  // image of row g0 - 1

  // The x pieces this thread copies and activates in every step: piece
  // i = tid + j * THREADS is channels 4 * (i % 2) .. + 3 of staged pixel
  // i / 2, at x row G = g0 - 1 + r and column ox = x0 - 1 + col. Per
  // piece: its pixel in x (-1 outside the image: zero-filled, activated
  // to 0) and its offset in an activated buffer: slot (padded row) r
  // plus the image boundaries crossed since row g0 - 1, column col.
  const int n_pieces = (g.T + 2) * (g.WS + 2) * (CK / 4);
  const int piece = tid % (CK / 4);
  int src_pix[MAX_PIECES], act_off[MAX_PIECES];
#pragma unroll
  for (int j = 0; j < MAX_PIECES; ++j) {
    const int pix = (tid + j * THREADS) / (CK / 4);
    const int r = pix / (g.WS + 2), col = pix % (g.WS + 2);
    const int G = g0 - 1 + r, ox = x0 - 1 + col;
    src_pix[j] = G >= 0 && G < g.BH && ox >= 0 && ox < g.W ? G * g.W + ox
                                                           : -1;
    act_off[j] = 4 * piece * g.NS * RP +
                 (r + floordiv(G, g.H) - b_first) * RP + col;
  }

  // The weight pieces this thread copies in every step: piece
  // i = tid + j * THREADS is output channels 4 * (i % (BN / 4)) .. + 3 of
  // weight row (tap, kk) = (i / (BN / 4)) / CK, % CK; per piece, its
  // offset in w at step 0 (-1 past Cout)
  constexpr int B_PIECES = 9 * CK * BN / 4;
  constexpr int MAX_B = (B_PIECES + THREADS - 1) / THREADS;
  int w_off[MAX_B], w_kk[MAX_B];
#pragma unroll
  for (int j = 0; j < MAX_B; ++j) {
    const int i = tid + j * THREADS;
    const int row = i / (BN / 4), co = n0 + 4 * (i % (BN / 4));
    w_kk[j] = row % CK;
    w_off[j] = co < g.Cout ? ((row / CK) * g.Cin + w_kk[j]) * g.Cout + co
                           : -1;
  }

  // step q's x pieces and its 9 x CK x BN weights, into stage q % STAGES
  auto issue = [&](int q) {
    if (q < nk) {
      const int ci = q * CK + 4 * piece;
      float* xd = x_s + (q % STAGES) * XS + 4 * tid;
#pragma unroll
      for (int j = 0; j < MAX_PIECES; ++j) {
        if (tid + j * THREADS >= n_pieces) break;
        const bool ok = src_pix[j] >= 0 && ci < g.Cin;
        const float* src =
            ok ? x + static_cast<long long>(src_pix[j]) * g.Cin + ci : x;
        cp_async(xd + 4 * j * THREADS, src, ok ? 16 : 0);
      }
      float* bd = b_s + (q % STAGES) * b_stage(BN) + 4 * tid;
      const int step_off = q * CK * g.Cout;
#pragma unroll
      for (int j = 0; j < MAX_B; ++j) {
        if (B_PIECES % THREADS && tid + j * THREADS >= B_PIECES) break;
        const bool ok = w_off[j] >= 0 && q * CK + w_kk[j] < g.Cin;
        cp_async(bd + 4 * j * THREADS, ok ? w + w_off[j] + step_off : w,
                 ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  // activate this thread's pieces of step q (landed) into activated
  // buffer q & 1; 0 outside the image, and past Cin (whose weights are 0)
  auto activate = [&](int q) {
    if (q >= nk) return;
    const int ci = q * CK + 4 * piece;
    const bool live = ci < g.Cin;
    const float4 sc = live ? __ldg(reinterpret_cast<const float4*>(scale +
                                                                   ci))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 sh = live ? __ldg(reinterpret_cast<const float4*>(shift +
                                                                   ci))
                           : sc;
    const float* xs = x_s + (q % STAGES) * XS + 4 * tid;
    float* dst = act + (q & 1) * ACT;
    const int k = g.NS * RP;
#pragma unroll
    for (int j = 0; j < MAX_PIECES; ++j) {
      if (tid + j * THREADS >= n_pieces) break;
      const bool in = live && src_pix[j] >= 0;
      const float4 v =
          *reinterpret_cast<const float4*>(xs + 4 * j * THREADS);
      float* d = dst + act_off[j];
      d[0] = in ? leaky(v.x * sc.x + sh.x, slope) : 0.f;
      d[k] = in ? leaky(v.y * sc.y + sh.y, slope) : 0.f;
      d[2 * k] = in ? leaky(v.z * sc.z + sh.z, slope) : 0.f;
      d[3 * k] = in ? leaky(v.w * sc.w + sh.w, slope) : 0.f;
    }
  };

  // this thread's tile: runs p = tm + r * MT of 4 pixels (tile row
  // p / (WS / 4), columns 4 * (p % (WS / 4)) + 0..3) by output channels
  // tn * 4 + 0..3 of the slice; a warp spans 4 tm by 8 tn
  const int warp = tid / 32, lane = tid % 32;
  const int tn = (warp % WN) * 8 + lane % 8;
  const int tm = (warp / WN) * 4 + lane / 8;
  const int runs_per_row = g.WS / 4;
  int run_t[RUNS], run_j[RUNS], a_off[RUNS];
#pragma unroll
  for (int r = 0; r < RUNS; ++r) {
    const int p = tm + r * MT;
    run_t[r] = p / runs_per_row;
    run_j[r] = 4 * (p % runs_per_row);
    // the run's slot; a run past the tile's rows reads row 0's (not stored)
    const int t = run_t[r] < g.T ? run_t[r] : 0;
    const int slot = t + 1 + floordiv(g0 + t, g.H) - b_first;
    a_off[r] = slot * RP + run_j[r];
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  issue(0);
  __syncthreads();  // the padding zeros
  cp_async_wait<0>();  // step 0 (this thread's copies)
  activate(0);
  __syncthreads();

  for (int k = 0; k < nk; ++k) {
    // into the stage of step k - 1, which every thread has multiplied
    issue(k + 1);
    const float* a_k = act + (k & 1) * ACT;
    const float* b_k = b_s + (k % STAGES) * b_stage(BN) + tn * 4;
#pragma unroll 2
    for (int kk = 0; kk < CK; ++kk) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float a[RUNS][6];
#pragma unroll
        for (int r = 0; r < RUNS; ++r) {
          const float* p = a_k + kk * g.NS * RP + a_off[r] + (dy - 1) * RP;
          const float4 v = *reinterpret_cast<const float4*>(p);
          const float2 u = *reinterpret_cast<const float2*>(p + 4);
          a[r][0] = v.x;
          a[r][1] = v.y;
          a[r][2] = v.z;
          a[r][3] = v.w;
          a[r][4] = u.x;
          a[r][5] = u.y;
        }
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 v = *reinterpret_cast<const float4*>(
              b_k + ((dy * 3 + dx) * CK + kk) * BN);
          const float b[TN] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int r = 0; r < RUNS; ++r)
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < TN; ++j)
                acc[4 * r + i][j] =
                    fmaf(a[r][i + dx], b[j], acc[4 * r + i][j]);
        }
      }
    }
    cp_async_wait<0>();  // step k + 1 (this thread's copies)
    activate(k + 1);
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < RUNS; ++r) {
    const int G = g0 + run_t[r];
    if (run_t[r] >= g.T || G >= g.BH) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ox = x0 + run_j[r] + i;
      if (ox >= g.W) continue;
      const int col = n0 + tn * 4;
      if (col < g.Cout)
        *reinterpret_cast<float4*>(
            y + (static_cast<long long>(G) * g.W + ox) * g.Cout + col) =
            make_float4(acc[4 * r + i][0], acc[4 * r + i][1],
                        acc[4 * r + i][2], acc[4 * r + i][3]);
    }
  }
}

template <int BN, int RUNS>
int launch(const float* x, const float* scale, const float* shift,
           const float* w, float* y, const Geometry& g, int smem_bytes,
           int grid_m, int grid_n, float slope, cudaStream_t s) {
  static bool attr = false;
  auto kernel = fused_bn_act_conv3x3_kernel<BN, RUNS>;
  if (!attr) {  // the launcher checked smem_bytes against this limit
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = true;
  }
  kernel<<<dim3(grid_m, grid_n), THREADS, smem_bytes, s>>>(x, scale, shift,
                                                           w, y, g, slope);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (B, H, W, Cin) f32; scale, shift: (Cin,); w: (9*Cin, Cout), rows
// [tap][ci]; y: (B, H, W, Cout). Cin and Cout must be multiples of 4,
// 9 * Cin * Cout and B * H * W under 2^31, and every pointer 16-byte
// aligned (16-byte copies and stores). The plan (bn, runs, rows per tile,
// segment width, stages, smem_bytes, grid_m, grid_n) is conv_f32_plan()'s;
// returns -1 where it is not the plan this launcher derives for the shape.
extern "C" int fused_bn_act_conv3x3_f32(const float* x, const float* scale,
                                        const float* shift, const float* w,
                                        float* y, int B, int H, int W,
                                        int Cin, int Cout, int bn, int runs,
                                        int rows, int ws, int stages,
                                        int smem_bytes, int grid_m,
                                        int grid_n, float slope,
                                        void* stream) {
  if (B < 1 || H < 1 || W < 1 || Cin < 4 || Cout < 4 || Cin % 4 ||
      Cout % 4 || (bn != 32 && bn != 64) || (runs != 1 && runs != 2) ||
      stages != STAGES || static_cast<long long>(B) * H * W >= INT_MAX ||
      9LL * Cin * Cout >= INT_MAX)
    return -1;
  const int bm = 4 * runs * THREADS / (bn / TN);  // pixels per tile
  Geometry g;
  g.H = H;
  g.W = W;
  g.Cin = Cin;
  g.Cout = Cout;
  g.BH = B * H;
  g.WS = (W + 3) / 4 * 4;
  if (g.WS > MAX_WS) g.WS = MAX_WS;
  if (g.WS > bm) g.WS = bm;
  g.T = bm / g.WS;
  g.nseg = (W + g.WS - 1) / g.WS;
  g.NS = g.T + 2 + (g.T + H) / H;
  const long long gm =
      static_cast<long long>((g.BH + g.T - 1) / g.T) * g.nseg;
  if (rows != g.T || ws != g.WS || gm != grid_m || gm > INT_MAX ||
      grid_n != (Cout + bn - 1) / bn || grid_n > 65535 ||
      (g.T + 2) * (g.WS + 2) * (CK / 4) > MAX_PIECES * THREADS ||
      smem_bytes != 4 * smem_floats(bn, g.T, g.WS, g.NS) ||
      smem_bytes > SMEM_LIMIT)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 32)
    return runs == 1 ? launch<32, 1>(x, scale, shift, w, y, g, smem_bytes,
                                     grid_m, grid_n, slope, s)
                     : launch<32, 2>(x, scale, shift, w, y, g, smem_bytes,
                                     grid_m, grid_n, slope, s);
  return runs == 1 ? launch<64, 1>(x, scale, shift, w, y, g, smem_bytes,
                                   grid_m, grid_n, slope, s)
                   : launch<64, 2>(x, scale, shift, w, y, g, smem_bytes,
                                   grid_m, grid_n, slope, s);
}
