// Fused eval-BN affine + LeakyReLU + 3x3 SAME convolution, stride 1, bf16
// on Hopper's warpgroup tensor cores.
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
// Design (implicit GEMM, persistent, warp-specialised, wgmma):
//   * a work item is two 8x8 tiles of output pixels (M = 64 each, one
//     wgmma row block) by one slice of BN = 32 or 64 output channels. About
//     one block per SM walks a static list: block j owns slice j % n_slices
//     and every (grid / n_slices)-th tile from j / n_slices, two at a time
//     (any two, so an 8x8 image wastes nothing);
//   * the block's weight slice is loaded once, by TMA, and stays in shared
//     memory for all its tiles. The weight is read as it lies: a
//     channels_last (Cout, Cin, 3, 3) tensor is the K-major (Cout, 9*Cin)
//     matrix wgmma takes as B (K = tap * Cin + ci). It is stored in 8x8
//     core matrices ([k8][n][8 k]: one TMA box of 8 k by BN rows per k8),
//     with no swizzle. Where the slice does not fit beside the rings (Cin
//     above 320, e.g. WRN-28-10's 640), it is streamed instead: each
//     stage also holds the 9 * CC x BN weights of its chunk ([tap][k8][n]
//     [8 k]), which the producer loads once the consumer has released the
//     stage; the stage's operand is complete when the activation warps and
//     that load have all arrived;
//   * the items go through two rings of stages, by item parity; each ring
//     has one activation warpgroup and one consumer warpgroup, which walk
//     it in order, so no mbarrier wait can see a stage two rounds early
//     (the parity of a phase would alias);
//   * a producer warp loads each tile's raw x halo, (CC channels, 10, 10)
//     per chunk of CC input channels, with one 4-D TMA over NHWC x into the
//     item's ring (mbarrier completion). The map's zero fill covers the
//     image border and channels past Cin;
//   * the ring's activation warpgroup turns a raw stage into the activated
//     operand stage: x * scale + shift and LeakyReLU in f32,
//     rounded once to bf16 (the exact rounding of act() below), and 0 at
//     halo positions outside the image AFTER the activation (SAME pads the
//     activated tensor: the TMA's zero fill is x = 0, and
//     leaky(0 * scale + shift) is not 0). It stores the no-swizzle
//     core-matrix layout [k8][halo][halo row][halo col][8 ch], in which
//     every shifted 8x8 window starts 16-byte aligned;
//   * the ring's consumer warpgroup, for each tap (dy, dx) and k16 step,
//     takes one B descriptor at the resident weights and, per tile, an A
//     descriptor at the shifted window (SBO = one halo row, LBO = one k8
//     plane): two `wgmma.mma_async` m64nBNk16 into f32 registers, 18 * CC
//     / 16 per chunk. Its epilogue writes bf16 y into swizzled shared
//     memory and one TMA store per tile (which clips the image border and
//     channels past Cout). Where Cout is not a multiple of 8 (DenseNet-BC
//     100's growth rate of 12), no TMA map can describe y, whose rows are
//     then not 16-byte strided: the epilogue stores each accumulator to
//     device memory itself, clipped to the image and to Cout (`direct`).
//     While one consumer runs its products or its epilogue, the other
//     runs its own, the activation warpgroups prepare the next stages and
//     the producer loads ahead;
//   * `setmaxnreg` moves registers from the producer and activation
//     warpgroups to the consumers, in one if/else on the warpgroup whose
//     paths never rejoin.
// Measured (scripts/torch_kernel_study.py conv): in a first form one
// activation warpgroup set the time (compiling it out cut 40 %), and an
// activation warp spends few issue slots: a chunk's latency (barrier
// waits, shared loads, the proxy fence) set the rate. Hence two activation
// warpgroups, each thread's shared loads issued before its arithmetic, two
// tiles per item (half the hand-offs per pixel), the TMA-store epilogue,
// and rings as deep as the shared memory left beside the weights allows
// (up to 8 stages in all). In this form the y path, the activation and the
// products each add about a quarter of the time; none sets it alone.
// A wait on a pipeline barrier that takes more than about 8 seconds traps
// (a launch error) instead of hanging the card.
//
//
// A second work item, packed whole images (fused_bn_act_conv3x3_bf16_
// kernel_packed), for the deep stages. The tiled item above was made for
// WRN-28-2's wide maps and narrow channels; at preactresnet18's 256 and
// 512 channels on 8x8 and 4x4 maps it does the same work in the worst way
// (H100, batch 768, scripts/torch_kernel_study.py):
//   * 4x4 maps, Cin 512: one image fills 16 of an 8x8 tile's 64 rows (75 %
//     of the products idle) and a 10x10 halo is staged and activated for
//     16 pixels; no 64-channel weight slice (590 KB) fits, so it streams
//     again for every item: 3,072 items x 590 KB = 1.81 GB read from L2 a
//     launch, for a conv of 12.6 MB. 0.938 ms a launch against a bound of
//     0.0586 (operations) and F.conv2d's 0.0955;
//   * 8x8 maps, Cin 256: no resident 64-wide slice fits, so slices of 32:
//     each x chunk is loaded, activated and staged 8 times, once a slice,
//     and each product is m64n32, where reading A costs as much as the
//     product. About 0.40 ms.
// The packed item is 128 output pixels of whole images packed one after
// another (8 images of 4x4, 2 of 8x8; a band of rows of one image where
// an image has more than 128 pixels) by a slice of BN = 128 output
// channels (32 or 64 where Cout is small), with K streamed:
//   * M: a row of the products is an output pixel, and the A operand
//     comes from registers, loaded by ldmatrix with one row address a
//     pixel: each tap's shifted window is other addresses into the same
//     activated halos, so any packing of small images fills every row.
//     Inside an image its even rows go first, then its odd ones, so the 8
//     rows of each ldmatrix matrix fall in 8 banks at 4x4 (the halo's
//     pitch is 6);
//   * x: one 4-D TMA box a chunk of 64 input channels, the item's halos
//     ((H + 2) x (W + 2) an image, 128B-swizzled, one 128-byte row a
//     position), activated in place once by an activation warpgroup and
//     read by every tap and every output channel of the slice;
//   * weights: a stage is one (chunk, tap): 64 k by BN rows, one TMA box
//     (128B-swizzled; the B descriptor steps 32 bytes a k16), loaded once
//     an item and read by all its 128 rows. Weight bytes from L2 at 4x4 /
//     512: 384 items x 1.18 MB = 0.45 GB a launch (from 1.81);
//   * two consumer warpgroups take rows 0-63 and 64-127 of every item
//     (m64nBNk16, f32 accumulators); a producer warp each for x and for
//     the weights, so neither waits behind the other's ring;
//   * the epilogue stores y from registers, clipped to the items' pixels
//     and to Cout; where Cout is a multiple of 8, the 4 lanes of a row
//     trade their bf16 pairs first (a 4x4 transpose by two xor shuffles)
//     and store 16 bytes each.
// BN stops at 128: an m64n256 accumulator needs more than the 128
// registers a thread of a 512-thread block has to compile. Measured in
// this form: 512 -> 512 at 4x4 0.103 ms, 256 at 8x8 0.093 (F.conv2d 0.097
// and 0.091; bound 0.0586 each). Learned on the way: ring indices by
// division cost about 600 cycles a step (now counters); 4-byte stores of
// y took a third of the launch (now 16-byte stores); releasing an x stage
// at its last ldmatrix, before the products that read those registers
// were done, let its next chunk overwrite it under them (now released
// once they are done); and each warp converges again (__syncwarp) after a
// barrier wait or a lane-0 arrival, before its next .aligned instruction.
//
// The launch plan (N slices, chunk channels, ring stages, resident or
// streamed weights, shared-memory bytes, grid) is computed by conv_plan()
// in ops/kernels/fused_conv.py and passed in; the launcher recomputes the
// layout and refuses a plan that does not match it; for the packed item
// (slice width, images and rows an item, x and weight stages,
// shared-memory bytes, grid) by packed_plan(). The three TMA tensor
// maps are encoded on the host, each kept in a small per-thread cache
// keyed by everything it encodes, so a call whose tensors sit where an
// earlier call's did encodes none.
//
// Plain C interface, loaded with ctypes: the launcher runs on the caller's
// stream and returns cudaGetLastError(), or a negative code for a refused
// plan (-1), a missing driver entry point (-2) or a refused tensor map (-3).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <mutex>

namespace {

constexpr int TILE = 8;                      // output tile edge, pixels
constexpr int HALO = TILE + 2;               // input halo edge
constexpr int POS = HALO * HALO;             // halo positions
constexpr int TPI = 2;                       // 8x8 tiles per work item
// one k8 plane of an operand stage: the halos of the item's tiles, one
// after the other, and a spare position so that neighbouring planes fall
// in other banks
constexpr int PLANE_BYTES = (TPI * POS + 1) * 16;
constexpr int ACT_WARPS = 4;   // an activation warpgroup stages a chunk
constexpr int NTHREADS = 640;  // consumers 0-1, activation 2-3, producer 4
constexpr int MAX_SMEM = 232448;
constexpr long long TRAP_CYCLES = 1ll << 34;

__host__ __device__ constexpr int align128(int v) { return (v + 127) / 128 * 128; }

// Dynamic shared memory, in bytes: the same arithmetic as conv_plan().
// Resident weights: w_bytes for the slice, no per-stage weights; streamed:
// ws_bytes of a chunk's weights in every stage instead
struct Layout {
  int y_bytes, w_bytes, ws_bytes, raw_sub, raw_bytes, act_bytes, w_off,
      raw_off, act_off, ws_off, bar_off, total;
};

__host__ __device__ inline Layout layout(int cin_pad, int bn, int cc,
                                         int stages, bool stream) {
  Layout L;
  L.y_bytes = 2 * TPI * TILE * TILE * bn * 2;  // y staging, per consumer
  L.w_bytes = stream ? 0 : 9 * cin_pad * bn * 2;
  L.ws_bytes = stream ? 9 * cc * bn * 2 : 0;
  L.raw_sub = cc * POS * 2;  // one tile's raw halo chunk
  L.raw_bytes = TPI * L.raw_sub;
  L.act_bytes = align128(cc / 8 * PLANE_BYTES);
  L.w_off = L.y_bytes;  // a multiple of 1024, as the y swizzle needs
  L.raw_off = align128(L.w_off + L.w_bytes);
  L.act_off = L.raw_off + stages * L.raw_bytes;
  L.ws_off = L.act_off + stages * L.act_bytes;
  L.bar_off = L.ws_off + stages * L.ws_bytes;
  L.total = L.bar_off + 8 * (1 + 4 * stages);
  return L;
}

// leaky(v * s + h) in f32, with the product and the sum rounded separately
// (no FMA contraction), as the plain version computes it
__device__ __forceinline__ float act(float v, float s, float h, float slope) {
  const float pre = __fadd_rn(__fmul_rn(v, s), h);
  return pre > 0.f ? pre : __fmul_rn(slope, pre);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// one arrival for the warp, by lane 0, with the warp converged before and
// after (so that the .aligned instructions that follow see all its lanes)
__device__ __forceinline__ void arrive_warp(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
  __syncwarp();
}

// wait until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > TRAP_CYCLES) {
      __trap();
    }
  }
}

// ------------------------------------------------------------------ TMA

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the shared memory of every committed TMA store has been read
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// a barrier of the 128 threads of one warpgroup (id 1 + the warpgroup)
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// ---------------------------------------------------------------- wgmma

// shared-memory matrix descriptor, no swizzle (layout type 0): start, the
// leading byte offset (between the two k8 core matrices of a k16 step) and
// the stride byte offset (between 8-row groups of M or N), in 16-byte units
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// the layout-type field of a descriptor of a 128B-swizzled operand: 8-row
// groups of 128-byte rows, 16-byte chunk c of row r at c ^ (r % 8)
constexpr uint64_t DESC_SWIZZLE_128B = 1ull << 62;

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (+)= A * B, m64n32k16, A and B K-major in shared memory, f32 D
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// keep the compiler from moving or reusing an A fragment's registers
// while products that read it may run
__device__ __forceinline__ void fence_frag(uint32_t (&f)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(f[j][q])::"memory");
}

// D (+)= A * B, m64n64k16
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <int BN>
__device__ __forceinline__ void wgmma_bn(float (&d)[BN / 2], uint64_t a,
                                         uint64_t b, int accumulate) {
  if constexpr (BN == 32) {
    wgmma_n32(d, a, b, accumulate);
  } else {
    wgmma_n64(d, a, b, accumulate);
  }
}

// D (+)= A * B, m64n32k16, A from registers (ldmatrix), B K-major in
// shared memory, f32 D
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D (+)= A * B, m64n64k16, A from registers (ldmatrix), B K-major in
// shared memory, f32 D
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D (+)= A * B, m64n128k16, A from registers (ldmatrix), B K-major in
// shared memory, f32 D
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <int BN>
__device__ __forceinline__ void wgmma_rs(float (&d)[BN / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  if constexpr (BN == 32) {
    wgmma_rs_n32(d, a, b, accumulate);
  } else if constexpr (BN == 64) {
    wgmma_rs_n64(d, a, b, accumulate);
  } else {
    wgmma_rs_n128(d, a, b, accumulate);
  }
}

__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// four 8x8 b16 matrices from shared memory, one 16-byte row address a lane:
// lanes 8q..8q+7 give matrix q's rows, register q holds its fragment
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// ---------------------------------------------------------------- kernel

struct Geometry {
  int H, W, Cin, Cout, cin_pad, tiles_x, tiles_per_image, tiles, n_slices,
      stages, stream, direct;
};

template <int BN, int CC>
__global__ void __launch_bounds__(NTHREADS, 1)
fused_bn_act_conv3x3_bf16_kernel(const __grid_constant__ CUtensorMap x_map,
                                 const __grid_constant__ CUtensorMap w_map,
                                 const float* __restrict__ scale,
                                 const float* __restrict__ shift,
                                 const __grid_constant__ CUtensorMap y_map,
                                 __nv_bfloat16* __restrict__ y,
                                 const Geometry g, float slope) {
  constexpr int Q = CC / 8;  // 16-byte channel groups of a position
  extern __shared__ __align__(1024) uint8_t smem[];
  const Layout L = layout(g.cin_pad, BN, CC, g.stages, g.stream);
  const int S = g.stages;
  const uint32_t y_s = smem_u32(smem), w_s = y_s + L.w_off;
  const uint32_t raw_s = y_s + L.raw_off, act_s = y_s + L.act_off;
  const uint32_t ws_s = y_s + L.ws_off, bars = y_s + L.bar_off;
  // barriers: weights, raw full/empty, operand full/empty, 8 bytes each
  const uint32_t w_full = bars;
  const uint32_t raw_full = bars + 8, raw_empty = raw_full + 8 * S;
  const uint32_t act_full = raw_empty + 8 * S, act_empty = act_full + 8 * S;

  const int slice = blockIdx.x % g.n_slices;
  const int stride = gridDim.x / g.n_slices;
  const int first = blockIdx.x / g.n_slices;
  // the block's tiles are first + k * stride; item i holds its tiles
  // TPI * i .. TPI * i + TPI - 1
  const int n_tiles = first < g.tiles ? (g.tiles - first + stride - 1) / stride
                                      : 0;
  const int n_items = (n_tiles + TPI - 1) / TPI;
  const int chunks = g.cin_pad / CC;
  const int n0 = slice * BN;
  // Two rings of S / 2 stages: item it's chunks go through ring it % 2,
  // which one activation warpgroup and one consumer walk in order, so no
  // wait can see a stage two rounds early. Chunk k of item it: stage s of
  // the ring's buffers and its round there
  auto ring_slot = [&](int it, int k, int& s, int& round) {
    const int m = (it >> 1) * chunks + k;  // its place in its ring
    s = (it & 1) * (S / 2) + m % (S / 2);
    round = m / (S / 2);
  };
  // image and origin of the block's k-th tile
  auto tile = [&](int k, int& b, int& y0, int& x0) {
    const int t = first + k * stride;
    const int r = t % g.tiles_per_image;
    b = t / g.tiles_per_image;
    y0 = (r / g.tiles_x) * TILE;
    x0 = (r % g.tiles_x) * TILE;
  };

  if (threadIdx.x == 0) {
    mbar_init(w_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(raw_full + 8 * s, 1);   // the producer's expect_tx
      mbar_init(raw_empty + 8 * s, ACT_WARPS);  // one per staging warp
      // the staging warps and, streamed, the producer's weight expect_tx
      mbar_init(act_full + 8 * s, ACT_WARPS + (g.stream ? 1 : 0));
      mbar_init(act_empty + 8 * s, 1);  // the consuming warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 4) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 4 * 128) {
      if (!g.stream) {
        mbar_expect_tx(w_full, L.w_bytes);
        for (int p = 0; p < 9 * g.cin_pad / 8; ++p)
          tma_load_2d(w_s + p * BN * 16, &w_map, w_full, 8 * p, n0);
      }
      for (int it = 0; it < n_items; ++it) {
        const int n_sub = min(TPI, n_tiles - TPI * it);
        for (int k = 0; k < chunks; ++k) {
          int s, round;
          ring_slot(it, k, s, round);
          mbar_wait(raw_empty + 8 * s, (round & 1) ^ 1);
          mbar_expect_tx(raw_full + 8 * s, n_sub * L.raw_sub);
          for (int u = 0; u < n_sub; ++u) {
            int b, y0, x0;
            tile(TPI * it + u, b, y0, x0);
            tma_load_4d(raw_s + s * L.raw_bytes + u * L.raw_sub, &x_map,
                        raw_full + 8 * s, k * CC, x0 - 1, y0 - 1, b);
          }
          if (g.stream) {
            // the chunk's weights, rows tap * cin_pad + k * CC + 8q, once
            // the consumer has released the stage's last round
            mbar_wait(act_empty + 8 * s, (round & 1) ^ 1);
            mbar_expect_tx(act_full + 8 * s, L.ws_bytes);
            for (int p = 0; p < 9 * Q; ++p)
              tma_load_2d(ws_s + s * L.ws_bytes + p * BN * 16, &w_map,
                          act_full + 8 * s,
                          (p / Q) * g.cin_pad + k * CC + 8 * (p % Q), n0);
          }
        }
      }
    }
  } else if (wg >= 2) {
    // ----------------------------------------------------- activation
    // warpgroup 2 stages ring 0 (the even items), 3 ring 1 (the odd)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 88;\n" ::: "memory");
    const int ring = wg - 2;
    const int tid = threadIdx.x % 128;
    const int grp = tid % Q;  // this thread's channel group (Q divides 128)
    // index i = tid + 128 * n covers channel group grp of position
    // p = i / Q = tid / Q + n * (128 / Q) of the item's TPI halos
    constexpr int NPOS = TPI * POS, STEP = 128 / Q;
    constexpr int ITERS = (NPOS + STEP - 1) / STEP, BATCH = 4;
    for (int it = ring; it < n_items; it += 2) {
      const int n_sub = min(TPI, n_tiles - TPI * it);
      int ty[TPI], tx[TPI];
#pragma unroll
      for (int u = 0; u < TPI; ++u) {
        int b;
        tile(TPI * it + u, b, ty[u], tx[u]);
      }
      for (int k = 0; k < chunks; ++k) {
        int s, round;
        ring_slot(it, k, s, round);
        const int ci = k * CC + 8 * grp;
        const bool live = ci < g.Cin;  // Cin is a multiple of 8
        float sc[8], sh[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          sc[e] = live ? __ldg(scale + ci + e) : 0.f;
          sh[e] = live ? __ldg(shift + ci + e) : 0.f;
        }
        mbar_wait(raw_full + 8 * s, round & 1);
        mbar_wait(act_empty + 8 * s, (round & 1) ^ 1);
        const uint8_t* raw = smem + L.raw_off + s * L.raw_bytes + 16 * grp;
        uint8_t* opnd = smem + L.act_off + s * L.act_bytes + grp * PLANE_BYTES;
#pragma unroll
        for (int n0b = 0; n0b < ITERS; n0b += BATCH) {
          uint4 v[BATCH];  // a batch's loads issued before its arithmetic
          bool in[BATCH];
#pragma unroll
          for (int n = 0; n < BATCH; ++n) {
            const int p = tid / Q + (n0b + n) * STEP;
            const int u = p >= POS, lp = p - u * POS;
            const int iy = (u ? ty[1] : ty[0]) + lp / HALO - 1;
            const int ix = (u ? tx[1] : tx[0]) + lp % HALO - 1;
            in[n] = live && p < NPOS && u < n_sub && iy >= 0 && iy < g.H &&
                    ix >= 0 && ix < g.W;
            v[n] = in[n] ? *reinterpret_cast<const uint4*>(raw + p * CC * 2)
                         : make_uint4(0u, 0u, 0u, 0u);
          }
#pragma unroll
          for (int n = 0; n < BATCH; ++n) {
            const int p = tid / Q + (n0b + n) * STEP;
            if (n0b + n >= ITERS || p >= NPOS) continue;
            uint4 packed = make_uint4(0u, 0u, 0u, 0u);
            if (in[n]) {
              const __nv_bfloat162* xv =
                  reinterpret_cast<const __nv_bfloat162*>(&v[n]);
              __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float2 f = __bfloat1622float2(xv[e]);
                out[e] = __floats2bfloat162_rn(
                    act(f.x, sc[2 * e], sh[2 * e], slope),
                    act(f.y, sc[2 * e + 1], sh[2 * e + 1], slope));
              }
            }
            *reinterpret_cast<uint4*>(opnd + p * 16) = packed;
          }
        }
        // generic-proxy stores, read next by wgmma (the async proxy)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncwarp();
        if (tid % 32 == 0) {
          mbar_arrive(raw_empty + 8 * s);
          mbar_arrive(act_full + 8 * s);
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 128;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    float acc[TPI][BN / 2];
#pragma unroll
    for (int u = 0; u < TPI; ++u)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[u][i] = 0.f;
    if (!g.stream) mbar_wait(w_full, 0);
    // k8 planes between two taps' weights: the whole slice's K resident,
    // one chunk's streamed
    const int w_tap = g.stream ? Q : g.cin_pad / 8;
    for (int it = wg; it < n_items; it += 2) {  // ring wg
      const int n_sub = min(TPI, n_tiles - TPI * it);
      for (int k = 0; k < chunks; ++k) {
        int s, round;
        ring_slot(it, k, s, round);
        mbar_wait(act_full + 8 * s, round & 1);
        const uint32_t a_s = act_s + s * L.act_bytes;
        // the chunk's tap-0 weights: in the resident slice, or the stage's
        const uint32_t w_k =
            g.stream ? ws_s + s * L.ws_bytes : w_s + k * Q * BN * 16;
#pragma unroll
        for (int u = 0; u < TPI; ++u) fence_acc(acc[u]);
        wgmma_fence();
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int dy = tap / 3, dx = tap % 3;
#pragma unroll
          for (int j = 0; j < CC / 16; ++j) {
            // B: weight rows tap * cin_pad + k * CC + 16j, 16 of them; A,
            // for each tile u: the 8x8 window at (dy, dx) of its halo,
            // channels 16j..16j+15 of the chunk
            const int k8 = tap * w_tap + 2 * j;
            const uint64_t db = desc(w_k + k8 * BN * 16, BN * 16, 128);
            // both tiles always: a tile past the block's last is staged
            // as zeros and not stored (no branch around a wgmma)
#pragma unroll
            for (int u = 0; u < TPI; ++u) {
              const uint64_t da = desc(
                  a_s + 2 * j * PLANE_BYTES + (u * POS + dy * HALO + dx) * 16,
                  PLANE_BYTES, HALO * 16);
              wgmma_bn<BN>(acc[u], da, db, (k | tap | j) != 0);
            }
          }
        }
        wgmma_commit();
        wgmma_wait0();
#pragma unroll
        for (int u = 0; u < TPI; ++u) fence_acc(acc[u]);
        if (tid == 0) mbar_arrive(act_empty + 8 * s);
      }
      // epilogue. Accumulator 4j + 2h + e of tile u: pixel 8 * (2 * warp +
      // h) + lane / 4 of the tile, channel 8j + 2 * (lane % 4) + e of the
      // slice. Direct: each to y itself, clipped to the image and Cout
      if (g.direct) {
        for (int u = 0; u < n_sub; ++u) {
          int b, y0, x0;
          tile(TPI * it + u, b, y0, x0);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int P = 8 * (2 * warp + h) + (lane >> 2);
            const int py = y0 + P / TILE, px = x0 + P % TILE;
            if (py >= g.H || px >= g.W) continue;
            __nv_bfloat16* row =
                y + ((static_cast<size_t>(b) * g.H + py) * g.W + px) * g.Cout;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int c = n0 + 8 * j + 2 * (lane & 3) + e;
                if (c < g.Cout)
                  row[c] = __float2bfloat16_rn(acc[u][4 * j + 2 * h + e]);
              }
            }
          }
        }
        continue;
      }
      // Else bf16 y through shared memory and a TMA store per tile, which
      // clips the image border and channels past Cout. The staging
      // tile is [pixel][BN channels] with the TMA's 128-byte (BN = 64) or
      // 64-byte (BN = 32) swizzle: 16-byte chunk j of pixel P at j ^ (P % 8)
      // or j ^ (P / 2 % 4), so the 8 pixels of a store fall in other banks
      if (tid == 0) bulk_wait_read();  // the previous item's stores
      warpgroup_sync(1 + wg);
      const uint32_t stage_y = y_s + wg * TPI * TILE * TILE * BN * 2;
#pragma unroll
      for (int u = 0; u < TPI; ++u) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int P = 8 * (2 * warp + h) + (lane >> 2);
          const int swz = BN == 64 ? P & 7 : (P >> 1) & 3;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const __nv_bfloat162 pair = __floats2bfloat162_rn(
                acc[u][4 * j + 2 * h], acc[u][4 * j + 2 * h + 1]);
            const uint32_t addr = stage_y + (u * TILE * TILE + P) * BN * 2 +
                                  ((j ^ swz) << 4) + 4 * (lane & 3);
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
                         "r"(*reinterpret_cast<const uint32_t*>(&pair))
                         : "memory");
          }
        }
      }
      // generic-proxy stores, read next by the TMA (the async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      warpgroup_sync(1 + wg);
      if (tid == 0) {
        for (int u = 0; u < n_sub; ++u) {
          int b, y0, x0;
          tile(TPI * it + u, b, y0, x0);
          tma_store_4d(&y_map, stage_y + u * TILE * TILE * BN * 2, n0, x0,
                       y0, b);
        }
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait();
  }
}

// ------------------------------------------------- packed whole images
//
// The second work item (see the header): PK_ROWS output pixels of whole
// images packed one after another (or a band of rows of one image) by a
// slice of BN output channels, K streamed in chunks of (tap, 64 input
// channels). One x box a chunk, its halos activated in place; one weight
// box a (chunk, tap); the A operand from registers by ldmatrix, one row
// address an output pixel.

constexpr int PK_THREADS = 512;  // consumers 0-1, activation 2, producers 3
constexpr int PK_ROWS = 128;     // output pixels of an item, 64 a consumer
constexpr int PK_CC = 64;        // input channels of a chunk: 128 bytes
constexpr int PK_CONSUMER_WARPS = 8;

__host__ __device__ constexpr int align1024(int v) {
  return (v + 1023) / 1024 * 1024;
}

// Dynamic shared memory of the packed kernel, in bytes: the same arithmetic
// as packed_smem_bytes() in ops/kernels/fused_conv.py. x stages of the
// item's halos, one 128-byte row (64 channels) a position; weight stages
// of bn rows of 64 k (128 bytes); both 128B-swizzled; the barriers
struct PackedLayout {
  int x_bytes, w_bytes, w_off, bar_off, total;
};

__host__ __device__ inline PackedLayout packed_layout(int bn, int images,
                                                      int rows, int W,
                                                      int x_stages,
                                                      int w_stages) {
  PackedLayout L;
  L.x_bytes = align1024(images * (rows + 2) * (W + 2) * 128);
  L.w_bytes = PK_CC * bn * 2;
  L.w_off = x_stages * L.x_bytes;
  L.bar_off = L.w_off + w_stages * L.w_bytes;
  L.total = L.bar_off + 8 * (3 * x_stages + 2 * w_stages);
  return L;
}

// a ring's next stage and the parity of its phase there, advanced without
// a division
struct Ring {
  int stage = 0, phase = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

struct PackedGeometry {
  int B, H, W, Cin, Cout, images, rows, bands, n_slices, items, chunks,
      x_stages, w_stages;
};

// The output pixel of row m of an item: image im of the item, row py of
// the image (or band), column px. Images one after another; inside one,
// its even rows, then its odd rows, so that the 8 rows of each ldmatrix
// matrix lie in 8 banks at a 4x4 map (halo pitch 6; rows 2 apart are 12
// positions apart, 4 mod 8)
__device__ __forceinline__ void packed_pixel(const PackedGeometry& g, int m,
                                             int& im, int& py, int& px) {
  const int per_image = g.rows * g.W;
  im = m / per_image;
  const int r = m - im * per_image;
  const int q = r / g.W, evens = (g.rows + 1) / 2;
  px = r - q * g.W;
  py = q < evens ? 2 * q : 2 * (q - evens) + 1;
}

template <int BN>
__global__ void __launch_bounds__(PK_THREADS, 1)
fused_bn_act_conv3x3_bf16_kernel_packed(
    const __grid_constant__ CUtensorMap x_map,
    const __grid_constant__ CUtensorMap w_map,
    const float* __restrict__ scale, const float* __restrict__ shift,
    __nv_bfloat16* __restrict__ y, const PackedGeometry g, float slope) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const PackedLayout L =
      packed_layout(BN, g.images, g.rows, g.W, g.x_stages, g.w_stages);
  const int XS = g.x_stages, WS = g.w_stages;
  const uint32_t x_s = smem_u32(smem), w_s = x_s + L.w_off;
  // barriers, 8 bytes each: x full (the TMA), activated (the activation
  // warps), empty (the consumer warps); weights full, empty
  const uint32_t x_full = x_s + L.bar_off, x_act = x_full + 8 * XS;
  const uint32_t x_empty = x_act + 8 * XS, w_full = x_empty + 8 * XS;
  const uint32_t w_empty = w_full + 8 * WS;
  const int pitch = g.W + 2;              // halo positions of a row
  const int halo = (g.rows + 2) * pitch;  // of an image (or band)
  const int n_pos = g.images * halo;      // of an item
  const int n_items = static_cast<int>(blockIdx.x) < g.items
                          ? (g.items - 1 - blockIdx.x) / gridDim.x + 1
                          : 0;
  // the block's i-th item: its first image and row, its first channel
  auto item = [&](int i, int& b0, int& y0, int& n0) {
    const int t = blockIdx.x + i * gridDim.x;
    const int mb = t / g.n_slices;
    n0 = (t - mb * g.n_slices) * BN;
    b0 = mb / g.bands * g.images;
    y0 = mb % g.bands * g.rows;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < XS; ++s) {
      mbar_init(x_full + 8 * s, 1);  // the producer's expect_tx
      mbar_init(x_act + 8 * s, ACT_WARPS);
      mbar_init(x_empty + 8 * s, PK_CONSUMER_WARPS);
    }
    for (int s = 0; s < WS; ++s) {
      mbar_init(w_full + 8 * s, 1);
      mbar_init(w_empty + 8 * s, PK_CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 3) {
    // ------------------------------------------------------ producers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int t = threadIdx.x % 128;
    if (t == 0) {
      // x: one 4-D box a chunk, the item's images (or band) with their
      // halos; the map's zero fill covers borders, channels past Cin and
      // images past B
      Ring r;
      for (int i = 0; i < n_items; ++i) {
        int b0, y0, n0;
        item(i, b0, y0, n0);
        for (int k = 0; k < g.chunks; ++k, r.next(XS)) {
          mbar_wait(x_empty + 8 * r.stage, r.phase ^ 1);
          mbar_expect_tx(x_full + 8 * r.stage, n_pos * 128);
          tma_load_4d(x_s + r.stage * L.x_bytes, &x_map,
                      x_full + 8 * r.stage, k * PK_CC, -1, y0 - 1, b0);
        }
      }
    } else if (t == 32) {
      // weights: a (chunk, tap) stage, one box of BN rows of 64 k (128
      // bytes, 128B-swizzled), zero past cin_pad and Cout
      Ring r;
      for (int i = 0; i < n_items; ++i) {
        int b0, y0, n0;
        item(i, b0, y0, n0);
        for (int k = 0; k < g.chunks; ++k) {
          for (int tap = 0; tap < 9; ++tap, r.next(WS)) {
            mbar_wait(w_empty + 8 * r.stage, r.phase ^ 1);
            mbar_expect_tx(w_full + 8 * r.stage, L.w_bytes);
            tma_load_3d(w_s + r.stage * L.w_bytes, &w_map,
                        w_full + 8 * r.stage, k * PK_CC, tap, n0);
          }
        }
      }
    }
  } else if (wg == 2) {
    // ----------------------------------------------------- activation
    // In place: each 16-byte group of 8 channels of a position becomes
    // bf16(leaky(x * scale + shift)), 0 outside the image. The TMA's 128B
    // swizzle put channel group c of position p at 16-byte slot c ^ (p % 8)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 80;\n" ::: "memory");
    const int tid = threadIdx.x - 256;
    const int grp = tid & 7;     // this thread's channel group
    const int first = tid >> 3;  // and first position; 16 a pass
    constexpr int BATCH = 4;
    Ring r;
    for (int i = 0; i < n_items; ++i) {
      int b0, y0, n0;
      item(i, b0, y0, n0);
      const int images = min(g.images, g.B - b0);
      // bit n: position first + 16n lies inside an image (at most 64 of
      // them: the launcher takes at most 1024 positions an item)
      uint64_t inside = 0;
      for (int n = 0, p = first; p < n_pos; ++n, p += 16) {
        const int im = p / halo, rest = p - im * halo;
        const int hy = rest / pitch, hx = rest - hy * pitch;
        const int iy = y0 + hy - 1;
        if (im < images && hx >= 1 && hx <= g.W && iy >= 0 && iy < g.H)
          inside |= 1ull << n;
      }
      for (int k = 0; k < g.chunks; ++k, r.next(XS)) {
        const int ci = k * PK_CC + 8 * grp;
        const bool live = ci < g.Cin;  // Cin is a multiple of 8
        const uint64_t in_mask = live ? inside : 0;
        float sc[8], sh[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          sc[e] = live ? __ldg(scale + ci + e) : 0.f;
          sh[e] = live ? __ldg(shift + ci + e) : 0.f;
        }
        mbar_wait(x_full + 8 * r.stage, r.phase);
        uint8_t* stage = smem + r.stage * L.x_bytes;
        for (int p0 = first, nb = 0; p0 < n_pos;
             p0 += 16 * BATCH, nb += BATCH) {
          uint4 v[BATCH];  // a batch's loads issued before its arithmetic
          bool in[BATCH];
#pragma unroll
          for (int u = 0; u < BATCH; ++u) {
            const int p = p0 + 16 * u;
            in[u] = p < n_pos && ((in_mask >> (nb + u)) & 1);
            v[u] = in[u] ? *reinterpret_cast<const uint4*>(
                               stage + p * 128 + ((grp ^ (p & 7)) << 4))
                         : make_uint4(0u, 0u, 0u, 0u);
          }
#pragma unroll
          for (int u = 0; u < BATCH; ++u) {
            const int p = p0 + 16 * u;
            if (p >= n_pos) continue;
            uint4 packed = make_uint4(0u, 0u, 0u, 0u);
            if (in[u]) {
              const __nv_bfloat162* xv =
                  reinterpret_cast<const __nv_bfloat162*>(&v[u]);
              __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float2 f = __bfloat1622float2(xv[e]);
                out[e] = __floats2bfloat162_rn(
                    act(f.x, sc[2 * e], sh[2 * e], slope),
                    act(f.y, sc[2 * e + 1], sh[2 * e + 1], slope));
              }
            }
            *reinterpret_cast<uint4*>(stage + p * 128 +
                                      ((grp ^ (p & 7)) << 4)) = packed;
          }
        }
        // generic-proxy stores, overwritten next by the TMA (async proxy)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncwarp();
        if (tid % 32 == 0) mbar_arrive(x_act + 8 * r.stage);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    // consumer wg takes rows 64 * wg .. 64 * wg + 63 of every item
    asm volatile("setmaxnreg.inc.sync.aligned.u32 192;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    // this lane's ldmatrix row (output pixel of the item) and k8 half:
    // lanes 8q..8q+7 address matrix q, rows 0-7 / 8-15, k 0-7 / 8-15
    const int row = 64 * wg + 16 * warp + (lane & 15);
    const int half = lane >> 4;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    uint32_t fa[4][4], fb[4][4];  // a tap's A fragments, two in turn
    Ring rx, rw;                  // the next chunk's x and tap's weights
    int w_last = 0, x_last = 0;   // the last step's weight and x stages
    for (int i = 0; i < n_items; ++i) {
      int b0, y0, n0;
      item(i, b0, y0, n0);
      // the halo position of this lane's pixel at tap (0, 0); a row past
      // the item's pixels reads position 0 and is not stored
      int pos0 = 0;
      {
        int im, py, px;
        packed_pixel(g, row, im, py, px);
        if (im < g.images && b0 + im < g.B && y0 + py < g.H)
          pos0 = im * halo + py * pitch + px;
      }
      // one (chunk, tap) step: the tap's A fragments into f, its 4 k16
      // products; the item's first product overwrites the accumulators.
      // The products read f after they are issued: fp, the previous
      // step's fragments, stays live until its products are done, so the
      // compiler gives f other registers
      auto step = [&](int tap, bool first, uint32_t (&f)[4][4],
                      uint32_t (&fp)[4][4]) {
        const int pos = pos0 + (tap / 3) * pitch + tap % 3;
        const uint32_t a_row = x_s + rx.stage * L.x_bytes + pos * 128;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ldmatrix_x4(f[j], a_row + (((2 * j + half) ^ (pos & 7)) << 4));
        // every lane converged again before each .aligned instruction
        // (ldmatrix, wgmma)
        mbar_wait(w_full + 8 * rw.stage, rw.phase);
        __syncwarp();
        // B: the stage's BN rows of 128 bytes, 128B-swizzled (8-row
        // groups 1024 bytes apart); k16 step j starts 32j bytes in
        const uint32_t b = w_s + rw.stage * L.w_bytes;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wgmma_rs<BN>(acc, f[j],
                       desc(b + 32 * j, 16, 1024) | DESC_SWIZZLE_128B,
                       !first || j > 0);
        wgmma_commit();
        wgmma_wait1();  // the previous step's products are done
        fence_acc(acc);
        fence_frag(fp);
        if (!first) {
          arrive_warp(w_empty + 8 * w_last, lane);
          // the previous chunk's last products are done: its x stage is
          // free (released no earlier: released at its last ldmatrix, the
          // stage was seen overwritten under products still to run)
          if (tap == 0) arrive_warp(x_empty + 8 * x_last, lane);
        }
        w_last = rw.stage;
        rw.next(WS);
      };
      // a chunk's 9 taps, their fragments in f0, f1, f0, ..., f0; so a
      // fragment is loaded again only after the products that read it are
      // done on every path (else ptxas serialises the products)
      auto chunk = [&](bool first, uint32_t (&f0)[4][4],
                       uint32_t (&f1)[4][4]) {
        mbar_wait(x_act + 8 * rx.stage, rx.phase);
        __syncwarp();
        step(0, first, f0, f1);
        step(1, false, f1, f0);
        step(2, false, f0, f1);
        step(3, false, f1, f0);
        step(4, false, f0, f1);
        step(5, false, f1, f0);
        step(6, false, f0, f1);
        step(7, false, f1, f0);
        step(8, false, f0, f1);
        x_last = rx.stage;
        rx.next(XS);
      };
      for (int k = 0; k + 1 < g.chunks; k += 2) {
        chunk(k == 0, fa, fb);
        chunk(false, fb, fa);
      }
      if (g.chunks & 1) chunk(g.chunks == 1, fa, fb);
      wgmma_wait0();
      fence_acc(acc);
      fence_frag(fa);
      fence_frag(fb);
      arrive_warp(w_empty + 8 * w_last, lane);
      arrive_warp(x_empty + 8 * x_last, lane);
      // epilogue: accumulator 4j + 2h + e is row 64 * wg + 16 * warp + 8h +
      // lane / 4 of the item, channel n0 + 8j + 2 * (lane % 4) + e; each
      // to y itself, clipped to the item's pixels and to Cout. Where Cout
      // is a multiple of 8, the 4 lanes of a row first trade their bf16
      // pairs (a 4x4 transpose by two xor shuffles), so that each stores
      // 8 channels, 16 bytes, at once: 4-byte stores of half sectors
      // measured a third of the launch (scripts/torch_kernel_study.py
      // conv, ablation 8)
      const int t = lane & 3;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int im, py, px;
        packed_pixel(g, 64 * wg + 16 * warp + 8 * h + (lane >> 2), im, py,
                     px);
        const bool ok = im < g.images && b0 + im < g.B && y0 + py < g.H;
        __nv_bfloat16* out =
            y + (ok ? ((static_cast<size_t>(b0 + im) * g.H + y0 + py) * g.W +
                       px) * g.Cout
                    : 0);
        if (g.Cout % 8 == 0) {
#pragma unroll
          for (int q = 0; q < BN / 32; ++q) {
            // v[i]: this lane's pair of 8-channel group 4q + i
            uint32_t v[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const __nv_bfloat162 pair =
                  __floats2bfloat162_rn(acc[4 * (4 * q + i) + 2 * h],
                                        acc[4 * (4 * q + i) + 2 * h + 1]);
              v[i] = *reinterpret_cast<const uint32_t*>(&pair);
            }
#pragma unroll
            for (int i = 0; i < 4; i += 2) {  // lanes t, t ^ 1
              const uint32_t got = __shfl_xor_sync(
                  0xffffffffu, (t & 1) ? v[i] : v[i + 1], 1);
              v[i] = (t & 1) ? got : v[i];
              v[i + 1] = (t & 1) ? v[i + 1] : got;
            }
#pragma unroll
            for (int i = 0; i < 2; ++i) {  // lanes t, t ^ 2
              const uint32_t got = __shfl_xor_sync(
                  0xffffffffu, (t & 2) ? v[i] : v[i + 2], 2);
              v[i] = (t & 2) ? got : v[i];
              v[i + 2] = (t & 2) ? v[i + 2] : got;
            }
            // now lane t holds the pairs of all 4 lanes for group 4q + t
            const int c = n0 + 32 * q + 8 * t;
            if (ok && c < g.Cout)
              *reinterpret_cast<uint4*>(out + c) =
                  make_uint4(v[0], v[1], v[2], v[3]);
          }
          continue;
        }
        if (!ok) continue;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int c = n0 + 8 * j + 2 * t;
          const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if (g.Cout % 2 == 0) {
            if (c < g.Cout)
              *reinterpret_cast<__nv_bfloat162*>(out + c) =
                  __floats2bfloat162_rn(v0, v1);
          } else {
            if (c < g.Cout) out[c] = __float2bfloat16_rn(v0);
            if (c + 1 < g.Cout) out[c + 1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------------ host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime: no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &status);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &status);
#endif
    if (status == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// An encoded tensor map and what it encodes: the base address, the rank
// and swizzle, and the dims, box and strides
struct MapEntry {
  uint64_t key[14];
  CUtensorMap map;
  bool used;
};
// direct-mapped entries: a bf16 train step makes 88 launches of 3 maps
constexpr int MAP_CACHE = 256;
std::mutex map_mutex;
MapEntry map_cache[MAP_CACHE];

// a bf16 tensor map of `base`, taken from the cache where one with the same
// key was encoded before; false where the driver refuses it
bool encode_bf16(EncodeTiled encode, CUtensorMap* map, const void* base,
                 int rank, const cuuint64_t* dims, const cuuint64_t* strides,
                 const cuuint32_t* box,
                 CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  uint64_t key[14] = {};
  key[0] = reinterpret_cast<uint64_t>(base);
  key[1] = static_cast<uint64_t>(rank) * 16 + static_cast<uint64_t>(swizzle);
  for (int i = 0; i < rank; ++i) {
    key[2 + i] = dims[i];
    key[6 + i] = box[i];
  }
  for (int i = 0; i + 1 < rank; ++i) key[10 + i] = strides[i];
  uint64_t h = 1469598103934665603ull;  // FNV-1a over the key's words
  for (uint64_t v : key) h = (h ^ v) * 1099511628211ull;
  std::lock_guard<std::mutex> lock(map_mutex);
  MapEntry& e = map_cache[h % MAP_CACHE];
  if (e.used && std::memcmp(e.key, key, sizeof key) == 0) {
    *map = e.map;
    return true;
  }
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
             const_cast<void*>(base), dims, strides, box, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  std::memcpy(e.key, key, sizeof key);
  e.map = *map;
  e.used = true;
  return true;
}

template <int BN, int CC>
int launch(const CUtensorMap& x_map, const CUtensorMap& w_map,
           const CUtensorMap& y_map, const float* scale, const float* shift,
           void* y, const Geometry& g, int smem_bytes, int grid, float slope,
           cudaStream_t stream) {
  static bool attr = false;
  auto kernel = fused_bn_act_conv3x3_bf16_kernel<BN, CC>;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = true;
  }
  kernel<<<grid, NTHREADS, smem_bytes, stream>>>(
      x_map, w_map, scale, shift, y_map, static_cast<__nv_bfloat16*>(y), g,
      slope);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_packed(const CUtensorMap& x_map, const CUtensorMap& w_map,
                  const float* scale, const float* shift, void* y,
                  const PackedGeometry& g, int smem_bytes, int grid,
                  float slope, cudaStream_t stream) {
  static bool attr = false;
  auto kernel = fused_bn_act_conv3x3_bf16_kernel_packed<BN>;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = true;
  }
  kernel<<<grid, PK_THREADS, smem_bytes, stream>>>(
      x_map, w_map, scale, shift, static_cast<__nv_bfloat16*>(y), g, slope);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (B, H, W, Cin) bf16; scale, shift: (Cin,) f32; w: the K-major (Cout,
// 9 * cin_pad) bf16 matrix, row co = [ky][kx][ci] with input channels padded
// with zeros to cin_pad; y: (B, H, W, Cout) bf16. Cin a multiple of 8 (the
// TMA's 16-byte row stride of x), any Cout (the epilogue stores directly
// where Cout is not a multiple of 8), every pointer 16-byte aligned.
// (cin_pad, bn, cc, stages, streamed, smem_bytes, grid) is conv_plan()'s
// launch plan; streamed is 1 where the weights go through the stages
// rather than stay resident.
extern "C" int fused_bn_act_conv3x3_bf16(const void* x, const float* scale,
                                         const float* shift, const void* w,
                                         void* y, int B, int H, int W,
                                         int Cin, int Cout, int cin_pad,
                                         int bn, int cc, int stages,
                                         int streamed, int smem_bytes,
                                         int grid,
                                         float slope, void* stream) {
  Geometry g;
  g.H = H, g.W = W, g.Cin = Cin, g.Cout = Cout, g.cin_pad = cin_pad;
  g.tiles_x = (W + TILE - 1) / TILE;
  g.tiles_per_image = g.tiles_x * ((H + TILE - 1) / TILE);
  g.tiles = B * g.tiles_per_image;
  g.n_slices = (Cout + bn - 1) / bn;
  g.stages = stages;
  g.stream = streamed != 0;
  g.direct = Cout % 8 != 0;
  const bool plan_ok =
      B > 0 && H > 0 && W > 0 && Cin > 0 && Cin % 8 == 0 && Cout > 0 &&
      (bn == 32 || bn == 64) &&
      (cc == 16 || cc == 32 || cc == 64) && cin_pad % 16 == 0 &&
      cin_pad >= Cin && cin_pad - Cin < 16 && cin_pad % cc == 0 &&
      stages >= 2 && stages <= 8 && stages % 2 == 0 &&
      (streamed == 0 || streamed == 1) &&
      layout(cin_pad, bn, cc, stages, g.stream).total == smem_bytes &&
      smem_bytes <= MAX_SMEM && grid >= g.n_slices &&
      grid % g.n_slices == 0 && grid / g.n_slices <= g.tiles;
  if (!plan_ok) return -1;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -2;

  CUtensorMap x_map, w_map, y_map;
  const cuuint64_t x_dims[4] = {static_cast<cuuint64_t>(Cin),
                                static_cast<cuuint64_t>(W),
                                static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(B)};
  const cuuint64_t x_strides[3] = {
      static_cast<cuuint64_t>(Cin) * 2, static_cast<cuuint64_t>(W) * Cin * 2,
      static_cast<cuuint64_t>(H) * W * Cin * 2};
  const cuuint32_t x_box[4] = {static_cast<cuuint32_t>(cc), HALO, HALO, 1};
  const cuuint64_t w_dims[2] = {static_cast<cuuint64_t>(9) * cin_pad,
                                static_cast<cuuint64_t>(Cout)};
  const cuuint64_t w_strides[1] = {static_cast<cuuint64_t>(9) * cin_pad * 2};
  const cuuint32_t w_box[2] = {8, static_cast<cuuint32_t>(bn)};
  const cuuint64_t y_dims[4] = {static_cast<cuuint64_t>(Cout),
                                static_cast<cuuint64_t>(W),
                                static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(B)};
  const cuuint64_t y_strides[3] = {
      static_cast<cuuint64_t>(Cout) * 2, static_cast<cuuint64_t>(W) * Cout * 2,
      static_cast<cuuint64_t>(H) * W * Cout * 2};
  const cuuint32_t y_box[4] = {static_cast<cuuint32_t>(bn), TILE, TILE, 1};
  if (!encode_bf16(encode, &x_map, x, 4, x_dims, x_strides, x_box) ||
      !encode_bf16(encode, &w_map, w, 2, w_dims, w_strides, w_box))
    return -3;
  if (g.direct) {
    y_map = x_map;  // no map can describe y; the kernel does not read it
  } else if (!encode_bf16(encode, &y_map, y, 4, y_dims, y_strides, y_box,
                          bn == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                   : CU_TENSOR_MAP_SWIZZLE_64B)) {
    return -3;
  }

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int key = bn * 100 + cc;
  switch (key) {
    case 3216: return launch<32, 16>(x_map, w_map, y_map, scale, shift, y, g, smem_bytes, grid, slope, s);
    case 3232: return launch<32, 32>(x_map, w_map, y_map, scale, shift, y, g, smem_bytes, grid, slope, s);
    case 3264: return launch<32, 64>(x_map, w_map, y_map, scale, shift, y, g, smem_bytes, grid, slope, s);
    case 6416: return launch<64, 16>(x_map, w_map, y_map, scale, shift, y, g, smem_bytes, grid, slope, s);
    case 6432: return launch<64, 32>(x_map, w_map, y_map, scale, shift, y, g, smem_bytes, grid, slope, s);
    default: return launch<64, 64>(x_map, w_map, y_map, scale, shift, y, g, smem_bytes, grid, slope, s);
  }
}

// The packed work item (fused_bn_act_conv3x3_bf16_kernel_packed): the same
// x, scale, shift, w and y. (cin_pad, bn, images, rows, x_stages, w_stages,
// smem_bytes, grid) is conv_plan()'s packed launch plan: an item is
// `images` whole images (rows == H) or a band of `rows` rows of one image,
// at most 128 output pixels, by bn output channels.
extern "C" int fused_bn_act_conv3x3_bf16_packed(
    const void* x, const float* scale, const float* shift, const void* w,
    void* y, int B, int H, int W, int Cin, int Cout, int cin_pad, int bn,
    int images, int rows, int x_stages, int w_stages, int smem_bytes,
    int grid, float slope, void* stream) {
  PackedGeometry g;
  g.B = B, g.H = H, g.W = W, g.Cin = Cin, g.Cout = Cout;
  g.images = images, g.rows = rows;
  g.bands = rows > 0 ? (H + rows - 1) / rows : 0;
  g.n_slices = bn > 0 ? (Cout + bn - 1) / bn : 0;
  g.items = images > 0 ? (B + images - 1) / images * g.bands * g.n_slices
                       : 0;
  g.chunks = (cin_pad + PK_CC - 1) / PK_CC;
  g.x_stages = x_stages, g.w_stages = w_stages;
  const bool plan_ok =
      B > 0 && H > 0 && W > 0 && Cin > 0 && Cin % 8 == 0 && Cout > 0 &&
      (bn == 32 || bn == 64 || bn == 128) &&
      cin_pad % 16 == 0 && cin_pad >= Cin && cin_pad - Cin < 16 &&
      images >= 1 && images <= 256 && rows >= 1 && rows <= H &&
      (images == 1 || rows == H) && images * rows * W <= PK_ROWS &&
      images * (rows + 2) * (W + 2) <= 1024 &&
      x_stages >= 2 && x_stages <= 4 && w_stages >= 2 && w_stages <= 8 &&
      packed_layout(bn, images, rows, W, x_stages, w_stages).total ==
          smem_bytes &&
      smem_bytes <= MAX_SMEM && grid >= 1 && grid <= g.items;
  if (!plan_ok) return -1;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -2;

  // x: the item's images (or band) with their one-pixel halos, 64
  // channels a box; w: (Cout, 9, cin_pad), 64 k by bn; both 128B-swizzled
  CUtensorMap x_map, w_map;
  const cuuint64_t x_dims[4] = {static_cast<cuuint64_t>(Cin),
                                static_cast<cuuint64_t>(W),
                                static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(B)};
  const cuuint64_t x_strides[3] = {
      static_cast<cuuint64_t>(Cin) * 2, static_cast<cuuint64_t>(W) * Cin * 2,
      static_cast<cuuint64_t>(H) * W * Cin * 2};
  const cuuint32_t x_box[4] = {PK_CC, static_cast<cuuint32_t>(W + 2),
                               static_cast<cuuint32_t>(rows + 2),
                               static_cast<cuuint32_t>(images)};
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(cin_pad), 9,
                                static_cast<cuuint64_t>(Cout)};
  const cuuint64_t w_strides[2] = {static_cast<cuuint64_t>(cin_pad) * 2,
                                   static_cast<cuuint64_t>(9) * cin_pad * 2};
  const cuuint32_t w_box[3] = {PK_CC, 1, static_cast<cuuint32_t>(bn)};
  if (!encode_bf16(encode, &x_map, x, 4, x_dims, x_strides, x_box,
                   CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_bf16(encode, &w_map, w, 3, w_dims, w_strides, w_box,
                   CU_TENSOR_MAP_SWIZZLE_128B))
    return -3;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 32: return launch_packed<32>(x_map, w_map, scale, shift, y, g, smem_bytes, grid, slope, s);
    case 64: return launch_packed<64>(x_map, w_map, scale, shift, y, g, smem_bytes, grid, slope, s);
    default: return launch_packed<128>(x_map, w_map, scale, shift, y, g, smem_bytes, grid, slope, s);
  }
}
