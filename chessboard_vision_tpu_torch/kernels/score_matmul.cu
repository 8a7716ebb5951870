// Hough score matmul for the conv circle detector, hand-written for Hopper.
//
//   out[m, n] = sum_k f32(basis[m, k]) * f32(pf[n, k])
//
// basis: (M, K) bf16 row-major -- the ring kernels unrolled over the union
//        of the per-square center windows (ConvHoughPlan.basis).
// pf:    (N, K) bf16 row-major -- the q-pooled cos-2theta planes, one row
//        per square (N = 64 for one stream, streams * 64 for N streams).
// out:   (M, N) f32 row-major -- square axis last, like the TPU kernel.
//
// Replaces chessboard_vision_tpu/ops/hough_conv.py::_score_matmul_pallas
// (the Pallas M-tiled matmul, reached through _score_matmul_tpu).
//
// What bounds it on an H100: at 1080p the basis is (7168, 3200) bf16 =
// 45.9 MB and pf is (64, 3200), so the product is 2.9 GFLOP against ~46 MB
// of traffic (~64 FLOP/byte), below the bf16 ridge (~295 FLOP/byte): the
// floor is streaming the basis once from device memory, ~14 us at
// 3.35 TB/s. At N = 512 the work is bound by operations (23.7 us). At the
// 720p plans (M 2048 or 3840, K 1256) the bound (1.7-3.2 us) is below a
// launch's fixed latency.
//
// Design (score_matmul_kernel<NT, WG>). Both operands go through TMA,
// which needs K % 8 == 0 and 16-byte aligned operands: the card's plans
// pad K to a multiple of 8 with zero columns (ConvHoughPlan.build's
// k_align), and the wrapper raises on anything else.
// - A CTA owns WG 64-row blocks (WG = 1, 2) and NT 64-column sub-tiles
//   (NT = 1..4; NT >= 2 with WG = 2) and walks all of K. One producer lane keeps a ring of
//   shared-memory stages full with TMA (cp.async.bulk.tensor) loads of a
//   (64 * WG) x 64 basis tile and a (64 * NT) x 64 pf tile, each row 64
//   bf16 = 128 bytes wide in the 128-byte swizzle that the wgmma
//   descriptors read: each basis tile serves up to 256 columns, each pf
//   tile up to 128 rows. mbarriers carry "full" (transaction bytes) and
//   "empty" (every consumer warpgroup done) between the producer and the
//   consumers. The ring holds up to 8 stages within 200 KB, and no more
//   stages than the CTA has tiles of K.
// - Consumer warpgroup w issues wgmma.mma_async m64n(64 NT)k16 (bf16 in,
//   f32 accumulators in registers) on its 64 rows of each stage: one
//   instruction a 16-wide step of K for all its columns, which reads the
//   basis rows from shared memory once instead of NT times (N = 512 took
//   8% less time than with NT m64n64k16 on NVIDIA H100 80GB HBM3, 700 W).
//   Each column comes out bit-equal to m64n64k16's, so a stream's columns
//   of a wide launch are bit-equal to its own N = 64 launch. It keeps one
//   stage's group in flight while it waits for the next stage, and hands a
//   stage back once its group has retired.
// - The wrapper's tile_shape takes the largest CTA tile (128 x 256 down to
//   64 x 64) that still gives three quarters of the SMs a CTA: N = 512 is
//   112 CTAs of 128 x 256, which read the basis a quarter and the planes
//   half as often as 64 x 64 tiles did.
// - Every score is the same sum in the same order from run to run, and
//   every N takes the same sums: no split of K.
// - Launch order: the column tile is the fastest launch index: the CTAs that read the same basis rows run side
//   by side, and L2 serves all but the first read (with the row tile
//   fastest, N = 512 took 122 us against 75 us on NVIDIA H100 80GB HBM3,
//   700 W).
// - The TMA descriptor of the basis (a constant of the plan) is encoded
//   once per pointer, shape and box and cached; pf's is cached the same
//   way (the caching allocator hands the step the same block). The encoder
//   is reached through cudaGetDriverEntryPoint, so the library needs no
//   -lcuda. The >48 KB shared-memory opt-in is set once per device.
// - Ragged M, N and K: TMA fills rows and columns past the edges with
//   zeros, and the epilogue masks rows >= M and columns >= N.
// Measured on the card and slower at 1080p, N = 64: clusters of two
// CTAs splitting K, 128-row tiles (56 CTAs), two consumer warpgroups on
// alternate stages, 4, 6 or 12 stages, 2-4 swizzle rows per stage, and L2
// evict-first or evict-last hints on the loads. At the 720p plans (20
// tiles of K), clusters of 2-3 CTAs splitting K saved at most 0.6 us at
// N = 64 and M 2048, and were slower at N = 256 and at M 3840. At
// N >= 512, pairs of 128-row CTAs sharing each pf tile by TMA multicast
// (half its L2 reads) gave no gain (PERF.md section 6).
//
// A bf16 x bf16 product is exact in f32; the sums run in the tensor core's
// order, so the low bits differ from a sequential f32 sum (the plain
// version's tolerance covers it).

#include <cstdint>
#include <mutex>

#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int BN = 64;             // columns per sub-tile: one wgmma N
constexpr int BK = 64;             // K per stage: one 128-byte swizzle row of bf16
constexpr int WG_ROWS = 64;        // rows per consumer warpgroup: one wgmma M
constexpr int MAX_NT = 4;          // sub-tiles per CTA: up to 256 columns
constexpr int MAX_WG = 2;          // consumer warpgroups per CTA: up to 128 rows
constexpr int MAX_STAGES = 8;
constexpr int RING_BYTES = 200 * 1024;
constexpr int MAX_SMEM = 226 * 1024;  // dynamic shared memory a CTA may ask for
constexpr int ACC = BN / 2;        // f32 accumulators per thread of m64n64

// A CTA: WG consumer warpgroups of 64 rows each and one producer warp;
// NT sub-tiles of 64 columns.
template <int NT, int WG>
struct Tile {
  static constexpr int THREADS = 128 * WG + 32;
  static constexpr int BM = WG_ROWS * WG;
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = NT * BN * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES =
      RING_BYTES / STAGE_BYTES < MAX_STAGES ? RING_BYTES / STAGE_BYTES : MAX_STAGES;
  static_assert(STAGE_BYTES % 1024 == 0, "stages must keep the swizzle's 1024-byte period");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA tile load: box (64 K-columns, rows of the map's box) at (k, row).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int k, int row,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k), "r"(row)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (stride byte offset),
// leading byte offset unused (1), layout type 1 = SWIZZLE_128B.
__device__ __forceinline__ uint64_t smem_desc(const void* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d += A(64 x 16, K-major) * B(16 x 64, K-major), f32 accumulators.
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[ACC], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// The same product on NT sub-tiles at once: d[j] += A * B(16 x 64, the j-th
// 64 columns), one m64n(64 NT)k16. Its accumulator registers are the NT
// m64n64 ones in order, and each column comes out bit-equal to m64n64k16's
// (chip_smoke checks every wide launch's columns against N = 64 launches).
__device__ __forceinline__ void wgmma_tile(float (&d)[1][ACC], uint64_t da, uint64_t db) {
  wgmma_64x64x16(d[0], da, db);
}

__device__ __forceinline__ void wgmma_tile(float (&d)[2][ACC], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[0][4]),
        "+f"(d[0][5]), "+f"(d[0][6]), "+f"(d[0][7]), "+f"(d[0][8]), "+f"(d[0][9]),
        "+f"(d[0][10]), "+f"(d[0][11]), "+f"(d[0][12]), "+f"(d[0][13]), "+f"(d[0][14]),
        "+f"(d[0][15]), "+f"(d[0][16]), "+f"(d[0][17]), "+f"(d[0][18]), "+f"(d[0][19]),
        "+f"(d[0][20]), "+f"(d[0][21]), "+f"(d[0][22]), "+f"(d[0][23]), "+f"(d[0][24]),
        "+f"(d[0][25]), "+f"(d[0][26]), "+f"(d[0][27]), "+f"(d[0][28]), "+f"(d[0][29]),
        "+f"(d[0][30]), "+f"(d[0][31]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]),
        "+f"(d[1][3]), "+f"(d[1][4]), "+f"(d[1][5]), "+f"(d[1][6]), "+f"(d[1][7]),
        "+f"(d[1][8]), "+f"(d[1][9]), "+f"(d[1][10]), "+f"(d[1][11]), "+f"(d[1][12]),
        "+f"(d[1][13]), "+f"(d[1][14]), "+f"(d[1][15]), "+f"(d[1][16]), "+f"(d[1][17]),
        "+f"(d[1][18]), "+f"(d[1][19]), "+f"(d[1][20]), "+f"(d[1][21]), "+f"(d[1][22]),
        "+f"(d[1][23]), "+f"(d[1][24]), "+f"(d[1][25]), "+f"(d[1][26]), "+f"(d[1][27]),
        "+f"(d[1][28]), "+f"(d[1][29]), "+f"(d[1][30]), "+f"(d[1][31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_tile(float (&d)[3][ACC], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[0][4]),
        "+f"(d[0][5]), "+f"(d[0][6]), "+f"(d[0][7]), "+f"(d[0][8]), "+f"(d[0][9]),
        "+f"(d[0][10]), "+f"(d[0][11]), "+f"(d[0][12]), "+f"(d[0][13]), "+f"(d[0][14]),
        "+f"(d[0][15]), "+f"(d[0][16]), "+f"(d[0][17]), "+f"(d[0][18]), "+f"(d[0][19]),
        "+f"(d[0][20]), "+f"(d[0][21]), "+f"(d[0][22]), "+f"(d[0][23]), "+f"(d[0][24]),
        "+f"(d[0][25]), "+f"(d[0][26]), "+f"(d[0][27]), "+f"(d[0][28]), "+f"(d[0][29]),
        "+f"(d[0][30]), "+f"(d[0][31]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]),
        "+f"(d[1][3]), "+f"(d[1][4]), "+f"(d[1][5]), "+f"(d[1][6]), "+f"(d[1][7]),
        "+f"(d[1][8]), "+f"(d[1][9]), "+f"(d[1][10]), "+f"(d[1][11]), "+f"(d[1][12]),
        "+f"(d[1][13]), "+f"(d[1][14]), "+f"(d[1][15]), "+f"(d[1][16]), "+f"(d[1][17]),
        "+f"(d[1][18]), "+f"(d[1][19]), "+f"(d[1][20]), "+f"(d[1][21]), "+f"(d[1][22]),
        "+f"(d[1][23]), "+f"(d[1][24]), "+f"(d[1][25]), "+f"(d[1][26]), "+f"(d[1][27]),
        "+f"(d[1][28]), "+f"(d[1][29]), "+f"(d[1][30]), "+f"(d[1][31]), "+f"(d[2][0]),
        "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[2][4]), "+f"(d[2][5]),
        "+f"(d[2][6]), "+f"(d[2][7]), "+f"(d[2][8]), "+f"(d[2][9]), "+f"(d[2][10]),
        "+f"(d[2][11]), "+f"(d[2][12]), "+f"(d[2][13]), "+f"(d[2][14]), "+f"(d[2][15]),
        "+f"(d[2][16]), "+f"(d[2][17]), "+f"(d[2][18]), "+f"(d[2][19]), "+f"(d[2][20]),
        "+f"(d[2][21]), "+f"(d[2][22]), "+f"(d[2][23]), "+f"(d[2][24]), "+f"(d[2][25]),
        "+f"(d[2][26]), "+f"(d[2][27]), "+f"(d[2][28]), "+f"(d[2][29]), "+f"(d[2][30]),
        "+f"(d[2][31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_tile(float (&d)[4][ACC], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[0][4]),
        "+f"(d[0][5]), "+f"(d[0][6]), "+f"(d[0][7]), "+f"(d[0][8]), "+f"(d[0][9]),
        "+f"(d[0][10]), "+f"(d[0][11]), "+f"(d[0][12]), "+f"(d[0][13]), "+f"(d[0][14]),
        "+f"(d[0][15]), "+f"(d[0][16]), "+f"(d[0][17]), "+f"(d[0][18]), "+f"(d[0][19]),
        "+f"(d[0][20]), "+f"(d[0][21]), "+f"(d[0][22]), "+f"(d[0][23]), "+f"(d[0][24]),
        "+f"(d[0][25]), "+f"(d[0][26]), "+f"(d[0][27]), "+f"(d[0][28]), "+f"(d[0][29]),
        "+f"(d[0][30]), "+f"(d[0][31]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]),
        "+f"(d[1][3]), "+f"(d[1][4]), "+f"(d[1][5]), "+f"(d[1][6]), "+f"(d[1][7]),
        "+f"(d[1][8]), "+f"(d[1][9]), "+f"(d[1][10]), "+f"(d[1][11]), "+f"(d[1][12]),
        "+f"(d[1][13]), "+f"(d[1][14]), "+f"(d[1][15]), "+f"(d[1][16]), "+f"(d[1][17]),
        "+f"(d[1][18]), "+f"(d[1][19]), "+f"(d[1][20]), "+f"(d[1][21]), "+f"(d[1][22]),
        "+f"(d[1][23]), "+f"(d[1][24]), "+f"(d[1][25]), "+f"(d[1][26]), "+f"(d[1][27]),
        "+f"(d[1][28]), "+f"(d[1][29]), "+f"(d[1][30]), "+f"(d[1][31]), "+f"(d[2][0]),
        "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[2][4]), "+f"(d[2][5]),
        "+f"(d[2][6]), "+f"(d[2][7]), "+f"(d[2][8]), "+f"(d[2][9]), "+f"(d[2][10]),
        "+f"(d[2][11]), "+f"(d[2][12]), "+f"(d[2][13]), "+f"(d[2][14]), "+f"(d[2][15]),
        "+f"(d[2][16]), "+f"(d[2][17]), "+f"(d[2][18]), "+f"(d[2][19]), "+f"(d[2][20]),
        "+f"(d[2][21]), "+f"(d[2][22]), "+f"(d[2][23]), "+f"(d[2][24]), "+f"(d[2][25]),
        "+f"(d[2][26]), "+f"(d[2][27]), "+f"(d[2][28]), "+f"(d[2][29]), "+f"(d[2][30]),
        "+f"(d[2][31]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[3][4]), "+f"(d[3][5]), "+f"(d[3][6]), "+f"(d[3][7]), "+f"(d[3][8]),
        "+f"(d[3][9]), "+f"(d[3][10]), "+f"(d[3][11]), "+f"(d[3][12]), "+f"(d[3][13]),
        "+f"(d[3][14]), "+f"(d[3][15]), "+f"(d[3][16]), "+f"(d[3][17]), "+f"(d[3][18]),
        "+f"(d[3][19]), "+f"(d[3][20]), "+f"(d[3][21]), "+f"(d[3][22]), "+f"(d[3][23]),
        "+f"(d[3][24]), "+f"(d[3][25]), "+f"(d[3][26]), "+f"(d[3][27]), "+f"(d[3][28]),
        "+f"(d[3][29]), "+f"(d[3][30]), "+f"(d[3][31])
      : "l"(da), "l"(db), "r"(1));
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma.
__device__ __forceinline__ void fence_acc(float (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Grid: (column tiles, row tiles).
template <int NT, int WG>
__global__ void __launch_bounds__(Tile<NT, WG>::THREADS, 1)
score_matmul_kernel(const __grid_constant__ CUtensorMap a_map,
                    const __grid_constant__ CUtensorMap b_map, float* __restrict__ out, int M,
                    int N, int K, int stages) {
  using T = Tile<NT, WG>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[MAX_STAGES];
  __shared__ __align__(8) uint64_t empty_bar[MAX_STAGES];
  // The 128-byte swizzle repeats every 1024 bytes: stage tiles start there.
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int n0 = blockIdx.x * (NT * BN);
  const int m0 = blockIdx.y * T::BM;
  const int k_tiles = (K + BK - 1) / BK;
  const int t = threadIdx.x;  // < 128 * WG: the consumer warpgroups
  constexpr int PRODUCER = 128 * WG;

  if (t == PRODUCER) {
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&a_map))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&b_map))
                 : "memory");
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], WG);  // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (t >= PRODUCER) {  // producer warp: one lane keeps `stages` tiles in flight
    if (t == PRODUCER) {
      int s = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < k_tiles; ++kt) {
        // Stage s last held the tile `stages` back: wait until its consumers let go.
        if (kt >= stages) mbar_wait(&empty_bar[s], phase ^ 1);
        mbar_expect_tx(&full_bar[s], T::STAGE_BYTES);
        uint8_t* dst = smem + s * T::STAGE_BYTES;
        tma_load(dst, &a_map, kt * BK, m0, &full_bar[s]);
        tma_load(dst + T::A_BYTES, &b_map, kt * BK, n0, &full_bar[s]);
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // Consumer warpgroup wg owns rows 64wg..64wg+63 of the tile. It keeps
    // one stage's wgmma group in flight while it waits for the next stage,
    // and hands each stage back once its group has retired. Each sub-tile's
    // accumulators see the same wgmma sequence as a launch with one
    // sub-tile and one warpgroup.
    const int wg = t / 128, tw = t % 128;
    float acc[NT][ACC];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[j][i] = 0.0f;
    int s = 0, prev = -1;
    uint32_t phase = 0;
    for (int kt = 0; kt < k_tiles; ++kt) {
      mbar_wait(&full_bar[s], phase);
      uint8_t* stage = smem + s * T::STAGE_BYTES;
      const uint64_t da = smem_desc(stage + wg * (WG_ROWS * 128));
      const uint64_t db = smem_desc(stage + T::A_BYTES);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int k = 0; k < BK / 16; ++k)  // 16 bf16 = 32 bytes = 2 descriptor units
        wgmma_tile(acc, da + 2 * k, db + 2 * k);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      if (prev >= 0 && tw == 0) mbar_arrive(&empty_bar[prev]);
      prev = s;
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
    for (int j = 0; j < NT; ++j) fence_acc(acc[j]);

    // m64nNk16 accumulator layout: warp w of the warpgroup holds rows
    // 16w..16w+15; registers i, i+1 (i even) are row lane/4 + 8*((i/2)%2),
    // columns 8*(i/4) + 2*(lane%4) and the one after it.
    const int lane = tw % 32;
    const int r0 = wg * WG_ROWS + (tw / 32) * 16 + lane / 4;  // and r0 + 8
    const int c0 = 2 * (lane % 4);  // + 64j + 8(i/4)
    const bool row_ok[2] = {m0 + r0 < M, m0 + r0 + 8 < M};
    float* dst[2] = {out + static_cast<size_t>(m0 + r0) * N + n0 + c0,
                     out + static_cast<size_t>(m0 + r0 + 8) * N + n0 + c0};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < ACC; i += 2) {
        const int h = (i / 2) % 2, dc = j * BN + 8 * (i / 4);
        if (!row_ok[h]) continue;
        const int col = n0 + c0 + dc;
        if (N % 2 == 0 && col + 1 < N) {
          *reinterpret_cast<float2*>(dst[h] + dc) = make_float2(acc[j][i], acc[j][i + 1]);
        } else {
          if (col < N) dst[h][dc] = acc[j][i];
          if (col + 1 < N) dst[h][dc + 1] = acc[j][i + 1];
        }
      }
  }
}

// ---------------------------------------------------------------------------
// Host side: descriptor cache and one-time setup
// ---------------------------------------------------------------------------

// Codes below 0 are this file's own; the rest are cudaError_t.
constexpr int ERR_NO_ENCODER = -1;    // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = -2;        // the CUDA driver refused the descriptor
constexpr int ERR_TILE = -3;          // sub-tiles or warpgroups out of range

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

struct MapEntry {
  const void* ptr = nullptr;
  int rows = 0, cols = 0, box_rows = 0;
  CUtensorMap map;
};

constexpr int CACHE_SIZE = 16;
constexpr int MAX_DEVICES = 64;

std::mutex g_mutex;  // ctypes drops the GIL: calls may come from several threads
EncodeTiled g_encode = nullptr;
MapEntry g_cache[CACHE_SIZE];
int g_next = 0;
bool g_smem_set[MAX_DEVICES][MAX_NT + 1][MAX_WG + 1] = {};

EncodeTiled encoder() {
  if (g_encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                      cudaEnableDefault, &found);
#else
    cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                             &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess)
      g_encode = reinterpret_cast<EncodeTiled>(fn);
  }
  return g_encode;
}

// The descriptor of a (rows, cols) row-major bf16 matrix read in boxes of
// 64 columns x box_rows rows, 128-byte swizzle, zeros past the edges.
// Cached by pointer and shape; caller holds g_mutex.
int tensor_map(const void* ptr, int rows, int cols, int box_rows, const CUtensorMap** out) {
  for (const MapEntry& e : g_cache) {
    if (e.ptr == ptr && e.rows == rows && e.cols == cols && e.box_rows == box_rows) {
      *out = &e.map;
      return 0;
    }
  }
  EncodeTiled encode = encoder();
  if (encode == nullptr) return ERR_NO_ENCODER;
  MapEntry& e = g_cache[g_next];
  g_next = (g_next + 1) % CACHE_SIZE;
  e.ptr = nullptr;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult rc = encode(&e.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                             const_cast<void*>(ptr), dims, strides, box, elem,
                             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (rc != CUDA_SUCCESS) return ERR_ENCODE;
  e.ptr = ptr;
  e.rows = rows;
  e.cols = cols;
  e.box_rows = box_rows;
  *out = &e.map;
  return 0;
}

template <int NT, int WG>
int launch(const void* basis, const void* pf, void* out, int M, int N, int K,
           cudaStream_t stream) {
  using T = Tile<NT, WG>;
  CUtensorMap a_map, b_map;
  {
    std::lock_guard<std::mutex> lock(g_mutex);
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
    if (!g_smem_set[dev][NT][WG]) {
      err = cudaFuncSetAttribute(score_matmul_kernel<NT, WG>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
      if (err != cudaSuccess) return static_cast<int>(err);
      g_smem_set[dev][NT][WG] = true;
    }
    const CUtensorMap* map = nullptr;
    int rc = tensor_map(basis, M, K, T::BM, &map);
    if (rc != 0) return rc;
    a_map = *map;
    rc = tensor_map(pf, N, K, NT * BN, &map);
    if (rc != 0) return rc;
    b_map = *map;
  }
  // No more stages than the CTA has tiles of K.
  const int k_tiles = (K + BK - 1) / BK;
  const int stages = k_tiles < T::STAGES ? (k_tiles > 0 ? k_tiles : 1) : T::STAGES;
  const int smem = stages * T::STAGE_BYTES + 1024;  // + alignment slack
  const dim3 grid((N + NT * BN - 1) / (NT * BN), (M + T::BM - 1) / T::BM);
  score_matmul_kernel<NT, WG><<<grid, T::THREADS, smem, stream>>>(
      a_map, b_map, static_cast<float*>(out), M, N, K, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// basis (M, K), pf (N, K) bf16 row-major on the device, K % 8 == 0 and both
// 16-byte aligned; out (M, N) f32. A CTA covers `subtiles` (1..4) 64-column
// sub-tiles and `warpgroups` 64-row blocks (1, or 2 with 2..4 sub-tiles).
// Launches on `stream` and returns 0, a cudaError_t of the launch, or one
// of this file's negative codes; the caller raises on anything but 0.
extern "C" int cbv_score_matmul(const void* basis, const void* pf, void* out, int M, int N,
                                int K, int subtiles, int warpgroups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (warpgroups * 8 + subtiles) {
    case 8 + 1: return launch<1, 1>(basis, pf, out, M, N, K, s);
    case 8 + 2: return launch<2, 1>(basis, pf, out, M, N, K, s);
    case 8 + 3: return launch<3, 1>(basis, pf, out, M, N, K, s);
    case 8 + 4: return launch<4, 1>(basis, pf, out, M, N, K, s);
    case 16 + 2: return launch<2, 2>(basis, pf, out, M, N, K, s);
    case 16 + 3: return launch<3, 2>(basis, pf, out, M, N, K, s);
    case 16 + 4: return launch<4, 2>(basis, pf, out, M, N, K, s);
    default: return ERR_TILE;
  }
}

extern "C" const char* cbv_cuda_error_string(int code) {
  if (code == ERR_NO_ENCODER) return "cuTensorMapEncodeTiled not found in the CUDA driver";
  if (code == ERR_ENCODE) return "cuTensorMapEncodeTiled refused the operand";
  if (code == ERR_TILE) return "sub-tiles must be 1..4 with 1 warpgroup, 2..4 with 2";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
