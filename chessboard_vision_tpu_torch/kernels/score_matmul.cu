// Hough score matmul for the conv circle detector, hand-written for Hopper.
//
//   out[m, n] = sum_k f32(basis[m, k]) * f32(pf[n, k])
//
// basis: (M, K) bf16 row-major -- the ring kernels unrolled over the union
//        of the per-square center windows (ConvHoughPlan.basis).
// pf:    (N, K) bf16 row-major -- the q-pooled cos-2theta planes, one row
//        per square (N = 64 for one stream).
// out:   (M, N) f32 row-major -- square axis last, like the TPU kernel.
//
// Replaces chessboard_vision_tpu/ops/hough_conv.py::_score_matmul_pallas
// (the Pallas M-tiled matmul, reached through _score_matmul_tpu).
//
// What bounds it on an H100: at 1080p the basis is (7168, 3200) bf16 =
// 45.9 MB and pf is (64, 3200), so the product is 2.9 GFLOP against ~46 MB
// of traffic (~64 FLOP/byte), below the bf16 ridge (~295 FLOP/byte): the
// floor is streaming the basis once from device memory, ~14 us at
// 3.35 TB/s. The kernel has to keep loads in flight on every SM all the
// time and hide the tensor-core work behind them.
//
// Design (score_matmul_tma_kernel, taken when K % 8 == 0 and both operands
// are 16-byte aligned, which TMA needs):
// - Each CTA owns a 64-row x 64-column output tile and walks all of K:
//   7168 rows give 112 CTAs, one wave on the 132 SMs, each streaming 410 KB
//   of the basis once.
// - One producer lane keeps a ring of 8 shared-memory stages full with TMA
//   (cp.async.bulk.tensor) loads of a 64 x 64 basis tile and a 64 x 64 pf
//   tile, each 64 bf16 = 128 bytes wide in the 128-byte swizzle that the
//   wgmma descriptors read: 128 KB in flight per SM. mbarriers carry
//   "full" (transaction bytes) and "empty" (consumer done) between the
//   producer and the consumer.
// - One consumer warpgroup issues wgmma.mma_async m64n64k16 (bf16 in, f32
//   accumulators in registers) on each stage, keeps that group in flight
//   while it waits for the next stage, and hands a stage back once its
//   group has retired. The stores leave from registers, two floats at once.
// - Every score is one CTA's sum over K in order: the same from run to run
//   (no split of K, no atomics).
// - The TMA descriptor of the basis (a constant of the plan) is encoded
//   once per pointer and shape and cached; pf's is cached the same way
//   (the caching allocator hands the step the same block). The encoder is
//   reached through cudaGetDriverEntryPoint, so the library needs no
//   -lcuda. The >48 KB shared-memory opt-in is set once per device.
// - Ragged M, N and K: TMA fills rows and columns past the edges with
//   zeros, and the epilogue masks rows >= M and columns >= N. N of any size
//   runs as a grid of 64-column tiles, the column tile the fastest launch
//   index: with N = streams * 64 (the N-stream step) the CTAs of one row
//   tile run together and the basis comes from HBM about once. With the
//   row tile fastest, each column tile swept the whole basis again: at
//   N = 512, 122 us against 75 us (NVIDIA H100 80GB HBM3, 700 W), the same
//   19.0 us at N = 64. At N = 512 the work is bound by operations (23.8 us)
//   and the kernel stays slower than torch.mm (37.6 us).
// Measured on the card and slower at 1080p: clusters of two CTAs splitting
// K and adding the halves through distributed shared memory, 128-row tiles
// (56 CTAs), two consumer warpgroups on alternate stages, 4, 6 or 12
// stages, 2-4 swizzle rows per stage, and L2 evict-first or evict-last
// hints on the loads.
//
// A shape TMA cannot describe (K % 8 != 0: the 720p plan has K = 1250, or a
// misaligned view) takes score_matmul_staged_kernel: 32 x 64 tiles staged
// through shared memory by plain loads and multiplied with 16x16x16 bf16
// WMMA fragments. The wrapper picks the kernel by shape and alignment and
// reports which one ran.
//
// A bf16 x bf16 product is exact in f32; the sums run in the tensor core's
// order, so the low bits differ from a sequential f32 sum (the plain
// version's tolerance covers it).

#include <cstdint>
#include <mutex>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

// ---------------------------------------------------------------------------
// TMA + wgmma path
// ---------------------------------------------------------------------------

constexpr int BM = 64;           // output rows per CTA: one wgmma M
constexpr int BN = 64;           // output columns per tile
constexpr int BK = 64;           // K per stage: one 128-byte swizzle row of bf16
constexpr int STAGES = 8;
constexpr int THREADS = 128 + 32;  // one consumer warpgroup + one producer warp
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BN * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int ACC = BN / 2;      // f32 accumulators per thread of m64n64
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + alignment slack

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

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma.
__device__ __forceinline__ void fence_acc(float (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__global__ void __launch_bounds__(THREADS, 1)
score_matmul_tma_kernel(const __grid_constant__ CUtensorMap a_map,
                        const __grid_constant__ CUtensorMap b_map, float* __restrict__ out,
                        int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[STAGES];
  __shared__ __align__(8) uint64_t empty_bar[STAGES];
  // The 128-byte swizzle repeats every 1024 bytes: stage tiles start there.
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  // The column tile is the fastest launch index: the CTAs that read the same
  // basis rows run side by side, and L2 serves all but the first read.
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int k_tiles = (K + BK - 1) / BK;
  const int t = threadIdx.x;  // < 128: the consumer warpgroup

  if (t == 128) {  // the producer lane
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&a_map))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&b_map))
                 : "memory");
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (t >= 128) {  // producer warp: one lane keeps STAGES tiles in flight
    if (t == 128) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % STAGES;
        // Stage s last held tile kt - STAGES: wait until its consumer let go.
        if (kt >= STAGES) mbar_wait(&empty_bar[s], (kt / STAGES - 1) & 1);
        mbar_expect_tx(&full_bar[s], STAGE_BYTES);
        uint8_t* dst = smem + s * STAGE_BYTES;
        tma_load(dst, &a_map, kt * BK, m0, &full_bar[s]);
        tma_load(dst + A_BYTES, &b_map, kt * BK, n0, &full_bar[s]);
      }
    }
    return;
  }

  // The consumer keeps one tile's wgmma group in flight while it waits for
  // the next tile, and hands each stage back once its group has retired.
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.0f;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full_bar[s], (kt / STAGES) & 1);
    const uint64_t da = smem_desc(smem + s * STAGE_BYTES);
    const uint64_t db = smem_desc(smem + s * STAGE_BYTES + A_BYTES);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int k = 0; k < BK / 16; ++k)  // 16 bf16 = 32 bytes = 2 descriptor units
      wgmma_64x64x16(acc, da + 2 * k, db + 2 * k);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    if (kt > 0 && t == 0) mbar_arrive(&empty_bar[(kt - 1) % STAGES]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_acc(acc);

  // m64nNk16 accumulator layout: warp w of the warpgroup holds rows
  // 16w..16w+15; registers i, i+1 (i even) are row lane/4 + 8*((i/2)%2),
  // columns 8*(i/4) + 2*(lane%4) and the one after it.
  const int lane = t % 32;
  const int row0 = m0 + (t / 32) * 16 + lane / 4;
  const int col0 = n0 + 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < ACC; i += 2) {
    const int row = row0 + 8 * ((i / 2) % 2);
    const int col = col0 + 8 * (i / 4);
    if (row >= M) continue;
    float* dst = out + static_cast<size_t>(row) * N + col;
    if (N % 2 == 0 && col + 1 < N) {
      *reinterpret_cast<float2*>(dst) = make_float2(acc[i], acc[i + 1]);
    } else {
      if (col < N) dst[0] = acc[i];
      if (col + 1 < N) dst[1] = acc[i + 1];
    }
  }
}

// ---------------------------------------------------------------------------
// Staged path (shapes TMA cannot describe)
// ---------------------------------------------------------------------------

using namespace nvcuda;

constexpr int SBM = 32;          // output rows per block
constexpr int SBN = 64;          // output columns per block
constexpr int SBK = 128;         // K-chunk staged per iteration
constexpr int LDS = SBK + 8;     // staged row stride (elements): spreads banks
constexpr int LDC = SBN + 4;     // f32 epilogue tile stride
constexpr int STHREADS = 128;    // four warps: 2 (rows) x 2 (column halves)
constexpr int WM = 16, WN = 16, WK = 16;

// Copies rows [row0, row0 + ROWS) x cols [k0, k0 + SBK) of a (n_rows, K)
// row-major bf16 matrix into dst, zero-filling whatever lies outside it.
template <int ROWS>
__device__ __forceinline__ void stage(__nv_bfloat16 (*dst)[LDS],
                                      const __nv_bfloat16* __restrict__ src, int row0,
                                      int n_rows, int k0, int K) {
  for (int e = threadIdx.x; e < ROWS * SBK; e += STHREADS) {
    const int r = e / SBK, c = e % SBK;
    const int gr = row0 + r, gk = k0 + c;
    dst[r][c] = (gr < n_rows && gk < K) ? src[static_cast<size_t>(gr) * K + gk]
                                        : __float2bfloat16(0.0f);
  }
}

__global__ void __launch_bounds__(STHREADS)
score_matmul_staged_kernel(const __nv_bfloat16* __restrict__ a,
                           const __nv_bfloat16* __restrict__ b, float* __restrict__ out,
                           int M, int N, int K) {
  __shared__ __align__(32) __nv_bfloat16 As[SBM][LDS];
  __shared__ __align__(32) __nv_bfloat16 Bs[SBN][LDS];
  __shared__ __align__(32) float Cs[SBM][LDC];

  const int warp = threadIdx.x / 32;
  const int wr = (warp / 2) * WM;      // warp's first row in the tile
  const int wc = (warp % 2) * 2 * WN;  // warp's first column in the tile
  const int m0 = blockIdx.x * SBM;
  const int n0 = blockIdx.y * SBN;

  wmma::fragment<wmma::accumulator, WM, WN, WK, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
  wmma::fragment<wmma::matrix_a, WM, WN, WK, __nv_bfloat16, wmma::row_major> fa;
  // pf rows are columns of the (K, N) right operand: column-major, ld LDS.
  wmma::fragment<wmma::matrix_b, WM, WN, WK, __nv_bfloat16, wmma::col_major> fb;

  for (int k0 = 0; k0 < K; k0 += SBK) {
    stage<SBM>(As, a, m0, M, k0, K);
    stage<SBN>(Bs, b, n0, N, k0, K);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SBK; kk += WK) {
      wmma::load_matrix_sync(fa, &As[wr][kk], LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(fb, &Bs[wc + j * WN][kk], LDS);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();
  }

  wmma::store_matrix_sync(&Cs[wr][wc], acc[0], LDC, wmma::mem_row_major);
  wmma::store_matrix_sync(&Cs[wr][wc + WN], acc[1], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < SBM * SBN; e += STHREADS) {
    const int r = e / SBN, c = e % SBN;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < N) out[static_cast<size_t>(m) * N + n] = Cs[r][c];
  }
}

// ---------------------------------------------------------------------------
// Host side: descriptor cache and one-time setup
// ---------------------------------------------------------------------------

// Codes below 0 are this file's own; the rest are cudaError_t.
constexpr int ERR_NO_ENCODER = -1;    // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = -2;        // the CUDA driver refused the descriptor

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
bool g_smem_set[MAX_DEVICES] = {};

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

}  // namespace

// Both launchers: basis (M, K), pf (N, K) bf16 row-major on the device,
// out (M, N) f32. Launch on `stream` and return 0, a cudaError_t of the
// launch, or one of this file's negative codes; the caller raises on
// anything but 0.

// The TMA + wgmma kernel. Needs K % 8 == 0 and 16-byte aligned operands.
extern "C" int cbv_score_matmul_tma(const void* basis, const void* pf, void* out, int M,
                                    int N, int K, void* stream) {
  CUtensorMap a_map, b_map;
  {
    std::lock_guard<std::mutex> lock(g_mutex);
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
    if (!g_smem_set[dev]) {
      err = cudaFuncSetAttribute(score_matmul_tma_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
      if (err != cudaSuccess) return static_cast<int>(err);
      g_smem_set[dev] = true;
    }
    const CUtensorMap* map = nullptr;
    int rc = tensor_map(basis, M, K, BM, &map);
    if (rc != 0) return rc;
    a_map = *map;
    rc = tensor_map(pf, N, K, BN, &map);
    if (rc != 0) return rc;
    b_map = *map;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  score_matmul_tma_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      a_map, b_map, static_cast<float*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// The staged WMMA kernel: any K, any alignment of a bf16 tensor.
extern "C" int cbv_score_matmul_staged(const void* basis, const void* pf, void* out, int M,
                                       int N, int K, void* stream) {
  const dim3 grid((M + SBM - 1) / SBM, (N + SBN - 1) / SBN);
  score_matmul_staged_kernel<<<grid, STHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(basis), static_cast<const __nv_bfloat16*>(pf),
      static_cast<float*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cbv_cuda_error_string(int code) {
  if (code == ERR_NO_ENCODER) return "cuTensorMapEncodeTiled not found in the CUDA driver";
  if (code == ERR_ENCODE) return "cuTensorMapEncodeTiled refused the operand";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
