// Hough score matmul for the conv circle detector, hand-written for Hopper.
//
//   out[m, n] = sum_k f32(basis[m, k]) * f32(pf[n, k])
//
// basis: (M, K) bf16 row-major -- the ring kernels unrolled over the union
//        of the per-square center windows (ConvHoughPlan.basis).
// pf:    (N, K) bf16 row-major -- the q-pooled cos-2theta planes, one row
//        per square.
// out:   (M, N) f32 row-major -- square axis last, like the TPU kernel.
//
// Replaces chessboard_vision_tpu/ops/hough_conv.py::_score_matmul_pallas
// (the Pallas M-tiled matmul, reached through _score_matmul_tpu).
//
// What bounds it on an H100: at 1080p the basis is (7168, 3200) bf16 =
// 45.9 MB and pf is (64, 3200), so the product is 2.9 GFLOP against ~46 MB
// of traffic (~64 FLOP/byte): below the bf16 ridge (~295 FLOP/byte), so
// the floor is streaming the basis once, ~14 us at 3.35 TB/s. The FMAs on
// the CUDA cores alone would take ~44 us at their full f32 rate, so the
// products run on the tensor cores: each block owns a BM x BN output tile
// (BN = 64 = every square), walks K in BK-chunks staged through shared
// memory (16-byte loads when K allows, zero-filled past the edges), and
// its four warps issue bf16 16x16x16 WMMA products accumulated in f32
// fragments. A bf16 x bf16 product is exact in f32; the sums run in the
// tensor core's order, so the low bits differ from a sequential f32 sum
// (the plain version's tolerance covers it). Later work: a TMA/wgmma
// pipeline that overlaps the loads, and fusing the kvalid mask and the
// first-max column argmax into the epilogue.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int BM = 32;          // output rows per block
constexpr int BN = 64;          // output columns per block (one per square)
constexpr int BK = 128;         // K-chunk staged per iteration
constexpr int LDS = BK + 8;     // staged row stride (elements): spreads banks,
                                // keeps rows 16-byte aligned
constexpr int LDC = BN + 4;     // f32 epilogue tile stride
constexpr int THREADS = 128;    // four warps: 2 (rows) x 2 (column halves)
constexpr int WM = 16, WN = 16, WK = 16;

// Copies rows [row0, row0 + ROWS) x cols [k0, k0 + BK) of a (n_rows, K)
// row-major bf16 matrix into dst, zero-filling whatever lies outside it.
template <int ROWS, bool VEC>
__device__ __forceinline__ void stage(__nv_bfloat16 (*dst)[LDS],
                                      const __nv_bfloat16* __restrict__ src,
                                      int row0, int n_rows, int k0, int K) {
  if constexpr (VEC) {  // K % 8 == 0: whole 8-element vectors are in or out
    constexpr int VPR = BK / 8;  // vectors per row
    for (int v = threadIdx.x; v < ROWS * VPR; v += THREADS) {
      const int r = v / VPR, c = (v % VPR) * 8;
      const int gr = row0 + r, gk = k0 + c;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gr < n_rows && gk < K)
        val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(gr) * K + gk);
      *reinterpret_cast<uint4*>(&dst[r][c]) = val;
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int gr = row0 + r, gk = k0 + c;
      dst[r][c] = (gr < n_rows && gk < K) ? src[static_cast<size_t>(gr) * K + gk]
                                          : __float2bfloat16(0.0f);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
score_matmul_kernel(const __nv_bfloat16* __restrict__ a,
                    const __nv_bfloat16* __restrict__ b,
                    float* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(32) __nv_bfloat16 As[BM][LDS];
  __shared__ __align__(32) __nv_bfloat16 Bs[BN][LDS];
  __shared__ __align__(32) float Cs[BM][LDC];

  const int warp = threadIdx.x / 32;
  const int wr = (warp / 2) * WM;      // warp's first row in the tile
  const int wc = (warp % 2) * 2 * WN;  // warp's first column in the tile
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  wmma::fragment<wmma::accumulator, WM, WN, WK, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
  wmma::fragment<wmma::matrix_a, WM, WN, WK, __nv_bfloat16, wmma::row_major> fa;
  // pf rows are columns of the (K, N) right operand: column-major, ld LDS.
  wmma::fragment<wmma::matrix_b, WM, WN, WK, __nv_bfloat16, wmma::col_major> fb;

  for (int k0 = 0; k0 < K; k0 += BK) {
    stage<BM, VEC>(As, a, m0, M, k0, K);
    stage<BN, VEC>(Bs, b, n0, N, k0, K);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += WK) {
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
  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e % BN;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < N) out[static_cast<size_t>(m) * N + n] = Cs[r][c];
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() of the launch
// (0 = cudaSuccess); the caller raises on anything else.
extern "C" int cbv_score_matmul(const void* basis, const void* pf, void* out,
                                int M, int N, int K, void* stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const __nv_bfloat16*>(basis);
  const auto* b = static_cast<const __nv_bfloat16*>(pf);
  auto* c = static_cast<float*>(out);
  const bool vec = K % 8 == 0 && reinterpret_cast<std::uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(b) % 16 == 0;
  if (vec)
    score_matmul_kernel<true><<<grid, THREADS, 0, s>>>(a, b, c, M, N, K);
  else
    score_matmul_kernel<false><<<grid, THREADS, 0, s>>>(a, b, c, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cbv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
