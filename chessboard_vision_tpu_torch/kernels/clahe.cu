// CLAHE's two per-pixel phases, hand-written for Hopper: per-tile
// histograms and the bilinear mix of the neighbour-tile LUTs.
//
// Both take the reflect-padded LAB-L image (Hp, Wp) = (th * tiles,
// tw * tiles) u8, row-major; tile t = ty * tiles + tx covers rows
// [ty*th, (ty+1)*th) and columns [tx*tw, (tx+1)*tw).
//
// cbv_clahe_hist: hist[t, v] = number of pixels of tile t with value v,
//   (tiles^2, 256) i32. Replaces chessboard_vision_tpu/ops/pallas/
//   clahe_apply.py::clahe_hist_pallas_v3 and its any-tiles fallback
//   clahe_hist_pallas (v1): the TPU builds one-hot operands for the matrix
//   unit; here one block per tile counts into a 256-bin shared-memory
//   histogram with shared-memory atomics and writes it out. Counts are
//   integers, so the result is exact whatever the order.
//
// cbv_clahe_apply: out[y, x] = round(sum over the <= 2 tile columns c with
//   wx[c] != 0 of wx[c] * ((1 - fy) * lut[ty0, c][v] + fy * lut[ty1, c][v]))
//   with fy, ty0, ty1 from y / th - 0.5 and wx from x / tw - 0.5 (floor),
//   v = img[y, x], round half to even, clipped to u8. Replaces
//   clahe_apply_pallas_v2 and its fallback clahe_apply_pallas (v1), which
//   select lut[t][v] with a one-hot matmul because TPU gathers serialize;
//   here each block stages the LUT rows of the tile rows its image rows
//   touch in shared memory and every thread looks its four values up.
//
//   Rounding: the f32 operations of the TPU kernel as XLA compiles them.
//   XLA rewrites the divide by the constant tile size into a multiply by its
//   f32 reciprocal and contracts the multiply-adds: p / size - 0.5 is
//   fma(p, 1/size, -0.5); (1 - fy) * e0 + fy * e1 is fma(1 - fy, e0, fy * e1)
//   (first product fused); the sum over tile columns accumulates
//   acc = fma(wx[c], ey[c], acc) in column order, so of the two nonzero
//   terms the first is a rounded product and the second is fused. This
//   kernel spells out the same fused and unfused operations (__fmaf_rn,
//   __fmul_rn, __fadd_rn; nvcc contracts nothing else here), so it is
//   bit-equal to the TPU kernel. At an image edge (tx0 == tx1) the TPU
//   kernel's weight is (1 - fx) + fx, rounded, times one term; so is this
//   one.
//
// What bounds them on an H100: at 1080p (984 x 984) the histogram reads
// ~1 MB and the apply moves ~2 MB plus the 64 KB LUT set, a microsecond of
// memory traffic each: both are bound by launch and latency, not by bytes
// or operations. Later work: privatised per-warp histograms against atomic
// contention on flat tiles, and fusing the apply with the Lab round trip.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int HIST_THREADS = 256;
constexpr int APPLY_THREADS = 256;
constexpr int APPLY_ROWS = 8;  // image rows per apply block

__global__ void __launch_bounds__(HIST_THREADS)
clahe_hist_kernel(const uint8_t* __restrict__ img, int* __restrict__ hist,
                  int Wp, int th, int tw, int tiles) {
  __shared__ int bins[256];
  for (int i = threadIdx.x; i < 256; i += HIST_THREADS) bins[i] = 0;
  __syncthreads();
  const int t = blockIdx.x, ty = t / tiles, tx = t % tiles;
  const uint8_t* base = img + static_cast<size_t>(ty) * th * Wp + static_cast<size_t>(tx) * tw;
  for (int i = threadIdx.x; i < th * tw; i += HIST_THREADS) {
    const int r = i / tw, c = i % tw;
    atomicAdd(&bins[base[static_cast<size_t>(r) * Wp + c]], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 256; i += HIST_THREADS) hist[t * 256 + i] = bins[i];
}

// Tile coordinate of pixel row/col p: (clipped floor, clipped floor + 1,
// fraction) of fma(p, 1/size, -0.5), as the TPU kernel computes it.
struct TileCoord {
  int i0, i1;
  float f;
};

__device__ __forceinline__ TileCoord tile_coord(int p, float inv_size, int tiles) {
  const float tf = __fmaf_rn(static_cast<float>(p), inv_size, -0.5f);
  const float t0 = floorf(tf);
  const int i0 = static_cast<int>(t0);
  return {min(max(i0, 0), tiles - 1), min(max(i0 + 1, 0), tiles - 1), __fsub_rn(tf, t0)};
}

__global__ void __launch_bounds__(APPLY_THREADS)
clahe_apply_kernel(const uint8_t* __restrict__ img, const float* __restrict__ luts,
                   uint8_t* __restrict__ out, int Hp, int Wp, float inv_th, float inv_tw,
                   int tiles) {
  extern __shared__ float lut_s[];  // [tile row - lo][tile col][256]
  const int y_first = blockIdx.x * APPLY_ROWS;
  const int y_last = min(y_first + APPLY_ROWS, Hp) - 1;
  const int lo = tile_coord(y_first, inv_th, tiles).i0;
  const int hi = tile_coord(y_last, inv_th, tiles).i1;
  const int n_stage = (hi - lo + 1) * tiles * 256;
  const float* src = luts + static_cast<size_t>(lo) * tiles * 256;
  for (int i = threadIdx.x; i < n_stage; i += APPLY_THREADS) lut_s[i] = src[i];
  __syncthreads();

  const int n_px = (y_last - y_first + 1) * Wp;
  for (int i = threadIdx.x; i < n_px; i += APPLY_THREADS) {
    const int y = y_first + i / Wp, x = i % Wp;
    const size_t o = static_cast<size_t>(y) * Wp + x;
    const int v = img[o];
    const TileCoord ry = tile_coord(y, inv_th, tiles), cx = tile_coord(x, inv_tw, tiles);
    const float* row0 = lut_s + (ry.i0 - lo) * tiles * 256;
    const float* row1 = lut_s + (ry.i1 - lo) * tiles * 256;
    const float gy0 = __fsub_rn(1.0f, ry.f), gy1 = ry.f;
    const float gx0 = __fsub_rn(1.0f, cx.f), gx1 = cx.f;
    // ey = (1 - fy) * e0 + fy * e1 for tile column c, first product fused.
    const float ey0 = __fmaf_rn(gy0, row0[cx.i0 * 256 + v], __fmul_rn(gy1, row1[cx.i0 * 256 + v]));
    float res;
    if (cx.i0 == cx.i1) {
      res = __fmul_rn(__fadd_rn(gx0, gx1), ey0);
    } else {
      const float ey1 =
          __fmaf_rn(gy0, row0[cx.i1 * 256 + v], __fmul_rn(gy1, row1[cx.i1 * 256 + v]));
      res = __fmaf_rn(gx1, ey1, __fmul_rn(gx0, ey0));
    }
    out[o] = static_cast<uint8_t>(fminf(fmaxf(rintf(res), 0.f), 255.f));
  }
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() of the launch
// (0 = success). img: (th * tiles, tw * tiles) u8; hist: (tiles^2, 256) i32;
// luts: (tiles^2, 256) f32 integer-valued; out: like img; inv_th, inv_tw:
// 1/th and 1/tw rounded to f32.
extern "C" int cbv_clahe_hist(const void* img, void* hist, int Wp, int th, int tw,
                              int tiles, void* stream) {
  clahe_hist_kernel<<<tiles * tiles, HIST_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), static_cast<int*>(hist), Wp, th, tw, tiles);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory per block: the LUTs of every tile row that APPLY_ROWS
// consecutive image rows can touch (their two blend rows included).
extern "C" int cbv_clahe_apply_smem_bytes(int th, int tiles) {
  const int rows = (APPLY_ROWS - 1) / th + 3 < tiles ? (APPLY_ROWS - 1) / th + 3 : tiles;
  return rows * tiles * 256 * static_cast<int>(sizeof(float));
}

extern "C" int cbv_clahe_apply(const void* img, const void* luts, void* out, int Hp, int Wp,
                               int th, float inv_th, float inv_tw, int tiles, void* stream) {
  const int smem = cbv_clahe_apply_smem_bytes(th, tiles);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        clahe_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (Hp + APPLY_ROWS - 1) / APPLY_ROWS;
  clahe_apply_kernel<<<blocks, APPLY_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), static_cast<const float*>(luts),
      static_cast<uint8_t*>(out), Hp, Wp, inv_th, inv_tw, tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cbv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
