// CLAHE's two per-pixel phases, hand-written for Hopper: per-tile
// histograms with the LUTs built from them, and the bilinear mix of the
// neighbour-tile LUTs.
//
// Both read N LAB-L images (N, H, W) u8, row-major, unpadded, one launch
// for all N: the board is a grid axis (blockIdx.y of the histogram,
// blockIdx.z of the apply), as Pallas's batching rule gives the TPU kernels
// a leading grid axis when the JAX meshed tick vmaps them over a slot's
// boards. Each board reads its own plane and writes (reads) its own
// (tiles^2, 256) histograms and LUTs; nothing is shared between boards, so
// a board's result is bit-equal to its launch alone. CLAHE cuts each image
// into tiles x tiles tiles of th x tw (th = ceil(H / tiles), likewise tw):
// tile t = ty * tiles + tx covers rows [ty*th, (ty+1)*th) and columns
// [tx*tw, (tx+1)*tw) of the reflect-101 padded image (th * tiles,
// tw * tiles). The pad is at most th - 1 rows and tw - 1 columns, fewer
// than H and W, so one reflection maps every padded coordinate p >= n to
// the source coordinate 2n - 2 - p; the kernels read the pad that way and
// never build it. A plane that is already padded (H = th * tiles) reads
// no reflection.
//
// cbv_clahe_hist: hist[b, t, v] = number of padded pixels of tile t of
//   board b with value v, (N, tiles^2, 256) i32, and, unless luts is null,
//   the tiles' LUTs (N, tiles^2, 256) f32 in the same launch. Replaces chessboard_vision_tpu/
//   ops/pallas/clahe_apply.py::clahe_hist_pallas_v3 and its any-tiles
//   fallback clahe_hist_pallas (v1), which build one-hot operands for the
//   TPU's matrix unit, and the torch ops of the LUT phase between the two
//   kernels (chessboard_vision_tpu/ops/enhance.py::clahe_luts_from_hist).
//   One block of TILE_THREADS per tile and board: lane l of each warp reads columns
//   4l .. 4l+3 of the tile's padded rows (128 columns a pass), each warp
//   its own rows, its loads of TILE_ROW_BATCH rows issued before it counts
//   any; the counts go into the tile's 256 bins in shared memory
//   by shared atomics, and warp 0 then builds the tile's LUT (clip, the
//   excess redistribution, an inclusive scan by warp shuffles, the scaled
//   CDF). Lanes are not merged before their atomics: a constant plane,
//   every lane of a warp on one bin, counts as fast as random u8. Integer counts in any order are exact: launches are bit-equal.
//   That is 64 blocks a board at tiles = 8, fewer than the 132 SMs for one
//   board (512 for a tick of 8 boards); the kernel is
//   bound by latency, and a merge across blocks costs more than more blocks
//   save: row strips over ~256 blocks, merged by integer atomics into a
//   zeroed scratch with a per-tile-row arrival counter, measured 2.3x
//   slower at 980 x 980 (PERF.md section 6).
//
//   LUT arithmetic, as clahe_luts_from_hist computes it: excess =
//   sum max(h - clip, 0); batch = excess / 256, resid = excess - 256 batch;
//   step = max(256 / max(resid, 1), 1); h' = min(h, clip) + batch +
//   (b % step == 0 && b / step < resid); lut = clamp(rint(f32(cdf) *
//   scale), 0, 255) with scale = f32(255 / area) from the host and cdf the
//   inclusive sum of h' (cdf <= area < 2^24: exact in f32).
//
// cbv_clahe_apply: out[b, y, x] = round(sum over the <= 2 tile columns c with
//   wx[c] != 0 of wx[c] * ((1 - fy) * lut[ty0, c][v] + fy * lut[ty1, c][v]))
//   with fy, ty0, ty1 from y / th - 0.5 and wx from x / tw - 0.5 (floor),
//   v = img[y, x], round half to even, clipped to u8. Replaces
//   clahe_apply_pallas_v2 and its fallback clahe_apply_pallas (v1), which
//   select lut[t][v] with a one-hot matmul because TPU gathers serialize.
//   out[y, x] depends only on img[y, x], y, x, th, tw and the LUTs, so the
//   kernel maps the unpadded plane and writes only the (H, W) the caller
//   keeps. Each thread owns 4 consecutive pixels of a row (one 4-byte word
//   when W % 4 == 0 and the planes are 4-byte aligned, else 4 bytes) in
//   APPLY_ROWS rows APPLY_WARPS apart; it computes its columns' tile pairs
//   and weights once, each row's once, and looks the four LUT values of a
//   pixel up through the read-only path (__ldg), which keeps the 64 KB LUT
//   set in L1: no staging, no barrier (a u8 copy of a block's window of
//   LUTs staged in shared memory measured 1.2-2.1 us slower).
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
// Ablation variants (tools/ablate_enhanced.py, cbv_clahe_hist_variant and
// cbv_clahe_apply_variant): extra instantiations of the same two kernels
// with one part taken out, so a time difference is that part's; variant 0
// is the production instantiation (cbv_clahe_hist, cbv_clahe_apply). The
// TPU kernels' cuts build or skip one-hot operands for the matrix unit,
// which these kernels do not have; the nearest cuts:
// - histogram kLoadOnly: the tile's loads without the counting (the TPU
//   kernel's "matonly" left only its data path); kCountOnly: the shared
//   atomics on values made from the indices, no image loads.
// - apply kLookupOnly: the four LUT lookups summed, no blend weights (the
//   TPU kernel's "matonly", its one-hot selection alone); kBlendOnly: the
//   blend arithmetic on the pixel value, no LUT lookups (its "blendonly");
//   kCopy: the image load and the store alone.
// cbv_empty launches an empty kernel: the launch floor of both.
//
// What bounds them on an H100: at 1080p (980 x 980) the histogram reads
// ~1 MB and writes 128 KB, the apply moves ~2 MB plus the 64 KB LUT set, a
// microsecond of memory traffic or less each: both are bound by launch and
// latency, not by bytes or operations, so the designs aim at one short
// wave with enough warps in flight. Later work: fusing the apply with the
// Lab round trip around it, and the whole step into a CUDA graph.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int TILE_THREADS = 1024;  // the histogram kernel's block, one a tile
constexpr int TILE_ROW_BATCH = 4;   // rows a warp loads before it counts
constexpr int APPLY_WARPS = 8;      // rows of an apply block at a time, a warp each
constexpr int APPLY_ROWS = 2;       // rows a thread, APPLY_WARPS apart
constexpr int APPLY_COLS = 128;     // columns of a block: 32 threads x 4
constexpr unsigned FULL = 0xffffffffu;

enum HistVariant : int { kHistFull = 0, kLoadOnly = 1, kCountOnly = 2 };
enum ApplyVariant : int { kApplyFull = 0, kLookupOnly = 1, kBlendOnly = 2, kCopy = 3 };

// Source coordinate of padded coordinate p on an axis of n pixels.
__device__ __forceinline__ int reflect(int p, int n) { return p < n ? p : 2 * n - 2 - p; }

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
  return v;
}

// One tile's LUT from its histogram h (256 bins in shared memory), by one
// warp: lane l owns bins 8l .. 8l+7.
__device__ void build_lut(const int* h, float* lut, int clip, float scale) {
  const int lane = threadIdx.x & 31;
  int v[8];
  int excess = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    v[k] = h[lane * 8 + k];
    excess += max(v[k] - clip, 0);
  }
  excess = warp_sum(excess);
  const int batch = excess / 256, resid = excess - batch * 256;
  const int step = max(256 / max(resid, 1), 1);
  int run = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int b = lane * 8 + k;
    run += min(v[k], clip) + batch + ((b % step == 0 && b / step < resid) ? 1 : 0);
    v[k] = run;
  }
  int incl = run;  // inclusive scan of the lanes' totals
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += t;
  }
  const int before = incl - run;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float cdf = static_cast<float>(v[k] + before);
    lut[lane * 8 + k] = fminf(fmaxf(rintf(__fmul_rn(cdf, scale)), 0.f), 255.f);
  }
}

// cbv_clahe_hist's kernel: block (t, b) counts tile t = ty * tiles + tx of
// board b, lane l of warp w reading columns 4l .. 4l+3 (128 a pass) of rows
// w, w + WARPS, ...; then warp 0 builds the tile's LUT.
template <int V>
__global__ void __launch_bounds__(TILE_THREADS)
clahe_hist_tile_kernel(const uint8_t* __restrict__ img, int H, int W, int th, int tw, int tiles,
                       int* __restrict__ hist, float* __restrict__ luts, int clip, float scale) {
  constexpr int WARPS = TILE_THREADS / 32;
  __shared__ int bins[256];
  if (threadIdx.x < 256) bins[threadIdx.x] = 0;
  __syncthreads();
  const int t = blockIdx.x, ty = t / tiles, tx = t % tiles;
  img += static_cast<size_t>(H) * W * blockIdx.y;  // this block's board
  hist += static_cast<size_t>(tiles) * tiles * 256 * blockIdx.y;
  if (luts != nullptr) luts += static_cast<size_t>(tiles) * tiles * 256 * blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t seen = 0;  // kLoadOnly: the loaded words, folded into one count
  for (int c0 = 4 * lane; c0 < tw; c0 += 128) {
    int col[4];  // source columns (the tile's last column past its edge)
#pragma unroll
    for (int k = 0; k < 4; ++k) col[k] = reflect(tx * tw + min(c0 + k, tw - 1), W);
    for (int r0 = warp; r0 < th; r0 += WARPS * TILE_ROW_BATCH) {
      uint32_t w[TILE_ROW_BATCH];
#pragma unroll
      for (int b = 0; b < TILE_ROW_BATCH; ++b) {  // every load before any count
        w[b] = 0;
        const int r = r0 + b * WARPS;
        if (r >= th) continue;
        if constexpr (V == kCountOnly) {  // a value from the indices, no load
          w[b] = (static_cast<uint32_t>(r) * 0x9E3779B1u) ^ static_cast<uint32_t>(c0);
          continue;
        }
        const uint8_t* row = img + static_cast<size_t>(reflect(ty * th + r, H)) * W;
#pragma unroll
        for (int k = 0; k < 4; ++k) w[b] |= static_cast<uint32_t>(__ldg(row + col[k])) << (8 * k);
      }
      if constexpr (V == kLoadOnly) {
#pragma unroll
        for (int b = 0; b < TILE_ROW_BATCH; ++b) seen ^= w[b];
        continue;
      }
#pragma unroll
      for (int b = 0; b < TILE_ROW_BATCH; ++b) {
        if (r0 + b * WARPS >= th) break;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (c0 + k < tw) atomicAdd(&bins[(w[b] >> (8 * k)) & 255u], 1);
      }
    }
  }
  if constexpr (V == kLoadOnly) atomicAdd(&bins[seen & 255u], 1);
  __syncthreads();
  if (threadIdx.x < 256) hist[t * 256 + threadIdx.x] = bins[threadIdx.x];
  if (luts != nullptr && warp == 0) build_lut(bins, luts + t * 256, clip, scale);
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

template <bool kWord, int V>
__global__ void __launch_bounds__(32 * APPLY_WARPS)
clahe_apply_kernel(const uint8_t* __restrict__ img, const float* __restrict__ luts,
                   uint8_t* __restrict__ out, int H, int W, float inv_th, float inv_tw,
                   int tiles) {
  const int x0 = blockIdx.x * APPLY_COLS + 4 * threadIdx.x;
  if (x0 >= W) return;
  img += static_cast<size_t>(H) * W * blockIdx.z;  // this block's board
  out += static_cast<size_t>(H) * W * blockIdx.z;
  luts += static_cast<size_t>(tiles) * tiles * 256 * blockIdx.z;
  // The thread's 4 columns: LUT offsets of their tile columns, weights.
  int c0[4], c1[4];
  float gx0[4], gx1[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const TileCoord cx = tile_coord(min(x0 + k, W - 1), inv_tw, tiles);
    c0[k] = cx.i0 * 256;
    c1[k] = cx.i1 * 256;
    gx0[k] = __fsub_rn(1.0f, cx.f);
    gx1[k] = cx.f;
  }
  const int y_first = blockIdx.y * APPLY_WARPS * APPLY_ROWS + threadIdx.y;
  uint32_t px[APPLY_ROWS];
#pragma unroll
  for (int r = 0; r < APPLY_ROWS; ++r) {  // every load before any lookup
    const int y = y_first + r * APPLY_WARPS;
    px[r] = 0;
    if (y < H) {
      const uint8_t* src = img + static_cast<size_t>(y) * W + x0;
      if (kWord) {
        px[r] = __ldg(reinterpret_cast<const uint32_t*>(src));
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (x0 + k < W) px[r] |= static_cast<uint32_t>(__ldg(src + k)) << (8 * k);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < APPLY_ROWS; ++r) {
    const int y = y_first + r * APPLY_WARPS;
    if (y >= H) break;
    const TileCoord ry = tile_coord(y, inv_th, tiles);
    const float* row0 = luts + ry.i0 * tiles * 256;
    const float* row1 = luts + ry.i1 * tiles * 256;
    const float gy0 = __fsub_rn(1.0f, ry.f), gy1 = ry.f;
    uint32_t res4 = 0;
#pragma unroll
    for (int k = 0; k < 4 && V != kCopy; ++k) {
      const int v = static_cast<int>((px[r] >> (8 * k)) & 255u);
      if constexpr (V == kLookupOnly) {  // the four lookups, no weights
        const float e = __ldg(row0 + c0[k] + v) + __ldg(row1 + c0[k] + v) +
                        __ldg(row0 + c1[k] + v) + __ldg(row1 + c1[k] + v);
        res4 |= static_cast<uint32_t>(e) << (8 * k);
        continue;
      }
      if constexpr (V == kBlendOnly) {  // the blend on the value, no lookups
        const float e = static_cast<float>(v);
        const float ey = __fmaf_rn(gy0, e, __fmul_rn(gy1, e));
        const float res = __fmaf_rn(gx1[k], ey, __fmul_rn(gx0[k], ey));
        res4 |= static_cast<uint32_t>(fminf(fmaxf(rintf(res), 0.f), 255.f)) << (8 * k);
        continue;
      }
      // ey = (1 - fy) * e0 + fy * e1 for tile column c, first product fused.
      const float ey0 =
          __fmaf_rn(gy0, __ldg(row0 + c0[k] + v), __fmul_rn(gy1, __ldg(row1 + c0[k] + v)));
      float res;
      if (c0[k] == c1[k]) {
        res = __fmul_rn(__fadd_rn(gx0[k], gx1[k]), ey0);
      } else {
        const float ey1 =
            __fmaf_rn(gy0, __ldg(row0 + c1[k] + v), __fmul_rn(gy1, __ldg(row1 + c1[k] + v)));
        res = __fmaf_rn(gx1[k], ey1, __fmul_rn(gx0[k], ey0));
      }
      res4 |= static_cast<uint32_t>(fminf(fmaxf(rintf(res), 0.f), 255.f)) << (8 * k);
    }
    if constexpr (V == kCopy) res4 = px[r];
    uint8_t* dst = out + static_cast<size_t>(y) * W + x0;
    if (kWord) {
      *reinterpret_cast<uint32_t*>(dst) = res4;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (x0 + k < W) dst[k] = static_cast<uint8_t>(res4 >> (8 * k));
    }
  }
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() of the launch
// (0 = success).

// img: (N, H, W) u8, 1 <= N <= 65535, with (tiles - 1) * th < H <= th *
// tiles and th * tiles - H < H (likewise W); hist: (N, tiles^2, 256) i32;
// luts: (N, tiles^2, 256) f32 or null (histograms only); clip: the absolute
// clip limit; scale: f32(255 / (th * tw)).
extern "C" int cbv_clahe_hist(const void* img, int N, int H, int W, int th, int tw, int tiles,
                              void* hist, void* luts, int clip, float scale, void* stream) {
  clahe_hist_tile_kernel<kHistFull>
      <<<dim3(tiles * tiles, N), TILE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(img), H, W, th, tw, tiles, static_cast<int*>(hist),
          static_cast<float*>(luts), clip, scale);
  return static_cast<int>(cudaGetLastError());
}

// An ablation variant of the histogram kernel (HistVariant: 1 kLoadOnly,
// 2 kCountOnly; 0 is the production kernel) with cbv_clahe_hist's
// arguments and launch for one image (H, W); cudaErrorInvalidValue for an unknown variant.
extern "C" int cbv_clahe_hist_variant(int variant, const void* img, int H, int W, int th,
                                      int tw, int tiles, void* hist, void* luts, int clip,
                                      float scale, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint8_t*>(img);
  auto* h = static_cast<int*>(hist);
  auto* l = static_cast<float*>(luts);
  const int n = tiles * tiles;
  switch (variant) {
    case kHistFull:
      clahe_hist_tile_kernel<kHistFull><<<n, TILE_THREADS, 0, s>>>(in, H, W, th, tw, tiles, h,
                                                                   l, clip, scale);
      break;
    case kLoadOnly:
      clahe_hist_tile_kernel<kLoadOnly><<<n, TILE_THREADS, 0, s>>>(in, H, W, th, tw, tiles, h,
                                                                   l, clip, scale);
      break;
    case kCountOnly:
      clahe_hist_tile_kernel<kCountOnly><<<n, TILE_THREADS, 0, s>>>(in, H, W, th, tw, tiles, h,
                                                                    l, clip, scale);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// img, out: (N, H, W) u8, 1 <= N <= 65535, with (tiles - 1) * th < H <=
// th * tiles (likewise W); luts: (N, tiles^2, 256) f32 integer-valued,
// board b's LUTs for image b; inv_th, inv_tw: 1/th and 1/tw rounded to f32.
extern "C" int cbv_clahe_apply(const void* img, const void* luts, void* out, int N, int H,
                               int W, float inv_th, float inv_tw, int tiles, void* stream) {
  const int rows = APPLY_WARPS * APPLY_ROWS;
  const dim3 block(32, APPLY_WARPS);
  const dim3 grid((W + APPLY_COLS - 1) / APPLY_COLS, (H + rows - 1) / rows, N);
  const bool word = W % 4 == 0 && reinterpret_cast<uintptr_t>(img) % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 4 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint8_t*>(img);
  const auto* l = static_cast<const float*>(luts);
  auto* o = static_cast<uint8_t*>(out);
  if (word)
    clahe_apply_kernel<true, kApplyFull><<<grid, block, 0, s>>>(in, l, o, H, W, inv_th, inv_tw,
                                                                tiles);
  else
    clahe_apply_kernel<false, kApplyFull><<<grid, block, 0, s>>>(in, l, o, H, W, inv_th, inv_tw,
                                                                 tiles);
  return static_cast<int>(cudaGetLastError());
}

// An ablation variant of the apply kernel (ApplyVariant: 1 kLookupOnly, 2
// kBlendOnly, 3 kCopy; 0 is the production kernel) with cbv_clahe_apply's
// arguments for one image (H, W), on its word path: W % 4 == 0 and 4-byte aligned planes, else
// cudaErrorInvalidValue (so is an unknown variant).
extern "C" int cbv_clahe_apply_variant(int variant, const void* img, const void* luts,
                                       void* out, int H, int W, float inv_th, float inv_tw,
                                       int tiles, void* stream) {
  const int rows = APPLY_WARPS * APPLY_ROWS;
  const dim3 block(32, APPLY_WARPS);
  const dim3 grid((W + APPLY_COLS - 1) / APPLY_COLS, (H + rows - 1) / rows);
  if (W % 4 != 0 || reinterpret_cast<uintptr_t>(img) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint8_t*>(img);
  const auto* l = static_cast<const float*>(luts);
  auto* o = static_cast<uint8_t*>(out);
  switch (variant) {
    case kApplyFull:
      clahe_apply_kernel<true, kApplyFull><<<grid, block, 0, s>>>(in, l, o, H, W, inv_th,
                                                                  inv_tw, tiles);
      break;
    case kLookupOnly:
      clahe_apply_kernel<true, kLookupOnly><<<grid, block, 0, s>>>(in, l, o, H, W, inv_th,
                                                                   inv_tw, tiles);
      break;
    case kBlendOnly:
      clahe_apply_kernel<true, kBlendOnly><<<grid, block, 0, s>>>(in, l, o, H, W, inv_th,
                                                                  inv_tw, tiles);
      break;
    case kCopy:
      clahe_apply_kernel<true, kCopy><<<grid, block, 0, s>>>(in, l, o, H, W, inv_th, inv_tw,
                                                             tiles);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

namespace {
__global__ void empty_kernel() {}
}  // namespace

// One launch of an empty kernel (one block of one thread): the launch floor.
extern "C" int cbv_empty(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cbv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
