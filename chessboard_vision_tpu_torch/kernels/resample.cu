// The bilinear resample of the squares (and of the enhanced path's board
// tiles) at planned coordinates, hand-written for Hopper: every board and
// channel of a call in one launch.
//
//   out[b, c, s] = clip(rint(lerp(lerp(t00, t01, 1 - fx, fx, ox),
//                                 lerp(t10, t11, 1 - fx, fx, ox),
//                                 1 - fy, fy, oy)), 0, 255)
//   lerp(p0, p1, w0, w1, first) = first ? fma(p0, w0, p1 * w1)
//                                       : fma(p1, w1, p0 * w0)
//   fma(x, y, z) = f32(f64(x) * f64(y) + f64(z))
//
// with the four taps t00 = src[b, c, i], t01 = src[b, c, i + 1], t10 =
// src[b, c, i + W], t11 = src[b, c, i + W + 1] of the sample's flat source
// index i, and 0 where the plan's anchor leaves the source (zero_mask).
//
// Replaces the port's op-by-op chain of ops/matmul_resample.py (the tap
// gathers, then three lerps of two f32 products and two f64 fmas each, the
// wheres, the round, the clamp and the cast: ~58 launches a board), which
// the JAX package computes as one-hot selection matmuls on the TPU
// (chessboard_vision_tpu/ops/matmul_resample.py). It has no Pallas
// counterpart. The plain ops stay the CPU's path and the tests' reference.
//
// Rounding, kept bit for bit: XLA:CPU contracts the JAX form's tap sum into
// one fused multiply-add whose fused product is the first nonzero tap's at
// band offset 0 (ox: ux_off == 0 horizontally, oy: uy_off == 0
// vertically), else the second's; the port's plain ops reproduce that with
// an f64 multiply of the two f32 values (exact), an f64 add of the f32
// addend and one rounding to f32. The kernel does the same operations with
// the rounding intrinsics (__fsub_rn, __fmul_rn, __dmul_rn, __dadd_rn,
// __double2float_rn), so nvcc cannot contract a product into an add; rintf
// rounds half to even. The u8 taps are exact in f32.
//
// Layout: the sources are (N, C, H * W) u8 planes at any strides of board,
// channel and pixel (a pixel's row is W pixels: planar frames, or the
// planar view of HWC frames with a pixel stride of 3), so the caller never
// copies them. The plan is (N, S) a board, S = 64 * Qr * Qc samples:
// index i32, fx and fy f32, and one byte of flags (bit 0 ox, bit 1 oy, bit
// 2 zero_mask), 13 bytes a sample. The output is (N, C, S) u8, which is the
// caller's (N * 64, Qr, Qc) squares for C = 1.
//
// One thread a sample: it reads the sample's 13 plan bytes once (coalesced)
// and writes its C channels, each from four tap loads (gathers; a hall
// tick's 16.6 MB of gray frames sit in L2 after the gray conversion). The
// board is blockIdx.y. What bounds it is bytes, and most of them are the
// plan's: 13 a sample, read once, against 1 a sample and channel written
// and the source pixels the taps touch, the function's own floor
// (chip_smoke.py's resample_bound gives both at the hall's shapes).
// No shared memory, no atomics: a sample depends only on its inputs, so
// launches are bit-equal.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr uint8_t FIRST_X = 1;  // ux_off == 0: the horizontal lerps fuse the first product
constexpr uint8_t FIRST_Y = 2;  // uy_off == 0: the vertical lerp fuses the first product
constexpr uint8_t ZERO = 4;     // the anchor leaves the source: the sample is 0

__device__ __forceinline__ float fma_f64(float x, float y, float z) {
  return __double2float_rn(__dadd_rn(__dmul_rn(static_cast<double>(x), static_cast<double>(y)),
                                     static_cast<double>(z)));
}

__device__ __forceinline__ float lerp(float p0, float p1, float w0, float w1, bool first) {
  return first ? fma_f64(p0, w0, __fmul_rn(p1, w1)) : fma_f64(p1, w1, __fmul_rn(p0, w0));
}

__global__ void __launch_bounds__(THREADS)
resample_kernel(const uint8_t* __restrict__ src, long long stride_b, long long stride_c,
                long long stride_p, int C, int W, const int* __restrict__ index,
                const float* __restrict__ fx, const float* __restrict__ fy,
                const uint8_t* __restrict__ flags, int S, uint8_t* __restrict__ out) {
  const int s = blockIdx.x * THREADS + threadIdx.x;
  if (s >= S) return;
  const int b = blockIdx.y;
  const long long k = static_cast<long long>(b) * S + s;
  uint8_t* o = out + static_cast<long long>(b) * C * S + s;
  const uint8_t f = flags[k];
  if (f & ZERO) {
    for (int c = 0; c < C; ++c) o[static_cast<long long>(c) * S] = 0;
    return;
  }
  const long long i = index[k];
  const float wx = fx[k], wy = fy[k];
  const float gx = __fsub_rn(1.0f, wx), gy = __fsub_rn(1.0f, wy);
  const bool ox = f & FIRST_X, oy = f & FIRST_Y;
  const long long p00 = i * stride_p, p01 = (i + 1) * stride_p;
  const long long p10 = (i + W) * stride_p, p11 = (i + W + 1) * stride_p;
  const uint8_t* plane = src + b * stride_b;
  for (int c = 0; c < C; ++c, plane += stride_c) {
    const float top = lerp(plane[p00], plane[p01], gx, wx, ox);
    const float bot = lerp(plane[p10], plane[p11], gx, wx, ox);
    const float v = rintf(lerp(top, bot, gy, wy, oy));
    o[static_cast<long long>(c) * S] = static_cast<uint8_t>(fminf(fmaxf(v, 0.0f), 255.0f));
  }
}

}  // namespace

// src: N boards of C planes of H * W u8 pixels, pixel (b, c, p) at
// b * stride_b + c * stride_c + p * stride_p; the plan (index, fx, fy,
// flags): (N, S) each, contiguous; out: (N, C, S) u8, contiguous. Returns a
// cudaError_t (0: launched). Allocates nothing and never synchronises.
extern "C" int cbv_resample(const void* src, long long stride_b, long long stride_c,
                            long long stride_p, int N, int C, int W, const void* index,
                            const void* fx, const void* fy, const void* flags, int S, void* out,
                            void* stream) {
  if (N < 1 || N > 65535 || C < 1 || S < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + THREADS - 1) / THREADS, N);
  resample_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), stride_b, stride_c, stride_p, C, W,
      static_cast<const int*>(index), static_cast<const float*>(fx),
      static_cast<const float*>(fy), static_cast<const uint8_t*>(flags), S,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cbv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
