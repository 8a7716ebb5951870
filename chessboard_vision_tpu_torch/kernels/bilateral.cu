// Bilateral filter (cv2.bilateralFilter d=9, sigma_color = sigma_space = 75)
// on a planar (3, H, W) u8 image, hand-written for Hopper.
//
//   out[c, y, x] = round(sum_taps w * in[c, y+dy, x+dx] / sum_taps w)
//   w = sw[dy, dx] * exp(cd * cd * gc),  cd = sum_c |in[c, tap] - in[c, y, x]|
//
// over the 69 taps of the radius-4 disk, reflect-101 borders, round half to
// even, clipped to u8.
//
// Replaces chessboard_vision_tpu/ops/pallas/bilateral.py::
// bilateral_planar_pallas (the Pallas row-band stencil with hoisted
// lane-shifted copies).
//
// What bounds it on an H100: at 1080p (3, 980, 980) it reads and writes
// 5.8 MB (~2 us at 3.35 TB/s) but evaluates 66 M taps, each an exp on the
// special-function units (~16 us for 66 M) and ~15 FP32 instructions
// around it (~30 us at the card's FP32 issue rate): it is bound by
// operations. Design: one thread per output pixel computes all 3 channels;
// a 32x8 block stages its tile plus a 4-pixel halo of all 3 channels in
// shared memory as f32 (reflect-101 applied to the indices at load time, no
// padded copy in device memory), so each input byte is read from device
// memory about 1.5 times and every tap reads shared memory. The space
// weights (exact zeros outside the disk, taps skipped at compile time) are
// a by-value kernel argument, which the card keeps in its constant bank.
//
// Rounding: the TPU kernel's order is kept. For each dy the row partials
// run over dx in order, then num += rn and den += rd; products and sums
// are rounded separately (__fmul_rn / __fadd_rn: no contraction into FMA),
// expf is the accurate exp (no fast math), rintf rounds half to even.
// Later work: vectorised halo loads, and two pixels per thread to reuse
// the staged neighbourhood from registers.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int R = 4;              // d = 9
constexpr int SPAN = 2 * R + 1;
constexpr int BW = 32, BH = 8;    // output pixels per block
constexpr int TW = BW + 2 * R, TH = BH + 2 * R;

struct SpaceWeights {
  float w[SPAN * SPAN];  // [dy][dx], exact zeros outside the disk
};

__device__ __forceinline__ int reflect101(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * n - 2 - i : i;
  // Rows/cols that only out-of-image threads read may still fall outside.
  return min(max(i, 0), n - 1);
}

__global__ void __launch_bounds__(BW * BH)
bilateral_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                 int H, int W, SpaceWeights sw, float gc) {
  __shared__ float tile[3][TH][TW];
  const int x0 = blockIdx.x * BW, y0 = blockIdx.y * BH;
  const size_t plane = static_cast<size_t>(H) * W;
  const int tid = threadIdx.y * BW + threadIdx.x;
  for (int e = tid; e < TH * TW; e += BW * BH) {
    const int ly = e / TW, lx = e % TW;
    const size_t off = static_cast<size_t>(reflect101(y0 + ly - R, H)) * W +
                       reflect101(x0 + lx - R, W);
#pragma unroll
    for (int c = 0; c < 3; ++c) tile[c][ly][lx] = static_cast<float>(in[c * plane + off]);
  }
  __syncthreads();

  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const int ty = threadIdx.y + R, tx = threadIdx.x + R;
  const float c0 = tile[0][ty][tx], c1 = tile[1][ty][tx], c2 = tile[2][ty][tx];
  // 0 + v == v exactly, so zero-initialised sums equal "first term" starts.
  float num0 = 0.f, num1 = 0.f, num2 = 0.f, den = 0.f;
#pragma unroll
  for (int dy = 0; dy < SPAN; ++dy) {
    float rn0 = 0.f, rn1 = 0.f, rn2 = 0.f, rd = 0.f;
#pragma unroll
    for (int dx = 0; dx < SPAN; ++dx) {
      if ((dy - R) * (dy - R) + (dx - R) * (dx - R) > R * R) continue;
      const float n0 = tile[0][threadIdx.y + dy][threadIdx.x + dx];
      const float n1 = tile[1][threadIdx.y + dy][threadIdx.x + dx];
      const float n2 = tile[2][threadIdx.y + dy][threadIdx.x + dx];
      // Integer-valued, so exact in any order.
      const float cd = fabsf(n0 - c0) + fabsf(n1 - c1) + fabsf(n2 - c2);
      const float cw = expf(__fmul_rn(__fmul_rn(cd, cd), gc));
      const float w = __fmul_rn(sw.w[dy * SPAN + dx], cw);
      rn0 = __fadd_rn(rn0, __fmul_rn(w, n0));
      rn1 = __fadd_rn(rn1, __fmul_rn(w, n1));
      rn2 = __fadd_rn(rn2, __fmul_rn(w, n2));
      rd = __fadd_rn(rd, w);
    }
    num0 = __fadd_rn(num0, rn0);
    num1 = __fadd_rn(num1, rn1);
    num2 = __fadd_rn(num2, rn2);
    den = __fadd_rn(den, rd);
  }
  const size_t o = static_cast<size_t>(y) * W + x;
  out[o] = static_cast<uint8_t>(fminf(fmaxf(rintf(__fdiv_rn(num0, den)), 0.f), 255.f));
  out[plane + o] = static_cast<uint8_t>(fminf(fmaxf(rintf(__fdiv_rn(num1, den)), 0.f), 255.f));
  out[2 * plane + o] = static_cast<uint8_t>(fminf(fmaxf(rintf(__fdiv_rn(num2, den)), 0.f), 255.f));
}

}  // namespace

// in/out: (3, H, W) u8 on the device; space_weights: 81 host floats
// ([dy][dx], zeros outside the disk); gc = -0.5 / sigma_color^2. Launches
// on `stream` and returns cudaGetLastError() of the launch (0 = success).
extern "C" int cbv_bilateral(const void* in, void* out, int H, int W,
                             const float* space_weights, float gc, void* stream) {
  SpaceWeights sw;
  for (int i = 0; i < SPAN * SPAN; ++i) sw.w[i] = space_weights[i];
  const dim3 grid((W + BW - 1) / BW, (H + BH - 1) / BH);
  bilateral_kernel<<<grid, dim3(BW, BH), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), H, W, sw, gc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cbv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
