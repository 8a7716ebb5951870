// Bilateral filter (cv2.bilateralFilter d=9, sigma_color = sigma_space = 75)
// on a planar (3, H, W) u8 image, hand-written for Hopper.
//
//   out[c, y, x] = round(sum_taps w * in[c, y+dy, x+dx] / sum_taps w)
//   w = sw[dy, dx] * cw[cd],  cw[cd] = exp(cd * cd * gc),
//   cd = sum_c |in[c, tap] - in[c, y, x]|
//
// over the 49 taps of the radius-4 disk (81 minus 32 corners), reflect-101
// borders, round half to even, clipped to u8.
//
// Replaces chessboard_vision_tpu/ops/pallas/bilateral.py::
// bilateral_planar_pallas (the Pallas row-band stencil with hoisted
// lane-shifted copies).
//
// What bounds it on an H100: at 1080p (3, 980, 980) it reads and writes
// 5.8 MB (~2 us at 3.35 TB/s) but evaluates 47 M taps: it is bound by
// instruction issue and by the shared-memory pipe. Per tap, 8 FP32
// operations cannot go while the rounding order stays: the weight product,
// three numerator products and sums, the denominator sum. The design
// removes the rest of what the tap loop used to do:
// - The exponential leaves the tap loop. cd is an integer in [0, 765], so
//   cw is a 766-entry f32 table, computed once per gc by the card's own
//   expf from the same two rounded products (cbv_bilateral_color_table,
//   cached by the wrapper) and copied by each block into shared memory:
//   every lookup is bit-identical to the per-tap exponential it replaces.
//   cv2's own bilateral uses the same table.
// - cd is computed on the integer pipe: the block keeps a packed copy of
//   its tile, one 32-bit word per pixel holding the three u8 channels, and
//   one __vsadu4 (VABSDIFF4: byte-wise sum of absolute differences) gives
//   cd, which indexes the table directly, with no float-to-int conversion.
// - Fewer shared-memory loads: each thread computes 4 horizontally
//   adjacent outputs. For each of the 9 tap rows it loads the 12 columns
//   those outputs need with 16-byte loads (3 f32 channels and the packed
//   word: 12 loads for 4 x ~5.4 taps) and reuses them from registers.
// - Every sum starts from its first term, which drops the additions to
//   zero that began each row partial.
// What is left is ~11.6 instructions a tap (the 8 FP32 operations, the
// VABSDIFF4, the table address and its load, and a share of the row
// loads) and ~2.9 shared-memory wavefronts per warp and tap (the table
// load, plus the row loads' 16 bytes a lane), both near the SM's limits.
// A 32 x 16 block (8 x 16 threads, 78 registers, 6 blocks an SM) stages its
// tile plus a 4-pixel halo (reflect-101 applied to the indices at load
// time, no padded copy in device memory; rows as 4-byte words where the
// halo stays inside the image columns). The space weights (exact zeros
// outside the disk, taps skipped at compile time) are a by-value kernel
// argument, which the card keeps in its constant bank. Larger tiles, two
// output rows or 8 outputs a thread, and space weights folded into one
// table per ring of taps all measured slower: each costs registers or
// shared memory, and so resident warps.
//
// Rounding: the TPU kernel's order is kept. For each dy the row partials
// run over dx in order, then num += rn and den += rd; products and sums
// are rounded separately (__fmul_rn / __fadd_rn: no contraction into FMA),
// __fdiv_rn divides and rintf rounds half to even.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int R = 4;              // d = 9
constexpr int SPAN = 2 * R + 1;
constexpr int PX = 4;             // outputs per thread, horizontally adjacent (one uint4)
constexpr int TX = 8, TY = 16;    // threads per block
constexpr int BW = TX * PX, BH = TY;  // output pixels per block
constexpr int TW = BW + 2 * R, TH = BH + 2 * R;
constexpr int COLS = PX + 2 * R;  // tile columns one thread reads per tap row
constexpr int CD_LEVELS = 766;    // cd in [0, 3 * 255]
constexpr int TABLE_LEN = 768;    // the table padded to whole 16-byte vectors

struct SpaceWeights {
  float w[SPAN * SPAN];  // [dy][dx], exact zeros outside the disk
};

__device__ __forceinline__ int reflect101(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * n - 2 - i : i;
  // Rows/cols that only out-of-image threads read may still fall outside.
  return min(max(i, 0), n - 1);
}

__device__ __forceinline__ uint8_t to_u8(float num, float den) {
  return static_cast<uint8_t>(fminf(fmaxf(rintf(__fdiv_rn(num, den)), 0.f), 255.f));
}

__global__ void __launch_bounds__(TX * TY, 6)
bilateral_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                 const float* __restrict__ color_table, int H, int W, SpaceWeights sw) {
  // Row strides of TW = 40 elements keep every 4-column group 16-byte aligned.
  __shared__ __align__(16) float tile[3][TH][TW];
  __shared__ __align__(16) uint32_t packed[TH][TW];  // c0 | c1 << 8 | c2 << 16
  __shared__ __align__(16) float cw[TABLE_LEN];
  const int x0 = blockIdx.x * BW, y0 = blockIdx.y * BH;
  const size_t plane = static_cast<size_t>(H) * W;
  const int tid = threadIdx.y * TX + threadIdx.x;
  // A block whose halo stays inside the image columns reads its tile rows
  // as aligned 4-byte words; border blocks reflect column by column.
  const bool words = x0 >= R && x0 + BW + R <= W && W % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(in) % 4 == 0;
  if (words) {
    constexpr int WPR = TW / 4;  // words per tile row
    for (int e = tid; e < TH * WPR; e += TX * TY) {
      const int ly = e / WPR, lx = 4 * (e % WPR);
      const size_t off = static_cast<size_t>(reflect101(y0 + ly - R, H)) * W + (x0 - R + lx);
      const uint32_t q0 = *reinterpret_cast<const uint32_t*>(in + off);
      const uint32_t q1 = *reinterpret_cast<const uint32_t*>(in + plane + off);
      const uint32_t q2 = *reinterpret_cast<const uint32_t*>(in + 2 * plane + off);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const uint32_t v0 = (q0 >> (8 * b)) & 0xFF, v1 = (q1 >> (8 * b)) & 0xFF,
                       v2 = (q2 >> (8 * b)) & 0xFF;
        tile[0][ly][lx + b] = static_cast<float>(v0);
        tile[1][ly][lx + b] = static_cast<float>(v1);
        tile[2][ly][lx + b] = static_cast<float>(v2);
        packed[ly][lx + b] = v0 | (v1 << 8) | (v2 << 16);
      }
    }
  } else {
    for (int e = tid; e < TH * TW; e += TX * TY) {
      const int ly = e / TW, lx = e % TW;
      const size_t off = static_cast<size_t>(reflect101(y0 + ly - R, H)) * W +
                         reflect101(x0 + lx - R, W);
      const uint32_t v0 = in[off], v1 = in[plane + off], v2 = in[2 * plane + off];
      tile[0][ly][lx] = static_cast<float>(v0);
      tile[1][ly][lx] = static_cast<float>(v1);
      tile[2][ly][lx] = static_cast<float>(v2);
      packed[ly][lx] = v0 | (v1 << 8) | (v2 << 16);
    }
  }
  for (int i = tid; i < TABLE_LEN / 4; i += TX * TY)
    reinterpret_cast<float4*>(cw)[i] = reinterpret_cast<const float4*>(color_table)[i];
  __syncthreads();

  const int c0 = PX * threadIdx.x;  // first tile column this thread reads
  const uint4 cq = *reinterpret_cast<const uint4*>(&packed[threadIdx.y + R][c0 + R]);
  const uint32_t center[PX] = {cq.x, cq.y, cq.z, cq.w};
  // Every sum starts from its first term: the reference's 0 + v is v
  // exactly, as no term is -0 (weights > 0, pixel values >= 0).
  float num0[PX], num1[PX], num2[PX], den[PX];

#pragma unroll
  for (int dy = 0; dy < SPAN; ++dy) {
    const int row = threadIdx.y + dy;
    uint32_t nw[COLS];
    float n0[COLS], n1[COLS], n2[COLS];
#pragma unroll
    for (int g = 0; g < COLS / 4; ++g) {
      const uint4 q = *reinterpret_cast<const uint4*>(&packed[row][c0 + 4 * g]);
      const float4 f0 = *reinterpret_cast<const float4*>(&tile[0][row][c0 + 4 * g]);
      const float4 f1 = *reinterpret_cast<const float4*>(&tile[1][row][c0 + 4 * g]);
      const float4 f2 = *reinterpret_cast<const float4*>(&tile[2][row][c0 + 4 * g]);
      nw[4 * g] = q.x, nw[4 * g + 1] = q.y, nw[4 * g + 2] = q.z, nw[4 * g + 3] = q.w;
      n0[4 * g] = f0.x, n0[4 * g + 1] = f0.y, n0[4 * g + 2] = f0.z, n0[4 * g + 3] = f0.w;
      n1[4 * g] = f1.x, n1[4 * g + 1] = f1.y, n1[4 * g + 2] = f1.z, n1[4 * g + 3] = f1.w;
      n2[4 * g] = f2.x, n2[4 * g + 1] = f2.y, n2[4 * g + 2] = f2.z, n2[4 * g + 3] = f2.w;
    }
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      float rn0, rn1, rn2, rd;
      bool first = true;
#pragma unroll
      for (int dx = 0; dx < SPAN; ++dx) {
        if ((dy - R) * (dy - R) + (dx - R) * (dx - R) > R * R) continue;
        const int j = p + dx;
        const float w = __fmul_rn(sw.w[dy * SPAN + dx], cw[__vsadu4(nw[j], center[p])]);
        const float t0 = __fmul_rn(w, n0[j]), t1 = __fmul_rn(w, n1[j]),
                    t2 = __fmul_rn(w, n2[j]);
        if (first) {
          rn0 = t0, rn1 = t1, rn2 = t2, rd = w;
          first = false;
        } else {
          rn0 = __fadd_rn(rn0, t0);
          rn1 = __fadd_rn(rn1, t1);
          rn2 = __fadd_rn(rn2, t2);
          rd = __fadd_rn(rd, w);
        }
      }
      if (dy == 0) {
        num0[p] = rn0, num1[p] = rn1, num2[p] = rn2, den[p] = rd;
      } else {
        num0[p] = __fadd_rn(num0[p], rn0);
        num1[p] = __fadd_rn(num1[p], rn1);
        num2[p] = __fadd_rn(num2[p], rn2);
        den[p] = __fadd_rn(den[p], rd);
      }
    }
  }

  const int y = y0 + threadIdx.y;
  if (y >= H) return;
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int x = x0 + c0 + p;
    if (x >= W) break;
    const size_t o = static_cast<size_t>(y) * W + x;
    out[o] = to_u8(num0[p], den[p]);
    out[plane + o] = to_u8(num1[p], den[p]);
    out[2 * plane + o] = to_u8(num2[p], den[p]);
  }
}

__global__ void color_table_kernel(float* __restrict__ table, float gc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < TABLE_LEN) {
    const float cd = static_cast<float>(i);
    table[i] = i < CD_LEVELS ? expf(__fmul_rn(__fmul_rn(cd, cd), gc)) : 0.f;
  }
}

}  // namespace

// table: 768 (TABLE_LEN) f32 on the device, 16-byte aligned; gc = -0.5 /
// sigma_color^2. Fills table[cd] = expf((cd * cd) * gc) for cd < 766, each
// product rounded to f32, and zeros in the two padding entries. Launches on
// `stream` and returns cudaGetLastError() of the launch (0 = success).
extern "C" int cbv_bilateral_color_table(void* table, float gc, void* stream) {
  color_table_kernel<<<(TABLE_LEN + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(table), gc);
  return static_cast<int>(cudaGetLastError());
}

// in/out: (3, H, W) u8 on the device; space_weights: 81 host floats
// ([dy][dx], zeros outside the disk); color_table: the device table of
// cbv_bilateral_color_table. Launches on `stream` and returns
// cudaGetLastError() of the launch (0 = success).
extern "C" int cbv_bilateral(const void* in, void* out, int H, int W,
                             const float* space_weights, const void* color_table,
                             void* stream) {
  SpaceWeights sw;
  for (int i = 0; i < SPAN * SPAN; ++i) sw.w[i] = space_weights[i];
  const dim3 grid((W + BW - 1) / BW, (H + BH - 1) / BH);
  bilateral_kernel<<<grid, dim3(TX, TY), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out),
      static_cast<const float*>(color_table), H, W, sw);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cbv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
