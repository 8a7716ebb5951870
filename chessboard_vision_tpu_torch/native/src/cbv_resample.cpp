// Host runtime of chessboard_vision_tpu_torch: the host resampler and the
// HWC -> planar conversion.
//
// The resample and to-planar functions of chessboard_vision_tpu/native/
// src/cbv_native.cpp, copied so that the port builds them from its own
// source. A bilinear warp and square extraction on the host with the
// arithmetic of the gather warp run op by op (ops/warp.warp_bilinear with
// contract=False): per-channel f32 lerps, each product and sum rounded to
// f32 (the x86-64-v2 build has no FMA to contract them into), round half
// to even, a constant-0 border by per-tap masks; driven by a plan of
// anchor indices and fractions built on the host
// (chessboard_vision_tpu_torch/native/__init__.py HostResampler).
//
// Built with g++ at first use by chessboard_vision_tpu_torch/native/
// __init__.py (ctypes binding).

#include <cmath>
#include <cstdint>

extern "C" {

// ---------------------------------------------------------------------------
// Bilinear resample: queries with static anchor indices and fractions.
// frame: HWC u8 BGR. For query j:
//   anchor = idx[j] (flat index y*W+x), taps anchor, +1, +W, +W+1
//   oob[j] bit t set -> tap t contributes 0
//   out_c[j] = round_half_even(lerp2d(taps_c))
// ---------------------------------------------------------------------------

static inline float lerp2(float p00, float p01, float p10, float p11,
                          float fx, float fy) {
  float top = p00 + fx * (p01 - p00);
  float bot = p10 + fx * (p11 - p10);
  return top + fy * (bot - top);
}

static inline uint8_t round_u8(float v) {
  // round half to even, clamped to [0, 255]
  float r = nearbyintf(v);
  if (r < 0.f) r = 0.f;
  if (r > 255.f) r = 255.f;
  return (uint8_t)r;
}

static inline void taps(const uint8_t* frame, int64_t a, int64_t stride, int c,
                        uint8_t m, float* p) {
  p[0] = (m & 1) ? 0.f : (float)frame[a + c];
  p[1] = (m & 2) ? 0.f : (float)frame[a + 3 + c];
  p[2] = (m & 4) ? 0.f : (float)frame[a + stride + c];
  p[3] = (m & 8) ? 0.f : (float)frame[a + stride + 3 + c];
}

void cbv_resample_bgr(const uint8_t* frame, int64_t src_w,
                      const int32_t* idx, const float* fx, const float* fy,
                      const uint8_t* oob, int64_t n_queries,
                      uint8_t* out_b, uint8_t* out_g, uint8_t* out_r) {
  const int64_t stride = src_w * 3;
  uint8_t* out[3] = {out_b, out_g, out_r};
  for (int64_t j = 0; j < n_queries; ++j) {
    const int64_t a = (int64_t)idx[j] * 3;
    for (int c = 0; c < 3; ++c) {
      float p[4];
      taps(frame, a, stride, c, oob[j], p);
      out[c][j] = round_u8(lerp2(p[0], p[1], p[2], p[3], fx[j], fy[j]));
    }
  }
}

// Resample + exact fixed-point grayscale in one pass
// (gray = (R*9798 + G*19235 + B*3735 + 2^14) >> 15, the cv2 u8 formula).
void cbv_resample_gray(const uint8_t* frame, int64_t src_w,
                       const int32_t* idx, const float* fx, const float* fy,
                       const uint8_t* oob, int64_t n_queries, uint8_t* out) {
  const int64_t stride = src_w * 3;
  for (int64_t j = 0; j < n_queries; ++j) {
    const int64_t a = (int64_t)idx[j] * 3;
    int32_t ch[3];
    for (int c = 0; c < 3; ++c) {
      float p[4];
      taps(frame, a, stride, c, oob[j], p);
      ch[c] = (int32_t)round_u8(lerp2(p[0], p[1], p[2], p[3], fx[j], fy[j]));
    }
    out[j] = (uint8_t)((ch[2] * 9798 + ch[1] * 19235 + ch[0] * 3735 + (1 << 14)) >> 15);
  }
}

// HWC -> planar conversion.
void cbv_to_planar(const uint8_t* hwc, int64_t h, int64_t w, uint8_t* planar) {
  const int64_t n = h * w;
  for (int64_t i = 0; i < n; ++i) {
    planar[i] = hwc[i * 3];
    planar[n + i] = hwc[i * 3 + 1];
    planar[2 * n + i] = hwc[i * 3 + 2];
  }
}

}  // extern "C"
