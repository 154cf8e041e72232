// The Sobel arithmetic shared by sobel.cu (interleaved rows) and
// sobel_planar.cu (planes): the grey value and the edge magnitude, every
// operation rounded on its own.
#pragma once

#include "launch.cuh"

namespace gip {

// (0.299f*R + 0.587f*G) + 0.114f*B, quantized to floor(gray + 0.5) when
// kQuantGray (level 2), kept in f32 otherwise (level 1).
template <bool kQuantGray>
__device__ __forceinline__ float gray_rgb(float r, float g, float b) {
  const float v = __fadd_rn(__fadd_rn(__fmul_rn(0.299f, r), __fmul_rn(0.587f, g)),
                            __fmul_rn(0.114f, b));
  return kQuantGray ? quantize_u8(v) : v;
}

// floor(min(sqrt(gx*gx + gy*gy), 255) + 0.5) of a 3x3 grey neighbourhood,
// gx and gy in the term order of sobel.py:94-103 (and :209-218).
__device__ __forceinline__ float sobel_magnitude(const float (&g)[3][3]) {
  float gx = __fmul_rn(-1.0f, g[0][0]);
  gx = __fadd_rn(gx, __fmul_rn(1.0f, g[0][2]));
  gx = __fadd_rn(gx, __fmul_rn(-2.0f, g[1][0]));
  gx = __fadd_rn(gx, __fmul_rn(2.0f, g[1][2]));
  gx = __fadd_rn(gx, __fmul_rn(-1.0f, g[2][0]));
  gx = __fadd_rn(gx, __fmul_rn(1.0f, g[2][2]));
  float gy = __fmul_rn(-1.0f, g[0][0]);
  gy = __fadd_rn(gy, __fmul_rn(-2.0f, g[0][1]));
  gy = __fadd_rn(gy, __fmul_rn(-1.0f, g[0][2]));
  gy = __fadd_rn(gy, __fmul_rn(1.0f, g[2][0]));
  gy = __fadd_rn(gy, __fmul_rn(2.0f, g[2][1]));
  gy = __fadd_rn(gy, __fmul_rn(1.0f, g[2][2]));
  const float m = __fsqrt_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)));
  return floorf(__fadd_rn(fminf(m, 255.0f), 0.5f));
}

}  // namespace gip
