// The Sobel arithmetic of sobel.cu (interleaved rows and planes): the grey
// value and the edge magnitude, every operation rounded on its own.
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

// floor(min(sqrt(gx*gx + gy*gy), 255) + 0.5).
__device__ __forceinline__ float sobel_round(float gx, float gy) {
  const float m = __fsqrt_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)));
  return floorf(__fadd_rn(fminf(m, 255.0f), 0.5f));
}

// The magnitude of a 3x3 grey neighbourhood, gx and gy in the term order of
// sobel.py:94-103 (and :209-218): gx = -g00 + g02 - 2g10 + 2g12 - g20 + g22
// and gy = -g00 - 2g01 - g02 + g20 + 2g21 + g22, each term a product by its
// weight, added in turn.  A product by +-1 or +-2 is exact, so adding
// -1 * a is subtracting a, and -2 * a subtracting 2a: the same roundings
// with 14 operations, not 22.
__device__ __forceinline__ float sobel_magnitude(const float (&g)[3][3]) {
  float gx = __fsub_rn(g[0][2], g[0][0]);
  gx = __fsub_rn(gx, __fmul_rn(2.0f, g[1][0]));
  gx = __fadd_rn(gx, __fmul_rn(2.0f, g[1][2]));
  gx = __fsub_rn(gx, g[2][0]);
  gx = __fadd_rn(gx, g[2][2]);
  float gy = __fsub_rn(-g[0][0], __fmul_rn(2.0f, g[0][1]));
  gy = __fsub_rn(gy, g[0][2]);
  gy = __fadd_rn(gy, g[2][0]);
  gy = __fadd_rn(gy, __fmul_rn(2.0f, g[2][1]));
  gy = __fadd_rn(gy, g[2][2]);
  return sobel_round(gx, gy);
}

// The window of a column of outputs, fed one grey row at a time (a pixel's
// left neighbour, itself, its right neighbour); magnitude() is the output
// whose 3x3 neighbourhood the last three rows are.
//
// kWholeGrey: every grey value is a whole number in [0, 255] (the quantized
// grey of level 2, or one channel).  Every partial sum of gx and gy is then
// a whole number under 2^11 in magnitude, exact in f32 in any order, so
// gx = d0 + 2 d1 + d2 with d = right - left of a row, gy = s2 - s0 with
// s = left + 2 middle + right, and each row's d and s serve the three
// outputs that read it: 8 operations an output, the same bits.  Otherwise
// (f32 grey) the three rows and sobel_magnitude's chains.
template <bool kWholeGrey>
struct SobelColumn;

template <>
struct SobelColumn<false> {
  float g[3][3] = {};
  __device__ __forceinline__ void push(float left, float mid, float right) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      g[0][dx] = g[1][dx];
      g[1][dx] = g[2][dx];
    }
    g[2][0] = left;
    g[2][1] = mid;
    g[2][2] = right;
  }
  __device__ __forceinline__ float magnitude() const { return sobel_magnitude(g); }
};

template <>
struct SobelColumn<true> {
  float d[3] = {}, s[3] = {};
  __device__ __forceinline__ void push(float left, float mid, float right) {
    d[0] = d[1];
    d[1] = d[2];
    s[0] = s[1];
    s[1] = s[2];
    d[2] = __fsub_rn(right, left);
    s[2] = __fadd_rn(__fadd_rn(left, right), __fadd_rn(mid, mid));
  }
  __device__ __forceinline__ float magnitude() const {
    const float gx = __fadd_rn(__fadd_rn(d[0], d[2]), __fadd_rn(d[1], d[1]));
    return sobel_round(gx, __fsub_rn(s[2], s[0]));
  }
};

}  // namespace gip
