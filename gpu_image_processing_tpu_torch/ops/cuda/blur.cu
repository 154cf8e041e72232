// Separable gaussian and box blurs on (H, W*C) interleaved uint8 rows.
//
// Replaces the TPU kernels
//   gpu_image_processing_tpu/ops/pallas/blur.py::_blur_kernel (gaussian at
//     every radius, box at r = 1), and
//   gpu_image_processing_tpu/ops/pallas/blur_mxu.py::_gauss_mxu_kernel in box
//     mode (box at r >= 2),
// with what they compute, not how the TPU had to tile it: each pass clamps at
// the true image edge, a horizontal tap t of lane l reads pixel
// clamp(l / C + t - r, 0, W - 1) in the same channel, and the horizontal
// result is quantized to uint8 before the vertical pass reads it.
//
// Numerics (bit-exact against the level-1 path):
//   gaussian: acc = __fadd_rn(acc, __fmul_rn(px, w[t])) in tap order, then
//             floor(acc + 0.5);
//   box:      an int32 window sum (exact, so tap order does not matter, the
//             argument of blur_mxu.py:23-31), then
//             floor(__fmul_rn((float)sum, 1/taps) + 0.5).
//
// Design: two launches, one thread per output byte, the uint8 intermediate in
// device memory.  Each pass reads its 2r+1 taps from L1/L2 and writes one
// byte, so it is bound by memory traffic (one u8 read and write of the image
// per pass from device memory, plus cache hits for the taps).  A fused tile
// with the intermediate in shared memory is the next step for speed.

#include "launch.cuh"

namespace {

using gip::clamp_index;
using gip::quantize_u8;

// Horizontal pass: taps step by whole pixels (C lanes), clamped per pixel.
template <bool kBox>
__global__ void blur_h(const uint8_t* __restrict__ src,
                       uint8_t* __restrict__ dst,
                       const float* __restrict__ weights, float inv, int radius,
                       int height, int width, int channels) {
  const int lanes = width * channels;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const int pix = lane / channels;
  const int ch = lane - pix * channels;
  for (int y = blockIdx.y; y < height; y += gridDim.y) {
    const uint8_t* row = src + static_cast<size_t>(y) * lanes;
    float value;
    if (kBox) {
      int sum = 0;
      for (int t = -radius; t <= radius; ++t) {
        sum += row[clamp_index(pix + t, width) * channels + ch];
      }
      value = __fmul_rn(static_cast<float>(sum), inv);
    } else {
      float acc = 0.0f;
      for (int t = 0; t <= 2 * radius; ++t) {
        const float px = row[clamp_index(pix + t - radius, width) * channels + ch];
        acc = __fadd_rn(acc, __fmul_rn(px, __ldg(weights + t)));
      }
      value = acc;
    }
    dst[static_cast<size_t>(y) * lanes + lane] =
        static_cast<uint8_t>(quantize_u8(value));
  }
}

// Vertical pass: taps step by whole rows, clamped per row.
template <bool kBox>
__global__ void blur_v(const uint8_t* __restrict__ src,
                       uint8_t* __restrict__ dst,
                       const float* __restrict__ weights, float inv, int radius,
                       int height, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  for (int y = blockIdx.y; y < height; y += gridDim.y) {
    float value;
    if (kBox) {
      int sum = 0;
      for (int t = -radius; t <= radius; ++t) {
        sum += src[static_cast<size_t>(clamp_index(y + t, height)) * lanes + lane];
      }
      value = __fmul_rn(static_cast<float>(sum), inv);
    } else {
      float acc = 0.0f;
      for (int t = 0; t <= 2 * radius; ++t) {
        const float px =
            src[static_cast<size_t>(clamp_index(y + t - radius, height)) * lanes + lane];
        acc = __fadd_rn(acc, __fmul_rn(px, __ldg(weights + t)));
      }
      value = acc;
    }
    dst[static_cast<size_t>(y) * lanes + lane] =
        static_cast<uint8_t>(quantize_u8(value));
  }
}

template <bool kBox>
int separable(const uint8_t* src, uint8_t* tmp, uint8_t* dst,
              const float* weights, float inv, int radius, int height,
              int width, int channels, void* stream) {
  const int lanes = width * channels;
  const dim3 grid = gip::rows_grid(lanes, height);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  blur_h<kBox><<<grid, gip::kThreads, 0, s>>>(src, tmp, weights, inv, radius,
                                              height, width, channels);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  blur_v<kBox><<<grid, gip::kThreads, 0, s>>>(tmp, dst, weights, inv, radius,
                                              height, lanes);
  return cudaGetLastError();
}

}  // namespace

// weights: (2r+1,) float32 on the device.  tmp and dst: (H, W*C) uint8.
extern "C" int gip_gaussian_rows(const uint8_t* src, uint8_t* tmp, uint8_t* dst,
                                 const float* weights, int radius, int height,
                                 int width, int channels, void* stream) {
  return separable<false>(src, tmp, dst, weights, 0.0f, radius, height, width,
                          channels, stream);
}

// inv: the f32 reciprocal 1/(2r+1), computed on the host.
extern "C" int gip_box_rows(const uint8_t* src, uint8_t* tmp, uint8_t* dst,
                            float inv, int radius, int height, int width,
                            int channels, void* stream) {
  return separable<true>(src, tmp, dst, nullptr, inv, radius, height, width,
                         channels, stream);
}
