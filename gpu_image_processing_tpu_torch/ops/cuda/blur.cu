// Separable gaussian and box blurs on (B, H, W*C) interleaved uint8 rows.
//
// Replaces the TPU kernels
//   gpu_image_processing_tpu/ops/pallas/blur.py::_blur_kernel: gaussian at
//     every radius (level 2), gaussian with folded taps (level 4, r < 3), and
//     box at r = 1;
//   gpu_image_processing_tpu/ops/pallas/blur_mxu.py::_gauss_mxu_kernel: box
//     mode (box at r >= 2) and gaussian mode (level 4, r >= 3, bf16 hi + lo
//     weights);
//   and the batched rows variants of both (blur.py:985,996,
//     blur_mxu.py:518,567), where the batch is the grid's z dimension,
// with what they compute, not how the TPU had to tile it: each pass clamps at
// the true image edge, a horizontal tap t of lane l reads pixel
// clamp(l / C + t - r, 0, W - 1) in the same channel, a vertical tap clamps
// within the lane's own image (a batch is never blurred across images), and
// the horizontal result is quantized to uint8 before the vertical pass reads
// it.
//
// Numerics, per pass: `taps_value` of taps.cuh (bit-exact against the plain
// versions in ops/interleaved.py), then floor(acc + 0.5).  Box at levels 2
// and 4 is exact (the argument of blur_mxu.py:23-31, and both TPU routes at
// level 4, the folded box and the box band, are exact too).
//
// Design: two launches, one thread per output byte, the uint8 intermediate in
// device memory.  Each pass reads its 2r+1 taps from L1/L2 and writes one
// byte, so it is bound by memory traffic (one u8 read and write of the image
// per pass from device memory, plus cache hits for the taps); the band mode
// doubles the arithmetic and at large radii is bound by it.  A fused tile
// with the intermediate in shared memory (as blur_planar.cu does for
// planes), and for the band a tensor-core product (mma.sync or wgmma, bf16
// in, f32 accumulate), are the next steps for speed.

#include "launch.cuh"
#include "taps.cuh"

namespace {

using gip::clamp_index;
using gip::quantize_u8;
using gip::taps_value;

// Horizontal pass: taps step by whole pixels (C lanes), clamped per pixel.
// blockIdx.z is the image of the batch.
template <typename Mode>
__global__ void blur_h(const uint8_t* __restrict__ src,
                       uint8_t* __restrict__ dst, const float* __restrict__ w,
                       const float* __restrict__ lo, float inv, int radius,
                       int height, int width, int channels) {
  const int lanes = width * channels;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t image = static_cast<size_t>(blockIdx.z) * height * lanes;
  src += image;
  dst += image;
  const int pix = lane / channels;
  const int ch = lane - pix * channels;
  for (int y = blockIdx.y; y < height; y += gridDim.y) {
    const uint8_t* row = src + static_cast<size_t>(y) * lanes;
    const auto load = [&](int t) -> int {
      return row[clamp_index(pix + t - radius, width) * channels + ch];
    };
    dst[static_cast<size_t>(y) * lanes + lane] = static_cast<uint8_t>(
        quantize_u8(taps_value<Mode>(load, w, lo, inv, radius)));
  }
}

// Vertical pass: taps step by whole rows, clamped to the image's own rows.
// blockIdx.z is the image of the batch.
template <typename Mode>
__global__ void blur_v(const uint8_t* __restrict__ src,
                       uint8_t* __restrict__ dst, const float* __restrict__ w,
                       const float* __restrict__ lo, float inv, int radius,
                       int height, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t image = static_cast<size_t>(blockIdx.z) * height * lanes;
  src += image + lane;
  dst += image;
  for (int y = blockIdx.y; y < height; y += gridDim.y) {
    const auto load = [&](int t) -> int {
      return src[static_cast<size_t>(clamp_index(y + t - radius, height)) * lanes];
    };
    dst[static_cast<size_t>(y) * lanes + lane] = static_cast<uint8_t>(
        quantize_u8(taps_value<Mode>(load, w, lo, inv, radius)));
  }
}

template <typename Mode>
int separable(const uint8_t* src, uint8_t* tmp, uint8_t* dst, const float* w,
              const float* lo, float inv, int radius, int batch, int height,
              int width, int channels, void* stream) {
  const int lanes = width * channels;
  const dim3 grid = gip::rows_grid(lanes, height, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  blur_h<Mode><<<grid, gip::kThreads, 0, s>>>(src, tmp, w, lo, inv, radius,
                                              height, width, channels);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  blur_v<Mode><<<grid, gip::kThreads, 0, s>>>(tmp, dst, w, lo, inv, radius,
                                              height, lanes);
  return cudaGetLastError();
}

}  // namespace

// src, tmp, dst: (B, H, W*C) uint8.  weights: (2r+1,) float32 on the device.
extern "C" int gip_gaussian_rows(const uint8_t* src, uint8_t* tmp, uint8_t* dst,
                                 const float* weights, int radius, int batch,
                                 int height, int width, int channels,
                                 void* stream) {
  return separable<gip::Weighted>(src, tmp, dst, weights, nullptr, 0.0f, radius,
                                  batch, height, width, channels, stream);
}

extern "C" int gip_gaussian_folded_rows(const uint8_t* src, uint8_t* tmp,
                                        uint8_t* dst, const float* weights,
                                        int radius, int batch, int height,
                                        int width, int channels, void* stream) {
  return separable<gip::Folded>(src, tmp, dst, weights, nullptr, 0.0f, radius,
                                batch, height, width, channels, stream);
}

// hi, lo: (2r+1,) float32 tables of exact bf16 values, made on the host.
extern "C" int gip_gaussian_band_rows(const uint8_t* src, uint8_t* tmp,
                                      uint8_t* dst, const float* hi,
                                      const float* lo, int radius, int batch,
                                      int height, int width, int channels,
                                      void* stream) {
  return separable<gip::Band>(src, tmp, dst, hi, lo, 0.0f, radius, batch,
                              height, width, channels, stream);
}

// inv: the f32 reciprocal 1/(2r+1), computed on the host.
extern "C" int gip_box_rows(const uint8_t* src, uint8_t* tmp, uint8_t* dst,
                            float inv, int radius, int batch, int height,
                            int width, int channels, void* stream) {
  return separable<gip::Box>(src, tmp, dst, nullptr, nullptr, inv, radius,
                             batch, height, width, channels, stream);
}
