// Sobel edge magnitude on (B, H, W*C) interleaved uint8 rows.
//
// Replaces the TPU kernels
//   gpu_image_processing_tpu/ops/pallas/sobel.py::_sobel_kernel_interleaved
//     (grey images, and colour where the MXU tier is off), and
//   gpu_image_processing_tpu/ops/pallas/sobel_mxu.py::_sobel_mxu_kernel
//     (colour images on the TPU),
// at both numerics levels: level 2 quantizes the grey value (sobel.py:328,
// served at level 2), level 1 keeps it in f32 (sobel_mxu.py:364, served at
// level 4), and their batched variants (sobel.py:289, sobel_mxu.py:299),
// where the batch is the grid's z dimension.
// The MXU kernel compacts interleaved RGB(A) to grey with a band matmul only
// because Mosaic has no strided lane load (sobel_mxu.py:3-9).  Here each
// thread reads its pixels' channels directly.
//
// Numerics, per output pixel (edges.cuh):
//   gray = (0.299f*R + 0.587f*G) + 0.114f*B with every product and sum
//          rounded (C = 1: the value itself), quantized to floor(gray + 0.5)
//          when kQuantGray (level 2), kept in f32 otherwise (level 1);
//   gx, gy in the term order of sobel.py:209-218;
//   floor(min(sqrt(gx*gx + gy*gy), 255) + 0.5), 0 on each image's 1-pixel
//   border (an image thinner than 3 pixels is all border);
//   the value goes to every channel, alpha included.
//
// Design: one thread per pixel; each recomputes the grey of its 3x3
// neighbourhood from the interleaved bytes, which L1 serves.  The kernel is
// bound by memory traffic (one read and one write of the image).  A tile of
// grey values in shared memory is the next step for speed.

#include "edges.cuh"

namespace {

template <bool kQuantGray>
__device__ __forceinline__ float gray(const uint8_t* __restrict__ px,
                                      int channels) {
  if (channels == 1) return static_cast<float>(px[0]);
  return gip::gray_rgb<kQuantGray>(static_cast<float>(px[0]),
                                   static_cast<float>(px[1]),
                                   static_cast<float>(px[2]));
}

// blockIdx.z is the image of the batch.
template <bool kQuantGray>
__global__ void sobel_edges(const uint8_t* __restrict__ src,
                            uint8_t* __restrict__ dst, int height, int width,
                            int channels) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= width) return;
  const size_t row_bytes = static_cast<size_t>(width) * channels;
  const size_t image = static_cast<size_t>(blockIdx.z) * height * row_bytes;
  src += image;
  dst += image;
  for (int y = blockIdx.y; y < height; y += gridDim.y) {
    float mag = 0.0f;
    if (x >= 1 && x <= width - 2 && y >= 1 && y <= height - 2) {
      float g[3][3];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const uint8_t* row = src + static_cast<size_t>(y + dy - 1) * row_bytes;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          g[dy][dx] = gray<kQuantGray>(
              row + static_cast<size_t>(x + dx - 1) * channels, channels);
        }
      }
      mag = gip::sobel_magnitude(g);
    }
    const uint8_t out = static_cast<uint8_t>(mag);
    uint8_t* o = dst + static_cast<size_t>(y) * row_bytes +
                 static_cast<size_t>(x) * channels;
    for (int c = 0; c < channels; ++c) o[c] = out;
  }
}

template <bool kQuantGray>
int launch(const uint8_t* src, uint8_t* dst, int batch, int height, int width,
           int channels, void* stream) {
  sobel_edges<kQuantGray><<<gip::rows_grid(width, height, batch),
                            gip::kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      src, dst, height, width, channels);
  return cudaGetLastError();
}

}  // namespace

// src, dst: (B, H, W*C) uint8 with C in {1, 3, 4}.  Level 2: quantized grey.
extern "C" int gip_sobel_rows(const uint8_t* src, uint8_t* dst, int batch,
                              int height, int width, int channels,
                              void* stream) {
  return launch<true>(src, dst, batch, height, width, channels, stream);
}

// The same with the grey value kept in f32 (level-1 numerics, level 4).
extern "C" int gip_sobel_f32_rows(const uint8_t* src, uint8_t* dst, int batch,
                                  int height, int width, int channels,
                                  void* stream) {
  return launch<false>(src, dst, batch, height, width, channels, stream);
}
