// Sobel edge magnitude on (B, C, H, W) uint8 planes.
//
// Replaces the TPU kernels
//   gpu_image_processing_tpu/ops/pallas/sobel.py::_sobel_kernel (:121, call
//     :535): the (C, H, W) planes of one image (sobel_pallas), batch 1 here;
//   gpu_image_processing_tpu/ops/pallas/sobel.py::_sobel_kernel_batch (:143,
//     call :441): a (B, C, H, W) batch (sobel_pallas_batch), with
//     `rows_prepadded` (one given halo row above and below each image, as
//     the row bands of a split image carry) and `zero_rows=False` (the
//     caller zeroes the first and last rows of the whole image itself),
// at both numerics levels: level 2 quantizes the grey value, level 1 keeps
// it in f32.
//
// Numerics, per output pixel (edges.cuh): grey (0.299R + 0.587G) + 0.114B
// with every operation rounded (C = 1: the plane itself; alpha ignored),
// floor(grey + 0.5) at level 2; gx and gy in the term order of
// sobel.py:94-103; floor(min(sqrt(gx*gx + gy*gy), 255) + 0.5).  The 1-pixel
// width border is 0, and so are the first and last rows unless zero_rows is
// false.  Outside the image the grey rows read 0, the TPU kernels'
// constant row pad.  The value goes to every plane, alpha included.
//
// Design: a block owns a kTileH x kTileW output tile of one image (the
// grid's z dimension is the image).  It computes the (kTileH + 2) x
// (kTileW + 2) grey tile into shared memory from the C planes, once per
// pixel (K7's `gbuf`, sobel.py:68-89), then each thread reads its 3x3
// neighbourhood from that tile.  Bound by memory traffic: one read of the
// C planes and one write.  Shared memory: 34 x 130 floats, 17,680 bytes.

#include "edges.cuh"

namespace {

constexpr int kTileW = 128;    // output columns of a block, one per thread
constexpr int kTileH = 32;     // output rows of a block
constexpr int kRowGroups = 2;  // blockDim = (kTileW, kRowGroups)

// src: (B, C, src_rows, W) with src_rows = H, or H + 2 when rows_prepadded;
// dst: (B, C, H, W).
template <bool kQuantGray>
__global__ void __launch_bounds__(kTileW * kRowGroups)
sobel_planar(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
             int channels, int height, int width, int src_rows,
             bool rows_prepadded, bool zero_rows) {
  __shared__ float gbuf[kTileH + 2][kTileW + 2];
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const size_t plane_in = static_cast<size_t>(src_rows) * width;
  const size_t plane_out = static_cast<size_t>(height) * width;
  src += static_cast<size_t>(blockIdx.z) * channels * plane_in;
  dst += static_cast<size_t>(blockIdx.z) * channels * plane_out;

  // Tile (i, j) is input row y0 + i - 1 (y0 + i with the halo rows given)
  // and column x0 + j - 1.
  for (int i = threadIdx.y; i < kTileH + 2; i += kRowGroups) {
    const int y = rows_prepadded ? y0 + i : y0 + i - 1;
    for (int j = threadIdx.x; j < kTileW + 2; j += kTileW) {
      const int x = x0 + j - 1;
      float g = 0.0f;
      if (y >= 0 && y < src_rows && x >= 0 && x < width) {
        const uint8_t* px = src + static_cast<size_t>(y) * width + x;
        g = channels == 1
                ? static_cast<float>(px[0])
                : gip::gray_rgb<kQuantGray>(static_cast<float>(px[0]),
                                            static_cast<float>(px[plane_in]),
                                            static_cast<float>(px[2 * plane_in]));
      }
      gbuf[i][j] = g;
    }
  }
  __syncthreads();

  const int j = threadIdx.x;
  const int x = x0 + j;
  if (x >= width) return;
  for (int i = threadIdx.y; i < kTileH && y0 + i < height; i += kRowGroups) {
    const int y = y0 + i;
    float mag = 0.0f;
    if (x >= 1 && x <= width - 2 &&
        (!zero_rows || (y >= 1 && y <= height - 2))) {
      float g[3][3];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) g[dy][dx] = gbuf[i + dy][j + dx];
      }
      mag = gip::sobel_magnitude(g);
    }
    const uint8_t out = static_cast<uint8_t>(mag);
    uint8_t* o = dst + static_cast<size_t>(y) * width + x;
    for (int c = 0; c < channels; ++c) o[c * plane_out] = out;
  }
}

template <bool kQuantGray>
int launch(const uint8_t* src, uint8_t* dst, int batch, int channels,
           int height, int width, int rows_prepadded, int zero_rows,
           void* stream) {
  const dim3 grid((width + kTileW - 1) / kTileW,
                  (height + kTileH - 1) / kTileH, batch);
  sobel_planar<kQuantGray><<<grid, dim3(kTileW, kRowGroups), 0,
                             static_cast<cudaStream_t>(stream)>>>(
      src, dst, channels, height, width,
      rows_prepadded ? height + 2 : height, rows_prepadded != 0,
      zero_rows != 0);
  return cudaGetLastError();
}

}  // namespace

// src: (B, C, H, W) uint8 with C in {1, 3, 4}, or (B, C, H + 2, W) when
// rows_prepadded; dst: (B, C, H, W).  Level 2: quantized grey.
extern "C" int gip_sobel_planar(const uint8_t* src, uint8_t* dst, int batch,
                                int channels, int height, int width,
                                int rows_prepadded, int zero_rows,
                                void* stream) {
  return launch<true>(src, dst, batch, channels, height, width,
                      rows_prepadded, zero_rows, stream);
}

// The same with the grey value kept in f32 (level-1 numerics, level 4).
extern "C" int gip_sobel_f32_planar(const uint8_t* src, uint8_t* dst,
                                    int batch, int channels, int height,
                                    int width, int rows_prepadded,
                                    int zero_rows, void* stream) {
  return launch<false>(src, dst, batch, channels, height, width,
                       rows_prepadded, zero_rows, stream);
}
