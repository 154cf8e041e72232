// Separable gaussian and box blurs on (N, H, W) uint8 planes, both passes in
// one launch.
//
// Replaces the TPU kernel
//   gpu_image_processing_tpu/ops/pallas/blur.py::_blur_kernel as
//   `_separable_blur_planar` (blur.py:664, call :784) launches it: on the
//   (C, H, W) planes of one image (gaussian_pallas, box_pallas, :1090,
//   :1107) and the (B*C, H, W) planes of a batch (gaussian_pallas_batch,
//   box_pallas_batch, :1055, :1075), in its weighted (level 2), folded
//   (level 4, r < 3) and box modes, and with `rows_prepadded` (the input
//   carries r given halo rows above and below, as the row bands of a split
//   image do),
// with what it computes, not how the TPU had to tile it: each pass clamps
// at the true edge of the pixel's own plane, and the horizontal result is
// quantized to uint8 before the vertical pass reads it.
//
// Numerics: `taps_value` of taps.cuh, the tap orders of blur.cu, then
// floor(acc + 0.5) after each pass; bit-exact against the plain versions
// (ops/interleaved.py on planes, one channel).
//
// Design: a block owns a kTileH x kTileW output tile of one plane; the
// grid's z dimension is the plane.  The block loads the (kTileH + 2r) x
// (kTileW + 2r) input tile into shared memory, each pixel clamped at its
// plane's own edge (never read across planes); runs the horizontal pass for
// all kTileH + 2r rows into a u8 shared tile; then, after a barrier, the
// vertical pass from that tile into device memory.  The intermediate never
// leaves the SM, so the kernel reads the image once and writes it once: it
// is bound by those 2 N H W bytes (a blur in two launches moves twice as
// many).  Neighbouring blocks recompute the 2r halo rows of the
// intermediate; the horizontal pass is row-local and deterministic, so the
// values agree (the argument of spatial.py:100-104).  That recompute costs
// (kTileH + 2r) / kTileH horizontal passes, 2.9 at r = 31.  Shared memory,
// (kTileH + 2r)(kTileW + 2r) + (kTileH + 2r) kTileW bytes, is 29,892 bytes
// at the cap r = 31: under the 48 KB a launch may take without opting in.

#include "launch.cuh"
#include "taps.cuh"

namespace {

using gip::clamp_index;
using gip::quantize_u8;
using gip::taps_value;

constexpr int kTileW = 128;    // output columns of a block, one per thread
constexpr int kTileH = 32;     // output rows of a block
constexpr int kRowGroups = 2;  // blockDim = (kTileW, kRowGroups)
// 2r + 1 <= 64 taps (core/config.py MAX_KERNEL_TAPS) sizes the tiles.
constexpr int kMaxRadius = 31;

int shared_bytes(int radius) {
  const int rows = kTileH + 2 * radius;
  return rows * (kTileW + 2 * radius) + rows * kTileW;
}

// src: (N, src_rows, W) with src_rows = H, or H + 2r when rows_prepadded;
// dst: (N, H, W).
template <typename Mode>
__global__ void __launch_bounds__(kTileW * kRowGroups)
blur_planar(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
            const float* __restrict__ w, float inv, int radius, int height,
            int width, int src_rows, bool rows_prepadded) {
  extern __shared__ uint8_t smem[];
  const int rows = kTileH + 2 * radius;
  const int cols = kTileW + 2 * radius;
  uint8_t* in = smem;                 // rows x cols input pixels
  uint8_t* mid = smem + rows * cols;  // rows x kTileW horizontal results
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  src += static_cast<size_t>(blockIdx.z) * src_rows * width;
  dst += static_cast<size_t>(blockIdx.z) * height * width;

  // Tile row i is image row y0 + i - r, clamped to the plane; with the halo
  // rows given it is input row y0 + i, clamped only past the plane's last
  // row (rows that no output reads).
  for (int i = threadIdx.y; i < rows; i += kRowGroups) {
    const int y = rows_prepadded ? min(y0 + i, src_rows - 1)
                                 : clamp_index(y0 + i - radius, height);
    const uint8_t* row = src + static_cast<size_t>(y) * width;
    for (int j = threadIdx.x; j < cols; j += kTileW) {
      in[i * cols + j] = row[clamp_index(x0 + j - radius, width)];
    }
  }
  __syncthreads();

  const int j = threadIdx.x;
  for (int i = threadIdx.y; i < rows; i += kRowGroups) {
    const uint8_t* px = in + i * cols + j;
    const auto load = [&](int t) -> int { return px[t]; };
    mid[i * kTileW + j] = static_cast<uint8_t>(
        quantize_u8(taps_value<Mode>(load, w, inv, radius)));
  }
  __syncthreads();

  const int x = x0 + j;
  if (x >= width) return;
  for (int i = threadIdx.y; i < kTileH && y0 + i < height; i += kRowGroups) {
    const uint8_t* px = mid + i * kTileW + j;
    const auto load = [&](int t) -> int { return px[t * kTileW]; };
    dst[static_cast<size_t>(y0 + i) * width + x] = static_cast<uint8_t>(
        quantize_u8(taps_value<Mode>(load, w, inv, radius)));
  }
}

template <typename Mode>
int launch(const uint8_t* src, uint8_t* dst, const float* w, float inv,
           int radius, int planes, int height, int width, int rows_prepadded,
           void* stream) {
  if (radius < 1 || radius > kMaxRadius) return cudaErrorInvalidValue;
  const dim3 grid((width + kTileW - 1) / kTileW,
                  (height + kTileH - 1) / kTileH, planes);
  const int src_rows = rows_prepadded ? height + 2 * radius : height;
  blur_planar<Mode><<<grid, dim3(kTileW, kRowGroups), shared_bytes(radius),
                      static_cast<cudaStream_t>(stream)>>>(
      src, dst, w, inv, radius, height, width, src_rows, rows_prepadded != 0);
  return cudaGetLastError();
}

}  // namespace

// src: (N, H, W) uint8 planes, or (N, H + 2r, W) when rows_prepadded;
// dst: (N, H, W).  weights: (2r+1,) float32 on the device, r <= 31.
extern "C" int gip_gaussian_planar(const uint8_t* src, uint8_t* dst,
                                   const float* weights, int radius,
                                   int planes, int height, int width,
                                   int rows_prepadded, void* stream) {
  return launch<gip::Weighted>(src, dst, weights, 0.0f, radius, planes,
                               height, width, rows_prepadded, stream);
}

extern "C" int gip_gaussian_folded_planar(const uint8_t* src, uint8_t* dst,
                                          const float* weights, int radius,
                                          int planes, int height, int width,
                                          int rows_prepadded, void* stream) {
  return launch<gip::Folded>(src, dst, weights, 0.0f, radius, planes, height,
                             width, rows_prepadded, stream);
}

// inv: the f32 reciprocal 1/(2r+1), computed on the host.
extern "C" int gip_box_planar(const uint8_t* src, uint8_t* dst, float inv,
                              int radius, int planes, int height, int width,
                              int rows_prepadded, void* stream) {
  return launch<gip::Box>(src, dst, nullptr, inv, radius, planes, height,
                          width, rows_prepadded, stream);
}
