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
// because Mosaic has no strided lane load (sobel_mxu.py:3-9).  Here a block
// reads its pixels' channels from shared memory directly.
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
// Bound on this card: its bytes, one read and one write of the image (the
// float work, 35 operations a pixel, is under two thirds of that time at one
// instruction an operation).  The old kernel ran one thread a pixel and a
// row a block; each thread recomputed the grey value of its 9 neighbours (27
// byte loads, 9 grey computations where 1 would do) and wrote its C bytes
// with C strided byte stores.  The redesign, sobel_tile_rows<kQuantGray, C>:
//   * a block of 256 threads owns a kTileH x kTileW (8 x 128) output tile of
//     one image; it stages the (kTileH + 2) x (kTileW + 2) x C input bytes
//     with stage_rows (16-byte cp.async copies; pixels past the image are
//     clamped, and only border outputs, which are 0, read them);
//   * it computes each pixel's grey value once into a shared f32 tile,
//     (kTileH + 2) / kTileH = 1.25 grey values an output, the u8 values
//     made f32 on the FP32 unit (u8_to_f32), not the conversion unit;
//   * each thread computes kColumnRows = 4 outputs down one column from a
//     3x3 register window, three shared loads an output, with no branch
//     (tools/sass_counts.py counts its instructions);
//   * it writes the magnitude, replicated to C channels, into an output
//     tile in shared memory (over the staged input, no longer needed), laid
//     out at each row's 16-byte phase in device memory, and copies the tile
//     out with 16-byte stores (byte stores only at each row's ragged ends).
//   C is a template parameter (1, 3 or 4), so the channel strides and the
//   replicated store are fixed offsets.  Short tiles and 6 blocks an SM
//   were the fastest shape in development probes on the H100 (8-row tiles
//   against 16 and 32, 128-pixel against 64 and 256, 3 to 8 blocks an SM):
//   what holds it is latency between its three barriers more than issue,
//   so more blocks in flight moved it, and a block that walked a band of
//   tiles with the next tile's copies in flight was slower (fewer blocks).

#include "edges.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileW = 128;   // output pixels of a tile row, a thread each
constexpr int kTileH = 8;     // output rows of a tile
constexpr int kColumnRows = kTileH / (kThreads / kTileW);   // rows a thread
constexpr int kGreyRows = kTileH + 2;
constexpr int kGreyCols = kTileW + 2;
// stage_rows calls write shift entries in groups of kStageRows.
constexpr int kShiftRows =
    (kGreyRows + gip::kStageRows - 1) / gip::kStageRows * gip::kStageRows;
constexpr int kBlocksPerSM = 6;

// Bytes of a staged input row: (kTileW + 2) * C, plus 15 for its 16-byte
// phase, rounded to an odd multiple of 16 (rows on other banks).  The output
// tile (kTileW * C bytes a row, plus its phase) fits the same stride.
__host__ __device__ inline int tile_stride(int channels) {
  return ((kTileW + 2) * channels + 15 + 15) / 16 * 16 | 16;
}

template <bool kQuantGray, int C>
__device__ __forceinline__ float gray(const uint8_t* px) {
  if constexpr (C == 1) {
    return gip::u8_to_f32(px[0]);
  } else {
    return gip::gray_rgb<kQuantGray>(gip::u8_to_f32(px[0]),
                                     gip::u8_to_f32(px[1]),
                                     gip::u8_to_f32(px[2]));
  }
}

// blockIdx.z is the image of the batch.  C is a template parameter: the
// replicated store and the channel strides then compile to fixed offsets.
// Registers are capped for kBlocksPerSM blocks an SM.
template <bool kQuantGray, int C>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
sobel_tile_rows(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                int height, int width) {
  extern __shared__ __align__(128) uint8_t tile[];   // staged input, then output
  __shared__ float grey[kGreyRows][kGreyCols];
  __shared__ int shift[kShiftRows];
  const int lanes = width * C;
  const int stride = tile_stride(C);
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const size_t image = static_cast<size_t>(blockIdx.z) * height * lanes;
  src += image;
  dst += image;

  // Staged row i is image row clamp(y0 - 1 + i); staged pixel j is pixel
  // clamp(x0 - 1 + j).
  for (int i0 = 0; i0 < kGreyRows; i0 += gip::kStageRows) {
    gip::stage_rows<kThreads>(src, tile + i0 * stride, shift + i0, stride,
                              (x0 - 1) * C, kGreyCols * C, lanes, C, y0 - 1 + i0,
                              min(gip::kStageRows, kGreyRows - i0), height);
  }
  gip::wait_async_copies();
  __syncthreads();

  // Grey: a thread takes column j of every kThreads / kTileW-th row; the
  // first 2 * kGreyRows threads also take the last two columns.
  const int j = threadIdx.x % kTileW;
  for (int i = threadIdx.x / kTileW; i < kGreyRows; i += kThreads / kTileW) {
    grey[i][j] = gray<kQuantGray, C>(tile + i * stride + shift[i] + j * C);
  }
  if (threadIdx.x < 2 * kGreyRows) {
    const int i = threadIdx.x / 2;
    const int jj = kTileW + threadIdx.x % 2;
    grey[i][jj] = gray<kQuantGray, C>(tile + i * stride + shift[i] + jj * C);
  }
  __syncthreads();

  // Output row y0 + r, pixel x0 + j, reads grey rows r .. r + 2 and columns
  // j .. j + 2; its C bytes go to tile row r (over the staged input, no
  // longer needed) at that row's 16-byte phase in device memory, which
  // steps by `lanes` a row.  Every thread computes and writes all its rows,
  // without branches: the tile has room for them, and the copy out takes
  // only the image's rows and pixels.
  const int r0 = threadIdx.x / kTileW * kColumnRows;
  const int x = x0 + j;
  const bool col_inside = x >= 1 && x <= width - 2;
  int phase = static_cast<int>(
      reinterpret_cast<uintptr_t>(dst + static_cast<size_t>(y0 + r0) * lanes + x0 * C) & 15);
  float g[3][3];
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) g[dy][dx] = grey[r0 + dy][j + dx];
  }
#pragma unroll
  for (int k = 0; k < kColumnRows; ++k) {
    const int r = r0 + k;
    const int y = y0 + r;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) g[2][dx] = grey[r + 2][j + dx];
    const float m = gip::sobel_magnitude(g);
    const float mag = col_inside && y >= 1 && y <= height - 2 ? m : 0.0f;
    uint8_t* o = tile + r * stride + phase + j * C;
    // mag is a whole number in [0, 255]: 2^23 + mag is exact, and its low
    // byte is mag (no trip through the conversion unit).
    const uint8_t v = static_cast<uint8_t>(__float_as_int(__fadd_rn(mag, 8388608.0f)));
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = v;
    phase = (phase + lanes) & 15;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      g[0][dx] = g[1][dx];
      g[1][dx] = g[2][dx];
    }
  }
  __syncthreads();

  // Copy the tile out, a warp a row: 16-byte stores between the row's
  // ragged ends.
  const int len = min(kTileW, width - x0) * C;
  const int rows = min(kTileH, height - y0);
  for (int r = threadIdx.x / 32; r < rows; r += kThreads / 32) {
    uint8_t* a = dst + static_cast<size_t>(y0 + r) * lanes + x0 * C;
    const int sh = static_cast<int>(reinterpret_cast<uintptr_t>(a) & 15);
    uint8_t* base = a - sh;   // 16-byte aligned
    const uint8_t* row = tile + r * stride;
    const int end = sh + len;
    const int vec_begin = (sh + 15) & ~15;
    const int vec_end = end & ~15;
    for (int c = vec_begin + threadIdx.x % 32 * 16; c < vec_end; c += 32 * 16) {
      *reinterpret_cast<uint4*>(base + c) = *reinterpret_cast<const uint4*>(row + c);
    }
    const int head = sh + threadIdx.x % 32;
    if (head < min(vec_begin, end)) base[head] = row[head];
    const int tail = max(vec_end, vec_begin) + threadIdx.x % 32;
    if (tail < end) base[tail] = row[tail];
  }
}

template <bool kQuantGray, int C>
int launch_c(const uint8_t* src, uint8_t* dst, int batch, int height,
             int width, cudaStream_t stream) {
  // Under 48 KB of shared memory at C <= 4 (with the grey tile), so no
  // opt-in.
  sobel_tile_rows<kQuantGray, C>
      <<<dim3((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH,
              batch),
         kThreads, kGreyRows * tile_stride(C), stream>>>(src, dst, height, width);
  return cudaGetLastError();
}

template <bool kQuantGray>
int launch(const uint8_t* src, uint8_t* dst, int batch, int height, int width,
           int channels, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (channels) {
    case 1: return launch_c<kQuantGray, 1>(src, dst, batch, height, width, s);
    case 3: return launch_c<kQuantGray, 3>(src, dst, batch, height, width, s);
    case 4: return launch_c<kQuantGray, 4>(src, dst, batch, height, width, s);
    default: return cudaErrorInvalidValue;
  }
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
