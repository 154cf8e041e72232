// Sobel edge magnitude on (B, H, W*C) interleaved uint8 rows and on (B, C,
// H, W) uint8 planes.
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
// On planes (sobel_planar, sobel_f32_planar) it also replaces
//   gpu_image_processing_tpu/ops/pallas/sobel.py::_sobel_kernel (:121, call
//     :535): the (C, H, W) planes of one image, a batch of 1 here, and
//   sobel.py::_sobel_kernel_batch (:143, call :441): a (B, C, H, W) batch,
//     with `rows_prepadded` (one given halo row above and below each image,
//     as the row bands of a split image carry) and `zero_rows=False` (the
//     caller zeroes the first and last rows of the whole image itself).
//
// Numerics, per output pixel (edges.cuh):
//   gray = (0.299f*R + 0.587f*G) + 0.114f*B with every product and sum
//          rounded (C = 1: the value itself), quantized to floor(gray + 0.5)
//          when kQuantGray (level 2), kept in f32 otherwise (level 1);
//   gx, gy in the term order of sobel.py:209-218;
//   floor(min(sqrt(gx*gx + gy*gy), 255) + 0.5), 0 on each image's 1-pixel
//   border (an image thinner than 3 pixels is all border), where the first
//   and last rows keep their value when zero_rows is false;
//   rows outside the image (past its halo rows, if it has them) read grey
//   0, the TPU kernels' constant row pad (only unzeroed rows see it);
//   the value goes to every channel, alpha included.
//
// Bound on this card: its bytes, one read and one write of the image (the
// float work, 35 operations a pixel, is under two thirds of that time at one
// instruction an operation).  The old kernel ran one thread a pixel and a
// row a block; each thread recomputed the grey value of its 9 neighbours (27
// byte loads, 9 grey computations where 1 would do) and wrote its C bytes
// with C strided byte stores.  The redesign, sobel_tile_rows<kQuantGray, C,
// kPlanar>, is one template for both layouts:
//   * a block of 256 threads owns a kTileH x kTileW output tile of one image
//     (8 x 128 pixels for rows, 8 x 512 for planes); it stages the
//     (kTileH + 2) x (kTileW + 2) input pixels with stage_rows (16-byte
//     cp.async copies; pixels past the image's columns are clamped, and only
//     border outputs, which are 0, read them): one call for the C-byte
//     pixels of the rows layout, one call a plane for the planes that make
//     the grey value (the alpha plane is not read);
//   * it computes each pixel's grey value once into a shared f32 tile,
//     (kTileH + 2) / kTileH = 1.25 grey values an output, the u8 values
//     made f32 on the FP32 unit (u8_to_f32), not the conversion unit;
//   * each thread computes kColumnRows outputs down each of its columns
//     from a 3x3 register window (gip::SobelColumn), three shared loads an
//     output, with no branch (tools/sass_counts.py counts its
//     instructions); products by +-1 and +-2 are exact, so they become
//     subtractions and doublings, and a whole-number grey (level 2, or one
//     channel) keeps each row's two partial sums for the three outputs that
//     read it: 8 operations an output for gx and gy, not 22, the same bits;
//   * it writes the magnitude into an output tile in shared memory (over
//     the staged input, no longer needed), C bytes a pixel for rows, one
//     tile a plane for planes, each row laid out at its 16-byte phase in
//     device memory, and copies the tiles out with 16-byte stores (byte
//     stores only at each row's ragged ends).
//   C and the layout are template parameters, so the channel and plane
//   strides and the replicated store are fixed offsets; the halo rows and
//   zero_rows are arguments of the planar layout only (the row clamp of
//   staging and one predicate), which the rows layout compiles out.
//   For rows, short tiles and 6 blocks an SM were the fastest shape in
//   development probes on the H100 (8-row tiles against 16 and 32, 128-pixel
//   against 64 and 256, 3 to 8 blocks an SM): what holds it is latency
//   between its three barriers more than issue, so more blocks in flight
//   moved it.  A plane's row holds a third of the bytes of an interleaved
//   RGB row, so at the rows' tile a planar block moved a third as many
//   bytes a row for the same latency, and ran slower than the old planar
//   kernel; 512-pixel plane rows (two columns a thread) at 5 blocks an SM
//   were the fastest of 128 to 1024 pixels, 8 and 16 rows and 3 to 6
//   blocks.  With the shorter arithmetic above, 4, 5 and 6 blocks an SM
//   ran within 3% of each other on planes; 5 spills a few bytes at level 2.

#include "edges.cuh"

namespace {

constexpr int kThreads = 256;
// The tile shape (output rows x pixels, a thread a column or more) and the
// blocks an SM of each layout.  Interleaved rows hold C bytes a pixel;
// planes hold one, so their tiles are wider and taller for the same bytes.
constexpr int kRowsTileH = 8, kRowsTileW = 128, kRowsBlocksPerSM = 6;
constexpr int kPlanesTileH = 8, kPlanesTileW = 512, kPlanesBlocksPerSM = 5;

// Bytes of a staged input row of tile_w + 2 pixels of `lane_bytes` bytes,
// plus 15 for its 16-byte phase, rounded to an odd multiple of 16 (rows on
// other banks).  An output row (tile_w * lane_bytes bytes, plus its phase)
// fits the same stride.
__host__ __device__ constexpr int tile_stride(int tile_w, int lane_bytes) {
  return ((tile_w + 2) * lane_bytes + 15 + 15) / 16 * 16 | 16;
}

// The layout of an image: interleaved rows (C bytes a pixel, one row of
// W*C lanes) or C planes of W lanes a row.
template <int C, bool kPlanar>
struct Layout {
  static constexpr int kLaneBytes = kPlanar ? 1 : C;   // bytes a staged pixel
  static constexpr int kPlanes = kPlanar ? C : 1;      // planes an image
  // Planes staged: those that make the grey value (alpha is not read).
  static constexpr int kGreyPlanes = kPlanar && C > 1 ? 3 : 1;
  static constexpr int kTileH = kPlanar ? kPlanesTileH : kRowsTileH;
  static constexpr int kTileW = kPlanar ? kPlanesTileW : kRowsTileW;
  static constexpr int kBlocksPerSM = kPlanar ? kPlanesBlocksPerSM : kRowsBlocksPerSM;
  static constexpr int kGreyRows = kTileH + 2;
  static constexpr int kGreyCols = kTileW + 2;
  // Threads that share a column's rows, and columns a thread takes.
  static constexpr int kColGroups = kTileW < kThreads ? kThreads / kTileW : 1;
  static constexpr int kCols = kTileW > kThreads ? kTileW / kThreads : 1;
  static constexpr int kColumnRows = kTileH / kColGroups;   // rows a thread
  static_assert(kTileW % kThreads == 0 || kThreads % kTileW == 0, "tile width");
  static_assert(kTileH % kColGroups == 0, "tile height");
  // stage_rows calls stage kStageRows rows at a time, shift entries too.
  static constexpr int kShiftRows =
      (kGreyRows + gip::kStageRows - 1) / gip::kStageRows * gip::kStageRows;
  static constexpr int kStride = tile_stride(kTileW, kLaneBytes);
  // Tile rows: the staged planes, then the output tiles over them.
  static constexpr int kTileRows = kGreyPlanes * kGreyRows > kPlanes * kTileH
                                       ? kGreyPlanes * kGreyRows
                                       : kPlanes * kTileH;
  static constexpr int kBytes = kTileRows * kStride;
  // Past 48 KB with the grey tile and shifts, a launch must opt in.
  static constexpr bool kOptIn =
      kBytes + (kGreyRows * kGreyCols + kGreyPlanes * kShiftRows) * 4 > 48 * 1024;
};

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

// blockIdx.z is the image of the batch.  Planes only (the rows layout
// compiles them out): halo_rows, 0 or 1 when each image carries one given
// halo row above and below its `height` output rows; zero_rows, whether
// the first and last output rows are 0.  Registers are capped for the
// layout's blocks an SM.
template <bool kQuantGray, int C, bool kPlanar>
__global__ void __launch_bounds__(kThreads, Layout<C, kPlanar>::kBlocksPerSM)
sobel_tile_rows(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                int height, int width, int halo_rows, int zero_rows) {
  using L = Layout<C, kPlanar>;
  constexpr int kTileH = L::kTileH, kTileW = L::kTileW, kGreyRows = L::kGreyRows;
  constexpr int LB = L::kLaneBytes;
  constexpr int stride = L::kStride;
  constexpr int kPlaneTile = kGreyRows * stride;   // a staged plane's bytes
  extern __shared__ __align__(128) uint8_t tile[];   // staged input, then output
  __shared__ float grey[kGreyRows][L::kGreyCols];
  __shared__ int shift[L::kGreyPlanes][L::kShiftRows];
  const int halo = kPlanar ? halo_rows : 0;
  const int lanes = width * LB;   // bytes of a row of a plane
  const int in_rows = height + 2 * halo;
  const size_t plane_in = static_cast<size_t>(in_rows) * lanes;
  const size_t plane_out = static_cast<size_t>(height) * lanes;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  // src points at output row 0 of the image's first plane.
  src += static_cast<size_t>(blockIdx.z) * L::kPlanes * plane_in +
         static_cast<size_t>(halo) * lanes;
  dst += static_cast<size_t>(blockIdx.z) * L::kPlanes * plane_out;

  // Staged row i is virtual row v = y0 - 1 + i, input row clamp(v) (v + 1
  // with the halo row given); staged pixel j is pixel clamp(x0 - 1 + j).
#pragma unroll
  for (int p = 0; p < L::kGreyPlanes; ++p) {
#pragma unroll
    for (int i0 = 0; i0 < kGreyRows; i0 += gip::kStageRows) {
      gip::stage_rows<kThreads>(src + p * plane_in, tile + p * kPlaneTile + i0 * stride,
                                shift[p] + i0, stride, (x0 - 1) * LB,
                                L::kGreyCols * LB, lanes, LB, y0 - 1 + i0,
                                min(gip::kStageRows, kGreyRows - i0), -halo,
                                in_rows);
    }
  }
  gip::wait_async_copies();
  __syncthreads();

  // Grey of staged pixel (i, j).  Planes: 0 for a row outside the image
  // and its halo rows, which a row kept with zero_rows false reads.
  const auto grey_at = [&](int i, int j) -> float {
    if constexpr (kPlanar) {
      const int v = y0 - 1 + i;
      if (v < -halo || v >= height + halo) return 0.0f;
    }
    const uint8_t* px = tile + i * stride + j * LB;
    if constexpr (kPlanar && C > 1) {
      return gip::gray_rgb<kQuantGray>(
          gip::u8_to_f32(px[shift[0][i]]),
          gip::u8_to_f32(px[kPlaneTile + shift[1][i]]),
          gip::u8_to_f32(px[2 * kPlaneTile + shift[2][i]]));
    } else {
      return gray<kQuantGray, LB>(px + shift[0][i]);
    }
  };
  // A thread takes its columns j + q * kThreads of every kColGroups-th row
  // from its group's; the first 2 * kGreyRows threads also take the last
  // two columns.
  const int j = kTileW < kThreads ? threadIdx.x % kTileW : threadIdx.x;
  const int group = kTileW < kThreads ? threadIdx.x / kTileW : 0;
  for (int i = group; i < kGreyRows; i += L::kColGroups) {
#pragma unroll
    for (int q = 0; q < L::kCols; ++q) {
      grey[i][j + q * kThreads] = grey_at(i, j + q * kThreads);
    }
  }
  if (threadIdx.x < 2 * kGreyRows) {
    const int i = threadIdx.x / 2;
    const int jj = kTileW + threadIdx.x % 2;
    grey[i][jj] = grey_at(i, jj);
  }
  __syncthreads();

  // Output row y0 + r, pixel x0 + jq, reads grey rows r .. r + 2 and
  // columns jq .. jq + 2.  Its bytes go to output tile row r (over the
  // staged input, no longer needed; a tile a plane for planes) at that
  // row's 16-byte phase in device memory, which steps by `lanes` a row.
  // Every thread computes and writes all its rows, without branches: the
  // tile has room for them, and the copy out takes only the image's rows
  // and pixels.
  const int r0 = group * L::kColumnRows;
#pragma unroll
  for (int q = 0; q < L::kCols; ++q) {
    const int jq = j + q * kThreads;
    const int x = x0 + jq;
    const bool col_inside = x >= 1 && x <= width - 2;
    int phase[L::kPlanes];
#pragma unroll
    for (int p = 0; p < L::kPlanes; ++p) {
      phase[p] = static_cast<int>(
          reinterpret_cast<uintptr_t>(dst + p * plane_out +
                                      static_cast<size_t>(y0 + r0) * lanes +
                                      x0 * LB) & 15);
    }
    gip::SobelColumn<kQuantGray || C == 1> column;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      column.push(grey[r0 + dy][jq], grey[r0 + dy][jq + 1], grey[r0 + dy][jq + 2]);
    }
#pragma unroll
    for (int k = 0; k < L::kColumnRows; ++k) {
      const int r = r0 + k;
      const int y = y0 + r;
      column.push(grey[r + 2][jq], grey[r + 2][jq + 1], grey[r + 2][jq + 2]);
      const float m = column.magnitude();
      const bool row_inside = (kPlanar && !zero_rows) || (y >= 1 && y <= height - 2);
      const float mag = col_inside && row_inside ? m : 0.0f;
      // mag is a whole number in [0, 255]: 2^23 + mag is exact, and its
      // low byte is mag (no trip through the conversion unit).
      const uint8_t v = static_cast<uint8_t>(__float_as_int(__fadd_rn(mag, 8388608.0f)));
#pragma unroll
      for (int p = 0; p < L::kPlanes; ++p) {
        uint8_t* o = tile + (p * kTileH + r) * stride + phase[p] + jq * LB;
#pragma unroll
        for (int c = 0; c < LB; ++c) o[c] = v;
        phase[p] = (phase[p] + lanes) & 15;
      }
    }
  }
  __syncthreads();

  // Copy the tiles out, a warp a row of a plane: 16-byte stores between
  // the row's ragged ends.
  const int len = min(kTileW, width - x0) * LB;
  const int rows = min(kTileH, height - y0);
#pragma unroll
  for (int p = 0; p < L::kPlanes; ++p) {
    for (int r = threadIdx.x / 32; r < rows; r += kThreads / 32) {
      uint8_t* a = dst + p * plane_out + static_cast<size_t>(y0 + r) * lanes + x0 * LB;
      const int sh = static_cast<int>(reinterpret_cast<uintptr_t>(a) & 15);
      uint8_t* base = a - sh;   // 16-byte aligned
      const uint8_t* row = tile + (p * kTileH + r) * stride;
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
}

template <bool kQuantGray, int C, bool kPlanar>
int launch_c(const uint8_t* src, uint8_t* dst, int batch, int height,
             int width, int halo, int zero_rows, cudaStream_t stream) {
  using L = Layout<C, kPlanar>;
  constexpr auto kernel = sobel_tile_rows<kQuantGray, C, kPlanar>;
  if constexpr (L::kOptIn) {
    const cudaError_t err = gip::allow_shared<kernel>(L::kBytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3((width + L::kTileW - 1) / L::kTileW,
                (height + L::kTileH - 1) / L::kTileH, batch),
           kThreads, L::kBytes, stream>>>(src, dst, height, width, halo,
                                          zero_rows);
  return cudaGetLastError();
}

template <bool kQuantGray, bool kPlanar>
int launch(const uint8_t* src, uint8_t* dst, int batch, int height, int width,
           int channels, int halo, int zero_rows, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (channels) {
    case 1: return launch_c<kQuantGray, 1, kPlanar>(src, dst, batch, height, width, halo, zero_rows, s);
    case 3: return launch_c<kQuantGray, 3, kPlanar>(src, dst, batch, height, width, halo, zero_rows, s);
    case 4: return launch_c<kQuantGray, 4, kPlanar>(src, dst, batch, height, width, halo, zero_rows, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// src, dst: (B, H, W*C) uint8 with C in {1, 3, 4}.  Level 2: quantized grey.
extern "C" int gip_sobel_rows(const uint8_t* src, uint8_t* dst, int batch,
                              int height, int width, int channels,
                              void* stream) {
  return launch<true, false>(src, dst, batch, height, width, channels, 0, 1,
                             stream);
}

// The same with the grey value kept in f32 (level-1 numerics, level 4).
extern "C" int gip_sobel_f32_rows(const uint8_t* src, uint8_t* dst, int batch,
                                  int height, int width, int channels,
                                  void* stream) {
  return launch<false, false>(src, dst, batch, height, width, channels, 0, 1,
                              stream);
}

// src: (B, C, H, W) uint8 planes with C in {1, 3, 4}, or (B, C, H + 2, W)
// when rows_prepadded; dst: (B, C, H, W).  Level 2: quantized grey.
extern "C" int gip_sobel_planar(const uint8_t* src, uint8_t* dst, int batch,
                                int channels, int height, int width,
                                int rows_prepadded, int zero_rows,
                                void* stream) {
  return launch<true, true>(src, dst, batch, height, width, channels,
                            rows_prepadded ? 1 : 0, zero_rows, stream);
}

// The same with the grey value kept in f32 (level-1 numerics, level 4).
extern "C" int gip_sobel_f32_planar(const uint8_t* src, uint8_t* dst,
                                    int batch, int channels, int height,
                                    int width, int rows_prepadded,
                                    int zero_rows, void* stream) {
  return launch<false, true>(src, dst, batch, height, width, channels,
                             rows_prepadded ? 1 : 0, zero_rows, stream);
}
