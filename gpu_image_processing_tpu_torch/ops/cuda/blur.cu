// Separable gaussian and box blurs on (B, H, W*C) interleaved uint8 rows.
// Every pass clamps at the true image edge: a horizontal tap t of lane l
// reads pixel clamp(l / C + t - r, 0, W - 1) in the same channel, a vertical
// tap clamps within the lane's own image (a batch, on the grid's z
// dimension, is never blurred across images), and the horizontal result is
// quantized to uint8, floor(x + 0.5), before the vertical pass reads it.
//
// gaussian_rows, gaussian_folded_rows (`separable` below) replace
//   gpu_image_processing_tpu/ops/pallas/blur.py::_blur_kernel, weighted
//   (level 2) and folded (level 4, r < 3), and its batched rows variant
//   (blur.py:985).  Two launches, one thread per output byte, the u8
//   intermediate in device memory, the scalar tap loops of taps.cuh:
//   bit-exact against ops/interleaved.py, bound by instruction issue (about
//   ten instructions a tap).
//
// box_window_rows and box_wide_h/_v (box_rows) replace
//   gpu_image_processing_tpu/ops/pallas/blur_mxu.py::_gauss_mxu_kernel in
//   box mode (the ones band, blur_mxu.py:23-31) and blur.py::_blur_kernel in
//   box mode, with their batched variants (blur_mxu.py:567, blur.py:996).
//   The function is an integer window sum of 2r+1 clamped taps, then
//   __fmul_rn((float)sum, 1/(2r+1)) and floor(x + 0.5), in each direction.
//   Integer sums are exact in any order, so running sums give the plain
//   version's bits (maxdiff 0) while the sum stays below 2^24, which every
//   r below about 32,000 keeps.  The old kernel paid 2r+1 byte loads and adds
//   an output per pass; the bound of the function is its bytes (one read and
//   one write of the image), so the redesign spends O(1) work an output:
//   * box_window_rows, r <= kBoxMaxRadius: one launch.  A block of 256
//     threads owns a strip of at most 512 lanes over a band of rows (sized
//     on the host so that the grid fills the SMs' block slots once) and
//     walks its virtual rows (y0 - r .. y0 + band + r, each clamped to the
//     image) in chunks of kChunk: it stages the chunk's input
//     rows in shared memory (16-byte loads where the strip's halo lies
//     inside the row, byte loads clamped per pixel at the image's edges),
//     runs a horizontal running sum along runs of kRun pixels of one channel
//     (add the incoming tap, subtract the outgoing one), and writes the
//     quantized rows into a shared ring of 2r + kChunk rows; then each
//     thread adds the newest ring row to the column sums it holds in
//     registers for 2 lanes, emits an output row, and subtracts the ring row
//     2r back.  The intermediate never reaches device memory.  Work an
//     output: about 2 loads and adds a pass, plus (2r+1)/kRun for the first
//     window of each run and (band + 2r)/band for the halo rows a band
//     recomputes.  What bounds it on the card is latency more than bytes:
//     each chunk is three dependent phases between barriers, so the
//     registers are capped (kBoxBlocksPerSM) to keep 4 blocks on an SM;
//     uncapped, half as many fitted and it ran slower.
//   * box_wide_h, box_wide_v, r > kBoxMaxRadius: the ring would pass the
//     shared memory, so two launches through device memory, one thread per
//     segment of kWideSeg outputs along the pass, a running sum over the
//     clamped sequence after a first window summed in closed form:
//     max(r - p, 0) copies of the first value, max(p + r - (n - 1), 0) of
//     the last, and the values between.  That window costs min(2r + 1, n)
//     loads per segment, so r wider than the image (r > W horizontally,
//     r > H vertically) costs O(W) (O(H)) loads per segment and no more:
//     about W / kWideSeg (H / kWideSeg) extra loads an output.
//
// band_mma_rows (gaussian_band_rows) replaces
//   blur_mxu.py::_gauss_mxu_kernel in gaussian mode (level 4, r >= 3) and
//   its batched variant (blur_mxu.py:506,518): each pass is the banded
//   product x @ B_hi + x @ B_lo of the bf16 split weights
//   (ops/weights.py::bf16_split), as the TPU ran it on its matrix unit.  On
//   this card it runs on the tensor cores (wmma, bf16 16x16x16, f32
//   accumulate), one launch for both passes.  A block owns a 64-row x
//   128-lane output tile of the interleaved rows: it stages the tile's input
//   with the halo, each pixel clamped at its image's edge, as bf16 in
//   shared memory (u8 values are exact in bf16), runs the horizontal band
//   product over the tile's rows plus the 2r halo rows (16 output lanes a
//   product, depth 16 + 2rC rounded up to 16, taps C lanes apart),
//   quantizes, keeps the u8 result as bf16 in shared memory, and runs the
//   vertical band product from the left (depth 16 + 2r, the band read
//   column-major).  The four band tiles are built once per block from the
//   (2r+1,) tables.  Deinterleaving the channels first (band stride 1,
//   depth 16 + 2r) cuts the zero products about C-fold; on rows at C = 3 a
//   deinterleaving variant was slower than this kernel at the main radius,
//   r = 3 (its per-channel gathers and strided stores cost more than the
//   products it saves), and faster at r = 15 and 31.  On planes (C = 1) the
//   two are the same kernel.
//   Numerics: every u8 x bf16 product is exact in f32, but the tensor cores
//   sum in their own order, not tap order, so a value within a few f32 ulps
//   of a .5 tie may round the other way: the kernel is held to maxdiff <= 1
//   on at most 0.1% of bytes against the tap-order plain version
//   (interleaved.py::gaussian_rows_band), as the TPU kernel was held to its
//   level-4 contract (within 1 of level 2); planes and rows sum in other
//   orders, so they are held to each other the same way.  It is
//   deterministic: the same input gives the same bits, and an image of a
//   batch equals its single launch.  Its bound on the card is its bytes;
//   the products are far below the tensor cores' rate, and staging, the
//   quantizing epilogues and the barriers between the three phases take
//   its time.

#include <mma.h>
#include <cuda_bf16.h>

#include "launch.cuh"
#include "taps.cuh"

namespace {

using gip::clamp_index;
using gip::quantize_u8;
using gip::taps_value;

// -- gaussian_rows, gaussian_folded_rows: two passes --------------------------

// Horizontal pass: taps step by whole pixels (C lanes), clamped per pixel.
// blockIdx.z is the image of the batch.
template <typename Mode>
__global__ void blur_h(const uint8_t* __restrict__ src,
                       uint8_t* __restrict__ dst, const float* __restrict__ w,
                       int radius, int height, int width, int channels) {
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
        quantize_u8(taps_value<Mode>(load, w, 0.0f, radius)));
  }
}

// Vertical pass: taps step by whole rows, clamped to the image's own rows.
// blockIdx.z is the image of the batch.
template <typename Mode>
__global__ void blur_v(const uint8_t* __restrict__ src,
                       uint8_t* __restrict__ dst, const float* __restrict__ w,
                       int radius, int height, int lanes) {
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
        quantize_u8(taps_value<Mode>(load, w, 0.0f, radius)));
  }
}

template <typename Mode>
int separable(const uint8_t* src, uint8_t* tmp, uint8_t* dst, const float* w,
              int radius, int batch, int height, int width, int channels,
              void* stream) {
  const int lanes = width * channels;
  const dim3 grid = gip::rows_grid(lanes, height, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  blur_h<Mode><<<grid, gip::kThreads, 0, s>>>(src, tmp, w, radius, height,
                                              width, channels);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  blur_v<Mode><<<grid, gip::kThreads, 0, s>>>(tmp, dst, w, radius, height,
                                              lanes);
  return cudaGetLastError();
}

// Let `kernel` take `bytes` of dynamic shared memory on the current device
// (above 48 KB a launch must opt in).  The attribute is raised, never
// lowered, and set only when a launch needs more than before: a host call
// on every launch would cost more than the kernels.
template <auto kernel>
cudaError_t allow_shared(int bytes) {
  constexpr int kMaxDevices = 64;
  static int allowed[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && bytes <= allowed[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess && device < kMaxDevices) allowed[device] = bytes;
  return err;
}

__device__ __forceinline__ uint8_t box_value(int sum, float inv) {
  return static_cast<uint8_t>(
      quantize_u8(__fmul_rn(static_cast<float>(sum), inv)));
}

// -- box_window_rows: one launch, running sums, a shared ring ----------------

constexpr int kBoxThreads = 256;
constexpr int kBoxLanes = 2;                          // lanes a thread sums
constexpr int kStripLanes = kBoxThreads * kBoxLanes;  // 512
constexpr int kChunk = 16;       // virtual rows staged at a time
constexpr int kRun = 32;         // pixels of one horizontal running sum
constexpr int kBoxMaxRadius = 64;
// Blocks an SM should hold: caps the registers at 64 a thread, since
// latency, not issue, bounds each block's chunk loop.
constexpr int kBoxBlocksPerSM = 4;
constexpr int kMinBandRows = 32;
constexpr int kBoxMaxChannels = kStripLanes / kRun;   // 16

struct BoxGeometry {
  int strip_px;      // pixels of a strip
  int in_len;        // bytes of a staged row: (strip_px + 2r) * C
  int in_stride;     // in_len + 15 rounded to an odd multiple of 16
  int ring_rows;     // 2r + kChunk
  int ring_stride;   // strip_px * C rounded to 16
  __host__ __device__ BoxGeometry(int radius, int channels) {
    strip_px = kStripLanes / channels / kRun * kRun;
    if (strip_px < kRun) strip_px = kRun;
    in_len = (strip_px + 2 * radius) * channels;
    in_stride = (in_len + 15 + 15) / 16 * 16 | 16;   // rows on other banks
    ring_rows = 2 * radius + kChunk;
    ring_stride = (strip_px * channels + 15) / 16 * 16;
  }
  __host__ __device__ int bytes() const {
    return kChunk * in_stride + ring_rows * ring_stride;
  }
};

__global__ void __launch_bounds__(kBoxThreads, kBoxBlocksPerSM)
box_window_rows(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                float inv, int radius, int height, int width, int channels,
                int band_rows) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int shift[kChunk];
  const BoxGeometry g(radius, channels);
  uint8_t* in = smem;                        // kChunk staged input rows
  uint8_t* ring = smem + kChunk * g.in_stride;  // quantized horizontal rows
  const int C = channels;
  const int lanes = width * C;
  const int px0 = blockIdx.x * g.strip_px;
  const int y0 = blockIdx.y * band_rows;
  const int valid_px = min(g.strip_px, width - px0);
  const int valid_lanes = valid_px * C;
  const size_t image = static_cast<size_t>(blockIdx.z) * height * lanes;
  src += image;
  dst += image + px0 * C;
  // Virtual row v is image row clamp(v); output row y reads v = y-r .. y+r.
  const int v_begin = y0 - radius;
  const int v_end = min(y0 + band_rows, height) + radius;
  const int g0 = (px0 - radius) * C;   // row lane of staged byte 0
  const int runs = (valid_px + kRun - 1) / kRun;
  const int taps = 2 * radius + 1;
  // A thread's horizontal running sum, the same in every chunk: row
  // threadIdx.x % kChunk of the chunk and the (channel, run) pair
  // threadIdx.x / kChunk in channel-major order; a strip has at most
  // kStripLanes / kRun pairs.
  static_assert(kChunk * (kStripLanes / kRun) == kBoxThreads,
                "one running sum a thread");
  const int task_k = threadIdx.x % kChunk;
  const int pair = threadIdx.x / kChunk;
  const int task_ch = pair % C;
  const int task_p0 = pair < C * runs ? pair / C * kRun : valid_px;   // idle
  const int task_end = min(task_p0 + kRun, valid_px);

  int colsum[kBoxLanes];
#pragma unroll
  for (int i = 0; i < kBoxLanes; ++i) colsum[i] = 0;

  for (int vc = v_begin; vc < v_end; vc += kChunk) {
    const int nrows = min(kChunk, v_end - vc);
    // Stage: staged byte e of row k, at in[k * in_stride + shift[k] + e],
    // is lane g0 + e of image row clamp(vc + k), its pixel clamped to
    // [0, W - 1].  A strip whose halo lies inside the row copies it with
    // 16-byte loads (shift[k] aligns them in shared memory; the ragged ends
    // go byte by byte); an edge strip clamps byte by byte, with kChunk loads
    // in flight a thread (g0 is a multiple of C, so the channel is e % C).
    if (g0 >= 0 && g0 + g.in_len <= lanes) {
#pragma unroll 2
      for (int k = threadIdx.x / 32; k < nrows; k += kBoxThreads / 32) {
        const uint8_t* a =
            src + static_cast<size_t>(clamp_index(vc + k, height)) * lanes + g0;
        const int sh = static_cast<int>(reinterpret_cast<uintptr_t>(a) & 15);
        const uint8_t* base = a - sh;   // 16-byte aligned
        uint8_t* staged = in + k * g.in_stride;
        const int end = sh + g.in_len;
        if (threadIdx.x % 32 == 0) shift[k] = sh;
        const int vec_begin = (sh + 15) & ~15;   // whole 16-byte chunks
        const int vec_end = end & ~15;
        for (int c = vec_begin + threadIdx.x % 32 * 16; c < vec_end; c += 32 * 16) {
          *reinterpret_cast<uint4*>(staged + c) =
              __ldg(reinterpret_cast<const uint4*>(base + c));
        }
        // The ragged ends, under 16 bytes each: a byte a lane.
        const int head = sh + threadIdx.x % 32;
        if (head < min(vec_begin, end)) staged[head] = base[head];
        const int tail = max(vec_end, vec_begin) + threadIdx.x % 32;
        if (tail < end) staged[tail] = base[tail];
      }
    } else {
      if (threadIdx.x < kChunk) shift[threadIdx.x] = 0;
      for (int e = threadIdx.x; e < g.in_len; e += kBoxThreads) {
        int at = g0 + e;
        if (at < 0) {
          at = e % C;
        } else if (at >= lanes) {
          at = lanes - C + e % C;
        }
        uint8_t v[kChunk];
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          v[k] = k < nrows
                     ? src[static_cast<size_t>(clamp_index(vc + k, height)) * lanes + at]
                     : 0;
        }
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          if (k < nrows) in[k * g.in_stride + e] = v[k];
        }
      }
    }
    __syncthreads();

    // Horizontal: one running sum a (row, channel, run of kRun pixels).
    // Staged pixel j is strip pixel j - r, so output pixel p sums staged
    // pixels p .. p + 2r.  Chunk row k goes to ring row (slot0 + k) mod
    // ring_rows.
    const int slot0 = (vc - v_begin) % g.ring_rows;
    if (task_k < nrows && task_p0 < task_end) {
      const int slot_k = slot0 + task_k < g.ring_rows
                             ? slot0 + task_k : slot0 + task_k - g.ring_rows;
      const uint8_t* x = in + task_k * g.in_stride + shift[task_k] + task_ch;
      uint8_t* h = ring + slot_k * g.ring_stride + task_ch;
      int sum = 0;
#pragma unroll 8
      for (int t = 0; t < taps; ++t) sum += x[(task_p0 + t) * C];
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        const int p = task_p0 + i;
        if (p < task_end) {
          if (i > 0) sum += x[(p + 2 * radius) * C] - x[(p - 1) * C];
          h[p * C] = box_value(sum, inv);
        }
      }
    }
    __syncthreads();

    // Vertical: add the newest row; once a window is whole, emit output row
    // v - r and subtract its oldest row, v - 2r.  The next chunk's
    // horizontal pass overwrites ring rows only after the barrier that
    // follows its staging.
    int slot = slot0;
#pragma unroll 4
    for (int k = 0; k < nrows; ++k) {
      const int age = vc + k - v_begin;
      const uint8_t* add = ring + slot * g.ring_stride;
      const bool emit = age >= 2 * radius;
      // The ring row 2r back (ring_rows > 2r).
      const int old = slot >= 2 * radius ? slot - 2 * radius
                                         : slot - 2 * radius + g.ring_rows;
      const uint8_t* sub = ring + old * g.ring_stride;
      if (++slot == g.ring_rows) slot = 0;
      uint8_t* out = dst + static_cast<size_t>(vc + k - radius) * lanes;
#pragma unroll
      for (int i = 0; i < kBoxLanes; ++i) {
        const int j = threadIdx.x + i * kBoxThreads;
        if (j < valid_lanes) {
          colsum[i] += add[j];
          if (emit) {
            out[j] = box_value(colsum[i], inv);
            colsum[i] -= sub[j];
          }
        }
      }
    }
  }
}

int launch_box_window(const uint8_t* src, uint8_t* dst, float inv, int radius,
                      int batch, int height, int width, int channels,
                      void* stream) {
  if (radius < 1 || radius > kBoxMaxRadius || channels < 1 ||
      channels > kBoxMaxChannels) {
    return cudaErrorInvalidValue;
  }
  const BoxGeometry g(radius, channels);
  cudaError_t err = allow_shared<box_window_rows>(g.bytes());
  if (err != cudaSuccess) return err;
  // The band of rows a block walks: as many bands as fill the SMs' block
  // slots once (a block's time grows with its rows, a partial last wave
  // idles most SMs), at least kMinBandRows (the halo rows a band
  // recomputes cost (band + 2r) / band).  The result does not depend on it.
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, box_window_rows, kBoxThreads, g.bytes());
  }
  if (err != cudaSuccess) return err;
  const long long columns =
      static_cast<long long>((width + g.strip_px - 1) / g.strip_px) * batch;
  const long long bands = std::max(1LL, sms * std::max(per_sm, 1) / columns);
  int band_rows = static_cast<int>((height + bands - 1) / bands + 15) / 16 * 16;
  band_rows = std::max(band_rows, kMinBandRows);
  const dim3 grid((width + g.strip_px - 1) / g.strip_px,
                  (height + band_rows - 1) / band_rows, batch);
  box_window_rows<<<grid, kBoxThreads, g.bytes(),
                    static_cast<cudaStream_t>(stream)>>>(
      src, dst, inv, radius, height, width, channels, band_rows);
  return cudaGetLastError();
}

// -- box_wide_h, box_wide_v: radii past the ring ------------------------------

constexpr int kWideThreads = 256;
constexpr int kWideSeg = 256;    // outputs of one running sum

// Outputs p0 .. p1-1 of one pass over the n values at[0], at[s], ...: the
// window of p0 in closed form over the clamped sequence, then a running sum.
__device__ void wide_segment(const uint8_t* __restrict__ at, size_t s, int n,
                             int p0, int p1, int radius, float inv,
                             uint8_t* __restrict__ out) {
  int sum = max(radius - p0, 0) * at[0] +
            max(p0 + radius - (n - 1), 0) * at[static_cast<size_t>(n - 1) * s];
  const int last = min(p0 + radius, n - 1);
  for (int q = max(p0 - radius, 0); q <= last; ++q) {
    sum += at[static_cast<size_t>(q) * s];
  }
  for (int p = p0;;) {
    out[static_cast<size_t>(p) * s] = box_value(sum, inv);
    if (++p == p1) break;
    sum += at[static_cast<size_t>(min(p + radius, n - 1)) * s] -
           at[static_cast<size_t>(max(p - radius - 1, 0)) * s];
  }
}

// Horizontal: one thread a (row, channel, segment of pixels).
__global__ void __launch_bounds__(kWideThreads)
box_wide_h(const uint8_t* __restrict__ src, uint8_t* __restrict__ tmp,
           float inv, int radius, int height, int width, int channels) {
  const int segs = (width + kWideSeg - 1) / kWideSeg;
  const long long t = static_cast<long long>(blockIdx.x) * kWideThreads + threadIdx.x;
  if (t >= static_cast<long long>(height) * channels * segs) return;
  const int seg = static_cast<int>(t % segs);
  const int row_ch = static_cast<int>(t / segs);
  const int y = row_ch / channels;
  const int ch = row_ch - y * channels;
  const int lanes = width * channels;
  const size_t at = static_cast<size_t>(blockIdx.z) * height * lanes +
                    static_cast<size_t>(y) * lanes + ch;
  wide_segment(src + at, channels, width, seg * kWideSeg,
               min(seg * kWideSeg + kWideSeg, width), radius, inv, tmp + at);
}

// Vertical: one thread a (lane, segment of rows); neighbouring threads read
// neighbouring lanes.
__global__ void __launch_bounds__(kWideThreads)
box_wide_v(const uint8_t* __restrict__ tmp, uint8_t* __restrict__ dst,
           float inv, int radius, int height, int lanes) {
  const int segs = (height + kWideSeg - 1) / kWideSeg;
  const long long t = static_cast<long long>(blockIdx.x) * kWideThreads + threadIdx.x;
  if (t >= static_cast<long long>(lanes) * segs) return;
  const int lane = static_cast<int>(t % lanes);
  const int seg = static_cast<int>(t / lanes);
  const size_t at = static_cast<size_t>(blockIdx.z) * height * lanes + lane;
  wide_segment(tmp + at, lanes, height, seg * kWideSeg,
               min(seg * kWideSeg + kWideSeg, height), radius, inv, dst + at);
}

int launch_box_wide(const uint8_t* src, uint8_t* tmp, uint8_t* dst, float inv,
                    int radius, int batch, int height, int width, int channels,
                    void* stream) {
  if (radius <= kBoxMaxRadius) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long lanes = static_cast<long long>(width) * channels;
  const long long h_threads =
      static_cast<long long>(height) * channels * ((width + kWideSeg - 1) / kWideSeg);
  const long long v_threads = lanes * ((height + kWideSeg - 1) / kWideSeg);
  box_wide_h<<<dim3(static_cast<unsigned>((h_threads + kWideThreads - 1) / kWideThreads),
                    1, batch), kWideThreads, 0, s>>>(src, tmp, inv, radius,
                                                     height, width, channels);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  box_wide_v<<<dim3(static_cast<unsigned>((v_threads + kWideThreads - 1) / kWideThreads),
                    1, batch), kWideThreads, 0, s>>>(
      tmp, dst, inv, radius, height, static_cast<int>(lanes));
  return cudaGetLastError();
}

// -- band_mma_rows: the bf16 hi + lo band on the tensor cores ----------------

constexpr int kBandWarps = 8;
constexpr int kBandThreads = 32 * kBandWarps;
constexpr int kBandTileH = 64;     // output rows of a block
constexpr int kBandTileW = 128;    // output lanes of a block
constexpr int kBandPad = 8;        // bf16 added to each shared row (banks)
constexpr int kBandMaxRadius = 31;
constexpr int kBandStageRows = 8;  // staging loads a thread has in flight
constexpr int kMaxSharedBytes = 227 * 1024;   // a block's dynamic share

struct BandGeometry {
  int depth_h;    // the horizontal band's rows: 16 + 2rC, in 16s (taps C lanes apart)
  int depth_v;    // the vertical band's rows: 16 + 2r, in 16s
  int rows;       // staged rows: the tile's rows and the halo
  int cols;       // staged lanes: the tile's lanes and the halo
  int x_stride;   // bf16 a staged input row
  int h_stride;   // bf16 a horizontal result row
  __host__ __device__ BandGeometry(int radius, int channels)
      : depth_h((2 * radius * channels + 31) / 16 * 16),
        depth_v((2 * radius + 31) / 16 * 16),
        rows(kBandTileH - 16 + depth_v),
        cols(kBandTileW - 16 + depth_h),
        x_stride(cols + kBandPad),
        h_stride(kBandTileW + kBandPad) {}
  // The hi and lo bands of each pass, staged input, horizontal result, a
  // float 16x16 epilogue tile a warp; every part a multiple of 32 bytes.
  __host__ __device__ int bytes() const {
    return 2 * (depth_h + depth_v) * 16 * 2 + rows * x_stride * 2 +
           rows * h_stride * 2 + kBandWarps * 256 * 4;
  }
};

// band[k][n] = w[(k - n) / stride] where k - n is a multiple of `stride` in
// [0, 2r * stride], else 0: a depth x 16 row-major tile.
__device__ void build_band(__nv_bfloat16* band_hi, __nv_bfloat16* band_lo,
                           const float* __restrict__ hi,
                           const float* __restrict__ lo, int depth, int stride,
                           int radius) {
  for (int e = threadIdx.x; e < depth * 16; e += kBandThreads) {
    const int d = e / 16 - e % 16;
    const int t = d / stride;
    const bool on = d >= 0 && d == t * stride && t <= 2 * radius;
    band_hi[e] = __float2bfloat16(on ? hi[t] : 0.0f);
    band_lo[e] = __float2bfloat16(on ? lo[t] : 0.0f);
  }
}

__global__ void __launch_bounds__(kBandThreads)
band_mma_rows(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
              const float* __restrict__ hi, const float* __restrict__ lo,
              int radius, int height, int width, int channels) {
  using namespace nvcuda;
  using FragX = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                               wmma::row_major>;
  using FragBandT = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                                   wmma::col_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                               wmma::row_major>;
  using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

  extern __shared__ __align__(128) uint8_t smem[];
  const BandGeometry g(radius, channels);
  __nv_bfloat16* hband_hi = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* hband_lo = hband_hi + g.depth_h * 16;
  __nv_bfloat16* vband_hi = hband_lo + g.depth_h * 16;
  __nv_bfloat16* vband_lo = vband_hi + g.depth_v * 16;
  __nv_bfloat16* xs = vband_lo + g.depth_v * 16;
  __nv_bfloat16* hs = xs + g.rows * g.x_stride;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* tile_f = reinterpret_cast<float*>(hs + g.rows * g.h_stride) + warp * 256;

  const int C = channels;
  const int lanes = width * C;
  const int l0 = blockIdx.x * kBandTileW;
  const int y0 = blockIdx.y * kBandTileH;
  const size_t image = static_cast<size_t>(blockIdx.z) * height * lanes;
  src += image;
  dst += image;

  // The horizontal band steps C lanes a tap; the vertical one a row a tap,
  // read column-major as an A it is A[m][k] = w[k - m].
  build_band(hband_hi, hband_lo, hi, lo, g.depth_h, C, radius);
  build_band(vband_hi, vband_lo, hi, lo, g.depth_v, 1, radius);
  const int out_rows = min(kBandTileH, height - y0);
  const int out_lanes = min(kBandTileW, lanes - l0);
  const int row_tiles = (out_rows + 15) / 16;
  const int col_tiles = (out_lanes + 15) / 16;
  const int h_rows = (row_tiles - 1) * 16 + g.depth_v;   // rows the vertical reads
  const int x_cols = (col_tiles - 1) * 16 + g.depth_h;   // lanes the horizontal reads

  // Staged row i, lane j: image row clamp(y0 - r + i), lane g0 + j with its
  // pixel clamped to [0, W - 1] in its own channel, as bf16 (exact for u8).
  // A thread stages two neighbouring lanes of kBandStageRows rows at once.
  const int g0 = l0 - radius * C;
  const bool inside = g0 >= 0 && g0 + x_cols <= lanes;
  for (int j = 2 * lane; j < x_cols; j += 64) {
    int at0 = g0 + j;
    int at1 = at0 + 1;
    if (!inside) {
      const auto clamp_lane = [&](int at) {
        if (at < 0) return (at % C + C) % C;
        if (at >= lanes) return lanes - C + at % C;
        return at;
      };
      at0 = clamp_lane(at0);
      at1 = clamp_lane(at1);
    }
    for (int i0 = warp; i0 < h_rows; i0 += kBandWarps * kBandStageRows) {
      uint8_t v0[kBandStageRows], v1[kBandStageRows];
#pragma unroll
      for (int u = 0; u < kBandStageRows; ++u) {
        const int i = i0 + u * kBandWarps;
        const uint8_t* row =
            src + static_cast<size_t>(clamp_index(y0 - radius + i, height)) * lanes;
        v0[u] = i < h_rows ? row[at0] : 0;
        v1[u] = i < h_rows ? row[at1] : 0;
      }
#pragma unroll
      for (int u = 0; u < kBandStageRows; ++u) {
        const int i = i0 + u * kBandWarps;
        if (i < h_rows) {
          *reinterpret_cast<__nv_bfloat162*>(xs + i * g.x_stride + j) =
              __floats2bfloat162_rn(static_cast<float>(v0[u]),
                                    static_cast<float>(v1[u]));
        }
      }
    }
  }
  __syncthreads();

  // Horizontal: h[i][n] = q(x[i][n..n+Kd) @ band_hi + ... @ band_lo) for
  // every staged row, quantized, kept as bf16 (exact for u8).
  for (int tile = warp; tile < h_rows / 16 * col_tiles; tile += kBandWarps) {
    const int ti = tile / col_tiles;
    const int tj = tile - ti * col_tiles;
    FragAcc acc_hi, acc_lo;
    wmma::fill_fragment(acc_hi, 0.0f);
    wmma::fill_fragment(acc_lo, 0.0f);
    for (int ks = 0; ks < g.depth_h / 16; ++ks) {
      FragX a;
      FragB b;
      wmma::load_matrix_sync(a, xs + ti * 16 * g.x_stride + (tj + ks) * 16,
                             g.x_stride);
      wmma::load_matrix_sync(b, hband_hi + ks * 256, 16);
      wmma::mma_sync(acc_hi, a, b, acc_hi);
      wmma::load_matrix_sync(b, hband_lo + ks * 256, 16);
      wmma::mma_sync(acc_lo, a, b, acc_lo);
    }
    for (int e = 0; e < acc_hi.num_elements; ++e) {
      acc_hi.x[e] = quantize_u8(__fadd_rn(acc_hi.x[e], acc_lo.x[e]));
    }
    wmma::store_matrix_sync(tile_f, acc_hi, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = 2 * lane; e < 256; e += 64) {
      *reinterpret_cast<__nv_bfloat162*>(
          hs + (ti * 16 + e / 16) * g.h_stride + tj * 16 + e % 16) =
          __floats2bfloat162_rn(tile_f[e], tile_f[e + 1]);
    }
    __syncwarp();
  }
  __syncthreads();

  // Vertical: out[m][n] = q(vband_hi^T[m][..] @ h[m..m+Kd][n] + lo), the
  // band read column-major from the left; output rows are contiguous lanes.
  for (int tile = warp; tile < row_tiles * col_tiles; tile += kBandWarps) {
    const int ti = tile / col_tiles;
    const int tj = tile - ti * col_tiles;
    FragAcc acc_hi, acc_lo;
    wmma::fill_fragment(acc_hi, 0.0f);
    wmma::fill_fragment(acc_lo, 0.0f);
    for (int ks = 0; ks < g.depth_v / 16; ++ks) {
      FragBandT a;
      FragB b;
      wmma::load_matrix_sync(b, hs + (ti + ks) * 16 * g.h_stride + tj * 16,
                             g.h_stride);
      wmma::load_matrix_sync(a, vband_hi + ks * 256, 16);
      wmma::mma_sync(acc_hi, a, b, acc_hi);
      wmma::load_matrix_sync(a, vband_lo + ks * 256, 16);
      wmma::mma_sync(acc_lo, a, b, acc_lo);
    }
    for (int e = 0; e < acc_hi.num_elements; ++e) {
      acc_hi.x[e] = quantize_u8(__fadd_rn(acc_hi.x[e], acc_lo.x[e]));
    }
    wmma::store_matrix_sync(tile_f, acc_hi, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int m = ti * 16 + e / 16;
      const int n = tj * 16 + e % 16;
      if (m < out_rows && n < out_lanes) {
        dst[static_cast<size_t>(y0 + m) * lanes + l0 + n] =
            static_cast<uint8_t>(tile_f[e]);
      }
    }
    __syncwarp();
  }
}

int launch_band(const uint8_t* src, uint8_t* dst, const float* hi,
                const float* lo, int radius, int batch, int height, int width,
                int channels, void* stream) {
  if (radius < 1 || radius > kBandMaxRadius || channels < 1) {
    return cudaErrorInvalidValue;
  }
  const BandGeometry g(radius, channels);
  if (g.bytes() > kMaxSharedBytes) return cudaErrorInvalidValue;
  cudaError_t err = allow_shared<band_mma_rows>(g.bytes());
  if (err != cudaSuccess) return err;
  const dim3 grid((width * channels + kBandTileW - 1) / kBandTileW,
                  (height + kBandTileH - 1) / kBandTileH, batch);
  band_mma_rows<<<grid, kBandThreads, g.bytes(),
                  static_cast<cudaStream_t>(stream)>>>(
      src, dst, hi, lo, radius, height, width, channels);
  return cudaGetLastError();
}

}  // namespace

// src, tmp, dst: (B, H, W*C) uint8.  weights: (2r+1,) float32 on the device.
extern "C" int gip_gaussian_rows(const uint8_t* src, uint8_t* tmp, uint8_t* dst,
                                 const float* weights, int radius, int batch,
                                 int height, int width, int channels,
                                 void* stream) {
  return separable<gip::Weighted>(src, tmp, dst, weights, radius, batch,
                                  height, width, channels, stream);
}

extern "C" int gip_gaussian_folded_rows(const uint8_t* src, uint8_t* tmp,
                                        uint8_t* dst, const float* weights,
                                        int radius, int batch, int height,
                                        int width, int channels, void* stream) {
  return separable<gip::Folded>(src, tmp, dst, weights, radius, batch, height,
                                width, channels, stream);
}

// hi, lo: (2r+1,) float32 tables of exact bf16 values, made on the host;
// 1 <= r <= 31.
extern "C" int gip_gaussian_band_rows(const uint8_t* src, uint8_t* dst,
                                      const float* hi, const float* lo,
                                      int radius, int batch, int height,
                                      int width, int channels, void* stream) {
  return launch_band(src, dst, hi, lo, radius, batch, height, width, channels,
                     stream);
}

// inv: the f32 reciprocal 1/(2r+1), computed on the host.  The window
// kernel takes 1 <= r <= 64 and 1 <= C <= 32; the wide one r > 64 and
// scratch of the image's size.
extern "C" int gip_box_window_rows(const uint8_t* src, uint8_t* dst, float inv,
                                   int radius, int batch, int height,
                                   int width, int channels, void* stream) {
  return launch_box_window(src, dst, inv, radius, batch, height, width,
                           channels, stream);
}

extern "C" int gip_box_wide_rows(const uint8_t* src, uint8_t* tmp, uint8_t* dst,
                                 float inv, int radius, int batch, int height,
                                 int width, int channels, void* stream) {
  return launch_box_wide(src, tmp, dst, inv, radius, batch, height, width,
                         channels, stream);
}
