// Separable gaussian and box blurs on (B, H, W*C) interleaved uint8 rows.
// Every pass clamps at the true image edge: a horizontal tap t of lane l
// reads pixel clamp(l / C + t - r, 0, W - 1) in the same channel, a vertical
// tap clamps within the lane's own image (a batch, on the grid's z
// dimension, is never blurred across images), and the horizontal result is
// quantized to uint8, floor(x + 0.5), before the vertical pass reads it.
//
// gauss_window_rows (gaussian_rows, gaussian_folded_rows) replaces
//   gpu_image_processing_tpu/ops/pallas/blur.py::_blur_kernel, weighted
//   (level 2) and folded (level 4, r < 3), and its batched rows variant
//   (blur.py:985).  The function is 2r+1 taps a pass in a fixed order, each
//   product and sum rounded (-fmad=false, __fmul_rn/__fadd_rn), so its bound
//   on this card is its float operations issued one by one: a multiply and
//   an add a tap and pass, 4(2r+1) an output, at 132 SMs x 128 lanes x
//   1.98 GHz (0.0175 ms at r = 3 on 2146x3239x3, above the 0.0124 ms of its
//   bytes).  The old kernel ran two launches (the intermediate through
//   device memory), one thread an output, and about ten instructions a tap:
//   a clamped index, a byte load, a weight load, a convert, the multiply and
//   the add, with no loaded value reused.  The redesign removes that per-tap
//   work:
//   * One launch on box_window_rows's skeleton: a block of 256 threads owns
//     a strip of at most 512 lanes over a band of rows (sized on the host to
//     fill the SMs' block slots once) and walks it in chunks of kChunk
//     output rows.  It stages input rows with stage_rows (16-byte cp.async
//     copies, each pixel clamped at its image's edge), runs the horizontal
//     pass into a window of 2r + kChunk quantized rows in shared memory, and
//     runs the vertical pass from that window.  Two windows alternate: a chunk copies
//     the last 2r rows of the previous one (16-byte copies) and computes
//     only kChunk new horizontal rows, so a band recomputes 2r halo rows
//     once, not per chunk.  The intermediate never reaches device memory.
//   * The radius is a template parameter, so the tap loops unroll fully, at
//     the weighted radii 1 to 15 (the API's) and 31 and the folded radii 1
//     and 2 (level 4 folds only below 3; from kPairMinRadius the weighted
//     taps of the port's tables go to gauss_pair_rows, below, and only
//     other tables come here); the other radii share one kernel
//     per mode that takes the radius at run time and sums each output from
//     its taps.  Twenty kernels, not 62: every radius specialised made
//     blur.cu's build several times longer.  The taps are a kernel
//     parameter, a struct of 63 floats passed by value: every multiply of
//     an unrolled tap takes its weight as a constant-bank operand, with no
//     load and no register, and each launch carries its own table.
//   * Weighted, register windows: a thread converts each u8 value it reads
//     to f32 once and adds its product into every output it reaches, in
//     input order, which is tap order for each output (output k takes input
//     j as tap j - k).  Horizontally a thread computes kRunH = 16 pixels of
//     one channel from 16 + 2r values; vertically kChunk = 16 rows of two
//     lanes from 16 + 2r rows of the window, 32 accumulators.
//   * Folded: the pair sum x[t] + x[2r - t] comes before its multiply, so no
//     input-order form exists; each output reads its taps from shared memory
//     (integer pair sums, as the plain version's exact f32 sums of u8
//     values), in t order, then the centre tap.
//   * u8 values become f32 on the FP32 unit (u8_to_f32: 2^23 + v less
//     2^23) and sums become u8 by an exact round-down add (quantize_u8_int),
//     not on the conversion unit, which runs at a quarter of the rate.
//   * The next window's input rows are copied in with cp.async while the
//     vertical pass of this window runs.
//   SASS (tools/sass_counts.py, cuobjdump -sass of
//   gauss_window_rows<gip::Weighted, 3>, sm_90a):
//   the horizontal pass of a 16-pixel run is 442 instructions for 112 taps,
//   3.9 a tap (112 FMUL; 150 FADD, of which 96 tap adds, 22 conversions and
//   32 rounding adds; loads, stores and addresses); the vertical pass has
//   224 FMUL and 300 FADD for its 32 outputs, with two shared loads and two
//   conversions a row for 16 outputs.  The old kernel took about ten a tap.
//
// gauss_pair_rows (gaussian_rows and gaussian_planar from kPairMinRadius,
//   8, to r = 15 and at r = 31) replaces the same TPU kernel,
//   ops/pallas/blur.py::_blur_kernel, weighted, where the window kernel is
//   bound by issue rather than bytes.  Held to -fmad=false, each of the
//   4(2r + 1) = 124 operations an output at r = 15 issues alone, so on
//   2146x3239x3 the floor is 124 x 20.85 M outputs at 33.45e12 thread
//   instructions a second (132 SMs x 128 lanes x 1.98 GHz): 77.3 us, where
//   the benchmark's yardstick (portbench/reference/work.py) counts the same
//   operations at the FFMA rate, 38.59 us.  gauss_window_rows<Weighted, 15>
//   took 0.198 ms, 2.56x the floor: about 75 instructions an output a pass
//   for 61 taps, 23% of its horizontal pass on halo rows, 6.7% dead lanes.
//   The design, same arithmetic (f32, each product and sum rounded in tap
//   order, floor(x + 0.5) after each pass, clamp to edge; maxdiff 0):
//   * Register runs of 32 outputs in each pass, 32 pixels of one channel
//     across and 32 rows of one lane down: each staged value is loaded and
//     converted once for 32 outputs, 1.94 times an output a pass at r = 15
//     (2.9 in the window kernel).
//   * One product a symmetric tap pair: an input's product with tap m <= r
//     is its product with tap 2r - m too, since the table holds w[m] and
//     w[2r - m] equal to the bit (pair_takes checks it on the host, where
//     the taps are copied; any other table takes the window kernel), so it
//     is formed once and added to both outputs: 23.5 multiplies an output
//     a pass, 31 before.  Each output still adds its taps in tap order.
//   * Only live lanes: a thread a lane of its strip, a strip 32-pixel runs
//     wide, chosen a launch among 1 to kPairMaxLanes / (32 C) runs
//     (pair_launch_for); a warp past the strip's last pixel runs no taps.
//   * One ring of horizontal rows in chunks of 32 rows (2r + 32 and the
//     chunk being filled), bands sized so that the grid fills the SMs: at
//     r = 15 strips of 128 pixels (C = 3) and bands of 224 rows, halo rows
//     11.8% of the horizontal pass (23% before), 260 blocks in 264 slots.
//   And: u8 to f32 by I2FP, one instruction; floor(x + 0.5) without a
//   clamp, since pair_takes admits only tables whose sums stay in
//   [0, 255.5); C = 3, the photo's, a constant of its own instantiation;
//   384-thread blocks, two an SM at 80 registers (at 512 threads and 64
//   registers the runs spilled).
//   SASS at r = 15 (tools/sass_counts.py, sm_90a): the horizontal pass of a
//   32-pixel run, gauss_pair_rows<15, 3>, is 1962 instructions for 32 x 31
//   taps, 2.0 a tap and 61 an output (752 FMUL, 1024 FADD), 80 registers,
//   no spills; gauss_window_rows<Weighted, 15>'s 16-pixel run is 1342 for
//   16 x 31, 2.7 a tap and 84 an output (496 FMUL, 558 FADD), 80
//   registers, no spills.  On the H100 (PERF.md, K1) it takes 0.141 ms at
//   r = 15 (the window kernel 0.193), issuing at about 55% of the card's
//   instruction rate, as the window kernel did; separate FP32 multiplies
//   and adds alone ran at 94% of that rate, so the FP32 pipe is not what
//   holds it back.
//
// gaussian_planar, gaussian_folded_planar and box_planar (blur_planar.py)
//   replace blur.py::_blur_kernel as `_separable_blur_planar` (blur.py:664,
//   call :784) launches it on (N, H, W) planes, with `rows_prepadded`: r
//   given halo rows above and below each plane, as the row bands of a split
//   image carry them.  A plane is an image of one channel, so these launch
//   gauss_window_rows and box_window_rows below at C = 1 (box_planar as
//   box_rows routes it: the window kernel in box mode to r = 7), the planes
//   on the grid's z dimension.  The halo mode is the kernels' `halo` argument and
//   nothing else: an input image is H + 2r rows, and staging reads virtual
//   row v as input row v + r, clamped only past the input's last row
//   (stage_rows's row_lo and row_count), so the loops are the rows
//   kernels'.
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
//   one write of the image), so the redesign spends O(1) work an output,
//   except at small radii:
//   * r <= kBoxWindowMaxRadius (7): gauss_window_rows<Box, r>, the
//     gaussian's window kernel with each tap's product replaced by the
//     value itself and the sum multiplied by 1/(2r+1) at the end (exact in
//     f32: whole numbers under 2^24).  Its outputs are independent sums,
//     2r+1 adds each a pass, where a running sum is a chain of dependent
//     adds down a run, and below r = 8 it was the faster of the two.
//   * box_window_rows, r <= kBoxMaxRadius: one launch.  A block of 256
//     threads owns a strip of at most 512 lanes over a band of rows (sized
//     on the host so that the grid fills the SMs' block slots once) and
//     walks its virtual rows (y0 - r .. y0 + band + r, each clamped to the
//     image) in chunks of kChunk: it stages the chunk's input rows in shared
//     memory (stage_rows), runs a horizontal running sum along runs of kRun
//     pixels of one channel (add the incoming tap, subtract the outgoing
//     one), and writes the quantized rows into a shared ring of 2r + kChunk
//     rows; then each thread adds the newest ring row to the column sums it
//     holds in registers for 2 lanes, emits an output row, and subtracts the
//     ring row 2r back.  The intermediate never reaches device memory.  Work
//     an output: about 2 loads and adds a pass, plus (2r+1)/kRun for the
//     first window of each run and (band + 2r)/band for the halo rows a band
//     recomputes.  What bounds it on the card is latency more than bytes:
//     each chunk is three dependent phases between barriers, so the
//     registers are capped (kBlocksPerSM) to keep 4 blocks on an SM;
//     uncapped, half as many fitted and it ran slower.  At one channel (the
//     planar blur) two things cost it more than at three: the ring's rows,
//     512 bytes apart, put the horizontal pass's kChunk row writes on one
//     bank (the ring stride is now an odd multiple of 16), and 512-pixel
//     strips left the last strip of a 3239-pixel row a third full while
//     its blocks took as long as the others (the strips are now evened
//     out over the width).  Launch bounds of 5, 6 and 8 blocks, and direct
//     window sums for r = 1 and 2 (conflict-free loads, 2r + 1 of them),
//     were slower in development probes on the H100.
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
//
// gip_blur_route names the device function that a launch of given kind,
// radius and channels runs, from the rules that pick it (kernel_radius,
// box_route and the launches' argument checks), so the wrappers can count
// each launch by the function it ran (ops/cuda/__init__.py, ROUTES).

#include <algorithm>
#include <array>
#include <cstring>
#include <type_traits>
#include <utility>

#include <mma.h>
#include <cuda_bf16.h>

#include "launch.cuh"

namespace gip {

// The window kernel's tap orders, as template tags (their names show in
// profiler traces): Weighted (level 2) sums x[t] * w[t] in tap order;
// Folded (level 4, r < 3) sums (x[t] + x[2r - t]) * w[t] for t < r in t
// order, then x[r] * w[r] (ops/pallas/blur.py:318-329); Box sums the x[t],
// whole numbers and so exact in f32 in any order, then multiplies by
// 1/(2r+1) (box_rows at small radii).
struct Weighted {};
struct Folded {};
struct Box {};

}  // namespace gip

namespace {

using gip::allow_shared;
using gip::clamp_index;
using gip::quantize_u8;

// -- the strip geometry of the one-launch kernels ----------------------------

constexpr int kBlockThreads = 256;
constexpr int kStripLanes = 512;   // lanes a block's strip holds at most
constexpr int kChunk = gip::kStageRows;   // rows staged at a time
// Blocks an SM should hold: caps the registers at 64 a thread, since
// latency, not issue, bounds each block's chunk loop.
constexpr int kBlocksPerSM = 4;
constexpr int kMinBandRows = 32;

// The staged input of a strip: `run` divides the strip's pixels, at most
// kStripLanes lanes.  Given the image's width, the strips are evened out:
// the fewest that cover the width, each the same multiple of `run`, so the
// last is not mostly empty (box at one channel: 3239 pixels are 7 strips of
// 480, not 6 of 512 and one of 167; a box block takes about as long for a
// part strip as for a whole one).
struct Strip {
  int strip_px;      // pixels of a strip
  int in_len;        // bytes of a staged row: (strip_px + 2r) * C
  int in_stride;     // in_len + 15 rounded to an odd multiple of 16
  __host__ __device__ Strip(int radius, int channels, int run, int width = 0) {
    strip_px = kStripLanes / channels / run * run;
    if (strip_px < run) strip_px = run;
    if (width > 0) {
      const int strips = (width + strip_px - 1) / strip_px;
      const int even = ((width + strips - 1) / strips + run - 1) / run * run;
      if (even < strip_px) strip_px = even;
    }
    in_len = (strip_px + 2 * radius) * channels;
    in_stride = (in_len + 15 + 15) / 16 * 16 | 16;   // rows on other banks
  }
};

// -- gauss_window_rows: one launch, register windows, taps by value ----------

constexpr int kMaxTaps = 63;        // 2r + 1, r <= 31 (MAX_KERNEL_TAPS)
constexpr int kRunH = 16;           // pixels of one channel a thread computes
constexpr int kGaussMaxChannels = kStripLanes / kRunH;   // 32
// The taps, 2r + 1 of them, by value: a kernel parameter lies in the
// constant bank.
struct GaussTaps {
  float w[kMaxTaps];
};

using gip::quantize_u8_int;
using gip::u8_to_f32;

struct GaussGeometry {
  Strip strip;
  int win_rows;      // 2r + kChunk quantized horizontal rows
  __host__ __device__ GaussGeometry(int radius, int channels)
      : strip(radius, channels, kRunH), win_rows(2 * radius + kChunk) {}
  __host__ __device__ int bytes() const {
    return kChunk * strip.in_stride + 2 * win_rows * kStripLanes;
  }
};

// Weighted, input order: value J of a run adds its tap J - k to each output
// k it reaches (Box: the value itself).
template <typename Mode, int R, int K, int J>
__device__ __forceinline__ void add_input(float (&acc)[K], float v,
                                          const GaussTaps& taps) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (J - k >= 0 && J - k <= 2 * R) {
      const float term =
          std::is_same_v<Mode, gip::Box> ? v : __fmul_rn(v, taps.w[J - k]);
      acc[k] = J == k ? term : __fadd_rn(acc[k], term);
    }
  }
}

// An output of the input order as the u8 it quantizes to: Box multiplies its
// sum by 1/(2r+1), which its launch passes as taps.w[0].
template <typename Mode>
__device__ __forceinline__ uint8_t window_value(float acc, const GaussTaps& taps) {
  if constexpr (std::is_same_v<Mode, gip::Box>) acc = __fmul_rn(acc, taps.w[0]);
  return static_cast<uint8_t>(quantize_u8_int(acc));
}

// One output from its taps, x(t) the u8 value of tap t, in the order of
// the mode; the loops unroll where the radius is a constant.
//   Folded: sum over t < r of (x[t] + x[2r - t]) * w[t] in t order, then
//   + x[r] * w[r] (the pair sum is exact);
//   Weighted: sum over t of x[t] * w[t] in t order (the radii that have no
//   kernel of their own; the others take the input order of add_input).
template <typename Mode, typename Load>
__device__ __forceinline__ float tap_sum(const Load& x, int radius,
                                         const GaussTaps& taps) {
  float acc = 0.0f;
  if constexpr (std::is_same_v<Mode, gip::Folded>) {
#pragma unroll 4
    for (int t = 0; t < radius; ++t) {
      const float term =
          __fmul_rn(u8_to_f32(x(t) + x(2 * radius - t)), taps.w[t]);
      acc = t == 0 ? term : __fadd_rn(acc, term);
    }
    return __fadd_rn(acc, __fmul_rn(u8_to_f32(x(radius)), taps.w[radius]));
  } else {
#pragma unroll 4
    for (int t = 0; t <= 2 * radius; ++t) {
      const float term = __fmul_rn(u8_to_f32(x(t)), taps.w[t]);
      acc = t == 0 ? term : __fadd_rn(acc, term);
    }
    return acc;
  }
}

template <typename Mode, int R, int J, int K>
__device__ __forceinline__ void weighted_run(float (&acc)[K],
                                             const uint8_t* x, int step,
                                             const GaussTaps& taps) {
  if constexpr (J < K + 2 * R) {
    add_input<Mode, R, K, J>(acc, u8_to_f32(x[J * step]), taps);
    weighted_run<Mode, R, J + 1, K>(acc, x, step, taps);
  }
}

// Weighted and Box with the radius R as a constant (R > 0) take the input
// order of register windows; the folded mode, and the weighted radii that
// have no kernel of their own (R = 0), sum each output from its taps (Box
// runs only at constant radii).
template <typename Mode, int R>
constexpr bool kInputOrder = !std::is_same_v<Mode, gip::Folded> && R > 0;

// Horizontal pass of `nrows` staged rows into window rows 0.. of `win`: a
// thread takes one (channel, run of kRunH pixels) pair, channel fastest (a
// strip has at most kStripLanes / kRunH = 32 pairs), for every eighth row.
// Staged pixel j is strip pixel j - r, so output pixel p reads staged
// pixels p .. p + 2r.
constexpr int kPairs = kStripLanes / kRunH;
constexpr int kRowGroups = kBlockThreads / kPairs;   // 8
template <typename Mode, int R>
__device__ __forceinline__ void gauss_horizontal(
    const uint8_t* in, const int* shift, uint8_t* win, const Strip& s,
    int channels, int valid_px, int nrows, int radius, const GaussTaps& taps) {
  const int C = channels;
  const int pair = threadIdx.x % kPairs;
  const int ch = pair % C;
  const int p0 = pair / C * kRunH;
  if (p0 >= valid_px) return;
  const int n = min(kRunH, valid_px - p0);
  for (int k = threadIdx.x / kPairs; k < nrows; k += kRowGroups) {
    const uint8_t* x = in + k * s.in_stride + shift[k] + p0 * C + ch;
    uint8_t* h = win + k * kStripLanes + p0 * C + ch;
    if constexpr (kInputOrder<Mode, R>) {
      float acc[kRunH];
      weighted_run<Mode, R, 0, kRunH>(acc, x, C, taps);
#pragma unroll
      for (int i = 0; i < kRunH; ++i) {
        if (i < n) h[i * C] = window_value<Mode>(acc[i], taps);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        const uint8_t* xi = x + i * C;
        h[i * C] = static_cast<uint8_t>(quantize_u8_int(tap_sum<Mode>(
            [&](int t) -> unsigned { return xi[t * C]; }, radius, taps)));
      }
    }
  }
}

template <typename Mode, int R, int J, int K>
__device__ __forceinline__ void weighted_column(float (&a0)[K], float (&a1)[K],
                                                const uint8_t* col,
                                                const GaussTaps& taps) {
  if constexpr (J < K + 2 * R) {
    add_input<Mode, R, K, J>(a0, u8_to_f32(col[J * kStripLanes]), taps);
    add_input<Mode, R, K, J>(a1, u8_to_f32(col[J * kStripLanes + kBlockThreads]),
                             taps);
    weighted_column<Mode, R, J + 1, K>(a0, a1, col, taps);
  }
}

// Vertical pass of a whole window: output row yc + k (k < rows_out) of the
// strip's lanes lane and lane + kBlockThreads reads window rows k .. k + 2R.
template <typename Mode, int R>
__device__ __forceinline__ void gauss_vertical(const uint8_t* win,
                                               uint8_t* out, int lanes,
                                               int valid_lanes, int rows_out,
                                               int radius, const GaussTaps& taps) {
  const int lane0 = threadIdx.x;
  const int lane1 = threadIdx.x + kBlockThreads;
  const uint8_t* col = win + lane0;
  if constexpr (kInputOrder<Mode, R>) {
    float a0[kChunk], a1[kChunk];
    weighted_column<Mode, R, 0, kChunk>(a0, a1, col, taps);
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (k < rows_out) {
        uint8_t* o = out + static_cast<size_t>(k) * lanes;
        if (lane0 < valid_lanes) o[lane0] = window_value<Mode>(a0[k], taps);
        if (lane1 < valid_lanes) o[lane1] = window_value<Mode>(a1[k], taps);
      }
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < rows_out; ++k) {
      const uint8_t* c0 = col + k * kStripLanes;
      uint8_t* o = out + static_cast<size_t>(k) * lanes;
      if (lane0 < valid_lanes) {
        o[lane0] = static_cast<uint8_t>(quantize_u8_int(tap_sum<Mode>(
            [&](int t) -> unsigned { return c0[t * kStripLanes]; }, radius,
            taps)));
      }
      if (lane1 < valid_lanes) {
        o[lane1] = static_cast<uint8_t>(quantize_u8_int(tap_sum<Mode>(
            [&](int t) -> unsigned { return c0[t * kStripLanes + kBlockThreads]; },
            radius, taps)));
      }
    }
  }
}

// blockIdx.z is the image of the batch; band_rows is a multiple of kChunk.
// R is the radius, or 0 for a kernel that takes it at run time.
// halo: 0, or r when each input image carries r given halo rows above and
// below its `height` output rows (the planar blur's rows_prepadded): then
// virtual row v is input row v + r, clamped only past the input's last
// row, so the vertical pass reads the halo rows as given.
// Registers: 64 a thread (kBlocksPerSM blocks) to r = 8; past it the window
// of 2r + kChunk rows lets fewer blocks fit and the unrolled taps want
// more registers, so 3 blocks.
template <typename Mode, int R>
__global__ void __launch_bounds__(kBlockThreads, R <= 8 ? kBlocksPerSM : 3)
gauss_window_rows(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                  const __grid_constant__ GaussTaps taps, int radius, int height,
                  int width, int channels, int halo, int band_rows) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int shift[kChunk];
  const int r = R > 0 ? R : radius;
  const GaussGeometry g(r, channels);
  uint8_t* in = smem;                                // kChunk staged rows
  // The two windows, by pointer arithmetic: an indexed array of the two
  // pointers would live in local memory and make every access generic.
  uint8_t* wins = smem + kChunk * g.strip.in_stride;
  const int win_bytes = g.win_rows * kStripLanes;
  const int C = channels;
  const int lanes = width * C;
  const int px0 = blockIdx.x * g.strip.strip_px;
  const int y0 = blockIdx.y * band_rows;
  const int y_end = min(y0 + band_rows, height);
  const int valid_px = min(g.strip.strip_px, width - px0);
  const int valid_lanes = valid_px * C;
  // An input image is height + 2 * halo rows; src points at its output row 0.
  src += (static_cast<size_t>(blockIdx.z) * (height + 2 * halo) + halo) * lanes;
  dst += static_cast<size_t>(blockIdx.z) * height * lanes + px0 * C;
  const int g0 = (px0 - r) * C;   // row lane of staged byte 0
  const auto stage = [&](int v0, int nrows) {
    gip::stage_rows<kBlockThreads>(src, in, shift, g.strip.in_stride, g0,
                                   g.strip.in_len, lanes, C, v0, nrows, -halo,
                                   height + 2 * halo);
  };

  // Window row j of the chunk of output rows yc .. yc + kChunk - 1 is
  // virtual row yc - r + j (the input row clamp of it).  The first window
  // is staged and filtered kChunk rows at a time.
  for (int j0 = 0; j0 < g.win_rows; j0 += kChunk) {
    const int nrows = min(kChunk, g.win_rows - j0);
    if (j0 != 0) __syncthreads();   // the last horizontal pass read `in`
    stage(y0 - r + j0, nrows);
    gip::wait_async_copies();
    __syncthreads();
    gauss_horizontal<Mode, R>(in, shift, wins + j0 * kStripLanes, g.strip, C,
                              valid_px, nrows, r, taps);
  }
  for (int yc = y0, cur = 0;; yc += kChunk, cur ^= 1) {
    const uint8_t* win = wins + cur * win_bytes;
    __syncthreads();   // this window is whole, and `in` is free
    const int next = yc + kChunk;
    const bool more = next < y_end;
    // The next window's kChunk new rows (virtual rows next + r ..) are
    // copied in while this window's vertical pass runs.
    if (more) stage(next + r, kChunk);
    gauss_vertical<Mode, R>(win, dst + static_cast<size_t>(yc) * lanes, lanes,
                            valid_lanes, min(kChunk, y_end - yc), r, taps);
    if (!more) break;
    // The next window: the last 2r rows of this one, then the new rows.
    uint8_t* following = wins + (cur ^ 1) * win_bytes;
    const uint4* from = reinterpret_cast<const uint4*>(win + kChunk * kStripLanes);
    uint4* to = reinterpret_cast<uint4*>(following);
    for (int e = threadIdx.x; e < 2 * r * kStripLanes / 16; e += kBlockThreads) {
      to[e] = from[e];
    }
    gip::wait_async_copies();
    __syncthreads();
    gauss_horizontal<Mode, R>(in, shift, following + 2 * r * kStripLanes,
                              g.strip, C, valid_px, kChunk, r, taps);
  }
}

template <typename Mode, int R>
int launch_gauss_r(const uint8_t* src, uint8_t* dst, const GaussTaps& taps,
                   int radius, int batch, int height, int width, int channels,
                   int halo, cudaStream_t stream) {
  constexpr auto kernel = gauss_window_rows<Mode, R>;
  const GaussGeometry g(radius, channels);
  cudaError_t err = allow_shared<kernel>(g.bytes());
  if (err != cudaSuccess) return err;
  const int columns = (width + g.strip.strip_px - 1) / g.strip.strip_px;
  int band_rows = 0;
  err = gip::band_rows_for<kernel>(kBlockThreads, g.bytes(),
                                   static_cast<long long>(columns) * batch,
                                   height, kChunk, kMinBandRows, &band_rows);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(columns, (height + band_rows - 1) / band_rows, batch),
           kBlockThreads, g.bytes(), stream>>>(src, dst, taps, radius, height,
                                               width, channels, halo, band_rows);
  return cudaGetLastError();
}

using GaussLaunch = int (*)(const uint8_t*, uint8_t*, const GaussTaps&, int,
                            int, int, int, int, int, cudaStream_t);

// The radii with a kernel of their own: the weighted taps at the API's radii
// (1 to 15) and the cap, 31; the folded taps below r = 3, the only radii
// level 4 folds.  Every other radius takes the run-time kernel (R = 0),
// which keeps the build to 20 kernels.
template <typename Mode>
constexpr bool specialised(int r) {
  return std::is_same_v<Mode, gip::Weighted> ? r <= 15 || r == 31 : r <= 2;
}

// The template radius of the kernel that runs radius r.
template <typename Mode>
constexpr int kernel_radius(int r) {
  return specialised<Mode>(r) ? r : 0;
}

template <typename Mode, int... Rs>
constexpr std::array<GaussLaunch, sizeof...(Rs)> gauss_table(
    std::integer_sequence<int, Rs...>) {
  return {&launch_gauss_r<Mode, kernel_radius<Mode>(Rs + 1)>...};
}

constexpr bool gauss_takes(int radius, int channels) {
  return radius >= 1 && radius <= kMaxTaps / 2 && channels >= 1 &&
         channels <= kGaussMaxChannels;
}

// Box at radii up to kBoxWindowMaxRadius takes the window kernel in box
// mode (Box), whose outputs are independent sums with no running chain.  In
// development probes on the H100 at 2146x3239x3 it beat box_window_rows's
// running sums to r = 7 and lost from r = 8 (rows: 0.0539 against 0.0910 ms
// at r = 1, 0.0924 against 0.0995 at r = 7, 0.1013 against 0.0993 at r = 8;
// planes alike).  Entry r - 1 is radius r.
constexpr int kBoxWindowMaxRadius = 7;

// The weighted gaussian takes gauss_pair_rows from kPairMinRadius to 15 and
// at 31, with a table that pair_takes admits (every table the port builds)
// and at most kPairMaxChannels channels; below it gauss_window_rows<Weighted,
// r>.  On the H100 at 2146x3239x3 rows the pair kernel was the faster from
// r = 8 up (card ms, window against pair: r = 8 0.1245 / 0.1099, r = 9
// 0.1275 / 0.0982, r = 12 0.1558 / 0.1182, r = 15 0.1928 / 0.1414, r = 31
// 0.4348 / 0.2925).  Below 8 the window kernel is bound by bytes and
// latency more than by issue; the pair kernel has no instantiation there
// and was not timed.
constexpr int kPairMinRadius = 8;

// -- gauss_pair_rows: the weighted gaussian at wide radii ---------------------

constexpr int kPairRun = 32;        // outputs of a register run, each pass
// Lanes of a strip, a thread a lane: two blocks of 384 threads an SM leave
// 80 registers a thread, which the runs take without spilling (at 64, two
// blocks of 512, they spilled and ran slower).
constexpr int kPairMaxLanes = 384;
constexpr int kPairMaxChannels = kPairMaxLanes / kPairRun;   // 12
// Bytes from one ring row to the next: a constant, so each ring load of the
// vertical pass takes its row as an immediate offset; 384 + 16 puts
// neighbouring rows on other banks.
constexpr int kPairRingStride = kPairMaxLanes + 16;
// A block's cost beside its rows and lanes (staging, barriers, the pipeline
// filling), in lanes: fitted to card times of strips of 1 to 16 runs.
constexpr int kPairBlockLanes = 128;

// A strip of `runs` runs of kPairRun pixels, one thread a lane of it, and
// its ring: the vertical run reads 2r + kPairRun rows, which with the chunk
// being computed take `chunks` chunks of kPairRun rows.  (Chunks of two
// vertical runs, half the barriers, made the compiler spill and ran 2.7x
// slower.)
struct PairGeometry {
  int strip_px;    // runs * kPairRun
  int lanes;       // strip_px * C: the block's threads
  int in_len;      // bytes of a staged row: (strip_px + 2r) * C
  int in_stride;   // in_len + 15 rounded to an odd multiple of 16
  int chunks;      // ring chunks
  __host__ __device__ PairGeometry(int radius, int channels, int runs)
      : strip_px(runs * kPairRun),
        lanes(strip_px * channels),
        in_len((strip_px + 2 * radius) * channels),
        in_stride((in_len + 15 + 15) / 16 * 16 | 16),
        chunks((2 * radius + kPairRun - 1) / kPairRun + 1) {}
  __host__ __device__ int bytes() const {
    return kPairRun * in_stride + chunks * kPairRun * kPairRingStride;
  }
};

// The f32 value of a u8 by I2FP: exact, and one instruction where
// u8_to_f32 takes two; on the H100 the pair kernel ran faster with it.
__device__ __forceinline__ float u8_float(unsigned v) { return __uint2float_rn(v); }

// floor(x + 0.5) in the low byte of the result, for 0 <= x < 255.5, which
// the tables pair_takes admits keep every sum to: t = x + 0.5 rounded to
// nearest, then t + 1.5 * 2^23 rounded down has the bits of 1.5 * 2^23 (a
// zero low byte) plus floor(t), as in quantize_u8_int, and a byte store
// keeps the low byte.  No clamp: two instructions fewer an output than
// quantize_u8_int.
__device__ __forceinline__ unsigned quantize_u8_low(float x) {
  return __float_as_uint(__fadd_rd(__fadd_rn(x, 0.5f), 12582912.0f));
}

// Input J of a run: its product with tap m (m <= R), formed once, is tap m
// of output J - m and tap 2R - m of output J - 2R + m, whose weights are
// equal to the bit; each output adds its taps in tap order, since the
// inputs come in order and an output takes one tap of each.
template <int R, int J>
__device__ __forceinline__ void add_pair_input(float (&acc)[kPairRun], float v,
                                               const GaussTaps& taps) {
#pragma unroll
  for (int m = 0; m <= R; ++m) {
    const int k = J - m;
    const int k2 = J - 2 * R + m;
    const bool first = k >= 0 && k < kPairRun;
    const bool second = m < R && k2 >= 0 && k2 < kPairRun;
    if (first || second) {
      const float p = __fmul_rn(v, taps.w[m]);
      if (first) acc[k] = m == 0 ? p : __fadd_rn(acc[k], p);
      if (second) acc[k2] = __fadd_rn(acc[k2], p);
    }
  }
}

// Horizontal: the kPairRun + 2R staged values x[0], x[step], ... of a run.
template <int R, int J>
__device__ __forceinline__ void pair_run(float (&acc)[kPairRun],
                                         const uint8_t* x, int step,
                                         const GaussTaps& taps) {
  if constexpr (J < kPairRun + 2 * R) {
    add_pair_input<R, J>(acc, u8_float(x[J * step]), taps);
    pair_run<R, J + 1>(acc, x, step, taps);
  }
}

// Vertical: window row J of a lane, in ring chunk (J + kSkip) / kPairRun
// at the chunk's row (J + kSkip) % kPairRun; every offset is a constant.
template <int R, int kSkip, int kChunks, int J>
__device__ __forceinline__ void pair_column(float (&acc)[kPairRun],
                                            const uint8_t* const (&chunk)[kChunks],
                                            const GaussTaps& taps) {
  if constexpr (J < kPairRun + 2 * R) {
    constexpr int q = J + kSkip;
    add_pair_input<R, J>(
        acc, u8_float(chunk[q / kPairRun][q % kPairRun * kPairRingStride]), taps);
    pair_column<R, kSkip, kChunks, J + 1>(acc, chunk, taps);
  }
}

// blockIdx.z is the image of the batch; blockDim.x is the strip's lanes
// (runs runs of kPairRun pixels at `channels`); band_rows is a multiple of
// kPairRun.  halo as in gauss_window_rows.  kC: the channels as a constant
// (3, the photo's), so each staged load and ring store of the horizontal
// run takes its offset as an immediate (2.7% faster at r = 15 on the H100),
// or 0 for `channels` at run time.
//
// The horizontal rows go to one ring of kChunks chunks of kPairRun rows.
// Chunk c holds virtual rows v_first + kPairRun c .. + kPairRun - 1, in
// ring slot c % kChunks; the vertical run n (output rows y0 + kPairRun n
// ..) reads the 2R + kPairRun rows that end with chunk n + kChunks - 1, so
// once the chunks before it are in, each chunk computed lets one vertical
// run go.  Chunk 0's first kSkip rows, and rows past the last one an
// output reads, are not computed.
template <int R, int kC>
__global__ void __launch_bounds__(kPairMaxLanes, 2)
gauss_pair_rows(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                const __grid_constant__ GaussTaps taps, int height, int width,
                int channels, int halo, int runs, int band_rows) {
  constexpr int kChunks = (2 * R + kPairRun - 1) / kPairRun + 1;
  constexpr int kSkip = (kChunks - 1) * kPairRun - 2 * R;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int shift[kPairRun];
  const int C = kC > 0 ? kC : channels;
  const PairGeometry g(R, C, runs);
  uint8_t* in = smem;                                 // kPairRun staged rows
  uint8_t* ring = smem + kPairRun * g.in_stride;
  const int lanes = width * C;
  const int px0 = blockIdx.x * g.strip_px;
  const int y0 = blockIdx.y * band_rows;
  const int y_end = min(y0 + band_rows, height);
  const int valid_px = min(g.strip_px, width - px0);
  src += (static_cast<size_t>(blockIdx.z) * (height + 2 * halo) + halo) * lanes;
  dst += static_cast<size_t>(blockIdx.z) * height * lanes + px0 * C;
  const int g0 = (px0 - R) * C;   // row lane of staged byte 0
  const int v_first = y0 + R - (kChunks - 1) * kPairRun;
  const int v_last = y_end - 1 + R;   // the last virtual row an output reads
  const int last_chunk = (y_end - y0 + kPairRun - 1) / kPairRun + kChunks - 2;
  // This thread's horizontal run: row hk of a chunk, channel hch, pixels
  // hp0 .. hp0 + kPairRun - 1 of the strip; the strip's live runs only, so
  // threads past them (hk >= kPairRun) have none.
  const int pairs = C * ((valid_px + kPairRun - 1) / kPairRun);
  const int hk = threadIdx.x / pairs;
  const int hpair = threadIdx.x - hk * pairs;
  const int hch = hpair % C;
  const int hp0 = hpair / C * kPairRun;
  const bool live_lane = static_cast<int>(threadIdx.x) < valid_px * C;

  const auto stage = [&](int c) {
    const int v0 = v_first + c * kPairRun;
#pragma unroll
    for (int k = 0; k < kPairRun; k += gip::kStageRows) {
      gip::stage_rows<0>(src, in + k * g.in_stride, shift + k, g.in_stride, g0,
                         g.in_len, lanes, C, v0 + k, gip::kStageRows, -halo,
                         height + 2 * halo);
    }
  };

  stage(0);
  for (int c = 0;; ++c) {
    gip::wait_async_copies();
    __syncthreads();   // chunk c is staged; the run that read its slot is done
    const int v = v_first + c * kPairRun + hk;
    if (hk < kPairRun && v >= y0 - R && v <= v_last) {
      const uint8_t* x = in + hk * g.in_stride + shift[hk] + hp0 * C + hch;
      uint8_t* h = ring + ((c % kChunks) * kPairRun + hk) * kPairRingStride +
                   hp0 * C + hch;
      float acc[kPairRun];
      pair_run<R, 0>(acc, x, C, taps);
      // Pixels past the strip's last live one land in its ring row unread.
#pragma unroll
      for (int i = 0; i < kPairRun; ++i) h[i * C] = quantize_u8_low(acc[i]);
    }
    __syncthreads();   // the chunk's ring rows are whole, and `in` is free
    const bool more = c < last_chunk;
    if (more) stage(c + 1);   // copied in while the vertical run goes
    const int n = c - (kChunks - 1);
    if (n >= 0 && live_lane) {
      const uint8_t* chunk[kChunks];
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        chunk[i] = ring + (n + i) % kChunks * kPairRun * kPairRingStride + threadIdx.x;
      }
      float acc[kPairRun];
      pair_column<R, kSkip, kChunks, 0>(acc, chunk, taps);
      const int yn = y0 + n * kPairRun;
      uint8_t* out = dst + static_cast<size_t>(yn) * lanes + threadIdx.x;
      // A whole run stores without a test a row; the band's last may not.
      const int rows_out = min(kPairRun, y_end - yn);
      if (rows_out == kPairRun) {
#pragma unroll
        for (int k = 0; k < kPairRun; ++k, out += lanes) *out = quantize_u8_low(acc[k]);
      } else {
#pragma unroll
        for (int k = 0; k < kPairRun; ++k, out += lanes) {
          if (k < rows_out) *out = quantize_u8_low(acc[k]);
        }
      }
    }
    if (!more) break;
  }
}

// The strip and the bands of a launch: of the strips of 1 to
// kPairMaxLanes / (kPairRun C) runs, those whose blocks leave the most
// warps resident on an SM (fewer ran slower), and of them the one whose
// grid, its row bands sized to fill the SMs' block slots once (a multiple
// of kPairRun rows), puts the least work on the busiest SM: its blocks,
// ceil(blocks / SMs), times a block's horizontal and vertical rows, 2 band
// + 2r, times its lanes and kPairBlockLanes.  Narrow strips give more
// strips and so taller bands, fewer halo rows a band; wide ones fewer
// blocks.  At 2146x3239 and r = 15 it takes strips of 4 runs at C = 3
// (bands of 224 rows, halo rows 11.8% of the horizontal pass) and of 8
// runs on planes: the fastest of each in card times.
struct PairLaunch {
  int runs = 0;
  int strips = 0;
  int bands = 0;
  int band_rows = 0;
};

template <int R, int kC>
cudaError_t pair_launch_for(int batch, int height, int width, int channels,
                            PairLaunch* best) {
  long long best_cost = 0;
  int best_warps = 0;
  for (int runs = kPairMaxLanes / kPairRun / channels; runs >= 1; --runs) {
    const PairGeometry g(R, channels, runs);
    int sms = 0, per_sm = 0;
    const cudaError_t err =
        gip::blocks_per_sm<gauss_pair_rows<R, kC>>(g.lanes, g.bytes(), &sms, &per_sm);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) continue;
    const long long strips = (width + g.strip_px - 1) / g.strip_px;
    const long long fit = std::max(1LL, sms * per_sm / (strips * batch));
    const int rows = static_cast<int>((height + fit - 1) / fit);
    const int band_rows = (rows + kPairRun - 1) / kPairRun * kPairRun;
    const int bands = (height + band_rows - 1) / band_rows;
    const long long blocks = strips * bands * batch;
    const long long cost = (blocks + sms - 1) / sms *
                           (2LL * band_rows + 2 * R) * (g.lanes + kPairBlockLanes);
    const int warps = per_sm * g.lanes / 32;
    if (best->runs == 0 || warps > best_warps ||
        (warps == best_warps && cost < best_cost)) {
      *best = {runs, static_cast<int>(strips), bands, band_rows};
      best_cost = cost;
      best_warps = warps;
    }
  }
  return best->runs > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <int R, int kC>
int launch_pair_r(const uint8_t* src, uint8_t* dst, const GaussTaps& taps,
                  int /*radius*/, int batch, int height, int width,
                  int channels, int halo, cudaStream_t stream) {
  constexpr auto kernel = gauss_pair_rows<R, kC>;
  // The widest strip takes the most shared memory.
  cudaError_t err = allow_shared<kernel>(
      PairGeometry(R, channels, kPairMaxLanes / kPairRun / channels).bytes());
  if (err != cudaSuccess) return err;
  PairLaunch p;
  err = pair_launch_for<R, kC>(batch, height, width, channels, &p);
  if (err != cudaSuccess) return err;
  const PairGeometry g(R, channels, p.runs);
  kernel<<<dim3(p.strips, p.bands, batch), g.lanes, g.bytes(), stream>>>(
      src, dst, taps, height, width, channels, halo, p.runs, p.band_rows);
  return cudaGetLastError();
}

// The radii gauss_pair_rows serves: from the crossover to the API's 15, and
// the cap, 31 (the radii with a weighted kernel of their own).
constexpr bool pair_serves(int radius, int channels) {
  return ((radius >= kPairMinRadius && radius <= 15) || radius == 31) &&
         channels <= kPairMaxChannels;
}

// The channels a launch of gauss_pair_rows takes as a constant: 3, or 0.
constexpr int pair_channels(int channels) { return channels == 3 ? 3 : 0; }

template <int kC, int... Rs>
constexpr std::array<GaussLaunch, sizeof...(Rs)> pair_table(
    std::integer_sequence<int, Rs...>) {
  return {&launch_pair_r<Rs + kPairMinRadius, kC>...};
}

// The tables gauss_pair_rows takes: w[t] and w[2r - t] the same float, bit
// for bit, for every t (its one product a pair needs it); every tap >= 0
// and their sum at most 1 + 2^-10, so that no sum leaves [0, 255.5) and
// quantize_u8_low needs no clamp (each sum is at most 255 sum(w) (1 +
// 2^-24)^(2r+1) < 255.3).  Every table the port builds is one; any other
// takes gauss_window_rows<Weighted, r>.
bool pair_takes(const GaussTaps& taps, int radius) {
  double sum = 0.0;
  for (int t = 0; t <= 2 * radius; ++t) {
    uint32_t a, b;
    std::memcpy(&a, &taps.w[t], sizeof a);
    std::memcpy(&b, &taps.w[2 * radius - t], sizeof b);
    if (a != b || !(taps.w[t] >= 0.0f)) return false;
    sum += taps.w[t];
  }
  return sum <= 1.0 + 1.0 / 1024;
}

// The launch of radius r is entry r - 1.  halo: 0, or r (halo rows given).
// The weighted taps go to gauss_pair_rows where it serves the radius and
// takes the table, checked here, where the taps are copied.
template <typename Mode>
int launch_gauss(const uint8_t* src, uint8_t* dst, const float* weights,
                 int radius, int batch, int height, int width, int channels,
                 int halo, void* stream) {
  static constexpr auto table =
      gauss_table<Mode>(std::make_integer_sequence<int, kMaxTaps / 2>());
  if (!gauss_takes(radius, channels) || (halo != 0 && halo != radius)) {
    return cudaErrorInvalidValue;
  }
  GaussTaps taps = {};
  std::copy(weights, weights + 2 * radius + 1, taps.w);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same_v<Mode, gip::Weighted>) {
    using Radii = std::make_integer_sequence<int, 16 - kPairMinRadius>;
    static constexpr auto pairs = pair_table<0>(Radii());
    static constexpr auto pairs3 = pair_table<3>(Radii());
    if (pair_serves(radius, channels) && pair_takes(taps, radius)) {
      const bool three = pair_channels(channels) == 3;
      const GaussLaunch launch =
          radius == 31 ? (three ? &launch_pair_r<31, 3> : &launch_pair_r<31, 0>)
                       : (three ? pairs3 : pairs)[radius - kPairMinRadius];
      return launch(src, dst, taps, radius, batch, height, width, channels,
                    halo, s);
    }
  }
  return table[radius - 1](src, dst, taps, radius, batch, height, width,
                           channels, halo, s);
}

template <int... Rs>
constexpr std::array<GaussLaunch, sizeof...(Rs)> box_window_table(
    std::integer_sequence<int, Rs...>) {
  return {&launch_gauss_r<gip::Box, Rs + 1>...};
}

int launch_box_taps(const uint8_t* src, uint8_t* dst, float inv, int radius,
                    int batch, int height, int width, int channels, int halo,
                    cudaStream_t stream) {
  static constexpr auto table =
      box_window_table(std::make_integer_sequence<int, kBoxWindowMaxRadius>());
  GaussTaps taps = {};
  taps.w[0] = inv;
  return table[radius - 1](src, dst, taps, radius, batch, height, width,
                           channels, halo, stream);
}

__device__ __forceinline__ uint8_t box_value(int sum, float inv) {
  return static_cast<uint8_t>(
      quantize_u8(__fmul_rn(static_cast<float>(sum), inv)));
}

// -- box_window_rows: one launch, running sums, a shared ring ----------------

constexpr int kBoxLanes = 2;                          // lanes a thread sums
constexpr int kRun = 32;         // pixels of one horizontal running sum
constexpr int kBoxMaxRadius = 64;
constexpr int kBoxMaxChannels = kStripLanes / kRun;   // 16

// Which device function a box of radius r runs: the window kernel's plain
// sums, the running sums, or (past the ring) the two wide launches.
enum class BoxRoute { kTaps, kWindow, kWide };

constexpr BoxRoute box_route(int radius) {
  return radius <= kBoxWindowMaxRadius ? BoxRoute::kTaps
         : radius <= kBoxMaxRadius     ? BoxRoute::kWindow
                                       : BoxRoute::kWide;
}

// The one-launch box (taps or running sums) takes these.
constexpr bool box_window_takes(int radius, int channels) {
  return radius >= 1 && box_route(radius) != BoxRoute::kWide &&
         channels >= 1 && channels <= kBoxMaxChannels;
}

struct BoxGeometry {
  Strip strip;
  int ring_rows;     // 2r + kChunk
  // strip_px * C rounded to an odd multiple of 16: the horizontal pass
  // writes kChunk ring rows at once, which a multiple of 128 bytes (512 at
  // C = 1) would put on one bank.
  int ring_stride;
  __host__ __device__ BoxGeometry(int radius, int channels, int width)
      : strip(radius, channels, kRun, width),
        ring_rows(2 * radius + kChunk),
        ring_stride((strip.strip_px * channels + 15) / 16 * 16 | 16) {}
  __host__ __device__ int bytes() const {
    return kChunk * strip.in_stride + ring_rows * ring_stride;
  }
};

// halo: 0, or r halo rows given above and below each image, as in
// gauss_window_rows.
__global__ void __launch_bounds__(kBlockThreads, kBlocksPerSM)
box_window_rows(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                float inv, int radius, int height, int width, int channels,
                int halo, int band_rows) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int shift[kChunk];
  const BoxGeometry g(radius, channels, width);
  uint8_t* in = smem;                        // kChunk staged input rows
  uint8_t* ring = smem + kChunk * g.strip.in_stride;  // quantized horizontal rows
  const int C = channels;
  const int lanes = width * C;
  const int px0 = blockIdx.x * g.strip.strip_px;
  const int y0 = blockIdx.y * band_rows;
  const int valid_px = min(g.strip.strip_px, width - px0);
  const int valid_lanes = valid_px * C;
  src += (static_cast<size_t>(blockIdx.z) * (height + 2 * halo) + halo) * lanes;
  dst += static_cast<size_t>(blockIdx.z) * height * lanes + px0 * C;
  // Virtual row v is input row clamp(v); output row y reads v = y-r .. y+r.
  const int v_begin = y0 - radius;
  const int v_end = min(y0 + band_rows, height) + radius;
  const int g0 = (px0 - radius) * C;   // row lane of staged byte 0
  const int runs = (valid_px + kRun - 1) / kRun;
  const int taps = 2 * radius + 1;
  // A thread's horizontal running sum, the same in every chunk: row
  // threadIdx.x % kChunk of the chunk and the (channel, run) pair
  // threadIdx.x / kChunk in channel-major order; a strip has at most
  // kStripLanes / kRun pairs.
  static_assert(kChunk * (kStripLanes / kRun) == kBlockThreads,
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
    gip::stage_rows<kBlockThreads, false>(src, in, shift, g.strip.in_stride, g0,
                                          g.strip.in_len, lanes, C, vc, nrows,
                                          -halo, height + 2 * halo);
    __syncthreads();

    // Horizontal: one running sum a (row, channel, run of kRun pixels).
    // Staged pixel j is strip pixel j - r, so output pixel p sums staged
    // pixels p .. p + 2r.  Chunk row k goes to ring row (slot0 + k) mod
    // ring_rows.
    const int slot0 = (vc - v_begin) % g.ring_rows;
    if (task_k < nrows && task_p0 < task_end) {
      const int slot_k = slot0 + task_k < g.ring_rows
                             ? slot0 + task_k : slot0 + task_k - g.ring_rows;
      const uint8_t* x = in + task_k * g.strip.in_stride + shift[task_k] + task_ch;
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
        const int j = threadIdx.x + i * kBlockThreads;
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
                      int batch, int height, int width, int channels, int halo,
                      void* stream) {
  if (!box_window_takes(radius, channels) || (halo != 0 && halo != radius)) {
    return cudaErrorInvalidValue;
  }
  if (box_route(radius) == BoxRoute::kTaps) {
    return launch_box_taps(src, dst, inv, radius, batch, height, width,
                           channels, halo, static_cast<cudaStream_t>(stream));
  }
  const BoxGeometry g(radius, channels, width);
  cudaError_t err = allow_shared<box_window_rows>(g.bytes());
  if (err != cudaSuccess) return err;
  const int columns = (width + g.strip.strip_px - 1) / g.strip.strip_px;
  int band_rows = 0;
  err = gip::band_rows_for<box_window_rows>(
      kBlockThreads, g.bytes(), static_cast<long long>(columns) * batch, height,
      16, kMinBandRows, &band_rows);
  if (err != cudaSuccess) return err;
  box_window_rows<<<dim3(columns, (height + band_rows - 1) / band_rows, batch),
                    kBlockThreads, g.bytes(),
                    static_cast<cudaStream_t>(stream)>>>(
      src, dst, inv, radius, height, width, channels, halo, band_rows);
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
  if (box_route(radius) != BoxRoute::kWide) return cudaErrorInvalidValue;
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

bool band_takes(int radius, int channels) {
  return radius >= 1 && radius <= kBandMaxRadius && channels >= 1 &&
         BandGeometry(radius, channels).bytes() <= kMaxSharedBytes;
}

int launch_band(const uint8_t* src, uint8_t* dst, const float* hi,
                const float* lo, int radius, int batch, int height, int width,
                int channels, void* stream) {
  if (!band_takes(radius, channels)) return cudaErrorInvalidValue;
  const BandGeometry g(radius, channels);
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

// src, dst: (B, H, W*C) uint8 on the device.  weights: (2r+1,) float32 on
// the host, copied into the launch's parameters.  1 <= r <= 31,
// 1 <= C <= kGaussMaxChannels (32).
extern "C" int gip_gaussian_rows(const uint8_t* src, uint8_t* dst,
                                 const float* weights, int radius, int batch,
                                 int height, int width, int channels,
                                 void* stream) {
  return launch_gauss<gip::Weighted>(src, dst, weights, radius, batch, height,
                                     width, channels, 0, stream);
}

extern "C" int gip_gaussian_folded_rows(const uint8_t* src, uint8_t* dst,
                                        const float* weights, int radius,
                                        int batch, int height, int width,
                                        int channels, void* stream) {
  return launch_gauss<gip::Folded>(src, dst, weights, radius, batch, height,
                                   width, channels, 0, stream);
}

// The planar blur (K5): src (N, H, W) uint8 planes, or (N, H + 2r, W) when
// rows_prepadded; dst (N, H, W); the window kernels at one channel, each
// plane an image of the batch.  weights as above, 1 <= r <= 31.
extern "C" int gip_gaussian_planar(const uint8_t* src, uint8_t* dst,
                                   const float* weights, int radius,
                                   int planes, int height, int width,
                                   int rows_prepadded, void* stream) {
  return launch_gauss<gip::Weighted>(src, dst, weights, radius, planes,
                                     height, width, 1,
                                     rows_prepadded ? radius : 0, stream);
}

extern "C" int gip_gaussian_folded_planar(const uint8_t* src, uint8_t* dst,
                                          const float* weights, int radius,
                                          int planes, int height, int width,
                                          int rows_prepadded, void* stream) {
  return launch_gauss<gip::Folded>(src, dst, weights, radius, planes, height,
                                   width, 1, rows_prepadded ? radius : 0,
                                   stream);
}

// inv: the f32 reciprocal 1/(2r+1); 1 <= r <= 64.
extern "C" int gip_box_planar(const uint8_t* src, uint8_t* dst, float inv,
                              int radius, int planes, int height, int width,
                              int rows_prepadded, void* stream) {
  return launch_box_window(src, dst, inv, radius, planes, height, width, 1,
                           rows_prepadded ? radius : 0, stream);
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
// kernel takes 1 <= r <= 64 and 1 <= C <= 16; the wide one r > 64 and
// scratch of the image's size.
extern "C" int gip_box_window_rows(const uint8_t* src, uint8_t* dst, float inv,
                                   int radius, int batch, int height,
                                   int width, int channels, void* stream) {
  return launch_box_window(src, dst, inv, radius, batch, height, width,
                           channels, 0, stream);
}

extern "C" int gip_box_wide_rows(const uint8_t* src, uint8_t* tmp, uint8_t* dst,
                                 float inv, int radius, int batch, int height,
                                 int width, int channels, void* stream) {
  return launch_box_wide(src, tmp, dst, inv, radius, batch, height, width,
                         channels, stream);
}

// The device function that a blur launch of these arguments runs, as the
// launch functions above pick it: (function << 8) | R, where R is the
// window kernel's template radius (0: the radius at run time) and function
// is 1 gauss_window_rows<Weighted, R>, 2 <Folded, R>, 3 <Box, R>,
// 4 box_window_rows, 5 box_wide_h + box_wide_v, 6 band_mma_rows,
// 7 gauss_pair_rows<R, 0>, 8 gauss_pair_rows<R, 3>; -1 where the launch
// refuses the arguments.  kind: 0 the weighted gaussian (gip_gaussian_rows,
// _planar) with a table gauss_pair_rows takes (pair_takes), 4 with one it
// does not, 1 the folded one, 2 the box (gip_box_*), 3 the band.  A planar
// launch is a launch at one channel.
extern "C" int gip_blur_route(int kind, int radius, int channels) {
  switch (kind) {
    case 0:
      if (gauss_takes(radius, channels) && pair_serves(radius, channels)) {
        return (pair_channels(channels) == 3 ? 8 << 8 : 7 << 8) | radius;
      }
      [[fallthrough]];
    case 4:
      return gauss_takes(radius, channels)
                 ? (1 << 8) | kernel_radius<gip::Weighted>(radius) : -1;
    case 1:
      return gauss_takes(radius, channels)
                 ? (2 << 8) | kernel_radius<gip::Folded>(radius) : -1;
    case 2:
      if (box_route(radius) == BoxRoute::kWide) {
        return channels >= 1 ? 5 << 8 : -1;
      }
      if (!box_window_takes(radius, channels)) return -1;
      return box_route(radius) == BoxRoute::kTaps ? (3 << 8) | radius : 4 << 8;
    case 3:
      return band_takes(radius, channels) ? 6 << 8 : -1;
    default:
      return -1;
  }
}
