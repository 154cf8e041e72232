// Shared helpers of the hand-written kernels: the reference's rounding, the
// staging of interleaved rows into shared memory, the launch-side helpers
// (shared-memory opt-in, row bands) and the plain C interface that Python
// loads with ctypes (ops/cuda/build.py).
//
// Every float operation below uses an `_rn` intrinsic, and the library is
// also built with -fmad=false: a contracted multiply-add rounds once where
// the reference rounds twice, which flips floor(x + 0.5) ties.
#pragma once

#include <algorithm>
#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace gip {

// (unsigned char)(x + 0.5f) of the reference for x >= 0: floor(x + 0.5)
// clamped to [0, 255].  Not __float2int_rn: that rounds half to even.
__device__ __forceinline__ float quantize_u8(float x) {
  return fminf(fmaxf(floorf(__fadd_rn(x, 0.5f)), 0.0f), 255.0f);
}

__device__ __forceinline__ int clamp_index(int i, int n) {
  return min(max(i, 0), n - 1);
}

// i clamped to the rows lo .. lo + count - 1.
__device__ __forceinline__ int clamp_row(int i, int lo, int count) {
  return min(max(i, lo), lo + count - 1);
}

// The f32 value of 0 <= v < 2^23 on the FP32 unit, not the conversion unit
// (a quarter of the rate): 2^23 + v is exact in f32, so less 2^23 it is v.
__device__ __forceinline__ float u8_to_f32(unsigned v) {
  return __fsub_rn(__uint_as_float(0x4B000000u | v), 8388608.0f);
}

// quantize_u8 as an int, on the FP32 and integer units: t = x + 0.5 rounded
// to nearest, as the reference rounds it; t + 1.5 * 2^23 rounded down is
// floor(t) + 1.5 * 2^23 exactly while |t| < 2^22 (the ulp there is 1), so
// its bits less those of 1.5 * 2^23 are floor(t); then clamped to [0, 255].
// Equal to quantize_u8 for |x| < 2^22, which every blur sum keeps.
__device__ __forceinline__ int quantize_u8_int(float x) {
  const float f = __fadd_rd(__fadd_rn(x, 0.5f), 12582912.0f);
  return min(max(__float_as_int(f) - 0x4B400000, 0), 255);
}

// One 16-byte copy from device to shared memory that does not wait for the
// data (cp.async); both addresses 16-byte aligned.
__device__ __forceinline__ void copy16_async(void* shared, const void* global) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(shared));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to),
               "l"(global));
}

// Wait for this thread's cp.async copies; a barrier then shows them to the
// block.
__device__ __forceinline__ void wait_async_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows a stage_rows call copies at most.
constexpr int kStageRows = 16;

// Stage `nrows` (<= kStageRows) rows of interleaved (H, W*C) uint8 rows into
// shared memory, a block of kBlockThreads threads: staged byte e of row k,
// at staged[k * stride + shift[k] + e] for e < len, is lane g0 + e of row
// clamp(v0 + k, row_lo, row_lo + row_count - 1) of `src` (rows row_lo ..
// row_lo + row_count - 1 are the image's: row_lo = 0 and row_count = H for
// an image alone; with h given halo rows above and below, `src` points at
// the first row below them, row_lo = -h and row_count = H + 2h), its pixel
// clamped to [0, W - 1] in its own channel (g0 is a multiple of C, so the
// channel is e % C).  `stride` is at least
// (len + 30) / 16 * 16, and `staged` and `stride` are multiples of 16.  A
// span that lies inside the row is copied as the 16-byte aligned chunks
// that cover it (shift[k] is the span's phase; the bytes around it are the
// row's neighbours and are never read), with cp.async copies that do not
// wait for their data when kAsync, else with 16-byte loads and stores; a
// chunk that would leave the image's bytes goes byte by byte.  A span that
// passes the image's edge is clamped byte by byte, with nrows loads in
// flight a thread.  Before reading, the caller calls wait_async_copies
// (kAsync) and then synchronises the block.  A caller that waits at once
// gains nothing from cp.async, and measured it slower.
template <int kBlockThreads, bool kAsync = true>
__device__ __forceinline__ void stage_rows(
    const uint8_t* __restrict__ src, uint8_t* __restrict__ staged, int* shift,
    int stride, int g0, int len, int lanes, int channels, int v0, int nrows,
    int row_lo, int row_count) {
  const auto row_at = [&](int v) {
    return src + static_cast<ptrdiff_t>(clamp_row(v, row_lo, row_count)) * lanes;
  };
  if (g0 >= 0 && g0 + len <= lanes) {
    const uint8_t* image_begin = src + static_cast<ptrdiff_t>(row_lo) * lanes;
    const uint8_t* image_end = image_begin + static_cast<size_t>(row_count) * lanes;
#pragma unroll 2
    for (int k = threadIdx.x / 32; k < nrows; k += kBlockThreads / 32) {
      const uint8_t* a = row_at(v0 + k) + g0;
      const int sh = static_cast<int>(reinterpret_cast<uintptr_t>(a) & 15);
      const uint8_t* base = a - sh;   // 16-byte aligned
      uint8_t* row = staged + k * stride;
      const int end = sh + len;
      if (threadIdx.x % 32 == 0) shift[k] = sh;
      for (int c = threadIdx.x % 32 * 16; c < end; c += 32 * 16) {
        if (base + c >= image_begin && base + c + 16 <= image_end) {
          if constexpr (kAsync) {
            copy16_async(row + c, base + c);
          } else {
            *reinterpret_cast<uint4*>(row + c) =
                __ldg(reinterpret_cast<const uint4*>(base + c));
          }
        } else {
          for (int e = max(c, sh); e < min(c + 16, end); ++e) row[e] = base[e];
        }
      }
    }
  } else {
    if (threadIdx.x < kStageRows) shift[threadIdx.x] = 0;
    for (int e = threadIdx.x; e < len; e += kBlockThreads) {
      int at = g0 + e;
      if (at < 0) {
        at = e % channels;
      } else if (at >= lanes) {
        at = lanes - channels + e % channels;
      }
      uint8_t v[kStageRows];
#pragma unroll
      for (int k = 0; k < kStageRows; ++k) {
        v[k] = k < nrows ? row_at(v0 + k)[at] : 0;
      }
#pragma unroll
      for (int k = 0; k < kStageRows; ++k) {
        if (k < nrows) staged[k * stride + e] = v[k];
      }
    }
  }
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

// Row bands of `block_threads`-thread blocks of `kernel` with `bytes` of
// shared memory over `columns` strips (times the batch): as many bands as
// fill the SMs' block slots once (a block's time grows with its rows, a
// partial last wave idles most SMs), each a multiple of `multiple` rows and
// at least `least`.  The result of a kernel does not depend on it.
//
// The SM count and the blocks an SM holds are fixed for a kernel, a card,
// its threads and its shared memory, so they are asked of the runtime on
// the first launch of each (device, threads, bytes) and kept, key and
// answer in one atomic word of a small table that is only ever filled (a
// slot is claimed by compare-and-swap, so threads that launch at once keep
// consistent entries); a launch whose key finds no slot asks again.
template <auto kernel>
cudaError_t band_rows_for(int block_threads, int bytes, long long columns,
                          int height, int multiple, int least, int* band_rows) {
  constexpr int kSlots = 64;
  // key (device + 1, threads, bytes) << 24 | sms << 12 | per_sm; 0: empty.
  static std::atomic<unsigned long long> held[kSlots];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long key =
      (static_cast<unsigned long long>(device + 1) << 29 |
       static_cast<unsigned long long>(block_threads) << 18 |
       static_cast<unsigned long long>(bytes)) << 24;
  const bool cacheable = device < 255 && block_threads < (1 << 11) &&
                         bytes >= 0 && bytes < (1 << 18);
  int sms = 0, per_sm = 0;
  int slot = -1;
  if (cacheable) {
    const int start = static_cast<int>((key >> 24) * 0x9E3779B97F4A7C15ull >> 58);
    for (int i = 0; i < kSlots; ++i) {
      const int at = (start + i) % kSlots;
      const unsigned long long entry = held[at].load(std::memory_order_acquire);
      if (entry == 0) {
        slot = at;
        break;
      }
      if ((entry & ~0xFFFFFFull) == key) {
        sms = static_cast<int>(entry >> 12 & 0xFFF);
        per_sm = static_cast<int>(entry & 0xFFF);
        break;
      }
    }
  }
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          block_threads, bytes);
    }
    if (err != cudaSuccess) return err;
    if (slot >= 0 && sms > 0 && sms < (1 << 12) && per_sm >= 0 &&
        per_sm < (1 << 12)) {
      unsigned long long empty = 0;
      // Another thread may have claimed the slot meanwhile: then this
      // answer is simply not kept.
      held[slot].compare_exchange_strong(
          empty,
          key | static_cast<unsigned long long>(sms) << 12 |
              static_cast<unsigned long long>(per_sm),
          std::memory_order_acq_rel);
    }
  }
  const long long bands = std::max(1LL, sms * std::max(per_sm, 1) / columns);
  const int rows = static_cast<int>((height + bands - 1) / bands);
  *band_rows = std::max((rows + multiple - 1) / multiple * multiple, least);
  return cudaSuccess;
}

}  // namespace gip

// cudaGetErrorString for the code a launch function returned.
extern "C" const char* gip_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
