// Shared helpers of the hand-written kernels: the reference's rounding and
// the plain C interface that Python loads with ctypes (ops/cuda/build.py).
//
// Every float operation below uses an `_rn` intrinsic, and the library is
// also built with -fmad=false: a contracted multiply-add rounds once where
// the reference rounds twice, which flips floor(x + 0.5) ties.
#pragma once

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace gip {

constexpr int kThreads = 256;
// gridDim.y limit; taller images loop over rows inside the kernel.
constexpr int kMaxGridY = 65535;

// (unsigned char)(x + 0.5f) of the reference for x >= 0: floor(x + 0.5)
// clamped to [0, 255].  Not __float2int_rn: that rounds half to even.
__device__ __forceinline__ float quantize_u8(float x) {
  return fminf(fmaxf(floorf(__fadd_rn(x, 0.5f)), 0.0f), 255.0f);
}

__device__ __forceinline__ int clamp_index(int i, int n) {
  return min(max(i, 0), n - 1);
}

// x: lanes, y: rows (looped past kMaxGridY), z: the images of a batch.
inline dim3 rows_grid(int lanes, int height, int batch) {
  return dim3((lanes + kThreads - 1) / kThreads, std::min(height, kMaxGridY),
              batch);
}

}  // namespace gip

// cudaGetErrorString for the code a launch function returned.
extern "C" const char* gip_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
