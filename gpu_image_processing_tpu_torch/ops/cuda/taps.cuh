// The scalar blur taps of blur_planar.cu (both passes in one launch, the
// only user): one pass's value at one output element, in the tap order each
// numerics level fixes.
//
//   Weighted (level 2): acc = __fadd_rn(acc, __fmul_rn(px, w[t])) in tap order;
//   Folded (level 4, r < 3): for t < r, acc += (x[t] + x[2r-t]) * w[t] in t
//     order, then acc += x[r] * w[r] (blur.py:318-329);
//   Box (levels 2 and 4): an int32 window sum, exact, so tap order does not
//     matter, then __fmul_rn((float)sum, 1/taps).
//
// What bounds a kernel built on these: instruction issue, about ten
// instructions a tap (load, convert, weight load, multiply, add, loop).
// The rows kernels of blur.cu do not use them: the gaussian keeps register
// windows with the taps as constant operands, box running window sums, the
// band the tensor cores.  The tags below name the tap orders for both files.
#pragma once

#include <type_traits>

namespace gip {

// Tap orders, as template tags (their names show in profiler traces).
struct Weighted {};
struct Folded {};
struct Box {};

// One pass's value from `load(t)`, the u8 value of tap t in [0, 2r].
template <typename Mode, typename Load>
__device__ __forceinline__ float taps_value(const Load& load,
                                            const float* __restrict__ w,
                                            float inv, int radius) {
  if constexpr (std::is_same_v<Mode, Box>) {
    int sum = 0;
    for (int t = 0; t <= 2 * radius; ++t) sum += load(t);
    return __fmul_rn(static_cast<float>(sum), inv);
  } else if constexpr (std::is_same_v<Mode, Folded>) {
    float acc = 0.0f;
    for (int t = 0; t < radius; ++t) {
      const float pair = static_cast<float>(load(t) + load(2 * radius - t));
      acc = __fadd_rn(acc, __fmul_rn(pair, __ldg(w + t)));
    }
    return __fadd_rn(acc, __fmul_rn(static_cast<float>(load(radius)),
                                    __ldg(w + radius)));
  } else {
    float acc = 0.0f;
    for (int t = 0; t <= 2 * radius; ++t) {
      acc = __fadd_rn(acc, __fmul_rn(static_cast<float>(load(t)), __ldg(w + t)));
    }
    return acc;
  }
}

}  // namespace gip
