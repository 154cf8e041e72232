// The scanline half of the native PNG tier (utils/native_codec.py): filter
// rows for the encoder, unfilter them for the decoder.  Host C++ with a C
// ABI, built by ops/cuda/build.py with the host C++ compiler (CXX_FLAGS), so
// it builds on any host, the card's or not.  Deflate, inflate and the CRCs
// stay on Python's `zlib`, the library native/src/gip_codec.cpp links, so
// nothing here needs <zlib.h>.
//
// The loops are gip_codec.cpp's: the encoder's Sub filter (:182-194) and the
// decoder's rows specialized by filter type (:279-321).  Its plain version is
// utils/image.py::unfilter_plain, which the tests and chip_smoke.py hold it
// against.

#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a);
  const int pb = std::abs(p - b);
  const int pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

// img: h rows of w * c bytes (HWC uint8).  out: h records of 1 filter byte
// and w * c bytes.  level <= 1 writes filter type 1 (Sub) on every row, the
// serving encoder's fast path; level >= 2 filter type 0 (None).
extern "C" int gip_png_filter_rows(const uint8_t* img, int64_t h, int64_t w,
                                   int c, int level, uint8_t* out) {
  if (!img || !out || h <= 0 || w <= 0 || c < 1 || c > 4) return 1;
  const size_t stride = static_cast<size_t>(w) * c;
  for (int64_t y = 0; y < h; ++y) {
    uint8_t* dst = out + (stride + 1) * y;
    const uint8_t* src = img + stride * y;
    if (level <= 1) {
      dst[0] = 1;
      for (int k = 0; k < c; ++k) dst[1 + k] = src[k];
      for (size_t x = c; x < stride; ++x)
        dst[1 + x] = static_cast<uint8_t>(src[x] - src[x - c]);
    } else {
      dst[0] = 0;
      std::memcpy(dst + 1, src, stride);
    }
  }
  return 0;
}

// raw: rows records of (1 filter byte + stride bytes), as inflated from
// IDAT.  out: rows * stride bytes, the unfiltered rows packed; the previous
// row of out is "up".  fbpp: the filter's unit, max(1, bits a pixel / 8).
// Returns 0, or -(y + 1) when row y has an unknown filter type.
extern "C" int gip_png_unfilter(const uint8_t* raw, uint8_t* out,
                                int64_t rows, int64_t stride, int fbpp) {
  const size_t n = static_cast<size_t>(stride);
  const size_t bpp = static_cast<size_t>(fbpp);
  for (int64_t y = 0; y < rows; ++y) {
    const uint8_t* in = raw + (n + 1) * y + 1;
    const uint8_t filter = in[-1];
    uint8_t* dst = out + n * y;
    const uint8_t* up = y ? dst - n : nullptr;
    switch (filter) {
      case 0:
        std::memcpy(dst, in, n);
        break;
      case 1:  // Sub
        for (size_t x = 0; x < bpp && x < n; ++x) dst[x] = in[x];
        for (size_t x = bpp; x < n; ++x)
          dst[x] = static_cast<uint8_t>(in[x] + dst[x - bpp]);
        break;
      case 2:  // Up (b = 0 on the first row: None)
        if (up) {
          for (size_t x = 0; x < n; ++x)
            dst[x] = static_cast<uint8_t>(in[x] + up[x]);
        } else {
          std::memcpy(dst, in, n);
        }
        break;
      case 3:  // Average
        if (!up) {
          for (size_t x = 0; x < bpp && x < n; ++x) dst[x] = in[x];
          for (size_t x = bpp; x < n; ++x)
            dst[x] = static_cast<uint8_t>(in[x] + dst[x - bpp] / 2);
        } else {
          for (size_t x = 0; x < bpp && x < n; ++x)
            dst[x] = static_cast<uint8_t>(in[x] + up[x] / 2);
          for (size_t x = bpp; x < n; ++x)
            dst[x] = static_cast<uint8_t>(in[x] + (dst[x - bpp] + up[x]) / 2);
        }
        break;
      case 4:  // Paeth (first row: the predictor is a, Sub; first unit: b, Up)
        if (!up) {
          for (size_t x = 0; x < bpp && x < n; ++x) dst[x] = in[x];
          for (size_t x = bpp; x < n; ++x)
            dst[x] = static_cast<uint8_t>(in[x] + dst[x - bpp]);
        } else {
          for (size_t x = 0; x < bpp && x < n; ++x)
            dst[x] = static_cast<uint8_t>(in[x] + up[x]);
          for (size_t x = bpp; x < n; ++x)
            dst[x] = static_cast<uint8_t>(
                in[x] + paeth(dst[x - bpp], up[x], up[x - bpp]));
        }
        break;
      default:
        return static_cast<int>(-(y + 1));
    }
  }
  return 0;
}
