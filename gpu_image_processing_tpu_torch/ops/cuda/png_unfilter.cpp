// PNG scanline unfiltering (the PNG specification, section 9: filter types
// None, Sub, Up, Average and Paeth), a host helper of utils/image.py.
//
// Average and Paeth depend on the byte just unfiltered to their left, so a
// row is sequential; a Python loop over a 7-Mpixel image takes tens of
// seconds, this loop milliseconds.  Its plain version is
// utils/image.py::unfilter_plain (numpy), which the CPU path and the tests
// use.

#include <cstdint>
#include <cstdlib>

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

// raw: height rows of (1 filter byte + row_bytes) bytes, as inflated from
// IDAT.  out: height * row_bytes bytes.  bpp: bytes per pixel (>= 1).
// Returns 0, or -(y + 1) when row y has an unknown filter type.
extern "C" int gip_png_unfilter(const uint8_t* raw, uint8_t* out,
                                int64_t height, int64_t row_bytes, int bpp) {
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* in = raw + y * (row_bytes + 1);
    const uint8_t filter = in[0];
    ++in;
    uint8_t* cur = out + y * row_bytes;
    const uint8_t* prev = y > 0 ? cur - row_bytes : nullptr;
    for (int64_t i = 0; i < row_bytes; ++i) {
      const int a = i >= bpp ? cur[i - bpp] : 0;
      const int b = prev ? prev[i] : 0;
      const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
      int pred;
      switch (filter) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: pred = paeth(a, b, c); break;
        default: return static_cast<int>(-(y + 1));
      }
      cur[i] = static_cast<uint8_t>(in[i] + pred);
    }
  }
  return 0;
}
