// png_bands: the serving PNG encoder of the PyTorch port, its rows deflated
// in row bands on threads, as pigz does, into one valid zlib stream.
//
// The image is the one gip_png_encode (native/src/gip_codec.cpp) writes at
// level 1: 8-bit grey, RGB or RGBA, every row Sub-filtered, zlib level 1
// with run-length matching (Z_RLE), in one PNG.  Here the rows are cut into
// `bands` contiguous bands.  Band i runs on its own std::thread (the
// caller's thread takes band 0): it Sub-filters its rows into its slice of
// one filtered buffer, keeps the slice's adler32, and deflates the slice raw
// (no zlib header) with the same level, window, memory level and strategy,
// ending in a full flush, byte-aligned and without a final block (the last
// band ends the stream with Z_FINISH).  Z_RLE only matches at distance 1,
// so a band that starts with no history loses at most a match of its first
// byte, and the size moves by a few bytes a band, either way.
//
// The stream is the 2-byte header deflateInit2(level 1, Z_DEFLATED, 15, 8,
// Z_RLE) writes, the bands' output in order, and the big-endian
// adler32_combine of the bands' sums.  Each IDAT chunk's CRC is joined from
// the bands' crc32 sums with crc32_combine.  The PNG is written straight
// into one malloc'd buffer: signature, IHDR, IDAT chunks of at most 1 GiB
// (as gip_codec.cpp splits them), IEND.
//
// The bytes depend on the image and the band count alone, never on how the
// threads are scheduled.  At one band they are gip_png_encode's at level 1:
// the same deflate over the same rows, its header and its Adler-32.
//
// C ABI, bound with ctypes (utils/native_codec.py); the result is freed
// with std::free.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <new>
#include <system_error>
#include <thread>
#include <vector>
#include <zlib.h>

namespace {

// zlib's lengths are 32-bit: it is fed and read in pieces of at most this.
constexpr size_t kPiece = size_t(1) << 30;
// The largest IDAT payload, as gip_codec.cpp's png_assemble splits them
// (PNG caps a chunk at 2^31 - 1 bytes).
constexpr size_t kMaxIdat = size_t(1) << 30;
// The header deflateInit2(1, Z_DEFLATED, 15, 8, Z_RLE) writes: CM 8 with a
// 32 KiB window, FLEVEL 0 (Z_RLE and level 1 both give it), FCHECK 1.
constexpr uint8_t kZlibHeader[2] = {0x78, 0x01};

struct Band {
  size_t row0 = 0, rows = 0;           // the image rows it covers
  uLong adler = 1;                     // adler32 of its filtered rows
  uLong crc = 0;                       // crc32 of its deflate output
  std::unique_ptr<uint8_t[]> out;      // its deflate output
  size_t out_len = 0;
  int rc = 0;                          // 0, or the error code it ended on
};

uLong adler_of(uLong adler, const uint8_t* p, size_t n) {
  for (size_t off = 0; off < n; off += kPiece)
    adler = adler32(adler, p + off, (uInt)std::min(n - off, kPiece));
  return adler;
}

uLong crc_of(uLong crc, const uint8_t* p, size_t n) {
  for (size_t off = 0; off < n; off += kPiece)
    crc = crc32(crc, p + off, (uInt)std::min(n - off, kPiece));
  return crc;
}

// Raw deflate of `n` bytes into band.out: level 1, Z_RLE, ending in a full
// flush, or in Z_FINISH for the stream's last band.  0, or 2 on a zlib
// error.
int deflate_band(const uint8_t* in, size_t n, bool last, Band& band) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (deflateInit2(&zs, 1, Z_DEFLATED, -15, 8, Z_RLE) != Z_OK) return 2;
  // The bound holds a whole stream; the full flush's empty stored block
  // needs 5 bytes more.  The loop grows the buffer should it fill.
  size_t cap = (size_t)deflateBound(&zs, (uLong)n) + 16;
  std::unique_ptr<uint8_t[]> out(new uint8_t[cap]);
  const int flush = last ? Z_FINISH : Z_FULL_FLUSH;
  size_t in_off = 0, out_off = 0;
  int rc = Z_OK;
  for (;;) {
    if (out_off == cap) {
      std::unique_ptr<uint8_t[]> wider(new uint8_t[2 * cap]);
      std::memcpy(wider.get(), out.get(), out_off);
      out = std::move(wider);
      cap *= 2;
    }
    const size_t take = std::min(n - in_off, kPiece);
    const bool final_piece = in_off + take == n;
    zs.next_in = const_cast<uint8_t*>(in + in_off);
    zs.avail_in = (uInt)take;
    zs.next_out = out.get() + out_off;
    zs.avail_out = (uInt)std::min(cap - out_off, kPiece);
    const uInt fed_in = zs.avail_in, fed_out = zs.avail_out;
    rc = deflate(&zs, final_piece ? flush : Z_NO_FLUSH);
    if (rc == Z_STREAM_ERROR) break;
    in_off += fed_in - zs.avail_in;
    out_off += fed_out - zs.avail_out;
    if (last ? rc == Z_STREAM_END
             : final_piece && in_off == n && zs.avail_out != 0)
      break;
  }
  deflateEnd(&zs);
  if (rc == Z_STREAM_ERROR) return 2;
  band.out = std::move(out);
  band.out_len = out_off;
  return 0;
}

// Band `band`'s whole work: its rows' Sub filter into its slice of `raw`
// (gip_codec.cpp's level <= 1 rows), the slice's adler32, its deflate and
// the crc32 of that.  Never throws: a failure is left in band.rc.
void run_band(const uint8_t* img, size_t stride, int c, uint8_t* raw,
              bool last, Band& band) noexcept {
  try {
    const size_t line = stride + 1;
    uint8_t* slice = raw + line * band.row0;
    for (size_t y = 0; y < band.rows; ++y) {
      uint8_t* dst = slice + line * y;
      const uint8_t* src = img + stride * (band.row0 + y);
      dst[0] = 1;  // Sub filter
      for (int k = 0; k < c; ++k) dst[1 + k] = src[k];
      for (size_t x = c; x < stride; ++x)
        dst[1 + x] = (uint8_t)(src[x] - src[x - c]);
    }
    const size_t n = line * band.rows;
    band.adler = adler_of(1, slice, n);
    band.rc = deflate_band(slice, n, last, band);
    if (band.rc == 0) band.crc = crc_of(0, band.out.get(), band.out_len);
  } catch (const std::bad_alloc&) {
    band.rc = 3;
  } catch (...) {
    band.rc = 9;
  }
}

void put_be32(uint8_t* p, uint32_t x) {
  p[0] = uint8_t(x >> 24);
  p[1] = uint8_t(x >> 16);
  p[2] = uint8_t(x >> 8);
  p[3] = uint8_t(x);
}

// One piece of the zlib stream as it lies in the PNG's IDAT chunks.
struct Piece {
  const uint8_t* data;
  size_t len;
  uLong crc;
};

// A whole chunk at `p`: length, type, payload (already at p + 8), CRC.
uint8_t* close_chunk(uint8_t* p, const char type[4], size_t len) {
  put_be32(p, (uint32_t)len);
  std::memcpy(p + 4, type, 4);
  put_be32(p + 8 + len, (uint32_t)crc_of(0, p + 4, 4 + len));
  return p + 12 + len;
}

int encode_bands(const uint8_t* img, int h, int w, int c, int bands,
                 uint8_t** out_buf, size_t* out_len) {
  if (!img || !out_buf || !out_len || h <= 0 || w <= 0 || bands <= 0 ||
      (c != 1 && c != 3 && c != 4))
    return 1;
  const uint8_t color_type = c == 1 ? 0 : (c == 3 ? 2 : 6);
  const size_t stride = (size_t)w * c;
  const size_t n_bands = (size_t)std::min(bands, h);

  std::vector<Band> band(n_bands);
  for (size_t i = 0; i < n_bands; ++i) {
    band[i].row0 = (size_t)h * i / n_bands;
    band[i].rows = (size_t)h * (i + 1) / n_bands - band[i].row0;
  }
  std::unique_ptr<uint8_t[]> raw(new uint8_t[(stride + 1) * (size_t)h]);
  {
    std::vector<std::thread> threads;
    threads.reserve(n_bands);
    // Joins every started thread however this block is left.
    struct Joiner {
      std::vector<std::thread>& threads;
      ~Joiner() {
        for (auto& t : threads)
          if (t.joinable()) t.join();
      }
    } joiner{threads};
    for (size_t i = 1; i < n_bands; ++i) {
      const bool last = i + 1 == n_bands;
      try {
        threads.emplace_back(run_band, img, stride, c, raw.get(), last,
                             std::ref(band[i]));
      } catch (const std::system_error&) {
        // No thread to be had: the band runs here, the bytes the same.
        run_band(img, stride, c, raw.get(), last, band[i]);
      }
    }
    run_band(img, stride, c, raw.get(), n_bands == 1, band[0]);
  }
  raw.reset();
  for (const Band& b : band)
    if (b.rc) return b.rc;

  uLong adler = band[0].adler;
  for (size_t i = 1; i < n_bands; ++i)
    adler = adler32_combine(adler, band[i].adler,
                            (z_off_t)((stride + 1) * band[i].rows));
  uint8_t trailer[4];
  put_be32(trailer, (uint32_t)adler);
  std::vector<Piece> pieces;
  pieces.reserve(n_bands + 2);
  pieces.push_back({kZlibHeader, 2, crc_of(0, kZlibHeader, 2)});
  for (const Band& b : band) pieces.push_back({b.out.get(), b.out_len, b.crc});
  pieces.push_back({trailer, 4, crc_of(0, trailer, 4)});
  size_t zlen = 0;
  for (const Piece& piece : pieces) zlen += piece.len;

  const size_t n_idat = (zlen + kMaxIdat - 1) / kMaxIdat;
  const size_t total = 8 + (12 + 13) + 12 * n_idat + zlen + 12;
  uint8_t* png = (uint8_t*)std::malloc(total);
  if (!png) return 3;
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  std::memcpy(png, sig, 8);
  uint8_t* p = png + 8;
  uint8_t* ihdr = p + 8;
  put_be32(ihdr, (uint32_t)w);
  put_be32(ihdr + 4, (uint32_t)h);
  ihdr[8] = 8;  // bit depth
  ihdr[9] = color_type;
  ihdr[10] = ihdr[11] = ihdr[12] = 0;  // deflate, adaptive, no interlace
  p = close_chunk(p, "IHDR", 13);

  // The IDAT chunks: each copies the pieces it covers and joins their CRCs,
  // whole pieces by crc32_combine, a piece cut by a chunk's end by crc32.
  size_t piece = 0, piece_off = 0;
  for (size_t done = 0; done < zlen;) {
    const size_t len = std::min(zlen - done, kMaxIdat);
    put_be32(p, (uint32_t)len);
    std::memcpy(p + 4, "IDAT", 4);
    uLong crc = crc_of(0, p + 4, 4);
    uint8_t* dst = p + 8;
    for (size_t left = len; left > 0;) {
      const Piece& cur = pieces[piece];
      const size_t n = std::min(cur.len - piece_off, left);
      std::memcpy(dst, cur.data + piece_off, n);
      crc = n == cur.len ? crc32_combine(crc, cur.crc, (z_off_t)n)
                         : crc_of(crc, dst, n);
      dst += n;
      left -= n;
      piece_off += n;
      if (piece_off == cur.len) {
        ++piece;
        piece_off = 0;
      }
    }
    put_be32(dst, (uint32_t)crc);
    p = dst + 4;
    done += len;
  }
  p = close_chunk(p, "IEND", 0);
  *out_buf = png;
  *out_len = total;
  return 0;
}

}  // namespace

extern "C" {

// img: HWC uint8, c in {1, 3, 4}, rows cut into min(bands, h) bands.
// 0 on success, with the PNG in *out_buf (free with std::free) and its
// length in *out_len; 1 for arguments it does not take, 2 for a zlib
// error, 3 when memory runs out, 9 for any other failure.
int gip_png_encode_bands(const uint8_t* img, int h, int w, int c, int bands,
                         uint8_t** out_buf, size_t* out_len) {
  // C ABI boundary: no exception may unwind into the ctypes caller.
  try {
    return encode_bands(img, h, w, c, bands, out_buf, out_len);
  } catch (const std::bad_alloc&) {
    return 3;
  } catch (...) {
    return 9;
  }
}

}  // extern "C"
