// Host-side hot loops of the data loader, for the CPU of the machine that
// drives the card.  Built by data/native.py with the host C++ compiler into
// one shared library with a plain C interface, bound with ctypes.
//
//   xmc_crc32c         CRC32C (Castagnoli), slicing-by-8: TFRecord frame
//                      checksums (data/records.py).
//   xmc_scan_offsets   the record offsets of a TFRecord file, found by
//                      hopping over the length headers; a truncated last
//                      record is left out (data/records.py).
//   xmc_png_unfilter   undoes PNG's per-row filters (None, Sub, Up, Average,
//                      Paeth) of 8-bit samples (data/png.py).  Sub, Average
//                      and Paeth read the pixel just reconstructed to the
//                      left, so a row is a sequential scan.
//   xmc_resize_bilinear  Pillow's bilinear resampling of 8-bit images, bit
//                      for bit: the same coefficients, the same 22-bit fixed
//                      point, the horizontal pass first over only the rows
//                      the vertical pass reads (data/resize.py).
//
// Every entry point has a plain numpy version in the Python module that
// calls it; the tests hold the two against each other and against Pillow.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct CrcTables {
  uint32_t t[8][256];
  CrcTables() {
    const uint32_t poly = 0x82F63B78u;
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t crc = i;
      for (int j = 0; j < 8; ++j) crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
      t[0][i] = crc;
    }
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t crc = t[0][i];
      for (int k = 1; k < 8; ++k) {
        crc = t[0][crc & 0xFF] ^ (crc >> 8);
        t[k][i] = crc;
      }
    }
  }
};

// Filled when the library is loaded, before any call.
const CrcTables kCrc;

// Pillow's fixed point for 8-bit samples (libImaging/Resample.c).
constexpr int kPrecisionBits = 32 - 8 - 2;

struct Coefficients {
  int ksize;
  std::vector<int> bounds;   // [out][2]: first input sample, sample count
  std::vector<int32_t> k;    // [out][ksize]
};

// Pillow's precompute_coeffs for the bilinear filter (support 1), then
// normalize_coeffs_8bpc.
Coefficients coefficients(int in_size, int out_size) {
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = filterscale;
  Coefficients c;
  c.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  c.bounds.assign(2 * static_cast<size_t>(out_size), 0);
  c.k.assign(static_cast<size_t>(out_size) * c.ksize, 0);
  std::vector<double> w(c.ksize);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    const double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double ww = 0.0;
    for (int x = 0; x < xmax; ++x) {
      double d = (x + xmin - center + 0.5) * ss;
      if (d < 0.0) d = -d;
      w[x] = d < 1.0 ? 1.0 - d : 0.0;
      ww += w[x];
    }
    int32_t* k = &c.k[static_cast<size_t>(xx) * c.ksize];
    for (int x = 0; x < xmax; ++x) {
      const double v = ww != 0.0 ? w[x] / ww : w[x];
      k[x] = static_cast<int32_t>(v < 0 ? -0.5 + v * (1 << kPrecisionBits)
                                        : 0.5 + v * (1 << kPrecisionBits));
    }
    c.bounds[2 * xx] = xmin;
    c.bounds[2 * xx + 1] = xmax;
  }
  return c;
}

inline uint8_t clip8(int32_t v) {
  if (v >= (1 << kPrecisionBits << 8)) return 255;
  if (v <= 0) return 0;
  return static_cast<uint8_t>(v >> kPrecisionBits);
}

inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

}  // namespace

extern "C" {

uint32_t xmc_crc32c(const uint8_t* data, uint64_t len) {
  uint32_t crc = 0xFFFFFFFFu;
  while (len >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, data, 4);
    std::memcpy(&hi, data + 4, 4);
    lo ^= crc;
    crc = kCrc.t[7][lo & 0xFF] ^ kCrc.t[6][(lo >> 8) & 0xFF] ^
          kCrc.t[5][(lo >> 16) & 0xFF] ^ kCrc.t[4][lo >> 24] ^
          kCrc.t[3][hi & 0xFF] ^ kCrc.t[2][(hi >> 8) & 0xFF] ^
          kCrc.t[1][(hi >> 16) & 0xFF] ^ kCrc.t[0][hi >> 24];
    data += 8;
    len -= 8;
  }
  while (len--) crc = kCrc.t[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

// Writes the start offset of every complete record of the TFRecord file at
// `path` into `offsets` (room for `max_records`).  Returns the count, -1 on
// an I/O error, -2 when `offsets` is too small.
int64_t xmc_scan_offsets(const char* path, int64_t* offsets,
                         int64_t max_records) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  if (std::fseek(f, 0, SEEK_END) != 0) {
    std::fclose(f);
    return -1;
  }
  const int64_t size = std::ftell(f);
  int64_t pos = 0, n = 0;
  uint8_t header[8];
  while (pos < size) {
    if (std::fseek(f, pos, SEEK_SET) != 0) {
      std::fclose(f);
      return -1;
    }
    if (std::fread(header, 1, 8, f) != 8) break;
    uint64_t length;
    std::memcpy(&length, header, 8);
    const int64_t end = pos + 8 + 4 + static_cast<int64_t>(length) + 4;
    if (end > size) break;  // truncated last record: not indexed
    if (n >= max_records) {
      std::fclose(f);
      return -2;
    }
    offsets[n++] = pos;
    pos = end;
  }
  std::fclose(f);
  return n;
}

// Undoes the filters of `height` rows of `row_bytes` bytes each, stored in
// `data` (`size` bytes) as PNG does: a filter-type byte, then the row.  The
// pixels are `bpp` bytes.  Writes height * row_bytes bytes to `out`.
// Returns 0, -1 when `size` is not height * (row_bytes + 1), or -2 on an
// unknown filter type.
int xmc_png_unfilter(const uint8_t* data, int64_t size, int height,
                     int row_bytes, int bpp, uint8_t* out) {
  if (size != static_cast<int64_t>(height) * (row_bytes + 1)) return -1;
  for (int y = 0; y < height; ++y) {
    const uint8_t* src = data + static_cast<int64_t>(y) * (row_bytes + 1);
    const int type = *src++;
    uint8_t* row = out + static_cast<int64_t>(y) * row_bytes;
    const uint8_t* up = y > 0 ? row - row_bytes : nullptr;
    switch (type) {
      case 0:
        std::memcpy(row, src, row_bytes);
        break;
      case 1:
        for (int x = 0; x < row_bytes; ++x)
          row[x] = static_cast<uint8_t>(src[x] + (x >= bpp ? row[x - bpp] : 0));
        break;
      case 2:
        for (int x = 0; x < row_bytes; ++x)
          row[x] = static_cast<uint8_t>(src[x] + (up ? up[x] : 0));
        break;
      case 3:
        for (int x = 0; x < row_bytes; ++x) {
          const int a = x >= bpp ? row[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          row[x] = static_cast<uint8_t>(src[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int x = 0; x < row_bytes; ++x) {
          const int a = x >= bpp ? row[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          const int c = (up && x >= bpp) ? up[x - bpp] : 0;
          row[x] = static_cast<uint8_t>(src[x] + paeth(a, b, c));
        }
        break;
      default:
        return -2;
    }
  }
  return 0;
}

// Resizes the [in_h, in_w, channels] uint8 image `in` to [out_h, out_w,
// channels] in `out` as Pillow's Image.resize(..., Image.BILINEAR) does.
// Returns 0, or -1 on a size that is not positive.
int xmc_resize_bilinear(const uint8_t* in, int in_h, int in_w, int channels,
                        uint8_t* out, int out_h, int out_w) {
  if (in_h <= 0 || in_w <= 0 || out_h <= 0 || out_w <= 0 || channels <= 0)
    return -1;
  const bool horizontal = out_w != in_w;
  const bool vertical = out_h != in_h;
  const int64_t row_in = static_cast<int64_t>(in_w) * channels;
  const int64_t row_out = static_cast<int64_t>(out_w) * channels;
  if (!horizontal && !vertical) {
    std::memcpy(out, in, static_cast<size_t>(in_h) * row_in);
    return 0;
  }
  Coefficients cv = coefficients(in_h, out_h);
  // The rows the vertical pass reads.
  const int first = cv.bounds[0];
  const int last = cv.bounds[2 * out_h - 2] + cv.bounds[2 * out_h - 1];
  std::vector<uint8_t> tmp;
  const uint8_t* src = in;
  int64_t src_row = row_in;
  if (horizontal) {
    Coefficients ch = coefficients(in_w, out_w);
    const int rows = vertical ? last - first : in_h;
    const int offset = vertical ? first : 0;
    uint8_t* dst = out;
    if (vertical) {
      tmp.resize(static_cast<size_t>(rows) * row_out);
      dst = tmp.data();
      for (int i = 0; i < out_h; ++i) cv.bounds[2 * i] -= first;
    }
    for (int y = 0; y < rows; ++y) {
      const uint8_t* line = in + static_cast<int64_t>(y + offset) * row_in;
      uint8_t* o = dst + static_cast<int64_t>(y) * row_out;
      for (int xx = 0; xx < out_w; ++xx) {
        const int xmin = ch.bounds[2 * xx], xmax = ch.bounds[2 * xx + 1];
        const int32_t* k = &ch.k[static_cast<size_t>(xx) * ch.ksize];
        for (int c = 0; c < channels; ++c) {
          int32_t ss = 1 << (kPrecisionBits - 1);
          for (int x = 0; x < xmax; ++x)
            ss += line[static_cast<int64_t>(x + xmin) * channels + c] * k[x];
          o[static_cast<int64_t>(xx) * channels + c] = clip8(ss);
        }
      }
    }
    if (!vertical) return 0;
    src = tmp.data();
    src_row = row_out;
  }
  for (int yy = 0; yy < out_h; ++yy) {
    const int ymin = cv.bounds[2 * yy], ymax = cv.bounds[2 * yy + 1];
    const int32_t* k = &cv.k[static_cast<size_t>(yy) * cv.ksize];
    uint8_t* o = out + static_cast<int64_t>(yy) * row_out;
    for (int64_t x = 0; x < row_out; ++x) {
      int32_t ss = 1 << (kPrecisionBits - 1);
      for (int y = 0; y < ymax; ++y) ss += src[(y + ymin) * src_row + x] * k[y];
      o[x] = clip8(ss);
    }
  }
  return 0;
}

}  // extern "C"
