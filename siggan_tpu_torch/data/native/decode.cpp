// Host image decoders of the port: JPEG, BMP and TIFF to 8-bit grey, as
// PIL's Image.open(path).convert("L") gives them, with no imaging library.
//
// JPEG: 8-bit DCT, Huffman-coded, sequential (SOF0/SOF1) or progressive
// (SOF2), or arithmetic-coded (SOF9/SOF10: jdarith.c's QM decoder and
// statistics, with a DAC segment's conditioning), or lossless (SOF3:
// predictors 1-7, a point transform, jddiffct.c's rows and restarts), one,
// three or four components (CMYK, or YCCK after Adobe's transform), any
// whole-number sampling, restart intervals, the default Huffman tables when
// a file carries none. The arithmetic is libjpeg's
// (libjpeg-turbo, which PIL links): its SIMD "islow" integer IDCT, 16-bit
// lanes and all, "fancy" chroma upsampling (jdsample.c: h2v1, h1v2, h2v2
// with the neighbouring rows of the next and previous iMCU rows, box
// replication for other factors and in a lossless frame), the YCbCr->RGB
// tables of jdcolor.c (no conversion of a lossless frame: RGB) and
// libjpeg's colour-space defaults (JFIF, then Adobe's transform, then the
// component ids). Then PIL's L = (19595 R + 38470 G + 7471 B + 2^15) >> 16,
// by way of PIL's CMYK -> RGB for four components (which PIL reads as
// Adobe's inverted CMYK). A progressive file's scans refine one coefficient
// buffer per component as jdphuff.c does; the IDCT runs once, after EOI,
// through libjpeg-turbo 3's block smoothing where a scan script leaves some
// of the first ten coefficients unrefined (jdcoefct.c). Damaged data reads
// as libjpeg reads it: a bad Huffman code gives a zero symbol, a restart
// marker out of place is resynchronised (jpeg_resync_to_restart), and once
// a segment's data runs out its MCUs are left alone (zero in a sequential
// scan). A file PIL reads in 64 KB blocks: whether data that ends without
// EOI is read follows libjpeg-turbo's bit-buffer fills (Bits) against those
// blocks (Jpeg::avail), and an arithmetic-coded scan past the first block
// is refused, as under PIL.
//
// BMP: as PIL's BmpImagePlugin reads it (1/4/8-bit palettes, 16-bit 555 and
// 565, 24-bit, 32-bit, BI_BITFIELDS, RLE4/RLE8 with PIL's own RLE rules,
// bottom-up and top-down rows).
//
// TIFF: the first page, classic or BigTIFF, strips or tiles, chunky or
// planar, either byte order, either FillOrder, no compression, PackBits,
// LZW or Deflate (compression 8 and 32946, the port's own inflate;
// predictor 1, 2, or 3 on floats, with either); WhiteIsZero/BlackIsZero at
// 1, 2, 4, 8 bits (PIL inverts WhiteIsZero) and 16 bits (PIL clamps at
// 255), grey numbers (12 bits, signed 16 and 32, unsigned 32, float 32) as
// PIL's modes convert them, RGB/RGBA and CMYK at 8 and 16 bits (PIL keeps
// the high byte), RGB with associated alpha (PIL's RGBa, un-premultiplied),
// grey+alpha, palettes (with an extra sample too: PA, PX), YCbCr; bilevel
// strips coded CCITT Modified Huffman, T.4 (1-D and 2-D, with or without EOL
// fill bits) or T.6 (Group 4), damaged code as libtiff's fax decoder reads
// it; LZMA (.xz) and ZSTD strips and tiles, through this file's own xz and
// Zstandard decoders. A compressed file is read as libtiff reads it
// for PIL (its directory rules, its codecs, YCbCr through its RGBA reader),
// an uncompressed one as PIL's own raw decoder reads it (its raw modes, its
// tiles over the offsets); see decode_tiff. And JPEG-in-TIFF
// (compression 7) in grey, RGB, CMYK or chunky YCbCr, each strip or tile a
// JPEG stream read with the JPEGTables tag's tables, as libtiff reads it for
// PIL (YCbCr through libjpeg's own upsampling and colour conversion); and
// old-style JPEG-in-TIFF (compression 6), one JPEG stream built from the
// file's pieces as libtiff's tif_ojpeg.c builds it (YCbCr through libtiff's
// RGBA reader: each block's chroma as it is, libtiff's colour tables).
//
// PNG: the Python side (infer/export.py::decode_png) parses the chunks and
// inflates the image data with zlib; sig_png_unfilter undoes the five row
// filters (None, Sub, Up, Average, Paeth) for any bytes per pixel.
//
// Resize: sig_resize_bilinear is Pillow's 8-bit L-mode bilinear resample
// (libImaging/Resample.c), bit for bit: per output pixel the triangle
// filter's taps over center +- support (support widened by the scale on a
// downscale), normalised by their sequential sum in double and rounded to
// 22 fraction bits; a horizontal pass, then a vertical pass over its
// output, each rounded and clamped to 0..255; a pass whose side keeps its
// size is skipped. data/resample.py holds the same arithmetic in numpy.
//
// Every entry returns a status: 0 ok, 1 corrupt (truncated or malformed
// data, or a kind PIL itself refuses), 2 unsupported (a file PIL reads, of a
// kind not read here yet), 3 the file could not be read, 4 a PNG file
// (decoded by the Python side).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <new>
#include <stdexcept>
#include <string>
#include <thread>
#include <type_traits>
#include <vector>

namespace {

enum Status { kOk = 0, kCorrupt = 1, kUnsupported = 2, kUnreadable = 3, kPng = 4 };

struct DecodeError {
  int status;
  std::string msg;
};

[[noreturn]] void corrupt(const std::string& m) { throw DecodeError{kCorrupt, m}; }
[[noreturn]] void unsupported(const std::string& m) { throw DecodeError{kUnsupported, m}; }

struct Gray {
  int w = 0, h = 0;
  std::vector<uint8_t> px;
};

inline uint8_t luma(int r, int g, int b) {
  return (uint8_t)((19595 * r + 38470 * g + 7471 * b + 0x8000) >> 16);
}

// PIL's Image.open refuses more than 2 * Image.MAX_IMAGE_PIXELS pixels
// (DecompressionBombError); any side length up to that is read.
constexpr int64_t kMaxPixels = 2 * (1024LL * 1024 * 1024 / 4 / 3);

inline void check_size(int64_t w, int64_t h) {
  if (w <= 0 || h <= 0) corrupt("image has no pixels");
  if (w * h > kMaxPixels)
    corrupt("image of " + std::to_string(w * h) + " pixels (PIL's decompression-bomb limit is " +
            std::to_string(kMaxPixels) + ")");
}

// ------------------------------------------------------------------ JPEG

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};  // overrun guard

struct Huff {
  bool defined = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int maxcode[18];
  int valoffset[18];
  uint16_t look[512];  // 9-bit lookahead: (length << 8) | symbol, 0 = longer code

  void build(bool dc) {
    int count = 0;
    for (int l = 1; l <= 16; ++l) count += bits[l];
    if (count > 256) corrupt("bad Huffman table");
    if (dc)  // libjpeg-turbo 3 allows 16, the lossless difference category
      for (int i = 0; i < count; ++i)
        if (vals[i] > 16) corrupt("bad Huffman table");
    int code = 0, k = 0;
    std::fill(look, look + 512, 0);
    for (int l = 1; l <= 16; ++l) {
      valoffset[l] = k - code;
      for (int i = 0; i < bits[l]; ++i, ++k, ++code) {
        if (l <= 9) {
          int shift = 9 - l;
          for (int j = 0; j < (1 << shift); ++j)
            look[(code << shift) | j] = (uint16_t)((l << 8) | vals[k]);
        }
      }
      maxcode[l] = bits[l] ? code - 1 : -1;
      if (code > (1 << l)) corrupt("bad Huffman table");
      code <<= 1;
    }
    maxcode[17] = 0x7FFFFFFF;
    defined = true;
  }
};

// The default tables of the JPEG standard (K.3), which libjpeg installs for
// a slot a scan uses when the file defined none (motion-JPEG frames).
const uint8_t kDcBits[2][17] = {{0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
                                {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcBits[2][17] = {{0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
                                {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
const uint8_t kAcVals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
     0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
     0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
     0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
     0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
     0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
     0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
     0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
     0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
     0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
     0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
     0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
     0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
     0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
     0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
     0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
     0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
     0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
     0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
     0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
     0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

void std_table(Huff& t, bool dc, int id) {
  memcpy(t.bits, dc ? kDcBits[id] : kAcBits[id], 17);
  memcpy(t.vals, dc ? kDcVals : kAcVals[id], dc ? 12 : 162);
  t.build(dc);
}

// PIL reads a file to its decoder in blocks of ImageFile.MAXBLOCK bytes
// (64 KB); libjpeg under PIL's source sees the file up to the end of the
// last block read, and suspends where it needs a byte past it, which makes
// PIL read the next block, or refuse the file ("image file is truncated")
// once there is none. (libtiff hands libjpeg a whole strip or tile.)
constexpr size_t kPilBlock = 65536;

struct Suspend {};  // a Huffman decode that suspends mid-file (see Jpeg::huffman_mcu)
struct OldTiffStop {};  // see Jpeg::old_tiff

// Entropy-coded data, MSB first, with FF00 unstuffing. At a marker it
// supplies zero bits (as libjpeg does); running off the end of the file is
// a truncated file. `pad` counts the zero bits supplied (the last `pad` of
// `cnt`); a read that takes some of them is libjpeg's insufficient_data,
// after which its decoders leave the rest of the restart interval alone
// (`starved`). A progressive scan's reader (kStarve) checks that at every
// read; a sequential scan's reader leaves it to the caller once an MCU
// (`took_padding`), so that its per-symbol work stays as small as it was.
//
// It fills where libjpeg-turbo's jdhuff.c fills, since under PIL that
// decides whether a file whose data ends without EOI is read: the slow
// path (kFast false) fills to 57 bits only when a code needs more than it
// holds (below 8 bits for its 8-bit lookahead, below 9 for a longer code,
// and so on one bit at a time; below s for s extra bits); the fast path
// (decode_mcu_fast, kFast true) reads 6 bytes whenever 16 bits or fewer are
// left, before each code and each run of extra bits, and at a marker
// (`hit`) has its MCU decoded again by the slow path. Bytes past `end`
// (PIL's buffer) are out of reach: a fill there suspends (Suspend) while
// the file goes on, else the file is truncated.
template <bool kStarve>
struct Bits {
  const uint8_t* d;
  size_t n, pos;
  size_t end;  // the end of what libjpeg's source holds
  uint64_t acc = 0;
  int cnt = 0;
  int pad = 0;  // the zero bits supplied at a marker, the last `pad` of `cnt`
  bool at_marker = false;
  bool starved = false;
  bool hit = false;  // the fast path met a marker
  bool open_end = false;  // see Jpeg::open_end

  [[noreturn, gnu::noinline]] void ran_out() const {
    if (open_end) throw OldTiffStop{};
    if (end < n) throw Suspend{};
    corrupt("JPEG data ends early");
  }
  void fill() {  // jpeg_fill_bit_buffer: to 57 bits, or zeros from a marker on
    while (cnt <= 56) {
      int byte = 0;
      if (!at_marker) {
        if (pos >= end) ran_out();
        byte = d[pos];
        if (byte == 0xFF) {
          size_t q = pos + 1;
          while (q < end && d[q] == 0xFF) ++q;
          if (q >= end) ran_out();
          if (d[q] == 0) {
            pos = q + 1;
          } else {
            pos = q - 1;  // the marker's last FF
            at_marker = true;
            byte = 0;
          }
        } else {
          ++pos;
        }
      }
      if (at_marker) pad += 8;
      acc |= (uint64_t)byte << (56 - cnt);
      cnt += 8;
    }
  }
  // FILL_BIT_BUFFER_FAST's six GET_BYTEs; the caller has 512 bytes a block
  // of the MCU before `end`.
  void fill6() {
    for (int i = 0; i < 6; ++i) {
      int c0 = d[pos++];
      if (c0 == 0xFF) {
        if (d[pos++] != 0) {  // a marker: back out, a zero byte
          pos -= 2;
          c0 = 0;
          hit = true;
        }
      }
      acc |= (uint64_t)c0 << (56 - cnt);
      cnt += 8;
    }
  }
  inline void take(int k) {
    acc <<= k;
    cnt -= k;
    if constexpr (kStarve) {
      if (cnt < pad) {
        starved = true;
        pad = cnt;
      }
    }
  }
  template <bool kFast = false>
  inline int get(int k) {  // 1 <= k <= 16
    if constexpr (kFast) {
      if (cnt <= 16) fill6();
    } else if (cnt < k) {
      fill();
    }
    int v = (int)(acc >> (64 - k));
    take(k);
    return v;
  }
  template <bool kFast = false>
  inline int decode(const Huff& h) {
    if constexpr (kFast) {
      if (cnt <= 16) fill6();
    } else if (cnt < 8) {
      fill();
    }
    uint16_t e = h.look[acc >> 55];
    if (e && (kFast || (e >> 8) <= cnt)) {
      take(e >> 8);
      return e & 0xFF;
    }
    return decode_long<kFast>(h);
  }
  // A code of 9 bits or more, or one the slow path holds too few bits for:
  // jpeg_huff_decode, 9 bits, then a bit at a time, the slow path filling
  // when none is left (so after taking the code's first bits).
  template <bool kFast>
  int decode_long(const Huff& h) {
    if (!kFast && cnt < 9) fill();
    if (uint16_t e = h.look[acc >> 55]) {
      take(e >> 8);
      return e & 0xFF;
    }
    int code = (int)(acc >> 55), l = 9;
    take(9);
    while (code > h.maxcode[l]) {  // maxcode[17] stops a bad code at 17 bits
      if (!kFast && cnt < 1) fill();
      code = (code << 1) | (int)(acc >> 63);
      take(1);
      ++l;
    }
    // No code of 16 bits or fewer: libjpeg (jdhuff.c, JWRN_HUFF_BAD_CODE)
    // takes 17 bits and fakes a zero symbol.
    return l > 16 ? 0 : h.vals[(h.valoffset[l] + code) & 0xFF];
  }
  bool took_padding() const { return cnt < pad; }
  void reset() {
    acc = 0;
    cnt = 0;
    pad = 0;
    at_marker = false;
    starved = false;
  }
};
using BitReader = Bits<false>;        // sequential scans
using ProgressiveReader = Bits<true>;  // progressive scans

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// ITU T.81 Table D.2, the QM coder's probability states, packed as
// libjpeg's jaricom.c packs them: Qe << 16 | Next_Index_MPS << 8 |
// Switch_MPS << 7 | Next_Index_LPS; state 113 is libjpeg's fixed 0.5.
#define QM(qe, mps, lps, sw) (((uint32_t)(qe) << 16) | ((mps) << 8) | ((sw) << 7) | (lps))
const uint32_t kQmStates[114] = {
    QM(0x5a1d, 1, 1, 1),     QM(0x2586, 2, 14, 0),    QM(0x1114, 3, 16, 0),
    QM(0x080b, 4, 18, 0),    QM(0x03d8, 5, 20, 0),    QM(0x01da, 6, 23, 0),
    QM(0x00e5, 7, 25, 0),    QM(0x006f, 8, 28, 0),    QM(0x0036, 9, 30, 0),
    QM(0x001a, 10, 33, 0),   QM(0x000d, 11, 35, 0),   QM(0x0006, 12, 9, 0),
    QM(0x0003, 13, 10, 0),   QM(0x0001, 13, 12, 0),   QM(0x5a7f, 15, 15, 1),
    QM(0x3f25, 16, 36, 0),   QM(0x2cf2, 17, 38, 0),   QM(0x207c, 18, 39, 0),
    QM(0x17b9, 19, 40, 0),   QM(0x1182, 20, 42, 0),   QM(0x0cef, 21, 43, 0),
    QM(0x09a1, 22, 45, 0),   QM(0x072f, 23, 46, 0),   QM(0x055c, 24, 48, 0),
    QM(0x0406, 25, 49, 0),   QM(0x0303, 26, 51, 0),   QM(0x0240, 27, 52, 0),
    QM(0x01b1, 28, 54, 0),   QM(0x0144, 29, 56, 0),   QM(0x00f5, 30, 57, 0),
    QM(0x00b7, 31, 59, 0),   QM(0x008a, 32, 60, 0),   QM(0x0068, 33, 62, 0),
    QM(0x004e, 34, 63, 0),   QM(0x003b, 35, 32, 0),   QM(0x002c, 9, 33, 0),
    QM(0x5ae1, 37, 37, 1),   QM(0x484c, 38, 64, 0),   QM(0x3a0d, 39, 65, 0),
    QM(0x2ef1, 40, 67, 0),   QM(0x261f, 41, 68, 0),   QM(0x1f33, 42, 69, 0),
    QM(0x19a8, 43, 70, 0),   QM(0x1518, 44, 72, 0),   QM(0x1177, 45, 73, 0),
    QM(0x0e74, 46, 74, 0),   QM(0x0bfb, 47, 75, 0),   QM(0x09f8, 48, 77, 0),
    QM(0x0861, 49, 78, 0),   QM(0x0706, 50, 79, 0),   QM(0x05cd, 51, 48, 0),
    QM(0x04de, 52, 50, 0),   QM(0x040f, 53, 50, 0),   QM(0x0363, 54, 51, 0),
    QM(0x02d4, 55, 52, 0),   QM(0x025c, 56, 53, 0),   QM(0x01f8, 57, 54, 0),
    QM(0x01a4, 58, 55, 0),   QM(0x0160, 59, 56, 0),   QM(0x0125, 60, 57, 0),
    QM(0x00f6, 61, 58, 0),   QM(0x00cb, 62, 59, 0),   QM(0x00ab, 63, 61, 0),
    QM(0x008f, 32, 61, 0),   QM(0x5b12, 65, 65, 1),   QM(0x4d04, 66, 80, 0),
    QM(0x412c, 67, 81, 0),   QM(0x37d8, 68, 82, 0),   QM(0x2fe8, 69, 83, 0),
    QM(0x293c, 70, 84, 0),   QM(0x2379, 71, 86, 0),   QM(0x1edf, 72, 87, 0),
    QM(0x1aa9, 73, 87, 0),   QM(0x174e, 74, 72, 0),   QM(0x1424, 75, 72, 0),
    QM(0x119c, 76, 74, 0),   QM(0x0f6b, 77, 74, 0),   QM(0x0d51, 78, 75, 0),
    QM(0x0bb6, 79, 77, 0),   QM(0x0a40, 48, 77, 0),   QM(0x5832, 81, 80, 1),
    QM(0x4d1c, 82, 88, 0),   QM(0x438e, 83, 89, 0),   QM(0x3bdd, 84, 90, 0),
    QM(0x34ee, 85, 91, 0),   QM(0x2eae, 86, 92, 0),   QM(0x299a, 87, 93, 0),
    QM(0x2516, 71, 86, 0),   QM(0x5570, 89, 88, 1),   QM(0x4ca9, 90, 95, 0),
    QM(0x44d9, 91, 96, 0),   QM(0x3e22, 92, 97, 0),   QM(0x3824, 93, 99, 0),
    QM(0x32b4, 94, 99, 0),   QM(0x2e17, 86, 93, 0),   QM(0x56a8, 96, 95, 1),
    QM(0x4f46, 97, 101, 0),  QM(0x47e5, 98, 102, 0),  QM(0x41cf, 99, 103, 0),
    QM(0x3c3d, 100, 104, 0), QM(0x375e, 93, 99, 0),   QM(0x5231, 102, 105, 0),
    QM(0x4c0f, 103, 106, 0), QM(0x4639, 104, 107, 0), QM(0x415e, 99, 103, 0),
    QM(0x5627, 106, 105, 1), QM(0x50e7, 107, 108, 0), QM(0x4b85, 103, 109, 0),
    QM(0x5597, 109, 110, 0), QM(0x504f, 107, 111, 0), QM(0x5a10, 111, 110, 1),
    QM(0x5522, 109, 112, 0), QM(0x59eb, 111, 112, 1), QM(0x5a1d, 113, 113, 0)};
#undef QM

// Arithmetic-coded data (jdarith.c's arith_decode and its byte input):
// FF 00 is an FF byte; at a marker the decoder takes zero bytes, and pos
// stays at the marker's last FF (where the Huffman reader leaves it).
// Running off the end of the file is a truncated file, and so is reading
// past `end`, the end of PIL's buffer: libjpeg's arithmetic decoder cannot
// suspend (JERR_CANT_SUSPEND), so PIL refuses a file whose arithmetic-coded
// data runs past the 64 KB block it was handed. Its interface is
// each_block's: it never runs out of data (libjpeg's arithmetic decoder
// never sets insufficient_data).
struct ArithReader {
  const uint8_t* d;
  size_t n, pos, end;
  int64_t c = 0, a = 0;
  int ct = -16;  // -16: two bytes to read into c; -1: an error left the interval's MCUs alone
  bool at_marker = false;
  bool starved = false;  // never set

  [[noreturn, gnu::noinline]] void ran_out() const {
    corrupt(end < n ? "arithmetic-coded JPEG data past PIL's 64 KB read block (libjpeg's "
                      "arithmetic decoder cannot suspend)"
                    : "JPEG data ends early");
  }
  int byte() {
    if (at_marker) return 0;
    if (pos >= end) ran_out();
    int v = d[pos];
    if (v != 0xFF) {
      ++pos;
      return v;
    }
    size_t q = pos + 1;
    while (q < end && d[q] == 0xFF) ++q;
    if (q >= end) ran_out();
    if (d[q] == 0) {
      pos = q + 1;
      return 0xFF;
    }
    pos = q - 1;
    at_marker = true;
    return 0;
  }
  int decode(uint8_t* st) {
    while (a < 0x8000) {  // renormalization and input (D.2.6)
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;  // the two first bytes are in
      }
      a <<= 1;
    }
    int sv = *st;
    const uint32_t e = kQmStates[sv & 0x7F];
    const int64_t qe = e >> 16;
    const int nl = e & 0xFF, nm = (e >> 8) & 0xFF;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // conditional LPS exchange
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {  // conditional MPS exchange
      if (a < qe) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
  bool took_padding() const { return false; }
  void reset() {  // at a restart
    c = a = 0;
    ct = -16;
    at_marker = false;
  }
};

// One arithmetic-coded scan's statistics (jdarith.c): 64 DC and 256 AC
// bins a table, each component's DC prediction and context, the fixed bin.
constexpr int kMaxComponents = 10;  // libjpeg's MAX_COMPONENTS

struct ArithStats {
  uint8_t dc[16][64], ac[16][256];
  int last_dc[kMaxComponents], dc_context[kMaxComponents];
  uint8_t fixed = 113;
};

// libjpeg-turbo's SIMD "islow" IDCT (jsimd_idct_islow, the arithmetic of
// jidctint.c in 16-bit lanes), which PIL runs on x86-64: 8x8 coefficients
// and their quantizers -> samples. Valid data never leaves 16 bits, and
// then this is jidctint.c; damaged data does, and then the lanes decide: a
// dequantized coefficient and the sums in0 + in4, in0 - in4, in7 + in3 and
// in5 + in1 wrap to 16 bits; pass 1's outputs saturate to 16 bits (and its
// shortcut for a block whose rows 1-7 are all zero shifts the DC in 16
// bits); pass 2's saturate to 16 and then 8 bits around the centre 128.
// Each pass runs on 8 lanes at once: pass 1's lanes are the columns, pass
// 2's the rows.
const int kConstBits = 13, kPass1Bits = 2;
const int32_t F0_298631336 = 2446, F0_390180644 = 3196, F0_541196100 = 4433,
              F0_765366865 = 6270, F0_899976223 = 7373, F1_175875602 = 9633,
              F1_501321110 = 12299, F1_847759065 = 15137, F1_961570560 = 16069,
              F2_053119869 = 16819, F2_562915447 = 20995, F3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

typedef int16_t I16x8 __attribute__((vector_size(16)));
typedef uint16_t U16x8 __attribute__((vector_size(16)));
typedef int32_t I32x8 __attribute__((vector_size(32)));
typedef uint8_t U8x8 __attribute__((vector_size(8)));

inline I32x8 wide(I16x8 v) { return __builtin_convertvector(v, I32x8); }
inline I16x8 add16(I16x8 a, I16x8 b) { return (I16x8)((U16x8)a + (U16x8)b); }
inline I16x8 sub16(I16x8 a, I16x8 b) { return (I16x8)((U16x8)a - (U16x8)b); }
inline I32x8 clamp(I32x8 v, int32_t lo, int32_t hi) {
  const I32x8 l = I32x8{} + lo, h = I32x8{} + hi;
  v = v < l ? l : v;
  return v > h ? h : v;
}
inline I32x8 descale(I32x8 x, int n) { return (x + (1 << (n - 1))) >> n; }

// One 1-D pass over 8 lanes of 8 values `in` -> 8 unrounded outputs, scaled
// by 2^13, in the order 0..7.
inline void idct_1d(const I16x8* in, I32x8* o) {
  const I32x8 z2 = wide(in[2]), z3 = wide(in[6]);
  const I32x8 tmp2 = z2 * F0_541196100 + z3 * (F0_541196100 - F1_847759065);
  const I32x8 tmp3 = z2 * (F0_541196100 + F0_765366865) + z3 * F0_541196100;
  const I32x8 tmp0 = wide(add16(in[0], in[4])) * (1 << kConstBits);
  const I32x8 tmp1 = wide(sub16(in[0], in[4])) * (1 << kConstBits);
  const I32x8 tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  const I32x8 t0 = wide(in[7]), t1 = wide(in[5]), t2 = wide(in[3]), t3 = wide(in[1]);
  const I32x8 z3o = wide(add16(in[7], in[3])), z4o = wide(add16(in[5], in[1]));
  const I32x8 zz3 = z3o * (F1_175875602 - F1_961570560) + z4o * F1_175875602;
  const I32x8 zz4 = z3o * F1_175875602 + z4o * (F1_175875602 - F0_390180644);
  const I32x8 o0 = t0 * (F0_298631336 - F0_899976223) + t3 * -F0_899976223 + zz3;
  const I32x8 o3 = t0 * -F0_899976223 + t3 * (F1_501321110 - F0_899976223) + zz4;
  const I32x8 o1 = t1 * (F2_053119869 - F2_562915447) + t2 * -F2_562915447 + zz4;
  const I32x8 o2 = t1 * -F2_562915447 + t2 * (F3_072711026 - F2_562915447) + zz3;
  o[0] = tmp10 + o3;
  o[7] = tmp10 - o3;
  o[1] = tmp11 + o2;
  o[6] = tmp11 - o2;
  o[2] = tmp12 + o1;
  o[5] = tmp12 - o1;
  o[3] = tmp13 + o0;
  o[4] = tmp13 - o0;
}

inline void transpose(I16x8* m) {
  // Three rounds of interleaving: 16-, 32- then 64-bit pairs of rows.
  typedef int32_t I32x4 __attribute__((vector_size(16)));
  typedef int64_t I64x2 __attribute__((vector_size(16)));
  const I16x8 lo16 = {0, 8, 1, 9, 2, 10, 3, 11}, hi16 = {4, 12, 5, 13, 6, 14, 7, 15};
  const I32x4 lo32 = {0, 4, 1, 5}, hi32 = {2, 6, 3, 7};
  const I64x2 lo64 = {0, 2}, hi64 = {1, 3};
  I16x8 a[8];
  for (int i = 0; i < 4; ++i) {
    a[2 * i] = __builtin_shuffle(m[2 * i], m[2 * i + 1], lo16);
    a[2 * i + 1] = __builtin_shuffle(m[2 * i], m[2 * i + 1], hi16);
  }
  I32x4 b[8];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) {
      const I32x4 x = (I32x4)a[4 * i + j], y = (I32x4)a[4 * i + j + 2];
      b[4 * i + 2 * j] = __builtin_shuffle(x, y, lo32);
      b[4 * i + 2 * j + 1] = __builtin_shuffle(x, y, hi32);
    }
  for (int j = 0; j < 4; ++j) {
    const I64x2 x = (I64x2)b[j], y = (I64x2)b[j + 4];
    m[2 * j] = (I16x8)__builtin_shuffle(x, y, lo64);
    m[2 * j + 1] = (I16x8)__builtin_shuffle(x, y, hi64);
  }
}

void idct_islow(const int16_t* coef, const int16_t* q, uint8_t* out, int stride) {
  I16x8 in[8];
  U16x8 ac = {};
  for (int r = 0; r < 8; ++r) {
    U16x8 c, k;
    memcpy(&c, coef + r * 8, sizeof c);
    memcpy(&k, q + r * 8, sizeof k);
    in[r] = (I16x8)(c * k);  // wraps
    if (r) ac |= c;
  }
  uint64_t any[2];
  memcpy(any, &ac, sizeof any);
  I16x8 ws[8];
  if (!(any[0] | any[1])) {  // rows 1-7 all zero: the DC shifted in 16 bits
    if (!(coef[1] | coef[2] | coef[3] | coef[4] | coef[5] | coef[6] | coef[7])) {
      // and row 0 too: every sample is the DC's
      const int32_t v = descale((int16_t)((uint16_t)in[0][0] << kPass1Bits), kPass1Bits + 3);
      const uint8_t x = (uint8_t)(std::min(std::max(v, -128), 127) + 128);
      for (int r = 0; r < 8; ++r) memset(out + r * stride, x, 8);
      return;
    }
    const I16x8 dc = (I16x8)((U16x8)in[0] << kPass1Bits);
    for (int r = 0; r < 8; ++r) ws[r] = dc;
  } else {
    I32x8 o[8];
    idct_1d(in, o);
    for (int r = 0; r < 8; ++r)
      ws[r] = __builtin_convertvector(clamp(descale(o[r], kConstBits - kPass1Bits), -32768, 32767),
                                      I16x8);
  }
  transpose(ws);
  I32x8 o[8];
  idct_1d(ws, o);
  for (int c = 0; c < 8; ++c)
    ws[c] = __builtin_convertvector(
        clamp(descale(o[c], kConstBits + kPass1Bits + 3), -128, 127) + 128, I16x8);
  transpose(ws);
  for (int r = 0; r < 8; ++r) {
    const U8x8 row = __builtin_convertvector(ws[r], U8x8);
    memcpy(out + r * stride, &row, sizeof row);
  }
}

// jidctint.c's islow IDCT as libjpeg-turbo builds it for 12-bit samples
// (no SIMD there; PASS1_BITS 1, 64-bit products, a 32-bit workspace): 8x8
// coefficients and their quantizers (unsigned 16-bit) -> samples 0 .. 4095
// through the range limit table, whose index is the descaled value masked
// to 14 bits: -2048 .. 2047 map to 0 .. 4095, 2048 .. 8191 to 4095, the
// rest of the table to 0 (then 0 .. 2047 again below -2048, as 8-bit).
void idct_islow12(const int16_t* coef, const int16_t* q, uint16_t* out, int stride) {
  const int kPass1 = 1;
  int32_t ws[64];
  auto deq = [&](int i) { return (int64_t)coef[i] * (uint16_t)q[i]; };
  auto round = [](int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; };
  // One 1-D pass: in(k) the k-th input, put(k, v) the k-th unrounded output.
  auto pass = [](auto in, auto put) {
    int64_t z2 = in(2), z3 = in(6);
    int64_t z1 = (z2 + z3) * F0_541196100;
    const int64_t tmp2 = z1 + z3 * -F1_847759065, tmp3 = z1 + z2 * F0_765366865;
    z2 = in(0);
    z3 = in(4);
    const int64_t t0 = (z2 + z3) * (1 << kConstBits), t1 = (z2 - z3) * (1 << kConstBits);
    const int64_t tmp10 = t0 + tmp3, tmp13 = t0 - tmp3, tmp11 = t1 + tmp2, tmp12 = t1 - tmp2;
    int64_t o0 = in(7), o1 = in(5), o2 = in(3), o3 = in(1);
    z1 = o0 + o3;
    z2 = o1 + o2;
    z3 = o0 + o2;
    int64_t z4 = o1 + o3;
    const int64_t z5 = (z3 + z4) * F1_175875602;
    o0 *= F0_298631336;
    o1 *= F2_053119869;
    o2 *= F3_072711026;
    o3 *= F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 = z3 * -F1_961570560 + z5;
    z4 = z4 * -F0_390180644 + z5;
    o0 += z1 + z3;
    o1 += z2 + z4;
    o2 += z2 + z3;
    o3 += z1 + z4;
    put(0, tmp10 + o3);
    put(7, tmp10 - o3);
    put(1, tmp11 + o2);
    put(6, tmp11 - o2);
    put(2, tmp12 + o1);
    put(5, tmp12 - o1);
    put(3, tmp13 + o0);
    put(4, tmp13 - o0);
  };
  for (int c = 0; c < 8; ++c)
    pass([&](int k) { return deq(8 * k + c); },
         [&](int k, int64_t v) { ws[8 * k + c] = (int32_t)round(v, kConstBits - kPass1); });
  for (int r = 0; r < 8; ++r)
    pass([&](int k) { return (int64_t)ws[8 * r + k]; }, [&](int k, int64_t v) {
      const int i = (int)round(v, kConstBits + kPass1 + 3) & 16383;
      out[(size_t)r * stride + k] = (uint16_t)(i < 2048 ? i + 2048 : i < 8192 ? 4095 : i < 14336 ? 0 : i - 14336);
    });
}

struct JpegEnd {};  // see Jpeg::whole

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;  // the current scan's tables
  int dw = 0, dh = 0;  // downsampled size (libjpeg's downsampled_width/height)
  int pw = 0, ph = 0;  // plane size, whole MCUs
  int16_t q[64] = {0};  // the quantization table, latched at the first scan
  bool latched = false;
  std::vector<uint8_t> plane;
  std::vector<uint16_t> plane12;  // a 12-bit frame's samples, in place of plane
  std::vector<int16_t> coef;  // progressive: 64 a block over the plane's blocks
  int dc_pred = 0;
};

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// jdcolor.c build_ycc_rgb_table (SCALEBITS 16) and ycc_rgb_convert.
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    const int32_t half = 1 << 15;
    auto fix = [](double x) { return (int32_t)(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int32_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + half) >> 16);
      cb_b[i] = (int)((fix(1.77200) * x + half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
  inline void rgb(int y, int cb, int cr, int& r, int& g, int& b) const {
    r = clamp255(y + cr_r[cr]);
    g = clamp255(y + (int)((cb_g[cb] + cr_g[cr]) >> 16));
    b = clamp255(y + cb_b[cb]);
  }
};

const YccTables& ycc_tables() {
  static const YccTables t;
  return t;
}

// PIL's CMYK -> L: Convert.c cmyk2rgb (each of R, G, B = nk - nk * ink / 255
// with nk = 255 - K, MULDIV255's rounding), then L from RGB.
inline uint8_t cmyk_luma(int c, int m, int y, int k) {
  const int nk = 255 - k;
  auto ch = [nk](int ink) {
    const int t = ink * nk + 128;
    return nk - (((t >> 8) + t) >> 8);
  };
  return luma(ch(c), ch(m), ch(y));
}

// One component plane upsampled to the image size (jdsample.c): "fancy"
// for h2v1, h1v2 and h2v2, replication otherwise and always with `box` (a
// lossless frame, whose blocks are one sample).
std::vector<uint8_t> upsample(const Component& c, int fx, int fy, int W, int H, bool box) {
  std::vector<uint8_t> out((size_t)W * H);
  const uint8_t* p = c.plane.data();
  const int pw = c.pw, dw = c.dw, dh = c.dh;
  auto row = [&](int i) { return p + (size_t)std::min(std::max(i, 0), dh - 1) * pw; };
  if (fx == 1 && fy == 1) {
    for (int y = 0; y < H; ++y) memcpy(&out[(size_t)y * W], p + (size_t)y * pw, W);
  } else if (box) {
    for (int y = 0; y < H; ++y) {
      const uint8_t* in = p + (size_t)(y / fy) * pw;
      uint8_t* o = &out[(size_t)y * W];
      for (int x = 0; x < W; ++x) o[x] = in[x / fx];
    }
  } else if (fx == 2 && fy == 1 && dw > 2) {
    for (int y = 0; y < H; ++y) {
      const uint8_t* in = p + (size_t)y * pw;
      uint8_t* o = &out[(size_t)y * W];
      for (int x = 0; x < W; ++x) {
        int c0 = x >> 1, v = 3 * in[c0];
        o[x] = (x & 1) ? (uint8_t)((v + in[std::min(c0 + 1, dw - 1)] + 2) >> 2)
                       : (uint8_t)((v + in[std::max(c0 - 1, 0)] + 1) >> 2);
      }
    }
  } else if (fx == 1 && fy == 2) {
    for (int y = 0; y < H; ++y) {
      int i = y >> 1;
      const uint8_t* near = row(i);
      const uint8_t* far = row((y & 1) ? i + 1 : i - 1);
      int bias = (y & 1) ? 2 : 1;
      uint8_t* o = &out[(size_t)y * W];
      for (int x = 0; x < W; ++x) o[x] = (uint8_t)((3 * near[x] + far[x] + bias) >> 2);
    }
  } else if (fx == 2 && fy == 2 && dw > 2) {
    std::vector<int> cs(dw);
    for (int y = 0; y < H; ++y) {
      int i = y >> 1;
      const uint8_t* near = row(i);
      const uint8_t* far = row((y & 1) ? i + 1 : i - 1);
      for (int x = 0; x < dw; ++x) cs[x] = 3 * near[x] + far[x];
      uint8_t* o = &out[(size_t)y * W];
      for (int x = 0; x < W; ++x) {
        int c0 = x >> 1, v = 3 * cs[c0];
        o[x] = (x & 1) ? (uint8_t)((v + cs[std::min(c0 + 1, dw - 1)] + 7) >> 4)
                       : (uint8_t)((v + cs[std::max(c0 - 1, 0)] + 8) >> 4);
      }
    }
  } else {
    for (int y = 0; y < H; ++y) {
      const uint8_t* in = p + (size_t)(y / fy) * pw;
      uint8_t* o = &out[(size_t)y * W];
      for (int x = 0; x < W; ++x) o[x] = in[x / fx];
    }
  }
  return out;
}

// How a frame's three components become RGB: libjpeg's defaults from the
// markers, YCbCr whatever they say (libtiff's JPEGCOLORMODE_RGB for a
// YCbCr TIFF), or as they are (libtiff's JCS_UNKNOWN for an RGB TIFF).
enum ColorMode { kColorFromMarkers, kColorYcc, kColorAsIs };

struct Jpeg {
  const uint8_t* d;
  size_t n, pos = 2;
  // The end of the data libjpeg's source holds: PIL's blocks read so far
  // for a JPEG file (kPilBlock), all of it for a TIFF's stream. Reading
  // markers past it suspends, and PIL reads the next block; an arithmetic
  // scan cannot suspend (can_suspend false), not even at its restarts.
  size_t avail = 0;
  bool can_suspend = true;
  // Tables outlive a stream: a TIFF's JPEGTables and its strips share them.
  int16_t qt[4][64];
  bool qdef[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  int W = 0, H = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  Component comp[kMaxComponents];
  bool frame = false, progressive = false, lossless = false, arith = false, jfif = false,
       adobe = false;
  // The DAC segment's conditioning per arithmetic table (defaults at SOI):
  // DC bounds L and U, AC threshold K.
  uint8_t dac_l[16], dac_u[16], dac_k[16];
  int adobe_transform = -1, restart = 0, scans = 0;
  // libjpeg's has_multiple_scans: a progressive frame, or one whose first
  // scan leaves a component out; any other frame ends after its first scan.
  bool multi_scan = false;
  // libtiff's old-style JPEG reader (tif_ojpeg.c) hands libjpeg a
  // resync_to_restart that fails: a restart marker out of place stops the
  // decode (OldTiffStop; stop_row is the MCU row it stopped at); and it
  // reads no marker past its one scan.
  bool old_tiff = false;
  int stop_row = 0;
  // libtiff's old-style stream without an EOI (its last strip or tile has
  // no data): libjpeg reading past its end fails, which stops the decode
  // as a restart out of place does.
  bool open_end = false;
  // The sample precision a frame may have: 8, or a TIFF's BitsPerSample
  // (libtiff's JPEG codec reads 8 or 12 bits and refuses the other).
  int allow_precision = 8, precision = 8;
  // libtiff's JPEG codec takes a frame of any count of components libjpeg
  // does (up to 10), PIL's JPEG plugin 1, 3 or 4.
  bool any_components = false;
  // A frame of one scan is whole once that scan is (see tail).
  bool whole = false;
  // libjpeg's coef_bits: per component and zig-zag index, -1 before any
  // scan codes the coefficient, else the Al of the last scan that did.
  int coef_bits[kMaxComponents][64];
  // jdphuff.c's copy of coef_bits 0 .. 9 from before the component's latest
  // scan (0 for the file's first scan), and the iMCU row of the last MCU
  // the latest scan began with data left (libjpeg's last_good_iMCU_row).
  int prev_bits[kMaxComponents][10];
  int last_good = 0, last_good_rows = 1;  // in the latest scan's MCU rows, and those an iMCU row

  // A new stream (SOI at data[0]) with the tables read so far; `pil`: a
  // file PIL hands libjpeg a block at a time.
  void begin(const uint8_t* data, size_t len, bool pil = false) {
    if (len < 2 || data[0] != 0xFF || data[1] != 0xD8) corrupt("not a JPEG stream");
    d = data;
    n = len;
    pos = 2;
    avail = pil ? std::min(len, kPilBlock) : len;
    can_suspend = true;
    W = H = ncomp = mcux = mcuy = 0;
    hmax = vmax = 1;
    for (Component& c : comp) c = Component();
    frame = progressive = lossless = arith = jfif = adobe = whole = false;
    adobe_transform = -1;
    restart = scans = 0;
    std::fill_n(dac_l, 16, 0);
    std::fill_n(dac_u, 16, 1);
    std::fill_n(dac_k, 16, 5);
  }

  int u8() {
    if (pos >= avail) more();
    return d[pos++];
  }
  [[gnu::noinline]] void more() {
    if (pos >= n) {
      if (whole) throw JpegEnd{};
      if (open_end) throw OldTiffStop{};
      corrupt("JPEG file ends early");
    }
    if (!can_suspend)
      corrupt("arithmetic-coded JPEG data past PIL's 64 KB read block (libjpeg's arithmetic "
              "decoder cannot suspend)");
    while (avail <= pos) avail = std::min(n, avail + kPilBlock);
  }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }

  int next_marker() {
    // Skip to the next FF xx (xx neither 00 nor FF), as libjpeg's next_marker.
    for (;;) {
      int c = u8();
      if (c != 0xFF) continue;
      do c = u8();
      while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  // A frame: DCT (progressive or not), or lossless, whose "blocks" are
  // single samples.
  void sof(bool prog, bool lossl = false, bool ari = false) {
    if (frame) corrupt("JPEG has two frames");
    int len = u16();
    size_t end = pos + len - 2;
    if (len < 8 || end > n) corrupt("bad JPEG frame header");
    int p = u8();
    H = u16();
    W = u16();
    ncomp = u8();
    // PIL's JpegImagePlugin takes 8-bit frames of 1, 3 or 4 components;
    // libjpeg refuses an empty frame (a height left to a DNL marker) and a
    // side over JPEG_MAX_DIMENSION.
    if (p != allow_precision)
      corrupt(allow_precision == 8 ? std::to_string(p) + "-bit JPEG (PIL reads 8-bit frames only)"
                                   : "JPEG-in-TIFF stream of another precision than the TIFF's bits");
    precision = p;
    if (H == 0) corrupt("JPEG with a DNL marker (height 0)");
    if (any_components ? ncomp < 1 || ncomp > kMaxComponents : ncomp != 1 && ncomp != 3 && ncomp != 4)
      corrupt(std::to_string(ncomp) + "-component JPEG (PIL reads 1, 3 or 4)");
    if ((size_t)len != 8 + 3 * (size_t)ncomp) corrupt("bad JPEG frame header");
    check_size(W, H);
    if (W > 65500 || H > 65500) corrupt("JPEG larger than libjpeg's 65500 pixels a side");
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) corrupt("bad JPEG sampling");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    if (ncomp > 1)
      for (int i = 0; i < ncomp; ++i)
        if (hmax % comp[i].h || vmax % comp[i].v)
          corrupt("JPEG with fractional chroma sampling, which libjpeg does not upsample");
    const int bs = lossl ? 1 : 8;
    mcux = (W + bs * hmax - 1) / (bs * hmax);
    mcuy = (H + bs * vmax - 1) / (bs * vmax);
    progressive = prog;
    lossless = lossl;
    arith = ari;
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.dw = (int)(((int64_t)W * c.h + hmax - 1) / hmax);
      c.dh = (int)(((int64_t)H * c.v + vmax - 1) / vmax);
      c.pw = mcux * c.h * bs;
      c.ph = mcuy * c.v * bs;
      if (prog)
        c.coef.assign((size_t)c.pw * c.ph, 0);  // 64 a block, pw/8 x ph/8 blocks
      else if (p == 12)
        c.plane12.assign((size_t)c.pw * c.ph, 0);
      else
        c.plane.assign((size_t)c.pw * c.ph, 0);
      std::fill(coef_bits[i], coef_bits[i] + 64, -1);
    }
    frame = true;
    pos = end;
  }

  void dqt() {
    int len = u16();
    size_t end = pos + len - 2;
    if (len < 2 || end > n) corrupt("bad JPEG quantization table");
    while (pos < end) {
      int pq = u8(), t = pq & 15;
      pq >>= 4;
      if (t > 3 || pq > 1) corrupt("bad JPEG quantization table");
      for (int i = 0; i < 64; ++i) qt[t][kNatural[i]] = (int16_t)(pq ? u16() : u8());
      qdef[t] = true;
    }
    if (pos != end) corrupt("bad JPEG quantization table");
  }

  void dht() {
    int len = u16();
    size_t end = pos + len - 2;
    if (len < 2 || end > n) corrupt("bad JPEG Huffman table");
    while (pos < end) {
      int tc = u8(), th = tc & 15;
      tc >>= 4;
      if (tc > 1 || th > 3) corrupt("bad JPEG Huffman table");
      Huff& t = tc ? ac[th] : dc[th];
      t.bits[0] = 0;
      int count = 0;
      for (int l = 1; l <= 16; ++l) count += (t.bits[l] = (uint8_t)u8());
      if (count > 256 || pos + count > end) corrupt("bad JPEG Huffman table");
      for (int i = 0; i < count; ++i) t.vals[i] = (uint8_t)u8();
      t.build(tc == 0);
    }
    if (pos != end) corrupt("bad JPEG Huffman table");
  }

  void app(int m) {
    int len = u16();
    size_t end = pos + len - 2;
    if (len < 2 || end > n) corrupt("bad JPEG marker segment");
    const uint8_t* a = d + pos;
    size_t l = len - 2;
    if (m == 0xE0 && l >= 14 && !memcmp(a, "JFIF\0", 5)) jfif = true;
    if (m == 0xEE && l >= 12 && !memcmp(a, "Adobe", 5)) {
      adobe = true;
      adobe_transform = a[11];
    }
    pos = end;
  }

  // DAC, arithmetic conditioning (jdmarker.c get_dac), which a
  // Huffman-coded frame does not use.
  void dac() {
    int len = u16() - 2;
    if (len < 0 || pos + len > n) corrupt("bad JPEG arithmetic conditioning");
    for (; len >= 2; len -= 2) {
      int index = u8(), val = u8();
      if (index >= 32 || (index < 16 && (val & 15) > (val >> 4)))
        corrupt("bad JPEG arithmetic conditioning");
      if (index >= 16) {
        dac_k[index - 16] = (uint8_t)val;
      } else {
        dac_l[index] = (uint8_t)(val & 15);
        dac_u[index] = (uint8_t)(val >> 4);
      }
    }
    if (len) corrupt("bad JPEG arithmetic conditioning");
  }

  template <bool kFast>
  void block(BitReader& br, Component& c, int brow, int bcol) {
    int16_t coef[64] = {0};
    int s = br.decode<kFast>(dc[c.td]);
    int diff = s ? extend(br.get<kFast>(s), s) : 0;
    c.dc_pred += diff;
    coef[0] = (int16_t)c.dc_pred;
    const Huff& a = ac[c.ta];
    for (int k = 1; k < 64; ++k) {
      int rs = br.decode<kFast>(a), r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        coef[kNatural[k]] = (int16_t)extend(br.get<kFast>(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    idct(c, coef, brow, bcol);
  }

  // A block's samples into its component's plane, at the frame's precision.
  void idct(Component& c, const int16_t* coef, int brow, int bcol) {
    const size_t at = (size_t)brow * 8 * c.pw + (size_t)bcol * 8;
    if (precision == 12)
      idct_islow12(coef, c.q, &c.plane12[at], c.pw);
    else
      idct_islow(coef, c.q, &c.plane[at], c.pw);
  }

  // jdphuff.c, one block of each kind of progressive scan; `eobrun` is the
  // scan's run of blocks left with no coefficient in its band.
  static void dc_first(ProgressiveReader& br, const Huff& t, Component& c, int16_t* b, int al) {
    int s = br.decode(t);
    if (s) c.dc_pred += extend(br.get(s), s);
    b[0] = (int16_t)(uint16_t)((unsigned)c.dc_pred << al);
  }

  static void ac_first(ProgressiveReader& br, const Huff& t, int16_t* b, int ss, int se, int al,
                       int& eobrun) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      int rs = br.decode(t), r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        b[kNatural[k]] = (int16_t)(uint16_t)((unsigned)extend(br.get(s), s) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.get(r);
        --eobrun;
        return;
      }
    }
  }

  // Correction bits of the coefficients already nonzero, new ones of +-1 at
  // Al, zero runs that count only zero-history coefficients.
  static void ac_refine(ProgressiveReader& br, const Huff& t, int16_t* b, int ss, int se, int al,
                        int& eobrun) {
    const int p1 = 1 << al, m1 = (int)((unsigned)-1 << al);
    auto refine = [&](int16_t* c) {
      if (br.get(1) && (*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
    };
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int rs = br.decode(t), r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.get(1) ? p1 : m1;  // libjpeg takes any size as 1
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t* c = b + kNatural[k];
          if (*c != 0) {
            refine(c);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) b[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k)
        if (b[kNatural[k]] != 0) refine(b + kNatural[k]);
      --eobrun;
    }
  }

  // After a restart interval: jdmarker.c read_restart_marker with
  // jpeg_resync_to_restart's rule. From where the bit reader stopped, the
  // next marker: RSTn as expected, or a restart too far off, is consumed;
  // one of the next two restarts, or a marker that is not a restart, is
  // left for the next interval, which then reads as empty data; an earlier
  // restart or an invalid marker is skipped for the one after it. Returns
  // whether a marker was left (pos then at its FF).
  bool restart_marker(int desired) {
    for (int m = next_marker();; m = next_marker()) {
      if (old_tiff && m != 0xD0 + desired) throw OldTiffStop{};
      const int k = m - 0xD0;
      const bool rst = k >= 0 && k <= 7;
      if (m >= 0xC0 && (!rst || k == ((desired + 1) & 7) || k == ((desired + 2) & 7))) {
        pos -= 2;
        return true;
      }
      if (m < 0xC0 || k == ((desired - 1) & 7) || k == ((desired - 2) & 7)) continue;
      return false;
    }
  }

  // A sequential Huffman MCU as jdhuff.c's decode_mcu reads it: the fast
  // path while there are no restarts, no marker has been met and 512 bytes
  // a block of the MCU are buffered, the slow path otherwise and for an MCU
  // whose fast decode met a marker; an MCU that suspends is decoded again
  // from its start once PIL has read the next block (jpeg_read_scanlines
  // returns, PIL reads on and calls the decoder again). f(fast, component,
  // block row, block column) decodes one block.
  template <class Mcu, class F>
  void huffman_mcu(BitReader& br, Component** sc, int ns, int blocks, Mcu& mcu, F& f) {
    int preds[4];
    for (int i = 0; i < ns; ++i) preds[i] = sc[i]->dc_pred;
    for (;;) {
      const BitReader at_start = br;
      auto undo = [&] {
        br = at_start;
        for (int i = 0; i < ns; ++i) sc[i]->dc_pred = preds[i];
      };
      try {
        if (!restart && !br.at_marker && br.end - br.pos >= (size_t)512 * blocks) {
          mcu([&](Component& c, int r, int col) { f(std::true_type{}, c, r, col); });
          if (!br.hit) return;
          undo();
        }
        mcu([&](Component& c, int r, int col) { f(std::false_type{}, c, r, col); });
        return;
      } catch (const Suspend&) {
        undo();
        br.end = std::min(n, br.end + kPilBlock);
      }
    }
  }

  // Calls f(component, block row, block column) for each block of each MCU
  // of a scan, reading the restart markers between intervals; before each
  // MCU, mcu_start(whether a restart came just before it). An MCU that
  // starts once the reader has run out of data in its interval (libjpeg's
  // insufficient_data) is passed to `skipped` instead, block by block: a
  // sequential decoder leaves its blocks zero, a progressive one as they are.
  // A sequential Huffman scan's f takes the path first (huffman_mcu).
  template <class Reader, class Start, class F, class Skip>
  void each_block(Component** sc, int ns, Reader& br, Start mcu_start, F f, Skip skipped) {
    constexpr bool kHuffman = std::is_same_v<Reader, BitReader>;
    int rows, cols;
    if (ns == 1) {  // a non-interleaved scan covers the component's own blocks
      cols = (sc[0]->dw + 7) / 8;
      rows = (sc[0]->dh + 7) / 8;
    } else {
      cols = mcux;
      rows = mcuy;
    }
    int64_t done = 0;
    int rst = 0, blocks = 0;
    for (int i = 0; i < ns; ++i) blocks += ns == 1 ? 1 : sc[i]->h * sc[i]->v;
    last_good_rows = ns == 1 ? sc[0]->v : 1;  // MCU rows an iMCU row
    for (int my = 0; my < rows; ++my) {
      stop_row = my;
      for (int mx = 0; mx < cols; ++mx) {
        bool restarted = restart && done > 0 && done % restart == 0;
        if (br.took_padding()) br.starved = true;
        if (restarted) {
          // Drop the buffered bits, find RSTn, restart the predictors; out
          // of data stays so only while a marker is left unread.
          const bool starved = br.starved;
          br.reset();
          pos = br.pos;
          if constexpr (kHuffman) avail = br.end;
          const bool left = restart_marker(rst);
          rst = (rst + 1) & 7;
          br.pos = pos;
          if constexpr (kHuffman) br.end = avail;
          br.starved = left && starved;
        }
        mcu_start(restarted);
        if (!br.starved) last_good = my;
        auto mcu = [&](auto&& g) {
          if (ns == 1) {
            g(*sc[0], my, mx);
          } else {
            for (int i = 0; i < ns; ++i)
              for (int v = 0; v < sc[i]->v; ++v)
                for (int h = 0; h < sc[i]->h; ++h) g(*sc[i], my * sc[i]->v + v, mx * sc[i]->h + h);
          }
        };
        if (br.starved)
          mcu(skipped);
        else if constexpr (kHuffman)
          huffman_mcu(br, sc, ns, blocks, mcu, f);
        else
          mcu(f);
        ++done;
      }
    }
    pos = br.pos;
    if constexpr (kHuffman) avail = br.end;
  }

  // A lossless scan (libjpeg-turbo 3: jdlhuff.c, jddiffct.c, jdlossls.c):
  // per sample a Huffman-coded difference category (16: 32768, no extra
  // bits), in MCUs of h x v samples a component (one sample a non-
  // interleaved scan's MCU). An iMCU row (one MCU row, or v rows of a lone
  // component) is decoded, then undifferenced row by row with predictor
  // `psv` from the row above and the sample to the left, modulo 2^16; the
  // first row after the scan's start or a restart is a row of its own
  // (2^(7 - pt), then the left neighbour), and so is, as in libjpeg, the
  // first row of an iMCU row in which a restart came. Each row's first
  // sample takes the one above. A sample is its value << pt, kept to 8 bits.
  // Once the reader runs past the segment's data, each further MCU row is
  // zero differences from a first row, until a restart.
  void lossless_scan(Component** sc, int ns, int psv, int pt) {
    const bool inter = ns > 1;
    const int cols = inter ? mcux : sc[0]->dw;  // MCUs a row
    if (restart % cols) corrupt("lossless JPEG restart interval not a whole number of rows");
    struct Rows {
      std::vector<int> diff, undiff;  // v rows of the padded width; v rows of the width
      bool first = true;
    } rows[4];
    for (int i = 0; i < ns; ++i) {
      rows[i].diff.assign((size_t)sc[i]->v * cols * (inter ? sc[i]->h : 1), 0);
      rows[i].undiff.assign((size_t)sc[i]->v * sc[i]->dw, 0);
    }
    // Its decoder suspends between MCUs and reads the same bits again, so
    // PIL's blocks do not matter; the end of the file does.
    BitReader br{d, n, pos, n};
    const int init = 1 << (precision - pt - 1);
    int rst = 0, rows_to_go = restart / cols;
    for (int im = 0; im < mcuy; ++im) {
      // A lone component's iMCU row is v of its rows, fewer at its foot.
      const int mrows = inter ? 1 : std::min(sc[0]->v, sc[0]->dh - im * sc[0]->v);
      for (int y = 0; y < mrows; ++y) {
        if (restart && rows_to_go == 0) {
          const bool starved = br.starved || br.took_padding();
          br.reset();
          pos = br.pos;
          stop_row = im;
          const bool left = restart_marker(rst);
          rst = (rst + 1) & 7;
          br.pos = pos;
          br.starved = left && starved;
          for (int i = 0; i < ns; ++i) rows[i].first = true;
          rows_to_go = restart / cols;
        }
        if (br.took_padding()) br.starved = true;
        for (int i = 0; i < ns; ++i) {
          if (!br.starved) continue;
          const int w = cols * (inter ? sc[i]->h : 1);
          for (int v = inter ? 0 : y; v < (inter ? sc[i]->v : y + 1); ++v)
            std::fill_n(&rows[i].diff[(size_t)v * w], w, 0);
          rows[i].first = true;
        }
        if (!br.starved) {
          for (int mx = 0; mx < cols; ++mx)
            for (int i = 0; i < ns; ++i) {
              const int h = inter ? sc[i]->h : 1, w = cols * h;
              for (int v = 0; v < (inter ? sc[i]->v : 1); ++v)
                for (int u = 0; u < h; ++u) {
                  int s = br.decode(dc[sc[i]->td]);
                  if (s == 16)
                    s = 32768;
                  else if (s)
                    s = extend(br.get(s), s);
                  rows[i].diff[(size_t)(inter ? v : y) * w + mx * h + u] = s;
                }
            }
        }
        if (restart) --rows_to_go;
      }
      for (int i = 0; i < ns; ++i) {
        Component& c = *sc[i];
        Rows& r = rows[i];
        const int w = cols * (inter ? c.h : 1), dw = c.dw;
        for (int y = 0; y < c.v && im * c.v + y < c.dh; ++y) {
          const int* df = &r.diff[(size_t)y * w];
          const int* prev = &r.undiff[(size_t)(y ? y - 1 : c.v - 1) * dw];
          int* u = &r.undiff[(size_t)y * dw];
          if (r.first) {
            int ra = (df[0] + init) & 0xFFFF;
            u[0] = ra;
            for (int x = 1; x < dw; ++x) u[x] = ra = (df[x] + ra) & 0xFFFF;
            r.first = false;
          } else {
            int rb = prev[0], ra = (df[0] + rb) & 0xFFFF;
            u[0] = ra;
            for (int x = 1; x < dw; ++x) {
              const int rc = rb;
              rb = prev[x];
              const int p = psv == 1   ? ra
                            : psv == 2 ? rb
                            : psv == 3 ? rc
                            : psv == 4 ? ra + rb - rc
                            : psv == 5 ? ra + ((rb - rc) >> 1)
                            : psv == 6 ? rb + ((ra - rc) >> 1)
                                       : (ra + rb) >> 1;
              u[x] = ra = (df[x] + p) & 0xFFFF;
            }
          }
          const size_t row = (size_t)(im * c.v + y) * c.pw;
          if (precision == 12) {  // libjpeg's 12-bit samples are shorts: the low 16 bits
            for (int x = 0; x < dw; ++x) c.plane12[row + x] = (uint16_t)(u[x] << pt);
            continue;
          }
          uint8_t* o = &c.plane[row];
          for (int x = 0; x < dw; ++x) o[x] = (uint8_t)(u[x] << pt);
        }
      }
    }
    pos = br.pos;
  }

  // jdarith.c: a DC difference (Figures F.19 - F.24) in the bins of table
  // `tbl` from context `ctx`, which it updates; false on a magnitude
  // overflow, which leaves the rest of the restart interval alone (ct -1).
  bool arith_dc(ArithReader& ar, uint8_t* bins, int tbl, int& ctx, int& v) {
    uint8_t* st = bins + ctx;
    v = 0;
    if (!ar.decode(st)) {
      ctx = 0;
      return true;
    }
    const int sign = ar.decode(st + 1);
    st += 2 + sign;
    int m = ar.decode(st);
    if (m) {
      st = bins + 20;
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) {
          ar.ct = -1;
          return false;
        }
        ++st;
      }
    }
    if (m < (1 << dac_l[tbl]) >> 1)
      ctx = 0;
    else if (m > (1 << dac_u[tbl]) >> 1)
      ctx = 12 + sign * 4;
    else
      ctx = 4 + sign * 4;
    v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    return true;
  }

  // jdarith.c: AC coefficients ss .. se of a block, as a sequential or a
  // first progressive scan codes them (Figure F.20), each << al.
  bool arith_ac(ArithReader& ar, uint8_t* bins, int tbl, uint8_t* fixed, int16_t* b, int ss,
                int se, int al) {
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = bins + 3 * (k - 1);
      if (ar.decode(st)) break;  // EOB
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++k > se) {
          ar.ct = -1;  // spectral overflow
          return false;
        }
      }
      const int sign = ar.decode(fixed);
      st += 2;
      int m = ar.decode(st);
      if (m && ar.decode(st)) {
        m <<= 1;
        st = bins + (k <= dac_k[tbl] ? 189 : 217);
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ar.ct = -1;
            return false;
          }
          ++st;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      b[kNatural[k]] = (int16_t)(uint16_t)((unsigned)v << al);
    }
    return true;
  }

  // An arithmetic-coded scan (SOF9, SOF10; libjpeg-turbo's jdarith.c), on
  // each_block's MCU walk and restarts. Statistics start at zero, and again
  // at each restart with the DC predictions, as do the coding variables.
  // An error (a magnitude or run past its bound) leaves the MCUs that
  // follow in its restart interval alone: zero blocks in a sequential scan.
  void arith_scan(Component** sc, int ns, int ss, int se, int ah, int al) {
    ArithReader ar{d, n, pos, avail};
    ArithStats s;
    can_suspend = false;
    const bool dc_scan = !progressive || (ss == 0 && ah == 0), ac_scan = !progressive || ss;
    auto reset = [&]() {
      for (int i = 0; i < ns; ++i) {
        const int ci = (int)(sc[i] - comp);
        if (dc_scan) {
          memset(s.dc[sc[i]->td], 0, sizeof s.dc[0]);
          s.last_dc[ci] = s.dc_context[ci] = 0;
        }
        if (ac_scan) memset(s.ac[sc[i]->ta], 0, sizeof s.ac[0]);
      }
    };
    reset();
    auto start = [&](bool restarted) {
      if (restarted) reset();
    };
    // A DC difference added to the component's prediction, modulo 2^16.
    auto dc_value = [&](Component& c, int& out) {
      const int ci = (int)(&c - comp);
      int v;
      if (!arith_dc(ar, s.dc[c.td], c.td, s.dc_context[ci], v)) return false;
      s.last_dc[ci] = (s.last_dc[ci] + v) & 0xFFFF;
      out = s.last_dc[ci];
      return true;
    };
    auto leave = [](Component&, int, int) {};
    if (!progressive) {
      each_block(sc, ns, ar, start, [&](Component& c, int r, int col) {
        int16_t b[64] = {0};
        int dcv;
        if (ar.ct != -1 && dc_value(c, dcv)) {
          b[0] = (int16_t)dcv;
          arith_ac(ar, s.ac[c.ta], c.ta, &s.fixed, b, 1, 63, 0);
        }
        idct(c, b, r, col);
      }, leave);
      return;
    }
    auto at = [](Component& c, int r, int col) {
      return &c.coef[((size_t)r * (c.pw / 8) + col) * 64];
    };
    if (ss == 0 && ah == 0) {
      each_block(sc, ns, ar, start, [&](Component& c, int r, int col) {
        int dcv;
        if (ar.ct != -1 && dc_value(c, dcv))
          *at(c, r, col) = (int16_t)(uint16_t)((unsigned)dcv << al);
      }, leave);
    } else if (ss == 0) {
      const int16_t p1 = (int16_t)(1 << al);
      each_block(sc, ns, ar, start, [&](Component& c, int r, int col) {
        if (ar.decode(&s.fixed)) *at(c, r, col) |= p1;
      }, leave);
    } else if (ah == 0) {
      each_block(sc, ns, ar, start, [&](Component& c, int r, int col) {
        if (ar.ct != -1) arith_ac(ar, s.ac[c.ta], c.ta, &s.fixed, at(c, r, col), ss, se, al);
      }, leave);
    } else {
      // Figure G.10's decoding: past the last coefficient that earlier
      // scans made nonzero an EOB decision; a nonzero one takes a
      // correction bit, a zero one may become +-1 << al.
      const int p1 = 1 << al, m1 = (int)((unsigned)-1 << al);
      each_block(sc, ns, ar, start, [&](Component& c, int r, int col) {
        if (ar.ct == -1) return;
        int16_t* b = at(c, r, col);
        uint8_t* bins = s.ac[c.ta];
        int kex = se;
        while (kex > 0 && !b[kNatural[kex]]) --kex;
        for (int k = ss; k <= se; ++k) {
          uint8_t* st = bins + 3 * (k - 1);
          if (k > kex && ar.decode(st)) break;
          for (;;) {
            int16_t* x = b + kNatural[k];
            if (*x) {
              if (ar.decode(st + 2)) *x = (int16_t)(*x + (*x < 0 ? m1 : p1));
              break;
            }
            if (ar.decode(st + 1)) {
              *x = (int16_t)(ar.decode(&s.fixed) ? m1 : p1);
              break;
            }
            st += 3;
            if (++k > se) {
              ar.ct = -1;
              return;
            }
          }
        }
      }, leave);
    }
  }

  void sos() {
    if (!frame) corrupt("JPEG scan before its frame");
    int len = u16();
    int ns = u8();
    if (ns < 1 || ns > ncomp || ns > 4 || len != 6 + 2 * ns) corrupt("bad JPEG scan header");
    Component* sc[4];
    for (int i = 0; i < ns; ++i) {
      int id = u8(), t = u8();
      Component* c = nullptr;
      for (int j = 0; j < std::min(ncomp, 4); ++j)  // libjpeg-turbo looks among the first 4 alone
        if (comp[j].id == id) c = &comp[j];
      if (!c) corrupt("JPEG scan names an unknown component");
      c->td = t >> 4;
      c->ta = t & 15;
      if (!arith && (c->td > 3 || c->ta > 3)) corrupt("bad JPEG scan header");
      sc[i] = c;
    }
    int ss = u8(), se = u8(), ahl = u8(), ah = ahl >> 4, al = ahl & 15;
    // A sequential scan's Ss, Se, Ah and Al are only a warning to libjpeg
    // (some baseline files hold zeros there): it codes all 64 coefficients.
    if (lossless) {  // jdlossls.c start_pass_lossless: the predictor and point transform
      if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= precision) corrupt("bad lossless JPEG scan");
    } else if (progressive) {  // jdphuff.c start_pass_phuff_decoder
      bool bad = ss == 0 ? se != 0 : ss > se || se > 63 || ns != 1;
      if ((ah != 0 && al != ah - 1) || al > 13 || bad) corrupt("bad progressive JPEG scan");
    }
    // Only the tables the scan uses: a DC refinement uses none, an AC scan
    // only its AC table. libjpeg installs the default tables in slots 0 and
    // 1 for a sequential scan only; a progressive scan needs its own.
    const bool use_dc = !progressive || (ss == 0 && ah == 0);
    const bool use_ac = !lossless && (!progressive || ss != 0);
    for (int i = 0; i < ns; ++i) {
      Component* c = sc[i];
      if (arith) {
        // no Huffman tables
      } else if (use_dc && !dc[c->td].defined) {
        if (c->td > 1 || progressive) corrupt("JPEG scan uses an undefined Huffman table");
        std_table(dc[c->td], true, c->td);
      }
      if (!arith && use_ac && !ac[c->ta].defined) {
        if (c->ta > 1 || progressive) corrupt("JPEG scan uses an undefined Huffman table");
        std_table(ac[c->ta], false, c->ta);
      }
      if (!c->latched && !lossless) {  // libjpeg latches a component's table at its first scan
        if (!qdef[c->tq]) corrupt("JPEG component uses an undefined quantization table");
        memcpy(c->q, qt[c->tq], sizeof c->q);
        c->latched = true;
      }
      c->dc_pred = 0;
    }
    int mcu_blocks = 0;
    for (int i = 0; i < ns; ++i) mcu_blocks += sc[i]->h * sc[i]->v;
    if (ns > 1 && mcu_blocks > 10) corrupt("JPEG scan of more than 10 blocks an MCU");
    if (scans == 0) multi_scan = progressive || ns < ncomp;
    ++scans;

    if (lossless) {
      lossless_scan(sc, ns, ss, al);
      return;
    }
    if (!progressive && arith) {
      arith_scan(sc, ns, 0, 63, 0, 0);
      can_suspend = true;
      return;
    }
    if (!progressive) {
      BitReader br{d, n, pos, avail};
      br.open_end = open_end;
      each_block(
          sc, ns, br,
          [&](bool rst) {
            if (rst)
              for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
          },
          [&](auto fast, Component& c, int r, int col) { block<decltype(fast)::value>(br, c, r, col); },
          [&](Component& c, int r, int col) {  // all-zero coefficients: flat 128 (2048)
            const int16_t zero[64] = {0};
            idct(c, zero, r, col);
          });
      return;
    }
    for (int i = 0; i < ns; ++i) {
      int* cb = coef_bits[sc[i] - comp];
      int* pb = prev_bits[sc[i] - comp];
      for (int k = std::min(ss, 1); k <= std::min(std::max(se, 9), 9); ++k) pb[k] = scans > 1 ? cb[k] : 0;
      for (int k = ss; k <= se; ++k) cb[k] = al;
    }
    if (arith) {
      arith_scan(sc, ns, ss, se, ah, al);
      can_suspend = true;
      return;
    }
    // jdphuff.c suspends between MCUs and reads the same bits again: PIL's
    // blocks do not matter.
    ProgressiveReader br{d, n, pos, n};
    int eobrun = 0;
    auto start = [&](bool rst) {
      if (rst) {
        for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
        eobrun = 0;
      }
    };
    auto leave = [](Component&, int, int) {};  // out of data: the blocks stay as they are
    auto at = [](Component& c, int r, int col) {
      return &c.coef[((size_t)r * (c.pw / 8) + col) * 64];
    };
    if (ss == 0 && ah == 0) {
      each_block(sc, ns, br, start, [&](Component& c, int r, int col) {
        dc_first(br, dc[c.td], c, at(c, r, col), al);
      }, leave);
    } else if (ss == 0) {
      const int16_t p1 = (int16_t)(1 << al);
      each_block(sc, ns, br, start, [&](Component& c, int r, int col) {
        if (br.get(1)) *at(c, r, col) |= p1;
      }, leave);
    } else {
      const Huff& t = ac[sc[0]->ta];
      each_block(sc, ns, br, start, [&](Component& c, int r, int col) {
        if (ah == 0)
          ac_first(br, t, at(c, r, col), ss, se, al, eobrun);
        else
          ac_refine(br, t, at(c, r, col), ss, se, al, eobrun);
      }, leave);
    }
  }

  // jdcoefct.c smoothing_ok (libjpeg-turbo 3, SAVED_COEFS = 10): whether
  // libjpeg would smooth this progressive image between blocks.
  bool would_smooth() const {
    bool useful = false;
    for (int i = 0; i < ncomp; ++i) {
      const Component& c = comp[i];
      if (!c.latched) return false;
      for (int pos : {0, 1, 8, 16, 9, 2, 3, 10, 17, 24})  // DC and Q01 .. Q30
        if (c.q[pos] == 0) return false;
      if (coef_bits[i][0] < 0) return false;
      for (int k = 1; k < 10; ++k) useful = useful || coef_bits[i][k] != 0;
    }
    return useful;
  }

  // jdcoefct.c decompress_smooth_data (libjpeg-turbo 3): before its IDCT,
  // each block's first nine AC coefficients that are still zero and not
  // known exactly (coef_bits not 0) are estimated from the DC values of the
  // 5 x 5 blocks around it (edges repeated); with no AC data at all the DC
  // is smoothed too. Rows past the last scan's last good iMCU row use the
  // coef_bits from before that scan.
  void smooth_plane(int ci) {
    Component& c = comp[ci];
    const int bw = c.pw / 8, wb = (c.dw + 7) / 8, hb = (c.dh + 7) / 8;
    auto at = [&](int r, int col) { return &c.coef[((size_t)r * bw + col) * 64]; };
    int64_t Q[10];  // the quantizers of zig-zag 0 .. 9 (Q00, Q01, Q10, Q20, Q11, Q02, ...)
    for (int k = 0; k < 10; ++k) Q[k] = (uint16_t)c.q[kNatural[k]];
    const int* prev = scans > 1 ? prev_bits[ci] : nullptr;
    for (int r = 0; r < hb; ++r) {
      const int* bits = r / c.v > last_good / last_good_rows ? prev : coef_bits[ci];
      auto known = [&](int k) { return bits ? bits[k] : -1; };
      bool change_dc = true;
      for (int k = 1; k < 10; ++k) change_dc = change_dc && known(k) == -1;
      // The neighbouring block rows as libjpeg-turbo picks them: by the
      // row's index counted in rows of its own iMCU row's height (that of
      // the last iMCU row, short when the image ends inside it, differs).
      // A row two above is its neighbour above where that index is 1; two
      // below can be an MCU-padding row (its DC as coded, or 0).
      const int im = r / c.v, rows_here = im < mcuy - 1 || hb % c.v == 0 ? c.v : hb % c.v;
      const int idx = im * rows_here + r % c.v, last = rows_here * mcuy - 1;
      const int up = idx > 0 ? r - 1 : r, down = idx < last ? r + 1 : r;
      const int rows[5] = {idx > 1 ? r - 2 : up, up, r, down, idx < last - 1 ? r + 2 : down};
      for (int col = 0; col < wb; ++col) {
        int DC[26];  // DC[1 + 5 * i + j]: row r - 2 + i, column col - 2 + j
        for (int i = 0; i < 5; ++i)
          for (int j = 0; j < 5; ++j)
            DC[1 + 5 * i + j] = at(rows[i], std::min(std::max(col - 2 + j, 0), wb - 1))[0];
        int16_t ws[64];
        memcpy(ws, at(r, col), sizeof ws);
        auto predict = [&](int k, int64_t weighted) {
          const int al = known(k), pos = kNatural[k];
          if (al == 0 || ws[pos] != 0) return;
          const int64_t num = Q[0] * weighted, d = Q[k] << 8;
          int64_t pred = ((Q[k] << 7) + (num >= 0 ? num : -num)) / d;
          if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
          ws[pos] = (int16_t)(num >= 0 ? pred : -pred);
        };
        const int *D = DC;
        if (change_dc) {
          predict(1, -D[1] - D[2] + D[4] + D[5] - 3 * D[6] + 13 * D[7] - 13 * D[9] + 3 * D[10] -
                         3 * D[11] + 38 * D[12] - 38 * D[14] + 3 * D[15] - 3 * D[16] + 13 * D[17] -
                         13 * D[19] + 3 * D[20] - D[21] - D[22] + D[24] + D[25]);
          predict(2, -D[1] - 3 * D[2] - 3 * D[3] - 3 * D[4] - D[5] - D[6] + 13 * D[7] + 38 * D[8] +
                         13 * D[9] - D[10] + D[16] - 13 * D[17] - 38 * D[18] - 13 * D[19] + D[20] +
                         D[21] + 3 * D[22] + 3 * D[23] + 3 * D[24] + D[25]);
          predict(3, D[3] + 2 * D[7] + 7 * D[8] + 2 * D[9] - 5 * D[12] - 14 * D[13] - 5 * D[14] +
                         2 * D[17] + 7 * D[18] + 2 * D[19] + D[23]);
          predict(4, -D[1] + D[5] + 9 * D[7] - 9 * D[9] - 9 * D[17] + 9 * D[19] + D[21] - D[25]);
          predict(5, 2 * D[7] - 5 * D[8] + 2 * D[9] + D[11] + 7 * D[12] - 14 * D[13] + 7 * D[14] +
                         D[15] + 2 * D[17] - 5 * D[18] + 2 * D[19]);
          predict(6, D[7] - D[9] + 2 * D[12] - 2 * D[14] + D[17] - D[19]);
          predict(7, D[7] - 3 * D[8] + D[9] - D[17] + 3 * D[18] - D[19]);
          predict(8, D[7] - D[9] - 3 * D[12] + 3 * D[14] + D[17] - D[19]);
          predict(9, D[7] + 2 * D[8] + D[9] - D[17] - 2 * D[18] - D[19]);
          const int64_t num =
              Q[0] * (-2 * D[1] - 6 * D[2] - 8 * D[3] - 6 * D[4] - 2 * D[5] - 6 * D[6] + 6 * D[7] +
                      42 * D[8] + 6 * D[9] - 6 * D[10] - 8 * D[11] + 42 * D[12] + 152 * D[13] +
                      42 * D[14] - 8 * D[15] - 6 * D[16] + 6 * D[17] + 42 * D[18] + 6 * D[19] -
                      6 * D[20] - 2 * D[21] - 6 * D[22] - 8 * D[23] - 6 * D[24] - 2 * D[25]);
          const int64_t pred = ((Q[0] << 7) + (num >= 0 ? num : -num)) / (Q[0] << 8);
          ws[0] = (int16_t)(num >= 0 ? pred : -pred);
        } else {
          predict(1, -7 * D[11] + 50 * D[12] - 50 * D[14] + 7 * D[15]);
          predict(2, -7 * D[3] + 50 * D[8] - 50 * D[18] + 7 * D[23]);
          predict(3, -D[3] + 13 * D[8] - 24 * D[13] + 13 * D[18] - D[23]);
          predict(4, D[10] + D[16] - 10 * D[17] + 10 * D[19] - D[2] - D[20] + D[22] - D[24] + D[4] -
                         D[6] + 10 * D[7] - 10 * D[9]);
          predict(5, -D[11] + 13 * D[12] - 24 * D[13] + 13 * D[14] - D[15]);
        }
        idct(c, ws, r, col);
      }
    }
  }

  // The progressive coefficients -> planes, once, after the last scan: the
  // blocks that hold the component's samples (the rest are never read).
  void idct_planes() {
    const bool smooth = would_smooth();
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      if (precision == 12)
        c.plane12.assign((size_t)c.pw * c.ph, 0);
      else
        c.plane.assign((size_t)c.pw * c.ph, 0);
      const int bw = c.pw / 8;
      if (smooth) {
        smooth_plane(i);
      } else {
        for (int r = 0; r < (c.dh + 7) / 8; ++r)
          for (int col = 0; col < (c.dw + 7) / 8; ++col) idct(c, &c.coef[((size_t)r * bw + col) * 64], r, col);
      }
      std::vector<int16_t>().swap(c.coef);
    }
  }

  // Markers up to EOI; with `tables_only`, a stream of tables (a TIFF's
  // JPEGTables) that must hold no frame.
  // The markers after a whole frame of one scan, as jpeg_finish_decompress
  // reads them (jdmarker.c): nothing they define is used, so only whether
  // libjpeg fails on them matters. It fails on a check in the order it
  // reads (a second SOS header whole fails: JERR_EOI_EXPECTED), and stops
  // at EOI or, under PIL's suspending source, at the end of the data.
  void tail() {
    whole = true;
    const auto bad = [] { corrupt("bad JPEG marker after the image"); };
    try {
      for (;;) {
        const int m = next_marker();
        if (m == 0xD9) return;
        if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;  // RSTn, TEM
        const bool skipped = (m >= 0xE0 && m <= 0xEF) || m == 0xFE || m == 0xDC;
        if (!skipped && m != 0xDD && m != 0xCC && m != 0xC4 && m != 0xDB && m != 0xDA)
          bad();  // SOI, SOFn, JPGn and the like
        int len = m == 0xDA ? 0 : u16() - 2;
        if (skipped) {  // APPn, COM, DNL
          for (; len > 0; --len) u8();
        } else if (m == 0xDD) {
          if (len != 2) bad();
          u16();
        } else if (m == 0xCC) {  // DAC, pair by pair
          for (; len > 0; len -= 2) {
            const int index = u8(), val = u8();
            if (index >= 32 || (index < 16 && (val & 15) > (val >> 4))) bad();
          }
          if (len) bad();
        } else if (m == 0xC4) {  // DHT, table by table (not built)
          while (len > 16) {
            const int index = u8();
            int count = 0;
            for (int i = 0; i < 16; ++i) count += u8();
            len -= 17;
            if (count > 256 || count > len) bad();
            for (int i = 0; i < count; ++i) u8();
            len -= count;
            if ((index & ~0x10) > 3) bad();
          }
          if (len) bad();
        } else if (m == 0xDB) {  // DQT
          while (len > 0) {
            const int pq = u8();
            if ((pq & 15) > 3) bad();
            for (int i = 0; i < (pq >> 4 ? 128 : 64); ++i) u8();
            len -= pq >> 4 ? 129 : 65;
          }
          if (len) bad();
        } else if (m == 0xDA) {  // a second scan's header, then EOI expected
          len = u16();
          const int ns = u8();
          if (len != 6 + 2 * ns || ns < 1 || ns > 4) bad();
          bool used[4] = {false, false, false, false};
          for (int i = 0; i < ns; ++i) {
            const int id = u8();
            u8();
            int ci = 0;
            while (ci < std::min(ncomp, 4) && (comp[ci].id != id || used[ci])) ++ci;
            if (ci == std::min(ncomp, 4)) bad();
            used[ci] = true;
          }
          u8();
          u8();
          u8();
          corrupt("JPEG scan after one of every component (libjpeg expects EOI)");
        }
      }
    } catch (const JpegEnd&) {
    }
  }

  void markers(bool tables_only) {
    for (;;) {
      if (tables_only && pos >= n) break;  // libtiff supplies a missing EOI here
      int m = next_marker();
      if (m == 0xD9) break;  // EOI
      if (tables_only && (m == 0xDA || (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 &&
                                        m != 0xCC)))
        corrupt("JPEG tables stream holds image data");
      if (m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC3) {
        sof(m == 0xC2, m == 0xC3);
      } else if (m == 0xCB) {  // libjpeg-turbo has no lossless arithmetic decoder: PIL refuses it
        corrupt("lossless arithmetic-coded JPEG (SOF11), which libjpeg does not decode");
      } else if (m == 0xC9 || m == 0xCA) {
        sof(m == 0xCA, false, true);
      } else if (m == 0xC5 || m == 0xC6 || m == 0xC7 || m == 0xCD || m == 0xCE || m == 0xCF) {
        corrupt("hierarchical (differential) JPEG, which libjpeg does not decode");
      } else if (m == 0xCC) {
        dac();
      } else if (m == 0xC4) {
        dht();
      } else if (m == 0xDB) {
        dqt();
      } else if (m == 0xDD) {
        if (u16() != 4) corrupt("bad JPEG restart interval");
        restart = u16();
      } else if (m == 0xDA) {
        sos();
        if (old_tiff) break;
        if (!multi_scan) {
          tail();
          break;
        }
      } else if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE || m == 0xDC) {
        app(m);  // a DNL segment after a frame with a height is skipped, as libjpeg does
      } else if (m >= 0xD0 && m <= 0xD7) {
        continue;  // a stray restart marker
      } else if (m == 0x01) {
        continue;  // TEM
      } else {
        corrupt("unknown JPEG marker");
      }
    }
  }

  // The markers to EOI, then every component's plane.
  void planes() {
    markers(false);
    if (!frame || !scans) corrupt("JPEG has no image data");
    if (progressive) idct_planes();
  }

  Gray run(ColorMode mode = kColorFromMarkers) {
    planes();
    Gray g;
    g.w = W;
    g.h = H;
    g.px.resize((size_t)W * H);
    if (ncomp == 1) {
      for (int y = 0; y < H; ++y) memcpy(&g.px[(size_t)y * W], &comp[0].plane[(size_t)y * comp[0].pw], W);
      return g;
    }
    std::vector<uint8_t> full[4];
    for (int i = 0; i < ncomp; ++i) {
      const Component& c = comp[i];
      full[i] = upsample(c, hmax / c.h, vmax / c.v, W, H, lossless);
    }
    // libjpeg's colour space (jdapimin.c default_decompress_parms): three
    // components are YCbCr under JFIF, else as Adobe's transform says (0:
    // RGB), else RGB only when named R, G, B; four are YCCK where Adobe's
    // transform is not 0, else CMYK.
    bool ycc;
    if (mode != kColorFromMarkers) {
      ycc = mode == kColorYcc;
    } else if (ncomp == 3 && jfif) {
      ycc = true;
    } else if (adobe) {
      ycc = adobe_transform != 0;
    } else {
      // libjpeg-turbo 3 takes a lossless frame without markers for RGB
      ycc = ncomp == 3 && !lossless &&
            !(comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B');
    }
    // and converts no colour space of a lossless frame.
    if (lossless && ycc) corrupt("lossless JPEG in YCbCr or YCCK, which libjpeg does not convert");
    const YccTables t = ycc_tables();  // a copy on the stack, out of the pixels' way
    const uint8_t *c0 = full[0].data(), *c1 = full[1].data(), *c2 = full[2].data();
    if (ncomp == 4) {
      // CMYK, or YCCK that libjpeg turns into CMYK (jdcolor.c
      // ycck_cmyk_convert: 255 minus the RGB of Y, Cb, Cr; K as coded).
      // PIL reads a JPEG file's CMYK as Adobe's inverted "CMYK;I", a TIFF's
      // (libtiff's JCS_UNKNOWN) as it is.
      const uint8_t* c3 = full[3].data();
      const int inv = mode == kColorFromMarkers ? 255 : 0;
      for (size_t i = 0; i < g.px.size(); ++i) {
        int c = c0[i], m = c1[i], y = c2[i];
        if (ycc) {
          int r, gg, b;
          t.rgb(c0[i], c1[i], c2[i], r, gg, b);
          c = 255 - r;
          m = 255 - gg;
          y = 255 - b;
        }
        g.px[i] = cmyk_luma(c ^ inv, m ^ inv, y ^ inv, c3[i] ^ inv);
      }
      return g;
    }
    uint8_t* o = g.px.data();
    const size_t n = g.px.size();
    if (!ycc) {
      for (size_t i = 0; i < n; ++i) o[i] = luma(c0[i], c1[i], c2[i]);
      return g;
    }
    for (size_t i = 0; i < n; ++i) {
      int r, gg, b;
      t.rgb(c0[i], c1[i], c2[i], r, gg, b);
      o[i] = luma(r, gg, b);
    }
    return g;
  }
};

Gray decode_jpeg(const uint8_t* d, size_t n) {
  Jpeg j;
  j.begin(d, n, true);
  return j.run();
}

// ------------------------------------------------------------------- BMP

inline uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t le32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
}

// PIL's P -> L: entries past the file's palette are black.
struct Palette {
  uint8_t grey[256] = {0};
};

// A kind PIL's BmpImagePlugin refuses (a header size, bit depth, bitfields
// layout, compression or palette size it does not know) is corrupt here too.
Gray decode_bmp(const uint8_t* d, size_t n) {
  if (n < 18) corrupt("BMP file ends early");
  uint32_t offset = le32(d + 10);
  uint32_t hsize = le32(d + 14);
  if (14 + (size_t)hsize > n) corrupt("BMP header ends early");
  const uint8_t* hd = d + 18;  // the header after its size field
  int64_t w, h;
  int bits, compression, pal_pad;
  bool top_down = false;
  uint32_t colors = 0;
  uint32_t masks[4] = {0, 0, 0, 0};
  if (hsize == 12) {
    w = le16(hd);
    h = le16(hd + 2);
    bits = le16(hd + 6);
    compression = 0;
    pal_pad = 3;
  } else if (hsize == 40 || hsize == 52 || hsize == 56 || hsize == 64 || hsize == 108 ||
             hsize == 124) {
    top_down = hd[7] == 0xFF;
    w = (int32_t)le32(hd);
    uint32_t hh = le32(hd + 4);
    h = top_down ? (int64_t)((uint64_t)1 << 32) - hh : hh;
    bits = le16(hd + 10);
    compression = (int)le32(hd + 12);
    colors = le32(hd + 28);
    pal_pad = 4;
    if (compression == 3) {
      size_t have = hsize - 4;
      if (have >= 48) {
        int k = have >= 52 ? 4 : 3;
        for (int i = 0; i < k; ++i) masks[i] = le32(hd + 36 + 4 * i);
      } else {
        if (14 + (size_t)hsize + 12 > n) corrupt("BMP header ends early");
        for (int i = 0; i < 3; ++i) masks[i] = le32(d + 14 + hsize + 4 * i);
      }
    }
  } else {
    corrupt("BMP header of " + std::to_string(hsize) + " bytes");
  }
  if (colors == 0) colors = 1u << std::min(bits, 31);
  if (offset == 14 + hsize && bits <= 8) offset += 4 * colors;
  if (bits != 1 && bits != 4 && bits != 8 && bits != 16 && bits != 24 && bits != 32)
    corrupt(std::to_string(bits) + "-bit BMP");
  check_size(w, h);
  const int W = (int)w, H = (int)h;

  // Channel layout of 16/24/32-bit pixels: (byte or field) positions of R, G, B.
  enum { kRaw, kRle } decoder = kRaw;
  int layout = 0;  // 15: 555, 16: 565, 24: BGR, 32: one of the 32-bit byte orders
  int order[3] = {2, 1, 0};  // byte index of R, G, B within a 32-bit or 24-bit pixel
  if (compression == 3) {
    if (bits == 32) {
      struct M { uint32_t m[4]; int r, g, b; } known[] = {
          {{0xFF0000, 0xFF00, 0xFF, 0x0}, 2, 1, 0},        // BGRX
          {{0xFF000000, 0xFF0000, 0xFF00, 0x0}, 3, 2, 1},  // XBGR
          {{0xFF000000, 0xFF00, 0xFF, 0x0}, 3, 1, 0},      // BGXR
          {{0xFF000000, 0xFF0000, 0xFF00, 0xFF}, 3, 2, 1}, // ABGR
          {{0xFF, 0xFF00, 0xFF0000, 0xFF000000}, 0, 1, 2}, // RGBA
          {{0xFF0000, 0xFF00, 0xFF, 0xFF000000}, 2, 1, 0}, // BGRA
          {{0xFF000000, 0xFF00, 0xFF, 0xFF0000}, 3, 1, 0}, // BGAR
          {{0x0, 0x0, 0x0, 0x0}, 2, 1, 0}};                // BGRA
      bool found = false;
      for (const M& k : known)
        if (!memcmp(k.m, masks, sizeof masks)) {
          order[0] = k.r;
          order[1] = k.g;
          order[2] = k.b;
          found = true;
          break;
        }
      if (!found) corrupt("BMP bitfields layout");
      layout = 32;
    } else if (bits == 24 && masks[0] == 0xFF0000 && masks[1] == 0xFF00 && masks[2] == 0xFF) {
      layout = 24;
    } else if (bits == 16 && masks[0] == 0xF800 && masks[1] == 0x7E0 && masks[2] == 0x1F) {
      layout = 16;
    } else if (bits == 16 && masks[0] == 0x7C00 && masks[1] == 0x3E0 && masks[2] == 0x1F) {
      layout = 15;
    } else {
      corrupt("BMP bitfields layout");
    }
  } else if (compression == 0) {
    layout = bits == 16 ? 15 : bits;
  } else if (compression == 1 || compression == 2) {
    decoder = kRle;
  } else {
    corrupt("BMP compression " + std::to_string(compression));
  }

  Palette pal;
  if (bits <= 8) {
    if (colors == 0 || colors > 65536) corrupt("BMP palette size");
    size_t pstart = 14 + hsize;
    size_t avail = pstart < n ? std::min((size_t)pal_pad * colors, n - pstart) : 0;
    size_t entries = std::min<size_t>(avail / pal_pad, 256);
    // PIL's grayscale test: a palette of (v, v, v) for v = 0, 1, ... (or 0
    // and 255 for two colours) makes the image "L" (or "1"), whose pixels
    // are the indices themselves, past the palette too.
    bool identity = entries == colors;
    for (size_t i = 0; i < entries; ++i) {
      const uint8_t* e = d + pstart + i * pal_pad;
      int v = colors == 2 ? (i ? 255 : 0) : (int)i;
      identity = identity && e[0] == v && e[1] == v && e[2] == v;
      pal.grey[i] = luma(e[2], e[1], e[0]);
    }
    if (identity)
      for (int i = 0; i < 256; ++i) pal.grey[i] = colors == 2 ? (i ? 255 : 0) : (uint8_t)i;
  }

  if (offset > n) corrupt("BMP pixel data missing");
  const size_t stride = (((size_t)W * bits + 31) >> 3) & ~(size_t)3;
  if (decoder == kRaw && offset + stride * H > n) corrupt("BMP pixel data ends early");
  Gray g;
  g.w = W;
  g.h = H;
  g.px.resize((size_t)W * H);
  if (decoder == kRle) {
    if ((compression == 1 && bits != 8) || (compression == 2 && bits != 4))
      corrupt("BMP RLE with the wrong bit depth");
    // PIL's BmpRleDecoder, rule for rule (file positions count from the file's start).
    bool rle4 = compression == 2;
    std::vector<uint8_t> data;
    size_t dest = (size_t)W * H, p = offset;
    size_t x = 0;
    auto rd = [&](size_t k, std::vector<uint8_t>& out) {
      size_t got = p < n ? std::min(k, n - p) : 0;
      out.assign(d + p, d + p + got);
      p += got;
      return got;
    };
    std::vector<uint8_t> tmp;
    while (data.size() < dest) {
      if (p + 2 > n) break;
      int num = d[p], byte = d[p + 1];
      p += 2;
      if (num) {
        if (x + num > (size_t)W) num = (int)std::max<int64_t>(0, (int64_t)W - (int64_t)x);
        if (rle4) {
          for (int i = 0; i < num; ++i) data.push_back((uint8_t)(i % 2 == 0 ? byte >> 4 : byte & 15));
        } else {
          data.insert(data.end(), num, (uint8_t)byte);
        }
        x += num;
      } else if (byte == 0) {
        while (data.size() % W) data.push_back(0);
        x = 0;
      } else if (byte == 1) {
        break;
      } else if (byte == 2) {
        if (rd(2, tmp) < 2) break;
        if (rd(2, tmp) < 2) corrupt("BMP RLE data ends early");
        size_t right = tmp[0], up = tmp[1];
        data.insert(data.end(), right + up * W, 0);
        x = data.size() % W;
      } else {
        size_t count = rle4 ? byte / 2 : byte;
        size_t got = rd(count, tmp);
        for (uint8_t b : tmp) {
          if (rle4) {
            data.push_back(b >> 4);
            data.push_back(b & 15);
          } else {
            data.push_back(b);
          }
        }
        if (got < count) break;
        x += byte;
        if (p % 2) ++p;
      }
    }
    if (data.size() < dest) corrupt("BMP RLE data ends early");
    for (int y = 0; y < H; ++y) {
      int src = top_down ? y : H - 1 - y;
      for (int xx = 0; xx < W; ++xx) g.px[(size_t)src * W + xx] = pal.grey[data[(size_t)y * W + xx]];
    }
    return g;
  }
  for (int y = 0; y < H; ++y) {
    const uint8_t* r = d + offset + stride * (top_down ? y : H - 1 - y);
    uint8_t* o = &g.px[(size_t)y * W];
    if (bits <= 8) {
      int per = 8 / bits, mask = (1 << bits) - 1;
      for (int x = 0; x < W; ++x) {
        int idx = bits == 8 ? r[x] : (r[x / per] >> (8 - bits * (x % per + 1))) & mask;
        o[x] = pal.grey[idx];
      }
    } else if (layout == 15 || layout == 16) {
      for (int x = 0; x < W; ++x) {
        int v = r[2 * x] | (r[2 * x + 1] << 8);
        int R, G, B;
        if (layout == 15) {
          R = ((v >> 10) & 31) * 255 / 31;
          G = ((v >> 5) & 31) * 255 / 31;
          B = (v & 31) * 255 / 31;
        } else {
          R = ((v >> 11) & 31) * 255 / 31;
          G = ((v >> 5) & 63) * 255 / 63;
          B = (v & 31) * 255 / 31;
        }
        o[x] = luma(R, G, B);
      }
    } else {
      int bpp = bits / 8;
      for (int x = 0; x < W; ++x) {
        const uint8_t* q = r + (size_t)bpp * x;
        o[x] = luma(q[order[0]], q[order[1]], q[order[2]]);
      }
    }
  }
  return g;
}

// ------------------------------------------------------------------ TIFF

struct Tiff {
  const uint8_t* d;
  size_t n;
  bool be = false;
  bool big = false;  // BigTIFF: 8-byte offsets and counts, 20-byte entries

  uint32_t r16(size_t p) const {
    if (p + 2 > n) corrupt("TIFF file ends early");
    return be ? (d[p] << 8) | d[p + 1] : d[p] | (d[p + 1] << 8);
  }
  uint32_t r32(size_t p) const {
    if (p + 4 > n) corrupt("TIFF file ends early");
    return be ? ((uint32_t)d[p] << 24) | ((uint32_t)d[p + 1] << 16) | ((uint32_t)d[p + 2] << 8) | d[p + 3]
              : (uint32_t)d[p] | ((uint32_t)d[p + 1] << 8) | ((uint32_t)d[p + 2] << 16) |
                    ((uint32_t)d[p + 3] << 24);
  }
  uint64_t r64(size_t p) const {
    const uint64_t a = r32(p), b = r32(p + 4);
    return be ? a << 32 | b : b << 32 | a;
  }
  size_t offset(size_t p) const { return big ? (size_t)r64(p) : r32(p); }

  // The bytes of a value of a field type (libtiff's TIFFDataWidth), 0 for
  // a type TIFF does not define.
  static int type_size(uint32_t type) {
    switch (type) {
      case 1: case 2: case 6: case 7: return 1;
      case 3: case 8: return 2;
      case 4: case 9: case 11: case 13: return 4;
      case 5: case 10: case 12: case 16: case 17: case 18: return 8;
      default: return 0;
    }
  }
  // An IFD entry (12 bytes, or 20 in a BigTIFF): its tag, field type, value
  // count and where its values lie, in the entry's value field when they
  // fit it; `fits`: a defined type whose values lie inside the file.
  struct Entry {
    uint32_t tag = 0, type = 0;
    uint64_t count = 0;
    size_t at = 0;
    bool fits = false;
  };
  Entry entry(size_t e) const {
    Entry x;
    x.tag = r16(e);
    x.type = r16(e + 2);
    x.count = big ? r64(e + 4) : r32(e + 4);
    const int size = type_size(x.type);
    if (size == 0) return x;
    const size_t field = e + (big ? 12 : 8), slot = big ? 8 : 4;
    x.at = x.count <= slot / size ? field : offset(field);
    x.fits = x.count <= (1u << 28) && x.at <= n && x.count * size <= n - x.at;
    return x;
  }
  // Value i of an entry of a defined type, as a number.
  double number(const Entry& x, uint64_t i) const {
    const size_t p = x.at + (size_t)i * type_size(x.type);
    switch (x.type) {
      case 1: case 2: case 7: return d[p];
      case 6: return (int8_t)d[p];
      case 3: return r16(p);
      case 8: return (int16_t)r16(p);
      case 4: case 13: return r32(p);
      case 9: return (int32_t)r32(p);
      case 5: case 10: {
        const uint32_t num = r32(p), den = r32(p + 4);
        const double a = x.type == 5 ? (double)num : (double)(int32_t)num;
        const double b = x.type == 5 ? (double)den : (double)(int32_t)den;
        return b != 0 ? a / b : std::nan("");
      }
      case 11: {
        const uint32_t u = r32(p);
        float f;
        memcpy(&f, &u, sizeof f);
        return f;
      }
      case 12: {
        const uint64_t u = r64(p);
        double f;
        memcpy(&f, &u, sizeof f);
        return f;
      }
      case 17: return (double)(int64_t)r64(p);
      default: return (double)r64(p);  // LONG8, IFD8
    }
  }
  // An entry's values as unsigned 32-bit integers (a value past that, or
  // not whole, is a bad tag); the first `limit` of them.
  std::vector<uint32_t> values(size_t e, uint64_t limit = ~0ull) const {
    Entry x = entry(e);
    if (x.count > limit && type_size(x.type)) {
      const uint64_t size = type_size(x.type);
      x.count = limit;
      x.fits = x.at <= n && limit * size <= n - x.at;
    }
    if (!x.fits) corrupt(type_size(x.type) ? "TIFF tag data outside the file" : "bad TIFF tag");
    std::vector<uint32_t> out(x.count);
    for (uint64_t i = 0; i < x.count; ++i) {
      const double v = number(x, i);
      if (!(v >= 0 && v <= 4294967295.0) || v != std::floor(v)) corrupt("bad TIFF tag");
      out[i] = (uint32_t)v;
    }
    return out;
  }
  // A RATIONAL entry's values as libtiff reads them into floats (0 for a
  // zero denominator).
  std::vector<float> rationals(size_t e) const {
    const Entry x = entry(e);
    if (x.type != 5 || x.count > 64 || !x.fits) corrupt("bad TIFF tag");
    std::vector<float> out(x.count);
    for (uint32_t i = 0; i < x.count; ++i) {
      const uint32_t num = r32(x.at + 8 * i), den = r32(x.at + 8 * i + 4);
      out[i] = den ? (float)num / (float)den : 0.0f;
    }
    return out;
  }
  // An IFD entry's data as bytes: (file offset, byte count).
  std::pair<size_t, size_t> bytes(size_t e) const {
    const Entry x = entry(e);
    if ((x.type != 1 && x.type != 7) || !x.fits) corrupt("bad TIFF tag");
    return {x.at, (size_t)x.count};
  }
};

// The codecs below decode into `out`, which keeps what they decoded when
// they fail (libtiff's RGBA reader reads on from such a strip).
void packbits(const uint8_t* s, size_t n, size_t want, std::vector<uint8_t>& out) {
  out.clear();
  out.reserve(want);
  size_t p = 0;
  while (out.size() < want && p < n) {  // libtiff's PackBitsDecode: a run cut to the output first
    int c = (int8_t)s[p++];
    if (c >= 0) {
      const size_t k = std::min((size_t)c + 1, want - out.size());
      if (p + k > n) corrupt("PackBits data ends early");
      out.insert(out.end(), s + p, s + p + k);
      p += k;
    } else if (c != -128) {
      if (p >= n) corrupt("PackBits data ends early");
      out.insert(out.end(), std::min((size_t)(1 - c), want - out.size()), s[p++]);
    }
  }
  if (out.size() < want) corrupt("PackBits data ends early");
  out.resize(want);
}

void lzw(const uint8_t* s, size_t n, size_t want, std::vector<uint8_t>& out) {
  out.clear();
  out.reserve(want);
  std::vector<uint16_t> prefix(4096);
  std::vector<uint8_t> suffix(4096), first(4096);
  std::vector<uint16_t> length(4096);
  for (int i = 0; i < 256; ++i) {
    suffix[i] = first[i] = (uint8_t)i;
    length[i] = 1;
  }
  std::vector<uint8_t> str;
  size_t bitpos = 0;
  int nbits = 9, next = 258, old = -1;
  auto read = [&]() -> int {
    if (bitpos + nbits > n * 8) return 257;  // end of data: as if EOI
    int v = 0;
    for (int i = 0; i < nbits; ++i, ++bitpos) v = (v << 1) | ((s[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
    return v;
  };
  auto emit = [&](int code) {
    size_t l = length[code];
    size_t at = out.size();
    out.resize(at + l);
    for (int c = code; l > 0; c = prefix[c]) out[at + --l] = suffix[c];
  };
  while (out.size() < want) {
    int code = read();
    if (code == 257) break;
    if (code == 256) {
      nbits = 9;
      next = 258;
      code = read();
      if (code == 257) break;
      if (code > 255) corrupt("bad TIFF LZW code");
      emit(code);
      old = code;
      continue;
    }
    if (old < 0) corrupt("TIFF LZW data does not start with a clear code");
    if (code < next) {
      emit(code);
      if (next < 4096) {
        prefix[next] = (uint16_t)old;
        suffix[next] = first[code];
        first[next] = first[old];
        length[next] = (uint16_t)(length[old] + 1);
        ++next;
      }
    } else if (code == next && next < 4096) {
      prefix[next] = (uint16_t)old;
      suffix[next] = first[old];
      first[next] = first[old];
      length[next] = (uint16_t)(length[old] + 1);
      ++next;
      emit(code);
    } else {
      corrupt("bad TIFF LZW code");
    }
    old = code;
    if (next > (1 << nbits) - 2 && nbits < 12) ++nbits;
  }
  if (out.size() < want) corrupt("TIFF LZW data ends early");
  out.resize(want);
}

// Old-style LZW, as libtiff's LZWDecodeCompat (tif_lzw.c, LZW_COMPAT) reads
// it: codes LSB first, the width one bit more once the next free entry
// passes 2^width - 1 (one code later than new-style), up to 12 bits, and a
// table of 5119 entries (past 4095 unreachable: the entries are still made,
// and one past the last is a corrupt table). A strip ends at EOI, where its
// bytes cannot give another code, or once it is full; a code past the next
// free entry, a first code that is no clear code, or a clear code followed
// by one past 256 are corrupt. `out` keeps what was decoded.
void lzw_compat(const uint8_t* s, size_t n, size_t want, std::vector<uint8_t>& out) {
  struct Entry {
    int32_t next;  // -1: none
    uint16_t length;
    uint8_t value, first;
  };
  constexpr int kSize = 4095 + 1024;
  std::vector<Entry> tab(kSize, Entry{-1, 0, 0, 0});
  for (int i = 0; i < 256; ++i) tab[i] = Entry{-1, 1, (uint8_t)i, (uint8_t)i};
  out.clear();
  out.reserve(want);
  size_t left = n * 8, at = 0;  // the strip's bits not yet taken
  uint64_t data = 0;
  int have = 0, nbits = 9, free = 258, old = -1;
  auto next_code = [&]() -> int {
    if (left < (size_t)nbits) return 257;  // not terminated with EOI
    data |= (uint64_t)s[at++] << have;
    have += 8;
    if (have < nbits) {
      data |= (uint64_t)s[at++] << have;
      have += 8;
    }
    const int code = (int)(data & ((1u << nbits) - 1));
    data >>= nbits;
    have -= nbits;
    left -= nbits;
    return code;
  };
  while (out.size() < want) {
    int code = next_code();
    if (code == 257) break;
    if (code == 256) {
      do {
        std::fill(tab.begin() + 258, tab.end(), Entry{-1, 0, 0, 0});
        free = 258;
        nbits = 9;
        code = next_code();
      } while (code == 256);
      if (code == 257) break;
      if (code > 256) corrupt("bad old-style TIFF LZW code after a clear code");
      out.push_back((uint8_t)code);
      old = code;
      continue;
    }
    if (free >= kSize) corrupt("old-style TIFF LZW table overflows");
    if (old < 0) corrupt("old-style TIFF LZW data does not start with a clear code");
    Entry& e = tab[free];
    e.next = old;
    e.first = tab[old].first;
    e.length = (uint16_t)(tab[old].length + 1);
    e.value = code < free ? tab[code].first : e.first;
    if (++free > (1 << nbits) - 1 && nbits < 12) ++nbits;
    old = code;
    if (code < 256) {
      out.push_back((uint8_t)code);
      continue;
    }
    const size_t len = tab[code].length;
    if (len == 0) corrupt("bad old-style TIFF LZW code");
    const size_t k = std::min(len, want - out.size()), base = out.size();
    int c = code;
    for (size_t l = len; l > k; --l) c = tab[c].next;  // a string past the strip: its start
    out.resize(base + k);
    for (size_t i = k; i > 0; --i, c = tab[c].next) out[base + i - 1] = tab[c].value;
  }
  if (out.size() < want) corrupt("old-style TIFF LZW data ends early");
}

// ---------------------------------------------------------------- inflate
// A zlib stream (RFC 1950 header, RFC 1951 stored, fixed- and dynamic-
// Huffman blocks) inflated into `want` bytes, as libtiff's ZIP codec asks
// zlib for a strip: a stream that ends short is corrupt; once the strip is
// whole zlib reads on as far as it can without room for output (block
// headers and tables, a match's length and distance codes, and after the
// last block the Adler-32 of the output), so an error there is corrupt too;
// a distance past the output it checks only with room to copy.

// Canonical Huffman codes of up to 15 bits, read LSB first: a 10-bit table
// of (length << 9 | symbol), 0 for a longer code, then puff's count walk.
struct InflateCodes {
  static constexpr int kFast = 10;
  uint16_t fast[1 << kFast];
  uint16_t count[16];
  uint16_t symbol[288];

  // zlib's rules: an over-subscribed set is an error, and so is an
  // incomplete one unless it is a set of `lengths` (literal/length or
  // distance codes) with a single code of length 1, or `allow_empty`
  // distances with no code at all.
  void build(const uint8_t* lens, int n, bool lengths, bool allow_empty) {
    std::fill(count, count + 16, 0);
    for (int i = 0; i < n; ++i) ++count[lens[i]];
    int left = 1, codes = n - count[0];
    for (int l = 1; l <= 15; ++l) {
      left = (left << 1) - count[l];
      if (left < 0) corrupt("bad Deflate code lengths (over-subscribed)");
    }
    if (left > 0 && !(lengths && codes == 1 && count[1] == 1) && !(codes == 0 && allow_empty))
      corrupt("bad Deflate code lengths (incomplete)");
    uint16_t offs[16];
    offs[1] = 0;
    for (int l = 1; l < 15; ++l) offs[l + 1] = offs[l] + count[l];
    for (int i = 0; i < n; ++i)
      if (lens[i]) symbol[offs[lens[i]]++] = (uint16_t)i;
    std::fill(fast, fast + (1 << kFast), 0);
    int code = 0, k = 0;
    for (int l = 1; l <= kFast; ++l) {
      for (int i = 0; i < count[l]; ++i, ++code, ++k) {
        int rev = 0;  // the code's bits as the stream holds them, first bit lowest
        for (int b = 0; b < l; ++b) rev |= ((code >> b) & 1) << (l - 1 - b);
        for (int j = rev; j < (1 << kFast); j += 1 << l) fast[j] = (uint16_t)((l << 9) | symbol[k]);
      }
      code <<= 1;
    }
  }
};

// Thrown where the input runs out once the output is whole: zlib stops there
// and libtiff has its strip.
struct InflateEnd {};

struct InflateBits {
  const uint8_t* s;
  size_t n, pos = 0;
  uint64_t buf = 0;
  int cnt = 0;
  const size_t* done = nullptr;  // the output so far, and all of it
  size_t whole = 0;

  [[noreturn]] void out_of_data() const {
    if (done && *done == whole) throw InflateEnd{};
    corrupt("Deflate data ends early");
  }

  inline void refill() {
    while (cnt <= 56 && pos < n) {
      buf |= (uint64_t)s[pos++] << cnt;
      cnt += 8;
    }
  }
  inline void drop(int k) {
    if (k > cnt) out_of_data();
    buf >>= k;
    cnt -= k;
  }
  inline int get(int k) {  // k <= 32
    if (cnt < k) refill();
    int v = (int)(buf & ((1ull << k) - 1));
    drop(k);
    return v;
  }
  inline int decode(const InflateCodes& h) {
    if (cnt < 15) refill();
    uint16_t e = h.fast[buf & ((1u << InflateCodes::kFast) - 1)];
    if (e) {
      drop(e >> 9);
      return e & 511;
    }
    int code = 0, first = 0, index = 0;
    for (int l = 1; l <= 15; ++l) {
      code |= (int)((buf >> (l - 1)) & 1);
      int c = h.count[l];
      if (code - c < first) {
        drop(l);
        return h.symbol[index + (code - first)];
      }
      index += c;
      first = (first + c) << 1;
      code <<= 1;
    }
    if (cnt < 15) out_of_data();
    corrupt("bad Deflate code");
  }
};

// zlib's Adler-32; 16 bytes a step (their sum, and their sum weighted 16
// .. 1 for b), within zlib's NMAX bytes between the modulo reductions.
uint32_t adler32(const uint8_t* p, size_t n) {
  typedef uint8_t U8x16 __attribute__((vector_size(16)));
  typedef uint16_t U16x16 __attribute__((vector_size(32)));
  typedef uint32_t U32x16 __attribute__((vector_size(64)));
  const U16x16 weight = {16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1};
  uint64_t a = 1, b = 0;
  while (n) {
    size_t k = std::min<size_t>(n, 5552 / 16 * 16);
    n -= k;
    U32x16 weighted = {};
    for (; k >= 16; k -= 16, p += 16) {
      U8x16 x;
      memcpy(&x, p, sizeof x);
      const U16x16 y = __builtin_convertvector(x, U16x16);
      uint32_t sum = 0;
      for (int i = 0; i < 16; ++i) sum += y[i];
      b += 16 * a;
      a += sum;
      weighted += __builtin_convertvector(y * weight, U32x16);
    }
    for (int i = 0; i < 16; ++i) b += weighted[i] % 65521;
    for (; k; --k) {
      a += *p++;
      b += a;
    }
    a %= 65521;
    b %= 65521;
  }
  return (uint32_t)(b << 16 | a);
}

void inflate_zlib(const uint8_t* s, size_t n, size_t want, std::vector<uint8_t>& out) {
  static const uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
                                        31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
  static const uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                        2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
  static const uint16_t kDistBase[30] = {1,    2,    3,    4,    5,    7,     9,     13,    17,  25,
                                         33,   49,   65,   97,   129,  193,   257,   385,   513, 769,
                                         1025, 1537, 2049, 3073, 4097, 6145,  8193, 12289, 16385, 24577};
  static const uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                         6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
  static const uint8_t kOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};
  out.clear();
  if (n < 2) corrupt("Deflate data ends early");
  if ((s[0] & 15) != 8 || (s[0] >> 4) > 7 || ((s[0] << 8) | s[1]) % 31 != 0)
    corrupt("bad zlib header");
  if (s[1] & 0x20) corrupt("zlib stream needs a preset dictionary");
  out.assign(want, 0);
  size_t at = 0;
  InflateBits b{s + 2, n - 2};
  b.done = &at;
  b.whole = want;
  InflateCodes lit, dist;
  try {
    for (bool last = false; !last;) {
      last = b.get(1);
      const int type = b.get(2);
      if (type == 0) {  // stored: LEN, NLEN from the next byte boundary
        b.drop(b.cnt & 7);
        const int len = b.get(16), nlen = b.get(16);
        if (len != (~nlen & 0xFFFF)) corrupt("bad Deflate stored block length");
        size_t left = len;
        while (left > 0 && at < want) {
          if (b.cnt > 0) {  // whole bytes still in the bit buffer
            out[at++] = (uint8_t)b.get(8);
            --left;
            continue;
          }
          const size_t k = std::min({left, want - at, b.n - b.pos});
          if (k == 0) corrupt("Deflate data ends early");
          memcpy(&out[at], b.s + b.pos, k);
          b.pos += k;
          at += k;
          left -= k;
        }
        if (left > 0) return;  // the rest waits for room
        continue;
      }
      if (type == 3) corrupt("bad Deflate block type");
      uint8_t lens[320];
      int nlit = 288, ndist = 32;
      if (type == 1) {
        std::fill(lens, lens + 144, 8);
        std::fill(lens + 144, lens + 256, 9);
        std::fill(lens + 256, lens + 280, 7);
        std::fill(lens + 280, lens + 288, 8);
        std::fill(lens + 288, lens + 320, 5);
      } else {
        nlit = b.get(5) + 257;
        ndist = b.get(5) + 1;
        const int ncode = b.get(4) + 4;
        if (nlit > 286 || ndist > 30) corrupt("bad Deflate code counts");
        uint8_t cl[19] = {0};
        for (int i = 0; i < ncode; ++i) cl[kOrder[i]] = (uint8_t)b.get(3);
        InflateCodes clh;
        clh.build(cl, 19, false, false);
        for (int i = 0; i < nlit + ndist;) {
          int sym = b.decode(clh);
          if (sym < 16) {
            lens[i++] = (uint8_t)sym;
            continue;
          }
          int rep, v = 0;
          if (sym == 16) {
            if (i == 0) corrupt("bad Deflate code lengths (repeat with no previous)");
            v = lens[i - 1];
            rep = 3 + b.get(2);
          } else {
            rep = sym == 17 ? 3 + b.get(3) : 11 + b.get(7);
          }
          if (i + rep > nlit + ndist) corrupt("bad Deflate code lengths (too many)");
          std::fill(lens + i, lens + i + rep, (uint8_t)v);
          i += rep;
        }
        if (lens[256] == 0) corrupt("Deflate block has no end-of-block code");
      }
      lit.build(lens, nlit, true, false);
      dist.build(lens + nlit, ndist, true, true);
      for (;;) {
        int sym = b.decode(lit);
        if (sym < 256) {
          if (at == want) return;  // a literal waits for room
          out[at++] = (uint8_t)sym;
          continue;
        }
        if (sym == 256) break;
        sym -= 257;
        if (sym >= 29) corrupt("bad Deflate length code");
        size_t len = kLenBase[sym] + b.get(kLenExtra[sym]);
        int ds = b.decode(dist);
        if (ds >= 30) corrupt("bad Deflate distance code");
        size_t back = kDistBase[ds] + b.get(kDistExtra[ds]);
        if (at == want) return;  // zlib checks a match's distance once it has room to copy
        if (back > at) corrupt("Deflate distance too far back");
        const bool room = len <= want - at;  // else the rest of the match waits for it
        len = std::min(len, want - at);
        uint8_t* o = &out[at];
        if (back >= len) {
          memcpy(o, o - back, len);
        } else {
          for (size_t i = 0; i < len; ++i) o[i] = o[i - back];
        }
        at += len;
        if (!room) return;
      }
    }
    if (at < want) corrupt("Deflate data ends early");
    b.drop(b.cnt & 7);
    uint32_t check = 0;
    for (int i = 0; i < 4; ++i) check = check << 8 | (uint32_t)b.get(8);
    if (check != adler32(out.data(), want)) corrupt("Deflate data check (Adler-32) fails");
  } catch (const InflateEnd&) {
  } catch (const DecodeError&) {
    if (at < want) out.resize(at);
    throw;
  }
}

// -------------------------------------------------------------------- xz
// LZMA TIFF (compression 34925) as libtiff's LZMADecode reads it for PIL:
// each strip one .xz stream (the xz project's xz-file-format 1.2), decoded
// as liblzma's stream decoder decodes it until the strip is full. What
// lies past the data that fills the strip (the rest of a block, its check,
// the index, the footer, a second stream) is not read; a stream that ends
// or fails before then fails the strip, as libtiff reports it, and PIL
// refuses the file. The filters are LZMA2 (the LZMA SDK's
// lzma-specification for its LZMA chunks), Delta and the BCJ filters of
// x86, PowerPC, IA-64, ARM, ARM-Thumb and SPARC; the checks None, CRC32,
// CRC64 and SHA-256, verified where a block ends before the strip is full.

uint32_t crc32_of(const uint8_t* p, size_t n, uint32_t c = 0) {
  static const auto table = [] {
    std::vector<uint32_t> t(256);
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t v = i;
      for (int k = 0; k < 8; ++k) v = v & 1 ? 0xEDB88320u ^ (v >> 1) : v >> 1;
      t[i] = v;
    }
    return t;
  }();
  c = ~c;
  for (size_t i = 0; i < n; ++i) c = table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return ~c;
}

uint64_t crc64_of(const uint8_t* p, size_t n, uint64_t c = 0) {
  static const auto table = [] {
    std::vector<uint64_t> t(256);
    for (uint64_t i = 0; i < 256; ++i) {
      uint64_t v = i;
      for (int k = 0; k < 8; ++k) v = v & 1 ? 0xC96C5795D7870F42ull ^ (v >> 1) : v >> 1;
      t[i] = v;
    }
    return t;
  }();
  c = ~c;
  for (size_t i = 0; i < n; ++i) c = table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return ~c;
}

// FIPS 180-4's SHA-256 of p[0 .. n).
void sha256_of(const uint8_t* p, size_t n, uint8_t digest[32]) {
  static const uint32_t K[64] = {
      0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
      0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174,
      0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
      0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967,
      0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
      0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
      0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
      0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208, 0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};
  uint32_t h[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                   0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  auto rotr = [](uint32_t x, int k) { return (x >> k) | (x << (32 - k)); };
  std::vector<uint8_t> m(p, p + n);
  m.push_back(0x80);
  while (m.size() % 64 != 56) m.push_back(0);
  for (int i = 7; i >= 0; --i) m.push_back((uint8_t)((uint64_t)n * 8 >> (8 * i)));
  for (size_t at = 0; at < m.size(); at += 64) {
    uint32_t w[64];
    for (int i = 0; i < 16; ++i)
      w[i] = (uint32_t)m[at + 4 * i] << 24 | m[at + 4 * i + 1] << 16 | m[at + 4 * i + 2] << 8 | m[at + 4 * i + 3];
    for (int i = 16; i < 64; ++i) {
      const uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
      const uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5], g = h[6], k = h[7];
    for (int i = 0; i < 64; ++i) {
      const uint32_t t1 = k + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) + ((e & f) ^ (~e & g)) + K[i] + w[i];
      const uint32_t t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) + ((a & b) ^ (a & c) ^ (b & c));
      k = g;
      g = f;
      f = e;
      e = d + t1;
      d = c;
      c = b;
      b = a;
      a = t1 + t2;
    }
    const uint32_t v[8] = {a, b, c, d, e, f, g, k};
    for (int i = 0; i < 8; ++i) h[i] += v[i];
  }
  for (int i = 0; i < 32; ++i) digest[i] = (uint8_t)(h[i / 4] >> (24 - 8 * (i % 4)));
}

[[noreturn]] void xz_error(const char* what) { corrupt(std::string("LZMA TIFF strip: ") + what); }

// A stage of a block's filter chain as liblzma runs it: asked to fill
// out[*pos .. size), it returns true at the end of the block's data.
struct XzCoder {
  virtual ~XzCoder() = default;
  virtual bool code(uint8_t* out, size_t& pos, size_t size) = 0;
};

// LZMA2 (lzma2_decoder.c over lzma_decoder.c): chunks of LZMA data or of
// bytes as they are, the dictionary its history since its last reset.
// Distances reach back no further than that reset and the dictionary size
// of the filter's properties, whatever the strip already holds.
struct Lzma2 final : XzCoder {
  const uint8_t* in;
  size_t n, at = 0;
  uint64_t dict_size;
  std::vector<uint8_t> hist;  // everything decoded, for the matches
  size_t reset_at = 0;        // where the dictionary was last reset
  size_t copied = 0;          // of hist, handed on
  bool need_dict = true, need_props = true, ended = false;
  bool exhausted = false;  // the input ran out: liblzma waits for more
  bool stalled = false;    // ... inside a symbol it decoded past a full strip
  int lc = 0, lp = 0, pb = 0;
  // the chunk in progress
  enum { kControl, kHeader, kLzma, kRaw } mode = kControl;
  uint8_t ctl = 0;  // the chunk's control byte
  size_t chunk_left = 0;  // its uncompressed bytes to come
  size_t comp_end = 0;    // where its compressed bytes should end
  // range decoder
  uint32_t range = 0, rcode = 0;
  // LZMA state
  uint32_t state = 0, rep[4] = {0, 0, 0, 0};
  size_t pending = 0;  // match bytes still to copy
  std::vector<uint16_t> probs;
  enum : size_t {
    kIsMatch = 0, kIsRep = 192, kIsRepG0 = 204, kIsRepG1 = 216, kIsRepG2 = 228, kIsRep0Long = 240,
    kPosSlot = 432, kSpecPos = 688, kAlign = 802, kLenCoder = 818, kRepLenCoder = 1332, kLiteral = 1846
  };

  Lzma2(const uint8_t* s, size_t cnt, uint64_t dict) : in(s), n(cnt), dict_size(dict) {}

  uint8_t byte() {
    if (at >= n) {
      exhausted = true;
      xz_error("data ends early");
    }
    return in[at++];
  }
  void normalize() {
    if (range < (1u << 24)) {
      if (at >= n) {
        exhausted = true;
        xz_error("data ends early");
      }
      range <<= 8;
      rcode = rcode << 8 | in[at++];
    }
  }
  int bit(uint16_t& p) {
    normalize();
    const uint32_t bound = (range >> 11) * p;
    if (rcode < bound) {
      range = bound;
      p = (uint16_t)(p + ((2048 - p) >> 5));
      return 0;
    }
    range -= bound;
    rcode -= bound;
    p = (uint16_t)(p - (p >> 5));
    return 1;
  }
  uint32_t tree(size_t base, int bits) {
    uint32_t m = 1;
    for (int i = 0; i < bits; ++i) m = (m << 1) | (uint32_t)bit(probs[base + m]);
    return m - (1u << bits);
  }
  uint32_t reverse_tree(size_t base, int bits) {
    uint32_t m = 1, v = 0;
    for (int i = 0; i < bits; ++i) {
      const int b = bit(probs[base + m]);
      m = (m << 1) | (uint32_t)b;
      v |= (uint32_t)b << i;
    }
    return v;
  }
  uint32_t length(size_t base, uint32_t pos_state) {
    if (!bit(probs[base])) return tree(base + 2 + (pos_state << 3), 3);
    if (!bit(probs[base + 1])) return 8 + tree(base + 130 + (pos_state << 3), 3);
    return 16 + tree(base + 258, 8);
  }
  void reset_state() {
    probs.assign(kLiteral + ((size_t)0x300 << (lc + lp)), 1024);
    state = 0;
    rep[0] = rep[1] = rep[2] = rep[3] = 0;
  }
  size_t full() const { return std::min<size_t>(hist.size() - reset_at, dict_size); }
  // One LZMA symbol into hist (a match's bytes to `pending`).
  void symbol() {
    const size_t pos = hist.size() - reset_at;
    const uint32_t ps = (uint32_t)(pos & ((1u << pb) - 1));
    if (!bit(probs[kIsMatch + (state << 4) + ps])) {
      const uint8_t prev = hist.size() > reset_at ? hist.back() : 0;
      const size_t lit = kLiteral + 0x300 * ((((pos & ((1u << lp) - 1)) << lc)) + (prev >> (8 - lc)));
      uint32_t sym = 1;
      if (state >= 7) {
        uint32_t match = hist[hist.size() - rep[0] - 1];
        do {
          const uint32_t mb = (match >> 7) & 1;
          match <<= 1;
          const int b = bit(probs[lit + 0x100 + (mb << 8) + sym]);
          sym = (sym << 1) | (uint32_t)b;
          if ((uint32_t)b != mb) break;
        } while (sym < 0x100);
      }
      while (sym < 0x100) sym = (sym << 1) | (uint32_t)bit(probs[lit + sym]);
      hist.push_back((uint8_t)sym);
      state = state < 4 ? 0 : state < 10 ? state - 3 : state - 6;
      --chunk_left;
      return;
    }
    uint32_t len;
    if (bit(probs[kIsRep + state])) {
      if (full() == 0) xz_error("repeated match before any data");
      if (!bit(probs[kIsRepG0 + state])) {
        if (!bit(probs[kIsRep0Long + (state << 4) + ps])) {  // a short rep: one byte at rep0
          state = state < 7 ? 9 : 11;
          hist.push_back(hist[hist.size() - rep[0] - 1]);
          --chunk_left;
          return;
        }
      } else {
        uint32_t d;
        if (!bit(probs[kIsRepG1 + state])) {
          d = rep[1];
        } else {
          if (!bit(probs[kIsRepG2 + state])) {
            d = rep[2];
          } else {
            d = rep[3];
            rep[3] = rep[2];
          }
          rep[2] = rep[1];
        }
        rep[1] = rep[0];
        rep[0] = d;
      }
      len = length(kRepLenCoder, ps);
      state = state < 7 ? 8 : 11;
    } else {
      rep[3] = rep[2];
      rep[2] = rep[1];
      rep[1] = rep[0];
      len = length(kLenCoder, ps);
      state = state < 7 ? 7 : 10;
      const uint32_t slot = tree(kPosSlot + (std::min<uint32_t>(len, 3) << 6), 6);
      uint32_t dist;
      if (slot < 4) {
        dist = slot;
      } else {
        const int direct = (int)(slot >> 1) - 1;
        dist = 2 | (slot & 1);
        if (slot < 14) {
          dist <<= direct;
          dist += reverse_tree(kSpecPos + dist - slot - 1, direct);
        } else {
          for (int i = 0; i < direct - 4; ++i) {
            normalize();
            range >>= 1;
            rcode -= range;
            const uint32_t t = 0u - (rcode >> 31);
            rcode += range & t;
            dist = (dist << 1) + (t + 1);
          }
          dist = (dist << 4) + reverse_tree(kAlign, 4);
        }
      }
      if (dist == 0xFFFFFFFFu) xz_error("end marker in an LZMA2 chunk");
      rep[0] = dist;
    }
    if (rep[0] >= full()) xz_error("match distance past the dictionary");
    pending = len + 2;
  }
  void copy_pending(size_t limit) {
    while (pending && chunk_left && hist.size() < limit) {
      hist.push_back(hist[hist.size() - rep[0] - 1]);
      --pending;
      --chunk_left;
    }
  }
  // Decode into hist until it holds `limit` bytes or the data ends. As
  // lzma2_decoder.c, it reads on from a chunk's end while there is input,
  // the strip full or not: the next control byte, and unless that resets
  // the dictionary the chunk's header and its range coder's first bytes.
  void run(size_t limit) {
    while (!ended) {
      if (mode == kControl) {
        if (hist.size() >= limit && at >= n) break;
        ctl = byte();
        if (ctl == 0) {
          ended = true;
          break;
        }
        if (ctl >= 0xE0 || ctl == 1) {
          need_props = true;
          need_dict = true;
        } else if (need_dict) {
          xz_error("LZMA2 data without a dictionary reset");
        }
        if (ctl >= 0x80) {
          if (ctl < 0xC0 && need_props) xz_error("LZMA2 chunk without properties");
        } else if (ctl > 2) {
          xz_error("bad LZMA2 control byte");
        }
        mode = kHeader;
        if (need_dict) {
          need_dict = false;
          reset_at = hist.size();
          if (hist.size() >= limit) break;
        }
        continue;
      }
      if (mode == kHeader) {
        const uint8_t c = ctl;
        if (c >= 0x80) {
          chunk_left = ((size_t)(c & 0x1F) << 16) + ((size_t)byte() << 8);
          chunk_left += byte() + 1u;
          size_t comp = (size_t)byte() << 8;
          comp += byte() + 1u;
          if (c >= 0xC0) {
            const uint8_t p = byte();
            if (p > (4 * 5 + 4) * 9 + 8) xz_error("bad LZMA properties");
            pb = p / 45;
            lp = p % 45 / 9;
            lc = p % 9;
            if (lc + lp > 4) xz_error("LZMA2 literal bits past 4");
            need_props = false;
            reset_state();
          } else if (c >= 0xA0) {
            reset_state();
          }
          comp_end = at + comp;
          range = 0xFFFFFFFFu;
          rcode = 0;
          if (byte() != 0) xz_error("LZMA range coder's first byte not 0");
          for (int i = 0; i < 4; ++i) rcode = rcode << 8 | byte();
          mode = kLzma;
        } else {
          chunk_left = (size_t)byte() << 8;
          chunk_left += byte() + 1u;
          mode = kRaw;
        }
        continue;
      }
      if (hist.size() >= limit) break;
      if (mode == kRaw) {
        const size_t k = std::min(chunk_left, limit - hist.size()), have = std::min(k, n - at);
        hist.insert(hist.end(), in + at, in + at + have);
        at += have;
        chunk_left -= have;
        if (have < k) xz_error("data ends early");
        if (!chunk_left) mode = kControl;
        continue;
      }
      if (stalled) break;
      copy_pending(limit);
      while (chunk_left && hist.size() < limit) {
        symbol();
        copy_pending(limit);
      }
      // At a full strip inside a chunk, liblzma's LZMA decoder decodes the
      // next symbol before it finds no room for it (its literal, short
      // rep or match waits for the next call); the input running out
      // inside it is no error.
      if (chunk_left && !pending && hist.size() == limit) {
        try {
          symbol();
        } catch (const DecodeError&) {
          if (!exhausted) throw;
          stalled = true;
          break;
        }
      }
      if (at > comp_end) xz_error("LZMA chunk reads past its compressed size");
      if (!chunk_left) {  // the chunk is whole: its range coder done and its bytes all read
        if (pending) xz_error("LZMA match past its chunk");
        normalize();
        if (rcode != 0 || at != comp_end) xz_error("LZMA chunk ends badly");
        mode = kControl;
      }
    }
  }
  // What run decoded goes out, also ahead of its error (lz_decoder.c).
  bool code(uint8_t* out, size_t& pos, size_t size) override {
    auto flush = [&] {
      const size_t k = std::min(hist.size() - copied, size - pos);
      std::memcpy(out + pos, hist.data() + copied, k);
      copied += k;
      pos += k;
    };
    try {
      run(copied + (size - pos));
    } catch (const DecodeError&) {
      flush();
      throw;
    }
    flush();
    return ended && copied == hist.size();
  }
};

// Delta (delta_decoder.c): each byte plus the byte `distance` before it.
struct XzDelta final : XzCoder {
  std::unique_ptr<XzCoder> next;
  size_t distance;
  uint8_t history[256] = {0};
  uint8_t p = 0;
  bool code(uint8_t* out, size_t& pos, size_t size) override {
    const size_t from = pos;
    auto decode = [&] {  // also ahead of an error below it in the chain
      for (size_t i = from; i < pos; ++i) {
        out[i] = (uint8_t)(out[i] + history[(uint8_t)(distance + p)]);
        history[p--] = out[i];
      }
    };
    bool end;
    try {
      end = next->code(out, pos, size);
    } catch (const DecodeError&) {
      decode();
      throw;
    }
    decode();
    return end;
  }
};

// The BCJ filters (liblzma's simple/*.c, decoding): branch targets from
// absolute back to relative. Each converts what it can decide and leaves
// the last few bytes, which an instruction may still span.
size_t bcj_x86(uint32_t now, uint8_t* b, size_t size, uint32_t& prev_mask, uint32_t& prev_pos) {
  static const bool allowed[8] = {true, true, true, false, true, false, false, false};
  static const uint32_t bit_number[8] = {0, 1, 2, 2, 3, 3, 3, 3};
  auto ms = [](uint8_t v) { return v == 0 || v == 0xFF; };
  if (size < 5) return 0;
  if (now - prev_pos > 5) prev_pos = now - 5;
  const size_t limit = size - 5;
  size_t i = 0;
  while (i <= limit) {
    uint8_t v = b[i];
    if (v != 0xE8 && v != 0xE9) {
      ++i;
      continue;
    }
    const uint32_t offset = now + (uint32_t)i - prev_pos;
    prev_pos = now + (uint32_t)i;
    if (offset > 5) {
      prev_mask = 0;
    } else {
      for (uint32_t k = 0; k < offset; ++k) {
        prev_mask &= 0x77;
        prev_mask <<= 1;
      }
    }
    v = b[i + 4];
    if (ms(v) && allowed[(prev_mask >> 1) & 7] && (prev_mask >> 1) < 0x10) {
      uint32_t src = (uint32_t)v << 24 | (uint32_t)b[i + 3] << 16 | (uint32_t)b[i + 2] << 8 | b[i + 1];
      uint32_t dest;
      for (;;) {
        dest = src - (now + (uint32_t)i + 5);
        if (prev_mask == 0) break;
        const uint32_t k = bit_number[prev_mask >> 1];
        v = (uint8_t)(dest >> (24 - k * 8));
        if (!ms(v)) break;
        src = dest ^ ((1u << (32 - k * 8)) - 1);
      }
      b[i + 4] = (uint8_t)(~(((dest >> 24) & 1) - 1));
      b[i + 3] = (uint8_t)(dest >> 16);
      b[i + 2] = (uint8_t)(dest >> 8);
      b[i + 1] = (uint8_t)dest;
      i += 5;
      prev_mask = 0;
    } else {
      ++i;
      prev_mask |= 1;
      if (ms(v)) prev_mask |= 0x10;
    }
  }
  return i;
}

size_t bcj_powerpc(uint32_t now, uint8_t* b, size_t size) {
  size &= ~(size_t)3;
  size_t i = 0;
  for (; i < size; i += 4)
    if ((b[i] >> 2) == 0x12 && (b[i + 3] & 3) == 1) {
      const uint32_t src = ((uint32_t)b[i] & 3) << 24 | (uint32_t)b[i + 1] << 16 | (uint32_t)b[i + 2] << 8 |
                           ((uint32_t)b[i + 3] & ~3u);
      const uint32_t dest = src - (now + (uint32_t)i);
      b[i] = (uint8_t)(0x48 | ((dest >> 24) & 3));
      b[i + 1] = (uint8_t)(dest >> 16);
      b[i + 2] = (uint8_t)(dest >> 8);
      b[i + 3] = (uint8_t)((b[i + 3] & 3) | (dest & 0xFF & ~3u));
    }
  return i;
}

size_t bcj_ia64(uint32_t now, uint8_t* b, size_t size) {
  static const uint32_t branch[32] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                      4, 4, 6, 6, 0, 0, 7, 7, 4, 4, 0, 0, 4, 4, 0, 0};
  size_t i = 0;
  for (; i + 16 <= size; i += 16) {
    const uint32_t mask = branch[b[i] & 0x1F];
    uint32_t bit_pos = 5;
    for (int slot = 0; slot < 3; ++slot, bit_pos += 41) {
      if (!((mask >> slot) & 1)) continue;
      const size_t byte_pos = bit_pos >> 3;
      const uint32_t bit_res = bit_pos & 7;
      uint64_t inst = 0;
      for (int j = 0; j < 6; ++j) inst += (uint64_t)b[i + j + byte_pos] << (8 * j);
      uint64_t norm = inst >> bit_res;
      if (((norm >> 37) & 0xF) == 0x5 && ((norm >> 9) & 0x7) == 0) {
        uint32_t src = (uint32_t)((norm >> 13) & 0xFFFFF);
        src |= (uint32_t)((norm >> 36) & 1) << 20;
        src <<= 4;
        uint32_t dest = src - (now + (uint32_t)i);
        dest >>= 4;
        norm &= ~((uint64_t)0x8FFFFF << 13);
        norm |= (uint64_t)(dest & 0xFFFFF) << 13;
        norm |= (uint64_t)(dest & 0x100000) << (36 - 20);
        inst &= (1ull << bit_res) - 1;
        inst |= norm << bit_res;
        for (int j = 0; j < 6; ++j) b[i + j + byte_pos] = (uint8_t)(inst >> (8 * j));
      }
    }
  }
  return i;
}

size_t bcj_arm(uint32_t now, uint8_t* b, size_t size) {
  size &= ~(size_t)3;
  size_t i = 0;
  for (; i < size; i += 4)
    if (b[i + 3] == 0xEB) {
      const uint32_t src = ((uint32_t)b[i + 2] << 16 | (uint32_t)b[i + 1] << 8 | b[i]) << 2;
      const uint32_t dest = (src - (now + (uint32_t)i + 8)) >> 2;
      b[i + 2] = (uint8_t)(dest >> 16);
      b[i + 1] = (uint8_t)(dest >> 8);
      b[i] = (uint8_t)dest;
    }
  return i;
}

size_t bcj_armthumb(uint32_t now, uint8_t* b, size_t size) {
  if (size < 4) return 0;
  size -= 4;
  size_t i = 0;
  for (; i <= size; i += 2)
    if ((b[i + 1] & 0xF8) == 0xF0 && (b[i + 3] & 0xF8) == 0xF8) {
      const uint32_t src = (((uint32_t)b[i + 1] & 7) << 19 | (uint32_t)b[i] << 11 | ((uint32_t)b[i + 3] & 7) << 8 |
                            b[i + 2]) << 1;
      const uint32_t dest = (src - (now + (uint32_t)i + 4)) >> 1;
      b[i + 1] = (uint8_t)(0xF0 | ((dest >> 19) & 7));
      b[i] = (uint8_t)(dest >> 11);
      b[i + 3] = (uint8_t)(0xF8 | ((dest >> 8) & 7));
      b[i + 2] = (uint8_t)dest;
      i += 2;
    }
  return i;
}

size_t bcj_sparc(uint32_t now, uint8_t* b, size_t size) {
  size &= ~(size_t)3;
  size_t i = 0;
  for (; i < size; i += 4)
    if ((b[i] == 0x40 && (b[i + 1] & 0xC0) == 0) || (b[i] == 0x7F && (b[i + 1] & 0xC0) == 0xC0)) {
      uint32_t src = (uint32_t)b[i] << 24 | (uint32_t)b[i + 1] << 16 | (uint32_t)b[i + 2] << 8 | b[i + 3];
      src <<= 2;
      uint32_t dest = (src - (now + (uint32_t)i)) >> 2;
      dest = (((0u - ((dest >> 22) & 1)) << 22) & 0x3FFFFFFF) | (dest & 0x3FFFFF) | 0x40000000;
      b[i] = (uint8_t)(dest >> 24);
      b[i + 1] = (uint8_t)(dest >> 16);
      b[i + 2] = (uint8_t)(dest >> 8);
      b[i + 3] = (uint8_t)dest;
    }
  return i;
}

// ARM64 (liblzma 5.4 on): BL's 26-bit immediate, and ADRP's 21-bit one
// where it lies within +-512 MiB (its top 3 bits all equal), from absolute
// back to relative, in 4-byte little-endian words.
size_t bcj_arm64(uint32_t now, uint8_t* b, size_t size) {
  size_t i = 0;
  for (; i + 4 <= size; i += 4) {
    const uint32_t pc = now + (uint32_t)i;
    uint32_t instr = b[i] | b[i + 1] << 8 | b[i + 2] << 16 | (uint32_t)b[i + 3] << 24;
    if ((instr >> 26) == 0x25) {  // BL
      instr = 0x94000000 | ((instr - (pc >> 2)) & 0x03FFFFFF);
    } else if ((instr & 0x9F000000) == 0x90000000) {  // ADRP
      const uint32_t src = ((instr >> 29) & 3) | ((instr >> 3) & 0x001FFFFC);
      if ((src + 0x00020000) & 0x001C0000) continue;
      const uint32_t dest = src - (pc >> 12);
      instr &= 0x9000001F;
      instr |= (dest & 3) << 29;
      instr |= (dest & 0x0003FFFC) << 3;
      instr |= (0u - (dest & 0x00020000)) & 0x00E00000;
    } else {
      continue;
    }
    for (int k = 0; k < 4; ++k) b[i + k] = (uint8_t)(instr >> (8 * k));
  }
  return i;
}

// RISC-V (liblzma 5.6 on), on 2-byte steps: JAL with rd x1 or x5 (its
// 20-bit immediate from the encoder's big-endian-ish absolute form back to
// relative), and AUIPC with the instruction after it: the encoder turns an
// AUIPC + a load, store or ADDI of the same register into a "special"
// AUIPC of rd x2 holding the second instruction's low 20 bits, followed by
// the absolute address big-endian, and swaps a genuine AUIPC x2 of that
// special form with the word after it; decoding undoes both.
size_t bcj_riscv(uint32_t now, uint8_t* b, size_t size) {
  auto rd32 = [&](size_t at) { return b[at] | b[at + 1] << 8 | b[at + 2] << 16 | (uint32_t)b[at + 3] << 24; };
  auto wr32 = [&](size_t at, uint32_t v) {
    for (int k = 0; k < 4; ++k) b[at + k] = (uint8_t)(v >> (8 * k));
  };
  if (size < 8) return 0;
  size -= 8;
  size_t i = 0;
  for (; i <= size; i += 2) {
    uint32_t inst = b[i];
    if (inst == 0xEF) {  // JAL
      const uint32_t b1 = b[i + 1];
      if (b1 & 0x0D) continue;
      const uint32_t b2 = b[i + 2], b3 = b[i + 3], pc = now + (uint32_t)i;
      uint32_t addr = ((b1 & 0xF0) << 13) | (b2 << 9) | (b3 << 1);
      addr -= pc;
      b[i + 1] = (uint8_t)((b1 & 0x0F) | ((addr >> 8) & 0xF0));
      b[i + 2] = (uint8_t)(((addr >> 16) & 0x0F) | ((addr >> 7) & 0x10) | ((addr << 4) & 0xE0));
      b[i + 3] = (uint8_t)(((addr >> 4) & 0x7F) | ((addr >> 13) & 0x80));
      i += 4 - 2;
    } else if ((inst & 0x7F) == 0x17) {  // AUIPC
      inst = rd32(i);
      if (inst & 0xE80) {  // rd neither x0 nor x2: a swapped special AUIPC, or nothing
        const uint32_t inst2 = rd32(i + 4);
        if ((((inst << 8) ^ (inst2 - 3)) & 0xF8003) != 0) {
          i += 6 - 2;
          continue;
        }
        wr32(i, 0x17 | (2 << 7) | (inst2 << 12));
        wr32(i + 4, (inst & 0xFFFFF000) | (inst2 >> 20));
      } else {  // rd x0 or x2: the special form of a pair, or nothing
        const uint32_t inst2_rs1 = inst >> 27;
        if ((uint32_t)((inst - 0x3117) << 18) >= (inst2_rs1 & 0x1D)) {
          i += 4 - 2;
          continue;
        }
        uint32_t addr = (uint32_t)b[i + 4] << 24 | (uint32_t)b[i + 5] << 16 | (uint32_t)b[i + 6] << 8 | b[i + 7];
        addr -= now + (uint32_t)i;
        const uint32_t inst2 = (inst >> 12) | (addr << 20);
        wr32(i, 0x17 | (inst2_rs1 << 7) | ((addr + 0x800) & 0xFFFFF000));
        wr32(i + 4, inst2);
      }
      i += 8 - 2;
    }
  }
  return i;
}

// simple_coder.c's buffering around a BCJ filter: bytes it cannot decide
// yet wait in `buffer` for more data; at the end of the block's data they
// go out as they are.
struct XzBcj final : XzCoder {
  std::unique_ptr<XzCoder> next;
  uint64_t id;
  uint32_t now = 0, prev_mask = 0, prev_pos = (uint32_t)-5;
  std::vector<uint8_t> buffer;
  size_t bpos = 0, bsize = 0, filtered = 0, allocated = 0;
  bool end = false;
  XzBcj(std::unique_ptr<XzCoder> nx, uint64_t filter, uint32_t start) : next(std::move(nx)), id(filter), now(start) {
    const size_t unfiltered_max = id == 4 ? 5 : id == 6 ? 16 : id == 0x0B ? 8 : 4;
    allocated = 2 * unfiltered_max;
    buffer.assign(allocated, 0);
  }
  size_t filter(uint8_t* b, size_t size) {
    size_t k = 0;
    switch (id) {
      case 4: k = bcj_x86(now, b, size, prev_mask, prev_pos); break;
      case 5: k = bcj_powerpc(now, b, size); break;
      case 6: k = bcj_ia64(now, b, size); break;
      case 7: k = bcj_arm(now, b, size); break;
      case 8: k = bcj_armthumb(now, b, size); break;
      case 9: k = bcj_sparc(now, b, size); break;
      case 0x0A: k = bcj_arm64(now, b, size); break;
      default: k = bcj_riscv(now, b, size); break;
    }
    now += (uint32_t)k;
    return k;
  }
  void copy(uint8_t* out, size_t& pos, size_t size) {
    const size_t k = std::min(filtered - bpos, size - pos);
    std::memcpy(out + pos, buffer.data() + bpos, k);
    bpos += k;
    pos += k;
  }
  bool code(uint8_t* out, size_t& pos, size_t size) override {
    if (bpos < filtered) {
      copy(out, pos, size);
      if (bpos < filtered) return false;
      if (end) return true;
    }
    filtered = 0;
    const size_t out_avail = size - pos, buf_avail = bsize - bpos;
    if (out_avail > buf_avail || buf_avail == 0) {
      const size_t out_start = pos;
      std::memcpy(out + pos, buffer.data() + bpos, buf_avail);
      pos += buf_avail;
      end = next->code(out, pos, size);
      const size_t got = pos - out_start;
      const size_t unfiltered = got - (got ? filter(out + out_start, got) : 0);
      bpos = 0;
      bsize = unfiltered;
      if (end) {
        bsize = 0;
      } else if (unfiltered > 0) {
        pos -= unfiltered;
        std::memcpy(buffer.data(), out + pos, unfiltered);
      }
    } else if (bpos > 0) {
      std::memmove(buffer.data(), buffer.data() + bpos, buf_avail);
      bsize -= bpos;
      bpos = 0;
    }
    if (bsize > 0) {
      end = next->code(buffer.data(), bsize, allocated);
      filtered = filter(buffer.data(), bsize);
      if (end) filtered = bsize;
      copy(out, pos, size);
    }
    return end && bpos == bsize;
  }
};

// The xz stream's multibyte integer at s[at ..].
uint64_t xz_vli(const uint8_t* s, size_t n, size_t& at) {
  uint64_t v = 0;
  for (int i = 0; i < 9; ++i) {
    if (at >= n) xz_error("data ends early");
    const uint8_t b = s[at++];
    if (i > 0 && b == 0) xz_error("multibyte integer not in its shortest form");
    v |= (uint64_t)(b & 0x7F) << (7 * i);
    if (!(b & 0x80)) return v;
  }
  xz_error("multibyte integer too long");
}

[[gnu::noinline]] void unxz(const uint8_t* s, size_t n, size_t want, std::vector<uint8_t>& out) {
  static const uint8_t magic[6] = {0xFD, '7', 'z', 'X', 'Z', 0};
  out.assign(want, 0);
  size_t got = 0;
  try {
    if (n < 12 || std::memcmp(s, magic, 6) != 0) xz_error("not an .xz stream");
    if (s[6] != 0 || s[7] > 0x0F) xz_error("unsupported stream flags");
    if (crc32_of(s + 6, 2) != (uint32_t)(s[8] | s[9] << 8 | s[10] << 16 | (uint32_t)s[11] << 24))
      xz_error("stream header CRC32 fails");
    const int check = s[7];
    static const int check_sizes[16] = {0, 4, 4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 32, 64, 64, 64};
    size_t at = 12;
    while (got < want) {  // a block
      if (at >= n) xz_error("data ends early");
      if (s[at] == 0) xz_error("stream ends before the strip is full");
      const size_t hsize = ((size_t)s[at] + 1) * 4;
      if (hsize > n - at) xz_error("data ends early");
      const uint8_t* h = s + at;
      if (crc32_of(h, hsize - 4) != (uint32_t)(h[hsize - 4] | h[hsize - 3] << 8 | h[hsize - 2] << 16 |
                                              (uint32_t)h[hsize - 1] << 24))
        xz_error("block header CRC32 fails");
      const uint8_t flags = h[1];
      if (flags & 0x3C) xz_error("unsupported block flags");
      size_t hp = 2;
      const uint64_t unknown = ~0ull;
      uint64_t csize = unknown, usize = unknown;
      if (flags & 0x40) csize = xz_vli(h, hsize - 4, hp);
      if (flags & 0x80) usize = xz_vli(h, hsize - 4, hp);
      if (csize == 0) xz_error("block of compressed size 0");
      struct Filter {
        uint64_t id;
        std::vector<uint8_t> props;
      };
      std::vector<Filter> chain((flags & 3) + 1);
      for (auto& f : chain) {
        f.id = xz_vli(h, hsize - 4, hp);
        if (f.id >= 0x4000000000000000ull) xz_error("reserved filter ID");
        const uint64_t ps = xz_vli(h, hsize - 4, hp);
        if (ps > hsize - 4 - hp) xz_error("filter properties past the block header");
        f.props.assign(h + hp, h + hp + ps);
        hp += (size_t)ps;
      }
      for (size_t i = hp; i < hsize - 4; ++i)
        if (h[i]) xz_error("block header padding not zero");
      at += hsize;
      const size_t data_start = at;
      // The chain: LZMA2 last, Delta or BCJ filters before it.
      const Filter& last = chain.back();
      if (last.id != 0x21 || last.props.size() != 1 || last.props[0] > 40)
        xz_error("filter chain not ending in LZMA2");
      const uint8_t d = last.props[0];
      const uint64_t dict = d == 40 ? 0xFFFFFFFFull : (uint64_t)(2 | (d & 1)) << (d / 2 + 11);
      const size_t data_end = csize == unknown || csize > n - at ? n : at + (size_t)csize;
      auto lzma2 = std::make_unique<Lzma2>(s, data_end, dict);
      lzma2->at = at;
      Lzma2* raw = lzma2.get();
      std::unique_ptr<XzCoder> top = std::move(lzma2);
      for (size_t k = chain.size() - 1; k-- > 0;) {
        const Filter& f = chain[k];
        if (f.id == 3) {
          if (f.props.size() != 1) xz_error("bad Delta properties");
          auto delta = std::make_unique<XzDelta>();
          delta->next = std::move(top);
          delta->distance = (size_t)f.props[0] + 1;
          top = std::move(delta);
        } else if (f.id >= 4 && f.id <= 0x0B) {
          uint32_t start = 0;
          if (f.props.size() == 4)
            start = f.props[0] | f.props[1] << 8 | f.props[2] << 16 | (uint32_t)f.props[3] << 24;
          else if (!f.props.empty())
            xz_error("bad BCJ properties");
          // simple_coder.c: a start offset a multiple of the filter's alignment
          static const uint32_t kAlign[8] = {1, 4, 16, 4, 2, 4, 4, 2};  // IDs 4 .. 11
          if (start % kAlign[f.id - 4]) xz_error("BCJ start offset off its filter's alignment");
          top = std::make_unique<XzBcj>(std::move(top), f.id, start);
        } else {
          xz_error("filter liblzma has no decoder for, or LZMA2 before the last filter");
        }
      }
      // The block's data into the strip, no more than an uncompressed
      // size given in its header.
      const size_t start = got;
      const size_t stop = usize == unknown || usize > want - got ? want : got + (size_t)usize;
      bool end = false;
      for (;;) {  // libtiff calls lzma_code until the strip is full
        const size_t before = got, decoded = raw->hist.size();
        end = top->code(out.data(), got, stop);
        if (end || got >= stop) break;
        if (got == before && raw->hist.size() == decoded) xz_error("data ends early");
      }
      if (!end) {
        if (got < want) xz_error("block's data longer than its header says");
        break;  // the strip is full
      }
      at = raw->at;
      if ((csize != unknown && at - data_start != csize) ||
          (usize != unknown && got - start != usize))
        xz_error("block sizes unlike its header's");
      while ((at - (size_t)(h - s)) & 3) {
        if (at >= n) xz_error("data ends early");
        if (s[at++]) xz_error("block padding not zero");
      }
      const int cs = check_sizes[check];
      if (cs > (int)(n - at)) xz_error("data ends early");
      const uint8_t* c = s + at;
      bool ok = true;
      if (check == 1) {
        ok = crc32_of(out.data() + start, got - start) == (uint32_t)(c[0] | c[1] << 8 | c[2] << 16 | (uint32_t)c[3] << 24);
      } else if (check == 4) {
        uint64_t v = 0;
        for (int i = 0; i < 8; ++i) v |= (uint64_t)c[i] << (8 * i);
        ok = crc64_of(out.data() + start, got - start) == v;
      } else if (check == 10) {
        uint8_t digest[32];
        sha256_of(out.data() + start, got - start, digest);
        ok = std::memcmp(digest, c, 32) == 0;
      }
      if (!ok) xz_error("block check fails");
      at += (size_t)cs;
    }
  } catch (const DecodeError& e) {
    if (e.status == kUnsupported) throw;
    if (got >= want) return;  // libtiff takes a full strip whatever lzma_code says
    out.resize(got);
    throw;
  }
}

// ------------------------------------------------------------- Zstandard
// ZSTD TIFF (compression 50000) as libtiff's ZSTDDecode reads it for PIL:
// each strip a Zstandard frame (RFC 8878) decoded as libzstd's
// ZSTD_decompressStream does until the frame ends or the strip is full.
// Blocks are decoded whole and then handed on, so a strip full at a block's
// end still has the next block (or the checksum, verified) decoded, and
// its error fails the strip; the end of the first frame ends the strip,
// short or not. A failing strip keeps the blocks before the one that
// failed. libzstd's defaults bound the window (windowLogMax 27).

[[noreturn]] void zstd_error(const char* what) { corrupt(std::string("ZSTD TIFF strip: ") + what); }

// xxHash's XXH64, seed 0.
uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull, P3 = 1609587929392839161ull,
                 P4 = 9650029242287828579ull, P5 = 2870177450012600261ull;
  auto rotl = [](uint64_t x, int r) { return (x << r) | (x >> (64 - r)); };
  auto rd64 = [](const uint8_t* q) {
    uint64_t v;
    std::memcpy(&v, q, 8);
    return v;
  };
  auto round = [&](uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; };
  auto merge = [&](uint64_t acc, uint64_t v) { return (acc ^ round(0, v)) * P1 + P4; };
  size_t i = 0;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; i + 32 <= n; i += 32) {
      v1 = round(v1, rd64(p + i));
      v2 = round(v2, rd64(p + i + 8));
      v3 = round(v3, rd64(p + i + 16));
      v4 = round(v4, rd64(p + i + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge(merge(merge(merge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += n;
  for (; i + 8 <= n; i += 8) h = rotl(h ^ round(0, rd64(p + i)), 27) * P1 + P4;
  if (i + 4 <= n) {
    uint32_t v;
    std::memcpy(&v, p + i, 4);
    h = rotl(h ^ (uint64_t)v * P1, 23) * P2 + P3;
    i += 4;
  }
  for (; i < n; ++i) h = rotl(h ^ p[i] * P5, 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// A bit stream read backwards from its end (RFC 8878 4.1): its last
// byte's highest 1 bit starts it; bits before its first byte read as 0.
struct BackBits {
  const uint8_t* s;
  int64_t pos;  // bits left
  BackBits(const uint8_t* p, size_t n) : s(p) {
    if (n == 0 || p[n - 1] == 0) zstd_error("bit stream without its end marker");
    int top = 7;
    while (!(p[n - 1] >> top & 1)) --top;
    pos = (int64_t)(n - 1) * 8 + top;
  }
  uint32_t peek(int k) const {  // the next k <= 25 bits, the first read the highest
    if (k == 0) return 0;
    const int64_t lo = pos - k;
    uint64_t w = 0;
    const int64_t b0 = lo < 0 ? 0 : lo >> 3;
    for (int64_t b = b0; b < b0 + 5 && b * 8 < pos; ++b) w |= (uint64_t)s[b] << (8 * (b - b0));
    if (lo < 0) return (uint32_t)((w << -lo) & ((1u << k) - 1));
    return (uint32_t)((w >> (lo & 7)) & ((1u << k) - 1));
  }
  uint32_t read(int k) {
    const uint32_t v = peek(k);
    pos -= k;
    return v;
  }
};

// An FSE decoding table (RFC 8878 4.1.1).
struct Fse {
  int log = 0;
  std::vector<uint8_t> sym, bits;
  std::vector<uint16_t> base;
  void build(const int16_t* norm, int nsym, int al) {
    log = al;
    const int size = 1 << al;
    sym.assign(size, 0);
    bits.assign(size, 0);
    base.assign(size, 0);
    std::vector<int> next(nsym);
    int high = size - 1;
    for (int s = 0; s < nsym; ++s)
      if (norm[s] == -1) {
        sym[high--] = (uint8_t)s;
        next[s] = 1;
      } else {
        next[s] = norm[s];
      }
    const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
    int p = 0;
    for (int s = 0; s < nsym; ++s)
      for (int i = 0; i < norm[s]; ++i) {
        sym[p] = (uint8_t)s;
        do p = (p + step) & mask;
        while (p > high);
      }
    if (p != 0) zstd_error("bad FSE table");
    for (int i = 0; i < size; ++i) {
      const int n = next[sym[i]]++;
      int hb = 31;
      while (!((uint32_t)n >> hb & 1)) --hb;
      bits[i] = (uint8_t)(al - hb);
      base[i] = (uint16_t)((n << bits[i]) - size);
    }
  }
  void rle(uint8_t s) {
    log = 0;
    sym.assign(1, s);
    bits.assign(1, 0);
    base.assign(1, 0);
  }
};

// FSE_readNCount: a table description at s[0 .. n), its length returned.
size_t fse_read(const uint8_t* s, size_t n, int max_log, int max_sym, Fse& t) {
  if (n < 1) zstd_error("data ends early");
  auto bit_at = [&](size_t b) -> uint32_t { return b / 8 < n ? (s[b / 8] >> (b % 8)) & 1 : 0; };
  auto bits = [&](size_t b, int k) {
    uint32_t v = 0;
    for (int i = 0; i < k; ++i) v |= bit_at(b + i) << i;
    return v;
  };
  size_t bp = 0;
  const int al = (int)bits(0, 4) + 5;
  bp = 4;
  if (al > max_log) zstd_error("FSE accuracy past its maximum");
  int remaining = (1 << al) + 1, threshold = 1 << al, nb = al + 1, symbol = 0;
  int16_t norm[256] = {0};
  bool prev0 = false;
  for (;;) {
    if (prev0) {  // runs of zero counts: 2-bit repeat fields, 3 again while they read 3
      int reps = 0;
      while (bits(bp, 2) == 3) {
        reps += 3;
        bp += 2;
      }
      reps += (int)bits(bp, 2);
      bp += 2;
      symbol += reps;
      if (symbol > max_sym) break;
    }
    const int max = (2 * threshold - 1) - remaining;
    int count;
    if ((int)(bits(bp, nb - 1)) < max) {
      count = (int)bits(bp, nb - 1);
      bp += nb - 1;
    } else {
      count = (int)bits(bp, nb);
      if (count >= threshold) count -= max;
      bp += nb;
    }
    --count;
    remaining -= count < 0 ? -count : count;
    norm[symbol++] = (int16_t)count;
    prev0 = count == 0;
    if (remaining < threshold) {
      if (remaining <= 1) break;
      nb = 1;
      while (remaining >> nb) ++nb;
      threshold = 1 << (nb - 1);
    }
    if (symbol > max_sym) break;
  }
  if (remaining != 1 || symbol > max_sym + 1) zstd_error("bad FSE table description");
  const size_t used = (bp + 7) / 8;
  if (used > n) zstd_error("data ends early");
  t.build(norm, symbol, al);
  return used;
}

struct Huffman {
  int max_bits = 0;
  std::vector<uint8_t> sym, len;  // by the next max_bits bits
};

// libzstd 1.5.7's Huffman literal decoders (huf_decompress.c, bitstream.h)
// as PIL's x86-64 build runs them with BMI2, which decide what damaged
// literals give. The single-symbol table (X1) or, for 4 streams where
// HUF_selectDecoder's timing table prefers it, the double-symbol table
// (X2: a code and the next one where both fit in the lookup bits); one
// stream always X1, and treeless literals the previous table's kind. The
// 4 streams take the fast path when each is 8 bytes or more, the table's
// lookup is 11 bits and the output is not tiny: streams in lock step, each
// reading on into the bytes before it; a stream whose pointer went more
// than 8 bytes below its own start is an error; each then finishes with a
// BIT_DStream whose start is the jump table's, decoding on past it with no
// end check (bits past the start read as zeros until 64 are consumed, then
// the container again). Otherwise (12-bit codes, a stream under 8 bytes)
// each stream's own reader, and every stream must end where its bits do.
struct HufEntry {
  uint8_t seq[2], nb, len;  // symbols (X1: one), bits consumed, symbols given
};

struct HufBits {  // BIT_DStream_t
  uint64_t c = 0;
  uint32_t used = 0;
  const uint8_t *ptr = nullptr, *start = nullptr;  // ptr null: overflowed (libzstd's zero word)
  enum { kUnfinished, kEndOfBuffer, kCompleted, kOverflow };
  static uint64_t rd(const uint8_t* q) {
    uint64_t v = 0;
    for (int i = 7; i >= 0; --i) v = v << 8 | q[i];
    return v;
  }
  void init(const uint8_t* s, size_t n) {  // BIT_initDStream
    if (n < 1) zstd_error("empty Huffman stream");
    start = s;
    const uint8_t last = s[n - 1];
    if (last == 0) zstd_error("bit stream without its end marker");
    int top = 7;
    while (!(last >> top & 1)) --top;
    used = 8 - top;
    if (n >= 8) {
      ptr = s + n - 8;
      c = rd(ptr);
    } else {
      ptr = s;
      c = 0;
      for (size_t i = 0; i < n; ++i) c |= (uint64_t)s[i] << (8 * i);
      used += (uint32_t)(8 - n) * 8;
    }
  }
  uint32_t look(int nb) const { return (uint32_t)((c << (used & 63)) >> ((64 - nb) & 63)); }
  int reload() {  // BIT_reloadDStream
    if (used > 64) {
      ptr = nullptr;
      return kOverflow;
    }
    if (ptr >= start + 8) {
      ptr -= used >> 3;
      used &= 7;
      c = rd(ptr);
      return kUnfinished;
    }
    if (ptr == start) return used < 64 ? kEndOfBuffer : kCompleted;
    size_t nbytes = used >> 3;
    int r = kUnfinished;
    if ((size_t)(ptr - start) < nbytes) {
      nbytes = (size_t)(ptr - start);
      r = kEndOfBuffer;
    }
    ptr -= nbytes;
    used -= (uint32_t)nbytes * 8;
    c = rd(ptr);
    return r;
  }
  int reload_fast() {  // BIT_reloadDStreamFast
    if (ptr < start + 8) return kOverflow;
    ptr -= used >> 3;
    used &= 7;
    c = rd(ptr);
    return kUnfinished;
  }
  bool end() const { return ptr == start && used == 64; }
};

// HUF_selectDecoder: whether the double-symbol decoder is the faster.
bool huf_select_x2(size_t dst, size_t src) {
  static const uint16_t t[16][4] = {
      {0, 0, 1, 1},        {0, 0, 1, 1},        {150, 216, 381, 119},  {170, 205, 514, 112},
      {177, 199, 539, 110}, {197, 194, 644, 107}, {221, 192, 735, 107},  {256, 189, 881, 106},
      {359, 188, 1167, 109}, {582, 187, 1570, 114}, {688, 187, 1712, 122}, {825, 186, 1965, 136},
      {976, 185, 2131, 150}, {1180, 186, 2070, 175}, {1377, 185, 1731, 202}, {1412, 185, 1695, 202}};
  const size_t q = src >= dst ? 15 : src * 16 / dst;
  const uint32_t d256 = (uint32_t)(dst >> 8);
  const uint32_t t0 = t[q][0] + t[q][1] * d256;
  uint32_t t1 = t[q][2] + t[q][3] * d256;
  t1 += t1 >> 5;
  return t1 < t0;
}

// The literal section's streams at p[0 .. n) decoded into `lit`.
void huf_literals(const Huffman& h, bool x2, const uint8_t* p, size_t n, bool single,
                  std::vector<uint8_t>& lit) {
  const size_t regen = lit.size();
  // The table: lookups of `log` bits (an X1 table of shorter codes is
  // rescaled to 11 bits, HUF_rescaleStats; X2's lookup is 11 bits too).
  const int log = std::max(h.max_bits, 11);
  std::vector<HufEntry> dt((size_t)1 << log);
  for (size_t i = 0; i < dt.size(); ++i) {
    const size_t a = i >> (log - h.max_bits);
    HufEntry e{{h.sym[a], 0}, h.len[a], 1};
    if (x2) {
      const size_t j = (i << e.nb) & (dt.size() - 1), b = j >> (log - h.max_bits);
      if (e.nb + h.len[b] <= log) e = HufEntry{{h.sym[a], h.sym[b]}, (uint8_t)(e.nb + h.len[b]), 2};
    }
    dt[i] = e;
  }
  auto put = [&](size_t at, const HufEntry& e, int k) {  // libzstd writes 2 bytes of an X2 entry
    for (int i = 0; i < k; ++i)
      if (at + i < regen) lit[at + i] = e.seq[i];
  };
  // HUF_decodeSymbolX1 / X2; X2 returns the symbols it gave.
  auto sym1 = [&](HufBits& b, size_t& op) {
    const HufEntry& e = dt[b.look(log)];
    put(op++, e, 1);
    b.used += e.nb;
  };
  auto sym2 = [&](HufBits& b, size_t& op) {
    const HufEntry& e = dt[b.look(log)];
    put(op, e, 2);
    b.used += e.nb;
    op += e.len;
  };
  auto stream1 = [&](HufBits& b, size_t op, size_t end) {  // HUF_decodeStreamX1
    if (end - op > 3) {
      while ((b.reload() == HufBits::kUnfinished) & (op < end - 3))
        for (int k = 0; k < 4; ++k) sym1(b, op);
    } else {
      b.reload();
    }
    while (op < end) sym1(b, op);
  };
  auto stream2 = [&](HufBits& b, size_t op, size_t end) {  // HUF_decodeStreamX2
    if (end - op >= 8) {
      if (log <= 11) {
        while ((b.reload() == HufBits::kUnfinished) & (op + 9 < end))
          for (int k = 0; k < 5; ++k) sym2(b, op);
      } else {
        while ((b.reload() == HufBits::kUnfinished) & (op + 7 < end))
          for (int k = 0; k < 4; ++k) sym2(b, op);
      }
    } else {
      b.reload();
    }
    if (end - op >= 2) {
      while ((b.reload() == HufBits::kUnfinished) & (op + 2 <= end)) sym2(b, op);
      while (op + 2 <= end) sym2(b, op);
    }
    if (op < end) {  // HUF_decodeLastSymbolX2
      const HufEntry& e = dt[b.look(log)];
      put(op, e, 1);
      if (e.len == 1) {
        b.used += e.nb;
      } else if (b.used < 64) {
        b.used = std::min<uint32_t>(b.used + e.nb, 64);
      }
    }
  };
  auto stream = [&](HufBits& b, size_t op, size_t end) { x2 ? stream2(b, op, end) : stream1(b, op, end); };
  if (single) {
    HufBits b;
    b.init(p, n);
    stream(b, 0, regen);
    if (!b.end()) zstd_error("Huffman stream not read to its end");
    return;
  }
  if (n < 10) zstd_error("data ends early");
  const size_t len[3] = {(size_t)(p[0] | p[1] << 8), (size_t)(p[2] | p[3] << 8), (size_t)(p[4] | p[5] << 8)};
  if (len[0] + len[1] + len[2] + 6 > n) zstd_error("bad literal stream sizes");
  const size_t len4 = n - 6 - len[0] - len[1] - len[2], seg = (regen + 3) / 4;
  const uint8_t* in[5] = {p + 6, p + 6 + len[0], p + 6 + len[0] + len[1], p + 6 + len[0] + len[1] + len[2],
                          p + n};
  const size_t ostart[4] = {0, seg, 2 * seg, 3 * seg};
  if (log == 11 && len[0] >= 8 && len[1] >= 8 && len[2] >= 8 && len4 >= 8 && 3 * seg < regen) {
    // HUF_DecompressFastArgs_init and the fast loop (X1: 5 symbols a
    // stream a turn; X2: 5 lookups).
    uint64_t bits[4];
    const uint8_t* ip[4];
    size_t op[4], oend[4] = {seg, 2 * seg, 3 * seg, regen};
    for (int i = 0; i < 4; ++i) {
      ip[i] = in[i + 1] - 8;
      const uint8_t last = ip[i][7];
      int top = 7;
      while (last && !(last >> top & 1)) --top;
      bits[i] = (HufBits::rd(ip[i]) | 1) << (last ? 8 - top : 0);
      op[i] = ostart[i];
    }
    for (;;) {
      size_t iters = (size_t)(ip[0] - p) / 7;
      if (x2) {
        for (int i = 0; i < 4; ++i) iters = std::min(iters, (oend[i] - op[i]) / 10);
      } else {
        iters = std::min(iters, (regen - op[3]) / 5);
      }
      const size_t olimit = op[3] + iters * 5;
      if (op[3] == olimit) break;
      if (ip[1] < ip[0] || ip[2] < ip[1] || ip[3] < ip[2]) break;
      do {
        for (int i = 0; i < 4; ++i) {
          for (int k = 0; k < 5; ++k) {
            const HufEntry& e = dt[bits[i] >> 53];
            bits[i] <<= e.nb;
            if (x2) {
              put(op[i], e, 2);
              op[i] += e.len;
            } else {
              put(op[i] + k, e, 1);
            }
          }
          if (!x2) op[i] += 5;
          const int ctz = __builtin_ctzll(bits[i]);
          ip[i] -= ctz >> 3;
          bits[i] = (HufBits::rd(ip[i]) | 1) << (ctz & 7);
        }
      } while (op[3] < olimit);
    }
    for (int i = 0; i < 4; ++i) {  // HUF_initRemainingDStream, then each stream to its end
      if (op[i] > oend[i] || ip[i] - p + 8 < in[i] - p) zstd_error("Huffman stream read past its start");
      HufBits b;
      b.c = HufBits::rd(ip[i]);
      b.used = (uint32_t)__builtin_ctzll(bits[i]);
      b.start = p;
      b.ptr = ip[i];
      stream(b, op[i], oend[i]);
    }
    return;
  }
  // HUF_decompress4X1/X2_usingDTable_internal_body.
  if (regen < 6) zstd_error("too few literals for 4 streams");
  HufBits b[4];
  for (int i = 0; i < 4; ++i) b[i].init(in[i], (size_t)(in[i + 1] - in[i]));
  size_t op[4] = {ostart[0], ostart[1], ostart[2], ostart[3]};
  if (regen - op[3] >= 8) {
    const size_t olimit = regen - (x2 ? 7 : 3);
    bool go = true;
    while (go && op[3] < olimit) {
      for (int k = 0; k < 4; ++k)
        for (int i = 0; i < 4; ++i) x2 ? sym2(b[i], op[i]) : sym1(b[i], op[i]);
      go = true;
      for (int i = 0; i < 4; ++i) go &= b[i].reload_fast() == HufBits::kUnfinished;
    }
  }
  for (int i = 0; i < 3; ++i)
    if (op[i] > ostart[i + 1]) zstd_error("Huffman stream past its segment");
  for (int i = 0; i < 4; ++i) stream(b[i], op[i], i < 3 ? ostart[i + 1] : regen);
  for (int i = 0; i < 4; ++i)
    if (!b[i].end()) zstd_error("Huffman stream not read to its end");
}

struct ZstdFrame {
  bool has_huffman = false;
  Huffman huf;
  bool huf_x2 = false;  // the table libzstd built is its double-symbol one (HUF_readDTableX2)
  Fse tables[3];  // literal lengths, offsets, match lengths
  bool has_table[3] = {false, false, false};
  uint32_t rep[3] = {1, 4, 8};
};

// The literals section of a compressed block at s[0 .. n): its literals,
// its length returned.
size_t zstd_literals(const uint8_t* s, size_t n, ZstdFrame& f, std::vector<uint8_t>& lit) {
  if (n < 1) zstd_error("data ends early");
  const int type = s[0] & 3, sf = (s[0] >> 2) & 3;
  size_t regen, comp = 0, hs;
  if (type < 2) {
    if (sf == 0 || sf == 2) {
      regen = s[0] >> 3;
      hs = 1;
    } else if (sf == 1) {
      if (n < 2) zstd_error("data ends early");
      regen = (s[0] >> 4) + ((size_t)s[1] << 4);
      hs = 2;
    } else {
      if (n < 3) zstd_error("data ends early");
      regen = (s[0] >> 4) + ((size_t)s[1] << 4) + ((size_t)s[2] << 12);
      hs = 3;
    }
    if (regen > 128 * 1024) zstd_error("literals past the block maximum");
    if (type == 0) {
      if (regen > n - hs) zstd_error("data ends early");
      lit.assign(s + hs, s + hs + regen);
      return hs + regen;
    }
    if (n < hs + 1) zstd_error("block too short for RLE literals");
    lit.assign(regen, s[hs]);
    return hs + 1;
  }
  hs = sf < 2 ? 3 : sf == 2 ? 4 : 5;
  if (n < 5) zstd_error("block too short for compressed literals");
  uint64_t v = 0;
  for (size_t i = 0; i < hs; ++i) v |= (uint64_t)s[i] << (8 * i);
  const int w = sf < 2 ? 10 : sf == 2 ? 14 : 18;
  regen = (size_t)((v >> 4) & ((1u << w) - 1));
  comp = (size_t)((v >> (4 + w)) & ((1u << w) - 1));
  const bool single = sf == 0;
  if (regen > 128 * 1024) zstd_error("literals past the block maximum");
  if (comp > n - hs) zstd_error("data ends early");
  if (!single && regen < 6) zstd_error("too few literals for 4 streams");
  const uint8_t* p = s + hs;
  size_t left = comp;
  if (type == 2) {  // the Huffman tree description
    if (left < 1) zstd_error("data ends early");
    const uint8_t hb = p[0];
    uint8_t weights[256] = {0};
    size_t nw;
    if (hb >= 128) {
      nw = hb - 127;
      const size_t bytes = (nw + 1) / 2;
      if (bytes + 1 > left) zstd_error("data ends early");
      for (size_t i = 0; i < nw; ++i) weights[i] = (uint8_t)(i & 1 ? p[1 + i / 2] & 15 : p[1 + i / 2] >> 4);
      p += 1 + bytes;
      left -= 1 + bytes;
    } else {
      if ((size_t)hb + 1 > left) zstd_error("data ends early");
      Fse t;
      const size_t used = fse_read(p + 1, hb, 6, 255, t);
      BackBits b(p + 1 + used, hb - used);
      uint32_t s1 = b.read(t.log), s2 = b.read(t.log);
      nw = 0;
      for (;;) {
        if (nw > 253) zstd_error("too many Huffman weights");
        weights[nw++] = t.sym[s1];
        s1 = t.base[s1] + b.read(t.bits[s1]);
        if (b.pos < 0) {
          weights[nw++] = t.sym[s2];
          break;
        }
        if (nw > 253) zstd_error("too many Huffman weights");
        weights[nw++] = t.sym[s2];
        s2 = t.base[s2] + b.read(t.bits[s2]);
        if (b.pos < 0) {
          weights[nw++] = t.sym[s1];
          break;
        }
      }
      p += 1 + hb;
      left -= 1 + hb;
    }
    // The last weight makes the total a power of 2.
    uint32_t total = 0, rank1 = 0;
    for (size_t i = 0; i < nw; ++i) {
      if (weights[i] > 12) zstd_error("Huffman weight past 12");
      total += (1u << weights[i]) >> 1;
    }
    if (total == 0) zstd_error("Huffman weights all 0");
    int hbit = 31;
    while (!(total >> hbit & 1)) --hbit;
    const int max_bits = hbit + 1;
    if (max_bits > 12) zstd_error("Huffman codes past 12 bits");
    const uint32_t rest = (1u << max_bits) - total;
    int rb = 31;
    while (!(rest >> rb & 1)) --rb;
    if ((1u << rb) != rest) zstd_error("Huffman weights not summing to a power of 2");
    weights[nw++] = (uint8_t)(rb + 1);
    for (size_t i = 0; i < nw; ++i) rank1 += weights[i] == 1;
    if (rank1 < 2 || (rank1 & 1)) zstd_error("bad Huffman tree");
    // Codes by weight, lowest first (HUF_readDTableX1).
    Huffman& h = f.huf;
    h.max_bits = max_bits;
    h.sym.assign((size_t)1 << max_bits, 0);
    h.len.assign((size_t)1 << max_bits, 0);
    uint32_t start[14] = {0};
    uint32_t count[14] = {0};
    for (size_t i = 0; i < nw; ++i) ++count[weights[i]];
    uint32_t next = 0;
    for (int wgt = 1; wgt <= max_bits; ++wgt) {
      start[wgt] = next;
      next += count[wgt] << (wgt - 1);
    }
    for (size_t i = 0; i < nw; ++i) {
      const int wgt = weights[i];
      if (!wgt) continue;
      const uint32_t k = 1u << (wgt - 1);
      for (uint32_t j = 0; j < k; ++j) {
        h.sym[start[wgt] + j] = (uint8_t)i;
        h.len[start[wgt] + j] = (uint8_t)(max_bits + 1 - wgt);
      }
      start[wgt] += k;
    }
    f.has_huffman = true;
  } else if (!f.has_huffman) {
    zstd_error("treeless literals without a previous Huffman table");
  }
  if (type == 2) f.huf_x2 = !single && huf_select_x2(regen, comp);
  lit.resize(regen);
  huf_literals(f.huf, f.huf_x2, p, left, single, lit);
  return hs + comp;
}

// A compressed block's sequences, executed onto `out` (the frame so far).
void zstd_sequences(const uint8_t* s, size_t n, ZstdFrame& f, const std::vector<uint8_t>& lit,
                    std::vector<uint8_t>& out, size_t block_max) {
  static const int16_t ll_def[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                     2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
  static const int16_t ml_def[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
  static const int16_t of_def[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                     1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
  static const uint32_t ll_base[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                                       12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                                       48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
  static const uint8_t ll_bits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                                      1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
  static const uint32_t ml_base[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,   13,   14,   15,   16,
                                       17, 18, 19, 20, 21, 22, 23, 24,  25,  26,   27,   28,   29,   30,
                                       31, 32, 33, 34, 35, 37, 39, 41,  43,  47,   51,   59,   67,   83,
                                       99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
  static const uint8_t ml_bits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                      0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                                      2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
  const size_t start = out.size();
  if (n < 1) zstd_error("data ends early");
  size_t at = 0, nseq;
  const uint8_t b0 = s[at++];
  if (b0 < 128) {
    nseq = b0;
  } else if (b0 < 255) {
    if (at >= n) zstd_error("data ends early");
    nseq = ((size_t)(b0 - 128) << 8) + s[at++];
  } else {
    if (at + 2 > n) zstd_error("data ends early");
    nseq = s[at] + ((size_t)s[at + 1] << 8) + 0x7F00;
    at += 2;
  }
  size_t li = 0;
  if (nseq > 0) {
    if (at >= n) zstd_error("data ends early");
    const uint8_t modes = s[at++];
    if (modes & 3) zstd_error("reserved bits of the sequence modes set");
    static const int max_log[3] = {9, 8, 9}, max_sym[3] = {35, 31, 52}, def_log[3] = {6, 5, 6};
    const int16_t* defs[3] = {ll_def, of_def, ml_def};
    const int shift[3] = {6, 4, 2};
    for (int k = 0; k < 3; ++k) {  // literal lengths, offsets, match lengths
      const int m = (modes >> shift[k]) & 3;
      if (m == 0) {
        f.tables[k].build(defs[k], max_sym[k] + 1 - (k == 1 ? 3 : 0), def_log[k]);
      } else if (m == 1) {
        if (at >= n) zstd_error("data ends early");
        if (s[at] > max_sym[k]) zstd_error("RLE sequence symbol past its maximum");
        f.tables[k].rle(s[at++]);
      } else if (m == 2) {
        at += fse_read(s + at, n - at, max_log[k], max_sym[k], f.tables[k]);
      } else if (!f.has_table[k]) {
        zstd_error("repeated sequence table without a previous one");
      }
      f.has_table[k] = true;
    }
    BackBits b(s + at, n - at);
    Fse &tl = f.tables[0], &to = f.tables[1], &tm = f.tables[2];
    uint32_t sl = b.read(tl.log), so = b.read(to.log), sm = b.read(tm.log);
    for (size_t q = 0; q < nseq; ++q) {
      const int oc = to.sym[so], mc = tm.sym[sm], lc = tl.sym[sl];
      if (lc > 35 || mc > 52 || oc > 31) zstd_error("sequence code past its maximum");
      uint32_t off_value = (1u << oc) + b.read(oc);
      uint32_t ml = ml_base[mc] + b.read(ml_bits[mc]);
      uint32_t ll = ll_base[lc] + b.read(ll_bits[lc]);
      size_t offset;
      if (off_value > 3) {
        offset = off_value - 3;
        f.rep[2] = f.rep[1];
        f.rep[1] = f.rep[0];
        f.rep[0] = (uint32_t)offset;
      } else {
        const uint32_t idx = off_value - 1 + (ll == 0);
        if (idx == 0) {
          offset = f.rep[0];
        } else {
          offset = idx < 3 ? f.rep[idx] : f.rep[0] - 1;
          if (idx > 1) f.rep[2] = f.rep[1];
          f.rep[1] = f.rep[0];
          f.rep[0] = (uint32_t)offset;
          if (offset == 0) zstd_error("offset 0");
        }
      }
      if (q + 1 < nseq) {  // the states: literal lengths, match lengths, offsets
        sl = tl.base[sl] + b.read(tl.bits[sl]);
        sm = tm.base[sm] + b.read(tm.bits[sm]);
        so = to.base[so] + b.read(to.bits[so]);
      }
      if (b.pos < 0) zstd_error("sequence stream read past its start");
      if (ll > lit.size() - li) zstd_error("literal length past the literals");
      if (out.size() - start + ll + ml > block_max) zstd_error("block larger than its maximum");
      out.insert(out.end(), lit.begin() + li, lit.begin() + li + ll);
      li += ll;
      if (offset > out.size()) zstd_error("match offset before the frame's start");
      const size_t from = out.size() - offset;
      for (uint32_t i = 0; i < ml; ++i) out.push_back(out[from + i]);
    }
    if (b.pos != 0) zstd_error("sequence stream not read to its end");
  } else if (at != n) {
    zstd_error("sequence section longer than its sequences");
  }
  if (out.size() - start + lit.size() - li > block_max) zstd_error("block larger than its maximum");
  out.insert(out.end(), lit.begin() + li, lit.end());
}

struct ZstdShort {};  // the data ends: libzstd waits for more, libtiff stops asking

[[gnu::noinline]] void unzstd(const uint8_t* s, size_t n, size_t want, std::vector<uint8_t>& out) {
  out.clear();
  size_t flushed = 0;  // what has gone into the strip: whole blocks
  size_t at = 0;
  auto need = [&](size_t k) {
    if (k > n - at) throw ZstdShort{};
  };
  try {
    need(4);
    const uint32_t magic = s[0] | s[1] << 8 | s[2] << 16 | (uint32_t)s[3] << 24;
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) zstd_error("skippable frame, which ends the strip");
    if (magic != 0xFD2FB528u) zstd_error("not a Zstandard frame");
    at = 4;
    need(1);
    const uint8_t fhd = s[at++];
    const int fcs_flag = fhd >> 6, did_flag = fhd & 3;
    const bool single = fhd & 0x20, checksum = fhd & 4;
    if (fhd & 8) zstd_error("reserved frame header bit set");
    uint64_t window = 0;
    if (!single) {
      need(1);
      const uint8_t wd = s[at++];
      const int wlog = 10 + (wd >> 3);
      window = (1ull << wlog) + ((1ull << wlog) / 8) * (wd & 7);
    }
    static const int did_size[4] = {0, 1, 2, 4};
    uint32_t did = 0;
    need(did_size[did_flag]);
    for (int i = 0; i < did_size[did_flag]; ++i) did |= (uint32_t)s[at + i] << (8 * i);
    at += did_size[did_flag];
    if (did) zstd_error("frame wants a dictionary");
    const int fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : 1 << fcs_flag;
    uint64_t content = ~0ull;
    if (fcs_size) {
      need(fcs_size);
      content = 0;
      for (int i = 0; i < fcs_size; ++i) content |= (uint64_t)s[at + i] << (8 * i);
      if (fcs_size == 2) content += 256;
      at += fcs_size;
    }
    if (single) window = content;
    // A frame whose content fits the strip is decoded in one pass, which
    // does not look at the window.
    if (!(content != ~0ull && content <= want) && window > (1ull << 27) + 1)
      zstd_error("window past libzstd's default maximum (windowLogMax 27)");
    const size_t block_max = (size_t)std::min<uint64_t>(window, 128 * 1024);
    ZstdFrame f;
    std::vector<uint8_t> lit;
    for (bool last = false; !last;) {
      if (flushed >= want) {
        // A full strip: the next unit is read only if the last block
        // filled it whole (libzstd decodes on until it cannot hand on).
        if (out.size() > want) break;
      }
      need(3);
      const uint32_t bh = s[at] | s[at + 1] << 8 | (uint32_t)s[at + 2] << 16;
      at += 3;
      last = bh & 1;
      const int type = (bh >> 1) & 3;
      const size_t size = bh >> 3;
      if (type == 3) zstd_error("reserved block type");
      if (size > block_max) zstd_error("block larger than its maximum");
      if (type == 0) {  // libzstd hands on a raw block's bytes as they come
        const size_t have = std::min(size, n - at);
        out.insert(out.end(), s + at, s + at + have);
        at += have;
        flushed = std::min(out.size(), want);
        need(size - have);
      } else if (type == 1) {
        need(1);
        out.insert(out.end(), size, s[at++]);
      } else {
        need(size);
        if (size < 2) zstd_error("compressed block too short");
        const size_t used = zstd_literals(s + at, size, f, lit);
        zstd_sequences(s + at + used, size - used, f, lit, out, block_max);
        at += size;
      }
      if (content != ~0ull && out.size() > content) zstd_error("frame longer than its content size");
      flushed = std::min(out.size(), want);
    }
    if (flushed >= want && out.size() > want) {
      out.resize(want);
      return;
    }
    if (content != ~0ull && out.size() != content) zstd_error("frame shorter than its content size");
    if (checksum) {
      need(4);
      const uint32_t c = s[at] | s[at + 1] << 8 | s[at + 2] << 16 | (uint32_t)s[at + 3] << 24;
      if (c != (uint32_t)xxh64(out.data(), out.size())) zstd_error("frame checksum fails");
    }
    if (out.size() < want) zstd_error("frame ends before the strip is full");
    out.resize(want);
  } catch (const ZstdShort&) {
    if (flushed >= want) {
      out.resize(want);
      return;
    }
    out.resize(flushed);
    zstd_error("data ends early");
  } catch (const DecodeError&) {
    out.resize(std::min(flushed, want));
    throw;
  }
}

// ----------------------------------------------------------------- CCITT
// Each byte's bits in reverse order, by byte.
const uint8_t* reversed_bits() {
  static const auto table = [] {
    std::vector<uint8_t> r(256);
    for (int b = 0; b < 256; ++b) {
      int v = 0;
      for (int k = 0; k < 8; ++k) v |= ((b >> k) & 1) << (7 - k);
      r[b] = (uint8_t)v;
    }
    return r;
  }();
  return table.data();
}

// Bilevel fax coding in TIFF (ITU-T T.4 and T.6), decoded to rows of 1-bit
// samples, MSB first, a black run as 1 bits (the raw samples libtiff's fax
// codec returns; PhotometricInterpretation then says which bit is white).
// Compression 2 is Modified Huffman: 1-D rows, each starting on a byte,
// no EOL. Compression 3 is T.4: each row after an EOL (found as libtiff's
// decoder finds it: any bits up to 11 zeros, the zeros, then a 1), then
// with T4Options bit 0 a tag bit (1: a 1-D row, 0: a 2-D row). Compression
// 4 is T.6: 2-D rows back to back. Each strip starts on an all-white
// reference line. The decoder is libtiff's (tif_fax3.c, tif_fax3.h), so
// that damaged code reads as PIL reads it (fax_strip).

// The terminating (0-63) and make-up (64-1728) codes of each colour, then
// the extended make-up codes (1792-2560) both colours share.
const char* const kWhiteCodes[] = {
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111", "10011", "10100",
    "00111", "01000", "001000", "000011", "110100", "110101", "101010", "101011", "0100111",
    "0001100", "0001000", "0010111", "0000011", "0000100", "0101000", "0101011", "0010011",
    "0100100", "0011000", "00000010", "00000011", "00011010", "00011011", "00010010",
    "00010011", "00010100", "00010101", "00010110", "00010111", "00101000", "00101001",
    "00101010", "00101011", "00101100", "00101101", "00000100", "00000101", "00001010",
    "00001011", "01010010", "01010011", "01010100", "01010101", "00100100", "00100101",
    "01011000", "01011001", "01011010", "01011011", "01001010", "01001011", "00110010",
    "00110011", "00110100",
    // 64, 128, ..., 1728
    "11011", "10010", "010111", "0110111", "00110110", "00110111", "01100100", "01100101",
    "01101000", "01100111", "011001100", "011001101", "011010010", "011010011", "011010100",
    "011010101", "011010110", "011010111", "011011000", "011011001", "011011010", "011011011",
    "010011000", "010011001", "010011010", "011000", "010011011"};
const char* const kBlackCodes[] = {
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011", "000101", "000100",
    "0000100", "0000101", "0000111", "00000100", "00000111", "000011000", "0000010111",
    "0000011000", "0000001000", "00001100111", "00001101000", "00001101100", "00000110111",
    "00000101000", "00000010111", "00000011000", "000011001010", "000011001011",
    "000011001100", "000011001101", "000001101000", "000001101001", "000001101010",
    "000001101011", "000011010010", "000011010011", "000011010100", "000011010101",
    "000011010110", "000011010111", "000001101100", "000001101101", "000011011010",
    "000011011011", "000001010100", "000001010101", "000001010110", "000001010111",
    "000001100100", "000001100101", "000001010010", "000001010011", "000000100100",
    "000000110111", "000000111000", "000000100111", "000000101000", "000001011000",
    "000001011001", "000000101011", "000000101100", "000001011010", "000001100110",
    "000001100111",
    // 64, 128, ..., 1728
    "0000001111", "000011001000", "000011001001", "000001011011", "000000110011",
    "000000110100", "000000110101", "0000001101100", "0000001101101", "0000001001010",
    "0000001001011", "0000001001100", "0000001001101", "0000001110010", "0000001110011",
    "0000001110100", "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010", "0000001011011",
    "0000001100100", "0000001100101"};
const char* const kExtendedCodes[] = {  // 1792, 1856, ..., 2560
    "00000001000", "00000001100", "00000001101", "000000010010", "000000010011",
    "000000010100", "000000010101", "000000010110", "000000010111", "000000011100",
    "000000011101", "000000011110", "000000011111"};

// libtiff's tables (mkg3states.c): an entry per next 7 (modes), 12 (white
// runs) or 13 (black runs) bits, read LSB first, of what the code is, its
// length and its run. A bit string no code starts is kFaxNull of length 0;
// libtiff's EOL is 7 zeros among the modes and 11 among the runs.
enum : uint8_t {
  kFaxNull, kFaxPass, kFaxHoriz, kFaxV0, kFaxVR, kFaxVL, kFaxExt, kFaxTermW, kFaxTermB,
  kFaxMakeUpW, kFaxMakeUpB, kFaxMakeUp, kFaxEol
};

struct FaxEntry {
  uint8_t state, width;
  uint16_t param;
};

struct FaxTables {
  FaxEntry main[1 << 7], white[1 << 12], black[1 << 13];
  static void add(FaxEntry* t, int size, const char* code, uint8_t state, int param) {
    const int w = (int)std::strlen(code);
    int at = 0;
    for (int i = 0; i < w; ++i) at |= (code[i] - '0') << i;
    for (int k = at; k < 1 << size; k += 1 << w) t[k] = FaxEntry{state, (uint8_t)w, (uint16_t)param};
  }
  FaxTables() {
    std::memset(this, 0, sizeof *this);
    static const struct { const char* code; uint8_t state; int param; } modes[] = {
        {"0001", kFaxPass, 0},   {"001", kFaxHoriz, 0},   {"1", kFaxV0, 0},
        {"011", kFaxVR, 1},      {"000011", kFaxVR, 2},   {"0000011", kFaxVR, 3},
        {"010", kFaxVL, 1},      {"000010", kFaxVL, 2},   {"0000010", kFaxVL, 3},
        {"0000001", kFaxExt, 0}, {"0000000", kFaxEol, 0}};
    for (const auto& m : modes) add(main, 7, m.code, m.state, m.param);
    for (int c = 0; c < 2; ++c) {
      FaxEntry* t = c ? black : white;
      const int size = c ? 13 : 12;
      const char* const* codes = c ? kBlackCodes : kWhiteCodes;
      for (int i = 0; i < 64; ++i) add(t, size, codes[i], c ? kFaxTermB : kFaxTermW, i);
      for (int i = 0; i < 27; ++i) add(t, size, codes[64 + i], c ? kFaxMakeUpB : kFaxMakeUpW, 64 * (i + 1));
      for (int i = 0; i < 13; ++i) add(t, size, kExtendedCodes[i], kFaxMakeUp, 1792 + 64 * i);
      add(t, size, "00000000000", kFaxEol, 0);
    }
  }
};

const FaxTables& fax_tables() {
  static const FaxTables t;
  return t;
}

// What libtiff keeps of one image's fax decoding from strip to strip
// (Fax3CodecState): its run arrays, zeroed once and then holding each row's
// runs, which a damaged row may read past its reference line's end; and
// FAXMODE_NOEOL, set once a T.4 strip shows no EOL. In tiles, where
// TIFFReadEncodedTile takes the decoder's -1 for success (it tests the
// return for truth, TIFFReadEncodedStrip for <= 0), a tile that fails keeps
// the rows decoded and the buffer's rows after them.
struct FaxCodec {
  int width;
  uint32_t compression;
  bool two_d;  // a reference line: T.4 2-D or T.6
  bool no_eol;
  bool tiles;
  bool odd = false;  // the strip's data starts at an odd offset (RLE-W's word alignment)
  uint32_t nruns;
  std::vector<uint32_t> runs;  // current and reference line, nruns each
  FaxCodec(uint32_t w, uint32_t c, uint32_t t4opts, bool in_tiles)
      : width((int)w), compression(c), two_d(c == 4 || (c == 3 && (t4opts & 1))),
        no_eol(c == 2 || c == 32771), tiles(in_tiles) {
    nruns = (w + 1 + 31) / 32 * 32 * (two_d ? 2 : 1);
    runs.assign(2 * (size_t)nruns + 2, 0);
  }
};

struct FaxEof {};

// Bits x0 .. x1 of a row of 1-bit samples (MSB first) set or cleared.
inline void fax_span(uint8_t* row, uint32_t x0, uint32_t x1, bool black) {
  if (x0 >= x1) return;
  const uint32_t b0 = x0 >> 3, b1 = (x1 - 1) >> 3;
  const uint8_t head = (uint8_t)(0xFF >> (x0 & 7)), tail = (uint8_t)(0xFF << (7 - ((x1 - 1) & 7)));
  if (b0 == b1) {
    const uint8_t m = head & tail;
    row[b0] = black ? row[b0] | m : row[b0] & ~m;
    return;
  }
  row[b0] = black ? row[b0] | head : row[b0] & ~head;
  if (b1 > b0 + 1) std::memset(row + b0 + 1, black ? 0xFF : 0, b1 - b0 - 1);
  row[b1] = black ? row[b1] | tail : row[b1] & ~tail;
}

// One strip of `rows` rows as libtiff's decoder (Fax3DecodeRLE,
// Fax3Decode1D, Fax3Decode2D, Fax4Decode with the macros of tif_fax3.h)
// writes it into PIL's strip buffer `out` (rows of rb bytes): a bad code,
// an EOL inside a row or a row too long or short ends the row there, which
// is then cut or padded to the width in the colour it had reached
// (CLEANUP_RUNS) and kept as the next row's reference; T.4 finds the next
// row's EOL past what is left; past the data's end the reader takes zero
// bits while bits it took from the data are left unread. A T.4 strip whose
// EOL search runs out of data is read again from its first bit without
// EOLs, from that row on and in every later strip (FAXMODE_NOEOL). Group 4
// ends a strip at an EOL or the data's end, and keeps its decoded rows
// unless that was in the first; the rows it did not reach keep what the
// buffer held (the previous strip's rows; zeros before the first strip).
// Corrupt where libtiff's decoder returns -1, as PIL then refuses the file.
void fax_strip(FaxCodec& f, const uint8_t* d, size_t n, uint32_t rows, uint8_t* out, size_t rb) {
  const FaxTables& T = fax_tables();
  const uint8_t* rev = reversed_bits();  // libtiff's reader takes each byte's bits LSB first
  const int lastx = f.width;
  const uint32_t nruns = f.nruns;
  uint32_t* R = f.runs.data();
  uint32_t acc = 0;
  size_t cp = 0;
  int avail = 0, eolcnt = 0;
  const size_t ep = n;
  uint32_t cur = 0, ref = nruns, thisrun = 0, pa = 0, pb = 0;
  int a0 = 0, rl = 0, b1 = 0;
  auto need8 = [&](int k) __attribute__((always_inline)) {
    if (avail < k) {
      if (cp >= ep) {
        if (avail == 0) throw FaxEof{};
        avail = k;  // zeros
      } else {
        acc |= (uint32_t)rev[d[cp++]] << avail;
        avail += 8;
      }
    }
  };
  auto need16 = [&](int k) __attribute__((always_inline)) {
    if (avail < k) {
      if (cp >= ep) {
        if (avail == 0) throw FaxEof{};
        avail = k;
      } else {
        acc |= (uint32_t)rev[d[cp++]] << avail;
        if ((avail += 8) < k) {
          if (cp >= ep) {
            avail = k;
          } else {
            acc |= (uint32_t)rev[d[cp++]] << avail;
            avail += 8;
          }
        }
      }
    }
  };
  auto clr = [&](int k) __attribute__((always_inline)) {
    avail -= k;
    acc >>= k;
  };
  auto lookup = [&](const FaxEntry* t, int wid) __attribute__((always_inline)) -> const FaxEntry& {
    need16(wid);
    const FaxEntry& e = t[acc & ((1u << wid) - 1)];
    clr(e.width);
    return e;
  };
  auto setvalue = [&](int x) __attribute__((always_inline)) {
    if (pa >= thisrun + nruns) corrupt("CCITT row of more runs than libtiff's buffer");
    R[pa++] = (uint32_t)(rl + x);
    a0 += x;
    rl = 0;
  };
  auto cleanup = [&]() __attribute__((always_inline)) {  // CLEANUP_RUNS
    if (rl) setvalue(0);
    if (a0 != lastx) {
      while (a0 > lastx && pa > thisrun) a0 -= (int)R[--pa];
      if (a0 < lastx) {
        if (a0 < 0) a0 = 0;
        if ((pa - thisrun) & 1) setvalue(0);
        setvalue(lastx - a0);
      } else if (a0 > lastx) {
        setvalue(lastx);
        setvalue(0);
      }
    }
  };
  auto fill = [&](uint32_t y) __attribute__((always_inline)) {  // _TIFFFax3fillruns, which cuts the runs it is given to the row
    uint8_t* row = out + (size_t)y * rb;
    uint32_t e = pa, x = 0;
    if ((e - thisrun) & 1) R[e++] = 0;
    for (uint32_t i = thisrun; i < e; i += 2)
      for (int c = 0; c < 2; ++c) {
        const uint32_t run = R[i + c];
        if (x + run > (uint32_t)lastx || run > (uint32_t)lastx) R[i + c] = lastx - x;
        fax_span(row, x, x + R[i + c], c == 1);
        x += R[i + c];
      }
  };
  // EXPAND1D's runs up to its end (the row full, an EOL, a bad code);
  // FaxEof past the data.
  auto runs1d = [&]() __attribute__((always_inline)) {
    for (;;) {
      for (int black = 0; black < 2; ++black) {
        for (;;) {
          const FaxEntry& e = black ? lookup(T.black, 13) : lookup(T.white, 12);
          if (e.state == (black ? kFaxTermB : kFaxTermW)) {
            setvalue(e.param);
            break;
          }
          if (e.state == (black ? kFaxMakeUpB : kFaxMakeUpW) || e.state == kFaxMakeUp) {
            a0 += e.param;
            rl += e.param;
            continue;
          }
          if (e.state == kFaxEol) eolcnt = 1;
          return;
        }
        if (a0 >= lastx) return;
      }
      if (R[pa - 1] == 0 && R[pa - 2] == 0) pa -= 2;
    }
  };
  auto check_b1 = [&]() __attribute__((always_inline)) {
    if (pa != thisrun)
      while (b1 <= a0 && b1 < lastx) {
        if (pb + 1 >= ref + nruns) corrupt("CCITT reference line past libtiff's buffer");
        b1 += (int)(R[pb] + R[pb + 1]);
        pb += 2;
      }
  };
  // EXPAND2D up to its end.
  auto runs2d = [&]() __attribute__((always_inline)) {
    while (a0 < lastx) {
      if (pa >= thisrun + nruns) corrupt("CCITT row of more runs than libtiff's buffer");
      need8(7);
      const FaxEntry& e = T.main[acc & 0x7F];
      clr(e.width);
      switch (e.state) {
        case kFaxPass:
          check_b1();
          if (pb + 1 >= ref + nruns) corrupt("CCITT reference line past libtiff's buffer");
          b1 += (int)R[pb++];
          rl += b1 - a0;
          a0 = b1;
          b1 += (int)R[pb++];
          break;
        case kFaxHoriz:
          for (int k = 0; k < 2; ++k) {  // black first after an odd number of runs
            const bool black = ((pa - thisrun) & 1) != 0;
            for (;;) {
              const FaxEntry& r = black ? lookup(T.black, 13) : lookup(T.white, 12);
              if (r.state == (black ? kFaxTermB : kFaxTermW)) {
                setvalue(r.param);
                break;
              }
              if (r.state == (black ? kFaxMakeUpB : kFaxMakeUpW) || r.state == kFaxMakeUp) {
                a0 += r.param;
                rl += r.param;
                continue;
              }
              return;
            }
          }
          check_b1();
          break;
        case kFaxV0:
        case kFaxVR:
          check_b1();
          setvalue(b1 - a0 + e.param);
          if (pb >= ref + nruns) corrupt("CCITT reference line past libtiff's buffer");
          b1 += (int)R[pb++];
          break;
        case kFaxVL:
          check_b1();
          if (b1 < a0 + e.param) return;
          setvalue(b1 - a0 - e.param);
          b1 -= (int)R[--pb];
          break;
        case kFaxExt:
          R[pa++] = (uint32_t)(lastx - a0);
          return;
        case kFaxEol:
          R[pa++] = (uint32_t)(lastx - a0);
          need8(4);
          clr(4);
          eolcnt = 1;
          return;
        default:
          return;
      }
    }
    if (rl) {
      if (rl + a0 < lastx) {  // a final V0
        need8(1);
        if (!(acc & 1)) return;
        clr(1);
      }
      setvalue(0);
    }
  };
  auto expand = [&](bool two) __attribute__((always_inline)) {  // the runs, then CLEANUP_RUNS, also past the data's end
    try {
      two ? runs2d() : runs1d();
    } catch (const FaxEof&) {
      cleanup();
      throw;
    }
    cleanup();
  };
  auto sync_eol = [&]() __attribute__((always_inline)) {  // SYNC_EOL
    if (eolcnt == 0)
      for (;;) {
        need16(11);
        if ((acc & 0x7FF) == 0) break;
        clr(1);
      }
    for (;;) {
      need8(8);
      if (acc & 0xFF) break;
      clr(8);
    }
    while (!(acc & 1)) clr(1);
    clr(1);
    eolcnt = 0;
  };

  if (f.two_d) {
    R[ref] = (uint32_t)lastx;
    R[ref + 1] = 0;
  }
  for (uint32_t y = 0; y < rows; ++y) {
    a0 = rl = 0;
    thisrun = pa = cur;
    if (f.compression == 4) {
      pb = ref;
      b1 = (int)R[pb++];
      bool eof = false;
      try {
        expand(true);
      } catch (const FaxEof&) {
        eof = true;
      }
      if (!eof && !eolcnt) {
        fill(y);
        setvalue(0);
        std::swap(cur, ref);
        continue;
      }
      try {  // the EOFB
        need16(13);
      } catch (const FaxEof&) {
      }
      clr(13);
      fill(y);
      if (y == 0) corrupt("CCITT Group 4 strip that ends in its first row");
      return;
    }
    if (f.compression == 2 || f.compression == 32771) {
      try {
        expand(false);
      } catch (const FaxEof&) {
        fill(y);
        corrupt("CCITT data ends early");
      }
      fill(y);
      if (f.compression == 2) {
        clr(avail & 7);  // the row ends on a byte
        continue;
      }
      // RLE-W: the row ends on a 16-bit word as libtiff's reader sees it:
      // the bits held past a multiple of 16 dropped, then, with none held,
      // the read pointer moved to an even address (PIL hands libtiff the
      // file at an even address, so a strip at an odd offset is off by one).
      clr(avail & 15);
      if (avail == 0 && ((cp + f.odd) & 1)) ++cp;
      continue;
    }
    bool is1d = true;
    try {
      if (!f.no_eol) {
        try {
          sync_eol();
        } catch (const FaxEof&) {
          f.no_eol = true;  // read again from the strip's first bit, without EOLs
          acc = 0;
          cp = 0;
          avail = eolcnt = 0;
        }
      }
      if (f.two_d) {
        need8(1);
        is1d = acc & 1;
        clr(1);
        pb = ref;
        b1 = (int)R[pb++];
      }
    } catch (const FaxEof&) {
      cleanup();
      fill(y);
      corrupt("CCITT data ends early");
    }
    try {
      expand(!is1d);
    } catch (const FaxEof&) {
      fill(y);
      corrupt("CCITT data ends early");
    }
    fill(y);
    if (f.two_d) {
      if (pa < thisrun + nruns) setvalue(0);
      std::swap(cur, ref);
    }
  }
}

// 1-bit samples, MSB first -> 8 grey pixels per byte: 255 for a 1 bit, or
// for a 0 bit when `inverted` (WhiteIsZero).
const uint8_t (*bilevel_lut(bool inverted))[8] {
  static const auto tables = [] {
    std::vector<uint8_t> t(2 * 256 * 8);
    for (int inv = 0; inv < 2; ++inv)
      for (int b = 0; b < 256; ++b)
        for (int k = 0; k < 8; ++k)
          t[(inv * 256 + b) * 8 + k] = ((b >> (7 - k)) & 1) != inv ? 255 : 0;
    return t;
  }();
  return reinterpret_cast<const uint8_t(*)[8]>(tables.data() + (inverted ? 256 * 8 : 0));
}

struct Chunks {  // a TIFF's strips or tiles
  const std::vector<uint32_t>& offsets;
  const std::vector<uint32_t>& counts;
  uint32_t cw, ch;  // a chunk's size
  bool tiles;
  int sub_h, sub_v;  // the YCbCrSubsampling tag, 0 when the file has none
};

// Whether PIL's TiffImagePlugin.OPEN_INFO holds a mode for this layout:
// the byte order, photometric, SampleFormat (one value when every sample's
// is 1), FillOrder, BitsPerSample (one per sample, a single value repeated)
// and ExtraSamples as the file gives them. PIL refuses any other, and more
// than 6 samples.
struct TiffLayout {
  bool be;
  uint32_t photometric, fill, spp;
  std::vector<uint32_t> fmt, bps, extra;
};

// Not inlined, and its arguments by reference: decode_tiff keeps its frame
// (see jpeg_tiff).
[[gnu::noinline]] bool pil_tiff_mode(const TiffLayout& layout) {
  const bool be = layout.be;
  const uint32_t photo = layout.photometric, fill = layout.fill, spp = layout.spp;
  std::vector<uint32_t> fmt = layout.fmt, bps = layout.bps;
  const std::vector<uint32_t>& extra = layout.extra;
  if (spp > 6) return false;
  if (bps.size() > spp) bps.resize(spp);
  if (bps.size() == 1 && spp > 1) bps.assign(spp, bps[0]);
  if (bps.size() != spp || spp == 0) return false;
  if (fmt.size() > 1 && std::all_of(fmt.begin(), fmt.end(), [](uint32_t f) { return f == 1; }))
    fmt.assign(1, 1);
  if (fmt.size() != 1 || (fill != 1 && fill != 2)) return false;
  const uint32_t f = fmt[0], b = bps[0], n = spp;
  for (uint32_t v : bps)
    if (v != b) return false;
  auto extra_is = [&](std::initializer_list<uint32_t> e) {
    return extra.size() == e.size() && std::equal(e.begin(), e.end(), extra.begin());
  };
  const bool none = extra.empty(), low = b == 1 || b == 2 || b == 4 || b == 8;
  switch (photo) {
    case 0:
    case 1:
      if (!none) return photo == 1 && f == 1 && fill == 1 && b == 8 && n == 2 && extra_is({2});
      if (n != 1) return false;
      if (f == 1 && low) return true;
      if (fill == 2) return photo == 1 && f == 1 && b == 16 && !be;
      if (f == 1) return photo == 0 ? b == 16 && !be : (b == 12 && !be) || b == 16 || (b == 32 && !be);
      if (f == 2) return photo == 1 && (b == 8 || b == 16 || b == 32);
      return f == 3 && b == 32;
    case 2:
      if (f != 1) return false;
      if (fill == 2) return b == 8 && n == 3 && none;
      if (b == 16) return (n == 3 && none) || (n == 4 && (none || extra_is({0}) || extra_is({1}) || extra_is({2})));
      if (b != 8) return false;
      if (n == 3 || (n == 4 && none)) return none;
      if (n == 4 && extra_is({999})) return true;
      if (extra.size() != n - 3 || extra[0] > 2) return false;
      return std::all_of(extra.begin() + 1, extra.end(), [](uint32_t e) { return e == 0; });
    case 3:
      if (f != 1) return false;
      if (n == 1) return low && none;
      return fill == 1 && n == 2 && b == 8 && (extra_is({0}) || extra_is({2}));
    case 5:
      if (f != 1 || fill != 1) return false;
      if (b == 16) return n == 4 && none;
      return b == 8 && ((n == 4 && none) || (n == 5 && extra_is({0})) || (n == 6 && extra_is({0, 0})));
    case 6:
      return f == 1 && fill == 1 && b == 8 && none && (n == 1 || n == 3);
    case 8:
      return f == 1 && fill == 1 && b == 8 && none && n == 3;
    default:
      return false;
  }
}

// JPEG-in-TIFF: each strip or tile a JPEG stream, read by one decoder, so
// that the tables of JPEGTables (the entry `tables`, if not 0) and any a
// stream defines carry over to the next stream, as in libjpeg. libtiff's
// checks: a stream holds the file's samples per pixel, its luma sampling is
// the YCbCr subsampling (that of the first stream, as libtiff's tag fix-up
// reads it; 1 x 1 for grey and RGB) and its chroma 1 x 1, and its size is
// the strip's or tile's (a last strip may be taller, and is cropped). PIL
// asks libtiff for RGB (JPEGCOLORMODE_RGB), so libjpeg upsamples and
// converts YCbCr within each stream; an RGB file's components are taken as
// they are. Not inlined, so that the JPEG decoder stays out of
// decode_tiff's frame, and six arguments, all in registers: a call that
// passes some on the stack makes GCC give decode_tiff a frame pointer, one
// register fewer for its sample loops.
[[gnu::noinline]] void jpeg_tiff(const Tiff& t, size_t tables, uint32_t photometric,
                                 uint32_t spp, const Chunks& c, Gray& g) {
  const uint8_t* d = t.d;
  const size_t n = t.n;
  const uint32_t cw = c.cw, ch = c.ch;
  Jpeg jp;
  if (tables) {
    auto [at, len] = t.bytes(tables);
    jp.begin(d + at, len);
    jp.markers(true);
  }
  const uint32_t W = g.w, H = g.h, across = (W + cw - 1) / cw, down = (H + ch - 1) / ch;
  // The YCbCr subsampling: the tag's, else the first stream's luma
  // sampling (libtiff's tag fix-up); libtiff takes 1, 2 or 4 only.
  int sub_h = c.sub_h, sub_v = c.sub_v;
  std::vector<uint8_t> stream;
  for (uint32_t ty = 0; ty < down; ++ty) {
    for (uint32_t tx = 0; tx < across; ++tx) {
      const size_t idx = (size_t)ty * across + tx, off = c.offsets[idx], cnt = c.counts[idx];
      const uint32_t y0 = ty * ch, x0 = tx * cw, rows = c.tiles ? ch : std::min(ch, H - y0);
      if (off > n || cnt > n - off) corrupt("TIFF strip outside the file");
      // libtiff feeds libjpeg an EOI once a strip's bytes run out
      // (std_fill_input_buffer), so a stream cut short still decodes.
      stream.assign(d + off, d + off + cnt);
      stream.insert(stream.end(), {0xFF, 0xD9});
      jp.begin(stream.data(), stream.size());
      Gray px = jp.run(photometric == 6 ? kColorYcc : kColorAsIs);
      if ((uint32_t)jp.ncomp != spp) corrupt("JPEG-in-TIFF stream with the wrong component count");
      if (photometric == 6 && sub_h == 0) {
        sub_h = jp.comp[0].h;
        sub_v = jp.comp[0].v;
      }
      if (photometric == 6)
        for (int f : {sub_h, sub_v})
          if (f != 1 && f != 2 && f != 4)
            corrupt("JPEG-in-TIFF with YCbCr subsampling " + std::to_string(f));
      const int want_h = photometric == 6 ? sub_h : 1, want_v = photometric == 6 ? sub_v : 1;
      for (int i = 0; i < jp.ncomp; ++i)
        if (jp.comp[i].h != (i ? 1 : want_h) || jp.comp[i].v != (i ? 1 : want_v))
          corrupt("JPEG-in-TIFF stream with improper sampling factors");
      const bool exact = c.tiles || y0 + rows < H;
      if ((uint32_t)px.w != cw || (uint32_t)px.h < rows || (exact && (uint32_t)px.h != rows))
        corrupt("JPEG-in-TIFF stream of the wrong size");
      const uint32_t nr = std::min(rows, H - y0), nc = std::min(cw, W - x0);
      for (uint32_t r = 0; r < nr; ++r)
        memcpy(&g.px[(size_t)(y0 + r) * W + x0], &px.px[(size_t)r * px.w], nc);
    }
  }
}

// libtiff's YCbCr -> RGB (tif_color.c TIFFYCbCrToRGBInit, TIFFYCbCrtoRGB),
// which its RGBA reader (tif_getimage.c) applies to YCbCr that libjpeg has
// not converted: tables in 16-bit fixed point from the YCbCrCoefficients
// and ReferenceBlackWhite tags, in float as libtiff computes them.
struct TiffYcc {
  int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256], y[256];
  TiffYcc(const float* luma, const float* rbw) {
    auto fix = [](float x) { return (int32_t)(x * (float)(1L << 16) + 0.5); };
    auto clampf = [](float f, float lo, float hi) { return f < lo ? lo : f > hi ? hi : f; };
    auto code2v = [](int c, float rb, float rw, float cr) {
      return ((float)(c - (int32_t)rb) * cr) / (rw - rb != 0 ? rw - rb : 1.0f);
    };
    const float f1 = 2 - 2 * luma[0], f2 = luma[0] * f1 / luma[1];
    const float f3 = 2 - 2 * luma[2], f4 = luma[2] * f3 / luma[1];
    const int32_t d1 = fix(clampf(f1, 0, 2)), d2 = -fix(clampf(f2, 0, 2));
    const int32_t d3 = fix(clampf(f3, 0, 2)), d4 = -fix(clampf(f4, 0, 2));
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      const int32_t cr = (int32_t)clampf(code2v(x, rbw[4] - 128, rbw[5] - 128, 127), -4096, 4096);
      const int32_t cb = (int32_t)clampf(code2v(x, rbw[2] - 128, rbw[3] - 128, 127), -4096, 4096);
      cr_r[i] = (d1 * cr + (1 << 15)) >> 16;
      cb_b[i] = (d3 * cb + (1 << 15)) >> 16;
      cr_g[i] = d2 * cr;
      cb_g[i] = d4 * cb + (1 << 15);
      y[i] = (int32_t)clampf(code2v(x + 128, rbw[0], rbw[1], 255), -4096, 4096);
    }
  }
  uint8_t grey(int yy, int cb, int cr) const {  // then PIL's RGB -> L
    const int32_t v = y[yy];
    return luma(clamp255(v + cr_r[cr]), clamp255(v + (int32_t)((cb_g[cb] + cr_g[cr]) >> 16)),
                  clamp255(v + cb_b[cb]));
  }
  uint8_t component(int yy, int cb, int cr, int i) const {  // R, G, B or A of the RGBA
    const int32_t v = y[yy];
    return i == 0   ? clamp255(v + cr_r[cr])
           : i == 1 ? clamp255(v + (int32_t)((cb_g[cb] + cr_g[cr]) >> 16))
           : i == 2 ? clamp255(v + cb_b[cb])
                    : 255;
  }
};

// The YCbCr subsamplings tif_getimage.c has a reader for: 4 x 4, 4 x 2,
// 4 x 1, 2 x 2, 2 x 1, 1 x 2, 1 x 1.
bool rgba_subsampling(int h, int v) {
  return (h == 4 && (v == 4 || v == 2 || v == 1)) || (h == 2 && (v == 2 || v == 1)) ||
         (h == 1 && (v == 2 || v == 1));
}

// The YCbCr conversion of a file's YCbCrCoefficients and
// ReferenceBlackWhite (libtiff's defaults where absent).
TiffYcc tiff_ycc(const Tiff& t, size_t coefficients, size_t refbw) {
  float luma[3] = {0.299f, 0.587f, 0.114f}, rbw[6] = {0, 255, 128, 255, 128, 255};
  if (coefficients) {
    const std::vector<float> v = t.rationals(coefficients);
    if (v.size() < 3) corrupt("bad YCbCrCoefficients tag");
    std::copy(v.begin(), v.begin() + 3, luma);
  }
  if (refbw) {
    const std::vector<float> v = t.rationals(refbw);
    if (v.size() < 6) corrupt("bad ReferenceBlackWhite tag");
    std::copy(v.begin(), v.begin() + 6, rbw);
  }
  if (std::isnan(luma[0]) || std::isnan(luma[1]) || luma[1] == 0 || std::isnan(luma[2]))
    corrupt("bad YCbCrCoefficients tag");
  return TiffYcc(luma, rbw);
}

struct OJpegTags {  // IFD entries, 0 where absent
  size_t jif, jif_len, restart, qtables, dctables, actables, coefficients, refbw;
};

// Old-style JPEG-in-TIFF (compression 6), as libtiff's tif_ojpeg.c reads it
// for PIL. libtiff builds one JPEG stream for libjpeg: its header from the
// marker segments at the front of a byte source (the JPEGInterchangeFormat
// bytes, then every strip's) up to SOS, or, when that source does not start
// with a marker, from the tables that JPEGQTables, JPEGDCTables and
// JPEGACTables point at and a frame of the strip's size with the YCbCr
// subsampling; then the rest of the source as the scan, an RSTn after each
// strip but the last, EOI. Strips shorter than the image make the restart
// interval a strip's MCUs (a DRI in the stream overrides it). Grey comes out
// as libjpeg decodes it. YCbCr (photometric 6, or libtiff's reading of 2)
// comes out of libjpeg raw, each component at its own resolution, when the
// stream's luma sampling is 1, 2 or 4 each way and its chroma 1 x 1; PIL
// then reads it through libtiff's RGBA reader: a block of h x v pixels takes
// its Cb and Cr as they are, converted by TiffYcc. Other sampling libjpeg
// upsamples itself (libtiff's "desubsampling inside decompression") before
// TiffYcc converts each pixel. Not inlined, six register arguments: see
// jpeg_tiff.
[[gnu::noinline]] void ojpeg_tiff(const Tiff& t, const OJpegTags& oj, uint32_t photometric,
                                  uint32_t spp, const Chunks& c, Gray& g) {
  const uint8_t* d = t.d;
  const size_t fsize = t.n;
  // libtiff's striles: strips of RowsPerStrip rows, or tiles, each read as
  // `rps` rows of a frame `sw` wide, one strile after another (a tile's
  // rows follow the previous tile's), the frame `total` rows high unless
  // the stream's own frame says otherwise.
  const uint32_t W = g.w, H = g.h, rps = c.ch, sw = c.tiles ? c.cw : W;
  const uint32_t across = (W + sw - 1) / sw, down = (H + rps - 1) / rps, nstrips = across * down;
  const uint32_t total = c.tiles ? down * rps : H;
  const bool ycc = spp == 3;
  if (ycc && photometric != 6 && photometric != 2)  // libtiff's OJPEG decoder fails (PIL refuses)
    corrupt("old-style JPEG-in-TIFF of 3 samples in photometric " + std::to_string(photometric));
  if (!ycc && photometric == 6)
    corrupt("old-style JPEG-in-TIFF of one YCbCr sample, which libtiff's RGBA reader refuses");
  // The byte source, and where each strip's bytes end in it.
  std::vector<uint8_t> src;
  std::vector<size_t> strip_end;
  if (oj.jif) {
    const size_t off = t.values(oj.jif).at(0);
    if (off < fsize) {
      size_t len = oj.jif_len ? t.values(oj.jif_len).at(0) : 0;
      if (len == 0 || len > fsize - off) len = fsize - off;
      src.assign(d + off, d + off + len);
    }
  }
  const size_t jif_size = src.size();
  for (uint32_t i = 0; i < nstrips; ++i) {
    const size_t off = c.offsets[i];
    if (off != 0 && off < fsize) {
      size_t cnt = c.counts[i];
      if (cnt == 0 || cnt > fsize - off) cnt = fsize - off;
      src.insert(src.end(), d + off, d + off + cnt);
    }
    strip_end.push_back(src.size());
  }
  // The subsampling: the stream's luma sampling when its header holds a
  // frame, else the tag's (2 x 2 by default); 1 x 1 for grey.
  int sub_h = 1, sub_v = 1;
  bool desub = false;  // libjpeg upsamples
  size_t p = 0;
  auto byte = [&]() -> int {
    if (p >= src.size()) corrupt("old-style JPEG-in-TIFF data ends early");
    return src[p++];
  };
  auto word = [&]() { return (byte() << 8) | byte(); };
  if (ycc) {
    sub_h = c.sub_h ? c.sub_h : 2;
    sub_v = c.sub_v ? c.sub_v : 2;
    for (size_t q = 0; q + 1 < src.size() && src[q] == 0xFF;) {  // a first pass to the frame
      int m = src[++q];
      while (m == 0xFF && q + 1 < src.size()) m = src[++q];
      ++q;
      if (m == 0xD8) continue;
      if (m == 0xDA || q + 2 > src.size()) break;
      const size_t len = (src[q] << 8) | src[q + 1];
      if (m == 0xC0 || m == 0xC1 || m == 0xC3) {
        if (len < 11 || (len - 8) % 3 || q + len > src.size()) break;
        const int nf = (int)(len - 8) / 3;
        for (int k = 0; k < nf; ++k) {
          const int hv = src[q + 9 + 3 * k];  // after Lf, P, Y, X, Nf and the id
          if (k == 0) {
            sub_h = hv >> 4;
            sub_v = hv & 15;
            for (int f : {sub_h, sub_v}) desub = desub || (f != 1 && f != 2 && f != 4);
          } else {
            desub = desub || hv != 0x11;
          }
        }
        break;
      }
      q += len;
    }
    if (desub) sub_h = sub_v = 1;
  }
  int restart = oj.restart ? (int)t.values(oj.restart).at(0) : 0;
  if (rps < H) {
    for (int f : {sub_h, sub_v})
      if (f != 1 && f != 2 && f != 4)
        corrupt("old-style JPEG-in-TIFF with YCbCr subsampling " + std::to_string(f));
    if (rps % (8 * sub_v)) corrupt("old-style JPEG-in-TIFF strips not whole MCU rows");
    restart = (int)(((sw + 8 * sub_h - 1) / (8 * sub_h)) * (rps / (8 * sub_v)));
  }
  // The header: libtiff's OJPEGReadHeaderInfoSec, segment by segment.
  std::vector<uint8_t> qseg[4], dcseg[4], acseg[4];
  int sof_marker = 0xC0, sof_x = (int)sw, sof_y = (int)total;
  int sof_c[3] = {0, 1, 2}, sof_hv[3] = {sub_h << 4 | sub_v, 0x11, 0x11}, sof_tq[3] = {0, 0, 0};
  int sos_cs[3] = {0, 1, 2}, sos_tda[3] = {0, 0, 0};
  bool have_sof = false;
  while (p < src.size() && src[p] == 0xFF) {
    ++p;
    int m;
    do m = byte();
    while (m == 0xFF);
    if (m == 0xD8) continue;
    if (m == 0xFE || (m >= 0xE0 && m <= 0xEF)) {
      const int len = word();
      if (len < 2) corrupt("bad JPEG marker segment in old-style JPEG-in-TIFF");
      p = std::min(src.size(), p + len - 2);
    } else if (m == 0xDD) {
      if (word() != 4) corrupt("bad DRI segment in old-style JPEG-in-TIFF");
      restart = word();
    } else if (m == 0xDB) {
      int len = word();
      if (len <= 2) corrupt("bad DQT segment in old-style JPEG-in-TIFF");
      for (len -= 2; len > 0; len -= 65) {
        if (len < 65) corrupt("bad DQT segment in old-style JPEG-in-TIFF");
        std::vector<uint8_t> s{0xFF, 0xDB, 0, 67};
        for (int k = 0; k < 65; ++k) s.push_back((uint8_t)byte());
        if ((s[4] & 15) > 3) corrupt("bad DQT segment in old-style JPEG-in-TIFF");
        qseg[s[4] & 15] = s;
      }
    } else if (m == 0xC4) {
      const int len = word();
      if (len <= 2) corrupt("bad DHT segment in old-style JPEG-in-TIFF");
      std::vector<uint8_t> s{0xFF, 0xC4, (uint8_t)(len >> 8), (uint8_t)len};
      for (int k = 0; k < len - 2; ++k) s.push_back((uint8_t)byte());
      const int o = s[4];
      if (((o & 0xF0) != 0 && (o & 0xF0) != 0x10) || (o & 15) > 3)
        corrupt("bad DHT segment in old-style JPEG-in-TIFF");
      ((o & 0xF0) ? acseg : dcseg)[o & 15] = s;
    } else if (m == 0xC0 || m == 0xC1 || m == 0xC3) {
      if (have_sof) corrupt("old-style JPEG-in-TIFF with two frames");
      sof_marker = m;
      const int len = word();
      if (len < 11 || (len - 8) % 3 || (len - 8) / 3 != (int)spp)
        corrupt("old-style JPEG-in-TIFF frame of the wrong sample count");
      if (byte() != 8) corrupt("old-style JPEG-in-TIFF not of 8 bits");
      sof_y = word();
      sof_x = word();
      if ((uint32_t)sof_y < std::min(H, total) || (uint32_t)sof_x != sw)
        corrupt("old-style JPEG-in-TIFF frame of the wrong size");
      if (byte() != (int)spp) corrupt("bad frame in old-style JPEG-in-TIFF");
      for (uint32_t k = 0; k < spp; ++k) {
        sof_c[k] = byte();
        sof_hv[k] = byte();
        if (!desub && sof_hv[k] != (k ? 0x11 : (sub_h << 4 | sub_v)))
          corrupt("old-style JPEG-in-TIFF frame with unexpected subsampling");
        sof_tq[k] = byte();
      }
      have_sof = true;
    } else if (m == 0xDA) {
      if (word() != 6 + 2 * (int)spp || byte() != (int)spp)
        corrupt("bad SOS in old-style JPEG-in-TIFF");
      for (uint32_t k = 0; k < spp; ++k) {
        sos_cs[k] = byte();
        sos_tda[k] = byte();
      }
      for (int k = 0; k < 3; ++k) byte();
      break;
    } else {
      corrupt("unknown JPEG marker in old-style JPEG-in-TIFF");
    }
  }
  if (!have_sof) {
    // The tables of the tags: per sample an offset, each new one (not the
    // previous sample's) a table of its own; an offset seen two samples
    // back is corrupt (tif_ojpeg.c's check).
    const std::vector<uint32_t> none;
    auto tag = [&](size_t e) { return e ? t.values(e) : none; };
    const std::vector<uint32_t> offs[3] = {tag(oj.qtables), tag(oj.dctables), tag(oj.actables)};
    for (int kind = 0; kind < 3; ++kind) {
      const std::vector<uint32_t>& v = offs[kind];
      auto at = [&](uint32_t k) { return k < v.size() ? v[k] : 0u; };
      if (!at(0)) corrupt("old-style JPEG-in-TIFF without JPEG tables");
      for (uint32_t k = 0; k < spp; ++k) {
        const size_t off = at(k);
        if (!off || (k && off == at(k - 1))) {  // the previous sample's table
          if (kind == 0) sof_tq[k] = sof_tq[k - 1];
          if (kind == 1) sos_tda[k] = sos_tda[k - 1];
          if (kind == 2) sos_tda[k] |= sos_tda[k - 1] & 15;
          continue;
        }
        for (uint32_t m = 0; m + 1 < k; ++m)
          if (at(m) == off) corrupt("old-style JPEG-in-TIFF with a bad JPEG tables tag");
        size_t len = 64;
        if (kind && off + 16 <= fsize) {
          len = 16;
          for (int b = 0; b < 16; ++b) len += d[off + b];
        }
        if (off + len > fsize) corrupt("old-style JPEG-in-TIFF table outside the file");
        std::vector<uint8_t>& seg = (kind == 0 ? qseg : kind == 1 ? dcseg : acseg)[k];
        if (kind == 0) {
          seg = {0xFF, 0xDB, 0, 67, (uint8_t)k};
          sof_tq[k] = (int)k;
        } else {
          seg = {0xFF, 0xC4, (uint8_t)((len + 3) >> 8), (uint8_t)(len + 3),
                 (uint8_t)((kind - 1) << 4 | k)};
          sos_tda[k] = kind == 1 ? (int)k << 4 : sos_tda[k] | (int)k;
        }
        seg.insert(seg.end(), d + off, d + off + len);
      }
    }
  }
  // The stream libjpeg reads.
  std::vector<uint8_t> s{0xFF, 0xD8};
  for (auto* set : {qseg, dcseg, acseg})
    for (int k = 0; k < 4; ++k) s.insert(s.end(), set[k].begin(), set[k].end());
  if (restart) s.insert(s.end(), {0xFF, 0xDD, 0, 4, (uint8_t)(restart >> 8), (uint8_t)restart});
  s.insert(s.end(), {0xFF, (uint8_t)sof_marker, 0, (uint8_t)(8 + 3 * spp), 8, (uint8_t)(sof_y >> 8),
                     (uint8_t)sof_y, (uint8_t)(sof_x >> 8), (uint8_t)sof_x, (uint8_t)spp});
  for (uint32_t k = 0; k < spp; ++k)
    s.insert(s.end(), {(uint8_t)sof_c[k], (uint8_t)sof_hv[k], (uint8_t)sof_tq[k]});
  s.insert(s.end(), {0xFF, 0xDA, 0, (uint8_t)(6 + 2 * spp), (uint8_t)spp});
  for (uint32_t k = 0; k < spp; ++k) s.insert(s.end(), {(uint8_t)sos_cs[k], (uint8_t)sos_tda[k]});
  s.insert(s.end(), {0, 63, 0});
  // The scan: what the header left of the source, an RSTn after each
  // strip's last bytes but the last strip's.
  if (p < jif_size) s.insert(s.end(), src.begin() + p, src.begin() + jif_size);
  for (uint32_t i = 0, rst = 0; i < nstrips; ++i) {
    const size_t from = std::max(p, i ? strip_end[i - 1] : jif_size), to = strip_end[i];
    if (from >= to) continue;
    s.insert(s.end(), src.begin() + from, src.begin() + to);
    if (i + 1 < nstrips) {
      s.insert(s.end(), {0xFF, (uint8_t)(0xD0 + rst)});
      rst = (rst + 1) & 7;
    }
  }
  // libtiff writes EOI once it has handed on the last strile's bytes; when
  // that strile has none (no offset, or one past the end of the file), the
  // stream ends after the previous strile's RSTn.
  const size_t last_off = nstrips ? c.offsets[nstrips - 1] : 0;
  const bool eoi = last_off != 0 && last_off < fsize;
  if (eoi) s.insert(s.end(), {0xFF, 0xD9});
  // A stop in a strip fails its read: PIL refuses the file, unless it is
  // the last strip of YCbCr, which libtiff's RGBA reader takes with the
  // rows from the stopped MCU row on left zero (Y = Cb = Cr = 0). Tiles
  // (C.17): PIL asks the reader for a row of tiles a call; the tile that
  // stops is zeroed, and each later one fails before it is read (libtiff
  // skips the stopped tile's rows again), which the reader ignores, the
  // zeroed buffer standing, unless it is the first tile of a call: so YCbCr
  // reads with the stopped tile and the rest of its row zero when the stop
  // is in the last row of tiles, and PIL refuses it otherwise.
  Jpeg jp;
  jp.begin(s.data(), s.size());
  jp.old_tiff = true;
  jp.open_end = !eoi;
  uint32_t good_rows = sof_y, stopped = nstrips;  // the strile a stop came in
  try {
    jp.planes();
  } catch (const OldTiffStop&) {
    good_rows = (uint32_t)jp.stop_row * 8 * jp.vmax;
    if (c.tiles) {
      stopped = std::min(good_rows / rps, nstrips - 1);
      good_rows = sof_y;
    }
    if (!ycc || (c.tiles ? stopped / across + 1 < down : good_rows / rps + 1 < nstrips))
      corrupt("old-style JPEG-in-TIFF stopped by a restart marker out of place or the end of its "
              "data (libtiff stops there)");
  }
  const Component* cp = jp.comp;
  static const float kLuma[3] = {0.299f, 0.587f, 0.114f}, kRbw[6] = {0, 255, 128, 255, 128, 255};
  const TiffYcc conv = ycc ? tiff_ycc(t, oj.coefficients, oj.refbw) : TiffYcc(kLuma, kRbw);
  if (ycc && desub)
    corrupt("old-style JPEG-in-TIFF of a sampling libtiff leaves to libjpeg (PIL refuses it)");
  if (ycc && !rgba_subsampling(sub_h, sub_v))
    corrupt("old-style JPEG-in-TIFF with YCbCr subsampling libtiff's RGBA reader refuses");
  // Each strile's rows to its place: frame row m * rps + r is row r of
  // strile m. Tiles past the frame's last row (the tables layout's frame
  // is one column of tiles high) are read all the same, libjpeg giving no
  // more rows: grey rows then keep PIL's tile buffer (the previous tile's
  // rows), YCbCr ones the last iMCU row libtiff's raw buffer holds. YCbCr
  // rows past a stop read Y = Cb = Cr = 0.
  const uint32_t imcu = 8 * (ycc ? sub_v : 1), last = ((uint32_t)sof_y + imcu - 1) / imcu * imcu - imcu;
  const uint8_t blank = ycc ? conv.grey(0, 0, 0) : 0;
  std::vector<uint8_t> held((size_t)rps * sw, 0);  // PIL's tile buffer (grey)
  for (uint32_t m = 0; m < nstrips; ++m) {
    const uint32_t x0 = (m % across) * sw, y0 = (m / across) * rps, nc = std::min(sw, W - x0);
    for (uint32_t r = 0; r < rps; ++r) {
      uint32_t v = m * rps + r;
      uint8_t* o = y0 + r < H ? &g.px[(size_t)(y0 + r) * W + x0] : nullptr;
      if (!ycc) {
        uint8_t* b = &held[(size_t)r * sw];
        if (v < (uint32_t)sof_y) memcpy(b, &cp[0].plane[(size_t)v * cp[0].pw], sw);
        if (o) memcpy(o, b, nc);
        continue;
      }
      if (!o) continue;
      if (v >= (uint32_t)sof_y) v = good_rows < (uint32_t)sof_y ? good_rows : last + v % imcu;
      if (v >= good_rows || m >= stopped) {
        std::fill(o, o + nc, blank);
        continue;
      }
      const uint8_t* yr = &cp[0].plane[(size_t)v * cp[0].pw];
      const uint8_t* cb = &cp[1].plane[(size_t)(v / sub_v) * cp[1].pw];
      const uint8_t* cr = &cp[2].plane[(size_t)(v / sub_v) * cp[2].pw];
      for (uint32_t x = 0; x < nc; ++x) o[x] = conv.grey(yr[x], cb[x / sub_h], cr[x / sub_h]);
    }
  }
}

// Grey TIFF numbers (PIL's modes I;12, I;16S, I;32S, I;32N and F;32F) to
// PIL's convert("L"): an integer clipped to 0 .. 255 (a uint32 read as
// PIL's int32 first), a float clipped and truncated, NaN to 0. libtiff
// returns 16- and 32-bit samples of a compressed file in the host's byte
// order, which PIL then reads in the file's: so a big-endian file's
// samples come out byte-swapped unless it is uncompressed. That is
// `le`, the order the rows are read in here, where a row's bytes stand in
// the file's order (the predictors below keep that order).
struct NumberGrey {
  int bits, fmt;  // 12 (fmt 1), 16 (fmt 2) or 32 (fmt 1, 2 or 3)
  bool be, le;    // the file's byte order; the order PIL reads a row in
  int predictor;  // 1, or 2 / 3 under a predicting codec
  size_t rb;      // bytes a chunk row
  uint32_t cw;    // samples a chunk row
};

inline uint8_t clip_int(int32_t v) { return (uint8_t)(v <= 0 ? 0 : v >= 255 ? 255 : v); }

// Rows `rows` of a chunk at (x0, y0), decompressed into `buf`, to grey.
// Predictor 2 adds each sample to its left neighbour's (in the file's byte
// order, modulo its size); predictor 3 is libtiff's fpAcc: the row's bytes
// summed left to right, then each sample's bytes taken from the row's byte
// planes, the most significant plane first.
[[gnu::noinline]] void number_rows(const NumberGrey& f, uint8_t* buf, uint32_t rows, uint32_t x0,
                                   uint32_t y0, Gray& g) {
  const uint32_t W = g.w, H = g.h, bps = f.bits / 8;
  std::vector<uint8_t> tmp(f.predictor == 3 ? f.rb : 0);
  auto rd = [](const uint8_t* p, int k, bool le) {
    uint32_t v = 0;
    for (int i = 0; i < k; ++i) v |= (uint32_t)p[le ? i : k - 1 - i] << (8 * i);
    return v;
  };
  for (uint32_t r = 0; r < rows && y0 + r < H; ++r) {
    uint8_t* row = buf + r * f.rb;
    if (f.predictor == 2) {
      for (uint32_t c = 1; c < f.cw; ++c) {
        const uint32_t v = rd(row + bps * c, bps, !f.be) + rd(row + bps * (c - 1), bps, !f.be);
        for (uint32_t i = 0; i < bps; ++i)
          row[bps * c + (f.be ? bps - 1 - i : i)] = (uint8_t)(v >> (8 * i));
      }
    } else if (f.predictor == 3) {
      for (size_t i = 1; i < f.rb; ++i) row[i] = (uint8_t)(row[i] + row[i - 1]);
      memcpy(tmp.data(), row, f.rb);
      for (uint32_t c = 0; c < f.cw; ++c)
        for (uint32_t b = 0; b < bps; ++b)  // plane b holds byte b, most significant first
          row[bps * c + (f.be ? b : bps - 1 - b)] = tmp[(size_t)b * f.cw + c];
    }
    uint8_t* o = &g.px[(size_t)(y0 + r) * W + x0];
    const uint32_t n = std::min(f.cw, W - x0);
    for (uint32_t c = 0; c < n; ++c) {
      if (f.bits == 12) {  // MSB first, two samples in three bytes
        const uint8_t* p = row + (size_t)c * 3 / 2;
        o[c] = clip_int(c & 1 ? ((p[0] & 15) << 8) | p[1] : (p[0] << 4) | (p[1] >> 4));
      } else if (f.bits == 16) {
        o[c] = clip_int((int16_t)rd(row + 2 * c, 2, f.le));
      } else if (f.fmt != 3) {
        o[c] = clip_int((int32_t)rd(row + 4 * c, 4, f.le));
      } else {
        const uint32_t u = rd(row + 4 * c, 4, f.le);
        float v;
        memcpy(&v, &u, sizeof v);
        o[c] = v > 0.0f ? (v >= 255.0f ? 255 : (uint8_t)v) : 0;  // NaN: 0
      }
    }
  }
}

// How PIL's ImageFileDirectory_v2 takes an IFD entry. It drops one of a
// type it has no loader for (0, 14, 15, 17, 18, past 18) or of no values;
// it stops reading the directory at an entry whose values run past the end
// of the file (`cut`: that entry's position), keeping the entries before
// it; it reads BYTE and UNDEFINED as bytes and ASCII as a string, which
// match no number, RATIONAL, FLOAT and DOUBLE as numbers, which match an
// integer only when whole, and the integer types (SHORT, LONG, IFD, LONG8
// and the signed ones) as integers.
struct PilTag {
  bool present = false;  // PIL keeps the entry
  bool ints = false;     // its values match integers 0 .. 2^32 - 1
  bool exact = false;    // and are of an integer type (what PIL's size and offsets must be)
  std::vector<uint32_t> v;
};

PilTag pil_tag(const Tiff& t, size_t e, size_t cut) {
  PilTag k;
  if (!e || e >= cut) return k;
  const Tiff::Entry x = t.entry(e);
  const uint32_t ty = x.type;
  if (!x.fits || x.count == 0 || ty == 0 || ty == 14 || ty == 15 || ty > 16) return k;
  k.present = true;
  if (ty == 1 || ty == 2 || ty == 7) return k;
  k.ints = true;
  for (uint64_t i = 0; i < x.count && k.ints; ++i) {
    const double v = t.number(x, i);
    k.ints = v >= 0 && v <= 4294967295.0 && v == std::floor(v);
    k.v.push_back(k.ints ? (uint32_t)v : 0);
  }
  k.exact = k.ints && ty != 5 && ty != 10 && ty != 11 && ty != 12;
  return k;
}

// Whether libtiff (tif_dirread.c) reads an entry as integers: BYTE, SHORT,
// LONG, LONG8 and their signed forms (not IFD), no value negative. It fails
// the directory on any other in a tag it needs (the size, the strip and
// tile layout, the sample layout, compression) and drops it in the rest.
bool libtiff_ints(const Tiff& t, size_t e, uint64_t limit = ~0ull) {
  Tiff::Entry x = t.entry(e);
  const uint32_t ty = x.type;
  if (!(ty == 1 || ty == 3 || ty == 4 || ty == 6 || ty == 8 || ty == 9 || ty == 16 || ty == 17))
    return false;
  if (x.count > limit) {  // a longer strip or tile array libtiff reads no further than it needs
    x.count = limit;
    x.fits = x.at <= t.n && limit * Tiff::type_size(ty) <= t.n - x.at;
  }
  if (!x.fits) return false;
  for (uint64_t i = 0; i < x.count; ++i)
    if (t.number(x, i) < 0) return false;
  return true;
}

// A TIFF's first directory as the decoder uses it: what PIL's own reading
// decides (the size, the mode's tags, the route: libtiff for a compressed
// file, PIL's raw decoder for an uncompressed one, and on the raw route the
// strips or tiles), and on the libtiff route what libtiff reads.
struct TiffDir {
  uint32_t W = 0, H = 0, compression = 1, photometric = 0, fill = 1, spp = 1, rps = 0xFFFFFFFF,
           planar = 1, predictor = 1, tw = 0, th = 0, t4opts = 0;
  uint32_t codec_fill = 1;  // libtiff's FillOrder: 2 reverses each byte's bits before a codec
  uint32_t lt_spp = 1, lt_bps = 1, lt_planar = 1;  // libtiff's sample layout
  uint32_t lt_compression = 1, lt_photometric = 0;  // libtiff's (a tag given twice: its first)
  bool lt_cmap = false;  // libtiff holds a ColorMap (of 3 << BitsPerSample entries)
  uint32_t lt_fmt = 1;   // libtiff's SampleFormat
  std::vector<uint32_t> bps{1}, offsets, counts, cmap, extra, fmt{1}, ycbcr_sub;
  bool strips = false, tiles = false, has_photometric = false, has_spp = false;
  size_t jpeg_tables = 0;  // the JPEGTables entry, 0 where absent
  OJpegTags oj{};  // old-style JPEG's entries, and YCbCr's colour tags
};

// libtiff's EstimateStripByteCounts for a compressed file without
// StripByteCounts (or with one strip of none): each strip the file's size
// less the header, the directory and the values it points at (a share of
// that a plane), the last strip cut at the end of the file.
void estimate_counts(const Tiff& t, size_t first, uint64_t count, TiffDir& dir) {
  const size_t width = t.big ? 20 : 12, slot = t.big ? 8 : 4;
  uint64_t space = (t.big ? 16 + 8 + 8 : 8 + 2 + 4) + count * width;
  for (uint64_t i = 0; i < count; ++i) {
    const size_t e = first + width * i;
    const int size = Tiff::type_size(t.r16(e + 2));
    if (size == 0) corrupt("TIFF without StripByteCounts and an entry of an unknown type");
    const uint64_t bytes = (uint64_t)size * (t.big ? t.r64(e + 4) : t.r32(e + 4));
    if (bytes > slot) space += bytes;
  }
  uint64_t share = t.n < space ? t.n : t.n - space;
  if (dir.lt_planar == 2) share /= dir.lt_spp;
  dir.counts.assign(dir.offsets.size(), (uint32_t)std::min<uint64_t>(share, 0xFFFFFFFF));
  if (!dir.offsets.empty()) {
    const uint64_t last = dir.offsets.back();
    if (last >= t.n)
      dir.counts.back() = 0;
    else if (last + dir.counts.back() > t.n)
      dir.counts.back() = (uint32_t)(t.n - last);
  }
}

[[gnu::noinline]] void read_tiff_dir(const Tiff& t, TiffDir& dir) {
  const size_t ifd = t.offset(t.big ? 8 : 4);
  uint64_t count = t.big ? t.r64(ifd) : t.r16(ifd);
  const size_t first = ifd + (t.big ? 8 : 2), width = t.big ? 20 : 12;
  if (first > t.n) corrupt("TIFF file ends early");
  // PIL reads the entries the file holds; libtiff needs the whole directory.
  const bool whole_dir = count <= (t.n - first) / width;
  count = std::min<uint64_t>(count, (t.n - first) / width);
  size_t cut = first + width * count;
  // The entries of the tags the decoder reads: PIL keeps the last of a tag
  // given twice among those it reads (`p`), libtiff the first (`q`).
  struct Entries {
    size_t w, h, bps, comp, photo, fill, soff, spp, rps, scnt, planar, t4, pred, cmap, tw, th,
        toff, tcnt, extra, fmt, sub, tables, jif, jif_len, restart, qtables, dctables, actables,
        coefficients, refbw;
  } p{}, q{};
  static const uint16_t kTags[] = {256, 257, 258, 259, 262, 266, 273, 277, 278, 279, 284, 292, 317, 320, 322,
                                   323, 324, 325, 338, 339, 530, 347, 513, 514, 515, 519, 520, 521, 529, 532};
  static_assert(sizeof(kTags) / sizeof(kTags[0]) == sizeof(Entries) / sizeof(size_t), "a tag a field");
  bool twice = false;  // a tag given twice
  for (uint64_t i = 0; i < count; ++i) {
    const size_t e = first + width * i;
    const uint32_t ty = t.r16(e + 2);
    if (cut == first + width * count && ty >= 1 && ty <= 16 && ty != 14 && ty != 15 &&
        !t.entry(e).fits) {
      cut = e;
      // PIL seeks to the values: past 2^63 Python's seek overflows, and
      // PIL's open fails.
      const uint64_t size = Tiff::type_size(ty) * t.entry(e).count;
      if (t.big && size > 8 && t.r64(e + 12) >> 63) corrupt("BigTIFF offset past 2^63");
    }
    const uint16_t* tag = std::find(std::begin(kTags), std::end(kTags), t.r16(e));
    if (tag == std::end(kTags)) continue;
    size_t* pf = &p.w + (tag - kTags);
    size_t* qf = &q.w + (tag - kTags);
    twice = twice || *qf;
    if (!*qf) *qf = e;
    if (e < cut) *pf = e;
  }
  dir.jpeg_tables = q.tables;  // libtiff's alone
  dir.oj = OJpegTags{q.jif, q.jif_len, q.restart, q.qtables, q.dctables, q.actables, q.coefficients, q.refbw};
  // PIL: the size must be integers; the tags of its mode key (and the
  // compression, looked up in a table) must match integers.
  const PilTag w = pil_tag(t, p.w, cut), h = pil_tag(t, p.h, cut);
  if (!w.exact || !h.exact) corrupt("TIFF size PIL does not read (ImageWidth, ImageLength)");
  dir.W = w.v[0];
  dir.H = h.v[0];
  auto key = [&](size_t e, std::vector<uint32_t>& out, const char* what) {
    const PilTag k = pil_tag(t, e, cut);
    if (k.present && !k.ints) corrupt(std::string("TIFF ") + what + " that PIL matches to no value");
    if (k.present) out = k.v;
    return k.present;
  };
  std::vector<uint32_t> v;
  if (key(p.comp, v, "compression")) dir.compression = v[0];
  if ((dir.has_photometric = key(p.photo, v, "photometric"))) dir.photometric = v[0];
  if (key(p.fill, v, "FillOrder")) dir.fill = v[0];
  if ((dir.has_spp = key(p.spp, v, "SamplesPerPixel"))) dir.spp = v[0];
  key(p.bps, dir.bps, "BitsPerSample");
  key(p.extra, dir.extra, "ExtraSamples");
  key(p.fmt, dir.fmt, "SampleFormat");
  const PilTag pl = pil_tag(t, p.planar, cut);
  dir.planar = pl.ints && pl.v[0] == 2 ? 2 : 1;
  const PilTag cm = pil_tag(t, p.cmap, cut);
  if (cm.exact) dir.cmap = cm.v;  // else no colour map: a palette is corrupt
  if (dir.compression == 1) {
    // PIL's raw decoder: the strips (StripOffsets, RowsPerStrip) or tiles
    // of its own reading, the counts unused.
    dir.strips = p.soff && p.soff < cut;
    dir.tiles = !dir.strips && p.toff && p.toff < cut;
    const PilTag off = pil_tag(t, dir.strips ? p.soff : p.toff, cut);
    if (!off.present) corrupt("TIFF has no image data");
    if (!off.exact) corrupt("TIFF strip or tile offsets PIL does not read");
    dir.offsets = off.v;
    if (dir.strips) {
      const PilTag r = pil_tag(t, p.rps, cut);
      if (r.present && !r.exact) corrupt("TIFF RowsPerStrip PIL does not read");
      if (r.present) dir.rps = r.v[0];
    } else {
      const PilTag a = pil_tag(t, p.tw, cut), b = pil_tag(t, p.th, cut);
      if (!a.exact || !b.exact) corrupt("TIFF tile size PIL does not read");
      dir.tw = a.v[0];
      dir.th = b.v[0];
    }
    return;
  }
  // libtiff's directory: the tags it needs as integers, the rest dropped
  // when of another type (their defaults then).
  if (!whole_dir) corrupt("TIFF directory past the end of the file");
  // EvaluateIFDdatasizeReading: every entry's values, and their sum out of
  // the entries, in 64 bits.
  uint64_t held = 0;
  for (uint64_t i = 0; i < count; ++i) {
    const size_t e = first + width * i;
    const uint64_t size = Tiff::type_size(t.r16(e + 2)), n = t.big ? t.r64(e + 4) : t.r32(e + 4);
    if (size && n > ~0ull / size) corrupt("TIFF entry of more data than 64 bits count");
    if (size * n > (t.big ? 8u : 4u) && (held += size * n) < size * n)
      corrupt("TIFF entries of more data than 64 bits count");
  }
  // PIL's libtiff decoder refuses an image whose size or bits a sample a
  // tag given twice makes libtiff read otherwise than PIL.
  const uint32_t pil_v[3] = {dir.W, dir.H, dir.bps.empty() ? 1 : dir.bps[0]};
  const size_t lt_first[3] = {q.w, q.h, q.bps};
  for (int k = 0; twice && k < 3; ++k)
    if (lt_first[k] && libtiff_ints(t, lt_first[k]) && t.values(lt_first[k]).at(0) != pil_v[k])
      corrupt("TIFF whose size or sample bits libtiff reads otherwise than PIL (a tag given twice)");
  if (t.big && (t.r16(4) != 8 || t.r16(6) != 0)) corrupt("BigTIFF of offsets not of 8 bytes");
  auto refuses = [&](size_t e) {
    corrupt("TIFF tag " + std::to_string(t.r16(e)) + " of type " + std::to_string(t.r16(e + 2)) +
            ", which libtiff refuses");
  };
  for (size_t e : {q.w, q.h, q.bps, q.comp, q.spp, q.rps, q.planar, q.tw, q.th, q.extra, q.fmt})
    if (e && !libtiff_ints(t, e)) refuses(e);
  // One value, or for BitsPerSample, Compression and SampleFormat one a
  // sample, all alike (TIFFReadDirEntryPersampleShort); a tag libtiff may
  // drop it drops for another count.
  for (size_t e : {q.w, q.h, q.spp, q.rps, q.planar, q.tw, q.th})
    if (e && t.entry(e).count != 1) refuses(e);
  const uint32_t spp1 = q.spp ? t.values(q.spp).at(0) : 1;
  for (size_t e : {q.bps, q.comp, q.fmt}) {
    if (!e || t.entry(e).count == 1) continue;
    const std::vector<uint32_t> v = t.values(e);
    if (v.size() < spp1 || std::count(v.begin(), v.begin() + spp1, v[0]) != (long)spp1) refuses(e);
  }
  auto dropped = [&](size_t e, uint32_t fallback) {
    return e && t.entry(e).count == 1 && libtiff_ints(t, e) ? t.values(e).at(0) : fallback;
  };
  if (q.planar && t.values(q.planar).at(0) != 1 && t.values(q.planar).at(0) != 2)
    corrupt("TIFF PlanarConfiguration not 1 or 2 (libtiff refuses it)");
  dir.lt_spp = spp1;
  dir.lt_compression = q.comp ? t.values(q.comp).at(0) : 1;
  dir.lt_photometric = dropped(q.photo, dir.photometric);
  dir.lt_fmt = q.fmt && libtiff_ints(t, q.fmt) ? t.values(q.fmt).at(0) : 1;
  dir.lt_bps = q.bps ? t.values(q.bps).at(0) : 1;
  dir.lt_planar = q.planar ? t.values(q.planar).at(0) : 1;
  dir.lt_cmap = q.cmap && dir.lt_bps <= 24 && t.entry(q.cmap).count == (3ull << dir.lt_bps);
  dir.predictor = dropped(q.pred, 1);
  dir.codec_fill = dropped(q.fill, 1);
  if (dir.codec_fill != 2) dir.codec_fill = 1;
  dir.t4opts = dropped(q.t4, 0);
  if (q.sub && libtiff_ints(t, q.sub)) dir.ycbcr_sub = t.values(q.sub);
  if (q.rps) dir.rps = t.values(q.rps).at(0);
  if (q.tw) dir.tw = t.values(q.tw).at(0);
  if (q.th) dir.th = t.values(q.th).at(0);
  // libtiff's strips a plane: none (an error) for RowsPerStrip 0, or one
  // so near 2^32 that TIFFhowmany_32 overflows.
  if (dir.rps == 0 || (dir.rps != 0xFFFFFFFF && dir.H >= 0xFFFFFFFFu - (dir.rps - 1)))
    corrupt("TIFF RowsPerStrip libtiff counts no strips for");
  // libtiff: tiles where the file gives a tile size (TileWidth or
  // TileLength, C.19), whichever offsets and counts it gives: StripOffsets
  // and TileOffsets are one field, the later entry's.
  const bool tiled = q.tw || q.th;
  const size_t offs = std::max(q.soff, q.toff), counts = std::max(q.scnt, q.tcnt);
  dir.tiles = tiled && offs;
  dir.strips = !tiled && offs;
  if (!dir.strips && !dir.tiles) corrupt("TIFF has no image data");
  if (tiled && (dir.tw == 0 || dir.th == 0)) corrupt("TIFF tile size of 0 (libtiff counts no tiles)");
  // libtiff reads a strip or tile array no further than the chunks it
  // needs, and pads a shorter one with zeros.
  const auto howmany = [](uint64_t a, uint64_t b) { return b ? (a + b - 1) / b : 0; };
  const uint64_t need =
      (dir.tiles ? howmany(dir.W, dir.tw) * howmany(dir.H, dir.th)
                 : howmany(dir.H, std::min<uint64_t>(dir.rps, dir.H))) *
      (dir.lt_planar == 2 ? dir.lt_spp : 1);
  for (size_t e : {offs, counts})
    if (e && !libtiff_ints(t, e, need)) refuses(e);
  dir.offsets = t.values(offs, need);
  if (counts) dir.counts = t.values(counts, need);
  if (dir.offsets.size() < need) dir.offsets.resize(need, 0);
  if (counts && dir.counts.size() < need) dir.counts.resize(need, 0);
  const size_t nchunks = dir.offsets.size();
  if (!counts || (nchunks == 1 && dir.strips && dir.counts.at(0) == 0 && dir.offsets[0] != 0)) {
    // libtiff estimates the counts of one strip (or one a plane) only.
    if (!counts &&
        ((dir.lt_planar == 1 && nchunks > 1) || (dir.lt_planar == 2 && nchunks != dir.lt_spp)))
      corrupt("TIFF strip byte counts missing");
    estimate_counts(t, first, count, dir);
  }
}

// ThunderScan 4-bit data (compression 32809) as libtiff's ThunderDecodeRow
// decodes a strip or tile into PIL's buffer `out` (`want` bytes, what the
// buffer held kept where nothing is written): rows of TIFFScanlineSize
// bytes, each of the image's width in pixels, from one run of code bytes.
// A code's top two bits: a run of the last pixel (its low 6 bits long;
// written unless it runs past the row, an odd start completing the
// half-written byte first), three 2-bit deltas, two 3-bit
// deltas (a delta of the skip code writes nothing), or a raw 4-bit pixel.
// A row of too few or too many pixels clears its rest and fails the strip.
void thunder(const uint8_t* s, size_t n, size_t want, uint32_t width, std::vector<uint8_t>& out) {
  static const int two[4] = {0, 1, 0, -1}, three[8] = {0, 1, 2, 3, 0, -3, -2, -1};
  const size_t line = ((size_t)width * 4 + 7) / 8;
  out.resize(want);
  if (line == 0 || want % line) corrupt("ThunderScan TIFF of fractional scanlines");
  size_t at = 0;
  for (size_t row = 0; row < want; row += line) {
    uint8_t* const op0 = &out[row];
    uint8_t* op = op0;
    unsigned last = 0;
    int64_t np = 0;
    const int64_t maxp = width;
    auto set = [&](unsigned v) {  // SETPIXEL
      last = v & 0xF;
      if (np < maxp) {
        if (np++ & 1)
          *op++ |= (uint8_t)last;
        else
          op[0] = (uint8_t)(last << 4);
      }
    };
    while (at < n && np < maxp) {
      const int c = s[at++];
      switch (c & 0xC0) {
        case 0x00: {
          int k = c & 0x3F;
          if (np & 1) {
            op[0] |= (uint8_t)last;
            last = *op++;
            ++np;
            --k;
          } else {
            last |= last << 4;
          }
          np += k;
          if (np <= maxp)
            for (; k > 0; k -= 2) *op++ = (uint8_t)last;
          if (k == -1) *--op &= 0xF0;
          last &= 0xF;
          break;
        }
        case 0x40:
          for (int shift : {4, 2, 0})
            if (((c >> shift) & 3) != 2) set((unsigned)((int)last + two[(c >> shift) & 3]));
          break;
        case 0x80:
          for (int shift : {3, 0})
            if (((c >> shift) & 7) != 4) set((unsigned)((int)last + three[(c >> shift) & 7]));
          break;
        default:
          set((unsigned)c);
          break;
      }
    }
    if (np != maxp) {
      std::fill(op, op0 + (maxp + 1) / 2, 0);
      corrupt(np < maxp ? "ThunderScan row of too few pixels" : "ThunderScan row of too many pixels");
    }
  }
}

// JPEG-in-TIFF through libtiff's JPEG codec (JPEGDecode) as a strip or
// tile codec, for what PIL unpacks as samples: one component a chunk (grey
// of photometric 0 or 3, 12-bit grey, a plane of a planar file), or
// several as they are (libtiff's JCS_UNKNOWN: grey or RGB with extra
// samples, CMYK with extra samples). One decoder, so that JPEGTables' and
// each stream's tables carry over. libtiff's checks, as jpeg_tiff's: the
// stream holds the chunk's samples a pixel, each component 1 x 1, the
// chunk's width and its rows (a last strip's stream may be taller, and is
// cropped), and the TIFF's bits a sample (8 or 12: Jpeg::allow_precision).
// 12-bit samples come out two in three bytes, MSB first; libtiff packs a
// row's samples in pairs, so of an odd count the last is not written (it
// stays zero here).
struct TiffJpeg {
  Jpeg jp;
  uint32_t per = 1;   // samples a chunk's pixel
  bool tiles = false;
  bool last = false;  // the chunk is the image's last strip
  std::vector<uint8_t> stream;
};

[[gnu::noinline]] void jpeg_chunk(TiffJpeg& j, const uint8_t* s, size_t cnt, uint32_t cw, uint32_t rows,
                                  size_t want, std::vector<uint8_t>& out) {
  // libtiff feeds libjpeg an EOI once a strip's bytes run out.
  j.stream.assign(s, s + cnt);
  j.stream.insert(j.stream.end(), {0xFF, 0xD9});
  Jpeg& jp = j.jp;
  jp.begin(j.stream.data(), j.stream.size());
  jp.planes();
  if ((uint32_t)jp.ncomp != j.per) corrupt("JPEG-in-TIFF stream with the wrong component count");
  for (int i = 0; i < jp.ncomp; ++i)
    if (jp.comp[i].h != 1 || jp.comp[i].v != 1) corrupt("JPEG-in-TIFF stream with improper sampling factors");
  if ((uint32_t)jp.W != cw || (uint32_t)jp.H < rows || ((j.tiles || !j.last) && (uint32_t)jp.H != rows))
    corrupt("JPEG-in-TIFF stream of the wrong size");
  out.assign(want, 0);
  const size_t rb = want / rows;
  for (uint32_t r = 0; r < rows; ++r) {
    uint8_t* o = &out[(size_t)r * rb];
    if (jp.precision == 12) {
      const uint16_t* v = &jp.comp[0].plane12[(size_t)r * jp.comp[0].pw];
      for (uint32_t x = 0; x + 1 < cw; x += 2, o += 3) {
        o[0] = (uint8_t)((v[x] & 0xFF0) >> 4);
        o[1] = (uint8_t)((v[x] & 0xF) << 4 | (v[x + 1] & 0xF00) >> 8);
        o[2] = (uint8_t)v[x + 1];
      }
      continue;
    }
    for (uint32_t k = 0; k < j.per; ++k) {
      const uint8_t* v = &jp.comp[k].plane[(size_t)r * jp.comp[k].pw];
      for (uint32_t x = 0; x < cw; ++x) o[(size_t)x * j.per + k] = v[x];
    }
  }
}

// A strip's or tile's bytes from the file, decompressed into `want` bytes
// of `out` (CCITT: `rows` rows of cw samples, over what `out` held from the
// previous strip, as PIL's strip buffer), each byte's bits reversed first
// for FillOrder 2; `out` keeps what a failing codec decoded. Not inlined,
// six register arguments (see jpeg_tiff).
struct TiffCodec {
  const Tiff* t;
  uint32_t compression, cw;
  bool reverse;
  FaxCodec* fax;  // the fax codings' state from strip to strip
  // LZW: -1 until the first strip is read, then whether that strip was
  // old-style (first byte 0, low bit of the second set), which libtiff then
  // takes for every strip of the image.
  int* lzw_old;
  TiffJpeg* jpeg;  // JPEG-in-TIFF as a codec
  uint32_t width;  // the image's (a ThunderScan row's pixels)
};


[[gnu::noinline]] void tiff_chunk(const TiffCodec& k, size_t off, size_t cnt, size_t want,
                                  uint32_t rows, std::vector<uint8_t>& out) {
  const Tiff& t = *k.t;
  std::vector<uint8_t> rev;
  const uint8_t* s = t.d + off;
  if (!k.fax && k.compression != 32809) out.clear();
  if (k.compression == 1) {
    if (off > t.n || want > t.n - off) corrupt("TIFF image data ends early");
    cnt = want;
  } else if (off > t.n || cnt > t.n - off) {
    corrupt("TIFF strip outside the file");
  }
  if (k.reverse) {
    const uint8_t* r = reversed_bits();
    rev.resize(cnt);
    for (size_t i = 0; i < cnt; ++i) rev[i] = r[s[i]];
    s = rev.data();
  }
  switch (k.compression) {
    case 1: out.assign(s, s + want); break;
    case 2: case 3: case 4: case 32771:  // into PIL's strip buffer, which keeps what libtiff does not write
      out.resize(want);
      k.fax->odd = off & 1;
      try {
        fax_strip(*k.fax, s, cnt, rows, out.data(), ((size_t)k.cw + 7) / 8);
      } catch (const DecodeError&) {
        if (!k.fax->tiles) throw;
      }
      break;
    case 5:
      if (*k.lzw_old < 0) *k.lzw_old = cnt >= 2 && s[0] == 0 && (s[1] & 1);
      *k.lzw_old ? lzw_compat(s, cnt, want, out) : lzw(s, cnt, want, out);
      break;
    case 7: jpeg_chunk(*k.jpeg, s, cnt, k.cw, rows, want, out); break;
    case 32809: thunder(s, cnt, want, k.width, out); break;
    case 8: case 32946: inflate_zlib(s, cnt, want, out); break;
    case 34925: unxz(s, cnt, want, out); break;
    case 50000: unzstd(s, cnt, want, out); break;
    default: packbits(s, cnt, want, out); break;
  }
}

// YCbCr outside JPEG, as PIL reads it through libtiff's RGBA reader
// (TIFFRGBAImage, tif_getimage.c; PIL's _decodeAsRGBA): per block of h x v
// pixels its luma samples with the block's Cb and Cr (as they are: no
// upsampling) through TiffYcc; planar files three planes of 1 x 1
// subsampling. The subsamplings tif_getimage.c has a reader for: 4 x 4,
// 4 x 2, 4 x 1, 2 x 2, 2 x 1, 1 x 2, 1 x 1 (planar: 1 x 1). Chunky strips
// hold rows of blocks (h x v luma samples, Cb, Cr); of a strip libtiff
// decodes (its rows rounded up to v) x TIFFScanlineSize bytes, the
// scanline being a block row's bytes over v rounded down, so the end of a
// strip whose blocks a row are odd under v = 4 is not read (it stays
// zero). The reader reads on from a strip or tile its codec cannot decode
// whole (PIL asks it not to stop on errors), with what the codec gave and
// zeros for the rest of what it was asked for.
[[gnu::noinline]] void ycbcr_rgba(const TiffCodec& k, const TiffDir& dir, const TiffYcc& conv,
                                  std::vector<uint8_t>* rgba, Gray& g) {
  const uint32_t W = dir.W, H = dir.H;
  const bool bytes_of_rgba = rgba != nullptr;
  // Each pixel's Y, Cb, Cr where PIL unpacks the RGBA rows as bytes.
  std::vector<uint8_t> ycc(bytes_of_rgba ? (size_t)W * H * 3 : 0);
  auto put = [&](uint32_t yy, uint32_t xx, int Y, int cb, int cr) {
    const size_t i = (size_t)yy * W + xx;
    if (!bytes_of_rgba) {
      g.px[i] = conv.grey(Y, cb, cr);
      return;
    }
    ycc[3 * i] = (uint8_t)Y;
    ycc[3 * i + 1] = (uint8_t)cb;
    ycc[3 * i + 2] = (uint8_t)cr;
  };
  const bool tiles = dir.tiles;
  const uint32_t cw = tiles ? dir.tw : W, ch = tiles ? dir.th : std::min(dir.rps ? dir.rps : H, H);
  if (cw == 0 || ch == 0) corrupt("bad TIFF tile size");
  int sh = 2, sv = 2;  // libtiff's default
  if (dir.ycbcr_sub.size() >= 2) {
    sh = (int)dir.ycbcr_sub[0];
    sv = (int)dir.ycbcr_sub[1];
  }
  const bool planar = dir.lt_planar == 2;  // libtiff's reader, on libtiff's route
  // PIL's _decodeAsRGBA sizes a buffer of RowsPerStrip (or the tile's
  // height) rows of 4-byte pixels, and refuses one past INT_MAX bytes.
  const uint32_t block_rows = tiles ? dir.th : dir.rps == 0xFFFFFFFF ? H : dir.rps;
  if (block_rows > 2147483647u / 4 / W) corrupt("YCbCr TIFF of more rows a strip than PIL's buffer");
  if (!rgba_subsampling(sh, sv) || (planar && (sh != 1 || sv != 1)))
    corrupt("YCbCr TIFF of a subsampling libtiff's RGBA reader has no reader for");
  const uint32_t across = (W + cw - 1) / cw, down = (H + ch - 1) / ch;
  const size_t per_plane = (size_t)across * down;
  if (dir.offsets.size() < per_plane * (planar ? 3 : 1) || dir.counts.size() < dir.offsets.size())
    corrupt("TIFF has too few strips or tiles");
  const uint32_t bcols = (cw + sh - 1) / sh;
  const size_t unit = (size_t)sh * sv + 2, brow = (size_t)bcols * unit;
  const size_t row_bytes = planar ? cw : brow / sv;  // TIFFScanlineSize, TIFFTileRowSize
  const uint32_t full_brows = (ch + sv - 1) / sv;
  std::vector<uint8_t> held[3], got;
  for (size_t idx = 0; idx < per_plane; ++idx) {
    const uint32_t y0 = (uint32_t)(idx / across) * ch, x0 = (uint32_t)(idx % across) * cw;
    const uint32_t rows = tiles ? ch : std::min(ch, H - y0), brows = (rows + sv - 1) / sv;
    // What libtiff asks of the codec: a tile whole; a strip's rows rounded
    // up to v, of the scanline's bytes, no more than the strip holds.
    const size_t whole = planar ? (size_t)cw * rows : brow * brows;
    const size_t want = tiles ? whole : std::min(whole, (size_t)brows * sv * row_bytes);
    // PIL asks the reader for a strip, or a row of tiles, a call; each call
    // reads into a new zeroed buffer, which the call's first read allocates:
    // libtiff stops the call (and PIL refuses the file) where that read
    // finds no data (no bytes, or bytes past the end of the file), and
    // reads on past a later one, as zeros.
    const bool call = !tiles || idx % across == 0;
    if (call)
      for (auto& b : held) b.assign(planar ? (size_t)cw * ch : brow * full_brows, 0);
    for (int p = 0; p < (planar ? 3 : 1); ++p) {
      const size_t i = idx + (size_t)p * per_plane;
      const size_t off = dir.offsets[i], cnt = dir.counts[i];
      if (cnt == 0 || off > k.t->n || cnt > k.t->n - off) {
        if (call && p == 0) corrupt("YCbCr TIFF strip or tile libtiff cannot read");
        std::fill(held[p].begin(), held[p].begin() + want, 0);
        continue;
      }
      bool whole_chunk = true;
      try {
        tiff_chunk(k, off, cnt, want, rows, got);
      } catch (const DecodeError&) {
        whole_chunk = false;
      }
      const size_t n = std::min(got.size(), want);  // a codec that runs short zeroes the rest
      std::copy(got.begin(), got.begin() + n, held[p].begin());
      std::fill(held[p].begin() + n, held[p].begin() + want, 0);
      // libtiff's predictor, after a codec that filled the request: rows of
      // TIFFScanlineSize (a strip) or TIFFTileRowSize (a tile: the tile's
      // width x samples, blind to subsampling), samples a pixel apart; a
      // request or row it does not divide it leaves as it is.
      const size_t prow = tiles ? (size_t)cw * (planar ? 1 : 3) : row_bytes;
      const size_t step = planar ? 1 : 3;
      if (whole_chunk && dir.predictor == 2 && prow && want % prow == 0 && prow % step == 0)
        for (size_t a = 0; a < want; a += prow)
          for (size_t q = step; q < prow; ++q)
            held[p][a + q] = (uint8_t)(held[p][a + q] + held[p][a + q - step]);
    }
    if (planar) {
      for (uint32_t r = 0; r < rows && y0 + r < H; ++r)
        for (uint32_t c = 0; c < cw && x0 + c < W; ++c) {
          const size_t q = (size_t)r * cw + c;
          put(y0 + r, x0 + c, held[0][q], held[1][q], held[2][q]);
        }
      continue;
    }
    // A tile past the image's right edge: the put routine skips the blocks
    // past the edge after each block row, by (tile width - width) / h
    // blocks; tif_getimage.c's 4 x 4 routine counts them 10 bytes each (its
    // 4 x 2 routine's), not 18.
    const uint8_t* buf = held[0].data();
    const uint32_t vis = std::min(cw, W - x0), used = (vis + sh - 1) / sh;
    const size_t step = tiles && vis < cw
                            ? used * unit + (size_t)((cw - vis) / sh) * (sh == 4 && sv == 4 ? 10 : unit)
                            : brow;
    for (uint32_t br = 0; br < brows; ++br)
      for (uint32_t bc = 0; bc < used; ++bc) {
        const uint8_t* u = &buf[br * step + bc * unit];
        const int cb = u[unit - 2], cr = u[unit - 1];
        for (int j = 0; j < sv; ++j) {
          const uint32_t yy = y0 + br * sv + j;
          if (br * sv + j >= rows || yy >= H) break;
          for (int i = 0; i < sh; ++i) {
            const uint32_t xx = x0 + bc * sh + i;
            if (bc * sh + i >= cw || xx >= W) break;
            put(yy, xx, u[j * sh + i], cb, cr);
          }
        }
      }
  }
  if (bytes_of_rgba) {  // the reader's RGBA rows, for PIL's raw mode to unpack
    rgba->resize((size_t)W * H * 4);
    for (size_t i = 0; i < (size_t)W * H; ++i)
      for (int c = 0; c < 4; ++c) (*rgba)[4 * i + c] = conv.component(ycc[3 * i], ycc[3 * i + 1], ycc[3 * i + 2], c);
  }
}

// PIL's raw route where it reads otherwise than the file's layout: planar
// files and YCbCr. TiffImageFile._setup gives each offset a tile: strips of
// the image's width and RowsPerStrip rows (or tiles), across then down, then
// the next layer; a planar file's layer p is read with the one-letter raw
// mode rawmode[p] (whatever BitsPerSample says: 8 bits for a band letter or
// L or P, 1 for "1", 32 for I and F), a chunky YCbCr one with "RGBX" (4
// bytes a pixel over 3-byte samples). PIL's raw decoder reads a tile's rows
// from its offset on, each (width x bits + 7) / 8 bytes, then a tile's
// stride less that (stride 0 but for a tile past the image's right edge:
// tile width x sum(bps) / 8, over the samples a pixel of a planar file);
// past the end of the file it is truncated. Fills `smp` (spp samples a
// pixel: bytes, bits, or I and F clipped to 0 .. 255; the bands a layer has
// not reached stay 0).
enum PilRawMode { kRawRgbx, kRawByte, kRawBit, kRawInt32, kRawFloat32 };

struct PilRaw {
  uint32_t W, H, cw, ch, spp, bps_sum, bps_count;
  PilRawMode mode;
  bool planar;
};

[[gnu::noinline]] void pil_raw(const Tiff& t, const PilRaw& r, const std::vector<uint32_t>& offsets,
                               std::vector<uint16_t>& smp) {
  uint32_t x = 0, y = 0, layer = 0;
  const int px_bits = r.mode == kRawBit ? 1 : r.mode == kRawByte ? 8 : 32;
  for (uint32_t off : offsets) {
    if (r.planar && layer >= r.spp) corrupt("TIFF of more planes than PIL's raw mode has bands");
    const uint32_t bw = std::min(x + r.cw, r.W) - x, bh = std::min(y + r.ch, r.H) - y;
    double stride = x + r.cw > r.W ? (double)r.cw * r.bps_sum / 8 : 0;
    if (r.planar) stride /= r.bps_count;
    const size_t bytes = ((size_t)bw * px_bits + 7) / 8, st = (size_t)stride;
    if (st && st < bytes) corrupt("TIFF tile stride below PIL's raw row (PIL's decoder refuses it)");
    const size_t skip = st ? st - bytes : 0;
    if (bh && (off > t.n || (bytes + skip) * (bh - 1) + bytes > t.n - off))
      corrupt("TIFF image data ends early (PIL's raw decoder runs out of the file)");
    for (uint32_t j = 0; j < bh; ++j) {
      const uint8_t* row = t.d + off + (bytes + skip) * j;
      uint16_t* o = &smp[((size_t)(y + j) * r.W + x) * r.spp];
      for (uint32_t i = 0; i < bw; ++i, o += r.spp) {
        switch (r.mode) {
          case kRawRgbx:
            o[0] = row[4 * i];
            o[1] = row[4 * i + 1];
            o[2] = row[4 * i + 2];
            break;
          case kRawByte: o[layer] = row[i]; break;
          case kRawBit: o[layer] = (row[i >> 3] >> (7 - (i & 7))) & 1; break;
          case kRawInt32: {  // native (little-endian) int32, clipped
            const int32_t v = (int32_t)(row[4 * i] | row[4 * i + 1] << 8 | row[4 * i + 2] << 16 |
                                        (uint32_t)row[4 * i + 3] << 24);
            o[layer] = clip_int(v);
            break;
          }
          case kRawFloat32: {
            const uint32_t u = row[4 * i] | row[4 * i + 1] << 8 | row[4 * i + 2] << 16 |
                               (uint32_t)row[4 * i + 3] << 24;
            float v;
            memcpy(&v, &u, sizeof v);
            o[layer] = v > 0.0f ? (v >= 255.0f ? 255 : (uint16_t)v) : 0;
            break;
          }
        }
      }
    }
    x += r.cw;
    if (x >= r.W) {
      x = 0;
      y += r.ch;
      if (y >= r.H) {
        y = 0;
        ++layer;
      }
    }
  }
}

Gray decode_tiff(const uint8_t* d, size_t n) {
  Tiff t{d, n};
  if (n < 8) corrupt("TIFF file ends early");
  t.be = d[0] == 'M';
  t.big = t.r16(2) == 43;
  // PIL takes a header's third byte for its version: a big-endian BigTIFF's
  // is 0, so PIL reads it as a classic header and fails.
  if (t.big && t.be) corrupt("big-endian BigTIFF, whose header PIL misreads");
  TiffDir dir;
  read_tiff_dir(t, dir);
  const uint32_t W = dir.W, H = dir.H, fill = dir.fill, tw = dir.tw,
                 th = dir.th, t4opts = dir.t4opts;
  uint32_t compression = dir.compression, photometric = dir.photometric, spp = dir.spp;
  std::vector<uint32_t> bps = dir.bps, fmt = dir.fmt;
  const std::vector<uint32_t>&offsets = dir.offsets, &cmap = dir.cmap, &extra = dir.extra;
  const bool strips = dir.strips, tiles = dir.tiles;
  check_size(W, H);
  if (compression == 6) {
    // libtiff (tif_dirread.c) takes an old-style JPEG's photometric for
    // YCbCr when the tag is missing or says RGB of 3 samples, and its
    // samples per pixel for 3 when missing there; PIL takes its own
    // photometric for YCbCr and defaults to 3 samples too.
    if (!dir.has_spp && (!dir.has_photometric || photometric == 2 || photometric == 6)) spp = 3;
    if (!dir.has_photometric || (photometric == 2 && spp == 3)) photometric = 6;
  }
  // What PIL itself refuses is corrupt: a compression its TiffImagePlugin
  // does not name, a layout without a mode in its OPEN_INFO, a CIELab image
  // (opened as LAB, which convert("L") refuses), and what libtiff refuses
  // under it.
  static const uint32_t kPilCompressions[] = {1,     2,     3,     4,     5,     6,     7,    8,    32771,
                                              32773, 32809, 32946, 34676, 34677, 34925, 50000, 50001};
  if (std::find(std::begin(kPilCompressions), std::end(kPilCompressions), compression) ==
      std::end(kPilCompressions))
    corrupt("TIFF compression " + std::to_string(compression) + ", which PIL does not name");
  if (!pil_tiff_mode(TiffLayout{t.be, compression == 6 ? 6 : photometric, fill, spp, fmt, bps, extra}))
    corrupt("TIFF layout without a PIL mode (photometric " + std::to_string(photometric) + ", " +
            std::to_string(spp) + " samples of " + std::to_string(bps.at(0)) + " bits)");
  if (bps.size() == 1 && spp > 1) bps.assign(spp, bps[0]);
  if (fmt.size() == 1 && spp > 1) fmt.assign(spp, fmt[0]);
  const int bits = (int)bps[0];
  if (photometric == 8) corrupt("CIELab TIFF (PIL cannot convert LAB to L)");
  const bool lib = compression != 1;  // libtiff decodes for PIL; else PIL's raw decoder
  // libtiff decodes with its own compression (a tag given twice: the first
  // entry, PIL's the last).
  const uint32_t pil_compression = compression;
  if (lib) compression = dir.lt_compression;
  // PlanarConfiguration as each route takes it: libtiff's decodes a
  // compressed file, PIL's own reading lays out the raw route's tiles.
  const uint32_t planar = lib ? dir.lt_planar : dir.planar;
  const bool fax = compression == 2 || compression == 3 || compression == 4 || compression == 32771;
  const bool jpeg = compression == 7, zip = compression == 8 || compression == 32946;
  // libtiff's codecs: SGILog wants a LogLuv image (no PIL mode), WebP is not
  // built into PIL's libtiff, the fax codecs take 1 bit, ThunderScan 4, JPEG
  // 8 or 12, and a predictor is 1, 2 (8 to 64 bits) or 3 (floating point).
  if (compression == 34676 || compression == 34677 || compression == 50001)
    corrupt("TIFF compression " + std::to_string(compression) + ", which PIL's libtiff refuses");
  if ((fax || compression == 32771) && bits != 1) corrupt("CCITT-coded TIFF of more than 1 bit");
  if (compression == 32809 && bits != 4) corrupt("ThunderScan TIFF not of 4 bits");
  if (jpeg && bits != 8 && bits != 12) corrupt(std::to_string(bits) + "-bit JPEG-in-TIFF");
  const bool predicted = compression == 5 || zip || compression == 34925 || compression == 50000;
  const uint32_t predictor = predicted ? dir.predictor : 1;
  if (predictor < 1 || predictor > 3) corrupt("TIFF predictor " + std::to_string(predictor));
  if (predictor == 2 && bits != 8 && bits != 16 && bits != 32 && bits != 64)
    corrupt("TIFF predictor 2 with " + std::to_string(bits) + "-bit samples");
  if (predictor == 3 && (lib ? dir.lt_fmt : fmt[0]) != 3) corrupt("TIFF floating-point predictor on integers");
  // PIL's raw modes of FillOrder 2 it has no unpacker for: 8-bit
  // WhiteIsZero (L;IR) and palettes below 8 bits (P;1R, P;2R, P;4R); a
  // planar file's layer takes the raw mode's first letter alone.
  if (!lib && fill == 2 && planar != 2 &&
      ((photometric == 0 && bits == 8) || (photometric == 3 && bits < 8)))
    corrupt("TIFF of FillOrder 2 in a raw mode PIL has no unpacker for");

  const bool ojpeg = compression == 6;
  const bool planes = spp > 1 && planar == 2;
  if (ojpeg && planes && photometric == 6)  // libtiff's OJPEG codec refuses it
    corrupt("YCbCr TIFF of JPEG in planes");
  // JPEG-in-TIFF as libtiff decodes it for PIL (a tag given twice: each
  // side its own entries). libjpeg converts YCbCr to RGB where libtiff's
  // photometric says YCbCr (PIL's decoder asks for JPEGCOLORMODE_RGB),
  // which wants 3 components and contiguous samples. PIL's raw mode of
  // YCbCr is RGB where its own compression is JPEG and its samples
  // contiguous, else RGBX, 4 bytes a pixel over libtiff's 3.
  const uint32_t lt_photo = dir.lt_photometric;
  if (jpeg && lt_photo == 6 && dir.lt_planar == 2) corrupt("YCbCr TIFF of JPEG in planes");
  if (jpeg && lt_photo == 6 && dir.lt_spp != 3)  // libjpeg's YCbCr -> RGB wants 3 components
    corrupt("JPEG-in-TIFF of photometric 6 with " + std::to_string(dir.lt_spp) + " samples");
  const bool pil_rgb_of_ycc = pil_compression == 7 && dir.planar == 1;
  if (pil_rgb_of_ycc && photometric == 6 && spp != 3)  // raw mode RGB for PIL's mode L
    corrupt("YCbCr JPEG-in-TIFF of one sample, whose raw mode PIL has no unpacker for");
  if (jpeg && photometric == 6 && !pil_rgb_of_ycc)
    corrupt("JPEG-in-TIFF of YCbCr PIL unpacks as RGBX (PIL's decoder refuses it)");
  // JPEG-in-TIFF that libjpeg converts (YCbCr) or whose grey, RGB or CMYK
  // jpeg_tiff reads whole; the rest through libtiff's JPEG codec
  // (TiffJpeg) as samples.
  const bool jpeg_whole = jpeg && (lt_photo == 6 || (!planes && bits == 8 && (photometric == 1 ? spp == 1
                                                                              : photometric == 2 ? spp == 3
                                                                              : photometric == 5 && spp == 4)));
  if (jpeg_whole && dir.lt_spp != spp)
    corrupt("TIFF whose samples PIL's directory and libtiff's read otherwise (PIL's decoder refuses it)");

  // libtiff's own reading: YCbCr outside JPEG goes through its RGBA reader,
  // whatever PIL's photometric (a tag given twice); it drops a ColorMap of
  // another count than 3 << bits, and then refuses a palette of fewer than
  // 8 bits.
  const bool lt_ycc = lib && dir.lt_photometric == 6 && !jpeg && !ojpeg;
  if (lt_ycc && (dir.lt_spp != 3 || dir.lt_bps != 8 || dir.lt_fmt == 3))
    corrupt("YCbCr TIFF not of 3 samples of 8-bit integers, which libtiff's RGBA reader refuses");
  if (lib && dir.lt_photometric == 3 && bits < 8 && !dir.lt_cmap)
    corrupt("TIFF palette of fewer than 8 bits without a ColorMap libtiff takes");

  // What the samples mean, in PIL's OPEN_INFO terms. pil_tiff_mode lets a
  // sample format other than 1 through for grey alone: 2 at 8 bits (read as
  // unsigned, PIL's L), 16 and 32 bits, 3 at 32 bits.
  enum { kGrey, kGreyInv, kGrey16, kNumber, kRgb, kRgbAssoc, kPal, kGreyAlpha, kCmyk, kYcc } kind = kGrey;
  if (jpeg_whole || ojpeg) {
    // libjpeg's output, converted to grey per strip or tile below.
  } else if (photometric == 6) {  // PIL's L of one sample, RGB (raw mode RGBX; RGB: see above) of three
    if (spp == 3) kind = pil_rgb_of_ycc ? kRgb : kYcc;
    if (lib && !lt_ycc && kind == kYcc)  // RGBX over libtiff's 3 bytes a pixel
      corrupt("TIFF whose rows PIL's libtiff decoder sizes otherwise (YCbCr to PIL, not to libtiff)");
  } else if (photometric <= 1 && spp == 1) {
    if (bits == 12 || bits == 32 || (bits == 16 && fmt[0] == 2)) {
      kind = kNumber;
    } else if (bits == 16) {
      kind = kGrey16;
    } else {
      kind = photometric == 0 ? kGreyInv : kGrey;
    }
  } else if (photometric == 1 && spp == 2 && bits == 8 && extra.size() == 1 && extra[0] == 2) {
    kind = kGreyAlpha;
  } else if (photometric == 2) {  // PIL's RGB, RGBX, RGBA and RGBa families
    kind = !extra.empty() && extra[0] == 1 ? kRgbAssoc : kRgb;
  } else if (photometric == 5) {  // PIL's CMYK, CMYKX, CMYKXX and 16-bit CMYK
    kind = kCmyk;
  } else if (photometric == 3) {  // P, or PA / PX of two samples: the palette of the first
    if (cmap.empty()) corrupt("TIFF palette without a colour map");
    if (cmap.size() / 3 > 256) corrupt("TIFF colour map of more than 256 entries (PIL's palette refuses it)");
    for (uint32_t v : cmap)
      if (v > 65535) corrupt("TIFF colour map entry past 16 bits (PIL's palette refuses it)");
    kind = kPal;
  } else {  // pil_tiff_mode has refused every other layout
    corrupt("TIFF photometric " + std::to_string(photometric) + " with " + std::to_string(spp) +
            " samples of " + std::to_string(bits) + " bits");
  }
  // The bands of PIL's mode: RGB for RGBX and YCbCr, RGBA for RGBA and
  // RGBa, CMYK, LA, PA, P for PX.
  const uint32_t bands = kind == kRgb || kind == kYcc ? (spp >= 4 && (extra.empty() || extra[0] != 0) ? 4 : 3)
                         : kind == kRgbAssoc || kind == kCmyk ? 4
                         : kind == kGreyAlpha || (kind == kPal && spp == 2 && extra[0] == 2) ? 2
                                                                                         : 1;

  // PIL's P -> L: a palette entry's grey. PIL's palette is the colour map
  // in thirds, red, green and blue, whatever its count; entries past it
  // are black (C.18).
  uint8_t pal[256] = {0};
  if (kind == kPal) {
    const size_t m = cmap.size() / 3;
    for (size_t i = 0; i < std::min<size_t>(m, 256); ++i)
      pal[i] = luma(cmap[i] / 256, cmap[m + i] / 256, cmap[2 * m + i] / 256);
  }

  // Chunks: strips (full width) or tiles.
  uint32_t cw, ch;
  if (tiles) {
    if (tw == 0 || th == 0) corrupt("bad TIFF tile size");
    cw = tw;
    ch = th;
  } else if (strips) {
    cw = W;
    ch = std::min(dir.rps == 0 ? H : dir.rps, H);
  } else {
    corrupt("TIFF has no image data");
  }
  const uint32_t across = (W + cw - 1) / cw, down = (H + ch - 1) / ch;
  const uint32_t nplanes = planes ? spp : 1;
  if (lib && offsets.size() < (size_t)across * down * std::min(nplanes, planes ? dir.lt_spp : 1))
    corrupt("TIFF has too few strips or tiles");
  if (lib && dir.counts.size() < offsets.size()) corrupt("TIFF strip byte counts missing");
  std::unique_ptr<FaxCodec> fax_codec(fax ? new FaxCodec(cw, compression, t4opts, tiles) : nullptr);
  int lzw_old = -1;
  std::unique_ptr<TiffJpeg> jpeg_codec(jpeg && !jpeg_whole ? new TiffJpeg : nullptr);
  if (jpeg_codec) {
    jpeg_codec->per = dir.lt_planar == 2 ? 1 : dir.lt_spp;
    jpeg_codec->tiles = tiles;
    jpeg_codec->jp.allow_precision = bits;
    jpeg_codec->jp.any_components = true;
    if (dir.jpeg_tables) {
      auto [at, len] = t.bytes(dir.jpeg_tables);
      jpeg_codec->jp.begin(d + at, len);
      jpeg_codec->jp.markers(true);
    }
  }
  const TiffCodec codec{&t, compression, cw, (lib ? dir.codec_fill : fill) == 2 && !jpeg && !ojpeg,
                        fax_codec.get(), &lzw_old, jpeg_codec.get(), W};

  Gray g;
  g.w = (int)W;
  g.h = (int)H;
  g.px.resize((size_t)W * H);
  if (jpeg_whole || ojpeg) {
    const bool sub = dir.ycbcr_sub.size() >= 2;
    const Chunks chunks{offsets, dir.counts, cw, ch, tiles, sub ? (int)dir.ycbcr_sub[0] : 0,
                        sub ? (int)dir.ycbcr_sub[1] : 0};
    if (jpeg)
      jpeg_tiff(t, dir.jpeg_tables, lt_photo, spp, chunks, g);
    else
      ojpeg_tiff(t, dir.oj, photometric, spp, chunks, g);
    return g;
  }
  if (lt_ycc) {
    const TiffYcc conv = tiff_ycc(t, dir.oj.coefficients, dir.oj.refbw);
    if (kind == kYcc) {  // PIL's RGBX: the reader's pixels as they are
      ycbcr_rgba(codec, dir, conv, nullptr, g);
      return g;
    }
    // PIL's raw mode of its own photometric (L, P, RGB, ...) unpacks the
    // reader's RGBA rows as bytes: pixel x is bytes spp x .. of its row.
    std::vector<uint8_t> rgba;
    ycbcr_rgba(codec, dir, conv, &rgba, g);
    for (uint32_t y = 0; y < H; ++y)
      for (uint32_t x = 0; x < W; ++x) {
        uint8_t q[6] = {0};  // past the last row, PIL's unpacker reads on past the buffer
        for (uint32_t c = 0; c < spp; ++c) {
          const size_t at = (size_t)y * W * 4 + (size_t)x * spp + c;
          q[c] = at < rgba.size() ? rgba[at] : 0;
        }
        uint8_t& o = g.px[(size_t)y * W + x];
        switch (kind) {
          case kGreyInv: o = (uint8_t)(255 - q[0]); break;
          case kPal: o = pal[q[0]]; break;
          case kRgb: o = luma(q[0], q[1], q[2]); break;
          case kRgbAssoc: {
            const int a = q[3];
            auto un = [a](int c) { return a == 255 ? c : (uint8_t)std::min(c * 255 / a, 255); };
            o = a == 0 ? 0 : luma(un(q[0]), un(q[1]), un(q[2]));
            break;
          }
          case kCmyk: o = cmyk_luma(q[0], q[1], q[2], q[3]); break;
          default: o = q[0]; break;  // L, LA
        }
      }
    return g;
  }
  // PIL's libtiff decoder sizes its rows by PIL's raw mode (its bits a
  // pixel over the mode's bands for a planar file, `planes`) and refuses a
  // strip whose libtiff scanline is shorter, or a tile whose libtiff size
  // is more than that many rows (the tile's height) of the tile's width.
  // It reads a planar file's first `bands` planes; a mode of one band (PX)
  // from the first plane's tiles with the chunky raw mode, on past a tile
  // row's bytes. It refuses a file whose samples its directory and
  // libtiff's read otherwise.
  uint32_t read_planes = nplanes;
  bool px_tiles = false;  // PX planes in tiles: the first plane read with raw mode PX
  if (lib) {
    const uint64_t lt_px = (uint64_t)dir.lt_bps * (dir.lt_planar == 2 ? 1 : dir.lt_spp);
    const uint32_t pil_planes = dir.lt_planar == 2 && bands > 1 ? bands : 1;
    const uint64_t raw_bits = (uint64_t)bits * spp;
    if (strips ? (W * lt_px + 7) / 8 < (W * raw_bits / pil_planes + 7) / 8
               : (tw * lt_px + 7) / 8 * th > (th * raw_bits / pil_planes + 7) / 8 * tw)
      corrupt("TIFF whose rows PIL's libtiff decoder sizes otherwise");
    if (dir.lt_bps != (uint32_t)bits || (planar == 1 && dir.lt_spp != spp))
      corrupt("TIFF whose samples PIL's directory and libtiff's read otherwise (PIL's decoder "
              "refuses it)");
    // A plane past libtiff's samples: TIFFReadTile refuses it, and
    // TIFFComputeStrip gives strip 0 for every strip of it.
    if (planar == 2 && tiles && std::min(spp, bands) > dir.lt_spp)
      corrupt("TIFF of fewer planes than PIL's mode has bands");
  }
  if (lib && planes) {
    read_planes = std::min(nplanes, bands);
    px_tiles = bands == 1;
    // PIL's decoder takes a planar RGBA's colours for premultiplied when no
    // ExtraSamples say otherwise (as its RGBa).
    if (kind == kRgb && bands == 4 && extra.empty()) kind = kRgbAssoc;
  }
  // PIL's raw decoder over planes (layers of one-letter raw modes) and
  // over YCbCr (raw mode RGBX). It takes PlanarConfiguration 2 for one
  // sample too: its layer is rawmode[0] (1, L, P, I or F; I;16's "I" it has
  // no unpacker for), inverted, reversed or packed or not.
  const bool pil_planes = !lib && (planar == 2 || kind == kYcc);
  PilRawMode raw_mode = kRawByte;
  if (pil_planes && planar == 2) {
    if (spp > 1 && !((kind == kRgb && spp == bands) || (kind == kCmyk && spp == 4) || kind == kYcc))
      corrupt("planar TIFF of a raw mode PIL reads no plane of (X, a, L or P)");
    if (kind == kGrey16 || (kind == kNumber && bits == 12))
      corrupt("planar TIFF of PIL's mode I;16, whose raw mode I it has no unpacker for");
    if (kind == kNumber) raw_mode = fmt[0] == 3 ? kRawFloat32 : kRawInt32;
    if (bits == 1 && (kind == kGrey || kind == kGreyInv)) raw_mode = kRawBit;
  } else if (pil_planes) {
    raw_mode = kRawRgbx;
  }
  // Bilevel grey and 1-bit palettes (CCITT scans among them) go straight to
  // their two greys through a byte table; every other kind unpacks to one
  // sample array per pixel (spp values each, 16-bit kept whole; 8-bit where
  // PIL's raw decoder read a plane).
  const bool bilevel = bits == 1 && (kind == kGrey || kind == kGreyInv || kind == kPal) && !pil_planes;
  std::vector<uint8_t> pal_lut(kind == kPal && bilevel ? 256 * 8 : 0);
  for (size_t b = 0; b < pal_lut.size(); ++b) pal_lut[b] = pal[(b / 8 >> (7 - b % 8)) & 1];
  std::vector<uint16_t> smp(bilevel || (kind == kNumber && !pil_planes) ? 0 : (size_t)W * H * spp);
  int sample_bits = bits;
  if (pil_planes) {
    // TiffImageFile._setup: one tile for all of a chunky image when a
    // strip or tile covers it (the last offset), else one an offset.
    const bool whole = (strips ? (dir.rps == 0xFFFFFFFF ? H : dir.rps) == H : tw == W && th == H) && !planes;
    const std::vector<uint32_t> last = whole ? std::vector<uint32_t>{offsets.back()} : offsets;
    const uint32_t bps_count = (photometric == 5 ? 4 : photometric == 2 || photometric == 6 ? 3 : 1) +
                               (uint32_t)extra.size();
    const uint32_t rows = strips ? (dir.rps == 0xFFFFFFFF ? H : dir.rps) : th;
    if (rows == 0) corrupt("TIFF of RowsPerStrip 0");
    const PilRaw r{W, H, cw, rows, spp, (uint32_t)bits * spp, bps_count, raw_mode, planar == 2};
    pil_raw(t, r, last, smp);
    sample_bits = raw_mode == kRawBit ? 1 : 8;
    if (kind == kYcc) kind = kRgb;
    if (kind == kGreyInv || kind == kNumber) kind = kGrey;  // "L;I"[0] is L: not inverted
  }
  const uint32_t per = planes ? 1 : spp;  // samples a chunk's pixel
  const size_t rb = ((size_t)cw * per * bits + 7) / 8;
  const bool pred2 = predictor == 2 && kind != kNumber;
  const NumberGrey numbers{bits, (int)fmt[0], t.be, !t.be || compression != 1, (int)predictor, rb, cw};
  // PIL's raw decoder takes the last offset when one strip or tile covers
  // the image (TiffImageFile._setup).
  // PIL's raw decoder reads every offset, layer after layer over the
  // image, or the last alone when one strip or tile covers the image
  // (TiffImageFile._setup); libtiff the planes' chunks it is asked for.
  const size_t per_plane = (size_t)across * down;
  const bool last_only = !lib && offsets.size() > 1 &&
                         (strips ? (dir.rps == 0xFFFFFFFF ? H : dir.rps) == H : tw == W && th == H);
  const size_t nchunks = pil_planes ? 0 : lib ? per_plane * read_planes : last_only ? 1 : offsets.size();
  std::vector<uint8_t> buf;
  for (size_t i = 0; i < nchunks; ++i) {
    {
      {
        const uint32_t pl = lib ? (uint32_t)(i / per_plane) : 0;
        const size_t idx = last_only ? offsets.size() - 1 : pl < dir.lt_spp || !planes ? i : 0, at = i % per_plane;
        const uint32_t ty = (uint32_t)(at / across), tx = (uint32_t)(at % across);
        const uint32_t y0 = ty * ch, x0 = tx * cw;
        const uint32_t rows = tiles ? ch : std::min(ch, H - y0);
        if (lib) {
          if (jpeg_codec) jpeg_codec->last = !tiles && y0 + rows >= H;
          tiff_chunk(codec, offsets[idx], dir.counts[idx], rb * rows, rows, buf);
        } else {
          // PIL's raw decoder reads a tile's rows inside the image alone, the
          // last of them to the image's right edge.
          const size_t last = ((size_t)std::min(cw, W - x0) * per * bits + 7) / 8;
          tiff_chunk(codec, offsets[idx], 0, (std::min(rows, H - y0) - 1) * rb + last, rows, buf);
          buf.resize(rb * rows);
        }
        if (kind == kNumber) {
          number_rows(numbers, buf.data(), rows, x0, y0, g);
          continue;
        }
        if (pred2) {
          for (uint32_t r = 0; r < rows; ++r) {
            uint8_t* row = &buf[r * rb];
            if (bits == 8) {
              for (size_t i = per; i < (size_t)cw * per; ++i) row[i] = (uint8_t)(row[i] + row[i - per]);
            } else {
              for (size_t i = per; i < (size_t)cw * per; ++i) {
                uint8_t* a = row + 2 * i;
                uint8_t* b = row + 2 * (i - per);
                uint32_t va = t.be ? (a[0] << 8) | a[1] : a[0] | (a[1] << 8);
                uint32_t vb = t.be ? (b[0] << 8) | b[1] : b[0] | (b[1] << 8);
                uint32_t v = (va + vb) & 0xFFFF;
                a[0] = (uint8_t)(t.be ? v >> 8 : v);
                a[1] = (uint8_t)(t.be ? v : v >> 8);
              }
            }
          }
        }
        if (px_tiles) {  // a tile row's pixel c is its byte 2c, on into the next row
          // The tile's last rows read past PIL's tile buffer, memory that
          // differs from run to run: the port takes 0 there (A.6.27).
          for (uint32_t r = 0; r < rows && y0 + r < H; ++r)
            for (uint32_t c = 0; c < cw && x0 + c < W; ++c) {
              const size_t k = (size_t)r * cw + 2 * c;
              smp[((size_t)(y0 + r) * W + x0 + c) * spp] = k < buf.size() ? buf[k] : 0;
            }
          continue;
        }
        for (uint32_t r = 0; r < rows && y0 + r < H; ++r) {
          const uint8_t* row = &buf[r * rb];
          if (bilevel) {  // a byte at a time, 8 pixels from a table
            const uint8_t(*lut)[8] = kind == kPal ? reinterpret_cast<const uint8_t(*)[8]>(pal_lut.data())
                                                  : bilevel_lut(kind == kGreyInv);
            uint8_t* o = &g.px[(size_t)(y0 + r) * W + x0];
            const uint32_t n = std::min(cw, W - x0);
            uint32_t c = 0;
            for (; c + 8 <= n; c += 8) std::memcpy(o + c, lut[row[c >> 3]], 8);
            for (; c < n; ++c) o[c] = lut[row[c >> 3]][c & 7];
            continue;
          }
          for (uint32_t c = 0; c < cw && x0 + c < W; ++c) {
            uint16_t* o = &smp[(((size_t)(y0 + r)) * W + x0 + c) * spp + pl];
            for (uint32_t s = 0; s < per; ++s) {
              size_t k = (size_t)c * per + s;
              uint16_t v;
              if (bits == 8) {
                v = row[k];
              } else if (bits == 16) {
                v = (uint16_t)(t.be ? (row[2 * k] << 8) | row[2 * k + 1] : row[2 * k] | (row[2 * k + 1] << 8));
              } else {
                size_t bit = k * bits;
                v = (uint16_t)((row[bit >> 3] >> (8 - bits - (bit & 7))) & ((1 << bits) - 1));
              }
              o[s] = v;
            }
          }
        }
      }
    }
  }

  if (bilevel || kind == kNumber) return g;
  const int maxv = (1 << std::min(sample_bits, 8)) - 1;
  const int hi = sample_bits == 16 ? 8 : 0;  // PIL keeps a 16-bit sample's high byte
  for (size_t i = 0; i < g.px.size(); ++i) {
    const uint16_t* s = &smp[i * spp];
    switch (kind) {
      case kGrey: g.px[i] = (uint8_t)(s[0] * 255 / maxv); break;
      case kGreyInv: g.px[i] = (uint8_t)(255 - s[0] * 255 / maxv); break;
      case kGrey16: g.px[i] = (uint8_t)std::min<int>(s[0], 255); break;
      case kGreyAlpha: g.px[i] = (uint8_t)s[0]; break;
      case kPal: g.px[i] = pal[s[0]]; break;
      case kRgb: g.px[i] = luma(s[0] >> hi, s[1] >> hi, s[2] >> hi); break;
      case kRgbAssoc: {  // PIL's RGBa unpackers: un-premultiplied, then RGBA -> L
        const int a = s[3] >> hi;
        auto un = [a](int c) { return a == 255 ? c : (uint8_t)std::min(c * 255 / a, 255); };
        g.px[i] = a == 0 ? 0 : luma(un(s[0] >> hi), un(s[1] >> hi), un(s[2] >> hi));
        break;
      }
      case kCmyk: g.px[i] = cmyk_luma(s[0] >> hi, s[1] >> hi, s[2] >> hi, s[3] >> hi); break;
      case kNumber:  // written by number_rows
      case kYcc:     // read as RGB or by ycbcr_rgba
        break;
    }
  }
  return g;
}

// --------------------------------------------------------------- dispatch

int format_of(const uint8_t* d, size_t n) {
  static const uint8_t png[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
  if (n >= 8 && !memcmp(d, png, 8)) return 'P';
  if (n >= 3 && d[0] == 0xFF && d[1] == 0xD8 && d[2] == 0xFF) return 'J';
  if (n >= 2 && d[0] == 'B' && d[1] == 'M') return 'B';
  if (n >= 4 && ((d[0] == 'I' && d[1] == 'I') || (d[0] == 'M' && d[1] == 'M'))) {
    uint32_t magic = d[0] == 'I' ? d[2] | (d[3] << 8) : (d[2] << 8) | d[3];
    if (magic == 42 || magic == 43 || magic == 0x2A00) return 'T';
  }
  if (n >= 6 && (!memcmp(d, "GIF87a", 6) || !memcmp(d, "GIF89a", 6))) return 'G';
  if (n >= 12 && !memcmp(d, "RIFF", 4) && !memcmp(d + 8, "WEBP", 4)) return 'W';
  return 0;
}

int decode_any(const uint8_t* d, size_t n, Gray& g, std::string& msg) {
  try {
    switch (format_of(d, n)) {
      case 'P': return kPng;
      case 'J': g = decode_jpeg(d, n); break;
      case 'B': g = decode_bmp(d, n); break;
      case 'T': g = decode_tiff(d, n); break;
      case 'G': unsupported("GIF");
      case 'W': unsupported("WebP");
      default: corrupt("not a recognised image file");
    }
  } catch (const DecodeError& e) {
    msg = e.msg;
    return e.status;
  } catch (const std::bad_alloc&) {
    msg = "out of memory";
    return kCorrupt;
  } catch (const std::out_of_range&) {
    msg = "malformed header";
    return kCorrupt;
  }
  return kOk;
}

void put_msg(char* dst, int len, const std::string& m) {
  if (dst && len > 0) {
    size_t k = std::min(m.size(), (size_t)len - 1);
    memcpy(dst, m.data(), k);
    dst[k] = 0;
  }
}

int finish(int status, const Gray* g, uint8_t** out, int* w, int* h) {
  *out = nullptr;
  *w = *h = 0;
  if (status != kOk) return status;
  *out = (uint8_t*)malloc(g->px.size());
  if (!*out) return kCorrupt;
  memcpy(*out, g->px.data(), g->px.size());
  *w = g->w;
  *h = g->h;
  return kOk;
}

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c, pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  return (uint8_t)(pb <= pc ? b : c);
}

// `h` rows of 1 filter byte + `stride` data bytes at `raw` -> `out` (h *
// stride bytes); `bpp` >= 1 is the bytes of one complete pixel (the left
// neighbour's distance). The row above the first is zeros.
void png_unfilter(const uint8_t* raw, int h, int64_t stride, int bpp, uint8_t* out) {
  const uint8_t* prev = nullptr;
  for (int r = 0; r < h; ++r) {
    const uint8_t* in = raw + (int64_t)r * (stride + 1);
    const int f = *in++;
    uint8_t* cur = out + (int64_t)r * stride;
    const int64_t lead = std::min<int64_t>(bpp, stride);
    switch (f) {
      case 0:
        memcpy(cur, in, stride);
        break;
      case 1:
        memcpy(cur, in, lead);
        for (int64_t i = bpp; i < stride; ++i) cur[i] = (uint8_t)(in[i] + cur[i - bpp]);
        break;
      case 2:
        if (!prev) {
          memcpy(cur, in, stride);
        } else {
          for (int64_t i = 0; i < stride; ++i) cur[i] = (uint8_t)(in[i] + prev[i]);
        }
        break;
      case 3:
        for (int64_t i = 0; i < lead; ++i) cur[i] = (uint8_t)(in[i] + ((prev ? prev[i] : 0) >> 1));
        for (int64_t i = bpp; i < stride; ++i)
          cur[i] = (uint8_t)(in[i] + ((cur[i - bpp] + (prev ? prev[i] : 0)) >> 1));
        break;
      case 4:
        if (!prev) {  // Paeth with a zero row above is Sub.
          memcpy(cur, in, lead);
          for (int64_t i = bpp; i < stride; ++i) cur[i] = (uint8_t)(in[i] + cur[i - bpp]);
        } else {
          for (int64_t i = 0; i < lead; ++i) cur[i] = (uint8_t)(in[i] + prev[i]);
          for (int64_t i = bpp; i < stride; ++i)
            cur[i] = (uint8_t)(in[i] + paeth(cur[i - bpp], prev[i], prev[i - bpp]));
        }
        break;
      default:
        corrupt("bad PNG filter type " + std::to_string(f));
    }
    prev = cur;
  }
}

constexpr int kPrecisionBits = 32 - 8 - 2;

// One axis's taps: per output position its first input index, its tap
// count and `ksize` fixed-point taps (zero past the count).
struct Taps {
  int ksize = 0;
  std::vector<int> xmin, count;
  std::vector<int32_t> k;
};

Taps bilinear_taps(int in_size, int out_size) {
  Taps t;
  const double scale = (double)in_size / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 1.0 * filterscale;
  t.ksize = (int)std::ceil(support) * 2 + 1;
  t.xmin.resize(out_size);
  t.count.resize(out_size);
  t.k.assign((size_t)out_size * t.ksize, 0);
  std::vector<double> w(t.ksize);
  const double ss = 1.0 / filterscale;
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double ww = 0.0;
    for (int x = 0; x < xmax; ++x) {
      double a = (x + xmin - center + 0.5) * ss;
      if (a < 0.0) a = -a;
      w[x] = a < 1.0 ? 1.0 - a : 0.0;
      ww += w[x];
    }
    for (int x = 0; x < xmax; ++x) {
      if (ww != 0.0) w[x] /= ww;
      const double v = w[x] * (1 << kPrecisionBits);
      t.k[(size_t)xx * t.ksize + x] = (int32_t)(w[x] < 0 ? -0.5 + v : 0.5 + v);
    }
    t.xmin[xx] = xmin;
    t.count[xx] = xmax;
  }
  return t;
}

inline uint8_t clip8(int64_t v) {
  if (v >= ((int64_t)255 << kPrecisionBits)) return 255;
  if (v <= 0) return 0;
  return (uint8_t)(v >> kPrecisionBits);
}

// Rows of `in` (h x w, row stride `in_stride`) -> `out` (h x ow), each row
// resampled along its length.
void pass_rows(const uint8_t* in, int h, int w, int64_t in_stride, uint8_t* out, int ow) {
  const Taps t = bilinear_taps(w, ow);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = in + (int64_t)y * in_stride;
    uint8_t* dst = out + (int64_t)y * ow;
    for (int xx = 0; xx < ow; ++xx) {
      const int32_t* k = &t.k[(size_t)xx * t.ksize];
      const uint8_t* src = row + t.xmin[xx];
      int64_t acc = 1 << (kPrecisionBits - 1);
      for (int x = 0; x < t.count[xx]; ++x) acc += (int64_t)src[x] * k[x];
      dst[xx] = clip8(acc);
    }
  }
}

// Columns of `in` (h x w, row stride `in_stride`) -> `out` (oh x w), each
// column resampled along its length, a whole output row at a time.
void pass_cols(const uint8_t* in, int h, int w, int64_t in_stride, uint8_t* out, int oh) {
  const Taps t = bilinear_taps(h, oh);
  std::vector<int64_t> acc(w);
  for (int yy = 0; yy < oh; ++yy) {
    const int32_t* k = &t.k[(size_t)yy * t.ksize];
    std::fill(acc.begin(), acc.end(), (int64_t)1 << (kPrecisionBits - 1));
    for (int y = 0; y < t.count[yy]; ++y) {
      const uint8_t* row = in + (int64_t)(t.xmin[yy] + y) * in_stride;
      const int64_t ky = k[y];
      for (int x = 0; x < w; ++x) acc[x] += (int64_t)row[x] * ky;
    }
    uint8_t* dst = out + (int64_t)yy * w;
    for (int x = 0; x < w; ++x) dst[x] = clip8(acc[x]);
  }
}

}  // namespace

extern "C" {

// uint8 grey `in` (h x w, row stride `in_stride` bytes) -> `out` (oh x ow,
// contiguous), Pillow's Image.resize((ow, oh), Image.BILINEAR) in L mode.
// Returns 0, or 1 for a size below 1.
int sig_resize_bilinear(const uint8_t* in, int h, int w, int64_t in_stride, uint8_t* out,
                        int oh, int ow) {
  if (h < 1 || w < 1 || oh < 1 || ow < 1 || in_stride < w) return kCorrupt;
  if (ow == w && oh == h) {
    for (int y = 0; y < h; ++y) memcpy(out + (int64_t)y * w, in + (int64_t)y * in_stride, w);
  } else if (oh == h) {
    pass_rows(in, h, w, in_stride, out, ow);
  } else if (ow == w) {
    pass_cols(in, h, w, in_stride, out, oh);
  } else {
    std::vector<uint8_t> mid((size_t)h * ow);
    pass_rows(in, h, w, in_stride, mid.data(), ow);
    pass_cols(mid.data(), h, ow, ow, out, oh);
  }
  return kOk;
}

// PNG rows as zlib inflates them (`n` bytes at `raw`: `h` rows of a filter
// byte and `stride` bytes) -> `out`, h * stride unfiltered bytes; `bpp` the
// bytes of one complete pixel (1 below 8 bits a sample). Returns 0, or 1
// with msg set (too little data, a bad filter type).
int sig_png_unfilter(const uint8_t* raw, int64_t n, int h, int64_t stride, int bpp, uint8_t* out,
                     char* msg, int msg_len) {
  try {
    if (h < 0 || stride < 0 || bpp < 1) corrupt("bad PNG row geometry");
    if (n < (int64_t)h * (stride + 1)) corrupt("PNG image data is too short");
    png_unfilter(raw, h, stride, bpp, out);
  } catch (const DecodeError& e) {
    put_msg(msg, msg_len, e.msg);
    return e.status;
  }
  put_msg(msg, msg_len, "");
  return kOk;
}

// One image in memory -> grey. On status 0, *out holds w*h bytes (free with
// sig_free); otherwise msg names what failed.
int sig_decode(const uint8_t* data, int64_t n, uint8_t** out, int* w, int* h, char* msg, int msg_len) {
  Gray g;
  std::string m;
  int st = decode_any(data, (size_t)n, g, m);
  put_msg(msg, msg_len, m);
  return finish(st, &g, out, w, h);
}

void sig_free(void* p) { free(p); }

// Files -> grey on `threads` threads: per file its status, size, pixels
// (malloc'd, free with sig_free) and a message of up to msg_len bytes.
void sig_decode_files(const char** paths, int n, int threads, uint8_t** outs, int* ws, int* hs,
                      int* status, char* msgs, int msg_len) {
  std::atomic<int> next{0};
  auto work = [&]() {
    std::vector<uint8_t> buf;
    for (int i = next++; i < n; i = next++) {
      char* msg = msgs ? msgs + (size_t)i * msg_len : nullptr;
      FILE* f = fopen(paths[i], "rb");
      if (!f) {
        put_msg(msg, msg_len, "cannot open the file");
        status[i] = finish(kUnreadable, nullptr, outs + i, ws + i, hs + i);
        continue;
      }
      buf.clear();
      uint8_t chunk[1 << 16];
      size_t k;
      while ((k = fread(chunk, 1, sizeof chunk, f)) > 0) buf.insert(buf.end(), chunk, chunk + k);
      bool err = ferror(f);
      fclose(f);
      if (err) {
        put_msg(msg, msg_len, "cannot read the file");
        status[i] = finish(kUnreadable, nullptr, outs + i, ws + i, hs + i);
        continue;
      }
      Gray g;
      std::string m;
      int st = decode_any(buf.data(), buf.size(), g, m);
      put_msg(msg, msg_len, m);
      status[i] = finish(st, &g, outs + i, ws + i, hs + i);
    }
  };
  int t = std::max(1, std::min(threads, n));
  std::vector<std::thread> pool;
  for (int i = 1; i < t; ++i) pool.emplace_back(work);
  work();
  for (auto& th : pool) th.join();
}

}  // extern "C"
