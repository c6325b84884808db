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
// bottom-up and top-down rows), through one DIB reader that also reads DIB
// files, cursors (CUR) and the bitmaps of icons (ICO).
//
// TGA, PCX (and DCX's first page), SGI, SUN raster, MSP and QOI: as Pillow's
// plugins and its C decoders (TgaRleDecode.c, PcxDecode.c, SgiRleDecode.c,
// SunRleDecode.c) and Python ones (MspDecoder, QoiDecoder) read them, their
// end-of-data and overrun rules included.
//
// DDS (BC1-BC7 through Pillow's BcnDecode.c, uncompressed through its
// Python DdsRgbDecoder), FTEX, BLP (its Python DXT decoders, BLP1's JPEG
// through this file's JPEG reader) and SPIDER: as Pillow's plugins read
// them, down to what a short or damaged file gives.
//
// PIXAR, GBR, McIdas, IMT and FITS (raw tiles as PIL's raw decoder, or its
// map of a file opened by name, reads them; FITS's GZIP_1 tiles through
// gzip and this file's inflate), IPTC (its image records' JPEG or raw grey,
// alone or as one band), FLI (Pillow's FliDecode.c on the first frame) and
// PCD (PcdDecode.c and the PhotoYCC tables of Pillow's YCC;P unpacker).
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
// WebP: webp.cpp (sigwebp::decode), libwebp's demuxer and decoders as
// Pillow calls them, reached through pil_format like the other formats PIL
// opens by their bytes.
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
// kind not read here yet), 3 the file could not be read, 4 a PNG stream,
// decoded by the Python side: a PNG file, or the PNG icon of an ICO file's
// largest entry (the stream's offset in the file handed back in the
// width's place), 5 ok, where PIL's convert("L") gives an image of mode P
// (a grey TGA with a colour map: its indices), which PIL resizes nearest.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <new>
#include <stdexcept>
#include <string>
#include <thread>
#include <type_traits>
#include <unordered_map>
#include <vector>

namespace sigwebp {  // webp.cpp
int decode(const uint8_t* data, size_t size, int64_t max_pixels, std::vector<uint8_t>& gray, int& w,
           int& h, std::string& msg);
}  // namespace sigwebp

namespace {

enum Status { kOk = 0, kCorrupt = 1, kUnsupported = 2, kUnreadable = 3, kPng = 4, kIndices = 5 };

struct DecodeError {
  int status;
  std::string msg;
};

[[noreturn]] void corrupt(const std::string& m) { throw DecodeError{kCorrupt, m}; }
[[noreturn]] void unsupported(const std::string& m) { throw DecodeError{kUnsupported, m}; }

struct Gray {
  int w = 0, h = 0;
  std::vector<uint8_t> px;
  int64_t png_at = -1;   // an icon's PNG stream, handed back to the Python side (kPng)
  bool indices = false;  // PIL's convert("L") leaves the image in mode P (kIndices)
};

inline uint8_t luma(int r, int g, int b) {
  return (uint8_t)((19595 * r + 38470 * g + 7471 * b + 0x8000) >> 16);
}

// PIL's F -> L (Convert.c): a float clipped to 0 .. 255 and truncated, NaN 0.
inline uint8_t float_grey(float f) { return f > 0.0f ? (f >= 255.0f ? 255 : (uint8_t)f) : 0; }

// PIL's Image.open refuses more than 2 * Image.MAX_IMAGE_PIXELS pixels
// (DecompressionBombError); any side length up to that is read.
constexpr int64_t kMaxPixels = 2 * (1024LL * 1024 * 1024 / 4 / 3);

inline void check_size(int64_t w, int64_t h) {
  if (w <= 0 || h <= 0) corrupt("image has no pixels");
  if (w > kMaxPixels || h > kMaxPixels || w * h > kMaxPixels)
    corrupt("image of " + std::to_string(w) + " x " + std::to_string(h) +
            " pixels (PIL's decompression-bomb limit is " + std::to_string(kMaxPixels) + ")");
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
  // jdhuff.c jpeg_make_d_derived_tbl's checks, which libjpeg makes when a
  // scan that uses the table starts, not at DHT (C.27): every code fits in
  // its length and none is all ones (C.22); a DC symbol is at most 15 (16,
  // the lossless difference category, in a lossless frame).
  bool valid = false;
  int max_val = 0;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int maxcode[18];
  int valoffset[18];
  uint16_t look[512];  // 9-bit lookahead: (length << 8) | symbol, 0 = longer code

  void build() {
    int count = 0;
    for (int l = 1; l <= 16; ++l) count += bits[l];
    if (count > 256) corrupt("bad Huffman table");
    defined = true;
    valid = false;
    max_val = count ? *std::max_element(vals, vals + count) : 0;
    int code = 0, k = 0;
    std::fill(look, look + 512, 0);
    for (int l = 1; l <= 16; ++l) {
      valoffset[l] = k - code;
      for (int i = 0; i < bits[l]; ++i, ++k, ++code) {
        if (code + 1 >= (1 << l)) return;
        if (l <= 9) {
          int shift = 9 - l;
          for (int j = 0; j < (1 << shift); ++j)
            look[(code << shift) | j] = (uint16_t)((l << 8) | vals[k]);
        }
      }
      maxcode[l] = bits[l] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7FFFFFFF;
    valid = true;
  }

  void check(bool dc, bool lossless) const {
    if (!valid || (dc && max_val > (lossless ? 16 : 15))) corrupt("bad Huffman table");
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
  t.build();
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
  // Where each restart of a sequential Huffman scan found the reader: the
  // next byte it would fetch, and whether it had met a marker (C.20).
  std::vector<std::pair<size_t, bool>>* restart_log = nullptr;
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
  // BLP1's JPEG (BlpImagePlugin): four components read as CMYK whatever
  // Adobe's transform says (jpegmode "CMYK", raw mode still CMYK;I), and
  // the RGB that PIL's convert("RGB") gives relabelled BGR: R and B swap.
  bool blp = false;
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
      t.build();
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
          if (restart_log) restart_log->emplace_back(br.pos, br.at_marker);
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

  // jdmarker.c get_sos's lookup of the scan's i-th component `id` (C.27):
  // the first of the frame's first 4 components of that id whose index ci
  // finds cur[ci] empty (cur holds the scan's components by their place
  // in the scan, so a scan out of the frame's order fails), and not one an
  // earlier place took (JERR_BAD_COMPONENT_ID).
  Component* scan_component(Component* cur[4], int i, int id) {
    const int m = std::min(ncomp, 4);
    int ci = 0;
    while (ci < m && (comp[ci].id != id || cur[ci])) ++ci;
    if (ci == m) corrupt("JPEG scan names an unknown component");
    cur[i] = &comp[ci];
    for (int pi = 0; pi < i; ++pi)
      if (cur[pi] == cur[i]) corrupt("JPEG scan names a component twice");
    return cur[i];
  }

  void sos() {
    if (!frame) corrupt("JPEG scan before its frame");
    int len = u16();
    int ns = u8();
    if (ns < 1 || ns > ncomp || ns > 4 || len != 6 + 2 * ns) corrupt("bad JPEG scan header");
    Component* sc[4] = {nullptr, nullptr, nullptr, nullptr};
    for (int i = 0; i < ns; ++i) {
      int id = u8(), t = u8();
      Component* c = scan_component(sc, i, id);
      c->td = t >> 4;
      c->ta = t & 15;
      if (!arith && (c->td > 3 || c->ta > 3)) corrupt("bad JPEG scan header");
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
      } else if (use_dc) {
        if (!dc[c->td].defined) {
          if (c->td > 1 || progressive) corrupt("JPEG scan uses an undefined Huffman table");
          std_table(dc[c->td], true, c->td);
        }
        dc[c->td].check(true, lossless);
      }
      if (!arith && use_ac) {
        if (!ac[c->ta].defined) {
          if (c->ta > 1 || progressive) corrupt("JPEG scan uses an undefined Huffman table");
          std_table(ac[c->ta], false, c->ta);
        }
        ac[c->ta].check(false, false);
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
          Component* cur[4] = {nullptr, nullptr, nullptr, nullptr};
          for (int i = 0; i < ns; ++i) {
            const int id = u8();
            u8();
            scan_component(cur, i, id);
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
    } else if (ncomp == 4 && blp) {  // BLP1's jpegmode "CMYK": no YCCK conversion
      ycc = false;
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
        g.px[i] = blp ? cmyk_luma(y ^ inv, m ^ inv, c ^ inv, c3[i] ^ inv)
                      : cmyk_luma(c ^ inv, m ^ inv, y ^ inv, c3[i] ^ inv);
      }
      return g;
    }
    uint8_t* o = g.px.data();
    const size_t n = g.px.size();
    if (!ycc) {
      if (blp) std::swap(c0, c2);
      for (size_t i = 0; i < n; ++i) o[i] = luma(c0[i], c1[i], c2[i]);
      return g;
    }
    for (size_t i = 0; i < n; ++i) {
      int r, gg, b;
      t.rgb(c0[i], c1[i], c2[i], r, gg, b);
      o[i] = blp ? luma(b, gg, r) : luma(r, gg, b);
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

// A device-independent bitmap as PIL's BmpImageFile._bitmap reads it: a BMP
// after its 14-byte file header, a DIB, a cursor (CUR) and an icon's
// bitmap (ICO). `mode` is PIL's: 'P' a palette, 'L' a palette of grey
// levels 0, 1, 2, ... whose pixels PIL unpacks a byte each ("L"), '1' the
// palette (0, 255) whose pixels it unpacks a bit each ("1"), whatever the
// bit depth (C.24); 'R' RGB or RGBA.
struct Dib {
  int64_t w = 0, h = 0;
  int bits = 0;
  uint32_t compression = 0;
  bool top_down = false, rle = false;
  char mode = 'R';
  int layout = 0;            // 16 to 32-bit pixels: 15 (555), 16 (565), 24 (BGR), 32
  int order[3] = {2, 1, 0};  // byte index of R, G, B within a 24- or 32-bit pixel
  bool mappable = false;     // PIL's raw mode is its mode and one it maps ("L", "P", "RGBA")
  bool too_many = false;     // a palette of more than 256 colours, which PIL's load refuses
  Palette pal;
  uint64_t offset = 0;       // where the pixel data starts
};

// The info header at `at`. `offset`: the pixel data's position from a BMP
// file header, or 0 for none (DIB, CUR, ICO, and a BMP that gives 0: the
// data starts where PIL's reads of the header, its masks and its palette
// stop, C.23). Throws corrupt() where _bitmap raises OSError; returns false
// where it fails in a way Image.open takes for "not this format" (the
// header's size or a bitfield mask read past the file's end).
bool dib_header(const uint8_t* d, size_t n, size_t at, uint64_t offset, Dib& b) {
  if (at > n || n - at < 4) return false;
  const uint32_t hsize = le32(d + at);
  uint64_t pos = at + 4;
  if (hsize > 4 && n - pos < hsize - 4) corrupt("BMP header ends early");
  const uint8_t* hd = d + pos;
  if (hsize > 4) pos += hsize - 4;
  uint32_t colors = 0;
  uint32_t masks[4] = {0, 0, 0, 0};
  int pal_pad;
  if (hsize == 12) {
    b.w = le16(hd);
    b.h = le16(hd + 2);
    b.bits = le16(hd + 6);
    pal_pad = 3;
  } else if (hsize == 40 || hsize == 52 || hsize == 56 || hsize == 64 || hsize == 108 ||
             hsize == 124) {
    b.top_down = hd[7] == 0xFF;
    b.w = le32(hd);
    const uint32_t hh = le32(hd + 4);
    b.h = b.top_down ? (int64_t)((uint64_t)1 << 32) - hh : hh;
    b.bits = le16(hd + 10);
    b.compression = le32(hd + 12);
    colors = le32(hd + 28);
    pal_pad = 4;
    if (b.compression == 3) {
      if (hsize - 4 >= 48) {
        const int k = hsize - 4 >= 52 ? 4 : 3;
        for (int i = 0; i < k; ++i) masks[i] = le32(hd + 36 + 4 * i);
      } else {
        if (n - pos < 12) return false;
        for (int i = 0; i < 3; ++i) masks[i] = le32(d + pos + 4 * i);
        pos += 12;
      }
    }
  } else {
    corrupt("BMP header of " + std::to_string(hsize) + " bytes");
  }
  const uint64_t ncolors = colors ? colors : (uint64_t)1 << std::min(b.bits, 63);
  if (offset == 14 + (uint64_t)hsize && b.bits <= 8) offset += 4 * ncolors;
  const int bits = b.bits;
  if (bits != 1 && bits != 4 && bits != 8 && bits != 16 && bits != 24 && bits != 32)
    corrupt(std::to_string(bits) + "-bit BMP");
  b.mode = bits <= 8 ? 'P' : 'R';
  if (b.compression == 3) {
    if (bits == 32) {
      struct M { uint32_t m[4]; int r, g, b; bool rgba; } known[] = {
          {{0xFF0000, 0xFF00, 0xFF, 0x0}, 2, 1, 0, false},         // BGRX
          {{0xFF000000, 0xFF0000, 0xFF00, 0x0}, 3, 2, 1, false},   // XBGR
          {{0xFF000000, 0xFF00, 0xFF, 0x0}, 3, 1, 0, false},       // BGXR
          {{0xFF000000, 0xFF0000, 0xFF00, 0xFF}, 3, 2, 1, false},  // ABGR
          {{0xFF, 0xFF00, 0xFF0000, 0xFF000000}, 0, 1, 2, true},   // RGBA
          {{0xFF0000, 0xFF00, 0xFF, 0xFF000000}, 2, 1, 0, false},  // BGRA
          {{0xFF000000, 0xFF00, 0xFF, 0xFF0000}, 3, 1, 0, false},  // BGAR
          {{0x0, 0x0, 0x0, 0x0}, 2, 1, 0, false}};                 // BGRA
      bool found = false;
      for (const M& k : known)
        if (!memcmp(k.m, masks, sizeof masks)) {
          b.order[0] = k.r;
          b.order[1] = k.g;
          b.order[2] = k.b;
          b.mappable = k.rgba;
          found = true;
          break;
        }
      if (!found) corrupt("BMP bitfields layout");
      b.layout = 32;
    } else if (bits == 24 && masks[0] == 0xFF0000 && masks[1] == 0xFF00 && masks[2] == 0xFF) {
      b.layout = 24;
    } else if (bits == 16 && masks[0] == 0xF800 && masks[1] == 0x7E0 && masks[2] == 0x1F) {
      b.layout = 16;
    } else if (bits == 16 && masks[0] == 0x7C00 && masks[1] == 0x3E0 && masks[2] == 0x1F) {
      b.layout = 15;
    } else {
      corrupt("BMP bitfields layout");
    }
  } else if (b.compression == 0) {
    b.layout = bits == 16 ? 15 : bits;
  } else if (b.compression == 1 || b.compression == 2) {
    b.rle = true;
  } else {
    corrupt("BMP compression " + std::to_string(b.compression));
  }

  if (b.mode == 'P') {
    if (ncolors == 0 || ncolors > 65536) corrupt("BMP palette size");
    const size_t got = (size_t)std::min<uint64_t>(pal_pad * ncolors, pos < n ? n - pos : 0);
    const uint8_t* p = d + pos;
    // PIL's grayscale test: the palette (v, v, v) for v = 0, 1, ... (mod
    // 256), or 0 and 255 for two colours, all of it in the file, makes the
    // image "L" (or "1"), whose pixels are unpacked as such (C.24).
    bool grey = true;
    for (uint64_t i = 0; i < ncolors && grey; ++i) {
      const int v = ncolors == 2 ? (i ? 255 : 0) : (int)(i & 255);
      grey = i * pal_pad + 3 <= got && p[i * pal_pad] == v && p[i * pal_pad + 1] == v &&
             p[i * pal_pad + 2] == v;
    }
    if (grey) {
      b.mode = ncolors == 2 ? '1' : 'L';
      b.mappable = b.mode == 'L';
    } else {
      b.too_many = got / pal_pad > 256;
      for (size_t i = 0; i < std::min<size_t>(got / pal_pad, 256); ++i) {
        const uint8_t* e = p + i * pal_pad;
        b.pal.grey[i] = luma(e[2], e[1], e[0]);
      }
      b.mappable = bits == 8 && !b.rle;
    }
    pos += got;
  }
  b.offset = offset ? offset : std::min<uint64_t>(pos, n);
  return true;
}

// PIL's grey of a DIB's first `rows` rows (all of them, or the XOR half of
// a cursor or an icon). `mapped`: the file was opened by its name, so PIL
// maps a tile of a mappable mode (Dib::mappable) whose rows fit in the file
// and reads them where they lie, past the file's end as zeros; otherwise
// its raw decoder unpacks each row from its own bytes.
Gray dib_pixels(const uint8_t* d, size_t n, const Dib& b, int64_t rows, bool mapped) {
  if (b.too_many) corrupt("BMP palette of more than 256 colours (PIL refuses it)");
  const int W = (int)b.w, H = (int)rows;
  Gray g;
  g.w = W;
  g.h = H;
  g.px.resize((size_t)W * H);
  if (b.rle) {
    // PIL's BmpRleDecoder, rule for rule (file positions count from the file's start).
    const bool rle4 = b.compression == 2;
    std::vector<uint8_t> data;
    const size_t dest = (size_t)W * H;
    size_t p = b.offset < n ? (size_t)b.offset : n, x = 0;
    auto rd = [&](size_t k, std::vector<uint8_t>& out) {
      const size_t got = p < n ? std::min(k, n - p) : 0;
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
        const size_t right = tmp[0], up = tmp[1];
        data.insert(data.end(), right + up * W, 0);
        x = data.size() % W;
      } else {
        const size_t count = rle4 ? byte / 2 : byte;
        const size_t got = rd(count, tmp);
        for (uint8_t v : tmp) {
          if (rle4) {
            data.push_back(v >> 4);
            data.push_back(v & 15);
          } else {
            data.push_back(v);
          }
        }
        if (got < count) break;
        x += byte;
        if (p % 2) ++p;
      }
    }
    if (data.size() < dest) corrupt("BMP RLE data ends early");
    // set_as_raw: raw mode "L" for an "L" image, else "P", which PIL has no
    // unpacker of for a "1" or an RGB image (RLE at 1 or 16-32 bits); any
    // bit depth of a palette reads the decoder's bytes (C.24).
    if (b.mode == '1' || b.mode == 'R') corrupt("BMP RLE of a mode PIL has no raw mode P for");
    for (int y = 0; y < H; ++y) {
      const int src = b.top_down ? y : H - 1 - y;
      uint8_t* o = &g.px[(size_t)src * W];
      const uint8_t* s = &data[(size_t)y * W];
      for (int xx = 0; xx < W; ++xx) o[xx] = b.mode == 'L' ? s[xx] : b.pal.grey[s[xx]];
    }
    return g;
  }
  const uint64_t stride = (((uint64_t)W * b.bits + 31) >> 3) & ~(uint64_t)3;
  const int unpack_bits = b.mode == 'L' ? 8 : b.mode == '1' ? 1 : b.layout == 15 || b.layout == 16 ? 16 : b.bits;
  const uint64_t row = ((uint64_t)W * unpack_bits + 7) / 8;
  const bool map = mapped && b.mappable && b.offset <= n && stride * H <= n - b.offset;
  if (!map) {
    if (row > stride) corrupt("BMP rows shorter than PIL's raw mode takes (PIL refuses it)");
    if (b.offset > n || n - b.offset < stride * (H - 1) + row) corrupt("BMP pixel data ends early");
  }
  for (int y = 0; y < H; ++y) {
    const uint64_t at = b.offset + stride * (b.top_down ? y : H - 1 - y);
    const uint8_t* r = d + at;
    uint8_t* o = &g.px[(size_t)y * W];
    if (b.mode == 'L') {
      const uint64_t k = std::min<uint64_t>(W, n - at);  // a mapped row past the file's end
      memcpy(o, r, k);
      std::fill(o + k, o + W, 0);
    } else if (b.mode == '1') {
      for (int x = 0; x < W; ++x) o[x] = (r[x >> 3] >> (7 - (x & 7))) & 1 ? 255 : 0;
    } else if (b.mode == 'P') {
      const int bits = b.bits, per = 8 / bits, mask = (1 << bits) - 1;
      for (int x = 0; x < W; ++x) {
        const int idx = bits == 8 ? r[x] : (r[x / per] >> (8 - bits * (x % per + 1))) & mask;
        o[x] = b.pal.grey[idx];
      }
    } else if (b.layout == 15 || b.layout == 16) {
      for (int x = 0; x < W; ++x) {
        const int v = r[2 * x] | (r[2 * x + 1] << 8);
        int R, G, B;
        if (b.layout == 15) {
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
      const int bpp = b.bits / 8;
      for (int x = 0; x < W; ++x) {
        const uint8_t* q = r + (size_t)bpp * x;
        o[x] = luma(q[b.order[0]], q[b.order[1]], q[b.order[2]]);
      }
    }
  }
  return g;
}

// A BMP file: the 14-byte file header, then its DIB. A kind PIL's
// BmpImagePlugin refuses (a header size, bit depth, bitfields layout,
// compression or palette size it does not know) is corrupt here too.
Gray decode_bmp(const uint8_t* d, size_t n) {
  Dib b;
  if (n < 14 || !dib_header(d, n, 14, le32(d + 10), b)) corrupt("BMP header ends early");
  check_size(b.w, b.h);
  return dib_pixels(d, n, b, b.h, true);
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

// Deflate's length and distance bases and extra bits.
const uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
                               31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
const uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                               2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
const uint16_t kDistBase[30] = {1,    2,    3,    4,    5,    7,     9,     13,    17,  25,
                                33,   49,   65,   97,   129,  193,   257,   385,   513, 769,
                                1025, 1537, 2049, 3073, 4097, 6145,  8193, 12289, 16385, 24577};
const uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

// A compressed block's codes: the fixed ones (type 1) or those its header
// gives (type 2).
void inflate_codes(InflateBits& b, int type, InflateCodes& lit, InflateCodes& dist) {
  static const uint8_t kOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};
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
}

void inflate_zlib(const uint8_t* s, size_t n, size_t want, std::vector<uint8_t>& out) {
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
      inflate_codes(b, type, lit, dist);
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

// A raw Deflate stream to its end, as Python's zlib.decompressobj(-15)
// reads it for gzip.decompress: the output grows as it must; returns the
// bytes the stream took (to the byte after its last block). A stream that
// ends early or is malformed is refused.
size_t inflate_raw(const uint8_t* s, size_t n, std::vector<uint8_t>& out) {
  out.clear();
  InflateBits b{s, n};
  InflateCodes lit, dist;
  for (bool last = false; !last;) {
    last = b.get(1);
    const int type = b.get(2);
    if (type == 0) {
      b.drop(b.cnt & 7);
      const int len = b.get(16), nlen = b.get(16);
      if (len != (~nlen & 0xFFFF)) corrupt("bad Deflate stored block length");
      for (int i = 0; i < len; ++i) out.push_back((uint8_t)b.get(8));
      continue;
    }
    if (type == 3) corrupt("bad Deflate block type");
    inflate_codes(b, type, lit, dist);
    for (;;) {
      int sym = b.decode(lit);
      if (sym < 256) {
        out.push_back((uint8_t)sym);
        continue;
      }
      if (sym == 256) break;
      sym -= 257;
      if (sym >= 29) corrupt("bad Deflate length code");
      const size_t len = kLenBase[sym] + b.get(kLenExtra[sym]);
      const int ds = b.decode(dist);
      if (ds >= 30) corrupt("bad Deflate distance code");
      const size_t back = kDistBase[ds] + b.get(kDistExtra[ds]);
      if (back > out.size()) corrupt("Deflate distance too far back");
      for (size_t i = 0; i < len; ++i) out.push_back(out[out.size() - back]);
    }
  }
  return b.pos - b.cnt / 8;
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
  bool planes;       // libtiff's PlanarConfiguration 2, of more than one sample
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

// C.20: old-style JPEG-in-TIFF of YCbCr in planes (PlanarConfiguration 2),
// as PIL reads it through libtiff's RGBA reader (gtStripSeparate): a call a
// strip, the strip of plane 0, 1 and 2 read in turn into a buffer cleared
// for the call; a read that fails leaves its plane's rows zero, and one that
// fails before it decodes plane 0 fails PIL's read. In tiles (A.6.48,
// gtTileSeparate): a call a row of tiles, the buffer cleared when the
// call's first tile is read and not between its tiles: a read that fails
// clears its plane's tile (libtiff 4.7.1 clears the buffer on a failure),
// one below libjpeg's frame succeeds with no line and leaves the tile
// before it in the same row of tiles; a tile is `rps` rows of a frame `sw`
// wide (striles one after another), `across` tiles a row. libtiff's codec
// decodes plane s as a frame of that one sample. Its scan's SOS is found by
// searching the byte source `src` (the JPEGInterchangeFormat bytes, then
// the striles, which end at `strip_end`) onward from plane s - 1's SOS for
// FF DA (OJPEGReadSecondarySos; plane 0's ends at `from`); a plane whose SOS
// is not found fails every read, and the search leaves the source where it
// stopped. One libjpeg session at a time: a read of another plane ends it
// (libtiff then starts that plane over, decoding the striles before the one
// read), a session whose header failed is never ended and every header
// after it fails, and a read that fails is not counted, so the plane's next
// read decodes the failed strile again. `stream(s, 1, at)` is plane s's
// stream, its scan at `at`; `down` the striles of a plane.
template <class Stream>
[[gnu::noinline]] void ojpeg_planes(const std::vector<uint8_t>& src, size_t jif_size,
                                    const std::vector<size_t>& strip_end, size_t from,
                                    const Stream& stream, int* sos_cs,
                                    int* sos_tda, const int* sof_hv, uint32_t sof_y, bool open_end,
                                    int restart, uint32_t rps, uint32_t down, bool tiles, uint32_t sw,
                                    uint32_t across, const TiffYcc& conv, Gray& g) {
  const uint32_t W = g.w, H = g.h;
  // The ends of the source's blocks, past which OJPEGReadSkip does not skip.
  std::vector<size_t> ends{jif_size};
  ends.insert(ends.end(), strip_end.begin(), strip_end.end());
  ends.push_back(SIZE_MAX);
  bool found[3] = {true, false, false};
  size_t at[3] = {from, 0, 0}, stopped = src.size();  // where a failed search stopped
  for (int s = 1; s < 3; ++s) {
    size_t q = at[s - 1];
    bool sos = false;
    while (q < src.size() && !sos) {
      if (src[q++] != 0xFF) continue;
      while (q < src.size() && src[q] == 0xFF) ++q;
      if (q < src.size()) sos = src[q++] == 0xDA;
    }
    // Ls 8 and Ns 1, each checked as it is read, then Cs and Td/Ta; Ss, Se
    // and Ah/Al are skipped, no further than the end of their block.
    const size_t left = src.size() - q;
    if (!sos || left < 2 || src[q] != 0 || src[q + 1] != 8 || left < 3 || src[q + 2] != 1) {
      stopped = !sos || left < 2 ? src.size() : left < 3 || src[q] != 0 || src[q + 1] != 8 ? q + 2 : q + 3;
      break;
    }
    if (left < 5) break;
    sos_cs[s] = src[q + 3];
    sos_tda[s] = src[q + 4];
    q += 5;
    at[s] = std::min(q + 3, *std::upper_bound(ends.begin(), ends.end(), q - 1));
    found[s] = true;
  }
  struct Plane {
    bool ok = false;  // its header decodes
    uint32_t lines = 0;  // the lines libjpeg gives before it fails
    std::vector<uint8_t> px;
    size_t pw = 0;
  } pl[3];
  auto decode = [&](const std::vector<uint8_t>& str, Plane& out,
                    std::vector<std::pair<size_t, bool>>* log) {
    Jpeg jp;
    jp.begin(str.data(), str.size());
    jp.old_tiff = true;
    jp.open_end = open_end;
    jp.restart_log = log;
    uint32_t lines = sof_y;
    try {
      jp.planes();
    } catch (const OldTiffStop&) {
      lines = (uint32_t)jp.stop_row * 8;
    } catch (const DecodeError&) {
      if (!jp.scans) return;
      lines = (uint32_t)jp.stop_row * 8;
    }
    out.ok = true;
    out.lines = lines;
    out.pw = jp.comp[0].pw;
    out.px = std::move(jp.comp[0].plane);
  };
  std::vector<std::pair<size_t, bool>> log0;
  std::vector<uint8_t> str0;
  for (int s = 0; s < 3 && found[s]; ++s) {
    if (sof_hv[s] != 0x11) continue;  // libtiff wants the frame's sampling its own, 1 x 1
    std::vector<uint8_t> str = stream(s, 1, at[s]);
    decode(str, pl[s], s ? nullptr : &log0);
    if (!s) str0 = std::move(str);
  }
  // Without plane 1's SOS every call's searches leave the source where they
  // stopped, and plane 0's session, left open, reads on from there: each
  // strip after the first begins with the bytes from where the search
  // stopped to the end of that strile (an RSTn libtiff owes from the
  // strile the strip before it read last comes first, and is the one it
  // wants). When the strip before it left bytes unread in a piece of a
  // strile that is not the strile's last (libtiff hands a strile on in
  // 2048-byte pieces), libjpeg skips them and those to the RSTn after the
  // search's strile, and the strip begins with the next strile's. Plane 0
  // is decoded again, a strip at a time, from such a stream.
  const bool reads_on = !found[1] && stopped < src.size() && pl[0].ok && down > 1 &&
                        restart == (int)(((sw + 7) / 8) * (rps / 8)) && !log0.empty();
  if (reads_on) {
    constexpr size_t kPiece = 2048;  // tif_ojpeg.c's OJPEG_BUFFER
    auto next_end = [&](size_t q) { return *std::upper_bound(strip_end.begin(), strip_end.end(), q); };
    auto block_start = [&](size_t q) {  // the start of q's strile (JPEGInterchangeFormat: 0)
      auto it = std::upper_bound(strip_end.begin(), strip_end.end(), q);
      return q < jif_size ? (size_t)0 : it == strip_end.begin() ? jif_size : std::max(jif_size, *(it - 1));
    };
    // Whether q, read in a piece handed on from `a` on (pieces counted from
    // `origin`), lies in its strile's last piece.
    auto last_piece = [&](size_t q, size_t a, size_t origin) {
      if (q < jif_size) return false;  // no RSTn follows the JPEGInterchangeFormat bytes
      const size_t e = next_end(a), first = std::min(e, origin + kPiece * ((a - origin) / kPiece + 1));
      return q >= (e <= first ? a : first + kPiece * ((e - first - 1) / kPiece));
    };
    const size_t e1 = next_end(stopped);
    const size_t search_origin = std::max(block_start(stopped), block_start(stopped) == block_start(from) ? from : 0);
    const size_t head = stream(0, 1, src.size()).size() - (open_end ? 0 : 2);
    std::vector<uint8_t> str(str0.begin(), str0.begin() + log0[0].first);
    bool from_stop = log0[0].second ||
                     last_piece(from + (log0[0].first - head), block_start(from), block_start(from));
    Plane emu;
    for (uint32_t j = 1; j < down; ++j) {
      const size_t a = from_stop ? stopped : e1, b = a < src.size() ? next_end(a) : a;
      std::vector<uint8_t> tail(str);
      tail.insert(tail.end(), {0xFF, (uint8_t)(0xD0 + ((j - 1) & 7))});
      const size_t at_data = tail.size();
      tail.insert(tail.end(), src.begin() + a, src.begin() + b);
      // RSTn after a strile's bytes, EOI after the last's
      const uint8_t m = b < src.size() || open_end ? 0xD0 + (j & 7) : 0xD9;
      tail.insert(tail.end(), {0xFF, m});
      std::vector<std::pair<size_t, bool>> log;
      emu = Plane();
      decode(tail, emu, &log);
      if (j + 1 < down && log.size() > j) {
        const auto [pos, met] = log[j];
        from_stop = met || pos < at_data ||
                    last_piece(a + (pos - at_data), a, a == stopped ? search_origin : a);
      }
      str.assign(tail.begin(), tail.end() - 2);
    }
    pl[0] = std::move(emu);
  }
  // The codec's session: its plane (-1 none), whether a failed header left
  // it open, the strips it has read, the lines it has given and can give.
  int cur = -1;
  bool stuck = false;
  uint32_t done = 0, line = 0, limit = 0;
  auto lines = [&](uint32_t n) {
    const uint32_t k = std::min(n, limit > line ? limit - line : 0u);
    line += k;
    return k;
  };
  // Plane s's read of strip k: the rows it writes, or -1 when it fails
  // before decoding.
  auto read = [&](int s, uint32_t k) -> int64_t {
    if (!found[s]) {
      if (!reads_on)  // the search ran to the end: libjpeg has only the lines it decoded
        limit = std::min(limit, (line + 7) / 8 * 8);
      return -1;
    }
    if (cur >= 0 && (cur != s || done > k)) cur = -1;
    if (cur < 0) {
      if (stuck) return -1;
      if (!pl[s].ok) {
        stuck = true;
        return -1;
      }
      cur = s;
      done = line = 0;
      limit = pl[s].lines;
    }
    // Past the frame's last line libjpeg gives no line and no error: such a
    // read succeeds, writing nothing (a tile below a tables-layout frame).
    for (; done < k; ++done)
      if (lines(rps) < rps && limit < sof_y) return -1;
    const uint32_t n = tiles ? rps : std::min(rps, H - k * rps), got = lines(n);
    if ((got == n || limit >= sof_y) && ++done % down == 0) cur = -1;  // the plane's last strile ends the session
    return got;
  };
  if (tiles) {
    const size_t tile = (size_t)rps * sw;
    std::vector<uint8_t> buf(3 * tile);
    for (uint32_t ty = 0; ty * across < down; ++ty) {
      std::fill(buf.begin(), buf.end(), 0);
      const uint32_t y0 = ty * rps, nrow = std::min(rps, H - y0);
      for (uint32_t tx = 0; tx < across; ++tx) {
        const uint32_t m = ty * across + tx, x0 = tx * sw, ncol = std::min(sw, W - x0);
        for (int s = 0; s < 3; ++s) {
          const int64_t w = read(s, m);
          if (w < 0 && !s && !tx)
            corrupt("old-style JPEG-in-TIFF plane 0 fails before it decodes (PIL's read fails)");
          if (w < 0 || (w < (int64_t)rps && limit < sof_y)) {  // a failed read clears its tile
            std::fill(&buf[s * tile], &buf[s * tile] + tile, 0);
            continue;
          }
          for (int64_t r = 0; r < w; ++r)
            memcpy(&buf[s * tile + r * sw], &pl[s].px[((size_t)m * rps + r) * pl[s].pw], sw);
        }
        for (uint32_t r = 0; r < nrow; ++r) {
          uint8_t* o = &g.px[(size_t)(y0 + r) * W + x0];
          const uint8_t* b = &buf[(size_t)r * sw];
          for (uint32_t x = 0; x < ncol; ++x) o[x] = conv.grey(b[x], b[tile + x], b[2 * tile + x]);
        }
      }
    }
    return;
  }
  for (uint32_t k = 0; k < down; ++k) {
    int64_t w[3];
    for (int s = 0; s < 3; ++s) w[s] = read(s, k);
    if (w[0] < 0) corrupt("old-style JPEG-in-TIFF plane 0 fails before it decodes (PIL's read fails)");
    const uint32_t n = std::min(rps, H - k * rps);
    for (uint32_t r = 0; r < n; ++r) {
      const size_t y = (size_t)k * rps + r;
      const uint8_t* row[3];
      for (int s = 0; s < 3; ++s) row[s] = w[s] > (int64_t)r ? &pl[s].px[y * pl[s].pw] : nullptr;
      uint8_t* o = &g.px[y * W];
      for (uint32_t x = 0; x < W; ++x)
        o[x] = conv.grey(row[0] ? row[0][x] : 0, row[1] ? row[1][x] : 0, row[2] ? row[2][x] : 0);
    }
  }
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
  const bool planes = c.planes;
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
  // The striles of every plane, one after another in the byte source; the
  // samples of a scan (libtiff's samples_per_pixel_per_plane).
  const uint32_t nall = nstrips * (planes ? spp : 1), per = planes ? 1 : spp;
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
  for (uint32_t i = 0; i < nall; ++i) {
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
  // C.26: libtiff's OJPEGReadSkip skips no further than the end of the
  // block it reads (the JPEGInterchangeFormat bytes or a strile).
  auto skip = [&](size_t k) {
    const size_t end = p <= jif_size ? jif_size : *std::lower_bound(strip_end.begin(), strip_end.end(), p);
    p = std::min({src.size(), end, p + k});
  };
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
      skip(len - 2);
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
      if (!have_sof) corrupt("old-style JPEG-in-TIFF scan before its frame");
      if (word() != 6 + 2 * (int)per || byte() != (int)per)
        corrupt("bad SOS in old-style JPEG-in-TIFF");
      for (uint32_t k = 0; k < per; ++k) {
        sos_cs[k] = byte();
        sos_tda[k] = byte();
      }
      skip(3);  // Ss, Se, Ah/Al
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
  // The stream libjpeg reads of the scan of samples k0 .. k0 + n - 1 whose
  // SOS ends at `from` in the source: the tables, the frame of those
  // samples, their SOS, then what is left of the source, an RSTn after
  // each strile's last bytes but the last strile's. libtiff writes EOI
  // once it has handed on the last strile's bytes; when that strile has
  // none (no offset, or one past the end of the file), the stream ends
  // after the previous strile's RSTn.
  const size_t last_off = nall ? c.offsets[nall - 1] : 0;
  const bool eoi = last_off != 0 && last_off < fsize;
  auto stream = [&](uint32_t k0, uint32_t n, size_t from) {
    std::vector<uint8_t> s{0xFF, 0xD8};
    for (auto* set : {qseg, dcseg, acseg})
      for (int k = 0; k < 4; ++k) s.insert(s.end(), set[k].begin(), set[k].end());
    if (restart) s.insert(s.end(), {0xFF, 0xDD, 0, 4, (uint8_t)(restart >> 8), (uint8_t)restart});
    s.insert(s.end(), {0xFF, (uint8_t)sof_marker, 0, (uint8_t)(8 + 3 * n), 8, (uint8_t)(sof_y >> 8),
                       (uint8_t)sof_y, (uint8_t)(sof_x >> 8), (uint8_t)sof_x, (uint8_t)n});
    for (uint32_t k = k0; k < k0 + n; ++k)
      s.insert(s.end(), {(uint8_t)sof_c[k], (uint8_t)sof_hv[k], (uint8_t)sof_tq[k]});
    s.insert(s.end(), {0xFF, 0xDA, 0, (uint8_t)(6 + 2 * n), (uint8_t)n});
    for (uint32_t k = k0; k < k0 + n; ++k) s.insert(s.end(), {(uint8_t)sos_cs[k], (uint8_t)sos_tda[k]});
    s.insert(s.end(), {0, 63, 0});
    if (from < jif_size) s.insert(s.end(), src.begin() + from, src.begin() + jif_size);
    for (uint32_t i = 0, rst = 0; i < nall; ++i) {
      const size_t a = std::max(from, i ? strip_end[i - 1] : jif_size), b = strip_end[i];
      if (a >= b) continue;
      s.insert(s.end(), src.begin() + a, src.begin() + b);
      if (i + 1 < nall) {
        s.insert(s.end(), {0xFF, (uint8_t)(0xD0 + rst)});
        rst = (rst + 1) & 7;
      }
    }
    if (eoi) s.insert(s.end(), {0xFF, 0xD9});
    return s;
  };
  static const float kLuma[3] = {0.299f, 0.587f, 0.114f}, kRbw[6] = {0, 255, 128, 255, 128, 255};
  const TiffYcc conv = ycc ? tiff_ycc(t, oj.coefficients, oj.refbw) : TiffYcc(kLuma, kRbw);
  if (planes) {
    // C.20: libtiff's RGBA reader takes YCbCr planes (gtStripSeparate) of
    // 1 x 1 subsampling alone, as libtiff's codec corrects it from the
    // stream's frame.
    if (sub_h != 1 || sub_v != 1)
      corrupt("old-style JPEG-in-TIFF planes of YCbCr subsampling libtiff's RGBA reader refuses");
    ojpeg_planes(src, jif_size, strip_end, p, stream, sos_cs, sos_tda, sof_hv, (uint32_t)sof_y, !eoi,
                 restart, rps, nstrips, c.tiles, sw, across, conv, g);
    return;
  }
  const std::vector<uint8_t> s = stream(0, spp, p);
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
        o[c] = float_grey(v);
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
  // tif_dirread.c's old-style JPEG hack: planes whose StripOffsets and
  // StripByteCounts hold one value each are read as contiguous samples.
  if (dir.lt_compression == 6 && dir.lt_planar == 2 && q.soff && q.scnt &&
      t.entry(q.soff).count == 1 && t.entry(q.scnt).count == 1)
    dir.lt_planar = 1;
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
                        sub ? (int)dir.ycbcr_sub[1] : 0, planes};
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

// ---------------------------------------------------------- Netpbm (A.6.29)
//
// PIL's PpmImagePlugin: P1-P6 plain and raw, Pf, and Pillow's own P0CMYK,
// PyP, PyRGBA and PyCMYK headers. A header token is read to whitespace, 10
// bytes at most, a comment (# to CR, LF or the end) skipped wherever it
// starts; its numbers are Python's int() and float(). A sample is scaled to
// the mode's range as Python rounds (half to even); a plain one past maxval,
// and samples that end early, are refused.

inline bool pnm_space(int c) { return c == ' ' || c == '\t' || c == '\n' || c == '\v' || c == '\f' || c == '\r'; }
inline bool pnm_digit(int c) { return c >= '0' && c <= '9'; }

// Python's int() of an ASCII token: a sign, then digits with single
// underscores between them; its value saturates at 2^50. False where
// Python raises.
constexpr int64_t kPyIntCap = (int64_t)1 << 50;
bool py_int(const char* t, size_t n, int64_t& v) {
  size_t i = 0;
  const bool neg = n && t[0] == '-';
  if (n && (t[0] == '+' || t[0] == '-')) ++i;
  if (i >= n) return false;
  int64_t x = 0;
  for (; i < n; ++i) {
    if (t[i] == '_' && i > 0 && pnm_digit(t[i - 1]) && i + 1 < n && pnm_digit(t[i + 1])) continue;
    if (!pnm_digit(t[i])) return false;
    x = std::min(kPyIntCap, x * 10 + (t[i] - '0'));
  }
  v = neg ? -x : x;
  return true;
}
bool py_int(const std::string& t, int64_t& v) { return py_int(t.data(), t.size(), v); }

// Python's float() of a token: a sign, then digits (underscores between
// them) with a point and an exponent, or inf, infinity or nan in any case.
bool py_float(const std::string& t, double& v) {
  std::string s;
  size_t i = 0;
  if (i < t.size() && (t[i] == '+' || t[i] == '-')) s += t[i++];
  std::string word;
  for (size_t k = i; k < t.size(); ++k) word += (char)tolower((unsigned char)t[k]);
  if (word == "inf" || word == "infinity" || word == "nan") {
    v = word == "nan" ? NAN : (s == "-" ? -INFINITY : INFINITY);
    return true;
  }
  int digits = 0, mant = 0;
  bool point = false, exp = false;
  for (; i < t.size(); ++i) {
    const char c = t[i];
    if (c == '_') {
      if (!(i > 0 && pnm_digit(t[i - 1]) && i + 1 < t.size() && pnm_digit(t[i + 1]))) return false;
      continue;
    }
    if (pnm_digit(c)) {
      ++digits;
      if (!exp) ++mant;
    } else if (c == '.' && !point && !exp) {
      point = true;
    } else if ((c == 'e' || c == 'E') && !exp && mant) {
      exp = true;
      digits = 0;
      if (i + 1 < t.size() && (t[i + 1] == '+' || t[i + 1] == '-')) s += t[++i] == '+' ? "e+" : "e-";
      else s += 'e';
      continue;
    } else {
      return false;
    }
    s += c;
  }
  if (!mant || (exp && !digits)) return false;
  v = strtod(s.c_str(), nullptr);
  return true;
}

struct Pnm {
  int kind = 0;  // '1'-'6': P1-P6; 'f': Pf; 'C': P0CMYK or PyCMYK; 'P': PyP; 'A': PyRGBA
  int64_t w = 0, h = 0, maxval = 255;
  double scale = 0;
  size_t data = 0;  // where the samples begin
};

// Whether PIL's PpmImagePlugin takes the file (false: it raises
// SyntaxError, and Image.open tries the next plugin); throws where its
// header raises ValueError.
bool pnm_head(const uint8_t* d, size_t n, Pnm& p) {
  size_t pos = 0;
  std::string magic;
  for (int i = 0; i < 6 && pos < n; ++i) {
    const int c = d[pos++];
    if (pnm_space(c)) break;
    magic += (char)c;
  }
  static const struct { const char* m; int kind; } kMagic[] = {
      {"P1", '1'}, {"P2", '2'}, {"P3", '3'}, {"P4", '4'}, {"P5", '5'}, {"P6", '6'},
      {"P0CMYK", 'C'}, {"Pf", 'f'}, {"PyP", 'P'}, {"PyRGBA", 'A'}, {"PyCMYK", 'C'}};
  for (const auto& k : kMagic)
    if (magic == k.m) p.kind = k.kind;
  if (!p.kind) return false;
  auto token = [&]() {
    std::string t;
    while (t.size() <= 10 && pos < n) {
      const int c = d[pos++];
      if (pnm_space(c)) {
        if (t.empty()) continue;
        break;
      }
      if (c == '#') {
        while (pos < n && d[pos] != '\r' && d[pos] != '\n') ++pos;
        if (pos < n) ++pos;
        continue;
      }
      t += (char)c;
    }
    if (t.empty()) corrupt("Netpbm header ends early");
    if (t.size() > 10) corrupt("Netpbm header token too long");
    return t;
  };
  if (!py_int(token(), p.w) || !py_int(token(), p.h)) corrupt("Netpbm size not a number");
  if (p.kind == 'f') {
    if (!py_float(token(), p.scale)) corrupt("Netpbm scale not a number");
    if (p.scale == 0.0 || !std::isfinite(p.scale)) corrupt("Netpbm scale zero or not finite");
  } else if (p.kind != '1' && p.kind != '4') {
    if (!py_int(token(), p.maxval)) corrupt("Netpbm maxval not a number");
    if (p.maxval <= 0 || p.maxval >= 65536) corrupt("Netpbm maxval not 1 .. 65535");
  }
  p.data = pos;
  return p.w > 0 && p.h > 0;  // ImageFile: no pixels is no image of this plugin
}

// PIL's plain decoders read the samples a SAFEBLOCK (1 MiB) at a time and
// drop comments, # to the first CR or LF, block by block.
struct PnmBlocks {
  const uint8_t* d;
  size_t n, pos;
  bool spans = false;  // a comment runs on into the next block
  static constexpr size_t kBlock = 1 << 20;
  std::string read() {
    const size_t k = std::min(kBlock, n - pos);
    std::string b((const char*)d + pos, k);
    pos += k;
    return b;
  }
  static long comment_end(const std::string& b, size_t from) {  // as PpmPlainDecoder finds it
    const size_t a = b.find('\n', from), c = b.find('\r', from);
    const long x = a == std::string::npos ? -1 : (long)a, y = c == std::string::npos ? -1 : (long)c;
    return x * y > 0 ? std::min(x, y) : std::max(x, y);
  }
  std::string uncomment(std::string b) {
    if (spans) {
      while (!b.empty()) {
        const long e = comment_end(b, 0);
        if (e != -1) {
          b.erase(0, e + 1);
          break;
        }
        b = read();
      }
    }
    spans = false;
    for (;;) {
      const size_t s = b.find('#');
      if (s == std::string::npos) break;
      const long e = comment_end(b, s);
      if (e != -1) {
        b.erase(s, e + 1 - s);
      } else {
        b.erase(s);
        spans = true;
        break;
      }
    }
    return b;
  }
};

inline int py_round(double x) { return (int)std::nearbyint(x); }

Gray decode_pnm(const uint8_t* d, size_t n, const Pnm& p) {
  check_size(p.w, p.h);
  Gray g;
  g.w = (int)p.w;
  g.h = (int)p.h;
  const size_t px = (size_t)p.w * p.h;
  g.px.resize(px);
  const uint8_t* s = d + p.data;
  const size_t left = n - p.data;
  auto short_data = [] { corrupt("Netpbm samples end early (PIL refuses the file)"); };
  if (p.kind == '4') {  // raw 1;I: a set bit is black
    const size_t stride = ((size_t)p.w + 7) / 8;
    if (left < stride * p.h) short_data();
    for (int64_t y = 0; y < p.h; ++y)
      for (int64_t x = 0; x < p.w; ++x)
        g.px[y * p.w + x] = (s[y * stride + (x >> 3)] >> (7 - (x & 7))) & 1 ? 0 : 255;
    return g;
  }
  if (p.kind == 'f') {  // F;32F (scale < 0) or F;32BF, the bottom row first; F -> L truncates
    if (left / 4 < px) short_data();
    for (int64_t y = 0; y < p.h; ++y)
      for (int64_t x = 0; x < p.w; ++x) {
        const uint8_t* q = s + 4 * ((p.h - 1 - y) * p.w + x);
        const uint32_t u = p.scale < 0 ? q[0] | q[1] << 8 | q[2] << 16 | (uint32_t)q[3] << 24
                                       : (uint32_t)q[0] << 24 | q[1] << 16 | q[2] << 8 | q[3];
        float f;
        memcpy(&f, &u, 4);
        g.px[y * p.w + x] = float_grey(f);
      }
    return g;
  }
  if (p.kind == '5' && p.maxval == 255) {  // raw L
    if (left < px) short_data();
    memcpy(g.px.data(), s, px);
    return g;
  }
  const int bands = p.kind == '3' || p.kind == '6' ? 3 : p.kind == 'C' || p.kind == 'A' ? 4 : 1;
  const bool grey_i = (p.kind == '2' || p.kind == '5') && p.maxval > 255;  // PIL's mode I
  const int out_max = grey_i ? 65535 : 255;
  std::vector<int> v((size_t)px * bands);
  if (p.kind == '1') {  // plain bitonal: every character 0 or 1, 0 white
    PnmBlocks b{d, n, p.data};
    size_t k = 0;
    while (k != px) {
      std::string blk = b.read();
      if (blk.empty()) break;
      blk = b.uncomment(blk);
      for (char c : blk) {
        if (pnm_space((unsigned char)c)) continue;
        if (c != '0' && c != '1') corrupt("Netpbm P1 sample not 0 or 1");
        if (k < px) v[k++] = c == '0' ? 255 : 0;
      }
    }
    if (k != px) short_data();
    for (size_t i = 0; i < px; ++i) g.px[i] = (uint8_t)v[i];
    return g;
  }
  if (p.kind == '2' || p.kind == '3') {  // plain: tokens of at most 10 bytes
    PnmBlocks b{d, n, p.data};
    size_t k = 0;
    const size_t total = v.size();
    std::string half;
    while (k != total) {
      std::string blk = b.read();
      if (blk.empty()) {
        if (half.empty()) break;
        blk = " ";
      }
      blk = b.uncomment(blk);
      blk = half + blk;
      half.clear();
      std::vector<std::pair<size_t, size_t>> toks;  // (start, length) in blk
      for (size_t i = 0; i < blk.size();) {
        while (i < blk.size() && pnm_space((unsigned char)blk[i])) ++i;
        size_t j = i;
        while (j < blk.size() && !pnm_space((unsigned char)blk[j])) ++j;
        if (j > i) toks.emplace_back(i, j - i);
        i = j;
      }
      if (!blk.empty() && !pnm_space((unsigned char)blk.back())) {
        half = blk.substr(toks.back().first);
        toks.pop_back();
        if (half.size() > 10) corrupt("Netpbm sample token too long");
      }
      for (const auto& [at, len] : toks) {
        int64_t x;
        if (len > 10) corrupt("Netpbm sample token too long");
        if (!py_int(blk.data() + at, len, x)) corrupt("Netpbm sample not a number");
        if (x < 0) corrupt("Netpbm sample negative");
        if (x > p.maxval) corrupt("Netpbm sample past maxval");
        v[k++] = py_round((double)x / (double)p.maxval * out_max);
        if (k == total) break;
      }
    }
    if (k != total) short_data();
  } else {  // raw, '5', '6', 'C', 'P', 'A'
    const int in = p.maxval < 256 ? 1 : 2;
    if (left / ((size_t)in * bands) < px) short_data();
    const bool straight = p.maxval == 255 || (p.maxval == 65535 && p.kind == '5');
    for (size_t i = 0; i < v.size(); ++i) {
      const int x = in == 1 ? s[i] : s[2 * i] << 8 | s[2 * i + 1];
      v[i] = straight ? x : std::min(out_max, py_round((double)x / (double)p.maxval * out_max));
    }
  }
  for (size_t i = 0; i < px; ++i) {
    const int* q = &v[i * bands];
    switch (p.kind) {
      case '2': case '5': g.px[i] = (uint8_t)std::min(q[0], 255); break;  // L, or I clipped
      case '3': case '6': case 'A': g.px[i] = luma(q[0], q[1], q[2]); break;
      case 'C': g.px[i] = cmyk_luma(q[0], q[1], q[2], q[3]); break;
      default: g.px[i] = 0; break;  // PyP: P without a palette reads black
    }
  }
  return g;
}

// --------------------------------------------------------------- GIF (A.6.28)
//
// The first frame as PIL's GifImagePlugin and GifDecode.c read it: the
// extensions before its image descriptor skipped (a graphic control
// extension's transparency index taken when its flag is set), its local
// table or the global one (mode L where there is none, or where it is the
// identity ramp, the indices then the grey; else P, an index past the table
// black), a canvas of the logical screen grown to hold the frame, filled
// with the transparency index or 0, then the LZW codes (Pillow's decoder:
// a code past the next free one or a first code past the clear code is
// refused, the code table stops growing at 4096 entries, a clear code
// after a clear is ignored) written in the frame's rows, interlaced in four
// passes, until the frame is full. Data that ends first is refused, as PIL
// refuses it ("image file is truncated"). EOI only ends a call of the
// decoder: PIL hands it the file 64 KB at a time from the frame's data on,
// and calls it again, with the codes after EOI, while the file holds more.
Gray decode_gif(const uint8_t* d, size_t n) {
  if (n < 11) corrupt("GIF header ends early");
  size_t pos = std::min<size_t>(13, n);
  int64_t W = le16(d + 6), H = le16(d + 8);
  const int flags = d[10];
  // GifImageFile._is_palette_needed: a table that is not i, i, i for every
  // entry it holds; a partial entry that matches so far raises.
  auto needed = [](const uint8_t* p, size_t len) {
    for (size_t i = 0; i < len; i += 3) {
      if (p[i] != i / 3) return true;
      if (i + 1 >= len) corrupt("GIF colour table ends early");
      if (p[i + 1] != p[i]) return true;
      if (i + 2 >= len) corrupt("GIF colour table ends early");
      if (p[i + 2] != p[i]) return true;
    }
    return false;
  };
  const uint8_t* global = nullptr;
  size_t global_len = 0;
  if (flags & 128) {
    if (n < 12) corrupt("GIF header ends early");
    const size_t len = std::min((size_t)3 << ((flags & 7) + 1), n - pos);
    if (needed(d + pos, len)) {
      global = d + pos;
      global_len = len;
    }
    pos += len;
  }
  auto byte = [&]() -> int { return pos < n ? d[pos++] : -1; };
  // GifImageFile.data: a sub-block (nullptr for a 0 length or the end),
  // its bytes as many as the file holds.
  auto block = [&](size_t& len) -> const uint8_t* {
    const int c = byte();
    if (c <= 0) return nullptr;
    len = std::min((size_t)c, n - pos);
    const uint8_t* b = d + pos;
    pos += len;
    return b;
  };
  int transparency = -1;
  int64_t x0 = 0, y0 = 0, fw = 0, fh = 0;
  bool interlace = false, have_frame = false;
  const uint8_t* table = global;
  size_t table_len = global_len;
  int bits = 0;
  for (int s = byte(); s >= 0 && s != ';'; s = byte()) {
    if (s == '!') {
      const int label = byte();
      if (label < 0) corrupt("GIF extension ends early");
      size_t len = 0;
      const uint8_t* b = block(len);
      if (label == 0xF9 && b) {
        if (len < 1) corrupt("GIF graphic control extension ends early");
        if (b[0] & 1) {
          if (len < 4) corrupt("GIF graphic control extension ends early");
          transparency = b[3];
        }
        if (len < 3) corrupt("GIF graphic control extension ends early");
      } else if (label == 0xFE) {
        while (b) b = block(len);
        continue;
      } else if (label == 0xFF && b && len >= 11 && !memcmp(b, "NETSCAPE2.0", 11)) {
        block(len);  // its loop count, or the terminator: the sub-blocks then run on past it
      }
      while (block(len) && len) {
      }
    } else if (s == ',') {
      if (n - pos < 9) corrupt("GIF image descriptor ends early");
      const uint8_t* q = d + pos;
      pos += 9;
      x0 = le16(q);
      y0 = le16(q + 2);
      fw = le16(q + 4);
      fh = le16(q + 6);
      W = std::max(W, x0 + fw);
      H = std::max(H, y0 + fh);
      if (W * H > kMaxPixels) corrupt("GIF larger than PIL's decompression-bomb limit");
      interlace = q[8] & 64;
      if (q[8] & 128) {
        const size_t len = std::min((size_t)3 << ((q[8] & 7) + 1), n - pos);
        const bool need = needed(d + pos, len);
        table = need ? d + pos : nullptr;
        table_len = need ? len : 0;
        pos += len;
      }
      bits = byte();
      if (bits < 0) corrupt("GIF image ends before its LZW code size");
      have_frame = true;
      break;
    }
  }
  if (!have_frame) corrupt("GIF without an image");
  check_size(W, H);
  if (bits > 12) corrupt("GIF LZW code size past 12 (PIL's decoder refuses it)");
  if (x0 == 0 && fw == 0) {  // decode.c's setimage: extents (0, y0, 0, y1) are the whole image
    y0 = 0;
    fw = W;
    fh = H;
  }
  if (fw <= 0 || fh <= 0) corrupt("GIF frame of no pixels (PIL: tile cannot extend outside image)");
  // The frame's indices on the canvas; then the palette's grey (L: as is).
  std::vector<uint8_t> idx((size_t)W * H, (uint8_t)(transparency < 0 ? 0 : transparency));
  constexpr int kTable = 4096;
  std::vector<uint8_t> data(kTable), stack(kTable);
  std::vector<uint16_t> link(kTable);
  const int clear = 1 << bits, end = clear + 1;
  int next = 0, codesize = 0, codemask = 0, lastdata = 0, lastcode = 0, state = 1;
  uint32_t bitbuf = 0;
  int bitcount = 0, blocksize = 0;
  int64_t x = 0, y = 0, step = interlace ? 8 : 1, pass = interlace ? 1 : 0;
  const size_t data_at = pos;  // the tile's offset, where PIL's reads begin
  uint8_t* out = &idx[(size_t)y0 * W + x0];
  bool full = false;
  // NEWLINE: the next row of the pass, the next pass past the frame's foot.
  auto newline = [&]() {
    x = 0;
    y += step;
    while (y >= fh) {
      if (pass == 1) {
        y = 4;
        pass = 2;
      } else if (pass == 2) {
        step = 4;
        y = 2;
        pass = 3;
      } else if (pass == 3) {
        step = 2;
        y = 1;
        pass = 0;
      } else {
        full = true;
        return;
      }
    }
    out = &idx[(size_t)(y0 + y) * W + x0];
  };
  while (!full) {
    if (state == 1) {
      next = clear + 2;
      codesize = bits + 1;
      codemask = (1 << codesize) - 1;
      state = 2;
    }
    while (bitcount < codesize) {
      if (blocksize > 0) {
        bitbuf |= (uint32_t)d[pos++] << bitcount;
        bitcount += 8;
        --blocksize;
      } else {  // a sub-block is decoded only once the file holds all of it
        if (pos >= n || n - pos < (size_t)d[pos] + 1)
          corrupt("GIF image data ends before EOI (PIL: image file is truncated)");
        blocksize = d[pos++];
      }
    }
    int c = (int)(bitbuf & codemask);
    bitbuf >>= codesize;
    bitcount -= codesize;
    if (c == clear) {
      if (state != 2) state = 1;
      continue;
    }
    if (c == end) {  // the call ends; the next one, with PIL's next 64 KB, goes on
      const size_t handed = data_at + ((pos + blocksize - data_at + kPilBlock - 1) / kPilBlock) * kPilBlock;
      if (handed >= n) corrupt("GIF frame ends before its pixels (PIL: image file is truncated)");
      continue;
    }
    const uint8_t* p;
    int len = 1;
    uint8_t one;
    if (state == 2) {
      if (c > clear) corrupt("GIF LZW code past the clear code after a clear");
      lastdata = lastcode = c;
      one = (uint8_t)c;
      p = &one;
      state = 3;
    } else {
      const int thiscode = c;
      if (c > next) corrupt("GIF LZW code past the next free code");
      int at = kTable;
      if (c == next) {
        stack[--at] = (uint8_t)lastdata;
        c = lastcode;
      }
      while (c >= clear) {
        stack[--at] = data[c];
        c = link[c];
      }
      stack[--at] = (uint8_t)c;
      lastdata = c;
      if (next < kTable) {
        data[next] = (uint8_t)c;
        link[next] = (uint16_t)lastcode;
        if (next == codemask && codesize < 12) {
          ++codesize;
          codemask = (1 << codesize) - 1;
        }
        ++next;
      }
      lastcode = thiscode;
      p = &stack[at];
      len = kTable - at;
    }
    for (int k = 0; k < len && !full; ++k) {
      *out++ = p[k];
      if (++x >= fw) newline();
    }
  }
  Gray g;
  g.w = (int)W;
  g.h = (int)H;
  g.px.resize(idx.size());
  if (!table) {
    g.px = std::move(idx);
    return g;
  }
  uint8_t grey[256] = {0};
  for (size_t i = 0; i < table_len / 3; ++i) grey[i] = luma(table[3 * i], table[3 * i + 1], table[3 * i + 2]);
  for (size_t i = 0; i < idx.size(); ++i) g.px[i] = grey[idx[i]];
  return g;
}

// ------------------------------------------------ PIL's other formats (C.21)
//
// Image.open tries Pillow 12.1.0's plugins in Image.ID's order: preinit's
// (BMP, DIB, GIF, JPEG, PPM, PNG), then the rest as init imports them. A
// plugin whose _accept takes the file's first 16 bytes opens it; an _open
// that raises SyntaxError (IndexError, TypeError, KeyError, EOFError and
// struct.error become one) passes the file on to the next plugin, any
// other exception fails Image.open. IM, IMT, IPTC, PCD, SPIDER and TGA have
// no _accept: their _open's checks decide. `pil_format` is the format PIL
// opens a file as, by those rules, for the kinds the port does not read by
// its own magic (PNG, JPEG, BMP, TIFF and GIF come first and keep their
// routes): PPM (A.6.29), WebP (A.6.30-A.6.32), DIB, ICO, CUR, TGA, PCX,
// DCX, SGI, SUN, MSP, QOI (A.6.33-A.6.42), IM, XBM, XPM, XVThumb and PSD
// (A.6.43-A.6.47), DDS, FTEX, BLP and SPIDER (A.6.49-A.6.55) are read
// here; the stubs with no decoder in PIL (BUFR, GRIB, HDF5, WMF), MPEG (no
// tile) and EPS (Ghostscript) are corrupt, as PIL refuses their pixels;
// every other raises naming A.6. The checks go
// as deep as each _open's header; a damaged file of a format PIL opens
// raises naming A.6 even where PIL would then refuse its pixels.

inline uint32_t be16(const uint8_t* p) { return p[0] << 8 | p[1]; }
inline uint32_t be32(const uint8_t* p) { return (uint32_t)p[0] << 24 | p[1] << 16 | p[2] << 8 | p[3]; }
inline bool starts(const uint8_t* d, size_t n, const char* m, size_t k) { return n >= k && !memcmp(d, m, k); }

// Python's int() and float() of a str read from a file as latin-1: the
// whitespace they take off around it first (ASCII's, 0x85 and 0xA0; not
// 0x1C-0x1F, which str.strip() would).
inline bool py_str_space(uint8_t c) { return (c >= 9 && c <= 13) || c == 0x20 || c == 0x85 || c == 0xA0; }
std::string py_strip(const std::string& t) {
  size_t a = 0, b = t.size();
  while (a < b && py_str_space((uint8_t)t[a])) ++a;
  while (b > a && py_str_space((uint8_t)t[b - 1])) --b;
  return t.substr(a, b - a);
}
// ImImagePlugin's _open (A.6.43): "Key: value" lines, each under 101
// bytes, a CR opening a line skipped, until NUL, ^Z or the end; at least
// one key of its TAGS; then ^Z before the pixels. "Image type" maps its
// OPEN names to a mode and a raw mode (any other value is the mode, the raw
// mode staying what it was, "L" at first); the size's, the frame count's
// and the scale's values must be numbers. A "Lut" key takes 768 bytes
// after ^Z: a palette of colours makes L and P mode P (raw P), LA and PA
// mode PA (raw PA;L); a grey one, linear or not, changes nothing (PIL keeps
// it as `lut` and never applies it). False where PIL passes the file on to
// the next plugin; throws where Image.open fails.
struct ImHead {
  std::string mode = "L", rawmode = "L";
  int64_t w = 512, h = 512;
  size_t data = 0;        // where the pixels start
  bool palette = false;   // a colour Lut: `pal` its RGB;L bytes
  const uint8_t* pal = nullptr;
};

bool im_open(const uint8_t* d, size_t n, ImHead& m) {
  if (!memchr(d, '\n', std::min<size_t>(n, 100))) return false;
  static const char* kTags[] = {"Comment", "Date", "Digitalization equipment", "File size (no of images)",
                                "Lut", "Name", "Scale (x,y)", "Image size (x*y)", "Image type"};
  static const char* kOpen[][3] = {
      {"0 1 image", "1", "1"}, {"L 1 image", "1", "1"}, {"Greyscale image", "L", "L"},
      {"Grayscale image", "L", "L"}, {"RGB image", "RGB", "RGB;L"}, {"RLB image", "RGB", "RLB"},
      {"RYB image", "RGB", "RLB"}, {"B1 image", "1", "1"}, {"B2 image", "P", "P;2"},
      {"B4 image", "P", "P;4"}, {"X 24 image", "RGB", "RGB"}, {"L 32 S image", "I", "I;32"},
      {"L 32 F image", "F", "F;32"}, {"RGB3 image", "RGB", "RGB;T"}, {"RYB3 image", "RGB", "RYB;T"},
      {"LA image", "LA", "LA;L"}, {"PA image", "LA", "PA;L"}, {"RGBA image", "RGBA", "RGBA;L"},
      {"RGBX image", "RGB", "RGBX;L"}, {"CMYK image", "CMYK", "CMYK;L"}, {"YCC image", "YCbCr", "YCbCr;L"},
      {"L 8 image", "F", "F;8"}, {"L 8S image", "F", "F;8S"}, {"L 16S image", "F", "F;16S"},
      {"L 32 image", "F", "F;32"}, {"L 32F image", "F", "F;32F"}, {"L*8S image", "F", "F;8S"},
      {"L*16S image", "F", "F;16S"}, {"L*32F image", "F", "F;32F"}, {"L 16 image", "I;16", "I;16"},
      {"L 16L image", "I;16L", "I;16L"}, {"L*16L image", "I;16L", "I;16L"},
      {"L 16B image", "I;16B", "I;16B"}, {"L*16B image", "I;16B", "I;16B"},
      {"L 32S image", "I", "I;32S"}, {"L*32S image", "I", "I;32S"}};
  size_t pos = 0;
  int tags = 0, c = -1;
  bool lut = false;
  std::vector<double> size{512, 512};  // the size's values; NAN marks a float
  while (pos < n) {
    c = d[pos++];
    if (c == '\r') continue;
    if (c == 0 || c == 0x1A) break;
    const size_t start = pos - 1;
    while (pos < n && d[pos++] != '\n') {
    }
    std::string s((const char*)d + start, pos - start);
    c = -1;
    if (s.size() > 100) return false;
    if (s.size() >= 2 && s.compare(s.size() - 2, 2, "\r\n") == 0) s.resize(s.size() - 2);
    else if (!s.empty() && s.back() == '\n') s.pop_back();
    const size_t colon = s.find(':');
    if (s.empty() || !isalpha((unsigned char)s[0]) || colon == std::string::npos ||
        s.find('\n') != std::string::npos)
      return false;
    const std::string k = s.substr(0, colon);
    size_t v0 = colon + 1;
    while (v0 < s.size() && (s[v0] == ' ' || s[v0] == '\t')) ++v0;
    const std::string v = s.substr(v0);
    const bool is_size = k == "Image size (x*y)";
    if (is_size || k == "File size (no of images)" || k == "Scale (x,y)") {
      std::vector<double> vals;
      for (size_t a = 0;;) {  // "*" read as ",", each piece int() or else float()
        size_t b = a;
        while (b < v.size() && v[b] != ',' && v[b] != '*') ++b;
        const std::string piece = py_strip(v.substr(a, b - a));
        int64_t iv;
        double fv;
        if (py_int(piece, iv)) vals.push_back((double)iv);
        else if (py_float(piece, fv)) vals.push_back(fv > 0 ? NAN : fv);  // a float > 0 only fails later
        else corrupt("IM header number not a number (PIL refuses the file)");
        if (b >= v.size()) break;
        a = b + 1;
      }
      if (is_size) size = vals;
    } else if (k == "Image type") {
      m.mode = v;
      for (const auto& o : kOpen)
        if (v == o[0]) {
          m.mode = o[1];
          m.rawmode = o[2];
        }
      for (int j = 2; j <= 32; ++j)  // "L*j image": F;j (8, 16 and 32 read raw, the rest bit-packed)
        if (v == "L*" + std::to_string(j) + " image") {
          m.mode = "F";
          m.rawmode = "F;" + std::to_string(j);
        }
    }
    lut = lut || k == "Lut";
    for (const char* t : kTags) tags += k == t;
  }
  if (!tags) return false;
  while (c != 0x1A) {  // the pixels start after ^Z
    if (pos >= n) return false;
    c = d[pos++];
  }
  if (lut) {
    if (n - pos < 768) return false;  // the palette's bytes cut short: IndexError
    const uint8_t* p = d + pos;
    bool grey = true;
    for (int i = 0; i < 256; ++i) grey = grey && p[i] == p[i + 256] && p[i] == p[i + 512];
    const std::string& mo = m.mode;
    if (!grey && (mo == "L" || mo == "P" || mo == "LA" || mo == "PA")) {
      const bool alpha = mo[1] == 'A';
      m.mode = alpha ? "PA" : "P";
      m.rawmode = alpha ? "PA;L" : "P";
      m.palette = true;
      m.pal = p;
    }
    pos += 768;
  }
  m.data = pos;
  // ImageFile: no mode, or a size of one value (TypeError) or not above 0,
  // passes the file on.
  if (m.mode.empty() || size.size() < 2 || !(size[0] > 0 || std::isnan(size[0])) ||
      !(size[1] > 0 || std::isnan(size[1])))
    return false;
  if (size.size() != 2 || std::isnan(size[0]) || std::isnan(size[1]))
    corrupt("IM size not two integers (PIL refuses the file)");
  m.w = (int64_t)size[0];
  m.h = (int64_t)size[1];
  return true;
}

// XbmImagePlugin's xbm_head matched on the first 512 bytes: whitespace,
// "#define[ \t]+.*_width[ \t]+N[\r\n]+", the same of "_height", then
// anything up to "_bits[]" (the regex's greedy parts: the last "_width" of
// its line that fits, the last "_bits[]"). False where it does not match;
// else the size and where the data starts, after that "_bits[]".
bool xbm_open(const uint8_t* d, size_t n, int64_t& w, int64_t& h, size_t& data) {
  const std::string s((const char*)d, std::min<size_t>(n, 512));
  size_t k = 0;
  while (k < s.size() && pnm_space((unsigned char)s[k])) ++k;
  if (k > 9) return false;  // _accept: "#define" within the first 16 bytes
  // The ends and numbers of "#define...<what> N[\r\n]+" at `at`, the
  // greedy .* trying the last <what> on the line first.
  auto defines = [&](size_t at, const std::string& what) {
    std::vector<std::pair<size_t, int64_t>> out;
    if (s.compare(at, 7, "#define") != 0) return out;
    at += 7;
    if (at >= s.size() || (s[at] != ' ' && s[at] != '\t')) return out;
    const size_t eol = std::min(s.find('\n', at), s.size());
    for (size_t p = eol; p-- > at + 1;) {
      if (s.compare(p, what.size(), what) != 0) continue;
      size_t q = p + what.size();
      if (q >= s.size() || (s[q] != ' ' && s[q] != '\t')) continue;
      while (q < s.size() && (s[q] == ' ' || s[q] == '\t')) ++q;
      const size_t digits = q;
      int64_t v = 0;
      for (; q < s.size() && pnm_digit(s[q]); ++q) v = std::min(kPyIntCap, v * 10 + (s[q] - '0'));
      if (q == digits || q >= s.size() || (s[q] != '\r' && s[q] != '\n')) continue;
      while (q < s.size() && (s[q] == '\r' || s[q] == '\n')) ++q;
      out.emplace_back(q, v);
    }
    return out;
  };
  const size_t bits = s.rfind("_bits[]");
  if (bits == std::string::npos) return false;
  for (const auto& [e1, wv] : defines(k, "_width"))
    for (const auto& [e2, hv] : defines(e1, "_height"))
      if (bits >= e2) {
        w = wv;
        h = hv;
        data = bits + 7;
        return true;
      }
  return false;
}

// ------------------------------------------------- ICO, CUR (on the DIB reader)

// CurImagePlugin: the first cursor of the directory, replaced by one whose
// width and height bytes are both larger (0 counts as 0 here); its DIB at
// the entry's offset (where the directory's reads stopped for an offset of
// 0), as high as half its height. False where Image.open passes the file
// on: a directory entry or the DIB's header read past the file's end, no
// cursor, a size that is not positive.
bool cur_open(const uint8_t* d, size_t n, Dib& b, int64_t& rows) {
  if (n < 6) return false;
  size_t pos = 6, mlen = 0;
  const uint8_t* m = nullptr;
  for (uint32_t i = 0, count = le16(d + 4); i < count; ++i) {
    const size_t k = pos < n ? std::min<size_t>(16, n - pos) : 0;
    const uint8_t* s = d + pos;
    pos += k;
    if (!mlen) {
      m = s;
      mlen = k;
    } else if (!k) {
      return false;  // s[0]: IndexError
    } else if (s[0] > m[0]) {
      if (k < 2 || mlen < 2) return false;
      if (s[1] > m[1]) {
        m = s;
        mlen = k;
      }
    }
  }
  if (mlen < 16) return false;  // no cursor (TypeError), or i32(m, 12) short
  const uint32_t at = le32(m + 12);
  if (!dib_header(d, n, at ? at : pos, 0, b)) return false;
  rows = b.h / 2;
  return b.w > 0 && rows > 0;
}

// IcoImagePlugin's entry: the directory sorted by colour depth, then by area,
// largest first (both sorts stable); PIL loads the first.
struct IcoEntry {
  uint32_t bpp, size, offset;
  int64_t square, depth;
};

// The icon PIL's IcoImageFile._open loads: 0 where Image.open passes the
// file on (a directory entry past the file's end, no entry, a bitmap
// header past the file's end or of no size), 1 a bitmap (`b`, `rows` its
// XOR half), 2 a PNG icon, whose stream starts at `png_at` and which the
// Python side decodes (infer/export.py::decode_png; PIL takes the PNG's
// own size).
int ico_open(const uint8_t* d, size_t n, Dib& b, int64_t& rows, size_t& png_at) {
  if (n < 6) return 0;
  const uint32_t count = le16(d + 4);
  if (!count || n - 6 < (uint64_t)16 * count) return 0;
  std::vector<IcoEntry> entries(count);
  for (uint32_t i = 0; i < count; ++i) {
    const uint8_t* s = d + 6 + 16 * i;
    const int64_t w = s[0] ? s[0] : 256, h = s[1] ? s[1] : 256;
    const uint32_t colors = s[2], bpp = le16(s + 6);
    // bpp or (nb_color != 0 and ceil(log(nb_color, 2))) or 256
    int64_t depth = bpp;
    if (!depth && colors) depth = (int64_t)std::ceil(std::log((double)colors) / std::log(2.0));
    if (!depth) depth = 256;
    entries[i] = IcoEntry{bpp, le32(s + 8), le32(s + 12), w * h, depth};
  }
  std::stable_sort(entries.begin(), entries.end(),
                   [](const IcoEntry& a, const IcoEntry& c) { return a.depth < c.depth; });
  std::stable_sort(entries.begin(), entries.end(),
                   [](const IcoEntry& a, const IcoEntry& c) { return a.square > c.square; });
  const IcoEntry& e = entries[0];
  static const uint8_t kMagic[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
  if (e.offset <= n && n - e.offset >= 8 && !memcmp(d + e.offset, kMagic, 8)) {
    png_at = e.offset;
    return 2;
  }
  if (!dib_header(d, n, e.offset, 0, b) || b.w <= 0 || b.h <= 0) return 0;
  check_size(b.w, b.h);
  rows = b.h / 2;
  if (rows <= 0) corrupt("ICO bitmap of height 1 (PIL refuses its tile)");
  if (e.bpp == 32) {  // the alpha bytes of 32-bit pixels, whatever the DIB holds
    if (b.offset > n || (n - b.offset) / 4 < (uint64_t)b.w * rows) corrupt("ICO alpha ends early");
  } else {  // the AND mask, rows padded to 32 bits, ending where the entry ends
    const uint64_t stride = (uint64_t)(b.w + 31) / 32 * 4, total = stride * rows;
    const int64_t at = (int64_t)e.offset + e.size - (int64_t)total;
    if (at < 0) corrupt("ICO mask before the file's start");
    const uint64_t got = (uint64_t)at < n ? std::min<uint64_t>(total, n - at) : 0;
    if (got < stride * (rows - 1) + (b.w + 7) / 8) corrupt("ICO mask ends early");
  }
  return 1;
}

// -------------------------------------------------------------------- TGA

// TgaImagePlugin and Pillow's TgaRleDecode.c. Types 1/9 (a colour map),
// 2/10 (BGR, BGRA, BGRA;15Z at 16 bits) and 3/11 (grey, 1-bit, grey + alpha),
// raw or RLE; rows bottom-up unless flag 0x20, flipped left to right by
// flag 0x10. A colour map on a grey image gives PIL's core a palette that
// "L" ignores and "LA" applies; on a 1-bit or RGB image, and of 32-bit
// entries, PIL refuses it.
inline uint8_t five_bits(int v) { return (uint8_t)(v * 255 / 31); }

Gray decode_tga(const uint8_t* d, size_t n) {
  const int id_len = d[0], cmt = d[1], type = d[2], depth = d[16], flags = d[17];
  const uint32_t start = le16(d + 3), size = le16(d + 5), mdepth = d[7];
  const int64_t W = le16(d + 12), H = le16(d + 14);
  check_size(W, H);
  // the mode and the raw mode of MODES[(type & 7, depth)] (no tile: refused)
  char mode;  // 'L', '1', 'A' (LA), 'P', 'R' (RGB or RGBA)
  int rawbits;
  const int t = type & 7;
  if (type == 3 || type == 11) mode = depth == 1 ? '1' : depth == 16 ? 'A' : 'L';
  else if (type == 1 || type == 9) mode = cmt ? 'P' : 'L';
  else mode = 'R';
  if (t == 1 && depth == 8) rawbits = 8;        // "P"
  else if (t == 3 && depth == 1) rawbits = 1;   // "1"
  else if (t == 3 && depth == 8) rawbits = 8;   // "L"
  else if (t == 3 && depth == 16) rawbits = 16; // "LA"
  else if (t == 2 && (depth == 16 || depth == 24 || depth == 32)) rawbits = depth;
  else corrupt("TGA of a type and depth PIL has no raw mode for (PIL refuses it)");
  if (t == 1 && mode == 'L') corrupt("TGA colour-mapped without a map (PIL refuses it)");
  const size_t pal_at = std::min<size_t>(n, 18 + (size_t)id_len);
  const int mbytes = cmt ? (mdepth == 16 ? 2 : mdepth == 24 ? 3 : 4) : 0;
  const size_t pal_got = std::min<size_t>((size_t)mbytes * size, n - pal_at);
  const size_t offset = pal_at + pal_got;
  // The palette: `start` zero entries, then the file's.
  uint8_t pal[256] = {0};
  if (cmt) {
    if (mode == '1' || mode == 'R') corrupt("TGA colour map on a 1-bit or RGB image (PIL refuses it)");
    if (mbytes == 4) corrupt("TGA colour map of 32-bit entries (PIL has no raw mode BGRA for an RGB palette)");
    if (start + pal_got / mbytes > 256) corrupt("TGA colour map of more than 256 entries (PIL refuses it)");
    for (size_t i = 0; i < pal_got / mbytes; ++i) {
      const uint8_t* e = d + pal_at + i * mbytes;
      const int v = e[0] | e[1] << 8;
      pal[start + i] = mbytes == 2 ? luma(five_bits(v >> 10 & 31), five_bits(v >> 5 & 31), five_bits(v & 31))
                                   : luma(e[2], e[1], e[0]);
    }
  }
  const size_t row = ((size_t)W * rawbits + 7) / 8;
  std::vector<uint8_t> rows_data;  // every row as the file holds it, in file order
  const uint8_t* src;
  if (!(type & 8)) {
    if (offset > n || n - offset < row * H) corrupt("TGA pixel data ends early");
    src = d + offset;
  } else {
    // TgaRleDecode.c: runs stop at a row's end (past it: refused), literal
    // packets carry on into the next rows; a 1-bit file (depth / 8 == 0
    // bytes a pixel) never fills a row.
    const size_t pix = depth / 8;
    if (!pix) corrupt("TGA RLE of 1-bit pixels (PIL never fills a row)");
    rows_data.resize(row * H);
    size_t p = offset, x = 0, y = 0;
    uint8_t* out = rows_data.data();
    while (y < (size_t)H) {
      if (p >= n) corrupt("TGA RLE data ends early");
      const size_t k = pix * ((d[p] & 0x7F) + 1);
      if (d[p] & 0x80) {
        if (n - p < 1 + pix) corrupt("TGA RLE data ends early");
        if (x + k > row) corrupt("TGA RLE run past a row's end (PIL refuses it)");
        for (size_t i = 0; i < k; i += pix) memcpy(out + y * row + x + i, d + p + 1, pix);
        p += 1 + pix;
        x += k;
      } else {
        if (n - p < 1 + k) corrupt("TGA RLE data ends early");
        const uint8_t* s = d + p + 1;
        p += 1 + k;
        for (size_t left = k; left && y < (size_t)H;) {
          const size_t m = std::min(left, row - x);
          memcpy(out + y * row + x, s, m);
          s += m;
          left -= m;
          x += m;
          if (x == row) {
            x = 0;
            ++y;
          }
        }
        continue;
      }
      if (x == row) {
        x = 0;
        ++y;
      }
    }
    src = rows_data.data();
  }
  Gray g;
  g.w = (int)W;
  g.h = (int)H;
  g.px.resize((size_t)W * H);
  // A grey image with a map: PIL puts the palette on the image at load, so
  // convert("L") returns it as it is, mode P, whose indices are its grey.
  g.indices = cmt && mode == 'L';
  const bool flip_x = flags & 0x10;
  for (int64_t y = 0; y < H; ++y) {
    const uint8_t* r = src + row * (flags & 0x20 ? y : H - 1 - y);
    uint8_t* o = &g.px[(size_t)y * W];
    for (int64_t x = 0; x < W; ++x) {
      uint8_t v;
      switch (rawbits) {
        case 1: v = (r[x >> 3] >> (7 - (x & 7))) & 1 ? 255 : 0; break;
        case 8: v = mode == 'P' ? pal[r[x]] : r[x]; break;
        case 16:
          if (mode == 'A') {
            v = cmt ? pal[r[2 * x]] : r[2 * x];
          } else {
            const int u = r[2 * x] | r[2 * x + 1] << 8;
            v = luma(five_bits(u >> 10 & 31), five_bits(u >> 5 & 31), five_bits(u & 31));
          }
          break;
        default: {
          const uint8_t* q = r + (size_t)x * (rawbits / 8);
          v = luma(q[2], q[1], q[0]);
        }
      }
      o[flip_x ? W - 1 - x : x] = v;
    }
  }
  return g;
}

// ------------------------------------------------------------- PCX, DCX

// PcxImagePlugin and Pillow's PcxDecode.c on the page at `at` (0, or a DCX
// page's offset): 1-bit (one plane, or 2 / 4 planes of a 16-colour header
// palette), 8-bit grey or a palette (the 769 bytes at the file's end), 24-bit
// RGB in three planes a row. PIL's row length, not the header's: (w bits +
// 7) / 8, made even where the header gives another. A run past a row's end
// is refused.
Gray decode_pcx(const uint8_t* d, size_t n, size_t at) {
  const uint8_t* s = d + at;
  const int64_t W = (int64_t)le16(s + 8) + 1 - le16(s + 4), H = (int64_t)le16(s + 10) + 1 - le16(s + 6);
  const int version = s[1], bits = s[3], planes = s[65];
  check_size(W, H);
  char mode;  // '1', 'p' (1-bit planes), 'L', 'P', 'R'
  uint8_t pal[256];
  for (int i = 0; i < 256; ++i) pal[i] = (uint8_t)i;
  if (bits == 1 && planes == 1) {
    mode = '1';
  } else if (bits == 1 && (planes == 2 || planes == 4)) {
    mode = 'p';
    for (int i = 0; i < 16; ++i) pal[i] = luma(s[16 + 3 * i], s[17 + 3 * i], s[18 + 3 * i]);
  } else if (version == 5 && bits == 8 && planes == 1) {
    mode = 'L';
    if (n < 769) corrupt("PCX of 8 bits shorter than its palette (PIL cannot seek to it)");
    const uint8_t* t = d + n - 769;
    if (t[0] == 12) {
      bool ramp = true;
      for (int i = 0; i < 256 && ramp; ++i) ramp = t[1 + 3 * i] == i && t[2 + 3 * i] == i && t[3 + 3 * i] == i;
      if (!ramp) {
        mode = 'P';
        for (int i = 0; i < 256; ++i) pal[i] = luma(t[1 + 3 * i], t[2 + 3 * i], t[3 + 3 * i]);
      }
    }
  } else {
    mode = 'R';
  }
  uint64_t stride = ((uint64_t)W * bits + 7) / 8;
  if (le16(s + 66) != stride) stride += stride % 2;
  const uint64_t bytes = planes * stride;
  const int ubits = mode == '1' ? 1 : mode == 'p' ? planes : mode == 'R' ? 24 : 8;
  if (((uint64_t)W * ubits + 7) / 8 > bytes) corrupt("PCX row shorter than its pixels (PIL refuses it)");
  Gray g;
  g.w = (int)W;
  g.h = (int)H;
  g.px.resize((size_t)W * H);
  std::vector<uint8_t> buf(bytes);
  size_t p = at + 128;
  for (int64_t y = 0; y < H; ++y) {
    for (uint64_t x = 0; x < bytes;) {
      if (p >= n) corrupt("PCX data ends early");
      if ((d[p] & 0xC0) == 0xC0) {
        if (n - p < 2) corrupt("PCX data ends early");
        const int k = d[p] & 0x3F;
        if (x + k > bytes) corrupt("PCX run past a row's end (PIL refuses it)");
        memset(&buf[x], d[p + 1], k);
        x += k;
        p += 2;
      } else {
        buf[x++] = d[p++];
      }
    }
    // PcxDecode.c's band shift: 1-bit planes (2 or 4) of (w + 7) / 8 bytes
    // each, other rows in bands of w bytes; bands further apart than that
    // move together, band i from i * stride.
    {
      const bool planar = mode == 'p';
      const uint64_t xsize = planar ? (W + 7) / 8 : W, bands = planar ? planes : bytes / W;
      const uint64_t step = bands ? bytes / bands : 0;
      if (step > xsize)
        for (uint64_t i = 1; i < bands; ++i) memmove(&buf[i * xsize], &buf[i * step], xsize);
    }
    uint8_t* o = &g.px[(size_t)y * W];
    const size_t plane = (W + 7) / 8;  // unpackP2L / unpackP4L
    for (int64_t x = 0; x < W; ++x) {
      const int bit = 7 - (x & 7);
      switch (mode) {
        case '1': o[x] = (buf[x >> 3] >> bit) & 1 ? 255 : 0; break;
        case 'p': {
          int v = 0;
          for (int k = 0; k < planes; ++k) v |= ((buf[(x >> 3) + k * plane] >> bit) & 1) << k;
          o[x] = pal[v];
          break;
        }
        case 'R': o[x] = luma(buf[x], buf[x + W], buf[x + 2 * W]); break;
        default: o[x] = pal[buf[x]];
      }
    }
  }
  return g;
}

// DcxImagePlugin: the first page of the offset list, which runs to a 0 or
// 1024 entries; 0 where Image.open passes the file on (the list past the
// file's end, no page), else the page's offset.
uint32_t dcx_page(const uint8_t* d, size_t n) {
  for (size_t i = 0; i < 1024; ++i) {
    if (n < 8 + 4 * i) return 0;
    if (!le32(d + 4 + 4 * i)) break;
  }
  return n >= 8 ? le32(d + 4) : 0;
}

// -------------------------------------------------------------------- SGI

// SgiImagePlugin: 8 or 16 bits a channel (PIL keeps the high byte), grey,
// RGB or RGBA, rows bottom-up; raw planes one after another, or
// Pillow's SgiRleDecode.c: start and length tables of a row a channel,
// a row's packets counted by its length, a row that ends early keeping the
// previous row's values, and a row's last counted packet that is not its end
// stopping the whole decode with what was read.
Gray decode_sgi(const uint8_t* d, size_t n) {
  const int compression = d[2], bpc = d[3], zsize = be16(d + 10);
  const int64_t W = be16(d + 6), H = be16(d + 8);
  check_size(W, H);
  const int bands = zsize == 1 ? 1 : zsize;  // the mode's bands: L, RGB, RGBA
  Gray g;
  g.w = (int)W;
  g.h = (int)H;
  g.px.resize((size_t)W * H);
  auto put = [&](int64_t y, const uint8_t* px, size_t step, size_t band) {  // a row of samples
    uint8_t* o = &g.px[(size_t)(H - 1 - y) * W];
    for (int64_t x = 0; x < W; ++x) {
      const uint8_t* q = px + x * step;
      o[x] = bands == 1 ? q[0] : luma(q[0], q[band], q[2 * band]);
    }
  };
  if (compression == 0) {
    const uint64_t page = (uint64_t)W * H * bpc;
    if (n < 512 || n - 512 < page * bands) corrupt("SGI pixel data ends early");
    const uint8_t* base = d + 512;
    for (int64_t y = 0; y < H; ++y) put(y, base + (size_t)y * W * bpc, bpc, page);
    return g;
  }
  if (compression != 1) corrupt("SGI compression " + std::to_string(compression) + " (PIL has no tile)");
  const int64_t bufsize = (int64_t)n - 512;
  const int64_t tablen = (int64_t)bands * H;
  if (bufsize < 8 * tablen) corrupt("SGI RLE tables end early");
  const uint8_t* buf = d + 512;
  const int64_t end = bufsize - 1;  // the last byte, which a packet's data may not reach
  std::vector<uint8_t> row((size_t)W * bands * 2, 0);
  for (int64_t r = 0; r < H; ++r) {
    for (int c = 0; c < bands; ++c) {
      uint32_t off = be32(buf + 4 * (r + c * H));
      const uint32_t len = be32(buf + 4 * (tablen + r + c * H));
      if (off < 512) corrupt("SGI RLE row before the data");
      off -= 512;
      int64_t s = off, x = 0;
      uint8_t* dst = &row[(size_t)c * bpc];
      const size_t step = (size_t)bands * bpc;
      int status = 0;
      for (int64_t k = (int32_t)len; k > 0; --k) {  // a C int: a length past 2^31 reads nothing
        if (s + bpc - 1 > end) { status = -1; break; }
        const uint8_t pixel = buf[s + bpc - 1];
        s += bpc;
        if (k == 1 && pixel) { status = 1; break; }
        const int count = pixel & 0x7F;
        if (!count) break;
        if (x + count > W) { status = -1; break; }
        x += count;
        if (pixel & 0x80) {
          if (s + (int64_t)bpc * count > end) { status = -1; break; }
          for (int i = 0; i < count; ++i, s += bpc, dst += step) memcpy(dst, buf + s, bpc);
        } else {
          if (s + bpc - 1 + (bpc == 2) > end) { status = -1; break; }
          for (int i = 0; i < count; ++i, dst += step) memcpy(dst, buf + s, bpc);
          s += bpc;
        }
      }
      if (status < 0) corrupt("SGI RLE row overruns (PIL refuses it)");
      if (status > 0) return g;
    }
    put(r, row.data(), (size_t)bands * bpc, bpc);
  }
  return g;
}

// ---------------------------------------------------------------- SUN

// SunImagePlugin: 1-bit (inverted), 4 and 8-bit grey or a palette (planar
// RGB, up to 256 entries), 24 and 32-bit BGR(X), RGB(X) for type 3; raw rows
// padded to 16 bits, or Pillow's SunRleDecode.c over unpadded rows (0x80 0
// a literal 0x80, 0x80 n v n + 1 copies of v, carried into the next rows).
Gray decode_sun(const uint8_t* d, size_t n) {
  const int64_t W = be32(d + 4), H = be32(d + 8);
  const uint32_t depth = be32(d + 12), type = be32(d + 20), plen = be32(d + 28);
  check_size(W, H);
  uint8_t pal[256];
  for (int i = 0; i < 256; ++i) pal[i] = (uint8_t)i;
  const size_t pal_got = std::min<size_t>(plen, n - 32);
  if (plen) {
    if (depth != 4 && depth != 8) corrupt("SUN palette on a 1-bit or RGB image (PIL refuses it)");
    const size_t k = pal_got / 3;  // "RGB;L": the reds, the greens, the blues
    if (k > 256) corrupt("SUN palette of more than 256 entries (PIL refuses it)");
    std::fill(pal, pal + 256, 0);
    for (size_t i = 0; i < k; ++i) pal[i] = luma(d[32 + i], d[32 + k + i], d[32 + 2 * k + i]);
  }
  const uint64_t offset = 32 + (uint64_t)plen;
  const uint64_t row = ((uint64_t)W * depth + 7) / 8;
  std::vector<uint8_t> rle;
  const uint8_t* src;
  uint64_t stride;
  if (type == 2) {
    rle.resize(row * H);
    stride = row;
    uint64_t p = offset, x = 0, y = 0;
    while (y < (uint64_t)H) {
      if (p >= n) corrupt("SUN RLE data ends early");
      uint64_t k = 1;
      uint8_t v = d[p];
      if (d[p] == 0x80) {
        if (n - p < 2) corrupt("SUN RLE data ends early");
        if (d[p + 1]) {
          if (n - p < 3) corrupt("SUN RLE data ends early");
          k = d[p + 1] + 1;
          v = d[p + 2];
          p += 3;
        } else {
          p += 2;
        }
      } else {
        p += 1;
      }
      while (k && y < (uint64_t)H) {
        const uint64_t m = std::min(k, row - x);
        memset(&rle[y * row + x], v, m);
        k -= m;
        x += m;
        if (x == row) {
          x = 0;
          ++y;
        }
      }
    }
    src = rle.data();
  } else {
    stride = ((W * depth + 15) / 16) * 2;
    if (offset > n || n - offset < stride * (H - 1) + row) corrupt("SUN pixel data ends early");
    src = d + offset;
  }
  Gray g;
  g.w = (int)W;
  g.h = (int)H;
  g.px.resize((size_t)W * H);
  for (int64_t y = 0; y < H; ++y) {
    const uint8_t* r = src + stride * y;
    uint8_t* o = &g.px[(size_t)y * W];
    for (int64_t x = 0; x < W; ++x) {
      switch (depth) {
        case 1: o[x] = (r[x >> 3] >> (7 - (x & 7))) & 1 ? 0 : 255; break;
        case 4: {
          const int v = (r[x >> 1] >> (x & 1 ? 0 : 4)) & 15;
          o[x] = plen ? pal[v] : (uint8_t)(v * 17);
          break;
        }
        case 8: o[x] = pal[r[x]]; break;
        default: {
          const uint8_t* q = r + (size_t)x * (depth / 8);
          o[x] = type == 3 ? luma(q[0], q[1], q[2]) : luma(q[2], q[1], q[0]);
        }
      }
    }
  }
  return g;
}

// ---------------------------------------------------------------- MSP

// MspImagePlugin: version 1 ("DanM") raw 1-bit rows; version 2 ("LinS")
// MspDecoder: a row map of encoded lengths, rows of runs (0 n v) and
// literals, all written one after another and read as raw 1-bit rows, so
// a row of another length shifts every later one; a row of length 0 is
// white.
Gray decode_msp(const uint8_t* d, size_t n) {
  const int64_t W = le16(d + 4), H = le16(d + 6);
  check_size(W, H);
  const size_t row = (W + 7) / 8;
  std::vector<uint8_t> bits;
  const uint8_t* src;
  if (d[0] == 'D') {
    if (n - 32 < row * H) corrupt("MSP pixel data ends early");
    src = d + 32;
  } else {
    if (n - 32 < 2 * (uint64_t)H) corrupt("MSP row map ends early");
    size_t p = 32 + 2 * H;
    bits.reserve(row * H);
    for (int64_t y = 0; y < H; ++y) {
      const size_t len = le16(d + 32 + 2 * y);
      if (!len) {
        bits.insert(bits.end(), row, 0xFF);
        continue;
      }
      if (n - p < len) corrupt("MSP row ends early");
      const uint8_t* r = d + p;
      p += len;
      for (size_t i = 0; i < len;) {
        const int type = r[i++];
        if (!type) {
          if (len - i < 2) corrupt("MSP run ends early");
          bits.insert(bits.end(), r[i], r[i + 1]);
          i += 2;
        } else {
          const size_t k = std::min<size_t>(type, len - i);
          bits.insert(bits.end(), r + i, r + i + k);
          i += type;
        }
      }
      if (bits.size() > row * H) bits.resize(row * H);
    }
    if (bits.size() < row * H) corrupt("MSP rows hold too little data (PIL refuses it)");
    src = bits.data();
  }
  Gray g;
  g.w = (int)W;
  g.h = (int)H;
  g.px.resize((size_t)W * H);
  for (int64_t y = 0; y < H; ++y)
    for (int64_t x = 0; x < W; ++x)
      g.px[(size_t)y * W + x] = (src[y * row + (x >> 3)] >> (7 - (x & 7))) & 1 ? 255 : 0;
  return g;
}

// ---------------------------------------------------------------- QOI

// QoiImagePlugin's QoiDecoder: the index of 64 seen pixels, runs, diffs
// and luma ops, until the image is full; the data ending before is refused.
// 3 channels make it RGB, any other count RGBA.
Gray decode_qoi(const uint8_t* d, size_t n) {
  const int64_t W = be32(d + 4), H = be32(d + 8);
  check_size(W, H);
  Gray g;
  g.w = (int)W;
  g.h = (int)H;
  g.px.resize((size_t)W * H);
  uint8_t seen[64][4] = {};  // an index entry never set is (0, 0, 0, 0)
  uint8_t prev[4] = {0, 0, 0, 255};
  const size_t total = (size_t)W * H;
  size_t p = 14, i = 0;
  while (i < total) {
    if (p >= n) corrupt("QOI data ends early");
    const int op = d[p++];
    uint8_t v[4];
    if (op == 0xFE || op == 0xFF) {
      const size_t k = op == 0xFE ? 3 : 4;
      if (n - p < k) corrupt("QOI data ends early");
      memcpy(v, d + p, k);
      if (k == 3) v[3] = prev[3];
      p += k;
    } else if (op >> 6 == 0) {
      memcpy(v, seen[op], 4);
    } else if (op >> 6 == 1) {
      v[0] = (uint8_t)(prev[0] + ((op >> 4) & 3) - 2);
      v[1] = (uint8_t)(prev[1] + ((op >> 2) & 3) - 2);
      v[2] = (uint8_t)(prev[2] + (op & 3) - 2);
      v[3] = prev[3];
    } else if (op >> 6 == 2) {
      if (p >= n) corrupt("QOI data ends early");
      const int second = d[p++], dg = (op & 63) - 32;
      v[0] = (uint8_t)(prev[0] + dg + (second >> 4) - 8);
      v[1] = (uint8_t)(prev[1] + dg);
      v[2] = (uint8_t)(prev[2] + dg + (second & 15) - 8);
      v[3] = prev[3];
    } else {  // a run of the previous pixel, which the index already holds
      const uint8_t grey = luma(prev[0], prev[1], prev[2]);
      for (int k = (op & 63) + 1; k && i < total; --k) g.px[i++] = grey;
      continue;
    }
    memcpy(prev, v, 4);
    const int h = (v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64;
    memcpy(seen[h], v, 4);
    g.px[i++] = luma(v[0], v[1], v[2]);
  }
  return g;
}

// The line from `p` through its '\n' (or the file's end), as Python's
// readline gives it; `p` moves past it.
std::string read_line(const uint8_t* d, size_t n, size_t& p) {
  const size_t a = p;
  const void* e = p < n ? memchr(d + p, '\n', n - p) : nullptr;
  p = e ? (size_t)((const uint8_t*)e - d) + 1 : n;
  return std::string((const char*)d + a, p - a);
}

// XpmImagePlugin's _open up to its "W H C P" line: the lines from byte 9 on
// until one opens with '"' and four runs of digits, a space after each of
// the first three. False where no line does (PIL passes the file on);
// throws where such a run is empty (int() refuses it). `v` the numbers,
// `p` past that line.
bool xpm_open(const uint8_t* d, size_t n, int64_t v[4], size_t& p) {
  for (p = 9; p < n;) {
    const std::string s = read_line(d, n, p);
    size_t k = 1;
    bool head = s[0] == '"';
    for (int f = 0; f < 4 && head; ++f) {
      const size_t a = k;
      for (v[f] = 0; k < s.size() && pnm_digit(s[k]); ++k) v[f] = std::min(kPyIntCap, v[f] * 10 + (s[k] - '0'));
      if (k == a) corrupt("XPM header of an empty number (PIL refuses it)");
      if (f < 3) head = k < s.size() && s[k++] == ' ';
    }
    if (head) return true;
  }
  return false;
}

// ---------------------------------------------------- XV thumbnail (A.6.46)

// XVThumbImagePlugin: "P7 332", the rest of that line, lines opening with
// '#', then a line whose first two fields are the size (int()); then the
// rows, mode P bytes through the fixed 3-3-2 palette ((r * 255) // 7, the
// same of g, (b * 255) // 3), the data whole or refused.
Gray decode_xvthumb(const uint8_t* d, size_t n) {
  size_t p = 6;
  read_line(d, n, p);
  std::string s;
  do {
    if (p >= n) corrupt("XV thumbnail header ends early (PIL refuses the file)");
    s = read_line(d, n, p);
  } while (s[0] == '#');
  std::vector<std::string> f;
  for (size_t i = 0; i < s.size() && f.size() < 2;) {
    while (i < s.size() && pnm_space((unsigned char)s[i])) ++i;
    size_t j = i;
    while (j < s.size() && !pnm_space((unsigned char)s[j])) ++j;
    if (j > i) f.push_back(s.substr(i, j - i));
    i = j;
  }
  int64_t W, H;
  if (f.size() < 2 || !py_int(f[0], W) || !py_int(f[1], H))
    corrupt("XV thumbnail size not two numbers (PIL refuses the file)");
  check_size(W, H);
  if ((uint64_t)(n - p) < (uint64_t)W * H) corrupt("XV thumbnail pixels end early (PIL refuses the file)");
  uint8_t grey[256];
  for (int v = 0; v < 256; ++v) grey[v] = luma((v >> 5) * 255 / 7, (v >> 2 & 7) * 255 / 7, (v & 3) * 255 / 3);
  Gray g;
  g.w = (int)W;
  g.h = (int)H;
  g.px.resize((size_t)W * H);
  for (size_t i = 0; i < g.px.size(); ++i) g.px[i] = grey[d[p + i]];
  return g;
}

// ------------------------------------------------------------- XBM (A.6.44)

inline int hex_digit(int c) {  // XbmDecode.c's HEX: 0 for a character not a hex digit
  return c >= '0' && c <= '9' ? c - '0' : c >= 'a' && c <= 'f' ? c - 'a' + 10 : c >= 'A' && c <= 'F' ? c - 'A' + 10 : 0;
}

// XbmDecode.c from xbm_open's data start: each byte is the two characters
// after the next 'x' (a token cut short, "0x5,", reads 0x50), its bits
// the row's pixels least significant first, a set bit white (PIL's mode 1
// from raw 1;R); an 'x' without two characters after it, or too few, is
// refused ("image file is truncated").
Gray decode_xbm(const uint8_t* d, size_t n) {
  int64_t W = 0, H = 0;
  size_t p = 0;
  xbm_open(d, n, W, H, p);
  check_size(W, H);
  const size_t stride = ((size_t)W + 7) / 8;
  if ((n - p) / 3 < stride * H) corrupt("XBM data ends early (PIL refuses the file)");
  Gray g;
  g.w = (int)W;
  g.h = (int)H;
  g.px.resize((size_t)W * H);
  std::vector<uint8_t> row(stride);
  for (int64_t y = 0; y < H; ++y) {
    for (size_t i = 0; i < stride; ++i) {
      const void* x = p < n ? memchr(d + p, 'x', n - p) : nullptr;
      if (!x || n - (size_t)((const uint8_t*)x - d) < 3) corrupt("XBM data ends early (PIL refuses the file)");
      p = (size_t)((const uint8_t*)x - d);
      row[i] = (uint8_t)(hex_digit(d[p + 1]) << 4 | hex_digit(d[p + 2]));
      p += 3;
    }
    uint8_t* o = &g.px[(size_t)y * W];
    for (int64_t x = 0; x < W; ++x) o[x] = row[x >> 3] >> (x & 7) & 1 ? 255 : 0;
  }
  return g;
}

// ------------------------------------------------------------- XPM (A.6.45)

// Python's int(t, 16) of a bytes token: a sign, an optional 0x, hex digits
// with single underscores between them (and one after the 0x); false where
// Python raises. `low` is the value's low 24 bits, two's complement.
bool py_hex24(const std::string& t, uint32_t& low) {
  size_t i = 0;
  const bool neg = !t.empty() && t[0] == '-';
  if (!t.empty() && (t[0] == '+' || t[0] == '-')) ++i;
  const bool prefix = t.size() >= i + 2 && t[i] == '0' && (t[i + 1] == 'x' || t[i + 1] == 'X');
  if (prefix) i += 2;
  auto hexc = [](char c) { return isxdigit((unsigned char)c) != 0; };
  uint32_t x = 0;
  int digits = 0;
  for (; i < t.size(); ++i) {
    if (t[i] == '_' && ((digits && hexc(t[i - 1])) || (prefix && !digits && t[i - 1] != '_')) &&
        i + 1 < t.size() && hexc(t[i + 1]))
      continue;
    if (!hexc(t[i])) return false;
    x = (x << 4 | (uint32_t)hex_digit(t[i])) & 0xFFFFFF;
    ++digits;
  }
  if (!digits) return false;
  low = neg ? (0x1000000 - x) & 0xFFFFFF : x;
  return true;
}

// XpmImagePlugin: after the "W H C P" line, C palette lines, each
// rstripped, its key line[1:P+1] and the pairs of line[P+1:-2].split():
// the first "c" pair's colour "#hex" (int(, 16)'s low 24 bits) or "None"
// (the key left out); another colour, or no "c", is refused. A key given
// twice keeps its first place with its last colour. More than 256 lines
// make the image RGB, else P of the palette in the keys' order: either way
// a pixel's grey is its key's colour's. Then XpmDecoder: lines until the
// pixels are enough (one "/* pixels */" line skipped), each the bytes
// between its first and last '"', P bytes a key; a key not in the palette,
// P 0, or too few pixels are refused; more are cut.
Gray decode_xpm(const uint8_t* d, size_t n) {
  size_t p;
  int64_t v[4];
  if (!xpm_open(d, n, v, p)) corrupt("XPM header not found (PIL refuses the file)");
  const int64_t W = v[0], H = v[1], colours = v[2], bpp = v[3];
  std::vector<std::string> keys;
  std::vector<uint8_t> greys;
  std::unordered_map<std::string, size_t> at;
  for (int64_t i = 0; i < colours; ++i) {
    std::string s = read_line(d, n, p);
    while (!s.empty() && pnm_space((unsigned char)s.back())) s.pop_back();
    const size_t len = s.size(), a = std::min<size_t>((size_t)std::min<int64_t>(bpp, kPyIntCap) + 1, len);
    const std::string key = s.substr(std::min<size_t>(1, len), a - std::min<size_t>(1, len));
    std::vector<std::string> words;
    for (size_t q = a, e = len >= 2 ? len - 2 : 0; q < e;) {
      while (q < e && pnm_space((unsigned char)s[q])) ++q;
      size_t r = q;
      while (r < e && !pnm_space((unsigned char)s[r])) ++r;
      if (r > q) words.push_back(s.substr(q, r - q));
      q = r;
    }
    bool found = false;
    for (size_t w = 0; w < words.size() && !found; w += 2) {
      if (words[w] != "c") continue;
      found = true;
      if (w + 1 >= words.size()) corrupt("XPM colour key without a colour (PIL refuses the file)");
      const std::string& rgb = words[w + 1];
      if (rgb == "None") break;
      uint32_t x;
      if (rgb[0] != '#' || !py_hex24(rgb.substr(1), x)) corrupt("XPM colour PIL cannot read");
      const uint8_t grey = luma(x >> 16 & 255, x >> 8 & 255, x & 255);
      const auto it = at.find(key);
      if (it != at.end()) {
        greys[it->second] = grey;
      } else {
        at.emplace(key, keys.size());
        keys.push_back(key);
        greys.push_back(grey);
      }
    }
    if (!found) corrupt("XPM palette line without a colour key (PIL refuses the file)");
  }
  check_size(W, H);
  if (bpp == 0) corrupt("XPM of 0 characters a pixel (PIL refuses the file)");
  Gray g;
  g.w = (int)W;
  g.h = (int)H;
  const size_t want = (size_t)W * H;
  g.px.reserve(std::min<size_t>(want, n));
  // Keys of 1 and 2 characters by table: the grey, -1 for none.
  std::vector<int16_t> one(256, -1), two(bpp == 2 ? 65536 : 0, -1);
  for (size_t k = 0; k < keys.size(); ++k) {
    if (keys[k].size() == 1) one[(uint8_t)keys[k][0]] = greys[k];
    if (keys[k].size() == 2 && bpp == 2) two[(uint8_t)keys[k][0] << 8 | (uint8_t)keys[k][1]] = greys[k];
  }
  bool pixels_line = false;
  std::string key;
  while (g.px.size() < want && p < n) {
    const std::string s = read_line(d, n, p);
    std::string t = s;
    while (!t.empty() && pnm_space((unsigned char)t.back())) t.pop_back();
    if (t == "/* pixels */" && !pixels_line) {
      pixels_line = true;
      continue;
    }
    const size_t f = s.find('"'), l = s.rfind('"');
    if (f == std::string::npos || f == l) continue;
    const char* c = s.data() + f + 1;
    const size_t len = l - f - 1;
    for (size_t i = 0; i < len; i += (size_t)bpp) {
      const size_t k = std::min<size_t>((size_t)bpp, len - i);
      int grey = -1;
      if (k == 1) {
        grey = one[(uint8_t)c[i]];
      } else if (k == 2 && bpp == 2) {
        grey = two[(uint8_t)c[i] << 8 | (uint8_t)c[i + 1]];
      } else {
        key.assign(c + i, k);
        const auto it = at.find(key);
        if (it != at.end()) grey = greys[it->second];
      }
      if (grey < 0) corrupt("XPM pixel of a key not in its palette (PIL refuses the file)");
      g.px.push_back((uint8_t)grey);
    }
  }
  if (g.px.size() < want) corrupt("XPM pixels end early (PIL refuses the file)");
  g.px.resize(want);
  return g;
}

// -------------------------------------------------------------- IM (A.6.43)

// Pillow's BitDecode.c as the IM plugin calls it (pad 8, fill 3, unsigned,
// bottom row first): N-bit samples packed from each byte's low bits up,
// each row from a fresh byte (the bits left in the buffer kept, ORed under
// the next byte), a buffer past 32 bits refilled from the last byte; a
// sample's value in float32, clipped to 255 by convert("L"). False where
// the data ends before the image is full.
bool bit_decode(const uint8_t* s, size_t n, int bits, int64_t W, int64_t H, uint8_t* out) {
  const uint64_t mask = (uint64_t)(uint32_t)((1 << bits) - 1);
  uint64_t buf = 0;
  int cnt = 0;
  int64_t x = 0, y = H - 1;
  for (size_t i = 0; i < n; ++i) {
    const uint8_t byte = s[i];
    buf |= (uint64_t)byte << cnt;
    cnt += 8;
    while (cnt >= bits) {
      const uint64_t v = buf & mask;
      if (cnt > 32) buf = byte >> (8 - (cnt - bits));
      else buf >>= bits;
      cnt -= bits;
      out[y * W + x] = (uint8_t)std::min<uint64_t>(v, 255);
      if (++x >= W) {
        if (--y < 0) return true;
        x = 0;
        cnt = 0;
      }
    }
  }
  return false;
}

// The first frame of an IM file (im_open), its rows bottom-up, of PIL's
// raw mode for its mode (a pair PIL's unpackers lack is refused), three
// planes G, R, B for RGB;T and RYB;T, the bit decoder for F;N; the data
// whole or refused. convert("L"): 1 to 0 / 255, P and PA through the Lut's
// colours (black without them), LA its L, RGB luma, CMYK cmyk_luma, YCbCr
// its Y, I and F clipped to 0 .. 255 (F truncated, NaN 0).
Gray decode_im(const uint8_t* d, size_t n) {
  ImHead m;
  im_open(d, n, m);
  check_size(m.w, m.h);
  const int64_t W = m.w, H = m.h;
  const uint8_t* s = d + m.data;
  const size_t left = n - m.data;
  const std::string &mo = m.mode, &raw = m.rawmode;
  enum Kind { kBits, kPlanes, kBit1, kGrey, kIndex, kIndex2, kIndex4, kPA, kRgb, kRgbL, kCmykL,
              kU16le, kU16be, kI32, kF8s, kF16s, kF32, kF32f };
  static const struct { const char* mode; const char* raw; Kind kind; int row8; } kRaw[] = {
      // row8: the row's bytes per 8 pixels
      {"1", "1", kBit1, 1}, {"L", "L", kGrey, 8}, {"P", "L", kIndex, 8}, {"P", "P", kIndex, 8},
      {"P", "P;2", kIndex2, 2}, {"P", "P;4", kIndex4, 4}, {"PA", "PA;L", kIndex, 16}, {"LA", "LA;L", kGrey, 16},
      {"RGB", "RGB", kRgb, 24}, {"RGBX", "RGB", kRgb, 24}, {"RGB", "RGB;L", kRgbL, 24},
      {"RGBX", "RGB;L", kRgbL, 24}, {"RGB", "RGBA;L", kRgbL, 32}, {"RGB", "RGBX;L", kRgbL, 32},
      {"RGBA", "RGBA;L", kRgbL, 32}, {"RGBX", "RGBX;L", kRgbL, 32}, {"CMYK", "CMYK;L", kCmykL, 32},
      {"YCbCr", "YCbCr;L", kGrey, 24}, {"I", "I;16", kU16le, 16}, {"I;16", "I;16", kU16le, 16},
      {"I;16L", "I;16L", kU16le, 16}, {"I", "I;16B", kU16be, 16}, {"I;16", "I;16B", kU16be, 16},
      {"I;16B", "I;16B", kU16be, 16}, {"I", "I;32", kI32, 32}, {"I", "I;32S", kI32, 32},
      {"F", "F;8", kGrey, 8}, {"F", "F;8S", kF8s, 8}, {"F", "F;16", kU16le, 16}, {"F", "F;16S", kF16s, 16},
      {"F", "F;32", kF32, 32}, {"F", "F;32F", kF32f, 32}};
  int kind = -1, bits = 0;
  size_t stride = 0;  // a row's bytes; kPlanes: a plane's
  if (raw.compare(0, 2, "F;") == 0 && raw.size() > 2 && raw.find_first_not_of("0123456789", 2) == std::string::npos &&
      raw != "F;8" && raw != "F;16" && raw != "F;32") {
    if (mo != "F") corrupt("IM of " + raw + " in mode " + mo + " (PIL's bit decoder takes F alone)");
    kind = kBits;
    bits = std::stoi(raw.substr(2));
    stride = ((size_t)W * bits + 7) / 8;
  } else if (raw == "RGB;T" || raw == "RYB;T") {  // planes G, R, B
    if (mo != "RGB" && mo != "RGBA" && mo != "RGBX") corrupt("IM planes of mode " + mo + " (PIL refuses them)");
    kind = kPlanes;
    stride = (size_t)W * 3;
  } else {
    for (const auto& r : kRaw)
      if (mo == r.mode && raw == r.raw) {
        kind = r.kind;
        stride = ((size_t)W * r.row8 + 7) / 8;
      }
    if (kind < 0) corrupt("IM of mode " + mo + " in raw mode " + raw + " (PIL has no such unpacker)");
  }
  if (left / stride < (size_t)H) corrupt("IM pixels end early (PIL refuses the file)");
  Gray g;
  g.w = (int)W;
  g.h = (int)H;
  g.px.resize((size_t)W * H);
  if (kind == kBits) {
    if (!bit_decode(s, left, bits, W, H, g.px.data())) corrupt("IM pixels end early (PIL refuses the file)");
    return g;
  }
  uint8_t pal[256] = {0};
  if (m.palette)
    for (int i = 0; i < 256; ++i) pal[i] = luma(m.pal[i], m.pal[256 + i], m.pal[512 + i]);
  const size_t plane = (size_t)W * H;
  for (int64_t y = 0; y < H; ++y) {
    const uint8_t* r = s + (size_t)(H - 1 - y) * (kind == kPlanes ? W : stride);
    uint8_t* o = &g.px[(size_t)y * W];
    if (kind == kGrey) {
      memcpy(o, r, W);
      continue;
    }
    for (int64_t x = 0; x < W; ++x) {
      int v = 0;
      switch (kind) {
        case kPlanes: v = luma(r[plane + x], r[x], r[2 * plane + x]); break;
        case kBit1: v = r[x >> 3] >> (7 - (x & 7)) & 1 ? 255 : 0; break;
        case kGrey: v = r[x]; break;
        case kIndex: v = pal[r[x]]; break;
        case kIndex2: v = pal[r[x >> 2] >> (6 - 2 * (x & 3)) & 3]; break;
        case kIndex4: v = pal[r[x >> 1] >> (x & 1 ? 0 : 4) & 15]; break;
        case kRgb: v = luma(r[3 * x], r[3 * x + 1], r[3 * x + 2]); break;
        case kRgbL: v = luma(r[x], r[W + x], r[2 * W + x]); break;
        case kCmykL: v = cmyk_luma(r[x], r[W + x], r[2 * W + x], r[3 * W + x]); break;
        case kU16le: v = std::min(255, r[2 * x] | r[2 * x + 1] << 8); break;
        case kU16be: v = std::min(255, r[2 * x] << 8 | r[2 * x + 1]); break;
        case kF8s: v = std::max(0, (int)(int8_t)r[x]); break;
        case kF16s: v = std::max(0, std::min(255, (int)(int16_t)(r[2 * x] | r[2 * x + 1] << 8))); break;
        case kI32: v = std::max(0, std::min(255, (int)(int32_t)le32(r + 4 * x))); break;
        case kF32: v = (int)std::min<uint32_t>(le32(r + 4 * x), 255); break;
        case kF32f: {
          const uint32_t u = le32(r + 4 * x);
          float f;
          memcpy(&f, &u, 4);
          v = float_grey(f);
          break;
        }
      }
      o[x] = (uint8_t)v;
    }
  }
  return g;
}

// ------------------------------------------------------------- PSD (A.6.47)

// Pillow's PackDecode.c from `at`: a run (257 - c copies) or a literal (c +
// 1 bytes) written into the row, cut at its end, 0x80 skipped, until `rows`
// rows of `rowb` bytes are full; false where the data ends first.
bool pil_packbits(const uint8_t* d, size_t n, size_t at, size_t rowb, size_t rows, uint8_t* out) {
  size_t p = at, x = 0, y = 0;
  for (;;) {
    if (p >= n) return false;
    const int c = d[p];
    if (c == 0x80) {
      ++p;
      continue;
    }
    uint8_t* o = out + y * rowb + x;
    if (c & 0x80) {
      if (n - p < 2) return false;
      const size_t k = std::min<size_t>(257 - c, rowb - x);
      memset(o, d[p + 1], k);
      x += k;
      p += 2;
    } else {
      if (n - p < (size_t)c + 2) return false;
      const size_t k = std::min<size_t>(c + 1, rowb - x);
      memcpy(o, d + p + 1, k);
      x += k;
      p += c + 2;
    }
    if (x >= rowb) {
      x = 0;
      if (++y >= rows) return true;
    }
  }
}

// PsdImagePlugin: the header's mode and depth (MODES: 1 or 8 bits; the
// mode's channels, RGB of exactly 4 read as RGBA), the colour mode data
// (a palette where P's is exactly 768 bytes, RGB;L), the image resources
// and the layer section skipped by their sizes, then the composite image:
// compression 0 (raw planes, each W * H bytes apart, even at 1 bit) or 1
// (a table of row byte counts, then each channel's PackBits stream from
// where the counts place it, read until its rows are full, whatever the
// counts say); any other makes no tile, which PIL refuses. A header read
// past the end passes the file on (refused); LAB opens and convert("L")
// refuses it. CMYK's planes are inverted; P without a palette reads black.
Gray decode_psd(const uint8_t* d, size_t n) {
  const int bits = (int)be16(d + 22), pmode = (int)be16(d + 24);
  const int64_t W = be32(d + 18), H = be32(d + 14);
  if (pmode == 9) corrupt("PSD in LAB, which PIL's convert(\"L\") refuses");
  const int channels = pmode == 3 ? (be16(d + 12) == 4 ? 4 : 3) : pmode == 4 ? 4 : 1;
  check_size(W, H);
  size_t p = 26;
  auto need = [&](size_t k) {
    if (p >= n || n - p < k) corrupt("PSD header ends early (PIL refuses the file)");
  };
  auto skip = [&](uint64_t k) { p = (size_t)std::min<uint64_t>(std::max(p, n), p + k); };
  need(4);
  const uint32_t mode_data = be32(d + p);
  p += 4;
  const uint8_t* palette = pmode == 2 && mode_data == 768 && n - p >= 768 ? d + p : nullptr;
  skip(mode_data);
  need(4);
  const uint64_t res_end = p + 4 + (uint64_t)be32(d + p);
  p += 4;
  while (p < res_end) {  // signature, id, a Pascal name padded to even, data padded to even
    skip(4);
    need(3);
    const size_t name = std::min<size_t>(d[p + 2], n - p - 3);
    p += 3 + name;
    if (!(name & 1)) skip(1);
    need(4);
    const uint32_t len = be32(d + p);
    p += 4;
    const size_t data = std::min<size_t>(len, n - p);
    p += data;
    if (data & 1) skip(1);
  }
  need(4);
  const uint32_t layers = be32(d + p);
  p += 4;
  if (layers) {
    const uint64_t end = p + (uint64_t)layers;
    need(4);
    p = (size_t)std::min<uint64_t>(end, SIZE_MAX);
  }
  need(2);
  const int compression = (int)be16(d + p);
  p += 2;
  const size_t rowb = bits == 1 ? ((size_t)W + 7) / 8 : (size_t)W, plane = rowb * H;
  // Too little data for the planes (a PackBits op of 2 bytes gives at most
  // 128 bytes of a row) is refused before they are allocated.
  const uint64_t least = compression ? (uint64_t)H * (2 * channels + 2 * ((rowb + 127) / 128)) : plane;
  if (p >= n || n - p < least) corrupt("PSD pixels end early (PIL refuses the file)");
  std::vector<uint8_t> planes((size_t)channels * plane);
  if (compression == 0) {
    for (int c = 0; c < channels; ++c) {
      const uint64_t at = p + (uint64_t)c * W * H;
      if (at > n || n - at < plane) corrupt("PSD pixels end early (PIL refuses the file)");
      memcpy(&planes[c * plane], d + at, plane);
    }
  } else if (compression == 1) {
    need((size_t)2 * channels * H);
    uint64_t at = p + (uint64_t)2 * channels * H;
    for (int c = 0; c < channels; ++c) {
      if (at > n || !pil_packbits(d, n, (size_t)at, rowb, H, &planes[c * plane]))
        corrupt("PSD PackBits data ends early (PIL refuses the file)");
      for (int64_t y = 0; y < H; ++y) at += be16(d + p + 2 * (c * H + y));
    }
  } else {
    corrupt("PSD of compression " + std::to_string(compression) + ", of which PIL makes no tile");
  }
  Gray g;
  g.w = (int)W;
  g.h = (int)H;
  if (bits == 8 && pmode != 2 && pmode != 3 && pmode != 4) {  // L: the first channel
    planes.resize(plane);
    g.px = std::move(planes);
    return g;
  }
  g.px.resize((size_t)W * H);
  const uint8_t* a = planes.data();
  for (int64_t y = 0; y < H; ++y)
    for (int64_t x = 0; x < W; ++x) {
      const size_t i = (size_t)y * rowb + x;
      uint8_t& o = g.px[(size_t)y * W + x];
      if (bits == 1) o = a[(size_t)y * rowb + (x >> 3)] >> (7 - (x & 7)) & 1 ? 255 : 0;
      else if (pmode == 2) o = palette ? luma(palette[a[i]], palette[256 + a[i]], palette[512 + a[i]]) : 0;
      else if (pmode == 3) o = luma(a[i], a[plane + i], a[2 * plane + i]);
      else if (pmode == 4)
        o = cmyk_luma(255 - a[i], 255 - a[plane + i], 255 - a[2 * plane + i], 255 - a[3 * plane + i]);
      else o = a[i];
    }
  return g;
}

// ------------------------------------ DDS, FTEX: Pillow's bcn (A.6.49-A.6.53)

// Pillow's BcnDecode.c: 4 x 4 blocks in raster order, each written into the
// image where it lies inside it (a partial block at the right and bottom
// edges cut), until the image is full; data that ends first is refused
// ("image file is truncated"). BC1-BC3 colour: the 565 endpoints widened
// by their high bits, 2/3 and 1/3 of the way between them (C's truncating
// division), or BC1's 3-colour mode with transparent black where c0 <= c1
// (BC2 and BC3 never take it); BC2's 4-bit alpha times 17; BC3/BC4/BC5's
// 8-value ramps (6 values, 0 and 255 where a0 <= a1), BC5S's signed
// endpoints plus 128; BC5's blue 0 (128 for BC5S).
struct Rgba {
  uint8_t r, g, b, a;
};

inline Rgba bcn_565(uint32_t x) {
  int r = (x & 0xF800) >> 8, g = (x & 0x7E0) >> 3, b = (x & 0x1F) << 3;
  return {(uint8_t)(r | r >> 5), (uint8_t)(g | g >> 6), (uint8_t)(b | b >> 5), 255};
}

void bc1_colour(Rgba* col, const uint8_t* s, bool separate_alpha) {
  const uint32_t c0 = le16(s), c1 = le16(s + 2), lut = le32(s + 4);
  Rgba p[4] = {bcn_565(c0), bcn_565(c1)};
  const int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b, r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
  if (c0 > c1 || separate_alpha) {
    p[2] = {(uint8_t)((2 * r0 + r1) / 3), (uint8_t)((2 * g0 + g1) / 3), (uint8_t)((2 * b0 + b1) / 3), 255};
    p[3] = {(uint8_t)((r0 + 2 * r1) / 3), (uint8_t)((g0 + 2 * g1) / 3), (uint8_t)((b0 + 2 * b1) / 3), 255};
  } else {
    p[2] = {(uint8_t)((r0 + r1) / 2), (uint8_t)((g0 + g1) / 2), (uint8_t)((b0 + b1) / 2), 255};
    p[3] = {0, 0, 0, 0};
  }
  for (int i = 0; i < 16; ++i) col[i] = p[3 & lut >> 2 * i];
}

// A BC3 alpha block into byte `o` of each of 16 `stride`-byte pixels.
void bc3_alpha(uint8_t* dst, int stride, int o, const uint8_t* s, bool sign) {
  const int a0 = sign ? (int8_t)s[0] + 128 : s[0], a1 = sign ? (int8_t)s[1] + 128 : s[1];
  uint8_t a[8] = {(uint8_t)a0, (uint8_t)a1};
  if (a0 > a1) {
    for (int k = 2; k < 8; ++k) a[k] = (uint8_t)(((8 - k) * a0 + (k - 1) * a1) / 7);
  } else {
    for (int k = 2; k < 6; ++k) a[k] = (uint8_t)(((6 - k) * a0 + (k - 1) * a1) / 5);
    a[6] = 0;
    a[7] = 255;
  }
  const uint32_t lut1 = s[2] | s[3] << 8 | s[4] << 16, lut2 = s[5] | s[6] << 8 | s[7] << 16;
  for (int i = 0; i < 8; ++i) {
    dst[stride * i + o] = a[7 & lut1 >> 3 * i];
    dst[stride * (8 + i) + o] = a[7 & lut2 >> 3 * i];
  }
}

inline int bcn_bit(const uint8_t* s, int bit) { return s[bit >> 3] >> (bit & 7) & 1; }

// BcnDecode.c's get_bits: up to 8 bits from `bit` on, least significant first.
inline int bcn_bits(const uint8_t* s, int bit, int count) {
  if (!count) return 0;
  const int by = bit >> 3;
  bit &= 7;
  const int x = bit + count <= 8 ? s[by] : s[by] | s[by + 1] << 8;
  return x >> bit & ((1 << count) - 1);
}

// BC7's tables (the format's): the partitions of 2 subsets (a bit a pixel)
// and 3 (two bits), the anchors of subset 1 of 2, of subsets 1 and 2 of 3,
// the interpolation weights of 2-, 3- and 4-bit indices.
const uint16_t kBc7Part2[64] = {
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80, 0xc800, 0xffec, 0xfe80, 0xe800, 0xffe8,
    0xff00, 0xfff0, 0xf000, 0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310, 0x3100, 0x8cce, 0x088c, 0x3110,
    0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c, 0xaaaa, 0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696,
    0xa55a, 0x73ce, 0x13c8, 0x324c, 0x3bdc, 0x6996, 0xc33c, 0x9966, 0x0660, 0x0272, 0x04e4, 0x4e40, 0x2720,
    0xc936, 0x936c, 0x39c6, 0x639c, 0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22};
const uint32_t kBc7Part3[64] = {
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050, 0x5555a0a0, 0x5a5a5050,
    0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090, 0x94949494, 0xa4a4a4a4, 0xa9a59450, 0x2a0a4250,
    0xa5945040, 0x0a425054, 0xa5a5a500, 0x55a0a0a0, 0xa8a85454, 0x6a6a4040, 0xa4a45000, 0x1a1a0500,
    0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400, 0xa08585a0, 0xaa821414, 0x50a4a450, 0x6a5a0200,
    0xa9a58000, 0x5090a0a8, 0xa8a09050, 0x24242424, 0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50,
    0x500aa550, 0xaaaa4444, 0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600,
    0xaa444444, 0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580, 0xaa141414, 0x96960000,
    0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000, 0x40804080, 0xa9a8a9a8, 0xaaaaaa44, 0x2a4a5254};
const uint8_t kBc7Anchor2[64] = {15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
                                 15, 2,  8,  2,  2,  8,  8,  15, 2,  8,  2,  2,  8,  8,  2,  2,
                                 15, 15, 6,  8,  2,  8,  15, 15, 2,  8,  2,  2,  2,  15, 15, 6,
                                 6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2,  15};
const uint8_t kBc7Anchor3a[64] = {3,  3,  15, 15, 8,  3,  15, 15, 8,  8,  6,  6,  6,  5,  3,  3,
                                  3,  3,  8,  15, 3,  3,  6,  10, 5,  8,  8,  6,  8,  5,  15, 15,
                                  8,  15, 3,  5,  6,  10, 8,  15, 15, 3,  15, 5,  15, 15, 15, 15,
                                  3,  15, 5,  5,  5,  8,  5,  10, 5,  10, 8,  13, 15, 12, 3,  3};
const uint8_t kBc7Anchor3b[64] = {15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,
                                  15, 8,  15, 3,  15, 8,  15, 8,  3,  15, 6,  10, 15, 15, 10, 8,
                                  15, 3,  15, 10, 10, 8,  9,  10, 6,  15, 8,  15, 3,  6,  6,  8,
                                  15, 3,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3,  15, 15, 8};
const uint8_t kBc7Weights[3][16] = {{0, 21, 43, 64},
                                    {0, 9, 18, 27, 37, 46, 55, 64},
                                    {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64}};
inline const uint8_t* bc7_weights(int bits) { return kBc7Weights[bits == 2 ? 0 : bits == 3 ? 1 : 2]; }

inline int bc7_subset(int ns, int partition, int i) {
  return ns == 2 ? kBc7Part2[partition] >> i & 1 : ns == 3 ? kBc7Part3[partition] >> 2 * i & 3 : 0;
}

// BC7 (BcnDecode.c's decode_bc7_block): the mode is the count of zero bits
// below the first set bit, a first byte of 0 an opaque black block; the
// endpoints channel by channel, p-bits per endpoint or per subset, each
// value widened by its high bits, indices with one bit less at each
// subset's anchor, the index-selection bit swapping colour and alpha
// indices, the rotation swapping alpha with a colour channel.
void bc7_block(Rgba* col, const uint8_t* s) {
  // subsets, partition bits, rotation bits, index-selection bits, colour
  // bits, alpha bits, p-bits per endpoint, per subset, index bits, second
  // index bits
  static const uint8_t kModes[8][10] = {{3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
                                        {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
                                        {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
                                        {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};
  if (!s[0]) {
    for (int i = 0; i < 16; ++i) col[i] = {0, 0, 0, 255};
    return;
  }
  int mode = 0;
  while (!(s[0] >> mode & 1)) ++mode;
  const uint8_t* m = kModes[mode];
  const int ns = m[0], ib = m[8], ib2 = m[9];
  int cb = m[4], ab = m[5], bit = mode + 1;
  const uint8_t *cw = bc7_weights(ib), *aw = bc7_weights(ab && ib2 ? ib2 : ib);
  auto load = [&](int k) {
    const int v = bcn_bits(s, bit, k);
    bit += k;
    return v;
  };
  const int partition = load(m[1]), rotation = load(m[2]), index_sel = load(m[3]), numep = ns * 2;
  uint8_t e[6][4];
  for (int c = 0; c < 3; ++c)
    for (int i = 0; i < numep; ++i) e[i][c] = (uint8_t)load(cb);
  for (int i = 0; i < numep; ++i) e[i][3] = ab ? (uint8_t)load(ab) : 255;
  auto pbit = [&](int i, int v) {
    for (int c = 0; c < (ab ? 4 : 3); ++c) e[i][c] = (uint8_t)(e[i][c] << 1 | v);
  };
  if (m[6]) {
    ++cb;
    if (ab) ++ab;
    for (int i = 0; i < numep; ++i) pbit(i, load(1));
  }
  if (m[7]) {
    ++cb;
    if (ab) ++ab;
    for (int i = 0; i < numep; i += 2) {
      const int v = load(1);
      pbit(i, v);
      pbit(i + 1, v);
    }
  }
  auto expand = [](uint8_t v, int b) {
    v = (uint8_t)(v << (8 - b));
    return (uint8_t)(v | v >> b);
  };
  for (int i = 0; i < numep; ++i) {
    for (int c = 0; c < 3; ++c) e[i][c] = expand(e[i][c], cb);
    if (ab) e[i][3] = expand(e[i][3], ab);
  }
  int cibit = bit, aibit = cibit + 16 * ib - ns;
  for (int i = 0; i < 16; ++i) {
    const int sub = bc7_subset(ns, partition, i) * 2;
    int k = ib;
    if (i == 0 || (ns == 2 && i == kBc7Anchor2[partition]) ||
        (ns == 3 && (i == kBc7Anchor3a[partition] || i == kBc7Anchor3b[partition])))
      --k;
    const int i0 = bcn_bits(s, cibit, k);
    cibit += k;
    int sc = cw[i0], sa = cw[i0];
    if (ab && ib2) {
      const int k2 = i == 0 ? ib2 - 1 : ib2, i1 = bcn_bits(s, aibit, k2);
      aibit += k2;
      sc = index_sel ? aw[i1] : cw[i0];
      sa = index_sel ? cw[i0] : aw[i1];
    }
    const uint8_t *e0 = e[sub], *e1 = e[sub + 1];
    uint8_t v[4];
    for (int c = 0; c < 4; ++c) {
      const int w = c < 3 ? sc : sa;
      v[c] = (uint8_t)(((64 - w) * e0[c] + w * e1[c] + 32) >> 6);
    }
    if (rotation) std::swap(v[rotation - 1], v[3]);
    col[i] = {v[0], v[1], v[2], v[3]};
  }
}

// BC6H's endpoint bits, mode by mode (the format's tables as Pillow reads
// them): runs of one endpoint value's bits, each {value, first bit, last
// bit} in the order they stand in the block; the values are r, g, b of w,
// x, y, z (x and z as deltas where the mode transforms).
enum { RW, GW, BW, RX, GX, BX, RY, GY, BY, RZ, GZ, BZ };
struct Bc6Run {
  uint8_t value, first, last;
};
const Bc6Run kBc6Runs[14][24] = {
    {{GY, 4, 4}, {BY, 4, 4}, {BZ, 4, 4}, {RW, 0, 9}, {GW, 0, 9}, {BW, 0, 9}, {RX, 0, 4}, {GZ, 4, 4},
     {GY, 0, 3}, {GX, 0, 4}, {BZ, 0, 0}, {GZ, 0, 3}, {BX, 0, 4}, {BZ, 1, 1}, {BY, 0, 3}, {RY, 0, 4},
     {BZ, 2, 2}, {RZ, 0, 4}, {BZ, 3, 3}},
    {{GY, 5, 5}, {GZ, 4, 5}, {RW, 0, 6}, {BZ, 0, 1}, {BY, 4, 4}, {GW, 0, 6}, {BY, 5, 5}, {BZ, 2, 2},
     {GY, 4, 4}, {BW, 0, 6}, {BZ, 3, 3}, {BZ, 5, 5}, {BZ, 4, 4}, {RX, 0, 5}, {GY, 0, 3}, {GX, 0, 5},
     {GZ, 0, 3}, {BX, 0, 5}, {BY, 0, 3}, {RY, 0, 5}, {RZ, 0, 5}},
    {{RW, 0, 9}, {GW, 0, 9}, {BW, 0, 9}, {RX, 0, 4}, {RW, 10, 10}, {GY, 0, 3}, {GX, 0, 3}, {GW, 10, 10},
     {BZ, 0, 0}, {GZ, 0, 3}, {BX, 0, 3}, {BW, 10, 10}, {BZ, 1, 1}, {BY, 0, 3}, {RY, 0, 4}, {BZ, 2, 2},
     {RZ, 0, 4}, {BZ, 3, 3}},
    {{RW, 0, 9}, {GW, 0, 9}, {BW, 0, 9}, {RX, 0, 3}, {RW, 10, 10}, {GZ, 4, 4}, {GY, 0, 3}, {GX, 0, 4},
     {GW, 10, 10}, {GZ, 0, 3}, {BX, 0, 3}, {BW, 10, 10}, {BZ, 1, 1}, {BY, 0, 3}, {RY, 0, 3}, {BZ, 0, 0},
     {BZ, 2, 2}, {RZ, 0, 3}, {GY, 4, 4}, {BZ, 3, 3}},
    {{RW, 0, 9}, {GW, 0, 9}, {BW, 0, 9}, {RX, 0, 3}, {RW, 10, 10}, {BY, 4, 4}, {GY, 0, 3}, {GX, 0, 3},
     {GW, 10, 10}, {BZ, 0, 0}, {GZ, 0, 3}, {BX, 0, 4}, {BW, 10, 10}, {BY, 0, 3}, {RY, 0, 3}, {BZ, 1, 2},
     {RZ, 0, 3}, {BZ, 4, 4}, {BZ, 3, 3}},
    {{RW, 0, 8}, {BY, 4, 4}, {GW, 0, 8}, {GY, 4, 4}, {BW, 0, 8}, {BZ, 4, 4}, {RX, 0, 4}, {GZ, 4, 4},
     {GY, 0, 3}, {GX, 0, 4}, {BZ, 0, 0}, {GZ, 0, 3}, {BX, 0, 4}, {BZ, 1, 1}, {BY, 0, 3}, {RY, 0, 4},
     {BZ, 2, 2}, {RZ, 0, 4}, {BZ, 3, 3}},
    {{RW, 0, 7}, {GZ, 4, 4}, {BY, 4, 4}, {GW, 0, 7}, {BZ, 2, 2}, {GY, 4, 4}, {BW, 0, 7}, {BZ, 3, 4},
     {RX, 0, 5}, {GY, 0, 3}, {GX, 0, 4}, {BZ, 0, 0}, {GZ, 0, 3}, {BX, 0, 4}, {BZ, 1, 1}, {BY, 0, 3},
     {RY, 0, 5}, {RZ, 0, 5}},
    {{RW, 0, 7}, {BZ, 0, 0}, {BY, 4, 4}, {GW, 0, 7}, {GY, 5, 5}, {GY, 4, 4}, {BW, 0, 7}, {GZ, 5, 5},
     {BZ, 4, 4}, {RX, 0, 4}, {GZ, 4, 4}, {GY, 0, 3}, {GX, 0, 5}, {GZ, 0, 3}, {BX, 0, 4}, {BZ, 1, 1},
     {BY, 0, 3}, {RY, 0, 4}, {BZ, 2, 2}, {RZ, 0, 4}, {BZ, 3, 3}},
    {{RW, 0, 7}, {BZ, 1, 1}, {BY, 4, 4}, {GW, 0, 7}, {BY, 5, 5}, {GY, 4, 4}, {BW, 0, 7}, {BZ, 5, 5},
     {BZ, 4, 4}, {RX, 0, 4}, {GZ, 4, 4}, {GY, 0, 3}, {GX, 0, 4}, {BZ, 0, 0}, {GZ, 0, 3}, {BX, 0, 5},
     {BY, 0, 3}, {RY, 0, 4}, {BZ, 2, 2}, {RZ, 0, 4}, {BZ, 3, 3}},
    {{RW, 0, 5}, {GZ, 4, 4}, {BZ, 0, 1}, {BY, 4, 4}, {GW, 0, 5}, {GY, 5, 5}, {BY, 5, 5}, {BZ, 2, 2},
     {GY, 4, 4}, {BW, 0, 5}, {GZ, 5, 5}, {BZ, 3, 3}, {BZ, 5, 5}, {BZ, 4, 4}, {RX, 0, 5}, {GY, 0, 3},
     {GX, 0, 5}, {GZ, 0, 3}, {BX, 0, 5}, {BY, 0, 3}, {RY, 0, 5}, {RZ, 0, 5}},
    {{RW, 0, 9}, {GW, 0, 9}, {BW, 0, 9}, {RX, 0, 9}, {GX, 0, 9}, {BX, 0, 9}},
    {{RW, 0, 9}, {GW, 0, 9}, {BW, 0, 9}, {RX, 0, 8}, {RW, 10, 10}, {GX, 0, 8}, {GW, 10, 10}, {BX, 0, 8},
     {BW, 10, 10}},
    {{RW, 0, 9}, {GW, 0, 9}, {BW, 0, 9}, {RX, 0, 7}, {RW, 11, 10}, {GX, 0, 7}, {GW, 11, 10}, {BX, 0, 7},
     {BW, 11, 10}},
    {{RW, 0, 9}, {GW, 0, 9}, {BW, 0, 9}, {RX, 0, 3}, {RW, 15, 10}, {GX, 0, 3}, {GW, 15, 10}, {BX, 0, 3},
     {BW, 15, 10}}};

// Pillow's half_to_float (a multiply by 2^112 of the bits shifted into
// place, infinity from 65536 up) and the float's 8 bits (0 below 0, 255
// above 1, else value * 255 truncated, in float).
inline uint8_t bc6_channel(uint16_t h) {
  uint32_t u = (uint32_t)(h & 0x7FFF) << 13;
  float f, magic;
  const uint32_t m = 0x77800000, inf = 0x47800000;
  memcpy(&f, &u, 4);
  memcpy(&magic, &m, 4);
  f *= magic;
  float lim;
  memcpy(&lim, &inf, 4);
  memcpy(&u, &f, 4);
  if (f >= lim) u |= 255u << 23;
  u |= (uint32_t)(h & 0x8000) << 16;
  memcpy(&f, &u, 4);
  return f < 0.0f ? 0 : f > 1.0f ? 255 : (uint8_t)(f * 255.0f);
}

inline void bc6_extend(uint16_t& v, int bits) {
  int x = v;
  if (x & 1 << (bits - 1)) x |= (int)(~0u << bits);
  v = (uint16_t)x;
}

int bc6_unquantize(uint16_t v, int bits, bool sign) {
  if (!sign) {
    if (bits >= 15) return v;
    if (!v) return 0;
    if (v == (1 << bits) - 1) return 0xFFFF;
    return (((int)v << 16) + 0x8000) >> bits;
  }
  if (bits >= 16) return v;
  const bool neg = v & 0x8000;
  if (neg) v = (uint16_t)-v;
  if (v) v = v >= (1 << (bits - 1)) - 1 ? 0x7FFF : (uint16_t)((((int)v << 15) + 0x4000) >> (bits - 1));
  return neg ? -(int)v : v;
}

inline uint16_t bc6_half(int v, bool sign) {
  if (!sign) return (uint16_t)(v * 31 / 64);
  return v < 0 ? (uint16_t)(0x8000 | (-v) * 31 / 32) : (uint16_t)(v * 31 / 32);
}

// BC6H (decode_bc6_block): the 2- or 5-bit mode (14 and up an all-zero
// block), the endpoint bits, the partition, signed values and deltas
// extended, the deltas added modulo the endpoint precision, each endpoint
// unquantized to 16 bits, then each pixel's value between its subset's
// two (weights of 3- or 4-bit indices, one bit less at the anchors) as a
// half float, in 8 bits.
void bc6_block(Rgba* col, const uint8_t* s, bool sign) {
  // subsets, transformed, partition bits, endpoint bits, delta bits r g b
  static const uint8_t kModes[14][7] = {
      {2, 1, 5, 10, 5, 5, 5}, {2, 1, 5, 7, 6, 6, 6},   {2, 1, 5, 11, 5, 4, 4}, {2, 1, 5, 11, 4, 5, 4},
      {2, 1, 5, 11, 4, 4, 5}, {2, 1, 5, 9, 5, 5, 5},   {2, 1, 5, 8, 6, 5, 5},  {2, 1, 5, 8, 5, 6, 5},
      {2, 1, 5, 8, 5, 5, 6},  {2, 0, 5, 6, 6, 6, 6},   {1, 0, 0, 10, 10, 10, 10},
      {1, 1, 0, 11, 9, 9, 9}, {1, 1, 0, 12, 8, 8, 8}, {1, 1, 0, 16, 4, 4, 4}};
  int mode = s[0] & 0x1F, bit = 5, epbits = 75, ib = 3;
  if ((mode & 3) < 2) {
    mode &= 3;
    bit = 2;
  } else if ((mode & 3) == 2) {
    mode = 2 + (mode >> 2);
    epbits = 72;
  } else {
    mode = 10 + (mode >> 2);
    epbits = 60;
    ib = 4;
  }
  if (mode >= 14) {
    for (int i = 0; i < 16; ++i) col[i] = {0, 0, 0, 0};
    return;
  }
  const uint8_t* m = kModes[mode];
  const int ns = m[0], epb = m[3], numep = ns == 2 ? 12 : 6;
  uint16_t e[12] = {0};
  int at = bit;
  for (const Bc6Run& r : kBc6Runs[mode]) {
    if (r.first == 0 && r.last == 0 && r.value == RW) break;  // the table's end
    const int step = r.first <= r.last ? 1 : -1;
    for (int b = r.first;; b += step) {
      e[r.value] |= (uint16_t)(bcn_bit(s, at++) << b);
      if (b == r.last) break;
    }
  }
  bit += epbits;
  const int partition = bcn_bits(s, bit, m[2]);
  bit += m[2];
  const int mask = (1 << epb) - 1;
  if (sign)
    for (int c = 0; c < 3; ++c) bc6_extend(e[c], epb);
  if (sign || m[1])
    for (int i = 3; i < numep; i += 3)
      for (int c = 0; c < 3; ++c) bc6_extend(e[i + c], m[4 + c]);
  if (m[1])
    for (int i = 3; i < numep; ++i) e[i] = (uint16_t)((e[i] + e[i % 3]) & mask);
  int u[12];
  for (int i = 0; i < numep; ++i) u[i] = bc6_unquantize(e[i], epb, sign);
  const uint8_t* w = bc7_weights(ib);
  for (int i = 0; i < 16; ++i) {
    const int sub = bc7_subset(ns, partition, i) * 6;
    const int k = i == 0 || (ns == 2 && i == kBc7Anchor2[partition]) ? ib - 1 : ib;
    const int t = w[bcn_bits(s, bit, k)];
    bit += k;
    uint8_t v[3];
    for (int c = 0; c < 3; ++c)
      v[c] = bc6_channel(bc6_half((u[sub + c] * (64 - t) + u[sub + 3 + c] * t) >> 6, sign));
    col[i] = {v[0], v[1], v[2], 255};
  }
}

// The grey of a bcn image of `n_` (1-7) from `at` on: each block to RGBA
// (BC4 to L), then luma; BC5 and BC6H are PIL's mode RGB, alpha unused.
Gray bcn_grey(const uint8_t* d, size_t n, size_t at, int64_t W, int64_t H, int n_, bool sign) {
  check_size(W, H);
  const int64_t bw = (W + 3) / 4, bh = (H + 3) / 4, bytes = n_ == 1 || n_ == 4 ? 8 : 16;
  if (at > n || (uint64_t)(n - at) / bytes < (uint64_t)bw * bh)
    corrupt("bcn data ends early (PIL refuses the file)");
  Gray g;
  g.w = (int)W;
  g.h = (int)H;
  g.px.resize((size_t)W * H);
  Rgba col[16];
  uint8_t lum[16];
  const uint8_t* s = d + at;
  for (int64_t by = 0; by < bh; ++by)
    for (int64_t bx = 0; bx < bw; ++bx, s += bytes) {
      switch (n_) {
        case 1: bc1_colour(col, s, false); break;
        case 2:
          bc1_colour(col, s + 8, true);
          for (int i = 0; i < 16; ++i) col[i].a = (uint8_t)((s[i >> 1] >> 4 * (i & 1) & 15) * 17);
          break;
        case 3:
          bc1_colour(col, s + 8, true);
          bc3_alpha(&col[0].r, 4, 3, s, false);
          break;
        case 4: bc3_alpha(lum, 1, 0, s, false); break;
        case 5:
          for (int i = 0; i < 16; ++i) col[i] = {0, 0, (uint8_t)(sign ? 128 : 0), 0};
          bc3_alpha(&col[0].r, 4, 0, s, sign);
          bc3_alpha(&col[0].r, 4, 1, s + 8, sign);
          break;
        case 6: bc6_block(col, s, sign); break;
        default: bc7_block(col, s);
      }
      for (int j = 0; j < 4 && by * 4 + j < H; ++j) {
        uint8_t* o = &g.px[(size_t)(by * 4 + j) * W + bx * 4];
        for (int i = 0; i < 4 && bx * 4 + i < W; ++i) {
          const Rgba& c = col[4 * j + i];
          o[i] = n_ == 4 ? lum[4 * j + i] : luma(c.r, c.g, c.b);
        }
      }
    }
  return g;
}

// DdsImagePlugin's _open: the 124-byte header, then the pixel format's
// route: RGB masks (DdsRgbDecoder), luminance (L at 8 bits, LA at 16 with
// alpha), an 8-bit palette of 1024 RGBA bytes, a FourCC or DX10 format of
// Pillow's bcn, DX10's R8G8B8A8 as raw RGBA; any other is refused. The
// pixels start where the header's reads stopped (load_seek does nothing).
// False where Image.open passes the file on.
struct Dds {
  int64_t w = 0, h = 0;
  int route = 0;    // 'R' masks, 'L', 'A' (LA), 'P', 'B' bcn, '4' RGBA
  int bcn = 0;      // Pillow's n
  bool sign = false;  // BC5S, BC6HS
  uint32_t bits = 0, masks[4] = {0}, nmasks = 0;
  size_t at = 0;
};

bool dds_open(const uint8_t* d, size_t n, Dds& f) {
  if (n < 8) return false;
  if (le32(d + 4) != 124) corrupt("DDS header size not 124 (PIL refuses it)");
  if (n < 128) corrupt("DDS header incomplete (PIL refuses it)");
  const uint8_t* h = d + 8;
  f.h = le32(h + 4);
  f.w = le32(h + 8);
  const uint32_t pf = le32(h + 72), fourcc = le32(h + 76);
  f.bits = le32(h + 80);
  f.at = 128;
  auto cc = [](const char* s) { return (uint32_t)le32((const uint8_t*)s); };
  if (pf & 0x40) {  // DDPF.RGB
    f.route = 'R';
    f.nmasks = pf & 1 ? 4 : 3;
    for (uint32_t i = 0; i < f.nmasks; ++i) f.masks[i] = le32(h + 84 + 4 * i);
  } else if (pf & 0x20000) {  // DDPF.LUMINANCE
    if (f.bits == 8) f.route = 'L';
    else if (f.bits == 16 && pf & 1) f.route = 'A';
    else corrupt("DDS luminance of a bit count PIL does not read (PIL refuses it)");
  } else if (pf & 0x20) {  // DDPF.PALETTEINDEXED8
    f.route = 'P';
    f.at = std::min<size_t>(n, 128 + 1024);
  } else if (pf & 4) {  // DDPF.FOURCC
    f.route = 'B';
    if (fourcc == cc("DXT1")) f.bcn = 1;
    else if (fourcc == cc("DXT3")) f.bcn = 2;
    else if (fourcc == cc("DXT5")) f.bcn = 3;
    else if (fourcc == cc("BC4U") || fourcc == cc("ATI1")) f.bcn = 4;
    else if (fourcc == cc("BC5S")) f.bcn = 5, f.sign = true;
    else if (fourcc == cc("BC5U") || fourcc == cc("ATI2")) f.bcn = 5;
    else if (fourcc == cc("DX10")) {
      if (n < 132) return false;  // struct.error: SyntaxError
      const uint32_t dx = le32(d + 128);
      f.at = std::min<size_t>(n, 148);
      if (dx == 70 || dx == 71) f.bcn = 1;
      else if (dx == 73 || dx == 74) f.bcn = 2;
      else if (dx == 76 || dx == 77) f.bcn = 3;
      else if (dx == 79 || dx == 80) f.bcn = 4;
      else if (dx == 82 || dx == 83) f.bcn = 5;
      else if (dx == 84) f.bcn = 5, f.sign = true;
      else if (dx == 95) f.bcn = 6;
      else if (dx == 96) f.bcn = 6, f.sign = true;
      else if (dx >= 97 && dx <= 99) f.bcn = 7;  // BC7_UNORM_SRGB only sets info["gamma"]
      else if (dx >= 27 && dx <= 29) f.route = '4';
      else corrupt("DDS of a DXGI format PIL does not read (PIL refuses it)");
    } else {
      corrupt("DDS of a FourCC PIL does not read (PIL refuses it)");
    }
  } else {
    corrupt("DDS of pixel format flags PIL does not read (PIL refuses it)");
  }
  return f.w > 0 && f.h > 0;
}

// DdsRgbDecoder: bits / 8 little-endian bytes a pixel (a short read the
// bytes left, past the end none: 0), each channel its mask's bits shifted
// down, over the mask's, times 255, truncated (in double); a zero mask 0.
Gray decode_dds(const uint8_t* d, size_t n) {
  Dds f;
  dds_open(d, n, f);
  if (f.route == 'B') return bcn_grey(d, n, f.at, f.w, f.h, f.bcn, f.sign);
  check_size(f.w, f.h);
  const size_t px = (size_t)f.w * f.h;
  Gray g;
  g.w = (int)f.w;
  g.h = (int)f.h;
  if (f.route == 'R') {
    int shift[4];
    double total[4];
    for (uint32_t c = 0; c < f.nmasks; ++c) {
      shift[c] = f.masks[c] ? __builtin_ctz(f.masks[c]) : 0;
      total[c] = (double)(f.masks[c] >> shift[c]);
    }
    auto chan = [&](uint32_t v, int c) {
      return f.masks[c] ? (int)((double)((v & f.masks[c]) >> shift[c]) / total[c] * 255) : 0;
    };
    g.px.resize(px);
    const size_t step = f.bits / 8;
    size_t p = f.at;
    for (size_t i = 0; i < px; ++i) {
      const size_t k = std::min(step, n - p);
      uint32_t v = 0;
      for (size_t b = 0; b < std::min<size_t>(k, 4); ++b) v |= (uint32_t)d[p + b] << 8 * b;
      p += k;
      g.px[i] = luma(chan(v, 0), chan(v, 1), chan(v, 2));
    }
    return g;
  }
  const size_t bpp = f.route == 'A' ? 2 : f.route == '4' ? 4 : 1;
  if ((n - f.at) / bpp < px) corrupt("DDS pixels end early (PIL refuses the file)");
  const uint8_t* s = d + f.at;
  g.px.resize(px);
  if (f.route == 'P') {  // the palette's RGBA entries (a file cut in them has no pixels)
    uint8_t grey[256];
    for (int i = 0; i < 256; ++i) grey[i] = luma(d[128 + 4 * i], d[129 + 4 * i], d[130 + 4 * i]);
    for (size_t i = 0; i < px; ++i) g.px[i] = grey[s[i]];
  } else if (f.route == '4') {
    for (size_t i = 0; i < px; ++i) g.px[i] = luma(s[4 * i], s[4 * i + 1], s[4 * i + 2]);
  } else {
    for (size_t i = 0; i < px; ++i) g.px[i] = s[bpp * i];
  }
  return g;
}

// FtexImagePlugin's _open: the size (signed), the format count (1 or
// Python's AssertionError, which fails Image.open), the first format and
// where its mipmaps start, the first mipmap's byte count (-1: the rest
// of the file, as a file's read(-1) gives it; below -1 read() raises),
// its bytes: DXT1 (bcn 1) or raw RGB. False where Image.open passes the file
// on; the data is [`p`, `e`).
struct Ftex {
  int64_t w = 0, h = 0;
  int format = 0;
  size_t p = 0, e = 0;
};

bool ftex_open(const uint8_t* d, size_t n, Ftex& f) {
  if (n < 24) return false;
  f.w = (int32_t)le32(d + 8);
  f.h = (int32_t)le32(d + 12);
  if (le32(d + 20) != 1) corrupt("FTEX of a format count other than 1 (PIL's assert fails)");
  if (n < 32) return false;
  f.format = (int32_t)le32(d + 24);
  const int32_t where = (int32_t)le32(d + 28);
  if (where < 0) corrupt("FTEX mipmap at a negative offset (PIL refuses it)");
  if ((size_t)where + 4 > n) return false;
  const int32_t size = (int32_t)le32(d + where);
  // a file's read(-1) is the rest of it; any other negative count raises
  if (size < -1) corrupt("FTEX mipmap of a negative byte count (PIL refuses it)");
  f.p = (size_t)where + 4;
  f.e = size < 0 ? n : std::min(n, f.p + (size_t)size);
  if (f.format != 0 && f.format != 1) corrupt("FTEX of a texture format PIL does not know (PIL refuses it)");
  // PIL's _open has closed the file: Image.open fails on the next plugin
  if (f.w <= 0 || f.h <= 0) corrupt("FTEX of no pixels (PIL refuses it)");
  return true;
}

Gray decode_ftex(const uint8_t* d, size_t n) {
  Ftex f;
  ftex_open(d, n, f);
  if (f.format == 0) return bcn_grey(d, f.e, f.p, f.w, f.h, 1, false);
  check_size(f.w, f.h);
  const size_t px = (size_t)f.w * f.h;
  if ((f.e - f.p) / 3 < px) corrupt("FTEX pixels end early (PIL refuses the file)");
  Gray g;
  g.w = (int)f.w;
  g.h = (int)f.h;
  g.px.resize(px);
  const uint8_t* s = d + f.p;
  for (size_t i = 0; i < px; ++i) g.px[i] = luma(s[3 * i], s[3 * i + 1], s[3 * i + 2]);
  return g;
}

// ------------------------------------------------------------- BLP (A.6.54)

// BlpImagePlugin's _open: BLP1 (compression, alpha, size, encoding) or
// BLP2 (compression, encoding, alpha and alpha encoding as signed bytes,
// size); mode RGBA where alpha is not 0, else RGB. False where Image.open
// passes the file on.
struct Blp {
  bool v2 = false, alpha = false;
  int32_t compression = 0, encoding = 0, alpha_encoding = 0;
  int64_t w = 0, h = 0;
};

bool blp_open(const uint8_t* d, size_t n, Blp& b) {
  b.v2 = d[3] == '2';
  if (n < (b.v2 ? 20u : 24u)) return false;
  b.compression = (int32_t)le32(d + 4);
  if (b.v2) {
    b.encoding = (int8_t)d[8];
    b.alpha = d[9] != 0;
    b.alpha_encoding = (int8_t)d[10];
  } else {
    b.alpha = le32(d + 8) != 0;
    b.encoding = (int32_t)le32(d + 20);
  }
  b.w = le32(d + 12);
  b.h = le32(d + 16);
  return b.w > 0 && b.h > 0;
}

// Pillow's Python DXT decoders (BlpImagePlugin.decode_dxt1/3/5): 565
// endpoints shifted up without their high bits copied down, Python's //;
// DXT1 gives RGB (RGBA where the image has alpha), DXT3 and DXT5 RGBA
// always. `out` gets a block's 16 pixels, `bpp` bytes each.
void blp_dxt(const uint8_t* s, int enc, uint8_t* out, int bpp) {
  const uint8_t* c = enc == 0 ? s : s + 8;
  const uint32_t c0 = le16(c), c1 = le16(c + 2), code = le32(c + 4);
  const int r0 = (c0 >> 11 & 31) << 3, g0 = (c0 >> 5 & 63) << 2, b0 = (c0 & 31) << 3;
  const int r1 = (c1 >> 11 & 31) << 3, g1 = (c1 >> 5 & 63) << 2, b1 = (c1 & 31) << 3;
  const uint64_t abits = enc == 7 ? (uint64_t)le16(s + 2) | (uint64_t)le32(s + 4) << 16 : 0;
  for (int i = 0; i < 16; ++i) {
    const int k = code >> 2 * i & 3;
    int r, g, b, a = 255;
    if (k == 0) r = r0, g = g0, b = b0;
    else if (k == 1) r = r1, g = g1, b = b1;
    else if (enc != 0 || c0 > c1) {
      const int u = k == 2 ? 2 : 1;  // DXT1's 4-colour mode; DXT3 and DXT5 always
      r = (u * r0 + (3 - u) * r1) / 3, g = (u * g0 + (3 - u) * g1) / 3, b = (u * b0 + (3 - u) * b1) / 3;
    } else if (k == 2) {
      r = (r0 + r1) / 2, g = (g0 + g1) / 2, b = (b0 + b1) / 2;
    } else {
      r = g = b = a = 0;
    }
    if (enc == 1) {
      a = (s[i >> 1] >> 4 * (i & 1) & 15) * 17;
    } else if (enc == 7) {
      const int a0 = s[0], a1 = s[1], q = (int)(abits >> 3 * i & 7);
      a = q == 0 ? a0 : q == 1 ? a1 : a0 > a1 ? ((8 - q) * a0 + (q - 1) * a1) / 7
          : q == 6 ? 0 : q == 7 ? 255 : ((6 - q) * a0 + (q - 1) * a1) / 5;
    }
    uint8_t* o = out + bpp * i;
    o[0] = (uint8_t)r, o[1] = (uint8_t)g, o[2] = (uint8_t)b;
    if (bpp == 4) o[3] = (uint8_t)a;
  }
}

// The BLP decoders: the 16 mipmap offsets and lengths after the header
// (PIL's _safe_read: all there or refused), then BLP1: a JPEG (its header
// and the first mipmap joined, after a skip to the mipmap that never goes
// back, read by this file's JPEG reader, R and B swapped) or a palette
// (encoding 4 or 5) and that many indices right after it; BLP2: the
// palette, then at the first mipmap's offset its indices (encoding 1) or
// DXT blocks a row of blocks at a time (alpha encoding 0, 1, 7), each
// row of blocks four rows of ceil(w / 4) * 4 pixels. set_as_raw then reads
// the image's w * h pixels from those bytes in order, 3 a pixel in mode
// RGB whatever the decoder gave (so a width off a multiple of 4 reads
// DXT rows sheared, and DXT3/5 without alpha bytes shifted): too few are
// refused.
Gray decode_blp(const uint8_t* d, size_t n) {
  Blp b;
  blp_open(d, n, b);
  check_size(b.w, b.h);
  size_t p = b.v2 ? 20 : 28;
  if (n < p + 128) corrupt("BLP mipmap table ends early (PIL refuses the file)");
  const uint32_t off0 = le32(d + p), len0 = le32(d + p + 64);
  p += 128;
  const size_t px = (size_t)b.w * b.h, mbpp = b.alpha ? 4 : 3;
  auto need = [&](size_t k) {
    if (k > n - std::min(p, n)) corrupt("BLP data ends early (PIL refuses the file)");
  };
  Gray g;
  g.w = (int)b.w;
  g.h = (int)b.h;
  if (!b.v2 && b.compression == 0) {
    need(4);
    const size_t hs = le32(d + p);
    p += 4;
    need(hs);
    std::vector<uint8_t> jpeg(d + p, d + p + hs);
    p += hs;
    if (off0 > p) {
      need(off0 - p);
      p = off0;
    }
    need(len0);
    jpeg.insert(jpeg.end(), d + p, d + p + len0);
    if (jpeg.size() < 3 || jpeg[0] != 0xFF || jpeg[1] != 0xD8 || jpeg[2] != 0xFF)
      corrupt("BLP1's JPEG is not a JPEG stream (PIL refuses the file)");
    Jpeg j;
    j.begin(jpeg.data(), jpeg.size(), true);
    j.blp = true;
    Gray rgb = j.run();
    if (rgb.px.size() < px) corrupt("BLP1's JPEG has fewer pixels than the image (PIL refuses the file)");
    rgb.px.resize(px);
    g.px = std::move(rgb.px);
    return g;
  }
  auto palette = [&](uint8_t grey[256]) {
    need(1024);
    for (int i = 0; i < 256; ++i) grey[i] = luma(d[p + 4 * i + 2], d[p + 4 * i + 1], d[p + 4 * i]);
    p += 1024;
  };
  auto indices = [&](const uint8_t grey[256]) {
    need(len0);
    if (len0 < px) corrupt("BLP indices fewer than the pixels (PIL refuses the file)");
    g.px.resize(px);
    for (size_t i = 0; i < px; ++i) g.px[i] = grey[d[p + i]];
  };
  uint8_t grey[256];
  if (!b.v2) {
    if (b.compression != 1 || (b.encoding != 4 && b.encoding != 5))
      corrupt("BLP1 of a compression or encoding PIL does not read (PIL refuses it)");
    palette(grey);
    indices(grey);
    return g;
  }
  palette(grey);
  p = off0;
  if (b.compression != 1 || (b.encoding != 1 && b.encoding != 2) ||
      (b.encoding == 2 && b.alpha_encoding != 0 && b.alpha_encoding != 1 && b.alpha_encoding != 7))
    corrupt("BLP2 of a compression or encoding PIL does not read (PIL refuses it)");
  if (b.encoding == 1) {
    indices(grey);
    return g;
  }
  const int enc = b.alpha_encoding;
  const size_t bw = ((size_t)b.w + 3) / 4, bh = ((size_t)b.h + 3) / 4, bytes = enc == 0 ? 8 : 16;
  const size_t dbpp = enc == 0 ? mbpp : 4, row = bw * 4 * dbpp;  // a pixel row of the decoder's
  need(bw * bh * bytes);
  // the decoder's bytes, only as many block rows as the image's pixels take
  const size_t total = px * mbpp, rows = std::min(bh, (total + 4 * row - 1) / (4 * row));
  std::vector<uint8_t> data(rows * 4 * row);
  uint8_t blk[64];
  for (size_t by = 0; by < rows; ++by)
    for (size_t bx = 0; bx < bw; ++bx) {
      blp_dxt(d + p + (by * bw + bx) * bytes, enc, blk, (int)dbpp);
      for (int j = 0; j < 4; ++j)
        memcpy(&data[(by * 4 + j) * row + bx * 4 * dbpp], blk + 4 * j * dbpp, 4 * dbpp);
    }
  g.px.resize(px);
  for (size_t i = 0; i < px; ++i) {
    const uint8_t* q = &data[i * mbpp];
    g.px[i] = luma(q[0], q[1], q[2]);
  }
  return g;
}

// ---------------------------------------------------------- SPIDER (A.6.55)

// SpiderImagePlugin's _open: 27 floats, big-endian first, then
// little-endian, whose header fields are whole numbers that agree
// (isSpiderHeader: labbyt = labrec * lenbyt, not 0), of a 2D image (iform
// 1, or SyntaxError without trying the other order); the stack fields as
// int() takes them (not numbers: ValueError); a plain image at labbyt, a
// stack's first image at 2 labbyt (its image count int() too), an image
// within a stack refused (self.stkoffset was never set: AttributeError),
// other stack fields passed on. False where Image.open passes the file
// on.
struct Spider {
  int64_t w = 0, h = 0;
  bool be = true;
  double offset = 0;
};

bool spider_open(const uint8_t* d, size_t n, Spider& f) {
  if (n < 108) return false;
  static const double kForms[] = {1, 3, -11, -12, -21, -22};
  for (int be = 1; be >= 0; --be) {
    double h[28];
    for (int i = 0; i < 27; ++i) {
      const uint8_t* q = d + 4 * i;
      const uint32_t u = be ? be32(q) : le32(q);
      float v;
      memcpy(&v, &u, 4);
      h[i + 1] = v;
    }
    auto whole = [](double v) { return std::isfinite(v) && v == std::trunc(v); };
    bool ok = true;
    for (int i : {1, 2, 5, 12, 13, 22, 23}) ok = ok && whole(h[i]);
    if (!ok || std::find(std::begin(kForms), std::end(kForms), h[5]) == std::end(kForms)) continue;
    // labbyt = labrec * lenbyt: float32 whole numbers, exact in long double
    if ((long double)h[22] != (long double)h[13] * (long double)h[23] || h[22] == 0) continue;
    if (h[5] != 1) return false;
    f.be = be;
    auto i64 = [](double v) { return v >= 1e18 ? INT64_MAX : v <= -1e18 ? INT64_MIN : (int64_t)v; };
    f.w = i64(h[12]);
    f.h = i64(h[2]);
    if (!std::isfinite(h[24]) || !std::isfinite(h[27])) corrupt("SPIDER stack fields not numbers");
    const double stack = std::trunc(h[24]), number = std::trunc(h[27]);
    if (stack == 0 && number == 0) {
      f.offset = h[22];
    } else if (stack > 0 && number == 0) {
      if (!std::isfinite(h[26])) corrupt("SPIDER image count not a number");
      f.offset = 2 * h[22];
    } else if (stack == 0 && number > 0) {
      corrupt("SPIDER image within a stack (PIL's offset for it was never set)");
    } else {
      return false;
    }
    return f.w > 0 && f.h > 0;
  }
  return false;
}

// Mode F from F;32BF or F;32F at the header's offset, the data whole or
// refused; convert("L") clips and truncates, NaN 0.
Gray decode_spider(const uint8_t* d, size_t n) {
  Spider f;
  spider_open(d, n, f);
  check_size(f.w, f.h);
  const size_t px = (size_t)f.w * f.h;
  if (f.offset < 0 || f.offset > (double)n || (n - (size_t)f.offset) / 4 < px)
    corrupt("SPIDER pixels end early or start before the file (PIL refuses it)");
  const uint8_t* s = d + (size_t)f.offset;
  Gray g;
  g.w = (int)f.w;
  g.h = (int)f.h;
  g.px.resize(px);
  for (size_t i = 0; i < px; ++i) {
    const uint32_t u = f.be ? be32(s + 4 * i) : le32(s + 4 * i);
    float v;
    memcpy(&v, &u, 4);
    g.px[i] = float_grey(v);
  }
  return g;
}

// ------------------------------------ PIXAR, GBR, McIdas, IMT, FITS (A.6.56-A.6.60)

std::string pil_format(const uint8_t* d, size_t n);
int format_of(const uint8_t* d, size_t n);

// The modes of these formats' raw tiles, as PIL's raw mode unpacks them
// (little-endian where the raw mode names no order) and convert("L") takes
// them: L itself, I;16 and I;16B 255 where the high byte is set, I clipped
// to 0 .. 255, F clipped and truncated (NaN 0), RGB and RGBA through luma.
enum RawMode { kRawL, kRawI16, kRawI16B, kRawI32, kRawI32B, kRawF32, kRawRgb, kRawRgba };
constexpr int kRawBytes[] = {1, 2, 2, 4, 4, 4, 3, 4};

inline uint8_t raw_grey(RawMode m, const uint8_t* p) {
  switch (m) {
    case kRawL: return p[0];
    case kRawI16: return p[1] ? 255 : p[0];
    case kRawI16B: return p[0] ? 255 : p[1];
    case kRawI32: return clip_int((int32_t)le32(p));
    case kRawI32B: return clip_int((int32_t)be32(p));
    case kRawF32: {
      const uint32_t u = le32(p);
      float f;
      memcpy(&f, &u, 4);
      return float_grey(f);
    }
    case kRawRgb: case kRawRgba: return luma(p[0], p[1], p[2]);
  }
  return 0;
}

// PIL's raw tile at `offset` of a W x H image: row after row `stride` bytes
// apart (0: packed), the bottom row first where `bottom_up`. ImageFile.load
// maps a tile of a file opened by its name whose raw mode is its mode and
// one of L, I;16 and I;16B (`mappable`): a negative offset is refused; if
// offset + H * stride passes the file's end it falls back to the decoder,
// else map_buffer reads the rows where they lie, `stride` apart or, for a
// stride of 0 or less, a row of the mode's own width apart (L 1, I;16 2
// bytes a pixel), refusing the file where those rows pass its end. The raw
// decoder (RawDecode.c) refuses a stride below a row's bytes, and a file
// that ends before the last row's bytes (a seek past the end reads
// nothing). A stride past C's int is refused either way.
Gray raw_tile(const uint8_t* d, size_t n, int64_t W, int64_t H, RawMode m, __int128 offset, __int128 stride,
              bool bottom_up, bool mappable, const char* what) {
  check_size(W, H);
  const int64_t row = W * kRawBytes[m];
  if (stride > INT32_MAX || stride < INT32_MIN) corrupt(std::string(what) + " row stride past C's int (PIL refuses it)");
  if (offset < 0) corrupt(std::string(what) + " pixels before the file's start (PIL refuses it)");
  __int128 step = stride;
  bool map = mappable && offset + H * stride <= (__int128)n;
  if (map) {
    if (step <= 0) step = row;
    if (offset + H * step > (__int128)n) corrupt(std::string(what) + " pixels end early (PIL's map refuses the file)");
  } else {
    if (step == 0) step = row;
    if (step < row) corrupt(std::string(what) + " row stride below a row's bytes (PIL refuses it)");
    if (offset + (H - 1) * step + row > (__int128)n) corrupt(std::string(what) + " pixels end early (PIL refuses the file)");
  }
  Gray g;
  g.w = (int)W;
  g.h = (int)H;
  g.px.resize((size_t)W * H);
  const int k = kRawBytes[m];
  uint8_t buf[4];
  auto unpack = [&](auto mode, const uint8_t* r, uint8_t* o) {  // the mode a constant in each loop
    for (int64_t x = 0; x < W; ++x) o[x] = raw_grey(decltype(mode)::value, r + k * x);
  };
  for (int64_t y = 0; y < H; ++y) {
    const size_t at = (size_t)(offset + (bottom_up ? H - 1 - y : y) * step);
    uint8_t* o = &g.px[(size_t)y * W];
    if (at + row <= n) {
      const uint8_t* r = d + at;
      switch (m) {
        case kRawL: memcpy(o, r, W); break;
        case kRawI16: unpack(std::integral_constant<RawMode, kRawI16>(), r, o); break;
        case kRawI16B: unpack(std::integral_constant<RawMode, kRawI16B>(), r, o); break;
        case kRawI32: unpack(std::integral_constant<RawMode, kRawI32>(), r, o); break;
        case kRawI32B: unpack(std::integral_constant<RawMode, kRawI32B>(), r, o); break;
        case kRawF32: unpack(std::integral_constant<RawMode, kRawF32>(), r, o); break;
        case kRawRgb: unpack(std::integral_constant<RawMode, kRawRgb>(), r, o); break;
        case kRawRgba: unpack(std::integral_constant<RawMode, kRawRgba>(), r, o); break;
      }
      continue;
    }
    for (int64_t x = 0; x < W; ++x) {  // a mapped row of a short stride past the file's end: zeros
      for (int i = 0; i < k; ++i) {
        const size_t p = at + (size_t)(k * x + i);
        buf[i] = p < n ? d[p] : 0;
      }
      o[x] = raw_grey(m, buf);
    }
  }
  return g;
}

// PixarImagePlugin: the magic, 508 more header bytes read (fewer than 428
// in all: struct.error, the file passed on), the size little-endian at 418
// (w) and 416 (h), and mode RGB only for the channel / depth pair (14, 2) at
// 424 (any other: no mode, passed on); raw RGB from 1024.
bool pixar_open(const uint8_t* d, size_t n, int64_t& w, int64_t& h) {
  if (!starts(d, n, "\x80\xe8\0\0", 4) || n < 428) return false;
  w = le16(d + 418);
  h = le16(d + 416);
  return le16(d + 424) == 14 && le16(d + 426) == 2 && w > 0 && h > 0;
}

Gray decode_pixar(const uint8_t* d, size_t n) {
  int64_t w = 0, h = 0;
  pixar_open(d, n, w, h);
  return raw_tile(d, n, w, h, kRawRgb, 1024, 0, false, false, "PIXAR");
}

// GbrImagePlugin: big-endian header size (at least 20), version (1 or 2),
// width and height (not 0), depth (1: L, 4: RGBA); version 2's "GIMP" and
// spacing after them; then a comment of header size - 20 (version 1) or -
// 28 bytes: -1 reads the rest of the file, a length below that is refused
// (a file's read() takes no other negative length). A header read past
// the file's end, or a value PIL does not know, passes the file on. The pixels are frombytes of w * h * depth bytes
// from where the reads stopped: fewer is refused.
struct Gbr {
  int64_t w = 0, h = 0;
  int depth = 0;
  size_t data = 0;
};

bool gbr_open(const uint8_t* d, size_t n, Gbr& f) {
  if (n < 20) return false;
  const uint32_t head = be32(d), version = be32(d + 4);
  if (head < 20 || (version != 1 && version != 2)) return false;
  f.w = be32(d + 8);
  f.h = be32(d + 12);
  f.depth = (int)be32(d + 16);
  if (!f.w || !f.h || (f.depth != 1 && f.depth != 4)) return false;
  size_t pos = 20;
  int64_t comment = (int64_t)head - 20;
  if (version == 2) {
    if (n < 28 || memcmp(d + 20, "GIMP", 4)) return false;
    pos = 28;
    comment = (int64_t)head - 28;
  }
  if (comment < -1) corrupt("GBR header shorter than its fields (read() of a negative length: PIL refuses it)");
  f.data = comment < 0 ? n : std::min<size_t>(n, pos + (size_t)comment);
  return true;
}

Gray decode_gbr(const uint8_t* d, size_t n) {
  Gbr f;
  gbr_open(d, n, f);
  return raw_tile(d, n, f.w, f.h, f.depth == 1 ? kRawL : kRawRgba, f.data, 0, false, false, "GBR");
}

// McIdasImagePlugin: 256 bytes of 64 big-endian int32 words (w[1] the
// first), starting 0 0 0 0 0 0 0 4; w[11] the mode (1: L, 2: I;16B, 4: I
// from I;32B, else passed on), the size (w[10], w[9]), a raw tile at w[34]
// + w[15] with a stride of w[15] + w[10] * w[11] * w[14] (Python's ints).
struct McIdas {
  int64_t w[65] = {0};
  RawMode mode = kRawL;
};

bool mcidas_open(const uint8_t* d, size_t n, McIdas& f) {
  if (n < 256 || !starts(d, n, "\0\0\0\0\0\0\0\x04", 8)) return false;
  for (int i = 1; i <= 64; ++i) f.w[i] = (int32_t)be32(d + 4 * (i - 1));
  if (f.w[11] == 1) f.mode = kRawL;
  else if (f.w[11] == 2) f.mode = kRawI16B;
  else if (f.w[11] == 4) f.mode = kRawI32B;
  else return false;
  return f.w[10] > 0 && f.w[9] > 0;
}

Gray decode_mcidas(const uint8_t* d, size_t n) {
  McIdas f;
  mcidas_open(d, n, f);
  const int64_t* w = f.w;
  const __int128 stride = (__int128)w[15] + (__int128)w[10] * w[11] * w[14];
  return raw_tile(d, n, w[10], w[9], f.mode, (__int128)w[34] + w[15], stride, false, f.mode != kRawI32B,
                  "McIdas");
}

// ImtImagePlugin: a newline in the first 100 bytes, then lines read 100
// bytes at a time (one of length 1 or past 100 ends the header, '*' starts
// a comment, a line the field regex ([a-z]*) ([^ \r\n]*) misses ends it):
// "width N" and "height N" (int(): not a number is refused), "pixel n8"
// mode L. A form feed ends the header: the raw L pixels start after it, at
// the size read so far. Without a mode or a size the file is passed on;
// with them and no form feed PIL has no tile and refuses it.
struct Imt {
  int64_t w = 0, h = 0;
  bool grey = false;
  int64_t data = -1;  // after the form feed
};

bool imt_open(const uint8_t* d, size_t n, Imt& f) {
  if (!memchr(d, '\n', std::min<size_t>(n, 100))) return false;
  std::string buf((const char*)d, std::min<size_t>(n, 100));
  size_t pos = buf.size();
  for (;;) {
    std::string s;
    if (!buf.empty()) {
      s = buf.substr(0, 1);
      buf.erase(0, 1);
    } else if (pos < n) {
      s = std::string(1, (char)d[pos++]);
    }
    if (s.empty()) break;
    if (s[0] == 0x0C) {
      if (f.grey) f.data = (int64_t)(pos - buf.size());
      break;
    }
    if (buf.find('\n') == std::string::npos) {
      const size_t k = std::min<size_t>(100, n - pos);
      buf.append((const char*)d + pos, k);
      pos += k;
    }
    const size_t nl = buf.find('\n');
    s += buf.substr(0, nl);
    buf = nl == std::string::npos ? std::string() : buf.substr(nl + 1);
    if (s.size() == 1 || s.size() > 100) break;
    if (s[0] == '*') continue;
    size_t k = 0;  // ([a-z]*) ([^ \r\n]*)
    while (k < s.size() && s[k] >= 'a' && s[k] <= 'z') ++k;
    if (k >= s.size() || s[k] != ' ') break;
    const std::string key = s.substr(0, k);
    size_t e = k + 1;
    while (e < s.size() && s[e] != ' ' && s[e] != '\r' && s[e] != '\n') ++e;
    const std::string v = s.substr(k + 1, e - k - 1);
    int64_t x;
    if (key == "width" || key == "height") {
      if (!py_int(v, x)) corrupt("IMT size not a number");
      (key == "width" ? f.w : f.h) = x;
    } else if (key == "pixel" && v == "n8") {
      f.grey = true;
    }
  }
  return f.grey && f.w > 0 && f.h > 0;
}

Gray decode_imt(const uint8_t* d, size_t n) {
  Imt f;
  imt_open(d, n, f);
  if (f.data < 0) corrupt("IMT header without a form feed (PIL has no tile to load)");
  return raw_tile(d, n, f.w, f.h, kRawL, f.data, 0, false, true, "IMT");
}

// bytes.strip(): ASCII whitespace off both ends.
std::string bytes_strip(const std::string& t) {
  auto space = [](char c) { return c == ' ' || (c >= 9 && c <= 13); };
  size_t a = 0, b = t.size();
  while (a < b && space(t[a])) ++a;
  while (b > a && space(t[b - 1])) --b;
  return t.substr(a, b - a);
}

// FitsImagePlugin: 80-byte cards (a read that returns nothing is refused,
// "Truncated FITS file"); the first must be SIMPLE = T (else passed on).
// END seeks to the next multiple of 2880 and, the first time it yields a
// decoder, parses the cards so far (later headers, extensions among them,
// are read past); a card after END that opens no header is the data, and
// the tile starts where it started (the read's end less 80). No decoder:
// refused ("No image data"). The size is (1, NAXIS1) for NAXIS 1, (NAXIS1,
// NAXIS2) above, none for 0; BITPIX 8 L, 16 I;16, 32 I, -32 and -64 F, read
// in the raw mode of the mode (little-endian; -64 as float32), the bottom
// row first, with no BSCALE or BZERO. A BINTABLE extension with ZIMAGE T
// and ZCMPTYPE 'GZIP_1  ' is the fits_gzip route: ZNAXIS and ZBITPIX, the
// data after NAXIS1 * NAXIS2 * (BITPIX // 8) bytes of table.
inline int64_t floor_div8(int64_t v) { return v >= 0 ? v / 8 : -((-v + 7) / 8); }

struct Fits {
  bool gzip = false;
  int64_t w = 0, h = 0, bitpix = 0;
  RawMode mode = kRawL;
  __int128 offset = 0;
};

bool fits_open(const uint8_t* d, size_t n, Fits& f) {
  std::map<std::string, std::string> headers;
  bool in_progress = false, decoder = false;
  size_t pos = 0;
  auto num = [&](const std::string& key, int64_t& v) {
    const auto it = headers.find(key);
    if (it == headers.end()) return false;  // KeyError: passed on
    if (!py_int(it->second, v)) corrupt("FITS " + key + " not a number (PIL refuses it)");
    return true;
  };
  // _get_size: -1 for KeyError, 0 for NAXIS 0 (no size), else 1
  auto size = [&](const std::string& prefix, int64_t& w, int64_t& h) {
    int64_t naxis;
    w = h = 0;
    if (!num(prefix + "NAXIS", naxis)) return -1;
    if (naxis == 0) return 0;
    if (naxis == 1) {
      w = 1;
      return num(prefix + "NAXIS1", h) ? 1 : -1;
    }
    return num(prefix + "NAXIS1", w) && num(prefix + "NAXIS2", h) ? 1 : -1;
  };
  for (;;) {
    const size_t k = pos < n ? std::min<size_t>(80, n - pos) : 0;
    if (!k) corrupt("FITS file ends within its header (PIL: Truncated FITS file)");
    const std::string card((const char*)d + pos, k);
    pos += k;
    const std::string keyword = bytes_strip(card.substr(0, 8));
    if (keyword == "SIMPLE" || keyword == "XTENSION") {
      in_progress = true;
    } else if (!headers.empty() && !in_progress) {
      break;
    } else if (keyword == "END") {
      pos = (pos + 2879) / 2880 * 2880;
      if (!decoder) {  // _parse_headers
        std::string prefix;
        __int128 offset = 0;
        int64_t w, h, bits;
        const auto x = headers.find("XTENSION"), z = headers.find("ZIMAGE");
        f.gzip = false;
        if (x != headers.end() && x->second == "'BINTABLE'" && z != headers.end() && z->second == "T") {
          const auto c = headers.find("ZCMPTYPE");
          if (c == headers.end()) return false;
          if (c->second == "'GZIP_1  '") {
            if (size("", w, h) < 0 || !num("BITPIX", bits)) return false;
            offset = (__int128)w * h * floor_div8(bits);
            prefix = "Z";
            f.gzip = true;
          }
        }
        const int got = size(prefix, w, h);
        if (got < 0) return false;
        if (got > 0) {
          if (!num(prefix + "BITPIX", bits)) return false;
          f.w = w;
          f.h = h;
          f.bitpix = bits;
          f.offset = offset;
          decoder = true;
        }
      }
      in_progress = false;
      continue;
    }
    if (decoder) continue;
    std::string value = card.size() > 8 ? card.substr(8) : std::string();
    value = bytes_strip(value.substr(0, value.find('/')));
    if (!value.empty() && value[0] == '=') value = bytes_strip(value.substr(1));
    if (headers.empty() && (keyword.compare(0, 6, "SIMPLE") != 0 || value != "T")) return false;
    headers[keyword] = value;
  }
  if (!decoder) corrupt("FITS file with no image data (PIL refuses it)");
  f.offset += (__int128)pos - 80;
  switch (f.bitpix) {
    case 8: f.mode = kRawL; break;
    case 16: f.mode = kRawI16; break;
    case 32: f.mode = kRawI32; break;
    case -32: case -64: f.mode = kRawF32; break;
    default: return false;  // no mode
  }
  return f.w > 0 && f.h > 0;
}

// Python's gzip.decompress: members, each a header (magic, method 8, the
// FEXTRA, FNAME, FCOMMENT and FHCRC fields its flags name), raw Deflate, a
// CRC-32 and the length that must agree, then any NUL bytes; the data
// ending where a member would start. Anything else is refused.
std::vector<uint8_t> gunzip(const uint8_t* s, size_t n) {
  std::vector<uint8_t> all, one;
  size_t p = 0;
  while (p < n) {
    if (n - p < 10 || s[p] != 0x1F || s[p + 1] != 0x8B || s[p + 2] != 8) corrupt("not gzip data (PIL refuses it)");
    const int flags = s[p + 3];
    p += 10;
    if (flags & 4) {
      if (n - p < 2) corrupt("gzip header ends early");
      const size_t k = le16(s + p);
      if (n - p - 2 < k) corrupt("gzip header ends early");
      p += 2 + k;
    }
    for (int bit : {8, 16})
      if (flags & bit) {
        while (p < n && s[p]) ++p;
        if (p < n) ++p;
      }
    if (flags & 2) {
      if (n - p < 2) corrupt("gzip header ends early");
      p += 2;
    }
    const size_t used = inflate_raw(s + p, n - p, one);
    p += used;
    if (n - p < 8) corrupt("gzip data ends before its trailer (PIL refuses it)");
    if (le32(s + p) != crc32_of(one.data(), one.size()) || le32(s + p + 4) != (uint32_t)one.size())
      corrupt("gzip CRC or length does not agree (PIL refuses it)");
    p += 8;
    all.insert(all.end(), one.begin(), one.end());
    while (p < n && !s[p]) ++p;
  }
  return all;
}

Gray decode_fits(const uint8_t* d, size_t n) {
  Fits f;
  fits_open(d, n, f);
  if (!f.gzip)
    return raw_tile(d, n, f.w, f.h, f.mode, f.offset, 0, true, f.mode == kRawL || f.mode == kRawI16, "FITS");
  // fits_gzip: the rest of the file from the offset, gunzipped; each sample
  // the last min(ZBITPIX // 8, 4) bytes of a 4-byte value (none for a
  // negative ZBITPIX: not enough image data), the rows reversed, set_as_raw
  // in the mode.
  check_size(f.w, f.h);
  if (f.offset < 0) corrupt("FITS tile before the file's start (PIL refuses it)");
  const size_t at = f.offset > (__int128)n ? n : (size_t)f.offset;
  const std::vector<uint8_t> v = gunzip(d + at, n - at);
  const int bytes = (int)std::min<int64_t>(floor_div8(f.bitpix), 4);
  if (bytes <= 0 || v.size() / 4 / f.w < (size_t)f.h) corrupt("FITS gzip tile holds too few samples (PIL refuses it)");
  const RawMode m = f.mode;
  Gray g;
  g.w = (int)f.w;
  g.h = (int)f.h;
  g.px.resize((size_t)f.w * f.h);
  for (int64_t y = 0; y < f.h; ++y)
    for (int64_t x = 0; x < f.w; ++x) {
      const uint8_t* s = &v[4 * (size_t)((f.h - 1 - y) * f.w + x) + 4 - bytes];
      g.px[(size_t)y * f.w + x] = raw_grey(m, s);
    }
  return g;
}

// ---------------------------------------------------------- IPTC (A.6.61)

// IptcImagePlugin: fields of five bytes read in turn, to none (the end, or
// all NUL) or the first image record (8, 10): 0x1C and a record number
// PIL knows (else passed on); a length byte past 132 refused, 128 no data,
// 129 .. 132 that many minus 128 length bytes after the five (the fifth
// ignored), below 128 a 16-bit length; a field's data read (short at the
// file's end), the same tag twice a list. Then the layers and component
// (3, 60: L for 1 and 0; RGB for 3, CMYK for 4, with a component; a band
// from 3, 65, 0 by default), the size (3, 20), (3, 30) and the compression
// (3, 120: 1 raw, 5 JPEG; any other, or none, refused), each the last 4
// bytes of its data, big-endian. Data that is not there, or a list, passes
// the file on (PIL's IndexError, TypeError, KeyError).
struct IptcField {
  int count = 0;
  bool none = true;  // no data (a length of 0)
  size_t at = 0, len = 0;
};

struct Iptc {
  int64_t w = 0, h = 0;
  int mode = 0;   // 'L', 'R' RGB, 'C' CMYK
  bool banded = false;  // not L: the image is one band of RGB or CMYK
  int band = 0;
  int compression = 0;
  int64_t image = -1;  // the first image record's field, -1 for none
};

// One field at `pos`: false for none; throws where PIL raises anything but
// the pass-on errors (`pass`: IndexError, struct.error, SyntaxError).
bool iptc_field(const uint8_t* d, size_t n, size_t& pos, int& t0, int& t1, size_t& size, bool& pass) {
  pass = false;
  const uint8_t* s = d + std::min(pos, n);
  const size_t k = pos < n ? std::min<size_t>(5, n - pos) : 0;
  pos += k;
  bool zero = true;
  for (size_t i = 0; i < k; ++i) zero = zero && !s[i];
  if (zero) return false;
  if (k < 3 || s[0] != 0x1C || !((s[1] >= 1 && s[1] <= 9) || s[1] == 240) || k < 4) {
    pass = true;
    return false;
  }
  t0 = s[1];
  t1 = s[2];
  size = s[3];
  if (size > 132) corrupt("IPTC field length past 132 (PIL refuses it)");
  if (size == 128) {
    size = 0;
  } else if (size > 128) {
    const size_t m = std::min(size - 128, pos < n ? n - pos : 0);
    size = 0;
    for (size_t i = 0; i < m; ++i) size = size << 8 | d[pos + i];
    pos += m;
  } else if (k < 5) {
    pass = true;
    return false;
  } else {
    size = be16(s + 3);
  }
  return true;
}

bool iptc_open(const uint8_t* d, size_t n, Iptc& f) {
  if (!n || d[0] != 0x1C) return false;
  std::map<std::pair<int, int>, IptcField> info;
  size_t pos = 0;
  for (;;) {
    const size_t start = pos;
    int t0 = 0, t1 = 0;
    size_t size = 0;
    bool pass;
    if (!iptc_field(d, n, pos, t0, t1, size, pass)) {
      if (pass) return false;
      break;
    }
    if (t0 == 8 && t1 == 10) {
      f.image = (int64_t)start;
      break;
    }
    IptcField& r = info[{t0, t1}];
    const size_t at = std::min(pos, n), m = std::min(size, n - at);
    r = IptcField{r.count + 1, size == 0, at, m};
    pos += size;
  }
  // bytes of a tag's data, false where PIL's lookup raises a pass-on error
  auto get = [&](int a, int b, const IptcField*& r) {
    const auto it = info.find({a, b});
    if (it == info.end() || it->second.count != 1 || it->second.none) return false;
    r = &it->second;
    return true;
  };
  auto getint = [&](int a, int b, int64_t& v) {
    const IptcField* r;
    if (!get(a, b, r)) return false;
    v = 0;
    for (size_t i = r->len > 4 ? r->len - 4 : 0; i < r->len; ++i) v = v << 8 | d[r->at + i];
    return true;
  };
  const auto l = info.find({3, 60});
  if (l == info.end()) return false;
  int layers = -1, component = -1;  // a list: neither matches a mode
  if (l->second.count == 1) {
    if (l->second.none || l->second.len < 2) return false;
    layers = d[l->second.at];
    component = d[l->second.at + 1];
  }
  f.mode = layers == 1 && !component ? 'L' : layers == 3 && component ? 'R' : layers == 4 && component ? 'C' : 0;
  f.banded = !(layers == 1 && !component);
  if (f.banded) {
    const auto b = info.find({3, 65});
    f.band = 0;
    if (b != info.end()) {
      const IptcField* r;
      if (!get(3, 65, r) || !r->len) return false;
      f.band = d[r->at] - 1;
    }
  }
  if (!getint(3, 20, f.w) || !getint(3, 30, f.h)) return false;
  const auto c = info.find({3, 120});
  if (c != info.end() && (c->second.count != 1 || c->second.none)) return false;  // TypeError
  int64_t comp = 0;
  if (!getint(3, 120, comp) || (comp != 1 && comp != 5)) corrupt("IPTC compression PIL does not know (PIL refuses it)");
  f.compression = (int)comp;
  return f.mode && f.w > 0 && f.h > 0;
}

Gray decode_iptc(const uint8_t* d, size_t n) {
  Iptc f;
  iptc_open(d, n, f);
  check_size(f.w, f.h);
  if (f.image < 0) corrupt("IPTC file without image data (PIL has no tile to load)");
  // load(): the image records' data joined (for raw compression after a
  // PGM header of the size), until the first field of another tag; a field
  // PIL cannot read there is refused.
  std::string buf;
  if (f.compression == 1) buf = "P5\n" + std::to_string(f.w) + " " + std::to_string(f.h) + "\n255\n";
  for (size_t pos = (size_t)f.image;;) {
    int t0 = 0, t1 = 0;
    size_t size = 0;
    bool pass;
    if (!iptc_field(d, n, pos, t0, t1, size, pass)) {
      if (pass) corrupt("IPTC field PIL cannot read after the image data (PIL refuses it)");
      break;
    }
    if (t0 != 8 || t1 != 10) break;
    const size_t at = std::min(pos, n), m = std::min(size, n - at);
    buf.append((const char*)d + at, m);
    pos += m;
  }
  // Image.open of that buffer: the PGM of raw data (mode L), or a JPEG; a
  // buffer of another format raises naming it, as the port does not read
  // it out of such a buffer.
  const uint8_t* b = (const uint8_t*)buf.data();
  const size_t bn = buf.size();
  const int kind = format_of(b, bn);
  std::string other;  // the format of a buffer that is neither the raw PGM nor a JPEG
  if (f.compression != 1 && kind != 'J') {
    static const std::map<int, std::string> kOwn = {{'P', "PNG"}, {'B', "BMP"}, {'T', "TIFF"}, {'G', "GIF"}};
    other = kind ? kOwn.at(kind) : pil_format(b, bn);
    if (other.empty()) corrupt("IPTC image data PIL identifies as no image (PIL refuses it)");
  }
  const int nb = f.mode == 'R' ? 3 : 4;
  if (f.banded && (f.band >= nb || f.band < -nb)) corrupt("IPTC band past the image's bands (PIL refuses it)");
  if (!other.empty()) unsupported("IPTC image holding a " + other + " image");
  Gray g;
  int bands = 1;
  if (f.compression == 1) {
    Pnm p;
    pnm_head(b, bn, p);
    g = decode_pnm(b, bn, p);
  } else {
    Jpeg j;
    j.begin(b, bn, true);
    g = j.run();
    bands = j.ncomp;
  }
  // L: the image itself, whose mode convert("L") keeps (one not grey is
  // not read); else the image as band `band` of an RGB or CMYK merge with
  // zero bands (a band out of range, or an image not L, is refused).
  if (!f.banded) {
    if (bands != 1) unsupported("IPTC image of mode L holding a JPEG of " + std::to_string(bands) +
                                " components (PIL's convert(\"L\") keeps its mode)");
    return g;
  }
  if (bands != 1) corrupt("IPTC band of a JPEG that is not grey (PIL's merge refuses it)");
  const int at = f.band < 0 ? f.band + nb : f.band;
  for (uint8_t& v : g.px) {
    int c[4] = {0, 0, 0, 0};
    c[at] = v;
    v = nb == 3 ? luma(c[0], c[1], c[2]) : cmyk_luma(c[0], c[1], c[2], c[3]);
  }
  return g;
}

// ------------------------------------------------------------ FLI (A.6.62)

// FliImagePlugin: 128 header bytes, the magic at 4 (0xAF11, 0xAF12),
// flags 0 or 3 at 14, bytes 20-22, 42-80 and 88-128 zero (else passed
// on), the size at 8 and 10; the palette grey unless the chunk after the
// header (or after a prefix chunk, 0xF100, at 128 + its size) is a frame
// (0xF1FA) whose subchunks, walked by their sizes, reach a COLOR_64 (11,
// values << 2) or COLOR_256 (4) chunk first: its packets of a skip and a
// count (0: 256) of RGB entries. A read past the file's end there, or an
// entry past 256, passes the file on; so do a frame count of 0 and
// nothing at 128. The frame
// decoded is the chunk at 128 (a prefix chunk there is no frame: refused).
struct Fli {
  int64_t w = 0, h = 0;
  uint8_t grey[256];
};

bool fli_open(const uint8_t* d, size_t n, Fli& f) {
  if (n < 128 || (le16(d + 4) != 0xAF11 && le16(d + 4) != 0xAF12) || (le16(d + 14) != 0 && le16(d + 14) != 3))
    return false;
  bool zero = !d[20] && !d[21];
  for (size_t i = 42; i < 80; ++i) zero = zero && !d[i];
  for (size_t i = 88; i < 128; ++i) zero = zero && !d[i];
  if (!zero) return false;
  f.w = le16(d + 8);
  f.h = le16(d + 10);
  uint8_t pal[256][3];
  for (int i = 0; i < 256; ++i) pal[i][0] = pal[i][1] = pal[i][2] = (uint8_t)i;
  auto avail = [&](int64_t p, int64_t k) { return p >= 0 && p <= (int64_t)n && (int64_t)n - p >= k; };
  int64_t p = 128;
  if (!avail(p, 6)) return false;
  if (le16(d + p + 4) == 0xF100) {
    if (!avail(p, 4)) return false;
    p = 128 + (int64_t)le32(d + p);
    if (!avail(p, 6)) return false;
  }
  if (le16(d + p + 4) == 0xF1FA) {
    if (!avail(p, 8)) return false;
    const int chunks = le16(d + p + 6);
    p += 16;
    int64_t chunk_size = -1;
    for (int c = 0; c < chunks; ++c) {
      if (chunk_size >= 0) p += chunk_size - 6;  // a seek past the subchunk from the 6 bytes read
      const int64_t at = p;
      if (!avail(at, 6)) return false;
      p += 6;
      const int type = le16(d + at + 4);
      if (type == 4 || type == 11) {
        const int shift = type == 11 ? 2 : 0;
        if (!avail(p, 2)) return false;
        const int packets = le16(d + p);
        p += 2;
        int i = 0;
        for (int e = 0; e < packets; ++e) {
          if (!avail(p, 2)) return false;
          i += d[p];
          const int count = d[p + 1] ? d[p + 1] : 256;
          p += 2;
          const int64_t got = std::min<int64_t>(3 * count, std::max<int64_t>(0, (int64_t)n - p));
          if (got % 3) return false;
          for (int64_t k = 0; k < got; k += 3, ++i) {
            if (i >= 256) return false;
            for (int ch = 0; ch < 3; ++ch) pal[i][ch] = (uint8_t)(d[p + k + ch] << shift);
          }
          p += got;
        }
        break;
      }
      chunk_size = le32(d + at);
      if (!chunk_size) break;
    }
  }
  for (int i = 0; i < 256; ++i) f.grey[i] = luma(pal[i][0], pal[i][1], pal[i][2]);
  // seek(0): a frame count of 0 is past the sequence, the frame's size must be read
  if (!le16(d + 6) || n - 128 < 4) return false;
  return f.w > 0 && f.h > 0;
}

// Pillow's FliDecode.c on the frame at 128, its bytes as ImageFile.load
// hands them over: reads of the frame's size (a pad byte short is taken,
// less waits for more, and a file that ends first is refused). A frame
// chunk's subchunks in turn: BLACK (13), COPY (16; too short: the decoder
// waits for data that never comes, refused), BRUN (15), LC (12), SS2 (7),
// PSTAMP (18) and the colour chunks skipped, any other type refused; every
// read past the data, a line not unpacked whole and a subchunk size of 0
// or past the data is refused. The image starts black (index 0).
Gray decode_fli(const uint8_t* d, size_t n) {
  Fli f;
  fli_open(d, n, f);
  check_size(f.w, f.h);
  const int64_t W = f.w, H = f.h;
  const uint32_t framesize_u = le32(d + 128);
  const int64_t rest = (int64_t)n - 128;
  const int64_t bytes0 = std::min<int64_t>(framesize_u, rest);
  if (bytes0 < 4 || bytes0 + (bytes0 % 2) < framesize_u) corrupt("FLI frame ends early (PIL: image file is truncated)");
  const uint8_t* buf = d + 128;
  int64_t bytes = bytes0;
  if (bytes < 8) corrupt("FLI frame too short (PIL refuses it)");
  if (le16(buf + 4) != 0xF1FA) corrupt("FLI frame chunk is not a frame (PIL refuses it)");
  std::vector<uint8_t> im((size_t)W * H, 0);
  const int chunks = le16(buf + 6);
  const uint8_t* ptr = buf + 16;
  bytes -= 16;
  auto oob = [&](const uint8_t* data, int64_t k) {
    if (data + k > ptr + bytes) corrupt("FLI chunk data past the frame (PIL refuses it)");
  };
  for (int c = 0; c < chunks; ++c) {
    if (bytes < 10) corrupt("FLI subchunk past the frame (PIL refuses it)");
    const uint8_t* data = ptr + 6;
    const int type = le16(ptr + 4);
    switch (type) {
      case 4: case 11: case 18: break;
      case 7: {  // SS2, word delta
        const int lines = le16(data);
        data += 2;
        int l = 0;
        int64_t y = 0;
        for (; l < lines && y < H; ++l, ++y) {
          uint8_t* row = &im[(size_t)y * W];
          oob(data, 2);
          int packets = le16(data);
          data += 2;
          while (packets & 0x8000) {
            if (packets & 0x4000) {
              y += 65536 - packets;
              if (y >= H) corrupt("FLI SS2 skips past the image (PIL refuses it)");
              row = &im[(size_t)y * W];
            } else {
              row[W - 1] = (uint8_t)packets;
            }
            oob(data, 2);
            packets = le16(data);
            data += 2;
          }
          int p = 0;
          int64_t x = 0;
          for (; p < packets; ++p) {
            oob(data, 2);
            x += data[0];
            if (data[1] >= 128) {
              oob(data, 4);
              const int i = 256 - data[1];
              if (x + 2 * i > W) break;
              for (int j = 0; j < i; ++j) {
                row[x++] = data[2];
                row[x++] = data[3];
              }
              data += 4;
            } else {
              const int i = 2 * data[1];
              if (x + i > W) break;
              oob(data, 2 + i);
              memcpy(row + x, data + 2, i);
              data += 2 + i;
              x += i;
            }
          }
          if (p < packets) break;
        }
        if (l < lines) corrupt("FLI SS2 lines not unpacked whole (PIL refuses it)");
        break;
      }
      case 12: {  // LC, byte delta
        int64_t y = le16(data);
        const int64_t ymax = y + le16(data + 2);
        data += 4;
        for (; y < ymax && y < H; ++y) {
          uint8_t* row = &im[(size_t)y * W];
          oob(data, 1);
          const int packets = *data++;
          int p = 0;
          int64_t x = 0, i = 0;
          for (; p < packets; ++p, x += i) {
            oob(data, 2);
            x += data[0];
            if (data[1] & 0x80) {
              i = 256 - data[1];
              if (x + i > W) break;
              oob(data, 3);
              memset(row + x, data[2], i);
              data += 3;
            } else {
              i = data[1];
              if (x + i > W) break;
              oob(data, 2 + i);
              memcpy(row + x, data + 2, i);
              data += 2 + i;
            }
          }
          if (p < packets) break;
        }
        if (y < ymax) corrupt("FLI LC lines not unpacked whole (PIL refuses it)");
        break;
      }
      case 13: std::fill(im.begin(), im.end(), 0); break;  // BLACK
      case 15: {  // BRUN
        for (int64_t y = 0; y < H; ++y) {
          uint8_t* row = &im[(size_t)y * W];
          data += 1;
          int64_t x = 0, i = 0;
          for (; x < W; x += i) {
            oob(data, 2);
            if (data[0] & 0x80) {
              i = 256 - data[0];
              if (x + i > W) break;
              oob(data, i + 1);
              memcpy(row + x, data + 1, i);
              data += i + 1;
            } else {
              i = data[0];
              if (x + i > W) break;
              memset(row + x, data[1], i);
              data += 2;
            }
          }
          if (x != W) corrupt("FLI BRUN line not unpacked whole (PIL refuses it)");
        }
        break;
      }
      case 16:  // COPY
        if (INT32_MAX / W < H) corrupt("FLI COPY chunk too large (PIL refuses it)");
        if (data + W * H > ptr + bytes) corrupt("FLI COPY chunk past the frame (PIL: image file is truncated)");
        memcpy(im.data(), data, (size_t)(W * H));
        break;
      default: corrupt("FLI subchunk of an unknown type (PIL refuses it)");
    }
    const int32_t advance = (int32_t)le32(ptr);
    if (advance == 0) corrupt("FLI subchunk of size 0 (PIL refuses it)");
    if (advance < 0 || advance > bytes) corrupt("FLI subchunk past the frame (PIL refuses it)");
    ptr += advance;
    bytes -= advance;
  }
  Gray g;
  g.w = (int)W;
  g.h = (int)H;
  g.px.resize(im.size());
  for (size_t i = 0; i < im.size(); ++i) g.px[i] = f.grey[im[i]];
  return g;
}

// ------------------------------------------------------------ PCD (A.6.63)

// PcdImagePlugin: "PCD_" at 2048, the orientation in the low 2 bits of
// byte 2048 + 1538 (fewer bytes: IndexError, passed on); the base image's
// 768 x 512 pixels from 96 sectors of 2048 bytes on (PcdDecode.c: each pair
// of rows 768 Y, 768 Y, 384 Cb, 384 Cr, a chroma sample for 2 x 2 pixels;
// a file that ends first is refused), through the YCC;P unpacker's PhotoYCC
// tables (ConvertYCC.c: int(k * (v - v0) + 0.5), truncated toward zero:
// luma 1.3584 Y, R 1.8215 (Cr - 137), G -0.9271 (Cr - 137) - 0.4303 (Cb -
// 156), B 2.2179 (Cb - 156), each sum clipped to 0 .. 255), then luma;
// orientations 1 and 3 rotate the image 90 and 270 degrees.
struct PcdTables {
  int16_t l[256], cr[256], gr[256], gb[256], cb[256];
  PcdTables() {
    auto t = [](double k, int v) { return (int16_t)(int)(k * v + 0.5); };
    for (int i = 0; i < 256; ++i) {
      l[i] = t(1.3584, i);
      cr[i] = t(1.8215, i - 137);
      gr[i] = t(-0.9271, i - 137);
      gb[i] = t(-0.4303, i - 156);
      cb[i] = t(2.2179, i - 156);
    }
  }
};

Gray decode_pcd(const uint8_t* d, size_t n) {
  static const PcdTables t;
  constexpr size_t kAt = 96 * 2048, W = 768, H = 512;
  if (n < kAt || (n - kAt) / (3 * W) < H / 2) corrupt("PCD image ends early (PIL: image file is truncated)");
  const int orientation = d[2048 + 1538] & 3;
  std::vector<uint8_t> im(W * H);
  auto c8 = [](int v) { return v <= 0 ? 0 : v >= 255 ? 255 : v; };
  for (size_t y = 0; y < H; ++y) {
    const uint8_t* pair = d + kAt + (y / 2) * 3 * W;
    const uint8_t *ys = pair + (y & 1) * W, *cbs = pair + 2 * W, *crs = pair + 2 * W + W / 2;
    for (size_t x = 0; x < W; ++x) {
      const int l = t.l[ys[x]], cb = cbs[x / 2], cr = crs[x / 2];
      im[y * W + x] = luma(c8(l + t.cr[cr]), c8(l + t.gr[cr] + t.gb[cb]), c8(l + t.cb[cb]));
    }
  }
  Gray g;
  if (orientation != 1 && orientation != 3) {
    g.w = (int)W;
    g.h = (int)H;
    g.px = std::move(im);
    return g;
  }
  g.w = (int)H;
  g.h = (int)W;
  g.px.resize(W * H);
  for (size_t y = 0; y < W; ++y)  // ROTATE_90 (counter-clockwise) or ROTATE_270
    for (size_t x = 0; x < H; ++x)
      g.px[y * H + x] = orientation == 1 ? im[x * W + (W - 1 - y)] : im[(H - 1 - x) * W + y];
  return g;
}

// PcxImagePlugin's header: a box of pixels and a mode it knows.
int pcx_header(const uint8_t* d, size_t n) {  // 0: not PCX, 1: PCX, -1: PIL fails
  if (n < 68 || d[0] != 10 || !(d[1] == 0 || d[1] == 2 || d[1] == 3 || d[1] == 5)) return 0;
  if ((int)le16(d + 8) + 1 <= (int)le16(d + 4) || (int)le16(d + 10) + 1 <= (int)le16(d + 6)) return 0;
  const int bits = d[3], planes = d[65], version = d[1];
  const bool mode = (bits == 1 && (planes == 1 || planes == 2 || planes == 4)) ||
                    (version == 5 && bits == 8 && (planes == 1 || planes == 3));
  return mode ? 1 : -1;
}

// The format PIL's Image.open takes the file for, "" for none.
std::string pil_format(const uint8_t* d, size_t n) {
  auto st = [&](const auto& m) { return starts(d, n, m, sizeof m - 1); };  // a literal, NULs and all
  const uint32_t l32 = n >= 4 ? le32(d) : 0;
  // preinit's: BMP, JPEG, PNG and GIF are the port's own; DIB, PPM
  for (uint32_t k : {12u, 40u, 52u, 56u, 64u, 108u, 124u})
    if (n >= 4 && l32 == k) {
      Dib b;
      if (dib_header(d, n, 0, 0, b) && b.w > 0 && b.h > 0) return "DIB";
    }
  if (n >= 2 && d[0] == 'P' && memchr("0123456fy", d[1], 9)) {
    Pnm p;
    if (pnm_head(d, n, p)) return "PPM";
  }
  // init's, in Image.ID's order
  if (n >= 12 && !memcmp(d + 4, "ftyp", 4) &&
      (!memcmp(d + 8, "avif", 4) || !memcmp(d + 8, "avis", 4) || !memcmp(d + 8, "mif1", 4) ||
       !memcmp(d + 8, "msf1", 4)))
    return "AVIF";
  if (st("BLP1") || st("BLP2")) {
    Blp b;
    if (blp_open(d, n, b)) return "BLP";
  }
  if (st("BUFR") || st("ZCZC")) return "BUFR";
  if (st("\0\0\2\0")) {
    Dib b;
    int64_t rows;
    if (cur_open(d, n, b, rows)) return "CUR";
  }
  if (const int pcx = pcx_header(d, n)) {
    if (pcx < 0) corrupt("PCX of a mode PIL does not know (PIL refuses it)");
    return "PCX";
  }
  if (n >= 4 && l32 == 987654321) {
    const uint32_t at = dcx_page(d, n);
    if (at && at < n) {
      const int pcx = pcx_header(d + at, n - at);
      if (pcx < 0) corrupt("DCX of a PCX mode PIL does not know (PIL refuses it)");
      if (pcx) return "DCX";
    }
  }
  if (st("DDS ")) {
    Dds f;
    if (dds_open(d, n, f)) return "DDS";
  }
  if (st("%!PS") || l32 == 0xC6D3D0C5u) return "EPS";
  if (st("SIMPLE")) {
    Fits f;
    if (fits_open(d, n, f)) return "FITS";
  }
  {
    Fli f;
    if (fli_open(d, n, f)) return "FLI";
  }
  if (st("FTEX")) {
    Ftex f;
    if (ftex_open(d, n, f)) return "FTEX";
  }
  {
    Gbr f;
    if (gbr_open(d, n, f)) return "GBR";
  }
  if (n >= 8 && st("GRIB") && d[7] == 1) return "GRIB";
  if (st("\x89HDF\r\n\x1a\n")) return "HDF5";
  if (st("\xff\x4f\xff\x51") || starts(d, n, "\0\0\0\x0cjP  \r\n\x87\n", 12)) return "JPEG2000";
  if (st("icns")) return "ICNS";
  if (st("\0\0\1\0")) {
    Dib b;
    int64_t rows;
    size_t png_at;
    if (ico_open(d, n, b, rows, png_at)) return "ICO";
  }
  {
    ImHead m;
    if (im_open(d, n, m)) return "IM";
  }
  {
    Imt f;
    if (imt_open(d, n, f)) return "IMT";
  }
  {
    Iptc f;
    if (iptc_open(d, n, f)) return "IPTC";
  }
  {
    McIdas f;
    if (mcidas_open(d, n, f)) return "MCIDAS";
  }
  if (n >= 7 && st("\0\0\1\xb3") && (d[4] << 4 | d[5] >> 4) && ((d[5] & 15) << 8 | d[6])) return "MPEG";
  if ((st("DanM") || st("LinS")) && n >= 32) {
    uint32_t x = 0;
    for (int i = 0; i < 32; i += 2) x ^= le16(d + i);
    if (!x && le16(d + 4) && le16(d + 6)) return "MSP";
  }
  if (n >= 2048 + 1539 && !memcmp(d + 2048, "PCD_", 4)) return "PCD";
  {
    int64_t w, h;
    if (pixar_open(d, n, w, h)) return "PIXAR";
  }
  if (st("8BPS") && n >= 26 && be16(d + 4) == 1) {
    static const int kModes[][3] = {{0, 1, 1}, {0, 8, 1}, {1, 8, 1}, {2, 8, 1}, {3, 8, 3},
                                    {4, 8, 4}, {7, 8, 1}, {8, 8, 1}, {9, 8, 3}};  // mode, bits, channels
    for (const auto& m : kModes)
      if ((int)be16(d + 24) == m[0] && (int)be16(d + 22) == m[1]) {
        if (m[2] > (int)be16(d + 12)) corrupt("PSD of fewer channels than its mode (PIL refuses it)");
        if (be32(d + 18) && be32(d + 14)) return "PSD";
      }
  }
  if (st("qoif") && n >= 13 && be32(d + 4) && be32(d + 8)) return "QOI";
  if (n >= 12 && be16(d) == 474) {
    static const int kModes[][3] = {{1, 1, 1}, {1, 2, 1}, {2, 1, 1}, {2, 2, 1},
                                    {1, 3, 3}, {2, 3, 3}, {1, 3, 4}, {2, 3, 4}};  // bpc, dimension, zsize
    bool mode = false;
    for (const auto& m : kModes) mode = mode || (d[3] == m[0] && (int)be16(d + 4) == m[1] && (int)be16(d + 10) == m[2]);
    if (!mode) corrupt("SGI of a mode PIL does not know (PIL refuses it)");
    if (be16(d + 6) && be16(d + 8)) return "SGI";
  }
  {
    Spider f;
    if (spider_open(d, n, f)) return "SPIDER";
  }
  if (n >= 32 && be32(d) == 0x59A66A95u) {
    const uint32_t depth = be32(d + 12), type = be32(d + 20), ptype = be32(d + 24), plen = be32(d + 28);
    if ((depth == 1 || depth == 4 || depth == 8 || depth == 24 || depth == 32) &&
        (!plen || (plen <= 1024 && ptype == 1)) && type <= 5 && be32(d + 4) && be32(d + 8))
      return "SUN";
  }
  if (n >= 18) {  // TgaImagePlugin
    const int cmt = d[1], type = d[2], depth = d[16];
    if ((cmt == 0 || cmt == 1) && le16(d + 12) && le16(d + 14) &&
        (depth == 1 || depth == 8 || depth == 16 || depth == 24 || depth == 32) &&
        (type == 1 || type == 2 || type == 3 || type == 9 || type == 10 || type == 11) &&
        (!cmt || d[7] == 16 || d[7] == 24 || d[7] == 32))
      return "TGA";
  }
  if (n >= 16 && st("RIFF") && !memcmp(d + 8, "WEBP", 4) &&
      (!memcmp(d + 12, "VP8 ", 4) || !memcmp(d + 12, "VP8L", 4) || !memcmp(d + 12, "VP8X", 4)))
    return "WebP";
  if (st("\xd7\xcd\xc6\x9a\0\0") && n >= 16) {
    if (!le16(d + 14)) corrupt("WMF of inch 0 (PIL refuses it)");
    if (n >= 26 && !memcmp(d + 22, "\x01\0\t\0", 4)) return "WMF";
  }
  if (st("\x01\0\0\0") && n >= 44 && !memcmp(d + 40, " EMF", 4)) return "WMF";
  {
    int64_t w = 0, h = 0;
    size_t at;
    if (xbm_open(d, n, w, h, at) && w > 0 && h > 0) return "XBM";
  }
  if (st("/* XPM */")) {
    int64_t v[4];
    size_t at;
    if (xpm_open(d, n, v, at)) return "XPM";
  }
  if (st("P7 332")) return "XVThumb";
  return "";
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
  return 0;
}

// Every other file: the format PIL opens it as (C.21).
Gray decode_other(const uint8_t* d, size_t n) {
  const std::string f = pil_format(d, n);
  if (f.empty()) corrupt("not a recognised image file");
  if (f == "PPM") {
    Pnm p;
    pnm_head(d, n, p);
    return decode_pnm(d, n, p);
  }
  if (f == "WebP") {
    Gray g;
    std::string msg;
    if (sigwebp::decode(d, n, kMaxPixels, g.px, g.w, g.h, msg)) corrupt(msg);
    return g;
  }
  Dib b;
  int64_t rows;
  if (f == "DIB") {
    dib_header(d, n, 0, 0, b);
    check_size(b.w, b.h);
    return dib_pixels(d, n, b, b.h, true);
  }
  if (f == "CUR") {
    cur_open(d, n, b, rows);
    check_size(b.w, rows);
    return dib_pixels(d, n, b, rows, true);
  }
  if (f == "ICO") {  // an icon's DIB comes through PIL's decoder, never mapped
    Gray g;
    size_t png_at = 0;
    if (ico_open(d, n, b, rows, png_at) == 2) {
      g.png_at = (int64_t)png_at;
      return g;
    }
    return dib_pixels(d, n, b, rows, false);
  }
  if (f == "TGA") return decode_tga(d, n);
  if (f == "PCX") return decode_pcx(d, n, 0);
  if (f == "DCX") return decode_pcx(d, n, dcx_page(d, n));
  if (f == "SGI") return decode_sgi(d, n);
  if (f == "SUN") return decode_sun(d, n);
  if (f == "MSP") return decode_msp(d, n);
  if (f == "QOI") return decode_qoi(d, n);
  if (f == "IM") return decode_im(d, n);
  if (f == "PSD") return decode_psd(d, n);
  if (f == "XBM") return decode_xbm(d, n);
  if (f == "XPM") return decode_xpm(d, n);
  if (f == "XVThumb") return decode_xvthumb(d, n);
  if (f == "DDS") return decode_dds(d, n);
  if (f == "FTEX") return decode_ftex(d, n);
  if (f == "BLP") return decode_blp(d, n);
  if (f == "SPIDER") return decode_spider(d, n);
  if (f == "PIXAR") return decode_pixar(d, n);
  if (f == "GBR") return decode_gbr(d, n);
  if (f == "MCIDAS") return decode_mcidas(d, n);
  if (f == "IMT") return decode_imt(d, n);
  if (f == "FITS") return decode_fits(d, n);
  if (f == "IPTC") return decode_iptc(d, n);
  if (f == "FLI") return decode_fli(d, n);
  if (f == "PCD") return decode_pcd(d, n);
  if (f == "BUFR" || f == "GRIB" || f == "HDF5" || f == "WMF" || f == "MPEG")
    corrupt(f + " file, which PIL opens and has no decoder for");
  if (f == "EPS") corrupt("EPS file, which PIL reads through Ghostscript alone");
  unsupported(f + " image (PIL's " + f + " plugin opens the file, whatever its name)");
}

int decode_any(const uint8_t* d, size_t n, Gray& g, std::string& msg) {
  try {
    switch (format_of(d, n)) {
      case 'P': g.png_at = 0; return kPng;
      case 'J': g = decode_jpeg(d, n); break;
      case 'B': g = decode_bmp(d, n); break;
      case 'T': g = decode_tiff(d, n); break;
      case 'G': g = decode_gif(d, n); break;
      default: g = decode_other(d, n);
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
  return g.png_at >= 0 ? kPng : g.indices ? kIndices : kOk;
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
  if (status == kPng) *w = (int)g->png_at;  // where the PNG stream starts
  if (status != kOk && status != kIndices) return status;
  *out = (uint8_t*)malloc(g->px.size());
  if (!*out) return kCorrupt;
  memcpy(*out, g->px.data(), g->px.size());
  *w = g->w;
  *h = g->h;
  return status;
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
