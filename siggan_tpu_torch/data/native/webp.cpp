// WebP to 8-bit grey, as PIL's Image.open(path).convert("L") gives it, with
// no imaging library: the port's own reading of the format, rule for rule as
// libwebp 1.6 reads it for Pillow 12 (WebPAnimDecoder over the demuxer).
//
// Container: first the decoder's header check of the whole file, which
// WebPAnimDecoderNew asks before anything else (webp_dec.c: a VP8X chunk
// of exactly 10 bytes, a still image the canvas's size); then demux.c:
// the RIFF size against the file (a file shorter than
// it is refused, bytes after it are not read), chunk sizes padded to even,
// the simple forms 'VP8 ' and 'VP8L', and 'VP8X' with its flags, canvas,
// ICCP/EXIF/XMP and unknown chunks, ALPH before 'VP8 ', and ANIM/ANMF (the
// first frame only, at its offsets on a zeroed canvas). The frame's bytes
// then go through the decoder's own header checks (webp_dec.c).
//
// VP8L (vp8l_dec.c, huffman_utils.c, lossless.c): the four transforms
// (predictor modes 0-13, 14 and 15 black; cross-colour; subtract green;
// colour indexing with pixels bundled at 1, 2 and 4 bits), the colour
// cache, the meta Huffman image, prefix codes (the simple form, the code-
// length code, a one-symbol code that reads no bits), LZ77 with the 120-
// entry distance map, and the bit reader's end of data, each as libwebp
// checks it: a stream that reads past its end is refused.
//
// VP8 (RFC 6386 as vp8_dec.c, tree_dec.c, quant_dec.c, frame_dec.c read it):
// key frames, the boolean decoder and its end-of-data flag (a macroblock
// whose tokens read past their partition is refused: libwebp's "premature
// end-of-file"), segments, quantiser deltas, 1-8 token partitions,
// coefficient probability updates, skip, every intra mode with libwebp's
// borders (127 above, 129 left), dequantisation, the inverse WHT, the
// inverse DCT in SSE2's 16-bit lanes where libwebp's x86-64 build runs it
// (Transform_SSE2; its AC3 and DC shortcuts in C), the normal and simple
// loop filters (a frame of level 0 is not filtered, whatever its segments
// say), then libwebp's fancy upsampler and 14-bit fixed-point YUV->RGB.
// An ALPH chunk (methods 0 and 1, filters 0-3) never changes the grey, but
// libwebp decodes it and refuses the frame where it fails, so it is
// decoded for that alone.
//
// Then L = (19595 R + 38470 G + 7471 B + 2^15) >> 16 on the RGBA canvas.
// No state is shared between calls: the tables are const.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace sigwebp {
// 0: grey in gray (w x h); 1: corrupt (PIL refuses the file), msg says why.
int decode(const uint8_t* data, size_t size, int64_t max_pixels, std::vector<uint8_t>& gray, int& w,
           int& h, std::string& msg);
}  // namespace sigwebp

namespace {

struct Refused {
  std::string msg;
};

[[noreturn]] void refuse(const std::string& m) { throw Refused{m}; }

inline uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t le24(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }
inline uint32_t le32(const uint8_t* p) { return le24(p) | ((uint32_t)p[3] << 24); }

inline uint8_t luma(int r, int g, int b) {
  return (uint8_t)((19595 * r + 38470 * g + 7471 * b + 0x8000) >> 16);
}

constexpr uint32_t kMaxChunkPayload = ~0U - 8 - 1;
// VP8X flags: alpha, animation; ICC 0x20, EXIF 0x08 and XMP 0x04 make up the rest
constexpr uint32_t kAlphaFlag = 0x10, kAnimFlag = 0x02, kAllFlags = 0x3E;

// ------------------------------------------------------------------ tables

const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};
const uint8_t kCoeffsProba0[4][8][3][11] = {
    {
        {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
         {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
         {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
        {{253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128},
         {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128},
         {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
        {{1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128},
         {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128},
         {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
        {{1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128},
         {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128},
         {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
        {{1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128},
         {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128},
         {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
        {{1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128},
         {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128},
         {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
        {{1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128},
         {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128},
         {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
        {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
         {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
         {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
    },
    {
        {{198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62},
         {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1},
         {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
        {{1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128},
         {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128},
         {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
        {{1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128},
         {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128},
         {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
        {{1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128},
         {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128},
         {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
        {{1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128},
         {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128},
         {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
        {{1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128},
         {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128},
         {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
        {{1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128},
         {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128},
         {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
        {{1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128},
         {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128},
         {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}},
    },
    {
        {{253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128},
         {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128},
         {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
        {{1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128},
         {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128},
         {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
        {{1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128},
         {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128},
         {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
        {{1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128},
         {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128},
         {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
        {{1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128},
         {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128},
         {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
        {{1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128},
         {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128},
         {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
        {{1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128},
         {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128},
         {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
        {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
         {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
         {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
    },
    {
        {{202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255},
         {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128},
         {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
        {{1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128},
         {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128},
         {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
        {{1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128},
         {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128},
         {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
        {{1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128},
         {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128},
         {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
        {{1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128},
         {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128},
         {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
        {{1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128},
         {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128},
         {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
        {{1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128},
         {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128},
         {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
        {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
         {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
         {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    },
};
const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    {
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255},
         {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255},
         {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255},
         {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255},
         {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    },
    {
        {{217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255},
         {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
        {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
         {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    },
    {
        {{186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255},
         {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255},
         {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
        {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    },
    {
        {{248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255},
         {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
         {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
         {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
        {{255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255},
         {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
         {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255},
         {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255},
         {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
         {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    },
};
const uint8_t kBModesProba[10][10][9] = {
    {{231, 120, 48, 89, 115, 113, 120, 152, 112},
     {152, 179, 64, 126, 170, 118, 46, 70, 95},
     {175, 69, 143, 80, 85, 82, 72, 155, 103},
     {56, 58, 10, 171, 218, 189, 17, 13, 152},
     {114, 26, 17, 163, 44, 195, 21, 10, 173},
     {121, 24, 80, 195, 26, 62, 44, 64, 85},
     {144, 71, 10, 38, 171, 213, 144, 34, 26},
     {170, 46, 55, 19, 136, 160, 33, 206, 71},
     {63, 20, 8, 114, 114, 208, 12, 9, 226},
     {81, 40, 11, 96, 182, 84, 29, 16, 36}},
    {{134, 183, 89, 137, 98, 101, 106, 165, 148},
     {72, 187, 100, 130, 157, 111, 32, 75, 80},
     {66, 102, 167, 99, 74, 62, 40, 234, 128},
     {41, 53, 9, 178, 241, 141, 26, 8, 107},
     {74, 43, 26, 146, 73, 166, 49, 23, 157},
     {65, 38, 105, 160, 51, 52, 31, 115, 128},
     {104, 79, 12, 27, 217, 255, 87, 17, 7},
     {87, 68, 71, 44, 114, 51, 15, 186, 23},
     {47, 41, 14, 110, 182, 183, 21, 17, 194},
     {66, 45, 25, 102, 197, 189, 23, 18, 22}},
    {{88, 88, 147, 150, 42, 46, 45, 196, 205},
     {43, 97, 183, 117, 85, 38, 35, 179, 61},
     {39, 53, 200, 87, 26, 21, 43, 232, 171},
     {56, 34, 51, 104, 114, 102, 29, 93, 77},
     {39, 28, 85, 171, 58, 165, 90, 98, 64},
     {34, 22, 116, 206, 23, 34, 43, 166, 73},
     {107, 54, 32, 26, 51, 1, 81, 43, 31},
     {68, 25, 106, 22, 64, 171, 36, 225, 114},
     {34, 19, 21, 102, 132, 188, 16, 76, 124},
     {62, 18, 78, 95, 85, 57, 50, 48, 51}},
    {{193, 101, 35, 159, 215, 111, 89, 46, 111},
     {60, 148, 31, 172, 219, 228, 21, 18, 111},
     {112, 113, 77, 85, 179, 255, 38, 120, 114},
     {40, 42, 1, 196, 245, 209, 10, 25, 109},
     {88, 43, 29, 140, 166, 213, 37, 43, 154},
     {61, 63, 30, 155, 67, 45, 68, 1, 209},
     {100, 80, 8, 43, 154, 1, 51, 26, 71},
     {142, 78, 78, 16, 255, 128, 34, 197, 171},
     {41, 40, 5, 102, 211, 183, 4, 1, 221},
     {51, 50, 17, 168, 209, 192, 23, 25, 82}},
    {{138, 31, 36, 171, 27, 166, 38, 44, 229},
     {67, 87, 58, 169, 82, 115, 26, 59, 179},
     {63, 59, 90, 180, 59, 166, 93, 73, 154},
     {40, 40, 21, 116, 143, 209, 34, 39, 175},
     {47, 15, 16, 183, 34, 223, 49, 45, 183},
     {46, 17, 33, 183, 6, 98, 15, 32, 183},
     {57, 46, 22, 24, 128, 1, 54, 17, 37},
     {65, 32, 73, 115, 28, 128, 23, 128, 205},
     {40, 3, 9, 115, 51, 192, 18, 6, 223},
     {87, 37, 9, 115, 59, 77, 64, 21, 47}},
    {{104, 55, 44, 218, 9, 54, 53, 130, 226},
     {64, 90, 70, 205, 40, 41, 23, 26, 57},
     {54, 57, 112, 184, 5, 41, 38, 166, 213},
     {30, 34, 26, 133, 152, 116, 10, 32, 134},
     {39, 19, 53, 221, 26, 114, 32, 73, 255},
     {31, 9, 65, 234, 2, 15, 1, 118, 73},
     {75, 32, 12, 51, 192, 255, 160, 43, 51},
     {88, 31, 35, 67, 102, 85, 55, 186, 85},
     {56, 21, 23, 111, 59, 205, 45, 37, 192},
     {55, 38, 70, 124, 73, 102, 1, 34, 98}},
    {{125, 98, 42, 88, 104, 85, 117, 175, 82},
     {95, 84, 53, 89, 128, 100, 113, 101, 45},
     {75, 79, 123, 47, 51, 128, 81, 171, 1},
     {57, 17, 5, 71, 102, 57, 53, 41, 49},
     {38, 33, 13, 121, 57, 73, 26, 1, 85},
     {41, 10, 67, 138, 77, 110, 90, 47, 114},
     {115, 21, 2, 10, 102, 255, 166, 23, 6},
     {101, 29, 16, 10, 85, 128, 101, 196, 26},
     {57, 18, 10, 102, 102, 213, 34, 20, 43},
     {117, 20, 15, 36, 163, 128, 68, 1, 26}},
    {{102, 61, 71, 37, 34, 53, 31, 243, 192},
     {69, 60, 71, 38, 73, 119, 28, 222, 37},
     {68, 45, 128, 34, 1, 47, 11, 245, 171},
     {62, 17, 19, 70, 146, 85, 55, 62, 70},
     {37, 43, 37, 154, 100, 163, 85, 160, 1},
     {63, 9, 92, 136, 28, 64, 32, 201, 85},
     {75, 15, 9, 9, 64, 255, 184, 119, 16},
     {86, 6, 28, 5, 64, 255, 25, 248, 1},
     {56, 8, 17, 132, 137, 255, 55, 116, 128},
     {58, 15, 20, 82, 135, 57, 26, 121, 40}},
    {{164, 50, 31, 137, 154, 133, 25, 35, 218},
     {51, 103, 44, 131, 131, 123, 31, 6, 158},
     {86, 40, 64, 135, 148, 224, 45, 183, 128},
     {22, 26, 17, 131, 240, 154, 14, 1, 209},
     {45, 16, 21, 91, 64, 222, 7, 1, 197},
     {56, 21, 39, 155, 60, 138, 23, 102, 213},
     {83, 12, 13, 54, 192, 255, 68, 47, 28},
     {85, 26, 85, 85, 128, 128, 32, 146, 171},
     {18, 11, 7, 63, 144, 171, 4, 4, 246},
     {35, 27, 10, 146, 174, 171, 12, 26, 128}},
    {{190, 80, 35, 99, 180, 80, 126, 54, 45},
     {85, 126, 47, 87, 176, 51, 41, 20, 32},
     {101, 75, 128, 139, 118, 146, 116, 128, 85},
     {56, 41, 15, 176, 236, 85, 37, 9, 62},
     {71, 30, 17, 119, 118, 255, 17, 18, 138},
     {101, 38, 60, 138, 55, 70, 43, 26, 142},
     {146, 36, 19, 30, 171, 255, 97, 27, 20},
     {138, 45, 61, 62, 219, 1, 81, 188, 64},
     {32, 41, 20, 117, 151, 142, 20, 21, 163},
     {112, 19, 12, 61, 195, 128, 48, 4, 24}},
};
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55,
    57, 21, 27, 54, 58, 37, 43, 72, 4, 71, 73, 20, 28, 53, 59,
    70, 74, 36, 44, 88, 69, 75, 52, 60, 3, 87, 89, 19, 29, 86,
    90, 35, 45, 68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62, 120, 1, 119,
    121, 83, 93, 17, 31, 100, 108, 66, 78, 118, 122, 33, 47, 117, 123,
    49, 63, 99, 109, 82, 94, 0, 116, 124, 65, 79, 16, 32, 98, 110,
    48, 115, 125, 81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[16 + 1] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};
const uint8_t kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

// ------------------------------------------------------------------- VP8L

// VP8LBitReader: a 64-bit window, refilled byte by byte (4 bytes at a time
// while 8 or more remain); the end of data is reading past the last byte
// (for a stream under 8 bytes, past the window's 64 bits).
struct LBits {
  uint64_t val = 0;
  const uint8_t* buf = nullptr;
  size_t len = 0, pos = 0;
  int bit_pos = 0, eos = 0;

  void init(const uint8_t* s, size_t n) {
    len = n;
    val = 0;
    bit_pos = 0;
    eos = 0;
    const size_t k = std::min<size_t>(n, 8);
    for (size_t i = 0; i < k; ++i) val |= (uint64_t)s[i] << (8 * i);
    pos = k;
    buf = s;
  }
  bool at_end() const { return eos || (pos == len && bit_pos > 64); }
  void set_end() {
    eos = 1;
    bit_pos = 0;
  }
  void shift_bytes() {
    while (bit_pos >= 8 && pos < len) {
      val = (val >> 8) | ((uint64_t)buf[pos++] << 56);
      bit_pos -= 8;
    }
    if (at_end()) set_end();
  }
  uint32_t prefetch() const { return (uint32_t)(val >> (bit_pos & 63)); }
  uint32_t read(int n) {
    if (!eos && n <= 24) {
      const uint32_t v = prefetch() & ((1u << n) - 1);
      bit_pos += n;
      shift_bytes();
      return v;
    }
    set_end();
    return 0;
  }
  void fill() {
    if (bit_pos < 32) return;
    if (pos + 8 < len) {
      val = (val >> 32) | ((uint64_t)le32(buf + pos) << 32);
      bit_pos -= 32;
      pos += 4;
      return;
    }
    shift_bytes();
  }
};

struct HCode {
  uint8_t bits;
  uint16_t value;
};

constexpr int kMaxCodeLength = 15;

inline uint32_t next_key(uint32_t key, int len) {
  uint32_t step = 1u << (len - 1);
  while (key & step) step >>= 1;
  return step ? (key & (step - 1)) + step : key;
}

inline void replicate(HCode* table, int step, int end, HCode code) {
  do {
    end -= step;
    table[end] = code;
  } while (end > 0);
}

inline int next_table_bits(const int* count, int len, int root_bits) {
  int left = 1 << (len - root_bits);
  while (len < kMaxCodeLength) {
    left -= count[len];
    if (left <= 0) break;
    ++len;
    left <<= 1;
  }
  return len - root_bits;
}

// huffman_utils.c's BuildHuffmanTable: the size of the root table of
// root_bits and its second-level tables, or 0 when the lengths make no
// complete code and more than one symbol; root == nullptr only sizes it.
int build_huffman(HCode* root, int root_bits, const int* lengths, int n) {
  int count[kMaxCodeLength + 1] = {0}, offset[kMaxCodeLength + 1];
  for (int s = 0; s < n; ++s) {
    if (lengths[s] > kMaxCodeLength) return 0;
    ++count[lengths[s]];
  }
  if (count[0] == n) return 0;
  offset[1] = 0;
  for (int len = 1; len < kMaxCodeLength; ++len) {
    if (count[len] > (1 << len)) return 0;
    offset[len + 1] = offset[len] + count[len];
  }
  std::vector<uint16_t> sorted(root ? n : 0);
  for (int s = 0; s < n; ++s)
    if (lengths[s] > 0) {
      if (root)
        sorted[offset[lengths[s]]++] = (uint16_t)s;
      else
        offset[lengths[s]]++;
    }
  int total = 1 << root_bits;
  if (offset[kMaxCodeLength] == 1) {
    if (root) replicate(root, 1, total, HCode{0, sorted[0]});
    return total;
  }
  HCode* table = root;
  int symbol = 0, num_nodes = 1, num_open = 1, table_bits = root_bits, table_size = 1 << root_bits;
  uint32_t low = 0xffffffffu, key = 0;
  const uint32_t mask = total - 1;
  int len, step;
  for (len = 1, step = 2; len <= root_bits; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return 0;
    if (!root) continue;
    for (; count[len] > 0; --count[len]) {
      replicate(&table[key], step, table_size, HCode{(uint8_t)len, sorted[symbol++]});
      key = next_key(key, len);
    }
  }
  for (len = root_bits + 1, step = 2; len <= kMaxCodeLength; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return 0;
    for (; count[len] > 0; --count[len]) {
      if ((key & mask) != low) {
        if (root) table += table_size;
        table_bits = next_table_bits(count, len, root_bits);
        table_size = 1 << table_bits;
        total += table_size;
        low = key & mask;
        if (root) {
          root[low].bits = (uint8_t)(table_bits + root_bits);
          root[low].value = (uint16_t)((table - root) - low);
        }
      }
      if (root)
        replicate(&table[key >> root_bits], step, table_size,
                  HCode{(uint8_t)(len - root_bits), sorted[symbol++]});
      key = next_key(key, len);
    }
  }
  if (num_nodes != 2 * offset[kMaxCodeLength] - 1) return 0;
  return total;
}

inline int read_symbol(const HCode* table, LBits& br) {
  uint32_t val = br.prefetch();
  table += val & 0xff;
  const int nbits = table->bits - 8;
  if (nbits > 0) {
    br.bit_pos += 8;
    val = br.prefetch();
    table += table->value;
    table += val & ((1u << nbits) - 1);
  }
  br.bit_pos += table->bits;
  return table->value;
}

enum { GREEN = 0, RED = 1, BLUE = 2, ALPHA = 3, DIST = 4 };
constexpr int kNumLiteral = 256, kNumLength = 24, kNumDistance = 40, kMaxCacheBits = 11;
const int kAlphabetSize[5] = {kNumLiteral + kNumLength, kNumLiteral, kNumLiteral, kNumLiteral,
                              kNumDistance};

struct HGroup {
  size_t trees[5];
  bool trivial_literal = false, trivial_code = false;
  uint32_t literal_arb = 0;
};

// What one image stream of a VP8L file decodes with (VP8LMetadata).
struct LMeta {
  int cache_bits = 0;
  std::vector<uint32_t> cache;
  int huffman_bits = 0, huffman_xsize = 0, huffman_mask = ~0;
  std::vector<uint32_t> huffman_image;
  std::vector<HGroup> groups;
  std::vector<HCode> tables;

  const HGroup& group_at(int x, int y) const {
    if (huffman_bits == 0) return groups[0];
    return groups[huffman_image[(size_t)huffman_xsize * (y >> huffman_bits) + (x >> huffman_bits)]];
  }
  void cache_insert(uint32_t argb) { cache[(0x1e35a7bdu * argb) >> (32 - cache_bits)] = argb; }
};

enum { PREDICTOR = 0, CROSS_COLOR = 1, SUBTRACT_GREEN = 2, COLOR_INDEXING = 3 };

struct LTransform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

struct Lossless {
  LBits br;
  LTransform transforms[4];
  int next_transform = 0;
  uint32_t seen = 0;

  // ReadHuffmanCodeLengths
  void code_lengths(const int* cl_lengths, int num_symbols, int* lengths) {
    HCode table[1 << 7];
    if (!build_huffman(table, 7, cl_lengths, 19)) refuse("VP8L code-length code is not a prefix code");
    int max_symbol = num_symbols;
    if (br.read(1)) {
      const int length_nbits = 2 + 2 * (int)br.read(3);
      max_symbol = 2 + (int)br.read(length_nbits);
      if (max_symbol > num_symbols) refuse("VP8L code lengths past the alphabet");
    }
    int symbol = 0, prev = 8;
    while (symbol < num_symbols) {
      if (max_symbol-- == 0) break;
      br.fill();
      const HCode& p = table[br.prefetch() & 127];
      br.bit_pos += p.bits;
      const int code_len = p.value;
      if (code_len < 16) {
        lengths[symbol++] = code_len;
        if (code_len) prev = code_len;
      } else {
        static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
        const int slot = code_len - 16;
        int repeat = (int)br.read(kExtra[slot]) + kOffset[slot];
        if (symbol + repeat > num_symbols) refuse("VP8L code-length repeat past the alphabet");
        const int length = code_len == 16 ? prev : 0;
        while (repeat-- > 0) lengths[symbol++] = length;
      }
    }
  }

  // ReadHuffmanCode: the code's table appended to tables (none when
  // tables is null); returns its size.
  int huffman_code(int alphabet, std::vector<int>& lengths, std::vector<HCode>* tables) {
    std::fill(lengths.begin(), lengths.begin() + alphabet, 0);
    if (br.read(1)) {  // simple: one or two symbols of 1 or 8 bits
      const int num_symbols = (int)br.read(1) + 1;
      const int first_bits = br.read(1) ? 8 : 1;
      lengths[br.read(first_bits)] = 1;
      if (num_symbols == 2) lengths[br.read(8)] = 1;
    } else {
      int cl[19] = {0};
      const int num_codes = (int)br.read(4) + 4;
      for (int i = 0; i < num_codes; ++i) cl[kCodeLengthCodeOrder[i]] = (int)br.read(3);
      code_lengths(cl, alphabet, lengths.data());
    }
    const int size = br.eos ? 0 : build_huffman(nullptr, 8, lengths.data(), alphabet);
    if (!size) refuse("VP8L Huffman code is not a prefix code, or the data ends");
    if (tables) {
      const size_t at = tables->size();
      tables->resize(at + size);
      build_huffman(tables->data() + at, 8, lengths.data(), alphabet);
    }
    return size;
  }

  // ReadHuffmanCodes (with ReadHuffmanCodesHelper)
  void huffman_codes(LMeta& hdr, int xsize, int ysize, int cache_bits, bool level0) {
    int num_groups = 1, num_groups_max = 1;
    std::vector<int> mapping;
    if (level0 && br.read(1)) {
      const int bits = 2 + (int)br.read(3);
      const int hx = subsample(xsize, bits), hy = subsample(ysize, bits);
      sub_image(hx, hy, &hdr.huffman_image);
      hdr.huffman_bits = bits;
      for (uint32_t& g : hdr.huffman_image) {
        g = (g >> 8) & 0xffff;
        num_groups_max = std::max(num_groups_max, (int)g + 1);
      }
      if (num_groups_max > 1000 || num_groups_max > xsize * ysize) {
        mapping.assign(num_groups_max, -1);
        num_groups = 0;
        for (uint32_t& g : hdr.huffman_image) {
          if (mapping[g] == -1) mapping[g] = num_groups++;
          g = mapping[g];
        }
      } else {
        num_groups = num_groups_max;
      }
    }
    if (br.eos) refuse("VP8L data ends in the meta Huffman image");
    std::vector<int> lengths(kAlphabetSize[0] + (cache_bits ? 1 << cache_bits : 0));
    hdr.groups.assign(num_groups, HGroup());
    for (int i = 0; i < num_groups_max; ++i) {
      if (!mapping.empty() && mapping[i] == -1) {  // unused: checked, not kept
        for (int j = 0; j < 5; ++j)
          huffman_code(kAlphabetSize[j] + (j == 0 && cache_bits ? 1 << cache_bits : 0), lengths,
                       nullptr);
        continue;
      }
      HGroup& g = hdr.groups[mapping.empty() ? i : mapping[i]];
      int total_bits = 0;
      bool trivial_literal = true;
      for (int j = 0; j < 5; ++j) {
        const int alphabet = kAlphabetSize[j] + (j == 0 && cache_bits ? 1 << cache_bits : 0);
        g.trees[j] = hdr.tables.size();
        huffman_code(alphabet, lengths, &hdr.tables);
        const HCode& first = hdr.tables[g.trees[j]];
        if (trivial_literal && (j == RED || j == BLUE || j == ALPHA)) trivial_literal = first.bits == 0;
        total_bits += first.bits;
      }
      g.trivial_literal = trivial_literal;
      g.trivial_code = false;
      if (trivial_literal) {
        const int red = hdr.tables[g.trees[RED]].value, blue = hdr.tables[g.trees[BLUE]].value,
                  alpha = hdr.tables[g.trees[ALPHA]].value;
        g.literal_arb = ((uint32_t)alpha << 24) | (red << 16) | blue;
        const int green = hdr.tables[g.trees[GREEN]].value;
        if (total_bits == 0 && green < kNumLiteral) {
          g.trivial_code = true;
          g.literal_arb |= green << 8;
        }
      }
    }
  }

  void transform(int& xsize, int ysize) {
    const int type = (int)br.read(2);
    if (seen & (1u << type)) refuse("VP8L transform given twice");
    seen |= 1u << type;
    LTransform& t = transforms[next_transform++];
    t.type = type;
    t.xsize = xsize;
    t.ysize = ysize;
    if (type == PREDICTOR || type == CROSS_COLOR) {
      t.bits = (int)br.read(3) + 2;
      sub_image(subsample(t.xsize, t.bits), subsample(t.ysize, t.bits), &t.data);
    } else if (type == COLOR_INDEXING) {
      const int num_colors = (int)br.read(8) + 1;
      t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
      xsize = subsample(t.xsize, t.bits);
      sub_image(num_colors, 1, &t.data);
      // the palette is delta-coded; entries past it are transparent black
      std::vector<uint32_t> map(1u << (8 >> t.bits), 0);
      map[0] = t.data[0];
      for (int i = 1; i < num_colors; ++i) {
        const uint32_t a = t.data[i], b = map[i - 1];
        map[i] = (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
                 (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
      }
      t.data.swap(map);
    }
  }

  // DecodeImageStream's colour cache and prefix codes (a meta Huffman image
  // at level 0 only).
  void codes(LMeta& hdr, int xsize, int ysize, bool level0) {
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = (int)br.read(4);
      if (cache_bits < 1 || cache_bits > kMaxCacheBits) refuse("VP8L colour cache of a bad size");
    }
    huffman_codes(hdr, xsize, ysize, cache_bits, level0);
    hdr.cache_bits = cache_bits;
    if (cache_bits) hdr.cache.assign(1u << cache_bits, 0);
    hdr.huffman_xsize = subsample(xsize, hdr.huffman_bits);
    hdr.huffman_mask = hdr.huffman_bits == 0 ? ~0 : (1 << hdr.huffman_bits) - 1;
  }

  // The level-0 stream's transforms and codes; returns the width its
  // pixels are coded at (a palette bundles them).
  int level0(LMeta& hdr, int w, int h) {
    int xsize = w;
    while (br.read(1)) transform(xsize, h);
    codes(hdr, xsize, h, true);
    return xsize;
  }

  // A sub-image (a transform's data, the meta Huffman image, a palette).
  void sub_image(int xsize, int ysize, std::vector<uint32_t>* out) {
    LMeta hdr;
    codes(hdr, xsize, ysize, false);
    out->assign((size_t)xsize * ysize, 0);
    if (!image_data(hdr, out->data(), xsize, ysize)) refuse("VP8L sub-image data is damaged or ends");
  }

  // DecodeImageData, not incremental: false on a bad copy or data that
  // reads past its end.
  bool image_data(LMeta& hdr, uint32_t* data, int width, int height) {
    int row = 0, col = 0;
    uint32_t *src = data, *last_cached = src;
    uint32_t* const src_end = data + (size_t)width * height;
    const int len_code_limit = kNumLiteral + kNumLength;
    const int cache_limit = len_code_limit + (hdr.cache_bits ? 1 << hdr.cache_bits : 0);
    const int mask = hdr.huffman_mask;
    const HGroup* g = src < src_end ? &hdr.group_at(col, row) : nullptr;
    const HCode* t = hdr.tables.data();
    while (src < src_end) {
      if ((col & mask) == 0) g = &hdr.group_at(col, row);
      int code;
      bool one = false;  // a pixel written: advance by one
      if (g->trivial_code) {
        *src = g->literal_arb;
        one = true;
      } else {
        br.fill();
        code = read_symbol(t + g->trees[GREEN], br);
        if (br.at_end()) break;
        if (code < kNumLiteral) {
          if (g->trivial_literal) {
            *src = g->literal_arb | (code << 8);
          } else {
            const int red = read_symbol(t + g->trees[RED], br);
            br.fill();
            const int blue = read_symbol(t + g->trees[BLUE], br);
            const int alpha = read_symbol(t + g->trees[ALPHA], br);
            if (br.at_end()) break;
            *src = ((uint32_t)alpha << 24) | (red << 16) | (code << 8) | blue;
          }
          one = true;
        } else if (code < len_code_limit) {
          const int length = copy_distance(code - kNumLiteral);
          const int dist_symbol = read_symbol(t + g->trees[DIST], br);
          br.fill();
          const int dist = plane_distance(width, copy_distance(dist_symbol));
          if (br.at_end()) break;
          if (src - data < (std::ptrdiff_t)dist || src_end - src < (std::ptrdiff_t)length) return false;
          for (int i = 0; i < length; ++i) src[i] = src[i - dist];
          src += length;
          col += length;
          while (col >= width) {
            col -= width;
            ++row;
          }
          if (col & mask) g = &hdr.group_at(col, row);
          if (hdr.cache_bits)
            while (last_cached < src) hdr.cache_insert(*last_cached++);
        } else if (code < cache_limit) {
          while (last_cached < src) hdr.cache_insert(*last_cached++);
          *src = hdr.cache[code - len_code_limit];
          one = true;
        } else {
          return false;
        }
      }
      if (one) {
        ++src;
        if (++col >= width) {
          col = 0;
          ++row;
          if (hdr.cache_bits)
            while (last_cached < src) hdr.cache_insert(*last_cached++);
        }
      }
    }
    br.eos = br.at_end();
    return !br.eos;
  }

  // DecodeAlphaData (the 8-bit route of an alpha plane whose one transform
  // is a palette): data that ends on the last pixel is not an error here.
  bool alpha_data(LMeta& hdr, uint8_t* data, int width, int height) {
    int row = 0, col = 0, pos = 0;
    const int end = width * height;
    const int mask = hdr.huffman_mask;
    const HCode* t = hdr.tables.data();
    const HGroup* g = &hdr.group_at(col, row);
    while (!br.eos && pos < end) {
      if ((col & mask) == 0) g = &hdr.group_at(col, row);
      br.fill();
      const int code = read_symbol(t + g->trees[GREEN], br);
      if (code < kNumLiteral) {
        data[pos++] = (uint8_t)code;
        if (++col >= width) {
          col = 0;
          ++row;
        }
      } else if (code < kNumLiteral + kNumLength) {
        const int length = copy_distance(code - kNumLiteral);
        const int dist_symbol = read_symbol(t + g->trees[DIST], br);
        br.fill();
        const int dist = plane_distance(width, copy_distance(dist_symbol));
        if (pos < dist || end - pos < length) return false;
        for (int i = 0; i < length; ++i) data[pos + i] = data[pos + i - dist];
        pos += length;
        col += length;
        while (col >= width) {
          col -= width;
          ++row;
        }
        if (pos < end && (col & mask)) g = &hdr.group_at(col, row);
      } else {
        return false;
      }
      br.eos = br.at_end();
    }
    br.eos = br.at_end();
    return !(br.eos && pos < end);
  }

  int copy_distance(int symbol) {
    if (symbol < 4) return symbol + 1;
    const int extra = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra;
    return offset + (int)br.read(extra) + 1;
  }

  static int plane_distance(int xsize, int code) {
    if (code > 120) return code - 120;
    const int d = kCodeToPlane[code - 1];
    const int dist = (d >> 4) * xsize + 8 - (d & 0xf);
    return dist >= 1 ? dist : 1;
  }
};

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
         (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }
inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }
inline int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }

uint32_t predict(int mode, uint32_t left, const uint32_t* top) {
  switch (mode) {
    case 1: return left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(left, top[1]), top[0]);
    case 6: return average2(left, top[-1]);
    case 7: return average2(left, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(left, top[-1]), average2(top[0], top[1]));
    case 11: {  // Select(top, left, top-left)
      const uint32_t a = top[0], b = left, c = top[-1];
      int s = 0;
      for (int sh = 0; sh < 32; sh += 8) s += sub3((a >> sh) & 0xff, (b >> sh) & 0xff, (c >> sh) & 0xff);
      return s <= 0 ? a : b;
    }
    case 12: {
      uint32_t out = 0;
      for (int sh = 0; sh < 32; sh += 8)
        out |= clip255((uint32_t)(((left >> sh) & 0xff) + ((top[0] >> sh) & 0xff) - ((top[-1] >> sh) & 0xff))) << sh;
      return out;
    }
    case 13: {
      const uint32_t ave = average2(left, top[0]);
      uint32_t out = 0;
      for (int sh = 0; sh < 32; sh += 8) {
        const int a = (ave >> sh) & 0xff, b = (top[-1] >> sh) & 0xff;
        out |= clip255((uint32_t)(a + (a - b) / 2)) << sh;
      }
      return out;
    }
    default: return 0xff000000u;  // 0, and the sentinels 14 and 15
  }
}

// The inverse transforms over a whole image, last one first (lossless.c).
void inverse_transforms(const Lossless& dec, std::vector<uint32_t>& px, int height) {
  for (int n = dec.next_transform - 1; n >= 0; --n) {
    const LTransform& t = dec.transforms[n];
    const int width = t.xsize;
    if (t.type == SUBTRACT_GREEN) {
      for (size_t i = 0; i < (size_t)width * height; ++i) {
        const uint32_t g = (px[i] >> 8) & 0xff, rb = (g << 16) | g;
        px[i] = (px[i] & 0xff00ff00u) | (((px[i] & 0x00ff00ffu) + rb) & 0x00ff00ffu);
      }
    } else if (t.type == PREDICTOR) {
      uint32_t* out = px.data();
      out[0] = add_pixels(out[0], 0xff000000u);
      for (int x = 1; x < width; ++x) out[x] = add_pixels(out[x], out[x - 1]);
      const int tiles = subsample(width, t.bits);
      for (int y = 1; y < height; ++y) {
        uint32_t* row = out + (size_t)y * width;
        const uint32_t* modes = t.data.data() + (size_t)(y >> t.bits) * tiles;
        row[0] = add_pixels(row[0], row[-width]);
        for (int x = 1; x < width; ++x) {
          const int mode = (modes[x >> t.bits] >> 8) & 0xf;
          row[x] = add_pixels(row[x], predict(mode, row[x - 1], row + x - width));
        }
      }
    } else if (t.type == CROSS_COLOR) {
      const int tiles = subsample(width, t.bits);
      for (int y = 0; y < height; ++y) {
        uint32_t* row = px.data() + (size_t)y * width;
        const uint32_t* codes = t.data.data() + (size_t)(y >> t.bits) * tiles;
        for (int x = 0; x < width; ++x) {
          const uint32_t c = codes[x >> t.bits];
          const int8_t g2r = (int8_t)(c & 0xff), g2b = (int8_t)((c >> 8) & 0xff), r2b = (int8_t)((c >> 16) & 0xff);
          const uint32_t argb = row[x];
          const int8_t green = (int8_t)(argb >> 8);
          int red = (argb >> 16) & 0xff, blue = argb & 0xff;
          red = (red + ((g2r * green) >> 5)) & 0xff;
          blue += (g2b * green) >> 5;
          blue = (blue + ((r2b * (int8_t)red) >> 5)) & 0xff;
          row[x] = (argb & 0xff00ff00u) | (red << 16) | blue;
        }
      }
    } else {  // colour indexing: the packed rows widen in place, from the end
      const int bits_per_pixel = 8 >> t.bits, count_mask = (1 << t.bits) - 1;
      const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
      const int packed = subsample(width, t.bits);
      std::vector<uint32_t> out((size_t)width * height);
      for (int y = 0; y < height; ++y) {
        const uint32_t* src = px.data() + (size_t)y * packed;
        uint32_t* dst = out.data() + (size_t)y * width;
        uint32_t bundle = 0;
        for (int x = 0; x < width; ++x) {
          if ((x & count_mask) == 0) bundle = (*src++ >> 8) & 0xff;
          dst[x] = t.data[bundle & bit_mask];
          bundle >>= bits_per_pixel;
        }
      }
      px.swap(out);
    }
  }
}

// VP8LGetInfo: the 5-byte header (0x2f, 14-bit width - 1 and height - 1,
// the alpha hint, 3 version bits of 0).
bool vp8l_info(const uint8_t* d, size_t n, int& w, int& h, int& alpha) {
  if (n < 5 || d[0] != 0x2f || (d[4] >> 5) != 0) return false;
  LBits br;
  br.init(d, n);
  if (br.read(8) != 0x2f) return false;
  w = (int)br.read(14) + 1;
  h = (int)br.read(14) + 1;
  alpha = (int)br.read(1);
  if (br.read(3) != 0) return false;
  return !br.eos;
}

// A VP8L image's ARGB pixels (w x h, known from vp8l_info).
std::vector<uint32_t> decode_vp8l(const uint8_t* d, size_t n) {
  Lossless dec;
  dec.br.init(d, n);
  int w, h, alpha;
  if (dec.br.read(8) != 0x2f) refuse("VP8L signature");
  w = (int)dec.br.read(14) + 1;
  h = (int)dec.br.read(14) + 1;
  alpha = (int)dec.br.read(1);
  (void)alpha;
  if (dec.br.read(3) != 0 || dec.br.eos) refuse("VP8L header");
  LMeta hdr;
  const int xsize = dec.level0(hdr, w, h);
  std::vector<uint32_t> px((size_t)xsize * h);
  if (!dec.image_data(hdr, px.data(), xsize, h)) refuse("VP8L image data is damaged or ends early");
  inverse_transforms(dec, px, h);
  return px;
}

// An ALPH chunk of method 1: a VP8L stream with no header, its alpha in the
// green channel; decoded only for whether libwebp takes it.
bool vp8l_alpha_ok(const uint8_t* d, size_t n, int w, int h) {
  try {
    Lossless dec;
    dec.br.init(d, n);
    LMeta hdr;
    const int xsize = dec.level0(hdr, w, h);
    bool small = dec.next_transform == 1 && dec.transforms[0].type == COLOR_INDEXING && !hdr.cache_bits;
    for (const HGroup& g : hdr.groups)
      small = small && !hdr.tables[g.trees[RED]].bits && !hdr.tables[g.trees[BLUE]].bits &&
              !hdr.tables[g.trees[ALPHA]].bits;
    if (small) {
      std::vector<uint8_t> px((size_t)xsize * h);
      return dec.alpha_data(hdr, px.data(), xsize, h);
    }
    std::vector<uint32_t> px((size_t)xsize * h);
    return dec.image_data(hdr, px.data(), xsize, h);
  } catch (const Refused&) {
    return false;
  }
}

// -------------------------------------------------------------------- VP8

// VP8BitReader: the boolean decoder, 56 bits loaded at a time. The first
// read that finds no byte left loads 8 zero bits and sets eof; libwebp
// refuses the frame when a partition's eof is set (bit_reader_inl_utils.h).
struct BoolReader {
  uint64_t value = 0;
  uint32_t range = 254;  // range - 1
  int bits = -8, eof = 0;
  const uint8_t *buf = nullptr, *end = nullptr, *max = nullptr;

  void init(const uint8_t* s, size_t n) {
    range = 254;
    value = 0;
    bits = -8;
    eof = 0;
    buf = s;
    end = s + n;
    max = n >= 8 ? s + n - 8 + 1 : s;
    load();
  }
  void load() {
    if (buf < max) {
      uint64_t in;
      memcpy(&in, buf, 8);
      buf += 7;
      value = (__builtin_bswap64(in) >> 8) | (value << 56);
      bits += 56;
    } else if (buf < end) {
      bits += 8;
      value = *buf++ | (value << 8);
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = 1;
    } else {
      bits = 0;
    }
  }
  int bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * prob) >> 8;
    const int b = (uint32_t)(value >> pos) > split;
    if (b) {
      r -= split;
      value -= (uint64_t)(split + 1) << pos;
    } else {
      r = split + 1;
    }
    const int shift = 7 ^ (31 ^ __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return b;
  }
  // VP8GetSigned: a sign at probability 1/2 with one shift whatever the
  // range; it parts from bit(0x80) only at a partition's first read.
  int sign(int v) {
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = range >> 1;
    const uint32_t val = (uint32_t)(value >> pos);
    const int32_t mask = (int32_t)(split - val) >> 31;  // -1 or 0
    bits -= 1;
    range += (uint32_t)mask;
    range |= 1;
    value -= (uint64_t)((split + 1) & (uint32_t)mask) << pos;
    return (v ^ mask) - mask;
  }
  int literal(int n) {
    int v = 0;
    while (n-- > 0) v |= bit(0x80) << n;
    return v;
  }
  int flag() { return literal(1); }
  int signed_literal(int n) {
    const int v = literal(n);
    return flag() ? -v : v;
  }
};

struct MBData {
  int16_t coeffs[384];
  uint8_t is_i4x4, imodes[16], uvmode, segment, skip;
  uint32_t non_zero_y, non_zero_uv;
};

struct FInfo {
  uint8_t limit, ilevel, inner, hev_thresh;
};

enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED, B_VL_PRED,
       B_HD_PRED, B_HU_PRED, DC_NOTOP = 4, DC_NOLEFT = 5, DC_NOTOPLEFT = 6 };

constexpr int BPS = 32;  // the stride of the work blocks

inline uint8_t clip8(int v) { return !(v & ~0xff) ? v : v < 0 ? 0 : 255; }
inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// Transform_SSE2 (dec_sse2.c), the inverse DCT libwebp runs on x86-64 for a
// block of more than three coefficients: every sum wraps at 16 bits, the
// products are _mm_mulhi_epi16, and the sum with the prediction saturates.
void idct_sse2(const int16_t* in, uint8_t* dst) {
  auto w = [](int v) { return (int16_t)v; };
  auto hi = [](int16_t a, int k) { return (int16_t)(((int32_t)a * k) >> 16); };
  auto pass = [&](const int16_t* i0, const int16_t* i1, const int16_t* i2, const int16_t* i3, int dc,
                  int16_t out[4][4]) {
    for (int l = 0; l < 4; ++l) {
      const int16_t a = w(w(i0[l] + dc) + i2[l]), b = w(w(i0[l] + dc) - i2[l]);
      const int16_t c = w(w(i1[l] - i3[l]) + w(hi(i1[l], -30068) - hi(i3[l], 20091)));
      const int16_t d = w(w(i1[l] + i3[l]) + w(hi(i1[l], 20091) + hi(i3[l], -30068)));
      out[0][l] = w(a + d);
      out[1][l] = w(b + c);
      out[2][l] = w(b - c);
      out[3][l] = w(a - d);
    }
  };
  int16_t v[4][4], t[4][4], h[4][4];
  pass(in, in + 4, in + 8, in + 12, 0, v);  // lanes: columns
  for (int j = 0; j < 4; ++j)
    for (int l = 0; l < 4; ++l) t[j][l] = v[l][j];
  pass(t[0], t[1], t[2], t[3], 4, h);  // lanes: rows
  for (int r = 0; r < 4; ++r)
    for (int x = 0; x < 4; ++x) {
      const int16_t s = w(dst[r * BPS + x] + (int16_t)(h[x][r] >> 3));
      dst[r * BPS + x] = (uint8_t)std::min(255, std::max(0, (int)s));
    }
}

// TransformAC3_C: coefficients 0, 1 and 4 alone, in int.
void idct_ac3(const int16_t* in, uint8_t* dst) {
  const int a = in[0] + 4, c4 = mul2(in[4]), d4 = mul1(in[4]), c1 = mul2(in[1]), d1 = mul1(in[1]);
  const int dc[4] = {a + d4, a + c4, a - c4, a - d4};
  for (int y = 0; y < 4; ++y) {
    uint8_t* p = dst + y * BPS;
    p[0] = clip8(p[0] + ((dc[y] + d1) >> 3));
    p[1] = clip8(p[1] + ((dc[y] + c1) >> 3));
    p[2] = clip8(p[2] + ((dc[y] - c1) >> 3));
    p[3] = clip8(p[3] + ((dc[y] - d1) >> 3));
  }
}

void idct_dc(const int16_t* in, uint8_t* dst) {
  const int dc = in[0] + 4;
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x) dst[y * BPS + x] = clip8(dst[y * BPS + x] + (dc >> 3));
}

// DoTransform: the routine libwebp picks by the block's last coefficient.
void do_transform(uint32_t bits, const int16_t* in, uint8_t* dst) {
  switch (bits >> 30) {
    case 3: idct_sse2(in, dst); break;
    case 2: idct_ac3(in, dst); break;
    case 1: idct_dc(in, dst); break;
    default: break;
  }
}

void do_uv_transform(uint32_t bits, const int16_t* in, uint8_t* dst) {
  if (!(bits & 0xff)) return;
  static const int kAt[4] = {0, 4, 4 * BPS, 4 * BPS + 4};
  for (int b = 0; b < 4; ++b) {
    if (bits & 0xaa)
      idct_sse2(in + 16 * b, dst + kAt[b]);
    else if (in[16 * b])
      idct_dc(in + 16 * b, dst + kAt[b]);
  }
}

void inverse_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

// ------------------------------------------------------------ predictors

inline uint8_t avg3(int a, int b, int c) { return (uint8_t)((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return (uint8_t)((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  for (int y = 0; y < size; ++y, dst += BPS)
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + dst[-1] - top[-1]);
}

void fill(uint8_t* dst, int size, int v) {
  for (int y = 0; y < size; ++y) memset(dst + y * BPS, v, size);
}

void predict4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - BPS;
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  auto at = [&](int x, int y) -> uint8_t& { return dst[x + y * BPS]; };
  switch (mode) {
    case B_DC_PRED: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
      fill(dst, 4, dc >> 3);
      break;
    }
    case B_TM_PRED: true_motion(dst, 4); break;
    case B_VE_PRED: {
      const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int y = 0; y < 4; ++y) memcpy(dst + y * BPS, v, 4);
      break;
    }
    case B_HE_PRED:
      memset(dst, avg3(X, I, J), 4);
      memset(dst + BPS, avg3(I, J, K), 4);
      memset(dst + 2 * BPS, avg3(J, K, L), 4);
      memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    case B_RD_PRED:
      at(0, 3) = avg3(J, K, L);
      at(1, 3) = at(0, 2) = avg3(I, J, K);
      at(2, 3) = at(1, 2) = at(0, 1) = avg3(X, I, J);
      at(3, 3) = at(2, 2) = at(1, 1) = at(0, 0) = avg3(A, X, I);
      at(3, 2) = at(2, 1) = at(1, 0) = avg3(B, A, X);
      at(3, 1) = at(2, 0) = avg3(C, B, A);
      at(3, 0) = avg3(D, C, B);
      break;
    case B_VR_PRED:
      at(0, 0) = at(1, 2) = avg2(X, A);
      at(1, 0) = at(2, 2) = avg2(A, B);
      at(2, 0) = at(3, 2) = avg2(B, C);
      at(3, 0) = avg2(C, D);
      at(0, 3) = avg3(K, J, I);
      at(0, 2) = avg3(J, I, X);
      at(0, 1) = at(1, 3) = avg3(I, X, A);
      at(1, 1) = at(2, 3) = avg3(X, A, B);
      at(2, 1) = at(3, 3) = avg3(A, B, C);
      at(3, 1) = avg3(B, C, D);
      break;
    case B_LD_PRED:
      at(0, 0) = avg3(A, B, C);
      at(1, 0) = at(0, 1) = avg3(B, C, D);
      at(2, 0) = at(1, 1) = at(0, 2) = avg3(C, D, E);
      at(3, 0) = at(2, 1) = at(1, 2) = at(0, 3) = avg3(D, E, F);
      at(3, 1) = at(2, 2) = at(1, 3) = avg3(E, F, G);
      at(3, 2) = at(2, 3) = avg3(F, G, H);
      at(3, 3) = avg3(G, H, H);
      break;
    case B_VL_PRED:
      at(0, 0) = avg2(A, B);
      at(1, 0) = at(0, 2) = avg2(B, C);
      at(2, 0) = at(1, 2) = avg2(C, D);
      at(3, 0) = at(2, 2) = avg2(D, E);
      at(0, 1) = avg3(A, B, C);
      at(1, 1) = at(0, 3) = avg3(B, C, D);
      at(2, 1) = at(1, 3) = avg3(C, D, E);
      at(3, 1) = at(2, 3) = avg3(D, E, F);
      at(3, 2) = avg3(E, F, G);
      at(3, 3) = avg3(F, G, H);
      break;
    case B_HD_PRED:
      at(0, 0) = at(2, 1) = avg2(I, X);
      at(0, 1) = at(2, 2) = avg2(J, I);
      at(0, 2) = at(2, 3) = avg2(K, J);
      at(0, 3) = avg2(L, K);
      at(3, 0) = avg3(A, B, C);
      at(2, 0) = avg3(X, A, B);
      at(1, 0) = at(3, 1) = avg3(I, X, A);
      at(1, 1) = at(3, 2) = avg3(J, I, X);
      at(1, 2) = at(3, 3) = avg3(K, J, I);
      at(1, 3) = avg3(L, K, J);
      break;
    default:  // B_HU_PRED
      at(0, 0) = avg2(I, J);
      at(2, 0) = at(0, 1) = avg2(J, K);
      at(2, 1) = at(0, 2) = avg2(K, L);
      at(1, 0) = avg3(I, J, K);
      at(3, 0) = at(1, 1) = avg3(J, K, L);
      at(3, 1) = at(1, 2) = avg3(K, L, L);
      at(3, 2) = at(2, 2) = at(0, 3) = at(1, 3) = at(2, 3) = at(3, 3) = (uint8_t)L;
      break;
  }
}

// A 16 x 16 luma or 8 x 8 chroma block's prediction (modes after CheckMode).
void predict_block(int mode, uint8_t* dst, int size) {
  const int shift = size == 16 ? 5 : 4;
  int dc = 0;
  switch (mode) {
    case B_DC_PRED:
      for (int i = 0; i < size; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, size, (dc + size) >> shift);
      break;
    case B_TM_PRED: true_motion(dst, size); break;
    case B_VE_PRED:
      for (int y = 0; y < size; ++y) memcpy(dst + y * BPS, dst - BPS, size);
      break;
    case B_HE_PRED:
      for (int y = 0; y < size; ++y) memset(dst + y * BPS, dst[y * BPS - 1], size);
      break;
    case DC_NOTOP:
      for (int i = 0; i < size; ++i) dc += dst[-1 + i * BPS];
      fill(dst, size, (dc + size / 2) >> (shift - 1));
      break;
    case DC_NOLEFT:
      for (int i = 0; i < size; ++i) dc += dst[i - BPS];
      fill(dst, size, (dc + size / 2) >> (shift - 1));
      break;
    default: fill(dst, size, 0x80); break;
  }
}

inline int check_mode(int mb_x, int mb_y, int mode) {
  if (mode != B_DC_PRED) return mode;
  if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
  return mb_y == 0 ? DC_NOTOP : B_DC_PRED;
}

// ------------------------------------------------------------ loop filter

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  return std::abs(p[-2 * step] - p[-step]) > thresh || std::abs(p[step] - p[0]) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  return 4 * std::abs(p[-step] - p[0]) + std::abs(p[-2 * step] - p[step]) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// FilterLoop26 (an edge between macroblocks) and FilterLoop24 (inside one).
void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh, int hev_t,
                 bool outer) {
  const int t2 = 2 * thresh + 1;
  for (; size-- > 0; p += vstride)
    if (needs_filter2(p, hstride, t2, ithresh)) {
      if (hev(p, hstride, hev_t))
        filter2(p, hstride);
      else if (outer)
        filter6(p, hstride);
      else
        filter4(p, hstride);
    }
}

void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, t2)) filter2(p, hstride);
}

// ------------------------------------------------------------ the decoder

struct Lossy {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  BoolReader br;
  BoolReader parts[8];
  int num_parts_minus_one = 0;
  int use_segment = 0, update_map = 0, absolute_delta = 1;
  int quantizer[4] = {0}, filter_strength[4] = {0};
  uint8_t segment_probs[3] = {255, 255, 255};
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0, filter_type = 0;
  int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
  struct Quant {
    int y1[2], y2[2], uv[2];
  } dqm[4];
  uint8_t proba[4][8][3][11];
  int use_skip = 0, skip_p = 0;
  FInfo fstrengths[4][2];
  // the planes, 16 * mb_w by 16 * mb_h, reconstructed before any filtering
  int ystride = 0, uvstride = 0;
  std::vector<uint8_t> y, u, v;
  std::vector<FInfo> finfo;

  void headers(const uint8_t* d, size_t n) {
    // VP8GetHeaders: the frame tag, the start code and the size (checked
    // already by vp8_info), then partition 0's header
    const uint32_t bits = le24(d);
    const size_t part0 = bits >> 5;
    width = le16(d + 6) & 0x3fff;
    height = le16(d + 8) & 0x3fff;
    mb_w = (width + 15) >> 4;
    mb_h = (height + 15) >> 4;
    d += 10;
    n -= 10;
    if (part0 > n) refuse("VP8 first partition is longer than the data");
    br.init(d, part0);
    d += part0;
    n -= part0;
    br.flag();  // colour space
    br.flag();  // clamping type
    use_segment = br.flag();
    if (use_segment) {
      update_map = br.flag();
      if (br.flag()) {
        absolute_delta = br.flag();
        for (int& q : quantizer) q = br.flag() ? br.signed_literal(7) : 0;
        for (int& f : filter_strength) f = br.flag() ? br.signed_literal(6) : 0;
      }
      if (update_map)
        for (uint8_t& p : segment_probs) p = br.flag() ? (uint8_t)br.literal(8) : 255;
    }
    if (br.eof) refuse("VP8 segment header ends");
    simple = br.flag();
    level = br.literal(6);
    sharpness = br.literal(3);
    use_lf_delta = br.flag();
    if (use_lf_delta && br.flag()) {
      for (int& r : ref_lf_delta)
        if (br.flag()) r = br.signed_literal(6);
      for (int& m : mode_lf_delta)
        if (br.flag()) m = br.signed_literal(6);
    }
    filter_type = level == 0 ? 0 : simple ? 1 : 2;
    if (br.eof) refuse("VP8 filter header ends");
    // ParsePartitions: the last partition takes the rest and must not be empty
    num_parts_minus_one = (1 << br.literal(2)) - 1;
    const size_t last = num_parts_minus_one;
    if (n < 3 * last) refuse("VP8 partition sizes past the data");
    const uint8_t* sz = d;
    const uint8_t* start = d + last * 3;
    size_t left = n - last * 3;
    for (size_t p = 0; p < last; ++p, sz += 3) {
      size_t psize = le24(sz);
      if (psize > left) psize = left;
      parts[p].init(start, psize);
      start += psize;
      left -= psize;
    }
    parts[last].init(start, left);
    if (start >= d + n) refuse("VP8 last partition is empty");
    // VP8ParseQuant
    const int base_q0 = br.literal(7);
    const int dqy1_dc = br.flag() ? br.signed_literal(4) : 0, dqy2_dc = br.flag() ? br.signed_literal(4) : 0;
    const int dqy2_ac = br.flag() ? br.signed_literal(4) : 0, dquv_dc = br.flag() ? br.signed_literal(4) : 0;
    const int dquv_ac = br.flag() ? br.signed_literal(4) : 0;
    auto clip = [](int q, int m) { return q < 0 ? 0 : q > m ? m : q; };
    for (int i = 0; i < 4; ++i) {
      if (!use_segment && i > 0) {
        dqm[i] = dqm[0];
        continue;
      }
      const int q = use_segment ? quantizer[i] + (absolute_delta ? 0 : base_q0) : base_q0;
      Quant& m = dqm[i];
      m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
      m.y1[1] = kAcTable[clip(q, 127)];
      m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      m.y2[1] = std::max(8, (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16);
      m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
      m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
    }
    br.flag();  // refresh entropy probs: one frame only
    // VP8ParseProba
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p)
            proba[t][b][c][p] = br.bit(kCoeffsUpdateProba[t][b][c][p]) ? (uint8_t)br.literal(8)
                                                                        : kCoeffsProba0[t][b][c][p];
    use_skip = br.flag();
    if (use_skip) skip_p = br.literal(8);
  }

  // PrecomputeFilterStrengths
  void filter_strengths() {
    for (int s = 0; s < 4; ++s) {
      int base = level;
      if (use_segment) base = filter_strength[s] + (absolute_delta ? 0 : level);
      for (int i4 = 0; i4 <= 1; ++i4) {
        FInfo& f = fstrengths[s][i4];
        int lv = base;
        if (use_lf_delta) lv += ref_lf_delta[0] + (i4 ? mode_lf_delta[0] : 0);
        lv = lv < 0 ? 0 : lv > 63 ? 63 : lv;
        if (lv > 0) {
          int il = lv;
          if (sharpness > 0) {
            il >>= sharpness > 4 ? 2 : 1;
            if (il > 9 - sharpness) il = 9 - sharpness;
          }
          if (il < 1) il = 1;
          f.ilevel = (uint8_t)il;
          f.limit = (uint8_t)(2 * lv + il);
          f.hev_thresh = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
        } else {
          f.limit = 0;
        }
        f.inner = (uint8_t)i4;
      }
    }
  }

  // ParseIntraMode
  void intra_mode(MBData& b, uint8_t* top, uint8_t* left) {
    b.segment = update_map ? (!br.bit(segment_probs[0]) ? br.bit(segment_probs[1])
                                                         : br.bit(segment_probs[2]) + 2)
                           : 0;
    if (use_skip) b.skip = (uint8_t)br.bit(skip_p);
    b.is_i4x4 = !br.bit(145);
    if (!b.is_i4x4) {
      const int ymode = br.bit(156) ? (br.bit(128) ? B_TM_PRED : B_HE_PRED)
                                    : (br.bit(163) ? B_VE_PRED : B_DC_PRED);
      b.imodes[0] = (uint8_t)ymode;
      memset(top, ymode, 4);
      memset(left, ymode, 4);
    } else {
      uint8_t* modes = b.imodes;
      for (int yy = 0; yy < 4; ++yy) {
        int ymode = left[yy];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* p = kBModesProba[top[x]][ymode];
          ymode = !br.bit(p[0]) ? B_DC_PRED
                  : !br.bit(p[1]) ? B_TM_PRED
                  : !br.bit(p[2]) ? B_VE_PRED
                  : !br.bit(p[3]) ? (!br.bit(p[4]) ? B_HE_PRED : !br.bit(p[5]) ? B_RD_PRED : B_VR_PRED)
                  : (!br.bit(p[6]) ? B_LD_PRED : !br.bit(p[7]) ? B_VL_PRED : !br.bit(p[8]) ? B_HD_PRED : B_HU_PRED);
          top[x] = (uint8_t)ymode;
        }
        memcpy(modes, top, 4);
        modes += 4;
        left[yy] = (uint8_t)ymode;
      }
    }
    b.uvmode = !br.bit(142) ? B_DC_PRED : !br.bit(114) ? B_VE_PRED : br.bit(183) ? B_TM_PRED : B_HE_PRED;
  }

  static int large_value(BoolReader& r, const uint8_t* p) {
    if (!r.bit(p[3])) return !r.bit(p[4]) ? 2 : 3 + r.bit(p[5]);
    if (!r.bit(p[6])) {
      if (!r.bit(p[7])) return 5 + r.bit(159);
      const int v = 7 + 2 * r.bit(165);
      return v + r.bit(145);
    }
    const int bit1 = r.bit(p[8]), bit0 = r.bit(p[9 + bit1]), cat = 2 * bit1 + bit0;
    int v = 0;
    for (const uint8_t* t = kCat3456[cat]; *t; ++t) v += v + r.bit(*t);
    return v + 3 + (8 << cat);
  }

  // GetCoeffs: the index after the last coefficient read
  int coeffs(BoolReader& r, int type, int ctx, const int dq[2], int n, int16_t* out) {
    const uint8_t* p = proba[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!r.bit(p[0])) return n;
      while (!r.bit(p[1])) {
        p = proba[type][kBands[++n]][0];
        if (n == 16) return 16;
      }
      const uint8_t(*p_ctx)[11] = proba[type][kBands[n + 1]];
      int v;
      if (!r.bit(p[2])) {
        v = 1;
        p = p_ctx[1];
      } else {
        v = large_value(r, p);
        p = p_ctx[2];
      }
      out[kZigzag[n]] = (int16_t)(r.sign(v) * dq[n > 0]);
    }
    return 16;
  }

  static uint32_t nz_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
    return (nz_coeffs << 2) | (nz > 3 ? 3 : nz > 1 ? 2 : dc_nz);
  }

  // ParseResiduals: true when the macroblock has no non-zero coefficient
  bool residuals(MBData& b, uint8_t& top_nz, uint8_t& top_nz_dc, uint8_t& left_nz, uint8_t& left_nz_dc,
                 BoolReader& r) {
    const Quant& q = dqm[b.segment];
    int16_t* dst = b.coeffs;
    memset(dst, 0, sizeof b.coeffs);
    int first, type;
    if (!b.is_i4x4) {
      int16_t dc[16] = {0};
      const int nz = coeffs(r, 1, top_nz_dc + left_nz_dc, q.y2, 0, dc);
      top_nz_dc = left_nz_dc = nz > 0;
      if (nz > 1) {
        inverse_wht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 256; i += 16) dst[i] = (int16_t)dc0;
      }
      first = 1;
      type = 0;
    } else {
      first = 0;
      type = 3;
    }
    uint32_t non_zero_y = 0, non_zero_uv = 0;
    uint8_t tnz = top_nz & 0x0f, lnz = left_nz & 0x0f;
    for (int yy = 0; yy < 4; ++yy) {
      int l = lnz & 1;
      uint32_t nzc = 0;
      for (int x = 0; x < 4; ++x) {
        const int nz = coeffs(r, type, l + (tnz & 1), q.y1, first, dst);
        l = nz > first;
        tnz = (uint8_t)((tnz >> 1) | (l << 7));
        nzc = nz_bits(nzc, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 4;
      lnz = (uint8_t)((lnz >> 1) | (l << 7));
      non_zero_y = (non_zero_y << 8) | nzc;
    }
    uint32_t out_t = tnz, out_l = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      uint32_t nzc = 0;
      tnz = (uint8_t)(top_nz >> (4 + ch));
      lnz = (uint8_t)(left_nz >> (4 + ch));
      for (int yy = 0; yy < 2; ++yy) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int nz = coeffs(r, 2, l + (tnz & 1), q.uv, 0, dst);
          l = nz > 0;
          tnz = (uint8_t)((tnz >> 1) | (l << 3));
          nzc = nz_bits(nzc, nz, dst[0] != 0);
          dst += 16;
        }
        tnz >>= 2;
        lnz = (uint8_t)((lnz >> 1) | (l << 5));
      }
      non_zero_uv |= nzc << (4 * ch);
      out_t |= (uint32_t)(tnz << 4) << ch;
      out_l |= (uint32_t)(lnz & 0xf0) << ch;
    }
    top_nz = (uint8_t)out_t;
    left_nz = (uint8_t)out_l;
    b.non_zero_y = non_zero_y;
    b.non_zero_uv = non_zero_uv;
    return !(non_zero_y | non_zero_uv);
  }

  // ReconstructRow for one macroblock: a work block of stride BPS with
  // libwebp's borders, predicted and summed with the residuals, copied out.
  void reconstruct(const MBData& b, int mb_x, int mb_y) {
    uint8_t ybuf[BPS * 17], ubuf[BPS * 9], vbuf[BPS * 9];
    uint8_t* yd = ybuf + BPS + 8;
    uint8_t* planes[3] = {ubuf + BPS + 8, vbuf + BPS + 8, nullptr};
    const int x0 = mb_x * 16, y0 = mb_y * 16;
    // left column and the top-left corner
    for (int j = 0; j < 16; ++j) yd[j * BPS - 1] = mb_x ? y[(size_t)(y0 + j) * ystride + x0 - 1] : 129;
    for (int c = 0; c < 2; ++c)
      for (int j = 0; j < 8; ++j)
        planes[c][j * BPS - 1] =
            mb_x ? (c ? v : u)[(size_t)(mb_y * 8 + j) * uvstride + mb_x * 8 - 1] : 129;
    if (mb_y > 0) {
      const uint8_t* top = y.data() + (size_t)(y0 - 1) * ystride + x0;
      yd[-BPS - 1] = mb_x ? top[-1] : 129;
      memcpy(yd - BPS, top, 16);
      for (int c = 0; c < 2; ++c) {
        const uint8_t* t = (c ? v : u).data() + (size_t)(mb_y * 8 - 1) * uvstride + mb_x * 8;
        planes[c][-BPS - 1] = mb_x ? t[-1] : 129;
        memcpy(planes[c] - BPS, t, 8);
      }
    } else {
      memset(yd - BPS - 1, 127, 16 + 4 + 1);
      memset(planes[0] - BPS - 1, 127, 9);
      memset(planes[1] - BPS - 1, 127, 9);
    }
    uint32_t bits = b.non_zero_y;
    if (b.is_i4x4) {
      uint8_t* top_right = yd - BPS + 16;
      if (mb_y > 0) {
        const uint8_t* top = y.data() + (size_t)(y0 - 1) * ystride + x0;
        if (mb_x >= mb_w - 1)
          memset(top_right, top[15], 4);
        else
          memcpy(top_right, top + 16, 4);
      }
      for (int k = 1; k <= 3; ++k) memcpy(top_right + 4 * k * BPS, top_right, 4);
      for (int n = 0; n < 16; ++n, bits <<= 2) {
        uint8_t* dst = yd + (n & 3) * 4 + (n >> 2) * 4 * BPS;
        predict4(b.imodes[n], dst);
        do_transform(bits, b.coeffs + n * 16, dst);
      }
    } else {
      predict_block(check_mode(mb_x, mb_y, b.imodes[0]), yd, 16);
      if (bits)
        for (int n = 0; n < 16; ++n, bits <<= 2)
          do_transform(bits, b.coeffs + n * 16, yd + (n & 3) * 4 + (n >> 2) * 4 * BPS);
    }
    const int uvmode = check_mode(mb_x, mb_y, b.uvmode);
    predict_block(uvmode, planes[0], 8);
    predict_block(uvmode, planes[1], 8);
    do_uv_transform(b.non_zero_uv, b.coeffs + 16 * 16, planes[0]);
    do_uv_transform(b.non_zero_uv >> 8, b.coeffs + 20 * 16, planes[1]);
    for (int j = 0; j < 16; ++j) memcpy(&y[(size_t)(y0 + j) * ystride + x0], yd + j * BPS, 16);
    for (int j = 0; j < 8; ++j) {
      memcpy(&u[(size_t)(mb_y * 8 + j) * uvstride + mb_x * 8], planes[0] + j * BPS, 8);
      memcpy(&v[(size_t)(mb_y * 8 + j) * uvstride + mb_x * 8], planes[1] + j * BPS, 8);
    }
  }

  // DoFilter over the whole frame, macroblocks in raster order.
  void loop_filter() {
    for (int mb_y = 0; mb_y < mb_h; ++mb_y)
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        const FInfo& f = finfo[(size_t)mb_y * mb_w + mb_x];
        const int limit = f.limit;
        if (!limit) continue;
        uint8_t* yd = &y[(size_t)mb_y * 16 * ystride + mb_x * 16];
        if (filter_type == 1) {
          if (mb_x > 0) simple_filter(yd, 1, ystride, limit + 4);
          if (f.inner)
            for (int k = 1; k <= 3; ++k) simple_filter(yd + 4 * k, 1, ystride, limit);
          if (mb_y > 0) simple_filter(yd, ystride, 1, limit + 4);
          if (f.inner)
            for (int k = 1; k <= 3; ++k) simple_filter(yd + 4 * k * ystride, ystride, 1, limit);
          continue;
        }
        uint8_t* ud = &u[(size_t)mb_y * 8 * uvstride + mb_x * 8];
        uint8_t* vd = &v[(size_t)mb_y * 8 * uvstride + mb_x * 8];
        const int il = f.ilevel, hv = f.hev_thresh, ys = ystride, us = uvstride;
        if (mb_x > 0) {
          filter_loop(yd, 1, ys, 16, limit + 4, il, hv, true);
          filter_loop(ud, 1, us, 8, limit + 4, il, hv, true);
          filter_loop(vd, 1, us, 8, limit + 4, il, hv, true);
        }
        if (f.inner) {
          for (int k = 1; k <= 3; ++k) filter_loop(yd + 4 * k, 1, ys, 16, limit, il, hv, false);
          filter_loop(ud + 4, 1, us, 8, limit, il, hv, false);
          filter_loop(vd + 4, 1, us, 8, limit, il, hv, false);
        }
        if (mb_y > 0) {
          filter_loop(yd, ys, 1, 16, limit + 4, il, hv, true);
          filter_loop(ud, us, 1, 8, limit + 4, il, hv, true);
          filter_loop(vd, us, 1, 8, limit + 4, il, hv, true);
        }
        if (f.inner) {
          for (int k = 1; k <= 3; ++k) filter_loop(yd + 4 * k * ys, ys, 1, 16, limit, il, hv, false);
          filter_loop(ud + 4 * us, us, 1, 8, limit, il, hv, false);
          filter_loop(vd + 4 * us, us, 1, 8, limit, il, hv, false);
        }
      }
  }

  void decode(const uint8_t* d, size_t n) {
    headers(d, n);
    filter_strengths();
    ystride = mb_w * 16;
    uvstride = mb_w * 8;
    y.assign((size_t)ystride * mb_h * 16, 0);
    u.assign((size_t)uvstride * mb_h * 8, 0);
    v.assign((size_t)uvstride * mb_h * 8, 0);
    finfo.assign((size_t)mb_w * mb_h, FInfo{0, 0, 0, 0});
    std::vector<uint8_t> intra_t(4 * mb_w, B_DC_PRED), top_nz(mb_w, 0), top_nz_dc(mb_w, 0);
    std::vector<MBData> row(mb_w);
    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
      uint8_t intra_l[4] = {B_DC_PRED, B_DC_PRED, B_DC_PRED, B_DC_PRED};
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) intra_mode(row[mb_x], &intra_t[4 * mb_x], intra_l);
      if (br.eof) refuse("premature end of VP8 partition 0");
      BoolReader& tokens = parts[mb_y & num_parts_minus_one];
      uint8_t left_nz = 0, left_nz_dc = 0;
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        MBData& b = row[mb_x];
        bool skip = use_skip ? b.skip : false;
        if (!skip) {
          skip = residuals(b, top_nz[mb_x], top_nz_dc[mb_x], left_nz, left_nz_dc, tokens);
        } else {
          left_nz = top_nz[mb_x] = 0;
          if (!b.is_i4x4) left_nz_dc = top_nz_dc[mb_x] = 0;
          b.non_zero_y = b.non_zero_uv = 0;
        }
        if (filter_type > 0) {
          FInfo& f = finfo[(size_t)mb_y * mb_w + mb_x];
          f = fstrengths[b.segment][b.is_i4x4];
          f.inner |= !skip;
        }
        if (tokens.eof) refuse("premature end of VP8 data");
        reconstruct(b, mb_x, mb_y);
      }
    }
    if (filter_type > 0) loop_filter();
  }
};

// VP8GetInfo: a key frame, shown, of profile 0-3, the start code, a first
// partition shorter than the chunk, a size of at least 1 x 1.
bool vp8_info(const uint8_t* d, size_t n, size_t chunk_size, int& w, int& h) {
  if (n < 10 || d[3] != 0x9d || d[4] != 0x01 || d[5] != 0x2a) return false;
  const uint32_t bits = le24(d);
  w = le16(d + 6) & 0x3fff;
  h = le16(d + 8) & 0x3fff;
  if (bits & 1) return false;
  if (((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) || (bits >> 5) >= chunk_size) return false;
  return w && h;
}

// EmitFancyRGB with UpsampleRgbaLinePair (upsampling.c) and VP8YuvToRgb
// (yuv.h): libwebp's 9-3-3-1 chroma filter and 14-bit YUV->RGB, to L.
inline int yuv_clip(int v) { return (v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255; }
inline uint8_t yuv_luma(int yy, int uu, int vv) {
  const int yh = (yy * 19077) >> 8;
  const int r = yuv_clip(yh + ((vv * 26149) >> 8) - 14234);
  const int g = yuv_clip(yh - ((uu * 6419) >> 8) - ((vv * 13320) >> 8) + 8708);
  const int b = yuv_clip(yh + ((uu * 33050) >> 8) - 17685);
  return luma(r, g, b);
}

void upsample_pair(const uint8_t* top_y, const uint8_t* bot_y, const uint8_t* tu, const uint8_t* tv,
                   const uint8_t* cu, const uint8_t* cv, uint8_t* top_dst, uint8_t* bot_dst, int len) {
  auto load = [](int a, int b) { return (uint32_t)a | ((uint32_t)b << 16); };
  const int last_pair = (len - 1) >> 1;
  uint32_t tl = load(tu[0], tv[0]), l = load(cu[0], cv[0]);
  auto put = [](const uint8_t* ys, uint8_t* dst, int x, uint32_t uv) {
    dst[x] = yuv_luma(ys[x], uv & 0xff, uv >> 16);
  };
  put(top_y, top_dst, 0, (3 * tl + l + 0x00020002u) >> 2);
  if (bot_y) put(bot_y, bot_dst, 0, (3 * l + tl + 0x00020002u) >> 2);
  for (int x = 1; x <= last_pair; ++x) {
    const uint32_t t = load(tu[x], tv[x]), uv = load(cu[x], cv[x]);
    const uint32_t avg = tl + t + l + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t + l)) >> 3, diag_03 = (avg + 2 * (tl + uv)) >> 3;
    put(top_y, top_dst, 2 * x - 1, (diag_12 + tl) >> 1);
    put(top_y, top_dst, 2 * x, (diag_03 + t) >> 1);
    if (bot_y) {
      put(bot_y, bot_dst, 2 * x - 1, (diag_03 + l) >> 1);
      put(bot_y, bot_dst, 2 * x, (diag_12 + uv) >> 1);
    }
    tl = t;
    l = uv;
  }
  if (!(len & 1)) {
    put(top_y, top_dst, len - 1, (3 * tl + l + 0x00020002u) >> 2);
    if (bot_y) put(bot_y, bot_dst, len - 1, (3 * l + tl + 0x00020002u) >> 2);
  }
}

// The grey of a decoded VP8 frame (w x h), row by row as EmitFancyRGB
// pairs them: row 0 alone, then rows 2k+1 and 2k+2, then the last row of
// an even height alone.
void vp8_grey(const Lossy& f, uint8_t* out, size_t stride) {
  const int w = f.width, h = f.height;
  auto Y = [&](int r) { return f.y.data() + (size_t)r * f.ystride; };
  auto U = [&](int r) { return f.u.data() + (size_t)r * f.uvstride; };
  auto V = [&](int r) { return f.v.data() + (size_t)r * f.uvstride; };
  upsample_pair(Y(0), nullptr, U(0), V(0), U(0), V(0), out, nullptr, w);
  int yy = 0;
  for (; yy + 2 < h; yy += 2)
    upsample_pair(Y(yy + 1), Y(yy + 2), U(yy / 2), V(yy / 2), U(yy / 2 + 1), V(yy / 2 + 1),
                  out + (yy + 1) * stride, out + (yy + 2) * stride, w);
  if (!(h & 1)) upsample_pair(Y(yy + 1), nullptr, U(yy / 2), V(yy / 2), U(yy / 2), V(yy / 2),
                              out + (yy + 1) * stride, nullptr, w);
}

// ALPHInit and ALPHDecode: whether libwebp decodes the chunk's alpha plane
// of a w x h frame (its pixels never reach L).
bool alpha_ok(const uint8_t* d, size_t n, int w, int h) {
  if (n <= 1) return false;
  const int method = d[0] & 3, pre = (d[0] >> 4) & 3, rsrv = d[0] >> 6;
  if (method > 1 || pre > 1 || rsrv) return false;
  if (method == 0) return n - 1 >= (size_t)w * h;
  return vp8l_alpha_ok(d + 1, n - 1, w, h);
}

// ------------------------------------------------------------------ demux

// demux.c's MemBuffer and parser, for a whole file (no partial data: a file
// shorter than its RIFF size is refused before any chunk is read).
enum Parse { P_OK, P_ERROR, P_MORE };
enum { STATE_HEADER = 0, STATE_PARSED = 1, STATE_DONE = 2 };

constexpr uint32_t fourcc(const char* s) { return s[0] | (s[1] << 8) | (s[2] << 16) | ((uint32_t)s[3] << 24); }

struct Mem {
  const uint8_t* buf = nullptr;
  size_t start = 0, end = 0, riff_end = 0;
  size_t avail() const { return end - start; }
  bool size_invalid(size_t size) const { return size > riff_end - start; }
  uint32_t r8() { return buf[start++]; }
  uint32_t r24() {
    const uint32_t v = le24(buf + start);
    start += 3;
    return v;
  }
  uint32_t r32() {
    const uint32_t v = le32(buf + start);
    start += 4;
    return v;
  }
};

struct Frame {
  int x_off = 0, y_off = 0, width = 0, height = 0, frame_num = 0, complete = 0;
  size_t img_off = 0, img_size = 0, alpha_off = 0, alpha_size = 0;
};

struct Demux {
  Mem mem;
  bool ext = false;
  uint32_t flags = 0;
  int canvas_w = 0, canvas_h = 0, state = STATE_HEADER, num_frames = 0;
  std::vector<Frame> frames;

  // WebPGetFeatures of a 'VP8 ' or 'VP8L' chunk (header included): 0 ok,
  // 1 too little data, 2 a bitstream error.
  int features(size_t at, size_t size, int& w, int& h) const {
    const uint8_t* d = mem.buf + at;
    if (size < 12) return 1;
    const uint32_t declared = le32(d + 4);
    d += 8;
    size -= 8;
    int alpha;
    if (!memcmp(d - 8, "VP8L", 4)) {
      if (size < 5) return 1;
      return vp8l_info(d, size, w, h, alpha) ? 0 : 2;
    }
    if (size < 10) return 1;
    return vp8_info(d, size, declared, w, h) ? 0 : 2;
  }

  bool add_frame(const Frame& f) {
    if (!frames.empty() && !frames.back().complete) return false;
    frames.push_back(f);
    return true;
  }

  Parse store_frame(int frame_num, uint32_t min_size, Frame& f) {
    int alpha_chunks = 0, image_chunks = 0;
    bool done = mem.avail() < 8 || mem.avail() < min_size;
    Parse status = P_OK;
    if (done) return P_MORE;
    do {
      const size_t chunk_start = mem.start;
      const uint32_t id = mem.r32(), payload = mem.r32();
      if (payload > kMaxChunkPayload) return P_ERROR;
      const uint32_t padded = payload + (payload & 1);
      const size_t available = padded > mem.avail() ? mem.avail() : padded;
      const size_t chunk_size = 8 + available;
      if (mem.size_invalid(padded)) return P_ERROR;
      if (padded > mem.avail()) status = P_MORE;
      bool stop = false;
      if (id == fourcc("VP8L") && alpha_chunks > 0) return P_ERROR;  // VP8L has its own alpha
      if (id == fourcc("ALPH") && alpha_chunks == 0) {
        ++alpha_chunks;
        f.alpha_off = chunk_start;
        f.alpha_size = chunk_size;
        f.frame_num = frame_num;
        mem.start += available;
      } else if ((id == fourcc("VP8L") || id == fourcc("VP8 ")) && image_chunks == 0) {
        int w = 0, h = 0;
        const int st = features(chunk_start, chunk_size, w, h);
        if (status == P_MORE && st == 1) return P_MORE;
        if (st != 0) return P_ERROR;
        ++image_chunks;
        f.img_off = chunk_start;
        f.img_size = chunk_size;
        f.width = w;
        f.height = h;
        f.frame_num = frame_num;
        f.complete = status == P_OK;
        mem.start += available;
      } else {  // a chunk of the next level
        mem.start -= 8;
        stop = true;
      }
      done = stop;
      if (mem.start == mem.riff_end)
        done = true;
      else if (mem.avail() < 8)
        status = P_MORE;
    } while (!done && status == P_OK);
    return status;
  }

  Parse single_image() {
    if (!frames.empty()) return P_ERROR;
    if (mem.size_invalid(8)) return P_ERROR;
    if (mem.avail() < 8) return P_MORE;
    Frame f;
    const Parse status = store_frame(1, 0, f);
    if (status == P_ERROR) return status;
    if (!(flags & kAlphaFlag) && f.alpha_size > 0) f.alpha_off = f.alpha_size = 0;
    if (!ext && f.width > 0 && f.height > 0) {
      state = STATE_PARSED;
      canvas_w = f.width;
      canvas_h = f.height;
    }
    if (!add_frame(f)) return P_ERROR;
    num_frames = 1;
    return status;
  }

  Parse animation_frame(uint32_t frame_chunk_size) {
    const bool anim = flags & kAnimFlag;
    if (mem.size_invalid(16) || frame_chunk_size < 16) return P_ERROR;
    if (mem.avail() < 16) return P_MORE;
    const uint32_t anmf_payload = frame_chunk_size - 16;
    Frame f;
    f.x_off = 2 * (int)mem.r24();
    f.y_off = 2 * (int)mem.r24();
    f.width = 1 + (int)mem.r24();
    f.height = 1 + (int)mem.r24();
    mem.r24();  // duration
    mem.r8();   // dispose and blend
    if ((uint64_t)f.width * f.height >= (1ULL << 32)) return P_ERROR;
    const size_t start = mem.start;
    Parse status = store_frame(num_frames + 1, anmf_payload, f);
    if (status != P_ERROR && mem.start - start > anmf_payload) status = P_ERROR;
    if (status != P_ERROR && anim && f.frame_num > 0) {
      if (add_frame(f))
        ++num_frames;
      else
        status = P_ERROR;
    }
    return status;
  }

  Parse vp8x_chunks() {
    const bool anim = flags & kAnimFlag;
    int anim_chunks = 0;
    Parse status = P_OK;
    do {
      const uint32_t id = mem.r32(), size = mem.r32();
      if (size > kMaxChunkPayload) return P_ERROR;
      const uint32_t padded = size + (size & 1);
      if (mem.size_invalid(padded)) return P_ERROR;
      if (id == fourcc("VP8X")) return P_ERROR;
      if (id == fourcc("ALPH") || id == fourcc("VP8 ") || id == fourcc("VP8L")) {
        if (anim_chunks > 0 || anim) return P_ERROR;
        mem.start -= 8;
        status = single_image();
      } else if (id == fourcc("ANIM")) {  // a second one is skipped as unknown
        if (padded < 6) return P_ERROR;
        if (mem.avail() < padded) {
          status = P_MORE;
        } else {
          ++anim_chunks;
          mem.start += padded;  // background colour, loop count, the rest
        }
      } else if (id == fourcc("ANMF")) {
        if (anim_chunks == 0) return P_ERROR;
        status = animation_frame(padded);
      } else {  // ICCP, EXIF, XMP, a second ANIM, unknown chunks: skipped
        if (padded <= mem.avail())
          mem.start += padded;
        else
          status = P_MORE;
      }
      if (mem.start == mem.riff_end) break;
      if (mem.avail() < 8) status = P_MORE;
    } while (status == P_OK);
    return status;
  }

  Parse vp8x() {
    if (mem.avail() < 8) return P_MORE;
    ext = true;
    mem.start += 4;
    uint32_t size = mem.r32();
    if (size > kMaxChunkPayload || size < 10) return P_ERROR;
    size += size & 1;
    if (mem.size_invalid(size)) return P_ERROR;
    if (mem.avail() < size) return P_MORE;
    flags = mem.r8();
    mem.start += 3;
    canvas_w = 1 + (int)mem.r24();
    canvas_h = 1 + (int)mem.r24();
    if ((uint64_t)canvas_w * canvas_h >= (1ULL << 32)) return P_ERROR;
    mem.start += size - 10;
    state = STATE_PARSED;
    if (mem.size_invalid(8)) return P_ERROR;
    if (mem.avail() < 8) return P_MORE;
    return vp8x_chunks();
  }

  bool valid_simple() const {
    if (state == STATE_HEADER) return true;
    if (canvas_w <= 0 || canvas_h <= 0) return false;
    if (state == STATE_DONE && frames.empty()) return false;
    return frames[0].width > 0 && frames[0].height > 0;
  }

  bool valid_extended() const {
    const bool anim = flags & kAnimFlag;
    if (state == STATE_HEADER) return true;
    if (canvas_w <= 0 || canvas_h <= 0) return false;
    if (state == STATE_DONE && frames.empty()) return false;
    if (flags & ~kAllFlags) return false;
    for (size_t i = 0; i < frames.size(); ++i) {
      const Frame& f = frames[i];
      if (!anim && f.frame_num > 1) return false;
      if (f.complete) {
        if (!f.alpha_size && !f.img_size) return false;
        if (f.alpha_size && f.alpha_off > f.img_off) return false;
        if (f.width <= 0 || f.height <= 0) return false;
      } else {
        if (state == STATE_DONE) return false;
        if (f.alpha_size && f.img_size && f.alpha_off > f.img_off) return false;
        if (i + 1 < frames.size()) return false;
      }
      if (f.width > 0 && f.height > 0) {
        if (!anim) {
          if (f.x_off || f.y_off || f.width != canvas_w || f.height != canvas_h) return false;
        } else if (f.x_off < 0 || f.y_off < 0 || f.width + f.x_off > canvas_w ||
                   f.height + f.y_off > canvas_h) {
          return false;
        }
      }
    }
    return true;
  }

  // WebPDemux (whole data, no partial file): false where libwebp returns NULL.
  bool parse(const uint8_t* d, size_t n) {
    mem.buf = d;
    if (n < 20) return false;  // ReadHeader: too little data
    const uint32_t riff = le32(d + 4);
    if (riff < 8 || riff > kMaxChunkPayload) return false;  // and no raw VP8/VP8L stream either
    mem.riff_end = (size_t)riff + 8;
    if (n < mem.riff_end) return false;  // partial
    mem.end = mem.riff_end;
    mem.start = 12;
    Parse status = P_ERROR;
    const uint8_t* id = d + 12;
    const bool simple = !memcmp(id, "VP8 ", 4) || !memcmp(id, "VP8L", 4);
    if (simple)
      status = single_image();
    else if (!memcmp(id, "VP8X", 4))
      status = vp8x();
    else
      return false;
    if (status == P_OK) state = STATE_DONE;
    if (status == P_MORE) status = P_ERROR;
    if (status != P_ERROR && !(simple ? valid_simple() : valid_extended())) status = P_ERROR;
    return status != P_ERROR;
  }
};

// WebPGetFeatures of the whole file (webp_dec.c's ParseHeadersInternal, not
// all data required), which WebPAnimDecoderNew asks before the demuxer: a
// VP8X chunk of exactly 10 bytes; in a still VP8X file the chunks before
// the first image within the RIFF size and that image the canvas's size.
// Too little data passes where a VP8X chunk was read.
bool features_ok(const uint8_t* d, size_t n) {
  if (n < 12) return false;
  if (memcmp(d + 8, "WEBP", 4)) return false;
  const uint32_t riff = le32(d + 4);
  if (riff < 12 || riff > kMaxChunkPayload) return false;
  d += 12;
  n -= 12;
  if (n < 8) return false;
  bool vp8x = false;
  int canvas_w = 0, canvas_h = 0;
  if (!memcmp(d, "VP8X", 4)) {
    if (le32(d + 4) != 10) return false;
    if (n < 18) return true;
    const uint32_t flags = le32(d + 8);
    canvas_w = 1 + (int)le24(d + 12);
    canvas_h = 1 + (int)le24(d + 15);
    if ((uint64_t)canvas_w * canvas_h >= (1ULL << 32)) return false;
    if (flags & kAnimFlag) return true;
    d += 18;
    n -= 18;
    vp8x = true;
  }
  if (n < 4) return vp8x;
  if (vp8x) {  // ParseOptionalChunks, up to the first 'VP8 ' or 'VP8L'
    uint32_t total = 4 + 8 + 10;
    for (;;) {
      if (n < 8) return true;
      const uint32_t size = le32(d + 4);
      if (size > kMaxChunkPayload) return false;
      const uint32_t disk = (8 + size + 1) & ~1u;
      total += disk;
      if (total > riff) return false;
      if (!memcmp(d, "VP8 ", 4) || !memcmp(d, "VP8L", 4)) break;
      if (n < disk) return true;
      d += disk;
      n -= disk;
    }
  }
  if (n < 8) return vp8x;
  const bool lossless = !memcmp(d, "VP8L", 4);
  size_t chunk = n;
  if (lossless || !memcmp(d, "VP8 ", 4)) {
    chunk = le32(d + 4);
    if (riff >= 12 && chunk > riff - 12) return false;
    d += 8;
    n -= 8;
  }
  int w = 0, h = 0, alpha;
  if (n < (lossless ? 5u : 10u)) return vp8x;
  if (!(lossless ? vp8l_info(d, n, w, h, alpha) : vp8_info(d, n, chunk, w, h))) return false;
  return !vp8x || (w == canvas_w && h == canvas_h);
}

}  // namespace

namespace sigwebp {

int decode(const uint8_t* data, size_t size, int64_t max_pixels, std::vector<uint8_t>& gray, int& w,
           int& h, std::string& msg) {
  try {
    if (!features_ok(data, size)) refuse("WebP headers libwebp's decoder refuses");
    Demux dmx;
    if (!dmx.parse(data, size)) refuse("WebP container libwebp's demuxer refuses");
    w = dmx.canvas_w;
    h = dmx.canvas_h;
    if ((int64_t)w * h > max_pixels)
      refuse("WebP canvas of " + std::to_string((int64_t)w * h) +
             " pixels (PIL's decompression-bomb limit is " + std::to_string(max_pixels) + ")");
    const Frame* first = nullptr;
    for (const Frame& f : dmx.frames)
      if (f.frame_num == 1) {
        first = &f;
        break;
      }
    if (!first || dmx.num_frames < 1) refuse("WebP file has no first frame");
    const uint8_t* img = data + first->img_off;
    const size_t img_payload = first->img_size - 8;
    gray.assign((size_t)w * h, 0);
    uint8_t* out = gray.data() + (size_t)first->y_off * w + first->x_off;
    if (!memcmp(img, "VP8L", 4)) {
      const std::vector<uint32_t> px = decode_vp8l(img + 8, img_payload);
      for (int y = 0; y < first->height; ++y)
        for (int x = 0; x < first->width; ++x) {
          const uint32_t p = px[(size_t)y * first->width + x];
          out[(size_t)y * w + x] = luma((p >> 16) & 0xff, (p >> 8) & 0xff, p & 0xff);
        }
    } else {
      Lossy dec;
      dec.decode(img + 8, img_payload);
      if (first->alpha_size) {
        const uint8_t* a = data + first->alpha_off;
        if (!alpha_ok(a + 8, le32(a + 4), dec.width, dec.height)) refuse("WebP alpha (ALPH) data libwebp refuses");
      }
      vp8_grey(dec, out, w);
    }
    return 0;
  } catch (const Refused& e) {
    msg = e.msg;
  } catch (const std::bad_alloc&) {
    msg = "out of memory";
  }
  gray.clear();
  return 1;
}

}  // namespace sigwebp
