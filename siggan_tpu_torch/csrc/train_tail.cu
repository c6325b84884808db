// Kernel B2: the train-mode forward of the packed generator tail, without
// gradient (the generator forward of every discriminator step).
//
// Replaces siggan_tpu/ops/pallas/train_tail.py::tail_forward_train (its
// three pallas_calls: _entry_kernel, _interior_kernel, _final_kernel, and
// _stats_to_affine between them). Bound with ctypes by
// siggan_tpu_torch/ops/kernels/train_tail.py, which holds the plain PyTorch
// version beside it.
//
// What it computes. From h0 (N, H, W, Ci), the last pixel-space activation:
//   K_entry     3x3 s1p1 conv to the packed (N, H, W, 4Co);
//   K_interior  per interior block: the previous BN's affine + ReLU fused
//               into the load, then the packed ConvT(4, 2, 1) as its 4
//               output phases, each a 2x2-tap conv over the input grid;
//   K_final     affine + ReLU on load, 3x3 conv to the 4 packed image
//               channels, + bias, tanh.
// After K_entry and each K_interior, bn_finalize turns per-block partial
// sums into the BN layer's statistics: the phase-pooled E[y^2] - E[y]^2,
// the folded affine (rounded to the compute dtype) that the next kernel
// reads, and the new running mean and unbiased variance (momentum 0.1, eps
// 1e-5), written straight into the caller's buffers. Activations are bf16
// or f32, every sum is f32, and the statistics come from the f32 conv
// result before it is rounded to the compute dtype, as in the TPU kernel.
// There are no float atomics: each conv block writes its own partial row,
// and bn_finalize sums the rows in a fixed order, so two runs on the same
// inputs give the same bits. One host call (siggan_train_tail) launches
// every kernel on the caller's stream; nothing leaves the card in between.
//
// Data parallelism needs the global batch's statistics, so the ranks' sums
// must be added between a layer's conv and its finalize. The layer route
// (siggan_train_tail_stage, one host call a stage) splits bn_finalize there:
// bn_totals_kernel writes the layer's 8 C totals (phase sums and sums of
// squares of each canonical channel), the caller all-reduces them on its
// stream, and bn_from_totals_kernel finalizes with the global count. Both
// halves share bn_finalize's arithmetic, so on one rank the layer route
// gives the single call's bits.
//
// Weights are read in the layouts kernel B1 writes (csrc/pack_tail.cu):
// entry OIHW (4Co, Ci, 3, 3), interior IOHW (4Ci, 4Co, 4, 4), final
// (4C, 3, 3, 4). Their pack laws zero whole (tap, input phase, output
// phase) blocks: of the entry's 9 taps 4 are live for each output phase,
// of the interior's 2x2 taps x 4 input phases 4 of 16, of the final's 9
// taps 2.25 on average for each (input phase, output phase). No kernel
// multiplies a dead block, so each does the canonical ConvT's work, and
// the kernels take only B1's packed weights, never arbitrary ones. The
// f32 tile skips dead chunks by `range_live`, the final conv by
// `final_live`; the bf16 kernels read each canonical tap from the one
// packed position `relayout_kernel` names. Their Python mirrors are held
// against the pack law in tests/test_torch_port_train_tail.py
// (`_range_live`, `_final_live`, `_canonical_tap`).
//
// What bounds it on an H100. Train-mode BN needs the whole batch's
// statistics before the next layer may read its input, so each pre-BN
// intermediate is written once and read once. At the full-width models and
// batch 64 in bf16 that is ~50 MB (64 px) and ~193 MB (128 px) of
// compulsory traffic, 0.015 / 0.058 ms at 3.35 TB/s, against 4.4 / 17.8
// GFLOP of canonical work, 0.0045 / 0.018 ms at the bf16 tensor peak:
// bound by bytes. In f32 (no tensor cores: TF32 would miss the f32 bars)
// the canonical FLOPs at the 67 TFLOP/s CUDA-core rate bound it.
//
// Design.
// - bf16 entry / interior (convt_mma_kernel): each layer as the canonical
//   ConvT(4, 2, 1), 4 output phases x 2x2 taps, on the tensor cores
//   (mma.sync m16n8k16 bf16 -> f32, ldmatrix). A block owns an 8 x 16 tile
//   of output pixels in all 4 phases and stages the tile's input halo once
//   per 32-channel chunk with 16-byte cp.async copies (zero-filled outside
//   the image), double-buffered; all 16 (phase, tap) products read it from
//   shared memory, so an activation crosses from L2 about 1.3 times per
//   layer instead of once per tap and channel block. The previous BN's
//   affine + ReLU is applied in shared memory by the thread that staged the
//   piece, rounded to bf16 once, never on padding. The weights' canonical
//   taps come from one relayout launch per host call, staged as 16-byte
//   vectors beside the halo. The epilogue sums each channel's f32 results
//   with shuffles, combines the two row halves in a fixed order, and writes
//   the bf16 tile through shared memory as coalesced 16-byte stores.
// - f32 entry / interior (conv_tile_kernel): CUDA-core FMAs, 128 pixels x
//   32 channels a block, 16-channel chunks, dead chunks skipped.
// - Final conv (final_conv_kernel, both dtypes): N = 4 is too narrow for
//   the tensor cores. A block stages a 16 x 32 output tile's halo 32
//   bytes a pixel at a time (16 bf16 or 8 f32 channels, two 16-byte
//   loads issued a chunk ahead into registers), keeps all Cin x 9 x 4
//   weights in shared memory, and gives each thread 4 pixels x 4 outputs;
//   a chunk inside one input phase runs only the taps its pack law keeps
//   live (9 of 36 per channel).
#include <cuda_bf16.h>
#include <cstdint>

#include "async_copy.cuh"
#include "common.cuh"

namespace {

constexpr int kBM = 128;  // f32 tile: output pixels per block
constexpr int kBN = 32;   // f32 tile: output channels per block
constexpr int kBK = 16;   // f32 tile: input channels per reduction chunk
constexpr int kThreads = 256;
constexpr int kMaxLayers = 8;
constexpr int kMaxChannels = 512;

// Final conv.
constexpr int kFinTW = 32, kFinTH = 16;  // output tile
constexpr int kFinWords = 8;             // 4-byte words of a pixel per staged chunk
constexpr int kFinThreads = 128;         // 4 pixels of one row each
constexpr int kFinHaloW = kFinTW + 2, kFinHaloH = kFinTH + 2;
constexpr int kFinRow = 41;              // odd row stride: the 4 rows of a warp hit distinct banks
constexpr int kFinPlane = kFinHaloH * kFinRow;

enum Kind { kEntry = 0, kInterior = 1 };

// Round to bf16, kept as a float.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Eight consecutive activation values (16-byte aligned) as floats.
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Four consecutive output values (aligned to 4 elements).
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 r;
  r.x = *reinterpret_cast<uint32_t*>(&lo);
  r.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = r;
}

// Whether B1's pack law can put a non-zero in the packed weight block of
// kernel index (r, c) (entry: conv tap (a, b); interior: ConvT (ky, kx)),
// input phase p and output phase q (csrc/pack_tail.cu, source_of).
__host__ __device__ __forceinline__ bool block_live(int kind, int r, int c, int p, int q) {
  const int qr = q >> 1, qc = q & 1;
  int u, v;
  if (kind == kEntry) {
    u = 3 - 2 * r + qr;
    v = 3 - 2 * c + qc;
  } else {
    u = 2 * r + qr - 2 * (p >> 1) - 1;
    v = 2 * c + qc - 2 * (p & 1) - 1;
  }
  return u >= 0 && u <= 3 && v >= 0 && v <= 3;
}

// Whether any block of input phases p_lo..p_hi and output phases
// q_lo..q_hi is live at kernel index (r, c): a chunk of input channels and
// a range of output channels may straddle phases at narrow widths.
__host__ __device__ __forceinline__ bool range_live(int kind, int r, int c, int p_lo,
                                                    int p_hi, int q_lo, int q_hi) {
  for (int p = p_lo; p <= p_hi; ++p)
    for (int q = q_lo; q <= q_hi; ++q)
      if (block_live(kind, r, c, p, q)) return true;
  return false;
}

// The final conv's law (out (4C, 3, 3, 4) from OIHW (1, C, 3, 3)): tap
// (a, b) links input phase p to output phase q iff the canonical tap
// u = 2a - 1 - qr + pr, v = 2b - 1 - qc + pc lies in the 3x3 kernel.
// p = 4 stands for a chunk that spans input phases: every tap is live.
__host__ __device__ constexpr bool final_live(int p, int a, int b, int q) {
  return p > 3 || (2 * a - 1 - (q >> 1) + (p >> 1) >= 0 && 2 * a - 1 - (q >> 1) + (p >> 1) <= 2 &&
                   2 * b - 1 - (q & 1) + (p & 1) >= 0 && 2 * b - 1 - (q & 1) + (p & 1) <= 2);
}

// Kernel index (r, c) and input offset (dy, dx) of reduction tap `tap`:
// the entry's 3x3 taps; an interior's 2x2 taps of output phase (di, dj).
template <int KIND>
__device__ __forceinline__ void tap_geometry(int tap, int di, int dj, int& r, int& c,
                                             int& dy, int& dx) {
  if (KIND == kEntry) {
    r = tap / 3;
    c = tap % 3;
    dy = r - 1;
    dx = c - 1;
  } else {
    const int ta = tap >> 1, tb = tap & 1;
    r = 3 - di - 2 * ta;
    c = 3 - dj - 2 * tb;
    dy = di - 1 + ta;
    dx = dj - 1 + tb;
  }
}

struct ConvArgs {      // the f32 tile's
  const float* x;     // input (N, H, W, Cin)
  const float* w;     // B1's packed weight
  const float* a;     // prologue affine (Cin,), or null for the entry
  const float* b;
  float* y;           // output: entry (N, H, W, Cout), interior (N, 2H, 2W, Cout)
  float* psum;        // partial sums [Cout][rows]
  float* psq;         // partial sums of squares [Cout][rows]
  int N, H, W;        // input grid
  int Cin, Cout;
  int Ci, Co;         // canonical channels per phase: Cin/4 (interior), Cout/4
  int rows;           // gridDim.x * gridDim.z
};

// ---------------------------------------------------------------------------
// f32 entry / interior conv tile on the CUDA cores. Grid (M tiles, Cout
// tiles, phases).
template <int KIND>
__global__ void __launch_bounds__(kThreads) conv_tile_kernel(ConvArgs g) {
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][kBN];
  const float* __restrict__ x = g.x;
  const float* __restrict__ w = g.w;
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / 4);  // 4 output channels each
  const int ty = tid / (kBN / 4);  // 4 output pixels each
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int phase = blockIdx.z;
  const int di = phase >> 1, dj = phase & 1;
  const int M = g.N * g.H * g.W;
  const int q_lo = n0 / g.Co;
  const int q_hi = (min(n0 + kBN, g.Cout) - 1) / g.Co;

  // The activation row this thread stages: pixel m0 + tid / 2, channels
  // (tid % 2) * 8 .. + 7 of each chunk.
  const int lm = tid >> 1;
  const int lc = (tid & 1) * 8;
  const int am = m0 + lm;
  const bool arow = am < M;
  const int aimg = arow ? am / (g.H * g.W) : 0;
  const int ai = arow ? (am / g.W) % g.H : 0;
  const int aj = arow ? am % g.W : 0;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int ntaps = KIND == kEntry ? 9 : 4;
  for (int tap = 0; tap < ntaps; ++tap) {
    int r, c, dy, dx;
    tap_geometry<KIND>(tap, di, dj, r, c, dy, dx);
    const int iy = ai + dy, ix = aj + dx;
    const bool inb = arow && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
    const float* xrow =
        inb ? x + ((static_cast<size_t>(aimg) * g.H + iy) * g.W + ix) * g.Cin : x;
    for (int ci0 = 0; ci0 < g.Cin; ci0 += kBK) {
      const bool live = KIND == kEntry
          ? range_live(kEntry, r, c, 0, 0, q_lo, q_hi)
          : range_live(kInterior, r, c, ci0 / g.Ci, (ci0 + kBK - 1) / g.Ci, q_lo, q_hi);
      if (!live) continue;  // uniform over the block

      float v[8];
      if (inb) {
        load8(xrow + ci0 + lc, v);
        if (KIND == kInterior) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int ci = ci0 + lc + e;
            v[e] = fmaxf(fmaf(v[e], __ldg(g.a + ci), __ldg(g.b + ci)), 0.f);
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = 0.f;  // zero padding after the prologue
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) As[lc + e][lm] = v[e];

#pragma unroll
      for (int rep = 0; rep < (kBK * kBN) / kThreads; ++rep) {
        const int e = tid + rep * kThreads;
        const int kk = e / kBN, nn = e % kBN;
        const int o = n0 + nn, ci = ci0 + kk;
        float wv = 0.f;
        if (o < g.Cout) {
          size_t idx;
          if (KIND == kEntry)
            idx = ((static_cast<size_t>(o) * g.Cin + ci) * 3 + r) * 3 + c;
          else
            idx = ((static_cast<size_t>(ci) * g.Cout + o) * 4 + r) * 4 + c;
          wv = w[idx];
        }
        Bs[kk][nn] = wv;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // Per-block partial statistics from the f32 results (rows past M are 0).
  float* red = &As[0][0];  // [2][kBM / 4][kBN], 2048 floats
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s += acc[i][j];
      q = fmaf(acc[i][j], acc[i][j], q);
    }
    red[ty * kBN + tx * 4 + j] = s;
    red[(kBM / 4) * kBN + ty * kBN + tx * 4 + j] = q;
  }
  __syncthreads();
  if (tid < 2 * kBN) {
    const int nn = tid % kBN;
    const float* src = red + (tid / kBN) * (kBM / 4) * kBN + nn;
    float t = 0.f;
    for (int k = 0; k < kBM / 4; ++k) t += src[k * kBN];
    const int o = n0 + nn;
    if (o < g.Cout) {
      const size_t at = static_cast<size_t>(o) * g.rows + phase * gridDim.x + blockIdx.x;
      (tid < kBN ? g.psum : g.psq)[at] = t;
    }
  }

  const int o0 = n0 + tx * 4;
  if (o0 < g.Cout) {
    float* y = g.y;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty * 4 + i;
      if (m >= M) continue;
      const int img = m / (g.H * g.W);
      const int pi = (m / g.W) % g.H, pj = m % g.W;
      size_t pix;
      if (KIND == kEntry)
        pix = (static_cast<size_t>(img) * g.H + pi) * g.W + pj;
      else
        pix = (static_cast<size_t>(img) * 2 * g.H + 2 * pi + di) * 2 * g.W + 2 * pj + dj;
      store4(y + pix * g.Cout + o0, acc[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 entry / interior: the canonical ConvT(4, 2, 1) on the tensor cores.
//
// Both layers are a canonical ConvT whose output, in packed form, has the
// canonical input's grid: output packed pixel (Py, Px), output phase
// q = (qr, qc) is canonical pixel (2Py + qr, 2Px + qc), the sum over taps
// (ta, tb) in 2x2 of canonical input (Py + qr + ta - 1, Px + qc + tb - 1)
// times the canonical weight at (ky, kx) = (3 - qr - 2ta, 3 - qc - 2tb).
// The entry's canonical input is h0 itself; an interior's canonical pixel
// (y, x) is packed pixel (y/2, x/2), channels p Ci .. + Ci - 1 with
// p = 2 (y % 2) + x % 2. Only canonical taps are multiplied: the pack law's
// zero blocks never enter.
//
// A block owns an 8 x 16 tile of output packed pixels and 32 canonical
// output channels, in all 4 output phases (128 packed channels). Per chunk
// of 32 input channels it stages, by cp.async, the tile's 10 x 18 input
// halo once and the weights of its 16 (phase, tap) pairs; warp (q, half)
// computes phase q of 4 tile rows (one m16 tile per row) over the 4 taps,
// its ldmatrix rows pointing at shifted halo pixels. Rows of 64 bytes are
// XOR-swizzled in 16-byte units so that ldmatrix reads 8 consecutive rows
// without bank conflicts. Two stages: the next chunk loads while this one
// is multiplied.

constexpr int kTY = 8, kTX = 16;                 // output packed tile
constexpr int kHY = kTY + 2, kHX = kTX + 2;      // its canonical input halo
constexpr int kCK = 32;                          // input channels per chunk
constexpr int kCN = 32;                          // canonical output channels per block
constexpr int kRowBytes = kCK * 2;               // one staged row: 32 bf16
constexpr int kABytes = kHY * kHX * kRowBytes;   // the halo
constexpr int kBBytes = 16 * kCN * kRowBytes;    // 16 (phase, tap) x 32 output channels
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kOutRow = 4 * kCN + 8;             // output tile row (bf16), padded

// Byte offset of byte b of staged row r: 16-byte unit u -> u ^ (r / 2 % 4).
__device__ __forceinline__ int swz(int r, int b) {
  return r * kRowBytes + ((((b >> 4) ^ (r >> 1)) & 3) << 4) + (b & 15);
}

// cp.async of 16 or 8 bytes with zero fill (async_copy.cuh).
using siggan::cp_async;
using siggan::cp_async_commit;
using siggan::cp_async_wait_all;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct ConvTArgs {
  const __nv_bfloat16* x;   // entry: h0 (N, Hin, Win, Ci); interior: packed (N, Hin, Win, 4Ci)
  const __nv_bfloat16* w;   // relayout [q][tap][Co][Ci] (relayout_kernel)
  const float* a;           // interior: the previous BN's affine over 4Ci packed channels
  const float* b;
  __nv_bfloat16* y;         // (N, Ho, Wo, 4Co) packed
  float* psum;              // partial sums [4Co][rows]
  float* psq;
  int N, Hin, Win, Ho, Wo;  // input grid; output packed grid (the canonical input's)
  int Ci, Co;               // canonical channels
  int rows;                 // gridDim.x * gridDim.z
};

size_t convt_smem_bytes(int cin_packed) {
  return 2 * kStageBytes + 2 * sizeof(float) * cin_packed;
}

// Grid (tiles of the output grid, Co / 32, N). PIECE: channels per copy,
// 8 (16 bytes) or 4 (8 bytes, for Ci = 4 mod 8).
template <int KIND, int PIECE>
__global__ void __launch_bounds__(kThreads, 2) convt_mma_kernel(ConvTArgs g) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* aff = reinterpret_cast<float*>(smem + 2 * kStageBytes);
  __shared__ float red[2][2][4 * kCN];  // [sum, sq][half][phase, channel]
  constexpr int kPieces = kCK / PIECE;  // per staged row
  constexpr int kPieceBytes = 2 * PIECE;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = warp >> 1, half = warp & 1, qr = q >> 1, qc = q & 1;
  const int tiles_x = (g.Wo + kTX - 1) / kTX;
  const int y0 = (blockIdx.x / tiles_x) * kTY, x0 = (blockIdx.x % tiles_x) * kTX;
  const int co0 = blockIdx.y * kCN, n = blockIdx.z;
  const int cinp = KIND == kEntry ? g.Ci : 4 * g.Ci;  // channels of an input pixel
  const int nk = (g.Ci + kCK - 1) / kCK;
  if (KIND == kInterior) {
    for (int i = tid; i < cinp; i += kThreads) {
      aff[i] = g.a[i];
      aff[cinp + i] = g.b[i];
    }
    __syncthreads();
  }

  // Halo piece e: its input element offset, or -1 outside the image / Ci.
  auto halo_src = [&](int e, int ci0) -> int {
    const int pix = e / kPieces, ci = ci0 + (e % kPieces) * PIECE;
    const int gy = y0 - 1 + pix / kHX, gx = x0 - 1 + pix % kHX;
    if (gy < 0 || gy >= g.Ho || gx < 0 || gx >= g.Wo || ci >= g.Ci) return -1;
    if (KIND == kEntry) return ((n * g.Hin + gy) * g.Win + gx) * cinp + ci;
    return ((n * g.Hin + (gy >> 1)) * g.Win + (gx >> 1)) * cinp +
           ((gy & 1) * 2 + (gx & 1)) * g.Ci + ci;
  };
  auto load_chunk = [&](int it) {
    unsigned char* sa = smem + (it & 1) * kStageBytes;
    unsigned char* sb = sa + kABytes;
    const int ci0 = it * kCK;
    for (int e = tid; e < kHY * kHX * kPieces; e += kThreads) {
      const int src = halo_src(e, ci0);
      cp_async<kPieceBytes>(sa + swz(e / kPieces, (e % kPieces) * kPieceBytes),
                            src < 0 ? g.x : g.x + src, src < 0 ? 0 : kPieceBytes);
    }
    for (int e = tid; e < 16 * kCN * kPieces; e += kThreads) {
      const int row = e / kPieces, ci = ci0 + (e % kPieces) * PIECE;
      const int co = co0 + row % kCN;  // row = (q * 4 + tap) * 32 + channel
      const bool ok = co < g.Co && ci < g.Ci;
      cp_async<kPieceBytes>(sb + swz(row, (e % kPieces) * kPieceBytes),
                            ok ? g.w + (static_cast<size_t>(row / kCN) * g.Co + co) * g.Ci + ci
                               : g.w,
                            ok ? kPieceBytes : 0);
    }
    cp_async_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  load_chunk(0);
  for (int it = 0; it < nk; ++it) {
    cp_async_wait_all();
    unsigned char* sa = smem + (it & 1) * kStageBytes;
    if (KIND == kInterior) {
      // The previous BN's affine + ReLU on this thread's own pieces,
      // rounded to bf16 once; padding (and channels past Ci) stays zero.
      for (int e = tid; e < kHY * kHX * kPieces; e += kThreads) {
        const int src = halo_src(e, it * kCK);
        if (src < 0) continue;
        const int ch = src % cinp;  // the packed channel, for the affine
        __nv_bfloat162* v =
            reinterpret_cast<__nv_bfloat162*>(sa + swz(e / kPieces, (e % kPieces) * kPieceBytes));
#pragma unroll
        for (int k = 0; k < PIECE / 2; ++k) {
          const float2 f = __bfloat1622float2(v[k]);
          const int c = ch + 2 * k;
          v[k] = __floats2bfloat162_rn(fmaxf(fmaf(f.x, aff[c], aff[cinp + c]), 0.f),
                                       fmaxf(fmaf(f.y, aff[c + 1], aff[cinp + c + 1]), 0.f));
        }
      }
    }
    __syncthreads();
    if (it + 1 < nk) load_chunk(it + 1);

    const unsigned abase = static_cast<unsigned>(__cvta_generic_to_shared(sa));
    const unsigned bbase = abase + kABytes;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int ta = t >> 1, tb = t & 1;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        if (it * kCK + kk * 16 >= g.Ci) continue;  // uniform: past Ci all is zero
        uint32_t b[4][2];
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t r4[4];
          const int row = (q * 4 + t) * kCN + np * 16 + (lane & 7) + (lane >> 4) * 8;
          ldmatrix_x4(r4, bbase + swz(row, kk * 32 + ((lane >> 3) & 1) * 16));
          b[2 * np][0] = r4[0];
          b[2 * np][1] = r4[1];
          b[2 * np + 1][0] = r4[2];
          b[2 * np + 1][1] = r4[3];
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          const int hy = half * 4 + mi + qr + ta, hx = (lane & 15) + qc + tb;
          uint32_t a[4];
          ldmatrix_x4(a, abase + swz(hy * kHX + hx, kk * 32 + (lane >> 4) * 16));
#pragma unroll
          for (int nj = 0; nj < 4; ++nj) mma_bf16(acc[mi][nj], a, b[nj][0], b[nj][1]);
        }
      }
    }
  }

  // Per-block partial statistics from the f32 results of the tile's pixels
  // inside the output grid: a thread's 8 rows per channel, then the lanes
  // of one channel (xor 4, 8, 16), then the two halves in a fixed order.
#pragma unroll
  for (int nj = 0; nj < 4; ++nj) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = 0.f, sq = 0.f;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int py = y0 + half * 4 + mi, px = x0 + (lane >> 2) + 8 * hh;
          const float v = py < g.Ho && px < g.Wo ? acc[mi][nj][2 * hh + e] : 0.f;
          s += v;
          sq = fmaf(v, v, sq);
        }
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        sq += __shfl_xor_sync(0xffffffffu, sq, off);
      }
      if (lane < 4) {
        const int col = q * kCN + nj * 8 + lane * 2 + e;
        red[0][half][col] = s;
        red[1][half][col] = sq;
      }
    }
  }
  __syncthreads();  // also: every warp is done with the ring
  const int row = blockIdx.z * gridDim.x + blockIdx.x;
  if (tid < 4 * kCN && co0 + tid % kCN < g.Co) {
    const size_t at = static_cast<size_t>((tid / kCN) * g.Co + co0 + tid % kCN) * g.rows + row;
    g.psum[at] = red[0][0][tid] + red[0][1][tid];
    g.psq[at] = red[1][0][tid] + red[1][1][tid];
  }

  // The tile in bf16 through shared memory, then coalesced stores: 16 bytes
  // (8 channels) a thread, or 4 bytes where Co is not a multiple of 8.
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem);  // [128 px][kOutRow]
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int px = (half * 4 + mi) * kTX + (lane >> 2) + 8 * hh;
        const int col = q * kCN + nj * 8 + (lane & 3) * 2;
        *reinterpret_cast<__nv_bfloat162*>(tile + px * kOutRow + col) =
            __floats2bfloat162_rn(acc[mi][nj][2 * hh], acc[mi][nj][2 * hh + 1]);
      }
  __syncthreads();
  const int unit = g.Co % 8 == 0 ? 8 : 2;
  const int per_px = 4 * kCN / unit;
  for (int e = tid; e < kTY * kTX * per_px; e += kThreads) {
    const int px = e / per_px, col = (e % per_px) * unit;
    const int oq = col / kCN, co = co0 + col % kCN;
    const int py = y0 + px / kTX, pxx = x0 + px % kTX;
    if (py >= g.Ho || pxx >= g.Wo || co >= g.Co) continue;
    __nv_bfloat16* dst =
        g.y + ((static_cast<size_t>(n) * g.Ho + py) * g.Wo + pxx) * 4 * g.Co + oq * g.Co + co;
    if (unit == 8)
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(tile + px * kOutRow + col);
    else
      *reinterpret_cast<uint32_t*>(dst) =
          *reinterpret_cast<const uint32_t*>(tile + px * kOutRow + col);
  }
}

// B1's packed bf16 conv weights -> the canonical taps of each output phase,
// [q][tap][Co][Ci]. Tap (ta, tb) of phase q = (qr, qc) is packed
//   entry    OIHW (4Co, Ci, 3, 3)  [q Co + co][ci][qr + ta][qc + tb]
//   interior IOHW (4Ci, 4Co, 4, 4) [ci][q Co + co][2 - qr - ta][2 - qc - tb]
// (input phase 0), where the pack law put the canonical weight at
// (3 - qr - 2ta, 3 - qc - 2tb). One element a thread; grid (elements of the
// largest layer, layers).
struct Relayout {
  const __nv_bfloat16* src[kMaxLayers];
  __nv_bfloat16* dst[kMaxLayers];
  int kind[kMaxLayers];
  int ci[kMaxLayers];
  int co[kMaxLayers];
};

__global__ void __launch_bounds__(kThreads) relayout_kernel(Relayout d) {
  const int l = blockIdx.y;
  const int Ci = d.ci[l], Co = d.co[l];
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= 16 * Co * Ci) return;
  const int ci = e % Ci, co = (e / Ci) % Co, qt = e / (Ci * Co);
  const int q = qt >> 2, t = qt & 3;
  const int qr = q >> 1, qc = q & 1, ta = t >> 1, tb = t & 1;
  const int src = d.kind[l] == kEntry
      ? (((q * Co + co) * Ci + ci) * 3 + qr + ta) * 3 + qc + tb
      : ((ci * 4 * Co + q * Co + co) * 4 + 2 - qr - ta) * 4 + 2 - qc - tb;
  d.dst[l][e] = d.src[l][src];
}

// ---------------------------------------------------------------------------
// The BN statistics of a layer, in two halves so that a data-parallel run
// can add the ranks' totals between them (the layer route,
// siggan_train_tail_stage): phase_totals sums canonical channel c's partial
// rows, of its 4 phase channels, in a fixed order; finalize_channel turns
// the 8 totals (4 phase sums, then 4 phase sums of squares) into the
// statistics. bn_finalize_kernel does both in one block, the single host
// call's route; bn_totals_kernel and bn_from_totals_kernel are the halves,
// with the same arithmetic, so that one rank's layer route gives the single
// call's bits.

// The block's 8 totals of channel c land in red[k][0].
__device__ __forceinline__ void phase_totals(const float* __restrict__ psum,
                                             const float* __restrict__ psq, int rows, int C,
                                             int c, float (*red)[kThreads]) {
  const int tid = threadIdx.x;
  float part[8];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float* s = psum + static_cast<size_t>(p * C + c) * rows;
    const float* q = psq + static_cast<size_t>(p * C + c) * rows;
    float ts = 0.f, tq = 0.f;
    for (int r = tid; r < rows; r += kThreads) {
      ts += s[r];
      tq += q[r];
    }
    part[p] = ts;
    part[4 + p] = tq;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) red[k][tid] = part[k];
  __syncthreads();
  for (int step = kThreads / 2; step > 0; step >>= 1) {
    if (tid < step) {
#pragma unroll
      for (int k = 0; k < 8; ++k) red[k][tid] += red[k][tid + step];
    }
    __syncthreads();
  }
}

// Channel c's statistics from its totals tot[k * stride] over `count`
// positions a phase: the running mean and unbiased variance, updated in
// place, and the folded affine (rounded to bf16 in bf16) for all 4 phases.
__device__ __forceinline__ void finalize_channel(const float* tot, int stride, int C, int c,
                                                 float count, float unbias,
                                                 const float* __restrict__ scale,
                                                 const float* __restrict__ offset,
                                                 float* run_mean, float* run_var, float* a4,
                                                 float* b4, int bf16) {
  float mean = 0.f, ey2 = 0.f;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    mean += tot[p * stride] / count;
    ey2 += tot[(4 + p) * stride] / count;
  }
  mean /= 4.f;
  ey2 /= 4.f;
  const float var = ey2 - mean * mean;
  run_mean[c] = __fadd_rn(__fmul_rn(0.9f, run_mean[c]), __fmul_rn(0.1f, mean));
  run_var[c] = __fadd_rn(__fmul_rn(0.9f, run_var[c]), __fmul_rn(0.1f, __fmul_rn(var, unbias)));
  float a = scale[c] * rsqrtf(var + 1e-5f);
  float b = offset[c] - mean * a;
  if (bf16) {
    a = round_bf16(a);
    b = round_bf16(b);
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    a4[p * C + c] = a;
    b4[p * C + c] = b;
  }
}

// One block per canonical channel c: its totals, then thread 0 writes the
// statistics.
__global__ void __launch_bounds__(kThreads)
bn_finalize_kernel(const float* __restrict__ psum, const float* __restrict__ psq,
                   int rows, int C, float count, float unbias,
                   const float* __restrict__ scale, const float* __restrict__ offset,
                   float* run_mean, float* run_var, float* a4, float* b4, int bf16) {
  __shared__ float red[8][kThreads];
  phase_totals(psum, psq, rows, C, blockIdx.x, red);
  if (threadIdx.x != 0) return;
  finalize_channel(&red[0][0], kThreads, C, blockIdx.x, count, unbias, scale, offset,
                   run_mean, run_var, a4, b4, bf16);
}

// One block per canonical channel c: its 8 totals into totals[k][C].
__global__ void __launch_bounds__(kThreads)
bn_totals_kernel(const float* __restrict__ psum, const float* __restrict__ psq, int rows,
                 int C, float* __restrict__ totals) {
  __shared__ float red[8][kThreads];
  phase_totals(psum, psq, rows, C, blockIdx.x, red);
  if (threadIdx.x != 0) return;
#pragma unroll
  for (int k = 0; k < 8; ++k) totals[k * C + blockIdx.x] = red[k][0];
}

// One thread per canonical channel: the statistics from totals[k][C] (the
// ranks' totals added) over `count` positions a phase.
__global__ void __launch_bounds__(kThreads)
bn_from_totals_kernel(const float* __restrict__ totals, int C, float count, float unbias,
                      const float* __restrict__ scale, const float* __restrict__ offset,
                      float* run_mean, float* run_var, float* a4, float* b4, int bf16) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  finalize_channel(totals + c, C, C, c, count, unbias, scale, offset, run_mean, run_var, a4,
                   b4, bf16);
}

// ---------------------------------------------------------------------------
// K_final: affine + ReLU on load, 3x3 conv Cin -> 4, + bias, tanh.
//
// A chunk is 32 bytes of each halo pixel (one memory sector): 16 bf16 or 8
// f32 channels, loaded as two 16-byte vectors and kept in shared memory as
// 8 words a pixel, bf16 channel pairs or f32 channels.

// Channels of a 32-byte chunk.
template <typename T>
__host__ __device__ constexpr int fin_channels() { return 32 / static_cast<int>(sizeof(T)); }

// Channel `sub` of a staged word as a float.
template <typename T>
__device__ __forceinline__ float word_value(uint32_t w, int sub);
template <>
__device__ __forceinline__ float word_value<float>(uint32_t w, int) { return __uint_as_float(w); }
template <>
__device__ __forceinline__ float word_value<__nv_bfloat16>(uint32_t w, int sub) {
  return __uint_as_float(sub ? w & 0xffff0000u : w << 16);
}

// One staged chunk: input phase P of the pack law, or 4 for a chunk that
// spans phases. xs: the chunk's 8 word planes of the halo; wc: its weights
// [channel][3][3][4]; a thread's 4 pixels x 4 outputs in acc.
template <int P, typename T>
__device__ __forceinline__ void final_chunk(const uint32_t* xs, const float* wc, int ty, int tx,
                                            float (&acc)[4][4]) {
  constexpr int kSub = fin_channels<T>() / kFinWords;  // channels a word
#pragma unroll 2
  for (int j = 0; j < kFinWords; ++j) {
    const uint32_t* xc = xs + j * kFinPlane + ty * kFinRow + tx * 4;
    uint32_t xw[3][6];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int k = 0; k < 6; ++k) xw[a][k] = xc[a * kFinRow + k];
#pragma unroll
    for (int sub = 0; sub < kSub; ++sub) {
      const float* w = wc + (j * kSub + sub) * 36;
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (!final_live(P, a, b, q)) continue;
            const float wv = w[(a * 3 + b) * 4 + q];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[i][q] = fmaf(word_value<T>(xw[a][i + b], sub), wv, acc[i][q]);
          }
    }
  }
}

size_t final_smem_bytes(int cin) {
  return sizeof(float) * (kFinWords * kFinPlane + cin * 36 + 2 * cin);
}

// Grid (W / 32, H / 16, N), 128 threads: thread (tx, ty) computes the
// pixels (y0 + ty, x0 + 4 tx .. + 3). The halo of the next chunk is loaded
// into registers while this one is multiplied.
template <typename T>
__global__ void __launch_bounds__(kFinThreads)
final_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ bias, T* __restrict__ img, int H, int W,
                  int Cin) {
  constexpr int kHalo = kFinHaloH * kFinHaloW;
  constexpr int kSlots = (kHalo + kFinThreads - 1) / kFinThreads;  // halo pixels a thread
  constexpr int kC = fin_channels<T>();
  extern __shared__ __align__(16) float fsm[];
  uint32_t* xs = reinterpret_cast<uint32_t*>(fsm);  // [kFinWords][kFinHaloH][kFinRow]
  float* ws = fsm + kFinWords * kFinPlane;          // [Cin][3][3][4]
  float* aff = ws + Cin * 36;                       // a[Cin], b[Cin]
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int x0 = blockIdx.x * kFinTW, y0 = blockIdx.y * kFinTH, n = blockIdx.z;
  const int C = Cin / 4;
  for (int e = tid * 8; e < Cin * 36; e += kFinThreads * 8) {
    float v[8];
    load8(w + e, v);
#pragma unroll
    for (int k = 0; k < 8; ++k) ws[e + k] = v[k];
  }
  for (int i = tid; i < Cin; i += kFinThreads) {
    aff[i] = a[i];
    aff[Cin + i] = b[i];
  }
  const T* xn = x + static_cast<size_t>(n) * H * W * Cin;
  uint4 raw[kSlots][2];
  unsigned inside = 0;  // bit s: halo pixel tid + s * kFinThreads is in the image
  auto fetch = [&](int ci0) {
    inside = 0;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int e = tid + s * kFinThreads;
      const int gy = y0 + e / kFinHaloW - 1, gx = x0 + e % kFinHaloW - 1;
      if (e < kHalo && gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const uint4* p = reinterpret_cast<const uint4*>(xn + (gy * W + gx) * Cin + ci0);
        raw[s][0] = __ldg(p);
        raw[s][1] = __ldg(p + 1);
        inside |= 1u << s;
      }
    }
  };
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;

  fetch(0);
  for (int ci0 = 0; ci0 < Cin; ci0 += kC) {
    __syncthreads();  // the previous chunk is consumed (the first: ws, aff are in)
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int e = tid + s * kFinThreads;
      if (e >= kHalo) continue;
      uint32_t words[kFinWords];
      if (inside >> s & 1) {
        float v[kC];
        if constexpr (kC == 16) {
          load8(reinterpret_cast<const __nv_bfloat16*>(&raw[s][0]),
                *reinterpret_cast<float(*)[8]>(v));
          load8(reinterpret_cast<const __nv_bfloat16*>(&raw[s][1]),
                *reinterpret_cast<float(*)[8]>(v + 8));
        } else {
          load8(reinterpret_cast<const float*>(&raw[s][0]), v);
        }
#pragma unroll
        for (int k = 0; k < kC; ++k)
          v[k] = fmaxf(fmaf(v[k], aff[ci0 + k], aff[Cin + ci0 + k]), 0.f);
#pragma unroll
        for (int j = 0; j < kFinWords; ++j) {
          if constexpr (kC == 16) {  // rounded to bf16 once
            const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
            words[j] = *reinterpret_cast<const uint32_t*>(&h);
          } else {
            words[j] = __float_as_uint(v[j]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kFinWords; ++j) words[j] = 0u;  // zero padding after the prologue
      }
      const int at = (e / kFinHaloW) * kFinRow + e % kFinHaloW;
#pragma unroll
      for (int j = 0; j < kFinWords; ++j) xs[j * kFinPlane + at] = words[j];
    }
    __syncthreads();
    if (ci0 + kC < Cin) fetch(ci0 + kC);
    const float* wc = ws + ci0 * 36;
    switch (C % kC == 0 ? ci0 / C : 4) {  // uniform over the block
      case 0: final_chunk<0, T>(xs, wc, ty, tx, acc); break;
      case 1: final_chunk<1, T>(xs, wc, ty, tx, acc); break;
      case 2: final_chunk<2, T>(xs, wc, ty, tx, acc); break;
      case 3: final_chunk<3, T>(xs, wc, ty, tx, acc); break;
      default: final_chunk<4, T>(xs, wc, ty, tx, acc); break;
    }
  }
  const int oy = y0 + ty;
  if (oy >= H) return;
  const float bv = bias[0];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ox = x0 + tx * 4 + i;
    if (ox >= W) continue;
    float out[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) out[q] = tanhf(acc[i][q] + bv);
    store4(img + ((static_cast<size_t>(n) * H + oy) * W + ox) * 4, out);
  }
}

// ---------------------------------------------------------------------------

struct Tail {
  int L;
  const void* const* ws;
  void* const* acts;
  const void* const* scales;
  const void* const* offsets;
  void* const* means;
  void* const* vars;
  const float* bias;
  float* scratch;
  long long scratch_floats;
  const int* chans;
  int N, H, W;
};

int ceil_div(int a, int b) { return (a + b - 1) / b; }

bool valid_shape(int L, const int* chans, int N, int H, int W) {
  if (L < 2 || L > kMaxLayers || N < 1 || H < 1 || W < 1 || chans[L] != 4) return false;
  for (int i = 0; i <= L; ++i) {
    if (chans[i] < 1 || (i > 0 && chans[i] % 4)) return false;
    if (i < L && (chans[i] % kBK || chans[i] > kMaxChannels)) return false;
  }
  // 32-bit element offsets in the kernels: the largest grid (the final
  // layer's) times any layer's channels.
  const long long pixels = (static_cast<long long>(N) * H * W) << (2 * (L - 2));
  for (int i = 0; i <= L; ++i)
    if (pixels * chans[i] >= (1LL << 31)) return false;
  return true;
}

// Canonical (Ci, Co) of conv layer i < L - 1.
void canonical(int i, const int* chans, int& ci, int& co) {
  ci = i == 0 ? chans[0] : chans[i] / 4;
  co = chans[i + 1] / 4;
}

// Partial-statistics rows of conv layer i (input grid h x w): the f32
// tile's blocks of kBM pixels x 4 output phases (1 for the entry), or the
// bf16 kernel's output tiles x N.
int stat_rows(int i, int N, int h, int w, bool bf16) {
  if (!bf16) return ceil_div(N * h * w, kBM) * (i > 0 ? 4 : 1);
  const int ho = i > 0 ? 2 * h : h, wo = i > 0 ? 2 * w : w;
  return ceil_div(ho, kTY) * ceil_div(wo, kTX) * N;
}

// Floats of f32 scratch: per BN layer the partial sums and squares
// [Cout][rows] of its conv blocks, then its folded affine a4, b4 [Cout];
// in bf16, after them (16-byte aligned), each conv weight's canonical taps
// (relayout_kernel).
long long stats_floats(int L, const int* chans, int N, int H, int W, bool bf16) {
  long long need = 0;
  int h = H, w = W;
  for (int i = 0; i + 1 < L; ++i) {
    need += 2LL * stat_rows(i, N, h, w, bf16) * chans[i + 1] + 2LL * chans[i + 1];
    if (i > 0) {
      h *= 2;
      w *= 2;
    }
  }
  return (need + 3) / 4 * 4;
}

long long relayout_elems(int i, const int* chans) {
  int ci, co;
  canonical(i, chans, ci, co);
  return 16LL * ci * co;
}

long long scratch_floats(int L, const int* chans, int N, int H, int W, bool bf16) {
  long long need = stats_floats(L, chans, N, H, W, bf16);
  if (bf16)
    for (int i = 0; i + 1 < L; ++i) need += (relayout_elems(i, chans) + 7) / 8 * 4;
  return need;
}

template <int KIND>
cudaError_t launch_convt(const ConvTArgs& g, dim3 grid, cudaStream_t stream) {
  const size_t smem = convt_smem_bytes(KIND == kEntry ? g.Ci : 4 * g.Ci);
  cudaError_t err;
  if (g.Ci % 8 == 0) {
    err = siggan::allow_smem(convt_mma_kernel<KIND, 8>, smem);
    if (err == cudaSuccess) convt_mma_kernel<KIND, 8><<<grid, kThreads, smem, stream>>>(g);
  } else {
    err = siggan::allow_smem(convt_mma_kernel<KIND, 4>, smem);
    if (err == cudaSuccess) convt_mma_kernel<KIND, 4><<<grid, kThreads, smem, stream>>>(g);
  }
  return err == cudaSuccess ? cudaGetLastError() : err;
}

// Where conv layer i < L - 1 keeps its statistics in the scratch, and its
// grids: per BN layer in order, the partial sums and squares [Cout][rows],
// then the folded affine a4, b4 [Cout].
struct Layer {
  float* psum;
  float* psq;
  float* a4;
  float* b4;
  int rows;
  int h, w;    // input grid
  int ho, wo;  // output grid
};

Layer layer_at(const Tail& t, int i, bool mma) {
  float* s = t.scratch;
  int h = t.H, w = t.W;
  for (int j = 0;; ++j) {
    const int cout = t.chans[j + 1];
    Layer l;
    l.rows = stat_rows(j, t.N, h, w, mma);
    l.psum = s;
    l.psq = s + static_cast<size_t>(cout) * l.rows;
    l.a4 = l.psq + static_cast<size_t>(cout) * l.rows;
    l.b4 = l.a4 + cout;
    l.h = h;
    l.w = w;
    l.ho = j > 0 ? 2 * h : h;
    l.wo = j > 0 ? 2 * w : w;
    if (j == i) return l;
    s = l.b4 + cout;
    h = l.ho;
    w = l.wo;
  }
}

// The input grid of the final conv.
void final_grid(const Tail& t, int& h, int& w) {
  h = t.H << (t.L - 2);
  w = t.W << (t.L - 2);
}

// bf16: every conv weight's canonical taps, laid out after the statistics;
// with `launch`, the one relayout launch that writes them.
cudaError_t canonical_taps(const Tail& t, __nv_bfloat16** taps, bool launch,
                           cudaStream_t stream) {
  Relayout d{};
  __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(
      t.scratch + stats_floats(t.L, t.chans, t.N, t.H, t.W, true));
  long long most = 0;
  for (int i = 0; i + 1 < t.L; ++i) {
    d.src[i] = static_cast<const __nv_bfloat16*>(t.ws[i]);
    d.dst[i] = taps[i] = dst;
    d.kind[i] = i == 0 ? kEntry : kInterior;
    canonical(i, t.chans, d.ci[i], d.co[i]);
    const long long n = relayout_elems(i, t.chans);
    dst += (n + 7) / 8 * 8;
    most = n > most ? n : most;
  }
  if (!launch) return cudaSuccess;
  const dim3 grid(static_cast<unsigned>(ceil_div(static_cast<int>(most), kThreads)), t.L - 1);
  relayout_kernel<<<grid, kThreads, 0, stream>>>(d);
  return cudaGetLastError();
}

// Conv layer i < L - 1 (the previous layer's affine a, b applied on load;
// null for the entry), writing its output and its partial statistics.
template <typename T>
cudaError_t conv_layer(const Tail& t, int i, const Layer& l, const float* a, const float* b,
                       __nv_bfloat16* const* taps, cudaStream_t stream) {
  constexpr bool kMma = sizeof(T) == 2;
  const int interior = i > 0;
  const int cin = t.chans[i], cout = t.chans[i + 1];
  if (kMma) {
    ConvTArgs g;
    g.x = static_cast<const __nv_bfloat16*>(t.acts[i]);
    g.w = taps[i];
    g.a = a;
    g.b = b;
    g.y = static_cast<__nv_bfloat16*>(t.acts[i + 1]);
    g.psum = l.psum;
    g.psq = l.psq;
    g.N = t.N;
    g.Hin = l.h;
    g.Win = l.w;
    g.Ho = l.ho;
    g.Wo = l.wo;
    canonical(i, t.chans, g.Ci, g.Co);
    g.rows = l.rows;
    const dim3 grid(ceil_div(g.Ho, kTY) * ceil_div(g.Wo, kTX), ceil_div(g.Co, kCN), t.N);
    return interior ? launch_convt<kInterior>(g, grid, stream)
                    : launch_convt<kEntry>(g, grid, stream);
  }
  ConvArgs g;
  g.x = static_cast<const float*>(t.acts[i]);
  g.w = static_cast<const float*>(t.ws[i]);
  g.a = a;
  g.b = b;
  g.y = static_cast<float*>(t.acts[i + 1]);
  g.N = t.N;
  g.H = l.h;
  g.W = l.w;
  g.Cin = cin;
  g.Cout = cout;
  g.Ci = interior ? cin / 4 : cin;
  g.Co = cout / 4;
  const dim3 grid(ceil_div(t.N * l.h * l.w, kBM), ceil_div(cout, kBN), interior ? 4 : 1);
  g.rows = l.rows;
  g.psum = l.psum;
  g.psq = l.psq;
  if (interior)
    conv_tile_kernel<kInterior><<<grid, kThreads, 0, stream>>>(g);
  else
    conv_tile_kernel<kEntry><<<grid, kThreads, 0, stream>>>(g);
  return cudaGetLastError();
}

// The final conv, + bias, tanh, with the last BN's affine a, b on load.
template <typename T>
cudaError_t final_layer(const Tail& t, const float* a, const float* b, cudaStream_t stream) {
  const int i = t.L - 1, cin = t.chans[i];
  int h, w;
  final_grid(t, h, w);
  const size_t smem = final_smem_bytes(cin);
  cudaError_t err = siggan::allow_smem(final_conv_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(w, kFinTW), ceil_div(h, kFinTH), t.N);
  final_conv_kernel<T><<<grid, kFinThreads, smem, stream>>>(
      static_cast<const T*>(t.acts[i]), static_cast<const T*>(t.ws[i]), a, b, t.bias,
      static_cast<T*>(t.acts[i + 1]), h, w, cin);
  return cudaGetLastError();
}

// BN layer i's count of positions a phase over a batch of n, and the
// running variance's unbiasing factor (over the 4 phases' positions).
void bn_count(const Layer& l, long long n, float& count, float& unbias) {
  const long long positions = n * l.ho * l.wo;
  const double n4 = 4.0 * static_cast<double>(positions);
  count = static_cast<float>(positions);
  unbias = static_cast<float>(n4 / (n4 - 1.0 > 1.0 ? n4 - 1.0 : 1.0));
}

template <typename T>
cudaError_t run(const Tail& t, cudaStream_t stream) {
  constexpr bool kMma = sizeof(T) == 2;
  if (scratch_floats(t.L, t.chans, t.N, t.H, t.W, kMma) > t.scratch_floats)
    return cudaErrorInvalidValue;
  __nv_bfloat16* taps[kMaxLayers] = {};
  if (kMma) {
    const cudaError_t err = canonical_taps(t, taps, true, stream);
    if (err != cudaSuccess) return err;
  }
  const float* a = nullptr;
  const float* b = nullptr;
  for (int i = 0; i + 1 < t.L; ++i) {
    const Layer l = layer_at(t, i, kMma);
    cudaError_t err = conv_layer<T>(t, i, l, a, b, taps, stream);
    if (err != cudaSuccess) return err;
    float count, unbias;
    bn_count(l, t.N, count, unbias);
    const int cout = t.chans[i + 1];
    bn_finalize_kernel<<<cout / 4, kThreads, 0, stream>>>(
        l.psum, l.psq, l.rows, cout / 4, count, unbias,
        static_cast<const float*>(t.scales[i]), static_cast<const float*>(t.offsets[i]),
        static_cast<float*>(t.means[i]), static_cast<float*>(t.vars[i]), l.a4, l.b4, kMma);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    a = l.a4;
    b = l.b4;
  }
  return final_layer<T>(t, a, b, stream);
}

// One stage of the layer route: stage 2i runs conv layer i < L - 1 (after
// the relayout, at stage 0 in bf16) and writes its totals [8][Cout / 4];
// stage 2i + 1 finalizes BN layer i from `totals` over a batch of
// n_total; stage 2(L - 1) is the final conv.
template <typename T>
cudaError_t run_stage(const Tail& t, int stage, float* totals, int n_total,
                      cudaStream_t stream) {
  constexpr bool kMma = sizeof(T) == 2;
  if (scratch_floats(t.L, t.chans, t.N, t.H, t.W, kMma) > t.scratch_floats || stage < 0 ||
      stage > 2 * (t.L - 1) || n_total < t.N)
    return cudaErrorInvalidValue;
  const int i = stage / 2;
  const float* a = nullptr;
  const float* b = nullptr;
  if (i > 0) {
    const Layer prev = layer_at(t, i - 1, kMma);
    a = prev.a4;
    b = prev.b4;
  }
  if (i == t.L - 1) return final_layer<T>(t, a, b, stream);
  const Layer l = layer_at(t, i, kMma);
  const int C = t.chans[i + 1] / 4;
  if (stage % 2 == 0) {
    __nv_bfloat16* taps[kMaxLayers] = {};
    if (kMma) {
      const cudaError_t err = canonical_taps(t, taps, i == 0, stream);
      if (err != cudaSuccess) return err;
    }
    const cudaError_t err = conv_layer<T>(t, i, l, a, b, taps, stream);
    if (err != cudaSuccess) return err;
    bn_totals_kernel<<<C, kThreads, 0, stream>>>(l.psum, l.psq, l.rows, C, totals);
    return cudaGetLastError();
  }
  float count, unbias;
  bn_count(l, n_total, count, unbias);
  bn_from_totals_kernel<<<ceil_div(C, kThreads), kThreads, 0, stream>>>(
      totals, C, count, unbias, static_cast<const float*>(t.scales[i]),
      static_cast<const float*>(t.offsets[i]), static_cast<float*>(t.means[i]),
      static_cast<float*>(t.vars[i]), l.a4, l.b4, kMma);
  return cudaGetLastError();
}

}  // namespace

// The f32 scratch siggan_train_tail needs for this shape and dtype, or -1
// for a shape it does not take.
extern "C" int siggan_train_tail_scratch(int L, const int* chans, int N, int H, int W,
                                         int bf16) {
  if (!valid_shape(L, chans, N, H, W)) return -1;
  return static_cast<int>(scratch_floats(L, chans, N, H, W, bf16 != 0));
}

// ws[L]: packed weights; acts[L + 1]: h0, each layer's output (the last the
// packed image); per BN layer i < L - 1: scale, offset, and the running
// mean/var, updated in place; bias (1,) f32; scratch of scratch_floats f32;
// chans[L + 1]: h0's channels, then each layer's output channels.
extern "C" int siggan_train_tail(int L, const void* const* ws, void* const* acts,
                                 const void* const* scales, const void* const* offsets,
                                 void* const* means, void* const* vars,
                                 const void* bias, void* scratch, long long scratch_floats,
                                 const int* chans, int N, int H, int W, int bf16,
                                 void* stream) {
  if (!valid_shape(L, chans, N, H, W)) return cudaErrorInvalidValue;
  const Tail t{L, ws, acts, scales, offsets, means, vars,
               static_cast<const float*>(bias), static_cast<float*>(scratch),
               scratch_floats, chans, N, H, W};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? run<__nv_bfloat16>(t, s) : run<float>(t, s));
}

// One stage of the layer route (run_stage): the arguments of
// siggan_train_tail, then the stage, the totals buffer (8 * chans[i + 1] / 4
// f32 of BN layer i) and the batch the totals cover (the global batch when
// the ranks' totals were added between the stages, else N).
extern "C" int siggan_train_tail_stage(int L, const void* const* ws, void* const* acts,
                                       const void* const* scales, const void* const* offsets,
                                       void* const* means, void* const* vars,
                                       const void* bias, void* scratch,
                                       long long scratch_floats, const int* chans, int N,
                                       int H, int W, int bf16, int stage, void* totals,
                                       int n_total, void* stream) {
  if (!valid_shape(L, chans, N, H, W)) return cudaErrorInvalidValue;
  const Tail t{L, ws, acts, scales, offsets, means, vars,
               static_cast<const float*>(bias), static_cast<float*>(scratch),
               scratch_floats, chans, N, H, W};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* tot = static_cast<float*>(totals);
  return static_cast<int>(bf16 ? run_stage<__nv_bfloat16>(t, stage, tot, n_total, s)
                               : run_stage<float>(t, stage, tot, n_total, s));
}
