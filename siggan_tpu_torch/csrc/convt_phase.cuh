// Eval-mode generator upsample block on Hopper, on the tensor cores in
// 3xTF32:
//   ConvTranspose2d(k=4, s=2, p=1, no bias) -> per-channel affine -> ReLU.
//
// Replaces the TPU kernel siggan_tpu/ops/pallas/upsample.py::upsample_block
// (_kernel), whose body is also the block that
// siggan_tpu/ops/pallas/generator_fwd.py::generator_forward (_block) chains
// four times. convt_tile_kernel is B3 (libupsample, and blocks 1-3 of the
// generator forward in libgenerator_fwd); generator_fwd.cu's gen_tail_kernel
// runs block 4 through this file's chunk loop and the final 3x3 conv + tanh
// in one kernel.
//
// Arithmetic. ConvT(4,2,1) splits into four output phases (di, dj); phase
// output y[2i+di, 2j+dj] = sum_{a,b in {0,1}} x[i+di-1+a, j+dj-1+b] @
// taps[p][a][b], p = 2*di + dj (pack_block_taps). Only these canonical taps
// are multiplied; the TPU kernel's pack_w9 zeros never enter.
//
// Precision. The TPU kernel's dots are f32, and the served images are held
// to rtol 1e-4 / atol 1e-4 of the f32 plain version: single-pass TF32 misses
// that. Each product runs as 3xTF32 (the scheme of CUTLASS's fast f32 GEMM):
// acc += a_lo b_hi + a_hi b_lo + a_hi b_hi, with hi = TF32(v), lo =
// TF32(v - hi), f32 accumulators, mma.sync m16n8k8 TF32.
//
// Operand layout. Both operands reach the MMA from shared memory already
// split, 16 floats for 8 channels of one pixel (or one weight row): for
// t = 0..3, floats 4t..4t+3 are hi(2t), hi(2t+1), lo(2t), lo(2t+1). The
// MMA's k index t stands for channel 2t and t + 4 for channel 2t + 1 in
// both operands, so lane (g, t) reads its whole hi and lo A fragment with
// two 16-byte loads (rows g and g + 8) and the B fragment of 8 output
// channels with one, free of bank conflicts. The weights come in that
// layout from the host (upsample.mma_taps: (16 phase-taps, Cin/8 chunks,
// Cout padded to 32, 16), zero past Cin and Cout); activations are split
// once per staged pixel (cvt.rna.tf32.f32), not once per product.
//
// Bound. At the 64 px generator's shapes and batch 64 the four blocks do
// 5.37 GFLOP of canonical work against a few MB of compulsory bytes: bound
// by operations, three times the FLOPs at the 494.7 TFLOP/s TF32 peak.
//
// Design of B3. A block owns 128 input-grid pixels in all 4 output phases
// and 32 output channels. Its pixels are whole images where the map is
// small (IPT images of H x W, at 4 x 4 eight of them), else Rs rows of CW
// <= 64 columns of one image; the staged halo holds each image's rows with
// a zero row above and below and zero columns beside, so no row needs a
// mask. Per chunk of 8 input channels, double-buffered, the weights of all
// 16 (phase, tap) pairs come by 16-byte cp.async, and the halo by register
// loads issued before the chunk's MMAs and split into shared memory after
// them. Warp (phase, half) multiplies 4 m16 tiles x 32 channels over its
// phase's 4 taps. Where the grid would hold fewer than 128 blocks (blocks
// 1 and 2 at batch 64 hold 32 and 64) the input channels are split over a
// cluster of S <= 4 blocks on neighbouring SMs; each writes its partial
// tile to its shared memory and block s of the cluster sums rows s/S of all
// S tiles through distributed shared memory, in rank order, so two launches
// give the same bits. The epilogue does affine + ReLU and 16-byte stores
// into the interleaved (2H, 2W, Cout) output, 128 contiguous bytes per 8
// threads.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "async_copy.cuh"
#include "common.cuh"

namespace siggan {

constexpr int kTileThreads = 256;
constexpr int kTileM = 128;      // B3: input-grid pixels per block (each phase)
constexpr int kKC = 8;           // input channels per staged chunk
constexpr int kNT = 32;          // output channels per block
constexpr int kPF = 16;          // floats per staged pixel or weight row (hi and lo)
constexpr int kWFloats = 16 * kNT * kPF;  // one chunk's weights, all (phase, tap)
constexpr int kHaloMax = 384;    // staged halo pixels at most
constexpr int kHaloItems = 2 * kHaloMax / kTileThreads;  // half-pixel loads a thread
constexpr int kEpiRow = 4 * kNT + 8;  // B3 epilogue: floats per pixel
constexpr int kMaxSplit = 4;     // blocks of a cluster sharing one tile's channels
constexpr int kTargetBlocks = 128;

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// d += a (16 x 8, row) * b (8 x 8, col), TF32 in, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (hi(a), hi(b), lo(a), lo(b)).
__device__ __forceinline__ float4 split_pair(float a, float b) {
  const float ha = __uint_as_float(tf32_rna(a)), hb = __uint_as_float(tf32_rna(b));
  return make_float4(ha, hb, __uint_as_float(tf32_rna(a - ha)),
                     __uint_as_float(tf32_rna(b - hb)));
}

// Halo staging. Item k of a thread is half (threadIdx.x & 1) of a chunk's 8
// channels of halo pixel halo_item(k); src[k] is the input pixel it holds
// (its index over the (N, H, W) map), -1 for zero padding, -2 past the halo.
__device__ __forceinline__ int halo_item(int k) {
  return (threadIdx.x >> 1) + k * (kTileThreads / 2);
}

// Load chunk kc of the thread's halo items into registers. VEC: Cin % 4 == 0.
template <bool VEC>
__device__ __forceinline__ void halo_fetch(float4 (&v)[kHaloItems], const int (&src)[kHaloItems],
                                           const float* __restrict__ x, int Cin, int kc) {
  const int ch = kc * kKC + (threadIdx.x & 1) * 4;
#pragma unroll
  for (int k = 0; k < kHaloItems; ++k) {
    v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (src[k] < 0 || ch >= Cin) continue;
    const float* p = x + static_cast<size_t>(src[k]) * Cin + ch;
    if (VEC) {
      v[k] = __ldg(reinterpret_cast<const float4*>(p));
    } else {
      v[k].x = __ldg(p);
      if (ch + 1 < Cin) v[k].y = __ldg(p + 1);
      if (ch + 2 < Cin) v[k].z = __ldg(p + 2);
      if (ch + 3 < Cin) v[k].w = __ldg(p + 3);
    }
  }
}

// Split the fetched items into hi and lo and store them in the MMA layout.
__device__ __forceinline__ void halo_store(float* sa, const float4 (&v)[kHaloItems],
                                           const int (&src)[kHaloItems]) {
  const int half = threadIdx.x & 1;
#pragma unroll
  for (int k = 0; k < kHaloItems; ++k) {
    if (src[k] == -2) continue;
    float* d = sa + halo_item(k) * kPF + half * 8;
    *reinterpret_cast<float4*>(d) = split_pair(v[k].x, v[k].y);
    *reinterpret_cast<float4*>(d + 4) = split_pair(v[k].z, v[k].w);
  }
}

// Stage chunk kc of the packed weights for output channels co0 .. co0 + 31
// of all 16 (phase, tap) pairs: [pt][32 channels][kPF], 2048 16-byte copies.
// w (16, KC, CoP, kPF), zero-padded on the host.
__device__ __forceinline__ void stage_weights(float* sw, const float* __restrict__ w, int KC,
                                              int CoP, int kc, int co0) {
  constexpr int kPieces = kNT * kPF / 4;  // per (phase, tap)
#pragma unroll
  for (int rep = 0; rep < 16 * kPieces / kTileThreads; ++rep) {
    const int e = threadIdx.x + rep * kTileThreads;
    const int pt = e / kPieces, piece = e % kPieces;
    cp_async<16>(sw + pt * kNT * kPF + piece * 4,
                 w + ((static_cast<size_t>(pt) * KC + kc) * CoP + co0) * kPF + piece * 4, 16);
  }
}

// One staged chunk through the tensor cores in 3xTF32. The warp computes
// phase q over MT m16 tiles x 32 channels; pix[mt][hh] is the halo pixel
// its rows g (hh = 0) and g + 8 (hh = 1) of tile mt read at tap (0, 0).
template <int MT>
__device__ __forceinline__ void mma_chunk(float (&acc)[MT][4][4], const float* sa,
                                          const float* sw, const int (&pix)[MT][2], int q,
                                          int HCW) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 1  // unrolled, ptxas hoists the next taps' loads and spills at 128 registers
  for (int tap = 0; tap < 4; ++tap) {
    const int off = (tap >> 1) * HCW + (tap & 1);
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const float4 w =
          *reinterpret_cast<const float4*>(sw + ((q * 4 + tap) * kNT + nj * 8 + g) * kPF + 4 * t);
      bh[nj][0] = __float_as_uint(w.x);
      bh[nj][1] = __float_as_uint(w.y);
      bl[nj][0] = __float_as_uint(w.z);
      bl[nj][1] = __float_as_uint(w.w);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float4 r0 = *reinterpret_cast<const float4*>(sa + (pix[mt][0] + off) * kPF + 4 * t);
      const float4 r1 = *reinterpret_cast<const float4*>(sa + (pix[mt][1] + off) * kPF + 4 * t);
      const uint32_t ah[4] = {__float_as_uint(r0.x), __float_as_uint(r1.x),
                              __float_as_uint(r0.y), __float_as_uint(r1.y)};
      const uint32_t al[4] = {__float_as_uint(r0.z), __float_as_uint(r1.z),
                              __float_as_uint(r0.w), __float_as_uint(r1.w)};
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) mma_tf32(acc[mt][nj], al, bh[nj][0], bh[nj][1]);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) mma_tf32(acc[mt][nj], ah, bl[nj][0], bl[nj][1]);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) mma_tf32(acc[mt][nj], ah, bh[nj][0], bh[nj][1]);
    }
  }
}

// The chunk loop shared by both kernels: chunks kb .. ke - 1 of the input
// channels into acc. Shared memory holds two halo buffers of HP pixels,
// then two weight buffers; one barrier a chunk.
template <int MT, bool VEC>
__device__ __forceinline__ void chunk_loop(float (&acc)[MT][4][4], float* smem, int HP,
                                           const int (&src)[kHaloItems], const int (&pix)[MT][2],
                                           int q, int HCW, const float* __restrict__ x, int Cin,
                                           const float* __restrict__ w, int KC, int CoP, int co0,
                                           int kb, int ke) {
  float* sa = smem;
  float* sw = smem + 2 * HP * kPF;
  float4 v[kHaloItems];
  halo_fetch<VEC>(v, src, x, Cin, kb);
  stage_weights(sw, w, KC, CoP, kb, co0);
  cp_async_commit();
  halo_store(sa, v, src);
  for (int it = kb; it < ke; ++it) {
    const int buf = (it - kb) & 1;
    cp_async_wait_all();
    __syncthreads();  // chunk it is staged; every warp is done with chunk it - 1
    const bool more = it + 1 < ke;
    if (more) {
      stage_weights(sw + (buf ^ 1) * kWFloats, w, KC, CoP, it + 1, co0);
      cp_async_commit();
      halo_fetch<VEC>(v, src, x, Cin, it + 1);
    }
    mma_chunk<MT>(acc, sa + buf * HP * kPF, sw + buf * kWFloats, pix, q, HCW);
    if (more) halo_store(sa + (buf ^ 1) * HP * kPF, v, src);
  }
}

// ---------------------------------------------------------------------------
// B3. x (N, H, W, Cin), w the packed taps (16, KC, CoP, kPF), scale / offset
// (Cout), out (N, 2H, 2W, Cout); f32, contiguous; Cout % 4 == 0. A block
// owns IPT images from image (blockIdx.x / TPI) * IPT, or rows from
// (blockIdx.x % TPI) * Rs of one image; columns from blockIdx.y * CW;
// output channels from (blockIdx.z / S) * 32; chunk range blockIdx.z % S.
struct ConvtTile {
  const float* x;
  const float* w;
  const float* scale;
  const float* offset;
  float* out;
  int N, H, W, Cin, Cout, relu;
  int KC, CoP;           // chunks of 8 input channels; Cout padded to 32
  int CW, Rs, IPT, TPI;  // tile geometry (convt_tile_geometry)
  int S;                 // blocks of a cluster splitting the chunks
};

template <bool VEC>
__global__ void __launch_bounds__(kTileThreads, 2) convt_tile_kernel(const ConvtTile a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int MT = kTileM / 32;  // m16 tiles per warp: 2 warps per phase
  const int HCW = a.CW + 2, SH = (a.Rs + 2) * HCW, HP = a.IPT * SH;
  const int seg_px = a.Rs * a.CW, used = a.IPT * seg_px;
  const int split = blockIdx.z % a.S, co0 = blockIdx.z / a.S * kNT;
  const int n0 = blockIdx.x / a.TPI * a.IPT, i0 = blockIdx.x % a.TPI * a.Rs;
  const int c0 = blockIdx.y * a.CW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q = warp >> 1, half = warp & 1, di = q >> 1, dj = q & 1;

  int src[kHaloItems];
#pragma unroll
  for (int k = 0; k < kHaloItems; ++k) {
    const int hp = halo_item(k), seg = hp / SH, hr = (hp - seg * SH) / HCW;
    const int n = n0 + seg, i = i0 + hr - 1, j = c0 + hp - seg * SH - hr * HCW - 1;
    src[k] = hp >= HP ? -2
             : (n < a.N && i >= 0 && i < a.H && j >= 0 && j < a.W) ? (n * a.H + i) * a.W + j
                                                                   : -1;
  }
  int pix[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = half * MT * 16 + mt * 16 + g + 8 * hh;
      const int seg = m / seg_px, r = (m - seg * seg_px) / a.CW, c = m - seg * seg_px - r * a.CW;
      pix[mt][hh] = m < used ? seg * SH + (r + di) * HCW + c + dj : 0;
    }

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nj][e] = 0.f;
  chunk_loop<MT, VEC>(acc, smem, HP, src, pix, q, HCW, a.x, a.Cin, a.w, a.KC, a.CoP, co0,
                      split * a.KC / a.S, (split + 1) * a.KC / a.S);
  __syncthreads();  // every warp is done with the ring

  // The raw tile [m][phase][channel] in shared memory.
  float* tile = smem;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = half * MT * 16 + mt * 16 + g + 8 * hh;
        *reinterpret_cast<float2*>(tile + m * kEpiRow + q * kNT + nj * 8 + 2 * t) =
            make_float2(acc[mt][nj][2 * hh], acc[mt][nj][2 * hh + 1]);
      }
  namespace cg = cooperative_groups;
  if (a.S > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();

  // Block `split` of the cluster finishes rows [split, split + 1) * 128 / S
  // of the tile: the sum of the S partial tiles in rank order, affine (+
  // ReLU), 16-byte stores, 8 threads on one pixel's 32 channels.
  const int rows = kTileM / a.S, m0 = split * rows;
  const int c4 = threadIdx.x & 7, p = (threadIdx.x >> 3) & 3, co = co0 + c4 * 4;
  const int pdi = p >> 1, pdj = p & 1;
  if (co < a.Cout) {
    const float4 s = __ldg(reinterpret_cast<const float4*>(a.scale + co));
    const float4 o = __ldg(reinterpret_cast<const float4*>(a.offset + co));
    for (int m = m0 + (threadIdx.x >> 5); m < m0 + rows; m += kTileThreads / 32) {
      const int seg = m / seg_px, r = (m - seg * seg_px) / a.CW, c = m - seg * seg_px - r * a.CW;
      const int n = n0 + seg, i = i0 + r, j = c0 + c;
      if (m >= used || n >= a.N || i >= a.H || j >= a.W) continue;
      const int at = m * kEpiRow + p * kNT + c4 * 4;
      float4 u[kMaxSplit];
#pragma unroll
      for (int rank = 0; rank < kMaxSplit; ++rank)  // all loads in flight, then the sum
        if (rank < a.S)
          u[rank] = *reinterpret_cast<const float4*>(
              (a.S > 1 ? cg::this_cluster().map_shared_rank(tile, rank) : tile) + at);
      float4 v = u[0];
#pragma unroll
      for (int rank = 1; rank < kMaxSplit; ++rank)
        if (rank < a.S) {
          v.x += u[rank].x;
          v.y += u[rank].y;
          v.z += u[rank].z;
          v.w += u[rank].w;
        }
      float4 y = make_float4(fmaf(v.x, s.x, o.x), fmaf(v.y, s.y, o.y), fmaf(v.z, s.z, o.z),
                             fmaf(v.w, s.w, o.w));
      if (a.relu) {
        y.x = fmaxf(y.x, 0.f);
        y.y = fmaxf(y.y, 0.f);
        y.z = fmaxf(y.z, 0.f);
        y.w = fmaxf(y.w, 0.f);
      }
      *reinterpret_cast<float4*>(
          a.out + ((static_cast<size_t>(n) * 2 * a.H + 2 * i + pdi) * 2 * a.W + 2 * j + pdj) *
                      a.Cout +
          co) = y;
    }
  }
  if (a.S > 1) cg::this_cluster().sync();  // no block leaves while its tile is read
}

// B3's tile for an H x W map: CW columns, and either IPT whole images (Rs
// = H rows each, TPI = 1) or Rs rows of one image (IPT = 1, TPI row tiles
// an image); HP halo pixels; row_tiles along the batch.
struct TileGeometry {
  int CW, Rs, IPT, TPI, HP, row_tiles;
};

inline TileGeometry convt_tile_geometry(int N, int H, int W) {
  TileGeometry g;
  g.CW = W < 64 ? W : 64;
  const int by_m = kTileM / g.CW, by_halo = kHaloMax / (g.CW + 2) - 2;
  const int R = by_m < by_halo ? by_m : by_halo;
  if (H <= R) {
    const int per = kHaloMax / ((H + 2) * (g.CW + 2));
    g.Rs = H;
    g.TPI = 1;
    g.IPT = R / H < per ? R / H : per;
  } else {
    g.Rs = R;
    g.IPT = 1;
    g.TPI = (H + R - 1) / R;
  }
  g.HP = g.IPT * (g.Rs + 2) * (g.CW + 2);
  g.row_tiles = (N + g.IPT - 1) / g.IPT * g.TPI;
  return g;
}

// The cluster size: double it while the grid holds fewer than
// kTargetBlocks blocks and each block keeps at least two chunks.
inline int convt_tile_splits(long long blocks, int KC) {
  int S = 1;
  while (S < kMaxSplit && blocks * S < kTargetBlocks && KC >= 4 * S) S *= 2;
  return S;
}

template <bool VEC>
cudaError_t launch_convt_tile_vec(const ConvtTile& a, dim3 grid, size_t smem,
                                  cudaStream_t stream) {
  cudaError_t err = allow_smem(convt_tile_kernel<VEC>, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kTileThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = a.S;
  cfg.attrs = &cluster;
  cfg.numAttrs = a.S > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, convt_tile_kernel<VEC>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// w: the packed taps, upsample.mma_taps's layout.
inline cudaError_t launch_convt_tile(const float* x, const float* w, const float* scale,
                                     const float* offset, float* out, int N, int H, int W,
                                     int Cin, int Cout, int relu, cudaStream_t stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || Cout % 4 ||
      static_cast<long long>(N) * H * W > INT_MAX)
    return cudaErrorInvalidValue;
  const TileGeometry geo = convt_tile_geometry(N, H, W);
  ConvtTile a{x, w, scale, offset, out, N, H, W, Cin, Cout, relu};
  a.KC = (Cin + kKC - 1) / kKC;
  a.CoP = (Cout + kNT - 1) / kNT * kNT;
  a.CW = geo.CW;
  a.Rs = geo.Rs;
  a.IPT = geo.IPT;
  a.TPI = geo.TPI;
  const int col_tiles = (W + geo.CW - 1) / geo.CW, co_tiles = a.CoP / kNT;
  a.S = convt_tile_splits(static_cast<long long>(geo.row_tiles) * col_tiles * co_tiles, a.KC);
  const dim3 grid(static_cast<unsigned>(geo.row_tiles), col_tiles, co_tiles * a.S);
  const size_t ring = 2 * static_cast<size_t>(geo.HP) * kPF + 2 * kWFloats;
  const size_t epi = static_cast<size_t>(kTileM) * kEpiRow;
  const size_t smem = (ring > epi ? ring : epi) * sizeof(float);
  return Cin % 4 == 0 ? launch_convt_tile_vec<true>(a, grid, smem, stream)
                      : launch_convt_tile_vec<false>(a, grid, smem, stream);
}

}  // namespace siggan
