// Kernels B1 and B1': the one-launch pack of every packed generator-tail
// weight, and its transpose.
//
// Replaces siggan_tpu/ops/packed.py::pack_tail_kernels_pallas: its forward
// Pallas `kernel` (B1) and its backward `bwd_kernel` (B1'). Bound with
// ctypes by siggan_tpu_torch/ops/kernels/pack_tail.py, which holds the
// plain PyTorch version beside it.
//
// What it computes. The tail of the generator (every block with Cout <= 64
// and the final conv) runs in 2x2 space-to-depth form; its kernels are the
// canonical weights re-indexed into packed-space kernels (laws in
// ops/packed.py):
//   entry     w (Ci,Co,4,4) IOHW -> OIHW (4Co,Ci,3,3)     u = 3 - 2a + qr
//   interior  w (Ci,Co,4,4) IOHW -> IOHW (4Ci,4Co,4,4)   u = 2A + qr - 2pr - 1
//   final     w (Co,Ci,3,3) OIHW -> (4Ci,3,3,4Co)         u = 2a - 1 - qr + pr
// (columns alike with the column phases; zero where u leaves the kernel).
// Each packed form is written in the layout its consumer reads: F.conv2d's
// OIHW, F.conv_transpose2d's IOHW, and the (K, kh, kw, Q) operand of the
// final conv's merged-tap matmul. B1 reads f32 and writes the compute dtype
// (bf16 or f32): a copy and a cast, equal bit for bit to the plain version.
//
// B1' is the transpose of that placement, in gather form: each canonical
// weight element is the f32 sum, in the JAX kernel's block order (p-major,
// q-minor), of the packed cotangent positions that copy it (1 for the
// entry, 4 for the interiors and the final at these laws). No atomics,
// deterministic, f32 canonical gradients in the stored layouts.
//
// What bounds it on an H100. Pure data movement: at the default model (64
// px, base 256) 180,512 f32 canonical values and 1,085,952 bf16 packed
// values, 2.9 MB, 0.86 us at 3.35 TB/s; at this size both kernels are bound
// by a launch's latency. The design keeps every weight in one launch (one
// descriptor passed by value) and gives each weight its own run of blocks,
// so a block finds its weight with one uniform lookup on blockIdx. B1: each
// thread writes 8 consecutive bf16 (or 4 f32) values, 16 bytes in one
// store, walking the output's mixed-radix digits by increments from one
// 32-bit decomposition (no 64-bit division); its reads are a permutation of
// a sub-megabyte array that stays in L2. B1': a block owns a tile of (ci,
// co) channels, stages the contiguous runs of the packed cotangent those
// channels own into shared memory with coalesced 16-byte cp.async copies,
// sums from there with 32-bit mixed-radix index math and writes 16 bytes a
// thread (below). Every size is checked once on the host to fit in 32 bits.
#include <cuda_bf16.h>
#include <cstdint>

#include "async_copy.cuh"
#include "common.cuh"

namespace {

constexpr int kMaxWeights = 8;
constexpr int kPackThreads = 256;
enum Kind { kEntry = 0, kInterior = 1, kFinal = 2 };

struct TailDesc {
  int n;
  int kind[kMaxWeights];
  int ci[kMaxWeights];
  int co[kMaxWeights];
  const void* in[kMaxWeights];
  void* out[kMaxWeights];
  int start[kMaxWeights + 1];        // prefix offsets of the elements walked
  int block_start[kMaxWeights + 1];  // B1: prefix offsets of each weight's blocks
};

// The packed output of one weight as mixed-radix digits, least significant
// first, in its consumer layout:
//   entry    OIHW (4Co, Ci, 3, 3)   digits b(3) a(3) ci(Ci) co(Co) q(4) -(1)
//   interior IOHW (4Ci, 4Co, 4, 4)  digits B(4) A(4) co(Co) q(4) ci(Ci) p(4)
//   final    (4Ci, 3, 3, 4Co)       digits co(Co) q(4) b(3) a(3) ci(Ci) p(4)
// with output channel o = q Co + co and input channel q / p likewise.
struct PackedIndex {
  int d[6];
  int rad[6];

  __device__ PackedIndex(int kind, int Ci, int Co, int e) {
    if (kind == kEntry) {
      rad[0] = 3; rad[1] = 3; rad[2] = Ci; rad[3] = Co; rad[4] = 4; rad[5] = 1;
    } else if (kind == kInterior) {
      rad[0] = 4; rad[1] = 4; rad[2] = Co; rad[3] = 4; rad[4] = Ci; rad[5] = 4;
    } else {
      rad[0] = Co; rad[1] = 4; rad[2] = 3; rad[3] = 3; rad[4] = Ci; rad[5] = 4;
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      d[k] = e % rad[k];
      e /= rad[k];
    }
  }

  __device__ __forceinline__ void next() {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      if (++d[k] < rad[k]) return;
      d[k] = 0;
    }
  }

  // Flat index of the canonical source in the stored layout, or -1 for a
  // structural zero (the pack laws of ops/packed.py).
  __device__ __forceinline__ int source(int kind, int Ci, int Co) const {
    if (kind == kEntry) {  // from IOHW (Ci, Co, 4, 4)
      const int b = d[0], a = d[1], ci = d[2], co = d[3], q = d[4];
      const int u = 3 - 2 * a + (q >> 1), v = 3 - 2 * b + (q & 1);
      if (u < 0 || u > 3 || v < 0 || v > 3) return -1;
      return ((ci * Co + co) * 4 + u) * 4 + v;
    }
    if (kind == kInterior) {  // from IOHW (Ci, Co, 4, 4)
      const int B = d[0], A = d[1], co = d[2], q = d[3], ci = d[4], p = d[5];
      const int u = 2 * A + (q >> 1) - 2 * (p >> 1) - 1;
      const int v = 2 * B + (q & 1) - 2 * (p & 1) - 1;
      if (u < 0 || u > 3 || v < 0 || v > 3) return -1;
      return ((ci * Co + co) * 4 + u) * 4 + v;
    }
    // kFinal: from OIHW (Co, Ci, 3, 3)
    const int co = d[0], q = d[1], b = d[2], a = d[3], ci = d[4], p = d[5];
    const int u = 2 * a - 1 - (q >> 1) + (p >> 1);
    const int v = 2 * b - 1 - (q & 1) + (p & 1);
    if (u < 0 || u > 2 || v < 0 || v > 2) return -1;
    return ((co * Ci + ci) * 3 + u) * 3 + v;
  }
};

__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 r;
  uint32_t* w = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = r;
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// B1: kV = 16 / sizeof(T) consecutive outputs a thread.
template <typename T>
__global__ void __launch_bounds__(kPackThreads) pack_tail_fwd_kernel(TailDesc d) {
  constexpr int kV = 16 / sizeof(T);
  int j = 0;  // the weight of this block (uniform)
  while (j + 1 < d.n && static_cast<int>(blockIdx.x) >= d.block_start[j + 1]) ++j;
  const int len = d.start[j + 1] - d.start[j];
  const int e0 = ((blockIdx.x - d.block_start[j]) * kPackThreads + threadIdx.x) * kV;
  if (e0 >= len) return;
  const int kind = d.kind[j], Ci = d.ci[j], Co = d.co[j];
  const float* __restrict__ src = static_cast<const float*>(d.in[j]);
  PackedIndex idx(kind, Ci, Co, e0);
  float v[kV];
#pragma unroll
  for (int k = 0; k < kV; ++k) {
    const int s = e0 + k < len ? idx.source(kind, Ci, Co) : -1;
    v[k] = s < 0 ? 0.0f : __ldg(src + s);
    idx.next();
  }
  T* out = static_cast<T*>(d.out[j]) + e0;
  if (e0 + kV <= len) {
    store16(out, v);
  } else {
    for (int k = 0; e0 + k < len; ++k) store1(out + k, v[k]);
  }
}

// ---------------------------------------------------------------------------
// B1': tiles of (ci, co) channels, the cotangents staged in shared memory.
//
// A block owns a tile of ti input x tc output channels of one weight (all its
// taps). It copies the packed cotangent runs those channels own -- whole
// contiguous runs of the consumer layout -- into shared memory with 16-byte
// cp.async copies (element copies when a run is not 16-byte aligned), then
// each thread sums 4 consecutive canonical elements, each from its terms in
// the JAX kernel's block order (p-major, q-minor), and writes them with one
// 16-byte store. Per kind (smem order, outermost first):
//   entry    [q 4][co tc][ci ti, a 3, b 3]          1 term  (a, b, q fixed by u, v)
//   interior [p 4][ci ti][q 4][co tc, A 4, B 4]     4 terms (p = 0..3; q fixed by u, v)
//   final    [p 4][ci ti, a 3, b 3, q 4, co Co]     4 terms (p = 0..3; q by u, v and p)
// Tiles: entry 8 x 8, interior 2 x 8, final (28 / Co, at most 8) x Co, so
// every block stages at most kBwdStage elements (8 KB of bf16 at 2 x 8).

constexpr int kBwdThreads = 128;
constexpr int kBwdStage = 4096;     // staged elements a block holds at most
constexpr int kMaxFinalCo = 28;     // the final tile keeps every output channel

struct BwdTile {
  int ti, tc;
};

__host__ __device__ inline BwdTile bwd_tile(int kind, int Co) {
  if (kind == kEntry) return {8, 8};
  if (kind == kInterior) return {2, 8};
  const int ti = kMaxFinalCo / Co;
  return {ti < 1 ? 1 : (ti > 8 ? 8 : ti), Co};
}

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Copy n_seg runs of L elements (segment s = (s2 S1 + s1) S0 + s0 starts at
// base + s2 st2 + s1 st1 + s0 st0) densely into smem (run s at s L).
template <typename T>
__device__ void stage_runs(T* smem, const T* __restrict__ src, int base, int S1, int S0,
                           int st2, int st1, int st0, int L, int n_seg) {
  constexpr int kV = 16 / sizeof(T);
  if (((base | st2 | st1 | st0 | L) % kV) == 0) {  // every run 16-byte aligned
    const int chunks = L / kV, total = n_seg * chunks;
    for (int c = threadIdx.x; c < total; c += blockDim.x) {
      const int seg = c / chunks, off = (c - seg * chunks) * kV;
      const int s0 = seg % S0, s1 = (seg / S0) % S1, s2 = seg / (S0 * S1);
      siggan::cp_async<16>(smem + seg * L + off,
                           src + base + s2 * st2 + s1 * st1 + s0 * st0 + off, 16);
    }
    siggan::cp_async_commit();
    siggan::cp_async_wait_all();
  } else {
    for (int e = threadIdx.x; e < n_seg * L; e += blockDim.x) {
      const int seg = e / L, off = e - seg * L;
      const int s0 = seg % S0, s1 = (seg / S0) % S1, s2 = seg / (S0 * S1);
      smem[e] = src[base + s2 * st2 + s1 * st1 + s0 * st0 + off];
    }
  }
}

// Element e of output run r of the tile (entry / interior: r = ci_l, e =
// (co_l 4 + u) 4 + v; final: r = co, e = (ci_l 3 + u) 3 + v) from the staged
// runs of length L.
template <typename T>
__device__ __forceinline__ float bwd_sum(int kind, const T* s, int r, int e, int ti, int tc,
                                         int Co, int L) {
  float acc = 0.0f;
  if (kind == kEntry) {
    const int v = e & 3, u = (e >> 2) & 3, co_l = e >> 4;
    const int qr = (u + 1) & 1, qc = (v + 1) & 1;
    const int a = (3 - u + qr) >> 1, b = (3 - v + qc) >> 1;
    acc += to_float(s[((2 * qr + qc) * tc + co_l) * L + r * 9 + a * 3 + b]);
    return acc;
  }
  if (kind == kInterior) {
    const int v = e & 3, u = (e >> 2) & 3, co_l = e >> 4;
    const int qr = (u + 1) & 1, qc = (v + 1) & 1, q = 2 * qr + qc;
#pragma unroll
    for (int pr = 0; pr < 2; ++pr)
#pragma unroll
      for (int pc = 0; pc < 2; ++pc) {
        const int A = (u + 1 + 2 * pr - qr) >> 1, B = (v + 1 + 2 * pc - qc) >> 1;
        acc += to_float(s[(((2 * pr + pc) * ti + r) * 4 + q) * L + co_l * 16 + A * 4 + B]);
      }
    return acc;
  }
  const int ci_l = e / 9, uv = e - ci_l * 9, u = uv / 3, v = uv - u * 3;
#pragma unroll
  for (int pr = 0; pr < 2; ++pr)
#pragma unroll
    for (int pc = 0; pc < 2; ++pc) {
      const int qr = (u + 1 + pr) & 1, qc = (v + 1 + pc) & 1;
      const int a = (u + 1 + qr - pr) >> 1, b = (v + 1 + qc - pc) >> 1;
      acc += to_float(s[(2 * pr + pc) * L + ((ci_l * 3 + a) * 3 + b) * 4 * Co +
                        (2 * qr + qc) * Co + r]);
    }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads) pack_tail_bwd_kernel(TailDesc d) {
  __shared__ __align__(16) T stage[kBwdStage];
  int j = 0;  // the weight of this block (uniform)
  while (j + 1 < d.n && static_cast<int>(blockIdx.x) >= d.block_start[j + 1]) ++j;
  const int kind = d.kind[j], Ci = d.ci[j], Co = d.co[j];
  const BwdTile tile = bwd_tile(kind, Co);
  const int co_tiles = (Co + tile.tc - 1) / tile.tc;
  const int t = blockIdx.x - d.block_start[j];
  const int ci0 = (t / co_tiles) * tile.ti, co0 = (t % co_tiles) * tile.tc;
  const int ti = min(tile.ti, Ci - ci0), tc = min(tile.tc, Co - co0);
  const T* src = static_cast<const T*>(d.in[j]);
  int L, n_runs, run_len;
  if (kind == kEntry) {  // packed OIHW (4Co, Ci, 3, 3)
    L = ti * 9;
    stage_runs(stage, src, (co0 * Ci + ci0) * 9, 4, tc, 0, Co * Ci * 9, Ci * 9, L, 4 * tc);
    n_runs = ti;
    run_len = tc * 16;
  } else if (kind == kInterior) {  // packed IOHW (4Ci, 4Co, 4, 4)
    L = tc * 16;
    stage_runs(stage, src, (ci0 * 4 * Co + co0) * 16, ti, 4, Ci * 64 * Co, 64 * Co, Co * 16,
               L, 16 * ti);
    n_runs = ti;
    run_len = tc * 16;
  } else {  // packed (4Ci, 3, 3, 4Co)
    L = ti * 36 * Co;
    stage_runs(stage, src, ci0 * 36 * Co, 1, 4, 0, 0, Ci * 36 * Co, L, 4);
    n_runs = Co;
    run_len = ti * 9;
  }
  __syncthreads();
  float* out = static_cast<float*>(d.out[j]);
  const int groups = (run_len + 3) / 4;
  for (int g = threadIdx.x; g < n_runs * groups; g += blockDim.x) {
    const int r = g / groups, e0 = (g - r * groups) * 4;
    const int n = min(4, run_len - e0);
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = k < n ? bwd_sum(kind, stage, r, e0 + k, ti, tc, Co, L) : 0.0f;
    float* dst = out + (kind == kFinal ? (r * Ci + ci0) * 9 : ((ci0 + r) * Co + co0) * 16) + e0;
    if (n == 4 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      store16(dst, v);
    } else {
      for (int k = 0; k < n; ++k) dst[k] = v[k];
    }
  }
}

int64_t canonical_size(int kind, int Ci, int Co) {
  return static_cast<int64_t>(Ci) * Co * (kind == kFinal ? 9 : 16);
}

int64_t packed_size(int kind, int Ci, int Co) {
  if (kind == kEntry) return 36LL * Ci * Co;
  if (kind == kInterior) return 256LL * Ci * Co;
  return 144LL * Ci * Co;
}

cudaError_t launch(bool backward, int n, const int* kinds, const int* cis,
                   const int* cos, const void* const* in, void* const* out,
                   int bf16, cudaStream_t stream) {
  if (n < 1 || n > kMaxWeights) return cudaErrorInvalidValue;
  TailDesc d{};
  d.n = n;
  const int per_block = kPackThreads * (bf16 ? 8 : 4);  // B1's outputs a block
  int64_t start = 0, blocks = 0;
  for (int j = 0; j < n; ++j) {
    if (kinds[j] < kEntry || kinds[j] > kFinal || cis[j] < 1 || cos[j] < 1 ||
        (backward && kinds[j] == kFinal && cos[j] > kMaxFinalCo))
      return cudaErrorInvalidValue;
    d.kind[j] = kinds[j];
    d.ci[j] = cis[j];
    d.co[j] = cos[j];
    d.in[j] = in[j];
    d.out[j] = out[j];
    const int64_t len = backward ? canonical_size(kinds[j], cis[j], cos[j])
                                 : packed_size(kinds[j], cis[j], cos[j]);
    d.start[j] = static_cast<int>(start);
    d.block_start[j] = static_cast<int>(blocks);
    start += len;
    if (backward) {  // B1': one block per (ci, co) tile
      const BwdTile t = bwd_tile(kinds[j], cos[j]);
      blocks += static_cast<int64_t>((cis[j] + t.ti - 1) / t.ti) * ((cos[j] + t.tc - 1) / t.tc);
    } else {
      blocks += (len + per_block - 1) / per_block;
    }
    // 32-bit indices: every element offset, and the packed index of any
    // source, stays below 2^31.
    if (start >= (1LL << 31) || packed_size(kinds[j], cis[j], cos[j]) >= (1LL << 31))
      return cudaErrorInvalidValue;
  }
  d.start[n] = static_cast<int>(start);
  d.block_start[n] = static_cast<int>(blocks);
  if (backward && bf16) {
    pack_tail_bwd_kernel<__nv_bfloat16>
        <<<static_cast<unsigned>(blocks), kBwdThreads, 0, stream>>>(d);
  } else if (backward) {
    pack_tail_bwd_kernel<float><<<static_cast<unsigned>(blocks), kBwdThreads, 0, stream>>>(d);
  } else if (bf16) {
    pack_tail_fwd_kernel<__nv_bfloat16>
        <<<static_cast<unsigned>(blocks), kPackThreads, 0, stream>>>(d);
  } else {
    pack_tail_fwd_kernel<float><<<static_cast<unsigned>(blocks), kPackThreads, 0, stream>>>(d);
  }
  return cudaGetLastError();
}

}  // namespace

// src[j]: canonical f32 weights (stored layouts); dst[j]: packed outputs in
// bf16 (out_bf16 != 0) or f32.
extern "C" int siggan_pack_tail_fwd(int n, const int* kinds, const int* ci,
                                    const int* co, const void* const* src,
                                    void* const* dst, int out_bf16, void* stream) {
  return static_cast<int>(launch(false, n, kinds, ci, co, src, dst, out_bf16,
                                 static_cast<cudaStream_t>(stream)));
}

// dp[j]: packed cotangents in bf16 (in_bf16 != 0) or f32; grad[j]: f32
// canonical gradients (stored layouts).
extern "C" int siggan_pack_tail_bwd(int n, const int* kinds, const int* ci,
                                    const int* co, const void* const* dp,
                                    void* const* grad, int in_bf16, void* stream) {
  return static_cast<int>(launch(true, n, kinds, ci, co, dp, grad, in_bf16,
                                 static_cast<cudaStream_t>(stream)));
}
