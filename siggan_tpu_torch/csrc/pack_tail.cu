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
// B1' is the transpose of that placement, in gather form: one thread per
// canonical weight element sums, in f32 and in the JAX kernel's block order
// (p-major, q-minor), the at most 16 packed cotangent positions that copy
// it (4 at these laws). No atomics, deterministic, f32 canonical gradients
// in the stored layouts.
//
// What bounds it on an H100. Pure data movement: at the default model (64
// px, base 256) 180,512 f32 values in and 1,085,952 bf16 values out, 2.9 MB,
// 0.86 us at 3.35 TB/s; both kernels are launch-bound at this size. The
// design keeps every weight in one launch (one descriptor passed by value).
// B1 gives each weight its own run of blocks, so a block finds its weight
// with one uniform lookup on blockIdx; each thread writes 8 consecutive
// bf16 (or 4 f32) values, 16 bytes in one store, walking the output's
// mixed-radix digits by increments from one 32-bit decomposition (no
// 64-bit division); its reads are a permutation of a sub-megabyte array
// that stays in L2. Every size is checked once on the host to fit in 32
// bits.
#include <cuda_bf16.h>
#include <cstdint>

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

__device__ __forceinline__ float load(const void* p, int i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ int find(const TailDesc& d, int g) {
  int j = 0;
  while (j + 1 < d.n && g >= d.start[j + 1]) ++j;
  return j;
}

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

// Canonical element e (stored layout) -> the sum of its packed cotangents.
__device__ float gather_grad(int kind, int Ci, int Co, const void* dp,
                             int in_bf16, int e) {
  float acc = 0.0f;
  if (kind == kEntry) {  // canonical IOHW (Ci, Co, 4, 4), packed OIHW
    const int v = e % 4, u = (e / 4) % 4;
    const int co = (e / 16) % Co;
    const int ci = e / (16 * Co);
    for (int qr = 0; qr < 2; ++qr) {
      const int a2 = 3 - u + qr;
      if (a2 & 1) continue;
      for (int qc = 0; qc < 2; ++qc) {
        const int b2 = 3 - v + qc;
        if (b2 & 1) continue;
        const int a = a2 >> 1, b = b2 >> 1;
        if (a > 2 || b > 2) continue;
        const int o = (2 * qr + qc) * Co + co;
        acc += load(dp, ((o * Ci + ci) * 3 + a) * 3 + b, in_bf16);
      }
    }
    return acc;
  }
  if (kind == kInterior) {  // canonical IOHW (Ci, Co, 4, 4), packed IOHW
    const int v = e % 4, u = (e / 4) % 4;
    const int co = (e / 16) % Co;
    const int ci = e / (16 * Co);
    for (int pr = 0; pr < 2; ++pr)
      for (int pc = 0; pc < 2; ++pc)
        for (int qr = 0; qr < 2; ++qr)
          for (int qc = 0; qc < 2; ++qc) {
            const int A2 = u + 1 + 2 * pr - qr, B2 = v + 1 + 2 * pc - qc;
            if ((A2 & 1) || (B2 & 1)) continue;
            const int A = A2 >> 1, B = B2 >> 1;
            if (A > 3 || B > 3) continue;
            const int pi = (2 * pr + pc) * Ci + ci;
            const int qo = (2 * qr + qc) * Co + co;
            acc += load(dp, ((pi * 4 * Co + qo) * 4 + A) * 4 + B, in_bf16);
          }
    return acc;
  }
  // kFinal: canonical OIHW (Co, Ci, 3, 3), packed (4Ci, 3, 3, 4Co)
  const int v = e % 3, u = (e / 3) % 3;
  const int ci = (e / 9) % Ci;
  const int co = e / (9 * Ci);
  for (int pr = 0; pr < 2; ++pr)
    for (int pc = 0; pc < 2; ++pc)
      for (int qr = 0; qr < 2; ++qr)
        for (int qc = 0; qc < 2; ++qc) {
          const int a2 = u + 1 + qr - pr, b2 = v + 1 + qc - pc;
          if ((a2 & 1) || (b2 & 1)) continue;
          const int a = a2 >> 1, b = b2 >> 1;
          if (a > 2 || b > 2) continue;
          const int pi = (2 * pr + pc) * Ci + ci;
          const int qo = (2 * qr + qc) * Co + co;
          acc += load(dp, ((pi * 3 + a) * 3 + b) * 4 * Co + qo, in_bf16);
        }
  return acc;
}

__global__ void pack_tail_bwd_kernel(TailDesc d, int in_bf16) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= d.start[d.n]) return;
  const int j = find(d, g);
  const int e = g - d.start[j];
  static_cast<float*>(d.out[j])[e] =
      gather_grad(d.kind[j], d.ci[j], d.co[j], d.in[j], in_bf16, e);
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
    if (kinds[j] < kEntry || kinds[j] > kFinal || cis[j] < 1 || cos[j] < 1)
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
    blocks += (len + per_block - 1) / per_block;
    // 32-bit indices: every element offset, and the packed index of any
    // source, stays below 2^31.
    if (start >= (1LL << 31) || packed_size(kinds[j], cis[j], cos[j]) >= (1LL << 31))
      return cudaErrorInvalidValue;
  }
  d.start[n] = static_cast<int>(start);
  d.block_start[n] = static_cast<int>(blocks);
  if (backward) {
    const int threads = 256;
    const int64_t grid = (start + threads - 1) / threads;
    pack_tail_bwd_kernel<<<static_cast<unsigned>(grid), threads, 0, stream>>>(d, bf16);
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
