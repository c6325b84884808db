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
// design keeps every weight in one launch (one descriptor passed by value)
// and walks the output in its own linear order, so writes coalesce; reads
// are a permutation of a sub-megabyte array that stays in L2.
#include <cuda_bf16.h>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxWeights = 8;
enum Kind { kEntry = 0, kInterior = 1, kFinal = 2 };

struct TailDesc {
  int n;
  int kind[kMaxWeights];
  int ci[kMaxWeights];
  int co[kMaxWeights];
  const void* in[kMaxWeights];
  void* out[kMaxWeights];
  int64_t start[kMaxWeights + 1];  // prefix offsets of the elements walked
};

__device__ __forceinline__ float load(const void* p, int64_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ int find(const TailDesc& d, int64_t g) {
  int j = 0;
  while (j + 1 < d.n && g >= d.start[j + 1]) ++j;
  return j;
}

// Packed element e of weight (kind, Ci, Co) -> flat index of its canonical
// source in the stored layout, or -1 for a structural zero.
__device__ int64_t source_of(int kind, int Ci, int Co, int64_t e) {
  if (kind == kEntry) {  // out OIHW (4Co, Ci, 3, 3)
    const int b = e % 3, a = (e / 3) % 3;
    const int ci = (e / 9) % Ci;
    const int o = static_cast<int>(e / (9LL * Ci));
    const int q = o / Co, co = o % Co, qr = q >> 1, qc = q & 1;
    const int u = 3 - 2 * a + qr, v = 3 - 2 * b + qc;
    if (u < 0 || u > 3 || v < 0 || v > 3) return -1;
    return ((static_cast<int64_t>(ci) * Co + co) * 4 + u) * 4 + v;  // IOHW
  }
  if (kind == kInterior) {  // out IOHW (4Ci, 4Co, 4, 4)
    const int B = e % 4, A = (e / 4) % 4;
    const int qo = (e / 16) % (4 * Co);
    const int pi = static_cast<int>(e / (16LL * 4 * Co));
    const int p = pi / Ci, ci = pi % Ci, q = qo / Co, co = qo % Co;
    const int u = 2 * A + (q >> 1) - 2 * (p >> 1) - 1;
    const int v = 2 * B + (q & 1) - 2 * (p & 1) - 1;
    if (u < 0 || u > 3 || v < 0 || v > 3) return -1;
    return ((static_cast<int64_t>(ci) * Co + co) * 4 + u) * 4 + v;  // IOHW
  }
  // kFinal: out (4Ci, 3, 3, 4Co)
  const int qo = e % (4 * Co);
  const int b = (e / (4 * Co)) % 3, a = (e / (12 * Co)) % 3;
  const int pi = static_cast<int>(e / (36LL * Co));
  const int p = pi / Ci, ci = pi % Ci, q = qo / Co, co = qo % Co;
  const int u = 2 * a - 1 - (q >> 1) + (p >> 1);
  const int v = 2 * b - 1 - (q & 1) + (p & 1);
  if (u < 0 || u > 2 || v < 0 || v > 2) return -1;
  return ((static_cast<int64_t>(co) * Ci + ci) * 3 + u) * 3 + v;  // OIHW
}

__global__ void pack_tail_fwd_kernel(TailDesc d, int out_bf16) {
  const int64_t g = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (g >= d.start[d.n]) return;
  const int j = find(d, g);
  const int64_t e = g - d.start[j];
  const int64_t s = source_of(d.kind[j], d.ci[j], d.co[j], e);
  const float x = s < 0 ? 0.0f : static_cast<const float*>(d.in[j])[s];
  if (out_bf16) {
    static_cast<__nv_bfloat16*>(d.out[j])[e] = __float2bfloat16_rn(x);
  } else {
    static_cast<float*>(d.out[j])[e] = x;
  }
}

// Canonical element e (stored layout) -> the sum of its packed cotangents.
__device__ float gather_grad(int kind, int Ci, int Co, const void* dp,
                             int in_bf16, int64_t e) {
  float acc = 0.0f;
  if (kind == kEntry) {  // canonical IOHW (Ci, Co, 4, 4), packed OIHW
    const int v = e % 4, u = (e / 4) % 4;
    const int co = (e / 16) % Co;
    const int ci = static_cast<int>(e / (16LL * Co));
    for (int qr = 0; qr < 2; ++qr) {
      const int a2 = 3 - u + qr;
      if (a2 & 1) continue;
      for (int qc = 0; qc < 2; ++qc) {
        const int b2 = 3 - v + qc;
        if (b2 & 1) continue;
        const int a = a2 >> 1, b = b2 >> 1;
        if (a > 2 || b > 2) continue;
        const int o = (2 * qr + qc) * Co + co;
        acc += load(dp, ((static_cast<int64_t>(o) * Ci + ci) * 3 + a) * 3 + b, in_bf16);
      }
    }
    return acc;
  }
  if (kind == kInterior) {  // canonical IOHW (Ci, Co, 4, 4), packed IOHW
    const int v = e % 4, u = (e / 4) % 4;
    const int co = (e / 16) % Co;
    const int ci = static_cast<int>(e / (16LL * Co));
    for (int pr = 0; pr < 2; ++pr)
      for (int pc = 0; pc < 2; ++pc)
        for (int qr = 0; qr < 2; ++qr)
          for (int qc = 0; qc < 2; ++qc) {
            const int A2 = u + 1 + 2 * pr - qr, B2 = v + 1 + 2 * pc - qc;
            if ((A2 & 1) || (B2 & 1)) continue;
            const int A = A2 >> 1, B = B2 >> 1;
            if (A > 3 || B > 3) continue;
            const int64_t pi = (2 * pr + pc) * Ci + ci;
            const int64_t qo = (2 * qr + qc) * Co + co;
            acc += load(dp, ((pi * 4 * Co + qo) * 4 + A) * 4 + B, in_bf16);
          }
    return acc;
  }
  // kFinal: canonical OIHW (Co, Ci, 3, 3), packed (4Ci, 3, 3, 4Co)
  const int v = e % 3, u = (e / 3) % 3;
  const int ci = (e / 9) % Ci;
  const int co = static_cast<int>(e / (9LL * Ci));
  for (int pr = 0; pr < 2; ++pr)
    for (int pc = 0; pc < 2; ++pc)
      for (int qr = 0; qr < 2; ++qr)
        for (int qc = 0; qc < 2; ++qc) {
          const int a2 = u + 1 + qr - pr, b2 = v + 1 + qc - pc;
          if ((a2 & 1) || (b2 & 1)) continue;
          const int a = a2 >> 1, b = b2 >> 1;
          if (a > 2 || b > 2) continue;
          const int64_t pi = (2 * pr + pc) * Ci + ci;
          const int64_t qo = (2 * qr + qc) * Co + co;
          acc += load(dp, ((pi * 3 + a) * 3 + b) * 4 * Co + qo, in_bf16);
        }
  return acc;
}

__global__ void pack_tail_bwd_kernel(TailDesc d, int in_bf16) {
  const int64_t g = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (g >= d.start[d.n]) return;
  const int j = find(d, g);
  const int64_t e = g - d.start[j];
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
  d.start[0] = 0;
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
    d.start[j + 1] = d.start[j] + len;
  }
  const int threads = 256;
  const int64_t blocks = (d.start[n] + threads - 1) / threads;
  if (backward) {
    pack_tail_bwd_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(d, bf16);
  } else {
    pack_tail_fwd_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(d, bf16);
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
