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
// inputs give the same bits. One host call launches every kernel on the
// caller's stream; nothing leaves the card in between.
//
// Weights are read in the layouts kernel B1 writes (csrc/pack_tail.cu):
// entry OIHW (4Co, Ci, 3, 3), interior IOHW (4Ci, 4Co, 4, 4), final
// (4C, 3, 3, 4). Their pack laws zero whole (tap, input phase, output
// phase) blocks: of the entry's 9 taps 4 are live for each output phase,
// of the interior's 2x2 taps x 4 input phases 4 of 16. A conv block whose
// output channels share one output phase skips every reduction chunk of a
// dead block (adding zeros would not change its sums), which brings the
// work down to the canonical ConvT's. The kernels therefore take only
// B1's packed weights, never arbitrary ones.
//
// What bounds it on an H100. At the full-width models and batch 64 the
// canonical work is 4.4 GFLOP (64 px) and 17.8 GFLOP (128 px) against
// ~47 MB and ~195 MB of compulsory bf16 traffic: bound by operations. This
// first version runs f32 FMAs on the CUDA cores (no tensor cores), so its
// bound is the canonical FLOP count over the f32 non-tensor rate.
//
// Design. K_entry / K_interior are one implicit-GEMM tile kernel: a block
// computes 128 output pixels (of one phase) x 32 output channels, a
// thread 4 x 4 of them; the reduction runs in chunks of 16 input channels
// of one tap, staged in shared memory (the activation chunk with the
// prologue applied, and the weight chunk). K_final stages a 16 x 16 pixel
// tile with its halo, 16 channels at a time, one pixel per thread.
#include <cuda_bf16.h>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBM = 128;  // output pixels per conv block
constexpr int kBN = 32;   // output channels per conv block
constexpr int kBK = 16;   // input channels per reduction chunk
constexpr int kThreads = 256;
constexpr int kTile = 16;  // K_final: output tile side
constexpr int kHalo = kTile + 2;
constexpr int kHaloStride = kHalo * kHalo + 1;  // odd: spreads banks

enum Kind { kEntry = 0, kInterior = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round to the compute dtype, kept as a float.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

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
__device__ __forceinline__ bool block_live(int kind, int r, int c, int p, int q) {
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

struct ConvArgs {
  const void* x;      // input (N, H, W, Cin), compute dtype
  const void* w;      // packed weight (B1's layout for the kind)
  const float* a;     // prologue affine (Cin,), or null for the entry
  const float* b;
  void* y;            // output, compute dtype: entry (N, H, W, Cout),
                      // interior (N, 2H, 2W, Cout)
  float* psum;        // partial sums [Cout][rows]
  float* psq;         // partial sums of squares [Cout][rows]
  int N, H, W;        // input grid
  int Cin, Cout;
  int Ci, Co;         // canonical channels per phase: Cin/4 (interior), Cout/4
  int rows;           // gridDim.x * gridDim.z
};

// Entry / interior conv tile. Grid (M tiles, Cout tiles, phases).
template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads) conv_tile_kernel(ConvArgs g) {
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][kBN];
  const T* __restrict__ x = static_cast<const T*>(g.x);
  const T* __restrict__ w = static_cast<const T*>(g.w);
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
    int r, c, dy, dx;  // kernel index, input offset
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
    const int iy = ai + dy, ix = aj + dx;
    const bool inb = arow && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
    const T* xrow =
        inb ? x + ((static_cast<size_t>(aimg) * g.H + iy) * g.W + ix) * g.Cin : x;
    for (int ci0 = 0; ci0 < g.Cin; ci0 += kBK) {
      bool live = false;
      if (KIND == kEntry) {
        for (int q = q_lo; q <= q_hi; ++q) live |= block_live(kEntry, r, c, 0, q);
      } else {
        const int p_lo = ci0 / g.Ci, p_hi = (ci0 + kBK - 1) / g.Ci;
        for (int p = p_lo; p <= p_hi; ++p)
          for (int q = q_lo; q <= q_hi; ++q) live |= block_live(kInterior, r, c, p, q);
      }
      if (!live) continue;  // uniform over the block

      float v[8];
      if (inb) {
        load8(xrow + ci0 + lc, v);
        if (KIND == kInterior) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int ci = ci0 + lc + e;
            v[e] = round_to<T>(fmaxf(fmaf(v[e], __ldg(g.a + ci), __ldg(g.b + ci)), 0.f));
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
          wv = to_f(w[idx]);
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

  // Store the tile in the compute dtype.
  const int o0 = n0 + tx * 4;
  if (o0 < g.Cout) {
    T* y = static_cast<T*>(g.y);
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

// One block per canonical channel c: sums the partial rows of its 4 phase
// channels in a fixed order, then thread 0 writes the statistics.
__global__ void __launch_bounds__(kThreads)
bn_finalize_kernel(const float* __restrict__ psum, const float* __restrict__ psq,
                   int rows, int C, float count, float unbias,
                   const float* __restrict__ scale, const float* __restrict__ offset,
                   float* run_mean, float* run_var, float* a4, float* b4, int bf16) {
  __shared__ float red[8][kThreads];
  const int c = blockIdx.x;
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
  if (tid != 0) return;
  float mean = 0.f, ey2 = 0.f;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    mean += red[p][0] / count;
    ey2 += red[4 + p][0] / count;
  }
  mean /= 4.f;
  ey2 /= 4.f;
  const float var = ey2 - mean * mean;
  run_mean[c] = __fadd_rn(__fmul_rn(0.9f, run_mean[c]), __fmul_rn(0.1f, mean));
  run_var[c] = __fadd_rn(__fmul_rn(0.9f, run_var[c]), __fmul_rn(0.1f, __fmul_rn(var, unbias)));
  float a = scale[c] * rsqrtf(var + 1e-5f);
  float b = offset[c] - mean * a;
  if (bf16) {
    a = round_to<__nv_bfloat16>(a);
    b = round_to<__nv_bfloat16>(b);
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    a4[p * C + c] = a;
    b4[p * C + c] = b;
  }
}

// K_final: affine + ReLU on load, 3x3 conv Cin -> 4, + bias, tanh.
// Grid (W tiles, H tiles, N), kTile x kTile threads, one pixel each.
template <typename T>
__global__ void __launch_bounds__(kTile * kTile)
final_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ bias, T* __restrict__ img, int H, int W,
                  int Cin) {
  __shared__ float xs[kBK * kHaloStride];
  __shared__ __align__(16) float ws[kBK * 9 * 4];
  const int tid = threadIdx.x;
  const int ox = blockIdx.x * kTile + tid % kTile;
  const int oy = blockIdx.y * kTile + tid / kTile;
  const int n = blockIdx.z;
  const T* xn = x + static_cast<size_t>(n) * H * W * Cin;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int ci0 = 0; ci0 < Cin; ci0 += kBK) {
    for (int e = tid; e < kBK * kHalo * kHalo; e += kTile * kTile) {
      const int cc = e % kBK, pos = e / kBK;
      const int gy = blockIdx.y * kTile + pos / kHalo - 1;
      const int gx = blockIdx.x * kTile + pos % kHalo - 1;
      float v = 0.f;  // zero padding after the prologue
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const int ci = ci0 + cc;
        v = to_f(xn[(static_cast<size_t>(gy) * W + gx) * Cin + ci]);
        v = round_to<T>(fmaxf(fmaf(v, __ldg(a + ci), __ldg(b + ci)), 0.f));
      }
      xs[cc * kHaloStride + pos] = v;
    }
    for (int e = tid; e < kBK * 36; e += kTile * kTile)
      ws[e] = to_f(w[static_cast<size_t>(ci0) * 36 + e]);
    __syncthreads();
    const int ly = tid / kTile, lx = tid % kTile;
    for (int cc = 0; cc < kBK; ++cc) {
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const float xv = xs[cc * kHaloStride + (ly + t / 3) * kHalo + lx + t % 3];
        const float4 wv = *reinterpret_cast<const float4*>(&ws[(cc * 9 + t) * 4]);
        acc[0] = fmaf(xv, wv.x, acc[0]);
        acc[1] = fmaf(xv, wv.y, acc[1]);
        acc[2] = fmaf(xv, wv.z, acc[2]);
        acc[3] = fmaf(xv, wv.w, acc[3]);
      }
    }
    __syncthreads();
  }
  if (ox >= W || oy >= H) return;
  const float bv = bias[0];
  float out[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) out[q] = tanhf(acc[q] + bv);
  store4(img + ((static_cast<size_t>(n) * H + oy) * W + ox) * 4, out);
}

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
  if (L < 2 || N < 1 || H < 1 || W < 1 || chans[L] != 4) return false;
  for (int i = 0; i <= L; ++i) {
    if (chans[i] < 1 || (i < L && chans[i] % kBK) || (i > 0 && chans[i] % 4)) return false;
  }
  return true;
}

// f32 scratch the tail needs: per BN layer, the partial sums and squares
// [Cout][rows] of its conv blocks, then its folded affine a4, b4 [Cout].
long long scratch_floats(int L, const int* chans, int N, int H, int W) {
  long long need = 0;
  int h = H, w = W;
  for (int i = 0; i + 1 < L; ++i) {
    const int interior = i > 0;
    const int rows = ceil_div(N * h * w, kBM) * (interior ? 4 : 1);
    need += 2LL * rows * chans[i + 1] + 2LL * chans[i + 1];
    if (interior) {
      h *= 2;
      w *= 2;
    }
  }
  return need;
}

template <typename T>
cudaError_t run(const Tail& t, cudaStream_t stream) {
  if (scratch_floats(t.L, t.chans, t.N, t.H, t.W) > t.scratch_floats)
    return cudaErrorInvalidValue;

  float* s = t.scratch;
  const float* a = nullptr;
  const float* b = nullptr;
  int h = t.H, w = t.W;
  for (int i = 0; i < t.L; ++i) {
    const int cin = t.chans[i], cout = t.chans[i + 1];
    if (i == t.L - 1) {
      const dim3 grid(ceil_div(w, kTile), ceil_div(h, kTile), t.N);
      final_conv_kernel<T><<<grid, kTile * kTile, 0, stream>>>(
          static_cast<const T*>(t.acts[i]), static_cast<const T*>(t.ws[i]), a, b,
          t.bias, static_cast<T*>(t.acts[i + 1]), h, w, cin);
      return cudaGetLastError();
    }
    const int interior = i > 0;
    ConvArgs g;
    g.x = t.acts[i];
    g.w = t.ws[i];
    g.a = a;
    g.b = b;
    g.y = t.acts[i + 1];
    g.N = t.N;
    g.H = h;
    g.W = w;
    g.Cin = cin;
    g.Cout = cout;
    g.Ci = interior ? cin / 4 : cin;
    g.Co = cout / 4;
    const dim3 grid(ceil_div(t.N * h * w, kBM), ceil_div(cout, kBN), interior ? 4 : 1);
    g.rows = grid.x * grid.z;
    g.psum = s;
    g.psq = s + static_cast<size_t>(cout) * g.rows;
    float* a4 = g.psq + static_cast<size_t>(cout) * g.rows;
    float* b4 = a4 + cout;
    s = b4 + cout;
    if (interior) {
      conv_tile_kernel<T, kInterior><<<grid, kThreads, 0, stream>>>(g);
      h *= 2;
      w *= 2;
    } else {
      conv_tile_kernel<T, kEntry><<<grid, kThreads, 0, stream>>>(g);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long count = static_cast<long long>(t.N) * h * w;
    const double n4 = 4.0 * static_cast<double>(count);
    const float unbias = static_cast<float>(n4 / (n4 - 1.0 > 1.0 ? n4 - 1.0 : 1.0));
    bn_finalize_kernel<<<cout / 4, kThreads, 0, stream>>>(
        g.psum, g.psq, g.rows, cout / 4, static_cast<float>(count), unbias,
        static_cast<const float*>(t.scales[i]), static_cast<const float*>(t.offsets[i]),
        static_cast<float*>(t.means[i]), static_cast<float*>(t.vars[i]), a4, b4,
        sizeof(T) == 2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    a = a4;
    b = b4;
  }
  return cudaErrorInvalidValue;  // unreachable: the last layer returns
}

}  // namespace

// ws[L]: packed weights; acts[L + 1]: h0, each layer's output (the last the
// packed image); per BN layer i < L - 1: scale, offset, and the running
// mean/var, updated in place; bias (1,) f32; scratch of scratch_floats f32;
// chans[L + 1]: h0's channels, then each layer's output channels.
// The f32 scratch siggan_train_tail needs for this shape, or -1 for a shape
// it does not take.
extern "C" int siggan_train_tail_scratch(int L, const int* chans, int N, int H, int W) {
  if (!valid_shape(L, chans, N, H, W)) return -1;
  return static_cast<int>(scratch_floats(L, chans, N, H, W));
}

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
