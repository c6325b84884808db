// Eval-mode generator upsample block on Hopper:
//   ConvTranspose2d(k=4, s=2, p=1, no bias) -> per-channel affine -> ReLU.
//
// Replaces the TPU kernel siggan_tpu/ops/pallas/upsample.py::upsample_block
// (_kernel), whose body is also the block that
// siggan_tpu/ops/pallas/generator_fwd.py::generator_forward (_block) chains
// four times; the port's generator forward launches this kernel for each of
// its four blocks.
//
// Arithmetic. ConvT(4,2,1) splits into four output phases (di, dj); phase
// output y[2i+di, 2j+dj] = sum_{a,b in {0,1}} x[i+di-1+a, j+dj-1+b] @
// taps[p][a][b], p = 2*di + dj, with taps from pack_block_taps (the 2x2 view
// of the 3x3 neighbourhood). The TPU kernel multiplies the whole 3x3
// neighbourhood against pack_w9's matrices, 5/9 of which are structural
// zeros; this kernel reads only the 2x2 taps of each phase.
//
// Bound. At the 64 px generator's shapes and batch 64 each block does
// 16*Cin*Cout*H*W MACs per image (8.4 M for blocks 1-3, 16.8 M for block 4)
// against a few MB of compulsory traffic: it is bound by operations. This
// first version uses no tensor cores (f32 FMAs, no TF32), so its bound is
// the FLOP count over the card's f32 non-tensor rate.
//
// Design. One block per (image, tile of kRows input rows): batch 64 gives
// 128 to 1024 blocks over the four shapes, enough for 132 SMs. The tile's
// input rows plus a one-pixel halo are staged once in shared memory with a
// padded pixel stride (Cin + 1) to spread banks. Each thread owns one phase,
// kPix output pixels and 4 consecutive output channels: per input channel it
// loads one float4 of weights (coalesced across the warp; the same weights
// serve every block through L2) and kPix shared-memory values (broadcast
// across the threads of a warp that share pixels), then does 4*kPix FMAs in
// f32. The affine and ReLU run in the epilogue, and the result is stored
// straight into the interleaved (2H, 2W, Cout) output as float4s.
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

namespace siggan {

constexpr int kConvtThreads = 256;
constexpr int kRows = 2;  // input rows per block
constexpr int kPix = 4;   // output pixels per thread (one phase)

// x (N, H, W, Cin), taps (4, 2, 2, Cin, Cout), scale/offset (Cout),
// out (N, 2H, 2W, Cout); all f32, contiguous; Cout % 4 == 0.
__global__ void __launch_bounds__(kConvtThreads)
convt_phase_kernel(const float* __restrict__ x, const float* __restrict__ taps,
                   const float* __restrict__ scale,
                   const float* __restrict__ offset, float* __restrict__ out,
                   int H, int W, int Cin, int Cout, int relu) {
  extern __shared__ float xs[];  // (kRows + 2) x (W + 2) x (Cin + 1)
  const int n = blockIdx.y;
  const int i0 = blockIdx.x * kRows;
  const int cs = Cin + 1;
  const int cols = W + 2;
  const int staged = (kRows + 2) * cols * Cin;
  const float* xn = x + static_cast<size_t>(n) * H * W * Cin;
  for (int e = threadIdx.x; e < staged; e += blockDim.x) {
    const int ci = e % Cin;
    const int rc = e / Cin;
    const int c = rc % cols;
    const int r = rc / cols;
    const int gi = i0 - 1 + r;
    const int gj = c - 1;
    float v = 0.f;
    if (gi >= 0 && gi < H && gj >= 0 && gj < W)
      v = xn[(static_cast<size_t>(gi) * W + gj) * Cin + ci];
    xs[(r * cols + c) * cs + ci] = v;
  }
  __syncthreads();

  const int c4n = Cout / 4;
  const int npix = kRows * W;
  const int ngroups = (npix + kPix - 1) / kPix;
  const int ntasks = 4 * ngroups * c4n;
  const float4* taps4 = reinterpret_cast<const float4*>(taps);
  float4* out4 = reinterpret_cast<float4*>(out);
  const size_t out_row = static_cast<size_t>(2 * W) * c4n;  // float4s per row

  for (int task = threadIdx.x; task < ntasks; task += blockDim.x) {
    const int c4 = task % c4n;
    const int pg = (task / c4n) % ngroups;
    const int p = task / (c4n * ngroups);
    const int di = p >> 1;
    const int dj = p & 1;

    int il[kPix], jj[kPix];
    bool ok[kPix];
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int q = pg * kPix + k;
      const int qc = q < npix ? q : npix - 1;
      il[k] = qc / W;
      jj[k] = qc % W;
      ok[k] = q < npix && i0 + il[k] < H;
    }
    float4 acc[kPix];
#pragma unroll
    for (int k = 0; k < kPix; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);

    for (int a = 0; a < 2; ++a) {
      for (int b = 0; b < 2; ++b) {
        const float4* wrow =
            taps4 + (static_cast<size_t>(p * 4 + a * 2 + b) * Cin) * c4n + c4;
        const float* xb[kPix];
#pragma unroll
        for (int k = 0; k < kPix; ++k)
          xb[k] = xs + ((il[k] + di + a) * cols + (jj[k] + dj + b)) * cs;
#pragma unroll 4
        for (int ci = 0; ci < Cin; ++ci) {
          const float4 w = __ldg(wrow + static_cast<size_t>(ci) * c4n);
#pragma unroll
          for (int k = 0; k < kPix; ++k) {
            const float xv = xb[k][ci];
            acc[k].x = fmaf(xv, w.x, acc[k].x);
            acc[k].y = fmaf(xv, w.y, acc[k].y);
            acc[k].z = fmaf(xv, w.z, acc[k].z);
            acc[k].w = fmaf(xv, w.w, acc[k].w);
          }
        }
      }
    }

    const float4 s = __ldg(reinterpret_cast<const float4*>(scale) + c4);
    const float4 o = __ldg(reinterpret_cast<const float4*>(offset) + c4);
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      if (!ok[k]) continue;
      float4 y;
      y.x = fmaf(acc[k].x, s.x, o.x);
      y.y = fmaf(acc[k].y, s.y, o.y);
      y.z = fmaf(acc[k].z, s.z, o.z);
      y.w = fmaf(acc[k].w, s.w, o.w);
      if (relu) {
        y.x = fmaxf(y.x, 0.f);
        y.y = fmaxf(y.y, 0.f);
        y.z = fmaxf(y.z, 0.f);
        y.w = fmaxf(y.w, 0.f);
      }
      const size_t row = static_cast<size_t>(n) * 2 * H + 2 * (i0 + il[k]) + di;
      out4[row * out_row + static_cast<size_t>(2 * jj[k] + dj) * c4n + c4] = y;
    }
  }
}

inline cudaError_t launch_convt_phase(const float* x, const float* taps,
                                      const float* scale, const float* offset,
                                      float* out, int N, int H, int W, int Cin,
                                      int Cout, int relu, cudaStream_t stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || Cout % 4)
    return cudaErrorInvalidValue;
  const size_t smem =
      static_cast<size_t>(kRows + 2) * (W + 2) * (Cin + 1) * sizeof(float);
  cudaError_t err = allow_smem(convt_phase_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((H + kRows - 1) / kRows, N);
  convt_phase_kernel<<<grid, kConvtThreads, smem, stream>>>(
      x, taps, scale, offset, out, H, W, Cin, Cout, relu);
  return cudaGetLastError();
}

}  // namespace siggan
