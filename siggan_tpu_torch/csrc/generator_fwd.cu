// The eval-mode 64 px generator forward on Hopper: the fc stage and the
// final conv stage. Bound with ctypes by
// siggan_tpu_torch/ops/kernels/generator_fwd.py, whose generator_forward
// launches, in order on one stream: fc_relu_kernel, the upsample block
// kernel of convt_phase.cuh (libupsample) once per block, conv3_tanh_kernel.
//
// Replaces the TPU kernel siggan_tpu/ops/pallas/generator_fwd.py::
// generator_forward (_gen_kernel). That kernel keeps every activation of an
// 8-image tile in ~100 MB of VMEM; on Hopper block 4's output alone is
// 64*64*32 f32 = 512 KB per image, more than twice the 227 KB a block may
// use, so the forward is three kernels in order with the intermediates in
// device memory (at batch 64 the largest is 32 MB, which stays in the 50 MB
// L2 between launches).
//
// Bound. One image is 43.5 M MACs (fc 0.41 M, blocks 8.39 M x 3 + 16.8 M,
// final conv 1.18 M) against ~5.6 MB of compulsory bytes per batch of 64:
// the forward is bound by operations, at the card's f32 non-tensor rate,
// since these kernels use no tensor cores. The fc and final stages are small
// (under 4 % of the MACs) and are written plainly:
//  - fc_relu_kernel: one thread per output feature, kFcImgs images per
//    block with their latents staged in shared memory; weight reads are
//    coalesced across the warp. BN is folded into the weights on the host.
//  - conv3_tanh_kernel: one thread per output pixel, the (3, 3, C, 1) kernel
//    in shared memory, float4 reads of the C = 32 channels of each tap.
#include <cuda_runtime.h>

#include "common.cuh"

namespace siggan {

constexpr int kFcThreads = 256;
constexpr int kFcImgs = 8;

// z (N, K), w16 (16, K, C0), b16 (16, C0) -> h (N, 4, 4, C0) = relu(fc).
// Output feature f = pix * C0 + c, the HWC order of the (4, 4, C0) map.
__global__ void __launch_bounds__(kFcThreads)
fc_relu_kernel(const float* __restrict__ z, const float* __restrict__ w16,
               const float* __restrict__ b16, float* __restrict__ h, int N,
               int K, int C0) {
  extern __shared__ float zs[];  // kFcImgs x K
  const int n0 = blockIdx.y * kFcImgs;
  for (int e = threadIdx.x; e < kFcImgs * K; e += blockDim.x) {
    const int r = e / K;
    zs[e] = n0 + r < N ? z[static_cast<size_t>(n0 + r) * K + e % K] : 0.f;
  }
  __syncthreads();
  const int F = 16 * C0;
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  const int pix = f / C0;
  const int c = f % C0;
  const float* wp = w16 + static_cast<size_t>(pix) * K * C0 + c;
  float acc[kFcImgs];
#pragma unroll
  for (int r = 0; r < kFcImgs; ++r) acc[r] = 0.f;
  for (int k = 0; k < K; ++k) {
    const float w = __ldg(wp + static_cast<size_t>(k) * C0);
#pragma unroll
    for (int r = 0; r < kFcImgs; ++r) acc[r] = fmaf(zs[r * K + k], w, acc[r]);
  }
  const float bias = __ldg(b16 + f);
#pragma unroll
  for (int r = 0; r < kFcImgs; ++r)
    if (n0 + r < N)
      h[static_cast<size_t>(n0 + r) * F + f] = fmaxf(acc[r] + bias, 0.f);
}

constexpr int kConvThreads = 256;

// h (N, S, S, C), wfin (3, 3, C, 1), bfin (1,) -> img (N, S, S, 1) =
// tanh(conv3x3(h, pad 1) + b); C % 4 == 0.
__global__ void __launch_bounds__(kConvThreads)
conv3_tanh_kernel(const float* __restrict__ h, const float* __restrict__ wfin,
                  const float* __restrict__ bfin, float* __restrict__ img,
                  int N, int S, int C) {
  extern __shared__ float4 ws4[];  // 9 * C / 4
  for (int e = threadIdx.x; e < 9 * C / 4; e += blockDim.x)
    ws4[e] = __ldg(reinterpret_cast<const float4*>(wfin) + e);
  __syncthreads();
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(N) * S * S) return;
  const int xq = idx % S;
  const int yq = (idx / S) % S;
  const size_t n = idx / (static_cast<size_t>(S) * S);
  const int c4n = C / 4;
  float acc = 0.f;
  for (int a = 0; a < 3; ++a) {
    const int yy = yq + a - 1;
    if (yy < 0 || yy >= S) continue;
    for (int b = 0; b < 3; ++b) {
      const int xx = xq + b - 1;
      if (xx < 0 || xx >= S) continue;
      const float4* hp = reinterpret_cast<const float4*>(
          h + ((n * S + yy) * S + xx) * C);
      const float4* wp = ws4 + (a * 3 + b) * c4n;
      for (int c4 = 0; c4 < c4n; ++c4) {
        const float4 v = __ldg(hp + c4);
        const float4 w = wp[c4];
        acc = fmaf(v.x, w.x, acc);
        acc = fmaf(v.y, w.y, acc);
        acc = fmaf(v.z, w.z, acc);
        acc = fmaf(v.w, w.w, acc);
      }
    }
  }
  img[idx] = tanhf(acc + __ldg(bfin));
}

}  // namespace siggan

extern "C" int siggan_gen_fc(const float* z, const float* w16,
                             const float* b16, float* h, int N, int K, int C0,
                             void* stream) {
  if (N <= 0 || K <= 0 || C0 <= 0) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(siggan::kFcImgs) * K * sizeof(float);
  cudaError_t err = siggan::allow_smem(siggan::fc_relu_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((16 * C0 + siggan::kFcThreads - 1) / siggan::kFcThreads,
                  (N + siggan::kFcImgs - 1) / siggan::kFcImgs);
  siggan::fc_relu_kernel<<<grid, siggan::kFcThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(z, w16, b16, h,
                                                                N, K, C0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int siggan_gen_final(const float* h, const float* wfin,
                                const float* bfin, float* img, int N, int S,
                                int C, void* stream) {
  if (N <= 0 || S <= 0 || C <= 0 || C % 4) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(9) * C * sizeof(float);
  cudaError_t err = siggan::allow_smem(siggan::conv3_tanh_kernel, smem);
  if (err != cudaSuccess) return err;
  const size_t total = static_cast<size_t>(N) * S * S;
  const unsigned blocks = static_cast<unsigned>(
      (total + siggan::kConvThreads - 1) / siggan::kConvThreads);
  siggan::conv3_tanh_kernel<<<blocks, siggan::kConvThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      h, wfin, bfin, img, N, S, C);
  return static_cast<int>(cudaGetLastError());
}
