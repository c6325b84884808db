// The eval-mode 64 px generator forward on Hopper, one host call. Bound with
// ctypes by siggan_tpu_torch/ops/kernels/generator_fwd.py, whose
// generator_forward calls siggan_gen_forward once; it launches, in order on
// the caller's stream: fc_relu_kernel, B3's convt_tile_kernel for blocks
// 1-3 (convt_phase.cuh), and gen_tail_kernel (below), which runs block 4 and
// the final 3x3 conv + tanh with block 4's output kept in shared memory.
//
// Replaces the TPU kernel siggan_tpu/ops/pallas/generator_fwd.py::
// generator_forward (_gen_kernel). That kernel keeps every activation of an
// 8-image tile in ~100 MB of VMEM; on Hopper block 4's output alone is
// 64*64*32 f32 = 512 KB per image, more than twice the 227 KB a block may
// use, so the forward is three stages: the fc, blocks 1-3 with their
// outputs in device memory (8.4 MB at batch 64, inside the 50 MB L2; block
// 3's hi + lo taps, 256 KB, are over a block's budget for fusing it too),
// and block 4 fused with the final conv, recomputing a one-row halo.
//
// Bound. One image is 43.5 M MACs (fc 0.41 M, blocks 8.39 M x 3 + 16.8 M,
// final conv 1.18 M) against ~5.6 MB of compulsory bytes per batch of 64:
// bound by operations. The blocks and the final conv run 3xTF32 on the
// tensor cores (three times their FLOPs at the TF32 peak; the final conv
// in gen_tail_kernel); the fc (1 % of the MACs) runs f32
// FMAs on the CUDA cores in fc_relu_kernel: one thread per output feature,
// kFcImgs images per block with their latents staged in shared memory;
// weight reads are coalesced across the warp. BN is folded into the
// weights on the host.
//
// Shapes and dtypes are checked on the host when the packed generator is
// built (generator_fwd.py::pack_generator) and when one of its tensors is
// replaced; the C entry checks only that its integers describe a forward
// it can run.
#include <cuda_runtime.h>

#include "common.cuh"
#include "convt_phase.cuh"

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

cudaError_t launch_fc(const float* z, const float* w16, const float* b16, float* h, int N,
                      int K, int C0, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kFcImgs) * K * sizeof(float);
  cudaError_t err = allow_smem(fc_relu_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((16 * C0 + kFcThreads - 1) / kFcThreads, (N + kFcImgs - 1) / kFcImgs);
  fc_relu_kernel<<<grid, kFcThreads, smem, stream>>>(z, w16, b16, h, N, K, C0);
  return cudaGetLastError();
}

// Block 4 and the final conv of the 64 px generator in one kernel, so that
// block 4's output (64 x 64 x C per image, 33.5 MB at batch 64 and C = 32)
// never leaves the SM. A block owns R = kTailRows rows of one 64 x 64 image.
// It runs block 4 (convt_phase.cuh's chunk loop, 3xTF32) for output rows
// y0 - 1 .. y0 + R, the image rows plus a one-row halo for the 3x3 conv:
// phase di computes input-grid rows y0/2 - di .. y0/2 - di + R/2, R/2 + 1
// rows of 32 pixels (MT = R/2 + 1 m16 tiles per warp), and both phases read
// input rows y0/2 - 1 .. y0/2 + R/2 of one staged halo (zero outside the
// map). The final conv C -> 1 runs on the tensor cores too, as a product
// with the 9 taps as its 16 (padded) columns: T[pixel][tap] = relu(affine(
// block 4))[pixel] . wfin[tap], 3xTF32, its A fragments made in registers
// from block 4's accumulators (the accumulator of 8 channels is an A
// fragment of the same k order: channel 2t at k = t, 2t + 1 at t + 4). Rows
// outside the image are the conv's zero padding and give T = 0. T goes to
// shared memory, (R + 2) x 64 pixels x kTapS floats, and each thread sums
// the 9 shifted taps of R / 4 pixels (columns past the edges are the
// padding). Channels go 32 at a time, the sums carried in registers across
// them; + bias, tanh, and only the image is written. Each output row of
// block 4 is computed (R + 2) / R times.
constexpr int kTailW = 32;              // block 4's input grid is 32 x 32
constexpr int kTailS = 2 * kTailW;      // image side
constexpr int kTapS = 12;               // floats per pixel of the T tile (9 taps)
constexpr int kTailRows = 8;            // image rows a block owns (R = 4 timed slower, PERF.md)
constexpr int kWfFloats = 2 * 4 * 32 * 4;  // wfin split for 2 n8 tiles x 4 k-steps x 32 lanes

__host__ __device__ constexpr size_t tail_smem_floats() {
  constexpr size_t ring =
      2 * static_cast<size_t>(kTailRows / 2 + 2) * (kTailW + 2) * kPF + 2 * kWFloats;
  constexpr size_t taps = static_cast<size_t>(kTailRows + 2) * kTailS * kTapS;
  return (ring > taps ? ring : taps) + kWfFloats;
}

// x (N, 32, 32, Cin) block 4's input, Cin % 4 == 0; w block 4's packed taps
// (16, KC, CoP, kPF); scale / offset (C); wfin (3, 3, C, 1); bfin (1); img
// (N, 64, 64, 1). Grid (N * 64 / kTailRows).
__global__ void __launch_bounds__(kTileThreads, 1)
gen_tail_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ scale, const float* __restrict__ offset,
                const float* __restrict__ wfin, const float* __restrict__ bfin,
                float* __restrict__ img, int Cin, int C) {
  extern __shared__ __align__(16) float smem[];
  constexpr int MT = kTailRows / 2 + 1;
  constexpr int HCW = kTailW + 2, HP = (kTailRows / 2 + 2) * HCW;
  static_assert(HP <= kHaloMax, "the halo exceeds the staging items");
  constexpr int kPix = kTailRows * kTailS / kTileThreads;  // image pixels per thread
  const int KC = (Cin + kKC - 1) / kKC, CoP = (C + kNT - 1) / kNT * kNT;
  float* wfs = smem + (tail_smem_floats() - kWfFloats);
  const int tiles = kTailS / kTailRows;
  const int n = blockIdx.x / tiles, y0 = (blockIdx.x % tiles) * kTailRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q = warp >> 1, half = warp & 1, di = q >> 1, dj = q & 1;

  int src[kHaloItems];
#pragma unroll
  for (int k = 0; k < kHaloItems; ++k) {
    const int hp = halo_item(k), i = y0 / 2 - 1 + hp / HCW, j = hp % HCW - 1;
    src[k] = hp >= HP ? -2
             : (i >= 0 && i < kTailW && j >= 0 && j < kTailW) ? (n * kTailW + i) * kTailW + j
                                                              : -1;
  }
  int pix[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = half * MT * 16 + mt * 16 + g + 8 * hh;
      pix[mt][hh] = (m / kTailW) * HCW + m % kTailW + dj;
    }

  float out[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) out[k] = 0.f;
  for (int co0 = 0; co0 < C; co0 += kNT) {
    float acc[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nj][e] = 0.f;
    chunk_loop<MT, true>(acc, smem, HP, src, pix, q, HCW, x, Cin, w, KC, CoP, co0, 0, KC);
    {  // wfin's B fragments, split: [n8 tile][k-step][lane] (hi0, hi1, lo0, lo1)
      const int e = threadIdx.x, tap = (e >> 7) * 8 + ((e >> 2) & 7);
      const int ch = co0 + ((e >> 5) & 3) * 8 + 2 * (e & 3);
      const float w0 = tap < 9 && ch < C ? __ldg(wfin + tap * C + ch) : 0.f;
      const float w1 = tap < 9 && ch + 1 < C ? __ldg(wfin + tap * C + ch + 1) : 0.f;
      *reinterpret_cast<float4*>(wfs + 4 * e) = split_pair(w0, w1);
    }
    __syncthreads();  // every warp is done with the ring; wfs is staged

    // T for block 4's output rows y0 - 1 .. y0 + kTailRows: phase di's row r is
    // image row 2 (y0/2 - di + r) + di, tile row 2r - di + 1.
    float* ts = smem;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      int tp[2];
      bool in[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = half * MT * 16 + mt * 16 + g + 8 * hh;
        const int ty = 2 * (m / kTailW) - di + 1, yy = y0 - 1 + ty;
        in[hh] = yy >= 0 && yy < kTailS;
        tp[hh] = ty * kTailS + 2 * (m % kTailW) + dj;
      }
      float tacc[2][4] = {};
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int ch = co0 + nj * 8 + 2 * t;
        const bool ok = ch < C;
        const float s0 = ok ? __ldg(scale + ch) : 0.f, s1 = ok ? __ldg(scale + ch + 1) : 0.f;
        const float o0 = ok ? __ldg(offset + ch) : 0.f, o1 = ok ? __ldg(offset + ch + 1) : 0.f;
        // rows g / g + 8 (hh), channels 2t / 2t + 1: k = t / t + 4
        const float y00 = in[0] ? fmaxf(fmaf(acc[mt][nj][0], s0, o0), 0.f) : 0.f;
        const float y01 = in[0] ? fmaxf(fmaf(acc[mt][nj][1], s1, o1), 0.f) : 0.f;
        const float y10 = in[1] ? fmaxf(fmaf(acc[mt][nj][2], s0, o0), 0.f) : 0.f;
        const float y11 = in[1] ? fmaxf(fmaf(acc[mt][nj][3], s1, o1), 0.f) : 0.f;
        const float4 p0 = split_pair(y00, y01), p1 = split_pair(y10, y11);
        const uint32_t ah[4] = {__float_as_uint(p0.x), __float_as_uint(p1.x),
                                __float_as_uint(p0.y), __float_as_uint(p1.y)};
        const uint32_t al[4] = {__float_as_uint(p0.z), __float_as_uint(p1.z),
                                __float_as_uint(p0.w), __float_as_uint(p1.w)};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float4 b = *reinterpret_cast<const float4*>(wfs + 4 * ((nt * 4 + nj) * 32 + lane));
          const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
          mma_tf32(tacc[nt], al, bh0, bh1);
          mma_tf32(tacc[nt], ah, __float_as_uint(b.z), __float_as_uint(b.w));
          mma_tf32(tacc[nt], ah, bh0, bh1);
        }
      }
      // taps 2t, 2t + 1 of tile nt for rows g and g + 8; of tile 1 only tap 8
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        *reinterpret_cast<float2*>(ts + tp[hh] * kTapS + 2 * t) =
            make_float2(tacc[0][2 * hh], tacc[0][2 * hh + 1]);
        if (t == 0) ts[tp[hh] * kTapS + 8] = tacc[1][2 * hh];
      }
    }
    __syncthreads();

    // The 3x3 conv's partial sums over these 32 channels.
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int p = threadIdx.x + k * kTileThreads, y = p / kTailS, xq = p % kTailS;
      float s = 0.f;
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          const int xx = xq + b - 1;
          if (xx >= 0 && xx < kTailS) s += ts[((y + a) * kTailS + xx) * kTapS + a * 3 + b];
        }
      out[k] += s;
    }
    __syncthreads();  // the T tile and wfs are reused by the next channel group
  }
  const float bias = __ldg(bfin);
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int p = threadIdx.x + k * kTileThreads;
    img[(static_cast<size_t>(n) * kTailS + y0 + p / kTailS) * kTailS + p % kTailS] =
        tanhf(out[k] + bias);
  }
}

inline cudaError_t launch_gen_tail(const float* x, const float* w, const float* scale,
                                   const float* offset, const float* wfin, const float* bfin,
                                   float* img, int N, int Cin, int C, cudaStream_t stream) {
  if (N <= 0 || Cin <= 0 || Cin % 4 || C <= 0 || C % 4 || N > (1 << 24))
    return cudaErrorInvalidValue;
  const size_t smem = tail_smem_floats() * sizeof(float);
  cudaError_t err = allow_smem(gen_tail_kernel, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(N) * (kTailS / kTailRows);
  gen_tail_kernel<<<static_cast<unsigned>(blocks), kTileThreads, smem, stream>>>(
      x, w, scale, offset, wfin, bfin, img, Cin, C);
  return cudaGetLastError();
}

}  // namespace siggan

// The whole forward. w: [wfc16, bfc16, then per block taps_mma, scale,
// offset, then wfin, bfin] (16 pointers); taps_mma in upsample.mma_taps's
// layout. dims: [zdim, c0, c1, c2, c3, c4], c_b the channels after block b.
// scratch holds the fc output and the outputs of blocks 1-3: N * (16 c0 +
// 64 c1 + 256 c2 + 1024 c3) floats. img (N, 64, 64, 1).
extern "C" int siggan_gen_forward(const float* z, float* scratch, float* img,
                                  const float* const* w, const int* dims, int N,
                                  void* stream_ptr) {
  const int zdim = dims[0];
  const int* c = dims + 1;
  if (N <= 0 || zdim <= 0 || N > (1 << 24)) return cudaErrorInvalidValue;
  for (int b = 0; b < 5; ++b)
    if (c[b] <= 0 || c[b] % 4) return cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  float* h[4];
  h[0] = scratch;
  for (int b = 0; b < 3; ++b)
    h[b + 1] = h[b] + static_cast<size_t>(N) * (16 << (2 * b)) * c[b];
  cudaError_t err = siggan::launch_fc(z, w[0], w[1], h[0], N, zdim, c[0], stream);
  for (int b = 0; b < 3 && err == cudaSuccess; ++b) {
    const int side = 4 << b;
    err = siggan::launch_convt_tile(h[b], w[2 + 3 * b], w[3 + 3 * b], w[4 + 3 * b], h[b + 1], N,
                                    side, side, c[b], c[b + 1], 1, stream);
  }
  if (err == cudaSuccess)
    err = siggan::launch_gen_tail(h[3], w[11], w[12], w[13], w[14], w[15], img, N, c[3], c[4],
                                  stream);
  return static_cast<int>(err);
}
