// C entry for the eval-mode upsample block, B3 (see convt_phase.cuh for what
// it replaces, what bounds it and its design). Bound with ctypes by
// siggan_tpu_torch/ops/kernels/upsample.py, which passes the taps split into
// their TF32 hi and lo parts in the kernel's layout (upsample.mma_taps).
#include "convt_phase.cuh"

extern "C" int siggan_upsample_block(const float* x, const float* taps_mma, const float* scale,
                                     const float* offset, float* out, int N, int H, int W,
                                     int Cin, int Cout, int relu, void* stream) {
  return static_cast<int>(siggan::launch_convt_tile(x, taps_mma, scale, offset, out, N, H, W,
                                                    Cin, Cout, relu,
                                                    static_cast<cudaStream_t>(stream)));
}
