// C entry for the eval-mode upsample block (see convt_phase.cuh for what it
// replaces, what bounds it and its design). Bound with ctypes by
// siggan_tpu_torch/ops/kernels/upsample.py.
#include "convt_phase.cuh"

extern "C" int siggan_upsample_block(const float* x, const float* taps,
                                     const float* scale, const float* offset,
                                     float* out, int N, int H, int W, int Cin,
                                     int Cout, int relu, void* stream) {
  return static_cast<int>(siggan::launch_convt_phase(
      x, taps, scale, offset, out, N, H, W, Cin, Cout, relu,
      static_cast<cudaStream_t>(stream)));
}
