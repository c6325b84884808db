// Shared by every kernel library of siggan_tpu_torch: the C entry that
// turns a cudaError_t (which each launcher returns) into its message.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* siggan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace siggan {

// Opt a kernel in to more than 48 KB of dynamic shared memory when a shape
// needs it (up to the 227 KB a Hopper block may use).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace siggan
