// Shared by every kernel library of siggan_tpu_torch: the C entry that
// turns a cudaError_t (which each launcher returns) into its message.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

extern "C" const char* siggan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace siggan {

// Opt a kernel in to more than 48 KB of dynamic shared memory when a shape
// needs it (up to the 227 KB a Hopper block may use), once per kernel,
// device and size.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  struct Done {
    const void* fn;
    int device;
    size_t bytes;
  };
  static std::mutex mu;
  static Done done[64];
  static int n_done = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_done; ++i)
    if (done[i].fn == fn && done[i].device == device && done[i].bytes >= bytes)
      return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && n_done < 64) done[n_done++] = {fn, device, bytes};
  return err;
}

}  // namespace siggan
