// Shared by the tensor-core kernels of siggan_tpu_torch (B2's
// convt_mma_kernel in train_tail.cu, B3's tiles in convt_phase.cuh, B4's in
// generator_fwd.cu):
// cp.async copies from global to shared memory with zero fill.
#pragma once

#include <cuda_runtime.h>

namespace siggan {

// cp.async of BYTES (16 or 8) bytes, of which `fill` are read and the rest
// zeroed. 16-byte copies bypass L1 (.cg); 8-byte ones may not.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, int fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(fill)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(fill)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace siggan
