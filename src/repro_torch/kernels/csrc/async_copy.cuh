// async_copy.cuh: 16-byte cp.async copies from global to shared memory
// (sm_80 and later), for kernels that stage the next tile while they
// compute on the current one (flash_attention.cu, mamba2_ssd.cu).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace async_copy {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from ``src`` to ``dst`` (both 16-byte aligned); ``src_bytes`` 0
// fills the 16 bytes with zeros and reads nothing.
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

// 4 bytes from ``src`` to ``dst`` (both 4-byte aligned).
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace async_copy
