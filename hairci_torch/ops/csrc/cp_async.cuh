// cp.async: 16-byte copies from global to shared memory that run beside the
// threads' own work, in groups that a thread commits and then waits for.
// A copy of src_bytes < 16 fills the rest of its 16 bytes with zeros and
// reads nothing past src + src_bytes.

#pragma once

#include <stdint.h>

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
