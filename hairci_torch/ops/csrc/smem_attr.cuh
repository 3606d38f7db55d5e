// Dynamic shared memory above the default 48 KB has to be allowed per kernel
// and device with cudaFuncSetAttribute before a launch may ask for it. That
// call takes the host a few microseconds, so a launcher makes it only when
// it needs more than it was last granted: it keeps one `granted` array per
// kernel (a function-local static of its own) and passes it here.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

constexpr int kSmemAttrDevices = 64;

inline cudaError_t allow_dynamic_smem(const void* kernel, size_t bytes,
                                      size_t (&granted)[kSmemAttrDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool known = dev >= 0 && dev < kSmemAttrDevices;
  if (known && bytes <= granted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && known) granted[dev] = bytes;
  return err;
}
