// A kernel's limit on dynamic shared memory a block, raised and never
// lowered.  cudaFuncSetAttribute(cudaFuncAttributeMaxDynamicSharedMemorySize)
// sets the function's attribute on the current device for every host
// thread: when two threads launch one kernel with different sizes at once
// (the shards of a mesh, each a thread, with their own query lengths), a
// thread that sets a smaller limit between another's set and launch makes
// that launch fail with cudaErrorInvalidValue.  Raising only, under a lock,
// keeps every size a thread has set valid until its launch.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <mutex>

namespace bwamem {

constexpr int kSmemDevices = 64;

// Lets `k` take `bytes` of dynamic shared memory a block on the current
// device; returns the refusal of a size past what the card allows.
template <class Kernel>
cudaError_t raise_smem_limit(Kernel k, size_t bytes) {
  static std::mutex mu;
  static size_t limit[kSmemDevices] = {};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  const bool tracked = dev >= 0 && dev < kSmemDevices;
  std::lock_guard<std::mutex> lock(mu);
  if (tracked && bytes <= limit[dev]) return cudaSuccess;
  rc = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(bytes));
  if (rc == cudaSuccess && tracked) limit[dev] = bytes;
  return rc;
}

}  // namespace bwamem
