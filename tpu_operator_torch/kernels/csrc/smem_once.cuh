// Per-kernel, per-device launch attributes, set once.
//
// The dynamic shared-memory limit (and the carveout preference) belong to
// a kernel on a device, not to a launch: set them on the first launch of
// each kernel on each device and keep that call's result for every later
// launch, so later launches set no attribute again.

#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int MAX_DEVICES = 64;

template <auto kernel>
cudaError_t set_smem_once(size_t smem_bytes, bool max_carveout) {
  static std::once_flag once[MAX_DEVICES];
  static cudaError_t result[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [dev, smem_bytes, max_carveout] {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes);
    if (e == cudaSuccess && max_carveout)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    result[dev] = e;
  });
  return result[dev];
}

}  // namespace
