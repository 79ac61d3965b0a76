// Per-kernel, per-device launch attributes, set once; cluster launches.
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

namespace {

// A launch configuration of `threads`-thread CTAs with `smem` bytes of
// dynamic shared memory, in clusters of `cs` CTAs along grid y (gridDim.y
// a multiple of cs). Launch it with cudaLaunchKernelEx; a refused cluster
// launch returns its error there and never runs. Not copyable: cfg points
// at attr.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  ClusterLaunch(dim3 grid, int threads, size_t smem, int cs, cudaStream_t stream) {
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = cs;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;
  ClusterLaunch& operator=(const ClusterLaunch&) = delete;
};

// The most clusters of `cs` CTAs of `kernel` (launched as ClusterLaunch
// with `threads` and `smem`) the device holds at once.
template <typename Kernel>
cudaError_t max_active_clusters(Kernel kernel, int threads, size_t smem, int cs, int* out) {
  ClusterLaunch l(dim3(1, cs, 1), threads, smem, cs, 0);
  return cudaOccupancyMaxActiveClusters(out, kernel, &l.cfg);
}

}  // namespace
