// The grid of the kernels whose blocks loop over lanes (decode2.cu,
// decode_sep.cu): as many blocks as are resident on the device at once.
#pragma once

#include <atomic>

#include <cuda_runtime.h>

namespace fdt {

constexpr int kMaxDevices = 64;

// Blocks of `kernel` (`threads` threads and `smem` bytes of dynamic shared
// memory each) resident on device `dev` at once, into *cap; sets the
// kernel's shared-memory limit there first.  `caps` keeps the result per
// device (one array per kernel); a race recomputes the same value.
template <class Kernel>
cudaError_t grid_cap(Kernel kernel, int threads, int smem, int dev,
                     std::atomic<int>* caps, int* cap) {
  if (dev >= 0 && dev < kMaxDevices && (*cap = caps[dev].load()) > 0)
    return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  *cap = sms * (per_sm > 0 ? per_sm : 1);
  if (dev >= 0 && dev < kMaxDevices) caps[dev].store(*cap);
  return cudaSuccess;
}

}  // namespace fdt
