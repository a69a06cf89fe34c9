// Dynamic shared memory above the 48 KB default, for the scan kernels that
// keep U resident.
//
// A launch needs the device's opt-in limit (to decide whether U fits) and,
// above 48 KB, cudaFuncAttributeMaxDynamicSharedMemorySize on the kernel.
// Both are per device and do not change, so each launcher keeps one
// SmemOptin: the limit is read on a device's first launch, and the
// attribute is raised only when a launch asks for more than the kernel was
// already granted on that device. A steady stream of launches at one shape
// then costs one cudaGetDevice of host time here.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace smem_optin {

constexpr int kMaxDevices = 64;

struct SmemOptin {
  int limit[kMaxDevices] = {};       // opt-in bytes; 0 until read
  size_t granted[kMaxDevices] = {};  // largest size set on the kernel
};

// The current device in *dev and its opt-in limit in *limit.
inline cudaError_t device_limit(SmemOptin& s, int* dev, int* limit) {
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev >= 0 && *dev < kMaxDevices && s.limit[*dev] > 0) {
    *limit = s.limit[*dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               *dev);
  if (err == cudaSuccess && *dev >= 0 && *dev < kMaxDevices)
    s.limit[*dev] = *limit;
  return err;
}

// Lets `kernel` launch with `bytes` of dynamic shared memory on `dev`.
inline cudaError_t grant(SmemOptin& s, const void* kernel, int dev,
                         size_t bytes) {
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached && bytes <= s.granted[dev]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess && cached) s.granted[dev] = bytes;
  return err;
}

}  // namespace smem_optin
