// Per-device launch facts, read once a device and shared by the launchers
// of potrf.cu, trsm.cu, cov.cu and cov_matvec.cu: the SM count, the CTAs of
// a kernel that fit on the card at once, and a kernel's raised dynamic
// shared-memory ceiling. Each cache is indexed by the current device.

#pragma once

#include <cuda_runtime.h>

namespace cugp {

constexpr int MAX_DEVICES = 64;

inline cudaError_t current_device(int* dev) {
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  return *dev < MAX_DEVICES ? cudaSuccess : cudaErrorInvalidDevice;
}

// SMs of the current device.
inline cudaError_t sm_count(int* out) {
  static int cache[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err != cudaSuccess) return err;
  if (cache[dev] == 0) {
    err = cudaDeviceGetAttribute(&cache[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return err;
  }
  *out = cache[dev];
  return cudaSuccess;
}

// SMs x resident CTAs a SM of KERN at THREADS threads and SMEM bytes of
// dynamic shared memory: the CTAs of a persistent (or cooperative) grid.
template <auto KERN, int THREADS, size_t SMEM>
cudaError_t resident_ctas(int* out) {
  static int cache[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err != cudaSuccess) return err;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = sm_count(&sms);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, KERN,
                                                        THREADS, SMEM);
    if (err != cudaSuccess) return err;
    if (per_sm <= 0) return cudaErrorInvalidConfiguration;
    cache[dev] = per_sm * sms;
  }
  *out = cache[dev];
  return cudaSuccess;
}

// Raise KERN's dynamic shared-memory ceiling to bytes, once a device.
template <auto KERN>
cudaError_t raise_smem_once(size_t bytes) {
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err != cudaSuccess) return err;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(KERN,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace cugp
