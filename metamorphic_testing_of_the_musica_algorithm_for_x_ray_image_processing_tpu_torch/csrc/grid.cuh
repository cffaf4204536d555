// Launch helpers shared by the kernels: the SM count, the opt-in to more
// than 48 KB of dynamic shared memory, and the size of one wave of blocks.

#pragma once

#include <cuda_runtime.h>

// Shared memory a block may use on sm_90 after the opt-in (227 KB); up to
// 48 KB needs none.
constexpr int kMaxSharedBytes = 232448;
constexpr int kDefaultSharedBytes = 48 * 1024;

// The current device's SM count, read once per device.
inline int sm_count(int* sms) {
  constexpr int kDevices = 64;
  static int per_device[kDevices];  // 0: not read yet
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kDevices) return (int)cudaErrorInvalidDevice;
  if (per_device[dev] == 0) {
    e = cudaDeviceGetAttribute(&per_device[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  *sms = per_device[dev];
  return (int)cudaSuccess;
}

// Lets `kernel` launch with `bytes` of dynamic shared memory: above 48 KB
// only after cudaFuncSetAttribute, above 227 KB never.
template <typename Kernel>
int allow_shared(Kernel kernel, size_t bytes) {
  if (bytes > (size_t)kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  if (bytes <= (size_t)kDefaultSharedBytes) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// *blocks = the blocks of `kernel` that fit on all SMs at once (at least
// one), after its shared-memory opt-in.
template <typename Kernel>
int wave_blocks(Kernel kernel, int threads, size_t smem, long long* blocks) {
  int e = allow_shared(kernel, smem);
  if (e != (int)cudaSuccess) return e;
  int sms = 0, per_sm = 0;
  e = sm_count(&sms);
  if (e != (int)cudaSuccess) return e;
  e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != (int)cudaSuccess) return e;
  *blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return (int)cudaSuccess;
}
