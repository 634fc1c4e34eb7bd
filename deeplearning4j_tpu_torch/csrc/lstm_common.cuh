// Pieces shared by the LSTM kernels (the sequence forward, the cell
// backward): the block size, element conversion between the storage type
// and f32, the gate activation, and the co-resident grid of a cooperative
// launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <mutex>

namespace lstm {

constexpr int NT = 256;   // threads a block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }

constexpr int kMaxDevices = 64;

// The co-resident grid of one kernel, per device. Function attributes and
// occupancy belong to a device: each device ordinal gets its own raised
// dynamic shared-memory limit and its own grid cap, asked on the first
// launch there and cached under the lock. A failed query is not cached.
struct CoresidentCache {
  std::mutex lock;
  int blocks[kMaxDevices] = {};
};

// The most blocks of `kernel` the current device holds at once with
// `threads` a block and `smem` bytes of dynamic shared memory, after
// raising the kernel's dynamic shared-memory limit to `smem` there: the
// largest grid a cooperative launch may start. A launch may ask for less
// shared memory than `smem`; its blocks then fit at least as well.
inline cudaError_t coresident_blocks(CoresidentCache& cache, const void* kernel, int threads,
                                     size_t smem, int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(cache.lock);
  if (cache.blocks[dev] < 1) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    if (sms * per_sm < 1) return cudaErrorInvalidConfiguration;
    cache.blocks[dev] = sms * per_sm;
  }
  *blocks = cache.blocks[dev];
  return cudaSuccess;
}

}  // namespace lstm
