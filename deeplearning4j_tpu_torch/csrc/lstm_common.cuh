// Pieces shared by the LSTM cell kernels (forward, backward): the block
// size, element conversion between the storage type and f32, and the gate
// activation.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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

}  // namespace lstm
