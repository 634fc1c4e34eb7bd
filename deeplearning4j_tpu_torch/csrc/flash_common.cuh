// Pieces shared by the flash-attention kernels (forward, dQ, dK/dV):
// element conversion between the storage type and f32, the reference's mask
// value, and the causal / sliding-window visibility rule.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace flash {

constexpr float NEG_INF = -1e30f;   // the reference's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Whether query qpos sees key kpos: both inside the sequence, and under a
// causal mask the key is not later than the query and, with a window
// (window > 0), fewer than `window` positions before it.
__device__ __forceinline__ bool visible(int qpos, int kpos, int t, int causal,
                                        int window) {
  if (qpos >= t || kpos >= t) return false;
  if (!causal) return true;
  return kpos <= qpos && (window <= 0 || qpos - kpos < window);
}

}  // namespace flash
