// Pieces shared by the LSTM cell kernels (forward, backward): element
// conversion between the storage type and f32, the gate activations, and the
// tiled gate dot products z[b, g*H + j] - zx = sum_k h_prev[b, k] RW[k, g*H + j]
// for one block's tile of hidden units and batch rows.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace lstm {

constexpr int JT = 32;   // hidden units per block (one per lane)
constexpr int BT = 8;    // batch rows per pass (one per warp)
constexpr int KT = 32;   // reduction depth staged in shared memory
constexpr int NT = JT * BT;   // 256 threads

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }

// Shared-memory staging for gate_dots: a [BT][KT] tile of h_prev and a
// [KT][4][JT] tile of RW's four gate column slices.
struct DotSmem {
  float h[BT][KT];
  float rw[KT][4][JT];
};

// acc[g] = sum_k h_prev[b, k] * RW[k, g*H + j] for this thread's b = b0 + ty
// and j = j0 + tx, in f32 FMAs in k order. Every thread of the block calls
// it (it synchronises); rows b >= B and columns j >= H read zeros.
template <typename T>
__device__ __forceinline__ void gate_dots(const T* __restrict__ h_prev,
                                          const T* __restrict__ rw, int B, int H,
                                          int b0, int j0, DotSmem& s, float acc[4]) {
  const int tid = threadIdx.x;
  const int tx = tid % JT, ty = tid / JT;
  const size_t H4 = (size_t)4 * H;
#pragma unroll
  for (int g = 0; g < 4; ++g) acc[g] = 0.f;
  for (int k0 = 0; k0 < H; k0 += KT) {
    // start every load of the tile before the first shared-memory store,
    // so their latencies overlap instead of adding up
    float hv, rv[KT * 4 * JT / NT];
    {
      const int r = tid / KT, kk = tid % KT;   // BT x KT = NT: one each
      const int b = b0 + r, k = k0 + kk;
      hv = (b < B && k < H) ? to_f32(h_prev[(size_t)b * H + k]) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < KT * 4 * JT / NT; ++q) {
      const int i = tid + q * NT;
      const int jj = i % JT, g = (i / JT) % 4, kk = i / (4 * JT);
      const int k = k0 + kk, j = j0 + jj;
      rv[q] = (k < H && j < H) ? to_f32(rw[(size_t)k * H4 + (size_t)g * H + j]) : 0.f;
    }
    __syncthreads();   // the previous tile is no longer read
    s.h[tid / KT][tid % KT] = hv;
#pragma unroll
    for (int q = 0; q < KT * 4 * JT / NT; ++q) {
      const int i = tid + q * NT;
      s.rw[i / (4 * JT)][(i / JT) % 4][i % JT] = rv[q];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KT; ++kk) {
      const float h = s.h[ty][kk];
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[g] = fmaf(h, s.rw[kk][g][tx], acc[g]);
    }
  }
}

}  // namespace lstm
