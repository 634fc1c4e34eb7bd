// Tensor-core building blocks of the bf16 flash-attention kernels (forward,
// dQ and dK/dV): asynchronous global-to-shared copies (cp.async, from
// cp_async.cuh), shared-memory fragment loads (ldmatrix), the m16n8k16
// bf16 product with f32 accumulation (mma.sync), and a tile loader that
// stages rows of a [t, d] bf16 matrix.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * g + tq, g = lane / 4,
// tq = lane % 4), which the kernels rely on:
// - A (16 x 16, row major), 4 registers of two bf16: a0 = rows g, columns
//   2tq, 2tq+1; a1 = row g + 8, the same columns; a2, a3 = the same rows,
//   columns 2tq + 8, 2tq + 9;
// - B (16 x 8, k x n), 2 registers: b0 = column g, rows 2tq, 2tq+1; b1 =
//   rows 2tq + 8, 2tq + 9;
// - C (16 x 8 f32), 4 registers: c0, c1 = row g, columns 2tq, 2tq+1; c2, c3
//   = row g + 8, the same columns.
// So a C fragment pair (n-tiles 2j, 2j+1) is, element for element, the A
// fragment of the 16-column k-chunk j: a product's result feeds the next
// product from registers.
//
// Shared tiles keep rows of DP bf16 with a stride of DP + 8 elements: the 8
// rows an ldmatrix reads then start 16 bytes apart modulo 128, in distinct
// banks, for every DP in {16, 32, 64, 128, 256}.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace flash {
namespace tc {

using bf16 = __nv_bfloat16;

using cpasync::cp_async16;
using cpasync::cp_async4;
using cpasync::cp_async_commit;
using cpasync::cp_async_wait;
using cpasync::smem_u32;

// four 8 x 8 b16 matrices; lanes 8m .. 8m+7 give the row addresses of
// matrix m, and register m of each lane receives its (lane / 4, 2 (lane % 4)
// + {0, 1}) pair
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

// the same, transposed: register m receives (2 (lane % 4) + {0, 1}, lane / 4)
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

// c += a b on one 16 x 8 x 16 tile, f32 accumulation
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of 16-column k-chunk j from C fragments c[2j], c[2j+1],
// each value rounded to bf16.
template <int N>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c)[N][4],
                                       int j) {
  a[0] = pack_bf16(c[2 * j][0], c[2 * j][1]);
  a[1] = pack_bf16(c[2 * j][2], c[2 * j][3]);
  a[2] = pack_bf16(c[2 * j + 1][0], c[2 * j + 1][1]);
  a[3] = pack_bf16(c[2 * j + 1][2], c[2 * j + 1][3]);
}

// Stage rows r0 .. r0 + ROWS - 1 of a row-major [t, d] bf16 matrix into a
// shared ROWS x DP tile of row stride DP + 8; rows past t and columns past d
// are zero. With vec (d % 8 == 0 and a 16-byte aligned base, so every row
// starts on a 16-byte boundary) each thread issues 16-byte cp.async copies
// that complete asynchronously (the caller commits and waits); otherwise the
// tile is loaded element by element, synchronously.
template <int ROWS, int DP, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int t, int d, bool vec, int tid) {
  constexpr int LD = DP + 8;
  if (vec) {
    constexpr int CH = DP / 8;   // 16-byte chunks a row
    for (int i = tid; i < ROWS * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool in = r0 + r < t && c < d;
      cp_async16(dst + r * LD + c, in ? src + (size_t)(r0 + r) * d + c : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < ROWS * DP; i += NT) {
      const int r = i / DP, c = i % DP;
      dst[r * LD + c] = (r0 + r < t && c < d)
                            ? src[(size_t)(r0 + r) * d + c]
                            : __float2bfloat16_rn(0.f);
    }
  }
}

// Write ROWS x DP of a shared tile (row stride DP + 8) to rows r0 .. of a
// row-major [t, d] bf16 matrix, skipping rows past t and columns past d;
// 16 bytes a lane with vec, else element by element. One warp's rows.
template <int ROWS, int DP>
__device__ __forceinline__ void store_rows(bf16* dst, const bf16* src, int r0,
                                           int t, int d, bool vec, int lane) {
  constexpr int LD = DP + 8;
  if (vec) {
    constexpr int CH = DP / 8;
    for (int i = lane; i < ROWS * CH; i += 32) {
      const int r = i / CH, c = (i % CH) * 8;
      if (r0 + r < t && c < d)
        *reinterpret_cast<uint4*>(dst + (size_t)(r0 + r) * d + c) =
            *reinterpret_cast<const uint4*>(src + r * LD + c);
    }
  } else {
    for (int i = lane; i < ROWS * DP; i += 32) {
      const int r = i / DP, c = i % DP;
      if (r0 + r < t && c < d) dst[(size_t)(r0 + r) * d + c] = src[r * LD + c];
    }
  }
}

// whether a row of 8 bf16 at p can move as one 16-byte access (host side)
inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace tc
}  // namespace flash
