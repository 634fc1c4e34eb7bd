// Flash-attention backward, dK/dV pass, for Hopper (sm_90a): for each K/V
// tile, stream the query tiles that see it, recompute P from the forward's
// logsumexp and accumulate
//   dV = sum over queries of P^T dO,  dK = sum over queries of dS^T Q,
// with S = (Q K^T) scale, P = exp(S - lse), dP = dO V^T,
// dS = P * (dP - delta) * scale and delta = rowsum(dO * O).
// Causal mask, sliding window and grouped-query attention as in the forward.
//
// Replaces: deeplearning4j_tpu/ops/pallas_kernels.py:_flash_dkv_kernel
// (launched by _flash_bwd through pl.pallas_call).
//
// What bounds it on this card. At the training shape (n = 32 x 8 = 256
// heads, T = 511, d = 64, causal, bf16) the call reads Q, K, V and dO and
// writes dK and dV (about 100 MB of bf16) plus lse and delta (1 MB of f32):
// 30 us at 3.35 TB/s. Its products (S, dP, P^T dO and dS^T Q: 8 n pairs d,
// 1.7e10 operations for the causal half) take 17 us at the bf16 tensor-core
// peak. So the bound is memory. This kernel does not reach it: its products
// run on the f32 CUDA cores from shared memory (67 TFLOP/s peak, so about
// 260 us of pure arithmetic), the simple exact design the f32 parity bar
// (1e-5) needs first.
//
// What the design does about that:
// - one thread block per (kv head, 64-key tile). A TPU grid walks its
//   innermost axis in order on one core; CUDA blocks run in no order on 132
//   SMs, so nothing is summed across blocks. Under GQA the block itself
//   loops over the `group` query heads that share its kv head, and over
//   their live query tiles. It writes dK/dV [n / group, T, d] once, with
//   no race, no atomics and no per-q-head buffer, and rounds once to the
//   input type. (The reference writes per-q-head dK/dV in the input type
//   and sums each group outside the kernel, so in bf16 it rounds twice.)
// - K and V of the tile are read once; Q, dO, lse and delta tiles of 64
//   queries stream through shared memory; dK and dV stay in f32 registers
//   (4 key rows x d/8 columns a thread each) and are written once;
// - S^T and dP^T are built one after the other in the same registers, with
//   P^T and dS^T kept in shared memory for the two accumulations;
// - query tiles wholly before the key tile (causal) or past the window are
//   skipped (the reference's _block_live rule); queries and keys past T are
//   masked here, so padded rows add nothing and the wrapper never pads;
// - a masked entry gets P = 0 directly, so nothing computes
//   exp(NEG_INF - NEG_INF);
// - key tiles are launched heaviest first (under a causal mask the first
//   tiles are seen by the most queries).
// Tensor cores (wgmma), TMA and warp specialisation are left for later work.
//
// Interface: a plain C function, bound from Python with ctypes. It launches
// on the caller's stream, allocates nothing, and returns cudaGetLastError().

#include "flash_common.cuh"

namespace {

using flash::NEG_INF;
using flash::from_f32;
using flash::to_f32;
using flash::visible;

constexpr int BM = 64;     // queries per Q/dO tile
constexpr int BN = 64;     // keys per block
constexpr int NT = 128;    // threads per block: 16 key-row groups x 8 column groups

template <int DP>
constexpr size_t smem_bytes() {
  // K, V [BN][DP+1]; Q, dO [BM][DP+1]; P^T, dS^T [BN][BM+1]; lse, delta [BM]
  return sizeof(float) *
         (size_t)(2 * BN * (DP + 1) + 2 * BM * (DP + 1) + 2 * BN * (BM + 1) + 2 * BM);
}

// T: element type of q/k/v/dO/dK/dV. DP: head dim rounded up to
// 16/32/64/128; columns d..DP-1 are zero in shared memory so they add
// nothing.
template <typename T, int DP>
__global__ void __launch_bounds__(NT)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dk, T* __restrict__ dv, int t, int d, int group,
                 int causal, int window, float scale) {
  extern __shared__ float smem[];
  constexpr int QS = DP + 1;   // odd row strides: column walks hit distinct banks
  constexpr int PS = BM + 1;
  constexpr int CPT = DP / 8;  // dK/dV columns per thread
  float* ks = smem;
  float* vs = ks + BN * QS;
  float* qs = vs + BN * QS;
  float* dos = qs + BM * QS;
  float* pt = dos + BM * QS;
  float* dst = pt + BN * PS;
  float* lses = dst + BN * PS;
  float* dels = lses + BM;

  const int h = blockIdx.x;            // kv head
  const int k0 = blockIdx.y * BN;      // heaviest (earliest) key tiles first
  const int tid = threadIdx.x;
  const int rg = tid >> 3;     // key rows rg*4 .. rg*4+3 of the tile
  const int cg = tid & 7;      // queries cg + 8*jj, columns cg + 8*cc

  const size_t td = (size_t)t * d;
  const T* kb = k + (size_t)h * td;
  const T* vb = v + (size_t)h * td;
  for (int i = tid; i < BN * DP; i += NT) {
    const int r = i / DP, c = i % DP;
    float kx = 0.f, vx = 0.f;
    if (k0 + r < t && c < d) {
      const size_t off = (size_t)(k0 + r) * d + c;
      kx = to_f32(kb[off]);
      vx = to_f32(vb[off]);
    }
    ks[r * QS + c] = kx;
    vs[r * QS + c] = vx;
  }

  float acc_k[4][CPT], acc_v[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) acc_k[i][cc] = acc_v[i][cc] = 0.f;

  // live query tiles of this key tile: some query at or after a key of the
  // tile (causal), and within the window of one
  const int n_tiles = (t + BM - 1) / BM;
  int qt_begin = 0, qt_end = n_tiles;
  if (causal) {
    qt_begin = k0 / BM;
    if (window > 0) {
      // a tile at q0 sees a key of this tile iff q0 < k0 + BN - 1 + window
      // (the entry point clamps window to t, so this cannot overflow)
      qt_end = min(n_tiles, (k0 + BN - 1 + window + BM - 1) / BM);
    }
  }

  for (int j = 0; j < group; ++j) {
    const int b = h * group + j;       // a query head of this kv head
    const T* qb = q + (size_t)b * td;
    const T* gb = dout + (size_t)b * td;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BM;
      __syncthreads();   // the previous tile's Q, dO, P^T and dS^T are no longer read
      for (int i = tid; i < BM * DP; i += NT) {
        const int r = i / DP, c = i % DP;
        float x = 0.f, g = 0.f;
        if (q0 + r < t && c < d) {
          const size_t off = (size_t)(q0 + r) * d + c;
          x = to_f32(qb[off]);
          g = to_f32(gb[off]);
        }
        qs[r * QS + c] = x;
        dos[r * QS + c] = g;
      }
      for (int i = tid; i < BM; i += NT) {
        const bool in = q0 + i < t;   // rows past T: P = 0 and no delta
        lses[i] = in ? lse[(size_t)b * t + q0 + i] : -NEG_INF;
        dels[i] = in ? delta[(size_t)b * t + q0 + i] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T on a 4 x 8 micro-tile per thread, then P^T
      float acc_s[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) acc_s[i][jj] = 0.f;
#pragma unroll 4
      for (int c = 0; c < DP; ++c) {
        float kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) kv[i] = ks[(rg * 4 + i) * QS + c];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float qv = qs[(cg + 8 * jj) * QS + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc_s[i][jj] = fmaf(kv[i], qv, acc_s[i][jj]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg * 4 + i;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int qc = cg + 8 * jj;
          const bool keep = visible(q0 + qc, k0 + r, t, causal, window);
          // the reference's order: the f32 product, times the unrounded scale
          pt[r * PS + qc] = keep ? expf(acc_s[i][jj] * scale - lses[qc]) : 0.f;
        }
      }

      // dP^T = V dO^T in the same registers; dS^T from this thread's own P^T
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) acc_s[i][jj] = 0.f;
#pragma unroll 4
      for (int c = 0; c < DP; ++c) {
        float vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) vv[i] = vs[(rg * 4 + i) * QS + c];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float gv = dos[(cg + 8 * jj) * QS + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc_s[i][jj] = fmaf(vv[i], gv, acc_s[i][jj]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg * 4 + i;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int qc = cg + 8 * jj;
          dst[r * PS + qc] = (pt[r * PS + qc] * (acc_s[i][jj] - dels[qc])) * scale;
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q on 4 x CPT micro-tiles per thread
#pragma unroll 4
      for (int qq = 0; qq < BM; ++qq) {
        float pv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = pt[(rg * 4 + i) * PS + qq];
          sv[i] = dst[(rg * 4 + i) * PS + qq];
        }
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) {
          const float gv = dos[qq * QS + cg + 8 * cc];
          const float qv = qs[qq * QS + cg + 8 * cc];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_v[i][cc] = fmaf(pv[i], gv, acc_v[i][cc]);
            acc_k[i][cc] = fmaf(sv[i], qv, acc_k[i][cc]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + rg * 4 + i;
    if (kpos >= t) continue;
    const size_t row = (size_t)h * td + (size_t)kpos * d;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int c = cg + 8 * cc;
      if (c < d) {
        dk[row + c] = from_f32<T>(acc_k[i][cc]);
        dv[row + c] = from_f32<T>(acc_v[i][cc]);
      }
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv, int n,
                   int t, int d, int group, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DP>();
  auto kernel = flash_dkv_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(n / group, (t + BN - 1) / BN);
  kernel<<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv),
      t, d, group, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dk, void* dv, int n,
                     int t, int d, int group, int causal, int window, float scale,
                     cudaStream_t s) {
  if (d <= 16) return launch<T, 16>(q, k, v, dout, lse, delta, dk, dv, n, t, d, group, causal, window, scale, s);
  if (d <= 32) return launch<T, 32>(q, k, v, dout, lse, delta, dk, dv, n, t, d, group, causal, window, scale, s);
  if (d <= 64) return launch<T, 64>(q, k, v, dout, lse, delta, dk, dv, n, t, d, group, causal, window, scale, s);
  return launch<T, 128>(q, k, v, dout, lse, delta, dk, dv, n, t, d, group, causal, window, scale, s);
}

}  // namespace

// q, dout: [n, t, d]; k, v, dk, dv: [n / group, t, d], all in one input
// type; lse, delta: [n, t] f32. All contiguous. dtype: 0 = float32,
// 1 = bfloat16. window <= 0 means no window; scale is 1/sqrt(d) unrounded.
// Returns a cudaError_t (0 on success).
extern "C" int flash_attn_dkv(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv, int n,
                              int t, int d, int group, int causal, int window,
                              float scale, int dtype, void* stream) {
  if (n < 1 || t < 1 || d < 1 || d > 128 || group < 1 || n % group ||
      (t + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  if (window > t) window = t;   // the same mask: no query is t keys back
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(q, k, v, dout, lse, delta, dk, dv, n, t, d, group, causal, window, scale, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, n, t, d, group, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
