// Flash-attention backward, dQ pass, for Hopper (sm_90a): for each query
// tile, stream the live K/V tiles, recompute P from the forward's logsumexp
// and accumulate dQ = sum over keys of dS K, with
//   S = (Q K^T) scale, P = exp(S - lse), dP = dO V^T,
//   dS = P * (dP - delta) * scale, delta = rowsum(dO * O).
// Causal mask, sliding window and grouped-query attention as in the forward.
//
// Replaces: deeplearning4j_tpu/ops/pallas_kernels.py:_flash_dq_kernel
// (launched by _flash_bwd through pl.pallas_call).
//
// What bounds it on this card. At the training shape (n = 32 x 8 = 256
// heads, T = 511, d = 64, causal, bf16) the call reads Q, K, V and dO and
// writes dQ (about 84 MB of bf16) plus lse and delta (1 MB of f32): 25 us at
// 3.35 TB/s. Its products (S, dP and dS K: 6 n pairs d, 1.3e10 operations
// for the causal half) take 13 us at the bf16 tensor-core peak. So the bound
// is memory. This kernel does not reach it: its products run on the f32
// CUDA cores from shared memory (67 TFLOP/s peak, so about 190 us of pure
// arithmetic), the simple exact design the f32 parity bar (1e-5) needs
// first.
//
// What the design does about that:
// - one thread block per (flattened head b, 64-row query tile); Q, dO, lse
//   and delta of the tile are read once, and K/V tiles of 64 keys stream
//   through shared memory, so no T x T matrix reaches device memory;
// - dQ stays in f32 registers (4 rows x d/8 columns a thread) across the
//   K/V loop and is written once, rounded to the input type;
// - S and dP are built one after the other in the same registers, with P
//   parked in shared memory between them, which keeps the register count
//   of the d = 128 instantiation down;
// - tiles entirely above the causal diagonal or outside the window are
//   skipped (the reference's _block_live rule); keys and rows past T are
//   masked here, so the wrapper never pads;
// - a row with no visible key has lse = +1e30 from the forward, and a masked
//   entry gets P = 0 directly, so nothing computes exp(NEG_INF - NEG_INF);
// - GQA reads kv head b / group directly: no repeated K/V in memory;
// - query tiles are launched heaviest first (under a causal mask the last
//   tiles see the most keys).
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

constexpr int BM = 64;     // query rows per block
constexpr int BN = 64;     // keys per K/V tile
constexpr int NT = 128;    // threads per block: 16 row groups x 8 column groups

template <int DP>
constexpr size_t smem_bytes() {
  // Q, dO [BM][DP+1]; K, V [BN][DP+1]; P then dS [BM][BN+1]; lse, delta [BM]
  return sizeof(float) *
         (size_t)(2 * BM * (DP + 1) + 2 * BN * (DP + 1) + BM * (BN + 1) + 2 * BM);
}

// T: element type of q/k/v/dO/dQ. DP: head dim rounded up to 16/32/64/128;
// columns d..DP-1 are zero in shared memory so they add nothing.
template <typename T, int DP>
__global__ void __launch_bounds__(NT)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, int t, int d, int group, int causal,
                int window, float scale) {
  extern __shared__ float smem[];
  constexpr int QS = DP + 1;   // odd row strides: column walks hit distinct banks
  constexpr int PS = BN + 1;
  constexpr int CPT = DP / 8;  // dQ columns per thread
  float* qs = smem;
  float* dos = qs + BM * QS;
  float* ks = dos + BM * QS;
  float* vs = ks + BN * QS;
  float* ds = vs + BN * QS;
  float* lses = ds + BM * PS;
  float* dels = lses + BM;

  const int b = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;   // heaviest tiles first
  const int tid = threadIdx.x;
  const int rg = tid >> 3;     // rows rg*4 .. rg*4+3 of the tile
  const int cg = tid & 7;      // keys cg + 8*jj, columns cg + 8*cc

  const size_t td = (size_t)t * d;
  const T* qb = q + (size_t)b * td;
  const T* gb = dout + (size_t)b * td;
  const T* kb = k + (size_t)(b / group) * td;
  const T* vb = v + (size_t)(b / group) * td;

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

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) acc[i][cc] = 0.f;

  // live K/V tiles of this query tile (the forward's rule)
  const int n_tiles = (t + BN - 1) / BN;
  int kt_begin = 0, kt_end = n_tiles;
  if (causal) {
    const int q_last = min(q0 + BM, t) - 1;
    kt_end = min(n_tiles, q_last / BN + 1);
    if (window > 0) {
      const int first_key = q0 - window + 1;   // earliest key any row sees
      if (first_key > 0) kt_begin = first_key / BN;
    }
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();   // the previous tile's K, V and dS are no longer read
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
    __syncthreads();

    // S = Q K^T on a 4 x 8 micro-tile per thread, then P into shared memory
    float acc_s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) acc_s[i][jj] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; ++c) {
      float qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(rg * 4 + i) * QS + c];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float kv = ks[(cg + 8 * jj) * QS + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc_s[i][jj] = fmaf(qv[i], kv, acc_s[i][jj]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i;
      const float l = lses[r];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const bool keep = visible(q0 + r, k0 + cg + 8 * jj, t, causal, window);
        // the reference's order: the f32 product, times the unrounded scale
        ds[r * PS + cg + 8 * jj] = keep ? expf(acc_s[i][jj] * scale - l) : 0.f;
      }
    }

    // dP = dO V^T in the same registers; dS over this thread's own P
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) acc_s[i][jj] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; ++c) {
      float gv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) gv[i] = dos[(rg * 4 + i) * QS + c];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float vv = vs[(cg + 8 * jj) * QS + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc_s[i][jj] = fmaf(gv[i], vv, acc_s[i][jj]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i;
      const float dl = dels[r];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        float* e = &ds[r * PS + cg + 8 * jj];
        *e = (*e * (acc_s[i][jj] - dl)) * scale;
      }
    }
    __syncthreads();

    // dQ += dS K on a 4 x CPT micro-tile per thread
#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = ds[(rg * 4 + i) * PS + j];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const float kv = ks[j * QS + cg + 8 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(sv[i], kv, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + rg * 4 + i;
    if (qpos >= t) continue;
    T* row = dq + (size_t)b * td + (size_t)qpos * d;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int c = cg + 8 * cc;
      if (c < d) row[c] = from_f32<T>(acc[i][cc]);
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, int n, int t,
                   int d, int group, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DP>();
  auto kernel = flash_dq_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(n, (t + BM - 1) / BM);
  kernel<<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), t, d, group, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dq, int n, int t,
                     int d, int group, int causal, int window, float scale,
                     cudaStream_t s) {
  if (d <= 16) return launch<T, 16>(q, k, v, dout, lse, delta, dq, n, t, d, group, causal, window, scale, s);
  if (d <= 32) return launch<T, 32>(q, k, v, dout, lse, delta, dq, n, t, d, group, causal, window, scale, s);
  if (d <= 64) return launch<T, 64>(q, k, v, dout, lse, delta, dq, n, t, d, group, causal, window, scale, s);
  return launch<T, 128>(q, k, v, dout, lse, delta, dq, n, t, d, group, causal, window, scale, s);
}

}  // namespace

// q, dout, dq: [n, t, d]; k, v: [n / group, t, d], all in one input type;
// lse, delta: [n, t] f32. All contiguous. dtype: 0 = float32, 1 = bfloat16.
// window <= 0 means no window; scale is 1/sqrt(d) unrounded. Returns a
// cudaError_t (0 on success).
extern "C" int flash_attn_dq(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq, int n, int t, int d,
                             int group, int causal, int window, float scale,
                             int dtype, void* stream) {
  if (n < 1 || t < 1 || d < 1 || d > 128 || group < 1 || n % group ||
      (t + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(q, k, v, dout, lse, delta, dq, n, t, d, group, causal, window, scale, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, n, t, d, group, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
