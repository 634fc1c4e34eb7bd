// Flash-attention forward for Hopper (sm_90a): exact softmax attention with
// an online softmax, optional causal mask and sliding window, and
// grouped-query attention by index map.
//
// Replaces: deeplearning4j_tpu/ops/pallas_kernels.py:_flash_kernel (launched
// by _flash_forward through pl.pallas_call).
//
// What bounds it on this card. At the serving shapes (n = 64 heads, T = 512,
// d = 64, causal, bf16) the call reads Q, K and V and writes O: about 17 MB,
// 5 us at 3.35 TB/s, against 2.1 GFLOP of products, 2 us at the bf16
// tensor-core peak. So the bound is memory. This kernel does not reach it:
// its products run on the f32 CUDA cores from shared memory (67 TFLOP/s
// peak, so about 32 us of pure arithmetic for the causal half), which is the
// simple, exact design the f32 parity bar (1e-5) needs first.
//
// What the design does about that:
// - one thread block per (flattened head b, 64-row query tile); each block
//   reads its Q tile once and streams K/V tiles of 64 keys through shared
//   memory, so no T x T score matrix ever reaches device memory and each
//   K/V element is read once per query tile;
// - the running max, running sum and the output accumulator stay in f32
//   registers across the K/V loop (4 rows x (d/8) columns per thread);
// - tiles entirely above the causal diagonal, or entirely outside the
//   sliding window, are skipped, not computed and masked;
// - GQA reads kv head b / group directly: no repeated K/V in memory;
// - the ragged end of T is masked in the kernel, so the wrapper never pads;
// - query tiles are launched heaviest first (the last causal tiles have the
//   most keys) to shorten the tail of the grid.
// Tensor cores (wgmma), TMA and warp specialisation are left for later work.
//
// Interface: a plain C function, bound from Python with ctypes. It launches
// on the caller's stream, allocates nothing, and returns cudaGetLastError().

#include "flash_common.cuh"

namespace {

using flash::NEG_INF;
using flash::from_f32;
using flash::to_f32;

constexpr int BM = 64;     // query rows per block
constexpr int BN = 64;     // keys per K/V tile
constexpr int NT = 128;    // threads per block: 16 row groups x 8 column groups

template <int DP>
constexpr size_t smem_bytes() {
  // Q [BM][DP+1], K [BN][DP+1], V [BN][DP], P [BM][BN+1], all f32
  return sizeof(float) * (size_t)(BM * (DP + 1) + BN * (DP + 1) + BN * DP + BM * (BN + 1));
}

// T: element type of q/k/v/o. DP: head dim rounded up to 16/32/64/128; the
// columns d..DP-1 are held at zero in shared memory so they add nothing.
template <typename T, int DP>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int t, int d, int group,
                 int causal, int window, float scale) {
  extern __shared__ float smem[];
  constexpr int QS = DP + 1;   // odd row strides: column walks hit distinct banks
  constexpr int PS = BN + 1;
  constexpr int CPT = DP / 8;  // output columns per thread
  float* qs = smem;
  float* ks = qs + BM * QS;
  float* vs = ks + BN * QS;
  float* ps = vs + BN * DP;

  const int b = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;   // heaviest tiles first
  const int tid = threadIdx.x;
  const int rg = tid >> 3;     // rows rg*4 .. rg*4+3 of the tile
  const int cg = tid & 7;      // keys cg + 8*jj, columns cg + 8*cc

  const size_t td = (size_t)t * d;
  const T* qb = q + (size_t)b * td;
  const T* kb = k + (size_t)(b / group) * td;
  const T* vb = v + (size_t)(b / group) * td;

  // Q tile, scaled before the product as the reference does, and rounded
  // back to T so a bf16 input sees the same scaled values.
  for (int i = tid; i < BM * DP; i += NT) {
    const int r = i / DP, c = i % DP;
    float x = 0.f;
    if (q0 + r < t && c < d)
      x = to_f32(from_f32<T>(to_f32(qb[(size_t)(q0 + r) * d + c]) * scale));
    qs[r * QS + c] = x;
  }

  float m_i[4], l_i[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) acc[i][cc] = 0.f;
  }

  // live K/V tiles of this query tile
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
    __syncthreads();   // the previous tile's K, V and P are no longer read
    for (int i = tid; i < BN * DP; i += NT) {
      const int r = i / DP, c = i % DP;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < t && c < d) {
        const size_t off = (size_t)(k0 + r) * d + c;
        kx = to_f32(kb[off]);
        vx = to_f32(vb[off]);
      }
      ks[r * QS + c] = kx;
      vs[r * DP + c] = vx;
    }
    __syncthreads();

    // S = (Q scale) K^T on a 4 x 8 micro-tile per thread
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; ++c) {
      float qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(rg * 4 + i) * QS + c];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float kv = ks[(cg + 8 * jj) * QS + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][jj] = fmaf(qv[i], kv, s[i][jj]);
      }
    }

    // mask, then the online softmax; the 8 lanes of a row group share rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + rg * 4 + i;
      bool keep[8];
      float mc = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int kpos = k0 + cg + 8 * jj;
        bool kp = kpos < t;
        if (causal) {
          kp = kp && kpos <= qpos;
          if (window > 0) kp = kp && (qpos - kpos < window);
        }
        keep[jj] = kp;
        if (!kp) s[i][jj] = NEG_INF;
        mc = fmaxf(mc, s[i][jj]);
      }
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 4));
      const float m_new = fmaxf(m_i[i], mc);
      const float corr = (m_i[i] == NEG_INF) ? 0.f : expf(m_i[i] - m_new);
      float rowsum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        // a masked key adds exactly nothing, even to a row that has seen
        // no key yet
        const float p = keep[jj] ? expf(s[i][jj] - m_new) : 0.f;
        rowsum += p;
        ps[(rg * 4 + i) * PS + cg + 8 * jj] = p;
      }
      l_i[i] = l_i[i] * corr + rowsum;   // this lane's share of the row sum
      m_i[i] = m_new;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) acc[i][cc] *= corr;
    }
    __syncthreads();

    // O += P V on a 4 x CPT micro-tile per thread
#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(rg * 4 + i) * PS + j];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const float vv = vs[j * DP + cg + 8 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(pv[i], vv, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = l_i[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l += __shfl_xor_sync(0xffffffffu, l, 4);
    const int qpos = q0 + rg * 4 + i;
    if (qpos >= t) continue;
    const float denom = fmaxf(l, 1e-30f);
    T* orow = o + (size_t)b * td + (size_t)qpos * d;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int c = cg + 8 * cc;
      if (c < d) orow[c] = from_f32<T>(acc[i][cc] / denom);
    }
    // a row with no unmasked key gets +1e30, so a backward's exp(s - lse)
    // underflows to an exact 0; a caller that needs no lse passes null
    if (lse != nullptr && cg == 0)
      lse[(size_t)b * t + qpos] = l > 0.f ? m_i[i] + logf(denom) : -NEG_INF;
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   int n, int t, int d, int group, int causal, int window,
                   float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DP>();
  auto kernel = flash_fwd_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(n, (t + BM - 1) / BM);
  kernel<<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), t, d, group, causal, window,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, void* lse,
                     int n, int t, int d, int group, int causal, int window,
                     float scale, cudaStream_t stream) {
  if (d <= 16) return launch<T, 16>(q, k, v, o, lse, n, t, d, group, causal, window, scale, stream);
  if (d <= 32) return launch<T, 32>(q, k, v, o, lse, n, t, d, group, causal, window, scale, stream);
  if (d <= 64) return launch<T, 64>(q, k, v, o, lse, n, t, d, group, causal, window, scale, stream);
  return launch<T, 128>(q, k, v, o, lse, n, t, d, group, causal, window, scale, stream);
}

}  // namespace

// q: [n, t, d]; k, v: [n / group, t, d]; o: [n, t, d] in the input type;
// lse: [n, t] f32, or null to skip writing it. All contiguous.
// dtype: 0 = float32, 1 = bfloat16.
// window <= 0 means no window. Returns a cudaError_t (0 on success).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int n, int t, int d,
                              int group, int causal, int window, float scale,
                              int dtype, void* stream) {
  if (n < 1 || t < 1 || d < 1 || d > 128 || group < 1 || n % group ||
      (t + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(q, k, v, o, lse, n, t, d, group, causal, window, scale, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(q, k, v, o, lse, n, t, d, group, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
