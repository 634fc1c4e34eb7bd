// Flash-attention forward for Hopper (sm_90a): exact softmax attention with
// an online softmax, optional causal mask and sliding window, and
// grouped-query attention by index map.
//
// Replaces: deeplearning4j_tpu/ops/pallas_kernels.py:_flash_kernel (launched
// by _flash_forward through pl.pallas_call).
//
// Two kernels behind one entry point, chosen by dtype and nothing else:
// - bf16: flash_fwd_mma_kernel, on the tensor cores;
// - f32: flash_fwd_kernel, on the CUDA cores, the parity lane (1e-5 against
//   the plain twin; TF32 would break it).
//
// What bounds it on this card. At the LM training shape (n = 256 heads,
// T = 511, d = 64, causal, bf16) the call reads Q, K and V and writes O and
// lse: about 67 MB, 20 us at 3.35 TB/s, against 8.6 GFLOP of products for
// the causal half, 9 us at the bf16 tensor-core peak. So the bound is
// memory; the f32 CUDA-core products alone (67 TFLOP/s peak) would take
// 130 us, which is why bf16 runs on the tensor cores.
//
// The bf16 design (FlashAttention-2 class, mma.sync rather than wgmma):
// - one block of 4 warps per (flattened head b, 64-row query tile); each
//   warp owns 16 query rows. Q is staged once, scaled by the bf16 scale and
//   rounded back to bf16 (the reference's order), and held in registers as
//   A fragments;
// - K/V tiles of 64 keys stay bf16 in shared memory, in a 2-stage ring
//   filled by 16-byte cp.async copies, so the next tile's load overlaps this
//   tile's products; rows are padded to DP + 8 so ldmatrix is conflict free;
// - S = Q K^T by mma.sync m16n8k16 (bf16 in, f32 accumulate) from ldmatrix
//   fragments; the online softmax runs on the accumulator fragments (row max
//   and sum across each quad of lanes), masks in registers (causal, window,
//   the ragged end of T; a masked entry is an exact 0), and the row sum l
//   is taken from the unrounded f32 P, so lse keeps its f32 accuracy;
// - O += P V with P converted in registers from the C layout of S to the A
//   layout of the next product, as bf16 pairs: P never touches shared
//   memory; V comes in as B fragments by ldmatrix.trans;
// - O is divided by max(l, 1e-30), staged through shared memory and written
//   once with 16-byte stores; a row with no visible key gets O = 0 and
//   lse = +1e30, so a backward's exp(s - lse) is an exact 0;
// - tiles wholly above the causal diagonal or outside the window are
//   skipped; tiles wholly inside it skip the per-element mask; query tiles
//   run heaviest first; GQA reads kv head b / group directly;
// - rows that do not start on a 16-byte boundary (d % 8 != 0, or a base
//   pointer that carries a storage offset) are loaded and stored element by
//   element inside the same kernel; columns d..DP-1 are zero.
// Rounding: P is rounded to bf16 before P V (the reference multiplies f32 P
// by bf16 V). Each term p_j v_j then moves by at most 2^-9 p_j |v_j|, so O
// moves by at most 2^-9 max|V|, and O's own rounding adds 2^-9 |O|: the bar
// is |O - O_f32| <= 2^-8 (max|V| of the kv head + |O_f32|)
// (ops/flash_attention.py: BF16_O_BAR).
//
// The f32 design (unchanged since it was first written): the same grid and
// tiles, Q, K, V and P staged as f32 in shared memory, scalar fmaf products
// on a 4 x 8 micro-tile per thread.
// wgmma, TMA and warp specialisation are left for later work.
//
// Interface: a plain C function, bound from Python with ctypes. It launches
// on the caller's stream, allocates nothing, and returns cudaGetLastError().

#include "flash_common.cuh"
#include "flash_mma.cuh"

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

// ---- bf16 on the tensor cores ----

template <int DP>
constexpr size_t mma_smem_bytes() {
  // Q [BM][DP+8], then K and V [2 stages][BN][DP+8], all bf16
  return sizeof(__nv_bfloat16) * (size_t)(BM + 4 * BN) * (DP + 8);
}

constexpr float LOG2E = 1.4426950408889634f;

// DP: head dim rounded up to 16/32/64/128. Each of the 4 warps owns 16 query
// rows; lane (g, tq) holds rows g and g + 8 of them (see flash_mma.cuh).
// Up to d 64 the registers are capped so that 4 blocks fit an SM, which
// flash_variants.py measured faster at the LM train shape than 3 or 2,
// despite a few bytes of spill at d 64.
template <int DP>
__global__ void __launch_bounds__(NT, DP <= 64 ? 4 : 2)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int t, int d, int group, int causal, int window,
                     float scale, int vec) {
  using namespace flash::tc;
  constexpr int LD = DP + 8;
  constexpr int KC = DP / 16;   // 16-wide chunks of the head dim
  constexpr int ON = DP / 8;    // 8-wide output tiles of the head dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + BM * LD;          // [2][BN][LD]
  bf16* vs = ks + 2 * BN * LD;      // [2][BN][LD]

  const int b = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;   // heaviest tiles first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;

  const size_t td = (size_t)t * d;
  const bf16* qb = q + (size_t)b * td;
  const bf16* kb = k + (size_t)(b / group) * td;
  const bf16* vb = v + (size_t)(b / group) * td;

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

  // the first K/V tile's copy starts before Q is staged
  if (kt_begin < kt_end) {
    load_tile<BN, DP, NT>(ks, kb, kt_begin * BN, t, d, vec, tid);
    load_tile<BN, DP, NT>(vs, vb, kt_begin * BN, t, d, vec, tid);
  }
  cp_async_commit();

  // Q, scaled before the product as the reference does and rounded back to
  // bf16, then into registers as A fragments
  if (vec) {
    for (int i = tid; i < BM * (DP / 8); i += NT) {
      const int r = i / (DP / 8), c = (i % (DP / 8)) * 8;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (q0 + r < t && c < d) {
        x = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * d + c);
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h[e]);
          h[e] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
        }
      }
      *reinterpret_cast<uint4*>(qs + r * LD + c) = x;
    }
  } else {
    for (int i = tid; i < BM * DP; i += NT) {
      const int r = i / DP, c = i % DP;
      float x = 0.f;
      if (q0 + r < t && c < d) x = to_f32(qb[(size_t)(q0 + r) * d + c]) * scale;
      qs[r * LD + c] = __float2bfloat16_rn(x);
    }
  }
  __syncthreads();
  uint32_t qf[KC][4];
  bf16* qw = qs + warp * 16 * LD;   // this warp's 16 rows; only it reads them
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
    ldsm_x4(qf[kc], qw + (lane & 15) * LD + kc * 16 + (lane >> 4) * 8);

  float acc[ON][4];
#pragma unroll
  for (int j = 0; j < ON; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;   // this lane's rows: row0, row0 + 8
  // ldmatrix row offsets: B fragments of K (keys x dims) and, transposed, of
  // V (keys x dims); lanes 8m .. 8m+7 address matrix m
  const int mi = lane >> 3, r8 = lane & 7;
  const int k_off = ((mi >> 1) * 8 + r8) * LD + (mi & 1) * 8;
  const int v_off = ((mi & 1) * 8 + r8) * LD + (mi >> 1) * 8;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {   // the next tile, into the stage read last time
      load_tile<BN, DP, NT>(ks + (stage ^ 1) * BN * LD, kb, (kt + 1) * BN, t, d, vec, tid);
      load_tile<BN, DP, NT>(vs + (stage ^ 1) * BN * LD, vb, (kt + 1) * BN, t, d, vec, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();   // this tile's group has landed
    __syncthreads();
    const bf16* kst = ks + stage * BN * LD;
    const bf16* vst = vs + stage * BN * LD;
    const int k0 = kt * BN;

    // S = (Q scale) K^T: 16 rows x 64 keys a warp, 8 n-tiles of 8 keys
    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        uint32_t bk[4];
        ldsm_x4(bk, kst + j * 16 * LD + kc * 16 + k_off);
        mma(s[2 * j], qf[kc], bk[0], bk[1]);
        mma(s[2 * j + 1], qf[kc], bk[2], bk[3]);
      }
    }

    // a tile wholly inside T and inside the mask for all 64 rows needs no
    // per-element test
    const bool full = k0 + BN <= t && q0 + BM <= t &&
                      (!causal || (k0 + BN - 1 <= q0 &&
                                   (window <= 0 || q0 + BM - 1 - k0 < window)));
    uint32_t keep = 0xffffffffu;   // bit 4 j + e: entry s[j][e] is visible
    if (!full) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(row0 + (e >> 1) * 8, k0 + j * 8 + 2 * tq + (e & 1), t,
                       causal, window))
            keep &= ~(1u << (4 * j + e));
    }

    // online softmax on the fragments; a quad of lanes shares each row
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (keep >> (4 * j + e) & 1) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    float corr[2], m_new[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m_i[r], mx[r]);
      corr[r] = (m_i[r] == NEG_INF) ? 0.f : exp2f((m_i[r] - m_new[r]) * LOG2E);
      m_i[r] = m_new[r];
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a masked key adds exactly nothing, even to a row that has seen no
        // key yet (where s - m_new would be 0); exp by the SFU's exp2
        const float p = (keep >> (4 * j + e) & 1)
                            ? exp2f((s[j][e] - m_new[e >> 1]) * LOG2E) : 0.f;
        rowsum[e >> 1] += p;   // the unrounded P: lse stays f32-exact
        s[j][e] = p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_i[r] = l_i[r] * corr[r] + rowsum[r];
#pragma unroll
    for (int j = 0; j < ON; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // O += P V: P from registers as bf16 A fragments, 16 keys a chunk
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[4];
      c_to_a(pa, s, kk);
#pragma unroll
      for (int j = 0; j < DP / 16; ++j) {
        uint32_t bv[4];
        ldsm_x4_t(bv, vst + kk * 16 * LD + j * 16 + v_off);
        mma(acc[2 * j], pa, bv[0], bv[1]);
        mma(acc[2 * j + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();   // all warps are done with this stage
  }
  cp_async_wait<0>();

  // O = acc / l, rounded once, through this warp's rows of the Q tile
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_i[r] = l;
    den[r] = fmaxf(l, 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < ON; ++j) {
    const int c = j * 8 + 2 * tq;
    *reinterpret_cast<__nv_bfloat162*>(qw + g * LD + c) =
        __floats2bfloat162_rn(acc[j][0] / den[0], acc[j][1] / den[0]);
    *reinterpret_cast<__nv_bfloat162*>(qw + (g + 8) * LD + c) =
        __floats2bfloat162_rn(acc[j][2] / den[1], acc[j][3] / den[1]);
  }
  __syncwarp();
  store_rows<16, DP>(o + (size_t)b * td, qw, q0 + warp * 16, t, d, vec, lane);
  // a caller that needs no lse passes null
  if (lse != nullptr && tq == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = row0 + r * 8;
      if (qpos < t)
        lse[(size_t)b * t + qpos] = l_i[r] > 0.f ? m_i[r] + logf(den[r]) : -NEG_INF;
    }
  }
}

template <int DP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       void* lse, int n, int t, int d, int group, int causal,
                       int window, float scale, cudaStream_t stream) {
  using flash::tc::aligned16;
  constexpr size_t bytes = mma_smem_bytes<DP>();
  auto kernel = flash_fwd_mma_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int vec = d % 8 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(o);
  const dim3 grid(n, (t + BM - 1) / BM);
  kernel<<<grid, NT, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), t, d, group, causal, window, scale, vec);
  return cudaGetLastError();
}

cudaError_t dispatch_mma(const void* q, const void* k, const void* v, void* o,
                         void* lse, int n, int t, int d, int group, int causal,
                         int window, float scale, cudaStream_t s) {
  if (d <= 16) return launch_mma<16>(q, k, v, o, lse, n, t, d, group, causal, window, scale, s);
  if (d <= 32) return launch_mma<32>(q, k, v, o, lse, n, t, d, group, causal, window, scale, s);
  if (d <= 64) return launch_mma<64>(q, k, v, o, lse, n, t, d, group, causal, window, scale, s);
  return launch_mma<128>(q, k, v, o, lse, n, t, d, group, causal, window, scale, s);
}

}  // namespace

// q: [n, t, d]; k, v: [n / group, t, d]; o: [n, t, d] in the input type;
// lse: [n, t] f32, or null to skip writing it. All contiguous.
// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the tensor-core
// kernel); nothing falls back from one to the other.
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
  if (dtype == 1) return (int)dispatch_mma(q, k, v, o, lse, n, t, d, group, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
