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
// Two kernels behind one entry point, chosen by dtype and nothing else:
// - bf16: flash_dkv_mma_kernel, on the tensor cores;
// - f32: flash_dkv_kernel, on the CUDA cores, the parity lane (1e-5 of each
//   gradient's max abs against the plain twin).
//
// What bounds it on this card. At the training shape (n = 32 x 8 = 256
// heads, T = 511, d = 64, causal, bf16) the call reads Q, K, V and dO and
// writes dK and dV (about 100 MB of bf16) plus lse and delta (1 MB of f32):
// 30 us at 3.35 TB/s. Its products (S, dP, P^T dO and dS^T Q: 8 n pairs d,
// 1.7e10 operations for the causal half) take 17 us at the bf16 tensor-core
// peak. So the bound is memory; the same products on the f32 CUDA cores
// (67 TFLOP/s peak) would take 260 us, which is why bf16 runs on the
// tensor cores.
//
// What both designs share:
// - one thread block per (kv head, 64-key tile). A TPU grid walks its
//   innermost axis in order on one core; CUDA blocks run in no order on 132
//   SMs, so nothing is summed across blocks. Under GQA the block itself
//   loops over the `group` query heads that share its kv head, and over
//   their live query tiles. It writes dK/dV [n / group, T, d] once, with
//   no race, no atomics and no per-q-head buffer, and rounds once to the
//   input type. (The reference writes per-q-head dK/dV in the input type
//   and sums each group outside the kernel, so in bf16 it rounds twice.)
// - query tiles wholly before the key tile (causal) or past the window are
//   skipped (the reference's _block_live rule); queries and keys past T are
//   masked here, so padded rows add nothing and the wrapper never pads;
// - a masked entry gets P = 0 directly, so nothing computes
//   exp(NEG_INF - NEG_INF), and its dS is 0 too;
// - key tiles are launched heaviest first (under a causal mask the first
//   tiles are seen by the most queries).
//
// The bf16 design:
// - 4 warps, each owning 16 key rows; K and V of the tile are loaded once
//   into bf16 shared memory (rows padded to DP + 8: ldmatrix without bank
//   conflicts) and read as A fragments by ldmatrix;
// - Q and dO tiles of 64 queries, with their lse and delta, stream through
//   a 2-stage cp.async ring. The (q-head, query tile) pairs of the group
//   loop are walked as one flat sequence, so the ring crosses from one
//   q-head's last tile into the next head's first without a stale stage;
// - for each live query tile, by mma.sync m16n8k16 (bf16 in, f32
//   accumulate): S^T = K Q^T, times the unrounded f32 scale; P^T = exp(S^T -
//   lse) in registers; dP^T = V dO^T; dS^T = P^T (dP^T - delta) scale in
//   registers; dV += P^T dO and dK += dS^T Q with P^T and dS^T converted in
//   registers from C to A fragments as bf16 (never through shared memory),
//   dO and Q read as B fragments by ldmatrix.trans. A tile is taken in two
//   passes of 32 queries, which keeps S^T and dP^T within the register
//   budget beside the two accumulators;
// - dK and dV stay in f32 registers (16 x d a warp each) for the whole
//   group loop, are rounded to bf16 once, staged through shared memory and
//   written with 16-byte stores;
// - rows that do not start on a 16-byte boundary (d % 8 != 0, or a base
//   pointer that carries a storage offset) are loaded and stored element by
//   element inside the same kernel; columns d..DP-1 are zero.
// Rounding: P^T and dS^T are rounded to bf16 before their products (the
// reference multiplies them in f32). Each term moves by at most 2^-9 of its
// size; summed over the keys' queries this stays within one bf16 step at the
// gradient's scale: the bar is max|g - g_f32| <= 2^-7 max|g_f32|
// (ops/flash_attention.py: BF16_DKV_BAR).
//
// The f32 design (unchanged since it was first written): K, V, Q, dO, P^T
// and dS^T staged as f32 in shared memory, scalar fmaf products on 4 x 8
// micro-tiles per thread, dK and dV in registers (4 key rows x d/8 columns
// a thread each).
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

// ---- bf16 on the tensor cores ----

template <int DP>
constexpr size_t mma_smem_bytes() {
  // K, V [BN][DP+8]; Q, dO [2 stages][BM][DP+8], all bf16; lse, delta
  // [2 stages][BM] f32
  return sizeof(__nv_bfloat16) * (size_t)(2 * BN + 4 * BM) * (DP + 8) +
         sizeof(float) * 4 * BM;
}

// DP: head dim rounded up to 16/32/64/128. Each of the 4 warps owns 16 key
// rows; lane (g, tq) holds key rows g and g + 8 of them (see flash_mma.cuh).
template <int DP>
__global__ void __launch_bounds__(NT)
flash_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int t, int d, int group,
                     int causal, int window, float scale, int vec) {
  using namespace flash::tc;
  constexpr int LD = DP + 8;
  constexpr int KC = DP / 16;                  // 16-wide chunks of the head dim
  constexpr int ON = DP / 8;                   // 8-wide tiles of dK / dV
  // queries a pass of the inner products takes: two passes of 32 a tile
  // keep S^T and dP^T (16 registers each) small beside the two f32
  // accumulators (DP registers a lane); flash_variants.py measured it
  // faster than one pass of 64 at the LM train shape
  constexpr int QW = 32;
  constexpr int QN = QW / 8;                   // 8-query n-tiles of a pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + BN * LD;
  bf16* qs = vs + BN * LD;                     // [2][BM][LD]
  bf16* gs = qs + 2 * BM * LD;                 // dO, [2][BM][LD]
  float* lses = reinterpret_cast<float*>(gs + 2 * BM * LD);   // [2][BM]
  float* dels = lses + 2 * BM;                                 // [2][BM]

  const int h = blockIdx.x;            // kv head
  const int k0 = blockIdx.y * BN;      // heaviest (earliest) key tiles first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const size_t td = (size_t)t * d;

  load_tile<BN, DP, NT>(ks, k + (size_t)h * td, k0, t, d, vec, tid);
  load_tile<BN, DP, NT>(vs, v + (size_t)h * td, k0, t, d, vec, tid);

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
  const int n_live = qt_end - qt_begin;
  const int total = group * n_live;   // (q-head, query tile) pairs, flat

  // Q, dO, lse and delta of pair i into a stage; lse/delta of rows past T
  // are zero-filled (their P is masked to 0 regardless)
  auto issue = [&](int i, int stage) {
    const int b = h * group + i / n_live;
    const int q0 = (qt_begin + i % n_live) * BM;
    load_tile<BM, DP, NT>(qs + stage * BM * LD, q + (size_t)b * td, q0, t, d, vec, tid);
    load_tile<BM, DP, NT>(gs + stage * BM * LD, dout + (size_t)b * td, q0, t, d, vec, tid);
    for (int r = tid; r < BM; r += NT) {
      const bool in = q0 + r < t;
      const size_t off = in ? (size_t)b * t + q0 + r : 0;
      cp_async4(lses + stage * BM + r, lse + off, in ? 4 : 0);
      cp_async4(dels + stage * BM + r, delta + off, in ? 4 : 0);
    }
  };
  if (total > 0) issue(0, 0);
  cp_async_commit();   // K and V ride with the first pair's group

  float acc_k[ON][4], acc_v[ON][4];
#pragma unroll
  for (int j = 0; j < ON; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  bf16* kw = ks + warp * 16 * LD;      // this warp's 16 key rows
  bf16* vw = vs + warp * 16 * LD;
  const int a_off = (lane & 15) * LD + (lane >> 4) * 8;   // A fragments
  const int mi = lane >> 3, r8 = lane & 7;
  // B fragments of Q / dO (queries x dims) for S^T and dP^T, and the same
  // tiles transposed for dV and dK
  const int b_off = ((mi >> 1) * 8 + r8) * LD + (mi & 1) * 8;
  const int bt_off = ((mi & 1) * 8 + r8) * LD + (mi >> 1) * 8;
  const int key0 = k0 + warp * 16 + g;  // this lane's keys: key0, key0 + 8

  for (int i = 0; i < total; ++i) {
    const int stage = i & 1;
    if (i + 1 < total) issue(i + 1, stage ^ 1);   // the stage read last time
    cp_async_commit();
    cp_async_wait<1>();   // this pair's group (and K, V) has landed
    __syncthreads();
    const int q0 = (qt_begin + i % n_live) * BM;
    const bf16* qst = qs + stage * BM * LD;
    const bf16* gst = gs + stage * BM * LD;
    const float* lst = lses + stage * BM;
    const float* dst = dels + stage * BM;
    const bool full = k0 + BN <= t && q0 + BM <= t &&
                      (!causal || (k0 + BN - 1 <= q0 &&
                                   (window <= 0 || q0 + BM - 1 - k0 < window)));

#pragma unroll
    for (int pass = 0; pass < BM / QW; ++pass) {
      const int c0 = pass * QW;   // first query of the pass within the tile
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x QW queries a warp
      float s[QN][4], dp[QN][4];
#pragma unroll
      for (int j = 0; j < QN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t ka[4], va[4];
        ldsm_x4(ka, kw + kc * 16 + a_off);
        ldsm_x4(va, vw + kc * 16 + a_off);
#pragma unroll
        for (int j = 0; j < QN / 2; ++j) {
          uint32_t bq[4], bg[4];
          const int off = (c0 + j * 16) * LD + kc * 16 + b_off;
          ldsm_x4(bq, qst + off);
          ldsm_x4(bg, gst + off);
          mma(s[2 * j], ka, bq[0], bq[1]);
          mma(s[2 * j + 1], ka, bq[2], bq[3]);
          mma(dp[2 * j], va, bg[0], bg[1]);
          mma(dp[2 * j + 1], va, bg[2], bg[3]);
        }
      }
      // P^T and dS^T in registers; the reference's order: the f32 product
      // times the unrounded scale
#pragma unroll
      for (int j = 0; j < QN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = c0 + j * 8 + 2 * tq + (e & 1);
          const bool keep = full || visible(q0 + qc, key0 + (e >> 1) * 8, t,
                                            causal, window);
          const float p = keep ? expf(s[j][e] * scale - lst[qc]) : 0.f;
          s[j][e] = p;
          dp[j][e] = (p * (dp[j][e] - dst[qc])) * scale;
        }
      // dV += P^T dO and dK += dS^T Q, 16 queries a chunk
#pragma unroll
      for (int kk = 0; kk < QW / 16; ++kk) {
        uint32_t pa[4], sa[4];
        c_to_a(pa, s, kk);
        c_to_a(sa, dp, kk);
#pragma unroll
        for (int j = 0; j < DP / 16; ++j) {
          uint32_t bg[4], bq[4];
          const int off = (c0 + kk * 16) * LD + j * 16 + bt_off;
          ldsm_x4_t(bg, gst + off);
          ldsm_x4_t(bq, qst + off);
          mma(acc_v[2 * j], pa, bg[0], bg[1]);
          mma(acc_v[2 * j + 1], pa, bg[2], bg[3]);
          mma(acc_k[2 * j], sa, bq[0], bq[1]);
          mma(acc_k[2 * j + 1], sa, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();   // all warps are done with this stage
  }
  cp_async_wait<0>();
  __syncthreads();

  // dK and dV rounded once, through this warp's own K and V rows
#pragma unroll
  for (int j = 0; j < ON; ++j) {
    const int c = j * 8 + 2 * tq;
    *reinterpret_cast<__nv_bfloat162*>(kw + g * LD + c) =
        __floats2bfloat162_rn(acc_k[j][0], acc_k[j][1]);
    *reinterpret_cast<__nv_bfloat162*>(kw + (g + 8) * LD + c) =
        __floats2bfloat162_rn(acc_k[j][2], acc_k[j][3]);
    *reinterpret_cast<__nv_bfloat162*>(vw + g * LD + c) =
        __floats2bfloat162_rn(acc_v[j][0], acc_v[j][1]);
    *reinterpret_cast<__nv_bfloat162*>(vw + (g + 8) * LD + c) =
        __floats2bfloat162_rn(acc_v[j][2], acc_v[j][3]);
  }
  __syncwarp();
  store_rows<16, DP>(dk + (size_t)h * td, kw, k0 + warp * 16, t, d, vec, lane);
  store_rows<16, DP>(dv + (size_t)h * td, vw, k0 + warp * 16, t, d, vec, lane);
}

template <int DP>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int n, int t, int d, int group,
                       int causal, int window, float scale,
                       cudaStream_t stream) {
  using flash::tc::aligned16;
  constexpr size_t bytes = mma_smem_bytes<DP>();
  auto kernel = flash_dkv_mma_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int vec = d % 8 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(dout) && aligned16(dk) &&
                  aligned16(dv);
  const dim3 grid(n / group, (t + BN - 1) / BN);
  kernel<<<grid, NT, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), t, d,
      group, causal, window, scale, vec);
  return cudaGetLastError();
}

cudaError_t dispatch_mma(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dk, void* dv, int n, int t, int d, int group,
                         int causal, int window, float scale, cudaStream_t s) {
  if (d <= 16) return launch_mma<16>(q, k, v, dout, lse, delta, dk, dv, n, t, d, group, causal, window, scale, s);
  if (d <= 32) return launch_mma<32>(q, k, v, dout, lse, delta, dk, dv, n, t, d, group, causal, window, scale, s);
  if (d <= 64) return launch_mma<64>(q, k, v, dout, lse, delta, dk, dv, n, t, d, group, causal, window, scale, s);
  return launch_mma<128>(q, k, v, dout, lse, delta, dk, dv, n, t, d, group, causal, window, scale, s);
}

}  // namespace

// q, dout: [n, t, d]; k, v, dk, dv: [n / group, t, d], all in one input
// type; lse, delta: [n, t] f32. All contiguous. dtype: 0 = float32 (the
// CUDA-core kernel), 1 = bfloat16 (the tensor-core kernel); nothing falls
// back from one to the other. window <= 0 means no window; scale is
// 1/sqrt(d) unrounded.
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
  if (dtype == 1) return (int)dispatch_mma(q, k, v, dout, lse, delta, dk, dv, n, t, d, group, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
