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
// Two kernels behind one entry point, chosen by dtype and nothing else:
// - bf16: flash_dq_mma_kernel, on the tensor cores;
// - f32: flash_dq_kernel, on the CUDA cores, the parity lane (1e-5 of the
//   gradient's max abs against the plain twin).
//
// What bounds it on this card. At the training shape (n = 32 x 8 = 256
// heads, T = 511, d = 64, causal, bf16) the call reads Q, K, V and dO and
// writes dQ (about 84 MB of bf16) plus lse and delta (1 MB of f32): 25 us at
// 3.35 TB/s. Its products (S, dP and dS K: 6 n pairs d, 1.3e10 operations
// for the causal half) take 13 us at the bf16 tensor-core peak. So the bound
// is memory. On the f32 CUDA cores (67 TFLOP/s peak) the same products take
// about 190 us of pure arithmetic; the first design, which ran them there
// from f32 shared memory in both dtypes, took 0.95 ms, 37x the bound. That
// is why bf16 runs on the tensor cores.
//
// What both designs share:
// - one thread block per (flattened head b, 64-row query tile); Q, dO, lse
//   and delta of the tile are read once, and K/V tiles of 64 keys stream
//   through shared memory, so no T x T matrix reaches device memory;
// - dQ stays in f32 registers across the K/V loop and is written once,
//   rounded to the input type; nothing is summed across blocks (no
//   atomics), so every result is independent of scheduling, and dQ stays
//   its own kernel beside dK/dV;
// - tiles entirely above the causal diagonal or outside the window are
//   skipped (the reference's _block_live rule); keys and rows past T are
//   masked here, so the wrapper never pads;
// - a row with no visible key has lse = +1e30 from the forward, and a masked
//   entry gets P = 0 directly, so nothing computes exp(NEG_INF - NEG_INF);
// - GQA reads kv head b / group directly: no repeated K/V in memory;
// - query tiles are launched heaviest first (under a causal mask the last
//   tiles see the most keys).
//
// The bf16 design:
// - 4 warps, each owning 16 query rows; Q and dO of the tile are loaded once
//   and kept as bf16 A fragments in registers (ldmatrix), lse and delta of
//   the lane's two rows in registers;
// - K and V tiles stream through a 2-stage cp.async ring of bf16 rows
//   padded to DP + 8 (ldmatrix without bank conflicts), so the next tile's
//   copy overlaps this tile's products;
// - for each live K/V tile, by mma.sync m16n8k16 (bf16 in, f32 accumulate):
//   S = Q K^T and dP = dO V^T in accumulator registers (K and V read as B
//   fragments by ldmatrix); P = exp(S scale - lse), the masks and dS = P
//   (dP - delta) scale on those fragments; dQ += dS K with dS converted in
//   registers from C to A fragments as bf16 and K read as B fragments by
//   ldmatrix.trans. Nothing in the loop round-trips through shared memory.
//   A tile is taken in two passes of 32 keys, which keeps S and dP (16
//   registers each) small beside the two operand fragment sets and the f32
//   dQ (DP / 2 registers each);
// - dQ is rounded to bf16 once, staged through the warp's own rows of the Q
//   tile and written with 16-byte stores;
// - rows that do not start on a 16-byte boundary (d % 8 != 0, or a base
//   pointer that carries a storage offset) are loaded and stored element by
//   element inside the same kernel; columns d..DP-1 are zero.
// Rounding: dS is rounded to bf16 before dS K (the reference multiplies it
// in f32). Each term moves by at most 2^-9 of its size; summed over the
// row's keys this stays within one bf16 step at the gradient's scale: the
// bar is max|dq - dq_f32| <= 2^-7 max|dq_f32| (ops/flash_attention.py:
// BF16_DQ_BAR).
//
// The f32 design: Q, dO, K and V staged as f32 in shared memory, scalar
// fmaf products on 4 x (KB / 8) micro-tiles per thread, S and dP built one
// after the other in the same registers with P parked in shared memory
// between them, dQ in registers (4 rows x d/8 columns a thread). K/V tiles
// are KB = 64 keys up to DP 128 and 32 keys at DP 256, where 64 would need
// 280 KB of shared memory against the card's 227 KB.
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

// keys per K/V tile of the f32 kernel
template <int DP>
constexpr int f32_keys() { return DP > 128 ? 32 : 64; }

template <int DP, int KB>
constexpr size_t smem_bytes() {
  // Q, dO [BM][DP+1]; K, V [KB][DP+1]; P then dS [BM][KB+1]; lse, delta [BM]
  return sizeof(float) *
         (size_t)(2 * BM * (DP + 1) + 2 * KB * (DP + 1) + BM * (KB + 1) + 2 * BM);
}

// T: element type of q/k/v/dO/dQ. DP: head dim rounded up to
// 16/32/64/128/256; columns d..DP-1 are zero in shared memory so they add
// nothing. KB: keys per K/V tile.
template <typename T, int DP, int KB>
__global__ void __launch_bounds__(NT)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, int t, int d, int group, int causal,
                int window, float scale) {
  extern __shared__ float smem[];
  constexpr int QS = DP + 1;   // odd row strides: column walks hit distinct banks
  constexpr int PS = KB + 1;
  constexpr int JJ = KB / 8;   // keys per thread of a tile
  constexpr int CPT = DP / 8;  // dQ columns per thread
  float* qs = smem;
  float* dos = qs + BM * QS;
  float* ks = dos + BM * QS;
  float* vs = ks + KB * QS;
  float* ds = vs + KB * QS;
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
  const int n_tiles = (t + KB - 1) / KB;
  int kt_begin = 0, kt_end = n_tiles;
  if (causal) {
    const int q_last = min(q0 + BM, t) - 1;
    kt_end = min(n_tiles, q_last / KB + 1);
    if (window > 0) {
      const int first_key = q0 - window + 1;   // earliest key any row sees
      if (first_key > 0) kt_begin = first_key / KB;
    }
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * KB;
    __syncthreads();   // the previous tile's K, V and dS are no longer read
    for (int i = tid; i < KB * DP; i += NT) {
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
    float acc_s[4][JJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < JJ; ++jj) acc_s[i][jj] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; ++c) {
      float qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(rg * 4 + i) * QS + c];
#pragma unroll
      for (int jj = 0; jj < JJ; ++jj) {
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
      for (int jj = 0; jj < JJ; ++jj) {
        const bool keep = visible(q0 + r, k0 + cg + 8 * jj, t, causal, window);
        // the reference's order: the f32 product, times the unrounded scale
        ds[r * PS + cg + 8 * jj] = keep ? expf(acc_s[i][jj] * scale - l) : 0.f;
      }
    }

    // dP = dO V^T in the same registers; dS over this thread's own P
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < JJ; ++jj) acc_s[i][jj] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; ++c) {
      float gv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) gv[i] = dos[(rg * 4 + i) * QS + c];
#pragma unroll
      for (int jj = 0; jj < JJ; ++jj) {
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
      for (int jj = 0; jj < JJ; ++jj) {
        float* e = &ds[r * PS + cg + 8 * jj];
        *e = (*e * (acc_s[i][jj] - dl)) * scale;
      }
    }
    __syncthreads();

    // dQ += dS K on a 4 x CPT micro-tile per thread
#pragma unroll 4
    for (int j = 0; j < KB; ++j) {
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
  constexpr int KB = f32_keys<DP>();
  constexpr size_t bytes = smem_bytes<DP, KB>();
  auto kernel = flash_dq_kernel<T, DP, KB>;
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
  if (d <= 128) return launch<T, 128>(q, k, v, dout, lse, delta, dq, n, t, d, group, causal, window, scale, s);
  return launch<T, 256>(q, k, v, dout, lse, delta, dq, n, t, d, group, causal, window, scale, s);
}

// ---- bf16 on the tensor cores ----

template <int DP>
constexpr size_t mma_smem_bytes() {
  // Q, dO [BM][DP+8]; K, V [2 stages][BN][DP+8], all bf16
  return sizeof(__nv_bfloat16) * (size_t)(2 * BM + 4 * BN) * (DP + 8);
}

constexpr float LOG2E = 1.4426950408889634f;

// DP: head dim rounded up to 16/32/64/128/256. Each of the 4 warps owns 16
// query rows; lane (g, tq) holds rows g and g + 8 of them (see
// flash_mma.cuh). Up to d 64 the registers are capped so that 4 blocks fit
// an SM (128 registers, no spill), which flash_variants.py measured faster
// at the LM train shape than 3 or 2. At DP 256 the f32 dQ alone takes 128
// registers a lane, so the fragments of Q and dO are read from shared
// memory at each product instead of being held in registers.
template <int DP>
__global__ void __launch_bounds__(NT, DP <= 64 ? 4 : 2)
flash_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int t, int d, int group,
                    int causal, int window, float scale, int vec) {
  using namespace flash::tc;
  constexpr int LD = DP + 8;
  constexpr int KC = DP / 16;   // 16-wide chunks of the head dim
  constexpr int ON = DP / 8;    // 8-wide tiles of dQ
  constexpr bool QREG = DP <= 128;   // Q's and dO's A fragments in registers
  // keys a pass of the inner products takes: two passes of 32 a tile keep
  // S and dP small beside Q, dO and dQ in registers
  constexpr int KW = 32;
  constexpr int KN = KW / 8;    // 8-key n-tiles of a pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* gs = qs + BM * LD;          // dO
  bf16* ks = gs + BM * LD;          // [2][BN][LD]
  bf16* vs = ks + 2 * BN * LD;      // [2][BN][LD]

  const int b = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;   // heaviest tiles first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;

  const size_t td = (size_t)t * d;
  const bf16* kb = k + (size_t)(b / group) * td;
  const bf16* vb = v + (size_t)(b / group) * td;

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

  // Q, dO and the first K/V tile in one group
  load_tile<BM, DP, NT>(qs, q + (size_t)b * td, q0, t, d, vec, tid);
  load_tile<BM, DP, NT>(gs, dout + (size_t)b * td, q0, t, d, vec, tid);
  if (kt_begin < kt_end) {
    load_tile<BN, DP, NT>(ks, kb, kt_begin * BN, t, d, vec, tid);
    load_tile<BN, DP, NT>(vs, vb, kt_begin * BN, t, d, vec, tid);
  }
  cp_async_commit();

  // this lane's rows, their lse and delta (rows past T: P is masked to 0)
  const int row0 = q0 + warp * 16 + g;   // rows row0, row0 + 8
  float lse_r[2], del_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + r * 8;
    const bool in = qpos < t;
    lse_r[r] = in ? lse[(size_t)b * t + qpos] : 0.f;
    del_r[r] = in ? delta[(size_t)b * t + qpos] : 0.f;
  }

  cp_async_wait<0>();
  __syncthreads();
  // Q and dO of this warp's 16 rows into registers as A fragments; only
  // this warp reads those rows, and later stages dQ through its Q rows
  bf16* qw = qs + warp * 16 * LD;
  const bf16* gw = gs + warp * 16 * LD;
  uint32_t qf[QREG ? KC : 1][4], gf[QREG ? KC : 1][4];
  const int a_off = (lane & 15) * LD + (lane >> 4) * 8;
  if constexpr (QREG) {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      ldsm_x4(qf[kc], qw + a_off + kc * 16);
      ldsm_x4(gf[kc], gw + a_off + kc * 16);
    }
  }

  float acc[ON][4];
#pragma unroll
  for (int j = 0; j < ON; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // ldmatrix row offsets: B fragments of K and V (keys x dims) for S and
  // dP, and K transposed for dS K; lanes 8m .. 8m+7 address matrix m
  const int mi = lane >> 3, r8 = lane & 7;
  const int b_off = ((mi >> 1) * 8 + r8) * LD + (mi & 1) * 8;
  const int bt_off = ((mi & 1) * 8 + r8) * LD + (mi >> 1) * 8;

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
    // a tile wholly inside T and inside the mask for all 64 rows needs no
    // per-element test
    const bool full = k0 + BN <= t && q0 + BM <= t &&
                      (!causal || (k0 + BN - 1 <= q0 &&
                                   (window <= 0 || q0 + BM - 1 - k0 < window)));

#pragma unroll
    for (int pass = 0; pass < BN / KW; ++pass) {
      const int c0 = pass * KW;   // first key of the pass within the tile
      // S = Q K^T and dP = dO V^T: 16 rows x KW keys a warp
      float s[KN][4], dp[KN][4];
#pragma unroll
      for (int j = 0; j < KN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t qa[4], ga[4];
        if constexpr (QREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            qa[e] = qf[kc][e];
            ga[e] = gf[kc][e];
          }
        } else {
          ldsm_x4(qa, qw + a_off + kc * 16);
          ldsm_x4(ga, gw + a_off + kc * 16);
        }
#pragma unroll
        for (int j = 0; j < KN / 2; ++j) {
          uint32_t bk[4], bv[4];
          const int off = (c0 + j * 16) * LD + kc * 16 + b_off;
          ldsm_x4(bk, kst + off);
          ldsm_x4(bv, vst + off);
          mma(s[2 * j], qa, bk[0], bk[1]);
          mma(s[2 * j + 1], qa, bk[2], bk[3]);
          mma(dp[2 * j], ga, bv[0], bv[1]);
          mma(dp[2 * j + 1], ga, bv[2], bv[3]);
        }
      }
      // P and dS in registers; the reference's order: the f32 product
      // times the unrounded scale, exp by the SFU's exp2 (flash_variants.py
      // measured it faster than expf here)
#pragma unroll
      for (int j = 0; j < KN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const bool keep = full ||
              visible(row0 + r * 8, k0 + c0 + j * 8 + 2 * tq + (e & 1), t,
                      causal, window);
          const float p = keep ? exp2f((s[j][e] * scale - lse_r[r]) * LOG2E)
                               : 0.f;
          dp[j][e] = (p * (dp[j][e] - del_r[r])) * scale;
        }
      // dQ += dS K, 16 keys a chunk
#pragma unroll
      for (int kk = 0; kk < KW / 16; ++kk) {
        uint32_t sa[4];
        c_to_a(sa, dp, kk);
#pragma unroll
        for (int j = 0; j < DP / 16; ++j) {
          uint32_t bk[4];
          ldsm_x4_t(bk, kst + (c0 + kk * 16) * LD + j * 16 + bt_off);
          mma(acc[2 * j], sa, bk[0], bk[1]);
          mma(acc[2 * j + 1], sa, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();   // all warps are done with this stage
  }
  cp_async_wait<0>();

  // dQ rounded once, through this warp's rows of the Q tile
#pragma unroll
  for (int j = 0; j < ON; ++j) {
    const int c = j * 8 + 2 * tq;
    *reinterpret_cast<__nv_bfloat162*>(qw + g * LD + c) =
        __floats2bfloat162_rn(acc[j][0], acc[j][1]);
    *reinterpret_cast<__nv_bfloat162*>(qw + (g + 8) * LD + c) =
        __floats2bfloat162_rn(acc[j][2], acc[j][3]);
  }
  __syncwarp();
  store_rows<16, DP>(dq + (size_t)b * td, qw, q0 + warp * 16, t, d, vec, lane);
}

template <int DP>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, int n, int t, int d, int group, int causal,
                       int window, float scale, cudaStream_t stream) {
  using flash::tc::aligned16;
  constexpr size_t bytes = mma_smem_bytes<DP>();
  auto kernel = flash_dq_mma_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int vec = d % 8 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(dout) && aligned16(dq);
  const dim3 grid(n, (t + BM - 1) / BM);
  kernel<<<grid, NT, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), t, d, group, causal, window, scale, vec);
  return cudaGetLastError();
}

cudaError_t dispatch_mma(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dq, int n, int t, int d, int group, int causal,
                         int window, float scale, cudaStream_t s) {
  if (d <= 16) return launch_mma<16>(q, k, v, dout, lse, delta, dq, n, t, d, group, causal, window, scale, s);
  if (d <= 32) return launch_mma<32>(q, k, v, dout, lse, delta, dq, n, t, d, group, causal, window, scale, s);
  if (d <= 64) return launch_mma<64>(q, k, v, dout, lse, delta, dq, n, t, d, group, causal, window, scale, s);
  if (d <= 128) return launch_mma<128>(q, k, v, dout, lse, delta, dq, n, t, d, group, causal, window, scale, s);
  return launch_mma<256>(q, k, v, dout, lse, delta, dq, n, t, d, group, causal, window, scale, s);
}

}  // namespace

// q, dout, dq: [n, t, d]; k, v: [n / group, t, d], all in one input type;
// lse, delta: [n, t] f32. All contiguous. dtype: 0 = float32 (the CUDA-core
// kernel), 1 = bfloat16 (the tensor-core kernel); nothing falls back from
// one to the other. window <= 0 means no window; scale is 1/sqrt(d)
// unrounded. Head dims up to 256 (MAX_HEAD_DIM). Returns a cudaError_t
// (0 on success).
extern "C" int flash_attn_dq(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq, int n, int t, int d,
                             int group, int causal, int window, float scale,
                             int dtype, void* stream) {
  if (n < 1 || t < 1 || d < 1 || d > flash::MAX_HEAD_DIM || group < 1 || n % group ||
      (t + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(q, k, v, dout, lse, delta, dq, n, t, d, group, causal, window, scale, s);
  if (dtype == 1) return (int)dispatch_mma(q, k, v, dout, lse, delta, dq, n, t, d, group, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
