// LSTM cell backward for Hopper (sm_90a): recompute the gates of one time
// step from (zx, h_prev, c_prev, RW, P), then every gate adjoint and
//   dzx = dz = [d_i, d_f, d_g, d_o] (pre-activation), dc_prev (with the
//   peephole paths), dP (batch column sums), dh_prev = dz RW^T and
//   dRW = h_prev^T dz.
//
// Replaces: deeplearning4j_tpu/ops/pallas_kernels.py:_lstm_cell_bwd_kernel
// (launched by _lstm_cell_bwd_call through pl.pallas_call).
//
// What bounds it on this card. At the char-RNN's shape (B 32, H 200, f32) the
// call reads zx, h_prev, c_prev, RW, P, dh and dc once and writes dzx,
// dh_prev, dc_prev, dRW and dP: about 1.64 MB, 0.49 us at 3.35 TB/s, against
// 30.7 MFLOP (the recomputed z and the two products), 0.46 us at the f32
// peak: bound by bytes. At such a size what a launch costs, and the latency
// of each dependent step inside it, decide the time. The first design made
// three launches a call (gates, products, a finish), so each call paid two
// extra launches and two drains of the card between them.
//
// What the design does: one cooperative launch a call, in two phases split
// by one grid-wide barrier (cooperative_groups grid sync), with no atomics:
// every sum is taken in a fixed order, so f32 results do not depend on
// scheduling and two calls on the same inputs are bit-identical.
//  Phase 1, gates: work items of 4 hidden units j x 32 batch rows b. The
//   item's h_prev rows and RW's four column slices stream through a ring
//   of 128-deep chunks filled by 16-byte cp.async, three stages deep, so
//   up to H 384 the whole reduction costs one memory round trip. The gate
//   sums are split over the 8 warps by k, each lane holding 4 rows x 4
//   gates of one unit in registers (8 shared-memory reads for 16 FMAs; one
//   (b, j) a thread took 5 reads for 4 and was bound by them); the warps'
//   sums are added in warp order. Then one thread a (b, j) runs the gates
//   and adjoints, on operands it loaded before the products, and writes
//   dzx, the unrounded f32 dz (into scratch for bf16; for f32 the scratch
//   is dzx itself) and dc_prev. The block sums its rows' dP terms in row
//   order into a per-chunk partial.
//  Phase 2, after the barrier, products from the f32 dz (the reference
//   multiplies the unrounded dz):
//   - dh_prev [B, H] = dz RW^T on tiles of 16 rows x 8 hidden units: the
//     4H-long reduction streams through a 4-stage ring of 256-column
//     chunks (one round trip up to H 256), split over 16 column groups
//     (2 x 4 outputs a thread in registers), whose sums are added in group
//     order;
//   - dRW [H, 4H] = h_prev^T dz on 64 x 64 tiles, reduced over the batch
//     in batch order, 4 x 4 outputs a thread fed by two 16-byte shared
//     reads;
//   - dP = the chunk partials summed in chunk order.
//  Work items of both phases are walked by a grid-stride loop over a grid
//  no larger than the card holds at once (the cooperative launch's rule;
//  one block an SM), dh_prev first. At the char-RNN's shape (B 32, H 200)
//  phase 1 has 50 items and phase 2 has 102, so each phase is one round of
//  items. The launch is one node of a CUDA graph, so a captured tBPTT
//  window replays it.
// bf16 inputs are converted on load and accumulate in f32; each output is
// rounded once to its input's type (dP to RW's). Ragged edges are masked in
// the kernel. Tensor cores (TF32 would break the f32 parity bar) are later
// work.
// With `accumulate` set, dRW and dP are added to what the buffers hold: a
// tBPTT window's backward calls the kernel once a step into one pair of
// buffers. Each element has one owning thread, so the sum runs in step
// order and is bit-stable; the step's term is rounded to the storage type
// before the add, as adding two tensors of that type rounds it.
//
// Interface: a plain C function, bound from Python with ctypes. It launches
// on the caller's stream, allocates nothing (the caller passes the f32
// scratch, see lstm_cell_bwd_scratch_floats), and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "lstm_common.cuh"

namespace {

namespace cg = cooperative_groups;
using cpasync::cp_async16;
using cpasync::cp_async_commit;
using cpasync::cp_async_wait;
using lstm::NT;
using lstm::from_f32;
using lstm::to_f32;

// Stage rows r0 .. r0 + ROWS - 1, columns c0 .. c0 + COLS - 1 of a
// row-major matrix with row stride ld into a shared [ROWS][COLS + PAD] f32
// tile (PAD a multiple of 4); rows past n_rows and columns past n_cols are
// zero. With vec (f32, every row start and c0 on a 16-byte boundary, n_cols
// a multiple of 4)
// the copies are 16-byte cp.async that complete asynchronously (the caller
// commits and waits); otherwise element by element, synchronously.
template <int ROWS, int COLS, int PAD = 4, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, size_t ld, int r0,
                                      int n_rows, int c0, int n_cols, bool vec) {
  constexpr int LDS = COLS + PAD;
  if (vec) {
    constexpr int CH = COLS / 4;
    for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * 4;
      const bool in = r0 + r < n_rows && c0 + c < n_cols;
      cp_async16(dst + r * LDS + c,
                 in ? reinterpret_cast<const float*>(src) + (size_t)(r0 + r) * ld + c0 + c
                    : reinterpret_cast<const float*>(src),
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += NT) {
      const int r = i / COLS, c = i % COLS;
      dst[r * LDS + c] = (r0 + r < n_rows && c0 + c < n_cols)
                             ? to_f32(src[(size_t)(r0 + r) * ld + c0 + c]) : 0.f;
    }
  }
}

// A ring of NS shared-memory stages over n chunks: issue(chunk, stage)
// starts a chunk's copies, compute(chunk, stage) reads it. NS - 1 chunks
// are in flight ahead of the one being read, so a reduction of up to NS
// chunks costs one memory round trip.
template <int NS, typename Issue, typename Compute>
__device__ __forceinline__ void ring(int n, Issue issue, Compute compute) {
#pragma unroll
  for (int c = 0; c < NS - 1; ++c) {
    if (c < n) issue(c, c);
    cp_async_commit();
  }
  for (int c = 0; c < n; ++c) {
    if (c + NS - 1 < n) issue(c + NS - 1, (c + NS - 1) % NS);
    cp_async_commit();
    cp_async_wait<NS - 1>();   // chunk c's group has landed
    __syncthreads();
    compute(c, c % NS);
    __syncthreads();   // the stage is read before a later issue refills it
  }
}

// ---- phase 1: gates and adjoints ----

constexpr int JT = 4;           // hidden units of a gates item
constexpr int BC = 32;          // batch rows of a gates item
constexpr int KC = 128;         // reduction depth a stage holds
constexpr int KS = 3;           // stages: H up to 384 in one round trip
constexpr int KG = NT / 32;     // k groups, one warp each
constexpr int KW = KC / KG;     // k a group takes of each stage

struct GateStage {
  float h[BC][KC + 4];          // h_prev rows, KC columns of k
  float rw[4][KC][JT];          // RW[k, g H + j0 ..], one slice per gate
};

struct GateSmem {
  GateStage st[KS];
  float part[KG][32][17];       // each group's 16 sums a lane
  float red[3][BC][JT];
};

// One item: hidden units j0 .. j0 + JT - 1 of batch rows b0 .. b0 + BC - 1.
// The gate sums z - zx = h_prev[b, :] RW[:, g H + j] are split over the k
// groups (warps): lane (bg, jj) of a group sums rows bg + 8 i (i < 4) of
// unit j0 + jj, all four gates, over the group's k of each chunk, in k
// order; the groups' sums are then added in group order. The h_prev rows
// and RW's four column slices stream through the ring in KC-deep chunks.
// Then one thread a (b, j) runs the adjoints, on operands it loaded before
// the products.
template <typename T>
__device__ void gates_item(const T* __restrict__ zx, const T* __restrict__ h_prev,
                           const T* __restrict__ c_prev, const T* __restrict__ rw,
                           const T* __restrict__ peep, const T* __restrict__ dh,
                           const T* __restrict__ dc, T* dzx, float* dz32,
                           T* __restrict__ dc_prev, float* dp_part, int B, int H,
                           int j0, int bc, bool vec, GateSmem& s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bg = lane / JT, jj = lane % JT;
  const int b0 = bc * BC;
  const bool has_p = peep != nullptr;
  const size_t H4 = (size_t)4 * H;

  // thread (r, u) < BC x JT owns row b0 + r, unit j0 + u in the adjoints;
  // its operands are loaded now, their latency hidden by the products
  const int r = threadIdx.x / JT, u = threadIdx.x % JT;
  const int b = b0 + r, j = j0 + u;
  const bool mine = threadIdx.x < BC * JT && b < B && j < H;
  const size_t row = (size_t)b * H4, hj = (size_t)b * H + j;
  float zxv[4] = {0.f, 0.f, 0.f, 0.f}, pv[3] = {0.f, 0.f, 0.f};
  float cp = 0.f, dhv = 0.f, dcv = 0.f;
  if (mine) {
#pragma unroll
    for (int q = 0; q < 4; ++q) zxv[q] = to_f32(zx[row + (size_t)q * H + j]);
    if (has_p) {
#pragma unroll
      for (int q = 0; q < 3; ++q) pv[q] = to_f32(peep[(size_t)q * H + j]);
    }
    cp = to_f32(c_prev[hj]);
    dhv = to_f32(dh[hj]);
    dcv = to_f32(dc[hj]);
  }

  float acc[4][4] = {};   // [row i][gate q]
  ring<KS>(
      (H + KC - 1) / KC,
      [&](int kc, int st) {
        GateStage& g = s.st[st];
        stage<BC, KC>(&g.h[0][0], h_prev, (size_t)H, b0, B, kc * KC, H, vec);
#pragma unroll
        for (int q = 0; q < 4; ++q)   // rows k of RW, columns q H + j0 ..
          stage<KC, JT, 0>(&g.rw[q][0][0], rw + (size_t)q * H + j0, H4, kc * KC,
                           H, 0, H - j0, vec);
      },
      [&](int kc, int st) {
        const GateStage& g = s.st[st];
        const int k_end = min(warp * KW + KW, H - kc * KC);
        for (int k = warp * KW; k < k_end; ++k) {
          float hv[4], rv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) hv[i] = g.h[bg + 8 * i][k];
#pragma unroll
          for (int q = 0; q < 4; ++q) rv[q] = g.rw[q][k][jj];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(hv[i], rv[q], acc[i][q]);
        }
      });
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) s.part[warp][lane][4 * i + q] = acc[i][q];
  __syncthreads();

  float sp0 = 0.f, sp1 = 0.f, sp2 = 0.f;   // this row's dP terms
  if (mine) {
    const int ln = (r % 8) * JT + u, at = 4 * (r / 8);
    float z[4] = {0.f, 0.f, 0.f, 0.f};
    for (int w = 0; w < KG; ++w)
#pragma unroll
      for (int q = 0; q < 4; ++q) z[q] += s.part[w][ln][at + q];
    const float p0 = pv[0], p1 = pv[1], p2 = pv[2];
    float zi = z[0] + zxv[0];
    float zf = z[1] + zxv[1];
    const float zg = z[2] + zxv[2];
    float zo = z[3] + zxv[3];
    if (has_p) {
      zi = zi + cp * p0;
      zf = zf + cp * p1;
    }
    const float i = lstm::sigm(zi), f = lstm::sigm(zf), g = tanhf(zg);
    const float c = f * cp + i * g;
    if (has_p) zo = zo + c * p2;
    const float o = lstm::sigm(zo);
    const float tc = tanhf(c);

    const float d_o = dhv * tc * o * (1.f - o);
    float dc_tot = dcv + dhv * o * (1.f - tc * tc);
    if (has_p) dc_tot = dc_tot + d_o * p2;
    const float d_i = dc_tot * g * i * (1.f - i);
    const float d_f = dc_tot * cp * f * (1.f - f);
    const float d_g = dc_tot * i * (1.f - g * g);
    float dcp = dc_tot * f;
    if (has_p) dcp = dcp + d_i * p0 + d_f * p1;

    dz32[row + j] = d_i;
    dz32[row + H + j] = d_f;
    dz32[row + 2 * (size_t)H + j] = d_g;
    dz32[row + 3 * (size_t)H + j] = d_o;
    if (static_cast<void*>(dzx) != static_cast<void*>(dz32)) {
      dzx[row + j] = from_f32<T>(d_i);
      dzx[row + H + j] = from_f32<T>(d_f);
      dzx[row + 2 * (size_t)H + j] = from_f32<T>(d_g);
      dzx[row + 3 * (size_t)H + j] = from_f32<T>(d_o);
    }
    dc_prev[hj] = from_f32<T>(dcp);
    sp0 = d_i * cp;
    sp1 = d_f * cp;
    sp2 = d_o * c;
  }
  if (!has_p) return;   // uniform across the block
  if (threadIdx.x < BC * JT) {
    s.red[0][r][u] = sp0;
    s.red[1][r][u] = sp1;
    s.red[2][r][u] = sp2;
  }
  __syncthreads();
  if (threadIdx.x < 3 * JT && j0 + threadIdx.x % JT < H) {
    const int q = threadIdx.x / JT, v = threadIdx.x % JT;
    float sum = 0.f;
    for (int rr = 0; rr < BC; ++rr) sum += s.red[q][rr][v];   // in row order
    dp_part[((size_t)bc * 3 + q) * H + j0 + v] = sum;
  }
  __syncthreads();   // red is read before the next item writes it
}

// ---- phase 2: products ----

constexpr int DB = 16;     // dh_prev tile: batch rows
constexpr int DK = 8;      // dh_prev tile: hidden units
constexpr int CK = 256;    // columns of the 4H reduction a stage holds
constexpr int CS = 4;      // stages: H up to 256 in one round trip
constexpr int CG = 16;     // column groups: group g takes columns c = g mod CG

struct DhStage {
  float dz[DB][CK + 4];    // row stride CK + 4: the tile's rows start in
  float rw[DK][CK + 4];    // distinct banks, on 16-byte boundaries
};

struct DhSmem {
  DhStage st[CS];
  float part[CG][DB * DK + 1];
};

// dh_prev[b0.., k0..] = dz[b, :] . RW[k, :] over all 4H columns, which
// stream through the ring in CK-wide chunks. Column group g (16 threads)
// takes columns g, g + CG, ... of each chunk, in order; its thread (bp,
// kq) sums rows bp, bp + 8 against hidden units kq + 2 m (m < 4). The
// groups' sums are added in group order.
template <typename T>
__device__ void dh_item(const float* dz32, const T* __restrict__ rw,
                        T* __restrict__ dh_prev, int B, int H, int b0, int k0,
                        bool vec_rw, DhSmem& s) {
  const int tid = threadIdx.x;
  const int cg = tid / 16, bp = tid % 8, kq = (tid / 8) % 2;
  const int H4 = 4 * H;
  float acc[2][4] = {};   // [row bp + 8 i][unit kq + 2 m]
  __syncthreads();   // the previous item's shared memory is no longer read
  ring<CS>(
      (H4 + CK - 1) / CK,
      [&](int cc, int st) {
        stage<DB, CK>(&s.st[st].dz[0][0], dz32, (size_t)H4, b0, B, cc * CK, H4, true);
        stage<DK, CK>(&s.st[st].rw[0][0], rw, (size_t)H4, k0, H, cc * CK, H4, vec_rw);
      },
      [&](int cc, int st) {
        const DhStage& g = s.st[st];
        const int cn = min(CK, H4 - cc * CK);
#pragma unroll 4
        for (int c = cg; c < cn; c += CG) {
          const float d0 = g.dz[bp][c], d1 = g.dz[bp + 8][c];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const float rv = g.rw[kq + 2 * m][c];
            acc[0][m] = fmaf(d0, rv, acc[0][m]);
            acc[1][m] = fmaf(d1, rv, acc[1][m]);
          }
        }
      });
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int m = 0; m < 4; ++m) s.part[cg][(bp + 8 * i) * DK + kq + 2 * m] = acc[i][m];
  __syncthreads();
  const int bi = tid / DK, ki = tid % DK;
  if (tid < DB * DK && b0 + bi < B && k0 + ki < H) {
    float sum = 0.f;
    for (int q = 0; q < CG; ++q) sum += s.part[q][tid];   // in group order
    dh_prev[(size_t)(b0 + bi) * H + k0 + ki] = from_f32<T>(sum);
  }
}

constexpr int WT = 64;     // dRW tile: rows k and columns c
constexpr int WB = 32;     // batch rows a stage holds
constexpr int WS = 2;      // stages: B up to 64 in one round trip

struct DrwStage {
  float h[WB][WT + 4];     // h_prev[b, k0 ..]
  float dz[WB][WT + 4];    // dz[b, c0 ..]
};

struct DrwSmem {
  DrwStage st[WS];
};

// dRW[k0 .., c0 ..] = h_prev[:, k]^T dz[:, c] over the batch, in batch
// order; thread (tk, tc) holds the 4 x 4 outputs k0 + 4 tk .., c0 + 4 tc ..
// in registers, reading two 16-byte vectors of shared memory for 16 FMAs.
template <typename T>
__device__ void drw_item(const T* __restrict__ h_prev, const float* dz32,
                         T* __restrict__ drw, int B, int H, int k0, int c0,
                         bool vec, bool accum, DrwSmem& s) {
  const int tk = threadIdx.x / 16, tc = threadIdx.x % 16;
  const size_t H4 = (size_t)4 * H;
  float acc[4][4] = {};   // [k][c]
  __syncthreads();   // the previous item's shared memory is no longer read
  ring<WS>(
      (B + WB - 1) / WB,
      [&](int bc, int st) {
        stage<WB, WT>(&s.st[st].h[0][0], h_prev, (size_t)H, bc * WB, B, k0, H, vec);
        stage<WB, WT>(&s.st[st].dz[0][0], dz32, H4, bc * WB, B, c0, (int)H4, true);
      },
      [&](int bc, int st) {
        const DrwStage& g = s.st[st];
        const int bn = min(WB, B - bc * WB);
        for (int rb = 0; rb < bn; ++rb) {
          const float4 hv = *reinterpret_cast<const float4*>(&g.h[rb][4 * tk]);
          const float4 dv = *reinterpret_cast<const float4*>(&g.dz[rb][4 * tc]);
          const float hk[4] = {hv.x, hv.y, hv.z, hv.w};
          const float dc[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[a][e] = fmaf(hk[a], dc[e], acc[a][e]);
        }
      });
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int k = k0 + 4 * tk + a;
    if (k >= H) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + 4 * tc + e;
      if (c < (int)H4) {
        T* d = drw + (size_t)k * H4 + c;
        *d = accum ? from_f32<T>(to_f32(from_f32<T>(acc[a][e])) + to_f32(*d))
                   : from_f32<T>(acc[a][e]);
      }
    }
  }
}

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

union BwdSmem {
  GateSmem gates;
  DhSmem dh;
  DrwSmem drw;
};

constexpr size_t SMEM_BYTES = sizeof(BwdSmem);

// One block an SM (registers uncapped): lstm_variants.py measured it
// faster at the char-RNN's step than two, with their grid of twice the
// blocks to wait for at the barrier.
template <typename T>
__global__ void __launch_bounds__(NT, 1)
lstm_bwd_kernel(const T* __restrict__ zx, const T* __restrict__ h_prev,
                const T* __restrict__ c_prev, const T* __restrict__ rw,
                const T* __restrict__ peep, const T* __restrict__ dh,
                const T* __restrict__ dc, T* dzx, float* dz32,
                T* __restrict__ dc_prev, float* dp_part, T* __restrict__ dh_prev,
                T* __restrict__ drw, T* __restrict__ dp, int B, int H, int vec,
                int accumulate) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem& s = *reinterpret_cast<BwdSmem*>(smem_raw);
  const int n_chunks = cdiv(B, BC);
  const int tj = cdiv(H, JT);
  for (int it = blockIdx.x; it < tj * n_chunks; it += gridDim.x)
    gates_item(zx, h_prev, c_prev, rw, peep, dh, dc, dzx, dz32, dc_prev, dp_part,
               B, H, (it % tj) * JT, it / tj, vec != 0, s.gates);

  cg::this_grid().sync();   // every dz and dP partial is written

  if (dp != nullptr) {
    for (int i = blockIdx.x * NT + threadIdx.x; i < 3 * H; i += gridDim.x * NT) {
      float sum = 0.f;
      for (int c = 0; c < n_chunks; ++c) sum += __ldcg(dp_part + (size_t)c * 3 * H + i);
      dp[i] = accumulate ? from_f32<T>(to_f32(from_f32<T>(sum)) + to_f32(dp[i]))
                         : from_f32<T>(sum);
    }
  }
  const int tk_dh = cdiv(H, DK);
  const int n_dh = cdiv(B, DB) * tk_dh;
  const int tc_rw = cdiv(4 * H, WT);
  const int n_items = n_dh + cdiv(H, WT) * tc_rw;
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    if (it < n_dh) {
      dh_item(dz32, rw, dh_prev, B, H, (it / tk_dh) * DB, (it % tk_dh) * DK,
              vec != 0, s.dh);
    } else {
      const int t = it - n_dh;
      drw_item(h_prev, dz32, drw, B, H, (t / tc_rw) * WT, (t % tc_rw) * WT,
               vec != 0, accumulate != 0, s.drw);
    }
  }
}

// Blocks of lstm_bwd_kernel<T> the current device holds at once: the most
// a cooperative launch may start. Asked per device (lstm::coresident_blocks:
// each device gets its own raised shared-memory limit and its own cap).
template <typename T>
cudaError_t resident_blocks(int* blocks) {
  static lstm::CoresidentCache cache;
  return lstm::coresident_blocks(cache, reinterpret_cast<const void*>(lstm_bwd_kernel<T>), NT,
                                 SMEM_BYTES, blocks);
}

template <typename T>
cudaError_t launch(const void* zx, const void* h, const void* c, const void* rw,
                   const void* p, const void* dh, const void* dc, void* dzx,
                   void* dz32, void* scratch, void* dhp, void* dcp, void* drw,
                   void* dp, int B, int H, int accumulate, cudaStream_t stream) {
  int most = 0;
  cudaError_t err = resident_blocks<T>(&most);
  if (err != cudaSuccess) return err;
  const int n_gates = cdiv(H, JT) * cdiv(B, BC);
  const int n_products = cdiv(B, DB) * cdiv(H, DK) + cdiv(H, WT) * cdiv(4 * H, WT);
  int grid = n_gates > n_products ? n_gates : n_products;
  if (grid > most) grid = most;
  // f32 rows of h_prev and RW move 16 bytes at a time when H is a multiple
  // of 4 and both bases are 16-byte aligned (every row and chunk start is
  // then); bf16 and other shapes are converted element by element
  int vec = sizeof(T) == 4 && H % 4 == 0 &&
            (reinterpret_cast<uintptr_t>(h) & 15) == 0 &&
            (reinterpret_cast<uintptr_t>(rw) & 15) == 0;
  const T* zx_ = static_cast<const T*>(zx);
  const T* h_ = static_cast<const T*>(h);
  const T* c_ = static_cast<const T*>(c);
  const T* rw_ = static_cast<const T*>(rw);
  const T* p_ = static_cast<const T*>(p);
  const T* dh_ = static_cast<const T*>(dh);
  const T* dc_ = static_cast<const T*>(dc);
  T* dzx_ = static_cast<T*>(dzx);
  float* dz32_ = static_cast<float*>(dz32);
  T* dcp_ = static_cast<T*>(dcp);
  float* part_ = static_cast<float*>(scratch);
  T* dhp_ = static_cast<T*>(dhp);
  T* drw_ = static_cast<T*>(drw);
  T* dp_ = static_cast<T*>(dp);
  void* args[] = {&zx_, &h_, &c_, &rw_, &p_, &dh_, &dc_, &dzx_, &dz32_, &dcp_,
                  &part_, &dhp_, &drw_, &dp_, &B, &H, &vec, &accumulate};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(lstm_bwd_kernel<T>),
                                    dim3(grid), dim3(NT), args, SMEM_BYTES, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// The f32 scratch lstm_cell_bwd needs beside dz32, in floats: the
// [ceil(B / 32), 3, H] dP partials.
extern "C" long long lstm_cell_bwd_scratch_floats(int B, int H) {
  return 3LL * ((B + BC - 1) / BC) * H;
}

// zx, dzx: [B, 4H]; dz32: [B, 4H] f32 scratch (may be dzx itself when dtype
// is float32), 16-byte aligned; scratch: lstm_cell_bwd_scratch_floats(B, H)
// f32; h_prev, c_prev, dh, dc, dh_prev, dc_prev: [B, H]; rw, drw: [H, 4H];
// p, dp: [3, H], or both null for no peepholes. All contiguous; every tensor
// but the scratch of one type. accumulate: 0 writes dRW and dP, 1 adds to
// them. dtype: 0 = float32, 1 = bfloat16. One cooperative launch. Returns a
// cudaError_t (0 on success).
extern "C" int lstm_cell_bwd(const void* zx, const void* h_prev, const void* c_prev,
                             const void* rw, const void* p, const void* dh,
                             const void* dc, void* dzx, void* dz32, void* scratch,
                             void* dh_prev, void* dc_prev, void* drw, void* dp, int B,
                             int H, int accumulate, int dtype, void* stream) {
  if (B < 1 || H < 1 || (p == nullptr) != (dp == nullptr) ||
      (reinterpret_cast<uintptr_t>(dz32) & 15) != 0 ||
      (long long)B * 4 * H > 2147483647LL || (long long)H * 4 * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(zx, h_prev, c_prev, rw, p, dh, dc, dzx, dz32, scratch,
                              dh_prev, dc_prev, drw, dp, B, H, accumulate, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(zx, h_prev, c_prev, rw, p, dh, dc, dzx, dz32,
                                      scratch, dh_prev, dc_prev, drw, dp, B, H, accumulate,
                                      s);
  return (int)cudaErrorInvalidValue;
}
