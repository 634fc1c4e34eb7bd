// LSTM forward over a tBPTT window for Hopper (sm_90a): every step of one
// layer's (Graves) LSTM over a window of T steps in one persistent launch.
// Step by step, z = zx[t] + h_prev @ RW with gates packed [i, f, g, o],
// optional peepholes (i += c_prev P0, f += c_prev P1, o += c P2 on the new
// c), c = sig(f) c_prev + sig(i) tanh(g), h = sig(o) tanh(c); with a keep
// mask a dropped row holds (h, c) and emits 0; with `reverse` the window is
// walked from t = T - 1 down to 0.
//
// Replaces: deeplearning4j_tpu/ops/pallas_kernels.py:_lstm_cell_fwd_kernel
// (:508, launched once a step by _lstm_cell_call :599 through
// pl.pallas_call, inside the reference's lax.scan over the window).
//
// What bounds it on this card. At the char-RNN's window (B 32, H 200, T 50,
// f32) the launch reads zx, h0, c0, RW and P once and writes the outputs
// and every step's (h, c): about 9.7 MB, 2.9 us at 3.35 TB/s, against
// T x 2 B H 4H = 512 MFLOP, 7.6 us at the f32 peak: operations bound it.
// What costs is the chain through h: step t + 1 needs every hidden unit of
// step t, so each step pays one exchange across the card, and a design
// that launches a kernel a step pays a launch and the host's turn besides.
//
// What the design does: one cooperative launch for the window, T steps in a
// loop inside it, one exchange a step.
//  - An item is 8 batch rows x 8 hidden units, with all four gate columns
//    of those units. A block owns its items for the whole window: the
//    grid walks hidden-unit tiles first, and blocks that share a unit tile
//    take its batch tiles in turn. At the char-RNN's shape that is 100
//    blocks of one item each.
//  - A block keeps its RW column slice ([H, 32]) in shared memory for all
//    T steps when it owns one unit tile and H <= 1024; otherwise the slice
//    is staged from L2 every step, 1024 rows of k at a time.
//  - Each step a block stages its batch tile's h_prev rows from L2
//    (16-byte cp.async.cg for f32), splits the H-long products over its 8
//    warps (a lane a gate column, 8 rows in registers, 4 k a pass from
//    16-byte broadcast reads), and adds the warps' sums in warp order; one
//    thread a (b, j) then runs the cell. Sums run in a fixed order (k in
//    order within a warp's range, then the warps in order), so results are
//    bit-stable from call to call.
//  - The cell state c of a block's own (b, j) stays in a register across
//    steps (one item a block), and P in registers; c never crosses blocks.
//    Only h does: step k writes h_k+1 into its own slot of h_all (slots
//    are never rewritten, so there is no write-after-read hazard), then
//    each block adds one to the arrival counter of its batch tile. Before
//    step k + 1 reads a batch tile's h rows, a block waits until that
//    counter shows every unit tile of the step: only the 25 blocks that
//    share a batch tile's rows wait for each other, not the grid. The
//    counters are zeroed inside the launch, behind one grid sync, so a
//    CUDA-graph replay is right.
//  - The next step's zx slice is fetched by cp.async into a second buffer
//    before the wait, so its latency hides behind it.
//  - T = 1 (generation, a character at a time) has no wait and no grid
//    sync, and is a plain launch.
//  Variants (lstm_variants.py at the char-RNN's window on an H100 80GB
//  HBM3 at 700 W): a grid-wide barrier a step (cooperative_groups grid
//  sync) in place of the counters, 0.1548 against 0.1492 ms; RW staged
//  from L2 every step (kRwResident false), 0.187 ms; no exchange at all
//  (wrong results), 0.103 ms: the exchange costs about 1 us a step.
// bf16 inputs are converted on load and everything accumulates in f32; h and
// c are rounded once a step to the storage type, and the next step reads
// the rounded values, as a launch a step would. Ragged B and H are masked.
//
// Interface: a plain C function, bound from Python with ctypes. It launches
// on the caller's stream, allocates nothing (the caller passes the outputs
// and lstm_cell_fwd_scratch_ints int32 of scratch for the counters), and
// returns the launch's error.

#include <cooperative_groups.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "lstm_common.cuh"

namespace {

namespace cg = cooperative_groups;
using cpasync::cp_async16;
using cpasync::cp_async4;
using cpasync::cp_async_commit;
using cpasync::cp_async_wait;
using lstm::from_f32;
using lstm::NT;
using lstm::to_f32;

constexpr int BT = 8;          // batch rows of an item
constexpr int JT = 8;          // hidden units of an item
constexpr int NC = 4 * JT;     // gate columns of an item: one a lane
constexpr int KG = NT / 32;    // k groups: one warp each
constexpr int KC = 1024;       // rows of k staged at once
constexpr int PS = 40;         // row stride of the warps' partial sums: the
                               // cell threads' reads hit 32 distinct banks
static_assert(NC == 32 && BT * NC == NT && BT * JT <= NT, "item shape");

// design switches, flipped by lstm_variants.py
constexpr bool kTileCounters = true;    // per-batch-tile arrival counters
constexpr bool kRwResident = true;      // RW slice kept in shared memory

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int round4(int a) { return (a + 3) & ~3; }

// A load through L2 only (never a stale L1 line), converted to f32: for
// data other blocks of the same launch write.
__device__ __forceinline__ float ld_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_cg(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

// Dynamic shared memory, in floats, for a staged depth kcp (a multiple of
// 4): RW slice [kcp][NC], h rows [BT][kcp + 4], the warps' partial sums
// [KG][BT][PS], two zx slices [2][BT][NC].
struct Layout {
  int kcp;
  __host__ __device__ int h() const { return kcp * NC; }
  __host__ __device__ int part() const { return h() + BT * (kcp + 4); }
  __host__ __device__ int zx() const { return part() + KG * BT * PS; }
  __host__ __device__ size_t bytes() const {
    return (size_t)(zx() + 2 * BT * NC) * sizeof(float);
  }
};

constexpr size_t SMEM_MAX = (size_t)(KC * NC + BT * (KC + 4) + KG * BT * PS + 2 * BT * NC) *
                            sizeof(float);

// Rows b0 .. b0 + BT - 1, columns k0 .. k0 + kcp - 1 of a [B, H] state into
// h_s [BT][kcp + 4]; zero past B and past kc. With vec (f32, H a multiple of
// 4, a 16-byte aligned base) by 16-byte cp.async through L2, which the
// caller commits and waits for; otherwise loads through L2, eight a thread
// in flight.
template <typename T>
__device__ __forceinline__ void stage_h(float* h_s, const T* src, int B, int H, int b0,
                                        int k0, int kc, int kcp, bool vec) {
  const int hs = kcp + 4;
  if (vec) {
    const int ch = kcp / 4;
    for (int i = threadIdx.x; i < BT * ch; i += NT) {
      const int r = i / ch, c = (i % ch) * 4;
      const bool in = b0 + r < B;
      const float* s = reinterpret_cast<const float*>(src) + (size_t)(b0 + r) * H + k0 + c;
      cp_async16(h_s + r * hs + c, in ? s : reinterpret_cast<const float*>(src), in ? 16 : 0);
    }
    return;
  }
  constexpr int U = 8;
  const int n = BT * kcp;
  for (int i0 = 0; i0 < n; i0 += U * NT) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * NT + threadIdx.x, r = i / kcp, c = i % kcp;
      v[u] = (i < n && b0 + r < B && c < kc) ? ld_cg(src + (size_t)(b0 + r) * H + k0 + c) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * NT + threadIdx.x;
      if (i < n) h_s[(i / kcp) * hs + i % kcp] = v[u];
    }
  }
}

// Rows k0 .. k0 + kcp - 1 of RW's four gate column slices q H + j0 .. q H +
// j0 + JT - 1 into rw_s [kcp][NC] (column q JT + u); zero past kc and past
// H. vec as for stage_h.
template <typename T>
__device__ __forceinline__ void stage_rw(float* rw_s, const T* rw, int H, int j0, int k0, int kc,
                                         int kcp, bool vec) {
  const size_t H4 = (size_t)4 * H;
  if (vec) {
    for (int i = threadIdx.x; i < kcp * (NC / 4); i += NT) {
      const int kk = i / (NC / 4), piece = i % (NC / 4), q = piece / 2, u = (piece % 2) * 4;
      const bool in = kk < kc && j0 + u < H;
      const float* s = reinterpret_cast<const float*>(rw) + (size_t)(k0 + kk) * H4 +
                       (size_t)q * H + j0 + u;
      cp_async16(rw_s + kk * NC + q * JT + u, in ? s : reinterpret_cast<const float*>(rw),
                 in ? 16 : 0);
    }
    return;
  }
  constexpr int U = 8;
  const int n = kcp * NC;
  for (int i0 = 0; i0 < n; i0 += U * NT) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * NT + threadIdx.x, kk = i / NC, q = (i % NC) / JT,
                j = j0 + i % JT;
      v[u] = (i < n && kk < kc && j < H) ? to_f32(rw[(size_t)(k0 + kk) * H4 + (size_t)q * H + j])
                                         : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * NT + threadIdx.x;
      if (i < n) rw_s[i] = v[u];
    }
  }
}

// Step t's zx slice of an item into zx_s [BT][NC], a thread an element:
// f32 by 4-byte cp.async (committed by the caller), bf16 by a load.
template <typename T>
__device__ __forceinline__ void fetch_zx(float* zx_s, const T* zx, int t, int B, int H, int b0,
                                         int j0) {
  const int r = threadIdx.x / NC, c = threadIdx.x % NC, q = c / JT, u = c % JT;
  const bool in = b0 + r < B && j0 + u < H;
  const T* s = zx + ((size_t)t * B + b0 + r) * 4 * (size_t)H + (size_t)q * H + j0 + u;
  if constexpr (sizeof(T) == 4) {
    cp_async4(zx_s + threadIdx.x, in ? static_cast<const void*>(s) : static_cast<const void*>(zx),
              in ? 4 : 0);
  } else {
    zx_s[threadIdx.x] = in ? to_f32(*s) : 0.f;
  }
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Wait until a batch tile's counter reaches target: every unit tile of it
// has published its rows of the previous step.
__device__ __forceinline__ void wait_count(const int* counter, int target) {
  if (threadIdx.x == 0) {
    while (ld_acquire(counter) < target) {
    }
  }
  __syncthreads();
}

// zx_t [T, B, 4H]; h0, c0 [B, H]; rw [H, 4H]; peep [3, H] or null; keep
// [T, B] (bytes, nonzero = keep) or null; h_all, c_all [T + 1, B, H]: slot
// k + 1 holds the state after the k-th step walked, slot 0 h0 and c0;
// out [T, B, H]. Grid: gj unit-tile columns x bpj batch-tile rows of blocks.
template <typename T>
__global__ void __launch_bounds__(NT, 1)
lstm_seq_kernel(const T* __restrict__ zx, const T* __restrict__ h0, const T* __restrict__ c0,
                const T* __restrict__ rw, const T* __restrict__ peep,
                const uint8_t* __restrict__ keep, T* h_all, T* c_all, T* __restrict__ out,
                int* counters, int n_steps, int B, int H, int reverse, int gj, int bpj,
                int vec) {
  extern __shared__ __align__(16) float smem[];
  const int n_jt = cdiv(H, JT), n_bt = cdiv(B, BT);
  const int kcp = round4(min(H, KC)), n_ch = cdiv(H, KC);
  const Layout L{kcp};
  float* rw_s = smem;
  float* h_s = smem + L.h();
  float* part = smem + L.part();
  float* zx_s = smem + L.zx();
  const int jt0 = blockIdx.x % gj, bt0 = blockIdx.x / gj;
  const bool resident = kRwResident && gj == n_jt && n_ch == 1;   // one unit tile a block
  const bool single = gj == n_jt && bpj == n_bt;                   // one item a block
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int eb = threadIdx.x / JT, eu = threadIdx.x % JT;          // the cell's (b, j)
  const bool cell = threadIdx.x < BT * JT;
  const size_t BH = (size_t)B * H;
  const bool has_p = peep != nullptr;

  if (kTileCounters && n_steps > 1) {
    if (blockIdx.x == 0)
      for (int i = threadIdx.x; i < n_bt; i += NT) counters[i] = 0;
    cg::this_grid().sync();
  }
  if (resident) {   // committed now, waited for with the first step's h rows
    stage_rw(rw_s, rw, H, jt0 * JT, 0, H, kcp, vec != 0);
    cp_async_commit();
  }
  float h_own = 0.f, c_own = 0.f;   // one item a block: its (b, j) state

  for (int k = 0; k < n_steps; ++k) {
    const int t = reverse ? n_steps - 1 - k : k;
    const T* hsrc = k == 0 ? h0 : h_all + (size_t)k * BH;
    const T* csrc = k == 0 ? c0 : c_all + (size_t)k * BH;
    T* hdst = h_all + (size_t)(k + 1) * BH;
    T* cdst = c_all + (size_t)(k + 1) * BH;
    bool first = true;
    for (int jt = jt0; jt < n_jt; jt += gj) {
      for (int bt = bt0; bt < n_bt; bt += bpj) {
        const int j0 = jt * JT, b0 = bt * BT;
        float* zxs = zx_s + (single ? (k & 1) * BT * NC : 0);
        if (!single || k == 0) fetch_zx(zxs, zx, t, B, H, b0, j0);
        if (first && k > 0 && !kTileCounters) cg::this_grid().sync();   // h_k published
        if (kTileCounters && k > 0) wait_count(counters + bt, k * n_jt);
        first = false;

        // the cell thread's operands, loaded now: their latency hides
        // behind the products
        const int b = b0 + eb, j = j0 + eu;
        const bool mine = cell && b < B && j < H;
        const size_t hj = (size_t)b * H + j;
        float hp = h_own, cp = c_own, p0 = 0.f, p1 = 0.f, p2 = 0.f;
        bool kept = true;
        if (mine) {
          if (!single || k == 0) {
            hp = ld_cg(hsrc + hj);
            cp = ld_cg(csrc + hj);
          }
          if (has_p) {
            p0 = to_f32(peep[j]);
            p1 = to_f32(peep[H + j]);
            p2 = to_f32(peep[2 * H + j]);
          }
          if (keep != nullptr) kept = keep[(size_t)t * B + b] != 0;
        }

        // products: warp w sums its k range of each staged chunk for the
        // lane's gate column and the item's 8 rows
        float acc[BT];
#pragma unroll
        for (int i = 0; i < BT; ++i) acc[i] = 0.f;
        for (int ch = 0; ch < n_ch; ++ch) {
          const int k0 = ch * KC, kc = min(KC, H - k0), kr = round4(kc);
          if (ch > 0) __syncthreads();   // the previous chunk is read
          stage_h(h_s, hsrc, B, H, b0, k0, kc, kr, vec != 0);
          if (!resident) stage_rw(rw_s, rw, H, j0, k0, kc, kr, vec != 0);
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
          const int kw = round4(cdiv(kr, KG));
          const int kb = warp * kw, ke = min(kb + kw, kr);
          const int hs = kr + 4;
          for (int kk = kb; kk < ke; kk += 4) {
            const float r0 = rw_s[kk * NC + lane], r1 = rw_s[(kk + 1) * NC + lane];
            const float r2 = rw_s[(kk + 2) * NC + lane], r3 = rw_s[(kk + 3) * NC + lane];
#pragma unroll
            for (int i = 0; i < BT; ++i) {
              const float4 hv = *reinterpret_cast<const float4*>(h_s + i * hs + kk);
              acc[i] = fmaf(hv.x, r0, acc[i]);
              acc[i] = fmaf(hv.y, r1, acc[i]);
              acc[i] = fmaf(hv.z, r2, acc[i]);
              acc[i] = fmaf(hv.w, r3, acc[i]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < BT; ++i) part[(warp * BT + i) * PS + lane] = acc[i];
        __syncthreads();

        if (mine) {
          float z[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float s = 0.f;
#pragma unroll
            for (int w = 0; w < KG; ++w) s += part[(w * BT + eb) * PS + q * JT + eu];
            z[q] = s + zxs[eb * NC + q * JT + eu];
          }
          float zi = z[0], zf = z[1], zo = z[3];
          if (has_p) {
            zi = zi + cp * p0;
            zf = zf + cp * p1;
          }
          const float i = lstm::sigm(zi), f = lstm::sigm(zf), g = tanhf(z[2]);
          const float c = f * cp + i * g;
          if (has_p) zo = zo + c * p2;
          const float o = lstm::sigm(zo);
          const T hn = from_f32<T>(o * tanhf(c)), cn = from_f32<T>(c);
          const float hv = kept ? to_f32(hn) : hp, cv = kept ? to_f32(cn) : cp;
          if (k == 0) {
            h_all[hj] = from_f32<T>(hp);
            c_all[hj] = from_f32<T>(cp);
          }
          hdst[hj] = from_f32<T>(hv);
          cdst[hj] = from_f32<T>(cv);
          out[(size_t)t * BH + hj] = kept ? hn : from_f32<T>(0.f);
          h_own = hv;
          c_own = cv;
        }
        if (single && k + 1 < n_steps) {   // the next step's zx, during the barrier
          fetch_zx(zx_s + ((k + 1) & 1) * BT * NC, zx, reverse ? t - 1 : t + 1, B, H, b0, j0);
          cp_async_commit();
        }
        if (!single) __syncthreads();   // zx_s, h_s and part serve the next item
      }
    }
    if (kTileCounters && k + 1 < n_steps) {   // publish this step's rows
      __syncthreads();
      if (threadIdx.x == 0) {
        __threadfence();
        for (int jt = jt0; jt < n_jt; jt += gj)
          for (int bt = bt0; bt < n_bt; bt += bpj) atomicAdd(counters + bt, 1);
      }
    }
  }
}

template <typename T>
cudaError_t resident_blocks(int* blocks) {
  static lstm::CoresidentCache cache;
  return lstm::coresident_blocks(cache, reinterpret_cast<const void*>(lstm_seq_kernel<T>), NT,
                                 SMEM_MAX, blocks);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
cudaError_t launch(const void* zx, const void* h0, const void* c0, const void* rw,
                   const void* p, const void* keep, void* h_all, void* c_all, void* out,
                   void* counters, int n_steps, int B, int H, int reverse,
                   cudaStream_t stream) {
  int most = 0;
  cudaError_t err = resident_blocks<T>(&most);
  if (err != cudaSuccess) return err;
  const int n_jt = cdiv(H, JT), n_bt = cdiv(B, BT);
  int gj = n_jt < most ? n_jt : most;
  int bpj = most / gj < n_bt ? most / gj : n_bt;
  if (bpj < 1) bpj = 1;
  const int grid = gj * bpj;
  int vec = sizeof(T) == 4 && H % 4 == 0 && aligned16(h0) && aligned16(h_all) && aligned16(rw);
  const size_t smem = Layout{round4(H < KC ? H : KC)}.bytes();
  const T* zx_ = static_cast<const T*>(zx);
  const T* h0_ = static_cast<const T*>(h0);
  const T* c0_ = static_cast<const T*>(c0);
  const T* rw_ = static_cast<const T*>(rw);
  const T* p_ = static_cast<const T*>(p);
  const uint8_t* keep_ = static_cast<const uint8_t*>(keep);
  T* h_all_ = static_cast<T*>(h_all);
  T* c_all_ = static_cast<T*>(c_all);
  T* out_ = static_cast<T*>(out);
  int* counters_ = static_cast<int*>(counters);
  if (n_steps == 1) {   // no barrier: a plain launch
    lstm_seq_kernel<T><<<grid, NT, smem, stream>>>(zx_, h0_, c0_, rw_, p_, keep_, h_all_, c_all_,
                                                    out_, counters_, n_steps, B, H, reverse, gj,
                                                    bpj, vec);
    return cudaGetLastError();
  }
  void* args[] = {&zx_,      &h0_,     &c0_, &rw_, &p_,      &keep_, &h_all_, &c_all_, &out_,
                  &counters_, &n_steps, &B,   &H,   &reverse, &gj,    &bpj,    &vec};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(lstm_seq_kernel<T>), dim3(grid),
                                    dim3(NT), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// int32 scratch lstm_cell_fwd needs for a window (T > 1): one arrival
// counter a batch tile (none with the grid-sync variant).
extern "C" long long lstm_cell_fwd_scratch_ints(int B, int H) {
  (void)H;
  return kTileCounters ? (long long)cdiv(B, BT) : 0LL;
}

// zx_t: [T, B, 4H]; h0, c0: [B, H]; rw: [H, 4H]; p: [3, H], or null for no
// peepholes; keep: [T, B] bytes (nonzero keeps the step), or null; h_all,
// c_all: [T + 1, B, H] (slot 0 gets h0 and c0, slot k + 1 the state after
// the k-th step walked); out: [T, B, H]; counters:
// lstm_cell_fwd_scratch_ints(B, H) int32, or null when that is 0 or T is 1.
// Every tensor but keep and counters contiguous and of one type. reverse:
// 1 walks t = T - 1 .. 0. dtype: 0 = float32, 1 = bfloat16. One launch,
// cooperative for T > 1. Returns a cudaError_t (0 on success).
extern "C" int lstm_cell_fwd(const void* zx_t, const void* h0, const void* c0, const void* rw,
                             const void* p, const void* keep, void* h_all, void* c_all,
                             void* out, void* counters, int T, int B, int H, int reverse,
                             int dtype, void* stream) {
  if (T < 1 || B < 1 || H < 1 || (kTileCounters && T > 1 && counters == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(zx_t, h0, c0, rw, p, keep, h_all, c_all, out, counters, T, B, H,
                              reverse, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(zx_t, h0, c0, rw, p, keep, h_all, c_all, out, counters, T,
                                      B, H, reverse, s);
  return (int)cudaErrorInvalidValue;
}
