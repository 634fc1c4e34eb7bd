// LSTM cell forward for Hopper (sm_90a): one time step of a (Graves) LSTM,
// z = zx + h_prev @ RW with gates packed [i, f, g, o], optional peepholes
// (i += c_prev P0, f += c_prev P1, o += c P2 on the new c),
// c = sig(f) c_prev + sig(i) tanh(g), h = sig(o) tanh(c).
//
// Replaces: deeplearning4j_tpu/ops/pallas_kernels.py:_lstm_cell_fwd_kernel
// (launched by _lstm_cell_call through pl.pallas_call).
//
// What bounds it on this card. At the char-RNN's shape (B 32, H 200, f32) the
// call reads zx, h_prev, c_prev, RW and P once and writes h and c: 847,200 B,
// 0.25 us at 3.35 TB/s, against 10.2 MFLOP of products, 0.15 us at the f32
// peak. So the bound is bytes, and it is far below the few microseconds any
// launch costs: a cell step is bound by launch and host overhead, which a
// later design (a persistent kernel over the time loop, or a CUDA graph per
// tBPTT window) has to remove.
//
// What the design does: each block owns a tile of 32 hidden units j and 8
// batch rows b; each thread one (b, j) and all four of its gate sums
// z[b, g*H + j], so the epilogue (activations, peepholes, cell update) runs
// in registers and nothing crosses blocks. h_prev rows and RW's four column
// slices are staged through shared memory 32 rows of k at a time (RW is not
// assumed to fit: 16 MB at H 1024 in f32). bf16 inputs are converted on load
// and everything accumulates in f32; h and c are rounded once. Ragged edges
// (H or B not a multiple of the tile) are masked in the kernel.
//
// Interface: a plain C function, bound from Python with ctypes. It launches
// on the caller's stream, allocates nothing, and returns cudaGetLastError().

#include "lstm_common.cuh"

namespace {

using lstm::NT;
using lstm::to_f32;

constexpr int JT = 32;   // hidden units per block (one per lane)
constexpr int BT = 8;    // batch rows per pass (one per warp)
constexpr int KT = 32;   // reduction depth staged in shared memory
static_assert(JT * BT == NT, "one (b, j) a thread");

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

template <typename T>
__global__ void __launch_bounds__(NT)
lstm_fwd_kernel(const T* __restrict__ zx, const T* __restrict__ h_prev,
                const T* __restrict__ c_prev, const T* __restrict__ rw,
                const T* __restrict__ peep, T* __restrict__ h_out,
                T* __restrict__ c_out, int B, int H) {
  __shared__ DotSmem s;
  const int j0 = blockIdx.x * JT, b0 = blockIdx.y * BT;
  const int j = j0 + threadIdx.x % JT, b = b0 + threadIdx.x / JT;
  float acc[4];
  gate_dots(h_prev, rw, B, H, b0, j0, s, acc);
  if (b >= B || j >= H) return;

  const size_t row = (size_t)b * 4 * H;
  float zi = acc[0] + lstm::to_f32(zx[row + j]);
  float zf = acc[1] + lstm::to_f32(zx[row + H + j]);
  const float zg = acc[2] + lstm::to_f32(zx[row + 2 * (size_t)H + j]);
  float zo = acc[3] + lstm::to_f32(zx[row + 3 * (size_t)H + j]);
  const float cp = lstm::to_f32(c_prev[(size_t)b * H + j]);
  if (peep != nullptr) {
    zi = zi + cp * lstm::to_f32(peep[j]);
    zf = zf + cp * lstm::to_f32(peep[H + j]);
  }
  const float i = lstm::sigm(zi), f = lstm::sigm(zf), g = tanhf(zg);
  const float c = f * cp + i * g;
  if (peep != nullptr) zo = zo + c * lstm::to_f32(peep[2 * H + j]);
  const float o = lstm::sigm(zo);
  h_out[(size_t)b * H + j] = lstm::from_f32<T>(o * tanhf(c));
  c_out[(size_t)b * H + j] = lstm::from_f32<T>(c);
}

template <typename T>
cudaError_t launch(const void* zx, const void* h, const void* c, const void* rw,
                   const void* p, void* h_out, void* c_out, int B, int H,
                   cudaStream_t stream) {
  const dim3 grid((H + JT - 1) / JT, (B + BT - 1) / BT);
  lstm_fwd_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(zx), static_cast<const T*>(h), static_cast<const T*>(c),
      static_cast<const T*>(rw), static_cast<const T*>(p), static_cast<T*>(h_out),
      static_cast<T*>(c_out), B, H);
  return cudaGetLastError();
}

}  // namespace

// zx: [B, 4H]; h_prev, c_prev, h_out, c_out: [B, H]; rw: [H, 4H]; p: [3, H],
// or null for no peepholes. All contiguous, all of one type.
// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
extern "C" int lstm_cell_fwd(const void* zx, const void* h_prev, const void* c_prev,
                             const void* rw, const void* p, void* h_out, void* c_out,
                             int B, int H, int dtype, void* stream) {
  if (B < 1 || H < 1 || (B + BT - 1) / BT > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(zx, h_prev, c_prev, rw, p, h_out, c_out, B, H, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(zx, h_prev, c_prev, rw, p, h_out, c_out, B, H, s);
  return (int)cudaErrorInvalidValue;
}
