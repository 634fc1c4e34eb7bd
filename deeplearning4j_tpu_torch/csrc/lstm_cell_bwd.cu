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
// of each dependent step inside it, decide the time, so the design keeps
// every chain of dependent tiles short and every SM it can busy.
//
// What the design does. dh_prev reduces over all 4H columns of dz, dRW and
// dP over the batch, so no block of one tile grid holds what they need. One
// C entry point therefore makes three launches on the caller's stream, in
// order, and no atomics (every sum is taken in a fixed order, so f32
// results do not depend on scheduling):
//  (a) lstm_gates_bwd_kernel: one block per (tile of 32 hidden units j,
//      chunk of 8 batch rows b). Each thread recomputes its four gate sums
//      (the forward's tiled dot products), the gates and the adjoints, and
//      writes dzx, the unrounded f32 dz (into scratch for bf16; for f32 the
//      scratch is dzx itself) and dc_prev. The block sums its 8 rows' dP
//      terms in row order into a per-chunk partial.
//  (b) lstm_products_kernel: output-tiled products on 32 x 32 tiles, reading
//      dz back in f32 (the reference multiplies the unrounded dz): dRW
//      [H, 4H] = h_prev^T dz, reduced over the batch; and dh_prev [B, H] =
//      dz RW^T split into its four gate segments of H columns, each tile
//      writing one segment's f32 partial, which cuts the dependent chain of
//      the 4H-long reduction by four.
//  (c) lstm_bwd_finish_kernel: dh_prev = the four segment partials summed in
//      gate order, dP = the chunk partials summed in chunk order, each
//      rounded once.
// bf16 inputs are converted on load and accumulate in f32; each output is
// rounded once to its input's type (dP to RW's). Ragged edges are masked in
// the kernels. Tensor cores, and accumulating dRW over a whole window in
// place instead of one fresh [H, 4H] per step, are later work.
//
// Interface: a plain C function, bound from Python with ctypes. It launches
// on the caller's stream, allocates nothing (the caller passes the f32
// scratch, see lstm_cell_bwd_scratch_floats), and returns cudaGetLastError().

#include "lstm_common.cuh"

namespace {

using lstm::BT;
using lstm::JT;
using lstm::NT;
using lstm::from_f32;
using lstm::to_f32;

template <typename T>
__global__ void __launch_bounds__(NT)
lstm_gates_bwd_kernel(const T* __restrict__ zx, const T* __restrict__ h_prev,
                      const T* __restrict__ c_prev, const T* __restrict__ rw,
                      const T* __restrict__ peep, const T* __restrict__ dh,
                      const T* __restrict__ dc, T* __restrict__ dzx,
                      float* __restrict__ dz32, T* __restrict__ dc_prev,
                      float* __restrict__ dp_part, int B, int H) {
  __shared__ lstm::DotSmem s;
  __shared__ float red[3][BT][JT];
  const int tx = threadIdx.x % JT, ty = threadIdx.x / JT;
  const int j0 = blockIdx.x * JT, j = j0 + tx;
  const int b0 = blockIdx.y * BT, b = b0 + ty;
  const bool has_p = peep != nullptr;
  float acc[4];
  lstm::gate_dots(h_prev, rw, B, H, b0, j0, s, acc);

  float sp0 = 0.f, sp1 = 0.f, sp2 = 0.f;   // this row's dP terms
  if (b < B && j < H) {
    float p0 = 0.f, p1 = 0.f, p2 = 0.f;
    if (has_p) {
      p0 = to_f32(peep[j]);
      p1 = to_f32(peep[H + j]);
      p2 = to_f32(peep[2 * H + j]);
    }
    const size_t row = (size_t)b * 4 * H;
    float zi = acc[0] + to_f32(zx[row + j]);
    float zf = acc[1] + to_f32(zx[row + H + j]);
    const float zg = acc[2] + to_f32(zx[row + 2 * (size_t)H + j]);
    float zo = acc[3] + to_f32(zx[row + 3 * (size_t)H + j]);
    const size_t hj = (size_t)b * H + j;
    const float cp = to_f32(c_prev[hj]);
    if (has_p) {
      zi = zi + cp * p0;
      zf = zf + cp * p1;
    }
    const float i = lstm::sigm(zi), f = lstm::sigm(zf), g = tanhf(zg);
    const float c = f * cp + i * g;
    if (has_p) zo = zo + c * p2;
    const float o = lstm::sigm(zo);
    const float tc = tanhf(c);

    const float dhv = to_f32(dh[hj]), dcv = to_f32(dc[hj]);
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
  red[0][ty][tx] = sp0;
  red[1][ty][tx] = sp1;
  red[2][ty][tx] = sp2;
  __syncthreads();
  if (ty < 3 && j < H) {
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < BT; ++r) sum += red[ty][r][tx];
    dp_part[((size_t)blockIdx.y * 3 + ty) * H + j] = sum;
  }
}

constexpr int PT = 32;            // output tile edge of the products
constexpr int PL = PT * PT / NT;  // tile elements each thread loads

// C[m, n] = sum_r A(m, r) B(r, n) on the 32 x 32 output tile at (m0, n0),
// r in [r_begin, r_end), A(m, r) = A[m sa_m + r sa_r], B(r, n) =
// B[r sb_r + n sb_n], accumulated in f32 in r order. Tiles are loaded so that
// neighbouring threads read neighbouring addresses along whichever index has
// stride 1, all of a tile's loads started before its stores.
template <typename TA, typename TB, typename TC>
__device__ void tile_product(const TA* __restrict__ A, size_t sa_m, size_t sa_r,
                             const TB* __restrict__ Bm, size_t sb_r, size_t sb_n,
                             TC* __restrict__ C, size_t ldc, int M, int N,
                             int r_begin, int r_end, int m0, int n0,
                             float (*As)[PT + 1], float (*Bs)[PT + 1]) {
  const int tid = threadIdx.x;
  const int tx = tid % PT, ty = tid / PT;   // 8 row groups
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int r0 = r_begin; r0 < r_end; r0 += PT) {
    float av[PL], bv[PL];
#pragma unroll
    for (int q = 0; q < PL; ++q) {
      const int i = tid + q * NT;
      const int lo = i % PT, hi = i / PT;
      const int m = m0 + (sa_m == 1 ? lo : hi), ra = r0 + (sa_m == 1 ? hi : lo);
      av[q] = (m < M && ra < r_end) ? to_f32(A[(size_t)m * sa_m + (size_t)ra * sa_r]) : 0.f;
      const int n = n0 + (sb_n == 1 ? lo : hi), rb = r0 + (sb_n == 1 ? hi : lo);
      bv[q] = (n < N && rb < r_end) ? to_f32(Bm[(size_t)rb * sb_r + (size_t)n * sb_n]) : 0.f;
    }
    __syncthreads();   // the previous tile is no longer read
#pragma unroll
    for (int q = 0; q < PL; ++q) {
      const int i = tid + q * NT;
      const int lo = i % PT, hi = i / PT;
      if (sa_m == 1) As[lo][hi] = av[q]; else As[hi][lo] = av[q];
      if (sb_n == 1) Bs[hi][lo] = bv[q]; else Bs[lo][hi] = bv[q];
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < PT; ++rr) {
      const float b = Bs[rr][tx];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = fmaf(As[ty + 8 * q][rr], b, acc[q]);
    }
  }
  const int n = n0 + tx;
  if (n >= N) return;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int m = m0 + ty + 8 * q;
    if (m < M) C[(size_t)m * ldc + n] = from_f32<TC>(acc[q]);
  }
}

__host__ __device__ inline int tiles(int n) { return (n + PT - 1) / PT; }

template <typename T>
__global__ void __launch_bounds__(NT)
lstm_products_kernel(const T* __restrict__ h_prev, const T* __restrict__ rw,
                     const float* __restrict__ dz32, T* __restrict__ drw,
                     float* __restrict__ dh_part, int B, int H) {
  __shared__ float As[PT][PT + 1];
  __shared__ float Bs[PT][PT + 1];
  const size_t H4 = (size_t)4 * H;
  const int tn_rw = tiles(4 * H);
  const int n_rw = tiles(H) * tn_rw;
  int t = blockIdx.x;
  if (t < n_rw) {
    // dRW [H, 4H] = h_prev^T [H, B] . dz [B, 4H]
    tile_product(h_prev, 1, (size_t)H, dz32, H4, 1, drw, H4, H, (int)H4, 0, B,
                 (t / tn_rw) * PT, (t % tn_rw) * PT, As, Bs);
  } else {
    // segment g of dh_prev [B, H] = dz[:, gH:(g+1)H] . RW[:, gH:(g+1)H]^T
    t -= n_rw;
    const int tn_h = tiles(H), per_seg = tiles(B) * tn_h;
    const int g = t / per_seg;
    t %= per_seg;
    tile_product(dz32, H4, 1, rw, 1, H4, dh_part + (size_t)g * B * H, (size_t)H,
                 B, H, g * H, (g + 1) * H, (t / tn_h) * PT, (t % tn_h) * PT, As, Bs);
  }
}

template <typename T>
__global__ void lstm_bwd_finish_kernel(const float* __restrict__ dh_part,
                                       const float* __restrict__ dp_part,
                                       T* __restrict__ dh_prev, T* __restrict__ dp,
                                       int B, int H, int n_chunks) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t bh = (size_t)B * H;
  if (i < bh) {
    float sum = 0.f;
#pragma unroll
    for (int g = 0; g < 4; ++g) sum += dh_part[(size_t)g * bh + i];
    dh_prev[i] = from_f32<T>(sum);
  }
  if (dp != nullptr && i < (size_t)3 * H) {
    float sum = 0.f;
    for (int c = 0; c < n_chunks; ++c) sum += dp_part[(size_t)c * 3 * H + i];
    dp[i] = from_f32<T>(sum);
  }
}

template <typename T>
cudaError_t launch(const void* zx, const void* h, const void* c, const void* rw,
                   const void* p, const void* dh, const void* dc, void* dzx,
                   float* dz32, float* scratch, void* dhp, void* dcp, void* drw,
                   void* dp, int B, int H, cudaStream_t stream) {
  const int n_chunks = (B + BT - 1) / BT;
  float* dh_part = scratch;                          // [4, B, H]
  float* dp_part = scratch + (size_t)4 * B * H;      // [n_chunks, 3, H]
  lstm_gates_bwd_kernel<T><<<dim3((H + JT - 1) / JT, n_chunks), NT, 0, stream>>>(
      static_cast<const T*>(zx), static_cast<const T*>(h), static_cast<const T*>(c),
      static_cast<const T*>(rw), static_cast<const T*>(p), static_cast<const T*>(dh),
      static_cast<const T*>(dc), static_cast<T*>(dzx), dz32, static_cast<T*>(dcp),
      dp_part, B, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)tiles(H) * tiles(4 * H) +
                           4LL * tiles(B) * tiles(H);
  lstm_products_kernel<T><<<(unsigned)blocks, NT, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(rw), dz32, static_cast<T*>(drw),
      dh_part, B, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = (size_t)B * H > (size_t)3 * H ? (size_t)B * H : (size_t)3 * H;
  lstm_bwd_finish_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      dh_part, dp_part, static_cast<T*>(dhp), static_cast<T*>(dp), B, H, n_chunks);
  return cudaGetLastError();
}

}  // namespace

// The f32 scratch lstm_cell_bwd needs beside dz32, in floats:
// [4, B, H] dh_prev partials, then [ceil(B / 8), 3, H] dP partials.
extern "C" long long lstm_cell_bwd_scratch_floats(int B, int H) {
  return 4LL * B * H + 3LL * ((B + BT - 1) / BT) * H;
}

// zx, dzx: [B, 4H]; dz32: [B, 4H] f32 scratch (may be dzx itself when dtype
// is float32); scratch: lstm_cell_bwd_scratch_floats(B, H) f32; h_prev,
// c_prev, dh, dc, dh_prev, dc_prev: [B, H]; rw, drw: [H, 4H]; p, dp: [3, H],
// or both null for no peepholes. All contiguous; every tensor but the
// scratch of one type. dtype: 0 = float32, 1 = bfloat16. Returns a
// cudaError_t (0 on success).
extern "C" int lstm_cell_bwd(const void* zx, const void* h_prev, const void* c_prev,
                             const void* rw, const void* p, const void* dh,
                             const void* dc, void* dzx, void* dz32, void* scratch,
                             void* dh_prev, void* dc_prev, void* drw, void* dp, int B,
                             int H, int dtype, void* stream) {
  if (B < 1 || H < 1 || (p == nullptr) != (dp == nullptr) ||
      (B + BT - 1) / BT > 65535 ||
      (long long)tiles(H) * tiles(4 * H) + 4LL * tiles(B) * tiles(H) > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* d32 = static_cast<float*>(dz32);
  float* part = static_cast<float*>(scratch);
  if (dtype == 0)
    return (int)launch<float>(zx, h_prev, c_prev, rw, p, dh, dc, dzx, d32, part, dh_prev,
                              dc_prev, drw, dp, B, H, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(zx, h_prev, c_prev, rw, p, dh, dc, dzx, d32, part,
                                      dh_prev, dc_prev, drw, dp, B, H, s);
  return (int)cudaErrorInvalidValue;
}
