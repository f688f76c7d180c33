// Mamba2 SSD chunked scan forward, for Hopper.
//
// Replaces repro/kernels/ssm_scan.py::ssm_scan_pallas (the Pallas TPU
// kernel).  It computes what the plain version,
// repro_torch/models/layers.py::ssd_scan_ref (a port of
// repro/models/layers.py::ssd_scan_ref, re-exported as
// repro_torch/kernels/ref.py::ssm_scan_ref), computes, without the D-skip
// term: for x (B, S, H, P), dt (B, S, H) float32, a_log (H,) float32 and
// b, c (B, S, N), with a = -exp(a_log) and the state s (P, N) of each
// (batch, head) starting at zero,
//   s_t = exp(dt_t a) s_{t-1} + dt_t x_t b_t^T,   y_t = s_t c_t,
// evaluated chunk by chunk as the SSD algorithm does (arXiv:2405.21060).
// y has x's type (float32 or bfloat16); b and c have x's type too.
//
// Two paths, chosen by the dtype at dispatch:
//
// bfloat16: the tensor cores, as three chunk-parallel stages on the
// caller's stream (the plain version's steps; csrc/ssm_tc.cuh describes
// the tiles and stages (a) and (b)): (a) the chunk states X^T diag(u) B,
// one warpgroup per (batch, head, 64-row tile), into a float32 scratch;
// (b) the recurrence over the tiles on those (P, N) states, in place, so
// that the scratch then holds the state entering each tile; (c) the
// outputs, one warpgroup per tile (chunk_out_kernel below).  The tiles
// come by TMA (x through a 4-D map over (B, S, H, P), b and c as 64
// contiguous rows of (B, S, N)).  Shared memory of (c): 72 KB at P 64,
// N 128 (x, b, c and S_in as two bf16 tiles), three blocks an SM.
//
// float32: the CUDA cores (ssm_scan_kernel): one block of 256 threads per
// (batch, head).  The float32 (P, N) state stays in shared memory while
// the block walks the chunks of L rows in order, each chunk as tiles of
// at most 64 rows (ssm::TileRows, as the bf16 stages cut it: tile tau is
// chunk tau / T, part tau % T, T = ceil(L / 64)).  For each tile of len
// rows the block stages x (len x P), b and c (len x N) and dt, takes seg
// = cumsum(dt a) over the tile, and builds the decay-weighted (len x len)
// matrix
//   W[i][j] = (c_i . b_j) exp(seg_i - seg_j) dt_j   for j <= i, else 0
// (the mask is applied before the exp, as ssm_scan.py does).  Then
//   y_i = sum_j W[i][j] x_j + exp(seg_i) (state c_i)        (len x P)
//   state <- exp(seg_len) state + sum_j x_j exp(seg_len - seg_j) dt_j b_j^T.
// Design: each tile is its own sub-chunk, with the state carried across
// the tiles of a chunk as across chunks.  The reference keeps a chunk's
// quadratic term over all its rows; the sub-chunks compute the same
// function in another summation order (the chunk-invariance that
// tests/test_kernels.py holds at 1e-4), and need no (L x L) matrix and no
// decays across tiles, so shared memory no longer grows with L.  (Blocked
// W over the tile pairs of a chunk would keep the reference's order at
// the cost of T (T + 1) / 2 tile products per chunk.)  Shared memory is
// smem_bytes(min(L, 64), P, N): 132,608 B at (L 128, P 64, N 128), where
// whole chunks took 264,960 B (above a block's 232,448 B).  Rows of b, c
// and the state are padded to N + 1 floats so that the threads of a warp
// read distinct banks.
//
// What bounds it on an H100: at the serving path's shapes (B 4, S 512,
// H 128, P 64, N 16, L 64) the function needs 3.8e9 flops (2 L (L N +
// L P + 2 N P) per (batch, head, chunk); 3.8 us on the tensor cores) and
// moves about 68 MB (x and y in bf16, dt, b and c; 20 us at 3.35 TB/s);
// at the training path's (mamba2-780m: B 8, S 2048, H 48, P 64, N 128)
// 4.5e10 flops (46 us) and 213 MB (64 us): the bound is the bytes at
// both.  The bf16 path moves more: the float32 states (403 MB at the
// training shape) are written by (a), read and written by (b) and read
// by (c), about 1.6 GB beyond the bound's bytes; its warpgroups also wait
// for each product before the next.  The float32 path walks the chunks
// of each (batch, head) in sequence with scalar FMAs: it is bound by
// latency and fp32 issue.
//
// Arithmetic.  bfloat16: the bf16 inputs enter products as they are
// (exact products, float32 sums); every float32 operand of a product (X
// scaled by u, W, S_in) enters as two bf16 parts, hi = bf16(v) and lo =
// bf16(v - hi), two wgmma into one float32 accumulator, so the product
// errs by about 2^-17 of it (one bf16 part erred by about 2e-3 of y's
// largest value, tests/test_torch_ssm_tc_numerics.py); expf for the
// decays; y rounded to bf16 once, where the plain version rounds it.
// float32: float32 throughout, expf, sums in another order than the
// reference's einsums.  Held to the plain version with
// tests/test_kernels.py's tolerances: 1e-4 (rtol and atol) in float32,
// 5e-2 in bfloat16.
//
// The launches use the caller's stream, allocate nothing and return
// cudaGetLastError() (or a tensor map's failure); the Python wrapper
// raises if it is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "ssm_tc.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// shared memory of ssm_scan_kernel for tiles of at most L rows
size_t smem_bytes(int L, int P, int N) {
  const size_t NP = N + 1;
  return sizeof(float) *
         (static_cast<size_t>(L) * P      // x chunk
          + 2 * L * NP                    // b, c chunk
          + static_cast<size_t>(L) * L    // W
          + P * NP                        // state
          + 3 * static_cast<size_t>(L));  // dt, seg, exp(seg_L - seg) dt
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a_log, const T* __restrict__ b,
                const T* __restrict__ c, T* __restrict__ y, int S, int H,
                int P, int N, int L) {
  const int NP = N + 1;
  const int Lt = min(L, ssm::kRows);  // the longest tile
  extern __shared__ float smem[];
  float* xs = smem;
  float* bs = xs + Lt * P;
  float* cs = bs + Lt * NP;
  float* ws = cs + Lt * NP;
  float* st = ws + Lt * Lt;
  float* dts = st + P * NP;
  float* seg = dts + Lt;
  float* wj = seg + Lt;

  const int tid = threadIdx.x;
  const int bi = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const float a = -expf(a_log[h]);

  for (int idx = tid; idx < P * N; idx += kThreads)
    st[(idx / N) * NP + idx % N] = 0.f;

  const int nt = (S / L) * ((L + ssm::kRows - 1) / ssm::kRows);
  for (int tau = 0; tau < nt; ++tau) {
    const ssm::TileRows tr(tau, L);
    const int len = tr.len;
    __syncthreads();  // the last tile's state update is done
    const size_t row0 = static_cast<size_t>(bi) * S + tr.row0;
    for (int idx = tid; idx < len * P; idx += kThreads) {
      const int l = idx / P, p = idx % P;
      xs[idx] = to_f32(x[((row0 + l) * H + h) * P + p]);
    }
    for (int idx = tid; idx < len * N; idx += kThreads) {
      const int l = idx / N, n = idx % N;
      bs[l * NP + n] = to_f32(b[(row0 + l) * N + n]);
      cs[l * NP + n] = to_f32(c[(row0 + l) * N + n]);
    }
    for (int l = tid; l < len; l += kThreads) dts[l] = dt[(row0 + l) * H + h];
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int l = 0; l < len; ++l) {
        run += dts[l] * a;
        seg[l] = run;
      }
    }
    __syncthreads();
    const float seg_last = seg[len - 1];
    for (int l = tid; l < len; l += kThreads)
      wj[l] = expf(seg_last - seg[l]) * dts[l];
    for (int idx = tid; idx < len * len; idx += kThreads) {
      const int i = idx / len, j = idx % len;
      float w = 0.f;
      if (j <= i) {
        float cb = 0.f;
        for (int n = 0; n < N; ++n) cb = fmaf(cs[i * NP + n], bs[j * NP + n], cb);
        w = cb * expf(seg[i] - seg[j]) * dts[j];
      }
      ws[idx] = w;
    }
    __syncthreads();
    for (int idx = tid; idx < len * P; idx += kThreads) {
      const int i = idx / P, p = idx % P;
      float yi = 0.f;
      for (int j = 0; j <= i; ++j) yi = fmaf(ws[i * len + j], xs[j * P + p], yi);
      float ci = 0.f;
      for (int n = 0; n < N; ++n) ci = fmaf(cs[i * NP + n], st[p * NP + n], ci);
      store(y + ((row0 + i) * H + h) * P + p, yi + expf(seg[i]) * ci);
    }
    __syncthreads();  // every read of the old state is done
    const float dec = expf(seg_last);
    for (int idx = tid; idx < P * N; idx += kThreads) {
      const int p = idx / N, n = idx % N;
      float u = 0.f;
      for (int j = 0; j < len; ++j)
        u = fmaf(xs[j * P + p] * wj[j], bs[j * NP + n], u);
      st[p * NP + n] = dec * st[p * NP + n] + u;
    }
  }
}

// ---- bfloat16: chunk-parallel stages on the tensor cores ----------------

// stage (c)'s shared memory: the x, b and c tiles, S_in as two bf16 tiles
// (rows p, columns n), the mbarrier and the per-row vectors
template <int P, int N>
constexpr size_t out_smem_bytes() {
  return tc::Tile<P>::kBytes + 4 * tc::Tile<N>::kBytes + 8 +
         3 * ssm::kRows * 4 + 8 + 1024;  // + 1 KB to align
}

// Stage (c); grid (n_tiles, H, B), one warpgroup: for the tile's rows i
//   y_i = exp(seg_i) (C S_in^T)_i + sum_j W_ij x_j,
//   W_ij = (C B^T)_ij exp(seg_i - seg_j) dt_j for j <= i, else 0,
// with C B^T (m64 n64, K = N) and C S_in^T (m64 n=P, K = N, S_in as two
// bf16 parts) on wgmma from shared memory, then W (two bf16 parts) as the
// register A operand of W X (m64 n=P k16 x 4, X the MN-major B operand)
// added to the scaled C S_in^T in the same float32 accumulator; y is
// rounded to bf16 once.
template <int P, int N>
__global__ void __launch_bounds__(ssm::kThreads)
chunk_out_kernel(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_b,
                 const __grid_constant__ CUtensorMap tm_c,
                 const float* __restrict__ dt, const float* __restrict__ a_log,
                 const float* __restrict__ s_in, __nv_bfloat16* __restrict__ y,
                 int S, int H, int L) {
  using TileX = tc::Tile<P>;
  using TileN = tc::Tile<N>;
  constexpr int kRows = ssm::kRows;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t x_s = tc::align1024(smem_raw);
  const uint32_t b_s = x_s + TileX::kBytes;
  const uint32_t c_s = b_s + TileN::kBytes;
  const uint32_t hi_s = c_s + TileN::kBytes;
  const uint32_t lo_s = hi_s + TileN::kBytes;
  const uint32_t bar = lo_s + TileN::kBytes;
  uint8_t* gen = smem_raw + (x_s - tc::smem_u32(smem_raw));
  float* dt_s = reinterpret_cast<float*>(gen + (bar + 8 - x_s));
  float* seg_s = dt_s + kRows;
  float* ex_s = seg_s + kRows;
  float* tmp = ex_s + kRows;

  const int tid = threadIdx.x;
  const int tau = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nt = gridDim.x;
  const ssm::TileRows tr(tau, L);
  if (tid == 0) {
    tc::mbar_init(bar, 1);
    tc::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    tc::mbar_expect_tx(bar, TileX::kBytes + 2 * TileN::kBytes);
    TileX::load_4d(x_s, &tm_x, bar, tr.row0, b, h);
    TileN::load(b_s, &tm_b, bar, tr.row0, b);
    TileN::load(c_s, &tm_c, bar, tr.row0, b);
  }
  const size_t bt = static_cast<size_t>(b) * H + h;
  ssm::stage_split<P, N>(s_in + (bt * nt + tau) * P * N, nullptr,
                         gen + (hi_s - x_s), gen + (lo_s - x_s));
  tc::fence_proxy_async();
  const float a = -expf(a_log[h]);
  ssm::tile_seg(dt, (static_cast<size_t>(b) * S + tr.row0) * H + h, H,
                tr.len, a, dt_s, seg_s, tmp);
  if (tid < kRows) ex_s[tid] = expf(seg_s[tid]);
  __syncthreads();
  tc::mbar_wait(bar, 0);

  // G = C B^T and Z = C S_in^T
  float g[32], acc[P / 2];
  tc::wg_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    tc::Wgmma<64>::ss<0, 0>(g, TileN::kmajor(c_s, kk),
                            TileN::kmajor(b_s, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    tc::Wgmma<P>::template ss<0, 0>(acc, TileN::kmajor(c_s, kk),
                                    TileN::kmajor(hi_s, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    tc::Wgmma<P>::template ss<0, 0>(acc, TileN::kmajor(c_s, kk),
                                    TileN::kmajor(lo_s, kk), 1);
  tc::wg_commit();
  tc::wg_wait<0>();
  tc::fence_operand(g);
  tc::fence_operand(acc);

  // this thread's rows (r0, r0 + 8) and first column of each 8-column
  // block of a fragment (hopper_tc.cuh)
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  // W, masked before the exp as the reference masks it
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = r0 + 8 * i, col = 8 * jj + c0 + e;
        float& w = g[4 * jj + 2 * i + e];
        w = col <= row ? w * expf(seg_s[row] - seg_s[col]) * dt_s[col] : 0.f;
      }
  uint32_t whi[4][4], wlo[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      ssm::split2(g[8 * kk + 2 * x], g[8 * kk + 2 * x + 1], whi[kk][x],
                  wlo[kk][x]);
  const float ex0 = ex_s[r0], ex1 = ex_s[r0 + 8];
#pragma unroll
  for (int jj = 0; jj < P / 8; ++jj) {
    acc[4 * jj] *= ex0;
    acc[4 * jj + 1] *= ex0;
    acc[4 * jj + 2] *= ex1;
    acc[4 * jj + 3] *= ex1;
  }
  tc::wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    tc::Wgmma<P>::template rs<1>(acc, whi[kk], TileX::mnmajor(x_s, kk), 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    tc::Wgmma<P>::template rs<1>(acc, wlo[kk], TileX::mnmajor(x_s, kk), 1);
  tc::wg_commit();
  tc::wg_wait<0>();
  tc::fence_operand(acc);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= tr.len) continue;
    __nv_bfloat16* dst =
        y + ((static_cast<size_t>(b) * S + tr.row0 + row) * H + h) * P + c0;
#pragma unroll
    for (int jj = 0; jj < P / 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * jj) =
          __floats2bfloat162_rn(acc[4 * jj + 2 * i], acc[4 * jj + 2 * i + 1]);
  }
}

struct ForwardTc {
  const void *x, *b, *c;
  const float *dt, *a_log;
  void* y;
  float *states, *decay;
  int B, S, H, L;
  cudaStream_t stream;

  template <int P, int N>
  cudaError_t run() const {
    CUtensorMap tm_x, tm_b, tm_c;
    cudaError_t e = tc::make_map_4d(&tm_x, x, B, S, H, P);
    if (e == cudaSuccess) e = tc::make_map(&tm_b, b, B, S, N);
    if (e == cudaSuccess) e = tc::make_map(&tm_c, c, B, S, N);
    if (e != cudaSuccess) return e;
    const int nt = ssm::n_tiles(S, L);
    // (a) the chunk states, (b) the states entering each tile
    e = ssm::launch_states<P, N>(tm_x, tm_b, dt, a_log, states, decay, B, S,
                                 H, L, nt, 0, stream);
    if (e == cudaSuccess)
      e = ssm::launch_pass(states, decay, B * H, nt, P * N, 0, stream);
    if (e != cudaSuccess) return e;
    // (c) the outputs
    constexpr size_t smem = out_smem_bytes<P, N>();
    e = cudaFuncSetAttribute(chunk_out_kernel<P, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    chunk_out_kernel<P, N><<<dim3(nt, H, B), ssm::kThreads, smem, stream>>>(
        tm_x, tm_b, tm_c, dt, a_log, states,
        static_cast<__nv_bfloat16*>(y), S, H, L);
    return cudaGetLastError();
  }
};

// ---- float32: the CUDA cores ----------------------------------------------

template <typename T>
int launch(const void* x, const float* dt, const float* a_log, const void* b,
           const void* c, void* y, int B, int S, int H, int P, int N, int L,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(L < ssm::kRows ? L : ssm::kRows, P, N);
  const cudaError_t e = cudaFuncSetAttribute(
      ssm_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  ssm_scan_kernel<T><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, a_log, static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), S, H, P, N, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, y (B, S, H, P), b, c (B, S, N) of one type (bfloat16 when is_bf16 is
// non-zero, else float32); dt (B, S, H) and a_log (H,) float32; all
// contiguous device pointers.  S is a multiple of the chunk length L.
// bfloat16: the tensor cores; P is 16, 32 or 64, N 16, 32, 64 or 128,
// any L; x, b and c 16-byte aligned (TMA); states (B H, n_tiles,
// P, N) and decay (B H, n_tiles) float32 are scratch, n_tiles = S / L
// times ceil(L / 64).  float32: the CUDA cores; states and decay unused.
int ssm_scan_launch(const void* x, const float* dt, const float* a_log,
                    const void* b, const void* c, void* y, float* states,
                    float* decay, int B, int S, int H, int P, int N, int L,
                    int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  if (L <= 0 || S % L != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return launch<float>(x, dt, a_log, b, c, y, B, S, H, P, N, L, st);
  const ForwardTc f{x, b, c, dt, a_log, y, states, decay, B, S, H, L, st};
  return static_cast<int>(ssm::dispatch(P, N, f));
}

const char* ssm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
