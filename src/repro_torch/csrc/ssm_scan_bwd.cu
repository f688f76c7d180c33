// Mamba2 SSD chunked scan backward, for Hopper.
//
// The backward of repro_torch/csrc/ssm_scan.cu, the forward that replaces
// repro/kernels/ssm_scan.py::ssm_scan_pallas.  The Pallas kernel has no
// backward: the JAX package trains by differentiating
// repro/models/layers.py::ssd_scan_ref.  This kernel gives the gradients
// of the function that the plain version
// repro_torch/models/layers.py::ssd_scan_ref computes (see ssm_scan.cu):
// for x (B, S, H, P), dt (B, S, H), a_log (H,), b, c (B, S, N), with
// seg the within-chunk cumulative sum of dt a and a = -exp(a_log).
//
// Design: dx, ddt, da_log, db and dc for the output gradient dy.  Two
// paths, chosen by the dtype at dispatch.
//
// bfloat16: the tensor cores, as chunk-parallel stages (csrc/ssm_tc.cuh
// describes the tiles and stages (a), (b)): (a) and (b) give the state
// entering each 64-row tile, S_in, as the forward does; (a') the
// gradient each tile's outputs send to its entering state, M = (diag(ex)
// dY)^T C, and (b') the reverse recurrence D = exp(seg_last) D + M give
// D_out, the gradient of the state leaving each tile; (c') one warpgroup
// per (batch, head, tile) takes the gradients (chunk_grads_kernel below).
// db and dc are shared by the heads: each block adds its (64, N) shares
// with float2 atomics to float32 (B, S, N) buffers, and a last kernel
// casts them to bf16; d a_log is one atomic per warp and block.  Shared
// memory of (c'): 99 KB at P 64, N 128 (x, dy, b, c, D_out and then S_in
// as two bf16 tiles, Am^T as two bf16 tiles), two blocks an SM.
//
// float32: the CUDA cores (ssm_scan_bwd_kernel).  One block of 256
// threads per (batch, head) does two passes over the tiles of at most 64
// rows that the forward walks (ssm_scan.cu: each tile its own sub-chunk,
// the same function as whole chunks in another summation order).  The
// first walks the tiles forward and writes the state entering each tile
// to a float32 scratch (B H, n_tiles, P, N).  The second walks the tiles
// in reverse with dstate (P, N), the gradient of the state leaving the
// tile, in shared memory.  Per tile of L <= 64 rows it stages x, dy (rows
// padded to P + 1), b, c (N + 1) and the entering state as float32,
// builds Q[i][j] = (c_i . b_j) exp(seg_i - seg_j) and A[i][j] = dy_i .
// x_j (j <= i), and from them
//   dc_i = sum_j A_ij exp(seg_i - seg_j) dt_j b_j + exp(seg_i) dy_i^T state
//   db_j = sum_i A_ij exp(seg_i - seg_j) dt_j c_i
//          + exp(seg_L - seg_j) dt_j dstate^T x_j
//   dx_j = sum_i Q_ij dt_j dy_i + exp(seg_L - seg_j) dt_j dstate b_j
// and the gradient of every seg and dt; a reverse cumulative sum turns
// dseg into ddt (times a) and da (times dt), and
//   dstate <- exp(seg_L) dstate + sum_i exp(seg_i) dy_i c_i^T.
// Every block adds its share of db, dc (into (B, S, N) float32) and d
// a_log (into (H,) float32) with atomics.  Shared memory is
// bwd_smem_bytes(min(L, 64), P, N) and does not grow with the chunk:
// 200,736 B at N 128, P 64 for any chunk of 64 rows or more (one block
// per SM), where whole chunks of 128 rows took 400,928 B (above a block's
// 232,448 B).
//
// The atomics of both paths add the heads' shares in an order that
// changes from run to run.
//
// What bounds it on an H100: per (batch, head, chunk) the work is
// 5 L P N + L^2 (3 N + 2 P) / 2 multiply-adds (the recomputed state, the
// lower triangles of Q and A, and the intra- and inter-chunk terms of dc,
// db, dx and dstate).  At the training path's shapes (mamba2-780m, B 8,
// S 2048, H 48, P 64, N 128, chunk 64, bf16) that is 9.0e10 flops (0.09
// ms on the tensor cores), and x, dy, dt, b, c read and dx, ddt, db, dc
// written are 0.33 GB (0.10 ms at 3.35 TB/s), so the bound is the bytes.
// The bf16 path moves more: the two float32 state scratches (403 MB
// each) are written by (a) and (a'), read and written by (b) and (b'),
// and read by (c') (D_out twice), about 3.2 GB; the db and dc atomics add
// 2e8 floats; each warpgroup waits for its products in turn.  The
// float32 path does its products as fp32 FMAs on the CUDA cores, with
// 384 blocks of 200.7 KB (one per SM) walking 32 chunks each and about
// ten barriers per chunk: it is bound by fp32 issue and the chunks'
// sequence, far above the bound.
//
// Arithmetic: bfloat16 as the forward's (the bf16 inputs enter products
// as they are; every float32 operand of a product, Qm, Am, D_out, S_in,
// dY scaled by ex, enters as two bf16 parts); dx rounded to bf16 once,
// db and dc summed over the heads in float32 and rounded once.  float32:
// float32, expf, sums in another order than autograd of the plain
// version.  Held against autograd of the plain version within 1e-4 of
// each gradient's largest magnitude in float32 and 5e-2 in bfloat16.
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

// shared memory of ssm_scan_bwd_kernel for tiles of at most L rows
size_t bwd_smem_bytes(int L, int P, int N) {
  const size_t PP = P + 1, NP = N + 1, LP = L + 1;
  return sizeof(float) * (2 * L * PP           // x, dy tile
                          + 2 * L * NP         // b, c tile
                          + 2 * P * NP         // entering state, dstate
                          + 2 * L * LP         // A, Q
                          + 8 * static_cast<size_t>(L)  // per-row vectors
                          + kThreads / 32);    // block reduction
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssm_scan_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a_log, const T* __restrict__ b,
                    const T* __restrict__ c, const T* __restrict__ dy,
                    T* __restrict__ dx, float* __restrict__ ddt,
                    float* __restrict__ da, float* __restrict__ db,
                    float* __restrict__ dc, float* __restrict__ states,
                    int S, int H, int P, int N, int L) {
  const int Lt = min(L, ssm::kRows);  // the longest tile
  const int PP = P + 1, NP = N + 1, LP = Lt + 1;
  constexpr int kWarps = kThreads / 32;
  extern __shared__ float smem[];
  float* xs = smem;
  float* dys = xs + Lt * PP;
  float* bs = dys + Lt * PP;
  float* cs = bs + Lt * NP;
  float* st = cs + Lt * NP;    // state entering the tile
  float* ds = st + P * NP;     // gradient of the state leaving it
  float* am = ds + P * NP;     // A, then A exp(seg_i - seg_j) dt_j
  float* qm = am + Lt * LP;    // Q, then Q dt_j
  float* dts = qm + Lt * LP;
  float* seg = dts + Lt;
  float* ex = seg + Lt;        // exp(seg_i)
  float* u = ex + Lt;          // exp(seg_L - seg_j) dt_j
  float* dseg = u + Lt;        // row terms of d seg_i
  float* cg = dseg + Lt;       // sum_i A_ij Q_ij (d dt_j, intra, direct)
  float* sv = cg + Lt;         // d dt_j from the leaving state, direct
  float* kv = sv + Lt;         // sv_j dt_j (d seg_L += sum, d seg_j -= each)
  float* red = kv + Lt;        // per-warp partial sums

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bi = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int nt = (S / L) * ((L + ssm::kRows - 1) / ssm::kRows);
  const float a = -expf(a_log[h]);
  float* sts = states + static_cast<size_t>(blockIdx.x) * nt * P * N;

  // ---- pass 1: the state entering every tile -----------------------------
  for (int idx = tid; idx < P * N; idx += kThreads)
    st[(idx / N) * NP + idx % N] = 0.f;
  for (int k = 0; k < nt; ++k) {
    __syncthreads();
    const ssm::TileRows tr(k, L);
    const int len = tr.len;
    const size_t row0 = static_cast<size_t>(bi) * S + tr.row0;
    for (int idx = tid; idx < P * N; idx += kThreads)
      sts[static_cast<size_t>(k) * P * N + idx] = st[(idx / N) * NP + idx % N];
    if (k == nt - 1) break;
    for (int idx = tid; idx < len * P; idx += kThreads) {
      const int l = idx / P, pp = idx % P;
      xs[l * PP + pp] = to_f32(x[((row0 + l) * H + h) * P + pp]);
    }
    for (int idx = tid; idx < len * N; idx += kThreads) {
      const int l = idx / N, n = idx % N;
      bs[l * NP + n] = to_f32(b[(row0 + l) * N + n]);
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
    for (int l = tid; l < len; l += kThreads)
      u[l] = expf(seg[len - 1] - seg[l]) * dts[l];
    __syncthreads();
    const float dec = expf(seg[len - 1]);
    for (int idx = tid; idx < P * N; idx += kThreads) {
      const int pp = idx / N, n = idx % N;
      float acc = 0.f;
      for (int j = 0; j < len; ++j)
        acc = fmaf(xs[j * PP + pp] * u[j], bs[j * NP + n], acc);
      st[pp * NP + n] = dec * st[pp * NP + n] + acc;
    }
  }
  __syncthreads();  // pass 1's stores are visible to the whole block

  // ---- pass 2: the tiles in reverse --------------------------------------
  for (int idx = tid; idx < P * N; idx += kThreads)
    ds[(idx / N) * NP + idx % N] = 0.f;
  float da_acc = 0.f;  // thread 0's running sum of d a
  for (int k = nt - 1; k >= 0; --k) {
    __syncthreads();  // the last tile's reads of every buffer are done
    const ssm::TileRows tr(k, L);
    const int len = tr.len;
    const size_t row0 = static_cast<size_t>(bi) * S + tr.row0;
    for (int idx = tid; idx < len * P; idx += kThreads) {
      const int l = idx / P, pp = idx % P;
      const size_t g = ((row0 + l) * H + h) * P + pp;
      xs[l * PP + pp] = to_f32(x[g]);
      dys[l * PP + pp] = to_f32(dy[g]);
    }
    for (int idx = tid; idx < len * N; idx += kThreads) {
      const int l = idx / N, n = idx % N;
      bs[l * NP + n] = to_f32(b[(row0 + l) * N + n]);
      cs[l * NP + n] = to_f32(c[(row0 + l) * N + n]);
    }
    for (int idx = tid; idx < P * N; idx += kThreads)
      st[(idx / N) * NP + idx % N] = sts[static_cast<size_t>(k) * P * N + idx];
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
    for (int l = tid; l < len; l += kThreads) {
      ex[l] = expf(seg[l]);
      u[l] = expf(seg_last - seg[l]) * dts[l];
    }
    // Q and A over the lower triangle
    for (int idx = tid; idx < len * len; idx += kThreads) {
      const int i = idx / len, j = idx % len;
      float qv = 0.f, av = 0.f;
      if (j <= i) {
        for (int n = 0; n < N; ++n) qv = fmaf(cs[i * NP + n], bs[j * NP + n], qv);
        qv *= expf(seg[i] - seg[j]);
        for (int pp = 0; pp < P; ++pp)
          av = fmaf(dys[i * PP + pp], xs[j * PP + pp], av);
      }
      qm[i * LP + j] = qv;
      am[i * LP + j] = av;
    }
    __syncthreads();
    // row sums (d seg_i) and column sums (d dt_j, d seg_j) of A Q
    if (tid < len) {
      const int i = tid;
      float r = 0.f;
      for (int j = 0; j <= i; ++j) r = fmaf(am[i * LP + j] * qm[i * LP + j], dts[j], r);
      dseg[i] = r;
    } else if (tid < 2 * len) {
      const int j = tid - len;
      float r = 0.f;
      for (int i = j; i < len; ++i) r = fmaf(am[i * LP + j], qm[i * LP + j], r);
      cg[j] = r;
    }
    __syncthreads();
    for (int idx = tid; idx < len * len; idx += kThreads) {
      const int i = idx / len, j = idx % len;
      if (j <= i) {
        am[i * LP + j] *= expf(seg[i] - seg[j]) * dts[j];
        qm[i * LP + j] *= dts[j];
      }
    }
    __syncthreads();
    // dc (a warp per row i, lanes over n) and its share of d seg_i
    for (int i = warp; i < len; i += kWarps) {
      float part = 0.f;
      for (int n = lane; n < N; n += 32) {
        float intra = 0.f;
        for (int j = 0; j <= i; ++j) intra = fmaf(am[i * LP + j], bs[j * NP + n], intra);
        float inter = 0.f;
        for (int pp = 0; pp < P; ++pp)
          inter = fmaf(dys[i * PP + pp], st[pp * NP + n], inter);
        inter *= ex[i];
        atomicAdd(dc + (row0 + i) * N + n, intra + inter);
        part = fmaf(cs[i * NP + n], inter, part);
      }
      part = warp_sum(part);
      if (lane == 0) dseg[i] += part;
    }
    // db (a warp per row j, lanes over n) and d dt_j from the leaving state
    for (int j = warp; j < len; j += kWarps) {
      float part = 0.f;
      for (int n = lane; n < N; n += 32) {
        float intra = 0.f;
        for (int i = j; i < len; ++i) intra = fmaf(am[i * LP + j], cs[i * NP + n], intra);
        float tn = 0.f;
        for (int pp = 0; pp < P; ++pp)
          tn = fmaf(ds[pp * NP + n], xs[j * PP + pp], tn);
        atomicAdd(db + (row0 + j) * N + n, intra + u[j] * tn);
        part = fmaf(bs[j * NP + n], tn, part);
      }
      part = warp_sum(part);
      if (lane == 0) {
        const float sj = part * expf(seg_last - seg[j]);
        sv[j] = sj;
        kv[j] = sj * dts[j];
      }
    }
    // dx (a warp per row j, lanes over p)
    for (int j = warp; j < len; j += kWarps) {
      for (int pp = lane; pp < P; pp += 32) {
        float intra = 0.f;
        for (int i = j; i < len; ++i) intra = fmaf(qm[i * LP + j], dys[i * PP + pp], intra);
        float inter = 0.f;
        for (int n = 0; n < N; ++n) inter = fmaf(ds[pp * NP + n], bs[j * NP + n], inter);
        store(dx + ((row0 + j) * H + h) * P + pp, intra + u[j] * inter);
      }
    }
    // sum of dstate * state (d seg_L through exp(seg_L) state)
    {
      float part = 0.f;
      for (int idx = tid; idx < P * N; idx += kThreads) {
        const int o = (idx / N) * NP + idx % N;
        part = fmaf(ds[o], st[o], part);
      }
      part = warp_sum(part);
      if (lane == 0) red[warp] = part;
    }
    __syncthreads();
    // dstate of the entering state
    const float dec = ex[len - 1];
    for (int idx = tid; idx < P * N; idx += kThreads) {
      const int pp = idx / N, n = idx % N;
      float acc = 0.f;
      for (int i = 0; i < len; ++i)
        acc = fmaf(ex[i] * dys[i * PP + pp], cs[i * NP + n], acc);
      ds[pp * NP + n] = dec * ds[pp * NP + n] + acc;
    }
    // d seg -> d dta by a reverse cumulative sum -> ddt and d a
    if (tid == 0) {
      float tot = 0.f;
      for (int w = 0; w < kWarps; ++w) tot += red[w];
      float last = dec * tot;
      for (int j = 0; j < len; ++j) last += kv[j];
      float run = 0.f;
      for (int j = len - 1; j >= 0; --j) {
        float g = dseg[j] - cg[j] * dts[j] - kv[j];
        if (j == len - 1) g += last;
        run += g;
        ddt[(row0 + j) * H + h] = cg[j] + sv[j] + a * run;
        da_acc = fmaf(run, dts[j], da_acc);
      }
    }
  }
  if (tid == 0) atomicAdd(da + h, da_acc * a);  // d a_log = d a * a
}

__global__ void __launch_bounds__(kThreads)
f32_to_bf16_kernel(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst,
                   long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       e < n; e += stride)
    dst[e] = __float2bfloat16_rn(src[e]);
}

int cast_to_bf16(const float* src, void* dst, long long n,
                 cudaStream_t stream) {
  const long long want = (n + kThreads - 1) / kThreads;
  f32_to_bf16_kernel<<<static_cast<unsigned>(want < 132 * 16 ? want
                                                            : 132 * 16),
                       kThreads, 0, stream>>>(
      src, static_cast<__nv_bfloat16*>(dst), n);
  return static_cast<int>(cudaGetLastError());
}

// ---- bfloat16: chunk-parallel stages on the tensor cores ----------------

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// stage (c')'s shared memory: the x, dy, b and c tiles, D_out or S_in as
// two bf16 tiles (rows p, columns n), Am^T as two bf16 tiles, the
// mbarrier, 7 per-row vectors, 4 per-warp partial rows and 8 floats
template <int P, int N>
constexpr size_t grads_smem_bytes() {
  return 2 * tc::Tile<P>::kBytes + 4 * tc::Tile<N>::kBytes +
         2 * tc::Tile<64>::kBytes + 8 + 11 * ssm::kRows * 4 + 8 * 4 +
         1024;  // + 1 KB to align
}

// Stage (c'); grid (n_tiles, H, B), one warpgroup.  With the tile's rows
// j (and i), Q = C B^T, A = dY X^T, decay_ij = exp(seg_i - seg_j) for
// j <= i < len (else 0), Am = A decay dt_j, Qm = Q decay dt_j, u and
// ex = exp(seg) as in stage (a), S_in and D_out from stage (b):
//   dx_j = u_j (B D_out^T)_j + sum_i Qm_ij dy_i
//   db_j = u_j (X D_out)_j + sum_i Am_ij c_i        (added over heads)
//   dc_i = ex_i (dY S_in)_i + sum_j Am_ij b_j       (added over heads)
//   d seg_i = sum_j A_ij Q_ij decay_ij dt_j + ex_i c_i . (dY S_in)_i
//   ddt_j (direct) = sum_i A_ij Q_ij decay_ij + sv_j,
//     sv_j = exp(seg_last - seg_j) x_j . (B D_out^T)_j,
//   d seg_j -= (sum_i A_ij Q_ij decay_ij + sv_j) dt_j,
//   d seg_last += exp(seg_last) sum(D_out S_in) + sum_j sv_j dt_j,
// then ddt = direct + a (reverse cumulative sum of d seg) and d a_log =
// a sum_j dt_j (that sum).  Q^T = B C^T and A^T = X dY^T are wgmma from
// shared memory (j in rows), so Qm^T and Am^T sit in the accumulator
// layout and become the register A operands (two bf16 parts) of
// Qm^T dY and Am^T C; Am^T is also written to shared memory, where
// dc's Am B reads it transposed.  B D_out^T, X D_out and dY S_in take the
// float32 states as two bf16 tiles; the row scales by u and ex are
// applied to the accumulator between its two products.
template <int P, int N>
__global__ void __launch_bounds__(ssm::kThreads)
chunk_grads_kernel(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_dy,
                   const __grid_constant__ CUtensorMap tm_b,
                   const __grid_constant__ CUtensorMap tm_c,
                   const float* __restrict__ dt,
                   const float* __restrict__ a_log,
                   const float* __restrict__ s_in,
                   const float* __restrict__ d_out,
                   __nv_bfloat16* __restrict__ dx, float* __restrict__ ddt,
                   float* __restrict__ da, float* __restrict__ db_acc,
                   float* __restrict__ dc_acc, int S, int H, int L) {
  using TileX = tc::Tile<P>;
  using TileN = tc::Tile<N>;
  using TileA = tc::Tile<64>;
  constexpr int kRows = ssm::kRows;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t x_s = tc::align1024(smem_raw);
  const uint32_t dy_s = x_s + TileX::kBytes;
  const uint32_t b_s = dy_s + TileX::kBytes;
  const uint32_t c_s = b_s + TileN::kBytes;
  const uint32_t hi_s = c_s + TileN::kBytes;
  const uint32_t lo_s = hi_s + TileN::kBytes;
  const uint32_t amh_s = lo_s + TileN::kBytes;
  const uint32_t aml_s = amh_s + TileA::kBytes;
  const uint32_t bar = aml_s + TileA::kBytes;
  uint8_t* gen = smem_raw + (x_s - tc::smem_u32(smem_raw));
  float* dt_s = reinterpret_cast<float*>(gen + (bar + 8 - x_s));
  float* seg_s = dt_s + kRows;
  float* ex_s = seg_s + kRows;
  float* u_s = ex_s + kRows;
  float* sv_s = u_s + kRows;
  float* ev_s = sv_s + kRows;   // ex_i c_i . (dY S_in)_i
  float* cg_s = ev_s + kRows;   // sum_i A_ij Q_ij decay_ij
  float* rw = cg_s + kRows;     // per warp: sum_j A_ij Q_ij decay_ij dt_j
  float* tmp = rw + 4 * kRows;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tau = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nt = gridDim.x;
  const ssm::TileRows tr(tau, L);
  if (tid == 0) {
    tc::mbar_init(bar, 1);
    tc::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    tc::mbar_expect_tx(bar, 2 * TileX::kBytes + 2 * TileN::kBytes);
    TileX::load_4d(x_s, &tm_x, bar, tr.row0, b, h);
    TileX::load_4d(dy_s, &tm_dy, bar, tr.row0, b, h);
    TileN::load(b_s, &tm_b, bar, tr.row0, b);
    TileN::load(c_s, &tm_c, bar, tr.row0, b);
  }
  const size_t bt = static_cast<size_t>(b) * H + h;
  const size_t tile = (bt * nt + tau) * P * N;
  ssm::stage_split<P, N>(d_out + tile, nullptr, gen + (hi_s - x_s),
                         gen + (lo_s - x_s));
  tc::fence_proxy_async();
  const float a = -expf(a_log[h]);
  const size_t first = (static_cast<size_t>(b) * S + tr.row0) * H + h;
  ssm::tile_seg(dt, first, H, tr.len, a, dt_s, seg_s, tmp);
  const float seg_last = seg_s[kRows - 1];
  if (tid < kRows) {
    ex_s[tid] = tid < tr.len ? expf(seg_s[tid]) : 0.f;
    u_s[tid] = expf(seg_last - seg_s[tid]) * dt_s[tid];
  }
  __syncthreads();
  tc::mbar_wait(bar, 0);

  // Q^T = B C^T, A^T = X dY^T (rows j, columns i) and B D_out^T
  float q[32], at[32], ax[P / 2];
  tc::wg_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    tc::Wgmma<64>::ss<0, 0>(q, TileN::kmajor(b_s, kk),
                            TileN::kmajor(c_s, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < P / 16; ++kk)
    tc::Wgmma<64>::ss<0, 0>(at, TileX::kmajor(x_s, kk),
                            TileX::kmajor(dy_s, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    tc::Wgmma<P>::template ss<0, 0>(ax, TileN::kmajor(b_s, kk),
                                    TileN::kmajor(hi_s, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    tc::Wgmma<P>::template ss<0, 0>(ax, TileN::kmajor(b_s, kk),
                                    TileN::kmajor(lo_s, kk), 1);
  tc::wg_commit();
  tc::wg_wait<0>();
  tc::fence_operand(q);
  tc::fence_operand(at);
  tc::fence_operand(ax);

  // this thread's rows (r0, r0 + 8) and first column of each 8-column
  // block of a fragment (hopper_tc.cuh)
  const int r0 = warp * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  float cg_part[2] = {0.f, 0.f}, rsum[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) rsum[t] = 0.f;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * jj + 2 * i + e;
        const int row = r0 + 8 * i, col = 8 * jj + c0 + e;
        const float dec = row <= col && col < tr.len
                              ? expf(seg_s[col] - seg_s[row]) : 0.f;
        const float qv = q[x] * dec;
        const float prod = at[x] * qv;
        cg_part[i] += prod;
        rsum[2 * jj + e] = fmaf(prod, dt_s[row], rsum[2 * jj + e]);
        q[x] = qv * dt_s[row];            // Qm^T
        at[x] = at[x] * dec * dt_s[row];  // Am^T
      }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float v = quad_sum(cg_part[i]);
    if ((lane & 3) == 0) cg_s[r0 + 8 * i] = v;
  }
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    float v = rsum[t];
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    if (lane < 4) rw[warp * kRows + 8 * (t >> 1) + c0 + (t & 1)] = v;
  }
  // A fragments of Qm^T and Am^T (K = i), and Am^T to shared memory
  uint32_t qhi[4][4], qlo[4][4], ahi[4][4], alo[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      ssm::split2(q[8 * kk + 2 * x], q[8 * kk + 2 * x + 1], qhi[kk][x],
                  qlo[kk][x]);
      ssm::split2(at[8 * kk + 2 * x], at[8 * kk + 2 * x + 1], ahi[kk][x],
                  alo[kk][x]);
      const uint32_t off =
          TileA::offset(r0 + 8 * (x & 1), 16 * kk + 8 * (x >> 1) + c0);
      tc::st_shared_b32(amh_s + off, ahi[kk][x]);
      tc::st_shared_b32(aml_s + off, alo[kk][x]);
    }
  tc::fence_proxy_async();

  // dx: sv_j from B D_out^T, then u_j (B D_out^T)_j + Qm^T dY
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    float part = 0.f;
#pragma unroll
    for (int jj = 0; jj < P / 8; ++jj) {
      const int col = 8 * jj + c0;
      part = fmaf(ssm::tile_at<P>(gen, row, col), ax[4 * jj + 2 * i], part);
      part = fmaf(ssm::tile_at<P>(gen, row, col + 1), ax[4 * jj + 2 * i + 1],
                  part);
    }
    part = quad_sum(part);
    if ((lane & 3) == 0) sv_s[row] = expf(seg_last - seg_s[row]) * part;
    const float uj = u_s[row];
#pragma unroll
    for (int jj = 0; jj < P / 8; ++jj) {
      ax[4 * jj + 2 * i] *= uj;
      ax[4 * jj + 2 * i + 1] *= uj;
    }
  }
  tc::wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    tc::Wgmma<P>::template rs<1>(ax, qhi[kk], TileX::mnmajor(dy_s, kk), 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    tc::Wgmma<P>::template rs<1>(ax, qlo[kk], TileX::mnmajor(dy_s, kk), 1);
  tc::wg_commit();
  tc::wg_wait<0>();
  tc::fence_operand(ax);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= tr.len) continue;
    __nv_bfloat16* dst =
        dx + ((static_cast<size_t>(b) * S + tr.row0 + row) * H + h) * P + c0;
#pragma unroll
    for (int jj = 0; jj < P / 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * jj) =
          __floats2bfloat162_rn(ax[4 * jj + 2 * i], ax[4 * jj + 2 * i + 1]);
  }

  // adds the rows below len of a (64, N) fragment to acc (B, S, N)
  auto add_rows = [&](float* dst_acc, const float (&v)[N / 2]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 8 * i;
      if (row >= tr.len) continue;
      float* dst =
          dst_acc + (static_cast<size_t>(b) * S + tr.row0 + row) * N + c0;
#pragma unroll
      for (int jj = 0; jj < N / 8; ++jj)
        atomicAdd(reinterpret_cast<float2*>(dst + 8 * jj),
                  make_float2(v[4 * jj + 2 * i], v[4 * jj + 2 * i + 1]));
    }
  };
  // scales the rows of a (64, N) fragment by vec
  auto scale_rows = [&](float (&v)[N / 2], const float* vec) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float f = vec[r0 + 8 * i];
#pragma unroll
      for (int jj = 0; jj < N / 8; ++jj) {
        v[4 * jj + 2 * i] *= f;
        v[4 * jj + 2 * i + 1] *= f;
      }
    }
  };

  // db: u_j (X D_out)_j + Am^T C
  float acc[N / 2];
  tc::wg_fence();
#pragma unroll
  for (int kk = 0; kk < P / 16; ++kk)
    tc::Wgmma<N>::template ss<0, 1>(acc, TileX::kmajor(x_s, kk),
                                    TileN::mnmajor(hi_s, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < P / 16; ++kk)
    tc::Wgmma<N>::template ss<0, 1>(acc, TileX::kmajor(x_s, kk),
                                    TileN::mnmajor(lo_s, kk), 1);
  tc::wg_commit();
  tc::wg_wait<0>();
  tc::fence_operand(acc);
  scale_rows(acc, u_s);
  tc::wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    tc::Wgmma<N>::template rs<1>(acc, ahi[kk], TileN::mnmajor(c_s, kk), 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    tc::Wgmma<N>::template rs<1>(acc, alo[kk], TileN::mnmajor(c_s, kk), 1);
  tc::wg_commit();
  tc::wg_wait<0>();
  tc::fence_operand(acc);
  add_rows(db_acc, acc);

  // S_in replaces D_out in shared memory; sum(D_out S_in) on the way
  __syncthreads();
  float dot = ssm::stage_split<P, N>(s_in + tile, d_out + tile,
                                     gen + (hi_s - x_s), gen + (lo_s - x_s));
  tc::fence_proxy_async();
  for (int s = 16; s > 0; s >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, s);
  if (lane == 0) tmp[warp] = dot;
  __syncthreads();

  // dc: ex_i (dY S_in)_i + Am B, and ex_i c_i . (dY S_in)_i
  tc::wg_fence();
#pragma unroll
  for (int kk = 0; kk < P / 16; ++kk)
    tc::Wgmma<N>::template ss<0, 1>(acc, TileX::kmajor(dy_s, kk),
                                    TileN::mnmajor(hi_s, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < P / 16; ++kk)
    tc::Wgmma<N>::template ss<0, 1>(acc, TileX::kmajor(dy_s, kk),
                                    TileN::mnmajor(lo_s, kk), 1);
  tc::wg_commit();
  tc::wg_wait<0>();
  tc::fence_operand(acc);
  const uint8_t* c_gen = gen + (c_s - x_s);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    float part = 0.f;
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj) {
      const int col = 8 * jj + c0;
      part = fmaf(ssm::tile_at<N>(c_gen, row, col), acc[4 * jj + 2 * i], part);
      part = fmaf(ssm::tile_at<N>(c_gen, row, col + 1),
                  acc[4 * jj + 2 * i + 1], part);
    }
    part = quad_sum(part);
    if ((lane & 3) == 0) ev_s[row] = ex_s[row] * part;
  }
  scale_rows(acc, ex_s);
  tc::wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    tc::Wgmma<N>::template ss<1, 1>(acc, TileA::mnmajor(amh_s, kk),
                                    TileN::mnmajor(b_s, kk), 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    tc::Wgmma<N>::template ss<1, 1>(acc, TileA::mnmajor(aml_s, kk),
                                    TileN::mnmajor(b_s, kk), 1);
  tc::wg_commit();
  tc::wg_wait<0>();
  tc::fence_operand(acc);
  add_rows(dc_acc, acc);
  __syncthreads();  // sv, ev, cg and rw are whole

  // d seg -> ddt and d a by a reverse cumulative sum (warps 0 and 1)
  float run = 0.f, kv = 0.f, g = 0.f;
  const int j = tid;
  if (tid < kRows) {
    const float dseg = rw[j] + rw[kRows + j] + rw[2 * kRows + j] +
                       rw[3 * kRows + j] + ev_s[j];
    kv = sv_s[j] * dt_s[j];
    g = dseg - cg_s[j] * dt_s[j] - kv;
    float ks = kv;
    for (int s = 16; s > 0; s >>= 1) ks += __shfl_xor_sync(0xffffffffu, ks, s);
    if (lane == 0) tmp[4 + warp] = ks;
  }
  __syncthreads();
  if (tid < kRows) {
    const float tot = tmp[0] + tmp[1] + tmp[2] + tmp[3];
    if (j == tr.len - 1) g += expf(seg_last) * tot + tmp[4] + tmp[5];
    run = g;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const float o = __shfl_down_sync(0xffffffffu, run, s);
      if (lane + s < 32) run += o;
    }
    if (tid == 32) tmp[6] = run;  // the sum over rows 32..63
  }
  __syncthreads();
  if (tid < kRows) {
    if (warp == 0) run += tmp[6];
    if (j < tr.len) ddt[first + static_cast<size_t>(j) * H] =
        cg_s[j] + sv_s[j] + a * run;
    float part = run * dt_s[j];
    for (int s = 16; s > 0; s >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, s);
    if (lane == 0) atomicAdd(da + h, part * a);  // d a_log = d a * a
  }
}

struct BackwardTc {
  const void *x, *b, *c, *dy;
  const float *dt, *a_log;
  void* dx;
  float *ddt, *da, *db_acc, *dc_acc, *states, *d_states, *decay;
  int B, S, H, L;
  cudaStream_t stream;

  template <int P, int N>
  cudaError_t run() const {
    CUtensorMap tm_x, tm_dy, tm_b, tm_c;
    cudaError_t e = tc::make_map_4d(&tm_x, x, B, S, H, P);
    if (e == cudaSuccess) e = tc::make_map_4d(&tm_dy, dy, B, S, H, P);
    if (e == cudaSuccess) e = tc::make_map(&tm_b, b, B, S, N);
    if (e == cudaSuccess) e = tc::make_map(&tm_c, c, B, S, N);
    if (e != cudaSuccess) return e;
    const int nt = ssm::n_tiles(S, L);
    // (a), (b): the state entering each tile
    e = ssm::launch_states<P, N>(tm_x, tm_b, dt, a_log, states, decay, B, S,
                                 H, L, nt, 0, stream);
    if (e == cudaSuccess)
      e = ssm::launch_pass(states, decay, B * H, nt, P * N, 0, stream);
    // (a'), (b'): the gradient of the state leaving each tile
    if (e == cudaSuccess)
      e = ssm::launch_states<P, N>(tm_dy, tm_c, dt, a_log, d_states, decay,
                                   B, S, H, L, nt, 1, stream);
    if (e == cudaSuccess)
      e = ssm::launch_pass(d_states, decay, B * H, nt, P * N, 1, stream);
    if (e != cudaSuccess) return e;
    // (c')
    constexpr size_t smem = grads_smem_bytes<P, N>();
    e = cudaFuncSetAttribute(chunk_grads_kernel<P, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    chunk_grads_kernel<P, N><<<dim3(nt, H, B), ssm::kThreads, smem,
                               stream>>>(
        tm_x, tm_dy, tm_b, tm_c, dt, a_log, states, d_states,
        static_cast<__nv_bfloat16*>(dx), ddt, da, db_acc, dc_acc, S, H, L);
    return cudaGetLastError();
  }
};

// ---- float32: the CUDA cores ----------------------------------------------

template <typename T>
int launch_bwd(const void* x, const float* dt, const float* a_log,
               const void* b, const void* c, const void* dy, void* dx,
               float* ddt, float* da, void* db, void* dc, float* db_acc,
               float* dc_acc, float* states, int B, int S, int H, int P,
               int N, int L, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(L < ssm::kRows ? L : ssm::kRows, P, N);
  cudaError_t e = cudaFuncSetAttribute(
      ssm_scan_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  ssm_scan_bwd_kernel<T><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, a_log, static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const T*>(dy),
      static_cast<T*>(dx), ddt, da, db_acc, dc_acc, states, S, H, P, N, L);
  e = cudaGetLastError();
  if (e != cudaSuccess || static_cast<void*>(db_acc) == db)
    return static_cast<int>(e);
  // bfloat16 inputs
  const long long n = static_cast<long long>(B) * S * N;
  const int rc = cast_to_bf16(db_acc, db, n, stream);
  return rc != 0 ? rc : cast_to_bf16(dc_acc, dc, n, stream);
}

}  // namespace

extern "C" {

// The gradients of ssm_scan_launch's y for the output gradient dy (as
// x): dx (as x), ddt (B, S, H) float32, da (H,) float32, db and dc
// (B, S, N) as b.  da, and db_acc and dc_acc ((B, S, N) float32), must be
// zero on entry; for float32 inputs db_acc and dc_acc may be db and dc
// themselves.  bfloat16: the tensor cores, with ssm_scan_launch's limits
// on P, N and L and its alignment; states and d_states (B H, n_tiles, P,
// N) and decay (B H, n_tiles) float32 are scratch.  float32: the CUDA
// cores; states (B H, n_tiles, P, N) float32 is scratch, d_states and
// decay are unused.
int ssm_scan_bwd_launch(const void* x, const float* dt, const float* a_log,
                        const void* b, const void* c, const void* dy,
                        void* dx, float* ddt, float* da, void* db, void* dc,
                        float* db_acc, float* dc_acc, float* states,
                        float* d_states, float* decay, int B, int S, int H,
                        int P, int N, int L, int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  if (L <= 0 || S % L != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return launch_bwd<float>(x, dt, a_log, b, c, dy, dx, ddt, da, db, dc,
                             db_acc, dc_acc, states, B, S, H, P, N, L, st);
  const BackwardTc f{x,      b,        c,     dy,     dt, a_log, dx,
                     ddt,    da,       db_acc, dc_acc, states, d_states,
                     decay,  B,        S,     H,      L,  st};
  cudaError_t e = ssm::dispatch(P, N, f);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n = static_cast<long long>(B) * S * N;
  const int rc = cast_to_bf16(db_acc, db, n, st);
  return rc != 0 ? rc : cast_to_bf16(dc_acc, dc, n, st);
}

const char* ssm_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
