// Blocked online-softmax attention forward (flash), for Hopper.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas (the
// Pallas TPU kernel).  It computes what the plain version,
// repro_torch/kernels/ref.py::flash_attention_ref (a port of
// repro/kernels/ref.py::flash_attention_ref), computes:
//   out = softmax(q k^T / sqrt(D), masked) v
// for q (BH, S, D) and k, v (BH, T, D), equal head counts (the caller
// expands GQA), D in {16, 32, 64, 128}.  With `causal`, key j is visible
// to query i iff j <= i + (T - S); a hidden score is set to -1e30, not
// -inf, so a row that sees no key averages every key, as the reference
// does.  Ragged S and T: missing keys get no weight, missing query rows
// are not stored.  m, l and the accumulator are float32; the output is
// acc / max(l, 1e-30) in the input type (float32 or bfloat16; in bfloat16
// each weight is divided by l before the product, as below).  When asked
// (lse non-null) it also writes the row log-sum-exp of the scaled scores,
// m + log(max(l, 1e-30)), float32.
//
// Two kernels, chosen by the dtype at dispatch:
//
// bfloat16: the tensor cores (flash_fwd_tc_kernel).  One block per (bh,
// 128 query rows): two warpgroups of 128 threads, 64 rows each, sharing
// the key and value tiles (which halves their traffic from L2, the limit
// with one warpgroup a block).  The two Q tiles arrive once by TMA; the K
// (and V) tiles of 64 keys go through a 2-stage ring in shared memory,
// loaded by TMA and signalled by mbarriers (hopper_tc.cuh), the load of
// step i + 2 issued as soon as both warpgroups have consumed step i.
// S = Q K^T is wgmma m64n64k16 with both operands in shared memory (K's
// rows are the K-major B operand).  The softmax rounds where the
// reference does, so two passes walk the key tiles: the first takes the
// row max and sum online from the bf16-rounded scores (K only; a row's 64
// columns lie in the 4 threads of a quad: the max is two shuffles, the
// sum is kept per thread and reduced once); the second recomputes S,
// forms the weights exp(s - m) / l, rounds them to bf16 in registers and
// uses them as wgmma's A operand from registers for O += W V, with V the
// MN-major B operand from shared memory.  (One online pass that rounds
// the unnormalised P instead is twice as fast but rounds elsewhere than
// the reference: reduced Jamba's training loss, whose top-2 routing turns
// on last bits, then moved 7e-4 from the CPU's, beyond chip_smoke.py
// phase 16's 2e-4.)  Under `causal` the tiles past the diagonal are not
// visited (a warpgroup whose rows see none of a tile skips it) and only
// the tiles that cross it (or the ragged last key tile) are masked; rows
// that see no key visit every key tile.  TMA zero-fills rows past S or T.
// The heaviest causal tiles (the last query rows) are scheduled first.
// Shared memory: 6 tiles (two Q, two K, two V), 96 KB at D 128; two
// blocks per SM.
//
// float32: the CUDA cores (flash_fwd_kernel): one block of 256 threads per
// (bh, 64-row query tile); the query tile staged in shared memory as
// float32, the key tiles walked in order (K transposed, V), m, l and the
// (64 x D) accumulator in registers, thread (ty, tx) of the 16 x 16 grid
// owning query rows ty + 16 i (i < 4), score columns tx + 16 j (j < 4) and
// output columns tx + 16 c; the row max and sum reduced over a half warp;
// the same causal stop and ragged-edge masking; the output acc / max(l,
// 1e-30).  TF32 could not meet float32's 2e-5.
//
// What bounds it on an H100: at the serving path's shapes (B 4, H 32,
// S = T = 512, D 128, bf16, causal) the function needs 8.6e9 flops (8.7 us
// on the tensor cores) and moves 67.1 MB (20 us at 3.35 TB/s), so the
// bound is the bytes; at the training path's (starcoder2-15b: B 4, H 48,
// S = T = 2048) it needs 2.06e11 flops (0.21 ms), so the operations.
// The bf16 kernel computes S twice, waits for each product before it goes
// on and keeps the tensor cores busy only through the other warpgroups on
// the SM (no producer warp, no ping-pong between softmax and products).
//
// Arithmetic: bf16 inputs; fp32 products and sums; q k^T rounded to bf16
// and the normalised weights rounded to bf16, where the reference's bf16
// einsums round them; exp2 of scores scaled by log2(e) / sqrt(D); the
// weights multiplied by 1 / l (an IEEE division took a quarter of the
// kernel's time, tools/flash_ab.py, and rounds to the same bf16 weights
// as torch's softmax as often).  Held to the plain version with
// tests/test_kernels.py's tolerances: 2e-5 (rtol and atol) in float32,
// 2e-2 in bfloat16.
//
// The launch uses the caller's stream, allocates nothing and returns
// cudaGetLastError() (or the tensor map's failure); the Python wrapper
// raises if it is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper_tc.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr float kMaskValue = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ float half_warp_max(float v) {
  for (int s = 8; s > 0; s >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
  for (int s = 8; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (D + 1)      // q tile, rows padded
                          + D * (kBK + 1)    // k tile, transposed, padded
                          + kBK * D          // v tile
                          + kBQ * (kBK + 1));  // probabilities
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int Tk, int causal,
                 float sm_scale) {
  constexpr int kQS = D + 1;    // q row stride
  constexpr int kKS = kBK + 1;  // k^T and p row stride
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* kt = qs + kBQ * kQS;
  float* vs = kt + D * kKS;
  float* ps = vs + kBK * D;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const size_t bh = blockIdx.x;
  // heaviest causal tiles (the last query rows) are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const T* qb = q + bh * S * D;
  const T* kb = k + bh * Tk * D;
  const T* vb = v + bh * Tk * D;
  const int off = Tk - S;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    qs[r * kQS + d] =
        q0 + r < S ? to_f32(qb[static_cast<size_t>(q0 + r) * D + d]) : 0.f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMaskValue;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  int k_end = Tk;
  if (causal && q0 + off >= 0) k_end = min(Tk, q0 + kBQ + off);

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the last tile's k, v and p are no longer read
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      const bool in = k0 + r < Tk;
      const size_t g = static_cast<size_t>(k0 + r) * D + d;
      kt[d * kKS + r] = in ? to_f32(kb[g]) : 0.f;
      vs[r * D + d] = in ? to_f32(vb[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * kQS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kt[d * kKS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float sv = s[i][j] * sm_scale;
        if (col >= Tk)
          sv = -INFINITY;  // no such key
        else if (causal && col > row + off)
          sv = kMaskValue;
        s[i][j] = sv;
        mx = fmaxf(mx, sv);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p =
            k0 + tx + 16 * j < Tk ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * kKS + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    const int kn = min(kBK, Tk - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty + 16 * i) * kKS + kk];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = o + (bh * S + row) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) store(orow + tx + 16 * c, acc[i][c] * inv_l);
    if (lse != nullptr && tx == 0)
      lse[bh * S + row] = m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

// ---- bfloat16: wgmma on TMA-fed tiles ------------------------------------

constexpr int kW = 2;  // warpgroups (64 query rows each) sharing K and V

// shared memory of the tensor-core kernel: the kW Q tiles, then K and V of
// stage 0, K and V of stage 1, then three mbarriers (Q, stage 0, stage 1)
template <int D>
constexpr size_t tc_smem_bytes() {
  return (kW + 4) * tc::Tile<D>::kBytes + 3 * 8 + 1024;  // + 1 KB to align
}

// two blocks per SM: at most 128 registers a thread (127 at D 128, no
// spill)
template <int D>
__global__ void __launch_bounds__(kW * tc::kWarpgroup, 2)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int S, int Tk, int causal, float scale_log2) {
  using Tile = tc::Tile<D>;
  constexpr int kR = D / 2;     // O accumulator floats a thread
  constexpr float kMask2 = kMaskValue * tc::kLog2e;  // -1e30 in log2 units
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_base = tc::align1024(smem_raw);
  const uint32_t bar_q = q_base + (kW + 4) * Tile::kBytes;
  auto k_s = [&](int st) { return q_base + (kW + 2 * st) * Tile::kBytes; };
  auto v_s = [&](int st) {
    return q_base + (kW + 1 + 2 * st) * Tile::kBytes;
  };
  auto bar_kv = [&](int st) { return bar_q + 8 * (1 + st); };

  const int tid = threadIdx.x;
  const int wg = tid / tc::kWarpgroup;
  const int bh = blockIdx.x;
  // heaviest causal tiles (the last query rows) are scheduled first
  const int q_block = (gridDim.y - 1 - blockIdx.y) * kW * kBQ;
  const int q0 = q_block + wg * kBQ;  // this warpgroup's rows
  const uint32_t q_s = q_base + wg * Tile::kBytes;
  const int off = Tk - S;
  // the key tiles that the 64 rows from qr on see (under `causal`, all of
  // them when a row sees no key; none for rows past S)
  auto key_tiles = [&](int qr) {
    if (qr >= S) return 0;
    const int end = causal && qr + off >= 0 ? min(Tk, qr + kBQ + off) : Tk;
    return (end + kBK - 1) / kBK;
  };
  const int my_tiles = key_tiles(q0);
  int n_tiles = 0;
  for (int w = 0; w < kW; ++w)
    n_tiles = max(n_tiles, key_tiles(q_block + w * kBQ));

  if (tid == 0) {
    tc::mbar_init(bar_q, 1);
    tc::mbar_init(bar_kv(0), 1);
    tc::mbar_init(bar_kv(1), 1);
    tc::fence_barrier_init();
  }
  __syncthreads();
  // step i < n_tiles reads key tile i for the row statistics (K only);
  // step n_tiles + n reads key tile n again, with V, for the output
  auto load_step = [&](int i) {
    const int st = i & 1;
    const bool with_v = i >= n_tiles;
    const int k0 = (with_v ? i - n_tiles : i) * kBK;
    tc::mbar_expect_tx(bar_kv(st), (with_v ? 2 : 1) * Tile::kBytes);
    Tile::load(k_s(st), &tm_k, bar_kv(st), k0, bh);
    if (with_v) Tile::load(v_s(st), &tm_v, bar_kv(st), k0, bh);
  };
  if (tid == 0) {
    tc::mbar_expect_tx(bar_q, kW * Tile::kBytes);
    for (int w = 0; w < kW; ++w)
      Tile::load(q_base + w * Tile::kBytes, &tm_q, bar_q, q_block + w * kBQ,
                 bh);
    for (int i = 0; i < 2 && i < 2 * n_tiles; ++i) load_step(i);
  }

  // this thread's rows (r0, r0 + 8) and first column of each 8-column
  // block of a fragment (hopper_tc.cuh)
  const int lane = tid & 31;
  const int r0 = ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);

  // the scores of key tile n (in stage st) in log2 units: q k^T rounded to
  // bf16 (where the reference's bf16 einsum rounds it), then scaled; in a
  // tile that crosses the diagonal or the ragged end of the keys, hidden
  // keys at kMask2 and keys past T at -inf
  auto scores = [&](float (&s)[32], int st, int n) {
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      tc::Wgmma<64>::ss<0, 0>(s, Tile::kmajor(q_s, kk),
                              Tile::kmajor(k_s(st), kk), kk > 0);
    tc::wg_commit();
    tc::wg_wait<0>();
    tc::fence_operand(s);
    const int k0 = n * kBK;
    const bool edge = k0 + kBK > Tk || (causal && k0 + kBK - 1 > q0 + off);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float t = tc::round_bf16(s[4 * j + 2 * i + e]) * scale_log2;
          if (edge) {
            const int col = k0 + 8 * j + c0 + e;
            if (col >= Tk)
              t = -INFINITY;  // no such key
            else if (causal && col > q0 + r0 + 8 * i + off)
              t = kMask2;
          }
          s[4 * j + 2 * i + e] = t;
        }
  };

  float m[2] = {kMask2, kMask2};  // row max, log2 units
  float l[2] = {0.f, 0.f};  // row sum (this thread's share until reduced)
  float inv_l[2];
  float acc[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) acc[i] = 0.f;

  tc::mbar_wait(bar_q, 0);
  for (int i = 0; i < 2 * n_tiles; ++i) {
    const int st = i & 1;
    const bool out_pass = i >= n_tiles;
    const int n = out_pass ? i - n_tiles : i;
    tc::mbar_wait(bar_kv(st), (i >> 1) & 1);
    if (i == n_tiles) {  // the statistics are whole: sum the quad's shares
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        inv_l[r] = 1.f / fmaxf(l[r], 1e-30f);
      }
    }
    if (n < my_tiles) {  // else no row of this warpgroup sees tile n
      float s[32];
      scores(s, st, n);
      if (!out_pass) {  // online row max and sum
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[r], mx);
          float rs = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            rs += exp2f(s[4 * j + 2 * r] - m_new) +
                  exp2f(s[4 * j + 2 * r + 1] - m_new);
          l[r] = l[r] * exp2f(m[r] - m_new) + rs;
          m[r] = m_new;
        }
      } else {
        // the softmax weights, normalised and then rounded to bf16 (as the
        // reference's are), as the A operand of the 4 k-steps over the keys
        uint32_t wa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int r = x & 1;
            wa[kk][x] = tc::pack_bf16(
                exp2f(s[8 * kk + 2 * x] - m[r]) * inv_l[r],
                exp2f(s[8 * kk + 2 * x + 1] - m[r]) * inv_l[r]);
          }
        tc::wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          tc::Wgmma<D>::template rs<1>(acc, wa[kk],
                                       Tile::mnmajor(v_s(st), kk), 1);
        tc::wg_commit();
        tc::wg_wait<0>();
        tc::fence_operand(acc);
      }
    }
    __syncthreads();  // every thread is done with stage st
    if (tid == 0 && i + 2 < 2 * n_tiles) load_step(i + 2);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* orow = o + (static_cast<size_t>(bh) * S + row) * D + c0;
#pragma unroll
    for (int j = 0; j < kR / 4; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    if (lse != nullptr && (lane & 3) == 0)
      lse[static_cast<size_t>(bh) * S + row] =
          m[r] * tc::kLn2 + logf(fmaxf(l[r], 1e-30f));
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* lse, int BH, int S, int Tk, int causal, float sm_scale,
              cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t e = tc::make_map(&tm_q, q, BH, S, D);
  if (e == cudaSuccess) e = tc::make_map(&tm_k, k, BH, Tk, D);
  if (e == cudaSuccess) e = tc::make_map(&tm_v, v, BH, Tk, D);
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr size_t smem = tc_smem_bytes<D>();
  e = cudaFuncSetAttribute(flash_fwd_tc_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(BH, (S + kW * kBQ - 1) / (kW * kBQ));
  flash_fwd_tc_kernel<D><<<grid, kW * tc::kWarpgroup, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse, S, Tk, causal,
      sm_scale * tc::kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// ---- float32: the CUDA cores ----------------------------------------------

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int BH, int S, int Tk, int causal, float sm_scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // above 48 KB a block's dynamic shared memory needs the opt-in (per
  // device, so it is set at every launch)
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(BH, (S + kBQ - 1) / kBQ);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, Tk, causal,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, int BH, int S, int Tk, int D, int causal,
             int is_bf16, float sm_scale, cudaStream_t stream) {
#define FLASH_FWD_CASE(DIM)                                                  \
  case DIM:                                                                  \
    return is_bf16 ? launch_tc<DIM>(q, k, v, o, lse, BH, S, Tk, causal,      \
                                    sm_scale, stream)                        \
                   : launch<float, DIM>(q, k, v, o, lse, BH, S, Tk, causal,  \
                                        sm_scale, stream);
  switch (D) {
    FLASH_FWD_CASE(16)
    FLASH_FWD_CASE(32)
    FLASH_FWD_CASE(64)
    FLASH_FWD_CASE(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_FWD_CASE
}

}  // namespace

extern "C" {

// q (BH, S, D), k and v (BH, T, D), o (BH, S, D): contiguous device
// pointers of one type, bfloat16 when is_bf16 is non-zero, else float32;
// bfloat16 ones 16-byte aligned (TMA).  D is 16, 32, 64 or 128.  lse, if
// not null, receives the (BH, S) float32 row log-sum-exp of the scaled
// scores.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, float* lse, int BH, int S, int T, int D,
                           int causal, int is_bf16, float sm_scale,
                           void* stream) {
  if (BH <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  return dispatch(q, k, v, o, lse, BH, S, T, D, causal, is_bf16, sm_scale,
                  static_cast<cudaStream_t>(stream));
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
