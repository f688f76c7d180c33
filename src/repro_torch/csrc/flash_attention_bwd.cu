// Blocked attention backward (FlashAttention-2), for Hopper.
//
// The backward of repro_torch/csrc/flash_attention.cu, the forward that
// replaces repro/kernels/flash_attention.py::flash_attention_pallas.  The
// Pallas kernel has no backward: the JAX package trains through its jnp
// attention (repro/models/layers.py::_sdpa).  This kernel gives the
// gradients of the function that the plain version
// repro_torch/kernels/ref.py::flash_attention_ref computes (softmax of
// q k^T / sqrt(D), hidden keys at -1e30, causal offset T - S, GQA
// expanded by the caller).
//
// Design (FlashAttention-2, arXiv:2307.08691): from q, k, v, the
// forward's output o and row log-sum-exp, and dO it gives dq, dk, dv of
// the function above.  A first kernel takes delta_i = sum_d dO_id o_id
// per row (one warp per row).  The main kernel runs one block per (bh,
// 64-key tile): K and V of the tile stay in shared memory and dK, dV in
// registers while the block walks the query tiles that can see a key of
// the tile.  For each it recomputes P = exp(s - lse) and dP = dO V^T,
// forms dS = P (dP - delta), adds P^T dO to dV and dS^T Q to dK, and adds
// dS K to a float32 dq buffer with atomics (blocks of other key tiles add
// to the same rows); a last kernel casts that buffer to bfloat16 where
// the inputs are bfloat16.  Hidden keys get no weight and no gradient, as
// the reference's masked_fill gives them; a row that sees no key (T < S)
// weighs every key by 1/T and passes no gradient to q or k.  Under
// `causal` the query tiles that see no key of the block's tile are
// skipped.  Two main kernels, chosen by the dtype at dispatch:
//
// bfloat16: the tensor cores (flash_bwd_tc_kernel, FlashAttention-3
// style).  One warpgroup of 128 threads.  K and V arrive once by TMA; the
// Q and dO tiles of 64 rows go through a 2-stage TMA ring (hopper_tc.cuh),
// the lse and delta rows of a tile are staged beside them by the threads.
// S^T = K Q^T and dP^T = V dO^T are wgmma m64n64k16 from shared memory;
// computing the transposes puts P^T and dS^T = P^T (dP^T - delta) in the
// accumulator layout of a key-row product, so both are rounded to bf16 in
// registers and are the A operands of dV += P^T dO and dK += dS^T Q, with
// dO and Q the MN-major B operands.  dS^T is also written to shared
// memory as bf16 (128-byte swizzle, by hand) and dQ = dS K is one more
// wgmma with A = dS read transposed from there and B = K, MN-major; each
// thread adds its dQ fragment to dq_acc with float2 atomics.  Registers
// at D 128: 64 + 64 floats for dK and dV, 32 + 32 for S^T and dP^T, then
// 64 for dQ; shared memory 104 KB (K, V, two Q and two dO tiles, dS), two
// blocks per SM.
//
// float32: the CUDA cores (flash_bwd_kernel): 256 threads, the tiles
// staged in float32 rows padded to D + 1, the five products as fp32 FMAs
// (one block per SM, 166 KB at D 128).  TF32 could not meet float32's 1e-5.
//
// What bounds it on an H100: at the training path's shapes (starcoder2-15b,
// B 4, H 48, S = T = 2048, D 128, bf16, causal) it needs 5 products of
// 2 D flops per visible (query, key) pair, 5.2e11 flops (0.52 ms on the
// tensor cores), and reads q, k, v, o, dO and writes dq, dk, dv (8 x
// 101 MB, 0.24 ms at 3.35 TB/s), so the bound is the operations.  The
// bf16 kernel waits for each product before the next, and its dq adds
// (4 B for every D-column product term, 3.3 GB at that shape) are what
// the L2 does slowest: without them it took about 2.3 of its 4.3 ms on
// an H100, and TMA's bulk reduce-add of whole dQ tiles took as long as
// the atomics.
//
// Arithmetic: float32 sums, exp2 of the scores in log2 units; in bf16, the
// scores round to bf16 (as the forward's do, so that P matches its row
// log-sum-exp), P to bf16 before P^T dO and dS before dS^T Q and dS K, as
// tests/test_torch_flash_tc_numerics.py emulates; the atomics add the dq
// contributions of the key tiles in an order that changes from run to
// run.  Held against autograd of the plain version, whose bf16 scores and
// probabilities round elsewhere, within 1e-5 of each gradient's largest
// magnitude in float32 and 2e-2 in bfloat16.
//
// The launches use the caller's stream, allocate nothing and return
// cudaGetLastError() (or a tensor map's failure); the Python wrapper
// raises if it is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper_tc.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // key rows per block
constexpr int kThreads = 256;  // 16 x 16

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// delta[r] = sum_d dout[r, d] o[r, d], one warp per row
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, long long rows, int D) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(to_f32(dout[row * D + d]), to_f32(o[row * D + d]), acc);
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) delta[row] = acc;
}

// row stride of a staged q, dO, k or v tile, in elements (float32 rows
// padded to an odd number of words, so 16 rows read at one column fall
// in 16 banks)
template <typename T, int D>
__host__ __device__ constexpr int tile_stride() {
  return D + 1;
}

template <typename T, int D>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (2 * kBQ * (kBK + 1)  // P, dS
                          + 2 * kBQ)           // lse, delta of the q tile
         + sizeof(T) * 4 * kBQ * tile_stride<T, D>();  // q, dO, k, v
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ lse,
                 const float* __restrict__ delta, const T* __restrict__ dout,
                 float* __restrict__ dq_acc, T* __restrict__ dk,
                 T* __restrict__ dv, int S, int Tk, int causal,
                 float sm_scale) {
  constexpr int kRS = tile_stride<T, D>();  // of the q, dO, k, v tiles
  constexpr int kPS = kBK + 1;  // row stride of P and dS
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* ps = smem;
  float* dss = ps + kBQ * kPS;
  float* lses = dss + kBQ * kPS;
  float* dels = lses + kBQ;
  T* qs = reinterpret_cast<T*>(dels + kBQ);
  T* dos = qs + kBQ * kRS;
  T* ks = dos + kBQ * kRS;
  T* vs = ks + kBK * kRS;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const size_t bh = blockIdx.x;
  const int k0 = blockIdx.y * kBK;
  const int off = Tk - S;
  const size_t qbase = bh * S * D;
  const size_t kbase = bh * Tk * D;
  const float inv_t = 1.f / static_cast<float>(Tk);

  for (int idx = tid; idx < kBK * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const bool in = k0 + r < Tk;
    const size_t g = kbase + static_cast<size_t>(k0 + r) * D + d;
    ks[r * kRS + d] = in ? k[g] : zero<T>();
    vs[r * kRS + d] = in ? v[g] : zero<T>();
  }

  // thread (ty, tx) owns key rows ty + 16 a and columns tx + 16 c of dK, dV
  float dk_acc[4][kCols], dv_acc[4][kCols];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;

  for (int q0 = 0; q0 < S; q0 += kBQ) {
    if (causal) {
      const int last = min(q0 + kBQ, S) - 1;
      // no row of this tile sees a key of this tile, and none sees no key
      if (q0 + off >= 0 && last + off < k0) continue;
    }
    __syncthreads();  // the last tile's q, dO, P and dS are no longer read
    for (int idx = tid; idx < kBQ * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      const bool in = q0 + r < S;
      const size_t g = qbase + static_cast<size_t>(q0 + r) * D + d;
      qs[r * kRS + d] = in ? q[g] : zero<T>();
      dos[r * kRS + d] = in ? dout[g] : zero<T>();
    }
    for (int r = tid; r < kBQ; r += kThreads) {
      const bool in = q0 + r < S;
      lses[r] = in ? lse[bh * S + q0 + r] : 0.f;
      dels[r] = in ? delta[bh * S + q0 + r] : 0.f;
    }
    __syncthreads();

    // s = q k^T and dp = dO v^T for query rows ty + 16 i, keys tx + 16 j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = to_f32(qs[(ty + 16 * i) * kRS + d]);
        dov[i] = to_f32(dos[(ty + 16 * i) * kRS + d]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = to_f32(ks[(tx + 16 * j) * kRS + d]);
        vv[j] = to_f32(vs[(tx + 16 * j) * kRS + d]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ri = ty + 16 * i;
      const int row = q0 + ri;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cj = tx + 16 * j;
        const int col = k0 + cj;
        float p = 0.f, ds = 0.f;
        if (row < S && col < Tk) {
          if (causal && row + off < 0) {
            p = inv_t;  // the row sees no key: every key weighs 1 / T
          } else if (!causal || col <= row + off) {
            p = expf(s[i][j] * sm_scale - lses[ri]);
            ds = p * (dp[i][j] - dels[ri]);
          }
        }
        ps[ri * kPS + cj] = p;
        dss[ri * kPS + cj] = ds;
      }
    }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q (key rows ty + 16 a, columns tx + 16 c)
    for (int r = 0; r < kBQ; ++r) {
      float pv[4], dsv[4], dov[kCols], qv[kCols];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        pv[a] = ps[r * kPS + ty + 16 * a];
        dsv[a] = dss[r * kPS + ty + 16 * a];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        dov[c] = to_f32(dos[r * kRS + tx + 16 * c]);
        qv[c] = to_f32(qs[r * kRS + tx + 16 * c]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          dv_acc[a][c] = fmaf(pv[a], dov[c], dv_acc[a][c]);
          dk_acc[a][c] = fmaf(dsv[a], qv[c], dk_acc[a][c]);
        }
    }

    // dq += dS K (query rows ty + 16 i, columns tx + 16 c), by atomics
    float dq[4][kCols];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) dq[i][c] = 0.f;
    for (int j = 0; j < kBK; ++j) {
      float dsv[4], kv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty + 16 * i) * kPS + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        kv[c] = to_f32(ks[j * kRS + tx + 16 * c]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) dq[i][c] = fmaf(dsv[i], kv[c], dq[i][c]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      if (row >= S) continue;
      float* dqrow = dq_acc + qbase + static_cast<size_t>(row) * D;
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        atomicAdd(dqrow + tx + 16 * c, dq[i][c] * sm_scale);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = k0 + ty + 16 * a;
    if (row >= Tk) continue;
    const size_t g = kbase + static_cast<size_t>(row) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dk[g + tx + 16 * c] = dk_acc[a][c] * sm_scale;
      dv[g + tx + 16 * c] = dv_acc[a][c];
    }
  }
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

// ---- bfloat16: wgmma on TMA-fed tiles ------------------------------------

// shared memory of the tensor-core kernel: K, V, then Q and dO of stage 0,
// Q and dO of stage 1, the dS^T tile (64 keys x 64 queries, bf16), the
// lse and delta rows of both stages (2 x 2 x 64 floats), then three
// mbarriers (K and V, stage 0, stage 1)
template <int D>
constexpr size_t tc_bwd_smem_bytes() {
  return 6 * tc::Tile<D>::kBytes + tc::Tile<64>::kBytes + 4 * kBQ * 4 +
         3 * 8 + 1024;  // + 1 KB to align
}

template <int D>
__global__ void __launch_bounds__(tc::kWarpgroup, 2)
flash_bwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    float* __restrict__ dq_acc,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int S, int Tk,
                    int causal, float sm_scale, float scale_log2) {
  using Tile = tc::Tile<D>;
  using DsTile = tc::Tile<64>;
  constexpr int kR = D / 2;  // dK, dV, dQ accumulator floats a thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t k_s = tc::align1024(smem_raw);
  const uint32_t v_s = k_s + Tile::kBytes;
  auto q_s = [&](int st) { return k_s + (2 + 2 * st) * Tile::kBytes; };
  auto do_s = [&](int st) { return k_s + (3 + 2 * st) * Tile::kBytes; };
  const uint32_t ds_s = k_s + 6 * Tile::kBytes;
  const uint32_t rows_s = ds_s + DsTile::kBytes;
  // rows[128 st + r]: lse (log2 units) of row r of stage st's tile;
  // rows[128 st + 64 + r]: its delta
  float* rows =
      reinterpret_cast<float*>(smem_raw + (rows_s - tc::smem_u32(smem_raw)));
  const uint32_t bar_kv = rows_s + 4 * kBQ * 4;
  auto bar_qdo = [&](int st) { return bar_kv + 8 * (1 + st); };

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBK;
  const int off = Tk - S;
  const int nq = (S + kBQ - 1) / kBQ;
  const float inv_t = 1.f / static_cast<float>(Tk);

  // the first query tile at or after qt that sees a key of this tile or
  // holds a row that sees no key
  auto next_visible = [&](int qt) {
    while (causal && qt < nq) {
      const int q0 = qt * kBQ;
      const int last = min(q0 + kBQ, S) - 1;
      if (q0 + off < 0 || last + off >= k0) break;
      ++qt;
    }
    return qt;
  };
  // this thread's lse (tid < 64) or delta value of row tid % 64 of tile qt
  auto row_value = [&](int qt) {
    const int q = qt * kBQ + (tid & (kBQ - 1));
    if (q >= S) return 0.f;
    const size_t g = static_cast<size_t>(bh) * S + q;
    return tid < kBQ ? lse[g] * tc::kLog2e : delta[g];
  };

  int qt = next_visible(0);
  int ahead = qt < nq ? next_visible(qt + 1) : nq;
  if (tid == 0) {
    tc::mbar_init(bar_kv, 1);
    tc::mbar_init(bar_qdo(0), 1);
    tc::mbar_init(bar_qdo(1), 1);
    tc::fence_barrier_init();
  }
  if (qt < nq) rows[tid] = row_value(qt);
  __syncthreads();
  if (tid == 0) {
    tc::mbar_expect_tx(bar_kv, 2 * Tile::kBytes);
    Tile::load(k_s, &tm_k, bar_kv, k0, bh);
    Tile::load(v_s, &tm_v, bar_kv, k0, bh);
    const int first[2] = {qt, ahead};
    for (int st = 0; st < 2; ++st) {
      if (first[st] >= nq) continue;
      tc::mbar_expect_tx(bar_qdo(st), 2 * Tile::kBytes);
      Tile::load(q_s(st), &tm_q, bar_qdo(st), first[st] * kBQ, bh);
      Tile::load(do_s(st), &tm_do, bar_qdo(st), first[st] * kBQ, bh);
    }
  }

  // this thread's key rows (r0, r0 + 8) and first column of each
  // 8-column block of a fragment (hopper_tc.cuh)
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  float dk_acc[kR], dv_acc[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  tc::mbar_wait(bar_kv, 0);
  for (int n = 0; qt < nq; ++n) {
    const int st = n & 1;
    const int q0 = qt * kBQ;
    const int after = ahead < nq ? next_visible(ahead + 1) : nq;
    const float ahead_row = ahead < nq ? row_value(ahead) : 0.f;
    tc::mbar_wait(bar_qdo(st), (n >> 1) & 1);

    // S^T = K Q^T and dP^T = V dO^T: keys in rows, queries in columns
    float s[32], dp[32];
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      tc::Wgmma<64>::ss<0, 0>(s, Tile::kmajor(k_s, kk),
                              Tile::kmajor(q_s(st), kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      tc::Wgmma<64>::ss<0, 0>(dp, Tile::kmajor(v_s, kk),
                              Tile::kmajor(do_s(st), kk), kk > 0);
    tc::wg_commit();
    tc::wg_wait<0>();
    tc::fence_operand(s);
    tc::fence_operand(dp);

    // P^T into s, dS^T into dp
    const float* lse_r = rows + 128 * st;
    const float* del_r = lse_r + kBQ;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * j + 2 * i + e;
          const int key = k0 + r0 + 8 * i;
          const int qi = 8 * j + c0 + e;
          const int q = q0 + qi;
          float p = 0.f, ds = 0.f;
          if (q < S && key < Tk) {
            if (causal && q + off < 0) {
              p = inv_t;  // the row sees no key: every key weighs 1 / T
            } else if (!causal || key <= q + off) {
              p = exp2f(tc::round_bf16(s[x]) * scale_log2 - lse_r[qi]);
              ds = p * (dp[x] - del_r[qi]);
            }
          }
          s[x] = p;
          dp[x] = ds;
        }

    // bf16 A fragments of P^T and dS^T for the 4 k-steps over the queries
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        pa[kk][x] = tc::pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
        da[kk][x] = tc::pack_bf16(dp[8 * kk + 2 * x], dp[8 * kk + 2 * x + 1]);
      }
    // dS^T to shared memory in the 128-byte swizzle: key row r, query
    // column c at byte r 128 + ((c / 8) ^ (r % 8)) 16 + (c % 8) 2
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int r = r0 + 8 * (x & 1);
        const int jc = 2 * kk + (x >> 1);
        tc::st_shared_b32(ds_s + r * 128 + ((jc ^ (r & 7)) << 4) + 2 * c0,
                          da[kk][x]);
      }
    tc::fence_proxy_async();

    // dV += P^T dO, dK += dS^T Q
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc::Wgmma<D>::template rs<1>(dv_acc, pa[kk],
                                   Tile::mnmajor(do_s(st), kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc::Wgmma<D>::template rs<1>(dk_acc, da[kk],
                                   Tile::mnmajor(q_s(st), kk), 1);
    tc::wg_commit();
    if (ahead < nq) rows[128 * (st ^ 1) + tid] = ahead_row;
    tc::wg_wait<0>();
    tc::fence_operand(dv_acc);
    tc::fence_operand(dk_acc);
    __syncthreads();  // dS^T is whole in shared memory

    // dQ = dS K: A = dS, read transposed from the dS^T tile
    float dq[kR];
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc::Wgmma<D>::template ss<1, 1>(dq, DsTile::mnmajor(ds_s, kk),
                                      Tile::mnmajor(k_s, kk), kk > 0);
    tc::wg_commit();
    tc::wg_wait<0>();
    tc::fence_operand(dq);
    __syncthreads();  // every thread is done with stage st and dS^T
    if (tid == 0 && after < nq) {
      tc::mbar_expect_tx(bar_qdo(st), 2 * Tile::kBytes);
      Tile::load(q_s(st), &tm_q, bar_qdo(st), after * kBQ, bh);
      Tile::load(do_s(st), &tm_do, bar_qdo(st), after * kBQ, bh);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = q0 + r0 + 8 * i;
      if (q >= S) continue;
      float* dst = dq_acc + (static_cast<size_t>(bh) * S + q) * D + c0;
#pragma unroll
      for (int j = 0; j < kR / 4; ++j)
        atomicAdd(reinterpret_cast<float2*>(dst + 8 * j),
                  make_float2(dq[4 * j + 2 * i] * sm_scale,
                              dq[4 * j + 2 * i + 1] * sm_scale));
    }
    qt = ahead;
    ahead = after;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + r0 + 8 * i;
    if (key >= Tk) continue;
    const size_t g = (static_cast<size_t>(bh) * Tk + key) * D + c0;
#pragma unroll
    for (int j = 0; j < kR / 4; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + g + 8 * j) =
          __floats2bfloat162_rn(dk_acc[4 * j + 2 * i] * sm_scale,
                                dk_acc[4 * j + 2 * i + 1] * sm_scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + g + 8 * j) =
          __floats2bfloat162_rn(dv_acc[4 * j + 2 * i],
                                dv_acc[4 * j + 2 * i + 1]);
    }
  }
}

// the main kernel for bfloat16: the tensor cores
template <int D>
cudaError_t launch_main(const __nv_bfloat16* q, const __nv_bfloat16* k,
                        const __nv_bfloat16* v, const float* lse,
                        const float* delta, const __nv_bfloat16* dout,
                        float* dq_acc, __nv_bfloat16* dk, __nv_bfloat16* dv,
                        int BH, int S, int Tk, int causal, float sm_scale,
                        cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  cudaError_t e = tc::make_map(&tm_q, q, BH, S, D);
  if (e == cudaSuccess) e = tc::make_map(&tm_k, k, BH, Tk, D);
  if (e == cudaSuccess) e = tc::make_map(&tm_v, v, BH, Tk, D);
  if (e == cudaSuccess) e = tc::make_map(&tm_do, dout, BH, S, D);
  if (e != cudaSuccess) return e;
  constexpr size_t smem = tc_bwd_smem_bytes<D>();
  e = cudaFuncSetAttribute(flash_bwd_tc_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(BH, (Tk + kBK - 1) / kBK);
  flash_bwd_tc_kernel<D><<<grid, tc::kWarpgroup, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse, delta, dq_acc, dk, dv, S, Tk, causal,
      sm_scale, sm_scale * tc::kLog2e);
  return cudaGetLastError();
}

// ---- float32: the CUDA cores ----------------------------------------------

template <int D>
cudaError_t launch_main(const float* q, const float* k, const float* v,
                        const float* lse, const float* delta,
                        const float* dout, float* dq_acc, float* dk,
                        float* dv, int BH, int S, int Tk, int causal,
                        float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<float, D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_kernel<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(BH, (Tk + kBK - 1) / kBK);
  flash_bwd_kernel<float, D><<<grid, kThreads, smem, stream>>>(
      q, k, v, lse, delta, dout, dq_acc, dk, dv, S, Tk, causal, sm_scale);
  return cudaGetLastError();
}

// delta, the main kernel of T's type, and (bfloat16) the cast of dq
template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const float* lse, const void* dout, void* dq, void* dk,
               void* dv, float* dq_acc, float* delta, int BH, int S, int Tk,
               int causal, float sm_scale, cudaStream_t stream) {
  const long long rows = static_cast<long long>(BH) * S;
  const long long n_delta_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  flash_bwd_delta_kernel<T><<<static_cast<unsigned>(n_delta_blocks), kThreads,
                              0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_main<D>(static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), lse, delta,
                     static_cast<const T*>(dout), dq_acc, static_cast<T*>(dk),
                     static_cast<T*>(dv), BH, S, Tk, causal, sm_scale, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (static_cast<void*>(dq_acc) != dq) {  // bfloat16 inputs
    const long long n = rows * D;
    const long long want = (n + kThreads - 1) / kThreads;
    f32_to_bf16_kernel<<<static_cast<unsigned>(want < 132 * 16 ? want
                                                              : 132 * 16),
                         kThreads, 0, stream>>>(
        dq_acc, static_cast<__nv_bfloat16*>(dq), n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_bwd(const void* q, const void* k, const void* v, const void* o,
                 const float* lse, const void* dout, void* dq, void* dk,
                 void* dv, float* dq_acc, float* delta, int BH, int S,
                 int Tk, int D, int causal, float sm_scale,
                 cudaStream_t stream) {
#define FLASH_BWD_CASE(DIM)                                                  \
  case DIM:                                                                  \
    return launch_bwd<T, DIM>(q, k, v, o, lse, dout, dq, dk, dv, dq_acc,    \
                              delta, BH, S, Tk, causal, sm_scale, stream);
  switch (D) {
    FLASH_BWD_CASE(16)
    FLASH_BWD_CASE(32)
    FLASH_BWD_CASE(64)
    FLASH_BWD_CASE(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_BWD_CASE
}

}  // namespace

extern "C" {

// The gradients of flash_attention_launch's o for the output gradient
// dout (as o): dq, dk, dv of the inputs' shapes and type.  lse is the
// forward's (BH, S) row log-sum-exp; dq_acc (BH, S, D) float32 must be
// zero on entry (for float32 inputs it may be dq itself); delta (BH, S)
// float32 is scratch.  bfloat16 q, k, v, dout are 16-byte aligned (TMA).
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const float* lse,
                               const void* dout, void* dq, void* dk, void* dv,
                               float* dq_acc, float* delta, int BH, int S,
                               int T, int D, int causal, int is_bf16,
                               float sm_scale, void* stream) {
  if (BH <= 0 || S <= 0 || T <= 0)
    return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_bwd<__nv_bfloat16>(q, k, v, o, lse, dout, dq, dk,
                                               dv, dq_acc, delta, BH, S, T, D,
                                               causal, sm_scale, st)
                 : dispatch_bwd<float>(q, k, v, o, lse, dout, dq, dk, dv,
                                       dq_acc, delta, BH, S, T, D, causal,
                                       sm_scale, st);
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
