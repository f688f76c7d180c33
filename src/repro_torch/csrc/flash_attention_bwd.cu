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
// per row (one warp per row).  The main kernel runs one block of 256
// threads per (bh, 64-key tile): K and V of the tile are staged once in
// the inputs' type (bf16 rows padded to D + 2 elements, an odd number of
// 4-byte words, so that 16 rows read at one column fall in 16 banks;
// float32 rows to D + 1) and dK, dV stay in registers while the block
// walks the query tiles that can see a key of the tile.
// For each it stages Q and dO the same way, recomputes P = exp(s - lse) and
// dP = dO V^T (64 x 64, fp32 FMAs), forms dS = P (dP - delta), adds
// P^T dO to dV and dS^T Q to dK, and adds dS K to a float32 dq buffer
// with atomics (blocks of other key tiles add to the same rows); a last
// kernel casts that buffer to bfloat16 where the inputs are bfloat16.
// Hidden keys get no weight and no gradient, as the reference's
// masked_fill gives them; a row that sees no key (T < S) weighs every key
// by 1/T and passes no gradient to q or k.
//
// What bounds it on an H100: at the training path's shapes (starcoder2-15b,
// B 4, H 48, S = T = 2048, D 128, bf16, causal) it needs 5 products of
// 2 D flops per visible (query, key) pair, 5.2e11 flops (0.52 ms on the
// tensor cores), and reads q, k, v, o, dO and writes dq, dk, dv (8 x
// 101 MB, 0.24 ms at 3.35 TB/s), so the bound is the operations.  This
// version runs its five products as fp32 FMAs on the CUDA cores, with two
// blocks per SM in bf16 (98 KB of shared memory and at most 128 registers
// a thread at D 128; one in float32, 166 KB), so it is bound by fp32
// issue, far above the bound.
//
// Arithmetic: float32 throughout, expf; the atomics add the dq
// contributions of the key tiles in an order that changes from run to
// run.  Held against autograd of the plain version, whose bf16 scores
// and probabilities round where the kernel's do not, within 1e-5 of each
// gradient's largest magnitude in float32 and 2e-2 in bfloat16.
//
// The launches use the caller's stream, allocate nothing and return
// cudaGetLastError(); the Python wrapper raises if it is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // key rows per block
constexpr int kThreads = 256;  // 16 x 16

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
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

// row stride of a staged q, dO, k or v tile, in elements
template <typename T, int D>
__host__ __device__ constexpr int tile_stride() {
  return D + (sizeof(T) == 4 ? 1 : 2);
}

template <typename T, int D>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (2 * kBQ * (kBK + 1)  // P, dS
                          + 2 * kBQ)           // lse, delta of the q tile
         + sizeof(T) * 4 * kBQ * tile_stride<T, D>();  // q, dO, k, v
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// at most 128 registers a thread, so that two blocks fit an SM's 64 K
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
      store(dk + g + tx + 16 * c, dk_acc[a][c] * sm_scale);
      store(dv + g + tx + 16 * c, dv_acc[a][c]);
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
  constexpr size_t smem = bwd_smem_bytes<T, D>();
  e = cudaFuncSetAttribute(flash_bwd_kernel<T, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(BH, (Tk + kBK - 1) / kBK);
  flash_bwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lse, delta, static_cast<const T*>(dout),
      dq_acc, static_cast<T*>(dk), static_cast<T*>(dv), S, Tk, causal,
      sm_scale);
  e = cudaGetLastError();
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
// float32 is scratch.
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
