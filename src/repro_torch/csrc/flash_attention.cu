// Blocked online-softmax attention forward (flash), for Hopper.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas (the
// Pallas TPU kernel).  It computes what the plain version,
// repro_torch/kernels/ref.py::flash_attention_ref (a port of
// repro/kernels/ref.py::flash_attention_ref), computes:
//   out = softmax(q k^T / sqrt(D), masked) v
// for q (BH, S, D) and k, v (BH, T, D), equal head counts (the caller
// expands GQA).  With `causal`, key j is visible to query i iff
// j <= i + (T - S); a hidden score is set to -1e30, not -inf, so a row
// that sees no key averages every key, as the reference does.  m, l and
// the accumulator are float32; the output is acc / max(l, 1e-30) in the
// input type (float32 or bfloat16).  When asked (lse non-null) it also
// writes the row log-sum-exp of the scaled scores, m + log(l), float32.
//
// Design (simple first): one block of 256 threads per (bh, 64-row query
// tile).  The query tile is staged in shared memory once as float32; the
// block walks the key tiles of 64 rows in order, staging K (transposed)
// and V as float32, and keeps the running max m, the normaliser l and the
// (64 x D) accumulator in registers: thread (ty, tx) of the 16 x 16 grid
// owns query rows ty + 16 i (i < 4), score columns tx + 16 j (j < 4) and
// output columns tx + 16 c (c < D / 16).  The row max and the row sum are
// reduced over the 16 lanes of a half warp with shuffles.  Under `causal`
// the block stops after the last key tile that one of its rows can see
// (unless a row of the tile sees no key at all; then it visits every
// tile, as the reference's averaging needs).  Ragged edges (S or T not a
// multiple of 64) are masked in the kernel: missing keys get no weight,
// missing query rows are not stored.
//
// What bounds it on an H100: at the serving path's shapes (B 4, H 32,
// S = T = 512, D 128, bf16) the function needs 8.6e9 flops (8.7 us on the
// tensor cores) and moves 67.1 MB (20 us at 3.35 TB/s), so the bound is
// the bytes.  This first version multiplies in float32 on the CUDA cores,
// not on the tensor cores (no wgmma, no TMA), so it is bound by its own
// fp32 FMA issue rate and by 113 KB of shared memory per block at D 128
// (one block per SM); moving the two products to wgmma is later work.
//
// Arithmetic: float32 products and sums, expf (no fast-math).  The sums
// run in another order than the reference's einsum, and bf16 inputs are
// read exactly (the reference rounds q k^T to bf16 first), so it is held
// to the plain version with tests/test_kernels.py's tolerances: 2e-5
// (rtol and atol) in float32, 2e-2 in bfloat16.
//
// The launch uses the caller's stream, allocates nothing and returns
// cudaGetLastError(); the Python wrapper raises if it is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr float kMaskValue = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
             int BH, int S, int Tk, int D, int causal, float sm_scale,
             cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, lse, BH, S, Tk, causal, sm_scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, BH, S, Tk, causal, sm_scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, BH, S, Tk, causal, sm_scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, BH, S, Tk, causal, sm_scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q (BH, S, D), k and v (BH, T, D), o (BH, S, D): contiguous device
// pointers of one type, bfloat16 when is_bf16 is non-zero, else float32.
// D is 16, 32, 64 or 128.  lse, if not null, receives the (BH, S) float32
// row log-sum-exp of the scaled scores.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, float* lse, int BH, int S, int T, int D,
                           int causal, int is_bf16, float sm_scale,
                           void* stream) {
  if (BH <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, lse, BH, S, T, D,
                                           causal, sm_scale, st)
                 : dispatch<float>(q, k, v, o, lse, BH, S, T, D, causal,
                                   sm_scale, st);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
