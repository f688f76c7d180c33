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
// Design (simple first): one block of 256 threads per (batch, head).  The
// float32 (P, N) state stays in shared memory while the block walks the
// chunks of L rows in order.  For each chunk the block stages x (L x P),
// b and c (L x N) and dt as float32, takes seg = cumsum(dt a) over the
// chunk, and builds the decay-weighted (L x L) matrix
//   W[i][j] = (c_i . b_j) exp(seg_i - seg_j) dt_j   for j <= i, else 0
// (the mask is applied before the exp, as ssm_scan.py does).  Then
//   y_i = sum_j W[i][j] x_j + exp(seg_i) (state c_i)          (L x P)
//   state <- exp(seg_L) state + sum_j x_j exp(seg_L - seg_j) dt_j b_j^T.
// Rows of b, c and the state are padded to N + 1 floats so that the
// threads of a warp read distinct banks.
//
// What bounds it on an H100: at the serving path's shapes (B 4, S 512,
// H 128, P 64, N 16, L 64) the function needs 3.8e9 flops (2 L (L N +
// L P + 2 N P) per (batch, head, chunk); 3.8 us on the tensor cores) and
// moves about 68 MB (x and y in bf16, dt, b and c; 20 us at 3.35 TB/s),
// so the bound is the bytes.  This version works in float32 on the CUDA
// cores with one block per (batch, head) walking its chunks in sequence:
// 512 blocks of 256 threads at that shape, each with three barriers per
// chunk, so it is bound by latency and fp32 issue, not by the bytes.
//
// Arithmetic: float32 throughout, expf (no fast-math), sums in another
// order than the reference's einsums, so it is held to the plain version
// with tests/test_kernels.py's tolerances: 1e-4 (rtol and atol) in
// float32, 5e-2 in bfloat16.
//
// The launch uses the caller's stream, allocates nothing and returns
// cudaGetLastError(); the Python wrapper raises if it is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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
  extern __shared__ float smem[];
  float* xs = smem;
  float* bs = xs + L * P;
  float* cs = bs + L * NP;
  float* ws = cs + L * NP;
  float* st = ws + L * L;
  float* dts = st + P * NP;
  float* seg = dts + L;
  float* wj = seg + L;

  const int tid = threadIdx.x;
  const int bi = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const float a = -expf(a_log[h]);

  for (int idx = tid; idx < P * N; idx += kThreads)
    st[(idx / N) * NP + idx % N] = 0.f;

  for (int s0 = 0; s0 < S; s0 += L) {
    __syncthreads();  // the last chunk's state update is done
    const size_t row0 = static_cast<size_t>(bi) * S + s0;
    for (int idx = tid; idx < L * P; idx += kThreads) {
      const int l = idx / P, p = idx % P;
      xs[idx] = to_f32(x[((row0 + l) * H + h) * P + p]);
    }
    for (int idx = tid; idx < L * N; idx += kThreads) {
      const int l = idx / N, n = idx % N;
      bs[l * NP + n] = to_f32(b[(row0 + l) * N + n]);
      cs[l * NP + n] = to_f32(c[(row0 + l) * N + n]);
    }
    for (int l = tid; l < L; l += kThreads) dts[l] = dt[(row0 + l) * H + h];
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int l = 0; l < L; ++l) {
        run += dts[l] * a;
        seg[l] = run;
      }
    }
    __syncthreads();
    const float seg_last = seg[L - 1];
    for (int l = tid; l < L; l += kThreads)
      wj[l] = expf(seg_last - seg[l]) * dts[l];
    for (int idx = tid; idx < L * L; idx += kThreads) {
      const int i = idx / L, j = idx % L;
      float w = 0.f;
      if (j <= i) {
        float cb = 0.f;
        for (int n = 0; n < N; ++n) cb = fmaf(cs[i * NP + n], bs[j * NP + n], cb);
        w = cb * expf(seg[i] - seg[j]) * dts[j];
      }
      ws[idx] = w;
    }
    __syncthreads();
    for (int idx = tid; idx < L * P; idx += kThreads) {
      const int i = idx / P, p = idx % P;
      float yi = 0.f;
      for (int j = 0; j <= i; ++j) yi = fmaf(ws[i * L + j], xs[j * P + p], yi);
      float ci = 0.f;
      for (int n = 0; n < N; ++n) ci = fmaf(cs[i * NP + n], st[p * NP + n], ci);
      store(y + ((row0 + i) * H + h) * P + p, yi + expf(seg[i]) * ci);
    }
    __syncthreads();  // every read of the old state is done
    const float dec = expf(seg_last);
    for (int idx = tid; idx < P * N; idx += kThreads) {
      const int p = idx / N, n = idx % N;
      float u = 0.f;
      for (int j = 0; j < L; ++j)
        u = fmaf(xs[j * P + p] * wj[j], bs[j * NP + n], u);
      st[p * NP + n] = dec * st[p * NP + n] + u;
    }
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* a_log, const void* b,
           const void* c, void* y, int B, int S, int H, int P, int N, int L,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(L, P, N);
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
int ssm_scan_launch(const void* x, const float* dt, const float* a_log,
                    const void* b, const void* c, void* y, int B, int S,
                    int H, int P, int N, int L, int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  if (L <= 0 || S % L != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, dt, a_log, b, c, y, B, S, H, P,
                                         N, L, st)
                 : launch<float>(x, dt, a_log, b, c, y, B, S, H, P, N, L, st);
}

const char* ssm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
