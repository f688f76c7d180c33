// Horner-rule polynomial evaluation, for Hopper.
//
// Replaces repro/kernels/horner.py::horner_pallas (the Pallas TPU kernel,
// reached through repro/kernels/ops.py::horner).  It computes what the
// plain version, repro_torch/kernels/ref.py::horner_ref, computes: for a
// flat x (N,) of float32 or bfloat16 and coeffs (d+1,) float32, lowest
// degree first,
//   y = (((c_d x + c_{d-1}) x + ...) x + c_0)
// in float32, stored in x's type.
//
// Design: elementwise, one thread per element in a grid-stride loop; the
// d+1 coefficients are staged in shared memory once per block (the degree
// is a run-time argument) and the accumulator stays in a register.
//
// What bounds it on an H100: every element is read once and written once
// and costs 2 d float32 operations, so at degree 8 (16 operations for 8
// bytes in float32, 4 in bfloat16) the work is far below the card's
// operations-per-byte line: it is bound by the bytes, x read and y written
// at 3.35 TB/s.
//
// Arithmetic: each step is one float32 multiply and one float32 add, each
// rounded (__fmul_rn, __fadd_rn: nvcc does not contract them into a fused
// multiply-add), in the plain version's order, so the kernel equals the
// plain version bit for bit in float32 and, after the same rounding to
// bfloat16, in bfloat16 too.  The tolerance against it is 0.
//
// The launch uses the caller's stream, allocates nothing and returns
// cudaGetLastError(); the Python wrapper raises if it is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
horner_kernel(const T* __restrict__ x, const float* __restrict__ coeffs,
              T* __restrict__ y, long long n, int n_coeffs) {
  extern __shared__ float smem[];
  for (int i = threadIdx.x; i < n_coeffs; i += kThreads) smem[i] = coeffs[i];
  __syncthreads();
  const float top = smem[n_coeffs - 1];
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       e < n; e += stride) {
    const float xv = to_f32(x[e]);
    float acc = top;
    for (int i = n_coeffs - 2; i >= 0; --i)
      acc = __fadd_rn(__fmul_rn(acc, xv), smem[i]);
    store(y + e, acc);
  }
}

template <typename T>
int launch(const void* x, const float* coeffs, void* y, long long n,
           int n_coeffs, int n_blocks, cudaStream_t stream) {
  horner_kernel<T><<<n_blocks, kThreads, n_coeffs * sizeof(float), stream>>>(
      static_cast<const T*>(x), coeffs, static_cast<T*>(y), n, n_coeffs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, y (n,) contiguous device arrays of one type (bfloat16 when is_bf16 is
// non-zero, else float32); coeffs (n_coeffs,) float32, lowest degree
// first, 1 <= n_coeffs <= 12288 (48 KB of shared memory).
int horner_launch(const void* x, const float* coeffs, void* y, long long n,
                  int n_coeffs, int is_bf16, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (n_coeffs < 1 || n_coeffs > 12288)
    return static_cast<int>(cudaErrorInvalidValue);
  // a few waves of blocks over the card's 132 SMs; each thread then
  // strides over the rest
  const long long want = (n + kThreads - 1) / kThreads;
  const int n_blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, coeffs, y, n, n_coeffs, n_blocks,
                                         st)
                 : launch<float>(x, coeffs, y, n, n_coeffs, n_blocks, st);
}

const char* horner_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
