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
// What bounds it on an H100: every element is read once and written once
// and costs 2 d float32 operations, so at degree 8 (16 operations for 8
// bytes in float32, 4 in bfloat16) the work is far below the card's
// operations-per-byte line: it is bound by the bytes, x read and y written
// at 3.35 TB/s.
//
// Design: a streaming kernel.  Each thread loads and stores 16-byte
// vectors (4 float32 or 8 bfloat16 values), two vectors per iteration of
// a grid-stride loop, both loads issued before either is used, with
// evict-first cache hints (x is read once, y written once).  Elements
// before x's first 16-byte boundary (a view such as x[1:]) and past the
// last whole vector run as scalars; the wrapper gives y the same offset
// from a 16-byte boundary as x, and where the two differ every element
// runs as a scalar.  Up to 16 coefficients (degree 15) live in registers,
// the loop unrolled by a template on their count; more go to shared
// memory, read in a loop.  The grid is one wave: the blocks that fit on
// every SM at once (occupancy API, asked once per device and count) times
// the SM count, or fewer for short inputs.
//
// Arithmetic: each step is one float32 multiply and one float32 add, each
// rounded (__fmul_rn, __fadd_rn: nvcc does not contract them into a fused
// multiply-add), in the plain version's order, so the kernel equals the
// plain version bit for bit in float32 and, after the same rounding to
// bfloat16 (round to nearest even), in bfloat16 too.  The tolerance
// against it is 0.
//
// The launch uses the caller's stream, allocates nothing and returns
// cudaGetLastError(); the Python wrapper raises if it is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRegCoeffs = 16;    // coefficients held in registers
constexpr int kMaxCoeffs = 12288; // in shared memory: 48 KB
constexpr int kMaxDevices = 64;   // devices whose grid size is kept

// the coefficients: in registers (NC of them) or, for NC = 0, in shared
// memory (n of them)
template <int NC>
struct Coeffs {
  float c[NC];
  __device__ __forceinline__ Coeffs(const float* __restrict__ g, int, float*) {
#pragma unroll
    for (int i = 0; i < NC; ++i) c[i] = __ldg(g + i);
  }
  __device__ __forceinline__ float operator()(float x) const {
    float acc = c[NC - 1];
#pragma unroll
    for (int i = NC - 2; i >= 0; --i) acc = __fadd_rn(__fmul_rn(acc, x), c[i]);
    return acc;
  }
};

template <>
struct Coeffs<0> {
  const float* s;
  int n;
  __device__ __forceinline__ Coeffs(const float* __restrict__ g, int count,
                                    float* smem)
      : s(smem), n(count) {
    for (int i = threadIdx.x; i < count; i += kThreads) smem[i] = g[i];
    __syncthreads();
  }
  __device__ __forceinline__ float operator()(float x) const {
    float acc = s[n - 1];
    for (int i = n - 2; i >= 0; --i) acc = __fadd_rn(__fmul_rn(acc, x), s[i]);
    return acc;
  }
};

// a 16-byte vector of one element type, and its evaluation
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  using V = float4;
  static constexpr int kWidth = 4;
  template <typename P>
  __device__ __forceinline__ static V eval(V v, const P& p) {
    return make_float4(p(v.x), p(v.y), p(v.z), p(v.w));
  }
  __device__ __forceinline__ static float load1(const float* x) { return *x; }
  __device__ __forceinline__ static void store1(float* y, float v) { *y = v; }
};

template <>
struct Vec<__nv_bfloat16> {
  using V = uint4;  // 8 bfloat16, as 4 pairs
  static constexpr int kWidth = 8;
  template <typename P>
  __device__ __forceinline__ static uint32_t pair(uint32_t w, const P& p) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w));
    const __nv_bfloat162 r = __floats2bfloat162_rn(p(f.x), p(f.y));
    return *reinterpret_cast<const uint32_t*>(&r);
  }
  template <typename P>
  __device__ __forceinline__ static V eval(V v, const P& p) {
    return make_uint4(pair(v.x, p), pair(v.y, p), pair(v.z, p), pair(v.w, p));
  }
  __device__ __forceinline__ static float load1(const __nv_bfloat16* x) {
    return __bfloat162float(*x);
  }
  __device__ __forceinline__ static void store1(__nv_bfloat16* y, float v) {
    *y = __float2bfloat16_rn(v);
  }
};

// x, y (n,); elements [0, head) and [head + n_vec * width, n) are scalars,
// the n_vec vectors between them start on a 16-byte boundary of x and y
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
horner_kernel(const T* __restrict__ x, const float* __restrict__ coeffs,
              T* __restrict__ y, long long n, int n_coeffs, long long head,
              long long n_vec) {
  extern __shared__ float smem[];
  using W = Vec<T>;
  using V = typename W::V;
  const Coeffs<NC> poly(coeffs, n_coeffs, smem);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long t0 = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
  const V* xv = reinterpret_cast<const V*>(x + head);
  V* yv = reinterpret_cast<V*>(y + head);
  long long v = t0;
  for (; v + stride < n_vec; v += 2 * stride) {
    const V a = __ldcs(xv + v);
    const V b = __ldcs(xv + v + stride);
    __stcs(yv + v, W::eval(a, poly));
    __stcs(yv + v + stride, W::eval(b, poly));
  }
  if (v < n_vec) __stcs(yv + v, W::eval(__ldcs(xv + v), poly));
  for (long long e = t0; e < head; e += stride)
    W::store1(y + e, poly(W::load1(x + e)));
  for (long long e = head + n_vec * W::kWidth + t0; e < n; e += stride)
    W::store1(y + e, poly(W::load1(x + e)));
}

template <typename T, int NC>
cudaError_t launch_nc(const void* x, const float* coeffs, void* y,
                      long long n, int n_coeffs, cudaStream_t stream) {
  constexpr int kWidth = Vec<T>::kWidth;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t ya = reinterpret_cast<uintptr_t>(y);
  long long head = n;  // all scalars unless x and y share their alignment
  if ((xa - ya) % 16 == 0)
    head = static_cast<long long>((16 - xa % 16) % 16 / sizeof(T));
  if (head > n) head = n;
  const long long n_vec = (n - head) / kWidth;
  const size_t smem = NC == 0 ? n_coeffs * sizeof(float) : 0;
  // one wave: the blocks that fit on an SM at once times the SMs, asked
  // once per device (NC > 0) so that a launch costs the host no query
  static long long waves[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  long long wave = dev < kMaxDevices && NC > 0 ? waves[dev] : 0;
  if (wave == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, horner_kernel<T, NC>, kThreads, smem);
    if (e != cudaSuccess) return e;
    wave = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
    if (dev < kMaxDevices && NC > 0) waves[dev] = wave;
  }
  // threads for two vectors each, or for the scalars, within one wave
  const long long work = n_vec > 0 ? (n_vec + 1) / 2 : n;
  const long long want = (work + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < wave ? want : wave);
  horner_kernel<T, NC><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), coeffs, static_cast<T*>(y), n, n_coeffs, head,
      n_vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const float* coeffs, void* y, long long n,
                   int n_coeffs, cudaStream_t st) {
  switch (n_coeffs) {
#define HORNER_CASE(K) \
  case K:              \
    return launch_nc<T, K>(x, coeffs, y, n, n_coeffs, st);
    HORNER_CASE(1) HORNER_CASE(2) HORNER_CASE(3) HORNER_CASE(4)
    HORNER_CASE(5) HORNER_CASE(6) HORNER_CASE(7) HORNER_CASE(8)
    HORNER_CASE(9) HORNER_CASE(10) HORNER_CASE(11) HORNER_CASE(12)
    HORNER_CASE(13) HORNER_CASE(14) HORNER_CASE(15) HORNER_CASE(16)
#undef HORNER_CASE
    default:  // more than kRegCoeffs: shared memory
      return launch_nc<T, 0>(x, coeffs, y, n, n_coeffs, st);
  }
}

}  // namespace

extern "C" {

// x, y (n,) contiguous device arrays of one type (bfloat16 when is_bf16 is
// non-zero, else float32); coeffs (n_coeffs,) float32, lowest degree
// first, 1 <= n_coeffs <= 12288 (48 KB of shared memory).
int horner_launch(const void* x, const float* coeffs, void* y, long long n,
                  int n_coeffs, int is_bf16, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (n_coeffs < 1 || n_coeffs > kMaxCoeffs)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? launch<__nv_bfloat16>(x, coeffs, y, n, n_coeffs, st)
              : launch<float>(x, coeffs, y, n, n_coeffs, st));
}

const char* horner_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
