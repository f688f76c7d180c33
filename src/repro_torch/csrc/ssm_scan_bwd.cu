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
// Design: dx, ddt, da_log, db and dc for the output gradient dy.  One
// block of 256 threads per (batch, head) does two passes.  The first
// walks the chunks forward as above and writes the state entering each
// chunk to a float32 scratch (B H, n_chunks, P, N).  The second walks
// the chunks in reverse with dstate (P, N), the gradient of the state
// leaving the chunk, in shared memory.  Per chunk it stages x, dy (rows
// padded to P + 1), b, c (N + 1) and the entering state as float32,
// builds Q[i][j] = (c_i . b_j) exp(seg_i - seg_j) and
// A[i][j] = dy_i . x_j (j <= i), and from them
//   dc_i = sum_j A_ij exp(seg_i - seg_j) dt_j b_j + exp(seg_i) dy_i^T state
//   db_j = sum_i A_ij exp(seg_i - seg_j) dt_j c_i
//          + exp(seg_L - seg_j) dt_j dstate^T x_j
//   dx_j = sum_i Q_ij dt_j dy_i + exp(seg_L - seg_j) dt_j dstate b_j
// and the gradient of every seg and dt; a reverse cumulative sum turns
// dseg into ddt (times a) and da (times dt), and
//   dstate <- exp(seg_L) dstate + sum_i exp(seg_i) dy_i c_i^T.
// b and c are shared by the heads and a_log by the batch, so every block
// adds its share of db, dc (into (B, S, N) float32) and d a_log (into
// (H,) float32) with atomics; a last kernel casts db and dc to bfloat16
// where the inputs are bfloat16.  The atomics add the heads' shares in an
// order that changes from run to run.  Shared memory: 200.7 KB at
// mamba2-780m's N 128, P 64, chunk 64 (one block per SM).
//
// What bounds it on an H100: per (batch, head, chunk) the work is
// 5 L P N + L^2 (3 N + 2 P) / 2 multiply-adds (the recomputed state, the
// lower triangles of Q and A, and the intra- and inter-chunk terms of dc,
// db, dx and dstate).  At the training path's shapes (mamba2-780m, B 8,
// S 2048, H 48, P 64, N 128, chunk 64, bf16) that is 9.0e10 flops (0.09
// ms on the tensor cores), and x, dy, dt, b, c read and dx, ddt, db, dc
// written are 0.33 GB (0.10 ms at 3.35 TB/s), so the bound is the bytes.
// This version does its products as fp32 FMAs on the CUDA cores, with
// 384 blocks of 200.7 KB (one per SM) walking 32 chunks each and about
// ten barriers per chunk: it is bound by fp32 issue and the chunks'
// sequence, far above the bound.
//
// Arithmetic: float32, expf, sums in another order than autograd of the
// plain version (and, for db, dc and d a_log, from run to run); held
// against it within 1e-4 of each gradient's largest magnitude in float32
// and 5e-2 in bfloat16.
//
// The launches use the caller's stream, allocate nothing and return
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

size_t bwd_smem_bytes(int L, int P, int N) {
  const size_t PP = P + 1, NP = N + 1, LP = L + 1;
  return sizeof(float) * (2 * L * PP           // x, dy chunk
                          + 2 * L * NP         // b, c chunk
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
  const int PP = P + 1, NP = N + 1, LP = L + 1;
  constexpr int kWarps = kThreads / 32;
  extern __shared__ float smem[];
  float* xs = smem;
  float* dys = xs + L * PP;
  float* bs = dys + L * PP;
  float* cs = bs + L * NP;
  float* st = cs + L * NP;     // state entering the chunk
  float* ds = st + P * NP;     // gradient of the state leaving it
  float* am = ds + P * NP;     // A, then A exp(seg_i - seg_j) dt_j
  float* qm = am + L * LP;     // Q, then Q dt_j
  float* dts = qm + L * LP;
  float* seg = dts + L;
  float* ex = seg + L;         // exp(seg_i)
  float* u = ex + L;           // exp(seg_L - seg_j) dt_j
  float* dseg = u + L;         // row terms of d seg_i
  float* cg = dseg + L;        // sum_i A_ij Q_ij (d dt_j, intra, direct)
  float* sv = cg + L;          // d dt_j from the leaving state, direct
  float* kv = sv + L;          // sv_j dt_j (d seg_L += sum, d seg_j -= each)
  float* red = kv + L;         // per-warp partial sums

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bi = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int nc = S / L;
  const float a = -expf(a_log[h]);
  float* sts = states + static_cast<size_t>(blockIdx.x) * nc * P * N;

  // ---- pass 1: the state entering every chunk ----------------------------
  for (int idx = tid; idx < P * N; idx += kThreads)
    st[(idx / N) * NP + idx % N] = 0.f;
  for (int k = 0; k < nc; ++k) {
    __syncthreads();
    const size_t row0 = static_cast<size_t>(bi) * S + static_cast<size_t>(k) * L;
    for (int idx = tid; idx < P * N; idx += kThreads)
      sts[static_cast<size_t>(k) * P * N + idx] = st[(idx / N) * NP + idx % N];
    if (k == nc - 1) break;
    for (int idx = tid; idx < L * P; idx += kThreads) {
      const int l = idx / P, pp = idx % P;
      xs[l * PP + pp] = to_f32(x[((row0 + l) * H + h) * P + pp]);
    }
    for (int idx = tid; idx < L * N; idx += kThreads) {
      const int l = idx / N, n = idx % N;
      bs[l * NP + n] = to_f32(b[(row0 + l) * N + n]);
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
    for (int l = tid; l < L; l += kThreads)
      u[l] = expf(seg[L - 1] - seg[l]) * dts[l];
    __syncthreads();
    const float dec = expf(seg[L - 1]);
    for (int idx = tid; idx < P * N; idx += kThreads) {
      const int pp = idx / N, n = idx % N;
      float acc = 0.f;
      for (int j = 0; j < L; ++j)
        acc = fmaf(xs[j * PP + pp] * u[j], bs[j * NP + n], acc);
      st[pp * NP + n] = dec * st[pp * NP + n] + acc;
    }
  }
  __syncthreads();  // pass 1's stores are visible to the whole block

  // ---- pass 2: the chunks in reverse -------------------------------------
  for (int idx = tid; idx < P * N; idx += kThreads)
    ds[(idx / N) * NP + idx % N] = 0.f;
  float da_acc = 0.f;  // thread 0's running sum of d a
  for (int k = nc - 1; k >= 0; --k) {
    __syncthreads();  // the last chunk's reads of every buffer are done
    const size_t row0 = static_cast<size_t>(bi) * S + static_cast<size_t>(k) * L;
    for (int idx = tid; idx < L * P; idx += kThreads) {
      const int l = idx / P, pp = idx % P;
      const size_t g = ((row0 + l) * H + h) * P + pp;
      xs[l * PP + pp] = to_f32(x[g]);
      dys[l * PP + pp] = to_f32(dy[g]);
    }
    for (int idx = tid; idx < L * N; idx += kThreads) {
      const int l = idx / N, n = idx % N;
      bs[l * NP + n] = to_f32(b[(row0 + l) * N + n]);
      cs[l * NP + n] = to_f32(c[(row0 + l) * N + n]);
    }
    for (int idx = tid; idx < P * N; idx += kThreads)
      st[(idx / N) * NP + idx % N] = sts[static_cast<size_t>(k) * P * N + idx];
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
    for (int l = tid; l < L; l += kThreads) {
      ex[l] = expf(seg[l]);
      u[l] = expf(seg_last - seg[l]) * dts[l];
    }
    // Q and A over the lower triangle
    for (int idx = tid; idx < L * L; idx += kThreads) {
      const int i = idx / L, j = idx % L;
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
    if (tid < L) {
      const int i = tid;
      float r = 0.f;
      for (int j = 0; j <= i; ++j) r = fmaf(am[i * LP + j] * qm[i * LP + j], dts[j], r);
      dseg[i] = r;
    } else if (tid < 2 * L) {
      const int j = tid - L;
      float r = 0.f;
      for (int i = j; i < L; ++i) r = fmaf(am[i * LP + j], qm[i * LP + j], r);
      cg[j] = r;
    }
    __syncthreads();
    for (int idx = tid; idx < L * L; idx += kThreads) {
      const int i = idx / L, j = idx % L;
      if (j <= i) {
        am[i * LP + j] *= expf(seg[i] - seg[j]) * dts[j];
        qm[i * LP + j] *= dts[j];
      }
    }
    __syncthreads();
    // dc (a warp per row i, lanes over n) and its share of d seg_i
    for (int i = warp; i < L; i += kWarps) {
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
    for (int j = warp; j < L; j += kWarps) {
      float part = 0.f;
      for (int n = lane; n < N; n += 32) {
        float intra = 0.f;
        for (int i = j; i < L; ++i) intra = fmaf(am[i * LP + j], cs[i * NP + n], intra);
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
    for (int j = warp; j < L; j += kWarps) {
      for (int pp = lane; pp < P; pp += 32) {
        float intra = 0.f;
        for (int i = j; i < L; ++i) intra = fmaf(qm[i * LP + j], dys[i * PP + pp], intra);
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
    const float dec = ex[L - 1];
    for (int idx = tid; idx < P * N; idx += kThreads) {
      const int pp = idx / N, n = idx % N;
      float acc = 0.f;
      for (int i = 0; i < L; ++i)
        acc = fmaf(ex[i] * dys[i * PP + pp], cs[i * NP + n], acc);
      ds[pp * NP + n] = dec * ds[pp * NP + n] + acc;
    }
    // d seg -> d dta by a reverse cumulative sum -> ddt and d a
    if (tid == 0) {
      float tot = 0.f;
      for (int w = 0; w < kWarps; ++w) tot += red[w];
      float last = dec * tot;
      for (int j = 0; j < L; ++j) last += kv[j];
      float run = 0.f;
      for (int j = L - 1; j >= 0; --j) {
        float g = dseg[j] - cg[j] * dts[j] - kv[j];
        if (j == L - 1) g += last;
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

template <typename T>
int launch_bwd(const void* x, const float* dt, const float* a_log,
               const void* b, const void* c, const void* dy, void* dx,
               float* ddt, float* da, void* db, void* dc, float* db_acc,
               float* dc_acc, float* states, int B, int S, int H, int P,
               int N, int L, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(L, P, N);
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
// themselves.  states (B H, S / L, P, N) float32 is scratch.
int ssm_scan_bwd_launch(const void* x, const float* dt, const float* a_log,
                        const void* b, const void* c, const void* dy,
                        void* dx, float* ddt, float* da, void* db, void* dc,
                        float* db_acc, float* dc_acc, float* states, int B,
                        int S, int H, int P, int N, int L, int is_bf16,
                        void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  if (L <= 0 || S % L != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bwd<__nv_bfloat16>(x, dt, a_log, b, c, dy, dx, ddt,
                                             da, db, dc, db_acc, dc_acc,
                                             states, B, S, H, P, N, L, st)
                 : launch_bwd<float>(x, dt, a_log, b, c, dy, dx, ddt, da, db,
                                     dc, db_acc, dc_acc, states, B, S, H, P,
                                     N, L, st);
}

const char* ssm_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
