// Myopic roofline lower bound per (candidate chip, operator), for Hopper.
//
// Replaces repro/kernels/dse_eval.py::dse_eval_pallas (the Pallas TPU
// kernel).  It computes what the plain version, repro_torch/kernels/ref.py
// ::dse_eval_ref (a port of repro/kernels/ref.py::dse_eval_ref), computes:
// for every candidate b and op n, Eq. 2 applied to the op alone on each of
// the candidate's T tile slots, the best (smallest) seconds over the slots
// with a strict `<` first-slot tie-break, and the energy
// macs * e_mac[best slot] + 0.5 * elems.  Where no slot can host the op the
// seconds are +inf and the energy uses slot 0, as ref.py does (the Pallas
// kernel returns energy 0 there; ref.py is the semantics of record).
//
// Layouts (float32, row-major, contiguous):
//   tiles (B, T, 10): exists, num_macs, dsp_lanes, clock_hz, eta, sfu_mask,
//                     sfu_par, prec_ok, e_mac_pj, bw_bytes_per_s
//   ops   (N, 7):     op_cls, macs, elems, bytes_total, seq_len, sfu_kind,
//                     sfu_n
//   out   (B, N, 2):  best seconds, energy at the best slot
//
// What bounds it on an H100: fp32 ALU work.  Each output walks T slots
// (24 on the DSE path) at some 15-25 operations each, three of them IEEE
// divisions (each a reciprocal and a few multiply-adds with a range
// check), against 8 bytes written per output and a tile table read once
// per block.
//
// Design (full lanes, per-slot terms computed once):
//   * the work is the flat output: one item is one (b, n).  A block of
//     256 threads takes G candidates x R ops, G R about 1,024 items
//     (R = N up to 256 ops, else N cut into equal column blocks of at most
//     256; G from R at launch, capped so that G T slot records fit in
//     48 KB).  So a launch with N = 7 still fills its warps and one with
//     N = 608 runs some 2,000 blocks.  Item i of a block is (g, r) =
//     (i / R, i % R): consecutive threads take consecutive ops of one
//     candidate, so they write consecutive float2s and read one slot
//     record at a time (a shared-memory broadcast);
//   * first the block's threads compute one record per (candidate, slot)
//     into shared memory, as two float4s: {clock, max(bw / clock, 1e-9),
//     max(num_macs eta, 1e-9), flags} and {max(lanes, 1), max(sfu_par, 1),
//     sfu_mask, e_mac}.  The flags hold the two ok conjunctions (MAC class,
//     other classes: exists, mac_ok, lanes > 0), mac_ok, and the `native`
//     bits for sfu kinds 1, 2 and 4 from the plain version's floor / fmod
//     expression.  The division bw / clock is then done once per slot, not
//     once per (op, slot); an op whose max(sfu_kind, 1) is not 1, 2 or 4
//     evaluates the expression in its loop from the record's sfu_mask;
//   * each item runs the loop of its op's class over the T slots (per-op
//     terms hoisted: 2 macs, 2 elems, 10 elems, sqrt(max(seq_len, 1)),
//     elems log2(max(sfu_n, 2))), and skips the arithmetic of a slot
//     that cannot host the op.  prefilter.pack_launches orders each
//     launch's ops by class, so warps rarely mix classes.
//
// Arithmetic: the plain version's operations in its order, IEEE division
// and sqrt (no fast-math), nothing contracted: the seconds are bit for
// bit the plain version's, and so is the energy (multiply and add rounded
// apart, __fmul_rn / __fadd_rn); chip_smoke.py phase 3 and
// tests/test_torch_gpu.py hold both bit for bit.
//
// The launch uses the caller's stream, allocates nothing and returns
// cudaGetLastError(); the Python wrapper raises if it is not cudaSuccess.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileFields = 10;
constexpr int kOpFields = 7;
constexpr int kThreads = 256;
constexpr int kItems = 1024;       // items (b, n) a block aims at
constexpr int kMaxOps = 256;       // ops (columns) a block at most
constexpr int kMaxRecords = 1536;  // slot records a block: 48 KB

// flags of a slot record
constexpr unsigned kOkMac = 1u;    // (mac_ok || lanes > 0) && exists
constexpr unsigned kOkOther = 2u;  // lanes > 0 && exists
constexpr unsigned kMacOk = 4u;    // num_macs > 0 && prec_ok > 0
constexpr int kNativeShift = 3;    // native for kind 1, 2, 4: bits 3, 4, 5

__device__ __forceinline__ bool native_bit(float sfu_mask, float kind) {
  return fmodf(floorf(sfu_mask / kind), 2.0f) >= 1.0f;
}

// the seconds of the op on one slot, by class (0 MAC, 1 DSP, 2 SPECIAL);
// +inf where the slot cannot host it
template <int kCls>
__device__ __forceinline__ void walk_slots(
    const float4* __restrict__ ra, const float4* __restrict__ rb, int T,
    float macs, float macs2, float elems2, float elems10, float dsp_scale,
    float sfu_work, float kind, int native_shift, float bytes_t,
    float& best_sec, int& best_t) {
  const unsigned ok_bit = kCls == 0 ? kOkMac : kOkOther;
#pragma unroll 2
  for (int t = 0; t < T; ++t) {
    const float4 a = ra[t];  // clock, bw / clock, macs / s, flags
    const unsigned fl = __float_as_uint(a.w);
    if (!(fl & ok_bit)) continue;
    float c_cmp;
    if (kCls == 0) {
      c_cmp = (fl & kMacOk) ? macs / a.z : ceilf(macs2 / rb[t].x);
    } else if (kCls == 1) {
      c_cmp = ceilf(elems2 / rb[t].x) * dsp_scale;
    } else {
      const float4 b = rb[t];  // lanes1, sfu_par1, sfu_mask, e_mac
      const bool native = native_shift >= 0 ? ((fl >> native_shift) & 1u)
                                            : native_bit(b.z, kind);
      c_cmp = native ? sfu_work / b.y : ceilf(elems10 / b.x);
    }
    const float c_bw = bytes_t / a.y;
    const float sec = fmaxf(c_cmp, c_bw) / a.x;
    if (sec < best_sec) {
      best_sec = sec;
      best_t = t;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dse_eval_kernel(const float* __restrict__ tiles, const float* __restrict__ ops,
                float* __restrict__ out, int B, int T, int N, int G, int R) {
  extern __shared__ float4 s_rec[];  // [G T] records a, then [G T] b
  const int b0 = blockIdx.x * G;
  const int n0 = blockIdx.y * R;
  const int nb = min(G, B - b0);
  const int nr = min(R, N - n0);
  float4* rec_a = s_rec;
  float4* rec_b = s_rec + G * T;

  // ---- one record per (candidate, slot) ----------------------------------
  for (int i = threadIdx.x; i < nb * T; i += kThreads) {
    const float* f = tiles + (static_cast<size_t>(b0) * T + i) * kTileFields;
    const float exists = f[0], num_macs = f[1], lanes = f[2];
    const float clock = f[3], eta = f[4], sfu_mask = f[5];
    const float sfu_par = f[6], prec_ok = f[7], e_mac = f[8], bw = f[9];
    const bool mac_ok = num_macs > 0.0f && prec_ok > 0.0f;
    const bool dsp_ok = lanes > 0.0f;
    const bool here = exists > 0.0f;
    unsigned fl = ((mac_ok || dsp_ok) && here ? kOkMac : 0u) |
                  (dsp_ok && here ? kOkOther : 0u) | (mac_ok ? kMacOk : 0u);
    fl |= (native_bit(sfu_mask, 1.0f) ? 1u : 0u) << kNativeShift;
    fl |= (native_bit(sfu_mask, 2.0f) ? 1u : 0u) << (kNativeShift + 1);
    fl |= (native_bit(sfu_mask, 4.0f) ? 1u : 0u) << (kNativeShift + 2);
    rec_a[i] = make_float4(clock, fmaxf(bw / clock, 1e-9f),
                           fmaxf(num_macs * eta, 1e-9f), __uint_as_float(fl));
    rec_b[i] = make_float4(fmaxf(lanes, 1.0f), fmaxf(sfu_par, 1.0f), sfu_mask,
                           e_mac);
  }
  __syncthreads();

  // ---- one item (b, n) per thread and round ------------------------------
  for (int it = threadIdx.x; it < nb * nr; it += kThreads) {
    const int g = it / nr;
    const int n = n0 + it % nr;
    const float* o = ops + static_cast<size_t>(n) * kOpFields;
    const float op_cls = __ldg(o), macs = __ldg(o + 1), elems = __ldg(o + 2);
    const float bytes_t = __ldg(o + 3), seq_len = __ldg(o + 4);
    const float sfu_kind = __ldg(o + 5), sfu_n = __ldg(o + 6);
    const float4* ra = rec_a + g * T;
    const float4* rb = rec_b + g * T;
    float best_sec = INFINITY;
    int best_t = 0;
    if (op_cls == 0.0f) {
      walk_slots<0>(ra, rb, T, macs, 2.0f * macs, 0.f, 0.f, 0.f, 0.f, 0.f, -1,
                    bytes_t, best_sec, best_t);
    } else if (op_cls == 2.0f) {
      const float kind = fmaxf(sfu_kind, 1.0f);
      const int shift = kind == 1.0f   ? kNativeShift
                        : kind == 2.0f ? kNativeShift + 1
                        : kind == 4.0f ? kNativeShift + 2
                                       : -1;
      walk_slots<2>(ra, rb, T, 0.f, 0.f, 0.f, 10.0f * elems, 0.f,
                    elems * log2f(fmaxf(sfu_n, 2.0f)), kind, shift, bytes_t,
                    best_sec, best_t);
    } else {
      walk_slots<1>(ra, rb, T, 0.f, 0.f, 2.0f * elems, 0.f,
                    sqrtf(fmaxf(seq_len, 1.0f)), 0.f, 0.f, -1, bytes_t,
                    best_sec, best_t);
    }
    float2 r;
    r.x = best_sec;
    r.y = __fadd_rn(__fmul_rn(macs, rb[best_t].w), __fmul_rn(elems, 0.5f));
    reinterpret_cast<float2*>(out)[static_cast<size_t>(b0 + g) * N + n] = r;
  }
}

}  // namespace

extern "C" {

// tiles (B, T, 10), ops (N, 7), out (B, N, 2): float32 device pointers;
// 1 <= T <= 1536 (the wrapper takes T <= 64).
int dse_eval_launch(const float* tiles, const float* ops, float* out, int B,
                    int T, int N, void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (T < 1 || T > kMaxRecords) return static_cast<int>(cudaErrorInvalidValue);
  // R ops a block: all N up to kMaxOps, else equal column blocks
  const int cols = (N + kMaxOps - 1) / kMaxOps;
  const int R = (N + cols - 1) / cols;
  // G candidates a block: about kItems items, records within kMaxRecords
  int G = (kItems + R - 1) / R;
  G = min(G, kMaxRecords / T);
  G = max(1, min(G, B));
  if (cols > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + G - 1) / G, cols);
  const size_t smem = 2 * static_cast<size_t>(G) * T * sizeof(float4);
  dse_eval_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      tiles, ops, out, B, T, N, G, R);
  return static_cast<int>(cudaGetLastError());
}

const char* dse_eval_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
