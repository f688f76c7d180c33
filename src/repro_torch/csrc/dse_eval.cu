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
// What bounds it on an H100: fp32 ALU work.  Each output walks T = 24 slots
// at some 15-25 flops each (three divisions among them), against 8 bytes
// written per output and a tile table that is read once per block.  The
// design keeps the ALUs fed and the memory side trivial:
//   * one thread per op column n; a block of 128 threads covers 128 ops and
//     BLOCK_B = 8 candidates, whose (8, T, 10) tile rows are staged once in
//     shared memory (every thread of a warp reads the same word: broadcast);
//   * the per-op terms (sqrt(max(seq_len, 1)), log2(max(sfu_n, 2)), the
//     class test) are hoisted out of the candidate and slot loops, and the
//     op's class picks one cost branch per thread instead of evaluating all
//     three under selects;
//   * stores are float2 per thread, consecutive threads on consecutive
//     addresses.
//
// Arithmetic: IEEE division and sqrt (no fast-math).  nvcc contracts
// macs * e_mac + elems * 0.5 into an FMA; the kernel is held to the plain
// version with the tolerances of tests/test_kernels.py::test_dse_eval
// (seconds rtol 1e-5 where finite, the same finiteness mask, energy
// rtol 1e-4 with atol 1.0), not bitwise.
//
// The launch uses the caller's stream, allocates nothing and returns
// cudaGetLastError(); the Python wrapper raises if it is not cudaSuccess.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileFields = 10;
constexpr int kOpFields = 7;
constexpr int kBlockN = 128;
constexpr int kBlockB = 8;

__global__ void __launch_bounds__(kBlockN)
dse_eval_kernel(const float* __restrict__ tiles, const float* __restrict__ ops,
                float* __restrict__ out, int B, int T, int N) {
  extern __shared__ float s_tiles[];  // kBlockB * T * kTileFields
  const int b0 = blockIdx.y * kBlockB;
  const int nb = min(kBlockB, B - b0);
  const int count = nb * T * kTileFields;
  const float* src = tiles + static_cast<size_t>(b0) * T * kTileFields;
  for (int i = threadIdx.x; i < count; i += blockDim.x) s_tiles[i] = src[i];
  __syncthreads();

  const int n = blockIdx.x * kBlockN + threadIdx.x;
  if (n >= N) return;
  const float* o = ops + static_cast<size_t>(n) * kOpFields;
  const float op_cls = o[0], macs = o[1], elems = o[2], bytes_t = o[3];
  const float seq_len = o[4], sfu_kind = o[5], sfu_n = o[6];
  const bool is_mac = op_cls == 0.0f;
  const bool is_spec = op_cls == 2.0f;
  // per-op terms, hoisted
  const float dsp_scale = sqrtf(fmaxf(seq_len, 1.0f));
  const float sfu_work = elems * log2f(fmaxf(sfu_n, 2.0f));
  const float kind = fmaxf(sfu_kind, 1.0f);
  const float half_elems = elems * 0.5f;

  for (int bb = 0; bb < nb; ++bb) {
    const float* tb = s_tiles + bb * T * kTileFields;
    float best_sec = INFINITY;
    int best_t = 0;
    for (int t = 0; t < T; ++t) {
      const float* f = tb + t * kTileFields;
      const float exists = f[0], num_macs = f[1], lanes = f[2];
      const float clock = f[3], eta = f[4], sfu_mask = f[5];
      const float sfu_par = f[6], prec_ok = f[7], bw = f[9];
      const float lanes1 = fmaxf(lanes, 1.0f);
      const bool mac_ok = num_macs > 0.0f && prec_ok > 0.0f;
      const bool dsp_ok = lanes > 0.0f;
      float c_cmp;
      bool ok;
      if (is_mac) {
        c_cmp = mac_ok ? macs / fmaxf(num_macs * eta, 1e-9f)
                       : ceilf(2.0f * macs / lanes1);
        ok = mac_ok || dsp_ok;
      } else if (is_spec) {
        const bool native = fmodf(floorf(sfu_mask / kind), 2.0f) >= 1.0f;
        c_cmp = native ? sfu_work / fmaxf(sfu_par, 1.0f)
                       : ceilf(10.0f * elems / lanes1);
        ok = dsp_ok;
      } else {
        c_cmp = ceilf(2.0f * elems / lanes1) * dsp_scale;
        ok = dsp_ok;
      }
      const float c_bw = bytes_t / fmaxf(bw / clock, 1e-9f);
      float sec = fmaxf(c_cmp, c_bw) / clock;
      if (!(ok && exists > 0.0f)) sec = INFINITY;
      if (sec < best_sec) {
        best_sec = sec;
        best_t = t;
      }
    }
    const float e_mac = tb[best_t * kTileFields + 8];
    float2 r;
    r.x = best_sec;
    r.y = macs * e_mac + half_elems;
    reinterpret_cast<float2*>(out)[static_cast<size_t>(b0 + bb) * N + n] = r;
  }
}

}  // namespace

extern "C" {

// tiles (B, T, 10), ops (N, 7), out (B, N, 2): float32 device pointers.
int dse_eval_launch(const float* tiles, const float* ops, float* out, int B,
                    int T, int N, void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((N + kBlockN - 1) / kBlockN, (B + kBlockB - 1) / kBlockB);
  const size_t smem = static_cast<size_t>(kBlockB) * T * kTileFields *
                      sizeof(float);
  dse_eval_kernel<<<grid, kBlockN, smem, static_cast<cudaStream_t>(stream)>>>(
      tiles, ops, out, B, T, N);
  return static_cast<int>(cudaGetLastError());
}

const char* dse_eval_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
