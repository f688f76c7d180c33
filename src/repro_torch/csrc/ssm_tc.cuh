// The chunk-parallel stages shared by the bf16 tensor-core scan kernels
// (ssm_scan.cu, ssm_scan_bwd.cu).  They follow the plain version,
// repro_torch/models/layers.py::ssd_scan_ref (a port of
// repro/models/layers.py::ssd_scan_ref), step by step: the chunk states by
// one product per chunk, the recurrence over chunks on the (P, N) states
// only, the chunk outputs by products per chunk.
//
// Tiles.  A chunk of L rows is cut into T = ceil(L / 64) tiles of at most
// 64 rows (wgmma's M), every one full but the last; any L.  Every stage
// works on tiles, with seg = cumsum(dt a) restarting at each tile, which
// is the SSD algorithm with chunks of the tiles' lengths (the same
// function; its float32 sums in another order).  A tile is brought in as
// a full 64-row TMA box; its rows past the chunk's end (which belong to
// the next chunk, or lie past S and read as zeros) count as dt = 0, so
// seg stays flat there and nothing decays or adds, and every product
// that sums over rows masks them out.  Tile tau of a (batch, head) is
// chunk tau / T, part tau % T, with T = ceil(L / 64) tiles a chunk.
//
// Stages here:
//   (a) chunk_states_kernel: out[tau] = V^T diag(w) M over the tile's rows
//       j, a (P x 64)(64 x N) product: wgmma m64 n=N k16 x 4, with
//       A = (v_jp w_j) from registers as two bf16 parts (hi = bf16(v),
//       lo = bf16(v - hi)) and M's tile the MN-major B operand.  The
//       forward takes V = x, M = b, w_j = exp(seg_last - seg_j) dt_j (the
//       chunk states state_c) and writes exp(seg_last) per tile; the
//       backward also takes V = dy, M = c, w_i = exp(seg_i) (M_k, the
//       gradient that the tile's outputs send to its entering state).
//       P < 64 leaves rows of A zero.  float32 out, (B H, n_tiles, P, N).
//   (b) pass_kernel: the recurrence over the tiles of each (batch, head),
//       in float32, in the reference's order: forward
//         S_in[tau] = S;  S = exp(seg_last,tau) S + state_c[tau],
//       reverse (from the last tile, D = 0)
//         D_out[tau] = D;  D = exp(seg_last,tau) D + M[tau].
//       It overwrites its input in place with S_in (or D_out).
//
// The launches use the caller's stream and allocate nothing.

#pragma once

#include "hopper_tc.cuh"

namespace ssm {

constexpr int kRows = tc::kRows;       // rows of a tile
constexpr int kThreads = tc::kWarpgroup;
constexpr int kPassThreads = 256;

// where tile tau of a (batch, head) lies: its first row and its length
struct TileRows {
  int row0, len;
  __device__ __forceinline__ TileRows(int tau, int L) {
    const int per = (L + kRows - 1) / kRows;
    const int part = tau % per;
    row0 = (tau / per) * L + part * kRows;
    len = min(kRows, L - part * kRows);
  }
};

// Threads 0..63 (warps 0 and 1) load dt of the tile's rows (0 past len)
// into dt_s and take seg = cumsum(dt a) into seg_s by a warp scan; the
// other threads pass.  Ends with a barrier.
__device__ __forceinline__ void tile_seg(const float* __restrict__ dt,
                                         size_t first, int H, int len,
                                         float a, float* dt_s, float* seg_s,
                                         float* tmp) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  float v = 0.f;
  if (tid < kRows) {
    const float d = tid < len ? dt[first + static_cast<size_t>(tid) * H] : 0.f;
    dt_s[tid] = d;
    v = d * a;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, v, s);
      if (lane >= s) v += o;
    }
    if (lane == 31) tmp[tid >> 5] = v;
  }
  __syncthreads();
  if (tid < kRows) seg_s[tid] = tid >= 32 ? v + tmp[0] : v;
  __syncthreads();
}

// a float32 value as two bf16 parts, packed in pairs for wgmma's A
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const float h0 = tc::round_bf16(v0), h1 = tc::round_bf16(v1);
  hi = tc::pack_bf16(h0, h1);
  lo = tc::pack_bf16(v0 - h0, v1 - h1);
}

// the bf16 element (row, col) of a tile at generic address base
template <int D>
__device__ __forceinline__ float tile_at(const uint8_t* base, int row,
                                         int col) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
      base + tc::Tile<D>::offset(row, col)));
}

// Writes rows 0..P-1 of the float32 (P, N) matrix at src as two bf16
// tiles of D = N columns (hi, lo) in the swizzled layout, by all the
// block's threads; returns this thread's share of sum(src * other) when
// other is not null.
template <int P, int N>
__device__ __forceinline__ float stage_split(const float* __restrict__ src,
                                             const float* __restrict__ other,
                                             uint8_t* hi, uint8_t* lo) {
  float dot = 0.f;
  for (int idx = threadIdx.x; idx < P * N / 2; idx += kThreads) {
    const int p = idx / (N / 2), n = 2 * (idx % (N / 2));
    const float2 v = *reinterpret_cast<const float2*>(src + 2 * idx);
    if (other != nullptr) {
      const float2 o = *reinterpret_cast<const float2*>(other + 2 * idx);
      dot = fmaf(v.x, o.x, fmaf(v.y, o.y, dot));
    }
    uint32_t h, l;
    split2(v.x, v.y, h, l);
    const uint32_t off = tc::Tile<N>::offset(p, n);
    *reinterpret_cast<uint32_t*>(hi + off) = h;
    *reinterpret_cast<uint32_t*>(lo + off) = l;
  }
  return dot;
}

template <int P, int N>
constexpr size_t states_smem_bytes() {
  return tc::Tile<P>::kBytes + tc::Tile<N>::kBytes + 8 + 3 * kRows * 4 +
         8 + 1024;  // + 1 KB to align
}

// Stage (a); grid (n_tiles, H, B), one warpgroup.  bwd selects the
// weights (see above).
template <int P, int N>
__global__ void __launch_bounds__(kThreads)
chunk_states_kernel(const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_m,
                    const float* __restrict__ dt,
                    const float* __restrict__ a_log,
                    float* __restrict__ out, float* __restrict__ decay,
                    int S, int H, int L, int bwd) {
  using TileV = tc::Tile<P>;
  using TileM = tc::Tile<N>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t v_s = tc::align1024(smem_raw);
  const uint32_t m_s = v_s + TileV::kBytes;
  const uint32_t bar = m_s + TileM::kBytes;
  uint8_t* gen = smem_raw + (v_s - tc::smem_u32(smem_raw));
  float* dt_s = reinterpret_cast<float*>(gen + (bar + 8 - v_s));
  float* seg_s = dt_s + kRows;
  float* w_s = seg_s + kRows;
  float* tmp = w_s + kRows;

  const int tid = threadIdx.x;
  const int tau = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nt = gridDim.x;
  const TileRows tr(tau, L);
  if (tid == 0) {
    tc::mbar_init(bar, 1);
    tc::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    tc::mbar_expect_tx(bar, TileV::kBytes + TileM::kBytes);
    TileV::load_4d(v_s, &tm_v, bar, tr.row0, b, h);
    TileM::load(m_s, &tm_m, bar, tr.row0, b);
  }
  const float a = -expf(a_log[h]);
  tile_seg(dt, (static_cast<size_t>(b) * S + tr.row0) * H + h, H, tr.len, a,
           dt_s, seg_s, tmp);
  const float seg_last = seg_s[kRows - 1];
  if (tid < kRows)
    w_s[tid] = bwd ? (tid < tr.len ? expf(seg_s[tid]) : 0.f)
                   : expf(seg_last - seg_s[tid]) * dt_s[tid];
  __syncthreads();
  tc::mbar_wait(bar, 0);

  // A[p][j] = v[j][p] w_j for this thread's rows p and columns j
  // (hopper_tc.cuh's fragment layout), as two bf16 parts
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  uint32_t ahi[4][4], alo[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int p = r0 + 8 * (x & 1);
      const int j = 16 * kk + 8 * (x >> 1) + c0;
      float v0 = 0.f, v1 = 0.f;
      if (p < P) {
        v0 = tile_at<P>(gen, j, p) * w_s[j];
        v1 = tile_at<P>(gen, j + 1, p) * w_s[j + 1];
      }
      split2(v0, v1, ahi[kk][x], alo[kk][x]);
    }
  float acc[N / 2];
  tc::wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    tc::Wgmma<N>::template rs<1>(acc, ahi[kk], TileM::mnmajor(m_s, kk),
                                 kk > 0);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    tc::Wgmma<N>::template rs<1>(acc, alo[kk], TileM::mnmajor(m_s, kk), 1);
  tc::wg_commit();
  tc::wg_wait<0>();
  tc::fence_operand(acc);

  const size_t bt = static_cast<size_t>(b) * H + h;
  float* dst = out + (bt * nt + tau) * P * N;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = r0 + 8 * i;
    if (p >= P) continue;
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj)
      *reinterpret_cast<float2*>(dst + p * N + 8 * jj + c0) =
          make_float2(acc[4 * jj + 2 * i], acc[4 * jj + 2 * i + 1]);
  }
  if (!bwd && tid == 0) decay[bt * nt + tau] = expf(seg_last);
}

// Stage (b); grid (ceil(P N / 4 / 256), B H): each thread carries four
// consecutive elements of a (batch, head)'s (P, N) state along the tiles.
__global__ void __launch_bounds__(kPassThreads)
pass_kernel(float* __restrict__ states, const float* __restrict__ decay,
            int nt, int PN, int reverse) {
  const int e = 4 * (blockIdx.x * kPassThreads + threadIdx.x);
  if (e >= PN) return;
  const size_t bt = blockIdx.y;
  float4* base = reinterpret_cast<float4*>(states + bt * nt * PN + e);
  const float* dec = decay + bt * nt;
  const int step = PN / 4;  // float4s from one tile to the next
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  int tau = reverse ? nt - 1 : 0;
  const int dir = reverse ? -1 : 1;
  float4 v = base[static_cast<size_t>(tau) * step];
  for (int n = 0; n < nt; ++n, tau += dir) {
    const bool more = n + 1 < nt;
    const float4 next =
        more ? base[static_cast<size_t>(tau + dir) * step] : v;
    const float d = dec[tau];
    base[static_cast<size_t>(tau) * step] = s;
    s = make_float4(d * s.x + v.x, d * s.y + v.y, d * s.z + v.z,
                    d * s.w + v.w);
    v = next;
  }
}

template <int P, int N>
cudaError_t launch_states(const CUtensorMap& tm_v, const CUtensorMap& tm_m,
                          const float* dt, const float* a_log, float* out,
                          float* decay, int B, int S, int H, int L, int nt,
                          int bwd, cudaStream_t stream) {
  constexpr size_t smem = states_smem_bytes<P, N>();
  cudaError_t e = cudaFuncSetAttribute(
      chunk_states_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  chunk_states_kernel<P, N><<<dim3(nt, H, B), kThreads, smem, stream>>>(
      tm_v, tm_m, dt, a_log, out, decay, S, H, L, bwd);
  return cudaGetLastError();
}

inline cudaError_t launch_pass(float* states, const float* decay, int BH,
                               int nt, int PN, int reverse,
                               cudaStream_t stream) {
  const int blocks = (PN / 4 + kPassThreads - 1) / kPassThreads;
  pass_kernel<<<dim3(blocks, BH), kPassThreads, 0, stream>>>(
      states, decay, nt, PN, reverse);
  return cudaGetLastError();
}

// the number of tiles of one (batch, head)
inline int n_tiles(int S, int L) {
  return (S / L) * ((L + kRows - 1) / kRows);
}

// calls F::template run<P, N>() for the instantiated widths, else returns
// cudaErrorInvalidValue
template <typename F>
cudaError_t dispatch(int P, int N, F&& f) {
#define SSM_TC_CASE(PP, NN) \
  if (P == PP && N == NN) return f.template run<PP, NN>();
#define SSM_TC_ROW(PP) \
  SSM_TC_CASE(PP, 16) SSM_TC_CASE(PP, 32) SSM_TC_CASE(PP, 64) \
  SSM_TC_CASE(PP, 128)
  SSM_TC_ROW(16)
  SSM_TC_ROW(32)
  SSM_TC_ROW(64)
#undef SSM_TC_ROW
#undef SSM_TC_CASE
  return cudaErrorInvalidValue;
}

}  // namespace ssm
