// Nearest-code assignment with a streaming argmin, for Hopper (sm_90a):
//   ids[n] = argmin_m (||c_m||^2 - 2 x_n . c_m),  first minimum on ties,
// for x [N, d] and a codebook [M, d] in one storage type T, products and
// sums in fp32.
//
// Replaces schemanet_tpu/ops/pallas/vq.py vq_assign_pallas. The TPU kernel
// tiled N x M on the MXU and carried the running (min, argmin) of each row
// in VMEM across the sequential M grid axis. Hopper's blocks run in parallel
// and in no order, so here the code axis is cut into S segments: block
// (row tile, segment) streams its segment's code tiles through shared memory
// in ascending order, keeps each row's running (min, argmin) in registers,
// and writes one (score, id) partial per row and segment; a second small
// launch takes the first minimum over the S partials in segment order. The
// [N, M] score matrix never exists in device memory. The wrapper picks S so
// that a small N (a k-means minibatch of 1,024 rows) still fills the card.
//
// What bounds it on the card: 2 N M d fp32 operations against N d + M d
// inputs, so operations (a Lloyd step at N = 200,000, M = 1,024, d = 192 is
// 78.6 GFLOP, 1.17 ms at the 67 TFLOP/s fp32 rate). The products are fp32
// FMA on 64 x 64 shared-memory tiles, 4 x 4 a thread: right first.
// Tensor-core tiles (TF32 would change the ids; a 3xTF32 split would not)
// are later work.
//
// Ties: within a thread codes are visited in ascending order and a later
// code must be strictly smaller; the threads of a row then reduce
// lexicographically on (score, id), and the segments in ascending order,
// so the result is the first minimum over all codes, as torch.argmin gives.
// Codes and rows past the end are bounds-checked, never padded.
//
// The squared norms are a tiny pre-pass (one warp per code, fp32), written
// to a scratch vector the wrapper allocates.
#include "common.cuh"

namespace sn {

constexpr int kVqBN = 64, kVqBM = 64, kVqKC = 32, kVqTM = 4, kVqTN = 4;
constexpr int kVqTX = kVqBM / kVqTN;  // 16 threads across the codes of a tile

template <typename T>
__global__ void __launch_bounds__(kThreads)
    vq_norms_kernel(const T* __restrict__ cb, float* __restrict__ cnorm, int M, int d) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int code = blockIdx.x * (kThreads / 32) + warp;
  if (code >= M) return;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float v = Num<T>::load(cb, (long)code * d + c);
    s = fmaf(v, v, s);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) cnorm[code] = s;
}

__device__ __forceinline__ bool vq_better(float s, int i, float best, int besti) {
  return s < best || (s == best && i < besti);
}

// grid (row tiles, segments); segment s covers codes [s * seg, (s+1) * seg)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    vq_assign_kernel(const T* __restrict__ x, const T* __restrict__ cb,
                     const float* __restrict__ cnorm, float* __restrict__ part_s,
                     int* __restrict__ part_i, int N, int M, int d, int seg) {
  __shared__ float xs[kVqKC][kVqBN + 1];
  __shared__ float cs[kVqKC][kVqBM + 1];
  const int tid = threadIdx.x;
  const int tx = tid % kVqTX, ty = tid / kVqTX;
  const int row0 = blockIdx.x * kVqBN;
  const int m_lo = blockIdx.y * seg, m_hi = min(M, m_lo + seg);
  float best[kVqTM];
  int besti[kVqTM];
#pragma unroll
  for (int i = 0; i < kVqTM; ++i) {
    best[i] = INFINITY;
    besti[i] = m_lo;
  }
  for (int m0 = m_lo; m0 < m_hi; m0 += kVqBM) {
    float acc[kVqTM][kVqTN];
#pragma unroll
    for (int i = 0; i < kVqTM; ++i)
#pragma unroll
      for (int j = 0; j < kVqTN; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < d; k0 += kVqKC) {
      __syncthreads();
      // loads run along k (coalesced); the +1 pads keep the transposing
      // stores free of bank conflicts
      for (int idx = tid; idx < kVqBN * kVqKC; idx += kThreads) {
        const int kk = idx % kVqKC, r = idx / kVqKC;
        const int k = k0 + kk, row = row0 + r, code = m0 + r;
        xs[kk][r] = (row < N && k < d) ? Num<T>::load(x, (long)row * d + k) : 0.f;
        cs[kk][r] = (code < m_hi && k < d) ? Num<T>::load(cb, (long)code * d + k) : 0.f;
      }
      __syncthreads();
      const int kmax = min(kVqKC, d - k0);
      for (int kk = 0; kk < kmax; ++kk) {
        float a[kVqTM], b[kVqTN];
#pragma unroll
        for (int i = 0; i < kVqTM; ++i) a[i] = xs[kk][ty * kVqTM + i];
#pragma unroll
        for (int j = 0; j < kVqTN; ++j) b[j] = cs[kk][tx + kVqTX * j];
#pragma unroll
        for (int i = 0; i < kVqTM; ++i)
#pragma unroll
          for (int j = 0; j < kVqTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    // epilogue: codes of this thread in ascending order, strictly smaller wins
#pragma unroll
    for (int j = 0; j < kVqTN; ++j) {
      const int code = m0 + tx + kVqTX * j;
      if (code >= m_hi) continue;
      const float cn = cnorm[code];
#pragma unroll
      for (int i = 0; i < kVqTM; ++i) {
        const float s = cn - 2.f * acc[i][j];
        if (s < best[i]) {
          best[i] = s;
          besti[i] = code;
        }
      }
    }
  }
  // the 16 threads of a row are 16 neighbouring lanes of one warp
#pragma unroll
  for (int i = 0; i < kVqTM; ++i) {
#pragma unroll
    for (int o = kVqTX / 2; o > 0; o >>= 1) {
      const float s = __shfl_xor_sync(0xffffffffu, best[i], o);
      const int id = __shfl_xor_sync(0xffffffffu, besti[i], o);
      if (vq_better(s, id, best[i], besti[i])) {
        best[i] = s;
        besti[i] = id;
      }
    }
    const int row = row0 + ty * kVqTM + i;
    if (tx == 0 && row < N) {
      part_s[(long)blockIdx.y * N + row] = best[i];
      part_i[(long)blockIdx.y * N + row] = besti[i];
    }
  }
}

// the first minimum over the segments, in ascending order
__global__ void __launch_bounds__(kThreads)
    vq_reduce_kernel(const float* __restrict__ part_s, const int* __restrict__ part_i,
                     int* __restrict__ ids, int N, int S) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= N) return;
  float best = part_s[row];
  int besti = part_i[row];
  for (int s = 1; s < S; ++s) {
    const float v = part_s[(long)s * N + row];
    if (v < best) {
      best = v;
      besti = part_i[(long)s * N + row];
    }
  }
  ids[row] = besti;
}

template <typename T>
cudaError_t vq_assign_impl(const void* x, const void* cb, void* cnorm, void* part_s,
                           void* part_i, void* ids, int N, int M, int d, int S,
                           cudaStream_t stream) {
  if (N == 0) return cudaSuccess;
  const int warps = kThreads / 32;
  vq_norms_kernel<T><<<(M + warps - 1) / warps, kThreads, 0, stream>>>(
      static_cast<const T*>(cb), static_cast<float*>(cnorm), M, d);
  // segments of whole code tiles
  const int tiles = (M + kVqBM - 1) / kVqBM;
  const int seg = ((tiles + S - 1) / S) * kVqBM;
  const int segs = (M + seg - 1) / seg;
  dim3 grid((N + kVqBN - 1) / kVqBN, segs);
  vq_assign_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(cb), static_cast<const float*>(cnorm),
      static_cast<float*>(part_s), static_cast<int*>(part_i), N, M, d, seg);
  vq_reduce_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_i),
      static_cast<int*>(ids), N, segs);
  return cudaGetLastError();
}

}  // namespace sn

// x [N, d], cb [M, d] in one dtype; cnorm fp32 [M], part_s fp32 [S, N],
// part_i int32 [S, N] scratch; ids int32 [N]. S is an upper bound on the
// segments (the launcher may use fewer, never more).
extern "C" int sn_vq_assign(int dtype, const void* x, const void* cb, void* cnorm, void* part_s,
                            void* part_i, void* ids, int N, int M, int d, int S, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == sn::kF32)
    return sn::vq_assign_impl<float>(x, cb, cnorm, part_s, part_i, ids, N, M, d, S, s);
  return sn::vq_assign_impl<__nv_bfloat16>(x, cb, cnorm, part_s, part_i, ids, N, M, d, S, s);
}
