// Block-tiled matrix products with an epilogue, for the FFN widths that the
// one-launch kernels do not hold (fused_mlp at 384 and 768, ffn_block's fc2
// at 768; mlp.cu and encoder_block.cu say which launches use them).
//
//   C[M][N] = A[M][K] B,  A row-major [M][K];  B [N][K] (BKN false: a weight
//   in nn.Linear layout) or [K][N] (BKN true)
//
// and every element pair (row, col), (row, col + 1) of C goes to the
// epilogue `epi(row, col, c0, c1, split)` (N even; split 0 but for the split
// sums below), which rounds, adds, stores. The
// one-launch kernels keep a whole row tile of A, or its hidden chunk, in
// shared memory: at 768 that tile alone is ~100 KB. These take a fixed tile
// of C and stream all of k through shared memory, so any width fits; the
// price is a hidden state that goes through device memory between two
// launches.
//
//   * gemm_tc_kernel (bf16, tensor cores): one block of 8 warps a 64 x 128
//     tile of C, k in steps of 32 double-buffered by cp.async (30 KB of
//     static shared memory), each warp 32 x 32 (2 x 4 mma.sync m16n8k16
//     fragments), fp32 sums. K and, for BKN, N multiples of 8 (16-byte
//     copies; chunks past the end are zero).
//   * gemm_fma_kernel (fp32 by FMA): one block of 256 threads a 64 x 64
//     tile, 4 x 4 a thread, k in chunks of 16 through shared memory; A may
//     also be read as [K][M] (AKM: the transpose of a row-major matrix, for
//     the weight gradients x^T dH). The k range of blockIdx.z is [z ks,
//     (z + 1) ks): split sums, each to its own partial, summed later in a
//     fixed order. FMA keeps fp32's agreement, where one TF32 product would
//     not.
// Each element's sum runs over k in ascending order, the same on every run.
#pragma once

#include "common.cuh"

namespace sn {

constexpr int kGmM = 64, kGmN = 128, kGmK = 32;  // gemm_tc_kernel tile

template <bool BKN>
struct GemmTcSmem {
  static constexpr int kPitchA = kGmK + 8;  // A [64][32 + 8]
  static constexpr int kA = kGmM * kPitchA;
  static constexpr int kPitchB = BKN ? kGmN + 8 : kGmK + 8;  // B [32][136] or [128][40]
  static constexpr int kB = BKN ? kGmK * kPitchB : kGmN * kPitchB;
  static constexpr int kStage = kA + kB;
};

template <bool BKN, typename Epi>
__global__ void __launch_bounds__(kThreads)
    gemm_tc_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b, int M, int N, int K,
                   Epi epi) {
  using S = GemmTcSmem<BKN>;
  __shared__ __align__(16) bf16 smem[2 * S::kStage];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 32 x 32 of the 64 x 128 tile
  const long m0 = (long)blockIdx.x * kGmM;
  const int n0 = blockIdx.y * kGmN;
  const int steps = (K + kGmK - 1) / kGmK;
  auto load = [&](int s) {
    bf16* at = smem + (s & 1) * S::kStage;
    bf16* bt = at + S::kA;
    const int k0 = s * kGmK;
    stage_tile<kThreads>(at, S::kPitchA, a, K, M, K, m0, k0, kGmM, kGmK);
    if (BKN)
      stage_tile<kThreads>(bt, S::kPitchB, b, N, K, N, k0, n0, kGmK, kGmN);
    else
      stage_tile<kThreads>(bt, S::kPitchB, b, K, N, K, n0, k0, kGmN, kGmK);
    cp_async_commit();
  };
  float acc[2][4][4] = {};
  load(0);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<0>();
    __syncthreads();  // step s landed; every warp is past step s - 1
    if (s + 1 < steps) load(s + 1);
    const bf16* at = smem + (s & 1) * S::kStage;
    const bf16* bt = at + S::kA;
#pragma unroll
    for (int kk = 0; kk < kGmK / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_a(af[mt], at, S::kPitchA, wm * 32 + mt * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bf[4];
        if (BKN)
          ldsm_b_kn(bf, bt, S::kPitchB, kk * 16, wn * 32 + np * 16, lane);
        else
          ldsm_b_nk(bf, bt, S::kPitchB, wn * 32 + np * 16, kk * 16, lane);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma16816(acc[mt][2 * np], af[mt], bf[0], bf[1]);
          mma16816(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long row = m0 + wm * 32 + mt * 16 + (lane >> 2) + half * 8;
        const int col = n0 + wn * 32 + nt * 8 + (lane & 3) * 2;
        if (row < M && col < N)
          epi(row, col, acc[mt][nt][half * 2], acc[mt][nt][half * 2 + 1], 0);
      }
}

// A and B bf16, 16-byte aligned; K (and N where BKN) multiples of 8, N even
template <bool BKN, typename Epi>
cudaError_t gemm_tc(const bf16* a, const bf16* b, long M, int N, int K, Epi epi,
                    cudaStream_t stream) {
  if (K % 8 || N % 2 || (BKN && N % 8)) return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  dim3 grid((unsigned)((M + kGmM - 1) / kGmM), (N + kGmN - 1) / kGmN);
  gemm_tc_kernel<BKN, Epi><<<grid, kThreads, 0, stream>>>(a, b, (int)M, N, K, epi);
  return cudaGetLastError();
}

constexpr int kFmM = 64, kFmN = 64, kFmK = 16;  // gemm_fma_kernel tile
constexpr int kFmPitch = kFmM + 4;

template <typename T, bool AKM, bool BKN, typename Epi>
__global__ void __launch_bounds__(kThreads)
    gemm_fma_kernel(const T* __restrict__ a, const T* __restrict__ b, int M, int N, int K,
                    int ks, Epi epi) {
  __shared__ float As[kFmK][kFmPitch];  // As[k][m]
  __shared__ float Bs[kFmK][kFmPitch];  // Bs[k][n]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long m0 = (long)blockIdx.x * kFmM;
  const int n0 = blockIdx.y * kFmN, split = blockIdx.z;
  const int k_lo = split * ks, k_hi = min(K, k_lo + ks);
  float acc[4][4] = {};
  for (int k0 = k_lo; k0 < k_hi; k0 += kFmK) {
    for (int idx = tid; idx < kFmK * kFmM; idx += kThreads) {
      // reads along the matrix's rows: k fastest for [M][K], m fastest for [K][M]
      const int kk = AKM ? idx / kFmM : idx % kFmK, mm = AKM ? idx % kFmM : idx / kFmK;
      const long m = m0 + mm;
      const int k = k0 + kk;
      As[kk][mm] = (m < M && k < k_hi)
                       ? Num<T>::load(a, AKM ? (long)k * M + m : m * (long)K + k)
                       : 0.f;
      const int kb = BKN ? idx / kFmN : idx % kFmK, nn = BKN ? idx % kFmN : idx / kFmK;
      const int n = n0 + nn, k2 = k0 + kb;
      Bs[kb][nn] = (n < N && k2 < k_hi)
                       ? Num<T>::load(b, BKN ? (long)k2 * N + n : (long)n * K + k2)
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFmK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      const int col = n0 + tx * 4 + j;
      if (col < N) epi(row, col, acc[i][j], acc[i][j + 1], split);
    }
  }
}

// splits blocks along z, each over ks of k (the last one the rest); N even
template <typename T, bool AKM, bool BKN, typename Epi>
cudaError_t gemm_fma(const T* a, const T* b, long M, int N, int K, int splits, int ks, Epi epi,
                     cudaStream_t stream) {
  if (N % 2) return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  dim3 grid((unsigned)((M + kFmM - 1) / kFmM), (N + kFmN - 1) / kFmN, splits);
  gemm_fma_kernel<T, AKM, BKN, Epi><<<grid, kThreads, 0, stream>>>(a, b, (int)M, N, K, ks, epi);
  return cudaGetLastError();
}

}  // namespace sn
