// Shared helpers of the hand-written Hopper kernels.
//
// Every kernel is templated on its storage type T (float or __nv_bfloat16)
// and computes in fp32: loads widen to float, products accumulate in fp32,
// and Num<T>::round() reproduces the rounding of a value stored in T at each
// point where the JAX reference rounds (so the bf16 kernels round exactly
// where the TPU kernels do, and the fp32 kernels never round).
//
// Each .cu file exports plain C launchers that take device pointers and a
// cudaStream_t as void*, and return the cudaError_t of the launch (0 = ok).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace sn {

enum DType : int { kF32 = 0, kBF16 = 1 };

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float load(const float* p, long i) { return p[i]; }
  static __device__ __forceinline__ void store(float* p, long i, float v) { p[i] = v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p, long i) {
    return __bfloat162float(p[i]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, long i, float v) {
    p[i] = __float2bfloat16(v);  // round to nearest even, like torch and XLA
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
};

constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// Tensor-core building blocks (bf16 in, fp32 accumulated): asynchronous copies
// into shared memory, ldmatrix / stmatrix, and mma.sync m16n8k16.
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory, asynchronously; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// BYTES (4, 8 or 16) from device to shared memory, asynchronously, through
// L1; src_bytes = 0 writes zeros. Both addresses aligned to BYTES.
template <int BYTES>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)), "l"(src),
               "n"(BYTES), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// the inverse of ldsm_x4: lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void stsm_x4(bf16* p, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   smem_addr(p)),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// c += a b: A 16x16 (row), B 16x8 (col), bf16 in, fp32 accumulated
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to bf16 (nearest even), the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Raises the dynamic shared-memory limit of `kernel` when `bytes` is above
// the 48 KB that every kernel gets without asking.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Block-level product with A in shared memory and B = W^T read from a weight
// in nn.Linear layout W[N][K] (row n holds the K inputs of output n):
//
//   acc[i][j] += sum_k As[(ty*TM + i) * lda + k] * W[(n0 + tx*TN + j) * ldw + k]
//
// over k in [0, K). kThreads threads form a (BM/TM) x (BN/TN) grid of TM x TN
// micro-tiles. W streams through `Bs` ([KC][BN+1] floats) in chunks of KC
// inputs; reads of W run along k (coalesced) and the +1 pad keeps the
// transposing shared-memory stores free of bank conflicts. Out-of-range k or
// n read as 0. Starts and ends with a barrier, so As/Bs may be rewritten
// around it.
template <typename T, int BM, int BN, int TM, int TN, int KC>
__device__ __forceinline__ void gemm_smem_a(const float* As, int lda, const T* W, int ldw,
                                            int K, int n0, int N, float* Bs,
                                            float (&acc)[TM][TN]) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "tile must use every thread");
  constexpr int TX = BN / TN;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();
    for (int idx = tid; idx < KC * BN; idx += kThreads) {
      const int kk = idx % KC, nn = idx / KC;
      const int k = k0 + kk, n = n0 + nn;
      Bs[kk * (BN + 1) + nn] = (k < K && n < N) ? Num<T>::load(W, (long)n * ldw + k) : 0.f;
    }
    __syncthreads();
    const int kmax = min(KC, K - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[(ty * TM + i) * lda + k0 + kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk * (BN + 1) + tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  __syncthreads();
}

// fp32 LayerNorm of `rows_here` rows of x (row stride `dim`) into shared
// memory, rounded to T: statistics as E[x^2] - E[x]^2 clamped at 0 (flax's
// fast variance, as the TPU kernels compute it), then scale and bias in fp32.
// One warp per row; rows past `rows_here` up to `BM` are zero-filled.
template <typename T, int BM>
__device__ __forceinline__ void layernorm_rows(const T* x, long row0, int rows_here, int dim,
                                               const float* scale, const float* bias, float eps,
                                               float* xs) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += kThreads / 32) {
    float* dst = xs + r * dim;
    if (r >= rows_here) {
      for (int c = lane; c < dim; c += 32) dst[c] = 0.f;
      continue;
    }
    const long base = (row0 + r) * (long)dim;
    float s = 0.f, s2 = 0.f;
    for (int c = lane; c < dim; c += 32) {
      const float v = Num<T>::load(x, base + c);
      s += v;
      s2 = fmaf(v, v, s2);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float mean = s / dim;
    const float var = fmaxf(s2 / dim - mean * mean, 0.f);
    const float rstd = 1.f / sqrtf(var + eps);
    for (int c = lane; c < dim; c += 32) {
      const float v = Num<T>::load(x, base + c);
      dst[c] = Num<T>::round((v - mean) * rstd * scale[c] + bias[c]);
    }
  }
  __syncthreads();
}

}  // namespace sn
