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

// ---------------------------------------------------------------------------
// fp32 products on the TF32 tensor cores by the 3xTF32 split: v = hi + lo,
// hi = tf32(v), lo = tf32(v - hi), both rounded to nearest (ties away) by
// cvt.rna; a product x w is x_lo w_hi + x_hi w_lo + x_hi w_hi in one fp32
// accumulator (x_lo w_lo dropped), about fp32's accuracy at three TF32
// products. The split is done once per element, as a tile is stored into
// shared memory in two planes (hi, lo), never per mma. An 8 x 16-byte
// ldmatrix gives lane l the 32-bit word (l / 4, l % 4), which is the TF32
// m16n8k8 A and B layout, so the bf16 fragment loaders below read TF32
// planes as bf16 pairs (pitch and k in 2-byte units).
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void tf32_split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

__device__ __forceinline__ void tf32_split4(const float4& v, uint4& hi, uint4& lo) {
  tf32_split(v.x, hi.x, lo.x);
  tf32_split(v.y, hi.y, lo.y);
  tf32_split(v.z, hi.z, lo.z);
  tf32_split(v.w, hi.w, lo.w);
}

// c += a b: A 16x8 (row), B 8x8 (col), TF32 in, fp32 accumulated
__device__ __forceinline__ void mma1688_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b for split operands: the three TF32 products, small terms first
__device__ __forceinline__ void mma1688_split(float (&c)[4], const uint32_t (&ah)[4],
                                              const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                              uint32_t bl0, uint32_t bl1) {
  mma1688_tf32(c, al, bh0, bh1);
  mma1688_tf32(c, ah, bl0, bl1);
  mma1688_tf32(c, ah, bh0, bh1);
}

// two fp32 values rounded to bf16 (nearest even), the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// mma operands from bf16 shared-memory tiles of row pitch `pitch` elements
// (a multiple of 8, padded by 16 bytes so the 8 rows an ldmatrix reads fall on
// distinct banks). In the C fragment of an m16n8 product, lane t holds rows
// t/4 and t/4 + 8 and columns 2 (t % 4) and 2 (t % 4) + 1.
//
// A (16 rows x 16 of k): rows m0.. and columns k0.. of a [m][k] tile
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const bf16* tile, int pitch, int m0,
                                       int k0, int lane) {
  ldsm_x4(a, tile + (m0 + (lane & 15)) * pitch + k0 + (lane >> 4) * 8);
}

// A (16 rows x 16 of k) of the transpose of a [k][m] tile: its rows k0..,
// columns m0..
__device__ __forceinline__ void ldsm_a_t(uint32_t (&a)[4], const bf16* tile, int pitch, int k0,
                                         int m0, int lane) {
  const int i = lane >> 3;
  ldsm_x4_trans(a, tile + (k0 + (lane & 7) + (i >> 1) * 8) * pitch + m0 + (i & 1) * 8);
}

// B of two n8 tiles (16 of k x 16 of n): b[0], b[1] for columns n0.., b[2],
// b[3] for n0 + 8..; from a [n][k] tile (rows n0.., columns k0..)
__device__ __forceinline__ void ldsm_b_nk(uint32_t (&b)[4], const bf16* tile, int pitch, int n0,
                                          int k0, int lane) {
  ldsm_x4(b, tile + (n0 + (lane & 7) + (lane >> 4) * 8) * pitch + k0 + ((lane >> 3) & 1) * 8);
}

// B of one n8 tile over 32 of k: b[0], b[1] for k0.., b[2], b[3] for
// k0 + 16..; from a [n][k] tile (rows n0.., columns k0..)
__device__ __forceinline__ void ldsm_b_nk_k32(uint32_t (&b)[4], const bf16* tile, int pitch,
                                              int n0, int k0, int lane) {
  ldsm_x4(b, tile + (n0 + (lane & 7)) * pitch + k0 + (lane >> 3) * 8);
}

// the same from a [k][n] tile (rows k0.., columns n0..), by ldmatrix.trans
__device__ __forceinline__ void ldsm_b_kn(uint32_t (&b)[4], const bf16* tile, int pitch, int k0,
                                          int n0, int lane) {
  ldsm_x4_trans(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * pitch + n0 +
                       (lane >> 4) * 8);
}

// Rows [row0, row0 + R) and columns [col0, col0 + C) of a row-major bf16
// matrix (nrows x ncols, row stride ld) into a [R][pitch] shared tile by
// 16-byte cp.async, THREADS threads; chunks at or past nrows or ncols are
// zero. C, ld, ncols and col0 are multiples of 8 and the matrix is 16-byte
// aligned. The caller commits the group.
template <int THREADS>
__device__ __forceinline__ void stage_tile(bf16* dst, int pitch, const bf16* src, long ld,
                                           long nrows, int ncols, long row0, int col0, int R,
                                           int C) {
  const int chunks = C / 8;
  for (int idx = threadIdx.x; idx < R * chunks; idx += THREADS) {
    const int r = idx / chunks, c = (idx % chunks) * 8;
    const long row = row0 + r;
    const int col = col0 + c;
    const bool in = row < nrows && col < ncols;
    cp_async16(dst + r * pitch + c, in ? src + row * ld + col : src, in ? 16 : 0);
  }
}

// Raises the dynamic shared-memory limit of `kernel` when `bytes` is above
// the 48 KB that every kernel gets without asking.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The blocks of `threads` threads and `smem` bytes of dynamic shared memory
// that the card holds at once: resident blocks an SM times the SMs. The
// answers are kept by (kernel, threads, smem) in a small table, so a launch
// asks the runtime once per shape.
template <typename Kernel>
inline int resident_blocks(Kernel kernel, int threads, size_t smem) {
  struct Entry {
    const void* fn;
    int threads;
    size_t smem;
    int blocks;
  };
  static Entry table[32];
  static int used = 0;
  const void* fn = reinterpret_cast<const void*>(kernel);
  for (int i = 0; i < used; ++i)
    if (table[i].fn == fn && table[i].threads == threads && table[i].smem == smem)
      return table[i].blocks;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  const int blocks = (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  table[used < 32 ? used++ : 31] = {fn, threads, smem, blocks};
  return blocks;
}

// N contiguous values of T as fp32, loaded and stored in one piece: 16 bytes
// (N = 8 bf16 or 4 fp32) through one vector instruction, or N = 1 for rows
// that are not 16-byte aligned. Raw holds the bits as loaded; get(k) widens
// value k (k known at compile time once the loops are unrolled).
template <typename T, int N>
struct Pack;

template <>
struct Pack<bf16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const bf16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ Raw zero() { return make_uint4(0, 0, 0, 0); }
  static __device__ __forceinline__ float get(const Raw& r, int k) {
    const uint32_t w = k < 2 ? r.x : k < 4 ? r.y : k < 6 ? r.z : r.w;
    return __uint_as_float(k & 1 ? (w & 0xffff0000u) : (w << 16));
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&v)[8]) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                              pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  }
};

template <>
struct Pack<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ Raw zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ float get(const Raw& r, int k) {
    return k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <typename T>
struct Pack<T, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(const T* p) { return Num<T>::load(p, 0); }
  static __device__ __forceinline__ Raw zero() { return 0.f; }
  static __device__ __forceinline__ float get(const Raw& r, int) { return r; }
  static __device__ __forceinline__ void store(T* p, const float (&v)[1]) {
    Num<T>::store(p, 0, v[0]);
  }
};

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
// (mean, rstd) of one row of x, by the warp that calls it (lane c sums
// columns c, c + 32, ...); every lane ends with the same bits
template <typename T>
__device__ __forceinline__ void layernorm_stats(const T* x, long base, int dim, float eps,
                                                int lane, float& mean, float& rstd) {
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
  mean = s / dim;
  const float var = fmaxf(s2 / dim - mean * mean, 0.f);
  rstd = 1.f / sqrtf(var + eps);
}

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
    float mean, rstd;
    layernorm_stats<T>(x, base, dim, eps, lane, mean, rstd);
    for (int c = lane; c < dim; c += 32) {
      const float v = Num<T>::load(x, base + c);
      dst[c] = Num<T>::round((v - mean) * rstd * scale[c] + bias[c]);
    }
  }
  __syncthreads();
}

// The same LayerNorm of bf16 rows, rounded to bf16 into a [BM][pitch] tile
// (the A operand of a tensor-core product); rows past `rows_here` are zero.
// The caller synchronises.
template <int BM>
__device__ __forceinline__ void layernorm_rows_bf16(const bf16* x, long row0, int rows_here,
                                                    int dim, const float* scale,
                                                    const float* bias, float eps, bf16* dst,
                                                    int pitch) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += kThreads / 32) {
    bf16* row = dst + r * pitch;
    if (r >= rows_here) {
      for (int c = lane; c < dim; c += 32) row[c] = __float2bfloat16(0.f);
      continue;
    }
    const long base = (row0 + r) * (long)dim;
    float mean, rstd;
    layernorm_stats<bf16>(x, base, dim, eps, lane, mean, rstd);
    for (int c = lane; c < dim; c += 32) {
      const float v = __bfloat162float(x[base + c]);
      row[c] = __float2bfloat16((v - mean) * rstd * scale[c] + bias[c]);
    }
  }
}

// The same LayerNorm of fp32 rows, split into TF32 planes hi and lo, each
// [BM][pitch] words (the A operand of a split-TF32 product); rows past
// `rows_here` are zero. The caller synchronises.
template <int BM>
__device__ __forceinline__ void layernorm_rows_tf32(const float* x, long row0, int rows_here,
                                                    int dim, const float* scale,
                                                    const float* bias, float eps, uint32_t* hi,
                                                    uint32_t* lo, int pitch) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += kThreads / 32) {
    if (r >= rows_here) {
      for (int c = lane; c < dim; c += 32) hi[r * pitch + c] = lo[r * pitch + c] = 0u;
      continue;
    }
    const long base = (row0 + r) * (long)dim;
    float mean, rstd;
    layernorm_stats<float>(x, base, dim, eps, lane, mean, rstd);
    for (int c = lane; c < dim; c += 32)
      tf32_split((x[base + c] - mean) * rstd * scale[c] + bias[c], hi[r * pitch + c],
                 lo[r * pitch + c]);
  }
}

// Defined in attention.cu, launched by encoder_block.cu's attn_block: the
// bf16 tensor-core attention forward at p = 0 on qkv [bs, n, 3 H d] into out
// [bs, n, H d], and, where hmean is not null, the head-mean of the
// pre-softmax scores into hmean [bs, n, n]. d a multiple of 16 up to 64,
// n <= 320.
cudaError_t mhsa_tc_forward(const void* qkv, void* out, void* hmean, int bs, int n, int heads,
                            int d, float scale, cudaStream_t stream);

}  // namespace sn
