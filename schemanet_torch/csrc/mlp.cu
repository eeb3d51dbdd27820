// Fused transformer FFN, forward and backward, with in-kernel hash dropout,
// for Hopper (sm_90a).
//
// Replaces schemanet_tpu/ops/pallas/mlp.py:
//   fused_mlp forward (_mlp_kernel):      out = drop(act(x W1 + b1)) W2 + b2
//   fused_mlp backward (_mlp_bwd_kernel): dx, dW1, db1, dW2, db2 by recompute
// on x [rows, dim] (the flattened [bs, n, dim]); weights in nn.Linear layout,
// w1 [f, dim], w2 [dim, f]. Dropout keeps hidden element (row, col) by the
// hash of dropmask.cuh with stream 0, the absolute row and cols = f, so the
// backward regenerates the forward's mask under its own blocking.
//
// What bounds it on the card: at the stage-0 shape (12,608 rows, 192 -> 768
// -> 192, bf16) a forward is 7.4 GFLOP and a backward 18.6 GFLOP (five
// products) against ~10 MB and ~16 MB of operands: compute-bound, once the
// [rows, f] hidden state stays on chip. The design keeps it there:
//   * forward: one block per 32 rows; the hidden width in chunks of 64:
//     fc1 + bias + gelu + mask into shared memory, and the fc2 partial sums
//     accumulate in registers (as the frozen ffn_block does).
//   * backward, three launches. (a) dx: one block per 32 rows, the hidden
//     width in chunks: recompute h = x W1 + b1 and dA = g W2^T for the chunk,
//     dH = dA * gelu'(h) in shared memory, dx += dH W1 in registers.
//     (b) weight gradients: one block per (chunk of 64 hidden columns, split
//     of the rows); it recomputes a and dH for its chunk over its rows and
//     sums dW1, dW2, db1 (and db2) for the chunk in registers, then writes
//     them as the split's fp32 partial. (c) the partials summed in a fixed
//     order. The TPU kernel added into revisited output blocks because its
//     grid runs in order; Hopper's blocks do not, so the splits write
//     partials instead, and the sums do not depend on the run.
//   Rows past the end are zero in x and g, so they add nothing to the
//   weight gradients.
// Products are fp32 FMA on shared-memory tiles: right first. Tensor-core
// (wgmma) tiles, and a backward that does not recompute the hidden chunk
// twice, are later work.
//
// Numerics follow the TPU kernel: x W1 accumulated in fp32 and rounded once
// to T, + b1 in T, gelu with the Abramowitz-Stegun erf in fp32 rounded to T,
// dropout h * inv as a product in T (inv rounded to T first, as JAX rounds
// a weak-typed Python float), then the fp32-accumulated fc2 rounded to T,
// + b2 in T. Backward: dA * inv in fp32, dH = dA * gelu'(h) rounded to T,
// weight and bias gradients summed in fp32.
#include "common.cuh"
#include "dropmask.cuh"

namespace sn {

constexpr int kMlpBM = 32, kMlpFC = 64, kMlpKC1 = 32, kMlpKC2 = 16;
constexpr int kMlpTF = 4;  // hidden columns per thread of the weight-gradient tiles

// Block-level product with A in shared memory and B read from a weight
// stored k-major, W[K][N] (row k holds the N outputs of input k):
//   acc[i][j] += sum_k As[(ty*TM + i) * lda + k] * W[k * ldw + n0 + tx*TN + j]
// The counterpart of gemm_smem_a (common.cuh) for W^T reads.
template <typename T, int BM, int BN, int TM, int TN, int KC>
__device__ __forceinline__ void gemm_smem_a_kn(const float* As, int lda, const T* W, int ldw,
                                               int K, int n0, int N, float* Bs,
                                               float (&acc)[TM][TN]) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "tile must use every thread");
  constexpr int TX = BN / TN;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();
    for (int idx = tid; idx < KC * BN; idx += kThreads) {
      const int nn = idx % BN, kk = idx / BN;
      const int k = k0 + kk, n = n0 + nn;
      Bs[kk * (BN + 1) + nn] = (k < K && n < N) ? Num<T>::load(W, (long)k * ldw + n) : 0.f;
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

// Abramowitz & Stegun 7.1.26 erf, as the TPU kernel computes it in fp32.
__device__ __forceinline__ float erf_as(float x) {
  const float s = (float)((x > 0.f) - (x < 0.f));
  const float ax = fabsf(x);
  const float t = 1.f / (1.f + 0.3275911f * ax);
  const float poly =
      ((((1.061405429f * t + -1.453152027f) * t + 1.421413741f) * t + -0.284496736f) * t +
       0.254829592f) *
      t;
  return s * (1.f - poly * expf(-ax * ax));
}

__device__ __forceinline__ float gelu_as(float x) {
  return x * 0.5f * (1.f + erf_as(x * 0.7071067811865476f));
}

__device__ __forceinline__ float gelu_as_grad(float x) {
  const float cdf = 0.5f * (1.f + erf_as(x * 0.7071067811865476f));
  const float pdf = expf(-0.5f * x * x) * 0.3989422804014327f;
  return cdf + x * pdf;
}

// x (or g) rows [row0, row0 + BM) into xs [BM][dim]; rows past the end are 0.
template <typename T>
__device__ __forceinline__ void load_rows(const T* x, long row0, int rows_here, int dim,
                                          float* xs) {
  for (int idx = threadIdx.x; idx < kMlpBM * dim; idx += kThreads) {
    const int r = idx / dim;
    xs[idx] = r < rows_here ? Num<T>::load(x, row0 * dim + idx) : 0.f;
  }
}

// The hidden chunk [f0, f0 + FC) of a row tile for the backward: a_used (the
// dropped activation, in T; skipped when `as` is null) and dH (in T), both
// [BM][FC] in shared memory, zero past the rows and columns.
template <typename T, int kDim>
__device__ __forceinline__ void mlp_hidden_bwd(const float* xs, const float* gs, const T* w1,
                                               const T* b1, const T* w2, int f, int f0,
                                               long row0, int rows_here, float p, float inv,
                                               float inv_t, uint32_t h0, float* bs, float* as,
                                               float* hs) {
  constexpr int TM = 2, TN = 4;
  float acc_h[TM][TN] = {}, acc_d[TM][TN] = {};
  gemm_smem_a<T, kMlpBM, kMlpFC, TM, TN, kMlpKC1>(xs, kDim, w1, kDim, kDim, f0, f, bs, acc_h);
  gemm_smem_a_kn<T, kMlpBM, kMlpFC, TM, TN, kMlpKC1>(gs, kDim, w2, f, kDim, f0, f, bs, acc_d);
  const int tx = threadIdx.x % (kMlpFC / TN), ty = threadIdx.x / (kMlpFC / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int r = ty * TM + i, c = tx * TN + j, col = f0 + c;
      float a_used = 0.f, dh = 0.f;
      if (r < rows_here && col < f) {
        const float h = Num<T>::round(Num<T>::round(acc_h[i][j]) + Num<T>::load(b1, col));
        a_used = Num<T>::round(gelu_as(h));
        float da = acc_d[i][j];
        if (p > 0.f) {
          const bool keep = drop_keep(h0, (uint32_t)(row0 + r), f, col, p);
          a_used = keep ? Num<T>::round(a_used * inv_t) : 0.f;
          da = keep ? da * inv : 0.f;
        }
        dh = Num<T>::round(da * gelu_as_grad(h));
      }
      if (as != nullptr) as[r * kMlpFC + c] = a_used;
      hs[r * kMlpFC + c] = dh;
    }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
template <typename T, int TN2>
__global__ void __launch_bounds__(kThreads)
    mlp_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
                   const T* __restrict__ w2, const T* __restrict__ b2, T* __restrict__ out,
                   int rows, int f, float p, float inv, int seed) {
  constexpr int dim = 32 * TN2;
  extern __shared__ float smem[];
  float* xs = smem;                  // [BM][dim]
  float* hs = xs + kMlpBM * dim;     // [BM][FC] hidden chunk after gelu and dropout
  float* bs = hs + kMlpBM * kMlpFC;  // weight chunks
  const long row0 = (long)blockIdx.x * kMlpBM;
  const int rows_here = min(kMlpBM, rows - (int)row0);
  const uint32_t h0 = drop_stream(seed, 0);
  const float inv_t = Num<T>::round(inv);
  load_rows<T>(x, row0, rows_here, dim, xs);
  __syncthreads();

  constexpr int TM1 = 2, TN1 = 4, TM2 = 4;
  const int tx1 = threadIdx.x % (kMlpFC / TN1), ty1 = threadIdx.x / (kMlpFC / TN1);
  float acc2[TM2][TN2] = {};
  for (int f0 = 0; f0 < f; f0 += kMlpFC) {
    float acc1[TM1][TN1] = {};
    gemm_smem_a<T, kMlpBM, kMlpFC, TM1, TN1, kMlpKC1>(xs, dim, w1, dim, dim, f0, f, bs, acc1);
#pragma unroll
    for (int i = 0; i < TM1; ++i)
#pragma unroll
      for (int j = 0; j < TN1; ++j) {
        const int r = ty1 * TM1 + i, c = tx1 * TN1 + j, col = f0 + c;
        float a = 0.f;
        if (col < f) {
          const float h = Num<T>::round(Num<T>::round(acc1[i][j]) + Num<T>::load(b1, col));
          a = Num<T>::round(gelu_as(h));
          if (p > 0.f)
            a = drop_keep(h0, (uint32_t)(row0 + r), f, col, p) ? Num<T>::round(a * inv_t) : 0.f;
        }
        hs[r * kMlpFC + c] = a;
      }
    gemm_smem_a<T, kMlpBM, dim, TM2, TN2, kMlpKC2>(hs, kMlpFC, w2 + f0, f, min(kMlpFC, f - f0), 0,
                                                   dim, bs, acc2);
  }
  const int tx2 = threadIdx.x % 32, ty2 = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < TM2; ++i) {
    const int r = ty2 * TM2 + i;
    if (r >= rows_here) continue;
#pragma unroll
    for (int j = 0; j < TN2; ++j) {
      const int c = tx2 * TN2 + j;
      Num<T>::store(out, (row0 + r) * dim + c,
                    Num<T>::round(acc2[i][j]) + Num<T>::load(b2, c));
    }
  }
}

// ---------------------------------------------------------------------------
// backward (a): dx
// ---------------------------------------------------------------------------
template <typename T, int TN2>
__global__ void __launch_bounds__(kThreads)
    mlp_dx_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
                  const T* __restrict__ w2, const T* __restrict__ g, T* __restrict__ dx, int rows,
                  int f, float p, float inv, int seed) {
  constexpr int dim = 32 * TN2;
  extern __shared__ float smem[];
  float* xs = smem;                  // [BM][dim]
  float* gs = xs + kMlpBM * dim;     // [BM][dim]
  float* hs = gs + kMlpBM * dim;     // [BM][FC] dH chunk
  float* bs = hs + kMlpBM * kMlpFC;  // weight chunks
  const long row0 = (long)blockIdx.x * kMlpBM;
  const int rows_here = min(kMlpBM, rows - (int)row0);
  const uint32_t h0 = drop_stream(seed, 0);
  const float inv_t = Num<T>::round(inv);
  load_rows<T>(x, row0, rows_here, dim, xs);
  load_rows<T>(g, row0, rows_here, dim, gs);
  __syncthreads();

  constexpr int TM2 = 4;
  float acc[TM2][TN2] = {};
  for (int f0 = 0; f0 < f; f0 += kMlpFC) {
    mlp_hidden_bwd<T, dim>(xs, gs, w1, b1, w2, f, f0, row0, rows_here, p, inv, inv_t, h0, bs,
                           nullptr, hs);
    gemm_smem_a_kn<T, kMlpBM, dim, TM2, TN2, kMlpKC2>(hs, kMlpFC, w1 + (long)f0 * dim, dim,
                                                      min(kMlpFC, f - f0), 0, dim, bs, acc);
  }
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < TM2; ++i) {
    const int r = ty * TM2 + i;
    if (r >= rows_here) continue;
#pragma unroll
    for (int j = 0; j < TN2; ++j) Num<T>::store(dx, (row0 + r) * dim + tx * TN2 + j, acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// backward (b): fp32 partial weight and bias gradients of one (hidden chunk,
// row split). part holds, per split: dW1 [f][dim], dW2 [dim][f], db1 [f],
// db2 [dim] (db2 from the blocks of chunk 0 only).
// ---------------------------------------------------------------------------
template <typename T, int TN2>
__global__ void __launch_bounds__(kThreads)
    mlp_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
                     const T* __restrict__ w2, const T* __restrict__ g,
                     float* __restrict__ part, int rows, int f, int tiles_per_split, float p,
                     float inv, int seed) {
  constexpr int dim = 32 * TN2;
  constexpr int TD = dim / 16;  // dim entries per thread: 16 x 16 threads over [dim][FC]
  extern __shared__ float smem[];
  float* xs = smem;                  // [BM][dim]
  float* gs = xs + kMlpBM * dim;     // [BM][dim]
  float* as = gs + kMlpBM * dim;     // [BM][FC] dropped activation chunk
  float* hs = as + kMlpBM * kMlpFC;  // [BM][FC] dH chunk
  float* bs = hs + kMlpBM * kMlpFC;  // weight chunks
  const int f0 = blockIdx.x * kMlpFC, split = blockIdx.y;
  const int tiles = (rows + kMlpBM - 1) / kMlpBM;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(tiles, t_begin + tiles_per_split);
  const uint32_t h0 = drop_stream(seed, 0);
  const float inv_t = Num<T>::round(inv);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float dw1[TD][kMlpTF] = {}, dw2[TD][kMlpTF] = {}, db1[kMlpTF] = {}, db2[TD] = {};
  for (int t = t_begin; t < t_end; ++t) {
    const long row0 = (long)t * kMlpBM;
    const int rows_here = min(kMlpBM, rows - (int)row0);
    __syncthreads();
    load_rows<T>(x, row0, rows_here, dim, xs);
    load_rows<T>(g, row0, rows_here, dim, gs);
    __syncthreads();
    mlp_hidden_bwd<T, dim>(xs, gs, w1, b1, w2, f, f0, row0, rows_here, p, inv, inv_t, h0, bs, as,
                           hs);
    for (int r = 0; r < rows_here; ++r) {
      float a[kMlpTF], h[kMlpTF], xv[TD], gv[TD];
#pragma unroll
      for (int j = 0; j < kMlpTF; ++j) {
        a[j] = as[r * kMlpFC + tx * kMlpTF + j];
        h[j] = hs[r * kMlpFC + tx * kMlpTF + j];
      }
#pragma unroll
      for (int i = 0; i < TD; ++i) {
        xv[i] = xs[r * dim + ty * TD + i];
        gv[i] = gs[r * dim + ty * TD + i];
      }
#pragma unroll
      for (int i = 0; i < TD; ++i)
#pragma unroll
        for (int j = 0; j < kMlpTF; ++j) {
          dw1[i][j] = fmaf(h[j], xv[i], dw1[i][j]);
          dw2[i][j] = fmaf(gv[i], a[j], dw2[i][j]);
        }
      if (ty == 0) {
#pragma unroll
        for (int j = 0; j < kMlpTF; ++j) db1[j] += h[j];
      }
      if (tx == 0) {
#pragma unroll
        for (int i = 0; i < TD; ++i) db2[i] += gv[i];
      }
    }
  }

  const long fd = (long)f * dim;
  float* p_w1 = part + (long)split * (2 * fd + f + dim);
  float* p_w2 = p_w1 + fd;
  float* p_b1 = p_w2 + fd;
  float* p_b2 = p_b1 + f;
#pragma unroll
  for (int i = 0; i < TD; ++i)
#pragma unroll
    for (int j = 0; j < kMlpTF; ++j) {
      const int c = ty * TD + i, col = f0 + tx * kMlpTF + j;
      if (col >= f) continue;
      p_w1[(long)col * dim + c] = dw1[i][j];
      p_w2[(long)c * f + col] = dw2[i][j];
    }
  if (ty == 0) {
#pragma unroll
    for (int j = 0; j < kMlpTF; ++j) {
      const int col = f0 + tx * kMlpTF + j;
      if (col < f) p_b1[col] = db1[j];
    }
  }
  if (tx == 0 && blockIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < TD; ++i) p_b2[ty * TD + i] = db2[i];
  }
}

// ---------------------------------------------------------------------------
// backward (c): out[e] = sum over splits of part[s][e], in split order
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out, long count,
                      int splits) {
  for (long e = (long)blockIdx.x * kThreads + threadIdx.x; e < count;
       e += (long)gridDim.x * kThreads) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[(long)k * count + e];
    out[e] = s;
  }
}

template <typename T, int TN2>
cudaError_t mlp_fwd_launch(const void* x, const void* w1, const void* b1, const void* w2,
                           const void* b2, void* out, int rows, int f, float p, float inv,
                           int seed, cudaStream_t stream) {
  constexpr int dim = 32 * TN2;
  const size_t chunk = kMlpKC1 * (kMlpFC + 1) > kMlpKC2 * (dim + 1) ? kMlpKC1 * (kMlpFC + 1)
                                                                    : kMlpKC2 * (dim + 1);
  const size_t bytes = sizeof(float) * ((size_t)kMlpBM * dim + kMlpBM * kMlpFC + chunk);
  cudaError_t err = allow_smem(mlp_fwd_kernel<T, TN2>, bytes);
  if (err != cudaSuccess) return err;
  mlp_fwd_kernel<T, TN2><<<(rows + kMlpBM - 1) / kMlpBM, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<T*>(out), rows, f, p, inv,
      seed);
  return cudaGetLastError();
}

// part: fp32 scratch of splits * (2 f dim + f + dim); dw1 [f, dim], dw2 [dim, f],
// db1 [f], db2 [dim] fp32, contiguous in that order (one buffer).
template <typename T, int TN2>
cudaError_t mlp_bwd_launch(const void* x, const void* w1, const void* b1, const void* w2,
                           const void* g, void* dx, void* part, void* grads, int rows, int f,
                           int splits, float p, float inv, int seed, cudaStream_t stream) {
  constexpr int dim = 32 * TN2;
  const size_t chunk = kMlpKC1 * (kMlpFC + 1) > kMlpKC2 * (dim + 1) ? kMlpKC1 * (kMlpFC + 1)
                                                                    : kMlpKC2 * (dim + 1);
  const int tiles = (rows + kMlpBM - 1) / kMlpBM;
  {
    const size_t bytes =
        sizeof(float) * (2 * (size_t)kMlpBM * dim + kMlpBM * kMlpFC + chunk);
    cudaError_t err = allow_smem(mlp_dx_kernel<T, TN2>, bytes);
    if (err != cudaSuccess) return err;
    mlp_dx_kernel<T, TN2><<<tiles, kThreads, bytes, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1),
        static_cast<const T*>(w2), static_cast<const T*>(g), static_cast<T*>(dx), rows, f, p, inv,
        seed);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  {
    const size_t bytes =
        sizeof(float) * (2 * (size_t)kMlpBM * dim + 2 * kMlpBM * kMlpFC + kMlpKC1 * (kMlpFC + 1));
    cudaError_t err = allow_smem(mlp_wgrad_kernel<T, TN2>, bytes);
    if (err != cudaSuccess) return err;
    dim3 grid((f + kMlpFC - 1) / kMlpFC, splits);
    mlp_wgrad_kernel<T, TN2><<<grid, kThreads, bytes, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1),
        static_cast<const T*>(w2), static_cast<const T*>(g), static_cast<float*>(part), rows, f,
        (tiles + splits - 1) / splits, p, inv, seed);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long count = 2L * f * dim + f + dim;
  sum_splits_kernel<<<(int)((count + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(grads), count, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t mlp_fwd_impl(const void* x, const void* w1, const void* b1, const void* w2,
                         const void* b2, void* out, int rows, int dim, int f, float p, float inv,
                         int seed, cudaStream_t s) {
  switch (dim) {
    case 64: return mlp_fwd_launch<T, 2>(x, w1, b1, w2, b2, out, rows, f, p, inv, seed, s);
    case 128: return mlp_fwd_launch<T, 4>(x, w1, b1, w2, b2, out, rows, f, p, inv, seed, s);
    case 192: return mlp_fwd_launch<T, 6>(x, w1, b1, w2, b2, out, rows, f, p, inv, seed, s);
    case 256: return mlp_fwd_launch<T, 8>(x, w1, b1, w2, b2, out, rows, f, p, inv, seed, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t mlp_bwd_impl(const void* x, const void* w1, const void* b1, const void* w2,
                         const void* g, void* dx, void* part, void* grads, int rows, int dim,
                         int f, int splits, float p, float inv, int seed, cudaStream_t s) {
  switch (dim) {
    case 64:
      return mlp_bwd_launch<T, 2>(x, w1, b1, w2, g, dx, part, grads, rows, f, splits, p, inv,
                                  seed, s);
    case 128:
      return mlp_bwd_launch<T, 4>(x, w1, b1, w2, g, dx, part, grads, rows, f, splits, p, inv,
                                  seed, s);
    case 192:
      return mlp_bwd_launch<T, 6>(x, w1, b1, w2, g, dx, part, grads, rows, f, splits, p, inv,
                                  seed, s);
    case 256:
      return mlp_bwd_launch<T, 8>(x, w1, b1, w2, g, dx, part, grads, rows, f, splits, p, inv,
                                  seed, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace sn

extern "C" {

// out [rows, dim]; p = 0 turns dropout off; inv = fp32(1 / (1 - p)).
int sn_fused_mlp(int dtype, const void* x, const void* w1, const void* b1, const void* w2,
                 const void* b2, void* out, int rows, int dim, int f, float p, float inv,
                 int seed, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == sn::kF32)
    return sn::mlp_fwd_impl<float>(x, w1, b1, w2, b2, out, rows, dim, f, p, inv, seed, s);
  return sn::mlp_fwd_impl<__nv_bfloat16>(x, w1, b1, w2, b2, out, rows, dim, f, p, inv, seed, s);
}

// dx [rows, dim] in the storage type; grads fp32 [2 f dim + f + dim] holding
// dw1 [f, dim], dw2 [dim, f], db1 [f], db2 [dim]; part fp32 scratch of
// splits * (2 f dim + f + dim).
int sn_fused_mlp_bwd(int dtype, const void* x, const void* w1, const void* b1, const void* w2,
                     const void* g, void* dx, void* part, void* grads, int rows, int dim, int f,
                     int splits, float p, float inv, int seed, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == sn::kF32)
    return sn::mlp_bwd_impl<float>(x, w1, b1, w2, g, dx, part, grads, rows, dim, f, splits, p,
                                   inv, seed, s);
  return sn::mlp_bwd_impl<__nv_bfloat16>(x, w1, b1, w2, g, dx, part, grads, rows, dim, f, splits,
                                         p, inv, seed, s);
}

}  // extern "C"
