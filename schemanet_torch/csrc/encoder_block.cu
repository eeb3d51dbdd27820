// Frozen pre-norm encoder layer in two halves, for Hopper (sm_90a).
//
// Replaces schemanet_tpu/ops/pallas/encoder_block.py:
//   attn_block (_attn_block_kernel, _attn_block_hmean_kernel):
//       y = x + (MHSA(LN1(x) Wqkv + bqkv) Wo + bo)   [+ head-mean of the scores]
//   ffn_block (_ffn_block_kernel):
//       z = y + (gelu(LN2(y) W1 + b1) W2 + b2)
//
// What bounds it on the card: at the serving shape ([64, 197, 192], 3 heads
// of 64, FFN 768) a layer is ~13 GFLOP against ~10 MB of activations, so the
// halves are compute-bound once the intermediates stay on chip. On the TPU one
// program held an item's whole qkv ([197, 576]) plus its [197, 197] fp32 score
// tiles in VMEM; on Hopper that qkv alone (227 KB in bf16) fills a block's
// shared memory. The design:
//   * attn_block is two launches. (a) ln_qkv: LN1 and the qkv product for a
//     tile of 32 rows x 64 columns, qkv to device memory (the one intermediate
//     that leaves the chip). (b) attn_core: one block per (item, 16 query
//     rows) loops over the heads; K and V stream through shared memory in
//     64-key chunks, the [16, n] scores and the head sum stay in shared memory
//     (no atomics: one block owns its rows of every head), then the out
//     projection, bias and residual run in the same block.
//   * ffn_block is one launch per 32-row tile: LN2 into shared memory, then
//     the hidden width in chunks of 64: fc1 + bias + gelu into shared memory,
//     and the fc2 partial sums accumulate in registers. The [rows, 768] hidden
//     state never reaches device memory.
// Products are fp32 FMA on shared-memory tiles: right first. Tensor-core
// (wgmma) tiles and keeping qkv on chip are later work.
//
// Numerics follow the TPU kernels: LN statistics in fp32 (E[x^2] - E[x]^2),
// every product accumulated in fp32 and rounded once to T, bias added in T
// after that rounding, q scaled in T, scores and softmax in fp32, the
// probabilities rounded to T before the AV product, the head-mean summed in
// fp32 over heads in order and scaled by 1/H, gelu in fp32 with erff.
#include "common.cuh"

namespace sn {

// ---------------------------------------------------------------------------
// (a) LN1 + qkv projection: qkv[r, :] = round(LN(x[r]) Wqkv^T) + bqkv
// ---------------------------------------------------------------------------
constexpr int kQkvBM = 32, kQkvBN = 64, kQkvKC = 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_qkv_kernel(const T* __restrict__ x, const float* __restrict__ ln_scale,
                  const float* __restrict__ ln_bias, const T* __restrict__ wqkv,
                  const T* __restrict__ bqkv, T* __restrict__ qkv, int rows, int dim, int n3,
                  float eps) {
  extern __shared__ float smem[];
  float* xs = smem;                    // [BM][dim]
  float* bs = smem + kQkvBM * dim;     // [KC][BN+1]
  const long row0 = (long)blockIdx.x * kQkvBM;
  const int n0 = blockIdx.y * kQkvBN;
  const int rows_here = min(kQkvBM, rows - (int)row0);
  layernorm_rows<T, kQkvBM>(x, row0, rows_here, dim, ln_scale, ln_bias, eps, xs);

  constexpr int TM = 2, TN = 4;
  float acc[TM][TN] = {};
  gemm_smem_a<T, kQkvBM, kQkvBN, TM, TN, kQkvKC>(xs, dim, wqkv, dim, dim, n0, n3, bs, acc);
  const int tx = threadIdx.x % (kQkvBN / TN), ty = threadIdx.x / (kQkvBN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
    if (r >= rows_here) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx * TN + j;
      if (c >= n3) continue;
      const float v = Num<T>::round(acc[i][j]) + Num<T>::load(bqkv, c);
      Num<T>::store(qkv, (row0 + r) * n3 + c, v);
    }
  }
}

// ---------------------------------------------------------------------------
// (b) attention core + out projection + residual (+ head-mean of the scores)
// ---------------------------------------------------------------------------
constexpr int kBQ = 16;       // query rows per block
constexpr int kKeyChunk = 64; // keys per K/V chunk in shared memory
constexpr int kOutBN = 64, kOutKC = 32;
constexpr int kMaxHeadDim = 128;
constexpr int kPerThread = kBQ * kMaxHeadDim / kThreads;  // AV outputs per thread

__host__ __device__ inline size_t attn_core_smem_floats(int n, int d, int hd, bool hmean) {
  return (size_t)kBQ * d                 // qs   [BQ][d]
         + (size_t)kKeyChunk * (d + 1)   // kv   [chunk][d+1]
         + (size_t)kBQ * n               // ss   [BQ][n] scores, then probabilities
         + (hmean ? (size_t)kBQ * n : 0) // hs   [BQ][n] head sum
         + (size_t)kBQ * hd              // os   [BQ][H*d] attention output
         + (size_t)kOutKC * (kOutBN + 1);// bs   out-projection weight chunk
}

template <typename T, bool kHmean>
__global__ void __launch_bounds__(kThreads)
    attn_core_kernel(const T* __restrict__ x, const T* __restrict__ qkv,
                     const T* __restrict__ wo, const T* __restrict__ bo, T* __restrict__ out,
                     T* __restrict__ hmean, int n, int heads, int d, int dim, float scale) {
  extern __shared__ float smem[];
  const int hd = heads * d, n3 = 3 * hd;
  float* qs = smem;
  float* kv = qs + kBQ * d;
  float* ss = kv + kKeyChunk * (d + 1);
  float* hs = ss + kBQ * n;
  float* os = hs + (kHmean ? kBQ * n : 0);
  float* bs = os + kBQ * hd;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int rows_here = min(kBQ, n - q0);
  const long item = (long)b * n;
  const float scale_t = Num<T>::round(scale);

  for (int h = 0; h < heads; ++h) {
    // q rows of this head, scaled in T
    for (int idx = tid; idx < kBQ * d; idx += kThreads) {
      const int r = idx / d, c = idx % d;
      qs[idx] = r < rows_here
                    ? Num<T>::round(Num<T>::load(qkv, (item + q0 + r) * n3 + h * d + c) * scale_t)
                    : 0.f;
    }
    // scores S = q k^T in fp32, one key chunk at a time
    for (int j0 = 0; j0 < n; j0 += kKeyChunk) {
      const int keys = min(kKeyChunk, n - j0);
      __syncthreads();
      for (int idx = tid; idx < keys * d; idx += kThreads) {
        const int jj = idx / d, c = idx % d;
        kv[jj * (d + 1) + c] = Num<T>::load(qkv, (item + j0 + jj) * n3 + (heads + h) * d + c);
      }
      __syncthreads();
      for (int idx = tid; idx < kBQ * keys; idx += kThreads) {
        const int r = idx / keys, jj = idx % keys;
        const float* q = qs + r * d;
        const float* k = kv + jj * (d + 1);
        float s = 0.f;
        for (int c = 0; c < d; ++c) s = fmaf(q[c], k[c], s);
        ss[r * n + j0 + jj] = s;
      }
    }
    __syncthreads();
    if (kHmean) {
      for (int idx = tid; idx < kBQ * n; idx += kThreads)
        hs[idx] = h == 0 ? ss[idx] : hs[idx] + ss[idx];
      __syncthreads();  // the softmax below overwrites ss in place
    }
    // fp32 softmax per row, probabilities rounded to T (one warp per row)
    for (int r = warp; r < kBQ; r += kThreads / 32) {
      float* row = ss + r * n;
      float m = -__int_as_float(0x7f800000);  // -inf
      for (int j = lane; j < n; j += 32) m = fmaxf(m, row[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float e = expf(row[j] - m);
        row[j] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      for (int j = lane; j < n; j += 32) row[j] = Num<T>::round(row[j] / sum);
    }
    // out_h = P v, fp32 accumulation, rounded once to T
    float acc[kPerThread] = {};
    for (int j0 = 0; j0 < n; j0 += kKeyChunk) {
      const int keys = min(kKeyChunk, n - j0);
      __syncthreads();
      for (int idx = tid; idx < keys * d; idx += kThreads) {
        const int jj = idx / d, c = idx % d;
        kv[jj * (d + 1) + c] =
            Num<T>::load(qkv, (item + j0 + jj) * n3 + (2 * heads + h) * d + c);
      }
      __syncthreads();
#pragma unroll
      for (int t = 0; t < kPerThread; ++t) {
        const int idx = tid + t * kThreads;
        if (idx >= kBQ * d) break;
        const int r = idx / d, c = idx % d;
        const float* p = ss + r * n + j0;
        float a = acc[t];
        for (int jj = 0; jj < keys; ++jj) a = fmaf(p[jj], kv[jj * (d + 1) + c], a);
        acc[t] = a;
      }
    }
#pragma unroll
    for (int t = 0; t < kPerThread; ++t) {
      const int idx = tid + t * kThreads;
      if (idx >= kBQ * d) break;
      const int r = idx / d, c = idx % d;
      os[r * hd + h * d + c] = Num<T>::round(acc[t]);
    }
    __syncthreads();
  }

  if (kHmean) {
    const float inv_h = (float)(1.0 / heads);
    for (int idx = tid; idx < rows_here * n; idx += kThreads) {
      const int r = idx / n, j = idx % n;
      Num<T>::store(hmean, (item + q0 + r) * n + j, hs[r * n + j] * inv_h);
    }
  }

  // out projection + bias + residual, 64 output columns at a time
  constexpr int TM = 1, TN = 4;
  const int tx = tid % (kOutBN / TN), ty = tid / (kOutBN / TN);
  for (int n0 = 0; n0 < dim; n0 += kOutBN) {
    float acc[TM][TN] = {};
    gemm_smem_a<T, kBQ, kOutBN, TM, TN, kOutKC>(os, hd, wo, hd, hd, n0, dim, bs, acc);
    const int r = ty;
    if (r >= rows_here) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx * TN + j;
      if (c >= dim) continue;
      const long o = (item + q0 + r) * dim + c;
      const float proj = Num<T>::round(Num<T>::round(acc[0][j]) + Num<T>::load(bo, c));
      Num<T>::store(out, o, Num<T>::load(x, o) + proj);
    }
  }
}

// ---------------------------------------------------------------------------
// FFN half: out[r] = x[r] + round(gelu(round(LN(x[r]) W1^T) + b1) W2^T) + b2
// ---------------------------------------------------------------------------
constexpr int kFfnBM = 32, kFfnFC = 64, kFc1KC = 32, kFc2KC = 16;

__host__ __device__ inline size_t ffn_smem_floats(int dim) {
  const size_t fc1 = (size_t)kFc1KC * (kFfnFC + 1), fc2 = (size_t)kFc2KC * (dim + 1);
  return (size_t)kFfnBM * dim + (size_t)kFfnBM * kFfnFC + (fc1 > fc2 ? fc1 : fc2);
}

// TN2 = dim / 32 output columns per thread of the fc2 accumulator ([32, dim]
// over 8 x 32 threads, 4 rows each).
template <typename T, int TN2>
__global__ void __launch_bounds__(kThreads)
    ffn_kernel(const T* __restrict__ x, const float* __restrict__ ln_scale,
               const float* __restrict__ ln_bias, const T* __restrict__ w1,
               const T* __restrict__ b1, const T* __restrict__ w2, const T* __restrict__ b2,
               T* __restrict__ out, int rows, int f, float eps) {
  constexpr int dim = 32 * TN2;
  extern __shared__ float smem[];
  float* xs = smem;                 // [BM][dim]
  float* hs = xs + kFfnBM * dim;    // [BM][FC] hidden chunk after gelu
  float* bs = hs + kFfnBM * kFfnFC; // weight chunks
  const long row0 = (long)blockIdx.x * kFfnBM;
  const int rows_here = min(kFfnBM, rows - (int)row0);
  layernorm_rows<T, kFfnBM>(x, row0, rows_here, dim, ln_scale, ln_bias, eps, xs);

  constexpr int TM1 = 2, TN1 = 4, TM2 = 4;
  const int tx1 = threadIdx.x % (kFfnFC / TN1), ty1 = threadIdx.x / (kFfnFC / TN1);
  float acc2[TM2][TN2] = {};
  for (int f0 = 0; f0 < f; f0 += kFfnFC) {
    float acc1[TM1][TN1] = {};
    gemm_smem_a<T, kFfnBM, kFfnFC, TM1, TN1, kFc1KC>(xs, dim, w1, dim, dim, f0, f, bs, acc1);
#pragma unroll
    for (int i = 0; i < TM1; ++i)
#pragma unroll
      for (int j = 0; j < TN1; ++j) {
        const int c = tx1 * TN1 + j;
        float g = 0.f;
        if (f0 + c < f) {
          const float h = Num<T>::round(Num<T>::round(acc1[i][j]) + Num<T>::load(b1, f0 + c));
          g = Num<T>::round(h * 0.5f * (1.f + erff(h * 0.70710678118654752f)));
        }
        hs[(ty1 * TM1 + i) * kFfnFC + c] = g;
      }
    gemm_smem_a<T, kFfnBM, dim, TM2, TN2, kFc2KC>(hs, kFfnFC, w2 + f0, f, min(kFfnFC, f - f0), 0,
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
      const long o = (row0 + r) * dim + c;
      const float y = Num<T>::round(Num<T>::round(acc2[i][j]) + Num<T>::load(b2, c));
      Num<T>::store(out, o, Num<T>::load(x, o) + y);
    }
  }
}

template <typename T>
cudaError_t attn_block_impl(const void* x, const void* g, const void* be, const void* wqkv,
                            const void* bqkv, const void* wo, const void* bo, void* qkv,
                            void* out, void* hmean, int bs, int n, int dim, int heads, int d,
                            float eps, float scale, cudaStream_t stream) {
  const int rows = bs * n, n3 = 3 * heads * d, hd = heads * d;
  {
    const size_t bytes = sizeof(float) * ((size_t)kQkvBM * dim + kQkvKC * (kQkvBN + 1));
    cudaError_t err = allow_smem(ln_qkv_kernel<T>, bytes);
    if (err != cudaSuccess) return err;
    dim3 grid((rows + kQkvBM - 1) / kQkvBM, (n3 + kQkvBN - 1) / kQkvBN);
    ln_qkv_kernel<T><<<grid, kThreads, bytes, stream>>>(static_cast<const T*>(x),
              static_cast<const float*>(g), static_cast<const float*>(be),
              static_cast<const T*>(wqkv), static_cast<const T*>(bqkv), static_cast<T*>(qkv),
              rows, dim, n3, eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const bool with_hmean = hmean != nullptr;
  const size_t bytes = sizeof(float) * attn_core_smem_floats(n, d, hd, with_hmean);
  dim3 grid((n + kBQ - 1) / kBQ, bs);
  cudaError_t err;
  if (with_hmean) {
    err = allow_smem(attn_core_kernel<T, true>, bytes);
    if (err != cudaSuccess) return err;
    attn_core_kernel<T, true><<<grid, kThreads, bytes, stream>>>(
              static_cast<const T*>(x), static_cast<const T*>(qkv), static_cast<const T*>(wo),
              static_cast<const T*>(bo), static_cast<T*>(out), static_cast<T*>(hmean), n, heads,
              d, dim, scale);
  } else {
    err = allow_smem(attn_core_kernel<T, false>, bytes);
    if (err != cudaSuccess) return err;
    attn_core_kernel<T, false><<<grid, kThreads, bytes, stream>>>(
              static_cast<const T*>(x), static_cast<const T*>(qkv), static_cast<const T*>(wo),
              static_cast<const T*>(bo), static_cast<T*>(out), static_cast<T*>(nullptr), n,
              heads, d, dim, scale);
  }
  return cudaGetLastError();
}

template <typename T, int TN2>
cudaError_t ffn_launch(const void* x, const void* g, const void* be, const void* w1,
                       const void* b1, const void* w2, const void* b2, void* out, int rows,
                       int f, float eps, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * ffn_smem_floats(32 * TN2);
  cudaError_t err = allow_smem(ffn_kernel<T, TN2>, bytes);
  if (err != cudaSuccess) return err;
  ffn_kernel<T, TN2><<<(rows + kFfnBM - 1) / kFfnBM, kThreads, bytes, stream>>>(
            static_cast<const T*>(x), static_cast<const float*>(g),
            static_cast<const float*>(be), static_cast<const T*>(w1), static_cast<const T*>(b1),
            static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<T*>(out), rows, f,
            eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t ffn_block_impl(const void* x, const void* g, const void* be, const void* w1,
                           const void* b1, const void* w2, const void* b2, void* out, int rows,
                           int dim, int f, float eps, cudaStream_t stream) {
  switch (dim) {
    case 64: return ffn_launch<T, 2>(x, g, be, w1, b1, w2, b2, out, rows, f, eps, stream);
    case 128: return ffn_launch<T, 4>(x, g, be, w1, b1, w2, b2, out, rows, f, eps, stream);
    case 192: return ffn_launch<T, 6>(x, g, be, w1, b1, w2, b2, out, rows, f, eps, stream);
    case 256: return ffn_launch<T, 8>(x, g, be, w1, b1, w2, b2, out, rows, f, eps, stream);
    case 384: return ffn_launch<T, 12>(x, g, be, w1, b1, w2, b2, out, rows, f, eps, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace sn

extern "C" {

// qkv: scratch [bs*n, 3*heads*d] of the storage type; hmean may be null.
int sn_attn_block(int dtype, const void* x, const void* ln_scale, const void* ln_bias,
                  const void* wqkv, const void* bqkv, const void* wo, const void* bo, void* qkv,
                  void* out, void* hmean, int bs, int n, int dim, int heads, int head_dim,
                  float eps, float scale, void* stream) {
  if (head_dim > sn::kMaxHeadDim) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == sn::kF32)
    return sn::attn_block_impl<float>(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, qkv, out,
                                      hmean, bs, n, dim, heads, head_dim, eps, scale, s);
  return sn::attn_block_impl<__nv_bfloat16>(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, qkv, out,
                                            hmean, bs, n, dim, heads, head_dim, eps, scale, s);
}

int sn_ffn_block(int dtype, const void* x, const void* ln_scale, const void* ln_bias,
                 const void* w1, const void* b1, const void* w2, const void* b2, void* out,
                 int rows, int dim, int f, float eps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == sn::kF32)
    return sn::ffn_block_impl<float>(x, ln_scale, ln_bias, w1, b1, w2, b2, out, rows, dim, f,
                                     eps, s);
  return sn::ffn_block_impl<__nv_bfloat16>(x, ln_scale, ln_bias, w1, b1, w2, b2, out, rows, dim,
                                           f, eps, s);
}

}  // extern "C"
