// Fused multi-head self-attention on the fused qkv layout, forward and
// backward, with in-kernel hash dropout, for Hopper (sm_90a).
//
// Replaces schemanet_tpu/ops/pallas/attention.py:
//   fused_mhsa forward (_mhsa_kernel):      out = softmax(q k^T / sqrt(d)) v per head
//   fused_mhsa backward (_mhsa_bwd_kernel): dqkv by recompute of the scores,
//                                           the softmax and the same mask
// on qkv [bs, n, (3, H, d)] as the qkv projection writes it; out [bs, n, H*d].
// Attention dropout keeps element (i, j) of (item, head) by the hash of
// dropmask.cuh with stream item * H + head and counter i * n + j.
//
// What bounds it on the card: at the stage-0 shape (qkv [64, 197, 576] bf16,
// 3 heads of 64) a forward is 1.9 GFLOP against 19 MB in and out, a backward
// 4.8 GFLOP against 34 MB: compute-bound at the tensor cores' rate, once the
// [n, n] scores stay on chip. On the TPU one program held whole [n, n] fp32
// score tiles of several items in VMEM. On Hopper:
//   * forward: one block per (query tile of 16 rows, head, item). K and V of
//     the head sit in shared memory in fp32 (2 x 197 x 65 floats, 102 KB),
//     the tile's [16, n] scores beside them; softmax, mask and the AV product
//     run there. Nothing [n, n]-shaped reaches device memory.
//   * backward, two launches, as FlashAttention-2 splits it: (a) per query
//     tile, the scores, softmax and dP = g v^T rows, D_i = sum_j dA_ij s_ij,
//     dS, and dq = dS k; it writes dq and the row statistics (max, sum, D) to
//     a [bs, H, n, 3] fp32 scratch. (b) per tile of 32 keys, loop over the
//     query rows in tiles, recompute s_ij from the statistics (the same
//     operations in the same order as (a), so the same bits) and dS_ij, and
//     sum dk and dv for the block's keys in registers. No atomics: every
//     output element has one owner.
// Products are fp32 FMA on shared-memory tiles: right first. Tensor-core
// (wgmma) tiles are later work.
//
// Numerics follow the TPU kernel: q scaled in T before the product, scores
// accumulated in fp32, softmax in fp32, dropout on the fp32 probabilities
// (s * inv, inv = fp32(1 / (1 - p))), the probabilities rounded to T before
// the fp32-accumulated AV product. Backward: a_lp and dS rounded to T before
// their products, dq scaled by the fp32 scale after its product, dk from the
// scaled q.
#include "common.cuh"
#include "dropmask.cuh"

namespace sn {

constexpr int kMhsaBQ = 16;         // query rows per block (forward, backward dq)
constexpr int kMhsaBK = 32;         // keys per block (backward dk, dv)
constexpr int kMhsaBQ2 = 32;        // query rows per step of the dk, dv loop
constexpr int kMhsaMaxHeadDim = 64;
constexpr int kMhsaPer = kMhsaBK * kMhsaMaxHeadDim / kThreads;  // dk, dv elements per thread
constexpr size_t kMaxSmem = 232448;

__host__ __device__ inline size_t mhsa_fwd_smem_floats(int n, int d) {
  return 2 * (size_t)n * (d + 1) + (size_t)kMhsaBQ * d + (size_t)kMhsaBQ * n;
}

__host__ __device__ inline size_t mhsa_dq_smem_floats(int n, int d) {
  return 2 * (size_t)n * (d + 1) + 2 * (size_t)kMhsaBQ * d + 2 * (size_t)kMhsaBQ * n;
}

__host__ __device__ inline size_t mhsa_dkv_smem_floats(int d) {
  return 2 * (size_t)kMhsaBK * (d + 1) + 2 * (size_t)kMhsaBQ2 * d + 2 * (size_t)kMhsaBQ2 * kMhsaBK +
         3 * (size_t)kMhsaBQ2;
}

// K and V of head h of one item into shared memory ([n][d+1] fp32 each).
template <typename T>
__device__ __forceinline__ void load_kv(const T* qkv, long item, int n, int n3, int heads, int h,
                                       int d, int j0, int keys, float* ks, float* vs) {
  for (int idx = threadIdx.x; idx < keys * d; idx += kThreads) {
    const int j = idx / d, c = idx % d;
    const long row = (item + j0 + j) * n3;
    ks[j * (d + 1) + c] = Num<T>::load(qkv, row + (heads + h) * d + c);
    vs[j * (d + 1) + c] = Num<T>::load(qkv, row + (2 * heads + h) * d + c);
  }
}

// Rows [q0, q0 + rows) of q (head h, scaled in T) into qs [BQ][d]; rows past
// `rows_here` are zero.
template <typename T>
__device__ __forceinline__ void load_q(const T* qkv, long item, int q0, int rows, int rows_here,
                                       int n3, int h, int d, float scale_t, float* qs) {
  for (int idx = threadIdx.x; idx < rows * d; idx += kThreads) {
    const int r = idx / d, c = idx % d;
    qs[idx] = r < rows_here
                  ? Num<T>::round(Num<T>::load(qkv, (item + q0 + r) * n3 + h * d + c) * scale_t)
                  : 0.f;
  }
}

__device__ __forceinline__ float dot_rows(const float* a, const float* b, int d) {
  float s = 0.f;
  for (int c = 0; c < d; ++c) s = fmaf(a[c], b[c], s);
  return s;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    mhsa_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out, int n, int heads, int d,
                    float scale, float p, float inv, int seed) {
  extern __shared__ float smem[];
  float* ks = smem;                      // [n][d+1]
  float* vs = ks + n * (d + 1);          // [n][d+1]
  float* qs = vs + n * (d + 1);          // [BQ][d]
  float* ss = qs + kMhsaBQ * d;          // [BQ][n]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * kMhsaBQ, h = blockIdx.y, b = blockIdx.z;
  const int rows_here = min(kMhsaBQ, n - q0);
  const int hd = heads * d, n3 = 3 * hd;
  const long item = (long)b * n;
  load_kv<T>(qkv, item, n, n3, heads, h, d, 0, n, ks, vs);
  load_q<T>(qkv, item, q0, kMhsaBQ, rows_here, n3, h, d, Num<T>::round(scale), qs);
  __syncthreads();

  for (int idx = tid; idx < rows_here * n; idx += kThreads) {
    const int r = idx / n, j = idx % n;
    ss[idx] = dot_rows(qs + r * d, ks + j * (d + 1), d);
  }
  __syncthreads();

  const uint32_t h0 = drop_stream(seed, b * heads + h);
  for (int r = warp; r < rows_here; r += kThreads / 32) {
    float* row = ss + r * n;
    float m = -__int_as_float(0x7f800000);
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
    for (int j = lane; j < n; j += 32) {
      float a = row[j] / sum;
      if (p > 0.f) a = drop_keep(h0, q0 + r, n, j, p) ? a * inv : 0.f;
      row[j] = Num<T>::round(a);
    }
  }
  __syncthreads();

  for (int idx = tid; idx < rows_here * d; idx += kThreads) {
    const int r = idx / d, c = idx % d;
    const float* a = ss + r * n;
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = fmaf(a[j], vs[j * (d + 1) + c], acc);
    Num<T>::store(out, (item + q0 + r) * hd + h * d + c, acc);
  }
}

// ---------------------------------------------------------------------------
// backward (a): row statistics and dq
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    mhsa_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ g, T* __restrict__ dqkv,
                   float* __restrict__ stats, int n, int heads, int d, float scale, float p,
                   float inv, int seed) {
  extern __shared__ float smem[];
  float* ks = smem;                      // [n][d+1]
  float* vs = ks + n * (d + 1);          // [n][d+1]
  float* qs = vs + n * (d + 1);          // [BQ][d]
  float* gs = qs + kMhsaBQ * d;          // [BQ][d]
  float* ss = gs + kMhsaBQ * d;          // [BQ][n] scores, then probabilities
  float* ps = ss + kMhsaBQ * n;          // [BQ][n] dP, then dS rounded to T
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * kMhsaBQ, h = blockIdx.y, b = blockIdx.z;
  const int rows_here = min(kMhsaBQ, n - q0);
  const int hd = heads * d, n3 = 3 * hd;
  const long item = (long)b * n;
  load_kv<T>(qkv, item, n, n3, heads, h, d, 0, n, ks, vs);
  load_q<T>(qkv, item, q0, kMhsaBQ, rows_here, n3, h, d, Num<T>::round(scale), qs);
  for (int idx = tid; idx < kMhsaBQ * d; idx += kThreads) {
    const int r = idx / d, c = idx % d;
    gs[idx] = r < rows_here ? Num<T>::load(g, (item + q0 + r) * hd + h * d + c) : 0.f;
  }
  __syncthreads();

  for (int idx = tid; idx < rows_here * n; idx += kThreads) {
    const int r = idx / n, j = idx % n;
    ss[idx] = dot_rows(qs + r * d, ks + j * (d + 1), d);
    ps[idx] = dot_rows(gs + r * d, vs + j * (d + 1), d);
  }
  __syncthreads();

  const uint32_t h0 = drop_stream(seed, b * heads + h);
  for (int r = warp; r < rows_here; r += kThreads / 32) {
    float* srow = ss + r * n;
    float* prow = ps + r * n;
    float m = -__int_as_float(0x7f800000);
    for (int j = lane; j < n; j += 32) m = fmaxf(m, srow[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(srow[j] - m);
      srow[j] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    float dsum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float s = srow[j] / sum;
      float da = prow[j];
      if (p > 0.f) da = drop_keep(h0, q0 + r, n, j, p) ? da * inv : 0.f;
      srow[j] = s;
      prow[j] = da;
      dsum = fmaf(da, s, dsum);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dsum += __shfl_xor_sync(0xffffffffu, dsum, o);
    for (int j = lane; j < n; j += 32) prow[j] = Num<T>::round(srow[j] * (prow[j] - dsum));
    if (lane == 0) {
      float* st = stats + (((long)b * heads + h) * n + q0 + r) * 3;
      st[0] = m;
      st[1] = sum;
      st[2] = dsum;
    }
  }
  __syncthreads();

  for (int idx = tid; idx < rows_here * d; idx += kThreads) {
    const int r = idx / d, c = idx % d;
    const float* ds = ps + r * n;
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = fmaf(ds[j], ks[j * (d + 1) + c], acc);
    Num<T>::store(dqkv, (item + q0 + r) * n3 + h * d + c, acc * scale);
  }
}

// ---------------------------------------------------------------------------
// backward (b): dk and dv of a tile of keys
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    mhsa_dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ g, T* __restrict__ dqkv,
                    const float* __restrict__ stats, int n, int heads, int d, float scale,
                    float p, float inv, int seed) {
  extern __shared__ float smem[];
  float* ks = smem;                        // [BK][d+1]
  float* vs = ks + kMhsaBK * (d + 1);      // [BK][d+1]
  float* qs = vs + kMhsaBK * (d + 1);      // [BQ2][d]
  float* gs = qs + kMhsaBQ2 * d;           // [BQ2][d]
  float* as = gs + kMhsaBQ2 * d;           // [BQ2][BK] dropped probabilities, rounded to T
  float* dss = as + kMhsaBQ2 * kMhsaBK;    // [BQ2][BK] dS, rounded to T
  float* st = dss + kMhsaBQ2 * kMhsaBK;    // [BQ2][3] row max, sum, D
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kMhsaBK, h = blockIdx.y, b = blockIdx.z;
  const int keys = min(kMhsaBK, n - j0);
  const int hd = heads * d, n3 = 3 * hd;
  const long item = (long)b * n;
  const float scale_t = Num<T>::round(scale);
  const uint32_t h0 = drop_stream(seed, b * heads + h);
  for (int idx = tid; idx < kMhsaBK * (d + 1); idx += kThreads) ks[idx] = vs[idx] = 0.f;
  __syncthreads();
  load_kv<T>(qkv, item, n, n3, heads, h, d, j0, keys, ks, vs);

  float dk[kMhsaPer] = {}, dv[kMhsaPer] = {};
  for (int q0 = 0; q0 < n; q0 += kMhsaBQ2) {
    const int rows_here = min(kMhsaBQ2, n - q0);
    __syncthreads();
    load_q<T>(qkv, item, q0, kMhsaBQ2, rows_here, n3, h, d, scale_t, qs);
    for (int idx = tid; idx < kMhsaBQ2 * d; idx += kThreads) {
      const int r = idx / d, c = idx % d;
      gs[idx] = r < rows_here ? Num<T>::load(g, (item + q0 + r) * hd + h * d + c) : 0.f;
    }
    for (int idx = tid; idx < rows_here * 3; idx += kThreads)
      st[idx] = stats[(((long)b * heads + h) * n + q0) * 3 + idx];
    __syncthreads();
    for (int idx = tid; idx < kMhsaBQ2 * kMhsaBK; idx += kThreads) {
      const int r = idx / kMhsaBK, jj = idx % kMhsaBK;
      float a = 0.f, ds = 0.f;
      if (r < rows_here && jj < keys) {
        // the same operations, in the same order, as mhsa_dq_kernel
        const float s = expf(dot_rows(qs + r * d, ks + jj * (d + 1), d) - st[r * 3]) / st[r * 3 + 1];
        float da = dot_rows(gs + r * d, vs + jj * (d + 1), d);
        a = s;
        if (p > 0.f) {
          const bool keep = drop_keep(h0, q0 + r, n, j0 + jj, p);
          a = keep ? s * inv : 0.f;
          da = keep ? da * inv : 0.f;
        }
        a = Num<T>::round(a);
        ds = Num<T>::round(s * (da - st[r * 3 + 2]));
      }
      as[idx] = a;
      dss[idx] = ds;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kMhsaPer; ++t) {
      const int idx = tid + t * kThreads;
      if (idx >= kMhsaBK * d) break;
      const int jj = idx / d, c = idx % d;
      float ak = dk[t], av = dv[t];
      for (int r = 0; r < rows_here; ++r) {
        ak = fmaf(dss[r * kMhsaBK + jj], qs[r * d + c], ak);
        av = fmaf(as[r * kMhsaBK + jj], gs[r * d + c], av);
      }
      dk[t] = ak;
      dv[t] = av;
    }
  }
#pragma unroll
  for (int t = 0; t < kMhsaPer; ++t) {
    const int idx = tid + t * kThreads;
    if (idx >= kMhsaBK * d) break;
    const int jj = idx / d, c = idx % d;
    if (jj >= keys) continue;
    const long row = (item + j0 + jj) * n3;
    Num<T>::store(dqkv, row + (heads + h) * d + c, dk[t]);
    Num<T>::store(dqkv, row + (2 * heads + h) * d + c, dv[t]);
  }
}

template <typename T>
cudaError_t mhsa_fwd_impl(const void* qkv, void* out, int bs, int n, int heads, int d,
                          float scale, float p, float inv, int seed, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * mhsa_fwd_smem_floats(n, d);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(mhsa_fwd_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + kMhsaBQ - 1) / kMhsaBQ, heads, bs);
  mhsa_fwd_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), n, heads, d, scale, p, inv, seed);
  return cudaGetLastError();
}

template <typename T>
cudaError_t mhsa_bwd_impl(const void* qkv, const void* g, void* dqkv, void* stats, int bs, int n,
                          int heads, int d, float scale, float p, float inv, int seed,
                          cudaStream_t stream) {
  const size_t dq_bytes = sizeof(float) * mhsa_dq_smem_floats(n, d);
  if (dq_bytes > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(mhsa_dq_kernel<T>, dq_bytes);
  if (err != cudaSuccess) return err;
  dim3 grid_q((n + kMhsaBQ - 1) / kMhsaBQ, heads, bs);
  mhsa_dq_kernel<T><<<grid_q, kThreads, dq_bytes, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(g), static_cast<T*>(dqkv),
      static_cast<float*>(stats), n, heads, d, scale, p, inv, seed);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t kv_bytes = sizeof(float) * mhsa_dkv_smem_floats(d);
  err = allow_smem(mhsa_dkv_kernel<T>, kv_bytes);
  if (err != cudaSuccess) return err;
  dim3 grid_k((n + kMhsaBK - 1) / kMhsaBK, heads, bs);
  mhsa_dkv_kernel<T><<<grid_k, kThreads, kv_bytes, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(g), static_cast<T*>(dqkv),
      static_cast<const float*>(stats), n, heads, d, scale, p, inv, seed);
  return cudaGetLastError();
}

}  // namespace sn

extern "C" {

// out [bs, n, heads*d]; p = 0 turns dropout off.
int sn_fused_mhsa(int dtype, const void* qkv, void* out, int bs, int n, int heads, int head_dim,
                  float scale, float p, float inv, int seed, void* stream) {
  if (head_dim > sn::kMhsaMaxHeadDim) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == sn::kF32)
    return sn::mhsa_fwd_impl<float>(qkv, out, bs, n, heads, head_dim, scale, p, inv, seed, s);
  return sn::mhsa_fwd_impl<__nv_bfloat16>(qkv, out, bs, n, heads, head_dim, scale, p, inv, seed,
                                          s);
}

// dqkv [bs, n, 3*heads*d]; stats: fp32 scratch of bs*heads*n*3.
int sn_fused_mhsa_bwd(int dtype, const void* qkv, const void* g, void* dqkv, void* stats, int bs,
                      int n, int heads, int head_dim, float scale, float p, float inv, int seed,
                      void* stream) {
  if (head_dim > sn::kMhsaMaxHeadDim) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == sn::kF32)
    return sn::mhsa_bwd_impl<float>(qkv, g, dqkv, stats, bs, n, heads, head_dim, scale, p, inv,
                                    seed, s);
  return sn::mhsa_bwd_impl<__nv_bfloat16>(qkv, g, dqkv, stats, bs, n, heads, head_dim, scale, p,
                                          inv, seed, s);
}

}  // extern "C"
