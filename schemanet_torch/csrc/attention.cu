// Fused multi-head self-attention on the fused qkv layout, forward and
// backward, with in-kernel hash dropout, for Hopper (sm_90a).
//
// Replaces schemanet_tpu/ops/pallas/attention.py:
//   _mhsa_kernel (called by fused_mhsa's forward):   out = softmax(q k^T / sqrt(d)) v per head
//   _mhsa_bwd_kernel (called by its backward):        dqkv by recompute of the scores,
//                                                     the softmax and the same mask
// on qkv [bs, n, (3, H, d)] as the qkv projection writes it; out [bs, n, H*d].
// Attention dropout keeps element (i, j) of (item, head) by the hash of
// dropmask.cuh with stream item * H + head and counter i * n + j.
//
// What bounds it on the card: bytes. At the stage-0 shape (qkv [64, 197, 576]
// bf16, 3 heads of 64) a forward reads qkv and writes out, 19.4 MB, against
// 1.9 GFLOP; a backward reads qkv and g and writes dqkv, 33.9 MB, against 4.8
// GFLOP. At 3.35 TB/s that is 5.8 and 10.1 us; at the bf16 tensor-core peak
// the products take 1.9 and 4.9 us. Nothing [n, n]-shaped reaches device
// memory: the scores live in registers and shared memory.
//
// Two routes, chosen by the storage type (ops/kernels/attention.py
// mhsa_route says which, and raises on what neither takes):
//
// * bf16, head_dim a multiple of 16 up to 64, n <= 320: tensor cores
//   (mma.sync m16n8k16, bf16 in, fp32 accumulated). 128 threads a block,
//   each warp owning 16 rows of the block's 64.
//   - forward, one block per (64 query rows, head, item): K and V of the head
//     staged once in bf16 shared memory by cp.async, rows padded to 16 keys
//     (zero) and each row padded by 16 bytes, so the 8 rows an ldmatrix reads
//     fall on distinct banks (2 x 208 x 72 x 2 B = 60 KB at n = 197, 92 KB at
//     n = 320; three blocks an SM at n = 197). The q fragment (q scaled in
//     bf16) is read once from device memory, while K and V are in flight,
//     and stays in registers. Pass 1 over key tiles of 16 computes the
//     scores with K fed by ldmatrix and keeps each row's running max and sum
//     of exp; the 4 lanes of a row then combine theirs. Pass 2 recomputes the
//     scores, forms a = exp(s - m) / l with the row's final max and sum,
//     applies the mask, rounds to bf16 and packs the C fragments straight
//     into the A fragment of the AV product, V read by ldmatrix.trans. The
//     output accumulator is [16, d] fp32 a warp. The frozen attn_block
//     (encoder_block.cu) runs the same forward at p = 0, and its head-mean
//     variant (one block per 64 query rows and item, all heads in order)
//     sums the pass-1 scores into a [64][np] fp32 shared tile.
//   - backward, FlashAttention-2's split. (a) dq, per 64 query rows: K and V
//     staged, q and g fragments in registers, as above; pass 1 the row
//     statistics (m, l), pass 2 D_i = sum_j dA_ij s_ij with dA = g v^T by
//     mma (its keep bits saved in shared memory, a byte a lane a key tile),
//     pass 3 dS = round(s (dA - D)) packed into A fragments and dq = dS k
//     (K by ldmatrix.trans); it writes dq and (m, l, D) to a [bs, H, n, 3]
//     fp32 scratch (61 KB of shared memory at n = 197: three blocks an SM).
//     (b) dk and dv, per 64 keys: K and V of the tile in shared memory
//     (74 KB in all), a loop over query tiles of 64 with the q and g tiles
//     double-buffered by cp.async. Each warp recomputes S = q_s k^T for its
//     16 query rows in the orientation and k-order of (a), so s_ij has the
//     bits (a)'s statistics came from, forms P_lp and dS and writes both,
//     bf16, to shared tiles; then each warp owns 16 keys and adds
//     P_lp^T g and dS^T q_s, the transposes read by ldmatrix.trans. dk and
//     dv stay in fp32 registers, one owner an element: no atomics.
//   Mask coordinates come from the fragment layout: in a C fragment lane t
//   holds rows t/4 and t/4 + 8 of its warp's 16 and columns 2 (t % 4) and
//   2 (t % 4) + 1 of each 8-key tile, so element (i, j) is (row0 + t/4 [+ 8],
//   key0 + 8 tile + 2 (t % 4) [+ 1]); padded keys score -inf (weight 0),
//   padded rows read zeros and are never stored.
//
// * fp32, head_dim up to 64, n <= 320: fp32 FMA on shared-memory tiles (the
//   first kernels of this file). Tensor cores would mean TF32 and
//   lose the 1e-4 agreement the fp32 checks hold; the config's dtype is bf16.
//
// Numerics follow the TPU kernel in both routes (the fp32 route never
// rounds): q scaled in bf16 before the product, scores accumulated in fp32,
// softmax in fp32 with the row's final max, dropout on the fp32
// probabilities (s * inv, inv = fp32(1 / (1 - p))), the probabilities rounded
// to bf16 before the fp32-accumulated AV product. Backward: a_lp and dS
// rounded to bf16 before their products, dq scaled by the fp32 scale after
// its product, dk from the scaled q.
#include "common.cuh"
#include "dropmask.cuh"

namespace sn {

// ---------------------------------------------------------------------------
// fp32 route: FMA on fp32 shared-memory tiles
// ---------------------------------------------------------------------------
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
__device__ __forceinline__ void load_kv(const float* qkv, long item, int n, int n3, int heads,
                                        int h, int d, int j0, int keys, float* ks, float* vs) {
  for (int idx = threadIdx.x; idx < keys * d; idx += kThreads) {
    const int j = idx / d, c = idx % d;
    const long row = (item + j0 + j) * n3;
    ks[j * (d + 1) + c] = qkv[row + (heads + h) * d + c];
    vs[j * (d + 1) + c] = qkv[row + (2 * heads + h) * d + c];
  }
}

// Rows [q0, q0 + rows) of q (head h, scaled) into qs [BQ][d]; rows past
// `rows_here` are zero.
__device__ __forceinline__ void load_q(const float* qkv, long item, int q0, int rows,
                                       int rows_here, int n3, int h, int d, float scale,
                                       float* qs) {
  for (int idx = threadIdx.x; idx < rows * d; idx += kThreads) {
    const int r = idx / d, c = idx % d;
    qs[idx] = r < rows_here ? qkv[(item + q0 + r) * n3 + h * d + c] * scale : 0.f;
  }
}

__device__ __forceinline__ float dot_rows(const float* a, const float* b, int d) {
  float s = 0.f;
  for (int c = 0; c < d; ++c) s = fmaf(a[c], b[c], s);
  return s;
}

// forward
__global__ void __launch_bounds__(kThreads)
    mhsa_fwd_kernel(const float* __restrict__ qkv, float* __restrict__ out, int n, int heads, int d,
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
  load_kv(qkv, item, n, n3, heads, h, d, 0, n, ks, vs);
  load_q(qkv, item, q0, kMhsaBQ, rows_here, n3, h, d, scale, qs);
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
      row[j] = a;
    }
  }
  __syncthreads();

  for (int idx = tid; idx < rows_here * d; idx += kThreads) {
    const int r = idx / d, c = idx % d;
    const float* a = ss + r * n;
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = fmaf(a[j], vs[j * (d + 1) + c], acc);
    out[(item + q0 + r) * hd + h * d + c] = acc;
  }
}

// ---------------------------------------------------------------------------
// backward (a): row statistics and dq
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    mhsa_dq_kernel(const float* __restrict__ qkv, const float* __restrict__ g,
                   float* __restrict__ dqkv, float* __restrict__ stats, int n, int heads, int d,
                   float scale, float p, float inv, int seed) {
  extern __shared__ float smem[];
  float* ks = smem;                      // [n][d+1]
  float* vs = ks + n * (d + 1);          // [n][d+1]
  float* qs = vs + n * (d + 1);          // [BQ][d]
  float* gs = qs + kMhsaBQ * d;          // [BQ][d]
  float* ss = gs + kMhsaBQ * d;          // [BQ][n] scores, then probabilities
  float* ps = ss + kMhsaBQ * n;          // [BQ][n] dP, then dS
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * kMhsaBQ, h = blockIdx.y, b = blockIdx.z;
  const int rows_here = min(kMhsaBQ, n - q0);
  const int hd = heads * d, n3 = 3 * hd;
  const long item = (long)b * n;
  load_kv(qkv, item, n, n3, heads, h, d, 0, n, ks, vs);
  load_q(qkv, item, q0, kMhsaBQ, rows_here, n3, h, d, scale, qs);
  for (int idx = tid; idx < kMhsaBQ * d; idx += kThreads) {
    const int r = idx / d, c = idx % d;
    gs[idx] = r < rows_here ? g[(item + q0 + r) * hd + h * d + c] : 0.f;
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
    for (int j = lane; j < n; j += 32) prow[j] = srow[j] * (prow[j] - dsum);
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
    dqkv[(item + q0 + r) * n3 + h * d + c] = acc * scale;
  }
}

// ---------------------------------------------------------------------------
// backward (b): dk and dv of a tile of keys
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    mhsa_dkv_kernel(const float* __restrict__ qkv, const float* __restrict__ g,
                    float* __restrict__ dqkv, const float* __restrict__ stats, int n, int heads,
                    int d, float scale, float p, float inv, int seed) {
  extern __shared__ float smem[];
  float* ks = smem;                        // [BK][d+1]
  float* vs = ks + kMhsaBK * (d + 1);      // [BK][d+1]
  float* qs = vs + kMhsaBK * (d + 1);      // [BQ2][d]
  float* gs = qs + kMhsaBQ2 * d;           // [BQ2][d]
  float* as = gs + kMhsaBQ2 * d;           // [BQ2][BK] dropped probabilities
  float* dss = as + kMhsaBQ2 * kMhsaBK;    // [BQ2][BK] dS
  float* st = dss + kMhsaBQ2 * kMhsaBK;    // [BQ2][3] row max, sum, D
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kMhsaBK, h = blockIdx.y, b = blockIdx.z;
  const int keys = min(kMhsaBK, n - j0);
  const int hd = heads * d, n3 = 3 * hd;
  const long item = (long)b * n;
  const uint32_t h0 = drop_stream(seed, b * heads + h);
  for (int idx = tid; idx < kMhsaBK * (d + 1); idx += kThreads) ks[idx] = vs[idx] = 0.f;
  __syncthreads();
  load_kv(qkv, item, n, n3, heads, h, d, j0, keys, ks, vs);

  float dk[kMhsaPer] = {}, dv[kMhsaPer] = {};
  for (int q0 = 0; q0 < n; q0 += kMhsaBQ2) {
    const int rows_here = min(kMhsaBQ2, n - q0);
    __syncthreads();
    load_q(qkv, item, q0, kMhsaBQ2, rows_here, n3, h, d, scale, qs);
    for (int idx = tid; idx < kMhsaBQ2 * d; idx += kThreads) {
      const int r = idx / d, c = idx % d;
      gs[idx] = r < rows_here ? g[(item + q0 + r) * hd + h * d + c] : 0.f;
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
        ds = s * (da - st[r * 3 + 2]);
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
    dqkv[row + (heads + h) * d + c] = dk[t];
    dqkv[row + (2 * heads + h) * d + c] = dv[t];
  }
}

cudaError_t mhsa_fwd_impl(const void* qkv, void* out, int bs, int n, int heads, int d,
                          float scale, float p, float inv, int seed, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * mhsa_fwd_smem_floats(n, d);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(mhsa_fwd_kernel, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + kMhsaBQ - 1) / kMhsaBQ, heads, bs);
  mhsa_fwd_kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out), n, heads, d, scale, p, inv, seed);
  return cudaGetLastError();
}

cudaError_t mhsa_bwd_impl(const void* qkv, const void* g, void* dqkv, void* stats, int bs, int n,
                          int heads, int d, float scale, float p, float inv, int seed,
                          cudaStream_t stream) {
  const size_t dq_bytes = sizeof(float) * mhsa_dq_smem_floats(n, d);
  if (dq_bytes > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(mhsa_dq_kernel, dq_bytes);
  if (err != cudaSuccess) return err;
  dim3 grid_q((n + kMhsaBQ - 1) / kMhsaBQ, heads, bs);
  mhsa_dq_kernel<<<grid_q, kThreads, dq_bytes, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(g), static_cast<float*>(dqkv),
      static_cast<float*>(stats), n, heads, d, scale, p, inv, seed);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t kv_bytes = sizeof(float) * mhsa_dkv_smem_floats(d);
  err = allow_smem(mhsa_dkv_kernel, kv_bytes);
  if (err != cudaSuccess) return err;
  dim3 grid_k((n + kMhsaBK - 1) / kMhsaBK, heads, bs);
  mhsa_dkv_kernel<<<grid_k, kThreads, kv_bytes, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(g), static_cast<float*>(dqkv),
      static_cast<const float*>(stats), n, heads, d, scale, p, inv, seed);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16 route: tensor cores (the mma, ldmatrix and cp.async helpers are in
// common.cuh)
// ---------------------------------------------------------------------------
constexpr int kTcThreads = 128;    // 4 warps of 16 rows
constexpr int kTcRows = 64;         // query rows (forward, dq) or keys (dk, dv) a block
constexpr int kTcMaxTokens = 320;
constexpr int kPPitch = kTcRows + 8;  // bf16 a row of the dk, dv kernel's P and dS tiles
constexpr float kNegMax = -3.402823466e+38f;

// bf16 a shared-memory row of a [rows][D] tile: 16 bytes of padding put the 8
// rows an ldmatrix reads on distinct banks
template <int D>
__host__ __device__ constexpr int tc_pitch() { return D + 8; }

// keys padded to whole tiles of 16
__host__ __device__ inline int tc_keys(int n) { return (n + 15) & ~15; }

// Rows [row0, row0 + rows) of one head's slice (columns col0 .. col0 + D) of
// a [.., n, stride] bf16 tensor into a [rows][D + 8] shared tile, by cp.async;
// rows at or past n are zero.
template <int D>
__device__ __forceinline__ void stage_async(const bf16* src, long item, int row0, int rows, int n,
                                            int stride, int col0, bf16* dst) {
  constexpr int kChunks = D / 8;  // 16 bytes each
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += kTcThreads) {
    const int r = idx / kChunks, c = idx % kChunks, row = row0 + r;
    const bool in = row < n;
    cp_async16(dst + r * tc_pitch<D>() + c * 8,
               src + (item + (in ? row : 0)) * stride + col0 + c * 8, in ? 16 : 0);
  }
}

// q_s = round(q * scale_t) in place, on the chunks this thread staged (after
// its cp.async group has landed, before the barrier that publishes them)
template <int D>
__device__ __forceinline__ void scale_staged(int rows, float scale_t, bf16* dst) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += kTcThreads) {
    uint4* chunk =
        reinterpret_cast<uint4*>(dst + (idx / kChunks) * tc_pitch<D>() + (idx % kChunks) * 8);
    uint4 v = *chunk;
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 f = __bfloat1622float2(e[t]);
      e[t] = __floats2bfloat162_rn(f.x * scale_t, f.y * scale_t);
    }
    *chunk = v;
  }
}

// A fragments of rows [r0, r0 + 16) of a [rows][D] tile, all of D
template <int D>
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[D / 16][4], const bf16* tile, int r0,
                                            int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(a[kk], tile + (r0 + (lane & 15)) * tc_pitch<D>() + kk * 16 + (lane >> 4) * 8);
}

// A fragments of rows [row0, row0 + 16) of one head's slice (columns col0 ..
// col0 + D) of a [.., n, stride] bf16 tensor, read straight from device
// memory (each element once, so no shared tile), each value rounded from
// value * scale_t (q_s = round(q * round(scale)); scale_t = 1 copies g);
// rows at or past n are zero
template <int D>
__device__ __forceinline__ void load_a_global(uint32_t (&a)[D / 16][4], const bf16* src, long item,
                                              int row0, int n, int stride, int col0,
                                              float scale_t, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + lane / 4 + half * 8;
    const bf16* from = src + (item + min(row, n - 1)) * stride + col0 + (lane & 3) * 2;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        __nv_bfloat162 e = *reinterpret_cast<const __nv_bfloat162*>(from + kk * 16 + hi * 8);
        const float2 f = __bfloat1622float2(e);
        e = __floats2bfloat162_rn(f.x * scale_t, f.y * scale_t);
        a[kk][hi * 2 + half] = row < n ? *reinterpret_cast<const uint32_t*>(&e) : 0u;
      }
  }
}

// c[t] = a tile[j0 + 8t, j0 + 8t + 8)^T for t = 0, 1: 16 columns of q_s k^T
// (or g v^T), summed over D in ascending order of 16
template <int D>
__device__ __forceinline__ void mma_rows16(float (&c)[2][4], const uint32_t (&a)[D / 16][4],
                                           const bf16* tile, int j0, int lane) {
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[t][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t b[4];
    ldsm_x4(b, tile + (j0 + (lane & 7) + (lane >> 4) * 8) * tc_pitch<D>() + kk * 16 +
                   ((lane >> 3) & 1) * 8);
    mma16816(c[0], a[kk], b[0], b[1]);
    mma16816(c[1], a[kk], b[2], b[3]);
  }
}

// acc += a tile[k0, k0 + 16): A (16 rows x 16 of k) times 16 rows of a
// [rows][D] tile (row pitch `pitch`), the tile read by ldmatrix.trans
template <int D>
__device__ __forceinline__ void mma_cols(float (&acc)[D / 8][4], const uint32_t (&a)[4],
                                         const bf16* tile, int k0, int lane) {
#pragma unroll
  for (int dt = 0; dt < D / 16; ++dt) {
    uint32_t b[4];
    ldsm_x4_trans(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * tc_pitch<D>() + dt * 16 +
                         (lane >> 4) * 8);
    mma16816(acc[2 * dt], a, b[0], b[1]);
    mma16816(acc[2 * dt + 1], a, b[2], b[3]);
  }
}

// A fragment of tile^T: rows [m0, m0 + 16) of the transpose (columns of the
// [k][kPPitch] tile), k = tile rows [k0, k0 + 16)
__device__ __forceinline__ void load_a_cols(uint32_t (&a)[4], const bf16* tile, int k0, int m0,
                                            int lane) {
  const int i = lane >> 3;
  ldsm_x4_trans(a, tile + (k0 + (lane & 7) + (i >> 1) * 8) * kPPitch + m0 + (i & 1) * 8);
}

// the key of element (t, c) of a lane's C fragments of 16 keys from j0
__device__ __forceinline__ int frag_key(int j0, int t, int c, int lane) {
  return j0 + t * 8 + (lane & 3) * 2 + c;
}

// running max and sum of exp of the lane's two rows over its columns of 16
// keys; keys at or past n score -inf
__device__ __forceinline__ void online_update(float (&m)[2], float (&l)[2], const float (&s)[2][4],
                                              int j0, int lane, int n) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float v[4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        v[t * 2 + c] = frag_key(j0, t, c, lane) < n ? s[t][half * 2 + c]
                                                    : -__int_as_float(0x7f800000);
    const float mn = fmaxf(m[half], fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3])));
    float sum = l[half] * expf(m[half] - mn);
#pragma unroll
    for (int e = 0; e < 4; ++e) sum += expf(v[e] - mn);
    m[half] = mn;
    l[half] = sum;
  }
}

// the row's (max, sum) from its 4 lanes; every lane ends with the same bits
__device__ __forceinline__ void quad_combine(float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[half], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[half], o);
      const float mn = fmaxf(m[half], mo);
      l[half] = l[half] * expf(m[half] - mn) + lo * expf(mo - mn);
      m[half] = mn;
    }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the fp32 score accumulator of the head-mean: element (i, j) of the block's
// 64 query rows, at the place of the lane whose C fragment holds it
__device__ __forceinline__ float& hsum_at(float* hsum, int np, int j0, int t, int half, int c,
                                          int lane) {
  const int warp = threadIdx.x / 32;
  return hsum[(warp * 16 + lane / 4 + half * 8) * np + frag_key(j0, t, c, lane)];
}

// The forward of head h for the block's 64 query rows from q0 (K and V of
// the head staged into ks and vs here). With `hsum` ([64][np] fp32 in shared
// memory), the head's scores are also added into it by the lane that holds
// each (h = 0 sets it): one owner an element, so the sum over heads runs in
// head order without atomics.
template <int D>
__device__ __forceinline__ void mhsa_tc_fwd_head(const bf16* __restrict__ qkv,
                                                 bf16* __restrict__ out, int n, int heads, int h,
                                                 int b, int q0, float scale, float p, float inv,
                                                 int seed, bf16* ks, bf16* vs, float* hsum) {
  const int np = tc_keys(n);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hd = heads * D, n3 = 3 * hd;
  const long item = (long)b * n;
  stage_async<D>(qkv, item, 0, np, n, n3, (heads + h) * D, ks);
  cp_async_commit();
  stage_async<D>(qkv, item, 0, np, n, n3, (2 * heads + h) * D, vs);
  cp_async_commit();
  uint32_t qa[D / 16][4];  // while K and V are in flight
  load_a_global<D>(qa, qkv, item, q0 + warp * 16, n, n3, h * D, Num<bf16>::round(scale), lane);
  cp_async_wait<1>();  // K
  __syncthreads();

  float m[2] = {kNegMax, kNegMax}, l[2] = {0.f, 0.f};
  for (int j0 = 0; j0 < np; j0 += 16) {
    float s[2][4];
    mma_rows16<D>(s, qa, ks, j0, lane);
    online_update(m, l, s, j0, lane, n);
    if (hsum != nullptr) {
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& acc = hsum_at(hsum, np, j0, t, half, c, lane);
            acc = h == 0 ? s[t][half * 2 + c] : acc + s[t][half * 2 + c];
          }
    }
  }
  quad_combine(m, l);

  cp_async_wait<0>();  // V
  __syncthreads();
  const uint32_t h0 = drop_stream(seed, b * heads + h);
  const int i0 = q0 + warp * 16 + lane / 4;  // rows i0 and i0 + 8
  float o[D / 8][4] = {};
  for (int j0 = 0; j0 < np; j0 += 16) {
    float s[2][4];
    mma_rows16<D>(s, qa, ks, j0, lane);
    uint32_t pa[4];  // the probabilities, bf16, as the A fragment of 16 keys
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float a[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = frag_key(j0, t, c, lane);
          float x = j < n ? expf(s[t][half * 2 + c] - m[half]) / l[half] : 0.f;
          if (p > 0.f) x = drop_keep(h0, i0 + half * 8, n, j, p) ? x * inv : 0.f;
          a[c] = x;
        }
        pa[t * 2 + half] = pack_bf16(a[0], a[1]);
      }
    mma_cols<D>(o, pa, vs, j0, lane);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + half * 8;
    if (i >= n) continue;
    bf16* row = out + (item + i) * hd + h * D + (lane & 3) * 2;
#pragma unroll
    for (int t = 0; t < D / 8; ++t)
      *reinterpret_cast<__nv_bfloat162*>(row + t * 8) =
          __floats2bfloat162_rn(o[t][half * 2], o[t][half * 2 + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
    mhsa_tc_fwd_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int n, int heads,
                       float scale, float p, float inv, int seed) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* ks = reinterpret_cast<bf16*>(tc_smem);  // [np][P]
  bf16* vs = ks + tc_keys(n) * tc_pitch<D>();   // [np][P]
  mhsa_tc_fwd_head<D>(qkv, out, n, heads, blockIdx.y, blockIdx.z, blockIdx.x * kTcRows, scale, p,
                      inv, seed, ks, vs, nullptr);
}

// The frozen layer-9 forward of attn_block's capture_hmean (p = 0): one
// block per (64 query rows, item) owns every head of its rows, so the
// head-mean of the pre-softmax scores, summed in fp32 in head order 0..H-1
// and scaled by 1/H, needs no atomics. K and V take 60 KB and the score sum
// [64][np] fp32 53 KB of shared memory at n = 197, two blocks an SM (the
// bound of 2 also keeps ptxas from a 4-byte spill it makes at head_dim 64
// without it).
template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
    mhsa_tc_hmean_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                         bf16* __restrict__ hmean, int n, int heads, float scale) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int np = tc_keys(n);
  bf16* ks = reinterpret_cast<bf16*>(tc_smem);             // [np][P]
  bf16* vs = ks + np * tc_pitch<D>();                      // [np][P]
  float* hsum = reinterpret_cast<float*>(vs + np * tc_pitch<D>());  // [64][np]
  const int q0 = blockIdx.x * kTcRows, b = blockIdx.y;
  for (int h = 0; h < heads; ++h) {
    if (h > 0) __syncthreads();  // every warp is done with the last head's K and V
    mhsa_tc_fwd_head<D>(qkv, out, n, heads, h, b, q0, scale, 0.f, 1.f, 0, ks, vs, hsum);
  }
  const int lane = threadIdx.x % 32, i0 = q0 + (threadIdx.x / 32) * 16 + lane / 4;
  const float inv_h = (float)(1.0 / heads);
  bf16* dst = hmean + (long)b * n * n;
  for (int j0 = 0; j0 < np; j0 += 16)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = i0 + half * 8, j = frag_key(j0, t, c, lane);
          if (i < n && j < n)
            dst[(long)i * n + j] = __float2bfloat16(hsum_at(hsum, np, j0, t, half, c, lane) * inv_h);
        }
}

// backward (a): row statistics and dq
template <int D>
__global__ void __launch_bounds__(kTcThreads)
    mhsa_tc_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ g,
                      bf16* __restrict__ dqkv, float* __restrict__ stats, int n, int heads,
                      float scale, float p, float inv, int seed) {
  constexpr int P = tc_pitch<D>();
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int np = tc_keys(n);
  bf16* ks = reinterpret_cast<bf16*>(tc_smem);  // [np][P]
  bf16* vs = ks + np * P;                       // [np][P]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the keep bits of each lane's 8 elements of a 16-key tile: pass 2 hashes,
  // pass 3 reads them back ([warp][np / 16][32] bytes)
  uint8_t* keep_bits = reinterpret_cast<uint8_t*>(vs + np * P) + warp * (np / 16) * 32 + lane;
  const int q0 = blockIdx.x * kTcRows, h = blockIdx.y, b = blockIdx.z;
  const int hd = heads * D, n3 = 3 * hd;
  const long item = (long)b * n;
  stage_async<D>(qkv, item, 0, np, n, n3, (heads + h) * D, ks);
  cp_async_commit();
  stage_async<D>(qkv, item, 0, np, n, n3, (2 * heads + h) * D, vs);
  cp_async_commit();
  uint32_t qa[D / 16][4], ga[D / 16][4];  // while K and V are in flight
  load_a_global<D>(qa, qkv, item, q0 + warp * 16, n, n3, h * D, Num<bf16>::round(scale), lane);
  load_a_global<D>(ga, g, item, q0 + warp * 16, n, hd, h * D, 1.f, lane);
  cp_async_wait<1>();  // K
  __syncthreads();

  // pass 1: the row max and sum of exp
  float m[2] = {kNegMax, kNegMax}, l[2] = {0.f, 0.f};
  for (int j0 = 0; j0 < np; j0 += 16) {
    float s[2][4];
    mma_rows16<D>(s, qa, ks, j0, lane);
    online_update(m, l, s, j0, lane, n);
  }
  quad_combine(m, l);

  cp_async_wait<0>();  // V
  __syncthreads();
  const uint32_t h0 = drop_stream(seed, b * heads + h);
  const int i0 = q0 + warp * 16 + lane / 4;  // rows i0 and i0 + 8

  // pass 2: D_i = sum_j dA_ij s_ij, dA = g v^T masked
  float dsum[2] = {0.f, 0.f};
  for (int j0 = 0; j0 < np; j0 += 16) {
    float s[2][4], da[2][4];
    mma_rows16<D>(s, qa, ks, j0, lane);
    mma_rows16<D>(da, ga, vs, j0, lane);
    uint32_t bits = 0;
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = frag_key(j0, t, c, lane);
          if (j >= n) continue;
          const float sp = expf(s[t][half * 2 + c] - m[half]) / l[half];
          float dav = da[t][half * 2 + c];
          if (p > 0.f) {
            const bool keep = drop_keep(h0, i0 + half * 8, n, j, p);
            bits |= uint32_t(keep) << (t * 4 + half * 2 + c);
            dav = keep ? dav * inv : 0.f;
          }
          dsum[half] = fmaf(dav, sp, dsum[half]);
        }
    keep_bits[j0 * 2] = static_cast<uint8_t>(bits);  // (j0 / 16) * 32
  }
  dsum[0] = quad_sum(dsum[0]);
  dsum[1] = quad_sum(dsum[1]);

  // pass 3: dS = round(s (dA - D)), dq = dS k
  float dq[D / 8][4] = {};
  for (int j0 = 0; j0 < np; j0 += 16) {
    float s[2][4], da[2][4];
    mma_rows16<D>(s, qa, ks, j0, lane);
    mma_rows16<D>(da, ga, vs, j0, lane);
    const uint32_t bits = keep_bits[j0 * 2];
    uint32_t dsa[4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float x[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = frag_key(j0, t, c, lane);
          x[c] = 0.f;
          if (j >= n) continue;
          const float sp = expf(s[t][half * 2 + c] - m[half]) / l[half];
          float dav = da[t][half * 2 + c];
          if (p > 0.f) dav = (bits >> (t * 4 + half * 2 + c)) & 1u ? dav * inv : 0.f;
          x[c] = sp * (dav - dsum[half]);
        }
        dsa[t * 2 + half] = pack_bf16(x[0], x[1]);
      }
    mma_cols<D>(dq, dsa, ks, j0, lane);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + half * 8;
    if (i >= n) continue;
    bf16* row = dqkv + (item + i) * n3 + h * D + (lane & 3) * 2;
#pragma unroll
    for (int t = 0; t < D / 8; ++t)
      *reinterpret_cast<__nv_bfloat162*>(row + t * 8) =
          __floats2bfloat162_rn(dq[t][half * 2] * scale, dq[t][half * 2 + 1] * scale);
    if ((lane & 3) == 0) {
      float* st = stats + (((long)b * heads + h) * n + i) * 3;
      st[0] = m[half];
      st[1] = l[half];
      st[2] = dsum[half];
    }
  }
}

// backward (b): dk and dv of a tile of 64 keys
template <int D>
__global__ void __launch_bounds__(kTcThreads)
    mhsa_tc_dkv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ g,
                       bf16* __restrict__ dqkv, const float* __restrict__ stats, int n, int heads,
                       float scale, float p, float inv, int seed) {
  constexpr int P = tc_pitch<D>();
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* ks = reinterpret_cast<bf16*>(tc_smem);  // [64][P]
  bf16* vs = ks + kTcRows * P;                  // [64][P]
  bf16* qs = vs + kTcRows * P;                  // 2 x [64][P], q scaled, double-buffered
  bf16* gs = qs + 2 * kTcRows * P;              // 2 x [64][P]
  bf16* ps = gs + 2 * kTcRows * P;              // [64 queries][kPPitch] P_lp
  bf16* dss = ps + kTcRows * kPPitch;           // [64 queries][kPPitch] dS
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j0 = blockIdx.x * kTcRows, h = blockIdx.y, b = blockIdx.z;
  const int hd = heads * D, n3 = 3 * hd;
  const long item = (long)b * n;
  const float scale_t = Num<bf16>::round(scale);
  const uint32_t h0 = drop_stream(seed, b * heads + h);
  const float* st = stats + ((long)b * heads + h) * n * 3;
  stage_async<D>(qkv, item, j0, kTcRows, n, n3, (heads + h) * D, ks);
  stage_async<D>(qkv, item, j0, kTcRows, n, n3, (2 * heads + h) * D, vs);
  stage_async<D>(qkv, item, 0, kTcRows, n, n3, h * D, qs);
  stage_async<D>(g, item, 0, kTcRows, n, hd, h * D, gs);
  cp_async_commit();

  float dk[D / 8][4] = {}, dv[D / 8][4] = {};
  const int tiles = (n + kTcRows - 1) / kTcRows;
  for (int t = 0; t < tiles; ++t) {
    bf16* qt = qs + (t & 1) * kTcRows * P;
    bf16* gt = gs + (t & 1) * kTcRows * P;
    if (t + 1 < tiles) {  // the next tile into the other buffer, freed by the last barrier
      const int nxt = (t + 1) & 1;
      stage_async<D>(qkv, item, (t + 1) * kTcRows, kTcRows, n, n3, h * D, qs + nxt * kTcRows * P);
      stage_async<D>(g, item, (t + 1) * kTcRows, kTcRows, n, hd, h * D, gs + nxt * kTcRows * P);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    scale_staged<D>(kTcRows, scale_t, qt);
    __syncthreads();

    {  // P_lp and dS of the warp's 16 query rows and the block's 64 keys
      uint32_t qa[D / 16][4], ga[D / 16][4];
      load_a_rows<D>(qa, qt, warp * 16, lane);
      load_a_rows<D>(ga, gt, warp * 16, lane);
      const int r0 = warp * 16 + lane / 4;  // rows r0 and r0 + 8 of the tile
      float m[2], l[2], dd[2];
      bool row_in[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = t * kTcRows + r0 + half * 8;
        row_in[half] = i < n;
        m[half] = row_in[half] ? st[i * 3] : 0.f;
        l[half] = row_in[half] ? st[i * 3 + 1] : 1.f;
        dd[half] = row_in[half] ? st[i * 3 + 2] : 0.f;
      }
#pragma unroll
      for (int c16 = 0; c16 < kTcRows; c16 += 16) {
        float s[2][4], da[2][4];
        mma_rows16<D>(s, qa, ks, c16, lane);
        mma_rows16<D>(da, ga, vs, c16, lane);
#pragma unroll
        for (int tt = 0; tt < 2; ++tt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float pv[2], dsv[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int j = j0 + frag_key(c16, tt, c, lane);
              pv[c] = dsv[c] = 0.f;
              if (!row_in[half] || j >= n) continue;
              // the same operations, on the same bits, as mhsa_tc_dq_kernel
              const float sp = expf(s[tt][half * 2 + c] - m[half]) / l[half];
              float dav = da[tt][half * 2 + c], a = sp;
              if (p > 0.f) {
                const bool keep = drop_keep(h0, t * kTcRows + r0 + half * 8, n, j, p);
                a = keep ? sp * inv : 0.f;
                dav = keep ? dav * inv : 0.f;
              }
              pv[c] = a;
              dsv[c] = sp * (dav - dd[half]);
            }
            const int at = (r0 + half * 8) * kPPitch + frag_key(c16, tt, 0, lane);
            *reinterpret_cast<uint32_t*>(ps + at) = pack_bf16(pv[0], pv[1]);
            *reinterpret_cast<uint32_t*>(dss + at) = pack_bf16(dsv[0], dsv[1]);
          }
      }
    }
    __syncthreads();

    // dv += P_lp^T g, dk += dS^T q_s over the tile's 64 queries, for the warp's 16 keys
#pragma unroll
    for (int k0 = 0; k0 < kTcRows; k0 += 16) {
      uint32_t a[4];
      load_a_cols(a, ps, k0, warp * 16, lane);
      mma_cols<D>(dv, a, gt, k0, lane);
      load_a_cols(a, dss, k0, warp * 16, lane);
      mma_cols<D>(dk, a, qt, k0, lane);
    }
    __syncthreads();
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = j0 + warp * 16 + lane / 4 + half * 8;
    if (j >= n) continue;
    bf16* row = dqkv + (item + j) * n3 + (lane & 3) * 2;
#pragma unroll
    for (int t = 0; t < D / 8; ++t) {
      *reinterpret_cast<__nv_bfloat162*>(row + (heads + h) * D + t * 8) =
          __floats2bfloat162_rn(dk[t][half * 2], dk[t][half * 2 + 1]);
      *reinterpret_cast<__nv_bfloat162*>(row + (2 * heads + h) * D + t * 8) =
          __floats2bfloat162_rn(dv[t][half * 2], dv[t][half * 2 + 1]);
    }
  }
}

template <int D>
size_t tc_fwd_smem(int n) { return sizeof(bf16) * 2 * (size_t)tc_keys(n) * tc_pitch<D>(); }
template <int D>  // K, V and the keep bits
size_t tc_dq_smem(int n) { return tc_fwd_smem<D>(n) + (kTcThreads / 32) * (size_t)tc_keys(n) * 2; }
template <int D>
size_t tc_dkv_smem() {  // K, V, two q and two g tiles; P and dS
  return sizeof(bf16) * (6 * (size_t)kTcRows * tc_pitch<D>() + 2 * kTcRows * kPPitch);
}

template <int D>
cudaError_t mhsa_tc_fwd(const void* qkv, void* out, int bs, int n, int heads, float scale, float p,
                        float inv, int seed, cudaStream_t stream) {
  const size_t bytes = tc_fwd_smem<D>(n);
  cudaError_t err = allow_smem(mhsa_tc_fwd_kernel<D>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + kTcRows - 1) / kTcRows, heads, bs);
  mhsa_tc_fwd_kernel<D><<<grid, kTcThreads, bytes, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), n, heads, scale, p, inv, seed);
  return cudaGetLastError();
}

template <int D>
cudaError_t mhsa_tc_bwd(const void* qkv, const void* g, void* dqkv, void* stats, int bs, int n,
                        int heads, float scale, float p, float inv, int seed,
                        cudaStream_t stream) {
  const size_t dq_bytes = tc_dq_smem<D>(n), kv_bytes = tc_dkv_smem<D>();
  cudaError_t err = allow_smem(mhsa_tc_dq_kernel<D>, dq_bytes);
  if (err != cudaSuccess) return err;
  err = allow_smem(mhsa_tc_dkv_kernel<D>, kv_bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + kTcRows - 1) / kTcRows, heads, bs);
  mhsa_tc_dq_kernel<D><<<grid, kTcThreads, dq_bytes, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(g), static_cast<bf16*>(dqkv),
      static_cast<float*>(stats), n, heads, scale, p, inv, seed);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mhsa_tc_dkv_kernel<D><<<grid, kTcThreads, kv_bytes, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(g), static_cast<bf16*>(dqkv),
      static_cast<const float*>(stats), n, heads, scale, p, inv, seed);
  return cudaGetLastError();
}

// the head_dim a bf16 launch takes: a multiple of 16 up to 64, with n <= 320
inline bool tc_takes(int n, int d) {
  return n <= kTcMaxTokens && d % 16 == 0 && d >= 16 && d <= 64;
}

template <int D>
cudaError_t mhsa_tc_hmean(const void* qkv, void* out, void* hmean, int bs, int n, int heads,
                          float scale, cudaStream_t stream) {
  const size_t bytes = tc_fwd_smem<D>(n) + sizeof(float) * kTcRows * (size_t)tc_keys(n);
  cudaError_t err = allow_smem(mhsa_tc_hmean_kernel<D>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + kTcRows - 1) / kTcRows, bs);
  mhsa_tc_hmean_kernel<D><<<grid, kTcThreads, bytes, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), static_cast<bf16*>(hmean), n, heads,
      scale);
  return cudaGetLastError();
}

// The bf16 attention forward at p = 0 for encoder_block.cu's attn_block: the
// kernel of fused_mhsa, or, with hmean [bs, n, n] not null, its head-mean
// variant. head_dim a multiple of 16 up to 64, n <= 320.
cudaError_t mhsa_tc_forward(const void* qkv, void* out, void* hmean, int bs, int n, int heads,
                            int d, float scale, cudaStream_t s) {
  if (!tc_takes(n, d)) return cudaErrorInvalidValue;
  if (hmean == nullptr) {
    switch (d) {
      case 16: return mhsa_tc_fwd<16>(qkv, out, bs, n, heads, scale, 0.f, 1.f, 0, s);
      case 32: return mhsa_tc_fwd<32>(qkv, out, bs, n, heads, scale, 0.f, 1.f, 0, s);
      case 48: return mhsa_tc_fwd<48>(qkv, out, bs, n, heads, scale, 0.f, 1.f, 0, s);
      default: return mhsa_tc_fwd<64>(qkv, out, bs, n, heads, scale, 0.f, 1.f, 0, s);
    }
  }
  switch (d) {
    case 16: return mhsa_tc_hmean<16>(qkv, out, hmean, bs, n, heads, scale, s);
    case 32: return mhsa_tc_hmean<32>(qkv, out, hmean, bs, n, heads, scale, s);
    case 48: return mhsa_tc_hmean<48>(qkv, out, hmean, bs, n, heads, scale, s);
    default: return mhsa_tc_hmean<64>(qkv, out, hmean, bs, n, heads, scale, s);
  }
}

}  // namespace sn

extern "C" {

// out [bs, n, heads*d]; p = 0 turns dropout off. fp32 takes the FMA kernel,
// bf16 the tensor-core kernel (head_dim a multiple of 16 up to 64, n <= 320).
int sn_fused_mhsa(int dtype, const void* qkv, void* out, int bs, int n, int heads, int head_dim,
                  float scale, float p, float inv, int seed, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == sn::kF32) {
    if (head_dim > sn::kMhsaMaxHeadDim) return cudaErrorInvalidValue;
    return sn::mhsa_fwd_impl(qkv, out, bs, n, heads, head_dim, scale, p, inv, seed, s);
  }
  if (!sn::tc_takes(n, head_dim)) return cudaErrorInvalidValue;
  switch (head_dim) {
    case 16: return sn::mhsa_tc_fwd<16>(qkv, out, bs, n, heads, scale, p, inv, seed, s);
    case 32: return sn::mhsa_tc_fwd<32>(qkv, out, bs, n, heads, scale, p, inv, seed, s);
    case 48: return sn::mhsa_tc_fwd<48>(qkv, out, bs, n, heads, scale, p, inv, seed, s);
    default: return sn::mhsa_tc_fwd<64>(qkv, out, bs, n, heads, scale, p, inv, seed, s);
  }
}

// dqkv [bs, n, 3*heads*d]; stats: fp32 scratch of bs*heads*n*3. Routes as
// sn_fused_mhsa.
int sn_fused_mhsa_bwd(int dtype, const void* qkv, const void* g, void* dqkv, void* stats, int bs,
                      int n, int heads, int head_dim, float scale, float p, float inv, int seed,
                      void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == sn::kF32) {
    if (head_dim > sn::kMhsaMaxHeadDim) return cudaErrorInvalidValue;
    return sn::mhsa_bwd_impl(qkv, g, dqkv, stats, bs, n, heads, head_dim, scale, p, inv, seed,
                             s);
  }
  if (!sn::tc_takes(n, head_dim)) return cudaErrorInvalidValue;
  switch (head_dim) {
    case 16: return sn::mhsa_tc_bwd<16>(qkv, g, dqkv, stats, bs, n, heads, scale, p, inv, seed, s);
    case 32: return sn::mhsa_tc_bwd<32>(qkv, g, dqkv, stats, bs, n, heads, scale, p, inv, seed, s);
    case 48: return sn::mhsa_tc_bwd<48>(qkv, g, dqkv, stats, bs, n, heads, scale, p, inv, seed, s);
    default: return sn::mhsa_tc_bwd<64>(qkv, g, dqkv, stats, bs, n, heads, scale, p, inv, seed, s);
  }
}

}  // extern "C"
