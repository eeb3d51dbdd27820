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
//   * forward (fp32): one block per 32 rows; the hidden width in chunks of 64:
//     fc1 + bias + gelu + mask into shared memory, and the fc2 partial sums
//     accumulate in registers (as the frozen ffn_block's fp32 FMA kernel
//     does at width 384).
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
// Two routes, chosen by the storage type (ops/kernels/mlp.py mlp_route says
// which, and raises on what neither takes): fp32 takes the FMA kernels
// above, whose products are fp32 FMA on shared-memory tiles (tensor cores
// would mean TF32 and lose the 1e-4 agreement the fp32 checks hold); bf16
// takes the tensor-core kernels below: the forward in one launch, the
// backward storing the hidden state once instead of recomputing it in two
// launches.
//
// Numerics follow the TPU kernel: x W1 accumulated in fp32 and rounded once
// to T, + b1 in T, gelu with the Abramowitz-Stegun erf in fp32 rounded to T,
// dropout h * inv as a product in T (inv rounded to T first, as JAX rounds
// a weak-typed Python float), then the fp32-accumulated fc2 rounded to T,
// + b2 in T. Backward: dA * inv in fp32, dH = dA * gelu'(h) rounded to T,
// weight and bias gradients summed in fp32.
#include "ffn.cuh"

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
// backward (c): out[e] = sum over splits of part[s][e], in split order. The
// first tr x tc elements (a [tr][tc] matrix; tr = 0 for none) land
// transposed: part's reads stay coalesced, and the one strided write is per
// element, not per split.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out, long count,
                      int splits, int tr, int tc) {
  const long tn = (long)tr * tc;
  for (long e = (long)blockIdx.x * kThreads + threadIdx.x; e < count;
       e += (long)gridDim.x * kThreads) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[(long)k * count + e];
    out[e < tn ? (e % tc) * tr + e / tc : e] = s;
  }
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulated;
// the fragment helpers are in common.cuh)
//
// forward, mlp_fwd_tc_kernel: one block of 8 warps per 64 rows, whose x
//     stays in shared memory, through the chunk loop of ffn.cuh (shared with
//     encoder_block.cu's ffn_tc_kernel): hidden chunks of 32, double-buffered
//     by cp.async; h, b1, gelu and the mask on the C fragments
//     (ffn_hidden_bf16, shared with (a) below); out += a_used W2^T in fp32
//     registers; b2 in the epilogue. Nothing of the hidden state leaves the
//     chip. The chunk of 32 (not (a)'s 64) keeps a block at 87 KB of shared
//     memory at dim 192, so two blocks share an SM and stage 0's 197 row
//     tiles run in one wave of 264 places, not two of 132.
// (a) mlp_dh_tc_kernel: one block of 8 warps per 64 rows. x and g of the
//     rows stay in shared memory; the hidden width goes by in chunks of 64,
//     W1[f0:+64, :] and W2[:, f0:+64] double-buffered by cp.async. Per
//     chunk each warp computes h = x W1^T and dA = g W2 for its 16 rows and
//     32 of the chunk's columns (W1 rows as [n][k] by ldmatrix, W2 as [k][n]
//     by ldmatrix.trans), applies b1, gelu, gelu' and the mask to the C
//     fragments in registers (an element's row and column from the lane
//     layout), and writes a_used and dH, bf16, to shared tiles. Then
//     dx += dH W1 (W1's chunk again, as [k][n]) for the warp's 16 rows and
//     dim/2 columns, in fp32 registers over all chunks, while the chunk's
//     dH and a_used go to a [rows, f] scratch each with 16-byte stores.
// (b) mlp_wgrad_tc_kernel: dW1^T = x^T dH and dW2 = g^T a_used, both
//     [dim][f] with K = rows: one block per (64 of dim, 128 of f, product,
//     split of the rows), 32 rows a step double-buffered, both operands
//     transposed out of row-major [rows][.] tiles by ldmatrix.trans. db1 and
//     db2 are column sums of the same tiles (dH in the first row of tiles,
//     g in the first column). Each block writes an fp32 partial.
// (c) sum_splits_kernel sums the partials in split order and transposes dW1.
// No atomics: two calls give the same bits. The hidden state is computed
// once, not once per launch as the FMA route does.
// ---------------------------------------------------------------------------
constexpr int kTcRowTile = 64;    // rows a block of (a)
constexpr int kTcChunk = 64;      // hidden columns a step of (a)
constexpr int kTcChunkPitch = kTcChunk + 8;
constexpr int kWgM = 64, kWgN = 128, kWgK = 32;  // (b): dim x f tile, rows a step
constexpr int kWgPitchA = kWgM + 8, kWgPitchB = kWgN + 8;
constexpr int kWgStage = kWgK * (kWgPitchA + kWgPitchB);

template <int DIM>
struct MlpTcSmem {
  static constexpr int kPitch = DIM + 8;
  static constexpr int kRows = kTcRowTile * kPitch;   // x or g rows; a W1 chunk
  static constexpr int kW2 = DIM * kTcChunkPitch;     // a W2 chunk
  static constexpr int kHidden = kTcRowTile * kTcChunkPitch;
  static constexpr size_t kBytes = sizeof(bf16) * (2 * kRows + 2 * (kRows + kW2) + 2 * kHidden);
};

template <int DIM>
__global__ void __launch_bounds__(kThreads, 1)
    mlp_dh_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                     const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                     const bf16* __restrict__ g, bf16* __restrict__ dx, bf16* __restrict__ dh_out,
                     bf16* __restrict__ a_out, int rows, int f, float p, float inv, int seed) {
  using S = MlpTcSmem<DIM>;
  constexpr int P = S::kPitch, CP = kTcChunkPitch;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [64][P]
  bf16* gs = xs + S::kRows;                      // [64][P]
  bf16* wbuf = gs + S::kRows;                    // 2 x (W1 chunk [64][P], W2 chunk [DIM][CP])
  bf16* hs = wbuf + 2 * (S::kRows + S::kW2);     // dH of the chunk [64][CP]
  bf16* as = hs + S::kHidden;                    // a_used of the chunk [64][CP]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp >> 1, wc = warp & 1;  // rows 16 wr..; column half wc
  const long row0 = (long)blockIdx.x * kTcRowTile;
  const uint32_t h0 = drop_stream(seed, 0);
  const float inv_t = Num<bf16>::round(inv);
  auto w1c = [&](int c) { return wbuf + (c & 1) * (S::kRows + S::kW2); };
  auto w2c = [&](int c) { return w1c(c) + S::kRows; };
  auto stage_chunk = [&](int c) {
    const int f0 = c * kTcChunk;
    stage_tile<kThreads>(w1c(c), P, w1, DIM, f, DIM, f0, 0, kTcChunk, DIM);
    stage_tile<kThreads>(w2c(c), CP, w2, f, DIM, f, 0, f0, DIM, kTcChunk);
  };
  stage_tile<kThreads>(xs, P, x, DIM, rows, DIM, row0, 0, kTcRowTile, DIM);
  stage_tile<kThreads>(gs, P, g, DIM, rows, DIM, row0, 0, kTcRowTile, DIM);
  stage_chunk(0);
  cp_async_commit();

  float dxa[DIM / 16][4] = {};  // the warp's 16 rows x DIM/2 columns of dx
  const int chunks = (f + kTcChunk - 1) / kTcChunk;
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<0>();
    __syncthreads();  // chunk c landed; every warp is past chunk c - 1
    if (c + 1 < chunks) {
      stage_chunk(c + 1);
      cp_async_commit();
    }
    const bf16* w1t = w1c(c);
    const bf16* w2t = w2c(c);
    const int f0 = c * kTcChunk;

    // h = x W1^T and dA = g W2 for rows 16 wr.., chunk columns 32 wc..
    float hacc[4][4] = {}, dacc[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < DIM / 16; ++kk) {
      uint32_t ax[4], ag[4];
      ldsm_a(ax, xs, P, wr * 16, kk * 16, lane);
      ldsm_a(ag, gs, P, wr * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        ldsm_b_nk(b, w1t, P, wc * 32 + np * 16, kk * 16, lane);
        mma16816(hacc[2 * np], ax, b[0], b[1]);
        mma16816(hacc[2 * np + 1], ax, b[2], b[3]);
        ldsm_b_kn(b, w2t, CP, kk * 16, wc * 32 + np * 16, lane);
        mma16816(dacc[2 * np], ag, b[0], b[1]);
        mma16816(dacc[2 * np + 1], ag, b[2], b[3]);
      }
    }
    // the roundings of the FMA route, on the C fragments
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wr * 16 + (lane >> 2) + half * 8;
        const int cc = wc * 32 + nt * 8 + (lane & 3) * 2;
        float av[2], dv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = f0 + cc + e;
          float a_used = 0.f, dh = 0.f;
          if (col < f) {
            const FfnHidden hv =
                ffn_hidden_bf16(hacc[nt][half * 2 + e], b1, row0 + r, col, f, p, inv_t, h0);
            a_used = hv.a_used;
            float da = dacc[nt][half * 2 + e];
            if (p > 0.f) da = hv.keep ? da * inv : 0.f;
            dh = Num<bf16>::round(da * gelu_as_grad(hv.h));
          }
          av[e] = a_used;
          dv[e] = dh;
        }
        *reinterpret_cast<uint32_t*>(as + r * CP + cc) = pack_bf16(av[0], av[1]);
        *reinterpret_cast<uint32_t*>(hs + r * CP + cc) = pack_bf16(dv[0], dv[1]);
      }
    __syncthreads();

    // dx += dH W1 over the chunk: rows 16 wr.., columns wc DIM/2..
#pragma unroll
    for (int kk = 0; kk < kTcChunk / 16; ++kk) {
      uint32_t a[4];
      ldsm_a(a, hs, CP, wr * 16, kk * 16, lane);
#pragma unroll
      for (int nb = 0; nb < DIM / 32; ++nb) {
        uint32_t b[4];
        ldsm_b_kn(b, w1t, P, kk * 16, wc * (DIM / 2) + nb * 16, lane);
        mma16816(dxa[2 * nb], a, b[0], b[1]);
        mma16816(dxa[2 * nb + 1], a, b[2], b[3]);
      }
    }
    // the chunk's dH and a_used to the scratch, 16 bytes a store
    constexpr int kChunks = kTcRowTile * (kTcChunk / 8);
    for (int idx = threadIdx.x; idx < 2 * kChunks; idx += kThreads) {
      const int which = idx / kChunks, rest = idx % kChunks;
      const int r = rest / (kTcChunk / 8), cc = (rest % (kTcChunk / 8)) * 8;
      const long row = row0 + r;
      const int col = f0 + cc;
      if (row < rows && col < f)
        *reinterpret_cast<uint4*>((which ? a_out : dh_out) + row * f + col) =
            *reinterpret_cast<const uint4*>((which ? as : hs) + r * CP + cc);
    }
  }
#pragma unroll
  for (int nt = 0; nt < DIM / 16; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long row = row0 + wr * 16 + (lane >> 2) + half * 8;
      const int col = wc * (DIM / 2) + nt * 8 + (lane & 3) * 2;
      if (row < rows)
        *reinterpret_cast<uint32_t*>(dx + row * DIM + col) =
            pack_bf16(dxa[nt][half * 2], dxa[nt][half * 2 + 1]);
    }
}

// part (per split): dW1^T [dim][f], dW2 [dim][f], db1 [f], db2 [dim], fp32
__global__ void __launch_bounds__(kThreads)
    mlp_wgrad_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                        const bf16* __restrict__ dh, const bf16* __restrict__ a,
                        float* __restrict__ part, int rows, int dim, int f, int steps_per_split) {
  __shared__ __align__(16) bf16 smem[2 * kWgStage];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 32 x 32 of the 64 x 128 tile
  const int n0 = blockIdx.x * kWgN, m0 = blockIdx.y * kWgM;
  const int which = blockIdx.z & 1, split = blockIdx.z >> 1;
  const bf16* A = which ? g : x;   // [rows][dim]
  const bf16* B = which ? a : dh;  // [rows][f]
  const int steps = (rows + kWgK - 1) / kWgK;
  const int s_begin = split * steps_per_split, s_end = min(steps, s_begin + steps_per_split);
  // db1: the column sums of dH (first row of tiles); db2: of g (first column)
  const bool bias = which ? blockIdx.x == 0 : blockIdx.y == 0;
  const int bias_cols = which ? kWgM : kWgN;
  auto stage = [&](int t) { return smem + (t & 1) * kWgStage; };
  auto load = [&](int s, bf16* buf) {
    stage_tile<kThreads>(buf, kWgPitchA, A, dim, rows, dim, (long)s * kWgK, m0, kWgK, kWgM);
    stage_tile<kThreads>(buf + kWgK * kWgPitchA, kWgPitchB, B, f, rows, f, (long)s * kWgK, n0,
                         kWgK, kWgN);
  };
  float acc[2][4][4] = {};
  float bsum = 0.f;
  if (s_begin < s_end) {
    load(s_begin, stage(0));
    cp_async_commit();
  }
  for (int s = s_begin; s < s_end; ++s) {
    const int t = s - s_begin;
    cp_async_wait<0>();
    __syncthreads();  // step s landed; every warp is past step s - 1
    if (s + 1 < s_end) {
      load(s + 1, stage(t + 1));
      cp_async_commit();
    }
    const bf16* at = stage(t);
    const bf16* bt = at + kWgK * kWgPitchA;
#pragma unroll
    for (int kk = 0; kk < kWgK / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) ldsm_a_t(af[mt], at, kWgPitchA, kk * 16, wm * 32 + mt * 16, lane);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        ldsm_b_kn(b, bt, kWgPitchB, kk * 16, wn * 32 + np * 16, lane);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma16816(acc[mt][2 * np], af[mt], b[0], b[1]);
          mma16816(acc[mt][2 * np + 1], af[mt], b[2], b[3]);
        }
      }
    }
    if (bias && threadIdx.x < bias_cols) {
      const bf16* col = which ? at + threadIdx.x : bt + threadIdx.x;
      const int pitch = which ? kWgPitchA : kWgPitchB;
      for (int k = 0; k < kWgK; ++k) bsum += __bfloat162float(col[k * pitch]);
    }
  }
  const long fd = (long)f * dim;
  float* base = part + (long)split * (2 * fd + f + dim);
  float* c_out = base + which * fd;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 32 + mt * 16 + (lane >> 2) + half * 8;  // < dim: dim % 64 == 0
        const int col = n0 + wn * 32 + nt * 8 + (lane & 3) * 2;
        if (col < f)
          *reinterpret_cast<float2*>(c_out + (long)row * f + col) =
              make_float2(acc[mt][nt][half * 2], acc[mt][nt][half * 2 + 1]);
      }
  if (bias && threadIdx.x < bias_cols) {
    if (which)
      base[2 * fd + f + m0 + threadIdx.x] = bsum;
    else if (n0 + (int)threadIdx.x < f)
      base[2 * fd + n0 + threadIdx.x] = bsum;
  }
}

// two resident blocks an SM up to dim 192 (<= 128 registers a thread); at
// 256 the fp32 output fragments take 64 registers, so one
template <int DIM>
__global__ void __launch_bounds__(kThreads, DIM <= 192 ? 2 : 1)
    mlp_fwd_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                      const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                      const bf16* __restrict__ b2, bf16* __restrict__ out, int rows, int f, float p,
                      float inv, int seed) {
  using S = FfnTcSmem<DIM, kTcRowTile>;
  using L = FfnTcLayout<DIM, kTcRowTile>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [64][DIM + 8]
  bf16* stages = xs + S::kA;                     // 2 x (W1 chunk, W2 chunk)
  bf16* act = stages + 2 * S::kStage;            // a_used of the chunk [64][40]
  const int lane = threadIdx.x & 31;
  const long row0 = (long)blockIdx.x * kTcRowTile;
  stage_tile<kThreads>(xs, S::kPitch, x, DIM, rows, DIM, row0, 0, kTcRowTile, DIM);
  ffn_tc_stage_chunk<DIM, kTcRowTile>(stages, w1, w2, f, 0);
  cp_async_commit();

  float oacc[L::kOutTiles][4] = {};  // the warp's 16 rows x DIM/2 columns of out
  ffn_tc_chunks<DIM, kTcRowTile>(xs, stages, act, w1, b1, w2, row0, f, p, Num<bf16>::round(inv),
                                 drop_stream(seed, 0), oacc);
  // out = round(round(a W2^T) + b2), as the FMA route
#pragma unroll
  for (int nt = 0; nt < L::kOutTiles; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int2 rc = ffn_tc_out_coord<DIM, kTcRowTile>(nt, half, lane);
      const long row = row0 + rc.x;
      if (row < rows)
        *reinterpret_cast<uint32_t*>(out + row * DIM + rc.y) =
            pack_bf16(Num<bf16>::round(oacc[nt][half * 2]) + Num<bf16>::load(b2, rc.y),
                      Num<bf16>::round(oacc[nt][half * 2 + 1]) + Num<bf16>::load(b2, rc.y + 1));
    }
}

template <int DIM>
cudaError_t mlp_fwd_tc_launch(const void* x, const void* w1, const void* b1, const void* w2,
                              const void* b2, void* out, int rows, int f, float p, float inv,
                              int seed, cudaStream_t stream) {
  const size_t bytes = FfnTcSmem<DIM, kTcRowTile>::kBytes;
  cudaError_t err = allow_smem(mlp_fwd_tc_kernel<DIM>, bytes);
  if (err != cudaSuccess) return err;
  mlp_fwd_tc_kernel<DIM><<<(rows + kTcRowTile - 1) / kTcRowTile, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(b2), static_cast<bf16*>(out), rows,
      f, p, inv, seed);
  return cudaGetLastError();
}

cudaError_t mlp_fwd_tc(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* b2, void* out, int rows, int dim, int f, float p, float inv,
                       int seed, cudaStream_t s) {
  if (f % 8) return cudaErrorInvalidValue;
  switch (dim) {
    case 64: return mlp_fwd_tc_launch<64>(x, w1, b1, w2, b2, out, rows, f, p, inv, seed, s);
    case 128: return mlp_fwd_tc_launch<128>(x, w1, b1, w2, b2, out, rows, f, p, inv, seed, s);
    case 192: return mlp_fwd_tc_launch<192>(x, w1, b1, w2, b2, out, rows, f, p, inv, seed, s);
    case 256: return mlp_fwd_tc_launch<256>(x, w1, b1, w2, b2, out, rows, f, p, inv, seed, s);
    default: return cudaErrorInvalidValue;
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
      static_cast<const float*>(part), static_cast<float*>(grads), count, splits, 0, 0);
  return cudaGetLastError();
}

// hidden: bf16 scratch of 2 rows f (dH, then a_used)
template <int DIM>
cudaError_t mlp_bwd_tc_launch(const void* x, const void* w1, const void* b1, const void* w2,
                              const void* g, void* dx, void* part, void* grads, void* hidden,
                              int rows, int f, int splits, float p, float inv, int seed,
                              cudaStream_t stream) {
  bf16* dh = static_cast<bf16*>(hidden);
  bf16* a = dh + (long)rows * f;
  const size_t bytes = MlpTcSmem<DIM>::kBytes;
  cudaError_t err = allow_smem(mlp_dh_tc_kernel<DIM>, bytes);
  if (err != cudaSuccess) return err;
  mlp_dh_tc_kernel<DIM><<<(rows + kTcRowTile - 1) / kTcRowTile, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(g), static_cast<bf16*>(dx), dh, a,
      rows, f, p, inv, seed);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int steps = (rows + kWgK - 1) / kWgK;
  dim3 grid((f + kWgN - 1) / kWgN, DIM / kWgM, 2 * splits);
  mlp_wgrad_tc_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g), dh, a, static_cast<float*>(part),
      rows, DIM, f, (steps + splits - 1) / splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long count = 2L * f * DIM + f + DIM;
  sum_splits_kernel<<<(int)((count + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(grads), count, splits, DIM, f);
  return cudaGetLastError();
}

cudaError_t mlp_bwd_tc(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* g, void* dx, void* part, void* grads, void* hidden, int rows,
                       int dim, int f, int splits, float p, float inv, int seed, cudaStream_t s) {
  if (f % 8 || hidden == nullptr) return cudaErrorInvalidValue;
  switch (dim) {
    case 64:
      return mlp_bwd_tc_launch<64>(x, w1, b1, w2, g, dx, part, grads, hidden, rows, f, splits, p,
                                   inv, seed, s);
    case 128:
      return mlp_bwd_tc_launch<128>(x, w1, b1, w2, g, dx, part, grads, hidden, rows, f, splits,
                                    p, inv, seed, s);
    case 192:
      return mlp_bwd_tc_launch<192>(x, w1, b1, w2, g, dx, part, grads, hidden, rows, f, splits,
                                    p, inv, seed, s);
    case 256:
      return mlp_bwd_tc_launch<256>(x, w1, b1, w2, g, dx, part, grads, hidden, rows, f, splits,
                                    p, inv, seed, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t mlp_fwd_fp32(const void* x, const void* w1, const void* b1, const void* w2,
                         const void* b2, void* out, int rows, int dim, int f, float p, float inv,
                         int seed, cudaStream_t s) {
  switch (dim) {
    case 64: return mlp_fwd_launch<float, 2>(x, w1, b1, w2, b2, out, rows, f, p, inv, seed, s);
    case 128: return mlp_fwd_launch<float, 4>(x, w1, b1, w2, b2, out, rows, f, p, inv, seed, s);
    case 192: return mlp_fwd_launch<float, 6>(x, w1, b1, w2, b2, out, rows, f, p, inv, seed, s);
    case 256: return mlp_fwd_launch<float, 8>(x, w1, b1, w2, b2, out, rows, f, p, inv, seed, s);
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

// out [rows, dim]; p = 0 turns dropout off; inv = fp32(1 / (1 - p)). fp32
// takes the FMA kernel, bf16 the tensor-core one (f a multiple of 8; x, w1
// and w2 16-byte aligned).
int sn_fused_mlp(int dtype, const void* x, const void* w1, const void* b1, const void* w2,
                 const void* b2, void* out, int rows, int dim, int f, float p, float inv,
                 int seed, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == sn::kF32)
    return sn::mlp_fwd_fp32(x, w1, b1, w2, b2, out, rows, dim, f, p, inv, seed, s);
  return sn::mlp_fwd_tc(x, w1, b1, w2, b2, out, rows, dim, f, p, inv, seed, s);
}

// dx [rows, dim] in the storage type; grads fp32 [2 f dim + f + dim] holding
// dw1 [f, dim], dw2 [dim, f], db1 [f], db2 [dim]; part fp32 scratch of
// splits * (2 f dim + f + dim). fp32 takes the FMA kernels (hidden unused,
// may be null); bf16 the tensor-core kernels (f a multiple of 8; hidden a
// bf16 scratch of 2 rows f; the splits cut the rows in steps of 32).
int sn_fused_mlp_bwd(int dtype, const void* x, const void* w1, const void* b1, const void* w2,
                     const void* g, void* dx, void* part, void* grads, void* hidden, int rows,
                     int dim, int f, int splits, float p, float inv, int seed, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == sn::kF32)
    return sn::mlp_bwd_impl<float>(x, w1, b1, w2, g, dx, part, grads, rows, dim, f, splits, p,
                                   inv, seed, s);
  return sn::mlp_bwd_tc(x, w1, b1, w2, g, dx, part, grads, hidden, rows, dim, f, splits, p, inv,
                        seed, s);
}

}  // extern "C"
