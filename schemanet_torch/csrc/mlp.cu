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
#include <cstring>

#include "ffn.cuh"
#include "gemm.cuh"

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
//     (ffn_hidden, shared with (a) below); out += a_used W2^T in fp32
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
// (b) mlp_wgrad_tc_kernel (widths 64-256; the wide route's is
//     mlp_wgrad_wg_kernel, below): dW1^T = x^T dH and dW2 = g^T a_used, both
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
                ffn_hidden<bf16>(hacc[nt][half * 2 + e], b1, row0 + r, col, f, p, inv_t, h0);
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

// ---------------------------------------------------------------------------
// Widths past 256 (DeiT-Small's 384, DeiT-Base's 768), both dtypes: the
// one-launch kernels above hold a row tile of x (and g) whole in shared
// memory and a row group's output in registers, which at 768 pass the
// 227 KB of shared memory and the 255 registers a thread. Here every
// product is one launch of gemm.cuh over a fixed tile of its output, and the
// hidden state goes through device memory between them, stored in T where
// the one-launch kernels round it to T (so nothing is lost by storing it):
//   forward:  hidden = a_used = drop(gelu(x W1^T + b1))       [rows, f] T
//             out = round(hidden W2^T) + b2
//   backward, bf16 (Hopper: TMA-fed wgmma, gemm.cuh):
//             (dH, a_used) from h = x W1^T and dA = g W2, both products in
//             one launch (gemm_tc_dual, two accumulators a thread; dA never
//             leaves the registers)                             [2][rows, f] T
//             dx = dH W1 (gemm_tc, W1 read MN-major)
//             dW1 = dH^T x and dW2 = g^T a_used (mlp_wgrad_wg_kernel, every
//             operand read MN-major from its row-major [rows][.] matrix),
//             db1 and db2 the column sums of the same tiles, over the row
//             splits the wrapper's plan gives (ops/kernels/mlp.py
//             wgrad_splits: fixed by the shape), then sum_splits_kernel in
//             split order
//   backward, fp32 (FMA, gemm_fma):
//             dA = g W2                                        [rows, f] fp32
//             (dH, a_used) from x W1^T + b1 and dA             [2][rows, f] T
//             dx = dH W1; dW1^T, dW2 over row splits and db1, db2 by
//             col_sum_kernel, then sum_splits_kernel
// The epilogues below are the one-launch kernels' roundings (ffn_hidden,
// the same gelu' and mask). The price against a fused kernel: the hidden
// state is written and read once more in device memory (at DeiT-Small's
// stage 0, 12,608 x 1,536 bf16: 39 MB a forward).
// ---------------------------------------------------------------------------
// Num<T>::round on the host, for the epilogues' scalars: bf16 to nearest
// even (v finite)
template <typename T>
inline float host_round(float v) {
  if (sizeof(T) == sizeof(float)) return v;
  uint32_t u;
  std::memcpy(&u, &v, sizeof u);
  u = (u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u;
  std::memcpy(&v, &u, sizeof v);
  return v;
}

// The wide route's epilogues. Each gives gemm.cuh's Hopper kernels
// `cols(col, in)`, the values of a column pair read before any store (the
// biases; Col), and `put(row, col, c0, c1, cv, in)`, which computes the pair
// unconditionally and stores it where `in`; gemm_fma (fp32) calls
// `operator()(row, col, c0, c1, split)`, which is the two together.
template <typename T>
__device__ __forceinline__ float2 load_pair(const T* p, int i) {
  if constexpr (sizeof(T) == 2)
    return unpack_bf16(*reinterpret_cast<const uint32_t*>(p + i));  // i even
  else
    return make_float2(p[i], p[i + 1]);
}

// v0, v1 to p[i], p[i + 1], rounded to T (bf16: one 4-byte store, i even)
template <typename T>
__device__ __forceinline__ void store_pair(T* p, long i, float v0, float v1) {
  if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<uint32_t*>(p + i) = pack_bf16(v0, v1);
  } else {
    p[i] = v0;
    p[i + 1] = v1;
  }
}

template <typename T>
struct EpiHidden {  // hidden[row][col] = a_used of x W1^T + b1
  using Col = float2;
  static constexpr bool kHeavy = true;  // gelu and the hash an element
  const T* b1;
  T* hidden;
  int f;
  float p, inv_t;
  uint32_t h0;
  __device__ __forceinline__ Col cols(int col, bool in) const {
    return in ? load_pair(b1, col) : make_float2(0.f, 0.f);
  }
  __device__ __forceinline__ void put(long row, int col, float c0, float c1, Col b,
                                      bool in) const {
    const float a0 = ffn_hidden_sel<T>(c0, b.x, row, col, f, p, inv_t, h0).a_used;
    const float a1 = ffn_hidden_sel<T>(c1, b.y, row, col + 1, f, p, inv_t, h0).a_used;
    if (in) store_pair(hidden, row * f + col, a0, a1);
  }
  __device__ __forceinline__ void operator()(long row, int col, float c0, float c1, int) const {
    put(row, col, c0, c1, cols(col, true), true);
  }
};

template <typename T>
struct EpiBias {  // out[row][col] = round(acc) + b2
  using Col = float2;
  static constexpr bool kHeavy = false;
  const T* b2;
  T* out;
  int n;
  __device__ __forceinline__ Col cols(int col, bool in) const {
    return in ? load_pair(b2, col) : make_float2(0.f, 0.f);
  }
  __device__ __forceinline__ void put(long row, int col, float c0, float c1, Col b,
                                      bool in) const {
    if (in) store_pair(out, row * n + col, Num<T>::round(c0) + b.x, Num<T>::round(c1) + b.y);
  }
  __device__ __forceinline__ void operator()(long row, int col, float c0, float c1, int) const {
    put(row, col, c0, c1, cols(col, true), true);
  }
};

template <typename T>
struct EpiStore {  // out[row][col] = acc, rounded to T
  struct Col {};
  static constexpr bool kHeavy = false;
  T* out;
  int n;
  __device__ __forceinline__ Col cols(int, bool) const { return {}; }
  __device__ __forceinline__ void put(long row, int col, float c0, float c1, Col,
                                      bool in) const {
    if (in) store_pair(out, row * n + col, c0, c1);
  }
  __device__ __forceinline__ void operator()(long row, int col, float c0, float c1, int) const {
    put(row, col, c0, c1, {}, true);
  }
};

// dH and a_used from the fc1 sum x W1^T and dA: dA handed over from its own
// accumulator (gemm_tc_dual's put) or read from the fp32 scratch `da`
// (gemm_fma's route)
template <typename T>
struct EpiHiddenBwd {
  using Col = float2;
  const T* b1;
  const float* da;
  T* dh;
  T* a_used;
  int f;
  float p, inv, inv_t;
  uint32_t h0;
  __device__ __forceinline__ Col cols(int col, bool in) const {
    return in ? load_pair(b1, col) : make_float2(0.f, 0.f);
  }
  // (dH, a_used) of one element
  __device__ __forceinline__ float2 one(long row, int col, float acc, float d, float bias) const {
    const FfnHidden hv = ffn_hidden_sel<T>(acc, bias, row, col, f, p, inv_t, h0);
    d = p > 0.f ? (hv.keep ? d * inv : 0.f) : d;
    return make_float2(Num<T>::round(d * gelu_as_grad(hv.h)), hv.a_used);
  }
  __device__ __forceinline__ void put(long row, int col, float c0, float c1, float d0, float d1,
                                      Col b, bool in) const {
    const float2 v0 = one(row, col, c0, d0, b.x), v1 = one(row, col + 1, c1, d1, b.y);
    if (in) {
      store_pair(dh, row * f + col, v0.x, v1.x);
      store_pair(a_used, row * f + col, v0.y, v1.y);
    }
  }
  __device__ __forceinline__ void operator()(long row, int col, float c0, float c1, int) const {
    put(row, col, c0, c1, da[row * f + col], da[row * f + col + 1], cols(col, true), true);
  }
};

struct EpiPart {  // part[split][off + row n + col] = the split's sum
  float* part;
  long stride, off;
  int n;
  __device__ __forceinline__ void operator()(long row, int col, float c0, float c1,
                                             int split) const {
    float* dst = part + split * stride + off + row * n + col;
    dst[0] = c0;
    dst[1] = c1;
  }
};

// part[z][off + c] = the sum over rows [z ks, (z + 1) ks) of x[row][c], in
// row order (the bias gradients of the fp32 wide route)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    col_sum_kernel(const T* __restrict__ x, float* __restrict__ part, long rows, int n, int ks,
                   long stride, long off) {
  const int c = blockIdx.x * kThreads + threadIdx.x, z = blockIdx.y;
  if (c >= n) return;
  const long lo = (long)z * ks, hi = min(rows, lo + ks);
  float s = 0.f;
  for (long r = lo; r < hi; ++r) s += Num<T>::load(x, r * n + c);
  part[z * stride + off + c] = s;
}

// hidden: [rows, f] of T
template <typename T>
cudaError_t mlp_fwd_wide(const void* x, const void* w1, const void* b1, const void* w2,
                         const void* b2, void* out, void* hidden, int rows, int dim, int f,
                         float p, float inv, int seed, cudaStream_t s) {
  if (hidden == nullptr) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const T* w1t = static_cast<const T*>(w1);
  const T* w2t = static_cast<const T*>(w2);
  T* ht = static_cast<T*>(hidden);
  const EpiHidden<T> eh{static_cast<const T*>(b1), ht, f, p, host_round<T>(inv),
                        drop_stream(seed, 0)};
  const EpiBias<T> eb{static_cast<const T*>(b2), static_cast<T*>(out), dim};
  cudaError_t err;
  if constexpr (sizeof(T) == 2) {
    err = gemm_tc<false>(xt, w1t, rows, f, dim, eh, s);
    if (err != cudaSuccess) return err;
    return gemm_tc<false>(ht, w2t, rows, dim, f, eb, s);
  } else {
    err = gemm_fma<T, false, false>(xt, w1t, rows, f, dim, 1, dim, eh, s);
    if (err != cudaSuccess) return err;
    return gemm_fma<T, false, false>(ht, w2t, rows, dim, f, 1, f, eb, s);
  }
}

// ---------------------------------------------------------------------------
// bf16 wide route's weight gradients, mlp_wgrad_wg_kernel: dW1 = dH^T x
// [f][dim] and dW2 = g^T a_used [dim][f], K = rows. A block a unit (128 x
// 128 of one product over one split of the rows), the producer / consumer
// loop of gemm.cuh with every operand read MN-major from its row-major
// [rows][.] matrix: a stage is two 64 x 64 boxes of A (dH or g) and two of
// B (x or a_used), 32 KB, six stages; wgmma m64n128k16 with both transpose
// bits. The units of the first column of tiles also sum A's columns (db1 of
// dH, db2 of g): a consumer thread a column of the stage's swizzled tile,
// each warpgroup half of its 64 rows, in row order, while the tensor cores
// multiply; the halves are added in a fixed order at the end. The units run
// with the tile along dim fastest, so the blocks in flight share their
// columns of dH or a_used, and a 77 MB dH at 768 is read from memory about
// once. Rows past the end are zeros (TMA), and a split ends on a multiple
// of 64 rows, so no unit reads its neighbour's rows. Both products land in
// their parameters' layouts, so the sum of the splits copies in order.
// ---------------------------------------------------------------------------
constexpr int kHwTile = 128;                  // a unit's rows and columns
constexpr int kHwStage = 4 * kHgBox;          // 32 KB
constexpr int kHwStages = kHgRingBytes / kHwStage;
constexpr int kHwBytes = kHwStages * kHwStage + 1024;

// part[split]: dW1 [f][dim], dW2 [dim][f], db1 [f], db2 [dim]; dim a multiple of 128
__global__ void __launch_bounds__(kHgThreads, 1)
    mlp_wgrad_wg_kernel(const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap tg,
                        const __grid_constant__ CUtensorMap tdh,
                        const __grid_constant__ CUtensorMap ta, float* __restrict__ part,
                        int rows, int dim, int f, int steps_per_split) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kHwStages], empty[kHwStages];
  __shared__ float half_sum[kHwTile];
  uint8_t* smem = ring_base(smem_raw);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int d_tiles = dim / kHwTile, f_tiles = (f + kHwTile - 1) / kHwTile;
  int u = blockIdx.x;
  const int d0 = (u % d_tiles) * kHwTile;
  u /= d_tiles;
  const int f0 = (u % f_tiles) * kHwTile;
  u /= f_tiles;
  const int which = u & 1, split = u >> 1;  // which: 0 dH^T x, 1 g^T a_used
  const int M = which ? dim : f, N = which ? f : dim;
  const int m0 = which ? d0 : f0, n0 = which ? f0 : d0;
  const int steps = (rows + kHgBK - 1) / kHgBK;
  const int s_begin = split * steps_per_split;
  const int s_end = min(steps, s_begin + steps_per_split);
  const bool bias = n0 == 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kHwStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (wg == 0) {
    regs_dec<kHgProducerRegs>();
    if (tid != 0) return;
    const CUtensorMap* am = which ? &tg : &tdh;
    const CUtensorMap* bm = which ? &ta : &tx;
    Ring<kHwStages> ring;
    for (int s = s_begin; s < s_end; ++s, ring.next()) {
      mbar_wait(&empty[ring.stage], ring.phase ^ 1);
      uint8_t* st = smem + ring.stage * kHwStage;
      uint64_t* bar = &full[ring.stage];
      mbar_arrive_expect(bar, kHwStage);
      tma_load(st, am, bar, m0, s * kHgBK);
      tma_load(st + kHgBox, am, bar, m0 + 64, s * kHgBK);
      tma_load(st + 2 * kHgBox, bm, bar, n0, s * kHgBK);
      tma_load(st + 3 * kHgBox, bm, bar, n0 + 64, s * kHgBK);
    }
    return;
  }
  regs_inc<kHgConsumerRegs>();
  const int cw = wg - 1, warp = tid / 32, lane = tid % 32;
  float acc[kHwTile / 2];
#pragma unroll
  for (int i = 0; i < kHwTile / 2; ++i) acc[i] = 0.f;
  wg_fence_regs(acc);
  // this thread's bias column: column tid of A's two swizzled 64-wide boxes
  const int chunk = (tid % 64) / 8, col_off = (tid / 64) * kHgBox + (tid % 8) * 2;
  float bsum = 0.f;
  int held = -1;
  Ring<kHwStages> ring;
  for (int s = s_begin; s < s_end; ++s, ring.next()) {
    mbar_wait(&full[ring.stage], ring.phase);
    const uint8_t* st = smem + ring.stage * kHwStage;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kHgBK / 16; ++kk)
      wgmma_bf16<kHwTile, 1, 1>(acc, wg_desc(st + cw * kHgBox + kk * 2048, 64 * 128, 1024),
                                wg_desc(st + 2 * kHgBox + kk * 2048, 64 * 128, 1024));
    wg_commit();
    if (bias) {
      const uint8_t* col = st + col_off;
#pragma unroll 8
      for (int r = cw * 32; r < cw * 32 + 32; ++r)
        bsum += __bfloat162float(
            *reinterpret_cast<const bf16*>(col + r * 128 + ((chunk ^ (r & 7)) << 4)));
    }
    wg_wait<1>();
    if (held >= 0 && tid == 0) mbar_arrive(&empty[held]);
    held = ring.stage;
  }
  wg_wait<0>();
  if (held >= 0 && tid == 0) mbar_arrive(&empty[held]);
  wg_fence_regs(acc);
  const long fd = (long)f * dim;
  float* base = part + (long)split * (2 * fd + f + dim);
  float* c_out = base + which * fd;
  const int row = m0 + cw * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < kHwTile / 8; ++j) {
    const int col = n0 + j * 8 + (lane % 4) * 2;
    if (col < N) {
      if (row < M)
        *reinterpret_cast<float2*>(c_out + (long)row * N + col) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
      if (row + 8 < M)
        *reinterpret_cast<float2*>(c_out + (long)(row + 8) * N + col) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  if (bias) {  // rows [0, 32) + rows [32, 64) of every stage, in that order
    if (cw == 1) half_sum[tid] = bsum;
    asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the consumer warpgroups alone
    if (cw == 0 && m0 + tid < M) base[2 * fd + (which ? f : 0) + m0 + tid] = bsum + half_sum[tid];
  }
}

// x, g [rows][dim] and dh, a [rows][f] bf16, 16-byte aligned; f a multiple
// of 8, dim of 128; the rows split in `splits` runs of whole 64-row steps
cudaError_t mlp_wgrad_wg(const bf16* x, const bf16* g, const bf16* dh, const bf16* a,
                         float* part, int rows, int dim, int f, int splits, cudaStream_t s) {
  if (dim % kHwTile || f % 8 || splits < 1) return cudaErrorInvalidValue;
  CUtensorMap tx, tg, tdh, ta;
  cudaError_t err = tma_map_bf16(&tx, x, rows, dim, 64);
  if (err == cudaSuccess) err = tma_map_bf16(&tg, g, rows, dim, 64);
  if (err == cudaSuccess) err = tma_map_bf16(&tdh, dh, rows, f, 64);
  if (err == cudaSuccess) err = tma_map_bf16(&ta, a, rows, f, 64);
  if (err == cudaSuccess) err = allow_smem(mlp_wgrad_wg_kernel, kHwBytes);
  if (err != cudaSuccess) return err;
  const int steps = (rows + kHgBK - 1) / kHgBK;
  const int units = dim / kHwTile * ((f + kHwTile - 1) / kHwTile) * 2 * splits;
  mlp_wgrad_wg_kernel<<<units, kHgThreads, kHwBytes, s>>>(tx, tg, tdh, ta, part, rows, dim, f,
                                                         (steps + splits - 1) / splits);
  return cudaGetLastError();
}

// hidden: [2][rows, f] of T (dH, then a_used); part: splits x (dW1
// [f][dim] in bf16, dW1^T [dim][f] in fp32; dW2 [dim][f], db1, db2) fp32; da:
// the fp32 route's [rows, f] scratch of dA (unused, may be null, in bf16)
template <typename T>
cudaError_t mlp_bwd_wide(const void* x, const void* w1, const void* b1, const void* w2,
                         const void* g, void* dx, void* part, void* grads, void* hidden, void* da,
                         int rows, int dim, int f, int splits, float p, float inv, int seed,
                         cudaStream_t s) {
  if (hidden == nullptr || (sizeof(T) == 4 && da == nullptr)) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const T* w1t = static_cast<const T*>(w1);
  const T* w2t = static_cast<const T*>(w2);
  const T* gt = static_cast<const T*>(g);
  T* dh = static_cast<T*>(hidden);
  T* a = dh + (long)rows * f;
  float* dat = static_cast<float*>(da);
  float* pt = static_cast<float*>(part);
  const EpiHiddenBwd<T> eh{static_cast<const T*>(b1), dat, dh, a, f, p, inv, host_round<T>(inv),
                           drop_stream(seed, 0)};
  const EpiStore<T> ex{static_cast<T*>(dx), dim};
  const long fd = (long)f * dim, stride = 2 * fd + f + dim;
  cudaError_t err;
  if constexpr (sizeof(T) == 2) {
    err = gemm_tc_dual(xt, w1t, gt, w2t, rows, f, dim, eh, s);  // h = x W1^T, dA = g W2
    if (err != cudaSuccess) return err;
    err = gemm_tc<true>(dh, w1t, rows, dim, f, ex, s);
    if (err != cudaSuccess) return err;
    err = mlp_wgrad_wg(xt, gt, dh, a, pt, rows, dim, f, splits, s);
  } else {
    const EpiStore<float> ed{dat, f};
    err = gemm_fma<T, false, true>(gt, w2t, rows, f, dim, 1, dim, ed, s);
    if (err != cudaSuccess) return err;
    err = gemm_fma<T, false, false>(xt, w1t, rows, f, dim, 1, dim, eh, s);
    if (err != cudaSuccess) return err;
    err = gemm_fma<T, false, true>(dh, w1t, rows, dim, f, 1, f, ex, s);
    if (err != cudaSuccess) return err;
    const int ks = (rows + splits - 1) / splits;
    err = gemm_fma<T, true, true>(xt, dh, dim, f, rows, splits, ks, EpiPart{pt, stride, 0, f}, s);
    if (err != cudaSuccess) return err;
    err = gemm_fma<T, true, true>(gt, a, dim, f, rows, splits, ks, EpiPart{pt, stride, fd, f}, s);
    if (err != cudaSuccess) return err;
    col_sum_kernel<T><<<dim3((f + kThreads - 1) / kThreads, splits), kThreads, 0, s>>>(
        dh, pt, rows, f, ks, stride, 2 * fd);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    col_sum_kernel<T><<<dim3((dim + kThreads - 1) / kThreads, splits), kThreads, 0, s>>>(
        gt, pt, rows, dim, ks, stride, 2 * fd + f);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  // fp32's partials hold dW1^T, bf16's dW1
  const int tr = sizeof(T) == 4 ? dim : 0;
  sum_splits_kernel<<<(int)((stride + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      pt, static_cast<float*>(grads), stride, splits, tr, f);
  return cudaGetLastError();
}

// the widths the wide route takes: past the one-launch kernels' 256, whole
// 128-row tiles of the bf16 weight-gradient kernel
inline bool mlp_wide(int dim) { return dim > 256 && dim % kHgBM == 0; }

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
// and w2 16-byte aligned), at widths 64-256; past 256 (a multiple of 128)
// both take the wide route, with hidden a scratch of rows f in the storage
// type (unused, may be null, at the narrower widths).
int sn_fused_mlp(int dtype, const void* x, const void* w1, const void* b1, const void* w2,
                 const void* b2, void* out, void* hidden, int rows, int dim, int f, float p,
                 float inv, int seed, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (sn::mlp_wide(dim)) {
    if (dtype == sn::kF32)
      return sn::mlp_fwd_wide<float>(x, w1, b1, w2, b2, out, hidden, rows, dim, f, p, inv, seed,
                                     s);
    if (f % 8) return cudaErrorInvalidValue;
    return sn::mlp_fwd_wide<sn::bf16>(x, w1, b1, w2, b2, out, hidden, rows, dim, f, p, inv, seed,
                                      s);
  }
  if (dtype == sn::kF32)
    return sn::mlp_fwd_fp32(x, w1, b1, w2, b2, out, rows, dim, f, p, inv, seed, s);
  return sn::mlp_fwd_tc(x, w1, b1, w2, b2, out, rows, dim, f, p, inv, seed, s);
}

// dx [rows, dim] in the storage type; grads fp32 [2 f dim + f + dim] holding
// dw1 [f, dim], dw2 [dim, f], db1 [f], db2 [dim]; part fp32 scratch of
// splits * (2 f dim + f + dim). At widths 64-256 fp32 takes the FMA kernels
// (hidden and da unused, may be null) and bf16 the tensor-core kernels (f a
// multiple of 8; hidden a bf16 scratch of 2 rows f; the splits cut the rows
// in steps of 32; da unused). Past 256 (a multiple of 128) both take the
// wide route: hidden a scratch of 2 rows f in the storage type; fp32: da an
// fp32 scratch of rows f, the splits cut the rows evenly; bf16: da unused
// (may be null), the splits cut the rows in steps of 64.
int sn_fused_mlp_bwd(int dtype, const void* x, const void* w1, const void* b1, const void* w2,
                     const void* g, void* dx, void* part, void* grads, void* hidden, void* da,
                     int rows, int dim, int f, int splits, float p, float inv, int seed,
                     void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (sn::mlp_wide(dim)) {
    if (dtype == sn::kF32)
      return sn::mlp_bwd_wide<float>(x, w1, b1, w2, g, dx, part, grads, hidden, da, rows, dim, f,
                                     splits, p, inv, seed, s);
    if (f % 8) return cudaErrorInvalidValue;
    return sn::mlp_bwd_wide<sn::bf16>(x, w1, b1, w2, g, dx, part, grads, hidden, da, rows, dim,
                                      f, splits, p, inv, seed, s);
  }
  if (dtype == sn::kF32)
    return sn::mlp_bwd_impl<float>(x, w1, b1, w2, g, dx, part, grads, rows, dim, f, splits, p,
                                   inv, seed, s);
  return sn::mlp_bwd_tc(x, w1, b1, w2, g, dx, part, grads, hidden, rows, dim, f, splits, p, inv,
                        seed, s);
}

}  // extern "C"


