// The transformer FFN's hidden element and the bf16 tensor-core forward's
// chunk loop, shared by the fused_mlp forward (mlp.cu, mlp_fwd_tc_kernel: x
// staged as it is, dropout) and the frozen ffn_block (encoder_block.cu,
// ffn_tc_kernel: LN2(x) as the A tile, no dropout, the residual).
//
// The chunk loop: a block of 8 warps holds RT rows of the A operand in
// shared memory; the hidden width goes by in chunks of 32, W1[f0:+32, :] and
// W2[:, f0:+32] double-buffered by cp.async. Per chunk each warp computes
// h = A W1^T for its 16 rows and 32 / WC of the chunk's columns (W1 rows as
// [n][k] by ldmatrix), turns the C fragments into the activation
// (ffn_hidden: b1, gelu, the mask) and writes it, bf16, to a shared
// tile; then out += act W2^T (W2's chunk as [n][k]) for its 16 rows and
// DIM / WC columns, in fp32 registers over all chunks. The hidden state
// never leaves the chip. RT = 64 (4 row groups x 2 column groups of warps)
// or 32 (2 x 4): 32 at DIM 384 keeps the output fragments at 48 registers
// a thread, where 64 rows would hold 96.
#pragma once

#include "common.cuh"
#include "dropmask.cuh"

namespace sn {

// Abramowitz & Stegun 7.1.26 erf, as the TPU kernels compute it in fp32.
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

// The hidden element (row, col) of the FFN from its fp32 fc1 sum, with the
// TPU kernel's roundings to the storage type T: h = round(round(acc) + b1),
// a = round(gelu(h)), and with dropout a_used = round(a * inv_t) where the
// hash keeps (row, col), else 0. The tensor-core forward and backward both
// call it on their C fragments, so they regenerate the same h, a_used and
// mask; so do the wide routes' epilogues (mlp.cu).
struct FfnHidden {
  float h, a_used;
  bool keep;
};

template <typename T>
__device__ __forceinline__ FfnHidden ffn_hidden(float acc, const T* b1, long row, int col, int f,
                                                float p, float inv_t, uint32_t h0) {
  FfnHidden v;
  v.h = Num<T>::round(Num<T>::round(acc) + Num<T>::load(b1, col));
  v.a_used = Num<T>::round(gelu_as(v.h));
  v.keep = true;
  if (p > 0.f) {
    v.keep = drop_keep(h0, (uint32_t)row, f, col, p);
    v.a_used = v.keep ? Num<T>::round(v.a_used * inv_t) : 0.f;
  }
  return v;
}

// ffn_hidden for the wide route's epilogues (mlp.cu), where a thread's
// elements run as one straight sequence the compiler interleaves: b1's value
// passed in (read before any store), the hash computed at p = 0 too and the
// mask applied by selects, no branch. The same numbers as ffn_hidden.
template <typename T>
__device__ __forceinline__ FfnHidden ffn_hidden_sel(float acc, float bias, long row, int col,
                                                    int f, float p, float inv_t, uint32_t h0) {
  FfnHidden v;
  v.h = Num<T>::round(Num<T>::round(acc) + bias);
  const float a = Num<T>::round(gelu_as(v.h));
  const bool drop = p > 0.f;
  const bool keep = drop_keep(h0, (uint32_t)row, f, col, p);
  v.keep = keep | !drop;
  v.a_used = drop ? (keep ? Num<T>::round(a * inv_t) : 0.f) : a;
  return v;
}

constexpr int kFfnChunk = 32;  // hidden columns a step
constexpr int kFfnChunkPitch = kFfnChunk + 8;

// The warps of a block over RT rows: WR groups of 16 rows by WC column groups.
template <int DIM, int RT>
struct FfnTcLayout {
  static_assert(RT == 32 || RT == 64, "a block takes 32 or 64 rows");
  static constexpr int kWR = RT / 16, kWC = kThreads / 32 / kWR;
  static constexpr int kFc1Tiles = kFfnChunk / 8 / kWC;  // n8 tiles of fc1 a warp: 2 or 1
  static constexpr int kOutCols = DIM / kWC;             // fc2 columns a warp
  static constexpr int kOutTiles = kOutCols / 8;
  static_assert(kOutCols % 16 == 0, "fc2 loads B 16 columns at a time");
  static_assert(kFc1Tiles == 2 || DIM % 32 == 0, "one fc1 tile a warp steps k by 32");
};

// bf16 shared memory: the A rows [RT][DIM], two stages of (W1 chunk
// [32][DIM], W2 chunk [DIM][32]) and the chunk's activation [RT][32], each
// row padded by 16 bytes
template <int DIM, int RT>
struct FfnTcSmem {
  static constexpr int kPitch = DIM + 8;
  static constexpr int kA = RT * kPitch;
  static constexpr int kW1 = kFfnChunk * kPitch;
  static constexpr int kW2 = DIM * kFfnChunkPitch;
  static constexpr int kAct = RT * kFfnChunkPitch;
  static constexpr int kStage = kW1 + kW2;
  static constexpr size_t kBytes = sizeof(bf16) * (kA + 2 * kStage + kAct);
};

// chunk c of W1 and W2 into its stage by cp.async; the caller commits
template <int DIM, int RT>
__device__ __forceinline__ void ffn_tc_stage_chunk(bf16* stages, const bf16* w1, const bf16* w2,
                                                   int f, int c) {
  using S = FfnTcSmem<DIM, RT>;
  bf16* w1s = stages + (c & 1) * S::kStage;
  const int f0 = c * kFfnChunk;
  stage_tile<kThreads>(w1s, S::kPitch, w1, DIM, f, DIM, f0, 0, kFfnChunk, DIM);
  stage_tile<kThreads>(w1s + S::kW1, kFfnChunkPitch, w2, f, DIM, f, 0, f0, DIM, kFfnChunk);
}

// (row, column) in the block's tile of element e of output fragment (nt, half)
template <int DIM, int RT>
__device__ __forceinline__ int2 ffn_tc_out_coord(int nt, int half, int lane) {
  using L = FfnTcLayout<DIM, RT>;
  const int warp = threadIdx.x >> 5;
  return make_int2((warp / L::kWC) * 16 + (lane >> 2) + half * 8,
                   (warp % L::kWC) * L::kOutCols + nt * 8 + (lane & 3) * 2);
}

// oacc += act(A W1^T + b1) W2^T over the whole hidden width, for the A tile
// `a` [RT][DIM + 8] of the rows from row0. On entry chunk 0 is staged into
// `stages` (its cp.async group committed) and the A tile is written or in
// flight in the same group; the first wait and barrier publish both.
template <int DIM, int RT>
__device__ __forceinline__ void ffn_tc_chunks(const bf16* a, bf16* stages, bf16* act,
                                              const bf16* w1, const bf16* b1, const bf16* w2,
                                              long row0, int f, float p, float inv_t, uint32_t h0,
                                              float (&oacc)[FfnTcLayout<DIM, RT>::kOutTiles][4]) {
  using S = FfnTcSmem<DIM, RT>;
  using L = FfnTcLayout<DIM, RT>;
  constexpr int P = S::kPitch, CP = kFfnChunkPitch, NT1 = L::kFc1Tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp / L::kWC, wc = warp % L::kWC;
  const int chunks = (f + kFfnChunk - 1) / kFfnChunk;
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<0>();
    __syncthreads();  // chunk c landed; every warp is past chunk c - 1
    if (c + 1 < chunks) {
      ffn_tc_stage_chunk<DIM, RT>(stages, w1, w2, f, c + 1);
      cp_async_commit();
    }
    const bf16* w1t = stages + (c & 1) * S::kStage;
    const bf16* w2t = w1t + S::kW1;
    const int f0 = c * kFfnChunk;

    // h = A W1^T for rows 16 wr.., chunk columns 8 NT1 wc..
    float hacc[NT1][4] = {};
    if constexpr (NT1 == 2) {
#pragma unroll
      for (int kk = 0; kk < DIM / 16; ++kk) {
        uint32_t af[4], b[4];
        ldsm_a(af, a, P, wr * 16, kk * 16, lane);
        ldsm_b_nk(b, w1t, P, wc * 16, kk * 16, lane);
        mma16816(hacc[0], af, b[0], b[1]);
        mma16816(hacc[1], af, b[2], b[3]);
      }
    } else {
#pragma unroll 4
      for (int kk = 0; kk < DIM / 32; ++kk) {
        uint32_t a0[4], a1[4], b[4];
        ldsm_b_nk_k32(b, w1t, P, wc * 8, kk * 32, lane);
        ldsm_a(a0, a, P, wr * 16, kk * 32, lane);
        ldsm_a(a1, a, P, wr * 16, kk * 32 + 16, lane);
        mma16816(hacc[0], a0, b[0], b[1]);
        mma16816(hacc[0], a1, b[2], b[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT1; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wr * 16 + (lane >> 2) + half * 8;
        const int cc = wc * (NT1 * 8) + nt * 8 + (lane & 3) * 2;
        float av[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = f0 + cc + e;
          av[e] = col < f ? ffn_hidden<bf16>(hacc[nt][half * 2 + e], b1, row0 + r, col, f, p,
                                            inv_t, h0)
                                .a_used
                          : 0.f;
        }
        *reinterpret_cast<uint32_t*>(act + r * CP + cc) = pack_bf16(av[0], av[1]);
      }
    __syncthreads();

    // out += act W2^T over the chunk: rows 16 wr.., columns wc DIM / WC..
#pragma unroll
    for (int kk = 0; kk < kFfnChunk / 16; ++kk) {
      uint32_t af[4];
      ldsm_a(af, act, CP, wr * 16, kk * 16, lane);
#pragma unroll
      for (int nb = 0; nb < L::kOutTiles / 2; ++nb) {
        uint32_t b[4];
        ldsm_b_nk(b, w2t, CP, wc * L::kOutCols + nb * 16, kk * 16, lane);
        mma16816(oacc[2 * nb], af, b[0], b[1]);
        mma16816(oacc[2 * nb + 1], af, b[2], b[3]);
      }
    }
  }
}

}  // namespace sn
