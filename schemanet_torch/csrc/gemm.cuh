// Block-tiled matrix products with an epilogue, for the FFN widths that the
// one-launch kernels do not hold (fused_mlp at 384 and 768, ffn_block's fc1
// and fc2 at 768; mlp.cu and encoder_block.cu say which launches use them).
//
//   C[M][N] = A[M][K] B,  A row-major [M][K];  B [N][K] (BKN false: a weight
//   in nn.Linear layout, read K-major) or [K][N] (BKN true, read MN-major)
//
// and every element pair (row, col), (row, col + 1) of C goes to the
// epilogue `epi(row, col, c0, c1, split)` (N even; split 0 but for the split
// sums below), which rounds, adds, stores; the Hopper kernels call it in
// two parts, `epi.cols(col, in)` (the pair's column values, such as biases)
// and `epi.put(row, col, c0, c1, cols, in)` (wg_epilogue below). The
// one-launch kernels keep a whole row tile of A, or its hidden chunk, in
// shared memory: at 768 that tile alone is ~100 KB. These take a fixed tile
// of C and stream all of k through shared memory, so any width fits; the
// price is a hidden state that goes through device memory between two
// launches.
//
// What bounds fc1 and the dual product on the card is their epilogue
// (gelu, the hash mask, gelu': ~60-80 instructions an element), which runs
// after the products on the same warps.
//
//   * gemm_wg_kernel (bf16, Hopper's tensor cores): what bounds it at the
//     FFN's shapes (12,608 rows, 384 or 768 -> 4x) is the tensor cores'
//     rate (K >= 384: ~100-400 operations a byte, above the card's ~295),
//     so the design keeps them fed. A persistent block an SM walks the
//     output tiles (n fastest, so the blocks in flight share their rows of
//     A and a 77 MB A of fc2 at 768 is read from memory once). Warpgroup 0
//     is the producer: one thread keeps TMA loads of A and B in flight
//     through a ring of stages in shared memory (128-byte swizzle, a full
//     and an empty mbarrier a stage) and hands its registers to the
//     consumers (setmaxnreg). The consumer warpgroups (two, or three for a
//     192-row tile) each multiply 64 rows of the tile by wgmma.mma_async
//     m64nBNk16 (bf16 in, fp32 sums),
//     one group of k in flight while the next stage is waited for, and run
//     the epilogue on their fragments while the producer already fills the
//     ring for the next tile. The tile is gemm_tile's choice for the shape
//     (the fewest rounds of persistent blocks; 192 x 128 for an
//     epilogue-heavy Epi); TMA fills rows and k past the ends with zeros and
//     the epilogue masks row < M.
//   * gemm_dual_kernel: the same loop over two products that share their
//     output tile and k, C1 = A1 B1 (B1 [N][K]) and C2 = A2 B2 (B2 [K][N]),
//     two accumulators a thread; the epilogue gets both fragments,
//     `epi.put(row, col, c1_0, c1_1, c2_0, c2_1, cols, in)` (the FFN
//     backward's h and dA).
//   * gemm_fma_kernel (fp32 by FMA): one block of 256 threads a 64 x 64
//     tile, 4 x 4 a thread, k in chunks of 16 through shared memory; A may
//     also be read as [K][M] (AKM: the transpose of a row-major matrix, for
//     the weight gradients x^T dH). The k range of blockIdx.z is [z ks,
//     (z + 1) ks): split sums, each to its own partial, summed later in a
//     fixed order. FMA keeps fp32's agreement, where one TF32 product would
//     not.
// Each element's sum runs over k in a fixed order, the same on every run.
#pragma once

#include "hopper.cuh"

namespace sn {

constexpr int kHgBM = 128;       // rows of a block tile: 64 a consumer warpgroup
constexpr int kHgBK = 64;        // k a stage: one 128-byte row of a swizzled box
constexpr int kHgThreads = 384;  // warpgroup 0 loads, 1 and 2 multiply
constexpr int kHgBox = 64 * 64 * 2;       // bytes of a 64 x 64 box
constexpr int kHgRingBytes = 200 * 1024;  // the stages' share of shared memory, one block an SM
constexpr int kSms = 132;  // the SMs of an H100 SXM, for the tile-width rule

// Registers of a block of NC consumer warpgroups and one producer
// warpgroup: the entry budget of its 128 (NC + 1) threads (168 at NC = 2,
// 128 at NC = 3), within which ptxas compiles every region; at run time the
// producer drops to 40 (setmaxnreg) and the consumers take what it leaves
// (232 at NC = 2: 128 x 40 + 256 x 232 <= 64K).
constexpr int kHgProducerRegs = 40;
template <int NC>
struct HgRegs {
  static constexpr int kEntry = 65536 / (128 * (NC + 1)) / 8 * 8;
  static constexpr int kConsumer =
      (128 * (NC + 1) * kEntry - 128 * kHgProducerRegs) / (128 * NC) / 8 * 8;
};
constexpr int kHgConsumerRegs = HgRegs<2>::kConsumer;

// stage and phase parity of a ring of S buffers
template <int S>
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++stage == S) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// the dynamic shared memory of a kernel, rounded up to 1024 bytes (the
// swizzle's alignment); the launch asks for 1 KB more
__device__ __forceinline__ uint8_t* ring_base(uint8_t* raw) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

// The tile of gemm_tc for an M x N product with a light epilogue: of the
// shapes built (two consumer warpgroups, 128 rows, by 96 or 192 columns
// for K-major B, 128 or 192 for MN-major; three, 192 rows by 192), the one
// with the least rounds of kSms persistent blocks times its rows times
// (columns + 32), the 32 standing for a tile's fixed cost (fill and
// epilogue); a tie goes to the later. At 12,608 rows: fc2 and dx 192 x 192
// at 384 (132 tiles, one round) and at 768, where 128 x 96 ties. An
// epilogue-heavy product (Epi::kHeavy: fc1's gelu and hash, tens of
// instructions an element) takes kHgHeavyN over 192-row tiles of three
// consumer warpgroups: its 64 sums a thread leave the epilogue the
// registers to interleave its elements, and 12 warps run it where 8 did
// (on an H100 SXM at 700 W fc1 at 768 took 0.388 ms at 256 columns and two
// warpgroups, 0.246 at 128, 0.193-0.198 at 128 and three). The launch plans
// (ops/kernels/gemm.py) repeat this rule.
constexpr int kHgHeavyN = 128;

struct HgTile {
  int nc, bn;  // consumer warpgroups (64 rows each), columns
};

inline HgTile gemm_tile(long M, int N, bool mn_major) {
  static const HgTile kmajor[] = {{2, 96}, {2, 192}, {3, 192}};
  static const HgTile mnmajor[] = {{2, 128}, {2, 192}, {3, 192}};
  const HgTile* shapes = mn_major ? mnmajor : kmajor;
  HgTile best = shapes[0];
  long best_cost = -1;
  for (int i = 0; i < 3; ++i) {
    const long bm = 64L * shapes[i].nc, bn = shapes[i].bn;
    const long tiles = (M + bm - 1) / bm * ((N + bn - 1) / bn);
    const long cost = (tiles + kSms - 1) / kSms * bm * (bn + 32);
    if (best_cost < 0 || cost <= best_cost) {
      best = shapes[i];
      best_cost = cost;
    }
  }
  return best;
}

// A consumer warpgroup's epilogue over its fragments (rows row and row + 8,
// columns col0 + 8j and the next; c2 the second product's, where DUAL), in
// groups of G = 4 column pairs: the group's column values first (epi.cols:
// the biases, read before any store), then epi.put on every pair, computed
// unconditionally and stored where inside M x N, so that a thread's
// elements are one straight run the compiler interleaves (the FFN's gelu
// and hash are tens of instructions an element; groups of 2 and 8 ran
// within 5% of 4 on the card).
template <int BN, bool DUAL = false, typename Epi>
__device__ __forceinline__ void wg_epilogue(const Epi& epi, const float (&c1)[BN / 2],
                                            const float (&c2)[BN / 2], long row, int col0, int M,
                                            int N) {
  constexpr int G = 4;
  static_assert((BN / 8) % G == 0, "whole groups");
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += G) {
    typename Epi::Col cv[G];
#pragma unroll
    for (int j = 0; j < G; ++j) cv[j] = epi.cols(col0 + 8 * (j0 + j), col0 + 8 * (j0 + j) < N);
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int col = col0 + 8 * (j0 + j), i = 4 * (j0 + j);
      const bool in = col < N;
      if constexpr (DUAL) {
        epi.put(row, col, c1[i], c1[i + 1], c2[i], c2[i + 1], cv[j], in && row < M);
        epi.put(row + 8, col, c1[i + 2], c1[i + 3], c2[i + 2], c2[i + 3], cv[j],
                in && row + 8 < M);
      } else {
        epi.put(row, col, c1[i], c1[i + 1], cv[j], in && row < M);
        epi.put(row + 8, col, c1[i + 2], c1[i + 3], cv[j], in && row + 8 < M);
      }
    }
  }
}

template <int BN, int NC>
struct WgSmem {
  static constexpr int kA = NC * 64 * kHgBK * 2;  // A box: 64 NC rows of 128 bytes
  static constexpr int kB = BN * kHgBK * 2;     // B: BN rows (K-major) or BN / 64 boxes
  static constexpr int kStage = kA + kB;
  static constexpr int kStages = kHgRingBytes / kStage < 8 ? kHgRingBytes / kStage : 8;
  static constexpr int kBytes = kStages * kStage + 1024;
  static_assert(kStage % 1024 == 0, "stages stay 1024-byte aligned");
};

template <int BN, bool BKN, int NC, typename Epi>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
    gemm_wg_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                   int M, int N, int K, Epi epi) {
  using S = WgSmem<BN, NC>;
  constexpr int BM = 64 * NC;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[S::kStages], empty[S::kStages];
  uint8_t* smem = ring_base(smem_raw);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int m_tiles = (M + BM - 1) / BM, n_tiles = (N + BN - 1) / BN;
  const int tiles = m_tiles * n_tiles, steps = (K + kHgBK - 1) / kHgBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC);  // one arrival a consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (wg == 0) {  // producer
    regs_dec<kHgProducerRegs>();
    if (tid != 0) return;
    Ring<S::kStages> ring;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int n0 = (t % n_tiles) * BN, m0 = (t / n_tiles) * BM;
      for (int s = 0; s < steps; ++s, ring.next()) {
        mbar_wait(&empty[ring.stage], ring.phase ^ 1);
        uint8_t* a_s = smem + ring.stage * S::kStage;
        mbar_arrive_expect(&full[ring.stage], S::kStage);
        tma_load(a_s, &ta, &full[ring.stage], s * kHgBK, m0);
        if (BKN) {
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            tma_load(a_s + S::kA + c * kHgBox, &tb, &full[ring.stage], n0 + c * 64, s * kHgBK);
        } else {
          tma_load(a_s + S::kA, &tb, &full[ring.stage], s * kHgBK, n0);
        }
      }
    }
    return;
  }
  regs_inc<HgRegs<NC>::kConsumer>();
  const int cw = wg - 1, warp = tid / 32, lane = tid % 32;
  Ring<S::kStages> ring;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int n0 = (t % n_tiles) * BN, m0 = (t / n_tiles) * BM;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    wg_fence_regs(acc);
    int held = -1;  // the stage whose products may still be in flight
    for (int s = 0; s < steps; ++s, ring.next()) {
      mbar_wait(&full[ring.stage], ring.phase);
      const uint8_t* a_s = smem + ring.stage * S::kStage + cw * 64 * 128;
      const uint8_t* b_s = smem + ring.stage * S::kStage + S::kA;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kHgBK / 16; ++kk) {
        const uint64_t da = wg_desc(a_s + kk * 32, 16, 1024);
        const uint64_t db = BKN ? wg_desc(b_s + kk * 2048, 64 * 128, 1024)
                                : wg_desc(b_s + kk * 32, 16, 1024);
        wgmma_bf16<BN, 0, BKN ? 1 : 0>(acc, da, db);
      }
      wg_commit();
      wg_wait<1>();  // the previous stage's products are done: release it
      if (held >= 0 && tid == 0) mbar_arrive(&empty[held]);
      held = ring.stage;
    }
    wg_wait<0>();
    if (held >= 0 && tid == 0) mbar_arrive(&empty[held]);
    wg_fence_regs(acc);
    wg_epilogue<BN>(epi, acc, acc, m0 + cw * 64 + warp * 16 + lane / 4,
                               n0 + (lane % 4) * 2, M, N);
  }
}

template <int BN, bool BKN, int NC, typename Epi>
cudaError_t gemm_wg_launch(const bf16* a, const bf16* b, long M, int N, int K, Epi epi,
                           cudaStream_t stream) {
  using S = WgSmem<BN, NC>;
  constexpr int BM = 64 * NC;
  CUtensorMap ta, tb;
  cudaError_t err = tma_map_bf16(&ta, a, M, K, BM);
  if (err != cudaSuccess) return err;
  err = BKN ? tma_map_bf16(&tb, b, K, N, 64) : tma_map_bf16(&tb, b, N, K, BN);
  if (err != cudaSuccess) return err;
  err = allow_smem(gemm_wg_kernel<BN, BKN, NC, Epi>, S::kBytes);
  if (err != cudaSuccess) return err;
  const long tiles = (M + BM - 1) / BM * ((N + BN - 1) / BN);
  const int grid = (int)(tiles < sm_count() ? tiles : sm_count());
  gemm_wg_kernel<BN, BKN, NC, Epi>
      <<<grid, 128 * (NC + 1), S::kBytes, stream>>>(ta, tb, (int)M, N, K, epi);
  return cudaGetLastError();
}

// A and B bf16, 16-byte aligned; K (and N where BKN) multiples of 8, N even
template <bool BKN, typename Epi>
cudaError_t gemm_tc(const bf16* a, const bf16* b, long M, int N, int K, Epi epi,
                    cudaStream_t stream) {
  if (K % 8 || N % 2 || (BKN && N % 8)) return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  if constexpr (Epi::kHeavy && !BKN) {
    return gemm_wg_launch<kHgHeavyN, false, 3, Epi>(a, b, M, N, K, epi, stream);
  } else {
    const HgTile t = gemm_tile(M, N, BKN);
    if (t.nc == 3) return gemm_wg_launch<192, BKN, 3, Epi>(a, b, M, N, K, epi, stream);
    if constexpr (BKN) {
      if (t.bn == 128) return gemm_wg_launch<128, true, 2, Epi>(a, b, M, N, K, epi, stream);
      if (t.bn == 192) return gemm_wg_launch<192, true, 2, Epi>(a, b, M, N, K, epi, stream);
    } else {
      if (t.bn == 96) return gemm_wg_launch<96, false, 2, Epi>(a, b, M, N, K, epi, stream);
      if (t.bn == 192) return gemm_wg_launch<192, false, 2, Epi>(a, b, M, N, K, epi, stream);
    }
    return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// two products over one output tile of 128 rows x 128: a stage holds A1, A2
// (128 rows of k each), B1 (128 rows of k, K-major) and B2 (two 64-wide
// boxes of [K][N], MN-major), 64 KB, three stages. Each consumer thread
// keeps 2 x 64 sums.
// ---------------------------------------------------------------------------
constexpr int kDualBN = 128;

struct DualSmem {
  static constexpr int BN = kDualBN;
  static constexpr int kA = kHgBM * kHgBK * 2;  // 16 KB: one A operand's share of a stage
  static constexpr int kB = BN * kHgBK * 2;
  static constexpr int kStage = 2 * kA + 2 * kB;
  static constexpr int kStages = kHgRingBytes / kStage < 8 ? kHgRingBytes / kStage : 8;
  static constexpr int kBytes = kStages * kStage + 1024;
};

template <typename Epi>
__global__ void __launch_bounds__(kHgThreads, 1)
    gemm_dual_kernel(const __grid_constant__ CUtensorMap ta1,
                     const __grid_constant__ CUtensorMap tb1,
                     const __grid_constant__ CUtensorMap ta2,
                     const __grid_constant__ CUtensorMap tb2, int M, int N, int K, Epi epi) {
  using S = DualSmem;
  constexpr int BN = kDualBN;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[S::kStages], empty[S::kStages];
  uint8_t* smem = ring_base(smem_raw);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int m_tiles = (M + kHgBM - 1) / kHgBM, n_tiles = (N + BN - 1) / BN;
  const int tiles = m_tiles * n_tiles, steps = (K + kHgBK - 1) / kHgBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (wg == 0) {
    regs_dec<kHgProducerRegs>();
    if (tid != 0) return;
    Ring<S::kStages> ring;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int n0 = (t % n_tiles) * BN, m0 = (t / n_tiles) * kHgBM;
      for (int s = 0; s < steps; ++s, ring.next()) {
        mbar_wait(&empty[ring.stage], ring.phase ^ 1);
        uint8_t* st = smem + ring.stage * S::kStage;
        uint64_t* bar = &full[ring.stage];
        mbar_arrive_expect(bar, S::kStage);
        tma_load(st, &ta1, bar, s * kHgBK, m0);
        tma_load(st + S::kA, &ta2, bar, s * kHgBK, m0);
        tma_load(st + 2 * S::kA, &tb1, bar, s * kHgBK, n0);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma_load(st + 2 * S::kA + S::kB + c * kHgBox, &tb2, bar, n0 + c * 64, s * kHgBK);
      }
    }
    return;
  }
  regs_inc<kHgConsumerRegs>();
  const int cw = wg - 1, warp = tid / 32, lane = tid % 32;
  Ring<S::kStages> ring;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int n0 = (t % n_tiles) * BN, m0 = (t / n_tiles) * kHgBM;
    float c1[BN / 2], c2[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) c1[i] = c2[i] = 0.f;
    wg_fence_regs(c1);
    wg_fence_regs(c2);
    int held = -1;
    for (int s = 0; s < steps; ++s, ring.next()) {
      mbar_wait(&full[ring.stage], ring.phase);
      const uint8_t* st = smem + ring.stage * S::kStage;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kHgBK / 16; ++kk) {
        wgmma_bf16<BN, 0, 0>(c1, wg_desc(st + cw * 64 * 128 + kk * 32, 16, 1024),
                             wg_desc(st + 2 * S::kA + kk * 32, 16, 1024));
        wgmma_bf16<BN, 0, 1>(c2, wg_desc(st + S::kA + cw * 64 * 128 + kk * 32, 16, 1024),
                             wg_desc(st + 2 * S::kA + S::kB + kk * 2048, 64 * 128, 1024));
      }
      wg_commit();
      wg_wait<1>();
      if (held >= 0 && tid == 0) mbar_arrive(&empty[held]);
      held = ring.stage;
    }
    wg_wait<0>();
    if (held >= 0 && tid == 0) mbar_arrive(&empty[held]);
    wg_fence_regs(c1);
    wg_fence_regs(c2);
    wg_epilogue<BN, true>(epi, c1, c2, m0 + cw * 64 + warp * 16 + lane / 4,
                                     n0 + (lane % 4) * 2, M, N);
  }
}

// C1 = A1 B1^T (A1 [M][K], B1 [N][K]) and C2 = A2 B2 (A2 [M][K], B2 [K][N]),
// all bf16, 16-byte aligned; K and N multiples of 8
template <typename Epi>
cudaError_t gemm_tc_dual(const bf16* a1, const bf16* b1, const bf16* a2, const bf16* b2, long M,
                         int N, int K, Epi epi, cudaStream_t stream) {
  using S = DualSmem;
  constexpr int BN = kDualBN;
  if (K % 8 || N % 8) return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  CUtensorMap ta1, tb1, ta2, tb2;
  cudaError_t err = tma_map_bf16(&ta1, a1, M, K, kHgBM);
  if (err == cudaSuccess) err = tma_map_bf16(&ta2, a2, M, K, kHgBM);
  if (err == cudaSuccess) err = tma_map_bf16(&tb1, b1, N, K, BN);
  if (err == cudaSuccess) err = tma_map_bf16(&tb2, b2, K, N, 64);
  if (err == cudaSuccess) err = allow_smem(gemm_dual_kernel<Epi>, S::kBytes);
  if (err != cudaSuccess) return err;
  const long tiles = (M + kHgBM - 1) / kHgBM * ((N + BN - 1) / BN);
  const int grid = (int)(tiles < sm_count() ? tiles : sm_count());
  gemm_dual_kernel<Epi>
      <<<grid, kHgThreads, S::kBytes, stream>>>(ta1, tb1, ta2, tb2, (int)M, N, K, epi);
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
