// Frozen pre-norm encoder layer in two halves, for Hopper (sm_90a).
//
// Replaces schemanet_tpu/ops/pallas/encoder_block.py:
//   attn_block (_attn_block_kernel, _attn_block_hmean_kernel):
//       y = x + (MHSA(LN1(x) Wqkv + bqkv) Wo + bo)   [+ head-mean of the scores]
//   ffn_block (_ffn_block_kernel):
//       z = y + (act(LN2(y) W1 + b1) W2 + b2), act the registry's activation
//
// What bounds it on the card: at the serving shape ([64, 197, 192], 3 heads
// of 64, FFN 768) a layer is ~13 GFLOP against ~10 MB of activations, so the
// halves are compute-bound once the intermediates stay on chip. On the TPU one
// program held an item's whole qkv ([197, 576]) plus its [197, 197] fp32 score
// tiles in VMEM; on Hopper that qkv alone (227 KB in bf16) fills a block's
// shared memory. So attn_block writes qkv and the heads' outputs (mh) to
// device memory between its products, and its [n, n] scores never leave the
// chip; ffn_block is one launch whose [rows, 768] hidden state never leaves
// it.
// Routes by the storage type (ops/kernels/encoder_block.py attn_block_route
// and ffn_block_route say which, and raise on what none takes):
//   * attn_block: bf16 on the tensor cores (linear_tc_kernel around
//     attention.cu's mhsa_tc kernels); fp32 by the 3xTF32 split on the TF32
//     tensor cores (linear_tf32_kernel around attn_tf32_kernel), any n,
//     head_dim up to 128. The split holds about fp32's accuracy where one
//     TF32 product would not: each 8 of k is summed in a zeroed fragment
//     and added in fp32 (the tensor cores truncate at every mma: chained
//     over all of k their sums drift to ~10x fp32's error, over 32 of k the
//     head-mean's error passed the plain fp32 version's).
//   * ffn_block: bf16 ffn_tc_kernel (mma.sync m16n8k16, the fused_mlp
//     forward's chunk loop of ffn.cuh behind an LN2 prologue); fp32
//     ffn_tf32_kernel (mma.sync m16n8k8 .tf32 by the 3xTF32 split). Past
//     width 384 the three launches of ffn_wide_tc (below).
//
// Numerics follow the TPU kernels: LN statistics in fp32 (E[x^2] - E[x]^2),
// every product accumulated in fp32 and rounded once to T, bias added in T
// after that rounding, q scaled in T, scores and softmax in fp32, the
// probabilities rounded to T before the AV product, the head-mean summed in
// fp32 over heads in order and scaled by 1/H, the FFN's activation in fp32
// (ffn.cuh's ffn_act: gelu with the Abramowitz-Stegun erf, or relu, swish,
// sigmoid, hard_sigmoid or none, a runtime code), the residual added in T. The
// fp32 attention takes its softmax online over chunks of 32 keys (running
// max, sums rescaled), dividing by the row's sum after the AV product: the
// same function, rounded in another order.
#include "ffn.cuh"
#include "gemm.cuh"

namespace sn {

// ---------------------------------------------------------------------------
// fp32 route of attn_block (attn_block_route's "split_tf32"): every product
// on the TF32 tensor cores (mma.sync m16n8k8) by the 3xTF32 split of
// common.cuh, each value split into hi and lo planes once, as it is stored
// into shared memory. Four launches:
//   (a) ln_stats_kernel: LN1's (mean, rstd) of every row, one warp a row, to
//       an fp32 scratch, so the product blocks below, which each take 128
//       rows, start without a serial walk over their rows;
//   (b) linear_tf32_kernel<true>: qkv = LN1(x) Wqkv^T + bqkv;
//   (c) attn_tf32_kernel<DP>: mh = softmax(q_s K^T) V per head into an fp32
//       scratch [rows, H d], and, where hmean is not null, the head-mean of
//       q_s K^T;
//   (d) linear_tf32_kernel<false>: out = x + (mh Wo^T + bo).
// Raw fp32 chunks reach shared memory by cp.async (16-byte copies where the
// widths and pointers allow, else 4-byte), in flight while the previous
// chunk is multiplied; a split pass then writes the chunk's planes (the
// split done once an element a block, never per mma). Every 8 of k (d in
// the scores, keys in the AV product) is summed in a zeroed fragment and
// added in fp32.
// ---------------------------------------------------------------------------

// Rows [row0, row0 + R) and columns [col0, col0 + C) of a row-major fp32
// matrix (row stride ld) into a dense [R][C] shared chunk by cp.async,
// THREADS threads; values at rows >= nrows or columns >= col_end are zero.
// vec: 16-byte copies (ld, col0 and col_end multiples of 4 and src 16-byte
// aligned), else 4-byte ones. The caller commits the group.
template <int R, int C, int THREADS>
__device__ __forceinline__ void stage_raw_f32(float* dst, const float* src, long ld, long nrows,
                                              long row0, int col0, int col_end, bool vec) {
  if (vec) {
    constexpr int kQuads = C / 4;
    for (int idx = threadIdx.x; idx < R * kQuads; idx += THREADS) {
      const int r = idx / kQuads, c = idx % kQuads * 4, col = col0 + c;
      const long row = row0 + r;
      const bool in = row < nrows && col < col_end;
      cp_async16(dst + r * C + c, in ? src + row * ld + col : src, in ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < R * C; idx += THREADS) {
      const int r = idx / C, col = col0 + idx % C;
      const long row = row0 + r;
      const bool in = row < nrows && col < col_end;
      cp_async_ca<4>(dst + idx, in ? src + row * ld + col : src, in ? 4 : 0);
    }
  }
}

// A dense [R][C] fp32 chunk split into TF32 planes hi and lo ([R][P]
// words), THREADS threads. A thread takes the quad of columns split_col<C>()
// of rows split_row<C>() + j THREADS / (C / 4), the same in every chunk;
// each quad v of its j-th row passes through f(j, v) first.
template <int C>
__device__ __forceinline__ int split_row() { return threadIdx.x / (C / 4); }
template <int C>
__device__ __forceinline__ int split_col() { return threadIdx.x % (C / 4) * 4; }

template <int R, int C, int P, int THREADS, typename F>
__device__ __forceinline__ void split_chunk(const float* raw, uint32_t* hi, uint32_t* lo, F f) {
  constexpr int kStep = THREADS / (C / 4);  // rows a pass of the block
  static_assert(THREADS % (C / 4) == 0 && R % kStep == 0, "whole quads a thread");
  const int r0 = split_row<C>(), c = split_col<C>();
#pragma unroll
  for (int j = 0; j < R / kStep; ++j) {
    const int r = r0 + j * kStep;
    uint4 h, l;
    tf32_split4(f(j, *reinterpret_cast<const float4*>(raw + r * C + c)), h, l);
    *reinterpret_cast<uint4*>(hi + r * P + c) = h;
    *reinterpret_cast<uint4*>(lo + r * P + c) = l;
  }
}

struct Identity4 {
  __device__ __forceinline__ float4 operator()(int, float4 v) const { return v; }
};

// the planes as bf16 pairs for the fragment loaders: pitch and k doubled
__device__ __forceinline__ const bf16* tf32_as_bf16(const uint32_t* p) {
  return reinterpret_cast<const bf16*>(p);
}

// (a) (mean, rstd) of each row of x [rows, dim], one warp a row
__global__ void __launch_bounds__(kThreads)
    ln_stats_kernel(const float* __restrict__ x, float2* __restrict__ stats, int rows, int dim,
                    float eps) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  float mean, rstd;
  layernorm_stats<float>(x, (long)row * dim, dim, eps, lane, mean, rstd);
  if (lane == 0) stats[row] = make_float2(mean, rstd);
}

// (b), (d): y = [LN](a) W^T + bias [+ resid], a [rows, K], W [N, K]. One
// block of 8 warps a 128 x 64 tile of y, each warp 32 rows x 32 columns
// (2 x 4 fragments: 4 ldmatrix of A and 4 of W a step of 8 of k for 24 mma);
// k in chunks of 32. Shared memory: the raw chunks of A and W (24 KB), their
// planes (54 KB) and the rows' LN statistics (1 KB), two blocks an SM.
constexpr int kLtRows = 128, kLtCols = 64, kLtK = 32;
constexpr int kLtPitch = kLtK + 4;  // words: the 8 rows an ldmatrix reads fall on distinct banks

struct LinearTf32Smem {
  static constexpr int kRawA = kLtRows * kLtK, kRawW = kLtCols * kLtK;
  static constexpr int kA = kLtRows * kLtPitch, kW = kLtCols * kLtPitch;  // one plane each
  static constexpr size_t kBytes = sizeof(float) * (kRawA + kRawW + 2 * (kA + kW) + 2 * kLtRows);
};

// kAct: y = act(acc + bias), the activation's instance A and code act (the
// wide FFN's fc1)
template <bool kLn, bool kAct = false, int A = kActGelu>
__global__ void __launch_bounds__(kThreads, 2)
    linear_tf32_kernel(const float* __restrict__ a, const float2* __restrict__ stats,
                       const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
                       const float* __restrict__ w, const float* __restrict__ bias,
                       const float* __restrict__ resid, float* __restrict__ y, int rows, int K,
                       int N, int vec, int act) {
  using S = LinearTf32Smem;
  constexpr int P = kLtPitch;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* raw_a = reinterpret_cast<float*>(smem_raw);
  float* raw_w = raw_a + S::kRawA;
  uint32_t* a_hi = reinterpret_cast<uint32_t*>(raw_w + S::kRawW);
  uint32_t* a_lo = a_hi + S::kA;
  uint32_t* w_hi = a_lo + S::kA;
  uint32_t* w_lo = w_hi + S::kW;
  float2* st = reinterpret_cast<float2*>(w_lo + S::kW);  // (mean, rstd) of the block's rows
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp >> 1, wc = warp & 1;  // rows 32 wr.., columns 32 wc.. of the tile
  const long row0 = (long)blockIdx.x * kLtRows;
  const int n0 = blockIdx.y * kLtCols;
  const int chunks = (K + kLtK - 1) / kLtK;
  auto stage = [&](int c) {
    stage_raw_f32<kLtRows, kLtK, kThreads>(raw_a, a, K, rows, row0, c * kLtK, K, vec);
    stage_raw_f32<kLtCols, kLtK, kThreads>(raw_w, w, K, N, n0, c * kLtK, K, vec);
    cp_async_commit();
  };

  stage(0);
  // LN: the block's rows' statistics, loaded once (rows past the end take
  // (0, 0): their values are never stored)
  if (kLn && threadIdx.x < kLtRows)
    st[threadIdx.x] = row0 + threadIdx.x < rows ? stats[row0 + threadIdx.x] : make_float2(0.f, 0.f);
  constexpr int kSplitStep = kThreads / (kLtK / 4);  // rows apart of a thread's split quads
  float acc[2][4][4] = {};
  for (int c = 0; c < chunks; ++c) {
    const int k0 = c * kLtK;
    float lg[4] = {}, lb[4] = {};  // LN's scale and bias at this thread's columns, 0 past K
    if (kLn) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = k0 + split_col<kLtK>() + q;
        lg[q] = k < K ? ln_scale[k] : 0.f;
        lb[q] = k < K ? ln_bias[k] : 0.f;
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // chunk c has landed, and every warp is done with chunk c - 1's planes
    split_chunk<kLtRows, kLtK, P, kThreads>(raw_a, a_hi, a_lo, [&](int j, float4 v) {
      if (!kLn) return v;
      const float2 s = st[split_row<kLtK>() + j * kSplitStep];
      return make_float4((v.x - s.x) * s.y * lg[0] + lb[0], (v.y - s.x) * s.y * lg[1] + lb[1],
                         (v.z - s.x) * s.y * lg[2] + lb[2], (v.w - s.x) * s.y * lg[3] + lb[3]);
    });
    split_chunk<kLtCols, kLtK, P, kThreads>(raw_w, w_hi, w_lo, Identity4());
    __syncthreads();  // the planes are in and the raw chunks free
    if (c + 1 < chunks) stage(c + 1);  // in flight while the tensor cores work

#pragma unroll 1  // unrolled, two steps' fragments in flight pass 128 registers and spill
    for (int ks = 0; ks < kLtK / 8; ++ks) {
      float t[2][4][4] = {};  // this 8 of k in a zeroed fragment
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        ldsm_a(ah[mi], tf32_as_bf16(a_hi), 2 * P, wr * 32 + mi * 16, ks * 16, lane);
        ldsm_a(al[mi], tf32_as_bf16(a_lo), 2 * P, wr * 32 + mi * 16, ks * 16, lane);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bh[4], bl[4];
        ldsm_b_nk(bh, tf32_as_bf16(w_hi), 2 * P, wc * 32 + np * 16, ks * 16, lane);
        ldsm_b_nk(bl, tf32_as_bf16(w_lo), 2 * P, wc * 32 + np * 16, ks * 16, lane);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma1688_split(t[mi][2 * np], ah[mi], al[mi], bh[0], bh[1], bl[0], bl[1]);
          mma1688_split(t[mi][2 * np + 1], ah[mi], al[mi], bh[2], bh[3], bl[2], bl[3]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] += t[mi][ni][e];
    }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long row = row0 + wr * 32 + mi * 16 + (lane >> 2) + (e >> 1) * 8;
        const int col = n0 + wc * 32 + ni * 8 + (lane & 3) * 2 + (e & 1);
        if (row >= rows || col >= N) continue;
        const float v = acc[mi][ni][e] + bias[col];
        y[row * N + col] = kAct ? ffn_act<A>(act, v) : kLn ? v : resid[row * N + col] + v;
      }
}

// (c) The attention of qkv [bs, n, (3, H, d)] into mh [bs, n, H d]: one
// block of 4 warps per (64 query rows, head, item), each warp 16 rows; with
// hmean one block per (64 query rows, item) takes every head in order. q_s
// = q * scale is split into planes once a head; K and V stream through in
// chunks of 32 keys. A chunk: S = q_s K^T (each 8 of d in a zeroed
// fragment), keys past n masked, the row's running max m and the lane's
// running sum l rescaled by exp(m_old - m), p = exp(s - m); then o = o
// exp(m_old - m) + p V (each 8 keys in a zeroed fragment). p goes from the C
// fragment of S straight into the A fragment of the AV product without a
// shuffle: lane t holds keys 2 (t % 4) and 2 (t % 4) + 1 of each 8, which
// become k slots t % 4 and t % 4 + 4, and V's B fragment is read from the
// same two keys (a V row pitch of 4 mod 16 words keeps those 32 loads on
// distinct banks). V rows past n are zero (the cp.async zero fill): their p
// is 0, and 0 x stale data could be NaN. mh = o / l at the end. The
// head-mean adds each head's s into hmean [bs, n, n] fp32 by the lane that
// holds it (the same lane every head: h = 0 stores, the last head scales by
// 1/H), so the sum runs in head order without atomics. DP: head_dim padded
// to 32, 64 or 128 (zero columns); shared memory 45, 86 or 168 KB.
constexpr int kAtRows = 64, kAtKeys = 32, kAtThreads = 128;

template <int DP>
struct AttnTf32Smem {
  static constexpr int kPitch = DP + 4;         // words, 4 mod 16 (see above)
  static constexpr int kQ = kAtRows * kPitch;   // one plane of q_s
  static constexpr int kKV = kAtKeys * kPitch;  // one plane of a K or V chunk
  static constexpr int kRaw = kAtKeys * DP;     // a raw K or V chunk
  static constexpr size_t kBytes = sizeof(float) * (2 * kQ + 4 * kKV + 2 * kRaw);
};

template <int DP>
__global__ void __launch_bounds__(kAtThreads)
    attn_tf32_kernel(const float* __restrict__ qkv, float* __restrict__ mh,
                     float* __restrict__ hmean, int n, int heads, int d, float scale, int vec) {
  using S = AttnTf32Smem<DP>;
  constexpr int P = S::kPitch, NT = DP / 8;  // n8 tiles of d
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* q_hi = reinterpret_cast<uint32_t*>(smem_raw);
  uint32_t* q_lo = q_hi + S::kQ;
  uint32_t* k_hi = q_lo + S::kQ;
  uint32_t* k_lo = k_hi + S::kKV;
  uint32_t* v_hi = k_lo + S::kKV;
  uint32_t* v_lo = v_hi + S::kKV;
  float* raw_k = reinterpret_cast<float*>(v_lo + S::kKV);
  float* raw_v = raw_k + S::kRaw;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * kAtRows, b = blockIdx.z;
  const int i0 = q0 + warp * 16 + (lane >> 2);  // rows i0 and i0 + 8 of the C fragments
  const int hd = heads * d, n3 = 3 * hd;
  const long item = (long)b * n;
  const int chunks = (n + kAtKeys - 1) / kAtKeys;
  const int h_begin = hmean ? 0 : blockIdx.y, h_end = hmean ? heads : blockIdx.y + 1;
  const float inv_h = (float)(1.0 / heads);
  const float neg_inf = -__int_as_float(0x7f800000);
  auto stage = [&](int h, int c) {  // raw K and V of keys 32 c.. of head h
    const long key0 = item + c * kAtKeys;
    stage_raw_f32<kAtKeys, DP, kAtThreads>(raw_k, qkv, n3, item + n, key0, (heads + h) * d,
                                           (heads + h + 1) * d, vec);
    stage_raw_f32<kAtKeys, DP, kAtThreads>(raw_v, qkv, n3, item + n, key0, (2 * heads + h) * d,
                                           (2 * heads + h + 1) * d, vec);
    cp_async_commit();
  };

  for (int h = h_begin; h < h_end; ++h) {
    if (h > h_begin) __syncthreads();  // every warp is done with the last head's q planes
    stage(h, 0);
    for (int idx = threadIdx.x; idx < kAtRows * DP; idx += kAtThreads) {
      const int r = idx / DP, c = idx % DP;
      const float v = q0 + r < n && c < d ? qkv[(item + q0 + r) * n3 + h * d + c] * scale : 0.f;
      tf32_split(v, q_hi[r * P + c], q_lo[r * P + c]);
    }
    float m[2] = {neg_inf, neg_inf}, l[2] = {0.f, 0.f};
    float o[NT][4] = {};
    for (int c = 0; c < chunks; ++c) {
      cp_async_wait<0>();
      __syncthreads();  // chunk c and the q planes are in; every warp is done with chunk c - 1
      split_chunk<kAtKeys, DP, P, kAtThreads>(raw_k, k_hi, k_lo, Identity4());
      split_chunk<kAtKeys, DP, P, kAtThreads>(raw_v, v_hi, v_lo, Identity4());
      __syncthreads();
      if (c + 1 < chunks) stage(h, c + 1);

      // s = q_s K^T: this warp's 16 rows x the chunk's 32 keys (4 n8 tiles)
      float s[4][4] = {};
#pragma unroll
      for (int ks = 0; ks < DP / 8; ++ks) {
        float t[4][4] = {};  // this 8 of d in a zeroed fragment
        uint32_t ah[4], al[4];
        ldsm_a(ah, tf32_as_bf16(q_hi), 2 * P, warp * 16, ks * 16, lane);
        ldsm_a(al, tf32_as_bf16(q_lo), 2 * P, warp * 16, ks * 16, lane);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bh[4], bl[4];
          ldsm_b_nk(bh, tf32_as_bf16(k_hi), 2 * P, np * 16, ks * 16, lane);
          ldsm_b_nk(bl, tf32_as_bf16(k_lo), 2 * P, np * 16, ks * 16, lane);
          mma1688_split(t[2 * np], ah, al, bh[0], bh[1], bl[0], bl[1]);
          mma1688_split(t[2 * np + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] += t[nt][e];
      }

      // the head-mean's sum, and the keys past n masked
      float mc[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + (e >> 1) * 8, j = c * kAtKeys + nt * 8 + (lane & 3) * 2 + (e & 1);
          if (hmean != nullptr && i < n && j < n) {
            float* acc = hmean + (item + i) * n + j;
            const float v = h == 0 ? s[nt][e] : *acc + s[nt][e];
            *acc = h == heads - 1 ? v * inv_h : v;
          }
          if (j >= n) s[nt][e] = neg_inf;
          mc[e >> 1] = fmaxf(mc[e >> 1], s[nt][e]);
        }
      // the online softmax: the row's max over its 4 lanes (the chunk holds
      // key 32 c < n, so it is finite), the old sums rescaled
      float alpha[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        mc[half] = fmaxf(mc[half], __shfl_xor_sync(0xffffffffu, mc[half], 1));
        mc[half] = fmaxf(mc[half], __shfl_xor_sync(0xffffffffu, mc[half], 2));
        alpha[half] = expf(m[half] - mc[half]);  // 0 on the first chunk
        m[half] = mc[half];
        l[half] *= alpha[half];
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = expf(s[nt][e] - m[e >> 1]);  // 0 past n
          l[e >> 1] += s[nt][e];
        }

      // o = o alpha + p V over the chunk, each 8 keys in a zeroed fragment
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] *= alpha[e >> 1];
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        uint32_t ah[4], al[4];  // slots t % 4 and t % 4 + 4: keys 2 (t % 4) and 2 (t % 4) + 1
        tf32_split(s[kt][0], ah[0], al[0]);
        tf32_split(s[kt][2], ah[1], al[1]);
        tf32_split(s[kt][1], ah[2], al[2]);
        tf32_split(s[kt][3], ah[3], al[3]);
        const int off = (kt * 8 + (lane & 3) * 2) * P + (lane >> 2);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float t[4] = {};
          const uint32_t* vh = v_hi + off + nt * 8;
          const uint32_t* vl = v_lo + off + nt * 8;
          mma1688_split(t, ah, al, vh[0], vh[P], vl[0], vl[P]);
#pragma unroll
          for (int e = 0; e < 4; ++e) o[nt][e] += t[e];
        }
      }
    }

    // the row's sum over its 4 lanes (every lane ends with the same bits), then mh = o / l
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
      l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + (e >> 1) * 8, col = nt * 8 + (lane & 3) * 2 + (e & 1);
        if (i < n && col < d) mh[(item + i) * hd + h * d + col] = o[nt][e] / l[e >> 1];
      }
  }
}

template <bool kLn, bool kAct = false, int A = kActGelu>
cudaError_t linear_tf32(const float* a, const float2* stats, const float* ln_scale,
                        const float* ln_bias, const float* w, const float* bias,
                        const float* resid, float* y, int rows, int K, int N, bool vec,
                        cudaStream_t stream, int act = kActGelu) {
  const size_t bytes = LinearTf32Smem::kBytes;
  auto kernel = linear_tf32_kernel<kLn, kAct, A>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((rows + kLtRows - 1) / kLtRows, (N + kLtCols - 1) / kLtCols);
  kernel<<<grid, kThreads, bytes, stream>>>(a, stats, ln_scale, ln_bias, w, bias, resid, y, rows,
                                            K, N, vec, act);
  return cudaGetLastError();
}

template <int DP>
cudaError_t attn_tf32(const float* qkv, float* mh, float* hmean, int bs, int n, int heads, int d,
                      float scale, bool vec, cudaStream_t stream) {
  const size_t bytes = AttnTf32Smem<DP>::kBytes;
  cudaError_t err = allow_smem(attn_tf32_kernel<DP>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + kAtRows - 1) / kAtRows, hmean ? 1 : heads, bs);
  attn_tf32_kernel<DP><<<grid, kAtThreads, bytes, stream>>>(qkv, mh, hmean, n, heads, d, scale,
                                                            vec);
  return cudaGetLastError();
}

// head_dim 1-128, any n and width; qkv, mh and stats fp32 scratch
cudaError_t attn_block_tf32(const float* x, const float* g, const float* be, const float* wqkv,
                            const float* bqkv, const float* wo, const float* bo, float* qkv,
                            float* mh, float2* stats, float* out, float* hmean, int bs, int n,
                            int dim, int heads, int d, float eps, float scale,
                            cudaStream_t stream) {
  const int rows = bs * n, hd = heads * d;
  if (d < 1 || d > 128 || mh == nullptr || stats == nullptr) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  constexpr int kWarps = kThreads / 32;
  ln_stats_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(x, stats, rows, dim, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = linear_tf32<true>(x, stats, g, be, wqkv, bqkv, nullptr, qkv, rows, dim, 3 * hd,
                          dim % 4 == 0 && aligned(x) && aligned(wqkv), stream);
  if (err != cudaSuccess) return err;
  const bool vec = d % 4 == 0 && aligned(qkv);
  err = d <= 32   ? attn_tf32<32>(qkv, mh, hmean, bs, n, heads, d, scale, vec, stream)
        : d <= 64 ? attn_tf32<64>(qkv, mh, hmean, bs, n, heads, d, scale, vec, stream)
                  : attn_tf32<128>(qkv, mh, hmean, bs, n, heads, d, scale, vec, stream);
  if (err != cudaSuccess) return err;
  return linear_tf32<false>(mh, nullptr, nullptr, nullptr, wo, bo, x, out, rows, hd, dim,
                            hd % 4 == 0 && aligned(mh) && aligned(wo), stream);
}

// ---------------------------------------------------------------------------
// FFN half, bf16 (ffn_block_route's "tensor_core"): ffn_tc_kernel, mma.sync
// m16n8k16 through ffn.cuh's chunk loop (the fused_mlp forward's), one
// block of 8 warps per RT rows. The prologue is LN2 of the block's rows,
// computed in fp32 and rounded to bf16 into the A tile (layernorm_rows_bf16)
// while the first W1/W2 chunk is in flight by cp.async; the hidden element
// is ffn_hidden at p = 0 (no hash, no mask) with the launch's activation;
// the epilogue is
//   out = x + round(round(acc) + b2), x re-read from device memory.
// RT = 64 up to width 256 (two blocks an SM up to 192), 32 at 384 (48
// output registers a thread, one block an SM). f a multiple of 8: the
// weights' hidden columns are copied in 16-byte chunks.
// ---------------------------------------------------------------------------
template <int DIM>
constexpr int kFfnTcRows = DIM <= 256 ? 64 : 32;

template <int DIM, int A>
__global__ void __launch_bounds__(kThreads, DIM <= 192 ? 2 : 1)
    ffn_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_scale,
                  const float* __restrict__ ln_bias, float eps, const bf16* __restrict__ w1,
                  const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                  const bf16* __restrict__ b2, bf16* __restrict__ out, int rows, int f, int act) {
  constexpr int RT = kFfnTcRows<DIM>;
  using S = FfnTcSmem<DIM, RT>;
  using L = FfnTcLayout<DIM, RT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* as = reinterpret_cast<bf16*>(smem_raw);  // LN2(x) [RT][DIM + 8]
  bf16* stages = as + S::kA;                     // 2 x (W1 chunk, W2 chunk)
  bf16* acts = stages + 2 * S::kStage;           // the chunk's activation [RT][40]
  const int lane = threadIdx.x & 31;
  const long row0 = (long)blockIdx.x * RT;
  ffn_tc_stage_chunk<DIM, RT>(stages, w1, w2, f, 0);
  cp_async_commit();
  layernorm_rows_bf16<RT>(x, row0, (int)min((long)RT, rows - row0), DIM, ln_scale, ln_bias, eps,
                          as, S::kPitch);  // while chunk 0 is in flight

  float oacc[L::kOutTiles][4] = {};
  ffn_tc_chunks<DIM, RT, A>(as, stages, acts, w1, b1, w2, row0, f, act, 0.f, 1.f, 0u, oacc);
#pragma unroll
  for (int nt = 0; nt < L::kOutTiles; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int2 rc = ffn_tc_out_coord<DIM, RT>(nt, half, lane);
      const long row = row0 + rc.x;
      if (row >= rows) continue;
      const float2 xv = unpack_bf16(*reinterpret_cast<const uint32_t*>(x + row * DIM + rc.y));
      const float y0 = Num<bf16>::round(Num<bf16>::round(oacc[nt][half * 2]) +
                                        Num<bf16>::load(b2, rc.y));
      const float y1 = Num<bf16>::round(Num<bf16>::round(oacc[nt][half * 2 + 1]) +
                                        Num<bf16>::load(b2, rc.y + 1));
      *reinterpret_cast<uint32_t*>(out + row * DIM + rc.y) = pack_bf16(xv.x + y0, xv.y + y1);
    }
}

// ---------------------------------------------------------------------------
// FFN half, fp32 (ffn_block_route's "split_tf32"): ffn_tf32_kernel,
// mma.sync m16n8k8 .tf32 by the 3xTF32 split (common.cuh), the output layout
// of ffn_tc_kernel: 8 warps over RT rows, the hidden width in chunks of CH
// (kFfnTf32Rows, kFfnTf32Chunk below). LN2(x), each W1 and W2 chunk and the
// chunk's activation are split into hi and lo planes once per element, as
// they are stored into shared memory. The planes take twice bf16's room, so
// the weights are double-buffered in registers, not in shared memory: chunk
// c + 1's 16-byte (W1) and 4-byte (W2, any f) loads are in flight while chunk
// c is multiplied, then split into the one stage (where that would hold more
// than 48 registers a thread, as at width 256, W2's are issued as the stage
// is written: ahead, they spill).
// Sums: the tensor cores add into an fp32 fragment with truncation, so a
// fragment chained over all of k (288 mma at width 192) drifts to ~10x the
// error of fp32 FMA sums; every 32 of k is summed in a zeroed fragment and added
// to the running sum in fp32, which also makes the mma chains short and
// independent.
// Shared memory: at width 192, 64 rows of LN2(x) planes (100 KB), a W1 and a
// W2 chunk (49 + 54 KB) and the activation (18 KB); at 384, 32 rows (99 KB)
// and chunks of 16 (50 + 61 KB, activation 5 KB): chunks of 32 would take
// 318 KB. With a chunk of 16 fc1 has 4 tiles of 16 x 8 for 8 warps, so two
// warps split each tile's k and one adds the other's half through shared
// memory (2.5 KB) before the activation. One block an SM.
//   out = x + ((act(LN2(x) W1^T + b1) W2^T) + b2), all in fp32
// ---------------------------------------------------------------------------
template <int DIM>
constexpr int kFfnTf32Rows = DIM <= 192 ? 64 : 32;
template <int DIM>
constexpr int kFfnTf32Chunk = DIM <= 256 ? 32 : 16;

template <int DIM>
struct FfnTf32Smem {
  static constexpr int kRows = kFfnTf32Rows<DIM>, kChunk = kFfnTf32Chunk<DIM>;
  static constexpr int kPitch = DIM + 4;          // words; rows 16 bytes past 128-byte lines
  static constexpr int kActPitch = kChunk + 4;
  static constexpr int kA = kRows * kPitch;       // one plane of LN2(x)
  static constexpr int kW1 = kChunk * kPitch;     // one plane of a W1 chunk [CH][DIM]
  static constexpr int kW2 = DIM * kActPitch;     // one plane of a W2 chunk [DIM][CH]
  static constexpr int kAct = kRows * kActPitch;  // one plane of the chunk's activation
  // the fc1 layout: n8 tiles a warp (2 or 1) and warps over one tile's k
  static constexpr int kWC = FfnTcLayout<DIM, kRows>::kWC, kTiles = kChunk / 8;
  static constexpr int kKSplit = kWC > kTiles ? kWC / kTiles : 1;
  static constexpr int kFc1Tiles = kTiles * kKSplit / kWC;
  static constexpr int kPart = kKSplit > 1 ? kAct : 0;  // fc1's other half of k, fp32
  static constexpr size_t kBytes = sizeof(uint32_t) * (2 * (kA + kW1 + kW2 + kAct) + kPart);
  static_assert(kKSplit <= 2 && (kFc1Tiles == 1 || kFc1Tiles == 2), "fc1 layout");
  static_assert(kFc1Tiles == 2 ? kKSplit == 1 : DIM / kKSplit % 32 == 0, "fc1 steps k by 32");
  static_assert(kChunk * DIM / 4 % kThreads == 0, "W1 chunk in whole 16-byte loads a thread");
};

template <int DIM, int A>
__global__ void __launch_bounds__(kThreads, 1)
    ffn_tf32_kernel(const float* __restrict__ x, const float* __restrict__ ln_scale,
                    const float* __restrict__ ln_bias, float eps, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, float* __restrict__ out, int rows, int f,
                    int act) {
  using S = FfnTf32Smem<DIM>;
  constexpr int RT = S::kRows, CH = S::kChunk, P = S::kPitch, AP = S::kActPitch;
  using L = FfnTcLayout<DIM, RT>;
  constexpr int NT1 = S::kFc1Tiles, KS = S::kKSplit;
  constexpr int kW1Vecs = CH * DIM / 4 / kThreads;  // 16-byte loads a thread
  constexpr int kW2Vals = DIM * CH / kThreads;      // 4-byte loads a thread
  // W2's values loaded a chunk ahead too where the weights in flight stay
  // within 48 registers; past that (width 256) the registers pass 255 and
  // ptxas spills, so they are loaded as stored
  constexpr bool kW2Ahead = 4 * kW1Vecs + kW2Vals <= 48;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* a_hi = reinterpret_cast<uint32_t*>(smem_raw);  // the planes, hi then lo
  uint32_t* a_lo = a_hi + S::kA;
  uint32_t* w1_hi = a_lo + S::kA;
  uint32_t* w1_lo = w1_hi + S::kW1;
  uint32_t* w2_hi = w1_lo + S::kW1;
  uint32_t* w2_lo = w2_hi + S::kW2;
  uint32_t* act_hi = w2_lo + S::kW2;
  uint32_t* act_lo = act_hi + S::kAct;
  float* part = reinterpret_cast<float*>(act_lo + S::kAct);  // [RT][AP] with a k split
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp / L::kWC, wc = warp % L::kWC;
  // fc1: this warp's n8 tiles g NT1.. of the chunk over the kq-th 1/KS of k
  const int g = wc % (L::kWC / KS), kq = wc / (L::kWC / KS);
  const long row0 = (long)blockIdx.x * RT;
  const int chunks = (f + CH - 1) / CH;

  uint4 w1v[kW1Vecs];
  float w2v[kW2Ahead ? kW2Vals : 1];
  auto w2_value = [&](int c, int j) {  // value j of this thread in chunk c's W2, 0 past f
    const int idx = threadIdx.x + j * kThreads, n = idx / CH, k = idx % CH;
    const int col = c * CH + k;
    return col < f ? __ldg(w2 + (long)n * f + col) : 0.f;
  };
  auto load = [&](int c) {  // chunk c's weights into registers, zero past f
    const int f0 = c * CH;
#pragma unroll
    for (int j = 0; j < kW1Vecs; ++j) {
      const int idx = threadIdx.x + j * kThreads, r = idx / (DIM / 4), q = idx % (DIM / 4);
      w1v[j] = f0 + r < f
                   ? __ldg(reinterpret_cast<const uint4*>(w1 + (long)(f0 + r) * DIM) + q)
                   : make_uint4(0, 0, 0, 0);
    }
    if constexpr (kW2Ahead) {
#pragma unroll
      for (int j = 0; j < kW2Vals; ++j) w2v[j] = w2_value(c, j);
    }
  };
  auto store = [&](int c) {  // chunk c, loaded, split into the stage
#pragma unroll
    for (int j = 0; j < kW1Vecs; ++j) {
      const int idx = threadIdx.x + j * kThreads, r = idx / (DIM / 4), q = idx % (DIM / 4);
      uint4 hi, lo;
      tf32_split4(*reinterpret_cast<const float4*>(&w1v[j]), hi, lo);
      *reinterpret_cast<uint4*>(w1_hi + r * P + 4 * q) = hi;
      *reinterpret_cast<uint4*>(w1_lo + r * P + 4 * q) = lo;
    }
    auto w2_put = [&](int j, float v) {
      const int idx = threadIdx.x + j * kThreads, n = idx / CH, k = idx % CH;
      tf32_split(v, w2_hi[n * AP + k], w2_lo[n * AP + k]);
    };
    if constexpr (kW2Ahead) {
#pragma unroll
      for (int j = 0; j < kW2Vals; ++j) w2_put(j, w2v[j]);
    } else {  // 16 loads in flight at a time: all 32 at once spill
#pragma unroll 16
      for (int j = 0; j < kW2Vals; ++j) w2_put(j, w2_value(c, j));
    }
  };
  load(0);
  layernorm_rows_tf32<RT>(x, row0, (int)min((long)RT, rows - row0), DIM, ln_scale, ln_bias, eps,
                          a_hi, a_lo, P);  // while chunk 0's loads are in flight
  store(0);
  __syncthreads();

  float oacc[L::kOutTiles][4] = {};
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) load(c + 1);  // in flight while the tensor cores work
    const int f0 = c * CH;

    // h = LN2(x) W1^T for rows 16 wr.., chunk columns 8 NT1 g..: each 32 of
    // k summed in a zeroed fragment (12 chained mma), then added in fp32
    // (round to nearest): the tensor cores' accumulation truncates, and one
    // fragment chained over all of k drifts by ~10x fp32's error
    float hacc[NT1][4] = {};
#pragma unroll 2
    for (int kg = 0; kg < DIM / KS / 32; ++kg) {
      float t[NT1][4] = {};
      if constexpr (NT1 == 2) {
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int k0 = (kg * 4 + s) * 16;  // in bf16 units: 8 of k
          uint32_t ah[4], al[4], bh[4], bl[4];
          ldsm_a(ah, tf32_as_bf16(a_hi), 2 * P, wr * 16, k0, lane);
          ldsm_a(al, tf32_as_bf16(a_lo), 2 * P, wr * 16, k0, lane);
          ldsm_b_nk(bh, tf32_as_bf16(w1_hi), 2 * P, g * 16, k0, lane);
          ldsm_b_nk(bl, tf32_as_bf16(w1_lo), 2 * P, g * 16, k0, lane);
          mma1688_split(t[0], ah, al, bh[0], bh[1], bl[0], bl[1]);
          mma1688_split(t[1], ah, al, bh[2], bh[3], bl[2], bl[3]);
        }
      } else {
#pragma unroll
        for (int kp = 0; kp < 2; ++kp) {
          const int k0 = 2 * kq * (DIM / KS) + (kg * 2 + kp) * 32;  // in bf16 units: 16 of k
          uint32_t bh[4], bl[4];
          ldsm_b_nk_k32(bh, tf32_as_bf16(w1_hi), 2 * P, g * 8, k0, lane);
          ldsm_b_nk_k32(bl, tf32_as_bf16(w1_lo), 2 * P, g * 8, k0, lane);
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            uint32_t ah[4], al[4];
            ldsm_a(ah, tf32_as_bf16(a_hi), 2 * P, wr * 16, k0 + s * 16, lane);
            ldsm_a(al, tf32_as_bf16(a_lo), 2 * P, wr * 16, k0 + s * 16, lane);
            mma1688_split(t[0], ah, al, bh[2 * s], bh[2 * s + 1], bl[2 * s], bl[2 * s + 1]);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT1; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[nt][e] += t[nt][e];
    }
    auto frag_coord = [&](int nt, int half) {  // (row, chunk column) of fc1 fragment values
      return make_int2(wr * 16 + (lane >> 2) + half * 8, g * (NT1 * 8) + nt * 8 + (lane & 3) * 2);
    };
    if constexpr (KS > 1) {  // the second half of k's sums to the first: fixed order
      if (kq == 1) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int2 rc = frag_coord(0, half);
          *reinterpret_cast<float2*>(part + rc.x * AP + rc.y) =
              make_float2(hacc[0][half * 2], hacc[0][half * 2 + 1]);
        }
      }
      __syncthreads();
    }
    // a = act(h + b1) in fp32, split into the activation planes
    if (kq == 0) {
#pragma unroll
      for (int nt = 0; nt < NT1; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int2 rc = frag_coord(nt, half);
          const int r = rc.x, cc = rc.y;
          float h0 = hacc[nt][half * 2], h1 = hacc[nt][half * 2 + 1];
          if constexpr (KS > 1) {
            const float2 o = *reinterpret_cast<const float2*>(part + r * AP + cc);
            h0 += o.x;
            h1 += o.y;
          }
          uint2 hi, lo;
          tf32_split(f0 + cc < f ? ffn_act<A>(act, h0 + b1[f0 + cc]) : 0.f, hi.x, lo.x);
          tf32_split(f0 + cc + 1 < f ? ffn_act<A>(act, h1 + b1[f0 + cc + 1]) : 0.f, hi.y, lo.y);
          *reinterpret_cast<uint2*>(act_hi + r * AP + cc) = hi;
          *reinterpret_cast<uint2*>(act_lo + r * AP + cc) = lo;
        }
    }
    __syncthreads();

    // out += a W2^T over the chunk (CH of k): rows 16 wr.., columns wc
    // DIM / WC..; each output tile's chunk summed in a zeroed fragment, then
    // added in fp32, as fc1's
    uint32_t ah[CH / 8][4], al[CH / 8][4];
#pragma unroll
    for (int ks = 0; ks < CH / 8; ++ks) {
      ldsm_a(ah[ks], tf32_as_bf16(act_hi), 2 * AP, wr * 16, ks * 16, lane);
      ldsm_a(al[ks], tf32_as_bf16(act_lo), 2 * AP, wr * 16, ks * 16, lane);
    }
    auto fc2_tiles = [&](int nb) {  // output tiles 2 nb and 2 nb + 1
      float t[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < CH / 8; ++ks) {
        uint32_t bh[4], bl[4];
        ldsm_b_nk(bh, tf32_as_bf16(w2_hi), 2 * AP, wc * L::kOutCols + nb * 16, ks * 16, lane);
        ldsm_b_nk(bl, tf32_as_bf16(w2_lo), 2 * AP, wc * L::kOutCols + nb * 16, ks * 16, lane);
        mma1688_split(t[0], ah[ks], al[ks], bh[0], bh[1], bl[0], bl[1]);
        mma1688_split(t[1], ah[ks], al[ks], bh[2], bh[3], bl[2], bl[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        oacc[2 * nb][e] += t[0][e];
        oacc[2 * nb + 1][e] += t[1][e];
      }
    };
    // 64 registers of weights in flight (width 256): no unroll, so oacc,
    // indexed at run time, sits in local memory (a 128-byte stack frame)
    if constexpr (!kW2Ahead) {
#pragma unroll 1
      for (int nb = 0; nb < L::kOutTiles / 2; ++nb) fc2_tiles(nb);
    } else {
#pragma unroll
      for (int nb = 0; nb < L::kOutTiles / 2; ++nb) fc2_tiles(nb);
    }
    if (c + 1 < chunks) {
      __syncthreads();  // every warp is done with chunk c's weights and activation
      store(c + 1);
      __syncthreads();
    }
  }
#pragma unroll
  for (int nt = 0; nt < L::kOutTiles; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int2 rc = ffn_tc_out_coord<DIM, RT>(nt, half, lane);
      const long row = row0 + rc.x;
      if (row >= rows) continue;
      const float2 xv = *reinterpret_cast<const float2*>(x + row * DIM + rc.y);
      *reinterpret_cast<float2*>(out + row * DIM + rc.y) =
          make_float2(xv.x + (oacc[nt][half * 2] + b2[rc.y]),
                      xv.y + (oacc[nt][half * 2 + 1] + b2[rc.y + 1]));
    }
}

// ---------------------------------------------------------------------------
// bf16 route of attn_block: tensor cores (mma.sync m16n8k16; the fragment
// helpers are in common.cuh), three launches:
//   (a) linear_tc_kernel<true>: qkv = round(LN1(x) Wqkv^T) + bqkv, the LN
//       computed in fp32 and rounded to bf16 into the A tile;
//   (b) the attention of fused_mhsa at p = 0 (attention.cu, the same
//       function: encoder_block.py:60-72 is attention.py:64-86 at p = 0), or
//       its head-mean variant, into mh [rows, H d] (bf16, as the TPU rounds
//       it before the out projection);
//   (c) linear_tc_kernel<false>: out = x + round(round(mh Wo^T) + bo).
// One block of 8 warps per 64 rows x 64 output columns; the A rows and the
// W rows of the block are staged whole (K <= 768) in padded bf16 tiles, each
// warp owns 16 rows x 32 columns.
// ---------------------------------------------------------------------------
constexpr int kLinRows = 64, kLinCols = 64, kLinMaxK = 768;

inline size_t linear_tc_smem(int K) { return sizeof(bf16) * 2 * (size_t)kLinRows * (K + 8); }

template <bool kLn>
__global__ void __launch_bounds__(kThreads)
    linear_tc_kernel(const bf16* __restrict__ a, const float* __restrict__ ln_scale,
                     const float* __restrict__ ln_bias, float eps, const bf16* __restrict__ w,
                     const bf16* __restrict__ bias, const bf16* __restrict__ resid,
                     bf16* __restrict__ y, int rows, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = K + 8;
  bf16* as = reinterpret_cast<bf16*>(smem_raw);  // [64][P]
  bf16* ws = as + kLinRows * P;                  // [64][P]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp >> 1, wc = warp & 1;
  const long row0 = (long)blockIdx.x * kLinRows;
  const int n0 = blockIdx.y * kLinCols;
  stage_tile<kThreads>(ws, P, w, K, N, K, n0, 0, kLinCols, K);
  if (!kLn) stage_tile<kThreads>(as, P, a, K, rows, K, row0, 0, kLinRows, K);
  cp_async_commit();
  if (kLn)  // while W is in flight
    layernorm_rows_bf16<kLinRows>(a, row0, min((long)kLinRows, rows - row0), K, ln_scale, ln_bias,
                                  eps, as, P);
  cp_async_wait<0>();
  __syncthreads();

  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[4];
    ldsm_a(af, as, P, wr * 16, k0, lane);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t b[4];
      ldsm_b_nk(b, ws, P, wc * 32 + np * 16, k0, lane);
      mma16816(acc[2 * np], af, b[0], b[1]);
      mma16816(acc[2 * np + 1], af, b[2], b[3]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long row = row0 + wr * 16 + (lane >> 2) + half * 8;
      const int col = n0 + wc * 32 + nt * 8 + (lane & 3) * 2;
      if (row >= rows || col >= N) continue;  // N even: the pair is in whole
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        v[e] = Num<bf16>::round(acc[nt][half * 2 + e]) + __bfloat162float(bias[col + e]);
        if (!kLn)
          v[e] = __bfloat162float(resid[row * N + col + e]) + Num<bf16>::round(v[e]);
      }
      *reinterpret_cast<uint32_t*>(y + row * N + col) = pack_bf16(v[0], v[1]);
    }
}

template <bool kLn>
cudaError_t linear_tc(const void* a, const void* ln_scale, const void* ln_bias, float eps,
                      const void* w, const void* bias, const void* resid, void* y, int rows, int K,
                      int N, cudaStream_t stream) {
  const size_t bytes = linear_tc_smem(K);
  auto kernel = linear_tc_kernel<kLn>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((rows + kLinRows - 1) / kLinRows, (N + kLinCols - 1) / kLinCols);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(a), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), eps, static_cast<const bf16*>(w),
      static_cast<const bf16*>(bias), static_cast<const bf16*>(resid), static_cast<bf16*>(y),
      rows, K, N);
  return cudaGetLastError();
}

// dim and H d multiples of 16 up to kLinMaxK; d and n as mhsa_tc_forward takes
cudaError_t attn_block_tc(const void* x, const void* g, const void* be, const void* wqkv,
                          const void* bqkv, const void* wo, const void* bo, void* qkv, void* mh,
                          void* out, void* hmean, int bs, int n, int dim, int heads, int d,
                          float eps, float scale, cudaStream_t stream) {
  const int rows = bs * n, hd = heads * d;
  if (dim % 16 || hd % 16 || dim > kLinMaxK || hd > kLinMaxK || mh == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t err = linear_tc<true>(x, g, be, eps, wqkv, bqkv, nullptr, qkv, rows, dim, 3 * hd,
                                    stream);
  if (err != cudaSuccess) return err;
  err = mhsa_tc_forward(qkv, mh, hmean, bs, n, heads, d, scale, stream);
  if (err != cudaSuccess) return err;
  return linear_tc<false>(mh, nullptr, nullptr, 0.f, wo, bo, x, out, rows, hd, dim, stream);
}

// one launch of an FFN kernel over `rows` rows, RT a block; T the storage type
template <typename T, int RT, typename Kernel>
cudaError_t ffn_launch(Kernel kernel, size_t bytes, const void* x, const void* g, const void* be,
                       const void* w1, const void* b1, const void* w2, const void* b2, void* out,
                       int rows, int f, int act, float eps, cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(rows + RT - 1) / RT, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(g), static_cast<const float*>(be), eps,
      static_cast<const T*>(w1), static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(out), rows, f, act);
  return cudaGetLastError();
}

template <int DIM, int A>
cudaError_t ffn_tc_launch(const void* x, const void* g, const void* be, const void* w1,
                          const void* b1, const void* w2, const void* b2, void* out, int rows,
                          int f, int act, float eps, cudaStream_t s) {
  constexpr int RT = kFfnTcRows<DIM>;
  return ffn_launch<bf16, RT>(ffn_tc_kernel<DIM, A>, FfnTcSmem<DIM, RT>::kBytes, x, g, be, w1, b1,
                              w2, b2, out, rows, f, act, eps, s);
}

template <int DIM, int A>
cudaError_t ffn_tf32_launch(const void* x, const void* g, const void* be, const void* w1,
                            const void* b1, const void* w2, const void* b2, void* out, int rows,
                            int f, int act, float eps, cudaStream_t s) {
  return ffn_launch<float, kFfnTf32Rows<DIM>>(ffn_tf32_kernel<DIM, A>, FfnTf32Smem<DIM>::kBytes, x,
                                                 g, be, w1, b1, w2, b2, out, rows, f, act, eps, s);
}

// ---------------------------------------------------------------------------
// FFN half past width 384 (DeiT-Base's 768): the one-launch kernels hold a
// row tile of LN2(x) and the warps' output fragments whole, which at 768
// passes the shared memory and registers a block has. So the half runs as
// separate launches, LN2(x) and the hidden state through device memory
// between them (in T, where the one-launch kernels round them to T anyway).
//
// bf16, three launches (ffn_wide_tc):
//   (a) ln_rows_bf16_kernel: a = round(LN2(x)) into a bf16 scratch [rows,
//       dim], a warp a row in 16-byte pieces;
//   (b) fc1, gemm.cuh's gemm_tc (TMA-fed wgmma) over k = dim with EpiAct:
//       hidden = round(act(round(round(acc) + b1)));
//   (c) fc2, the same GEMM over k = f with EpiResidual:
//       out = x + round(round(acc) + b2).
// What bounds it at [64, 197, 768], f 3072: the products, 119 GFLOP (0.12
// ms of bf16 tensor-core time), against ~0.03 ms of bytes for a, hidden and
// the weights. The first design (LN2 in the prologue of each of fc1's
// 64 x 64 blocks, K = 768 staged whole, mma.sync) held one block an SM,
// waited for all of its copies before its first product and recomputed a
// row tile's LN2 for each of its 48 column tiles: 1.8 ms. Here LN2 runs once
// a row (~0.02 ms of bytes), and both products stream k through the GEMM's
// ring of TMA stages; fc1's activation epilogue (tens of instructions an element)
// takes gemm_tile's epilogue-heavy tile, 192 x 128 over three consumer
// warpgroups.
// fp32: ln_stats_kernel, linear_tf32_kernel<true, true> (hidden =
// act(acc + b1)) and linear_tf32_kernel<false> (out = x + (acc + b2)),
// split TF32 as attn_block's fp32 route.
// ---------------------------------------------------------------------------

// (a) LN2 of each row of x [rows, dim] rounded to bf16 into a [rows, dim]:
// lane l holds the 16-byte pieces at columns 8 (l + 32 i), i < kLnPieces,
// in registers from the statistics to the stores. Each lane sums its values
// (s, and s2 of v v, exact for a bf16 v) in column order, then the xor tree
// 16, 8, 4, 2, 1; mean = s / dim, var = max(s2 / dim - mean mean, 0), rstd
// = 1 / sqrt(var + eps), a = round(((v - mean) rstd) scale + bias). Every
// operation rounds on its own (the _rn intrinsics, which nvcc never fuses
// into an FMA), so encoder_block.py's ln_rows_reference gives the same bits
// on any IEEE device. dim a multiple of 8 up to 256 kLnPieces; x and a
// 16-byte aligned.
constexpr int kLnPieces = 4;  // rows up to 1024 wide

__global__ void __launch_bounds__(kThreads)
    ln_rows_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                        const float* __restrict__ bias, float eps, bf16* __restrict__ a, long rows,
                        int dim) {
  using P = Pack<bf16, 8>;
  const long row = (long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const bf16* xr = x + row * dim;
  P::Raw raw[kLnPieces];
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kLnPieces; ++i) {
    const int c = 8 * (lane + 32 * i);
    raw[i] = c < dim ? P::load(xr + c) : P::zero();
    if (c >= dim) continue;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float v = P::get(raw[i], k);
      s = __fadd_rn(s, v);
      s2 = __fadd_rn(s2, __fmul_rn(v, v));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    s2 = __fadd_rn(s2, __shfl_xor_sync(0xffffffffu, s2, o));
  }
  const float n = (float)dim;
  const float mean = __fdiv_rn(s, n);
  const float var = fmaxf(__fsub_rn(__fdiv_rn(s2, n), __fmul_rn(mean, mean)), 0.f);
  const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
#pragma unroll
  for (int i = 0; i < kLnPieces; ++i) {
    const int c = 8 * (lane + 32 * i);
    if (c >= dim) continue;
    const float4 s0 = __ldg(reinterpret_cast<const float4*>(scale + c));
    const float4 s1 = __ldg(reinterpret_cast<const float4*>(scale + c + 4));
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(bias + c));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(bias + c + 4));
    const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const float bi[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    float y[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      y[k] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(P::get(raw[i], k), mean), rstd), sc[k]),
                       bi[k]);
    P::store(a + row * dim + c, y);
  }
}

// scale and bias: fp32 [dim], 16-byte aligned
cudaError_t ln_rows_bf16(const void* x, const void* scale, const void* bias, void* a, long rows,
                         int dim, float eps, cudaStream_t s) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (dim % 8 || dim > 256 * kLnPieces || !aligned(x) || !aligned(a) || !aligned(scale) ||
      !aligned(bias))
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  constexpr int kWarps = kThreads / 32;
  ln_rows_bf16_kernel<<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), eps, static_cast<bf16*>(a), rows, dim);
  return cudaGetLastError();
}

// (b) hidden = round(act(round(round(acc) + b1))), bf16, as the one-launch
// kernels' hidden chunk (gemm.cuh's cols / put)
template <int A>
struct EpiAct {
  using Col = float2;
  static constexpr bool kHeavy = true;  // the activation: gelu is tens of instructions
  const bf16* b1;
  bf16* hidden;
  int f, act;
  __device__ __forceinline__ Col cols(int col, bool in) const {
    return in ? unpack_bf16(*reinterpret_cast<const uint32_t*>(b1 + col)) : make_float2(0.f, 0.f);
  }
  __device__ __forceinline__ void put(long row, int col, float c0, float c1, Col b,
                                      bool in) const {
    const float h0 = Num<bf16>::round(Num<bf16>::round(c0) + b.x);
    const float h1 = Num<bf16>::round(Num<bf16>::round(c1) + b.y);
    const uint32_t v = pack_bf16(ffn_act<A>(act, h0), ffn_act<A>(act, h1));
    if (in) *reinterpret_cast<uint32_t*>(hidden + row * f + col) = v;
  }
};

// (c) out = x + round(round(acc) + b2), bf16
struct EpiResidual {
  using Col = float2;
  static constexpr bool kHeavy = false;
  const bf16* b2;
  const bf16* x;
  bf16* out;
  int n;
  __device__ __forceinline__ Col cols(int col, bool in) const {
    return in ? unpack_bf16(*reinterpret_cast<const uint32_t*>(b2 + col)) : make_float2(0.f, 0.f);
  }
  __device__ __forceinline__ void put(long row, int col, float c0, float c1, Col b,
                                      bool in) const {
    if (!in) return;
    const long i = row * n + col;
    const float2 xv = unpack_bf16(*reinterpret_cast<const uint32_t*>(x + i));
    const float y0 = Num<bf16>::round(Num<bf16>::round(c0) + b.x);
    const float y1 = Num<bf16>::round(Num<bf16>::round(c1) + b.y);
    *reinterpret_cast<uint32_t*>(out + i) = pack_bf16(xv.x + y0, xv.y + y1);
  }
};

// ln: bf16 scratch [rows, dim]; hidden: bf16 scratch [rows, f]; dim a
// multiple of 16 up to 1024, f of 8
template <int A>
cudaError_t ffn_wide_tc(const void* x, const void* g, const void* be, const void* w1,
                        const void* b1, const void* w2, const void* b2, void* out, void* ln,
                        void* hidden, int rows, int dim, int f, int act, float eps,
                        cudaStream_t s) {
  if (dim % 16 || f % 8 || ln == nullptr || hidden == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = ln_rows_bf16(x, g, be, ln, rows, dim, eps, s);
  if (err != cudaSuccess) return err;
  const EpiAct<A> fc1{static_cast<const bf16*>(b1), static_cast<bf16*>(hidden), f, act};
  err = gemm_tc<false>(static_cast<const bf16*>(ln), static_cast<const bf16*>(w1), rows, f, dim,
                       fc1, s);
  if (err != cudaSuccess) return err;
  const EpiResidual fc2{static_cast<const bf16*>(b2), static_cast<const bf16*>(x),
                        static_cast<bf16*>(out), dim};
  return gemm_tc<false>(static_cast<const bf16*>(hidden), static_cast<const bf16*>(w2), rows, dim,
                        f, fc2, s);
}

// hidden: fp32 scratch [rows, f]; stats fp32 [rows, 2]
template <int A>
cudaError_t ffn_wide_tf32(const float* x, const float* g, const float* be, const float* w1,
                          const float* b1, const float* w2, const float* b2, float* out,
                          float* hidden, float2* stats, int rows, int dim, int f, int act,
                          float eps, cudaStream_t s) {
  if (hidden == nullptr || stats == nullptr) return cudaErrorInvalidValue;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  constexpr int kWarps = kThreads / 32;
  ln_stats_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, s>>>(x, stats, rows, dim, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = linear_tf32<true, true, A>(x, stats, g, be, w1, b1, nullptr, hidden, rows, dim, f,
                                dim % 4 == 0 && aligned(x) && aligned(w1), s, act);
  if (err != cudaSuccess) return err;
  return linear_tf32<false>(hidden, nullptr, nullptr, nullptr, w2, b2, x, out, rows, f, dim,
                            f % 4 == 0 && aligned(hidden) && aligned(w2), s);
}

// bf16 by the tensor cores, f a multiple of 8
template <int A>
cudaError_t ffn_block_tc(const void* x, const void* g, const void* be, const void* w1,
                         const void* b1, const void* w2, const void* b2, void* out, int rows,
                         int dim, int f, int act, float eps, cudaStream_t s) {
  if (f % 8) return cudaErrorInvalidValue;
  switch (dim) {
    case 64: return ffn_tc_launch<64, A>(x, g, be, w1, b1, w2, b2, out, rows, f, act, eps, s);
    case 128: return ffn_tc_launch<128, A>(x, g, be, w1, b1, w2, b2, out, rows, f, act, eps, s);
    case 192: return ffn_tc_launch<192, A>(x, g, be, w1, b1, w2, b2, out, rows, f, act, eps, s);
    case 256: return ffn_tc_launch<256, A>(x, g, be, w1, b1, w2, b2, out, rows, f, act, eps, s);
    case 384: return ffn_tc_launch<384, A>(x, g, be, w1, b1, w2, b2, out, rows, f, act, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

// fp32 by the split TF32
template <int A>
cudaError_t ffn_block_fp32(const void* x, const void* g, const void* be, const void* w1,
                           const void* b1, const void* w2, const void* b2, void* out, int rows,
                           int dim, int f, int act, float eps, cudaStream_t s) {
  switch (dim) {
    case 64:
      return ffn_tf32_launch<64, A>(x, g, be, w1, b1, w2, b2, out, rows, f, act, eps, s);
    case 128:
      return ffn_tf32_launch<128, A>(x, g, be, w1, b1, w2, b2, out, rows, f, act, eps, s);
    case 192:
      return ffn_tf32_launch<192, A>(x, g, be, w1, b1, w2, b2, out, rows, f, act, eps, s);
    case 256:
      return ffn_tf32_launch<256, A>(x, g, be, w1, b1, w2, b2, out, rows, f, act, eps, s);
    case 384:
      return ffn_tf32_launch<384, A>(x, g, be, w1, b1, w2, b2, out, rows, f, act, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace sn

extern "C" {

// qkv: scratch [bs*n, 3*heads*d] and mh [bs*n, heads*d] of the storage
// type; hmean may be null. fp32 takes the split-TF32 kernels (head_dim
// 1-128, any n and width; stats an fp32 scratch [bs*n, 2]); bf16 the
// tensor-core kernels (head_dim a multiple of 16 up to 64, n <= 320, dim a
// multiple of 16 up to 768; stats unused, may be null).
int sn_attn_block(int dtype, const void* x, const void* ln_scale, const void* ln_bias,
                  const void* wqkv, const void* bqkv, const void* wo, const void* bo, void* qkv,
                  void* mh, void* stats, void* out, void* hmean, int bs, int n, int dim,
                  int heads, int head_dim, float eps, float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == sn::kF32) {
    const auto f = [](const void* p) { return static_cast<const float*>(p); };
    return sn::attn_block_tf32(f(x), f(ln_scale), f(ln_bias), f(wqkv), f(bqkv), f(wo), f(bo),
                               static_cast<float*>(qkv), static_cast<float*>(mh),
                               static_cast<float2*>(stats), static_cast<float*>(out),
                               static_cast<float*>(hmean), bs, n, dim, heads, head_dim, eps,
                               scale, s);
  }
  return sn::attn_block_tc(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, qkv, mh, out, hmean, bs, n,
                           dim, heads, head_dim, eps, scale, s);
}

// dim 64-384: fp32 takes the split-TF32 kernel (x and w1 16-byte aligned),
// bf16 the tensor-core kernel (f a multiple of 8; x, w1 and w2 16-byte
// aligned); hidden and ln unused, may be null. Past 384 the wide route:
// hidden a scratch [rows, f] of the storage type, and ln LN2's scratch, in
// fp32 its (mean, rstd) a row [rows, 2], in bf16 LN2(x) itself [rows, dim]
// (dim a multiple of 16 up to 1024; ln_scale and ln_bias 16-byte aligned).
// act: the activation's code (ffn.cuh FfnAct); the kernels' instances: gelu
// and the run-time code in fp32; gelu, relu and the run-time code in bf16.
int sn_ffn_block(int dtype, const void* x, const void* ln_scale, const void* ln_bias,
                 const void* w1, const void* b1, const void* w2, const void* b2, void* out,
                 void* hidden, void* ln, int rows, int dim, int f, int act, float eps,
                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (!sn::ffn_act_valid(act)) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const bool wide = dim > 384;
  if (dtype == sn::kF32) {
    const auto c = [](const void* p) { return static_cast<const float*>(p); };
    return sn::with_act<sn::kActGelu, sn::kActAny>(act, [&](auto a) {
      constexpr int A = decltype(a)::value;
      return wide ? sn::ffn_wide_tf32<A>(c(x), c(ln_scale), c(ln_bias), c(w1), c(b1), c(w2),
                                         c(b2), static_cast<float*>(out),
                                         static_cast<float*>(hidden), static_cast<float2*>(ln),
                                         rows, dim, f, act, eps, s)
                  : sn::ffn_block_fp32<A>(x, ln_scale, ln_bias, w1, b1, w2, b2, out, rows, dim,
                                          f, act, eps, s);
    });
  }
  return sn::with_act<sn::kActGelu, sn::kActRelu, sn::kActAny>(act, [&](auto a) {
    constexpr int A = decltype(a)::value;
    return wide ? sn::ffn_wide_tc<A>(x, ln_scale, ln_bias, w1, b1, w2, b2, out, ln, hidden, rows,
                                     dim, f, act, eps, s)
                : sn::ffn_block_tc<A>(x, ln_scale, ln_bias, w1, b1, w2, b2, out, rows, dim, f,
                                      act, eps, s);
  });
}

// the bf16 wide route's launch (a) alone: a = round(LN2(x)) [rows, dim]
// (dim a multiple of 8 up to 1024; x, a, ln_scale, ln_bias 16-byte aligned)
int sn_ffn_ln_rows(const void* x, const void* ln_scale, const void* ln_bias, void* a, long rows,
                   int dim, float eps, void* stream) {
  return sn::ln_rows_bf16(x, ln_scale, ln_bias, a, rows, dim, eps,
                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"
