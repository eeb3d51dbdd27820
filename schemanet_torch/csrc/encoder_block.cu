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
//   * ffn_block is one launch: LN2 of a row tile into shared memory, then
//     the hidden width in chunks: fc1 + bias + gelu into shared memory, and
//     the fc2 partial sums accumulate in registers. The [rows, 768] hidden
//     state never reaches device memory.
// Routes by the storage type (ops/kernels/encoder_block.py attn_block_route
// and ffn_block_route say which, and raise on what none takes):
//   * attn_block: fp32 FMA on shared-memory tiles (ln_qkv_kernel,
//     attn_core_kernel: tensor cores would mean TF32 and lose the 1e-4
//     agreement the fp32 checks hold); bf16 the tensor-core route below.
//   * ffn_block: bf16 ffn_tc_kernel (mma.sync m16n8k16, the fused_mlp
//     forward's chunk loop of ffn.cuh behind an LN2 prologue); fp32
//     ffn_tf32_kernel (mma.sync m16n8k8 .tf32 by the 3xTF32 split, which
//     keeps about fp32's accuracy).
//
// Numerics follow the TPU kernels: LN statistics in fp32 (E[x^2] - E[x]^2),
// every product accumulated in fp32 and rounded once to T, bias added in T
// after that rounding, q scaled in T, scores and softmax in fp32, the
// probabilities rounded to T before the AV product, the head-mean summed in
// fp32 over heads in order and scaled by 1/H, gelu in fp32 with the
// Abramowitz-Stegun erf (ffn.cuh's gelu_as), the residual added in T.
#include "ffn.cuh"

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
// FFN half, bf16 (ffn_block_route's "tensor_core"): ffn_tc_kernel, mma.sync
// m16n8k16 through ffn.cuh's chunk loop (the fused_mlp forward's), one
// block of 8 warps per RT rows. The prologue is LN2 of the block's rows,
// computed in fp32 and rounded to bf16 into the A tile (layernorm_rows_bf16)
// while the first W1/W2 chunk is in flight by cp.async; the hidden element
// is ffn_hidden_bf16 at p = 0 (no hash, no mask); the epilogue is
//   out = x + round(round(acc) + b2), x re-read from device memory.
// RT = 64 up to width 256 (two blocks an SM up to 192), 32 at 384 (48
// output registers a thread, one block an SM). f a multiple of 8: the
// weights' hidden columns are copied in 16-byte chunks.
// ---------------------------------------------------------------------------
template <int DIM>
constexpr int kFfnTcRows = DIM <= 256 ? 64 : 32;

template <int DIM>
__global__ void __launch_bounds__(kThreads, DIM <= 192 ? 2 : 1)
    ffn_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_scale,
                  const float* __restrict__ ln_bias, float eps, const bf16* __restrict__ w1,
                  const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                  const bf16* __restrict__ b2, bf16* __restrict__ out, int rows, int f) {
  constexpr int RT = kFfnTcRows<DIM>;
  using S = FfnTcSmem<DIM, RT>;
  using L = FfnTcLayout<DIM, RT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* as = reinterpret_cast<bf16*>(smem_raw);  // LN2(x) [RT][DIM + 8]
  bf16* stages = as + S::kA;                     // 2 x (W1 chunk, W2 chunk)
  bf16* act = stages + 2 * S::kStage;            // gelu of the chunk [RT][40]
  const int lane = threadIdx.x & 31;
  const long row0 = (long)blockIdx.x * RT;
  ffn_tc_stage_chunk<DIM, RT>(stages, w1, w2, f, 0);
  cp_async_commit();
  layernorm_rows_bf16<RT>(x, row0, (int)min((long)RT, rows - row0), DIM, ln_scale, ln_bias, eps,
                          as, S::kPitch);  // while chunk 0 is in flight

  float oacc[L::kOutTiles][4] = {};
  ffn_tc_chunks<DIM, RT>(as, stages, act, w1, b1, w2, row0, f, 0.f, 1.f, 0u, oacc);
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
// chunk's gelu output are split into hi and lo planes once per element, as
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
// memory (2.5 KB) before gelu. One block an SM.
//   out = x + ((gelu(LN2(x) W1^T + b1) W2^T) + b2), all in fp32
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
  static constexpr int kAct = kRows * kActPitch;  // one plane of the chunk's gelu
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

template <int DIM>
__global__ void __launch_bounds__(kThreads, 1)
    ffn_tf32_kernel(const float* __restrict__ x, const float* __restrict__ ln_scale,
                    const float* __restrict__ ln_bias, float eps, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, float* __restrict__ out, int rows, int f) {
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
  // the planes as bf16 pairs for the fragment loaders: pitch and k doubled
  auto h16 = [](const uint32_t* p) { return reinterpret_cast<const bf16*>(p); };

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
          ldsm_a(ah, h16(a_hi), 2 * P, wr * 16, k0, lane);
          ldsm_a(al, h16(a_lo), 2 * P, wr * 16, k0, lane);
          ldsm_b_nk(bh, h16(w1_hi), 2 * P, g * 16, k0, lane);
          ldsm_b_nk(bl, h16(w1_lo), 2 * P, g * 16, k0, lane);
          mma1688_split(t[0], ah, al, bh[0], bh[1], bl[0], bl[1]);
          mma1688_split(t[1], ah, al, bh[2], bh[3], bl[2], bl[3]);
        }
      } else {
#pragma unroll
        for (int kp = 0; kp < 2; ++kp) {
          const int k0 = 2 * kq * (DIM / KS) + (kg * 2 + kp) * 32;  // in bf16 units: 16 of k
          uint32_t bh[4], bl[4];
          ldsm_b_nk_k32(bh, h16(w1_hi), 2 * P, g * 8, k0, lane);
          ldsm_b_nk_k32(bl, h16(w1_lo), 2 * P, g * 8, k0, lane);
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            uint32_t ah[4], al[4];
            ldsm_a(ah, h16(a_hi), 2 * P, wr * 16, k0 + s * 16, lane);
            ldsm_a(al, h16(a_lo), 2 * P, wr * 16, k0 + s * 16, lane);
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
    // a = gelu(h + b1) in fp32, split into the activation planes
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
          tf32_split(f0 + cc < f ? gelu_as(h0 + b1[f0 + cc]) : 0.f, hi.x, lo.x);
          tf32_split(f0 + cc + 1 < f ? gelu_as(h1 + b1[f0 + cc + 1]) : 0.f, hi.y, lo.y);
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
      ldsm_a(ah[ks], h16(act_hi), 2 * AP, wr * 16, ks * 16, lane);
      ldsm_a(al[ks], h16(act_lo), 2 * AP, wr * 16, ks * 16, lane);
    }
    auto fc2_tiles = [&](int nb) {  // output tiles 2 nb and 2 nb + 1
      float t[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < CH / 8; ++ks) {
        uint32_t bh[4], bl[4];
        ldsm_b_nk(bh, h16(w2_hi), 2 * AP, wc * L::kOutCols + nb * 16, ks * 16, lane);
        ldsm_b_nk(bl, h16(w2_lo), 2 * AP, wc * L::kOutCols + nb * 16, ks * 16, lane);
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
  cudaError_t err = allow_smem(linear_tc_kernel<kLn>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((rows + kLinRows - 1) / kLinRows, (N + kLinCols - 1) / kLinCols);
  linear_tc_kernel<kLn><<<grid, kThreads, bytes, stream>>>(
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
                       int rows, int f, float eps, cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(rows + RT - 1) / RT, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(g), static_cast<const float*>(be), eps,
      static_cast<const T*>(w1), static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(out), rows, f);
  return cudaGetLastError();
}

template <int DIM>
cudaError_t ffn_tc_launch(const void* x, const void* g, const void* be, const void* w1,
                          const void* b1, const void* w2, const void* b2, void* out, int rows,
                          int f, float eps, cudaStream_t s) {
  constexpr int RT = kFfnTcRows<DIM>;
  return ffn_launch<bf16, RT>(ffn_tc_kernel<DIM>, FfnTcSmem<DIM, RT>::kBytes, x, g, be, w1, b1,
                              w2, b2, out, rows, f, eps, s);
}

template <int DIM>
cudaError_t ffn_tf32_launch(const void* x, const void* g, const void* be, const void* w1,
                            const void* b1, const void* w2, const void* b2, void* out, int rows,
                            int f, float eps, cudaStream_t s) {
  return ffn_launch<float, kFfnTf32Rows<DIM>>(ffn_tf32_kernel<DIM>, FfnTf32Smem<DIM>::kBytes, x,
                                                 g, be, w1, b1, w2, b2, out, rows, f, eps, s);
}

// bf16 by the tensor cores, f a multiple of 8
cudaError_t ffn_block_tc(const void* x, const void* g, const void* be, const void* w1,
                         const void* b1, const void* w2, const void* b2, void* out, int rows,
                         int dim, int f, float eps, cudaStream_t s) {
  if (f % 8) return cudaErrorInvalidValue;
  switch (dim) {
    case 64: return ffn_tc_launch<64>(x, g, be, w1, b1, w2, b2, out, rows, f, eps, s);
    case 128: return ffn_tc_launch<128>(x, g, be, w1, b1, w2, b2, out, rows, f, eps, s);
    case 192: return ffn_tc_launch<192>(x, g, be, w1, b1, w2, b2, out, rows, f, eps, s);
    case 256: return ffn_tc_launch<256>(x, g, be, w1, b1, w2, b2, out, rows, f, eps, s);
    case 384: return ffn_tc_launch<384>(x, g, be, w1, b1, w2, b2, out, rows, f, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

// fp32 by the split TF32
cudaError_t ffn_block_fp32(const void* x, const void* g, const void* be, const void* w1,
                           const void* b1, const void* w2, const void* b2, void* out, int rows,
                           int dim, int f, float eps, cudaStream_t s) {
  switch (dim) {
    case 64: return ffn_tf32_launch<64>(x, g, be, w1, b1, w2, b2, out, rows, f, eps, s);
    case 128: return ffn_tf32_launch<128>(x, g, be, w1, b1, w2, b2, out, rows, f, eps, s);
    case 192: return ffn_tf32_launch<192>(x, g, be, w1, b1, w2, b2, out, rows, f, eps, s);
    case 256: return ffn_tf32_launch<256>(x, g, be, w1, b1, w2, b2, out, rows, f, eps, s);
    case 384: return ffn_tf32_launch<384>(x, g, be, w1, b1, w2, b2, out, rows, f, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace sn

extern "C" {

// qkv: scratch [bs*n, 3*heads*d] of the storage type; hmean may be null.
// fp32 takes the FMA kernels (head_dim <= 128; mh unused, may be null); bf16
// the tensor-core kernels (head_dim a multiple of 16 up to 64, n <= 320, dim
// a multiple of 16 up to 768; mh a bf16 scratch [bs*n, heads*d]).
int sn_attn_block(int dtype, const void* x, const void* ln_scale, const void* ln_bias,
                  const void* wqkv, const void* bqkv, const void* wo, const void* bo, void* qkv,
                  void* mh, void* out, void* hmean, int bs, int n, int dim, int heads,
                  int head_dim, float eps, float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == sn::kF32) {
    if (head_dim > sn::kMaxHeadDim) return cudaErrorInvalidValue;
    return sn::attn_block_impl<float>(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, qkv, out,
                                      hmean, bs, n, dim, heads, head_dim, eps, scale, s);
  }
  return sn::attn_block_tc(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, qkv, mh, out, hmean, bs, n,
                           dim, heads, head_dim, eps, scale, s);
}

// dim 64-384; fp32 takes the split-TF32 kernel (x and w1 16-byte aligned),
// bf16 the tensor-core kernel (f a multiple of 8; x, w1 and w2 16-byte
// aligned).
int sn_ffn_block(int dtype, const void* x, const void* ln_scale, const void* ln_bias,
                 const void* w1, const void* b1, const void* w2, const void* b2, void* out,
                 int rows, int dim, int f, float eps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return cudaSuccess;
  if (dtype == sn::kF32)
    return sn::ffn_block_fp32(x, ln_scale, ln_bias, w1, b1, w2, b2, out, rows, dim, f, eps, s);
  return sn::ffn_block_tc(x, ln_scale, ln_bias, w1, b1, w2, b2, out, rows, dim, f, eps, s);
}

}  // extern "C"
