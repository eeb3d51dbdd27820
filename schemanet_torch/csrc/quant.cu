// W8A8 int8 projections for Hopper (sm_90a): per-row symmetric int8
// quantisation, and the int8 x int8 -> int32 GEMM with its fp32 epilogue.
//
//   quantize_rows: x [rows, k] (fp32 or bf16) -> q [rows, k] int8 and
//     scale [rows] fp32: scale = max(absmax, 1e-12) / 127,
//     q = clip(rint(x / scale), -127, 127) (round half to even);
//   int8_gemm: y[r, c] = cast(float(sum_k a[r, k] w[c, k]) * (as[r] * ws[c])
//     + b[c]) with a [rows, k] and w [n, k] int8 (both K-major, w in
//     nn.Linear layout), y fp32 or bf16; b may be absent.
//
// Replaces no Pallas kernel: schemanet_tpu/ops/quant.py (quantize_rows,
// quantize_weight, int8_dot) runs on XLA's int8 dot_general, which the TPU
// compiler maps to its matrix unit. On Hopper the int8 tensor cores run at
// twice the bf16 rate (1,979 against 989 dense TOP/s), and a product cast to
// floats would run none of that; so both steps are kernels of their own. The
// JAX package quantises the weights inside the same jit as their product, at
// every call; the port does the same (quantize_rows on the weight rows).
//
// Bit for bit: every division is IEEE (__fdiv_rn; the build has no
// fast-math), the rounding is __float2int_rn (nearest even, as torch.round
// and jnp.rint), the int32 sums are exact, and the epilogue is __fmul_rn and
// __fadd_rn in the plain version's order, never contracted into an FMA: so
// ops/kernels/quant.py's plain versions give the same bits on any device.
//
// What bounds them on the card:
//   * quantize_rows: bytes. A row is read once and its codes written once
//     (12,608 x 384 bf16: 9.7 MB + 4.8 MB, 4.3 us at 3.35 TB/s). One warp
//     takes a row whole in registers (16-byte pieces, lane l at pieces
//     l + 32 i, up to 3072 values), reduces |x|'s max by shuffles and writes
//     4 (fp32) or 8 (bf16) codes a piece: the row leaves device memory once.
//   * int8_gemm: at the serving shapes, bytes too. At DeiT-Small's qkv
//     (12,608 x 1,152 x 384) the products are 11.2 GOP (5.6 us at 1,979
//     TOP/s), while the bf16 output alone is 29 MB (8.7 us); at DeiT-Base's
//     fc2 (k 3,072) the products bound it. The design is gemm.cuh's
//     gemm_wg_kernel for int8: a persistent block an SM, a producer
//     warpgroup keeping TMA loads of a's and w's k stages (128 bytes of k,
//     the 128-byte swizzle; tma_map_i8) in flight through a ring with full
//     and empty mbarriers, and two consumer warpgroups on
//     wgmma.mma_async m64nBNk32 s32.s8.s8 (both operands K-major, the only
//     layout wgmma takes for 8-bit types and the one nn.Linear's weight has;
//     a k32 step is 32 bytes, as a bf16 k16 step). The tile is 128 x 96 or
//     128 x 192 (int8_tile_bn: the fewest rounds of persistent blocks). The
//     output write sets the bound, so the epilogue runs on the fragments in
//     registers (its column values from shared memory), puts the outputs in
//     shared memory, and writes y from there in whole 16-byte chunks along
//     its rows while the warpgroup's products of its next tile run (the
//     products alone take half the kernel's time at qkv or less on an H100
//     SXM at 700 W: tools/kernel_variants_torch.py int8). TMA fills rows, n and
//     k past their ends with zeros and the epilogue masks, so any rows, any
//     n >= 1 and k a multiple of 32 are taken.
//     (The first design, mma.sync m16n8k32 on 128 x 128 tiles a block fed
//     by two cp.async stages of 64 bytes, ran at 20% of the byte bound at
//     qkv and behind torch._int_mm on the same card.)

#include "gemm.cuh"

namespace sn {

constexpr float kQuantMax = 127.f;
constexpr float kScaleFloor = 1e-12f;

// ---------------------------------------------------------------------------
// quantize_rows: a warp a row, NP 16-byte pieces a lane at most
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t code_byte(float v, float s) {
  const int c = __float2int_rn(__fdiv_rn(v, s));
  return static_cast<uint32_t>(max(-127, min(127, c))) & 0xffu;
}

template <int N>
struct Codes;

template <>
struct Codes<4> {  // an fp32 piece: 4 codes, one 4-byte store
  template <typename Raw, typename P>
  static __device__ __forceinline__ void store(int8_t* q, const Raw& r, float s, P) {
    uint32_t w = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) w |= code_byte(P::get(r, j), s) << (8 * j);
    *reinterpret_cast<uint32_t*>(q) = w;
  }
};

template <>
struct Codes<8> {  // a bf16 piece: 8 codes, one 8-byte store
  template <typename Raw, typename P>
  static __device__ __forceinline__ void store(int8_t* q, const Raw& r, float s, P) {
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lo |= code_byte(P::get(r, j), s) << (8 * j);
      hi |= code_byte(P::get(r, j + 4), s) << (8 * j);
    }
    *reinterpret_cast<uint2*>(q) = make_uint2(lo, hi);
  }
};

template <typename T, int NP>
__global__ void __launch_bounds__(kThreads)
    quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                         float* __restrict__ scale, long rows, int k) {
  constexpr int N = 16 / sizeof(T);
  using P = Pack<T, N>;
  const long row = (long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int pieces = k / N;
  const T* xr = x + row * k;
  typename P::Raw raw[NP];
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int c = lane + 32 * i;
    raw[i] = c < pieces ? P::load(xr + (long)c * N) : P::zero();
#pragma unroll
    for (int j = 0; j < N; ++j) m = fmaxf(m, fabsf(P::get(raw[i], j)));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float s = __fdiv_rn(fmaxf(m, kScaleFloor), kQuantMax);
  if (lane == 0) scale[row] = s;
  int8_t* qr = q + row * k;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int c = lane + 32 * i;
    if (c < pieces) Codes<N>::store(qr + (long)c * N, raw[i], s, P{});
  }
}

template <typename T>
cudaError_t quantize_rows_t(const void* x, void* q, void* scale, long rows, int k,
                            cudaStream_t s) {
  constexpr int N = 16 / sizeof(T);
  const int per_lane = (k / N + 31) / 32;
  const unsigned blocks = (unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32));
  const auto xp = static_cast<const T*>(x);
  const auto qp = static_cast<int8_t*>(q);
  const auto sp = static_cast<float*>(scale);
  if (per_lane <= 1)
    quantize_rows_kernel<T, 1><<<blocks, kThreads, 0, s>>>(xp, qp, sp, rows, k);
  else if (per_lane <= 2)
    quantize_rows_kernel<T, 2><<<blocks, kThreads, 0, s>>>(xp, qp, sp, rows, k);
  else if (per_lane <= 4)
    quantize_rows_kernel<T, 4><<<blocks, kThreads, 0, s>>>(xp, qp, sp, rows, k);
  else if (per_lane <= 8)
    quantize_rows_kernel<T, 8><<<blocks, kThreads, 0, s>>>(xp, qp, sp, rows, k);
  else if (per_lane <= 12)
    quantize_rows_kernel<T, 12><<<blocks, kThreads, 0, s>>>(xp, qp, sp, rows, k);
  else
    quantize_rows_kernel<T, 24><<<blocks, kThreads, 0, s>>>(xp, qp, sp, rows, k);
  return cudaGetLastError();
}

constexpr int kQuantMaxRow = 3072;  // 24 pieces of 4 fp32 a lane

// ---------------------------------------------------------------------------
// int8_gemm: persistent blocks, a TMA ring of k stages, wgmma s8
// ---------------------------------------------------------------------------
constexpr int kI8Consumers = 2;          // consumer warpgroups, 64 rows each
constexpr int kI8BM = 64 * kI8Consumers;  // rows of a tile
constexpr int kI8BK = 128;               // k a stage: one 128-byte swizzled row
constexpr int kI8Threads = 128 * (kI8Consumers + 1);
constexpr int kMaxSmem = 232448;  // the dynamic shared memory a block may ask for on an H100

template <typename OutT>
struct Out2;  // two adjacent outputs into shared memory, and 16 bytes of y

template <>
struct Out2<float> {
  static __device__ __forceinline__ void put(uint8_t* p, float v0, float v1) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  }
  static __device__ __forceinline__ void one(float* y, const uint8_t* p) {
    *y = *reinterpret_cast<const float*>(p);
  }
};

template <>
struct Out2<bf16> {
  static __device__ __forceinline__ void put(uint8_t* p, float v0, float v1) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(v0, v1);
  }
  static __device__ __forceinline__ void one(bf16* y, const uint8_t* p) {
    *y = *reinterpret_cast<const bf16*>(p);
  }
};

template <int BN, typename OutT>
struct I8Smem {
  static constexpr int kA = kI8BM * kI8BK;  // 16 KB: 128 rows of a's k stage
  static constexpr int kB = BN * kI8BK;     // BN rows of w's
  static constexpr int kStage = kA + kB;
  // a consumer warpgroup's finished tile: 64 rows of BN outputs, padded by
  // 16 bytes a row (bf16) or 32 (fp32) so that the 4- or 8-byte fragment
  // stores of a warp (8 rows x 4 pairs) fall on distinct banks, then the
  // tile's w_scale and bias (BN each) and a_scale (64)
  static constexpr int kPitch = BN * (int)sizeof(OutT) + 8 * (int)sizeof(OutT);
  static constexpr int kOutRows = 64 * kPitch;
  static constexpr int kOut = (kOutRows + 2048 + 1023) / 1024 * 1024;
  static constexpr int kRoom = (kMaxSmem - 256 - 1024 - kI8Consumers * kOut) / kStage;
  static constexpr int kStages = kRoom < 6 ? kRoom : 6;
  static constexpr int kBytes = kStages * kStage + kI8Consumers * kOut + 1024;
  static_assert(kStage % 1024 == 0, "stages stay 1024-byte aligned");
  static_assert(kPitch % 16 == 0, "rows of whole 16-byte chunks");
  static_assert(kStages >= 2, "a ring of two stages at least");
};

__device__ __forceinline__ void consumer_sync(int cw) {  // the 128 threads of warpgroup 1 + cw
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
}

// One persistent block an SM walks the output tiles (kI8BM x BN, n fastest,
// so the blocks in flight share their rows of a). Warpgroup 0 is the
// producer: one thread keeps TMA loads of a's and w's k stages in flight
// through the ring (a full and an empty mbarrier a stage). Consumer
// warpgroup cw multiplies rows 64 cw.. of the tile by wgmma m64nBNk32 s8,
// then runs the epilogue on its fragments in registers (the tile's scales
// and bias, loaded while the products ran, from shared memory; the plain
// version's operations in its order) and puts the outputs in its own shared
// buffer. The buffer goes to y while the warpgroup's products of the next
// tile run, a share of its 16-byte chunks after each k stage's wgmma is
// issued. `vec`: y's rows are whole 16-byte chunks (n sizeof(OutT) a
// multiple of 16, y aligned); else element stores.
template <int BN, typename OutT>
__global__ void __launch_bounds__(kI8Threads, 1)
    int8_gemm_wg_kernel(const __grid_constant__ CUtensorMap ta,
                        const __grid_constant__ CUtensorMap tw, const float* __restrict__ as,
                        const float* __restrict__ ws, const float* __restrict__ bias,
                        OutT* __restrict__ y, int rows, int n, int K, int vec) {
  using S = I8Smem<BN, OutT>;
  constexpr int E = 16 / (int)sizeof(OutT);     // outputs a chunk
  constexpr int kChunks = 64 * (BN / E) / 128;  // a thread's chunks of a finished tile
  static_assert((64 * (BN / E)) % 128 == 0, "whole chunks a thread");
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[S::kStages], empty[S::kStages];
  uint8_t* smem = ring_base(smem_raw);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int n_tiles = (n + BN - 1) / BN;
  const int tiles = (rows + kI8BM - 1) / kI8BM * n_tiles, steps = (K + kI8BK - 1) / kI8BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kI8Consumers);  // one arrival a consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (wg == 0) {  // producer
    regs_dec<kHgProducerRegs>();
    if (tid != 0) return;
    Ring<S::kStages> ring;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int n0 = (t % n_tiles) * BN, m0 = (t / n_tiles) * kI8BM;
      for (int s = 0; s < steps; ++s, ring.next()) {
        mbar_wait(&empty[ring.stage], ring.phase ^ 1);
        uint8_t* st = smem + ring.stage * S::kStage;
        mbar_arrive_expect(&full[ring.stage], S::kStage);
        tma_load(st, &ta, &full[ring.stage], s * kI8BK, m0);
        tma_load(st + S::kA, &tw, &full[ring.stage], s * kI8BK, n0);
      }
    }
    return;
  }
  regs_inc<HgRegs<kI8Consumers>::kConsumer>();
  const int cw = wg - 1, warp = tid / 32, lane = tid % 32;
  uint8_t* staged = smem + S::kStages * S::kStage + cw * S::kOut;
  float* col_w = reinterpret_cast<float*>(staged + S::kOutRows);
  float* col_b = col_w + BN;
  float* row_a = col_b + BN;
  long pm0 = -1;  // the finished tile's first row (-1: none) and column
  int pn0 = 0;

  // chunk i of this thread's share of the finished tile, to y
  const auto emit = [&](int i) {
    const int id = tid + 128 * i;
    const int rl = id / (BN / E), cl = (id % (BN / E)) * E;
    const long r = pm0 + rl;
    const int c = pn0 + cl;
    if (r >= rows || c >= n) return;
    const uint8_t* src = staged + rl * S::kPitch + cl * (int)sizeof(OutT);
    OutT* out = y + r * n + c;
    if (vec && c + E <= n) {
      *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < E && c + e < n; ++e)
        Out2<OutT>::one(out + e, src + e * (int)sizeof(OutT));
    }
  };

  Ring<S::kStages> ring;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int n0 = (t % n_tiles) * BN, m0 = (t / n_tiles) * kI8BM + cw * 64;
    // this tile's scales and bias, loaded now, put in shared memory after
    // its products
    float pre_w[2], pre_b[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int cl = tid + 128 * q, c = n0 + cl;
      const bool in = cl < BN && c < n;
      pre_w[q] = in ? ws[c] : 0.f;
      pre_b[q] = in && bias ? bias[c] : 0.f;
    }
    const float pre_a = tid < 64 && m0 + tid < rows ? as[m0 + tid] : 0.f;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    wg_fence_regs(acc);
    int held = -1;  // the stage whose products may still be in flight
    for (int s = 0; s < steps; ++s, ring.next()) {
      mbar_wait(&full[ring.stage], ring.phase);
      const uint8_t* a_s = smem + ring.stage * S::kStage + cw * 64 * kI8BK;
      const uint8_t* w_s = smem + ring.stage * S::kStage + S::kA;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kI8BK / 32; ++kk)
        wgmma_s8<BN>(acc, wg_desc(a_s + kk * 32, 16, 1024), wg_desc(w_s + kk * 32, 16, 1024));
      wg_commit();
      if (pm0 >= 0)  // the finished tile's share for this stage, under the products
        for (int i = s * kChunks / steps; i < (s + 1) * kChunks / steps; ++i) emit(i);
      wg_wait<1>();  // the previous stage's products are done: release it
      if (held >= 0 && tid == 0) mbar_arrive(&empty[held]);
      held = ring.stage;
    }
    wg_wait<0>();
    if (held >= 0 && tid == 0) mbar_arrive(&empty[held]);
    wg_fence_regs(acc);

    // the epilogue: the previous tile's epilogue read the column values
    // before its last sync, and its chunks are all written
#pragma unroll
    for (int q = 0; q < 2; ++q)
      if (tid + 128 * q < BN) {
        col_w[tid + 128 * q] = pre_w[q];
        col_b[tid + 128 * q] = pre_b[q];
      }
    if (tid < 64) row_a[tid] = pre_a;
    consumer_sync(cw);
    // thread t holds rows 16 warp + lane / 4 (+ 8) and columns 8 j +
    // 2 (lane % 4) (+ 1)
    const int rl = warp * 16 + lane / 4;
    const float x0 = row_a[rl], x1 = row_a[rl + 8];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int cl = 8 * j + 2 * (lane % 4);
      const float2 wv = *reinterpret_cast<const float2*>(col_w + cl);
      const float2 bv = *reinterpret_cast<const float2*>(col_b + cl);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float x = h ? x1 : x0;
        float v0 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), __fmul_rn(x, wv.x));
        float v1 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), __fmul_rn(x, wv.y));
        if (bias) {
          v0 = __fadd_rn(v0, bv.x);
          v1 = __fadd_rn(v1, bv.y);
        }
        Out2<OutT>::put(staged + (rl + 8 * h) * S::kPitch + cl * (int)sizeof(OutT), v0, v1);
      }
    }
    consumer_sync(cw);
    pm0 = m0;
    pn0 = n0;
  }
  if (pm0 >= 0)
    for (int i = 0; i < kChunks; ++i) emit(i);
}

// The tile width for a rows x n product: of 96 and 192 columns (each n of
// the paths is a multiple of 192), the one with the fewest rounds of kSms
// persistent blocks times (columns + 32), the 32 standing for a tile's fixed
// cost (fill and epilogue), as gemm_tile; a tie goes to 192.
inline int int8_tile_bn(long rows, int n) {
  int best = 96;
  long best_cost = -1;
  static const int widths[] = {96, 192};
  for (const int bn : widths) {
    const long tiles = (rows + kI8BM - 1) / kI8BM * ((n + bn - 1) / bn);
    const long cost = (tiles + kSms - 1) / kSms * (bn + 32);
    if (best_cost < 0 || cost <= best_cost) {
      best = bn;
      best_cost = cost;
    }
  }
  return best;
}

template <int BN, typename OutT>
cudaError_t int8_gemm_launch(const int8_t* a, const int8_t* w, const float* as, const float* ws,
                             const float* bias, OutT* y, long rows, int n, int k,
                             cudaStream_t stream) {
  using S = I8Smem<BN, OutT>;
  CUtensorMap ta, tw;
  cudaError_t err = tma_map_i8(&ta, a, rows, k, kI8BM);
  if (err == cudaSuccess) err = tma_map_i8(&tw, w, n, k, BN);
  if (err == cudaSuccess) err = allow_smem(int8_gemm_wg_kernel<BN, OutT>, S::kBytes);
  if (err != cudaSuccess) return err;
  const long tiles = (rows + kI8BM - 1) / kI8BM * ((n + BN - 1) / BN);
  const int grid = (int)(tiles < sm_count() ? tiles : sm_count());
  const int vec = (n * (int)sizeof(OutT)) % 16 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  int8_gemm_wg_kernel<BN, OutT><<<grid, kI8Threads, S::kBytes, stream>>>(
      ta, tw, as, ws, bias, y, (int)rows, n, k, vec);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t int8_gemm_t(const int8_t* a, const int8_t* w, const float* as, const float* ws,
                        const float* bias, OutT* y, long rows, int n, int k, cudaStream_t s) {
  if (int8_tile_bn(rows, n) == 96)
    return int8_gemm_launch<96, OutT>(a, w, as, ws, bias, y, rows, n, k, s);
  return int8_gemm_launch<192, OutT>(a, w, as, ws, bias, y, rows, n, k, s);
}

}  // namespace sn

extern "C" {

// x [rows, k] of the storage type (k a multiple of 8 up to 3072, x 16-byte
// aligned) -> q [rows, k] int8 (8-byte aligned), scale [rows] fp32
int sn_quantize_rows(int dtype, const void* x, void* q, void* scale, long rows, int k,
                     void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto aligned = [](const void* p, int b) { return reinterpret_cast<uintptr_t>(p) % b == 0; };
  if (k <= 0 || k % 8 || k > sn::kQuantMaxRow || !aligned(x, 16) || !aligned(q, 8))
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  if (dtype == sn::kF32) return sn::quantize_rows_t<float>(x, q, scale, rows, k, s);
  return sn::quantize_rows_t<sn::bf16>(x, q, scale, rows, k, s);
}

// a [rows, k], w [n, k] int8 (16-byte aligned, k a multiple of 32), a_scale
// [rows], w_scale [n], bias [n] fp32 (bias may be null) -> y [rows, n] of
// out_dtype (fp32 or bf16)
int sn_int8_gemm(int out_dtype, const void* a, const void* w, const void* a_scale,
                 const void* w_scale, const void* bias, void* y, long rows, int n, int k,
                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (k <= 0 || k % 32 || n <= 0 || rows < 0 || rows > INT32_MAX || !aligned(a) || !aligned(w))
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const auto ap = static_cast<const int8_t*>(a);
  const auto wp = static_cast<const int8_t*>(w);
  const auto asp = static_cast<const float*>(a_scale);
  const auto wsp = static_cast<const float*>(w_scale);
  const auto bp = static_cast<const float*>(bias);
  if (out_dtype == sn::kF32)
    return sn::int8_gemm_t(ap, wp, asp, wsp, bp, static_cast<float*>(y), rows, n, k, s);
  return sn::int8_gemm_t(ap, wp, asp, wsp, bp, static_cast<sn::bf16*>(y), rows, n, k, s);
}

}  // extern "C"
