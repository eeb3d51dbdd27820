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
//     TOP/s), while the bf16 output alone is 29 MB (8.7 us). The first design
//     is the simple one: 128 x 128 output tiles a block of 8 warps (each
//     64 x 32), k in stages of 64 bytes double-buffered by cp.async,
//     ldmatrix of 16-byte rows into mma.sync m16n8k32 s8 fragments (the
//     int8 k32 fragment is the bf16 k16 one read as bytes, so the bf16
//     fragment loaders of common.cuh serve), the epilogue from registers.
//     A TMA-fed wgmma design with a fused gelu or quantise epilogue is later
//     work.

#include "common.cuh"

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
// int8_gemm: 128 x 128 tiles, 8 warps of 64 x 32, k in stages of 64 bytes
// ---------------------------------------------------------------------------
constexpr int kI8BM = 128, kI8BN = 128, kI8BK = 64;
constexpr int kI8Pitch = kI8BK + 16;  // bytes: the 8 rows of an ldmatrix fall on distinct banks
constexpr int kI8WarpsM = 2, kI8WarpsN = 4;
constexpr int kI8MT = kI8BM / kI8WarpsM / 16;  // m16 tiles a warp: 4
constexpr int kI8NT = kI8BN / kI8WarpsN / 8;   // n8 tiles a warp: 4
static_assert(kI8WarpsM * kI8WarpsN * 32 == kThreads, "a block is 8 warps");

// c += a b: A 16 x 32 (row), B 32 x 8 (col), s8 in, s32 accumulated (exact)
__device__ __forceinline__ void mma16832_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                            uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [r0, r0 + 128) and bytes [k0, k0 + 64) of a K-major int8 matrix into a
// [128][kI8Pitch] tile, 16 bytes a copy; rows past `nrows` read as zeros
__device__ __forceinline__ void stage_i8(int8_t* tile, const int8_t* __restrict__ src, long r0,
                                         long nrows, int k0, int K) {
#pragma unroll
  for (int i = 0; i < (kI8BM * kI8BK / 16) / kThreads; ++i) {
    const int id = threadIdx.x + kThreads * i;
    const int r = id / (kI8BK / 16), chunk = id % (kI8BK / 16);
    const long gr = r0 + r;
    const int gk = k0 + 16 * chunk;
    const bool in = gr < nrows && gk < K;
    cp_async16(tile + r * kI8Pitch + 16 * chunk, in ? src + gr * K + gk : src, in ? 16 : 0);
  }
}

template <typename OutT>
__device__ __forceinline__ void store_pair(OutT* y, long r, int c, int n, float v0, float v1);

template <>
__device__ __forceinline__ void store_pair<float>(float* y, long r, int c, int n, float v0,
                                                  float v1) {
  float* p = y + r * n + c;
  if (c + 1 < n && n % 2 == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    p[0] = v0;
    if (c + 1 < n) p[1] = v1;
  }
}

template <>
__device__ __forceinline__ void store_pair<bf16>(bf16* y, long r, int c, int n, float v0,
                                                 float v1) {
  bf16* p = y + r * n + c;
  if (c + 1 < n && n % 2 == 0) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(v0, v1);
  } else {
    p[0] = __float2bfloat16(v0);
    if (c + 1 < n) p[1] = __float2bfloat16(v1);
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
    int8_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
                     const float* __restrict__ as, const float* __restrict__ ws,
                     const float* __restrict__ bias, OutT* __restrict__ y, long rows, int n,
                     int K) {
  __shared__ __align__(128) int8_t sa[2][kI8BM * kI8Pitch];
  __shared__ __align__(128) int8_t sb[2][kI8BN * kI8Pitch];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / kI8WarpsN, wn = warp % kI8WarpsN;
  const long m0 = (long)blockIdx.x * kI8BM;
  const int n0 = blockIdx.y * kI8BN;
  int acc[kI8MT][kI8NT][4];
#pragma unroll
  for (int i = 0; i < kI8MT; ++i)
#pragma unroll
    for (int j = 0; j < kI8NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = (K + kI8BK - 1) / kI8BK;
  stage_i8(sa[0], a, m0, rows, 0, K);
  stage_i8(sb[0], w, n0, n, 0, K);
  cp_async_commit();
  constexpr int pitch = kI8Pitch / 2;  // in the 2-byte units of the bf16 fragment loaders
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      stage_i8(sa[(kt + 1) & 1], a, m0, rows, (kt + 1) * kI8BK, K);
      stage_i8(sb[(kt + 1) & 1], w, n0, n, (kt + 1) * kI8BK, K);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* ta = reinterpret_cast<const bf16*>(sa[kt & 1]);
    const bf16* tb = reinterpret_cast<const bf16*>(sb[kt & 1]);
#pragma unroll
    for (int ks = 0; ks < kI8BK / 32; ++ks) {
      uint32_t fa[kI8MT][4], fb[kI8NT / 2][4];
#pragma unroll
      for (int i = 0; i < kI8MT; ++i) ldsm_a(fa[i], ta, pitch, wm * 64 + i * 16, ks * 16, lane);
#pragma unroll
      for (int j = 0; j < kI8NT / 2; ++j)
        ldsm_b_nk(fb[j], tb, pitch, wn * 32 + j * 16, ks * 16, lane);
#pragma unroll
      for (int i = 0; i < kI8MT; ++i)
#pragma unroll
        for (int j = 0; j < kI8NT; ++j)
          mma16832_s8(acc[i][j], fa[i], fb[j / 2][(j & 1) * 2], fb[j / 2][(j & 1) * 2 + 1]);
    }
    __syncthreads();
  }

  // epilogue: lane holds rows lane/4 and lane/4 + 8, columns 2 (lane % 4) + 0, 1
#pragma unroll
  for (int j = 0; j < kI8NT; ++j) {
    const int c = n0 + wn * 32 + j * 8 + 2 * (lane % 4);
    if (c >= n) continue;
    const bool c1 = c + 1 < n;
    const float w0 = ws[c], w1 = c1 ? ws[c + 1] : 0.f;
    const float b0 = bias ? bias[c] : 0.f, b1 = bias && c1 ? bias[c + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < kI8MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long r = m0 + wm * 64 + i * 16 + lane / 4 + 8 * h;
        if (r >= rows) continue;
        const float x = as[r];
        float v0 = __fmul_rn(__int2float_rn(acc[i][j][2 * h]), __fmul_rn(x, w0));
        float v1 = __fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), __fmul_rn(x, w1));
        if (bias) {
          v0 = __fadd_rn(v0, b0);
          v1 = __fadd_rn(v1, b1);
        }
        store_pair<OutT>(y, r, c, n, v0, v1);
      }
    }
  }
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
  if (k <= 0 || k % 32 || n <= 0 || !aligned(a) || !aligned(w)) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const dim3 grid((unsigned)((rows + sn::kI8BM - 1) / sn::kI8BM),
                  (unsigned)((n + sn::kI8BN - 1) / sn::kI8BN));
  const auto ap = static_cast<const int8_t*>(a);
  const auto wp = static_cast<const int8_t*>(w);
  const auto asp = static_cast<const float*>(a_scale);
  const auto wsp = static_cast<const float*>(w_scale);
  const auto bp = static_cast<const float*>(bias);
  if (out_dtype == sn::kF32)
    sn::int8_gemm_kernel<float><<<grid, sn::kThreads, 0, s>>>(ap, wp, asp, wsp, bp,
                                                              static_cast<float*>(y), rows, n, k);
  else
    sn::int8_gemm_kernel<sn::bf16><<<grid, sn::kThreads, 0, s>>>(
        ap, wp, asp, wsp, bp, static_cast<sn::bf16*>(y), rows, n, k);
  return cudaGetLastError();
}

}  // extern "C"
