// Fused AdamW + atlas row projection for Hopper (sm_90a), in place on fp32
// [rows, C] views of the IR-Atlas vertex and edge weights.
//
// Replaces schemanet_tpu/ops/pallas/atlas_opt.py adamw_project_rows. Per
// element, optax.adamw with the bias corrections of the incremented count
// (computed on the host, as the TPU kernel got them through SMEM):
//   m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
//   p' = p - lr ((m bc1) / (sqrt(v bc2) + eps) + wd p)
// then, per row, the projection of project_atlas_params: w = max(p', 0),
// p'' = w / sum(w) with an all-zero row giving 0, and the self-loop column
// (r mod V of row r of a [K*V, V] edge view) zeroed when asked.
//
// Each moment, m and v, is stored in fp32 or, where the group's optimizer
// config asks for bf16 moments (moment_dtype / nu_dtype, as the JAX
// package's adamw_lowmem stores them), in bf16: the update runs in fp32 from
// the stored values and uses this step's fp32 moments; only their storage is
// rounded, to nearest even. bf16 moments cut the call's bytes from 7 to 5
// fp32-sized passes.
//
// What bounds it on the card: bytes. Each element is read once (p, g, m, v)
// and written once (p, m, v): at the CIFAR edge weights [102400, 1024] fp32
// 2.9 GB a call, at the ImageNet ones [500000, 500] with bf16 moments 5.0
// GB. The first design gave each row a block of 256 threads; at 500 columns
// each thread held 2 values, its loads were 4 and 2 bytes wide, and every
// row paid two block barriers between its loads and its stores, so a
// block's short life was mostly latency (47% of the bound). The design:
//
//   * rows up to 1024 wide (every config: V = 500 and 1024): one warp a row
//     (adamw_rows_warp_kernel), 8 rows a block, a grid of rows / 8 blocks.
//     The row sum is a shuffle tree within the warp: no shared memory, no
//     barrier. The blocks start in launch order, so the rows in flight are
//     neighbours in memory.
//   * wide pieces: 4 columns a piece in all four arrays where C % 4 == 0 and
//     the bases allow it (p, g and fp32 moments 16 bytes, bf16 moments 8:
//     at C = 500 a bf16 row is 1,000 bytes, 8-byte aligned, not 16), lane l
//     taking pieces l, l + 32, ...: at C = 500, 125 pieces, <= 4 a lane.
//     Otherwise (C = 70 and the like) one column a piece, the scalar route.
//     atlas_opt.py's adamw_plan chooses, from C and the pointers.
//   * latency: a lane issues all its loads of the row before any use (4
//     pieces of each array at C = 500, 8 at 1024), and the blocks the card
//     holds (3 an SM at C = 500 with bf16 moments, 1 at 1024 in fp32, by
//     their registers) keep 24 or 8 rows in flight an SM. Measured on an
//     H100 SXM at 700 W against this design's 1.65 ms at [500000, 500] with
//     bf16 moments: a persistent grid (warp w taking rows w, w + warps,
//     ...) 1.88 ms (tools/adamw_rows_variants.cu), the same with the warp's
//     next row loaded into registers before this row's sum and stores (two
//     rows in flight a warp) 2.53 ms, with three rows ahead by cp.async
//     into shared memory 2.37 ms: the persistent warps drift apart, and the
//     rows in flight with them.
//   * the projection: w / sum(w) as w (1 / sum), one division a row.
//   * rows of 1025-4096 columns (no config has them) keep the first design,
//     a block of 256 threads a row (adamw_rows_block_kernel).
//
// Each lane updates its elements in place (read once, written once, by the
// same lane), sums its projected values in column order, and the xor tree
// runs in one fixed shape, so a row sums the same on every run.
#include "common.cuh"

namespace sn {

constexpr int kMaxPer = 16;       // columns per thread of the block route: rows up to 4096
constexpr int kWarpMaxC = 1024;   // rows up to this wide take a warp a row
constexpr int kWarpsPerBlock = kThreads / 32;

struct AdamWArgs {
  float lr, b1, one_minus_b1, b2, one_minus_b2, bc1, bc2, eps, wd;
};

// the update of one element: this step's moments (mi, vi) and p'
__device__ __forceinline__ float adamw_one(float pi, float gi, float m0, float v0,
                                           const AdamWArgs& a, float& mi, float& vi) {
  mi = a.b1 * m0 + a.one_minus_b1 * gi;
  vi = a.b2 * v0 + a.one_minus_b2 * gi * gi;
  const float upd = (mi * a.bc1) / (sqrtf(vi * a.bc2) + a.eps) + a.wd * pi;
  return pi - a.lr * upd;
}

// W contiguous values of T as one piece: 4 values (fp32 16 bytes, bf16 8)
// or 1, loaded and stored by one instruction
template <typename T, int W>
struct Piece;

template <>
struct Piece<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ float get(const Raw& r, int k) {
    return k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Piece<bf16, 4> {
  using Raw = uint2;
  static __device__ __forceinline__ Raw load(const bf16* p) {
    return *reinterpret_cast<const uint2*>(p);
  }
  static __device__ __forceinline__ float get(const Raw& r, int k) {
    const uint32_t w = k < 2 ? r.x : r.y;
    return __uint_as_float(k & 1 ? (w & 0xffff0000u) : (w << 16));
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&v)[4]) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  }
};

template <typename T>
struct Piece<T, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(const T* p) { return Num<T>::load(p, 0); }
  static __device__ __forceinline__ float get(const Raw& r, int) { return r; }
  static __device__ __forceinline__ void store(T* p, const float (&v)[1]) {
    Num<T>::store(p, 0, v[0]);
  }
};

// One warp a row (rows up to 32 W PER wide), 8 rows a block; W columns a
// piece, lane l's pieces l, l + 32, ...
template <typename MT, typename VT, int W, int PER>
__global__ void __launch_bounds__(kThreads)
    adamw_rows_warp_kernel(float* __restrict__ p, const float* __restrict__ g,
                           MT* __restrict__ m, VT* __restrict__ v, long rows, int C, int project,
                           int self_loop_v, AdamWArgs a) {
  using PF = Piece<float, W>;
  using PM = Piece<MT, W>;
  using PV = Piece<VT, W>;
  const int lane = threadIdx.x % 32;
  const long row = (long)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;
  const long base = row * C;
  typename PF::Raw rp[PER], rg[PER];
  typename PM::Raw rm[PER];
  typename PV::Raw rv[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {  // every load of the row in flight at once
    const int c = W * (lane + 32 * i);
    if (c < C) {
      rp[i] = PF::load(p + base + c);
      rg[i] = PF::load(g + base + c);
      rm[i] = PM::load(m + base + c);
      rv[i] = PV::load(v + base + c);
    }
  }
  float pn[PER][W];
  float wsum = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = W * (lane + 32 * i);
    if (c >= C) continue;
    float mo[W], vo[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      float x = adamw_one(PF::get(rp[i], k), PF::get(rg[i], k), PM::get(rm[i], k),
                          PV::get(rv[i], k), a, mo[k], vo[k]);
      if (project) {
        x = fmaxf(x, 0.f);
        wsum += x;  // this lane's values in column order
      }
      pn[i][k] = x;
    }
    PM::store(m + base + c, mo);
    PV::store(v + base + c, vo);
  }
  // w / sum(w) as w (1 / sum): one division a row, not one an element
  // (within an ulp of the quotient; the row's sum differs from the plain
  // version's by its order anyway); an all-zero row gives 0
  float inv = 1.f;
  if (project) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) wsum += __shfl_xor_sync(0xffffffffu, wsum, o);
    inv = wsum > 0.f ? 1.f / wsum : 0.f;
  }
  const int diag = self_loop_v > 0 ? static_cast<int>(row % self_loop_v) : -1;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = W * (lane + 32 * i);
    if (c >= C) continue;
    float out[W];
#pragma unroll
    for (int k = 0; k < W; ++k) out[k] = c + k == diag ? 0.f : pn[i][k] * inv;
    PF::store(p + base + c, out);
  }
}

// One block of 256 threads a row, each thread its columns tid, tid + 256,
// ... (rows of 1025-4096 columns): the row sum through shared memory.
template <typename MT, typename VT>
__global__ void __launch_bounds__(kThreads)
    adamw_rows_block_kernel(float* __restrict__ p, const float* __restrict__ g,
                            MT* __restrict__ m, VT* __restrict__ v, int C, int project,
                            int self_loop_v, AdamWArgs a) {
  __shared__ float warp_sums[kWarpsPerBlock];
  __shared__ float row_sum;
  const long row = blockIdx.x;
  const long base = row * C;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float pn[kMaxPer];
  float wsum = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPer; ++i) {
    const int c = tid + i * kThreads;
    pn[i] = 0.f;
    if (c < C) {
      float mi, vi;
      float x = adamw_one(p[base + c], g[base + c], Num<MT>::load(m, base + c),
                          Num<VT>::load(v, base + c), a, mi, vi);
      Num<MT>::store(m, base + c, mi);
      Num<VT>::store(v, base + c, vi);
      if (project) x = fmaxf(x, 0.f);
      pn[i] = x;
      wsum += x;
    }
  }
  float scale = 1.f;
  if (project) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) wsum += __shfl_xor_sync(0xffffffffu, wsum, o);
    if (lane == 0) warp_sums[warp] = wsum;
    __syncthreads();
    if (warp == 0) {
      float s = lane < kWarpsPerBlock ? warp_sums[lane] : 0.f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) row_sum = s;
    }
    __syncthreads();
    scale = row_sum;
  }
  const int diag = self_loop_v > 0 ? static_cast<int>(row % self_loop_v) : -1;
#pragma unroll
  for (int i = 0; i < kMaxPer; ++i) {
    const int c = tid + i * kThreads;
    if (c >= C) continue;
    float x = pn[i];
    if (project) x = scale > 0.f ? x / scale : 0.f;
    if (c == diag) x = 0.f;
    p[base + c] = x;
  }
}

template <typename MT, typename VT, int W, int PER>
cudaError_t adamw_rows_warp(float* p, const float* g, MT* m, VT* v, long rows, int C, int project,
                            int self_loop_v, const AdamWArgs& a, cudaStream_t s) {
  const long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  adamw_rows_warp_kernel<MT, VT, W, PER><<<(unsigned)blocks, kThreads, 0, s>>>(
      p, g, m, v, rows, C, project, self_loop_v, a);
  return cudaGetLastError();
}

// vec: the 4-column pieces (C % 4 == 0, p and g 16-byte aligned, each
// moment 16 bytes where fp32 and 8 where bf16), else one column a piece
template <typename MT, typename VT>
cudaError_t adamw_project_rows_launch(void* pv, const void* gv, void* mv, void* vv, long rows,
                                      int C, int vec, int project, int self_loop_v,
                                      const AdamWArgs& a, cudaStream_t s) {
  auto* p = static_cast<float*>(pv);
  const auto* g = static_cast<const float*>(gv);
  auto* m = static_cast<MT*>(mv);
  auto* v = static_cast<VT*>(vv);
  if (C > kWarpMaxC) {
    adamw_rows_block_kernel<MT, VT><<<static_cast<unsigned>(rows), kThreads, 0, s>>>(
        p, g, m, v, C, project, self_loop_v, a);
    return cudaGetLastError();
  }
  if (vec) {
    const auto aligned = [](const void* q, int bytes) {
      return reinterpret_cast<uintptr_t>(q) % bytes == 0;
    };
    if (C % 4 || !aligned(p, 16) || !aligned(g, 16) || !aligned(m, 4 * sizeof(MT)) ||
        !aligned(v, 4 * sizeof(VT)))
      return cudaErrorInvalidValue;
    if (C <= 4 * 32 * 4)
      return adamw_rows_warp<MT, VT, 4, 4>(p, g, m, v, rows, C, project, self_loop_v, a, s);
    return adamw_rows_warp<MT, VT, 4, 8>(p, g, m, v, rows, C, project, self_loop_v, a, s);
  }
  if (C <= 32 * 16)
    return adamw_rows_warp<MT, VT, 1, 16>(p, g, m, v, rows, C, project, self_loop_v, a, s);
  return adamw_rows_warp<MT, VT, 1, 32>(p, g, m, v, rows, C, project, self_loop_v, a, s);
}

}  // namespace sn

// p, g: fp32 [rows, C]; m, v: [rows, C] of the types m_dtype, v_dtype (fp32
// or bf16, sn::DType); all contiguous; p, m and v are updated in place.
// self_loop_v > 0 zeroes column (row mod self_loop_v) of every row. vec
// takes 4-column pieces (rows up to 1024 wide; see adamw_project_rows_launch).
extern "C" int sn_adamw_project_rows(void* p, const void* g, void* m, void* v, int m_dtype,
                                     int v_dtype, long rows, int C, int vec, int project,
                                     int self_loop_v, float lr, float b1, float one_minus_b1,
                                     float b2, float one_minus_b2, float bc1, float bc2, float eps,
                                     float wd, void* stream) {
  using sn::bf16;
  if (C < 1 || C > sn::kThreads * sn::kMaxPer) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const sn::AdamWArgs a{lr, b1, one_minus_b1, b2, one_minus_b2, bc1, bc2, eps, wd};
  auto s = static_cast<cudaStream_t>(stream);
  const bool m16 = m_dtype == sn::kBF16, v16 = v_dtype == sn::kBF16;
  if (m16 && v16)
    return sn::adamw_project_rows_launch<bf16, bf16>(p, g, m, v, rows, C, vec, project,
                                                     self_loop_v, a, s);
  if (m16)
    return sn::adamw_project_rows_launch<bf16, float>(p, g, m, v, rows, C, vec, project,
                                                      self_loop_v, a, s);
  if (v16)
    return sn::adamw_project_rows_launch<float, bf16>(p, g, m, v, rows, C, vec, project,
                                                      self_loop_v, a, s);
  return sn::adamw_project_rows_launch<float, float>(p, g, m, v, rows, C, vec, project,
                                                     self_loop_v, a, s);
}
