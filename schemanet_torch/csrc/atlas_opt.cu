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
// What bounds it on the card: pure bandwidth. At the training shapes the
// edge weights are [102400, 1024] fp32: 4 reads (p, g, m, v) and 3 writes
// (p, m, v) of 419 MB, ~2.9 GB per call. The design keeps that at the floor:
// one block per row, each thread holds its columns of the updated row in
// registers (C <= kThreads * kMaxPer), the row sum is a block reduction
// (warp shuffles, then one warp over the warp sums), and the projected row is
// written straight from the registers, so every array is read once and
// written once.
#include "common.cuh"

namespace sn {

constexpr int kMaxPer = 16;  // columns per thread: rows up to 4096 wide

struct AdamWArgs {
  float lr, b1, one_minus_b1, b2, one_minus_b2, bc1, bc2, eps, wd;
};

template <typename MT, typename VT>
__global__ void __launch_bounds__(kThreads)
    adamw_project_rows_kernel(float* __restrict__ p, const float* __restrict__ g,
                              MT* __restrict__ m, VT* __restrict__ v, int C, int project,
                              int self_loop_v, AdamWArgs a) {
  __shared__ float warp_sums[kThreads / 32];
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
      const float gi = g[base + c], pi = p[base + c];
      const float mi = a.b1 * Num<MT>::load(m, base + c) + a.one_minus_b1 * gi;
      const float vi = a.b2 * Num<VT>::load(v, base + c) + a.one_minus_b2 * gi * gi;
      Num<MT>::store(m, base + c, mi);
      Num<VT>::store(v, base + c, vi);
      const float upd = (mi * a.bc1) / (sqrtf(vi * a.bc2) + a.eps) + a.wd * pi;
      float x = pi - a.lr * upd;
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
      float s = lane < kThreads / 32 ? warp_sums[lane] : 0.f;
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

template <typename MT, typename VT>
cudaError_t adamw_project_rows_launch(void* p, const void* g, void* m, void* v, long rows, int C,
                                      int project, int self_loop_v, const AdamWArgs& a,
                                      cudaStream_t s) {
  adamw_project_rows_kernel<MT, VT><<<static_cast<unsigned>(rows), kThreads, 0, s>>>(
      static_cast<float*>(p), static_cast<const float*>(g), static_cast<MT*>(m),
      static_cast<VT*>(v), C, project, self_loop_v, a);
  return cudaGetLastError();
}

}  // namespace sn

// p, g: fp32 [rows, C]; m, v: [rows, C] of the types m_dtype, v_dtype (fp32
// or bf16, sn::DType); all contiguous; p, m and v are updated in place.
// self_loop_v > 0 zeroes column (row mod self_loop_v) of every row.
extern "C" int sn_adamw_project_rows(void* p, const void* g, void* m, void* v, int m_dtype,
                                     int v_dtype, long rows, int C, int project, int self_loop_v,
                                     float lr, float b1, float one_minus_b1, float b2,
                                     float one_minus_b2, float bc1, float bc2, float eps,
                                     float wd, void* stream) {
  using sn::bf16;
  if (C > sn::kThreads * sn::kMaxPer) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const sn::AdamWArgs a{lr, b1, one_minus_b1, b2, one_minus_b2, bc1, bc2, eps, wd};
  auto s = static_cast<cudaStream_t>(stream);
  const bool m16 = m_dtype == sn::kBF16, v16 = v_dtype == sn::kBF16;
  if (m16 && v16)
    return sn::adamw_project_rows_launch<bf16, bf16>(p, g, m, v, rows, C, project, self_loop_v, a,
                                                     s);
  if (m16)
    return sn::adamw_project_rows_launch<bf16, float>(p, g, m, v, rows, C, project, self_loop_v, a,
                                                      s);
  if (v16)
    return sn::adamw_project_rows_launch<float, bf16>(p, g, m, v, rows, C, project, self_loop_v, a,
                                                      s);
  return sn::adamw_project_rows_launch<float, float>(p, g, m, v, rows, C, project, self_loop_v, a,
                                                     s);
}
