// Fused LayerNorm with an optional relu, forward and backward, for Hopper
// (sm_90a), on rows of x [rows, d] with fp32 scale and bias [d]:
//   forward:  y = act(xhat * scale + bias),  xhat = (x - mean) * rstd,
//             mean and var = max(E[x^2] - E[x]^2, 0) in fp32 (flax's fast
//             variance), rstd = rsqrt(var + eps), y stored in T;
//   backward: the statistics and y recomputed, g gated by y > 0 for relu,
//             ga = g * scale,
//             dx = rstd * (ga - mean(ga) - xhat * mean(ga * xhat))  in T,
//             dscale = sum over rows of g * xhat, dbias = sum of g  in fp32.
//
// Replaces schemanet_tpu/ops/pallas/layernorm.py fused_layernorm (_ln_kernel
// forward, _ln_bwd_kernel backward). The TPU kernels took blocks of rows
// through VMEM, and the backward added dscale and dbias into one revisited
// output block across its sequential grid. Here one warp owns a row at a
// time (d = 192 is 6 values a lane, d = 256 is 8, held in registers), and
// since Hopper's blocks run in no order the backward's blocks each write an
// fp32 partial of dscale and dbias, which a second launch sums in a fixed
// order: the sums do not depend on the run, and no atomics are used.
//
// What bounds it on the card: bytes. A forward reads x and writes y
// (stage 0, 12,608 x 192 bf16: 9.7 MB, 2.9 us at 3.35 TB/s); a backward
// reads x and g and writes dx. A few dozen operations an element are far
// below the card's rate. Each warp reads its row once into registers, with
// neighbouring lanes on neighbouring elements.
#include "common.cuh"

namespace sn {

constexpr int kLnWarps = kThreads / 32;  // rows in flight in a block
constexpr int kLnBwdBlocks = 264;        // backward blocks at most: two an SM

// The row's statistics from the values a lane holds (columns lane + 32 j).
template <int VPL>
__device__ __forceinline__ void ln_stats(const float (&v)[VPL], int d, float eps, float& mean,
                                         float& rstd) {
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    s += v[j];
    s2 = fmaf(v[j], v[j], s2);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  mean = s / d;
  const float var = fmaxf(s2 / d - mean * mean, 0.f);
  rstd = rsqrtf(var + eps);
}

template <typename T, int VPL>
__device__ __forceinline__ void ln_load_row(const T* p, long base, int d, float (&v)[VPL]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = lane + 32 * j;
    v[j] = c < d ? Num<T>::load(p, base + c) : 0.f;  // zeros add nothing to the sums
  }
}

template <typename T, int VPL>
__global__ void __launch_bounds__(kThreads)
    ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ y, long rows, int d, float eps,
                  int relu) {
  const int lane = threadIdx.x % 32;
  const long stride = (long)gridDim.x * kLnWarps;
  for (long r = blockIdx.x * (long)kLnWarps + threadIdx.x / 32; r < rows; r += stride) {
    const long base = r * d;
    float v[VPL], mean, rstd;
    ln_load_row<T, VPL>(x, base, d, v);
    ln_stats<VPL>(v, d, eps, mean, rstd);
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int c = lane + 32 * j;
      if (c >= d) continue;
      float out = (v[j] - mean) * rstd * scale[c] + bias[c];
      if (relu) out = fmaxf(out, 0.f);
      Num<T>::store(y, base + c, out);
    }
  }
}

// dx for the rows of this block, and the block's fp32 partial of dscale
// (part[blockIdx.x][0:d]) and dbias (part[blockIdx.x][d:2d]).
template <typename T, int VPL>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, const T* __restrict__ g, T* __restrict__ dx,
                  float* __restrict__ part, long rows, int d, float eps, int relu) {
  extern __shared__ float red[];  // [kLnWarps][2 d]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float dscale[VPL], dbias[VPL];
#pragma unroll
  for (int j = 0; j < VPL; ++j) dscale[j] = dbias[j] = 0.f;
  const long stride = (long)gridDim.x * kLnWarps;
  for (long r = blockIdx.x * (long)kLnWarps + warp; r < rows; r += stride) {
    const long base = r * d;
    float v[VPL], gv[VPL], mean, rstd;
    ln_load_row<T, VPL>(x, base, d, v);
    ln_load_row<T, VPL>(g, base, d, gv);
    ln_stats<VPL>(v, d, eps, mean, rstd);
    float s_ga = 0.f, s_gax = 0.f;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int c = lane + 32 * j;
      if (c >= d) continue;
      const float xhat = (v[j] - mean) * rstd;
      if (relu && !(xhat * scale[c] + bias[c] > 0.f)) gv[j] = 0.f;
      const float ga = gv[j] * scale[c];
      s_ga += ga;
      s_gax = fmaf(ga, xhat, s_gax);
      dscale[j] = fmaf(gv[j], xhat, dscale[j]);
      dbias[j] += gv[j];
      v[j] = xhat;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s_ga += __shfl_xor_sync(0xffffffffu, s_ga, o);
      s_gax += __shfl_xor_sync(0xffffffffu, s_gax, o);
    }
    const float m_ga = s_ga / d, m_gax = s_gax / d;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int c = lane + 32 * j;
      if (c >= d) continue;
      Num<T>::store(dx, base + c, rstd * (gv[j] * scale[c] - m_ga - v[j] * m_gax));
    }
  }
  // the warps' partials, summed in warp order
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = lane + 32 * j;
    if (c < d) {
      red[warp * 2 * d + c] = dscale[j];
      red[warp * 2 * d + d + c] = dbias[j];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * d; c += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kLnWarps; ++w) s += red[w * 2 * d + c];
    part[(long)blockIdx.x * 2 * d + c] = s;
  }
}

// out[c] = sum over blocks b, in order, of part[b][c]
__global__ void __launch_bounds__(kThreads)
    ln_param_sum_kernel(const float* __restrict__ part, float* __restrict__ out, int blocks,
                        int n) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= n) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += part[(long)b * n + c];
  out[c] = s;
}

inline int ln_blocks(long rows) {
  const long want = (rows + kLnWarps - 1) / kLnWarps;
  return static_cast<int>(want < 1 ? 1 : (want < 132L * 64 ? want : 132L * 64));
}

inline int ln_bwd_blocks(long rows) {
  const long want = (rows + kLnWarps - 1) / kLnWarps;
  return static_cast<int>(want < 1 ? 1 : (want < kLnBwdBlocks ? want : kLnBwdBlocks));
}

template <typename T, int VPL>
cudaError_t ln_fwd_impl(const void* x, const void* scale, const void* bias, void* y, long rows,
                        int d, float eps, int relu, cudaStream_t stream) {
  if (rows == 0) return cudaSuccess;
  ln_fwd_kernel<T, VPL><<<ln_blocks(rows), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(y), rows, d, eps, relu);
  return cudaGetLastError();
}

template <typename T, int VPL>
cudaError_t ln_bwd_impl(const void* x, const void* scale, const void* bias, const void* g,
                        void* dx, void* part, void* dparam, long rows, int d, float eps,
                        int relu, cudaStream_t stream) {
  const int blocks = ln_bwd_blocks(rows);
  const size_t smem = sizeof(float) * kLnWarps * 2 * d;
  cudaError_t err = allow_smem(ln_bwd_kernel<T, VPL>, smem);
  if (err != cudaSuccess) return err;
  ln_bwd_kernel<T, VPL><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const T*>(g), static_cast<T*>(dx),
      static_cast<float*>(part), rows, d, eps, relu);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_param_sum_kernel<<<(2 * d + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(dparam), blocks, 2 * d);
  return cudaGetLastError();
}

}  // namespace sn

extern "C" {

// The number of backward blocks, so the caller can size the partials.
int sn_layernorm_bwd_blocks(long rows) { return sn::ln_bwd_blocks(rows); }

// y [rows, d] in the storage type of x; d <= 768.
int sn_layernorm_fwd(int dtype, const void* x, const void* scale, const void* bias, void* y,
                     long rows, int d, float eps, int relu, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (d <= 256) {
    if (dtype == sn::kF32)
      return sn::ln_fwd_impl<float, 8>(x, scale, bias, y, rows, d, eps, relu, s);
    return sn::ln_fwd_impl<__nv_bfloat16, 8>(x, scale, bias, y, rows, d, eps, relu, s);
  }
  if (dtype == sn::kF32)
    return sn::ln_fwd_impl<float, 24>(x, scale, bias, y, rows, d, eps, relu, s);
  return sn::ln_fwd_impl<__nv_bfloat16, 24>(x, scale, bias, y, rows, d, eps, relu, s);
}

// dx [rows, d] in the storage type; part fp32 [sn_layernorm_bwd_blocks(rows), 2 d]
// scratch; dparam fp32 [2 d] = (dscale, dbias).
int sn_layernorm_bwd(int dtype, const void* x, const void* scale, const void* bias,
                     const void* g, void* dx, void* part, void* dparam, long rows, int d,
                     float eps, int relu, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (d <= 256) {
    if (dtype == sn::kF32)
      return sn::ln_bwd_impl<float, 8>(x, scale, bias, g, dx, part, dparam, rows, d, eps, relu,
                                       s);
    return sn::ln_bwd_impl<__nv_bfloat16, 8>(x, scale, bias, g, dx, part, dparam, rows, d, eps,
                                             relu, s);
  }
  if (dtype == sn::kF32)
    return sn::ln_bwd_impl<float, 24>(x, scale, bias, g, dx, part, dparam, rows, d, eps, relu,
                                      s);
  return sn::ln_bwd_impl<__nv_bfloat16, 24>(x, scale, bias, g, dx, part, dparam, rows, d, eps,
                                            relu, s);
}

}  // extern "C"
