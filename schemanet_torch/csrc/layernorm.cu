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
// output block across its sequential grid. Hopper's blocks run in parallel
// and in no order, so the backward's blocks each write an fp32 partial of
// dscale and dbias, and a second launch sums the partials in a fixed order:
// the sums do not depend on the run, and no atomics are used.
//
// What bounds both on the card: bytes. A forward reads x and writes y
// (stage 0, 12,608 x 192 bf16: 9.7 MB, 2.9 us at 3.35 TB/s); a backward
// reads x and g and writes dx (14.5 MB, 4.3 us; the GNN's class graphs,
// 102,400 x 256 bf16: 157 MB, 47 us). A few dozen operations an element are
// far below the card's rate, so what counts is how many bytes are in flight.
//
// The forward (left as it was: it reaches 62% of its bound) takes one row a
// warp, each lane loading scalars at columns lane + 32 j.
//
// The backward:
//   * Each lane loads and stores 16 bytes at a time (Pack<T, 8 or 4>): a row
//     of 256 bf16 is one warp instruction; a row of 192 bf16 is 24 lanes,
//     and the other 8 lanes of the warp idle on it (packing 4 rows into 3
//     instructions would save a quarter of the load instructions, not
//     bytes, at the cost of cross-lane row statistics). Rows whose width is
//     not a whole number of 16-byte pieces, or whose pointers are not
//     16-byte aligned, take the same kernel with scalar pieces (Pack<T, 1>,
//     the "scalar route"; ops/kernels/encoder_block.py piece_route).
//   * A warp takes R rows at a time (2 where a row is at most two pieces a
//     lane, else 1) and issues all their loads of x and g before it reduces
//     any: 2 R pieces of 16 bytes a lane in flight. The first rows' loads go
//     out before scale and bias are staged in shared memory.
//   * The grid is sized for residency (resident_blocks: as many blocks as
//     the card holds at once, at most kLnBwdMaxBlocks; three blocks or 24
//     warps an SM at the 16-byte kernels' ~75 registers), and each warp
//     walks its rows with a stride, so the partials' count no longer caps the
//     warps in flight. Each lane keeps its own columns' dscale/dbias in
//     registers.
//   * Order of addition, fixed for a given (rows, d) on a given card: each
//     lane adds its rows in ascending order; a block adds its 8 warps in warp
//     order (shared memory) into one partial; ln_param_sum_kernel gives each
//     block of 32 warps 32 columns, each warp a fixed slice of consecutive
//     partials added in order, and adds the 32 slices in slice order. That
//     second launch spreads the sum over 2d / 32 SMs (12 at d = 192). A
//     last-block ticket inside the kernel (two levels, groups of 32 blocks)
//     was measured slower: its __threadfence waits for every block's dx
//     stores, and the forced 85-register cap that went with it spilled.

#include "common.cuh"

namespace sn {

constexpr int kLnWarps = kThreads / 32;   // warps a block
constexpr int kLnBwdMaxBlocks = 1024;     // backward blocks at most: the partials' rows
constexpr int kLnSumWarps = 32;           // warps of a ln_param_sum_kernel block
constexpr int kLnMaxDim = 1024;           // 32 values a lane

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

// Loads the R rows r0 .. r0 + R - 1 of x and g, pieces lane + 32 j of each;
// rows past the end and pieces past the row read as 0 (no memory access),
// which adds nothing to any sum, their g being 0.
template <typename T, int N, int NV, int R>
__device__ __forceinline__ void ln_bwd_load(const T* x, const T* g, long r0, long rows, int d,
                                            int pieces, typename Pack<T, N>::Raw (&xr)[R][NV],
                                            typename Pack<T, N>::Raw (&gr)[R][NV]) {
  using P = Pack<T, N>;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = lane + 32 * j;
      const bool in = r0 + i < rows && v < pieces;
      const long off = (r0 + i) * d + (long)v * N;
      xr[i][j] = in ? P::load(x + off) : P::zero();
      gr[i][j] = in ? P::load(g + off) : P::zero();
    }
}

// dx for the rows of this block, and the block's fp32 partial of dscale
// (part[blockIdx.x][0:d]) and dbias (part[blockIdx.x][d:2d]). Lane l holds
// the pieces l + 32 j (j < NV) of N columns each; a warp takes R rows at a
// time, rows r0 .. r0 + R - 1, and the next R rows gridDim.x * 8 * R later.
template <typename T, int N, int NV, int R>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, const T* __restrict__ g, T* __restrict__ dx,
                  float* __restrict__ part, long rows, int d, float eps, int relu) {
  using P = Pack<T, N>;
  extern __shared__ float smem[];  // scale [d], bias [d], then [kLnWarps][2 d] partials
  float* s_scale = smem;
  float* s_bias = smem + d;
  float* red = smem + 2 * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pieces = d / N;
  const long stride = (long)gridDim.x * kLnWarps * R;
  long r0 = ((long)blockIdx.x * kLnWarps + warp) * R;
  // the first rows' loads go out before scale and bias are staged
  typename P::Raw xr[R][NV], gr[R][NV];
  ln_bwd_load<T, N, NV, R>(x, g, r0, rows, d, pieces, xr, gr);
  for (int c = threadIdx.x; c < d; c += kThreads) {
    s_scale[c] = scale[c];
    s_bias[c] = bias[c];
  }
  __syncthreads();
  float dscale[NV][N], dbias[NV][N];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int k = 0; k < N; ++k) dscale[j][k] = dbias[j][k] = 0.f;

  for (; r0 < rows; r0 += stride) {
    float mean[R], rstd[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float s = 0.f, s2 = 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float v = P::get(xr[i][j], k);
          s += v;
          s2 = fmaf(v, v, s2);
        }
      mean[i] = s;
      rstd[i] = s2;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int i = 0; i < R; ++i) {
        mean[i] += __shfl_xor_sync(0xffffffffu, mean[i], o);
        rstd[i] += __shfl_xor_sync(0xffffffffu, rstd[i], o);
      }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float m = mean[i] / d;
      mean[i] = m;
      rstd[i] = rsqrtf(fmaxf(rstd[i] / d - m * m, 0.f) + eps);
    }
    // the gate, the row sums of ga and ga * xhat, the parameter partials
    float s_ga[R], s_gax[R];
#pragma unroll
    for (int i = 0; i < R; ++i) s_ga[i] = s_gax[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = lane + 32 * j;
      if (v < pieces) {
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int k = 0; k < N; ++k) {
            const float sc = s_scale[v * N + k];
            const float xh = (P::get(xr[i][j], k) - mean[i]) * rstd[i];
            float gv = P::get(gr[i][j], k);
            if (relu && !(xh * sc + s_bias[v * N + k] > 0.f)) gv = 0.f;
            const float ga = gv * sc;
            s_ga[i] += ga;
            s_gax[i] = fmaf(ga, xh, s_gax[i]);
            dscale[j][k] = fmaf(gv, xh, dscale[j][k]);
            dbias[j][k] += gv;
          }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int i = 0; i < R; ++i) {
        s_ga[i] += __shfl_xor_sync(0xffffffffu, s_ga[i], o);
        s_gax[i] += __shfl_xor_sync(0xffffffffu, s_gax[i], o);
      }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float m_ga = s_ga[i] / d, m_gax = s_gax[i] / d;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int v = lane + 32 * j;
        if (r0 + i < rows && v < pieces) {
          float out[N];
#pragma unroll
          for (int k = 0; k < N; ++k) {
            const float sc = s_scale[v * N + k];
            const float xh = (P::get(xr[i][j], k) - mean[i]) * rstd[i];
            float gv = P::get(gr[i][j], k);
            if (relu && !(xh * sc + s_bias[v * N + k] > 0.f)) gv = 0.f;
            out[k] = rstd[i] * (gv * sc - m_ga - xh * m_gax);
          }
          P::store(dx + (r0 + i) * d + (long)v * N, out);
        }
      }
    }
    ln_bwd_load<T, N, NV, R>(x, g, r0 + stride, rows, d, pieces, xr, gr);
  }
  // the warps' partials, summed in warp order
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = lane + 32 * j;
    if (v < pieces) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        red[warp * 2 * d + v * N + k] = dscale[j][k];
        red[warp * 2 * d + d + v * N + k] = dbias[j][k];
      }
    }
  }
  __syncthreads();
  const int n = 2 * d;
  for (int c = threadIdx.x; c < n; c += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kLnWarps; ++w) s += red[w * n + c];
    part[(long)blockIdx.x * n + c] = s;
  }
}

// out[c] = the sum over blocks b of part[b][c]: a block takes 32 columns,
// each of its warps a slice of consecutive partials added in order, then the
// slices in order.
__global__ void __launch_bounds__(kLnSumWarps * 32)
    ln_param_sum_kernel(const float* __restrict__ part, float* __restrict__ out, int blocks,
                        int n) {
  __shared__ float red[kLnSumWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * 32 + lane;
  const int per = (blocks + kLnSumWarps - 1) / kLnSumWarps;
  const int b0 = warp * per, b1 = min(blocks, b0 + per);
  float s = 0.f;
  if (c < n) {
#pragma unroll 8
    for (int b = b0; b < b1; ++b) s += part[(long)b * n + c];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < n) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kLnSumWarps; ++w) t += red[w][lane];
    out[c] = t;
  }
}

inline int ln_blocks(long rows) {
  const long want = (rows + kLnWarps - 1) / kLnWarps;
  return static_cast<int>(want < 1 ? 1 : (want < 132L * 64 ? want : 132L * 64));
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

// The backward's grid: groups of 8 R rows spread evenly over at most as many
// blocks as the card holds at once (and kLnBwdMaxBlocks), so every block
// walks the same number of groups, give or take one.
template <typename T, int N, int NV, int R>
cudaError_t ln_bwd_impl(const void* x, const void* scale, const void* bias, const void* g,
                        void* dx, void* part, void* dparam, long rows, int d,
                        float eps, int relu, cudaStream_t stream) {
  auto kernel = ln_bwd_kernel<T, N, NV, R>;
  const size_t smem = sizeof(float) * (2 * d + kLnWarps * 2 * d);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  long cap = resident_blocks(kernel, kThreads, smem);
  cap = cap < kLnBwdMaxBlocks ? cap : kLnBwdMaxBlocks;
  const long groups = rows > 0 ? (rows + kLnWarps * R - 1) / (kLnWarps * R) : 1;
  const long walks = (groups + cap - 1) / cap;
  const int blocks = static_cast<int>((groups + walks - 1) / walks);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const T*>(g), static_cast<T*>(dx),
      static_cast<float*>(part), rows, d, eps, relu);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_param_sum_kernel<<<(2 * d + 31) / 32, kLnSumWarps * 32, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(dparam), blocks, 2 * d);
  return cudaGetLastError();
}

// 16-byte pieces: NV pieces a lane, R rows a warp at a time
template <typename T>
cudaError_t ln_bwd_vec(const void* x, const void* scale, const void* bias, const void* g,
                       void* dx, void* part, void* dparam, long rows, int d,
                       float eps, int relu, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  const int lanes = d / N;  // pieces a row
  if (lanes <= 32)
    return ln_bwd_impl<T, N, 1, 2>(x, scale, bias, g, dx, part, dparam, rows, d,
                                   eps, relu, stream);
  if (lanes <= 64)
    return ln_bwd_impl<T, N, 2, 2>(x, scale, bias, g, dx, part, dparam, rows, d,
                                   eps, relu, stream);
  if (lanes <= 96)
    return ln_bwd_impl<T, N, 3, 1>(x, scale, bias, g, dx, part, dparam, rows, d,
                                   eps, relu, stream);
  if (lanes <= 128)  // bf16 up to 1024 (the ImageNet GNN), fp32 up to 512
    return ln_bwd_impl<T, N, 4, 1>(x, scale, bias, g, dx, part, dparam, rows, d,
                                   eps, relu, stream);
  if (lanes <= 192)
    return ln_bwd_impl<T, N, 6, 1>(x, scale, bias, g, dx, part, dparam, rows, d,
                                   eps, relu, stream);
  return ln_bwd_impl<T, N, 8, 1>(x, scale, bias, g, dx, part, dparam, rows, d,
                                 eps, relu, stream);
}

// scalar pieces (the scalar route): up to 8, 24 or 32 columns a lane
template <typename T>
cudaError_t ln_bwd_scalar(const void* x, const void* scale, const void* bias, const void* g,
                          void* dx, void* part, void* dparam, long rows, int d,
                          float eps, int relu, cudaStream_t stream) {
  if (d <= 256)
    return ln_bwd_impl<T, 1, 8, 1>(x, scale, bias, g, dx, part, dparam, rows, d,
                                   eps, relu, stream);
  if (d <= 768)
    return ln_bwd_impl<T, 1, 24, 1>(x, scale, bias, g, dx, part, dparam, rows, d,
                                    eps, relu, stream);
  return ln_bwd_impl<T, 1, 32, 1>(x, scale, bias, g, dx, part, dparam, rows, d,
                                  eps, relu, stream);
}

}  // namespace sn

extern "C" {

// y [rows, d] in the storage type of x; d <= 1024.
int sn_layernorm_fwd(int dtype, const void* x, const void* scale, const void* bias, void* y,
                     long rows, int d, float eps, int relu, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d > sn::kLnMaxDim) return cudaErrorInvalidValue;
  if (d <= 256) {
    if (dtype == sn::kF32)
      return sn::ln_fwd_impl<float, 8>(x, scale, bias, y, rows, d, eps, relu, s);
    return sn::ln_fwd_impl<__nv_bfloat16, 8>(x, scale, bias, y, rows, d, eps, relu, s);
  }
  if (d > 768) {  // the ImageNet GNN's 1024
    if (dtype == sn::kF32)
      return sn::ln_fwd_impl<float, 32>(x, scale, bias, y, rows, d, eps, relu, s);
    return sn::ln_fwd_impl<__nv_bfloat16, 32>(x, scale, bias, y, rows, d, eps, relu, s);
  }
  if (dtype == sn::kF32)
    return sn::ln_fwd_impl<float, 24>(x, scale, bias, y, rows, d, eps, relu, s);
  return sn::ln_fwd_impl<__nv_bfloat16, 24>(x, scale, bias, y, rows, d, eps, relu, s);
}

// dx [rows, d] in the storage type, d <= 1024; part fp32 scratch of
// min(ceil(rows / 8), 1024) rows of 2 d (a block has at least one row);
// dparam fp32 [2 d] = (dscale, dbias). vec = 1 takes 16-byte pieces: d * sizeof(T) a multiple of
// 16 and x, g, dx 16-byte aligned, else cudaErrorInvalidValue; vec = 0 the
// scalar route.
int sn_layernorm_bwd(int dtype, int vec, const void* x, const void* scale, const void* bias,
                     const void* g, void* dx, void* part, void* dparam, long rows,
                     int d, float eps, int relu, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d > sn::kLnMaxDim) return cudaErrorInvalidValue;
  if (vec) {
    const int bytes = dtype == sn::kF32 ? 4 : 2;
    const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16; };
    if ((d * bytes) % 16 || misaligned(x) || misaligned(g) || misaligned(dx))
      return cudaErrorInvalidValue;
    if (dtype == sn::kF32)
      return sn::ln_bwd_vec<float>(x, scale, bias, g, dx, part, dparam, rows, d, eps,
                                   relu, s);
    return sn::ln_bwd_vec<__nv_bfloat16>(x, scale, bias, g, dx, part, dparam, rows, d,
                                         eps, relu, s);
  }
  if (dtype == sn::kF32)
    return sn::ln_bwd_scalar<float>(x, scale, bias, g, dx, part, dparam, rows, d, eps,
                                    relu, s);
  return sn::ln_bwd_scalar<__nv_bfloat16>(x, scale, bias, g, dx, part, dparam, rows, d,
                                          eps, relu, s);
}

}  // extern "C"
