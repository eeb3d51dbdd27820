// GraphConv forward for Hopper (sm_90a): out[b] = ((E[b] + E[b]^T)/2 + I) f[b].
//
// Replaces schemanet_tpu/ops/pallas/graphconv.py sym_conv (_fwd_kernel, the
// forward of the custom VJP). The TPU kernel formed the whole [V, V] E_sym of
// one graph in VMEM; here E_sym is never materialised anywhere: each block
// computes a 64 x 64 tile of out[b] and builds the [64, 32] E_sym tile it
// needs while loading, from tile (i, k) of E and the transposed tile (k, i),
// both read along rows (coalesced).
//
// What bounds it on the card: the serving class graphs are
// [100, 1024, 1024] x [100, 1024, 256], ~54 GFLOP per GNN layer against
// ~260 MB (bf16), so it is compute-bound; the instance graphs
// ([64, 196, 196] x [64, 196, 256]) are small. Products are fp32 FMA on
// shared-memory tiles: right first. Tensor-core (wgmma) tiles are later work.
//
// Rounding follows the TPU kernel: e_ij + e_ji rounded to T, times 0.5,
// plus the identity rounded to T, then an fp32-accumulated product rounded
// once to T. The backward (_sym_conv_bwd) is training work and not here.
#include "common.cuh"

namespace sn {

constexpr int kBM = 64, kBN = 64, kKC = 32, kTM = 4, kTN = 4;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sym_conv_kernel(const T* __restrict__ e, const T* __restrict__ f, T* __restrict__ out, int V,
                    int D) {
  __shared__ float ed[kBM][kKC + 1];   // E[i][k] tile
  __shared__ float et[kKC][kBM + 1];   // E[k][i] tile (the transpose's source)
  __shared__ float as[kKC][kBM + 1];   // E_sym[i][k], stored k-major
  __shared__ float bs[kKC][kBN + 1];   // f[k][n]
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const long g = blockIdx.z;
  const T* eg = e + g * V * (long)V;
  const T* fg = f + g * V * (long)D;
  constexpr int TX = kBN / kTN;
  const int tx = tid % TX, ty = tid / TX;
  float acc[kTM][kTN] = {};

  for (int k0 = 0; k0 < V; k0 += kKC) {
    __syncthreads();
    for (int idx = tid; idx < kBM * kKC; idx += kThreads) {
      const int i = idx / kKC, kk = idx % kKC;  // along a row of E
      const int r = m0 + i, c = k0 + kk;
      ed[i][kk] = (r < V && c < V) ? Num<T>::load(eg, (long)r * V + c) : 0.f;
    }
    for (int idx = tid; idx < kKC * kBM; idx += kThreads) {
      const int kk = idx / kBM, i = idx % kBM;  // along a row of E, transposed tile
      const int r = k0 + kk, c = m0 + i;
      et[kk][i] = (r < V && c < V) ? Num<T>::load(eg, (long)r * V + c) : 0.f;
    }
    for (int idx = tid; idx < kKC * kBN; idx += kThreads) {
      const int kk = idx / kBN, nn = idx % kBN;
      const int r = k0 + kk, c = n0 + nn;
      bs[kk][nn] = (r < V && c < D) ? Num<T>::load(fg, (long)r * D + c) : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < kKC * kBM; idx += kThreads) {
      const int kk = idx / kBM, i = idx % kBM;
      const float s = Num<T>::round(ed[i][kk] + et[kk][i]);
      const float eye = (m0 + i == k0 + kk) ? 1.f : 0.f;
      as[kk][i] = Num<T>::round(Num<T>::round(0.5f * s) + eye);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kKC; ++kk) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = as[kk][ty * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = bs[kk][tx * kTN + j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  T* og = out + g * V * (long)D;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = m0 + ty * kTM + i;
    if (r >= V) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = n0 + tx * kTN + j;
      if (c < D) Num<T>::store(og, (long)r * D + c, acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t sym_conv_impl(const void* e, const void* f, void* out, int K, int V, int D,
                          cudaStream_t stream) {
  dim3 grid((D + kBN - 1) / kBN, (V + kBM - 1) / kBM, K);
  sym_conv_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(e), static_cast<const T*>(f), static_cast<T*>(out), V, D);
  return cudaGetLastError();
}

}  // namespace sn

extern "C" int sn_sym_conv(int dtype, const void* e, const void* f, void* out, int K, int V,
                           int D, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == sn::kF32) return sn::sym_conv_impl<float>(e, f, out, K, V, D, s);
  return sn::sym_conv_impl<__nv_bfloat16>(e, f, out, K, V, D, s);
}
