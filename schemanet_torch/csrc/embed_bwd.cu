// Embedding-table gradient for Hopper (sm_90a):
//   out[m, :] = sum of g[r, :] over the rows r with ids[r] == m, in fp32.
//
// Replaces schemanet_tpu/ops/pallas/embed_bwd.py embed_grad. On the TPU one
// program kept the whole fp32 [M+1, Db] table block in VMEM and added the
// rows one after another (the grid runs in order there). Hopper's blocks run
// in parallel and in no order, so the sum is taken per table row instead: the
// wrapper sorts the ids once per call with a stable sort (torch.sort, which
// also gives the rows in that order), and block (m, column chunk) finds the
// segment of id m in the sorted ids by two binary searches and adds its rows
// in row order, in fp32, rounded once. That is the TPU kernel's order of
// addition, and it is the same on every run: no atomics. Every table row is
// written (an id no row takes gets 0), so the table needs no zeroing.
//
// What bounds it on the card: bytes. At the training shapes it reads 102,400
// x 256 (class graphs) or 12,544 x 256 (instance graphs) cotangent rows once
// and writes a [1025, 256] fp32 table. Threads of a block take neighbouring
// columns of one row, so every load is coalesced; the rows of a segment are
// loaded kUnroll at a time ahead of their in-order adds. The longest segment
// (the padding id of the instance graphs, a few thousand rows) sets the
// kernel's length.
//
// Ids outside [0, num_rows) are rejected by the wrapper; no segment takes
// them, so the kernel never reads them into the table.
#include "common.cuh"

namespace sn {

constexpr int kEmbedThreads = 128;  // columns a block
constexpr int kUnroll = 8;

// first position in sorted[0, rows) whose id is >= key
__device__ __forceinline__ long lower_bound(const int* sorted, long rows, int key) {
  long lo = 0, hi = rows;
  while (lo < hi) {
    const long mid = (lo + hi) >> 1;
    if (sorted[mid] < key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(kEmbedThreads)
    embed_grad_kernel(const int* __restrict__ sorted_ids, const long* __restrict__ order,
                      const T* __restrict__ g, float* __restrict__ out, long rows, int D) {
  __shared__ long seg[2];
  const int m = blockIdx.x;
  if (threadIdx.x < 2) seg[threadIdx.x] = lower_bound(sorted_ids, rows, m + threadIdx.x);
  __syncthreads();
  const long s0 = seg[0], s1 = seg[1];
  const int c = blockIdx.y * kEmbedThreads + threadIdx.x;
  if (c >= D) return;
  float acc = 0.f;
  long s = s0;
  for (; s + kUnroll <= s1; s += kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = Num<T>::load(g, order[s + u] * D + c);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc += v[u];  // in row order
  }
  for (; s < s1; ++s) acc += Num<T>::load(g, order[s] * D + c);
  out[(long)m * D + c] = acc;
}

template <typename T>
cudaError_t embed_grad_impl(const void* sorted_ids, const void* order, const void* g, void* out,
                            long rows, int D, int num_rows, cudaStream_t stream) {
  if (num_rows <= 0 || D <= 0) return cudaSuccess;
  dim3 grid(num_rows, (D + kEmbedThreads - 1) / kEmbedThreads);
  embed_grad_kernel<T><<<grid, kEmbedThreads, 0, stream>>>(
      static_cast<const int*>(sorted_ids), static_cast<const long*>(order),
      static_cast<const T*>(g), static_cast<float*>(out), rows, D);
  return cudaGetLastError();
}

}  // namespace sn

// sorted_ids: the int32 ids sorted ascending by a stable sort; order: int64,
// the row of g at each sorted position; out: fp32 [num_rows, D].
extern "C" int sn_embed_grad(int dtype, const void* sorted_ids, const void* order, const void* g,
                             void* out, long rows, int D, int num_rows, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == sn::kF32)
    return sn::embed_grad_impl<float>(sorted_ids, order, g, out, rows, D, num_rows, s);
  return sn::embed_grad_impl<__nv_bfloat16>(sorted_ids, order, g, out, rows, D, num_rows, s);
}
