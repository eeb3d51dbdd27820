// Embedding-table gradient for Hopper (sm_90a):
//   out[m, :] += g[r, :] for every row r with ids[r] == m, accumulated in fp32.
//
// Replaces schemanet_tpu/ops/pallas/embed_bwd.py embed_grad. On the TPU one
// program kept the whole fp32 [M+1, Db] table block in VMEM and added the
// rows one after another (the grid runs in order there). Hopper's blocks run
// in parallel and in no order, so the sum across rows is an fp32 atomicAdd
// per element into the zeroed table in device memory (the wrapper zeroes it).
// Duplicate ids therefore add in a run-dependent order: the result equals
// the serial sum up to fp32 summation order.
//
// What bounds it on the card: at the training shapes it reads 102,400 x 256
// (class graphs) or 12,544 x 256 (instance graphs) cotangent rows once and
// adds into a [1025, 256] fp32 table (1 MB, resident in L2): memory and
// atomic throughput bound, no arithmetic to speak of. Threads of a warp take
// neighbouring columns of one row, so the loads are coalesced and the
// atomics of a warp hit one contiguous 128-byte stretch of the table.
//
// Out-of-range ids are rejected by the wrapper; the kernel also skips them,
// so it never writes outside the table.
#include "common.cuh"

namespace sn {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    embed_grad_kernel(const int* __restrict__ ids, const T* __restrict__ g,
                      float* __restrict__ out, long rows, int D, int num_rows) {
  const long total = rows * D;
  const long stride = (long)gridDim.x * kThreads;
  for (long idx = blockIdx.x * (long)kThreads + threadIdx.x; idx < total; idx += stride) {
    const long r = idx / D;
    const int c = static_cast<int>(idx - r * D);
    const int id = ids[r];
    if (id < 0 || id >= num_rows) continue;
    atomicAdd(out + (long)id * D + c, Num<T>::load(g, idx));
  }
}

template <typename T>
cudaError_t embed_grad_impl(const void* ids, const void* g, void* out, long rows, int D,
                            int num_rows, cudaStream_t stream) {
  const long total = rows * D;
  // enough blocks for every SM several times over; the loop takes the rest
  const long blocks = (total + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < 132L * 32 ? (blocks > 0 ? blocks : 1) : 132L * 32);
  embed_grad_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const int*>(ids), static_cast<const T*>(g), static_cast<float*>(out), rows, D,
      num_rows);
  return cudaGetLastError();
}

}  // namespace sn

extern "C" int sn_embed_grad(int dtype, const void* ids, const void* g, void* out, long rows,
                             int D, int num_rows, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == sn::kF32) return sn::embed_grad_impl<float>(ids, g, out, rows, D, num_rows, s);
  return sn::embed_grad_impl<__nv_bfloat16>(ids, g, out, rows, D, num_rows, s);
}
