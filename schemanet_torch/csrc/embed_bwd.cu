// Embedding-table gradient for Hopper (sm_90a):
//   out[m, :] = sum of g[r, :] over the rows r with ids[r] == m, in fp32,
// into a [num_rows, D] fp32 table; an id no row takes gets 0.
//
// Replaces schemanet_tpu/ops/pallas/embed_bwd.py embed_grad. On the TPU one
// program kept the whole fp32 [M+1, Db] table block in VMEM and added the
// rows one after another (the grid runs in order there). Hopper's blocks run
// in parallel and in no order, so the rows are put in id order first: the
// wrapper sorts the ids with a stable sort (torch.sort, which also gives
// `order`, the row of each sorted position), and embed_offsets_kernel writes
// each id's first sorted position, offsets[m], in one pass over the sorted
// ids ([num_rows + 1]; offsets[num_rows] = rows). For a fixed id buffer
// (the class graphs' class_ingredients) the sort, the offsets and the range
// check are done once and kept as a plan (ops/kernels/embed_bwd.py).
//
// What bounds it on the card: bytes. It reads 102,400 x 256 (class graphs)
// or 12,544 x 256 (instance graphs) cotangent rows once and writes a
// [1025, 256] fp32 table: 53.5 MB (16 us at 3.35 TB/s) and 7.5 MB (2.2 us)
// in bf16.
//
// embed_chunk_kernel cuts the sorted positions into chunks of kEmbedChunk
// (32), one warp a chunk, whatever the ids: a segment of thousands of rows
// (the instance graphs' padding id) spreads over as many warps as it has
// chunks. A warp loads its chunk's `order` and ids in one coalesced load a
// lane, then gathers the rows kEmbedInFlight (8) at a time, each lane 16
// bytes of a row (Pack<T, 8 or 4>; a 512-byte bf16 row of D = 256 is one
// warp instruction), and adds each id's rows in sorted order, which is row
// order. A run of an id that lies wholly inside the chunk is written to the
// table directly. An id whose segment crosses a chunk edge gets one fp32
// partial per chunk it touches: the chunk's first run goes to slot 0 of the
// chunk's two partial rows, its last run to slot 1.
//
// embed_combine_kernel then writes 0 for every id no row takes and adds the
// partials of every id that crossed a chunk edge, in a fixed order. An id
// spanning at most 8 chunks takes one block, whose warp w adds chunk ca + w;
// the warps' sums are added in warp order. An id spanning more (the
// instance graphs' padding id spans ~100-200 chunks) is summed by
// ceil(D / 32) more blocks of the same launch, each 32 columns wide, whose 8
// warps add slices of consecutive chunks in chunk order, the slices then in
// slice order: no block walks a long segment alone. The order of addition
// depends only on the sorted ids, so every run gives the same bits, and no
// atomics are used.
//
// Rows of D not a multiple of 16 bytes, or a g not 16-byte aligned, take the
// same kernel with scalar pieces (the "scalar route"). Ids outside [0,
// num_rows) are rejected by the wrapper before any gather; the offsets pass
// clamps them so that it never writes out of bounds.
#include "common.cuh"

namespace sn {

constexpr int kEmbedChunk = 32;    // sorted positions a warp: one a lane
constexpr int kEmbedInFlight = 8;  // rows a warp gathers before it adds them
constexpr int kEmbedWarps = kThreads / 32;
constexpr int kCombineCols = 256;  // columns of one pass of embed_combine_kernel

// offsets[m] = the first sorted position whose id is >= m, m in [0, num_rows]
__global__ void __launch_bounds__(kThreads)
    embed_offsets_kernel(const int* __restrict__ sorted_ids, long rows, int num_rows,
                         int* __restrict__ offsets) {
  for (long p = blockIdx.x * (long)kThreads + threadIdx.x; p <= rows;
       p += (long)gridDim.x * kThreads) {
    const int lo = p > 0 ? max(sorted_ids[p - 1] + 1, 0) : 0;
    const int hi = p < rows ? min(sorted_ids[p], num_rows) : num_rows;
    for (int m = lo; m <= hi; ++m) offsets[m] = static_cast<int>(p);
  }
}

template <int N>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 4)
      *reinterpret_cast<float4*>(p + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) p[k] = v[k];
  }
}

// Warp (blockIdx.x * 8 + warp) takes the sorted positions [s0, s0 + 32),
// lane l the columns [t0 + l N, t0 + l N + N) with t0 = blockIdx.y * 32 N.
// part: [chunks][2][D] fp32, written only for runs that cross a chunk edge.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    embed_chunk_kernel(const int* __restrict__ sorted_ids, const long* __restrict__ order,
                       const T* __restrict__ g, float* __restrict__ out,
                       float* __restrict__ part, long rows, int D) {
  using P = Pack<T, N>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long chunk = (long)blockIdx.x * kEmbedWarps + warp;
  const long s0 = chunk * kEmbedChunk;
  if (s0 >= rows) return;
  const int count = static_cast<int>(min((long)kEmbedChunk, rows - s0));
  const long s1 = s0 + count;
  const int col = blockIdx.y * 32 * N + lane * N;
  const bool active = col < D;  // D is a multiple of N
  // the ids beside the chunk, to tell whether a run at an edge goes on there
  const int before = s0 > 0 ? sorted_ids[s0 - 1] : -1;
  const int after = s1 < rows ? sorted_ids[s1] : -1;
  const long my_row = lane < count ? order[s0 + lane] : 0;
  const int my_id = lane < count ? sorted_ids[s0 + lane] : -1;

  float acc[N];
#pragma unroll
  for (int k = 0; k < N; ++k) acc[k] = 0.f;
  int cur = __shfl_sync(0xffffffffu, my_id, 0);
  int run_start = 0;  // position of the current run's first row in the chunk
  // writes the run [run_start, end) of id `cur` and clears acc
  auto emit = [&](int end) {
    const bool head_inside = run_start > 0 || cur != before;
    const bool tail_inside = end < count || cur != after;
    float* dst = head_inside && tail_inside
                     ? out + (long)cur * D
                     : part + (chunk * 2 + (run_start == 0 ? 0 : 1)) * (long)D;
    if (active) store_f32<N>(dst + col, acc);
#pragma unroll
    for (int k = 0; k < N; ++k) acc[k] = 0.f;
  };
  for (int q = 0; q < count; q += kEmbedInFlight) {
    typename P::Raw raw[kEmbedInFlight];
    int id[kEmbedInFlight];
#pragma unroll
    for (int u = 0; u < kEmbedInFlight; ++u) {
      const long row = __shfl_sync(0xffffffffu, my_row, q + u);
      id[u] = __shfl_sync(0xffffffffu, my_id, q + u);
      raw[u] = active && q + u < count ? P::load(g + row * D + col) : P::zero();
    }
#pragma unroll
    for (int u = 0; u < kEmbedInFlight; ++u) {
      if (q + u < count) {
        if (id[u] != cur) {
          emit(q + u);
          cur = id[u];
          run_start = q + u;
        }
#pragma unroll
        for (int k = 0; k < N; ++k) acc[k] += P::get(raw[u], k);  // in sorted order
      }
    }
  }
  emit(count);
}

// The slot of chunk c's partial of an id whose segment starts at position a
// and whose first chunk is ca: in ca the id's run is the chunk's last run
// (slot 1) unless the segment starts on the chunk's edge; in every later
// chunk it is the first run (slot 0).
__device__ __forceinline__ long combine_row(int c, int ca, int a) {
  return (long)c * 2 + (c == ca && a != ca * kEmbedChunk ? 1 : 0);
}

// Blocks m < num_rows: out[m] = 0 where no row takes m; where m's segment
// crosses a chunk edge but spans at most 8 chunks, warp w adds chunk ca + w
// and the warps' sums are added in warp order. Blocks num_rows + t: columns
// [32 t, 32 t + 32) of every id that spans more than 8 chunks, each warp a
// slice of consecutive chunks added in order, the slices in slice order.
__global__ void __launch_bounds__(kThreads)
    embed_combine_kernel(const int* __restrict__ offsets, const float* __restrict__ part,
                         float* __restrict__ out, int num_rows, int D) {
  __shared__ float red[kEmbedWarps][kCombineCols];
  __shared__ int longs[kThreads];
  __shared__ int n_long;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (blockIdx.x < num_rows) {
    const int m = blockIdx.x;
    const int a = offsets[m], b = offsets[m + 1];
    float* dst = out + (long)m * D;
    if (a == b) {
      for (int c = threadIdx.x; c < D; c += kThreads) dst[c] = 0.f;
      return;
    }
    const int ca = a / kEmbedChunk, cb = (b - 1) / kEmbedChunk;
    // one chunk: written whole by embed_chunk_kernel; more than 8: the long path
    if (ca == cb || cb - ca + 1 > kEmbedWarps) return;
    const int c = ca + warp;
    const float* src = part + combine_row(c, ca, a) * D;
    for (int t0 = 0; t0 < D; t0 += kCombineCols) {
#pragma unroll
      for (int k = 0; k < kCombineCols / 32; ++k) {
        const int j = t0 + lane + 32 * k;
        red[warp][lane + 32 * k] = c <= cb && j < D ? src[j] : 0.f;
      }
      __syncthreads();
      if (threadIdx.x < kCombineCols && t0 + threadIdx.x < D) {
        float t = 0.f;
#pragma unroll
        for (int w = 0; w < kEmbedWarps; ++w) t += red[w][threadIdx.x];
        dst[t0 + threadIdx.x] = t;
      }
      __syncthreads();
    }
    return;
  }
  const int col = (blockIdx.x - num_rows) * 32 + lane;
  for (int base = 0; base < num_rows; base += kThreads) {
    if (threadIdx.x == 0) n_long = 0;
    __syncthreads();
    const int m = base + threadIdx.x;
    if (m < num_rows) {
      const int a = offsets[m], b = offsets[m + 1];
      if (a < b && (b - 1) / kEmbedChunk - a / kEmbedChunk + 1 > kEmbedWarps)
        longs[atomicAdd(&n_long, 1)] = m;  // the list's order does not enter any sum
    }
    __syncthreads();
    for (int i = 0; i < n_long; ++i) {
      const int id = longs[i];
      const int a = offsets[id], b = offsets[id + 1];
      const int ca = a / kEmbedChunk, cb = (b - 1) / kEmbedChunk;
      const int per = (cb - ca + 1 + kEmbedWarps - 1) / kEmbedWarps;
      const int c0 = ca + warp * per, c1 = min(cb + 1, c0 + per);
      float s = 0.f;
      if (col < D) {
#pragma unroll 8
        for (int c = c0; c < c1; ++c) s += part[combine_row(c, ca, a) * D + col];
      }
      red[warp][lane] = s;
      __syncthreads();
      if (warp == 0 && col < D) {
        float t = 0.f;
#pragma unroll
        for (int w = 0; w < kEmbedWarps; ++w) t += red[w][lane];
        out[(long)id * D + col] = t;
      }
      __syncthreads();
    }
    __syncthreads();  // every thread has read n_long before the next round resets it
  }
}

template <typename T, int N>
cudaError_t embed_grad_impl(const int* sorted_ids, const long* order, const int* offsets,
                            const T* g, float* out, float* part, long rows, int D,
                            int num_rows, cudaStream_t stream) {
  if (rows > 0) {
    const long chunks = (rows + kEmbedChunk - 1) / kEmbedChunk;
    dim3 grid((chunks + kEmbedWarps - 1) / kEmbedWarps, (D + 32 * N - 1) / (32 * N));
    embed_chunk_kernel<T, N><<<grid, kThreads, 0, stream>>>(sorted_ids, order, g, out, part,
                                                            rows, D);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  embed_combine_kernel<<<num_rows + (D + 31) / 32, kThreads, 0, stream>>>(offsets, part, out,
                                                                         num_rows, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t embed_grad_route(int vec, const void* sorted_ids, const void* order,
                             const void* offsets, const void* g, void* out, void* part, long rows,
                             int D, int num_rows, cudaStream_t stream) {
  auto ids = static_cast<const int*>(sorted_ids);
  auto ord = static_cast<const long*>(order);
  auto off = static_cast<const int*>(offsets);
  auto gp = static_cast<const T*>(g);
  auto o = static_cast<float*>(out);
  auto p = static_cast<float*>(part);
  if (vec) {
    constexpr int N = 16 / sizeof(T);
    if (D % N || reinterpret_cast<uintptr_t>(g) % 16) return cudaErrorInvalidValue;
    return embed_grad_impl<T, N>(ids, ord, off, gp, o, p, rows, D, num_rows, stream);
  }
  return embed_grad_impl<T, 1>(ids, ord, off, gp, o, p, rows, D, num_rows, stream);
}

}  // namespace sn

extern "C" {

// offsets int32 [num_rows + 1] of the stably sorted int32 ids [rows].
int sn_embed_offsets(const void* sorted_ids, void* offsets, long rows, int num_rows,
                     void* stream) {
  if (num_rows <= 0) return cudaErrorInvalidValue;
  const long want = (rows + 1 + sn::kThreads - 1) / sn::kThreads;
  const int blocks = static_cast<int>(want < 1024 ? want : 1024);
  sn::embed_offsets_kernel<<<blocks, sn::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(sorted_ids), rows, num_rows, static_cast<int*>(offsets));
  return cudaGetLastError();
}

// sorted_ids: the int32 ids sorted ascending by a stable sort; order: int64,
// the row of g at each sorted position; offsets: sn_embed_offsets' output;
// out: fp32 [num_rows, D]; part: fp32 [2 ceil(rows / 32), D] scratch. vec = 1
// takes 16-byte pieces of g (D a multiple of 8 in bf16, of 4 in fp32, g
// 16-byte aligned, else cudaErrorInvalidValue), vec = 0 scalar pieces.
int sn_embed_grad(int dtype, int vec, const void* sorted_ids, const void* order,
                  const void* offsets, const void* g, void* out, void* part, long rows, int D,
                  int num_rows, void* stream) {
  if (num_rows <= 0 || D <= 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == sn::kF32)
    return sn::embed_grad_route<float>(vec, sorted_ids, order, offsets, g, out, part, rows, D,
                                       num_rows, s);
  return sn::embed_grad_route<__nv_bfloat16>(vec, sorted_ids, order, offsets, g, out, part,
                                             rows, D, num_rows, s);
}

}  // extern "C"
