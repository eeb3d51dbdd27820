// Nearest-code assignment with a streaming argmin on Hopper's tensor cores
// (sm_90a):
//   ids[n] = argmin_m (||c_m||^2 - 2 x_n . c_m),  first minimum on ties,
// for x [N, d] and a codebook [M, d] in one storage type T, scores in fp32.
//
// Replaces schemanet_tpu/ops/pallas/vq.py vq_assign_pallas. The TPU kernel
// tiled N x M on the MXU and carried the running (min, argmin) of each row
// in VMEM across the sequential M grid axis. Hopper's blocks run in parallel
// and in no order, so the code axis is cut into S segments: block (row tile,
// segment) streams its segment's code tiles in ascending order and keeps each
// row's running (min, argmin) in registers. The [N, M] score matrix never
// reaches device memory.
//
// What bounds it on the card: 2 N M d operations against N d + M d inputs,
// so operations. Two routes by the storage type (ops/kernels/vq.py vq_route):
//   * fp32: the reference scores at Precision.HIGHEST, and one TF32 product
//     (10-bit mantissa) would move ids far past the near-ties the checks
//     allow. So the 3xTF32 split: x = x_hi + x_lo with x_hi = tf32(x),
//     x_lo = tf32(x - x_hi), the same for c, done once per element while the
//     tile is staged; each k step adds x_lo c_hi, then x_hi c_lo, then
//     x_hi c_hi into one fp32 accumulator by mma.sync m16n8k8 .tf32, and
//     drops x_lo c_lo: about fp32's accuracy at three TF32 products per fp32
//     product (3 x 2 N M d over 494.7 TFLOP/s dense TF32 is the bound).
//   * bf16: mma.sync m16n8k16, fp32 accumulated. The products of bf16 values
//     are exact in fp32, so only the order of the sum differs.
// A block of 8 warps takes 64 rows x 128 codes, each warp 32 x 32, over k in
// chunks of 128 bytes a row (32 fp32 or 64 bf16). The next chunk's 16-byte
// loads are in flight in registers while the current one is multiplied; they
// are split (fp32) and stored into the other of two shared-memory stages.
// Fragments come by ldmatrix: an 8 x 16-byte matrix gives lane l the 32-bit
// word (l / 4, l % 4), which is the TF32 m16n8k8 A and B layout, so the bf16
// fragment loaders of common.cuh serve both types (pitch and k in bf16
// units). The squared norms of a code tile are summed from the fp32 values
// (bf16 widened) as they are staged, and reduced by shuffles: no pre-pass.
// The codebook (0.79 MB at 1024 x 192 fp32) stays in L2 across row tiles.
//
// Epilogue on the C fragments, in registers: s = ||c||^2 - 2 acc; each thread
// scans its codes in ascending order and a later code must be strictly
// smaller; the lanes and warps that share a row then reduce
// lexicographically on (score, id). With S > 1 each block writes a (score,
// id) partial per row; the last block of a row tile to finish (a ticket taken
// by an atomic after a __threadfence) reduces the S partials
// lexicographically and writes the ids, so the result does not depend on
// which block finishes last, and it resets its ticket to 0 for the next call.
// Codes and rows past the end are zero in shared memory and never win.
#include "common.cuh"

namespace sn {

constexpr int kVqRows = 64, kVqCodes = 128;  // block tile: rows x codes
constexpr int kVqVecs = 8;                   // 16-byte vectors of a row in a chunk
constexpr int kVqXLoads = kVqRows * kVqVecs / kThreads;   // 2 a thread
constexpr int kVqCLoads = kVqCodes * kVqVecs / kThreads;  // 4 a thread

template <typename T>
struct VqTile;
template <>
struct VqTile<float> {  // planes: tf32 hi, tf32 lo
  static constexpr int kChunk = 32, kPitch = 36, kPlanes = 2;
};
template <>
struct VqTile<bf16> {
  static constexpr int kChunk = 64, kPitch = 72, kPlanes = 1;
};

template <typename T>
struct VqSmem {
  using Tile = VqTile<T>;
  static constexpr int kX = kVqRows * Tile::kPitch;   // one plane of x
  static constexpr int kC = kVqCodes * Tile::kPitch;  // one plane of the codes
  static constexpr int kStage = Tile::kPlanes * (kX + kC);
  static constexpr size_t kBytes = sizeof(T) * 2 * kStage + sizeof(float) * 2 * kVqCodes;
};

__device__ __forceinline__ bool vq_better(float s, int i, float best, int besti) {
  return s < best || (s == best && i < besti);
}

// sum of squares of the 16 bytes v of T, widened to fp32
template <typename T>
__device__ __forceinline__ float sq16(const uint4& v) {
  if constexpr (sizeof(T) == 4) {
    const float4 f = *reinterpret_cast<const float4*>(&v);
    return fmaf(f.x, f.x, fmaf(f.y, f.y, fmaf(f.z, f.z, f.w * f.w)));
  } else {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = unpack_bf16(w[i]);
      s = fmaf(f.x, f.x, fmaf(f.y, f.y, s));
    }
    return s;
  }
}

// the 16 bytes v into row r, vector q of a stage's planes (fp32: split)
template <typename T>
__device__ __forceinline__ void vq_put(T* plane, int plane_size, int r, int q, const uint4& v) {
  constexpr int P = VqTile<T>::kPitch, E = 16 / sizeof(T);
  if constexpr (sizeof(T) == 4) {
    uint4 hi, lo;
    tf32_split4(*reinterpret_cast<const float4*>(&v), hi, lo);
    *reinterpret_cast<uint4*>(plane + r * P + q * E) = hi;
    *reinterpret_cast<uint4*>(plane + plane_size + r * P + q * E) = lo;
  } else {
    *reinterpret_cast<uint4*>(plane + r * P + q * E) = v;
  }
}

// acc += the chunk's x tile (rows 32 wr..) times the code tile (codes 32 wc..)
template <typename T>
__device__ __forceinline__ void vq_chunk_mma(float (&acc)[2][4][4], const T* stage, int wr, int wc,
                                             int lane) {
  using S = VqSmem<T>;
  constexpr int P = VqTile<T>::kPitch;
  const bf16* xs = reinterpret_cast<const bf16*>(stage);
  const bf16* cs = reinterpret_cast<const bf16*>(stage + VqTile<T>::kPlanes * S::kX);
  if constexpr (sizeof(T) == 4) {
    // fp32 planes read as bf16 pairs: pitch and k in 2-byte units
    const bf16* xs_lo = xs + 2 * S::kX;
    const bf16* cs_lo = cs + 2 * S::kC;
#pragma unroll
    for (int ks = 0; ks < VqTile<T>::kChunk / 8; ++ks) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        ldsm_a(ah[mt], xs, 2 * P, wr * 32 + mt * 16, ks * 16, lane);
        ldsm_a(al[mt], xs_lo, 2 * P, wr * 32 + mt * 16, ks * 16, lane);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bh[4], bl[4];
        ldsm_b_nk(bh, cs, 2 * P, wc * 32 + np * 16, ks * 16, lane);
        ldsm_b_nk(bl, cs_lo, 2 * P, wc * 32 + np * 16, ks * 16, lane);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            mma1688_split(acc[mt][2 * np + h], ah[mt], al[mt], bh[2 * h], bh[2 * h + 1],
                          bl[2 * h], bl[2 * h + 1]);
          }
      }
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < VqTile<T>::kChunk / 16; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) ldsm_a(a[mt], xs, P, wr * 32 + mt * 16, ks * 16, lane);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        ldsm_b_nk(b, cs, P, wc * 32 + np * 16, ks * 16, lane);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma16816(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma16816(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
}

// grid (row tiles, segments); segment s covers code tiles [s * tps, (s+1) * tps).
// part: S partial (score) rows of N, then S partial (id) rows of N; tickets:
// one int a row tile, 0 between calls. Both unused when gridDim.y == 1.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    vq_tc_kernel(const T* __restrict__ x, const T* __restrict__ cb, int* __restrict__ tickets,
                 float* __restrict__ part, int* __restrict__ ids, int N, int M, int d, int tps) {
  using S = VqSmem<T>;
  constexpr int E = 16 / sizeof(T), KC = VqTile<T>::kChunk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stages = reinterpret_cast<T*>(smem_raw);
  float* cnorm = reinterpret_cast<float*>(stages + 2 * S::kStage);  // [2][128]
  __shared__ int last_block;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp >> 2, wc = warp & 3;  // rows 32 wr.., codes 32 wc..
  const int q = tid % kVqVecs, r0 = tid / kVqVecs;  // a thread's vector and first row
  const long row0 = (long)blockIdx.x * kVqRows;
  const int m_lo = blockIdx.y * tps * kVqCodes, m_hi = min(M, m_lo + tps * kVqCodes);
  const int kchunks = (d + KC - 1) / KC;
  const int total = ((m_hi - m_lo + kVqCodes - 1) / kVqCodes) * kchunks;

  uint4 xv[kVqXLoads], cv[kVqCLoads];
  float nsum[kVqCLoads] = {};
  auto load = [&](int c) {
    const int m0 = m_lo + (c / kchunks) * kVqCodes, col = (c % kchunks) * KC + q * E;
#pragma unroll
    for (int j = 0; j < kVqXLoads; ++j) {
      const long row = row0 + r0 + j * (kThreads / kVqVecs);
      xv[j] = row < N && col < d ? __ldg(reinterpret_cast<const uint4*>(x + row * d + col))
                                 : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < kVqCLoads; ++j) {
      const int code = m0 + r0 + j * (kThreads / kVqVecs);
      cv[j] = code < m_hi && col < d
                  ? __ldg(reinterpret_cast<const uint4*>(cb + (long)code * d + col))
                  : make_uint4(0, 0, 0, 0);
    }
  };
  // the loaded chunk c into its stage; at the tile's last chunk, its norms
  auto store = [&](int c) {
    T* st = stages + (c & 1) * S::kStage;
    T* cs = st + VqTile<T>::kPlanes * S::kX;
#pragma unroll
    for (int j = 0; j < kVqXLoads; ++j) vq_put<T>(st, S::kX, r0 + j * (kThreads / kVqVecs), q, xv[j]);
#pragma unroll
    for (int j = 0; j < kVqCLoads; ++j) {
      vq_put<T>(cs, S::kC, r0 + j * (kThreads / kVqVecs), q, cv[j]);
      nsum[j] += sq16<T>(cv[j]);
    }
    if (c % kchunks == kchunks - 1) {
      float* cn = cnorm + ((c / kchunks) & 1) * kVqCodes;
#pragma unroll
      for (int j = 0; j < kVqCLoads; ++j) {
        float s = nsum[j];
#pragma unroll
        for (int o = 1; o < kVqVecs; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (q == 0) cn[r0 + j * (kThreads / kVqVecs)] = s;
        nsum[j] = 0.f;
      }
    }
  };

  float best[4];
  int besti[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best[i] = INFINITY;
    besti[i] = m_lo;
  }
  float acc[2][4][4] = {};
  if (total > 0) {
    load(0);
    store(0);
  }
  __syncthreads();
  for (int c = 0; c < total; ++c) {
    const bool more = c + 1 < total;
    if (more) load(c + 1);  // in flight while the tensor cores work
    vq_chunk_mma<T>(acc, stages + (c & 1) * S::kStage, wr, wc, lane);
    if (c % kchunks == kchunks - 1) {
      // the tile's scores against the running minimum, codes in ascending order
      const int t = c / kchunks, m0 = m_lo + t * kVqCodes;
      const float* cn = cnorm + (t & 1) * kVqCodes;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int cc = wc * 32 + nt * 8 + (lane & 3) * 2 + e;
              const float s = cn[cc] - 2.f * acc[mt][nt][half * 2 + e];
              const int i = mt * 2 + half;
              if (m0 + cc < m_hi && s < best[i]) {
                best[i] = s;
                besti[i] = m0 + cc;
              }
            }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
    if (more) store(c + 1);
    __syncthreads();
  }

  // the 4 lanes of a row (lane % 4), then the 4 warps of a row block (wc)
  float* red_s = reinterpret_cast<float*>(smem_raw);  // [4][64], over the stages
  int* red_i = reinterpret_cast<int*>(red_s + 4 * kVqRows);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float s = __shfl_xor_sync(0xffffffffu, best[i], o);
      const int id = __shfl_xor_sync(0xffffffffu, besti[i], o);
      if (vq_better(s, id, best[i], besti[i])) {
        best[i] = s;
        besti[i] = id;
      }
    }
    const int r = wr * 32 + (i >> 1) * 16 + (lane >> 2) + (i & 1) * 8;
    if ((lane & 3) == 0) {
      red_s[wc * kVqRows + r] = best[i];
      red_i[wc * kVqRows + r] = besti[i];
    }
  }
  __syncthreads();
  const long row = row0 + tid;
  float bs = INFINITY;
  int bi = m_lo;
  if (tid < kVqRows) {
#pragma unroll
    for (int w = 0; w < 4; ++w)
      if (vq_better(red_s[w * kVqRows + tid], red_i[w * kVqRows + tid], bs, bi)) {
        bs = red_s[w * kVqRows + tid];
        bi = red_i[w * kVqRows + tid];
      }
  }
  const int segs = gridDim.y;
  if (segs == 1) {
    if (tid < kVqRows && row < N) ids[row] = bi;
    return;
  }
  if (tid < kVqRows && row < N) {
    part[(long)blockIdx.y * N + row] = bs;
    reinterpret_cast<int*>(part + (long)segs * N)[(long)blockIdx.y * N + row] = bi;
  }
  __threadfence();  // the partials reach L2 before the ticket is taken
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(&tickets[blockIdx.x], 1) == segs - 1;
  __syncthreads();
  if (!last_block) return;
  if (tid < kVqRows && row < N) {
    const int* part_i = reinterpret_cast<const int*>(part + (long)segs * N);
    bs = INFINITY;
    for (int s = 0; s < segs; ++s) {  // L2 reads: another block wrote them
      const float v = __ldcg(part + (long)s * N + row);
      const int id = __ldcg(part_i + (long)s * N + row);
      if (s == 0 || vq_better(v, id, bs, bi)) {
        bs = v;
        bi = id;
      }
    }
    ids[row] = bi;
  }
  if (tid == 0) tickets[blockIdx.x] = 0;
}

template <typename T>
cudaError_t vq_assign_impl(const void* x, const void* cb, void* tickets, void* part, void* ids,
                           int N, int M, int d, int S, cudaStream_t stream) {
  if (N == 0) return cudaSuccess;
  if (d <= 0 || d % 8 || M <= 0 || S <= 0) return cudaErrorInvalidValue;
  // segments of whole code tiles
  const int tiles = (M + kVqCodes - 1) / kVqCodes;
  const int tps = (tiles + S - 1) / S;
  const int segs = (tiles + tps - 1) / tps;
  if (segs > 1 && (tickets == nullptr || part == nullptr)) return cudaErrorInvalidValue;
  const size_t bytes = VqSmem<T>::kBytes;
  cudaError_t err = allow_smem(vq_tc_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kVqRows - 1) / kVqRows, segs);
  vq_tc_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(cb), static_cast<int*>(tickets),
      static_cast<float*>(part), static_cast<int*>(ids), N, M, d, tps);
  return cudaGetLastError();
}

}  // namespace sn

// x [N, d], cb [M, d] in one dtype (d a multiple of 8, both 16-byte
// aligned); ids int32 [N]. S is the number of code segments the wrapper
// sized its scratch for (the launcher uses ceil(tiles / ceil(tiles / S)) <= S
// of them, tiles = ceil(M / 128)). With more than one: tickets, int32
// [ceil(N / 64)], zero before the first call (each call leaves it zero);
// part, 8 S N bytes (fp32 scores, then int32 ids). Both may be null for one.
extern "C" int sn_vq_assign(int dtype, const void* x, const void* cb, void* tickets, void* part,
                            void* ids, int N, int M, int d, int S, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == sn::kF32)
    return sn::vq_assign_impl<float>(x, cb, tickets, part, ids, N, M, d, S, s);
  return sn::vq_assign_impl<sn::bf16>(x, cb, tickets, part, ids, N, M, d, S, s);
}
