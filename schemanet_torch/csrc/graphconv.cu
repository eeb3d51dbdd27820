// GraphConv for Hopper (sm_90a): out[b] = ((E[b] + E[b]^T)/2 + I) f[b], and
// its backward.
//
// Replaces schemanet_tpu/ops/pallas/graphconv.py sym_conv (_fwd_kernel, the
// forward of the custom VJP) and _sym_conv_bwd (_bwd_kernel). The TPU kernels
// formed the whole [V, V] E_sym of one graph in VMEM; here E_sym is never
// materialised in device memory: each block computes one tile of out[b] and
// builds the E_sym tile it needs from tile (i, k) of E and the transposed
// tile (k, i), both read along rows (coalesced).
//
// Rounding follows the TPU kernels: e_ij + e_ji rounded to T, times 0.5,
// plus the identity rounded to T, then an fp32-accumulated product rounded
// once to T. The backward:
//
// * df = E_sym^T g = E_sym g by symmetry: the forward with g in place of f
//   (same E_sym tiles, same roundings);
// * dE = (t + t^T)/2 with t = g f^T. Tile (i, j) of dE needs rows i and j of
//   both g and f, so it is computed as ONE product [g_i | f_i] . [f_j | g_j]^T
//   over K = 2D: the fp32 accumulator holds t_ij + t_ji directly, and neither
//   t nor its transpose is ever written. It is halved in fp32 and rounded
//   once to T, as the TPU kernel rounds.
//
// What bounds it on the card: bytes. The class graphs of the stage-4 step
// are [100, 1024, 1024] x [100, 1024, 256] bf16: the forward reads E and f
// and writes out, 262 MB, 0.078 ms at 3.35 TB/s, against 54 GFLOP, 0.054 ms
// at the bf16 tensor-core peak; the backward reads E, f, g and writes df and
// dE, ~0.5 GB. So the products must run on the tensor cores, and E must be
// read from device memory about once (the tiles of one graph that read the
// same rows of E run together and meet in L2).
//
// Two routes, chosen by the storage type (ops/kernels/graphconv.py
// conv_route says which, and raises on what neither takes):
//
// * bf16, any V, D a multiple of 8: tensor cores (mma.sync m16n8k16, bf16
//   in, fp32 accumulated), 256 threads a block, a 128 x 128 output tile, k in
//   steps of 32 double-buffered by cp.async. Shared-memory rows are padded by
//   16 bytes so the 8 rows an ldmatrix reads fall on distinct banks.
//   - forward (and df), one block per (128 rows, 128 columns of D, graph):
//     each k step stages E[i0:+128, k0:+32], E[k0:+32, i0:+128] and
//     f[k0:+32, n0:+128]. Each warp then forms 16 rows x 32 k of the E_sym
//     tile: ldmatrix gives the fragment of E, ldmatrix.trans of the (k, i)
//     tile the fragment of E^T in the same layout, the roundings above run
//     on the pairs in registers, the identity falls where the fragment's
//     row equals its column (lane t holds rows t/4 and t/4 + 8 and columns
//     2 (t % 4), +1 of each 8 x 8 matrix), and stmatrix writes the tile
//     back. Then the 8 warps (4 x 2, 32 x 64 each) take the product, f by
//     ldmatrix.trans. E's rows are 16-byte aligned only when V % 8 == 0, so
//     E is copied in chunks of the widest of 8, 4, 2 or 1 elements that
//     divides V (cp.async of 16, 8 or 4 bytes; plain loads for odd V);
//     chunks past V are zero. f's rows (D % 8 == 0) always take 16 bytes.
//   - dE, one block per (128 x 128 tile with j-block >= i-block, graph):
//     dE is symmetric, so only the upper triangle of tiles is computed
//     (36 of 64 at V = 1024). Both operands are K-contiguous rows, mma's
//     row.col layout, fed by ldmatrix without .trans. The tile, halved and
//     rounded, goes through shared memory and is written twice, as itself
//     and transposed, so both stores run along rows; in the diagonal tiles
//     the lower triangle is the mirror of the upper. dE is exactly
//     symmetric, like the plain version's 0.5 (t + t^T).
//   Measured on an H100, both kernels run at 120-150 TFLOP/s, ~4x behind
//   cuBLAS on a pre-formed E_sym. A k step loads 24 KB from L2 for 1 MFLOP
//   in the forward (E in both orientations) and 16 KB in dE, but neither a
//   third cp.async stage nor a 128 x 256 forward tile (E read half as often)
//   lifted them: the next step is Hopper's own pipeline (TMA loads, wgmma,
//   warp-specialised producers), not a retuned tile.
//
// * fp32: FMA on fp32 shared-memory tiles (64 x 64 a block, 4 x 4 a
//   thread). Tensor cores would mean TF32 and lose the 1e-4 agreement the
//   fp32 checks hold; the configs' graph dtype is bf16.
#include "common.cuh"

namespace sn {

// ---------------------------------------------------------------------------
// fp32 route: FMA on fp32 shared-memory tiles
// ---------------------------------------------------------------------------
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

// de[b] = 0.5 (g[b] f[b]^T + f[b] g[b]^T), one kBM x kBN tile per block.
// A operand row i = [g_i | f_i], B operand row j = [f_j | g_j], K = 2D; both
// are read along rows of f and g (coalesced) into k-major shared tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    sym_conv_de_kernel(const T* __restrict__ f, const T* __restrict__ g, T* __restrict__ de,
                       int V, int D) {
  __shared__ float as[kKC][kBM + 1];
  __shared__ float bs[kKC][kBN + 1];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const long b = blockIdx.z;
  const T* fb = f + b * V * (long)D;
  const T* gb = g + b * V * (long)D;
  constexpr int TX = kBN / kTN;
  const int tx = tid % TX, ty = tid / TX;
  const int K2 = 2 * D;
  float acc[kTM][kTN] = {};

  for (int k0 = 0; k0 < K2; k0 += kKC) {
    __syncthreads();
    for (int idx = tid; idx < kBM * kKC; idx += kThreads) {
      const int i = idx / kKC, kk = idx % kKC;
      const int r = m0 + i, k = k0 + kk;
      float a = 0.f;
      if (r < V && k < K2)
        a = k < D ? Num<T>::load(gb, (long)r * D + k) : Num<T>::load(fb, (long)r * D + k - D);
      as[kk][i] = a;
    }
    for (int idx = tid; idx < kBN * kKC; idx += kThreads) {
      const int j = idx / kKC, kk = idx % kKC;
      const int c = n0 + j, k = k0 + kk;
      float x = 0.f;
      if (c < V && k < K2)
        x = k < D ? Num<T>::load(fb, (long)c * D + k) : Num<T>::load(gb, (long)c * D + k - D);
      bs[kk][j] = x;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kKC; ++kk) {
      float a[kTM], x[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = as[kk][ty * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) x[j] = bs[kk][tx * kTN + j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], x[j], acc[i][j]);
    }
  }
  T* db = de + b * V * (long)V;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = m0 + ty * kTM + i;
    if (r >= V) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = n0 + tx * kTN + j;
      if (c < V) Num<T>::store(db, (long)r * V + c, 0.5f * acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t sym_conv_bwd_impl(const void* e, const void* f, const void* g, void* df, void* de,
                              int K, int V, int D, cudaStream_t stream) {
  cudaError_t err = sym_conv_impl<T>(e, g, df, K, V, D, stream);  // df = E_sym g
  if (err != cudaSuccess || de == nullptr) return err;
  dim3 grid((V + kBN - 1) / kBN, (V + kBM - 1) / kBM, K);
  sym_conv_de_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(f), static_cast<const T*>(g), static_cast<T*>(de), V, D);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores (mma, ldmatrix, stmatrix, cp.async in common.cuh)
// ---------------------------------------------------------------------------
constexpr int kTile = 128;               // rows and columns of a block's output tile
constexpr int kStep = 32;                // k a step
constexpr int kPitchK = kStep + 8;       // bf16 a row of a [rows][k] tile (80 bytes)
constexpr int kPitchR = kTile + 8;       // bf16 a row of a [k][rows] or [rows][rows] tile
constexpr int kRowsK = kTile * kPitchK;  // bf16 of a [128][k] tile
constexpr int kKRows = kStep * kPitchR;  // bf16 of a [k][128] tile
// forward: per stage E (i, k), E (k, i) and f (k, n); then the E_sym tile
constexpr int kConvStage = kRowsK + 2 * kKRows;
constexpr size_t kConvSmem = sizeof(bf16) * (2 * kConvStage + kRowsK);
// dE: per stage [g|f] rows i and [f|g] rows j; the output tile reuses them
constexpr int kDeStage = 2 * kRowsK;
constexpr size_t kDeSmem = sizeof(bf16) * 2 * kDeStage;
static_assert(kTile * kPitchR <= 2 * kDeStage, "the dE output tile fits the stage buffers");

// VEC bf16 (VEC * 2 bytes, aligned) from src to shared memory, or zeros
template <int VEC>
__device__ __forceinline__ void copy_chunk(bf16* dst, const bf16* src, bool in) {
  if constexpr (VEC == 8) {
    cp_async16(dst, src, in ? 16 : 0);
  } else if constexpr (VEC == 1) {
    *dst = in ? *src : __float2bfloat16(0.f);
  } else {
    cp_async_ca<2 * VEC>(dst, src, in ? 2 * VEC : 0);
  }
}

// E[m0:+128, k0:+32] into ed ([128][kPitchK]) and E[k0:+32, m0:+128] into et
// ([32][kPitchR]), in chunks of VEC (V % VEC == 0, so a chunk is in or out
// whole); out-of-range chunks are zero
template <int VEC>
__device__ __forceinline__ void stage_e(const bf16* eg, int V, int m0, int k0, bf16* ed,
                                        bf16* et) {
  constexpr int kChunksK = kStep / VEC, kChunksM = kTile / VEC;
  for (int idx = threadIdx.x; idx < kTile * kChunksK; idx += kThreads) {
    const int r = idx / kChunksK, c = (idx % kChunksK) * VEC;
    const int row = m0 + r, col = k0 + c;
    const bool in = row < V && col < V;
    copy_chunk<VEC>(ed + r * kPitchK + c, in ? eg + (long)row * V + col : eg, in);
  }
  for (int idx = threadIdx.x; idx < kStep * kChunksM; idx += kThreads) {
    const int r = idx / kChunksM, c = (idx % kChunksM) * VEC;
    const int row = k0 + r, col = m0 + c;
    const bool in = row < V && col < V;
    copy_chunk<VEC>(et + r * kPitchR + c, in ? eg + (long)row * V + col : eg, in);
  }
}

// f[k0:+32, n0:+128] into fs ([32][kPitchR]) in 16-byte chunks (D % 8 == 0)
__device__ __forceinline__ void stage_f(const bf16* fg, int V, int D, int k0, int n0, bf16* fs) {
  constexpr int kChunks = kTile / 8;
  for (int idx = threadIdx.x; idx < kStep * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    const int row = k0 + r, col = n0 + c;
    const bool in = row < V && col < D;
    cp_async16(fs + r * kPitchR + c, in ? fg + (long)row * D + col : fg, in ? 16 : 0);
  }
}

// The E_sym tile of this k step, E_sym[m0 + i][k0 + k] for i < 128, k < 32,
// into as ([128][kPitchK]): warp w forms rows [16w, 16w + 16) in registers.
__device__ __forceinline__ void form_esym(const bf16* ed, const bf16* et, int m0, int k0,
                                          bf16* as) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int cb = 0; cb < kStep / 16; ++cb) {
    uint32_t x[4], y[4];
    // matrix q of both: rows 16w + 8 (q & 1), columns 16 cb + 8 (q >> 1)
    ldsm_x4(x, ed + (warp * 16 + (lane & 15)) * kPitchK + cb * 16 + (lane >> 4) * 8);
    ldsm_x4_trans(y, et + (cb * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * kPitchR + warp * 16 +
                         ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = m0 + warp * 16 + (q & 1) * 8 + (lane >> 2);
      const int k = k0 + cb * 16 + (q >> 1) * 8 + (lane & 3) * 2;
      const float2 a = unpack_bf16(x[q]), b = unpack_bf16(y[q]);
      const float2 s = unpack_bf16(pack_bf16(a.x + b.x, a.y + b.y));
      const float2 h = unpack_bf16(pack_bf16(0.5f * s.x, 0.5f * s.y));
      x[q] = pack_bf16(h.x + (i == k ? 1.f : 0.f), h.y + (i == k + 1 ? 1.f : 0.f));
    }
    stsm_x4(as + (warp * 16 + (lane & 15)) * kPitchK + cb * 16 + (lane >> 4) * 8, x);
  }
}

// acc (warp's 32 rows x 64 columns, 2 x 8 C fragments) += A (rows of a
// [128][kPitchK] tile) times B over this k step. B_KMAJOR: B is a [32][kPitchR]
// tile, k-major (read by ldmatrix.trans); else a [128][kPitchK] tile of
// K-contiguous rows (read by ldmatrix).
template <bool B_KMAJOR>
__device__ __forceinline__ void mma_step(float (&acc)[2][8][4], const bf16* a_tile,
                                         const bf16* b_tile, int wm, int wn, int lane) {
#pragma unroll
  for (int kk = 0; kk < kStep / 16; ++kk) {
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldsm_x4(a[mt], a_tile + (wm * 32 + mt * 16 + (lane & 15)) * kPitchK + kk * 16 +
                         (lane >> 4) * 8);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {  // 16 columns each
      uint32_t b[4];
      const int n = wn * 64 + nt * 16;
      if constexpr (B_KMAJOR)
        ldsm_x4_trans(b, b_tile + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kPitchR + n +
                             (lane >> 4) * 8);
      else
        ldsm_x4(b, b_tile + (n + (lane & 7) + (lane >> 4) * 8) * kPitchK + kk * 16 +
                       ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma16816(acc[mt][2 * nt], a[mt], b[0], b[1]);
        mma16816(acc[mt][2 * nt + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads, 2)
    sym_conv_tc_kernel(const bf16* __restrict__ e, const bf16* __restrict__ f,
                       bf16* __restrict__ out, int V, int D) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  bf16* as = smem + 2 * kConvStage;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int n0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile;
  const long gi = blockIdx.z;
  const bf16* eg = e + gi * V * (long)V;
  const bf16* fg = f + gi * V * (long)D;
  auto stage = [&](int t) { return smem + (t & 1) * kConvStage; };
  float acc[2][8][4] = {};

  const int steps = (V + kStep - 1) / kStep;
  stage_e<VEC>(eg, V, m0, 0, stage(0), stage(0) + kRowsK);
  stage_f(fg, V, D, 0, n0, stage(0) + kRowsK + kKRows);
  cp_async_commit();
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // step t landed; every warp is past step t - 1's product
    if (t + 1 < steps) {
      bf16* next = stage(t + 1);
      stage_e<VEC>(eg, V, m0, (t + 1) * kStep, next, next + kRowsK);
      stage_f(fg, V, D, (t + 1) * kStep, n0, next + kRowsK + kKRows);
      cp_async_commit();
    }
    const bf16* cur = stage(t);
    form_esym(cur, cur + kRowsK, m0, t * kStep, as);
    __syncthreads();
    mma_step<true>(acc, as, cur + kRowsK + kKRows, wm, wn, lane);
  }
  bf16* og = out + gi * V * (long)D;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 32 + mt * 16 + (lane >> 2) + h * 8;
        const int col = n0 + wn * 64 + nt * 8 + (lane & 3) * 2;
        if (row < V && col < D)  // D % 8 == 0: the pair is in whole
          *reinterpret_cast<uint32_t*>(og + (long)row * D + col) =
              pack_bf16(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
}

// [g|f] rows r0.. into a ([128][kPitchK]) and [f|g] rows c0.. into b, k0:+32
// of K = 2D, 16-byte chunks (D % 8 == 0: a chunk lies in g or in f whole)
__device__ __forceinline__ void stage_gf(const bf16* fb, const bf16* gb, int V, int D, int r0,
                                         int c0, int k0, bf16* a, bf16* b) {
  constexpr int kChunks = kStep / 8;
  for (int idx = threadIdx.x; idx < 2 * kTile * kChunks; idx += kThreads) {
    const int which = idx / (kTile * kChunks), rest = idx % (kTile * kChunks);
    const int r = rest / kChunks, c = (rest % kChunks) * 8;
    const int row = (which ? c0 : r0) + r, k = k0 + c;
    const bool in = row < V && k < 2 * D;
    const bf16* lo = which ? fb : gb;  // k < D
    const bf16* hi = which ? gb : fb;  // k >= D
    const bf16* src = !in ? gb : k < D ? lo + (long)row * D + k : hi + (long)row * D + k - D;
    cp_async16((which ? b : a) + r * kPitchK + c, src, in ? 16 : 0);
  }
}

// rows row0.. of de, columns col0.. (128 x 128, clipped at V), from the tile
// ([128][kPitchR], element (i, j) at i * kPitchR + j): element (r, c) of the
// output is tile[c][r] where `transposed` (or, in a diagonal tile, c < r),
// else tile[r][c]. Chunks of VEC along rows (V % VEC == 0).
template <int VEC>
__device__ __forceinline__ void store_de(bf16* db, int V, int row0, int col0, const bf16* tile,
                                         bool transposed, bool diag) {
  struct alignas(2 * VEC) Chunk { bf16 v[VEC]; };
  constexpr int kChunks = kTile / VEC;
  for (int idx = threadIdx.x; idx < kTile * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * VEC;
    const int row = row0 + r, col = col0 + c;
    if (row >= V || col >= V) continue;
    Chunk chunk;
#pragma unroll
    for (int u = 0; u < VEC; ++u) {
      const int j = c + u;
      chunk.v[u] = (transposed || (diag && j < r)) ? tile[j * kPitchR + r] : tile[r * kPitchR + j];
    }
    *reinterpret_cast<Chunk*>(db + (long)row * V + col) = chunk;
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads, 2)
    sym_conv_de_tc_kernel(const bf16* __restrict__ f, const bf16* __restrict__ g,
                          bf16* __restrict__ de, int V, int D) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  // tile pair p -> (bi, bj), bj >= bi, row by row of the upper triangle
  const int nb = (V + kTile - 1) / kTile;
  int p = blockIdx.x, bi = 0;
  while (p >= nb - bi) {  // row bi of the triangle holds nb - bi tiles
    p -= nb - bi;
    ++bi;
  }
  const int bj = bi + p;
  const int r0 = bi * kTile, c0 = bj * kTile;
  const long b = blockIdx.y;
  const bf16* fb = f + b * V * (long)D;
  const bf16* gb = g + b * V * (long)D;
  auto stage = [&](int t) { return smem + (t & 1) * kDeStage; };
  float acc[2][8][4] = {};

  const int steps = (2 * D + kStep - 1) / kStep;
  stage_gf(fb, gb, V, D, r0, c0, 0, stage(0), stage(0) + kRowsK);
  cp_async_commit();
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < steps) {
      bf16* next = stage(t + 1);
      stage_gf(fb, gb, V, D, r0, c0, (t + 1) * kStep, next, next + kRowsK);
      cp_async_commit();
    }
    const bf16* cur = stage(t);
    mma_step<false>(acc, cur, cur + kRowsK, wm, wn, lane);
  }
  __syncthreads();  // every warp is done with the stage buffers
  bf16* tile = smem;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = wm * 32 + mt * 16 + (lane >> 2) + h * 8;
        const int j = wn * 64 + nt * 8 + (lane & 3) * 2;
        *reinterpret_cast<uint32_t*>(tile + i * kPitchR + j) =
            pack_bf16(0.5f * acc[mt][nt][2 * h], 0.5f * acc[mt][nt][2 * h + 1]);
      }
  __syncthreads();
  bf16* db = de + b * V * (long)V;
  store_de<VEC>(db, V, r0, c0, tile, false, bi == bj);
  if (bi != bj) store_de<VEC>(db, V, c0, r0, tile, true, false);
}

template <int VEC>
cudaError_t sym_conv_tc_launch(const void* e, const void* f, void* out, int K, int V, int D,
                               cudaStream_t stream) {
  cudaError_t err = allow_smem(sym_conv_tc_kernel<VEC>, kConvSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((D + kTile - 1) / kTile, (V + kTile - 1) / kTile, K);
  sym_conv_tc_kernel<VEC><<<grid, kThreads, kConvSmem, stream>>>(
      static_cast<const bf16*>(e), static_cast<const bf16*>(f), static_cast<bf16*>(out), V, D);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t sym_conv_de_tc_launch(const void* f, const void* g, void* de, int K, int V, int D,
                                  cudaStream_t stream) {
  cudaError_t err = allow_smem(sym_conv_de_tc_kernel<VEC>, kDeSmem);
  if (err != cudaSuccess) return err;
  const int nb = (V + kTile - 1) / kTile;
  dim3 grid(nb * (nb + 1) / 2, K);
  sym_conv_de_tc_kernel<VEC><<<grid, kThreads, kDeSmem, stream>>>(
      static_cast<const bf16*>(f), static_cast<const bf16*>(g), static_cast<bf16*>(de), V, D);
  return cudaGetLastError();
}

// the widest chunk of E's rows that keeps every chunk aligned and in or out whole
inline int row_vec(int V) { return V % 8 == 0 ? 8 : V % 4 == 0 ? 4 : V % 2 == 0 ? 2 : 1; }

cudaError_t sym_conv_tc(const void* e, const void* f, void* out, int K, int V, int D,
                        cudaStream_t stream) {
  if (D % 8) return cudaErrorInvalidValue;
  switch (row_vec(V)) {
    case 8: return sym_conv_tc_launch<8>(e, f, out, K, V, D, stream);
    case 4: return sym_conv_tc_launch<4>(e, f, out, K, V, D, stream);
    case 2: return sym_conv_tc_launch<2>(e, f, out, K, V, D, stream);
    default: return sym_conv_tc_launch<1>(e, f, out, K, V, D, stream);
  }
}

cudaError_t sym_conv_bwd_tc(const void* e, const void* f, const void* g, void* df, void* de,
                            int K, int V, int D, cudaStream_t stream) {
  cudaError_t err = sym_conv_tc(e, g, df, K, V, D, stream);  // df = E_sym g
  if (err != cudaSuccess || de == nullptr) return err;
  switch (row_vec(V)) {
    case 8: return sym_conv_de_tc_launch<8>(f, g, de, K, V, D, stream);
    case 4: return sym_conv_de_tc_launch<4>(f, g, de, K, V, D, stream);
    case 2: return sym_conv_de_tc_launch<2>(f, g, de, K, V, D, stream);
    default: return sym_conv_de_tc_launch<1>(f, g, de, K, V, D, stream);
  }
}

}  // namespace sn

// fp32 takes the FMA kernel, bf16 the tensor-core kernel (D a multiple of 8).
extern "C" int sn_sym_conv(int dtype, const void* e, const void* f, void* out, int K, int V,
                           int D, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == sn::kF32) return sn::sym_conv_impl<float>(e, f, out, K, V, D, s);
  return sn::sym_conv_tc(e, f, out, K, V, D, s);
}

// df (always) and de (skipped when de is null) of sym_conv for the cotangent
// g. Routes as sn_sym_conv.
extern "C" int sn_sym_conv_bwd(int dtype, const void* e, const void* f, const void* g, void* df,
                               void* de, int K, int V, int D, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == sn::kF32) return sn::sym_conv_bwd_impl<float>(e, f, g, df, de, K, V, D, s);
  return sn::sym_conv_bwd_tc(e, f, g, df, de, K, V, D, s);
}
