// The card's image pipeline: libjpeg's chroma upsampling and colour
// conversion of nvJPEG's planes (ycc_rgb_kernel, below the filter), and the
// crop, flip and antialiased resize of a ragged batch of decoded images:
//   out[b, y, x, c] = uint8 of the separable triangle filter of sample b's
//                     crop window, resized to out x out, mirrored if flip.
//
// Replaces no TPU kernel: it is the device counterpart of the host pipeline's
// ip_process_sample_u8 (native/src/imagepipe.cpp:29-63, :78-129, :147-162),
// which the JAX loader runs per sample under device_normalize=True. Here the
// loader ships the decoded images of a batch packed in one uint8 buffer
// (each image h x w x 3 at its own offset) with a table of (offset, h, w,
// top, left, crop_h, crop_w, flip) a sample, and one launch resizes them
// all; the normalisation follows on the device.
//
// The filter is the C++ one, operation for operation:
//   * taps of output i along an axis: center = start + (i + 0.5) scale,
//     scale = crop / out, support = max(scale, 1); from floor(center -
//     support + 0.5) to floor(center + support + 0.5), clamped to 16 pixels
//     beyond the crop window; weight 1 - |j + 0.5 - center| / support, at
//     least 0, in fp64, rounded to fp32, then renormalised as
//     fp32(double(w32) / sum of the fp64 weights);
//   * the horizontal pass sums, in fp32 and in tap order, the rows of the
//     crop window at every tap: real pixels outside the window but inside
//     the image, zeros outside the image; a flip takes the taps of the
//     mirrored output column;
//   * the vertical pass sums those row results in tap order, skipping rows
//     outside the window;
//   * u = (acc * (1/255)) * 255 + 0.5, truncated and clamped to [0, 255].
// Every fp32 and fp64 product and sum is rounded by itself (__fmul_rn,
// __fadd_rn, __dmul_rn, __dadd_rn): no fused multiply-add, so the plain
// version (ops/kernels/imagepipe.py crop_resize_reference), which takes the
// same operations in the same order, gives the same bits.
//
// What bounds it on the card: the bytes of the crop windows read and the
// bs out^2 3 bytes written (at 64 photo-sized training crops to 224^2: 34 MB,
// 10 us at 3.35 TB/s); short of that, its instructions: ~30 fp32 operations
// an output byte at a 2x downscale, and the shared-memory traffic of its
// pixels. Design: a block takes one sample's tile of up to 256 output
// columns (a thread a column) by a band of kBandRows output rows, grid
// (column tiles, bands, samples). It builds its columns' and rows' taps
// once, with the same fp64 operations as make_taps and tap_coef, so every
// coefficient is the one a per-pixel computation gives: a thread's own x
// coefficients in registers where a column has at most kRegTaps taps (a
// downscale to 2.5x), else in a shared table, the band's y coefficients in
// a shared table. It then streams the band's source rows through two shared
// stage buffers (16-byte asynchronous copies, the next fill in flight while
// one is summed), sums each row's horizontal taps once a column and adds
// that sum into the band's accumulators (registers) whose taps hold the row,
// and writes the band's rows in 16-byte words. Source
// rows stream and a row wider than the buffer goes in chunks of columns, so
// no scale bounds the rows or columns taken; where the coefficient tables
// would pass kCropTable bytes (a window 41,000 pixels wide or more, or more
// than 2,500 times the output's height), the kernel computes each
// coefficient where it uses it, as the first design did everywhere. (That
// first design, a thread an output pixel rebuilding its taps and every
// coefficient with fp64 divisions at every tap, ran at 4% of the byte
// bound on an H100 SXM at 700 W.)
#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

namespace sn {

constexpr int kCropThreads = 256;  // a block: up to 256 output columns, a thread each
constexpr int kYccThreads = 128;   // ycc_rgb_kernel: a thread a group of 2 x 16 pixels
constexpr int kCropMeta = 8;       // offset, h, w, top, left, crop_h, crop_w, flip
constexpr int kBandRows = 8;       // output rows a band: 24 sums a thread in registers
constexpr int kCropStage = 8192;   // bytes of staged source rows (and of the band's output)
constexpr int kCropTable = 160 * 1024;  // the coefficient tables' bytes at most

struct Taps {
  int lo, count;
  double center, support, total;
};

// The taps of output i of an axis whose crop window starts at `start` and
// spans `crop` pixels, resized to `out`; total is the sum of the fp64 weights.
__device__ __forceinline__ Taps make_taps(int start, int crop, int out, int i) {
  Taps t;
  const double scale = (double)crop / (double)out;
  t.support = scale < 1.0 ? 1.0 : scale;
  t.center = __dadd_rn((double)start, __dmul_rn((double)i + 0.5, scale));
  int lo = (int)floor(__dadd_rn(__dsub_rn(t.center, t.support), 0.5));
  int hi = (int)floor(__dadd_rn(__dadd_rn(t.center, t.support), 0.5));
  lo = max(lo, start - 16);
  hi = min(hi, start + crop + 16);
  t.lo = lo;
  t.count = hi - lo;
  double total = 0.0;
  for (int j = lo; j < hi; ++j) {
    const double x = __ddiv_rn(__dsub_rn((double)j + 0.5, t.center), t.support);
    double w = x < 0 ? 1.0 + x : 1.0 - x;
    if (w < 0) w = 0;
    total = __dadd_rn(total, w);
  }
  t.total = total;
  return t;
}

// The renormalised fp32 coefficient of source index j.
__device__ __forceinline__ float tap_coef(const Taps& t, int j) {
  const double x = __ddiv_rn(__dsub_rn((double)j + 0.5, t.center), t.support);
  double w = x < 0 ? 1.0 + x : 1.0 - x;
  if (w < 0) w = 0;
  const float w32 = (float)w;
  return t.total > 0 ? (float)__ddiv_rn((double)w32, t.total) : w32;
}

// Where crop_resize_kernel takes its coefficients: kRegX, each thread its
// own column's x coefficients in registers (at most kRegTaps taps) and the
// band's y coefficients from a table in shared memory; kTables, both from
// tables in shared memory; kPerTap, each computed where it is used (taps too
// many for the tables). Every route computes every coefficient with the
// same operations (make_taps, tap_coef).
enum CropMode : int { kRegX = 0, kTables = 1, kPerTap = 2 };
constexpr int kRegTaps = 8;

// acc[r] += cy(r, sy) * part for the band rows r from R0 while r < rb: the
// rows whose taps hold source row sy are the run [ra, rb), and a chain of
// tests on ra enters at its first row, so that every index of acc is a
// constant and the sums stay in registers.
template <int kMode, int R0>
__device__ __forceinline__ void add_rows(float (&acc)[kBandRows][3], int ra, int rb, int sy,
                                         const float (&part)[3], const int (&ylo)[kBandRows],
                                         const float* cyt, int ty_max, const Taps* yt) {
  if constexpr (R0 < kBandRows) {
    if (ra != R0) {
      add_rows<kMode, R0 + 1>(acc, ra, rb, sy, part, ylo, cyt, ty_max, yt);
      return;
    }
#pragma unroll
    for (int r = R0; r < kBandRows; ++r) {
      if (r >= rb) return;
      const float cy = kMode == kPerTap ? tap_coef(yt[r], sy) : cyt[r * ty_max + sy - ylo[r]];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) acc[r][ch] = __fadd_rn(acc[r][ch], __fmul_rn(cy, part[ch]));
    }
  }
}

// A block takes sample blockIdx.z's output columns [x0, x0 + tile) (a thread
// a column, 3 channels; the columns split evenly over the fewest tiles of
// kCropThreads, so a 224-wide output is one tile) and its band of kBandRows
// output rows from y0. It builds its columns' and rows' taps once (the
// coefficients too, in registers or shared tables by kMode), then walks the
// band's source rows in ascending order, a fill of g rows at a time staged
// in shared memory by 16-byte asynchronous copies, the next fill's in flight
// while this one is summed: each thread sums its column's horizontal taps of a row
// once and adds cy * that sum into each of the band's accumulators
// (registers) whose taps hold the row. Ascending rows are each output's tap
// order, and a row or pixel outside the image adds +0, which changes no sum
// of non-negative terms, so it is skipped: every byte comes from the plain
// version's operations in its order. A source row too wide for the stage
// buffer is taken in chunks of columns, one row at a time, the sums carried
// across the chunks in tap order.
// Three blocks an SM (80 registers a thread) but on the per-tap route, whose
// fp64 divisions in its loops would spill there.
template <int kMode>
__global__ void __launch_bounds__(kCropThreads, kMode == kPerTap ? 1 : 3)
crop_resize_kernel(const uint8_t* __restrict__ src, const int64_t* __restrict__ meta,
                   uint8_t* __restrict__ dst, int out, int tile, int tx_max, int ty_max) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* stages = smem;  // two stage buffers
  Taps* xt = reinterpret_cast<Taps*>(smem + 2 * kCropStage);
  Taps* yt = xt + kCropThreads;
  float* cyt = reinterpret_cast<float*>(yt + kBandRows);  // [kBandRows][ty_max]
  float* cxt = cyt + kBandRows * ty_max;                  // [tx_max][tile] (kTables)
  const int t = threadIdx.x, b = blockIdx.z;
  const int x0 = blockIdx.x * tile, ncols = min(tile, out - x0);
  const int y0 = blockIdx.y * kBandRows, nrows = min(kBandRows, out - y0);
  const int64_t* m = meta + (int64_t)b * kCropMeta;
  const uint8_t* img = src + m[0];
  const int h = (int)m[1], w = (int)m[2], top = (int)m[3], left = (int)m[4];
  const int crop_h = (int)m[5], crop_w = (int)m[6], flip = (int)m[7];

  // the taps, once a block
  Taps mine = {0, 0, 0.0, 1.0, 0.0};
  if (t < ncols) {
    mine = make_taps(left, crop_w, out, flip ? out - 1 - (x0 + t) : x0 + t);
    xt[t] = mine;
  }
  if (t < nrows) yt[t] = make_taps(top, crop_h, out, y0 + t);
  float cx[kRegTaps];
  if (kMode == kRegX) {
#pragma unroll
    for (int j = 0; j < kRegTaps; ++j) cx[j] = j < mine.count ? tap_coef(mine, mine.lo + j) : 0.f;
  }
  __syncthreads();
  if (kMode != kPerTap) {
    for (int id = t; id < kBandRows * ty_max; id += kCropThreads) {
      const int r = id / ty_max, j = id % ty_max;
      cyt[id] = r < nrows && j < yt[r].count ? tap_coef(yt[r], yt[r].lo + j) : 0.f;
    }
  }
  if (kMode == kTables) {
    for (int id = t; id < tx_max * tile; id += kCropThreads) {
      const int j = id / tile, col = id % tile;
      cxt[id] = col < ncols && j < xt[col].count ? tap_coef(xt[col], xt[col].lo + j) : 0.f;
    }
  }
  // lo and hi rise with the output index: the block's source columns and rows
  const Taps& xa = xt[flip ? ncols - 1 : 0];
  const Taps& xb = xt[flip ? 0 : ncols - 1];
  const int sx0 = max(xa.lo, 0), sx1 = min(xb.lo + xb.count, w);
  const int span = max(sx1 - sx0, 1), cw_max = (kCropStage - 32) / 3;
  const int chunks = (span + cw_max - 1) / cw_max;
  const int chunk_w = chunks == 1 ? span : cw_max;
  const int wpr = (chunk_w * 3 + 30) / 16 + 1;  // 16-byte words a staged row
  const int pitch = wpr * 16;
  const int fill = chunks == 1 ? max(1, kCropStage / pitch) : 1;
  const int ry0 = max(max(yt[0].lo, top), 0);
  const int ry1 = min(min(yt[nrows - 1].lo + yt[nrows - 1].count, top + crop_h), h);
  int ylo[kBandRows];
#pragma unroll
  for (int r = 0; r < kBandRows; ++r) ylo[r] = r < nrows ? yt[r].lo : 0;
  float acc[kBandRows][3];
#pragma unroll
  for (int r = 0; r < kBandRows; ++r) acc[r][0] = acc[r][1] = acc[r][2] = 0.f;
  int ra = 0, rb = 0;  // the band's rows whose taps hold the current source row

  // the fills: (g rows from sy0, columns [c0, c1)), item i of items
  const int items = sx1 > sx0 && ry1 > ry0 ? (ry1 - ry0 + fill - 1) / fill * chunks : 0;
  const auto load = [&](int i) {
    const int sy0 = ry0 + i / chunks * fill, c0 = sx0 + i % chunks * chunk_w;
    const int g = min(fill, ry1 - sy0), c1 = min(sx1, c0 + chunk_w);
    uint8_t* buf = stages + (i & 1) * kCropStage;
    for (int id = t; id < g * wpr; id += kCropThreads) {
      const int k = id / wpr, q = id % wpr;
      const uint8_t* first = img + ((int64_t)(sy0 + k) * w + c0) * 3;
      const uintptr_t base = reinterpret_cast<uintptr_t>(first) & ~uintptr_t(15);
      // an aligned word that holds a byte of the row lies in its allocation
      if (base + 16 * q < reinterpret_cast<uintptr_t>(first) + (c1 - c0) * 3)
        cp_async16(buf + 16 * (k * wpr + q), reinterpret_cast<const uint4*>(base) + q, 16);
    }
    cp_async_commit();
  };
  float part[3] = {0.f, 0.f, 0.f};
  if (items > 0) load(0);
  for (int i = 0; i < items; ++i) {
    if (i + 1 < items) {
      load(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // fill i is in
    const int sy0 = ry0 + i / chunks * fill, c = i % chunks, c0 = sx0 + c * chunk_w;
    const int g = min(fill, ry1 - sy0), c1 = min(sx1, c0 + chunk_w);
    const uint8_t* buf = stages + (i & 1) * kCropStage;
    for (int k = 0; k < g; ++k) {
      const int sy = sy0 + k;
      // the row's pixel c0 in the stage buffer
      const uint8_t* row =
          buf + k * pitch + (reinterpret_cast<uintptr_t>(img + ((int64_t)sy * w + c0) * 3) & 15);
      if (c == 0) part[0] = part[1] = part[2] = 0.f;
      if (kMode == kRegX) {
#pragma unroll
        for (int j = 0; j < kRegTaps; ++j) {
          const int sx = mine.lo + j;
          if (j < mine.count && sx >= c0 && sx < c1) {
            const uint8_t* p = row + (sx - c0) * 3;
#pragma unroll
            for (int ch = 0; ch < 3; ++ch)
              part[ch] = __fadd_rn(part[ch], __fmul_rn(cx[j], (float)p[ch]));
          }
        }
      } else {
        const int j1 = min(mine.lo + mine.count, c1);
        for (int sx = max(mine.lo, c0); sx < j1; ++sx) {
          const float cxv =
              kMode == kTables ? cxt[(sx - mine.lo) * tile + t] : tap_coef(mine, sx);
          const uint8_t* p = row + (sx - c0) * 3;
#pragma unroll
          for (int ch = 0; ch < 3; ++ch)
            part[ch] = __fadd_rn(part[ch], __fmul_rn(cxv, (float)p[ch]));
        }
      }
      if (c < chunks - 1) continue;
      // lo and hi rise with r: the rows [ra, rb) are those with lo <= sy < hi
      while (ra < nrows && yt[ra].lo + yt[ra].count <= sy) ++ra;
      while (rb < nrows && yt[rb].lo <= sy) ++rb;
      add_rows<kMode, 0>(acc, ra, rb, sy, part, ylo, cyt, ty_max, yt);
    }
    __syncthreads();  // fill i is read: its buffer takes fill i + 2
  }

  // the band's bytes through shared memory, each row placed at its
  // destination's offset mod 16, then written in whole 16-byte words
  const int opitch = (tile * 3 + 30) / 16 * 16 + 16;
  const int64_t row0 = ((int64_t)b * out + y0) * out + x0;  // the band's first pixel
  if (t < ncols) {
    const float inv255 = 1.0f / 255.0f;
#pragma unroll
    for (int r = 0; r < kBandRows; ++r) {
      if (r >= nrows) break;
      const uintptr_t d = reinterpret_cast<uintptr_t>(dst + (row0 + (int64_t)r * out) * 3);
      uint8_t* o = stages + r * opitch + (d & 15) + t * 3;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float v = __fmul_rn(acc[r][ch], inv255);
        const float u = __fadd_rn(__fmul_rn(v, 255.0f), 0.5f);
        o[ch] = (uint8_t)(u < 0.f ? 0 : (u > 255.f ? 255 : (int)u));
      }
    }
  }
  __syncthreads();
  const int owords = opitch / 16;
  for (int id = t; id < nrows * owords; id += kCropThreads) {
    const int r = id / owords, q = id % owords;
    uint8_t* d0 = dst + (row0 + (int64_t)r * out) * 3;
    uint8_t* d1 = d0 + ncols * 3;
    uint8_t* wd =
        reinterpret_cast<uint8_t*>(reinterpret_cast<uintptr_t>(d0) & ~uintptr_t(15)) + 16 * q;
    if (wd >= d1) continue;
    const uint8_t* s0 = stages + r * opitch + 16 * q;
    if (wd >= d0 && wd + 16 <= d1) {
      *reinterpret_cast<uint4*>(wd) = *reinterpret_cast<const uint4*>(s0);
    } else {
      for (int e = 0; e < 16; ++e)
        if (wd + e >= d0 && wd + e < d1) wd[e] = s0[e];
    }
  }
}

// ---------------------------------------------------------------------------
// ycc_rgb_kernel: the nvJPEG route's last decode step, RGB from a file's Y, Cb
// and Cr planes by libjpeg's upsampling (jdsample.c: the fancy 2h1v, 2h2v and
// 1h2v filters, edges replicated as libjpeg's context rows and column sums
// replicate them; plain replication where libjpeg takes it: 4h1v, 4h2v, a
// chroma plane 2 wide or less) and its fixed-point YCbCr conversion
// (jdcolor.c, 16 fractional bits: FIX(1.402) = 91881, FIX(1.772) = 116130,
// FIX(0.71414) = 46802, FIX(0.34414) = 22554, ONE_HALF = 32768, arithmetic
// shifts, then clamped to [0, 255]); a gray file's luma fills R, G and B.
// The integer operations are the plain version's (ops/kernels/imagepipe.py
// ycc_to_rgb_reference), so the bytes are equal.
//
// What bounds it: bytes. At 4:2:0 it reads 1.5 h w bytes and writes 3 h w
// (64 photos, 11.47 M pixels: 51.6 MB, 15.4 us at 3.35 TB/s; a copy_ of as
// many bytes takes 19.6 us). The first design, a thread an output pixel over
// the batch's bounding box (44% of its threads idle), 8 clamped chroma byte
// loads a pixel and three 1-byte stores at stride 3, ran at 13% of that
// bound on an H100 SXM at 700 W; this one at 42% (PERF.md, row 15): after
// the bytes, its ~30 integer operations a pixel, which overlap the memory
// traffic only in part.
//
// Design. The planes are packed as nvJPEG decodes them (a plane's pitch
// its width). The host half (ycc_prepare, in this library) checks the
// table and writes each file's record with its tiling, so the kernel
// divides by nothing; it alone decides the tiling (sn_ycc_prepare gives
// its records to the tests and its tile count to chip_smoke.py). A block
// takes one tile of real pixels: a band of an even
// number of rows from an even row (a 1h2v or 2h2v chroma row pair never
// straddles two tiles) by a chunk of at most kYccCols columns, whole rows
// for any photo, so that the band's RGB bytes are one contiguous run of the
// output; the grid is the batch's tiles, and a block finds its file by a
// search of the tiles' prefix, 128 candidates a round. No width is too
// wide: a wider row splits into chunks (bands of 2 rows). A thread takes a
// group of 2 rows by 16 columns, which share their chroma: Y in one 16-byte
// load a row where the row's 16 bytes are aligned (bytes where not), each
// chroma row the group needs loaded once (8 bytes and its two neighbours at
// 2h, 16 at 1h), each chroma column's 3 near + far sum formed once. The
// colour conversion adds y << 16 into jdcolor.c's term and clamps in one DPX
// instruction (the byte is bits 16-23), and byte permutes pack the group's
// 96 RGB bytes, which go into shared memory at their destination's offset
// mod 16 (funnel shifts, 4-byte stores). The copy engine then writes each
// run's 16-byte aligned body (a bulk copy, cp.async.bulk), and threads its
// head and tail bytes, so no output offset needs any alignment. Each block
// has one file and so one chroma mode (a switch uniform over the block).
// kYccBlocks caps a thread at 80 registers, where ptxas spills 24 bytes a
// thread to local memory (chip_smoke.py phase 2 prints it and holds it
// under 64 bytes). Tried and no faster on the card (PERF.md §7): planes at
// pitches rounded up to 16 (all Y loads aligned; within run-to-run noise of
// the packed planes), caps of 96 registers (5 blocks an SM: 60 bytes
// spilled, slower) and 64 (8 blocks: 84), 256 threads a block, the lower
// chroma rows loaded late (tools/kernel_variants_torch.py ycc); blocks that
// each take a run of tiles with the next band prefetched into L2 (slower;
// not kept).
constexpr int kYccMeta = 10;  // y, cb, cr offsets, h, w, chroma w, chroma h, hs, vs, out
constexpr int kYccRec = 14;   // a file's record (imagepipe.py YCC_REC): its 10 columns, then
                              // its tiling (chunks, chunk width, tc | tr << 16, 65536 / tc + 1)
                              // and, after the n records, each file's first tile
constexpr int kYccCols = 2048;    // a tile's columns at most, a multiple of 16
constexpr int kYccStage = 12320;  // staged output: 4,096 pixels, or 2 rows of 2,048 and 16 bytes a row
constexpr int kYccBlocks = 6;     // blocks an SM: at most 80 registers a thread
static_assert(kYccCols == 16 * kYccThreads, "a row cut into chunks has bands of 2 rows");
static_assert(kYccRec == kYccMeta + 4, "a record is the table's columns and 4 words of tiling");

enum YccMode : int { kGray = 0, kH1V1 = 1, kH2V1 = 2, kH2V2 = 3, kH1V2 = 4, kReplicate = 5 };

// How the host half cuts a file w wide: chunks of chunk_w columns (the
// fewest of at most kYccCols, evenly, a multiple of 16 wide), tc groups of
// 16 columns across a chunk and tr groups of 2 rows down a band of 2 tr rows
struct YccTiling {
  int chunks, chunk_w, tc, tr;
};

inline YccTiling ycc_tiling(int w) {
  YccTiling t;
  t.chunks = (w + kYccCols - 1) / kYccCols;
  t.chunk_w = ((w + t.chunks - 1) / t.chunks + 15) / 16 * 16;
  t.tc = t.chunk_w / 16;
  t.tr = kYccThreads / t.tc;
  return t;
}

// 16 bytes of a row from p: one 16-byte load where p is aligned and n >= 16
// of them lie in the row, else the first n by bytes (the rest 0)
__device__ __forceinline__ void load16(const uint8_t* __restrict__ p, int n, uint32_t (&v)[4]) {
  if (n >= 16 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
    return;
  }
  v[0] = v[1] = v[2] = v[3] = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (j < n) v[j >> 2] |= (uint32_t)__ldg(p + j) << (8 * (j & 3));
}

// byte l of 16 packed in v, in one byte permute
__device__ __forceinline__ int byte_of(const uint32_t (&v)[4], int l) {
  return (int)__byte_perm(v[l >> 2], 0, 0x4440 | (l & 3));
}

// A 2h group's chroma samples i0 - 1 .. i0 + 8 of a row cw wide, columns
// clamped to the row: the middle 8 packed in lo and hi (one 8-byte load
// where aligned and inside the row), the two neighbours in l and r
struct Chroma10 {
  uint32_t lo, hi;
  int l, r;
};

__device__ __forceinline__ Chroma10 load10(const uint8_t* __restrict__ row, int i0, int cw) {
  Chroma10 c;
  const uint8_t* p = row + i0;
  if (i0 + 8 <= cw && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    c.lo = q.x;
    c.hi = q.y;
  } else {
    c.lo = c.hi = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t b = __ldg(row + min(i0 + k, cw - 1));
      if (k < 4) c.lo |= b << (8 * k);
      else c.hi |= b << (8 * (k - 4));
    }
  }
  c.l = __ldg(row + max(i0 - 1, 0));
  c.r = __ldg(row + min(i0 + 8, cw - 1));
  return c;
}

// sample k (0 .. 9) of a group
__device__ __forceinline__ int at10(const Chroma10& c, int k) {
  return k == 0 ? c.l
         : k == 9 ? c.r
                  : (int)__byte_perm(k <= 4 ? c.lo : c.hi, 0, 0x4440 | ((k - 1) & 3));
}

// libjpeg's 2h1v filter at output l of a group: 3 x its sample + 1 x the
// further neighbour, biases 1 (left) and 2 (right)
__device__ __forceinline__ int h2v1_at(const Chroma10& c, int l) {
  const int i = (l >> 1) + 1;
  return (l & 1) ? (3 * at10(c, i) + at10(c, i + 1) + 2) >> 2
                 : (3 * at10(c, i) + at10(c, i - 1) + 1) >> 2;
}

// libjpeg's 2h2v filter across a group: column sums cs of 3 x the nearer
// chroma row (mid) + 1 x the further (far), then output l = (3 cs_i + cs_j
// + 8 or 7) >> 4 (j the further neighbour, 8 left and 7 right); 3 cs_i + 8
// is formed once a column
struct H2V2 {
  int cs[10], near[10];
  __device__ __forceinline__ H2V2(const Chroma10& mid, const Chroma10& far) {
#pragma unroll
    for (int k = 0; k < 10; ++k) {
      cs[k] = 3 * at10(mid, k) + at10(far, k);
      near[k] = 3 * cs[k] + 8;
    }
  }
  __device__ __forceinline__ int operator()(int l) const {
    const int i = (l >> 1) + 1;
    return (l & 1) ? (near[i] + cs[i + 1] - 1) >> 4 : (near[i] + cs[i - 1]) >> 4;
  }
};

// bytes 2 of a, b, c, d into one word, little-endian
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0062), __byte_perm(c, d, 0x0062), 0x5410);
}

// A row of 16 pixels: 48 RGB bytes packed little-endian in v, from the Y
// bytes yv and chroma(l) = (cb, cr) of pixel l, each taken where it is used.
// jdcolor.c's fixed point with y << 16 added in, so a channel's byte is bits
// 16-23 of y << 16 + its term (Cb and Cr - 128 folded into the constants:
// 91881 (r - 128) + 32768 = 91881 r - 11728000), clamped to [0, 0xffffff]
// with the add in one DPX instruction: the byte is then clamp(y + (term >>
// 16), 0, 255), as jdcolor.c computes it
template <class F>
__device__ __forceinline__ void ycc_pack(const uint32_t (&yv)[4], const F& chroma,
                                         uint32_t (&v)[12]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {  // 4 pixels, 12 bytes, 3 words
    uint32_t c[12];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int l = 4 * q + p;
      const int y16 = (int)__byte_perm(yv[q], 0, 0x4044 | (p << 8));  // y << 16
      const int2 bc = chroma(l);
      const int b = bc.x, r = bc.y;
      c[3 * p] = (uint32_t)__viaddmin_s32_relu(91881 * r - 11728000, y16, 0xffffff);
      c[3 * p + 1] =
          (uint32_t)__viaddmin_s32_relu(8910336 - 22554 * b - 46802 * r, y16, 0xffffff);
      c[3 * p + 2] = (uint32_t)__viaddmin_s32_relu(116130 * b - 14831872, y16, 0xffffff);
    }
    v[3 * q] = pack4(c[0], c[1], c[2], c[3]);
    v[3 * q + 1] = pack4(c[4], c[5], c[6], c[7]);
    v[3 * q + 2] = pack4(c[8], c[9], c[10], c[11]);
  }
}

// A gray row: each Y byte three times
__device__ __forceinline__ void gray_pack(const uint32_t (&yv)[4], uint32_t (&v)[12]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[3 * q] = __byte_perm(yv[q], 0, 0x1000);
    v[3 * q + 1] = __byte_perm(yv[q], 0, 0x2211);
    v[3 * q + 2] = __byte_perm(yv[q], 0, 0x3332);
  }
}

// The first nbytes of v into shared memory from byte s: a whole group's 48
// by 4-byte stores (funnel-shifted to s mod 4) and bytes at its two ends
__device__ __forceinline__ void stage_bytes(uint8_t* stage, int s, const uint32_t (&v)[12],
                                            int nbytes) {
  if (nbytes == 48) {
    const int a = s & 3;
    uint32_t* w = reinterpret_cast<uint32_t*>(stage + (s & ~3));
    if (a == 0) {
#pragma unroll
      for (int k = 0; k < 12; ++k) w[k] = v[k];
      return;
    }
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (j < 4 - a) stage[s + j] = (uint8_t)(v[0] >> (8 * j));
    const int sh = 8 * (4 - a);
#pragma unroll
    for (int k = 0; k < 11; ++k) w[k + 1] = __funnelshift_r(v[k], v[k + 1], sh);
#pragma unroll
    for (int j = 1; j < 4; ++j)
      if (j >= 4 - a) stage[s + 44 + j] = (uint8_t)(v[11] >> (8 * j));
    return;
  }
#pragma unroll
  for (int j = 0; j < 48; ++j)
    if (j < nbytes) stage[s + j] = (uint8_t)(v[j >> 2] >> (8 * (j & 3)));
}

// This thread's shared-memory writes made visible to the copy engine (the
// async proxy), before a bulk copy reads them
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// bytes (a multiple of 16) from shared to global memory by the copy engine,
// both addresses 16-byte aligned; bulk_wait_read waits until it has read
// the shared memory
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(kYccThreads, kYccBlocks)
ycc_rgb_kernel(const uint8_t* __restrict__ planes, const int64_t* __restrict__ meta, int n,
               uint8_t* __restrict__ dst) {
  __shared__ __align__(16) uint8_t stage[kYccStage];
  const int64_t* starts = meta + (int64_t)n * kYccRec;  // each file's first tile
  const int64_t tile = blockIdx.x;
  // the block's file: the last whose first tile is at most this one; each
  // round tests 128 evenly spaced candidates of the files left
  int lo = 0, span = n;
  while (span > 1) {
    const int step = (span + kYccThreads - 1) / kYccThreads;
    const int c = (int)threadIdx.x * step;
    const int count = __syncthreads_count(c < span && starts[lo + c] <= tile);
    lo += (count - 1) * step;
    span = min(step, span - (count - 1) * step);
  }
  const int64_t* m = meta + (int64_t)lo * kYccRec;
  const int h = (int)m[3], w = (int)m[4], cw = (int)m[5], ch = (int)m[6];
  const int hs = (int)m[7], vs = (int)m[8];
  const int64_t yp = w, cp = cw;  // packed planes: a row's pitch is its width
  const int mode = m[1] < 0                            ? kGray
                   : hs == 1 && vs == 1                ? kH1V1
                   : hs == 2 && vs == 1 && cw > 2      ? kH2V1
                   : hs == 2 && vs == 2 && cw > 2      ? kH2V2
                   : hs == 1 && vs == 2                ? kH1V2
                                                       : kReplicate;
  // the tile (the record's tiling: no division here but for a row in chunks)
  const int chunks = (int)m[10], chunk_w = (int)m[11], tc = (int)(m[12] & 0xffff);
  const int tr = (int)(m[12] >> 16), recip = (int)m[13];
  const int local = (int)(tile - starts[lo]), band = 2 * tr;
  const bool whole = chunks == 1;  // the band's output is one contiguous run
  const int y0 = (whole ? local : local / chunks) * band;
  const int x0 = whole ? 0 : local % chunks * chunk_w;
  const int nrows = min(band, h - y0), ncols = min(chunk_w, w - x0);
  const int64_t row_bytes = (int64_t)w * 3;
  const int opitch = chunk_w * 3 + 16;
  uint8_t* first = dst + m[9] + ((int64_t)y0 * w + x0) * 3;  // the tile's first output byte
  const int head = (int)(reinterpret_cast<uintptr_t>(first) & 15);
  const int t = threadIdx.x;
  const int trow = (t * recip) >> 16;  // t / tc, exact for t < 128
  const int r0 = 2 * trow, c0 = 16 * (t - trow * tc);
  const int nc = min(16, ncols - c0);
  if (trow < tr && r0 < nrows && nc > 0) {
    const bool two = r0 + 1 < nrows;
    const int ya = y0 + r0, xs = x0 + c0;
    const uint8_t* yrow = planes + m[0] + (int64_t)ya * yp + xs;
    uint32_t yv[2][4], v[12];
    load16(yrow, nc, yv[0]);
    if (two) load16(yrow + yp, nc, yv[1]);
    // row r (0 or 1) of the group into the stage, at its destination's
    // offset mod 16
    const auto emit = [&](int r) {
      const int s = whole ? head + (int)((r0 + r) * row_bytes) + c0 * 3
                          : (r0 + r) * opitch + c0 * 3 +
                                (int)(reinterpret_cast<uintptr_t>(first + (r0 + r) * row_bytes) & 15);
      stage_bytes(stage, s, v, nc * 3);
    };
    const uint8_t* cbp = planes + (mode == kGray ? 0 : m[1]);
    const uint8_t* crp = planes + (mode == kGray ? 0 : m[2]);
    if (mode == kGray) {
      gray_pack(yv[0], v);
      emit(0);
      if (two) {
        gray_pack(yv[1], v);
        emit(1);
      }
    } else if (mode == kH1V1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (r == 1 && !two) break;
        uint32_t bv[4], rv[4];
        load16(cbp + (int64_t)(ya + r) * cp + xs, nc, bv);
        load16(crp + (int64_t)(ya + r) * cp + xs, nc, rv);
        ycc_pack(yv[r], [&](int l) { return make_int2(byte_of(bv, l), byte_of(rv, l)); }, v);
        emit(r);
      }
    } else if (mode == kH2V1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (r == 1 && !two) break;
        const Chroma10 b = load10(cbp + (int64_t)(ya + r) * cp, xs >> 1, cw);
        const Chroma10 c = load10(crp + (int64_t)(ya + r) * cp, xs >> 1, cw);
        ycc_pack(yv[r], [&](int l) { return make_int2(h2v1_at(b, l), h2v1_at(c, l)); }, v);
        emit(r);
      }
    } else if (mode == kH2V2) {
      // chroma row j and its neighbours above and below (clamped), loaded
      // once for both output rows
      const int j = ya >> 1;
      const int64_t up = (int64_t)max(j - 1, 0) * cp, mid = (int64_t)j * cp;
      const int64_t down = (int64_t)min(j + 1, ch - 1) * cp;
      const Chroma10 bu = load10(cbp + up, xs >> 1, cw), bm = load10(cbp + mid, xs >> 1, cw);
      const Chroma10 bd = load10(cbp + down, xs >> 1, cw);
      const Chroma10 ru = load10(crp + up, xs >> 1, cw), rm = load10(crp + mid, xs >> 1, cw);
      const Chroma10 rd = load10(crp + down, xs >> 1, cw);
      {
        const H2V2 b(bm, bu), c(rm, ru);
        ycc_pack(yv[0], [&](int l) { return make_int2(b(l), c(l)); }, v);
      }
      emit(0);
      if (two) {
        const H2V2 b(bm, bd), c(rm, rd);
        ycc_pack(yv[1], [&](int l) { return make_int2(b(l), c(l)); }, v);
        emit(1);
      }
    } else if (mode == kH1V2) {
      // 3/4 the nearer row + 1/4 the further, biases 1 (upper) and 2 (lower)
      const int j = ya >> 1;
      const int64_t up = (int64_t)max(j - 1, 0) * cp, mid = (int64_t)j * cp;
      const int64_t down = (int64_t)min(j + 1, ch - 1) * cp;
      uint32_t bu[4], bm[4], bd[4], ru[4], rm[4], rd[4];
      load16(cbp + up + xs, nc, bu);
      load16(cbp + mid + xs, nc, bm);
      load16(cbp + down + xs, nc, bd);
      load16(crp + up + xs, nc, ru);
      load16(crp + mid + xs, nc, rm);
      load16(crp + down + xs, nc, rd);
      ycc_pack(yv[0], [&](int l) {
        return make_int2((3 * byte_of(bm, l) + byte_of(bu, l) + 1) >> 2,
                         (3 * byte_of(rm, l) + byte_of(ru, l) + 1) >> 2);
      }, v);
      emit(0);
      if (two) {
        ycc_pack(yv[1], [&](int l) {
          return make_int2((3 * byte_of(bm, l) + byte_of(bd, l) + 2) >> 2,
                           (3 * byte_of(rm, l) + byte_of(rd, l) + 2) >> 2);
        }, v);
        emit(1);
      }
    } else {  // kReplicate: chroma sample (y / vs, x / hs)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (r == 1 && !two) break;
        const int64_t row = (int64_t)((ya + r) / vs) * cp;
        ycc_pack(yv[r], [&](int l) {
          const int64_t at = row + (l < nc ? (xs + l) / hs : 0);
          return make_int2(__ldg(cbp + at), __ldg(crp + at));
        }, v);
        emit(r);
      }
    }
  }
  // the tile's runs of output bytes (the band, or each of its 2 rows where
  // a row is cut into chunks): the 16-byte aligned body of each by the copy
  // engine (a bulk copy from the stage, which holds it at the same offsets
  // mod 16), the head and tail before and after it (under 16 bytes each) a
  // byte a thread
  fence_async_shared();
  __syncthreads();
  const int runs = whole ? 1 : nrows;  // a row cut into chunks has bands of 2 rows
  const int64_t run_len = whole ? nrows * row_bytes : (int64_t)ncols * 3;
  const int r = t < 64 ? t : (t - 64) >> 5;  // threads 0-1: bodies; 64-127: heads, tails
  if (r < runs) {
    uint8_t* d0 = first + r * row_bytes;
    uint8_t* d1 = d0 + run_len;
    uint8_t* a0 = reinterpret_cast<uint8_t*>(reinterpret_cast<uintptr_t>(d0) & ~uintptr_t(15));
    uint8_t* b0 = a0 < d0 ? a0 + 16 : a0;  // the body [b0, b1)
    if (b0 > d1) b0 = d1;
    uint8_t* b1 = reinterpret_cast<uint8_t*>(reinterpret_cast<uintptr_t>(d1) & ~uintptr_t(15));
    if (b1 < b0) b1 = b0;
    const uint8_t* src = stage + r * opitch;  // holds byte g of the run at g - a0
    if (t < 64) {
      if (b1 > b0) {
        bulk_store(b0, src + (b0 - a0), (uint32_t)(b1 - b0));
        bulk_wait_read();  // the stage is read before the block ends
      }
    } else {
      const int e = (t - 64) & 31;
      uint8_t* p = e < 16 ? d0 + e : b1 + (e - 16);
      if (p < (e < 16 ? b0 : d1)) *p = src[p - a0];
    }
  }
}

// The host half: the table's checks (the conditions of ops/kernels/
// imagepipe.py _check_ycc, by code: 1 an empty image or plane, 2 a chroma
// plane short of its image, 3 a plane outside the plane buffer, 4 an image
// outside the output or too large, 5 more tiles than a launch takes) and
// the words the kernel reads (kYccRec a file, then each file's first
// tile). Returns the batch's tiles, or minus the first failed check.
long ycc_prepare(const int64_t* table, int n, int64_t n_planes, int64_t total, int64_t* words) {
  if (n > 65535) return -4;
  int64_t* starts = words + (int64_t)n * kYccRec;
  int64_t tiles = 0;
  for (int i = 0; i < n; ++i) {
    const int64_t* src = table + (int64_t)i * kYccMeta;
    int64_t* m = words + (int64_t)i * kYccRec;
    for (int c = 0; c < kYccMeta; ++c) m[c] = src[c];
    const int64_t yo = m[0], cbo = m[1], cro = m[2], h = m[3], w = m[4], cw = m[5], ch = m[6];
    const int64_t hs = m[7], vs = m[8], oo = m[9];
    const bool gray = cbo < 0;
    if (h < 1 || w < 1 || (!gray && (cw < 1 || ch < 1))) return -1;
    if (!gray && (hs < 1 || vs < 1 || cw * hs < w || ch * vs < h)) return -2;
    const int64_t plane = gray ? 0 : cw * ch;
    if (yo < 0 || yo + h * w > n_planes ||
        (!gray && (cro < 0 || cbo + plane > n_planes || cro + plane > n_planes)))
      return -3;
    if (oo < 0 || oo + h * w * 3 > total || h > 65535) return -4;
    starts[i] = tiles;
    const YccTiling tl = ycc_tiling((int)w);
    m[10] = tl.chunks;
    m[11] = tl.chunk_w;
    m[12] = tl.tc | (int64_t)tl.tr << 16;
    m[13] = 65536 / tl.tc + 1;  // (t * this) >> 16 = t / tc for t < 128
    tiles += (h + 2 * tl.tr - 1) / (2 * tl.tr) * tl.chunks;
    if (tiles >= 0x7fffffff) return -5;
  }
  return (long)tiles;
}

}  // namespace sn

// table [n, 10] int64 (host); words: n * (kYccRec + 1) int64 (host). The
// host half alone (sn::ycc_prepare): the batch's tiles, or minus the first
// failed check.
extern "C" int sn_ycc_prepare(const void* table, int n, long n_planes, long total, void* words) {
  if (n <= 0) return -1;
  return (int)sn::ycc_prepare(static_cast<const int64_t*>(table), n, n_planes, total,
                              static_cast<int64_t*>(words));
}

// planes: the files' planes (device); table [n, 10] int64 (host);
// host_words and dev_words: n * (kYccRec + 1) int64 of pinned host and
// device memory; dst: the packed RGB images. Checks the table and fills
// host_words (sn::ycc_prepare), copies them to dev_words on the stream and
// launches a block a tile. Returns minus a failed check's code, else the
// cudaError_t of the copy or the launch.
extern "C" int sn_ycc_to_rgb(const void* planes, const void* table, int n, long n_planes,
                             long total, void* host_words, void* dev_words, void* dst,
                             void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const long tiles = sn::ycc_prepare(static_cast<const int64_t*>(table), n, n_planes, total,
                                     static_cast<int64_t*>(host_words));
  if (tiles < 0) return (int)tiles;
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cudaMemcpyAsync(dev_words, host_words, (size_t)n * (sn::kYccRec + 1) * sizeof(int64_t),
                      cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return (int)err;
  sn::ycc_rgb_kernel<<<(unsigned)tiles, sn::kYccThreads, 0, s>>>(
      static_cast<const uint8_t*>(planes), static_cast<const int64_t*>(dev_words), n,
      static_cast<uint8_t*>(dst));
  return (int)cudaGetLastError();
}

namespace sn {

// A launch of the kernel on route kMode: a block a column tile and band.
template <int kMode>
cudaError_t crop_launch(const uint8_t* src, const int64_t* meta, uint8_t* dst, int bs, int out,
                        int tiles, int tile, int tx_max, int ty_max, size_t smem,
                        cudaStream_t s) {
  cudaError_t err = allow_smem(crop_resize_kernel<kMode>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles, (out + kBandRows - 1) / kBandRows, bs);
  crop_resize_kernel<kMode><<<grid, kCropThreads, smem, s>>>(src, meta, dst, out, tile, tx_max,
                                                             ty_max);
  return cudaGetLastError();
}

}  // namespace sn

// src: the packed images; meta [bs, 8] int64 on the device; dst [bs, out,
// out, 3]. The wrapper has checked every window's image against src's size;
// tx_max and ty_max bound every sample's tap count along x and y (the
// coefficient tables' sizes).
extern "C" int sn_crop_resize(const void* src, const void* meta, void* dst, int bs, int out,
                              int tx_max, int ty_max, void* stream) {
  using namespace sn;
  if (bs <= 0 || out <= 0 || tx_max <= 0 || ty_max <= 0) return (int)cudaErrorInvalidValue;
  const int tiles = (out + kCropThreads - 1) / kCropThreads;
  const int tile = (out + tiles - 1) / tiles;
  const size_t fixed = 2 * kCropStage + (kCropThreads + kBandRows) * sizeof(Taps);
  const size_t table_y = (size_t)kBandRows * ty_max * sizeof(float);
  const size_t table_x = (size_t)tx_max * tile * sizeof(float);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto sp = static_cast<const uint8_t*>(src);
  const auto mp = static_cast<const int64_t*>(meta);
  const auto dp = static_cast<uint8_t*>(dst);
  if (tx_max <= kRegTaps && table_y <= (size_t)kCropTable)
    return (int)crop_launch<kRegX>(sp, mp, dp, bs, out, tiles, tile, tx_max, ty_max,
                                   fixed + table_y, s);
  if (table_x + table_y <= (size_t)kCropTable)
    return (int)crop_launch<kTables>(sp, mp, dp, bs, out, tiles, tile, tx_max, ty_max,
                                     fixed + table_y + table_x, s);
  // taps too many for the tables: every coefficient computed where it is used
  return (int)crop_launch<kPerTap>(sp, mp, dp, bs, out, tiles, tile, tx_max, ty_max, fixed, s);
}
