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
constexpr int kYccThreads = 128;   // ycc_rgb_kernel: a thread a pixel, 128 along a row
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

// libjpeg's upsampling of one chroma plane p [ch][cw], at output (y, x) of
// an image with factors (hs, vs) (jdsample.c: the fancy 2h1v, 2h2v and
// 1h2v filters, edges replicated as libjpeg's context rows and column
// sums replicate them; plain replication where libjpeg takes it).
__device__ __forceinline__ int upsampled(const uint8_t* __restrict__ p, int cw, int ch, int hs,
                                         int vs, int y, int x) {
  auto at = [&](int r, int c) {
    r = min(max(r, 0), ch - 1);
    c = min(max(c, 0), cw - 1);
    return (int)p[(int64_t)r * cw + c];
  };
  if (hs == 1 && vs == 1) return at(y, x);
  const bool fancy = (hs == 2 && (vs == 1 || vs == 2) && cw > 2) || (hs == 1 && vs == 2);
  if (!fancy) return at(y / vs, x / hs);
  if (hs == 1) {  // 1h2v: 3/4 nearer row + 1/4 further, biases 1 (upper) and 2 (lower)
    const int j = y >> 1, lower = y & 1;
    return (3 * at(j, x) + at(lower ? j + 1 : j - 1, x) + (lower ? 2 : 1)) >> 2;
  }
  const int i = x >> 1, right = x & 1;
  if (vs == 1)  // 2h1v: 3/4 nearer column + 1/4 further, biases 1 (left) and 2 (right)
    return (3 * at(y, i) + at(y, right ? i + 1 : i - 1) + (right ? 2 : 1)) >> 2;
  // 2h2v: column sums 3 nearer row + 1 further, then 3/4 + 1/4 across,
  // biases 8 (left) and 7 (right)
  const int j = y >> 1, rn = (y & 1) ? j + 1 : j - 1;
  const int here = 3 * at(j, i) + at(rn, i);
  const int there = 3 * at(j, right ? i + 1 : i - 1) + at(rn, right ? i + 1 : i - 1);
  return (3 * here + there + (right ? 7 : 8)) >> 4;
}

constexpr int kYccMeta = 10;  // y, cb, cr offsets, h, w, chroma w, chroma h, hs, vs, out

// The nvJPEG route's last decode step: RGB from a file's Y, Cb, Cr planes by
// libjpeg's upsampling and its fixed-point YCbCr conversion (jdcolor.c,
// 16 fractional bits: FIX(1.402) = 91881, FIX(1.772) = 116130, FIX(0.71414)
// = 46802, FIX(0.34414) = 22554, ONE_HALF = 32768, arithmetic shifts, then
// clamped to [0, 255]); a gray file's luma fills R, G and B. A thread an
// output pixel, grid (column blocks, rows, files). Bound by bytes: each
// plane read once (L1 serves the neighbours), 3 h w bytes written.
__global__ void __launch_bounds__(kYccThreads)
ycc_rgb_kernel(const uint8_t* __restrict__ planes, const int64_t* __restrict__ meta,
               uint8_t* __restrict__ dst) {
  const int x = blockIdx.x * kYccThreads + threadIdx.x;
  const int y = blockIdx.y;
  const int64_t* m = meta + (int64_t)blockIdx.z * kYccMeta;
  const int h = (int)m[3], w = (int)m[4];
  if (x >= w || y >= h) return;
  const int yv = planes[m[0] + (int64_t)y * w + x];
  uint8_t* o = dst + m[9] + ((int64_t)y * w + x) * 3;
  if (m[1] < 0) {
    o[0] = o[1] = o[2] = (uint8_t)yv;
    return;
  }
  const int cw = (int)m[5], ch = (int)m[6], hs = (int)m[7], vs = (int)m[8];
  const int cb = upsampled(planes + m[1], cw, ch, hs, vs, y, x) - 128;
  const int cr = upsampled(planes + m[2], cw, ch, hs, vs, y, x) - 128;
  const int r = yv + ((91881 * cr + 32768) >> 16);
  const int g = yv + ((-22554 * cb + 32768 - 46802 * cr) >> 16);
  const int b = yv + ((116130 * cb + 32768) >> 16);
  o[0] = (uint8_t)min(max(r, 0), 255);
  o[1] = (uint8_t)min(max(g, 0), 255);
  o[2] = (uint8_t)min(max(b, 0), 255);
}

}  // namespace sn

extern "C" int sn_ycc_to_rgb(const void* planes, const void* meta, void* dst, int n, int max_h,
                             int max_w, void* stream) {
  const dim3 grid((max_w + sn::kYccThreads - 1) / sn::kYccThreads, max_h, n);
  sn::ycc_rgb_kernel<<<grid, sn::kYccThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(planes), static_cast<const int64_t*>(meta),
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
