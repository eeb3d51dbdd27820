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
// bs out^2 3 bytes written (a downscale reads each window pixel about once
// from device memory; the overlapping taps hit L1/L2). Design: a thread an
// output pixel (3 channels), blocks of 128 along a row, grid (row blocks,
// out rows, samples). The taps are computed by each thread as it goes, in
// fp64 (a few dozen operations a tap against the card's fp64 rate), so no
// table is built or stored and no tap count is bounded.
#include <cstdint>

#include <cuda_runtime.h>

namespace sn {

constexpr int kCropThreads = 128;
constexpr int kCropMeta = 8;  // offset, h, w, top, left, crop_h, crop_w, flip

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

__global__ void __launch_bounds__(kCropThreads)
crop_resize_kernel(const uint8_t* __restrict__ src, const int64_t* __restrict__ meta,
                   uint8_t* __restrict__ dst, int out) {
  const int x = blockIdx.x * kCropThreads + threadIdx.x;
  const int y = blockIdx.y, b = blockIdx.z;
  if (x >= out) return;
  const int64_t* m = meta + (int64_t)b * kCropMeta;
  const uint8_t* img = src + m[0];
  const int h = (int)m[1], w = (int)m[2], top = (int)m[3], left = (int)m[4];
  const int crop_h = (int)m[5], crop_w = (int)m[6], flip = (int)m[7];

  const Taps ty = make_taps(top, crop_h, out, y);
  const Taps tx = make_taps(left, crop_w, out, flip ? out - 1 - x : x);
  float acc[3] = {0.f, 0.f, 0.f};
  for (int jy = 0; jy < ty.count; ++jy) {
    const int sy = ty.lo + jy;
    if (sy - top < 0 || sy - top >= crop_h) continue;  // outside the window: skipped
    const float cy = tap_coef(ty, sy);
    float row[3] = {0.f, 0.f, 0.f};
    const bool row_in = sy >= 0 && sy < h;
    for (int jx = 0; jx < tx.count; ++jx) {
      const int sx = tx.lo + jx;
      const float cx = tap_coef(tx, sx);
      const uint8_t* p = img + ((int64_t)sy * w + sx) * 3;
      const bool in = row_in && sx >= 0 && sx < w;  // zeros outside the image
#pragma unroll
      for (int c = 0; c < 3; ++c)
        row[c] = __fadd_rn(row[c], __fmul_rn(cx, in ? (float)p[c] : 0.f));
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[c] = __fadd_rn(acc[c], __fmul_rn(cy, row[c]));
  }
  const float inv255 = 1.0f / 255.0f;
  uint8_t* o = dst + (((int64_t)b * out + y) * out + x) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v = __fmul_rn(acc[c], inv255);
    const float u = __fadd_rn(__fmul_rn(v, 255.0f), 0.5f);
    o[c] = (uint8_t)(u < 0.f ? 0 : (u > 255.f ? 255 : (int)u));
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
__global__ void __launch_bounds__(kCropThreads)
ycc_rgb_kernel(const uint8_t* __restrict__ planes, const int64_t* __restrict__ meta,
               uint8_t* __restrict__ dst) {
  const int x = blockIdx.x * kCropThreads + threadIdx.x;
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
  const dim3 grid((max_w + sn::kCropThreads - 1) / sn::kCropThreads, max_h, n);
  sn::ycc_rgb_kernel<<<grid, sn::kCropThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(planes), static_cast<const int64_t*>(meta),
      static_cast<uint8_t*>(dst));
  return (int)cudaGetLastError();
}

// src: the packed images; meta [bs, 8] int64 on the device; dst [bs, out,
// out, 3]. The wrapper has checked every window's image against src's size.
extern "C" int sn_crop_resize(const void* src, const void* meta, void* dst, int bs, int out,
                              void* stream) {
  const dim3 grid((out + sn::kCropThreads - 1) / sn::kCropThreads, out, bs);
  sn::crop_resize_kernel<<<grid, sn::kCropThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const int64_t*>(meta),
      static_cast<uint8_t*>(dst), out);
  return (int)cudaGetLastError();
}
