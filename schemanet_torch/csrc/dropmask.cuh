// Counter-based dropout keep bits, shared by the fused attention and FFN
// kernels (attention.cu, mlp.cu).
//
// Port of schemanet_tpu/ops/pallas/dropmask.py hash_keep_mask; the plain
// PyTorch version is schemanet_torch/ops/kernels/dropmask.py. The keep bit of
// logical element (row, col) of a stream is a pure function of (seed, stream,
// row, col), so a backward kernel regenerates its forward's mask bit for bit
// whatever either kernel's blocking:
//
//   h0      = fmix32(seed * 0x9E3779B1 ^ stream * 0x85EBCA77)
//   counter = row * cols + col
//   h       = fmix32(counter * 0xC2B2AE3D ^ h0)
//   keep    = float(h >> 8) * 2^-24 >= p          (fp32)
//
// everything in uint32 with wraparound.
#pragma once

#include <cstdint>

namespace sn {

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// h0 of a (seed, stream) pair: computed once per stream.
__device__ __forceinline__ uint32_t drop_stream(int seed, int stream) {
  return fmix32(static_cast<uint32_t>(seed) * 0x9E3779B1u ^
                static_cast<uint32_t>(stream) * 0x85EBCA77u);
}

// Keep bit of element (row, col) of a stream whose rows have `cols` columns.
__device__ __forceinline__ bool drop_keep(uint32_t h0, uint32_t row, uint32_t cols, uint32_t col,
                                          float p) {
  const uint32_t h = fmix32((row * cols + col) * 0xC2B2AE3Du ^ h0);
  return static_cast<float>(static_cast<int>(h >> 8)) * (1.0f / 16777216.0f) >= p;
}

}  // namespace sn
