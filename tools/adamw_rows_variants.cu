// Variants of adamw_project_rows' warp-a-row kernel (schemanet_torch/csrc/
// atlas_opt.cu), timed alone on the card at the two shapes of the kernel
// table: [102400, 1024] with fp32 moments (CIFAR's edge weights) and
// [500000, 500] with bf16 moments (ImageNet's). Each variant runs the
// same update and projection (the projection by the reciprocal of the row
// sum); the knobs:
//   R2       rows a warp takes at once (all their loads issued together);
//   MINB     the blocks an SM __launch_bounds__ asks for (caps registers);
//   FAST     sqrt.approx and __fdividef in the update instead of IEEE ops;
//   PERSIST  a persistent grid (the blocks the card holds; warp w takes rows
//            w, w + warps, ...) instead of one row a warp, rows / 8 blocks;
//   CS       streaming cache hints (ld/st .cs) instead of plain loads/stores;
//   TRIV     no arithmetic: the same bytes moved, the bandwidth ceiling.
// Prints one line a variant: registers, blocks an SM, ms a call (CUDA
// events over 20 calls after 3). Build and run on the card:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//     -I schemanet_torch/csrc -o /tmp/adamw_rows_variants tools/adamw_rows_variants.cu
//   /tmp/adamw_rows_variants
#include <cstdio>
#include "common.cuh"
using namespace sn;
struct A { float lr, b1, omb1, b2, omb2, bc1, bc2, eps, wd; };
template <bool FAST>
__device__ __forceinline__ float upd1(float pi, float gi, float m0, float v0, const A& a, float& mi, float& vi) {
  mi = a.b1 * m0 + a.omb1 * gi;
  vi = a.b2 * v0 + a.omb2 * gi * gi;
  float den;
  if (FAST) { float q; asm("sqrt.approx.f32 %0, %1;" : "=f"(q) : "f"(vi * a.bc2)); den = q + a.eps;
    return pi - a.lr * (__fdividef(mi * a.bc1, den) + a.wd * pi); }
  den = sqrtf(vi * a.bc2) + a.eps;
  return pi - a.lr * ((mi * a.bc1) / den + a.wd * pi);
}
// general variant: R2 rows a warp at once, PERSIST grid or a row set a warp, CS cache hints, TRIV: no math
template <typename T, bool CS> struct Q4;
template <bool CS> struct Q4<float, CS> { using R = float4;
  static __device__ R ld(const float* p) { return CS ? __ldcs(reinterpret_cast<const float4*>(p)) : *reinterpret_cast<const float4*>(p); }
  static __device__ float get(const R& r, int k) { return k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w; }
  static __device__ void st(float* p, const float (&v)[4]) { if (CS) __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3])); else *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]); } };
template <bool CS> struct Q4<bf16, CS> { using R = uint2;
  static __device__ R ld(const bf16* p) { return CS ? __ldcs(reinterpret_cast<const uint2*>(p)) : *reinterpret_cast<const uint2*>(p); }
  static __device__ float get(const R& r, int k) { const uint32_t w = k < 2 ? r.x : r.y; return __uint_as_float(k & 1 ? (w & 0xffff0000u) : (w << 16)); }
  static __device__ void st(bf16* p, const float (&v)[4]) { const uint2 u = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3])); if (CS) __stcs(reinterpret_cast<uint2*>(p), u); else *reinterpret_cast<uint2*>(p) = u; } };

template <typename MT, int PER, int R2, int MINB, bool FAST, bool PERSIST, bool CS, bool TRIV>
__global__ void __launch_bounds__(256, MINB) k2(float* __restrict__ p, const float* __restrict__ g, MT* __restrict__ m, MT* __restrict__ v, long rows, int C, A a) {
  using F = Q4<float, CS>; using M = Q4<MT, CS>;
  const int lane = threadIdx.x % 32;
  const long warps = PERSIST ? (long)gridDim.x * 8 : 0;
  long row0 = ((long)blockIdx.x * 8 + threadIdx.x / 32) * (PERSIST ? 1 : R2);
  const long step = PERSIST ? warps : 1;
  for (long r = row0; r < rows; r += (PERSIST ? R2 * step : rows)) {
    typename F::R rp[R2][PER], rg[R2][PER]; typename M::R rm[R2][PER], rv[R2][PER];
#pragma unroll
    for (int t = 0; t < R2; ++t) { const long row = r + t * step; if (row >= rows) continue; const long base = row * C;
#pragma unroll
      for (int i = 0; i < PER; ++i) { const int c = 4 * (lane + 32 * i); if (c < C) {
        rp[t][i] = F::ld(p + base + c); rg[t][i] = F::ld(g + base + c); rm[t][i] = M::ld(m + base + c); rv[t][i] = M::ld(v + base + c); } } }
#pragma unroll
    for (int t = 0; t < R2; ++t) { const long row = r + t * step; if (row >= rows) continue; const long base = row * C;
      float pn[PER][4]; float ws = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) { const int c = 4 * (lane + 32 * i); if (c >= C) continue; float mo[4], vo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) { float x;
          if (TRIV) { mo[e] = M::get(rm[t][i], e) + F::get(rg[t][i], e); vo[e] = M::get(rv[t][i], e); x = F::get(rp[t][i], e); }
          else x = upd1<FAST>(F::get(rp[t][i], e), F::get(rg[t][i], e), M::get(rm[t][i], e), M::get(rv[t][i], e), a, mo[e], vo[e]);
          x = fmaxf(x, 0.f); ws += x; pn[i][e] = x; }
        M::st(m + base + c, mo); M::st(v + base + c, vo); }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ws += __shfl_xor_sync(0xffffffffu, ws, o);
      const float inv = ws > 0.f ? 1.f / ws : 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) { const int c = 4 * (lane + 32 * i); if (c >= C) continue; float out[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) out[e] = pn[i][e] * inv;
        F::st(p + base + c, out); } }
  }
}
template <typename MT, int PER, int R2, int MINB, bool FAST, bool PERSIST, bool CS, bool TRIV>
void run2(const char* tag, float* p, float* g, MT* m, MT* v, long rows, int C) {
  A a{1e-3f, 0.9f, 0.1f, 0.999f, 0.001f, 1.1f, 1.2f, 1e-8f, 5e-4f};
  auto kern = k2<MT, PER, R2, MINB, FAST, PERSIST, CS, TRIV>;
  int per = 0, sms = 0; cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, 256, 0);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  long need = (rows + 8 * R2 - 1) / (8 * R2); long grid = PERSIST ? (per * sms < need ? per * sms : need) : need;
  for (int i = 0; i < 3; ++i) kern<<<grid, 256>>>(p, g, m, v, rows, C, a);
  cudaEvent_t s, e; cudaEventCreate(&s); cudaEventCreate(&e);
  cudaEventRecord(s); for (int i = 0; i < 20; ++i) kern<<<grid, 256>>>(p, g, m, v, rows, C, a); cudaEventRecord(e); cudaEventSynchronize(e);
  float ms; cudaEventElapsedTime(&ms, s, e);
  cudaFuncAttributes fa; cudaFuncGetAttributes(&fa, kern);
  printf("%s R2=%d MINB=%d FAST=%d PERSIST=%d CS=%d TRIV=%d regs=%d blocks/SM=%d ms=%.4f err=%s\n", tag, R2, MINB, FAST, PERSIST, CS, TRIV, fa.numRegs, per, ms / 20, cudaGetErrorString(cudaGetLastError()));
}
__global__ void init(float* p, float* g, long n, int C) { for (long i = blockIdx.x * 256L + threadIdx.x; i < n; i += 256L * gridDim.x) { p[i] = 1.f / C * (1 + 0.001f * (i % 7)); g[i] = 1e-3f * ((i % 13) - 6); } }
__global__ void initm(float* x, long n) { for (long i = blockIdx.x * 256L + threadIdx.x; i < n; i += 256L * gridDim.x) x[i] = 1e-6f * (i % 5); }
__global__ void initm(bf16* x, long n) { for (long i = blockIdx.x * 256L + threadIdx.x; i < n; i += 256L * gridDim.x) x[i] = __float2bfloat16(1e-6f * (i % 5)); }
#define SWEEP2(MT, PER, tag, p, g, m, v, R, C) \
  run2<MT, PER, 1, 1, false, true, true, true>(tag, p, g, m, v, R, C); \
  run2<MT, PER, 1, 1, false, false, true, true>(tag, p, g, m, v, R, C); \
  run2<MT, PER, 1, 1, false, true, false, true>(tag, p, g, m, v, R, C); \
  run2<MT, PER, 1, 1, false, true, true, false>(tag, p, g, m, v, R, C); \
  run2<MT, PER, 1, 1, false, false, true, false>(tag, p, g, m, v, R, C); \
  run2<MT, PER, 1, 1, false, true, false, false>(tag, p, g, m, v, R, C); \
  run2<MT, PER, 1, 1, false, false, false, false>(tag, p, g, m, v, R, C); \
  run2<MT, PER, 2, 1, false, true, true, false>(tag, p, g, m, v, R, C); \
  run2<MT, PER, 2, 1, false, false, true, false>(tag, p, g, m, v, R, C); \
  run2<MT, PER, 1, 1, true, true, true, false>(tag, p, g, m, v, R, C); \
  run2<MT, PER, 1, 1, true, false, false, false>(tag, p, g, m, v, R, C); \
  run2<MT, PER, 2, 1, true, true, true, false>(tag, p, g, m, v, R, C);
int main() {
  {
    long R = 102400; int C = 1024; long n = R * C;
    float *p, *g, *m, *v; cudaMalloc(&p, n * 4); cudaMalloc(&g, n * 4); cudaMalloc(&m, n * 4); cudaMalloc(&v, n * 4);
    init<<<1024, 256>>>(p, g, n, C); initm<<<1024, 256>>>(m, n); initm<<<1024, 256>>>(v, n);
    SWEEP2(float, 8, "fp32_1024", p, g, m, v, R, C)
    cudaFree(p); cudaFree(g); cudaFree(m); cudaFree(v);
  }
  {
    long R = 500000; int C = 500; long n = R * C;
    float *p, *g; bf16 *m, *v; cudaMalloc(&p, n * 4); cudaMalloc(&g, n * 4); cudaMalloc(&m, n * 2); cudaMalloc(&v, n * 2);
    init<<<1024, 256>>>(p, g, n, C); initm<<<1024, 256>>>(m, n); initm<<<1024, 256>>>(v, n);
    SWEEP2(bf16, 4, "bf16_500", p, g, m, v, R, C)
    run2<bf16, 4, 2, 2, false, true, true, false>("bf16_500", p, g, m, v, R, C);
    run2<bf16, 4, 2, 2, false, false, true, false>("bf16_500", p, g, m, v, R, C);
    run2<bf16, 4, 4, 1, false, true, true, false>("bf16_500", p, g, m, v, R, C);
  }
  return 0;
}
