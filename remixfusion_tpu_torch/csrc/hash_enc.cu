// Table gradient of the multiresolution hash-grid encoding.
//
// Replaces the Pallas TPU kernel remixfusion_tpu/ops/pallas/hash_enc.py
// (_bwd_kernel, called through _level_grad_table inside the custom VJP
// hash_encode). It computes, for a point batch x [N, 3] and the encoding's
// output gradient g [N, L, 2],
//
//     dtable[offset_l + idx_c(n, l)] += w_c(n, l) * g[n, l]
//
// over every point n, level l and trilinear corner c. The TPU kernel builds
// this as a one-hot segment-sum on the MXU over 128-row table pages with bf16
// operands; here it is the f32 scatter-add that tiny-cuda-nn and the JAX XLA
// path compute.
//
// Bound: bytes. Per point it reads x (12 B) and g (8 B per level, 128 B at
// 16 levels) once, and the table gradient (T x 8 B, 6.3 MB at the HashGrid
// bench widths) is written once: ~35 MB or ~10 us at 3.35 TB/s for a
// 242k-point map-step backward. The ~31M float2 atomics of such a backward
// resolve in the 50 MB L2, where the whole table sits.
//
// Design (simple and right first):
//   - one thread per (point, level); neighbouring threads take neighbouring
//     levels of one point, so the g read is coalesced (a warp reads 2 points
//     x 16 levels x 8 B);
//   - each thread recomputes its 8 corner rows and weights from x with the
//     forward's arithmetic (nothing of the forward is saved but x): pos =
//     x * scale + 0.5 computed in double and rounded once to float (the JAX
//     forward is a fused multiply-add, and the port's PyTorch forward computes
//     it in double the same way), corner = floor(pos), frac = pos - corner,
//     uint32 dense index or spatial hash, mod the level size, plus the level
//     offset; the library is built with --fmad=false so no other product and
//     sum are contracted, and a gradient never lands in a row the forward did
//     not read;
//   - 8 float2 atomicAdd per thread into the zeroed table gradient.
// Known cost: the dense coarse levels contend (level 0 has 4096 rows and
// takes ~500 hits per row in a map step); privatizing them in shared memory
// is left to the PR that makes this kernel fast.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kPrime1 = 2654435761u;
constexpr uint32_t kPrime2 = 805459861u;

__device__ __forceinline__ void add2(float2* dst, float a, float b) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && CUDART_VERSION >= 12010
  atomicAdd(dst, make_float2(a, b));
#else
  atomicAdd(&dst->x, a);
  atomicAdd(&dst->y, b);
#endif
}

// lvl: int32 [4, L], rows res / size / offset / hashed.
__global__ void __launch_bounds__(kThreads)
    hash_table_grad_kernel(const float* __restrict__ x,
                           const float2* __restrict__ g,
                           float2* __restrict__ dtable,
                           const float* __restrict__ scales,
                           const int* __restrict__ lvl, int n_pts,
                           int n_levels) {
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (tid >= (long long)n_pts * n_levels) return;
  const int n = (int)(tid / n_levels);
  const int l = (int)(tid - (long long)n * n_levels);

  const double s = (double)scales[l];
  const uint32_t res = (uint32_t)lvl[l];
  const uint32_t size = (uint32_t)lvl[n_levels + l];
  const uint32_t off = (uint32_t)lvl[2 * n_levels + l];
  const bool hashed = lvl[3 * n_levels + l] != 0;
  const uint32_t res2 = res * res;

  int c[3];
  float fr[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const double p = __dadd_rn(__dmul_rn((double)x[3 * n + a], s), 0.5);
    const float pos = __double2float_rn(p);
    const float fl = floorf(pos);
    fr[a] = pos - fl;
    c[a] = (int)fl;
  }
  const float2 gv = g[tid];

#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dx = (k >> 2) & 1, dy = (k >> 1) & 1, dz = k & 1;
    const uint32_t cx = (uint32_t)(c[0] + dx);
    const uint32_t cy = (uint32_t)(c[1] + dy);
    const uint32_t cz = (uint32_t)(c[2] + dz);
    const uint32_t idx =
        hashed ? (cx ^ (cy * kPrime1) ^ (cz * kPrime2))
               : (cx + cy * res + cz * res2);
    const uint32_t row = idx % size + off;
    const float wx = dx ? fr[0] : 1.f - fr[0];
    const float wy = dy ? fr[1] : 1.f - fr[1];
    const float wz = dz ? fr[2] : 1.f - fr[2];
    const float w = (wx * wy) * wz;
    add2(dtable + row, w * gv.x, w * gv.y);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). x [N, 3], g [N, L, 2] and dtable
// [T, 2] (zeroed by the caller) are contiguous float32 device arrays. Launches
// on `stream` and returns cudaGetLastError() (0 = success).
extern "C" int hash_table_grad_launch(const float* x, const float* g,
                                      float* dtable, const float* scales,
                                      const int* lvl, int n_pts, int n_levels,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)n_pts * n_levels;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  hash_table_grad_kernel<<<blocks, kThreads, 0, s>>>(
      x, reinterpret_cast<const float2*>(g), reinterpret_cast<float2*>(dtable),
      scales, lvl, n_pts, n_levels);
  return static_cast<int>(cudaGetLastError());
}
