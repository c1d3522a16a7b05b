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
// bench widths) is written once: ~27 MB or ~8 us at 3.35 TB/s for the
// 151k-point render backward. What costs is contention: 8 float2 atomics
// per (point, level), and the dense coarse levels are small (level 0 has
// 4,096 rows) while neighbouring samples of a ray land in the same rows.
//
// Design:
//   - persistent CTAs of 16 warps, several per SM; each takes a contiguous
//     range of points (render points are ray-major, so a CTA's points share
//     coarse rows) and walks it in chunks of 32 points;
//   - a chunk's g [32, L, 2] is read coalesced into shared memory and read
//     back transposed: warp w takes level w (and w + 16, ...) of the chunk's
//     32 points, one per lane, so a warp holds 32 neighbouring samples of
//     one level;
//   - every warp combines the lanes that hold the same row before it adds,
//     and one lane adds each group's sum: on the other levels, runs of equal
//     rows in consecutive lanes (ray-ordered samples repeat a row in
//     neighbouring lanes) are summed by a segmented shuffle scan; on level
//     0, __match_any_sync groups every set of equal rows in the warp and a
//     shuffle tree sums each group into its lowest lane;
//   - level 0 (the smallest dense level: 4,096 rows, 32,768 B at the bench
//     widths) is accumulated in dynamic shared memory when it fits and
//     flushed once per CTA, one global float2 atomic per row the CTA
//     touched (rows nobody touched stay exactly zero). Warp 0 alone owns
//     level 0, and after the full combine one lane holds each row, so the
//     update is a plain read-modify-write: a float atomicAdd on shared
//     memory is a compare-and-swap loop on this card. PERF.md has the sweep on
//     an H100 (levels in shared memory, CTAs per SM, how rows are combined)
//     that chose this design at 3 CTAs per SM;
//   - the other levels go to the zeroed table gradient in global memory,
//     one float2 atomicAdd per combined row;
//   - each thread recomputes its 8 corner rows and weights from x with the
//     forward's arithmetic (nothing of the forward is saved but x): pos =
//     x * scale + 0.5 computed in double and rounded once to float (the JAX
//     forward is a fused multiply-add, and the port's PyTorch forward computes
//     it in double the same way), corner = floor(pos), frac = pos - corner,
//     uint32 dense index or spatial hash, mod the level size, plus the level
//     offset; the library is built with --fmad=false so no other product and
//     sum are contracted, and a gradient never lands in a row the forward did
//     not read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;       // points per chunk, one per lane
constexpr int kMaxLevels = 32;
constexpr int kGStride = 2 * kMaxLevels + 2;  // = 2 mod 32: no bank conflict
constexpr uint32_t kPrime1 = 2654435761u;
constexpr uint32_t kPrime2 = 805459861u;
constexpr uint32_t kNoRow = 0xffffffffu;

__device__ __forceinline__ void add2(float2* dst, float a, float b) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && CUDART_VERSION >= 12010
  atomicAdd(dst, make_float2(a, b));
#else
  atomicAdd(&dst->x, a);
  atomicAdd(&dst->y, b);
#endif
}

// Sum (a, b) over the lanes of `peers` (this lane's group of equal rows)
// into the group's lowest lane: a tree over each group's lanes in lane
// order (segmented warp reduction). Every lane of the warp calls it.
__device__ __forceinline__ void reduce_peers(unsigned peers, int lane,
                                             float& a, float& b) {
  int rel = __popc(peers & ((1u << lane) - 1u));  // position in the group
  unsigned rest = peers & (0xfffffffeu << lane);  // higher lanes of it
  while (__any_sync(0xffffffffu, rest != 0u)) {
    const int next = __ffs(rest);  // 1 + next pending lane, 0 if none
    const int src = next ? next - 1 : lane;
    const float ta = __shfl_sync(0xffffffffu, a, src);
    const float tb = __shfl_sync(0xffffffffu, b, src);
    if (next) {
      a += ta;
      b += tb;
    }
    rest &= ~__ballot_sync(0xffffffffu, rel & 1);
    rel >>= 1;
  }
}

// Sum the contributions (a, b) of every group of lanes that hold the same
// row into the group's lowest lane; true on that lane. Every lane of the
// warp calls it.
__device__ __forceinline__ bool combine_groups(uint32_t row, int lane,
                                               float& a, float& b) {
  const unsigned peers = __match_any_sync(0xffffffffu, row);
  reduce_peers(peers, lane, a, b);
  return (peers & ((1u << lane) - 1u)) == 0u;
}

// Sum the contributions (a, b) of each run of equal rows in consecutive
// lanes into the run's first lane (a segmented sum over shuffles); true on
// that lane. Every lane of the warp calls it.
__device__ __forceinline__ bool combine_runs(uint32_t row, int lane, float& a,
                                             float& b) {
  const uint32_t prev = __shfl_up_sync(0xffffffffu, row, 1);
  const bool head = lane == 0 || prev != row;
  const unsigned later =
      __ballot_sync(0xffffffffu, head) & ~((2u << lane) - 1u);
  const int end = later ? __ffs(later) - 1 : 32;  // this run's end
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float ta = __shfl_down_sync(0xffffffffu, a, off);
    const float tb = __shfl_down_sync(0xffffffffu, b, off);
    if (lane + off < end) {
      a += ta;
      b += tb;
    }
  }
  return head;
}

// lvl: int32 [4, L], rows res / size / offset / hashed. Dynamic shared
// memory: priv_rows float2 accumulators of level 0 (global rows [0,
// priv_rows)), or none when priv_rows is 0.
__global__ void __launch_bounds__(kThreads)
    hash_table_grad_kernel(const float* __restrict__ x,
                           const float2* __restrict__ g,
                           float2* __restrict__ dtable,
                           const float* __restrict__ scales,
                           const int* __restrict__ lvl, int n_pts,
                           int n_levels, int priv_rows) {
  extern __shared__ float2 s_acc[];
  __shared__ __align__(16) float s_g[kChunk * kGStride];
  __shared__ float s_x[kChunk * 3];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int r = tid; r < priv_rows; r += kThreads)
    s_acc[r] = make_float2(0.f, 0.f);

  const long long n_chunks = (n_pts + kChunk - 1) / kChunk;
  const int c_begin = (int)(n_chunks * blockIdx.x / gridDim.x);
  const int c_end = (int)(n_chunks * (blockIdx.x + 1) / gridDim.x);

  for (int ch = c_begin; ch < c_end; ++ch) {
    const int n0 = ch * kChunk;
    const int n_here = min(kChunk, n_pts - n0);
    __syncthreads();  // the previous chunk is consumed (and s_acc zeroed)
    const float2* gc = g + (size_t)n0 * n_levels;
    for (int i = tid; i < n_here * n_levels; i += kThreads) {
      const int p = i / n_levels, l = i - p * n_levels;
      *reinterpret_cast<float2*>(s_g + p * kGStride + 2 * l) = gc[i];
    }
    for (int i = tid; i < n_here * 3; i += kThreads)
      s_x[i] = x[(size_t)n0 * 3 + i];
    __syncthreads();

    const bool active = lane < n_here;
    for (int l = warp; l < n_levels; l += kWarps) {
      const double s = (double)scales[l];
      const uint32_t res = (uint32_t)lvl[l];
      const uint32_t size = (uint32_t)lvl[n_levels + l];
      const uint32_t off = (uint32_t)lvl[2 * n_levels + l];
      const bool hashed = lvl[3 * n_levels + l] != 0;
      const uint32_t res2 = res * res;
      const bool priv = l == 0 && priv_rows > 0;  // warp-uniform

      int c[3];
      float fr[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float xa = active ? s_x[lane * 3 + a] : 0.f;
        const double p = __dadd_rn(__dmul_rn((double)xa, s), 0.5);
        const float pos = __double2float_rn(p);
        const float fl = floorf(pos);
        fr[a] = pos - fl;
        c[a] = (int)fl;
      }
      float2 gv = make_float2(0.f, 0.f);
      if (active)
        gv = *reinterpret_cast<const float2*>(s_g + lane * kGStride + 2 * l);

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
        float ax = w * gv.x, ay = w * gv.y;
        const uint32_t key = active ? row : kNoRow;
        if (priv) {
          // this warp alone owns level 0's rows, and after the full combine
          // one lane holds each row: a plain read-modify-write suffices
          if (combine_groups(key, lane, ax, ay) && active) {
            float2 v = s_acc[row];
            v.x += ax;
            v.y += ay;
            s_acc[row] = v;
          }
          __syncwarp();
        } else if (combine_runs(key, lane, ax, ay) && active) {
          add2(dtable + row, ax, ay);
        }
      }
    }
  }

  __syncthreads();
  for (int r = tid; r < priv_rows; r += kThreads) {
    const float2 v = s_acc[r];
    if (v.x != 0.f || v.y != 0.f) add2(dtable + r, v.x, v.y);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). x [N, 3], g [N, L, 2] and dtable
// [T, 2] (zeroed by the caller) are contiguous float32 device arrays; level 0
// occupies rows [0, priv_rows) and is accumulated in priv_rows * 8 bytes of
// shared memory per CTA (priv_rows 0: not privatized); n_ctas persistent
// CTAs. Launches on `stream` and returns the CUDA error code (0 = success).
extern "C" int hash_table_grad_launch(const float* x, const float* g,
                                      float* dtable, const float* scales,
                                      const int* lvl, int n_pts, int n_levels,
                                      int priv_rows, int n_ctas,
                                      void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_ctas < 1 || priv_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static int smem_set = 0;  // dynamic bytes allowed so far
  const int smem = priv_rows * (int)sizeof(float2);
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        hash_table_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  hash_table_grad_kernel<<<n_ctas, kThreads, smem, s>>>(
      x, reinterpret_cast<const float2*>(g), reinterpret_cast<float2*>(dtable),
      scales, lvl, n_pts, n_levels, priv_rows);
  return static_cast<int>(cudaGetLastError());
}
