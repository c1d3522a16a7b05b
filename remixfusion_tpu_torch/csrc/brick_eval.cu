// Fused brick-window candidate scoring for randomized pose optimization.
//
// Replaces the Pallas TPU kernel remixfusion_tpu/ops/pallas/brick_eval.py
// (_kernel, called through brick_eval). For every pose candidate c (a PST
// table row scaled by the search size: translation t, quaternion vector q,
// q0 = sqrt(1 - |q|^2)) and every tier pixel p it transforms the pre-rotated
// vertex g_p, x' = g + 2 q0 (q x g) + 2 q x (q x g) + t + T, checks that x'
// reprojects into the image in front of the camera, looks x' up in the
// pixel's 4^3 TSDF window (nearest: rint + in-window test; trilinear: 8
// corners + in-cube test) and accumulates |tsdf - expected| and a count per
// candidate. The result is sum / (count + 1e-6), or 1e6 where the count
// falls below half the identity candidate's count.
//
// Bound: ~70 FP32 operations per (candidate, pixel) pair against ~1.4 MB of
// inputs at the finest tier (C=1024, P=4800: 4.9 M pairs, ~5 us of FP32 at
// 67 TFLOP/s): compute-bound, and at these sizes a launch is short enough
// that latency (window gathers from a volume larger than L2, dependent
// divisions) and the launch's tail decide its time. Design:
//   - windows are read from the volume inside the kernel: with a per-pixel
//     integer base the 4^3 cells of pixel p are gathered from the
//     brick-major volume (bm_vox_flat's index arithmetic; a window may cross
//     a brick face on any axis) and, for a bfloat16 track view, rounded
//     through bf16 in registers, which equals .to(bfloat16).to(float32); a
//     float32 track view scores the cells as they are (a template argument:
//     one instantiation per lookup mode and rounding);
//   - each thread owns kCand = 2 candidates (their poses stay in registers,
//     the pixel's attributes read from shared memory serve both), a CTA of
//     8 warps owns 512 candidates and a range of pixels; the pixel axis is
//     split over gridDim.y so that the SMs are filled as far as the
//     registers allow (three CTAs each, ~24 warps an SM). 1 and 4
//     candidates per thread were slower at the 10,240-candidate tier on an
//     H100 (PERF.md has the times);
//   - pixel tiles of 8 (attributes + 512 window cells) are staged with
//     cp.async into two shared-memory buffers: the next tile's gathers are
//     in flight while the threads score the current one;
//   - one launch: every CTA writes its per-split partial sums and counts,
//     and the last CTA of each candidate block (a counter per block, reset
//     by that CTA) sums them over the splits in a fixed order and applies
//     the low-count guard. The guard needs candidate 0's count over all
//     pixels: warp 0 of every CTA counts candidate 0 over its split's
//     pixels, so each candidate block holds the whole count itself (counts
//     are integers, exact in any order). No atomics on the sums: every run
//     gives the same bits.
// Numerics follow the JAX kernel, not C habits: rintf (half to even) for
// jnp.round, floorf(x * f / z + c + 0.5f) for the pixel test, IEEE division
// and sqrt, and the operation order of the JAX expressions. The library is
// built with --fmad=false so no a*b+c is contracted into an FMA that could
// flip a floor or rint at a pixel or voxel boundary.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTilePix = 8;   // pixels per staged tile
constexpr int kCells = 64;    // 4^3 window cells
constexpr int kAttrs = 8;     // gx gy gz gt bx by bz ok
constexpr int kCand = 2;      // candidates per thread
constexpr int kMinCtas = 3;   // CTAs an SM holds at that register use

struct Frame {
  float R00, R01, R02, R10, R11, R12, R20, R21, R22;
  float Tx, Ty, Tz, fx, fy, cx, cy, Wf, Hf, inv_vox;
};

struct Pose {
  float t0, t1, t2, qx, qy, qz, q02;
};

__device__ __forceinline__ Pose load_pose(const float* __restrict__ table,
                                          const float* s_par, int n_cand,
                                          int c) {
  Pose p{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (c < n_cand) {
    p.t0 = table[0 * n_cand + c] * s_par[12];
    p.t1 = table[1 * n_cand + c] * s_par[13];
    p.t2 = table[2 * n_cand + c] * s_par[14];
    p.qx = table[3 * n_cand + c] * s_par[15];
    p.qy = table[4 * n_cand + c] * s_par[16];
    p.qz = table[5 * n_cand + c] * s_par[17];
  }
  const float q0 = sqrtf(
      fmaxf(1.0f - (p.qx * p.qx + p.qy * p.qy + p.qz * p.qz), 1e-12f));
  p.q02 = 2.0f * q0;
  return p;
}

// One (candidate, pixel) pair: true if it counts (ok, in image, in window),
// with the looked-up TSDF value in *val.
template <bool kTrilinear>
__device__ __forceinline__ bool pair_value(const Frame& F, const Pose& c,
                                           const float* a, const float* w,
                                           float* val) {
  const float gx = a[0], gy = a[1], gz = a[2];
  const float bx = a[4], by = a[5], bz = a[6];
  const bool ok = a[7] > 0.f;

  const float c1x = c.qy * gz - c.qz * gy;
  const float c1y = c.qz * gx - c.qx * gz;
  const float c1z = c.qx * gy - c.qy * gx;
  const float c2x = c.qy * c1z - c.qz * c1y;
  const float c2y = c.qz * c1x - c.qx * c1z;
  const float c2z = c.qx * c1y - c.qy * c1x;
  const float xw = gx + c.q02 * c1x + 2.0f * c2x + c.t0 + F.Tx;
  const float yw = gy + c.q02 * c1y + 2.0f * c2y + c.t1 + F.Ty;
  const float zw = gz + c.q02 * c1z + 2.0f * c2z + c.t2 + F.Tz;

  const float rx = xw - F.Tx, ry = yw - F.Ty, rz = zw - F.Tz;
  const float cam_x = F.R00 * rx + F.R10 * ry + F.R20 * rz;
  const float cam_y = F.R01 * rx + F.R11 * ry + F.R21 * rz;
  const float cam_z = F.R02 * rx + F.R12 * ry + F.R22 * rz;
  const float safe_z = cam_z != 0.f ? cam_z : 1e-9f;
  const float px = floorf(cam_x * F.fx / safe_z + F.cx + 0.5f);
  const float py = floorf(cam_y * F.fy / safe_z + F.cy + 0.5f);
  const bool in_img = px >= 0.f && py >= 0.f && px < F.Wf && py < F.Hf &&
                      cam_z >= 0.f;
  if (!(ok && in_img)) return false;

  if (kTrilinear) {
    const float fxc = xw * F.inv_vox - bx;
    const float fyc = yw * F.inv_vox - by;
    const float fzc = zw * F.inv_vox - bz;
    if (!(fxc >= 0.f && fxc <= 3.f && fyc >= 0.f && fyc <= 3.f &&
          fzc >= 0.f && fzc <= 3.f))
      return false;
    const float ix = fminf(fmaxf(floorf(fxc), 0.f), 2.f);
    const float iy = fminf(fmaxf(floorf(fyc), 0.f), 2.f);
    const float iz = fminf(fmaxf(floorf(fzc), 0.f), 2.f);
    const float tx = fminf(fmaxf(fxc - ix, 0.f), 1.f);
    const float ty = fminf(fmaxf(fyc - iy, 0.f), 1.f);
    const float tz = fminf(fmaxf(fzc - iz, 0.f), 1.f);
    const int o = (int)((ix * 4.f + iy) * 4.f + iz);
    const float v000 = w[o], v001 = w[o + 1];
    const float v010 = w[o + 4], v011 = w[o + 5];
    const float v100 = w[o + 16], v101 = w[o + 17];
    const float v110 = w[o + 20], v111 = w[o + 21];
    const float c00 = v000 + tz * (v001 - v000);
    const float c01 = v010 + tz * (v011 - v010);
    const float c10 = v100 + tz * (v101 - v100);
    const float c11 = v110 + tz * (v111 - v110);
    const float c0 = c00 + ty * (c01 - c00);
    const float c1 = c10 + ty * (c11 - c10);
    *val = c0 + tx * (c1 - c0);
  } else {
    const float ox = rintf(xw * F.inv_vox) - bx;
    const float oy = rintf(yw * F.inv_vox) - by;
    const float oz = rintf(zw * F.inv_vox) - bz;
    if (!(ox >= 0.f && ox < 4.f && oy >= 0.f && oy < 4.f && oz >= 0.f &&
          oz < 4.f))
      return false;
    // truncate then clip like the TPU kernel (fractional offsets when the
    // volume origin is off the voxel lattice)
    *val = w[min(max((int)((ox * 4.f + oy) * 4.f + oz), 0), 63)];
  }
  return true;
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

struct Volume {
  const float* data;     // brick-major [NB, >=b^3]
  long long row_stride;  // floats between bricks
  const int* base;       // [P, 3] window origins
  int b, BY, BZ;
};

// Flat offset of cell k of pixel p's window in the volume.
__device__ __forceinline__ long long cell_offset(const Volume& v, int p,
                                                 int k) {
  const int vx = __ldg(v.base + 3 * p + 0) + (k >> 4);
  const int vy = __ldg(v.base + 3 * p + 1) + ((k >> 2) & 3);
  const int vz = __ldg(v.base + 3 * p + 2) + (k & 3);
  const int b = v.b;
  const long long bid =
      ((long long)(vx / b) * v.BY + vy / b) * v.BZ + vz / b;
  const int within = ((vx % b) * b + vy % b) * b + vz % b;
  return bid * v.row_stride + within;
}

// Issue the cp.async copies of one tile (n_here pixels from p0).
__device__ __forceinline__ void stage_tile(float* s_attr, float* s_win,
                                           const float* __restrict__ pix,
                                           int pix_stride, const Volume& v,
                                           int p0, int n_here) {
  for (int i = threadIdx.x; i < n_here * kAttrs; i += kThreads)
    cp_async4(s_attr + i,
              pix + (size_t)(p0 + i / kAttrs) * pix_stride + i % kAttrs);
  for (int i = threadIdx.x; i < n_here * kCells; i += kThreads)
    cp_async4(s_win + i, v.data + cell_offset(v, p0 + i / kCells,
                                              i % kCells));
}

template <bool kTrilinear, bool kRoundBf16>
__global__ void __launch_bounds__(kThreads, kMinCtas)
brick_eval_kernel(const float* __restrict__ params,
                  const float* __restrict__ pix, int pix_stride, Volume vol,
                  const float* __restrict__ table,
                  float* __restrict__ partial, float* __restrict__ count0,
                  unsigned* __restrict__ done, float* __restrict__ out,
                  int n_cand, int n_pix, int pix_per_split) {
  __shared__ __align__(16) float s_attr[2][kTilePix * kAttrs];
  __shared__ __align__(16) float s_win[2][kTilePix * kCells];
  __shared__ float s_par[32];
  __shared__ Pose s_pose0;
  __shared__ bool s_last;

  const int tid = threadIdx.x, lane = tid & 31;
  const int cb = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int p_begin = split * pix_per_split;
  const int p_end = min(n_pix, p_begin + pix_per_split);
  const int n_tiles = (p_end - p_begin + kTilePix - 1) / kTilePix;

  // the first tile's gathers go out before anything else
  stage_tile(s_attr[0], s_win[0], pix, pix_stride, vol, p_begin,
             min(kTilePix, p_end - p_begin));
  cp_async_commit();

  if (tid < 32) s_par[tid] = params[tid];
  __syncthreads();
  const Frame F{s_par[0],  s_par[1],  s_par[2],  s_par[3],  s_par[4],
                s_par[5],  s_par[6],  s_par[7],  s_par[8],  s_par[9],
                s_par[10], s_par[11], s_par[18], s_par[19], s_par[20],
                s_par[21], s_par[22], s_par[23], s_par[24]};
  if (tid == 0) s_pose0 = load_pose(table, s_par, n_cand, 0);

  constexpr int kCandPerCta = kThreads * kCand;
  Pose cand[kCand];
  float sum[kCand], cnt[kCand];
#pragma unroll
  for (int j = 0; j < kCand; ++j) {
    cand[j] = load_pose(table, s_par, n_cand,
                        cb * kCandPerCta + j * kThreads + tid);
    sum[j] = 0.f;
    cnt[j] = 0.f;
  }
  float cnt0 = 0.f;  // warp 0: candidate 0's count, lane = pixel in tile

  for (int t = 0; t < n_tiles; ++t) {
    const int cur = t & 1;
    const int p0 = p_begin + t * kTilePix;
    const int n_here = min(kTilePix, p_end - p0);
    if (t + 1 < n_tiles) {
      const int p1 = p0 + kTilePix;
      stage_tile(s_attr[cur ^ 1], s_win[cur ^ 1], pix, pix_stride, vol, p1,
                 min(kTilePix, p_end - p1));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // each thread rounds the cells it copied itself through bf16
    if (kRoundBf16)
      for (int i = tid; i < n_here * kCells; i += kThreads)
        s_win[cur][i] = __bfloat162float(__float2bfloat16_rn(s_win[cur][i]));
    __syncthreads();

    for (int p = 0; p < n_here; ++p) {
      const float* a = s_attr[cur] + p * kAttrs;
      if (!(a[7] > 0.f)) continue;  // pixel not ok: no pair of it counts
      const float* w = s_win[cur] + p * kCells;
#pragma unroll
      for (int j = 0; j < kCand; ++j) {
        float val;
        if (pair_value<kTrilinear>(F, cand[j], a, w, &val)) {
          sum[j] += fabsf(val - a[3]);
          cnt[j] += 1.f;
        }
      }
    }
    if (tid < n_here) {
      float val;
      const Pose c0 = s_pose0;
      if (pair_value<kTrilinear>(F, c0, s_attr[cur] + tid * kAttrs,
                                 s_win[cur] + tid * kCells, &val))
        cnt0 += 1.f;
    }
    __syncthreads();  // the buffer is refilled two tiles on
  }

#pragma unroll
  for (int j = 0; j < kCand; ++j) {
    const int c = cb * kCandPerCta + j * kThreads + tid;
    if (c < n_cand) {
      partial[(size_t)(split * 2 + 0) * n_cand + c] = sum[j];
      partial[(size_t)(split * 2 + 1) * n_cand + c] = cnt[j];
    }
  }
  if (tid < 32) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      cnt0 += __shfl_down_sync(0xffffffffu, cnt0, off);
    if (lane == 0) count0[(size_t)cb * splits + split] = cnt0;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(done + cb, 1u) == (unsigned)(splits - 1);
  __syncthreads();
  if (!s_last) return;

  // last CTA of this candidate block: fixed-order sum over the splits
  __threadfence();
  float sc0 = 0.f;
  for (int s = 0; s < splits; ++s)
    sc0 += __ldcg(count0 + (size_t)cb * splits + s);
#pragma unroll
  for (int j = 0; j < kCand; ++j) {
    const int c = cb * kCandPerCta + j * kThreads + tid;
    if (c >= n_cand) continue;
    float sv = 0.f, sc = 0.f;
    for (int s = 0; s < splits; ++s) {
      sv += __ldcg(partial + (size_t)(s * 2 + 0) * n_cand + c);
      sc += __ldcg(partial + (size_t)(s * 2 + 1) * n_cand + c);
    }
    const float cost = sv / (sc + 1e-6f);
    out[c] = sc >= 0.5f * sc0 ? cost : 1e6f;
  }
  if (tid == 0) done[cb] = 0u;  // ready for the next launch
}

}  // namespace

// Plain C entry point (bound with ctypes). One launch on `stream`; returns
// cudaGetLastError() of the launch (0 = success).
//   vol, vol_stride: the brick-major volume [NB, >=b^3] (row stride in
//     floats), base int32 [P, 3] the window origins, layout (b, BY, BZ);
//     every window lies inside the volume;
//   partial: scratch of 2 * splits * n_cand + cblocks * splits floats, with
//     cblocks = ceil(n_cand / 512);
//   done: cblocks zeroed counters (left zeroed again by the launch);
//   splits * pix_per_split >= n_pix > (splits - 1) * pix_per_split;
//   round_bf16: round the window cells through bf16 (a bfloat16 track
//     view) or score them as float32.
extern "C" int brick_eval_launch(const float* params, const float* pix,
                                 int pix_stride, const float* vol,
                                 long long vol_stride, const int* base,
                                 int b, int BY, int BZ, const float* table,
                                 float* partial, unsigned* done, float* out,
                                 int n_cand, int n_pix, int splits,
                                 int pix_per_split, int trilinear,
                                 int round_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int per_cta = kThreads * kCand;
  const dim3 grid((n_cand + per_cta - 1) / per_cta, splits);
  const Volume v{vol, vol_stride, base, b, BY, BZ};
  float* count0 = partial + (size_t)2 * splits * n_cand;
  auto kernel = trilinear ? (round_bf16 ? brick_eval_kernel<true, true>
                                        : brick_eval_kernel<true, false>)
                          : (round_bf16 ? brick_eval_kernel<false, true>
                                        : brick_eval_kernel<false, false>);
  kernel<<<grid, kThreads, 0, s>>>(params, pix, pix_stride, v, table,
                                   partial, count0, done, out, n_cand, n_pix,
                                   pix_per_split);
  return static_cast<int>(cudaGetLastError());
}
