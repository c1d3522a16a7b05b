// Minimal z-buffer triangle rasterizer for mesh depth rendering (the
// port's copy of remixfusion_tpu/native/raster.cpp, built by
// remixfusion_tpu_torch/ops/build.py).
//
// Replaces the reference's open3d / pyrender offscreen depth renders used by
// mesh evaluation and occlusion culling (reference tools/eval_recon.py:157-322,
// tools/cull_mesh.py:82-125). Renders double-sided (no backface culling),
// matching pyrender's double-sided depth pass.
//
// Inputs are camera-space vertices (the caller applies the w2c transform);
// projection is a simple pinhole with fx, fy, cx, cy.

#include <algorithm>
#include <cmath>
#include <cstdint>

extern "C" {

// verts_cam: [V, 3] camera-space; faces: [F, 3]; out_depth: [H, W]
// (preinitialized by caller to 0 = no hit).
void render_depth(const float* verts_cam, int64_t n_verts,
                  const int32_t* faces, int64_t n_faces, float fx, float fy,
                  float cx, float cy, int h, int w, float near_clip,
                  float* out_depth) {
  (void)n_verts;
  for (int64_t f = 0; f < n_faces; ++f) {
    const int32_t* tri = faces + 3 * f;
    float px[3], py[3], pz[3];
    bool ok = true;
    for (int k = 0; k < 3; ++k) {
      const float* v = verts_cam + 3 * tri[k];
      float z = v[2];
      if (z <= near_clip) { ok = false; break; }
      px[k] = fx * v[0] / z + cx;
      py[k] = fy * v[1] / z + cy;
      pz[k] = z;
    }
    if (!ok) continue;  // near-plane clipping: drop the triangle

    int min_x = std::max(0, (int)std::floor(std::min({px[0], px[1], px[2]})));
    int max_x = std::min(w - 1, (int)std::ceil(std::max({px[0], px[1], px[2]})));
    int min_y = std::max(0, (int)std::floor(std::min({py[0], py[1], py[2]})));
    int max_y = std::min(h - 1, (int)std::ceil(std::max({py[0], py[1], py[2]})));
    if (min_x > max_x || min_y > max_y) continue;

    float x0 = px[0], y0 = py[0];
    float e1x = px[1] - x0, e1y = py[1] - y0;
    float e2x = px[2] - x0, e2y = py[2] - y0;
    float det = e1x * e2y - e1y * e2x;
    if (std::fabs(det) < 1e-12f) continue;
    float inv_det = 1.0f / det;
    // Interpolate 1/z for perspective-correct depth.
    float iz0 = 1.0f / pz[0], iz1 = 1.0f / pz[1], iz2 = 1.0f / pz[2];

    for (int y = min_y; y <= max_y; ++y) {
      for (int x = min_x; x <= max_x; ++x) {
        float dx = x - x0, dy = y - y0;
        float b1 = (dx * e2y - dy * e2x) * inv_det;
        float b2 = (dy * e1x - dx * e1y) * inv_det;
        float b0 = 1.0f - b1 - b2;
        if (b0 < -1e-6f || b1 < -1e-6f || b2 < -1e-6f) continue;
        float iz = b0 * iz0 + b1 * iz1 + b2 * iz2;
        float z = 1.0f / iz;
        float* d = out_depth + (int64_t)y * w + x;
        if (*d == 0.0f || z < *d) *d = z;
      }
    }
  }
}

}  // extern "C"
