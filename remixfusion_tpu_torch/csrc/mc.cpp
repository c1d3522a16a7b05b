// Isosurface extraction for TSDF volumes (marching tetrahedra).
//
// The port's copy of remixfusion_tpu/native/mc.cpp (the same code, built
// by remixfusion_tpu_torch/ops/build.py with the same g++ flags), which
// replaces the reference's vendored NumpyMarchingCubes extension and its
// skimage.measure.marching_cubes runtime path (reference: utils.py:168,
// model/Volume.py:1301). Each grid cell is split into 6 tetrahedra; each
// tetrahedron contributes 0-2 triangles with vertices linearly interpolated
// to the zero crossing. This is table-free and watertight per-cell, with
// sub-voxel surface placement identical to classic marching cubes on cube
// edges.
//
// Masking semantics: a cell is processed only if all 8 corners are masked
// valid (mirrors skimage's mask behavior used by the reference mesh path).
//
// Built as a plain shared library, driven from Python via ctypes.

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};

// Corner offsets of a unit cell, index 0..7.
const int kCorner[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1},
};

// Six tetrahedra covering the cube (all sharing the 0-6 diagonal).
const int kTets[6][4] = {
    {0, 5, 1, 6}, {0, 1, 2, 6}, {0, 2, 3, 6},
    {0, 3, 7, 6}, {0, 7, 4, 6}, {0, 4, 5, 6},
};

inline int64_t EdgeKey(int64_t a, int64_t b) {
  if (a > b) { int64_t t = a; a = b; b = t; }
  return (a << 32) | b;
}

struct Output {
  std::vector<float> verts;
  std::vector<int32_t> faces;
  std::unordered_map<int64_t, int32_t> edge_to_vert;
};

// Interpolated zero-crossing vertex on the edge between global grid nodes
// ga and gb with values va, vb. Deduplicated by edge key.
inline int32_t EdgeVertex(Output& out, int64_t ga, int64_t gb, const V3& pa,
                          const V3& pb, float va, float vb, float level) {
  int64_t key = EdgeKey(ga, gb);
  auto it = out.edge_to_vert.find(key);
  if (it != out.edge_to_vert.end()) return it->second;
  float denom = vb - va;
  float t = (denom == 0.0f) ? 0.5f : (level - va) / denom;
  if (t < 0.0f) t = 0.0f;
  if (t > 1.0f) t = 1.0f;
  V3 p{pa.x + t * (pb.x - pa.x), pa.y + t * (pb.y - pa.y),
       pa.z + t * (pb.z - pa.z)};
  int32_t idx = static_cast<int32_t>(out.verts.size() / 3);
  out.verts.push_back(p.x);
  out.verts.push_back(p.y);
  out.verts.push_back(p.z);
  out.edge_to_vert.emplace(key, idx);
  return idx;
}

}  // namespace

extern "C" {

// Returns 0 on success. Caller first invokes with count-only mode
// (verts==nullptr) is NOT supported; instead the caller passes generous
// capacity and we report the actual counts (negative return on overflow).
int marching_tetrahedra(const float* vol, const uint8_t* mask, int dx, int dy,
                        int dz, float level, float* out_verts,
                        int64_t max_verts, int32_t* out_faces,
                        int64_t max_faces, int64_t* n_verts,
                        int64_t* n_faces) {
  const int64_t sx = static_cast<int64_t>(dy) * dz;
  const int64_t sy = dz;
  Output out;
  out.verts.reserve(1 << 16);
  out.faces.reserve(1 << 16);

  for (int x = 0; x < dx - 1; ++x) {
    for (int y = 0; y < dy - 1; ++y) {
      for (int z = 0; z < dz - 1; ++z) {
        int64_t gid[8];
        float val[8];
        V3 pos[8];
        bool ok = true;
        bool any_neg = false, any_pos = false;
        for (int c = 0; c < 8; ++c) {
          int cx = x + kCorner[c][0];
          int cy = y + kCorner[c][1];
          int cz = z + kCorner[c][2];
          int64_t g = static_cast<int64_t>(cx) * sx + cy * sy + cz;
          if (mask && !mask[g]) { ok = false; break; }
          gid[c] = g;
          val[c] = vol[g];
          pos[c] = V3{static_cast<float>(cx), static_cast<float>(cy),
                      static_cast<float>(cz)};
          if (val[c] < level) any_neg = true; else any_pos = true;
        }
        if (!ok || !any_neg || !any_pos) continue;

        for (int t = 0; t < 6; ++t) {
          const int* tet = kTets[t];
          int below[4], above[4];
          int nb = 0, na = 0;
          for (int k = 0; k < 4; ++k) {
            if (val[tet[k]] < level) below[nb++] = tet[k];
            else above[na++] = tet[k];
          }
          if (nb == 0 || nb == 4) continue;

          if (nb == 1 || nb == 3) {
            // One vertex on one side: a single triangle.
            int apex = (nb == 1) ? below[0] : above[0];
            const int* others = (nb == 1) ? above : below;
            int32_t v0 = EdgeVertex(out, gid[apex], gid[others[0]], pos[apex],
                                    pos[others[0]], val[apex], val[others[0]],
                                    level);
            int32_t v1 = EdgeVertex(out, gid[apex], gid[others[1]], pos[apex],
                                    pos[others[1]], val[apex], val[others[1]],
                                    level);
            int32_t v2 = EdgeVertex(out, gid[apex], gid[others[2]], pos[apex],
                                    pos[others[2]], val[apex], val[others[2]],
                                    level);
            out.faces.push_back(v0);
            out.faces.push_back(v1);
            out.faces.push_back(v2);
          } else {
            // 2-2 split: a quad, emitted as two triangles.
            int b0 = below[0], b1 = below[1], a0 = above[0], a1 = above[1];
            int32_t v00 = EdgeVertex(out, gid[b0], gid[a0], pos[b0], pos[a0],
                                     val[b0], val[a0], level);
            int32_t v01 = EdgeVertex(out, gid[b0], gid[a1], pos[b0], pos[a1],
                                     val[b0], val[a1], level);
            int32_t v10 = EdgeVertex(out, gid[b1], gid[a0], pos[b1], pos[a0],
                                     val[b1], val[a0], level);
            int32_t v11 = EdgeVertex(out, gid[b1], gid[a1], pos[b1], pos[a1],
                                     val[b1], val[a1], level);
            out.faces.push_back(v00);
            out.faces.push_back(v01);
            out.faces.push_back(v11);
            out.faces.push_back(v00);
            out.faces.push_back(v11);
            out.faces.push_back(v10);
          }
        }
      }
    }
  }

  *n_verts = static_cast<int64_t>(out.verts.size() / 3);
  *n_faces = static_cast<int64_t>(out.faces.size() / 3);
  if (*n_verts > max_verts || *n_faces > max_faces) return -1;
  std::memcpy(out_verts, out.verts.data(), out.verts.size() * sizeof(float));
  std::memcpy(out_faces, out.faces.data(), out.faces.size() * sizeof(int32_t));
  return 0;
}

}  // extern "C"
