"""Mesh depth rendering: the z-buffer rasterizer in host C++
(csrc/raster.cpp), and its plain numpy version.

Counterpart of remixfusion_tpu.utils.raster. `render_mesh_depth` runs the
native library, built by ops/build.py with g++ at first use (a failed build
raises: there is no silent numpy fallback); `render_mesh_depth_reference`
is the per-triangle numpy loop the tests hold it against (test-size meshes
only).
"""

from __future__ import annotations

import ctypes

import numpy as np

from remixfusion_tpu_torch.ops import build

_fp = ctypes.POINTER(ctypes.c_float)


def _lib():
    lib = build.load_host("raster")
    if lib.render_depth.argtypes is None:
        lib.render_depth.restype = None
        lib.render_depth.argtypes = [
            _fp, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float, _fp]
    return lib


def _camera_vertices(verts, c2w):
    """World vertices [V, 3] -> camera frame (float64 w2c, float32 out)."""
    verts = np.asarray(verts, np.float32)
    c2w = np.asarray(c2w, np.float64)
    w2c_R = c2w[:3, :3].T
    w2c_t = -w2c_R @ c2w[:3, 3]
    return np.ascontiguousarray((verts @ w2c_R.T + w2c_t).astype(np.float32))


def render_mesh_depth(verts, faces, K, c2w, H, W, near_clip=1e-4):
    """Depth image [H, W] of the mesh from camera pose c2w (OpenCV
    pinhole): 0 where no geometry is hit, double-sided, perspective-correct
    z."""
    faces = np.ascontiguousarray(faces, np.int32)
    cam = _camera_vertices(verts, c2w)
    if faces.ndim != 2 or faces.shape[1] != 3 or (len(faces) and (
            faces.min() < 0 or faces.max() >= len(cam))):
        raise ValueError("faces must be [F, 3] indices into the vertices")
    out = np.zeros((H, W), np.float32)
    _lib().render_depth(
        cam.ctypes.data_as(_fp), len(cam),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(faces),
        float(K[0][0]), float(K[1][1]), float(K[0][2]), float(K[1][2]),
        H, W, near_clip, out.ctypes.data_as(_fp))
    return out


def render_mesh_depth_reference(verts, faces, K, c2w, H, W, near_clip=1e-4):
    """render_mesh_depth as a numpy loop over the triangles."""
    faces = np.ascontiguousarray(faces, np.int32)
    cam = _camera_vertices(verts, c2w)
    out = np.zeros((H, W), np.float32)
    fx, fy, cx, cy = K[0][0], K[1][1], K[0][2], K[1][2]
    for tri in faces:
        v = cam[tri]
        if (v[:, 2] <= near_clip).any():
            continue
        px = fx * v[:, 0] / v[:, 2] + cx
        py = fy * v[:, 1] / v[:, 2] + cy
        min_x = max(0, int(np.floor(px.min())))
        max_x = min(W - 1, int(np.ceil(px.max())))
        min_y = max(0, int(np.floor(py.min())))
        max_y = min(H - 1, int(np.ceil(py.max())))
        if min_x > max_x or min_y > max_y:
            continue
        e1 = np.array([px[1] - px[0], py[1] - py[0]])
        e2 = np.array([px[2] - px[0], py[2] - py[0]])
        det = e1[0] * e2[1] - e1[1] * e2[0]
        if abs(det) < 1e-12:
            continue
        xs, ys = np.meshgrid(np.arange(min_x, max_x + 1),
                             np.arange(min_y, max_y + 1))
        dx = xs - px[0]
        dy = ys - py[0]
        b1 = (dx * e2[1] - dy * e2[0]) / det
        b2 = (dy * e1[0] - dx * e1[1]) / det
        b0 = 1.0 - b1 - b2
        inside = (b0 >= -1e-6) & (b1 >= -1e-6) & (b2 >= -1e-6)
        iz = b0 / v[0, 2] + b1 / v[1, 2] + b2 / v[2, 2]
        z = np.where(iz > 0, 1.0 / np.maximum(iz, 1e-12), np.inf)
        sub = out[min_y:max_y + 1, min_x:max_x + 1]
        upd = inside & ((sub == 0) | (z < sub))
        sub[upd] = z[upd]
    return out
