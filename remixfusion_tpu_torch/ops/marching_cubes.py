"""Isosurface extraction: marching tetrahedra in host C++ (csrc/mc.cpp).

Counterpart of remixfusion_tpu.ops.marching_cubes. `marching_cubes` runs the
native library, built by ops/build.py with g++ at first use (a failed build
raises: there is no silent numpy fallback). `marching_cubes_reference` is
the same algorithm vectorised in numpy, the plain version the tests hold
the native one against. Each cell is split into 6 tetrahedra sharing the
0-6 diagonal; a cell emits geometry only when its 8 corners change sign and
all 8 are True in `mask`.

The two number their vertices differently: the native code in first-seen
order, the numpy version by sorted edge key. They agree as meshes (sorted
vertices, faces remapped), to float rounding of the edge interpolation.
"""

from __future__ import annotations

import ctypes

import numpy as np

from remixfusion_tpu_torch.ops import build

# Six tetrahedra covering the cube, all sharing the 0-6 diagonal.
_CORNER = np.array(
    [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], dtype=np.int64)
_TETS = np.array(
    [[0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
     [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]], dtype=np.int64)

_fp = ctypes.POINTER(ctypes.c_float)


def _lib():
    lib = build.load_host("mc")
    if lib.marching_tetrahedra.argtypes is None:
        lib.marching_tetrahedra.restype = ctypes.c_int
        lib.marching_tetrahedra.argtypes = [
            _fp, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            _fp, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64)]
    return lib


def _native_mc(vol, mask, level):
    lib = _lib()
    vol = np.ascontiguousarray(vol, dtype=np.float32)
    dx, dy, dz = vol.shape
    if mask is not None:
        mask_arr = np.ascontiguousarray(mask, dtype=np.uint8)
        if mask_arr.shape != vol.shape:
            raise ValueError(f"mask shape {mask_arr.shape} does not match "
                             f"the volume's {vol.shape}")
        mask_ptr = mask_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    else:
        mask_ptr = ctypes.POINTER(ctypes.c_uint8)()
    # surface cells are a small fraction of the volume; the library
    # reports its counts, so an overflow retries with 4x the room
    cap_v = max(1 << 20, vol.size // 4)
    cap_f = cap_v * 4
    for _ in range(4):
        verts = np.empty((cap_v, 3), np.float32)
        faces = np.empty((cap_f, 3), np.int32)
        nv = ctypes.c_int64(0)
        nf = ctypes.c_int64(0)
        rc = lib.marching_tetrahedra(
            vol.ctypes.data_as(_fp), mask_ptr, dx, dy, dz,
            ctypes.c_float(level), verts.ctypes.data_as(_fp), cap_v,
            faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap_f,
            ctypes.byref(nv), ctypes.byref(nf))
        if rc == 0:
            return verts[: nv.value].copy(), faces[: nf.value].copy()
        cap_v *= 4
        cap_f *= 4
    raise RuntimeError("marching_tetrahedra: capacity overflow")


def marching_cubes_reference(vol, level: float = 0.0, mask=None):
    """Vectorised numpy marching tetrahedra (the native library's
    algorithm; vertices numbered by sorted edge key)."""
    vol = np.asarray(vol, np.float32)
    dx, dy, dz = vol.shape
    sx, sy = dy * dz, dz

    # active cells: a sign change within the cell, all 8 corners masked
    below = vol < level
    cell_any_b = np.zeros((dx - 1, dy - 1, dz - 1), bool)
    cell_all_b = np.ones((dx - 1, dy - 1, dz - 1), bool)
    cell_mask = np.ones((dx - 1, dy - 1, dz - 1), bool)
    for cx, cy, cz in _CORNER:
        b = below[cx: cx + dx - 1, cy: cy + dy - 1, cz: cz + dz - 1]
        cell_any_b |= b
        cell_all_b &= b
        if mask is not None:
            cell_mask &= np.asarray(mask, bool)[
                cx: cx + dx - 1, cy: cy + dy - 1, cz: cz + dz - 1]
    active = cell_any_b & ~cell_all_b & cell_mask
    cells = np.argwhere(active)  # [C, 3]
    if len(cells) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    corner_idx = (
        (cells[:, None, 0] + _CORNER[None, :, 0]) * sx
        + (cells[:, None, 1] + _CORNER[None, :, 1]) * sy
        + (cells[:, None, 2] + _CORNER[None, :, 2]))  # [C, 8] node ids
    vals = vol.reshape(-1)[corner_idx]  # [C, 8]

    # each emitted triangle is three (a, b) node-id edge pairs whose zero
    # crossings are its vertices; they are deduplicated at the end
    tri_a, tri_b = [], []
    for tet in _TETS:
        tb = vals[:, tet] < level  # [C, 4]
        nb = tb.sum(1)
        # one corner on its own side (1 or 3 below): one triangle
        for apex_below in (True, False):
            sel = nb == (1 if apex_below else 3)
            if not sel.any():
                continue
            tv = tb[sel]
            tidx = corner_idx[sel][:, tet]
            apex_pos = np.argmax(tv == apex_below, axis=1)
            rows = np.arange(len(tidx))
            apex = tidx[rows, apex_pos]
            keep = np.ones_like(tidx, bool)
            keep[rows, apex_pos] = False
            others = tidx[keep].reshape(-1, 3)
            tri_a.append(np.stack([apex, apex, apex], axis=1))
            tri_b.append(others)
        # 2-2 split: a quad, two triangles
        sel = nb == 2
        if sel.any():
            tv = tb[sel]
            tidx = corner_idx[sel][:, tet]
            order = np.argsort(~tv, axis=1, kind="stable")  # below first
            rows = np.arange(len(tidx))[:, None]
            sorted_idx = tidx[rows, order]
            b0, b1, a0, a1 = (sorted_idx[:, k] for k in range(4))
            # quad corners: v00=(b0,a0) v01=(b0,a1) v10=(b1,a0) v11=(b1,a1)
            tri_a.append(np.stack([b0, b0, b1], axis=1))
            tri_b.append(np.stack([a0, a1, a1], axis=1))
            tri_a.append(np.stack([b0, b1, b1], axis=1))
            tri_b.append(np.stack([a0, a1, a0], axis=1))

    ea = np.concatenate(tri_a, axis=0).reshape(-1)
    eb = np.concatenate(tri_b, axis=0).reshape(-1)

    lo = np.minimum(ea, eb)
    hi = np.maximum(ea, eb)
    key = lo * (dx * dy * dz) + hi
    uniq, inv = np.unique(key, return_inverse=True)
    ulo = uniq // (dx * dy * dz)
    uhi = uniq % (dx * dy * dz)
    va = vol.reshape(-1)[ulo]
    vb = vol.reshape(-1)[uhi]
    denom = vb - va
    t = np.where(denom == 0, 0.5, (level - va) / np.where(denom == 0, 1, denom))
    t = np.clip(t, 0.0, 1.0)

    def unflat(g):
        return np.stack([g // sx, (g % sx) // sy, g % sy],
                        axis=1).astype(np.float32)

    pa = unflat(ulo)
    pb = unflat(uhi)
    verts = pa + t[:, None] * (pb - pa)
    faces = inv.reshape(-1, 3).astype(np.int32)
    return verts.astype(np.float32), faces


def marching_cubes(volume, level: float = 0.0, mask=None):
    """The `level` isosurface of `volume` [DX, DY, DZ] through the native
    library: (verts [V, 3] float32 in voxel-index coordinates, faces
    [F, 3] int32). A cell contributes only if all 8 of its corners are
    True in `mask`."""
    volume = np.asarray(volume, np.float32)
    if volume.ndim != 3:
        raise ValueError("volume must be 3D")
    if not ((volume < level).any() and (volume > level).any()):
        raise ValueError("level is outside the volume's value range")
    return _native_mc(volume, mask, level)


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals."""
    norms = np.zeros_like(verts)
    if len(faces) == 0:
        return norms
    tri = verts[faces]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    for k in range(3):
        np.add.at(norms, faces[:, k], fn)
    lens = np.linalg.norm(norms, axis=1, keepdims=True)
    return norms / np.maximum(lens, 1e-12)
