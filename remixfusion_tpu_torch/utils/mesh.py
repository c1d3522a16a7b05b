"""Neural-field mesh extraction: dense grid query + marching tetrahedra.

Counterpart of remixfusion_tpu.utils.mesh (reference extract_mesh_github,
utils.py:121-212): query the residual-corrected SDF (or the explicit grid's)
and the fusion weight over a dense grid inside marching_cubes_bound on the
scene's device, mask the cells by positive weight, run marching tetrahedra
at the isolevel on the host, rescale the vertices to metric units, color
them with the residual-corrected (or explicit) color and write a binary PLY.

The queries are pointwise, so they run in bounded chunks without padding:
the HashGrid forward builds int64 corner indices [N, levels, 8], which for
the 2.41 M points of a 4 m room at 3 cm would take ~2.5 GB at once.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from remixfusion_tpu_torch import host_to_device
from remixfusion_tpu_torch.ops.marching_cubes import marching_cubes, \
    vertex_normals
from remixfusion_tpu_torch.utils.meshio import write_ply_mesh
from remixfusion_tpu_torch.utils.spans import span

CHUNK = 1 << 18


def get_voxels(bound, voxel_size=None, resolution=None):
    """Axis linspaces covering `bound` [3, 2] (reference utils.py:79-103)."""
    axes = []
    for i in range(3):
        lo, hi = float(bound[i, 0]), float(bound[i, 1])
        if voxel_size is not None:
            n = round((hi - lo) / voxel_size + 0.0005)
            axes.append(np.linspace(lo, hi, n + 1, dtype=np.float32))
        else:
            axes.append(np.linspace(lo, hi, resolution, dtype=np.float32))
    return axes


def grid_points(bound, marching_cube_bound, voxel_size=None,
                resolution=None):
    """(axes, grid points [X*Y*Z, 3] normalized by `bound`, float32) of the
    dense mesh grid over marching_cube_bound."""
    axes = get_voxels(np.asarray(marching_cube_bound), voxel_size,
                      resolution)
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1)
    bound_np = np.asarray(bound, np.float32)
    flat_norm = ((grid.reshape(-1, 3) - bound_np[:, 0])
                 / (bound_np[:, 1] - bound_np[:, 0])).astype(np.float32)
    return axes, flat_norm


@torch.no_grad()
def query_points(fn, pts_norm: np.ndarray, device) -> np.ndarray:
    """fn over normalized points [N, 3] in chunks on `device` -> numpy."""
    outs = [fn(host_to_device(pts_norm[i: i + CHUNK], device))
            for i in range(0, pts_norm.shape[0], CHUNK)]
    return torch.cat(outs).cpu().numpy()


def grid_to_mesh(sdf, weight, axes, config, isolevel=0.0):
    """Marching tetrahedra on the grid, cells masked by weight > 0, and the
    vertices taken from voxel index to metric units / sc_factor -
    translation. (verts [V, 3] float32, faces [F, 3] int32); empty when no
    masked SDF lies below the isolevel."""
    mask = weight > 0
    if not ((sdf[mask] < isolevel).any() if mask.any() else False):
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    verts, faces = marching_cubes(sdf, isolevel, mask=mask)
    tx, ty, tz = axes
    # voxel index -> metric (reference utils.py:171-184)
    verts = verts / np.array([[len(tx) - 1, len(ty) - 1, len(tz) - 1]])
    scale = np.array([tx[-1] - tx[0], ty[-1] - ty[0], tz[-1] - tz[0]])
    offset = np.array([tx[0], ty[0], tz[0]])
    verts = verts * scale[None, :] + offset[None, :]
    verts = (verts / config["data"]["sc_factor"]
             - config["data"]["translation"]).astype(np.float32)
    return verts, faces


def extract_mesh(scene, config, bound, marching_cube_bound=None,
                 voxel_size=None, resolution=None, isolevel=0.0,
                 mesh_savepath="", explicit_only=False, info=None):
    """Extract and (if mesh_savepath) save the scene mesh. Returns (verts,
    faces, colors uint8 | None when the mesh is empty).

    explicit_only uses the raw explicit grid's SDF and color (reference
    save_mesh_explicit, mp_slam/slam.py:390-414). `info`, a dict, receives
    the stage times (query_ms: the grid and vertex queries on the scene's
    device, each ending in the copy to the host; marching_ms; write_ms:
    normals + PLY) and the queried grids (sdf, weight [X, Y, Z]).
    """
    if marching_cube_bound is None:
        marching_cube_bound = bound
    dev = scene.bound_box.device
    if explicit_only:
        sdf_fn, color_fn = scene.query_sdf_ex, scene.query_color_ex
    else:
        sdf_fn, color_fn = scene.query_sdf_res, scene.query_color_residual
    info = {} if info is None else info

    t0 = time.perf_counter()
    with span("mesh.query"):
        axes, flat_norm = grid_points(bound, marching_cube_bound,
                                      voxel_size, resolution)
        sh = tuple(len(a) for a in axes)
        sdf = query_points(sdf_fn, flat_norm, dev).reshape(sh)
        weight = query_points(scene.query_w_res, flat_norm, dev).reshape(sh)
    t1 = time.perf_counter()
    with span("mesh.marching"):
        verts, faces = grid_to_mesh(sdf, weight, axes, config, isolevel)
    t2 = time.perf_counter()
    info.update(sdf=sdf, weight=weight, marching_ms=1000.0 * (t2 - t1),
                query_ms=1000.0 * (t1 - t0), write_ms=0.0)
    if len(faces) == 0:
        return verts, faces, None

    with span("mesh.query"):
        bound_np = np.asarray(bound, np.float32)
        vert_norm = ((verts - bound_np[:, 0])
                     / (bound_np[:, 1] - bound_np[:, 0])).astype(np.float32)
        colors = query_points(color_fn, vert_norm, dev)
        colors = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
    t3 = time.perf_counter()
    info["query_ms"] += 1000.0 * (t3 - t2)
    if mesh_savepath:
        with span("mesh.write"):
            os.makedirs(os.path.dirname(mesh_savepath) or ".", exist_ok=True)
            write_ply_mesh(mesh_savepath, verts, faces, colors=colors,
                           normals=vertex_normals(verts, faces))
        info["write_ms"] = 1000.0 * (time.perf_counter() - t3)
    return verts, faces, colors
