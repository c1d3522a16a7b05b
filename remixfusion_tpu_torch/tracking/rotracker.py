"""Randomized pose optimization (gradient-free tracking) in PyTorch.

Counterpart of remixfusion_tpu.tracking.rotracker.ROTracker (reference
model/ROtracker.py:33-971). A frame runs `particle_iter_lens` iterations.
Each one picks the candidate tier from the success count (count % 3 ->
10240/3072/1024 candidates at image strides 32/16/8, pst.TIFF_INDEX /
pst.DEPTH_LEVEL), computes the tier's vertices and normals at its pixel
subgrid (gathered from per-frame maps), scores every candidate pose against
the moving TSDF volume and moves the pose to the weighted mean of the
improving candidates. With RO.sample_range != 0 the per-frame vertex map
shifts every pixel along its ray by a random fraction of the truncation
and expects the TSDF value that shift implies (reference compute_vertex,
ROtracker.py:272-344); the shift is drawn on the device from a
torch.Generator the caller owns.

RO.eval_mode picks how a candidate is scored:
  - 'pallas' (the main path): the `brick_eval` kernel, which reads each
    pixel's 4^3 TSDF window from the volume itself, in the track dtype
    (rounded through bfloat16 by default, like the JAX track volume;
    unrounded with volume.track_dtype float32);
  - 'gather' (the default, the reference's exact lookup): one volume read
    per (candidate, pixel) at the rounded voxel of the moved vertex, in
    plain PyTorch (JAX _eval_tier);
  - 'brick': the same transform, the lookup confined to a per-pixel window
    of side 2 * RO.brick_radius around the unperturbed voxel, nearest or
    trilinear, in plain PyTorch (JAX _eval_tier_brick; tiers of >= 2048
    pixels compute camera coordinates through per-candidate rotation
    matrices, as JAX does there).
Every mode reads the volume in volume.track_dtype (float32 for gather,
bfloat16 otherwise by default, as the JAX pipeline).
The volume is brick-major [NB, b^3] or dense [X, Y, Z] (layout (1, Y, Z));
voxels are addressed with ops.tsdf.bm_vox_flat either way.

The JAX tracker keeps the loop on the device (fori_loop + lax.switch over
three static-shape tiers). Here the tier's shape (C, P) depends on the
device-side success of the previous iteration, so each iteration reads back
one boolean; every other step stays on the device. The reference's CUDA
tracker read candidate scores back every iteration too (ROtracker.py:
570-571). The transform step computes both outcomes of an iteration and
selects one by its success on the device (_step), so the host only keeps
the tier bookkeeping.

A track call keeps its state in fixed tensors (_Fixed) and runs its chains
of small ops through utils/cuda_graphs: the frame's vertex and normal maps
(sample_range 0), a tier's kernel inputs (one key per level) and the
transform step (one per tier class and EMA flag). On a CUDA device with
eval_mode 'pallas' and no process group (`graphed`) a key's first call
runs its ops eagerly and captures them, later calls copy what changed into
the fixed inputs and replay them: the same kernels on the same values.
Elsewhere the chains run eagerly. The brick_eval launch stays outside
them, called through this module's name. `graph_hit` records per
iteration 1 when replays served its chains, else 0.

Candidate sharding (the counterpart of JAX's ROTracker(mesh=...)): with a
process group of D ranks, rank r scores the candidate columns
[r C/D, (r+1) C/D) of every tier in any eval_mode and the [C] costs are
all-gathered, so every rank runs the transform step on the same vector and
reads back the same boolean: the ranks stay in lockstep. The low-count guard
compares every candidate's count with the identity candidate's (column 0),
so every rank but the first scores column 0 ahead of its slice and drops
that cost. The kernel splits a slice's pixels as it splits the whole
table's (brick_eval_volume's split_for), so the gathered costs are the bits
one process gets, and so is the pose. A generator passed for the ray shift
is given rank 0's state first, so every rank draws the same shift.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from remixfusion_tpu_torch.ops.brick_eval import (BRICK_SIDE,
                                                  brick_eval_volume)
from remixfusion_tpu_torch.ops.tsdf import bm_vox_flat, window_index
from remixfusion_tpu_torch.parallel.launch import collectives
from remixfusion_tpu_torch.tracking import pst as pst_mod
from remixfusion_tpu_torch.utils.cuda_graphs import CudaGraphs, feed
from remixfusion_tpu_torch.utils.spans import span

EVAL_MODES = ("gather", "brick", "pallas")
# tiers with at least this many pixels take the rotation-matrix branch of
# brick mode (JAX _eval_tier_brick)
MATRIX_TIER_PIXELS = 2048


class TrackResult(NamedTuple):
    c2w: torch.Tensor           # [4, 4] optimized pose (device)
    search_size: torch.Tensor   # [6] final search size (device)
    first_iter_success: bool
    origin_value: torch.Tensor  # fitness of the final iteration's pose


def track_dtype(cfg) -> str:
    """The dtype of the tracker's view of the volume: volume.track_dtype,
    by default float32 for eval_mode gather (the exact lookup) and
    bfloat16 otherwise (the JAX pipeline's default)."""
    mode = cfg["RO"].get("eval_mode", "gather")
    return str(cfg["volume"].get(
        "track_dtype", "float32" if mode == "gather" else "bfloat16"))


def check_modes(cfg):
    """Raise ValueError for RO / volume settings no tracker runs: an
    unknown eval_mode or tsdf_interp, trilinear with gather (JAX raises
    alike), brick_radius < 1, and a track dtype other than float32 /
    bfloat16."""
    ro = cfg["RO"]
    mode = ro.get("eval_mode", "gather")
    if mode not in EVAL_MODES:
        raise ValueError(f"unknown RO.eval_mode {mode!r}")
    interp = str(ro.get("tsdf_interp", "nearest"))
    if interp not in ("nearest", "trilinear"):
        raise ValueError(f"unknown RO.tsdf_interp {interp!r}")
    if interp == "trilinear" and mode not in ("brick", "pallas"):
        raise ValueError(
            f"RO.tsdf_interp=trilinear requires eval_mode brick|pallas, "
            f"not {mode!r}")
    if int(ro.get("brick_radius", 2)) < 1:
        raise ValueError("RO.brick_radius must be >= 1")
    dt = track_dtype(cfg)
    if dt not in ("float32", "bfloat16"):
        raise ValueError(f"unknown volume.track_dtype {dt!r}")


class _Fixed:
    """A track call's state, which its chains (replayed or eager) read and
    write in place, allocated outside the graphs' memory pool: the pose R
    [3, 3] / T [3], the search sizes ss / prev_ss [6], origin [3], the
    depth [H, W] and its vertex / normal maps, per tier class the table
    slab [C, 6] and the costs [C], per level the subgrid's rows and
    columns. A graph's own outputs are read before any other graph
    replays, so the graphs may replay in any order."""

    def __init__(self, tr: "ROTracker"):
        f32 = {"dtype": torch.float32, "device": tr.device}
        self.R = torch.zeros((3, 3), **f32)
        self.T = torch.zeros(3, **f32)
        self.ss = torch.zeros(6, **f32)
        self.prev_ss = torch.zeros(6, **f32)
        self.origin = torch.zeros(3, **f32)
        self.depth = torch.zeros((tr.H, tr.W), **f32)
        self.vn = (torch.zeros((tr.H, tr.W, 4), **f32),
                   torch.zeros((tr.H, tr.W, 3), **f32))
        self.table = {c: torch.zeros_like(tr.pst[c][0]) for c in range(3)}
        self.value = {c: torch.zeros(tr.pst[c].shape[1], **f32)
                      for c in range(3)}
        self.subgrid = {lv: torch.zeros(tr.H // sr + tr.W // sc,
                                        dtype=torch.int64, device=tr.device)
                        for lv, (sr, sc) in tr.tier_strides.items()}


class ROTracker:
    def __init__(self, cfg, H: int, W: int, K: np.ndarray, vol_dims,
                 voxel_size: float, brick_layout, device, group=None):
        """group: a torch.distributed process group to shard the candidates
        over (ValueError unless every tier's candidate count divides by its
        size), or None."""
        ro = cfg["RO"]
        self.device = dev = torch.device(device)
        self.H, self.W = int(H), int(W)
        self.K = torch.as_tensor(np.asarray(K), dtype=torch.float32,
                                 device=dev)
        self.vol_dims = tuple(int(d) for d in vol_dims)
        self.voxel_size = float(voxel_size)
        # (b, BY, BZ) of the volume: brick-major, or (1, Y, Z) when dense
        self.brick_layout = tuple(int(v) for v in brick_layout)
        if 1 < self.brick_layout[0] < BRICK_SIDE:
            raise ValueError("a brick-major volume needs bricks >= 4 voxels")

        check_modes(cfg)
        self.eval_mode = ro.get("eval_mode", "gather")
        self.tsdf_interp = str(ro.get("tsdf_interp", "nearest"))
        self.brick_r = int(ro.get("brick_radius", 2))
        self.track_dtype = track_dtype(cfg)
        self.sample_range = float(ro["sample_range"])
        self.truncation = float(cfg["volume"]["trunc"])

        self.init_size = float(ro["init_size"])
        self.scaling_coefficient = float(ro["scaling_coefficient"])
        self.particle_iter_lens = int(ro["particle_iter_lens"])
        self.count_search = int(ro["count_search"])
        self.fix_level_index = bool(ro["fix_level_index"])
        self.cut_dist = float(ro["cut_dist"])
        self.iterative_scale = bool(ro["iterative_scale"])
        self.beta = 0.9
        self.min_scale = 1e-3

        tables = pst_mod.load_pst(ro["PST_path"], list(ro["PST_size"]))
        self.pst = {c: torch.as_tensor(tables[c], device=dev)
                    for c in range(3)}
        # transposed tables for the kernel: [slabs, 6, C]
        self.pst_t = {c: torch.as_tensor(
            np.ascontiguousarray(tables[c].transpose(0, 2, 1)), device=dev)
            for c in range(3)}
        self.slab_table = [int(s) for s in pst_mod.slab_index_table()]
        # this rank's candidate columns, preceded by the identity column on
        # every rank but the first: [slabs, C/D (+1), 6] and transposed
        self.comm = collectives(group)
        self.pst_rank, self.pst_t_rank = self.pst, self.pst_t
        if self.comm is not None:
            world, rank = self.comm.world, self.comm.rank
            self.pst_rank, self.pst_t_rank = {}, {}
            for c in range(3):
                n = tables[c].shape[1]
                if n % world:
                    raise ValueError(f"RO tier {c}: {n} candidates do not "
                                     f"split over {world} ranks")
                m = n // world
                cols = np.arange(rank * m, (rank + 1) * m)
                if rank > 0:
                    cols = np.concatenate([[0], cols])
                part = tables[c][:, cols]
                self.pst_rank[c] = torch.as_tensor(
                    np.ascontiguousarray(part), device=dev)
                self.pst_t_rank[c] = torch.as_tensor(np.ascontiguousarray(
                    part.transpose(0, 2, 1)), device=dev)
        self.class_level = tuple(
            int(v) for v in ro.get("depth_level", pst_mod.DEPTH_LEVEL[:3]))
        self.depth_level = [self.class_level[i % 3]
                            for i in range(len(pst_mod.DEPTH_LEVEL))]
        # RO.pix_ref rescales tier strides so the subgrid shape matches the
        # reference resolution at any input size (never below the reference
        # strides); null keeps absolute strides
        pix_ref = ro.get("pix_ref", [480, 640])
        self.tier_strides = {}
        for lv in set(self.class_level):
            if pix_ref:
                sr = max(lv, round(lv * self.H / int(pix_ref[0])))
                sc = max(lv, round(lv * self.W / int(pix_ref[1])))
            else:
                sr = sc = lv
            self.tier_strides[lv] = (sr, sc)

        inv_vox = 1.0 / self.voxel_size
        self._inv_vox = inv_vox
        # kernel params tail: fx fy cx cy W H inv_vox + 7 pad (f32[14])
        self._param_tail = torch.cat([
            torch.stack([self.K[0, 0], self.K[1, 1], self.K[0, 2],
                         self.K[1, 2]]),
            torch.tensor([float(self.W), float(self.H), inv_vox],
                         dtype=torch.float32, device=dev),
            torch.zeros(7, dtype=torch.float32, device=dev)])
        self._dims_t = torch.tensor(self.vol_dims, dtype=torch.int32,
                                    device=dev)
        self._dims_hi = self._dims_t - 1 - BRICK_SIDE
        self._subgrids = {}
        # an iteration's small ops replay as CUDA graphs where nothing
        # inside it needs the host: the kernel's path, one process
        self.graphed = (dev.type == "cuda" and self.eval_mode == "pallas"
                        and self.comm is None)
        self._fixed = _Fixed(self)
        self._graphs = CudaGraphs(dev)
        # per iteration: 1 when served by graph replays, 0 when run
        # eagerly or captured
        self.graph_hit = []

    # -------------------------------------------------- frame preparation

    def _subgrid(self, level: int, level_index: int) -> torch.Tensor:
        """A tier's pixel subgrid as one int64 tensor [rows + cols];
        level_index rotates its offset over the stride."""
        key = (level, level_index)
        if key not in self._subgrids:
            sr, sc = self.tier_strides[level]
            dev = self.device
            self._subgrids[key] = torch.cat([
                torch.arange(self.H // sr, device=dev) * sr
                + (level_index * sr) // level,
                torch.arange(self.W // sc, device=dev) * sc
                + (level_index * sc) // level])
        return self._subgrids[key]

    def _split(self, subgrid: torch.Tensor, level: int):
        """(rows, cols) of a subgrid tensor of `level`."""
        n = self.H // self.tier_strides[level][0]
        return subgrid[:n], subgrid[n:]

    def _rows_cols(self, level: int, level_index: int):
        return self._split(self._subgrid(level, level_index), level)

    def _vertex_normal_at(self, depth, rows, cols):
        """Vertex [P, 4] / normal [P, 3] at the rows x cols subgrid straight
        from depth (sample_range == 0: no perturbation, gt == 0), with the
        full-image pass's pad / border / zero-neighbour rules."""
        K = self.K
        H, W = self.H, self.W
        d_full = torch.where(depth > self.cut_dist, 0.0, depth)

        def vert_at(ii, jj, ivalid, jvalid):
            iic = ii.clamp(0, H - 1)
            jjc = jj.clamp(0, W - 1)
            d = d_full[iic][:, jjc]
            ok = (ivalid[:, None] & jvalid[None, :]) & (d > 0)
            cz = torch.where(ok, d, 0.0)
            cx = (jjc[None, :].to(torch.float32) - K[0, 2]) * cz / K[0, 0]
            cy = (iic[:, None].to(torch.float32) - K[1, 2]) * cz / K[1, 1]
            return cx, cy, cz

        tr_i = rows >= 0
        tr_j = cols >= 0
        cx, cy, cz = vert_at(rows, cols, tr_i, tr_j)
        lx, ly, lz = vert_at(rows, cols - 1, tr_i, cols - 1 >= 0)
        rx, ry, rz = vert_at(rows, cols + 1, tr_i, cols + 1 <= W - 1)
        ux, uy, uz = vert_at(rows - 1, cols, rows - 1 >= 0, tr_j)
        dx_, dy_, dz_ = vert_at(rows + 1, cols, rows + 1 <= H - 1, tr_j)

        hx, hy, hz = lx - rx, ly - ry, lz - rz
        vx, vy, vz = ux - dx_, uy - dy_, uz - dz_
        nx = hy * vz - hz * vy
        ny = hz * vx - hx * vz
        nz = hx * vy - hy * vx
        ln = torch.sqrt(nx * nx + ny * ny + nz * nz)
        inv = 1.0 / torch.clamp(ln, min=1e-12)
        nx, ny, nz = nx * inv, ny * inv, nz * inv
        flip = nz > 0
        nx = torch.where(flip, -nx, nx)
        ny = torch.where(flip, -ny, ny)
        nz = torch.where(flip, -nz, nz)
        zero_nb = (cz == 0) | (lz == 0) | (rz == 0) | (uz == 0) | (dz_ == 0)
        nx = torch.where(zero_nb, 0.0, nx)
        ny = torch.where(zero_nb, 0.0, ny)
        nz = torch.where(zero_nb, 0.0, nz)
        border = ((rows < 1) | (rows > H - 2))[:, None] \
            | ((cols < 1) | (cols > W - 2))[None, :]
        nx = torch.where(border, 1.0, nx)
        ny = torch.where(border, 1.0, ny)
        nz = torch.where(border, 1.0, nz)

        v = torch.stack([cx, cy, cz, torch.zeros_like(cz)], -1).reshape(-1, 4)
        n = torch.stack([nx, ny, nz], -1).reshape(-1, 3)
        return v, n

    def draw_sample(self, generator: torch.Generator) -> torch.Tensor:
        """Per-pixel along-ray shift [H, W] in units of the truncation:
        U(-sr, sr) for sample_range sr < 1, U(-sr, 1) for sr >= 1 (the JAX
        tracker's ranges; the draw is torch's, not jax.random's)."""
        sr = self.sample_range
        lo, hi = -sr, (sr if sr < 1.0 else 1.0)
        u = torch.rand((self.H, self.W), generator=generator,
                       dtype=torch.float32, device=self.device)
        return u * (hi - lo) + lo

    def _compute_vertex(self, depth, sample):
        """Camera-space vertex map [H, W, 4] (xyz + expected tsdf) with the
        along-ray shift sample * trunc; the expected tsdf -sample saturates
        to 1.0 where the shift leaves [-trunc, trunc] (JAX
        ROTracker._compute_vertex)."""
        K, trunc = self.K, self.truncation
        d = torch.where(depth > self.cut_dist, 0.0, depth)
        valid = d > 0
        z_val = sample * trunc
        gt = torch.where((z_val < -trunc) | (z_val > trunc), 1.0, -sample)
        jj = torch.arange(self.W, dtype=torch.float32,
                          device=self.device)[None, :]
        ii = torch.arange(self.H, dtype=torch.float32,
                          device=self.device)[:, None]
        cz = d + z_val
        cx = (jj - K[0, 2]) * cz / K[0, 0]
        cy = (ii - K[1, 2]) * cz / K[1, 1]
        vert = torch.stack([cx, cy, cz, gt], -1)
        return torch.where(valid[..., None], vert, 0.0)

    def _compute_normal(self, vertex):
        """Central-difference normals [H, W, 3] of a vertex map; a zero
        vertex among the five gives 0, border pixels keep the all-ones
        sentinel (JAX ROTracker._compute_normal)."""
        v = vertex[..., :3]
        zeros_col = torch.zeros_like(v[:, :1])
        zeros_row = torch.zeros_like(v[:1])
        left = torch.cat([zeros_col, v[:, :-1]], 1)
        right = torch.cat([v[:, 1:], zeros_col], 1)
        up = torch.cat([zeros_row, v[:-1]], 0)
        down = torch.cat([v[1:], zeros_row], 0)
        n = torch.linalg.cross(left - right, up - down, dim=-1)
        ln = torch.sqrt((n * n).sum(-1, keepdim=True))
        n = n / torch.clamp(ln, min=1e-12)
        n = torch.where(n[..., 2:3] > 0, -n, n)
        zero_nb = ((v[..., 2] == 0) | (left[..., 2] == 0)
                   | (right[..., 2] == 0) | (up[..., 2] == 0)
                   | (down[..., 2] == 0))
        n = torch.where(zero_nb[..., None], 0.0, n)
        H, W = self.H, self.W
        ii = torch.arange(H, device=self.device)[:, None]
        jj = torch.arange(W, device=self.device)[None, :]
        border = (ii < 1) | (ii > H - 2) | (jj < 1) | (jj > W - 2)
        return torch.where(border[..., None], 1.0, n)

    def vertex_normal_maps(self, depth, sample=None, generator=None):
        """Full-image vertex [H, W, 4] and normal [H, W, 3] maps, once per
        frame. sample_range == 0: _vertex_normal_at's per-pixel arithmetic
        (expected tsdf 0), so a tier's subgrid gathered from them is bitwise
        what the subgrid computation gives. Otherwise every pixel is shifted
        along its ray by `sample` [H, W] (drawn from `generator` when not
        given) and the normals follow the shifted vertices."""
        dev = self.device
        if self.sample_range == 0.0:
            v, n = self._vertex_normal_at(depth,
                                          torch.arange(self.H, device=dev),
                                          torch.arange(self.W, device=dev))
            return v.reshape(self.H, self.W, 4), n.reshape(self.H, self.W, 3)
        if sample is None:
            if generator is None:
                raise ValueError("RO.sample_range != 0 needs a per-pixel "
                                 "sample or a torch.Generator to draw it")
            sample = self.draw_sample(generator)
        vertex = self._compute_vertex(depth, sample)
        return vertex, self._compute_normal(vertex)

    def _tier_pixels(self, vn, level: int, level_index: int):
        """(vertex [P, 4], normal [P, 3], pix_ok [P]) at one tier's pixel
        subgrid; vn = vertex_normal_maps(depth); level_index rotates the
        subgrid offset over the stride."""
        return self._pixels_at(vn, *self._rows_cols(level, level_index))

    def _pixels_at(self, vn, rows, cols):
        """_tier_pixels at given subgrid rows and columns."""
        vertex, normal = vn
        # the initial level_index (5) can push a subgrid past the last row or
        # column; the subgrid computation clamps such reads, and a clamped
        # row/column is a border one (sentinel normal) either way
        rows = rows.clamp(max=self.H - 1)
        cols = cols.clamp(max=self.W - 1)
        v = vertex[rows][:, cols].reshape(-1, 4)
        n = normal[rows][:, cols].reshape(-1, 3)
        pix_ok = (n != 0).any(-1) & (v[:, :3] != 0).any(-1)
        return v, n, pix_ok

    # ------------------------------------------------- candidate evaluation

    def tier_inputs(self, level, level_index, R, T, ss, vn, origin):
        """brick_eval_volume's (params f32[32], pix f32[P, 8], base int32
        [P, 3]) for one tier (_eval_tier_pallas's preparation, without the
        window gather: the kernel reads the windows at base from the
        volume); vn from vertex_normal_maps."""
        return self._inputs_at(*self._rows_cols(level, level_index), R, T,
                               ss, vn, origin)

    def _inputs_at(self, rows, cols, R, T, ss, vn, origin):
        """tier_inputs at given subgrid rows and columns."""
        v, _, pix_ok = self._pixels_at(vn, rows, cols)
        g = (v[:, None, :3] * R[None, :, :]).sum(-1)  # R @ v, full f32
        gt = v[:, 3]
        inv_vox = self._inv_vox
        p0 = g + T[None, :]
        v0 = torch.round((p0 - origin[None, :]) * inv_vox).to(torch.int32)
        # every window lies inside the volume
        base = torch.minimum(torch.clamp(v0 - BRICK_SIDE // 2, min=1),
                             self._dims_hi)
        # bases shifted into round(x / voxel) integer-voxel coordinates
        base_eff = base.to(torch.float32) + origin[None, :] * inv_vox
        pix = torch.cat([g, gt[:, None], base_eff,
                         pix_ok.to(torch.float32)[:, None]], -1)
        params = torch.cat([R.reshape(-1), T, ss, self._param_tail])
        return params, pix, base

    # ------------------------------------------- plain candidate scoring

    def _candidates(self, table, ss):
        """Candidate translations t [C, 3], quaternion vectors qv [C, 3]
        and scalars q0 [C] of a table slab [C, 6] at search size ss."""
        t = table[:, :3] * ss[None, :3]
        qv = table[:, 3:] * ss[None, 3:]
        q0 = torch.sqrt(torch.clamp(1.0 - (qv * qv).sum(-1), min=1e-12))
        return t, qv, q0

    @staticmethod
    def _quat_world(g, t, qv, q0, T):
        """World positions ([C, P] x3) of the pixels' rotated vertices g
        [P, 3] moved by every candidate, quaternion algebra
        x' = g + 2 q0 (qv x g) + 2 qv x (qv x g) + t + T."""
        gx, gy, gz = g[None, :, 0], g[None, :, 1], g[None, :, 2]
        qx, qy, qz = qv[:, 0, None], qv[:, 1, None], qv[:, 2, None]
        q0c = q0[:, None]
        c1x = qy * gz - qz * gy
        c1y = qz * gx - qx * gz
        c1z = qx * gy - qy * gx
        c2x = qy * c1z - qz * c1y
        c2y = qz * c1x - qx * c1z
        c2z = qx * c1y - qy * c1x
        xw = gx + 2.0 * q0c * c1x + 2.0 * c2x + t[:, 0, None] + T[0]
        yw = gy + 2.0 * q0c * c1y + 2.0 * c2y + t[:, 1, None] + T[1]
        zw = gz + 2.0 * q0c * c1z + 2.0 * c2z + t[:, 2, None] + T[2]
        return xw, yw, zw

    @staticmethod
    def _to_cam(xw, yw, zw, R, T):
        """Camera coordinates R^T (x' - T) of world positions."""
        rx, ry, rz = xw - T[0], yw - T[1], zw - T[2]
        return (R[0, 0] * rx + R[1, 0] * ry + R[2, 0] * rz,
                R[0, 1] * rx + R[1, 1] * ry + R[2, 1] * rz,
                R[0, 2] * rx + R[1, 2] * ry + R[2, 2] * rz)

    @staticmethod
    def _matrix_cam(g, t, qv, q0, R):
        """Camera coordinates ([C, P] x3) through per-candidate rotation
        matrices: cam = (R^T Rc) g + R^T t_c (JAX _mxu_cam, a float32
        matmul at HIGHEST precision; no TF32 here either)."""
        C = t.shape[0]
        qx, qy, qz = qv[:, 0], qv[:, 1], qv[:, 2]
        Rc = torch.stack([
            1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * q0),
            2 * (qx * qz + qy * q0),
            2 * (qx * qy + qz * q0), 1 - 2 * (qx * qx + qz * qz),
            2 * (qy * qz - qx * q0),
            2 * (qx * qz - qy * q0), 2 * (qy * qz + qx * q0),
            1 - 2 * (qx * qx + qy * qy)], -1).reshape(C, 3, 3)
        M = torch.einsum("ji,cjk->cik", R, Rc)
        b = t @ R
        cam = (g @ M.reshape(C * 3, 3).T).reshape(-1, C, 3).permute(
            1, 0, 2) + b[:, None, :]
        return cam[..., 0], cam[..., 1], cam[..., 2]

    def _in_image(self, cam_x, cam_y, cam_z):
        K = self.K
        safe_z = torch.where(cam_z != 0, cam_z, torch.full_like(cam_z, 1e-9))
        px = torch.floor(cam_x * K[0, 0] / safe_z + K[0, 2] + 0.5)
        py = torch.floor(cam_y * K[1, 1] / safe_z + K[1, 2] + 0.5)
        return ((px >= 0) & (py >= 0) & (px < self.W) & (py < self.H)
                & (cam_z >= 0))

    @staticmethod
    def _guarded(vals, gt, valid):
        """Mean |tsdf - expected| over the valid pixels of each candidate,
        1e6 for a candidate with fewer than half the identity candidate's
        valid pixels (JAX _guarded_cost)."""
        sv = torch.where(valid, torch.abs(vals - gt[None, :]),
                         torch.zeros_like(vals)).sum(1)
        cnt = valid.sum(1).to(torch.float32)
        cost = sv / (cnt + 1e-6)
        return torch.where(cnt >= 0.5 * cnt[0], cost,
                           torch.full_like(cost, 1e6))

    def eval_gather(self, table, level, level_index, R, T, ss, vn, view,
                    origin):
        """Cost [C] of one tier, eval_mode gather: the voxel nearest each
        moved vertex, read straight from the track view `view` (the volume
        reshaped to [-1] in the track dtype); a voxel outside [1, dim - 1)
        drops the pair (JAX _eval_tier)."""
        v, _, pix_ok = self._tier_pixels(vn, level, level_index)
        g = (v[:, None, :3] * R[None, :, :]).sum(-1)
        t, qv, q0 = self._candidates(table, ss)
        xw, yw, zw = self._quat_world(g, t, qv, q0, T)
        in_img = self._in_image(*self._to_cam(xw, yw, zw, R, T))
        inv_vox = self._inv_vox
        dims = self.vol_dims
        vox, in_vol = [], None
        for a, w in enumerate((xw, yw, zw)):
            i = torch.round((w - origin[a]) * inv_vox).to(torch.int64)
            ok = (i >= 1) & (i < dims[a] - 1)
            in_vol = ok if in_vol is None else in_vol & ok
            vox.append(i.clamp(0, dims[a] - 1))
        vals = view[bm_vox_flat(self.brick_layout, *vox)].to(torch.float32)
        return self._guarded(vals, v[:, 3], pix_ok[None, :] & in_img
                             & in_vol)

    def eval_brick(self, table, level, level_index, R, T, ss, vn, view,
                   origin):
        """Cost [C] of one tier, eval_mode brick: the lookup confined to
        each pixel's window of side 2r (r = RO.brick_radius) around its
        unperturbed voxel; nearest, or trilinear as the hat-weighted sum of
        the window, whose non-zero terms are the 8 corners around the
        voxel coordinate, valid when 0 <= f <= side - 1 on every axis
        (JAX _eval_tier_brick)."""
        r = self.brick_r
        side = 2 * r
        v, _, pix_ok = self._tier_pixels(vn, level, level_index)
        g = (v[:, None, :3] * R[None, :, :]).sum(-1)
        inv_vox = self._inv_vox
        v0 = torch.round((g + T[None, :] - origin[None, :])
                         * inv_vox).to(torch.int32)
        base = torch.minimum(torch.clamp(v0 - r, min=1),
                             self._dims_t - 1 - side)
        win = view[window_index(self.brick_layout, base, side)]
        t, qv, q0 = self._candidates(table, ss)
        sr, sc = self.tier_strides[level]
        if (self.H // sr) * (self.W // sc) >= MATRIX_TIER_PIXELS:
            cam_x, cam_y, cam_z = self._matrix_cam(g, t, qv, q0, R)
            xw = R[0, 0] * cam_x + R[0, 1] * cam_y + R[0, 2] * cam_z + T[0]
            yw = R[1, 0] * cam_x + R[1, 1] * cam_y + R[1, 2] * cam_z + T[1]
            zw = R[2, 0] * cam_x + R[2, 1] * cam_y + R[2, 2] * cam_z + T[2]
        else:
            xw, yw, zw = self._quat_world(g, t, qv, q0, T)
            cam_x, cam_y, cam_z = self._to_cam(xw, yw, zw, R, T)
        in_img = self._in_image(cam_x, cam_y, cam_z)
        rows = torch.arange(win.shape[0], device=win.device)[None, :]
        bf = base.to(torch.float32)
        if self.tsdf_interp == "trilinear":
            f = [(w - origin[a]) * inv_vox - bf[None, :, a]
                 for a, w in enumerate((xw, yw, zw))]
            in_win = None
            lo, wts = [], []
            for fa in f:
                ok = (fa >= 0) & (fa <= side - 1)
                in_win = ok if in_win is None else in_win & ok
                i0 = torch.clamp(torch.floor(fa), 0.0, side - 2.0)
                lo.append(i0.to(torch.int64))
                wts.append((torch.clamp(1.0 - torch.abs(fa - i0), min=0.0),
                            torch.clamp(1.0 - torch.abs(fa - (i0 + 1.0)),
                                        min=0.0)))
            vals = torch.zeros_like(xw)
            for dx in (0, 1):
                for dy in (0, 1):
                    for dz in (0, 1):
                        cell = (((lo[0] + dx) * side + lo[1] + dy) * side
                                + lo[2] + dz)
                        w = wts[0][dx] * wts[1][dy] * wts[2][dz]
                        vals = vals + w * win[rows, cell].to(torch.float32)
        else:
            o, in_win = [], None
            for a, w in enumerate((xw, yw, zw)):
                i = (torch.round((w - origin[a]) * inv_vox).to(torch.int32)
                     - base[None, :, a])
                ok = (i >= 0) & (i < side)
                in_win = ok if in_win is None else in_win & ok
                o.append(i.clamp(0, side - 1).to(torch.int64))
            cell = (o[0] * side + o[1]) * side + o[2]
            vals = win[rows, cell].to(torch.float32)
        return self._guarded(vals, v[:, 3], pix_ok[None, :] & in_img
                             & in_win)

    def score_tier(self, cls, slab, level, level_index, R, T, ss, vn, vol,
                   origin):
        """Cost [C] of every candidate of tier `cls`'s table slab in the
        tracker's eval_mode; vol: the volume as track() reads it. With a
        group this rank scores its columns and the costs are gathered.
        The kernel's inputs come from _run_inputs (the brick_eval launch is
        eager); the costs are a fresh tensor."""
        if self.eval_mode == "pallas":
            params, pix, base = self._run_inputs(level, level_index, R, T,
                                                 ss, vn, origin)
            value = brick_eval_volume(params, pix, base, vol,
                                      self.brick_layout,
                                      self.pst_t_rank[cls][slab],
                                      interp=self.tsdf_interp,
                                      split_for=self.pst_t[cls].shape[2],
                                      track_dtype=self.track_dtype)
        else:
            score = (self.eval_gather if self.eval_mode == "gather"
                     else self.eval_brick)
            value = score(self.pst_rank[cls][slab], level, level_index, R, T,
                          ss, vn, vol, origin)
        if self.comm is None:
            return value
        if self.comm.rank > 0:
            value = value[1:]
        return self.comm.all_gather_cat(value)

    # ----------------------------------------- chains through the graphs

    def _run_inputs(self, level, level_index, R, T, ss, vn, origin):
        """tier_inputs from the level's chain: the arguments are fed into
        the fixed tensors (track passes those themselves), the subgrid of
        level_index is copied in; graphed, the outputs are overwritten by
        the level's next call."""
        f = self._fixed
        for dst, src in ((f.R, R), (f.T, T), (f.ss, ss), (f.origin, origin),
                         *zip(f.vn, vn)):
            feed(dst, src)
        fixed = f.subgrid[level]
        fixed.copy_(self._subgrid(level, level_index))
        return self._graphs.run(("inputs", level), lambda: self._inputs_at(
            *self._split(fixed, level), f.R, f.T, f.ss, f.vn, f.origin),
            self.graphed)

    def _run_vn(self, depth, sample, generator):
        """The frame's vertex and normal maps in the fixed maps: from their
        chain with sample_range 0, else computed and copied in."""
        f = self._fixed

        def fill(maps):
            for dst, src in zip(f.vn, maps):
                dst.copy_(src)

        if self.sample_range != 0.0:
            fill(self.vertex_normal_maps(depth, sample, generator))
        else:
            feed(f.depth, depth)
            self._graphs.run(("vn",), lambda: fill(
                self.vertex_normal_maps(f.depth)), self.graphed)
        return f.vn

    def _run_step(self, value, cls, slab, ema_flag: bool):
        """_step in the tier class's chain on the fixed pose and search
        sizes, which it updates in place; graphed, the success flag [] is
        overwritten by the next call."""
        f = self._fixed
        feed(f.value[cls], value)
        f.table[cls].copy_(self.pst[cls][slab])

        def step():
            success, *new = self._step(f.value[cls], f.table[cls], f.R, f.T,
                                       f.ss, f.prev_ss, ema_flag)
            for dst, src in zip((f.R, f.T, f.ss, f.prev_ss), new):
                feed(dst, src)
            return success

        return self._graphs.run(("step", cls, ema_flag), step, self.graphed)

    def track_view(self, tsdf):
        """The volume as track() reads it: [NB, b^3] float32 for the kernel
        (which applies the track dtype to the cells it reads), flat in the
        track dtype for the plain modes."""
        if self.eval_mode == "pallas":
            return tsdf.reshape(-1, self.brick_layout[0] ** 3)
        vol = tsdf.reshape(-1)
        return vol.to(torch.bfloat16) if self.track_dtype == "bfloat16" \
            else vol

    # ------------------------------------------------------ transform step

    def _cal_transform(self, value, table, ss):
        """Weighted mean of the first <= count_search improving candidates
        (reference cal_transform, ROtracker.py:606-708)."""
        origin = value[0]
        improving = value < origin
        improving[0].fill_(False)  # no host scalar: graph-safe
        cum = torch.cumsum(improving.to(torch.int32), 0)
        take = improving & (cum <= self.count_search)
        w = torch.where(take, origin - value, 0.0)
        sw = w.sum()
        success = sw > 0
        sw_safe = torch.where(success, sw, 1.0)

        raw_mean = (w[:, None] * table).sum(0) / sw_safe
        qv_scaled = table[:, 3:] * ss[None, 3:]
        qw_cand = torch.sqrt(torch.clamp(
            1.0 - (qv_scaled * qv_scaled).sum(-1), min=1e-12))
        qw_mean = (w * qw_cand).sum() / sw_safe

        mean_t = raw_mean[:3] * ss[:3]
        qxyz = raw_mean[3:] * ss[3:]
        qlen = 1.0 / torch.sqrt(qw_mean ** 2 + (qxyz * qxyz).sum() + 1e-12)
        mean_q = torch.cat([qw_mean[None], qxyz]) * qlen
        min_tsdf = torch.where(success, (w * value).sum() / sw_safe, origin)
        return success, min_tsdf, mean_t, mean_q

    def _update_pst(self, min_tsdf, mean_t, mean_q):
        """Search-size anneal from achieved fitness
        (reference update_PST, ROtracker.py:495-534)."""
        s = torch.abs(torch.cat([mean_t, mean_q[1:]])) + self.min_scale
        nrm = torch.sqrt((s * s).sum())
        return self.scaling_coefficient * min_tsdf * s / nrm + self.min_scale

    @staticmethod
    def _quat_to_rot(q):
        qw, qx, qy, qz = q[0], q[1], q[2], q[3]
        return torch.stack([
            1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
            2 * (qx * qz + qy * qw),
            2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
            2 * (qy * qz - qx * qw),
            2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
            1 - 2 * (qx * qx + qy * qy)]).reshape(3, 3)

    def _step(self, value, table, R, T, ss, prev_ss, ema_flag: bool):
        """One iteration's transform step and search-size update, on the
        device: (success [], R, T, ss, prev_ss) after it. On success the
        pose moves by the mean of the improving candidates and, without
        ema_flag (the previous iteration's EMA flag, a host value), prev_ss
        takes the new search size; with it, the new size is blended with
        prev_ss, which is kept. Both outcomes are computed with the
        host-branched step's arithmetic and one is selected by success, so
        the bits are that step's (reference ROtracker.py:606-708)."""
        success, min_tsdf, mean_t, mean_q = self._cal_transform(value, table,
                                                                ss)
        T_new = torch.where(success, T + mean_t, T)
        R_new = torch.where(success, (self._quat_to_rot(mean_q)[:, :, None]
                                      * R[None, :, :]).sum(1), R)
        ss_new = self._update_pst(min_tsdf, mean_t, mean_q)
        if ema_flag:
            blend = self.beta * ss_new + (1 - self.beta) * prev_ss
            return (success, R_new, T_new,
                    torch.where(success, blend, ss_new), prev_ss)
        return (success, R_new, T_new, ss_new,
                torch.where(success, ss_new, prev_ss))

    # -------------------------------------------------------------- track

    def track(self, tsdf, origin, c2w_init, depth, ss_init=None,
              sample=None, generator=None):
        """Optimize one frame's pose. tsdf: the volume's float32 tsdf
        (brick-major [NB, b^3] or dense [X, Y, Z]), origin [3], c2w_init
        [4, 4], depth [H, W] — device tensors; sample / generator as
        vertex_normal_maps takes them (sample_range != 0 only). One boolean
        is read back per iteration (the tier choice needs it on the
        host). The result's tensors are the caller's: no later call
        writes them."""
        f = self._fixed
        feed(f.origin, origin)
        R, T, ss, origin = f.R, f.T, f.ss, f.origin
        R.copy_(c2w_init[:3, :3])
        T.copy_(c2w_init[:3, 3])
        if ss_init is None:
            ss.fill_(self.init_size)
        else:
            ss.copy_(ss_init)
        f.prev_ss.zero_()
        count, level_index = 0, 5
        ema_flag, first_ok = False, False
        count_cap = min(self.particle_iter_lens - 1, 19)
        origin_val = None
        if (self.comm is not None and sample is None and generator is not None
                and self.sample_range != 0.0):
            self.comm.sync_generator(generator)
        with span("slice.track.vn"):
            vn = self._run_vn(depth, sample, generator)
            vol = self.track_view(tsdf)
        for i in range(self.particle_iter_lens):
            with span("slice.track.score"):
                cls = count % 3
                slab = self.slab_table[count]
                level = self.class_level[cls]
                value = self.score_tier(cls, slab, level, level_index, R, T,
                                        ss, vn, vol, origin)
                success_t = self._run_step(value, cls, slab, ema_flag)
            with span("slice.track.readback"):
                success = bool(success_t)  # the one readback per iteration
            with span("slice.track.update"):
                origin_val = value[0]
                if success and count < count_cap:
                    count += 1
                level_index = ((1 if self.fix_level_index
                                else level_index + 5)
                               % self.depth_level[count])
                ema_flag = ((ema_flag and success)
                            or (success and self.iterative_scale))
                if i == 0:
                    first_ok = success
                if not success:
                    count = 0
                self.graph_hit.append(self._graphs.hit())
        c2w = torch.eye(4, dtype=torch.float32, device=self.device)
        c2w[:3, :3] = R
        c2w[:3, 3] = T
        return TrackResult(c2w, ss.clone(), first_ok, origin_val)

    def init_search_size(self) -> torch.Tensor:
        return torch.full((6,), self.init_size, dtype=torch.float32,
                          device=self.device)

    def do_tracking(self, mv_state, c2w_init, depth, search_size=None,
                    sample=None, generator=None):
        """Optimize the pose of one frame against the moving volume
        (mv_state: ops.tsdf.VolumeState, brick-major or dense; c2w_init
        [4, 4] and depth [H, W] as arrays or tensors; sample [H, W] as an
        array or tensor)."""
        dev = self.device
        c2w = torch.as_tensor(np.asarray(c2w_init, np.float32)
                              if not torch.is_tensor(c2w_init)
                              else c2w_init, device=dev)
        depth = torch.as_tensor(np.asarray(depth, np.float32)
                                if not torch.is_tensor(depth) else depth,
                                device=dev)
        if sample is not None and not torch.is_tensor(sample):
            sample = torch.tensor(np.asarray(sample, np.float32),
                                  device=dev)
        return self.track(mv_state.tsdf, mv_state.origin, c2w, depth,
                          search_size, sample, generator)
