"""Randomized pose optimization (gradient-free tracking) in PyTorch.

Counterpart of remixfusion_tpu.tracking.rotracker.ROTracker in its main
mode, eval_mode 'pallas' (reference model/ROtracker.py:33-971). A frame runs
`particle_iter_lens` iterations. Each one picks the candidate tier from the
success count (count % 3 -> 10240/3072/1024 candidates at image strides
32/16/8, pst.TIFF_INDEX / pst.DEPTH_LEVEL), computes the tier's vertices and
normals at its pixel subgrid (gathered from per-frame maps) and each
pixel's window base. With RO.sample_range != 0 the per-frame vertex map
shifts every pixel along its ray by a random fraction of the truncation
and expects the TSDF value that shift implies (reference compute_vertex,
ROtracker.py:272-344); the shift is drawn on the device from a
torch.Generator the caller owns. Every candidate is scored with the
`brick_eval` kernel, which reads each pixel's 4^3 TSDF window from the
brick-major volume itself (rounded through bfloat16 like the JAX track
volume), and the pose moves to the weighted mean of the improving
candidates.

The JAX tracker keeps the loop on the device (fori_loop + lax.switch over
three static-shape tiers). Here the tier's shape (C, P) depends on the
device-side success of the previous iteration, so each iteration reads back
one boolean; every other step stays on the device. The reference's CUDA
tracker read candidate scores back every iteration too (ROtracker.py:
570-571).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from remixfusion_tpu_torch.ops.brick_eval import (BRICK_SIDE,
                                                  brick_eval_volume)
from remixfusion_tpu_torch.tracking import pst as pst_mod


class TrackResult(NamedTuple):
    c2w: torch.Tensor           # [4, 4] optimized pose (device)
    search_size: torch.Tensor   # [6] final search size (device)
    first_iter_success: bool
    origin_value: torch.Tensor  # fitness of the final iteration's pose


def check_modes(ro: dict):
    """Raise NotImplementedError for the RO settings the port does not
    implement: eval_mode other than the fused-kernel 'pallas', and
    brick_radius != 2."""
    mode = ro.get("eval_mode", "gather")
    if mode != "pallas":
        raise NotImplementedError(
            f"RO.eval_mode {mode!r} is not ported; the PyTorch tracker "
            f"implements the fused-kernel mode 'pallas'")
    if int(ro.get("brick_radius", 2)) != 2:
        raise NotImplementedError("RO.brick_radius must be 2 (4^3 windows)")


class ROTracker:
    def __init__(self, cfg, H: int, W: int, K: np.ndarray, vol_dims,
                 voxel_size: float, brick_layout, device):
        ro = cfg["RO"]
        self.device = dev = torch.device(device)
        self.H, self.W = int(H), int(W)
        self.K = torch.as_tensor(np.asarray(K), dtype=torch.float32,
                                 device=dev)
        self.vol_dims = tuple(int(d) for d in vol_dims)
        self.voxel_size = float(voxel_size)
        self.brick_layout = tuple(brick_layout)
        if self.brick_layout[0] < BRICK_SIDE:
            raise ValueError("brick-major volume needs bricks >= 4 voxels")

        check_modes(ro)
        self.tsdf_interp = str(ro.get("tsdf_interp", "nearest"))
        if self.tsdf_interp not in ("nearest", "trilinear"):
            raise ValueError(f"unknown RO.tsdf_interp {self.tsdf_interp!r}")
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
        self._dims_hi = torch.tensor(self.vol_dims, dtype=torch.int32,
                                     device=dev) - 1 - BRICK_SIDE
        self._subgrids = {}

    # -------------------------------------------------- frame preparation

    def _rows_cols(self, level: int, level_index: int):
        key = (level, level_index)
        if key not in self._subgrids:
            sr, sc = self.tier_strides[level]
            dev = self.device
            self._subgrids[key] = (
                torch.arange(self.H // sr, device=dev) * sr
                + (level_index * sr) // level,
                torch.arange(self.W // sc, device=dev) * sc
                + (level_index * sc) // level)
        return self._subgrids[key]

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
        rows, cols = self._rows_cols(level, level_index)
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
        v, _, pix_ok = self._tier_pixels(vn, level, level_index)
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

    # ------------------------------------------------------ transform step

    def _cal_transform(self, value, table, ss):
        """Weighted mean of the first <= count_search improving candidates
        (reference cal_transform, ROtracker.py:606-708)."""
        origin = value[0]
        improving = value < origin
        improving[0] = False
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

    # -------------------------------------------------------------- track

    def track(self, tsdf_bm, origin, c2w_init, depth, ss_init=None,
              sample=None, generator=None):
        """Optimize one frame's pose. tsdf_bm [NB, b^3] f32, origin [3],
        c2w_init [4, 4], depth [H, W] — device tensors; sample / generator
        as vertex_normal_maps takes them (sample_range != 0 only). One
        boolean is read back per iteration (the tier choice needs it on the
        host)."""
        R = c2w_init[:3, :3].clone()
        T = c2w_init[:3, 3].clone()
        ss = self.init_search_size() if ss_init is None else ss_init
        prev_ss = torch.zeros(6, dtype=torch.float32, device=self.device)
        count, level_index = 0, 5
        ema_flag, first_ok = False, False
        count_cap = min(self.particle_iter_lens - 1, 19)
        origin_val = None
        vn = self.vertex_normal_maps(depth, sample, generator)
        for i in range(self.particle_iter_lens):
            cls = count % 3
            slab = self.slab_table[count]
            params, pix, base = self.tier_inputs(
                self.class_level[cls], level_index, R, T, ss, vn, origin)
            value = brick_eval_volume(params, pix, base, tsdf_bm,
                                      self.brick_layout,
                                      self.pst_t[cls][slab],
                                      interp=self.tsdf_interp)
            success_t, min_tsdf, mean_t, mean_q = self._cal_transform(
                value, self.pst[cls][slab], ss)
            origin_val = value[0]
            success = bool(success_t)  # the one readback per iteration
            if success:
                T = T + mean_t
                R = (self._quat_to_rot(mean_q)[:, :, None]
                     * R[None, :, :]).sum(1)
                if count < count_cap:
                    count += 1
            level_index = ((1 if self.fix_level_index else level_index + 5)
                           % self.depth_level[count])
            ss_new = self._update_pst(min_tsdf, mean_t, mean_q)
            ema = ema_flag and success
            if ema:
                ss_new = self.beta * ss_new + (1 - self.beta) * prev_ss
            elif success:
                prev_ss = ss_new
            ss = ss_new
            ema_flag = ema or (success and self.iterative_scale)
            if i == 0:
                first_ok = success
            if not success:
                count = 0
        c2w = torch.eye(4, dtype=torch.float32, device=self.device)
        c2w[:3, :3] = R
        c2w[:3, 3] = T
        return TrackResult(c2w, ss, first_ok, origin_val)

    def init_search_size(self) -> torch.Tensor:
        return torch.full((6,), self.init_size, dtype=torch.float32,
                          device=self.device)

    def do_tracking(self, mv_state, c2w_init, depth, search_size=None,
                    sample=None, generator=None):
        """Optimize the pose of one frame against the moving volume
        (mv_state: ops.tsdf.VolumeState, brick-major; c2w_init [4, 4] and
        depth [H, W] as arrays or tensors; sample [H, W] as an array or
        tensor)."""
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
