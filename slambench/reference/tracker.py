"""Plain PyTorch reference of one frame's tracking: the candidate tables,
the per-frame vertex and normal maps, each tier's candidate scoring
against the brick-major TSDF volume (nearest lookup in each pixel's 4^3
window, the window cells rounded through bfloat16 as the configuration's
track dtype states), the weighted-mean transform step and the search-size
anneal, for RO.particle_iter_lens iterations.

Frozen copy of the arithmetic of remixfusion_tpu_torch/tracking/{pst,
rotracker}.py and ops/brick_eval.py (the plain version of the scoring) at
the revision this benchmark was written against, for RO.sample_range 0 and
RO.tsdf_interp nearest, the settings of every cell; it raises on others.
It imports nothing of the program and generates its own candidate tables.

`window_dtype` is the dtype the window cells are rounded through:
bfloat16 as configured, or float8_e4m3fn for the control (the precision
below bfloat16).
"""

from __future__ import annotations

import numpy as np
import torch

TIFF_INDEX = [0, 21, 42, 3, 24, 45, 6, 27, 48, 9, 30, 51, 12, 33, 54,
              15, 36, 57, 18, 39]
DEPTH_LEVEL = [32, 16, 8] * 6 + [32, 16]
SIDE = 4
_PST_CACHE: dict = {}


def _fps_reorder(pts, rng):
    n = len(pts)
    if n > 4096:
        return np.concatenate([_fps_reorder(pts[:4096], rng), pts[4096:]])
    order = [0]
    d = np.linalg.norm(pts - pts[0], axis=1)
    for _ in range(n - 1):
        i = int(d.argmax())
        order.append(i)
        d = np.minimum(d, np.linalg.norm(pts - pts[i], axis=1))
    return pts[order]


def pst_table(size: int, slab: int) -> np.ndarray:
    """[size, 6] candidates in the 6D unit ball, identity first."""
    key = (size, slab)
    if key not in _PST_CACHE:
        rng = np.random.default_rng(100003 * size + 7919 * slab + 13)
        v = rng.standard_normal((size, 6))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        pts = (v * rng.random((size, 1)) ** (1.0 / 6.0)).astype(np.float32)
        pts = _fps_reorder(pts, rng)
        pts[0] = 0.0
        _PST_CACHE[key] = pts
    return _PST_CACHE[key]


def slab_of(count: int) -> int:
    idx = TIFF_INDEX[count]
    return (idx - (idx // 20) * 20) // 3


class Tracker:
    def __init__(self, cfg, H, W, K, dims, voxel_size, layout, device,
                 window_dtype=torch.bfloat16):
        ro = cfg["RO"]
        if float(ro["sample_range"]) != 0.0 or str(
                ro.get("tsdf_interp", "nearest")) != "nearest":
            raise ValueError("the reference tracks with sample_range 0 and "
                             "nearest lookups only")
        if ro.get("PST_path"):
            raise ValueError("the reference generates its candidate tables")
        self.dev = torch.device(device)
        self.H, self.W = int(H), int(W)
        self.K = torch.as_tensor(np.asarray(K), dtype=torch.float32,
                                 device=self.dev)
        self.dims = torch.tensor([int(d) for d in dims], dtype=torch.int32,
                                 device=self.dev)
        self.inv_vox = 1.0 / float(voxel_size)
        self.layout = tuple(int(v) for v in layout)
        self.window_dtype = window_dtype
        self.init_size = float(ro["init_size"])
        self.coef = float(ro["scaling_coefficient"])
        self.iters = int(ro["particle_iter_lens"])
        self.count_search = int(ro["count_search"])
        self.fix_level = bool(ro["fix_level_index"])
        self.cut_dist = float(ro["cut_dist"])
        self.iterative = bool(ro["iterative_scale"])
        sizes = list(ro["PST_size"])
        self.sizes = sizes
        self.class_level = tuple(int(v) for v in ro.get(
            "depth_level", DEPTH_LEVEL[:3]))
        self.depth_level = [self.class_level[i % 3]
                            for i in range(len(DEPTH_LEVEL))]
        pix_ref = ro.get("pix_ref", [480, 640])
        self.strides = {}
        for lv in set(self.class_level):
            if pix_ref:
                self.strides[lv] = (max(lv, round(lv * self.H / pix_ref[0])),
                                    max(lv, round(lv * self.W / pix_ref[1])))
            else:
                self.strides[lv] = (lv, lv)
        self._tables = {}

    def table(self, cls, slab):
        key = (cls, slab)
        if key not in self._tables:
            self._tables[key] = torch.as_tensor(
                pst_table(self.sizes[cls], slab), device=self.dev)
        return self._tables[key]

    # ------------------------------------------------------------ maps

    def vertex_normal(self, depth):
        """Vertex [H, W, 4] (xyz, expected tsdf 0) and normal [H, W, 3]."""
        K, H, W = self.K, self.H, self.W
        dev = self.dev
        rows = torch.arange(H, device=dev)
        cols = torch.arange(W, device=dev)
        d_full = torch.where(depth > self.cut_dist, 0.0, depth)

        def vert(ii, jj, iv, jv):
            iic, jjc = ii.clamp(0, H - 1), jj.clamp(0, W - 1)
            d = d_full[iic][:, jjc]
            ok = (iv[:, None] & jv[None, :]) & (d > 0)
            cz = torch.where(ok, d, 0.0)
            cx = (jjc[None, :].to(torch.float32) - K[0, 2]) * cz / K[0, 0]
            cy = (iic[:, None].to(torch.float32) - K[1, 2]) * cz / K[1, 1]
            return cx, cy, cz

        ti, tj = rows >= 0, cols >= 0
        cx, cy, cz = vert(rows, cols, ti, tj)
        lx, ly, lz = vert(rows, cols - 1, ti, cols - 1 >= 0)
        rx, ry, rz = vert(rows, cols + 1, ti, cols + 1 <= W - 1)
        ux, uy, uz = vert(rows - 1, cols, rows - 1 >= 0, tj)
        dx, dy, dz = vert(rows + 1, cols, rows + 1 <= H - 1, tj)
        hx, hy, hz = lx - rx, ly - ry, lz - rz
        vx, vy, vz = ux - dx, uy - dy, uz - dz
        nx, ny, nz = hy * vz - hz * vy, hz * vx - hx * vz, hx * vy - hy * vx
        inv = 1.0 / torch.clamp(torch.sqrt(nx * nx + ny * ny + nz * nz),
                                min=1e-12)
        nx, ny, nz = nx * inv, ny * inv, nz * inv
        flip = nz > 0
        nx = torch.where(flip, -nx, nx)
        ny = torch.where(flip, -ny, ny)
        nz = torch.where(flip, -nz, nz)
        zero = (cz == 0) | (lz == 0) | (rz == 0) | (uz == 0) | (dz == 0)
        nx, ny, nz = (torch.where(zero, 0.0, a) for a in (nx, ny, nz))
        border = ((rows < 1) | (rows > H - 2))[:, None] \
            | ((cols < 1) | (cols > W - 2))[None, :]
        nx, ny, nz = (torch.where(border, 1.0, a) for a in (nx, ny, nz))
        v = torch.stack([cx, cy, cz, torch.zeros_like(cz)], -1)
        return v, torch.stack([nx, ny, nz], -1)

    def tier_pixels(self, vn, level, level_index):
        sr, sc = self.strides[level]
        rows = (torch.arange(self.H // sr, device=self.dev) * sr
                + (level_index * sr) // level).clamp(max=self.H - 1)
        cols = (torch.arange(self.W // sc, device=self.dev) * sc
                + (level_index * sc) // level).clamp(max=self.W - 1)
        v = vn[0][rows][:, cols].reshape(-1, 4)
        n = vn[1][rows][:, cols].reshape(-1, 3)
        ok = (n != 0).any(-1) & (v[:, :3] != 0).any(-1)
        return v, ok

    # --------------------------------------------------------- scoring

    def windows(self, tsdf_bm, base):
        b, BY, BZ = self.layout
        d = torch.arange(SIDE, device=self.dev)
        off = torch.stack(torch.meshgrid(d, d, d, indexing="ij"),
                          -1).reshape(1, SIDE ** 3, 3)
        vox = base[:, None, :].to(torch.int64) + off
        vx, vy, vz = vox[..., 0], vox[..., 1], vox[..., 2]
        bid = ((vx // b) * BY + vy // b) * BZ + vz // b
        within = ((vx % b) * b + vy % b) * b + vz % b
        win = tsdf_bm.reshape(-1)[bid * (b ** 3) + within]
        return win.to(self.window_dtype).to(torch.float32)

    def costs(self, tsdf_bm, origin, R, T, ss, vn, level, level_index,
              table):
        """Cost [C] of every candidate of `table` [C, 6] at search size
        ss: mean |tsdf - expected| over the pairs that reach a valid
        window cell, 1e6 below half the identity candidate's count."""
        v, ok = self.tier_pixels(vn, level, level_index)
        g = (v[:, None, :3] * R[None, :, :]).sum(-1)
        v0 = torch.round((g + T[None, :] - origin[None, :])
                         * self.inv_vox).to(torch.int32)
        base = torch.minimum(torch.clamp(v0 - SIDE // 2, min=1),
                             self.dims - 1 - SIDE)
        win = self.windows(tsdf_bm, base)
        bx, by, bz = (base.to(torch.float32) + origin[None, :]
                      * self.inv_vox).unbind(-1)
        K = self.K
        gx, gy, gz = g[None, :, 0], g[None, :, 1], g[None, :, 2]
        t0, t1, t2, qx, qy, qz = (table[:, i, None] * ss[i]
                                  for i in range(6))
        q0 = torch.sqrt(torch.clamp(1.0 - (qx * qx + qy * qy + qz * qz),
                                    min=1e-12))
        c1x, c1y, c1z = qy * gz - qz * gy, qz * gx - qx * gz, qx * gy - qy * gx
        c2x = qy * c1z - qz * c1y
        c2y = qz * c1x - qx * c1z
        c2z = qx * c1y - qy * c1x
        xw = gx + 2.0 * q0 * c1x + 2.0 * c2x + t0 + T[0]
        yw = gy + 2.0 * q0 * c1y + 2.0 * c2y + t1 + T[1]
        zw = gz + 2.0 * q0 * c1z + 2.0 * c2z + t2 + T[2]
        rx, ry, rz = xw - T[0], yw - T[1], zw - T[2]
        cam_x = R[0, 0] * rx + R[1, 0] * ry + R[2, 0] * rz
        cam_y = R[0, 1] * rx + R[1, 1] * ry + R[2, 1] * rz
        cam_z = R[0, 2] * rx + R[1, 2] * ry + R[2, 2] * rz
        safe = torch.where(cam_z != 0.0, cam_z, torch.full_like(cam_z, 1e-9))
        px = torch.floor(cam_x * K[0, 0] / safe + K[0, 2] + 0.5)
        py = torch.floor(cam_y * K[1, 1] / safe + K[1, 2] + 0.5)
        in_img = ((px >= 0) & (py >= 0) & (px < self.W) & (py < self.H)
                  & (cam_z >= 0))
        ox = torch.round(xw * self.inv_vox) - bx[None, :]
        oy = torch.round(yw * self.inv_vox) - by[None, :]
        oz = torch.round(zw * self.inv_vox) - bz[None, :]
        in_win = ((ox >= 0) & (ox < SIDE) & (oy >= 0) & (oy < SIDE)
                  & (oz >= 0) & (oz < SIDE))
        o = torch.where(in_win, (ox * SIDE + oy) * SIDE + oz,
                        torch.zeros_like(ox)).to(torch.int64)
        rows = torch.arange(win.shape[0], device=self.dev)[None, :]
        vals = win[rows, o.clamp(0, SIDE ** 3 - 1)]
        valid = ok[None, :] & in_img & in_win
        sv = torch.where(valid, torch.abs(vals - v[None, :, 3]),
                         torch.zeros_like(vals)).sum(1)
        cnt = valid.to(torch.float32).sum(1)
        cost = sv / (cnt + 1e-6)
        return torch.where(cnt >= 0.5 * cnt[0], cost,
                           torch.full_like(cost, 1e6))

    # --------------------------------------------------------- the loop

    def transform(self, value, table, ss):
        origin = value[0]
        improving = value < origin
        improving[0] = False
        cum = torch.cumsum(improving.to(torch.int32), 0)
        take = improving & (cum <= self.count_search)
        w = torch.where(take, origin - value, 0.0)
        sw = w.sum()
        success = sw > 0
        sws = torch.where(success, sw, 1.0)
        mean = (w[:, None] * table).sum(0) / sws
        qv = table[:, 3:] * ss[None, 3:]
        qw = (w * torch.sqrt(torch.clamp(1.0 - (qv * qv).sum(-1),
                                         min=1e-12))).sum() / sws
        mean_t = mean[:3] * ss[:3]
        qxyz = mean[3:] * ss[3:]
        qlen = 1.0 / torch.sqrt(qw ** 2 + (qxyz * qxyz).sum() + 1e-12)
        mean_q = torch.cat([qw[None], qxyz]) * qlen
        min_tsdf = torch.where(success, (w * value).sum() / sws, origin)
        return success, min_tsdf, mean_t, mean_q

    @staticmethod
    def quat_to_rot(q):
        qw, qx, qy, qz = q[0], q[1], q[2], q[3]
        return torch.stack([
            1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
            2 * (qx * qz + qy * qw),
            2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
            2 * (qy * qz - qx * qw),
            2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
            1 - 2 * (qx * qx + qy * qy)]).reshape(3, 3)

    def track(self, tsdf_bm, origin, c2w_init, depth, given=None,
              state_dtype=torch.float32):
        """One frame's tracking loop. Returns (c2w [4, 4], steps): steps[i]
        is iteration i's (cls, slab, level, level_index, R, T, ss, costs),
        the tier, pose and search size it scored and the costs it got.

        `given`: the program's steps as capture.py records them. The loop
        then follows the program step by step: iteration i's costs are
        scored on the program's own iteration-i inputs, and the transform
        step moves on with the program's costs, so the rounding of the
        scoring cannot change which candidates improve. `state_dtype`
        rounds the pose and search size through that dtype after every
        step (the control)."""
        def low(x):
            if state_dtype == torch.float32:
                return x
            return x.to(state_dtype).to(torch.float32)

        R = c2w_init[:3, :3].clone()
        T = c2w_init[:3, 3].clone()
        ss = torch.full((6,), self.init_size, dtype=torch.float32,
                        device=self.dev)
        prev_ss = torch.zeros(6, dtype=torch.float32, device=self.dev)
        count, level_index, ema_flag = 0, 5, False
        cap = min(self.iters - 1, 19)
        vn = self.vertex_normal(depth)
        steps = []
        for i in range(self.iters):
            cls = count % 3
            slab = slab_of(count)
            table = self.table(cls, slab)
            level = self.class_level[cls]
            if given is None:
                value = self.costs(tsdf_bm, origin, R, T, ss, vn, level,
                                   level_index, table)
                steps.append((cls, slab, level, level_index, R, T, ss,
                              value))
            else:
                g = given[i]
                pt = self.table(g[0], g[1])
                steps.append((cls, slab, level, level_index, R, T, ss,
                              self.costs(tsdf_bm, origin, g[4], g[5], g[6],
                                         vn, g[2], g[3], pt)))
                value = g[7]
            ok, min_tsdf, mean_t, mean_q = self.transform(value, table, ss)
            success = bool(ok)
            if success:
                T = low(T + mean_t)
                R = low((self.quat_to_rot(mean_q)[:, :, None]
                         * R[None, :, :]).sum(1))
                if count < cap:
                    count += 1
            level_index = ((1 if self.fix_level else level_index + 5)
                           % self.depth_level[count])
            s = torch.abs(torch.cat([mean_t, mean_q[1:]])) + 1e-3
            ss_new = self.coef * min_tsdf * s / torch.sqrt((s * s).sum()) \
                + 1e-3
            ema = ema_flag and success
            if ema:
                ss_new = 0.9 * ss_new + 0.1 * prev_ss
            elif success:
                prev_ss = ss_new
            ss = low(ss_new)
            ema_flag = ema or (success and self.iterative)
            if not success:
                count = 0
        c2w = torch.eye(4, dtype=torch.float32, device=self.dev)
        c2w[:3, :3] = R
        c2w[:3, 3] = T
        return c2w, steps
