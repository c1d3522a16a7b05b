"""Analytic synthetic RGB-D sequence with closed-form ground truth.

Counterpart of remixfusion_tpu.datasets.synthetic (the "synthetic" single-room
orbit scene; the multi-room building comes with a later slice). One exact
ray tracer (ray/sphere, ray/box-slab and ray/axis-plane intersections):
depth and geometry are noise-free and every metric has a closed-form ground
truth. Frames are numpy arrays; the renderer and its frame cache produce
bitwise the frames the JAX package produces, and both packages share the
on-disk cache (same key, same file format) under the temp directory.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from remixfusion_tpu_torch.datasets.base import BaseDataset


def _look_at(eye, target, up=(0.0, -1.0, 0.0)):
    """OpenCV-convention c2w: +z forward, +x right, +y down."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.asarray(up, np.float64)
    right = np.cross(up, fwd)
    if np.linalg.norm(right) < 1e-6:
        right = np.cross((1.0, 0.0, 0.0), fwd)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = right
    c2w[:3, 1] = down
    c2w[:3, 2] = fwd
    c2w[:3, 3] = eye
    return c2w


class AnalyticSceneDataset(BaseDataset):
    """Shared exact ray tracer + SDF ground truth + frame cache.

    Subclasses must set, before use: ``room_dims`` (outer box [0, Lx] x
    [0, Ly] x [0, Lz] — the interior walls are the box faces), ``spheres``
    (list of (center, radius)), ``boxes`` (list of (lo, hi) solid boxes:
    clutter AND interior walls), ``poses`` (list of c2w), ``n_frames``,
    ``min_depth``, and implement ``_cache_key_parts``.
    """

    def __init__(self, cfg):
        super().__init__(cfg)
        self._cache = {}

    def __len__(self):
        return self.n_frames

    def render(self, c2w):
        """Exact ray-traced depth (z-depth) + RGB for one pose.

        Batched over objects and chunked over rays (wall buildings carry
        30+ solid boxes — a per-object python loop over 307k rays was
        8-20 s/frame; this form is ~20x faster with identical per-object
        math: t candidates per object, strict-< winner selection matching
        the sequential spheres->boxes->walls update order)."""
        dirs = np.asarray(self.get_direction())  # [H, W, 3] camera frame
        d_world = dirs @ c2w[:3, :3].T
        o = c2w[:3, 3]

        all_d = d_world.reshape(-1, 3).astype(np.float64)
        t_hit = np.full(all_d.shape[0], np.inf)
        color = np.zeros((all_d.shape[0], 3), np.float32)

        s_c = (np.stack([c for c, _ in self.spheres])
               if self.spheres else np.zeros((0, 3)))
        s_r = np.array([r for _, r in self.spheres], np.float64)
        b_lo = (np.stack([lo for lo, _ in self.boxes])
                if self.boxes else np.zeros((0, 3)))
        b_hi = (np.stack([hi for _, hi in self.boxes])
                if self.boxes else np.zeros((0, 3)))

        chunk = 65536
        for i0 in range(0, all_d.shape[0], chunk):
            sl = slice(i0, min(i0 + chunk, all_d.shape[0]))
            flat_d = all_d[sl]
            t_c = t_hit[sl]
            col_c = color[sl]
            a = np.sum(flat_d * flat_d, axis=1)
            with np.errstate(invalid="ignore", over="ignore",
                             divide="ignore"):
                if len(s_r):
                    oc = (o[None, :] - s_c).astype(np.float64)  # [S, 3]
                    b = 2.0 * flat_d @ oc.T                     # [M, S]
                    c = np.einsum("sk,sk->s", oc, oc) - s_r ** 2
                    disc = b * b - 4 * a[:, None] * c[None, :]
                    sq = np.sqrt(np.maximum(disc, 0))
                    t1 = (-b - sq) / (2 * a)[:, None]
                    t_s = np.where((disc > 0) & (t1 > 1e-6), t1, np.inf)
                    si = np.argmin(t_s, axis=1)
                    t_best = t_s[np.arange(len(t_s)), si]
                    upd = t_best < t_c
                    p = o[None, :] + np.where(upd, t_best, 0.0)[:, None] \
                        * flat_d
                    n = (p - s_c[si]) / s_r[si][:, None]
                    sph_col = 0.5 + 0.45 * np.stack(
                        [np.sin(3 * n[:, 0]) * np.cos(2 * n[:, 1]),
                         np.sin(4 * n[:, 1]),
                         np.cos(3 * n[:, 2])], axis=1)
                    t_c = np.where(upd, t_best, t_c)
                    col_c[upd] = sph_col[upd].astype(np.float32)

                if len(b_lo):
                    inv_d = np.where(flat_d != 0, 1.0 / flat_d, 1e30)
                    t0 = (b_lo[None, :, :] - o[None, None, :]) \
                        * inv_d[:, None, :]                      # [M, B, 3]
                    t1b = (b_hi[None, :, :] - o[None, None, :]) \
                        * inv_d[:, None, :]
                    tmin = np.minimum(t0, t1b).max(axis=2)
                    tmax = np.maximum(t0, t1b).min(axis=2)
                    hit = (tmax > tmin) & (tmin > 1e-6)
                    t_b = np.where(hit, tmin, np.inf)
                    t_best = np.min(t_b, axis=1)
                    upd = t_best < t_c
                    p = o[None, :] + np.where(upd, t_best, 0.0)[:, None] \
                        * flat_d
                    box_col = 0.35 + 0.6 * np.abs(
                        np.sin(p * 4.0)).astype(np.float32)
                    t_c = np.where(upd, t_best, t_c)
                    col_c[upd] = box_col[upd].astype(np.float32)
            t_hit[sl] = t_c
            color[sl] = col_c

        flat_d = all_d
        # Outer box walls (interior): planes x=0, x=Lx, y=0, y=Ly, z=0, z=Lz
        dims = self.room_dims
        wall_colors = np.array([
            [0.85, 0.3, 0.3], [0.3, 0.85, 0.3], [0.3, 0.3, 0.85],
            [0.85, 0.85, 0.3], [0.3, 0.85, 0.85], [0.85, 0.3, 0.85],
        ], np.float32)
        for k, (axis, plane) in enumerate(
                [(0, 0.0), (0, dims[0]), (1, 0.0), (1, dims[1]),
                 (2, 0.0), (2, dims[2])]):
            da = flat_d[:, axis]
            with np.errstate(divide="ignore", invalid="ignore"):
                t_p = (plane - o[axis]) / da
                p = o[None, :] + t_p[:, None] * flat_d
            others = [i for i in range(3) if i != axis]
            su, sv = dims[others[0]], dims[others[1]]
            inside = ((p[:, others[0]] >= -1e-6) & (p[:, others[0]] <= su + 1e-6)
                      & (p[:, others[1]] >= -1e-6) & (p[:, others[1]] <= sv + 1e-6))
            ok = np.isfinite(t_p) & (t_p > 1e-6) & inside & (t_p < t_hit)
            t_hit = np.where(ok, t_p, t_hit)
            # checkerboard shading so mapping has texture to learn
            pu = np.nan_to_num(p[:, others[0]], nan=0.0, posinf=0.0, neginf=0.0)
            pv = np.nan_to_num(p[:, others[1]], nan=0.0, posinf=0.0, neginf=0.0)
            u = np.floor(pu * 2.5).astype(int)
            v = np.floor(pv * 2.5).astype(int)
            shade = np.where((u + v) % 2 == 0, 1.0, 0.72).astype(np.float32)
            color[ok] = wall_colors[k][None, :] * shade[ok, None]

        # z-depth (projection onto camera forward axis), like real sensors
        fwd = c2w[:3, 2].astype(np.float64)
        z = t_hit * (flat_d @ fwd)
        z = np.where(np.isfinite(z), z, 0.0)
        far = self.config["cam"]["far"]
        z = np.where(z > far * 1.5, 0.0, z)
        # real depth sensors report 0 below their minimum range
        z = np.where(z < self.min_depth, 0.0, z)
        H, W = dirs.shape[:2]
        return (color.reshape(H, W, 3),
                z.reshape(H, W).astype(np.float32))

    def gt_sdf(self, pts: np.ndarray) -> np.ndarray:
        """Exact signed distance of the scene at world points [N, 3]
        (positive in free interior space, zero on every surface)."""
        pts = np.asarray(pts, np.float64)
        dims = self.room_dims
        # outer box interior: distance to the box boundary from inside
        d = np.minimum.reduce([
            pts[:, 0], dims[0] - pts[:, 0], pts[:, 1], dims[1] - pts[:, 1],
            pts[:, 2], dims[2] - pts[:, 2]])
        for c, r in self.spheres:
            d = np.minimum(d, np.linalg.norm(pts - c, axis=1) - r)
        for lo, hi in self.boxes:
            q = np.maximum(lo - pts, pts - hi)
            outside = np.linalg.norm(np.maximum(q, 0), axis=1)
            inside = np.minimum(np.max(q, axis=1), 0.0)
            d = np.minimum(d, outside + inside)
        return d.astype(np.float32)

    def gt_mesh(self, voxel_size: float = 0.02):
        """Analytic ground-truth mesh: marching tetrahedra on the exact SDF
        sampled every voxel_size over the room (world coordinates)."""
        from remixfusion_tpu_torch.ops.marching_cubes import marching_cubes

        dims = self.room_dims
        ns = [int(round(dims[i] / voxel_size)) + 1 for i in range(3)]
        axes = [np.linspace(0, dims[i], ns[i], dtype=np.float32)
                for i in range(3)]
        grid = np.stack(
            np.meshgrid(axes[0], axes[1], axes[2], indexing="ij"), -1)
        flat = grid.reshape(-1, 3)
        # chunked: large buildings evaluate tens of millions of points
        sdf = np.concatenate(
            [self.gt_sdf(flat[i:i + 4_000_000])
             for i in range(0, len(flat), 4_000_000)]).reshape(ns)
        verts, faces = marching_cubes(sdf, 0.0)
        verts = verts * voxel_size
        return verts.astype(np.float32), faces

    def _cache_key_parts(self) -> tuple:
        raise NotImplementedError

    def _disk_cache_path(self, index):
        import hashlib
        key = hashlib.md5(
            repr(self._cache_key_parts()).encode()).hexdigest()[:12]
        d = os.path.join(tempfile.gettempdir(), "rmx_syn_cache", key)
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, f"{index}.npz")

    def __getitem__(self, index):
        if index not in self._cache:
            c2w = self.poses[index]
            path = self._disk_cache_path(index)
            if os.path.exists(path):
                data = np.load(path)
                rgb = data["rgb"].astype(np.float32) / 255.0
                depth = data["depth"]
            else:
                rgb, depth = self.render(c2w)
                np.savez_compressed(
                    path, rgb=(rgb * 255).astype(np.uint8), depth=depth)
                # serve the u8-quantized color on the FIRST render too, so
                # results are bitwise-identical whether the disk cache was
                # warm or cold (a virgin run otherwise sees exact-float
                # color once and diverges ~0.4 mm in poses from every
                # later run of the same config)
                rgb = (rgb * 255).astype(np.uint8).astype(np.float32) / 255.0
            self._cache[index] = {
                "frame_id": index,
                "c2w": c2w,
                "rgb": rgb,
                "depth": depth,
                "direction": np.asarray(self.get_direction()),
            }
            if len(self._cache) > 8:
                self._cache.pop(next(iter(self._cache)))
        return self._cache[index]


class SyntheticDataset(AnalyticSceneDataset):
    """Single-room orbit scene (a sphere inside a colored box room)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        syn = cfg["data"].get("synthetic", {})
        self.n_frames = int(syn.get("n_frames", 100))
        self.room_size = float(syn.get("room_size", 4.0))  # box [0, s]^3
        self.room_dims = (self.room_size, self.room_size, self.room_size)
        self.sphere_radius = float(syn.get("sphere_radius", 0.6))
        self.orbit_radius = float(syn.get("orbit_radius", 1.2))
        self.orbit_degrees = float(syn.get("orbit_degrees", 120.0))
        # Scene-variation knobs (all default to the original scene bitwise —
        # recorded baselines stay comparable): a different scene_seed
        # re-scatters the clutter; orbit_radius_z != orbit_radius makes the
        # orbit elliptical; speed_wobble > 0 modulates the angular speed
        # (±~2x at 0.15), stressing the const-speed pose prediction with
        # accelerations a circular orbit never produces.
        self.scene_seed = int(syn.get("scene_seed", 7))
        self.orbit_radius_z = float(syn.get("orbit_radius_z",
                                            self.orbit_radius))
        self.speed_wobble = float(syn.get("speed_wobble", 0.0))
        s = self.room_size
        self.center = np.array([s / 2, s / 2, s / 2], np.float32)
        # Clutter objects: extra spheres + boxes scattered deterministically.
        # Pure planes are sliding-invariant for depth-only tracking; the
        # clutter makes the pose fully observable like a real indoor scene.
        rng = np.random.default_rng(self.scene_seed)
        self.min_depth = float(syn.get("min_depth", 0.3))

        if self.orbit_radius_z == self.orbit_radius:
            def clear_of_orbit(center, radius):
                # distance from the camera orbit circle (y = center plane)
                d_xy = np.hypot(center[0] - self.center[0],
                                center[2] - self.center[2])
                ring = np.hypot(d_xy - self.orbit_radius,
                                center[1] - self.center[1])
                return ring - radius > self.min_depth + 0.1
        else:
            # elliptical path: no closed-form ring distance — test against
            # densely sampled eye positions instead
            eyes = np.stack([self._eye(t)
                             for t in np.linspace(0.0, 1.0, 512)])

            def clear_of_orbit(center, radius):
                d = np.linalg.norm(eyes - center[None, :], axis=1).min()
                return d - radius > self.min_depth + 0.1

        self.spheres = [(self.center.copy(), self.sphere_radius)]
        while len(self.spheres) < 1 + int(syn.get("n_spheres", 8)):
            c = rng.uniform(0.15 * s, 0.85 * s, 3)
            r = rng.uniform(0.06 * s, 0.14 * s)
            if clear_of_orbit(c, r):
                self.spheres.append((c, r))
        self.boxes = []
        while len(self.boxes) < int(syn.get("n_boxes", 5)):
            c = rng.uniform(0.15 * s, 0.85 * s, 3)
            h = rng.uniform(0.05 * s, 0.16 * s, 3)
            if clear_of_orbit(c, float(np.linalg.norm(h))):
                self.boxes.append((c - h, c + h))
        self.poses = [self._pose(i) for i in range(self.n_frames)]
        if syn.get("sensor_noise", 0):
            raise NotImplementedError(
                "data.synthetic.sensor_noise is not ported yet")

    def _eye(self, t: float) -> np.ndarray:
        """Camera position at normalized trajectory time t in [0, 1]."""
        ang = np.deg2rad(self.orbit_degrees) * (
            t + self.speed_wobble * np.sin(2.0 * np.pi * t))
        # op order matters: at the default knobs this must stay bitwise
        # identical to the original circular orbit (recorded baselines)
        eye = self.center + self.orbit_radius * np.array(
            [np.cos(ang), 0.12 * np.sin(2 * ang), np.sin(ang)])
        if self.orbit_radius_z != self.orbit_radius:
            eye[2] = self.center[2] + self.orbit_radius_z * np.sin(ang)
        return eye

    def _pose(self, i):
        t = i / max(self.n_frames - 1, 1)
        return _look_at(self._eye(t), self.center)

    def _cache_key_parts(self) -> tuple:
        # the variation knobs join the key only when non-default, so the
        # default scene's existing cache entries stay valid
        extra = ()
        if (self.scene_seed, self.orbit_radius_z, self.speed_wobble) != \
                (7, self.orbit_radius, 0.0):
            extra = (self.scene_seed, self.orbit_radius_z, self.speed_wobble)
        far = float(self.config["cam"]["far"])
        if far != 5.0:  # far shapes the rendered depth cutoff (z > 1.5*far
            extra += (far,)  # drops to 0); non-default values key the cache
        return (self.n_frames, self.room_size, self.sphere_radius,
                self.orbit_radius, self.orbit_degrees, self.min_depth,
                self.H, self.W, float(self.fx), float(self.fy),
                float(self.cx), float(self.cy),
                len(self.spheres), len(self.boxes)) + extra

