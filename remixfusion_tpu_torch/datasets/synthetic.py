"""Analytic synthetic RGB-D sequence with closed-form ground truth.

Counterpart of remixfusion_tpu.datasets.synthetic. Two scene families share
one exact ray tracer (ray/sphere, ray/box-slab and ray/axis-plane
intersections: depth and geometry are noise-free and every metric has a
closed-form ground truth):

- ``SyntheticDataset`` ("synthetic"): a single box room with a sphere and
  scattered clutter, the camera orbiting the room centre;
- ``SyntheticLargeDataset`` ("synthetic_large"): a multi-room building,
  rooms of distinct clutter off a long corridor, walls as solid boxes with
  door openings, traversed by a waypoint walk with a return pass (the
  large-scale regime of configs/Synthetic/synthetic_corridor.yaml: the
  building is several times the moving local volume).

Frames are numpy arrays; the renderer and its frame cache produce bitwise
the frames the JAX package produces, and both packages share the on-disk
cache (same key, same file format) under the temp directory. With
data.synthetic.sensor_noise (1, or a dict of utils.noise.add_sensor_noise
keywords) each frame is corrupted after the cache by Kinect-class noise
from a frame-seeded generator; the ground truth (gt_sdf, gt_mesh) stays
exact.
"""

from __future__ import annotations

import multiprocessing
import os
import tempfile
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

from remixfusion_tpu_torch.datasets.base import BaseDataset
from remixfusion_tpu_torch.utils.noise import add_sensor_noise


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


# rays per block of the box slab test and per chunk of the renderer, points
# per chunk of the exact SDF, the processes rendering missing frames
# (threads evaluating the SDF), and the fewest missing rays worth starting
# them for (~14 frames of 640x480)
_SLAB_ROWS = 4096
_RAY_CHUNK = 8192
_SDF_ROWS = 65536
_RENDER_WORKERS = min(8, os.cpu_count() or 1)
_WORKER_RAYS = 1 << 22
# box culling: a box is grown by _BOX_GROW (m) before its camera-frame
# slopes are taken, and a block of rays keeps every box whose slopes come
# within _SLOPE_PAD of the block's (float32 ray directions move a slope by
# ~1e-7)
_BOX_GROW = 1e-6
_SLOPE_PAD = 1e-3
_EDGES = [(c, c | 1 << k) for c in range(8) for k in range(3)
          if not c >> k & 1]


def _box_slopes(lo, hi, c2w):
    """[B, 4] per box: the least and largest x/z, then y/z, camera-frame
    slope of the points of the box (grown by _BOX_GROW) in front of the
    camera (z > 0); the side of a range is infinite where the box reaches
    the camera plane, and the range empty (inf, -inf) for a box wholly
    behind it. A ray of the pixel grid can hit only a box whose ranges hold
    its slopes."""
    bits = np.array([[c >> k & 1 for k in range(3)] for c in range(8)], bool)
    corners = np.where(bits[None], (hi + _BOX_GROW)[:, None],
                       (lo - _BOX_GROW)[:, None])
    rot = c2w[:3, :3].astype(np.float64)
    cam = (corners - c2w[:3, 3].astype(np.float64)) @ np.linalg.inv(rot).T
    x, y, z = cam[..., 0], cam[..., 1], cam[..., 2]
    front = z > 0
    zf = np.where(front, z, 1.0)
    a, b = np.array(_EDGES).T
    cross = front[:, a] != front[:, b]
    with np.errstate(divide="ignore", invalid="ignore"):
        f = np.where(cross, z[:, a] / (z[:, a] - z[:, b]), 0.0)
    out = []
    for v in (x, y):
        s = v / zf
        q = v[:, a] + (v[:, b] - v[:, a]) * f  # where an edge meets z = 0
        lo_s = np.where(front, s, np.inf).min(1)
        hi_s = np.where(front, s, -np.inf).max(1)
        lo_s[(cross & (q < _BOX_GROW)).any(1)] = -np.inf
        hi_s[(cross & (q > -_BOX_GROW)).any(1)] = np.inf
        out += [lo_s, hi_s]
    return np.stack(out, 1)


def _slab_hits(lo_o, hi_o, inv_d, slopes=None, box_slopes=None):
    """Nearest entry distance of each ray into any of B boxes (slab test;
    inf where none is hit in front of the origin): lo_o, hi_o [B, 3] the
    box corners minus the ray origin, inv_d [M, 3] the inverse directions.
    The JAX renderer's per-element arithmetic ((corner - o) * inv_d, the
    min / max over the three axes, the hit test, the min over boxes) on
    [_SLAB_ROWS, B] blocks one axis at a time instead of [M, B, 3] arrays,
    which keeps the temporaries in cache. With the rays' camera-frame
    slopes [M, 2] and _box_slopes, a block tests only the boxes its rays
    can reach: the others would add inf to the min. The result is bitwise
    the same."""
    out = np.empty(inv_d.shape[0])
    for r0 in range(0, inv_d.shape[0], _SLAB_ROWS):
        iv = inv_d[r0:r0 + _SLAB_ROWS]
        lo_b, hi_b = lo_o, hi_o
        if box_slopes is not None:
            s = slopes[r0:r0 + _SLAB_ROWS]
            s_lo, s_hi = s.min(0) - _SLOPE_PAD, s.max(0) + _SLOPE_PAD
            keep = ((box_slopes[:, 1] >= s_lo[0])
                    & (box_slopes[:, 0] <= s_hi[0])
                    & (box_slopes[:, 3] >= s_lo[1])
                    & (box_slopes[:, 2] <= s_hi[1]))
            if not keep.any():
                out[r0:r0 + _SLAB_ROWS] = np.inf
                continue
            lo_b, hi_b = lo_o[keep], hi_o[keep]
        tmin = tmax = None
        for k in range(3):
            a = lo_b[None, :, k] * iv[:, k, None]
            b = hi_b[None, :, k] * iv[:, k, None]
            near, far = np.minimum(a, b), np.maximum(a, b)
            tmin = near if tmin is None else np.maximum(tmin, near)
            tmax = far if tmax is None else np.minimum(tmax, far)
        hit = (tmax > tmin) & (tmin > 1e-6)
        out[r0:r0 + _SLAB_ROWS] = np.where(hit, tmin, np.inf).min(axis=1)
    return out


def _render_into_cache(scene, jobs):
    """A render_missing worker: the scene's (frame, cache path) pairs
    rendered into the cache."""
    for i, path in jobs:
        rgb, depth = scene.render(scene.poses[i])
        scene._write_cache(path, rgb, depth)


class AnalyticSceneDataset(BaseDataset):
    """Shared exact ray tracer + SDF ground truth + frame cache.

    Subclasses must set, before use: ``room_dims`` (outer box [0, Lx] x
    [0, Ly] x [0, Lz] — the interior walls are the box faces), ``spheres``
    (list of (center, radius)), ``boxes`` (list of (lo, hi) solid boxes:
    clutter AND interior walls), ``poses`` (list of c2w), ``n_frames``,
    ``min_depth``, ``sensor_noise`` (None or add_sensor_noise keywords),
    and implement ``_cache_key_parts``.
    """

    def __init__(self, cfg):
        super().__init__(cfg)
        self._cache = {}

    def __len__(self):
        return self.n_frames

    def __getstate__(self):
        # a render worker gets the scene, not the frames served so far
        return dict(self.__dict__, _cache={})

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

        if len(b_lo):
            box_s = _box_slopes(b_lo, b_hi, c2w)
            slopes = dirs.reshape(-1, 3).astype(np.float64)
            slopes = slopes[:, :2] / slopes[:, 2:]

        # outer box walls (interior): planes x=0, x=Lx, y=0, y=Ly, z=0, z=Lz
        dims = self.room_dims
        planes = [(0, 0.0), (0, dims[0]), (1, 0.0), (1, dims[1]),
                  (2, 0.0), (2, dims[2])]
        wall_colors = np.array([
            [0.85, 0.3, 0.3], [0.3, 0.85, 0.3], [0.3, 0.3, 0.85],
            [0.85, 0.85, 0.3], [0.3, 0.85, 0.85], [0.85, 0.3, 0.85],
        ], np.float32)

        chunk = _RAY_CHUNK
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
                    # the colour of the rays it updates only
                    p = o[None, :] + t_best[upd][:, None] * flat_d[upd]
                    n = (p - s_c[si[upd]]) / s_r[si[upd]][:, None]
                    sph_col = 0.5 + 0.45 * np.stack(
                        [np.sin(3 * n[:, 0]) * np.cos(2 * n[:, 1]),
                         np.sin(4 * n[:, 1]),
                         np.cos(3 * n[:, 2])], axis=1)
                    t_c = np.where(upd, t_best, t_c)
                    col_c[upd] = sph_col.astype(np.float32)

                if len(b_lo):
                    inv_d = np.where(flat_d != 0, 1.0 / flat_d, 1e30)
                    t_best = _slab_hits(b_lo - o, b_hi - o, inv_d,
                                        slopes[sl], box_s)
                    upd = t_best < t_c
                    p = o[None, :] + t_best[upd][:, None] * flat_d[upd]
                    box_col = 0.35 + 0.6 * np.abs(
                        np.sin(p * 4.0)).astype(np.float32)
                    t_c = np.where(upd, t_best, t_c)
                    col_c[upd] = box_col.astype(np.float32)

                for k, (axis, plane) in enumerate(planes):
                    others = [i for i in range(3) if i != axis]
                    t_p = (plane - o[axis]) / flat_d[:, axis]
                    pu, pv = (o[c] + t_p * flat_d[:, c] for c in others)
                    su, sv = dims[others[0]], dims[others[1]]
                    inside = ((pu >= -1e-6) & (pu <= su + 1e-6)
                              & (pv >= -1e-6) & (pv <= sv + 1e-6))
                    ok = (np.isfinite(t_p) & (t_p > 1e-6) & inside
                          & (t_p < t_c))
                    t_c = np.where(ok, t_p, t_c)
                    # checkerboard shading so mapping has texture to learn
                    # (the hit points are finite where ok)
                    u = np.floor(pu[ok] * 2.5).astype(int)
                    v = np.floor(pv[ok] * 2.5).astype(int)
                    shade = np.where((u + v) % 2 == 0, 1.0,
                                     0.72).astype(np.float32)
                    col_c[ok] = wall_colors[k][None, :] * shade[:, None]
            t_hit[sl] = t_c
            color[sl] = col_c

        flat_d = all_d
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
        # large buildings evaluate tens of millions of points: in chunks
        # that stay in cache, on threads (numpy releases the GIL)
        with ThreadPoolExecutor(_RENDER_WORKERS) as ex:
            sdf = np.concatenate(list(ex.map(
                lambda i: self.gt_sdf(flat[i:i + _SDF_ROWS]),
                range(0, len(flat), _SDF_ROWS)))).reshape(ns)
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

    @staticmethod
    def _write_cache(path, rgb, depth):
        """The cache entry (u8 colour, float32 depth), written to a temporary
        name and moved into place, so a reader never sees half a file."""
        tmp = f"{path}.{os.getpid()}.{id(rgb)}.tmp"
        with open(tmp, "wb") as f:
            np.savez_compressed(f, rgb=(rgb * 255).astype(np.uint8),
                                depth=depth)
        os.replace(tmp, path)

    def render_missing(self, indices):
        """Render the frames of `indices` that the disk cache lacks into
        the cache, in up to _RENDER_WORKERS worker processes, each given
        every n-th frame (a render's many small numpy calls hold the GIL
        between them, so threads do not scale), or in this process when
        they hold fewer than _WORKER_RAYS rays; __getitem__ then reads
        them. Returns how many were rendered."""
        todo = [i for i in indices
                if not os.path.exists(self._disk_cache_path(i))]
        if not todo:
            return 0
        self.get_direction()  # the ray grid, computed once for every worker
        jobs = [(i, self._disk_cache_path(i)) for i in todo]
        if len(jobs) * self.H * self.W < _WORKER_RAYS:
            _render_into_cache(self, jobs)  # less work than starting workers
            return len(jobs)
        n = min(_RENDER_WORKERS, len(jobs))
        with ProcessPoolExecutor(
                n, mp_context=multiprocessing.get_context("spawn")) as ex:
            list(ex.map(_render_into_cache, [self] * n,
                        [jobs[k::n] for k in range(n)]))
        return len(jobs)

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
                self._write_cache(path, rgb, depth)
                # serve the u8-quantized color on the first render too, so
                # the frames are bitwise the same whether the disk cache was
                # warm or cold
                rgb = (rgb * 255).astype(np.uint8).astype(np.float32) / 255.0
            if self.sensor_noise is not None:
                depth, rgb = add_sensor_noise(
                    depth, rgb, np.random.default_rng(1000003 + index),
                    **self.sensor_noise)
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


def _sensor_noise(syn) -> dict | None:
    """data.synthetic.sensor_noise: 0 (off), 1 (the defaults) or a dict of
    add_sensor_noise keywords."""
    sn = syn.get("sensor_noise", 0)
    return dict(sn) if isinstance(sn, dict) else ({} if sn else None)


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
        self.sensor_noise = _sensor_noise(syn)

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


class SyntheticLargeDataset(AnalyticSceneDataset):
    """Multi-room building walk: the large-scale online-reconstruction
    regime (BS3D corridor/cafeteria-class; reference configs/BS3D/ and the
    moving-volume machinery Volume.py:930-1082 exist for exactly this).

    Floor plan (x right, z up in plan view; y is the vertical axis of the
    world, camera height ~mid-story):

        z=Lz +----------+-+----------+-+----------+
             |  room 0  |w|  room 1  |w|  room 2  |   rooms: distinct
             |          |a|          |a|          |   clutter per room
        z=cw +--door----+l+--door----+l+--door----+   wall w/ door gaps
             |               corridor             |
        z=0  +------------------------------------+
             x=0                                  x=Lx

    Walls are SOLID boxes (thickness ``wall``) with door openings (width
    ``door_w``, height ``door_h``, lintel above), so rendering and gt_sdf
    are exact (see module docstring). The trajectory starts inside room 0,
    exits through its door, walks the corridor to the far room, tours it in
    a smooth loop, and returns along the corridor into room 0 — a
    tens-of-meters non-loop path with a return pass through previously
    mapped space, several times the moving-volume extent end to end.
    """

    def __init__(self, cfg):
        super().__init__(cfg)
        syn = cfg["data"].get("synthetic", {})
        self.n_frames = int(syn.get("n_frames", 640))
        self.scene_seed = int(syn.get("scene_seed", 11))
        self.min_depth = float(syn.get("min_depth", 0.3))
        self.n_rooms = int(syn.get("n_rooms", 3))
        self.room_w = float(syn.get("room_width", 7.2))     # x extent/room
        self.room_d = float(syn.get("room_depth", 7.0))     # z extent
        self.height = float(syn.get("height", 3.0))         # y extent
        self.corridor_w = float(syn.get("corridor_width", 2.8))
        self.wall = float(syn.get("wall_thickness", 0.2))
        self.door_w = float(syn.get("door_width", 1.6))
        self.door_h = float(syn.get("door_height", 2.3))
        self.eye_h = float(syn.get("eye_height", 1.5))      # below ceiling
        self.look_ahead = float(syn.get("look_ahead", 1.8)) # meters
        # Downward look offset (meters at look_ahead; y is down-positive):
        # ~9 deg of downward pitch like a person scanning a building. This
        # is load-bearing for the floor's fusion quality: a dead-level (or
        # slightly upward) gaze leaves the floor at extreme grazing where
        # the projective-TSDF update margin is thinner than the
        # grazing-amplified effect of a ~2 cm pose error, and the far
        # floor band never fuses (measured round 4).
        self.look_down = float(syn.get("look_down", 0.3))
        self.sway_deg = float(syn.get("sway_degrees", 10.0))
        self.sway_period = float(syn.get("sway_period", 90.0))  # frames

        nr, rw, w = self.n_rooms, self.room_w, self.wall
        Lx = nr * rw + (nr - 1) * w
        Lz = self.corridor_w + w + self.room_d
        Ly = self.height
        self.room_dims = (Lx, Ly, Lz)
        cw = self.corridor_w
        # room i occupies x in [x0_i, x0_i + rw], z in [cw + w, Lz]
        self._room_x0 = [i * (rw + w) for i in range(nr)]
        self._door_x = [x0 + rw / 2 for x0 in self._room_x0]

        # --- walls as solid boxes -------------------------------------
        boxes = []
        # corridor/room separating wall (z in [cw, cw+w]) with a door gap
        # per room + lintel above each door (y measures DOWN from the
        # ceiling y=0; the floor is y=Ly, so the lintel is y in
        # [0, Ly - door_h])
        xs = [0.0]
        for dx in self._door_x:
            xs += [dx - self.door_w / 2, dx + self.door_w / 2]
        xs.append(Lx)
        for i in range(0, len(xs), 2):  # solid segments between doors
            if xs[i + 1] - xs[i] > 1e-6:
                boxes.append((np.array([xs[i], 0.0, cw]),
                              np.array([xs[i + 1], Ly, cw + w])))
        for dx in self._door_x:         # lintels
            boxes.append((np.array([dx - self.door_w / 2, 0.0, cw]),
                          np.array([dx + self.door_w / 2,
                                    Ly - self.door_h, cw + w])))
            # door trim: jambs + head casing protruding from both wall
            # faces (real buildings have them; they are also the forward
            # depth texture that constrains tracking when walking straight
            # at a door — a bare wall + opening is depth-degenerate in the
            # lateral directions)
            tw, tp = 0.09, 0.05    # trim width / protrusion
            for side in (-1, 1):
                x_edge = dx + side * self.door_w / 2
                boxes.append((
                    np.array([x_edge - (tw if side < 0 else 0.0),
                              Ly - self.door_h - tw, cw - tp]),
                    np.array([x_edge + (tw if side > 0 else 0.0),
                              Ly, cw + w + tp])))
            boxes.append((
                np.array([dx - self.door_w / 2 - tw,
                          Ly - self.door_h - tw, cw - tp]),
                np.array([dx + self.door_w / 2 + tw,
                          Ly - self.door_h, cw + w + tp])))
        # divider walls between rooms (full height, rooms side only)
        for i in range(nr - 1):
            x0 = self._room_x0[i] + rw
            boxes.append((np.array([x0, 0.0, cw]),
                          np.array([x0 + w, Ly, Lz])))

        # --- clutter: distinct per room + corridor furniture ----------
        rng = np.random.default_rng(self.scene_seed)
        spheres = []
        clutter_boxes = []
        n_box_room = int(syn.get("n_boxes_per_room", 5))
        n_sph_room = int(syn.get("n_spheres_per_room", 3))
        for i in range(nr):
            x0 = self._room_x0[i]
            # furniture boxes stand on the floor (y up to Ly)
            k = 0
            while k < n_box_room:
                c = np.array([rng.uniform(x0 + 0.8, x0 + rw - 0.8),
                              0.0,
                              rng.uniform(cw + w + 0.8, Lz - 0.8)])
                h = rng.uniform(0.25, 0.7, 3)
                c[1] = Ly - h[1]  # resting on the floor
                lo = np.array([c[0] - h[0], c[1] - h[1], c[2] - h[2]])
                hi = np.array([c[0] + h[0], Ly, c[2] + h[2]])
                clutter_boxes.append((lo, hi))
                k += 1
            k = 0
            while k < n_sph_room:
                c = np.array([rng.uniform(x0 + 0.9, x0 + rw - 0.9),
                              rng.uniform(0.5, Ly - 0.5),
                              rng.uniform(cw + w + 0.9, Lz - 0.9)])
                r = rng.uniform(0.25, 0.45)
                spheres.append((c, r))
                k += 1
        # corridor furniture along the south wall (z near 0): benches /
        # cabinets that give the depth-only tracker forward observability
        n_corr = int(syn.get("n_corridor_boxes", max(4, int(Lx // 4))))
        for i in range(n_corr):
            cx = rng.uniform(1.0, Lx - 1.0)
            hx = rng.uniform(0.3, 0.7)
            hy = rng.uniform(0.4, 0.9)
            hz = rng.uniform(0.25, 0.45)
            clutter_boxes.append((
                np.array([cx - hx, Ly - 2 * hy, 0.0]),
                np.array([cx + hx, Ly, 2 * hz])))
        # wall-mounted panels on the corridor's north wall between doors
        for i in range(nr - 1):
            cx = (self._door_x[i] + self._door_x[i + 1]) / 2
            clutter_boxes.append((
                np.array([cx - 0.8, 0.6, cw - 0.12]),
                np.array([cx + 0.8, 1.6, cw])))
        # ceiling light fixtures (corridor + rooms): shallow boxes hanging
        # from the ceiling (y=0). Real corridors have them, and they are
        # the pitch/yaw anchors a depth-only tracker needs where walls and
        # floor are sliding-degenerate planes.
        for i in range(int(Lx // 2.2)):
            cx = 1.2 + 2.2 * i
            clutter_boxes.append((
                np.array([cx - 0.55, 0.0, cw / 2 - 0.22]),
                np.array([cx + 0.55, 0.12, cw / 2 + 0.22])))
        # transverse ceiling beams + wall pilasters along the corridor.
        # A corridor of bare parallel planes is sliding-degenerate for
        # depth-only tracking — every wall/floor/ceiling pixel is invariant
        # to motion along the corridor axis, so the |TSDF| fitness is flat
        # along the walk and the randomized optimizer's weighted-mean
        # update systematically undershoots (measured: monotone negative
        # forward drift, then collapse). Real BS3D-class corridors are
        # geometrically rich (beams, pillars, door recesses, radiators);
        # beams/pilasters give frontal faces at every depth along the walk.
        for i in range(int(Lx // 2.4)):
            bx = 1.9 + 2.4 * i
            clutter_boxes.append((          # beam across the ceiling
                np.array([bx - 0.07, 0.0, 0.0]),
                np.array([bx + 0.07, 0.21, cw])))
        door_keepout = self.door_w / 2 + 0.45
        for i in range(int(Lx // 3.1)):
            px_ = 1.3 + 3.1 * i
            clutter_boxes.append((          # pilaster, south corridor wall
                np.array([px_ - 0.09, 0.0, 0.0]),
                np.array([px_ + 0.09, Ly, 0.16])))
            pxn = px_ + 1.4                 # north wall: keep doors clear
            if all(abs(pxn - dx) > door_keepout for dx in self._door_x):
                clutter_boxes.append((
                    np.array([pxn - 0.09, 0.0, cw - 0.16]),
                    np.array([pxn + 0.09, Ly, cw])))
        for i in range(nr):
            rcx = self._room_x0[i] + rw / 2
            rcz = cw + w + self.room_d / 2
            for ox, oz in ((-rw / 4, -self.room_d / 4),
                           (rw / 4, self.room_d / 4)):
                clutter_boxes.append((
                    np.array([rcx + ox - 0.5, 0.0, rcz + oz - 0.3]),
                    np.array([rcx + ox + 0.5, 0.12, rcz + oz + 0.3])))
        # picture frames / boards on room walls (geometric wall texture)
        for i in range(nr):
            x0 = self._room_x0[i]
            zw_north = Lz
            clutter_boxes.append((         # north wall board
                np.array([x0 + rw * 0.3, 0.55, zw_north - 0.07]),
                np.array([x0 + rw * 0.7, 1.45, zw_north])))
            clutter_boxes.append((         # room-side face of the door wall
                np.array([x0 + rw * 0.62, 0.5, cw + w]),
                np.array([x0 + rw * 0.9, 1.35, cw + w + 0.07])))

        # --- trajectory: room 0 -> corridor -> far room tour -> return
        self._build_trajectory(syn)

        # keep CLUTTER clear of the path (min_depth + margin), mirroring
        # the orbit scene's clear_of_orbit guarantee; walls are layout and
        # are asserted clear instead of silently dropped
        eyes = np.stack([p[:3, 3] for p in self.poses])

        def box_path_dist(lo, hi):
            q = np.maximum(lo[None, :] - eyes, eyes - hi[None, :])
            return float(np.linalg.norm(np.maximum(q, 0), axis=1).min())

        margin = self.min_depth + 0.1
        self.spheres = [
            (c, r) for c, r in spheres
            if np.linalg.norm(eyes - c[None, :], axis=1).min() - r > margin]
        clutter_boxes = [(lo, hi) for lo, hi in clutter_boxes
                         if box_path_dist(lo, hi) > margin]
        for lo, hi in boxes:
            d = box_path_dist(lo, hi)
            assert d > margin, (
                f"trajectory passes within {d:.2f} m of a wall box "
                f"{lo}..{hi} — widen doors or adjust waypoints")
        self.boxes = boxes + clutter_boxes

        self.sensor_noise = _sensor_noise(syn)

    # ----------------------------------------------------------- trajectory

    def _waypoints(self) -> np.ndarray:
        """Plan-view (x, z) waypoints of the walk."""
        cw, w = self.corridor_w, self.wall
        z_mid = cw / 2 + 0.1             # corridor centerline
        d0 = self._door_x[0]             # start room door
        d2 = self._door_x[-1]            # far room door
        far_x0 = self._room_x0[-1]
        # far-room tour circle
        ccx = far_x0 + self.room_w / 2
        ccz = cw + w + self.room_d * 0.52
        rr = min(self.room_w, self.room_d) * 0.22
        rd = self.room_d
        z_in = cw + w + min(1.2, 0.3 * rd)   # just inside a room door
        pts = [(d0, cw + w + 0.46 * rd), (d0, z_in), (d0, z_mid),
               ((d0 + d2) / 2, z_mid), (d2, z_mid)]
        # tour: enter heading north (+z) through the door, pick up the
        # circle at its SOUTH point (tangent is +-x there: a single smoothed
        # ~90 deg corner, no hairpin), loop ~330 deg, exit back to the door
        for k in range(15):
            a = 2 * np.pi * 0.92 * (k / 14.0)
            pts.append((ccx + rr * np.sin(a), ccz - rr * np.cos(a)))
        pts += [(d2, z_mid), ((d0 + d2) / 2, z_mid),
                (d0, z_mid), (d0, z_in), (d0, cw + w + 0.43 * rd)]
        return np.asarray(pts, np.float64)

    def _build_trajectory(self, syn):
        way = self._waypoints()
        # densify the polyline, then box-filter to round the corners
        seg = np.linalg.norm(np.diff(way, axis=0), axis=1)
        n_dense = 6000
        t_knot = np.concatenate([[0.0], np.cumsum(seg)]) / seg.sum()
        t_dense = np.linspace(0.0, 1.0, n_dense)
        dense = np.stack([np.interp(t_dense, t_knot, way[:, k])
                          for k in range(2)], axis=1)
        win = max(3, int(round(float(syn.get("corner_smooth", 0.9))
                               / (seg.sum() / n_dense))))
        ker = np.ones(win) / win
        pad = np.concatenate([np.repeat(dense[:1], win, 0), dense,
                              np.repeat(dense[-1:], win, 0)])
        sm = np.stack([np.convolve(pad[:, k], ker, "same")
                       for k in range(2)], axis=1)[win:-win]
        # arc-length + speed profile: cosine ease-in/out over ramp_frames
        # so the const-speed pose prediction never sees a velocity step
        arc = np.concatenate([[0.0], np.cumsum(
            np.linalg.norm(np.diff(sm, axis=0), axis=1))])
        self.path_len = float(arc[-1])
        n = self.n_frames
        ramp = min(int(syn.get("ramp_frames", 25)), n // 4)
        v = np.ones(n)
        if ramp > 0:
            v[:ramp] = 0.5 * (1 - np.cos(np.pi * (np.arange(ramp) + 1)
                                         / (ramp + 1)))
            v[-ramp:] = v[:ramp][::-1]
        # Human-like turn dynamics (synthetic.turn_rate_cap, deg/frame;
        # 0 = constant-speed walk): people slow down through turns — real
        # BS3D-class handheld capture never sustains multi-deg/frame yaw
        # at full walking speed. Capping the per-frame heading change
        # redistributes the fixed frame budget (slower in turns, faster on
        # straights, same path): v_i is scaled by cap / (kappa * step) and
        # renormalized, iterated to a fixed point.
        turn_cap = float(syn.get("turn_rate_cap", 0.0))
        if turn_cap > 0:
            tang = np.gradient(sm, axis=0)
            ds = np.linalg.norm(tang, axis=1)
            theta = np.unwrap(np.arctan2(tang[:, 1], tang[:, 0]))
            kappa = np.abs(np.gradient(theta)) / np.maximum(ds, 1e-12)
            cap_rad = np.deg2rad(turn_cap)
            for _ in range(4):
                s_f = np.concatenate([[0.0], np.cumsum(v)[:-1]])
                s_f = s_f / s_f[-1] * self.path_len
                step = np.gradient(s_f)
                kap_f = np.interp(s_f, arc, kappa)
                scale = np.minimum(
                    1.0, cap_rad / np.maximum(kap_f * step, 1e-12))
                base = np.ones(n)
                if ramp > 0:
                    base[:ramp] = v[:ramp] / np.maximum(v[:ramp], 1e-12) \
                        * 0.5 * (1 - np.cos(np.pi * (np.arange(ramp) + 1)
                                            / (ramp + 1)))
                    base[-ramp:] = base[:ramp][::-1]
                v = base * scale
        s_frames = np.concatenate([[0.0], np.cumsum(v)[:-1]])
        s_frames = s_frames / s_frames[-1] * self.path_len

        # end tangents so the look target extrapolates smoothly past the
        # path ends (clamping it at the endpoint pitches the camera down
        # as the eye closes in, ending with an unstable look direction)
        tan_end = sm[-1] - sm[-40]
        tan_end /= np.linalg.norm(tan_end) + 1e-12
        tan_start = sm[40] - sm[0]
        tan_start /= np.linalg.norm(tan_start) + 1e-12

        def at(s):
            if s > self.path_len:
                return sm[-1] + tan_end * (s - self.path_len)
            if s < 0.0:
                return sm[0] + tan_start * s
            return np.array([np.interp(s, arc, sm[:, 0]),
                             np.interp(s, arc, sm[:, 1])])

        Ly = self.height
        self.poses = []
        for i in range(n):
            p = at(s_frames[i])
            # y measures down from the ceiling: floor at y=Ly
            eye_y = Ly - self.eye_h + 0.04 * np.sin(0.31 * i)
            eye = np.array([p[0], eye_y, p[1]])
            tgt2 = at(s_frames[i] + self.look_ahead)
            look = np.array([tgt2[0], eye_y + self.look_down, tgt2[1]])
            # lateral head sway (scan the walls while walking)
            if self.sway_deg > 0:
                a = np.deg2rad(self.sway_deg) * np.sin(
                    2 * np.pi * i / self.sway_period)
                dv = look - eye
                ca, sa = np.cos(a), np.sin(a)
                dv = np.array([ca * dv[0] + sa * dv[2], dv[1],
                               -sa * dv[0] + ca * dv[2]])
                look = eye + dv
            self.poses.append(_look_at(eye, look))

    def _cache_key_parts(self) -> tuple:
        # turn_rate_cap keys the cache only when set, so the default
        # scene's existing entries stay valid
        cap = float(self.config["data"]["synthetic"].get(
            "turn_rate_cap", 0.0))
        extra = (cap,) if cap else ()
        return ("large", float(self.config["cam"]["far"]),
                self.n_frames, self.scene_seed, self.n_rooms,
                self.room_w, self.room_d, self.height, self.corridor_w,
                self.wall, self.door_w, self.door_h, self.eye_h,
                self.look_ahead, self.look_down, self.sway_deg,
                self.sway_period,
                self.min_depth, self.H, self.W, float(self.fx),
                float(self.fy), float(self.cx), float(self.cy),
                len(self.spheres), len(self.boxes)) + extra
