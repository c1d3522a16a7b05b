"""Moving local TSDF volume: device state + host re-center policy.

Counterpart of remixfusion_tpu.tracking.volume.MovingVolume (reference
model/Volume.py:19-619). The volume's shape is fixed from the config
(extents 2*{x,y,z}_len at volume.voxel_size); re-centering moves the
integer-rounded origin. The re-center decisions ("center": per-axis
translation thresholds; "more": dominant-view-direction boxes,
Volume.py:930-1082) run on the host between frames.

With volume.brick_fusion (the default) the dims are padded to whole bricks
and the state is brick-major: re-centering permutes whole bricks
(ops.tsdf.shift_volume_bm), fusion goes through the brick fuser on
host-selected bricks (no bucket padding: the selected rows are fused as
they are), and the first frame seeds the volume by fusing every brick.
With brick_fusion false the state is a dense [X, Y, Z] volume (dims not
padded; layout (1, Y, Z) for the readers' index arithmetic): a frame fuses
the frustum tiles of frustum_tiles when a tile edge from TILE_EDGES divides
every dim and the tiles fit volume.tile_budget_frac of them, else every
voxel (ops.tsdf.fuse_dense); re-centering is ops.tsdf.shift_volume.

Each re-center records the bounds that held over the frames since the
previous one (frame_to_vrange, Volume.py:1084-1105), and the whole volume
state goes in and out of a resume checkpoint as dense [X, Y, Z] arrays
(state_arrays / load_state_arrays).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from remixfusion_tpu_torch import host_to_device
from remixfusion_tpu_torch.ops import tsdf as tsdf_ops
from remixfusion_tpu_torch.ops.marching_cubes import marching_cubes, \
    vertex_normals
from remixfusion_tpu_torch.utils.spans import span


# tile edges of the dense volume's frustum-tiled fusion, coarsest first
TILE_EDGES = (64, 60, 50, 48, 40, 32, 25)


class MovingVolume:
    def __init__(self, cfg, init_pose: np.ndarray, device):
        self.device = torch.device(device)
        v = cfg["volume"]
        self.voxel_size = float(v["voxel_size"])
        self.trunc_margin = float(v["trunc"])
        self.weight_clamp = float(v["weight_clamp"]) == 1.0
        self.t_threshold = v["t_treshold"]
        self.version = v["version"]
        self.fix = (v["x_config"]["fix"], v["y_config"]["fix"],
                    v["z_config"]["fix"])
        self.lens = (v["x_config"]["len"], v["y_config"]["len"],
                     v["z_config"]["len"])
        self.ranges = (v["x_config"]["range"], v["y_config"]["range"],
                       v["z_config"]["range"])
        self.first_len = v["first_len"]
        self.second_len = v["second_len"]
        self.third_len = v["third_len"]
        self.more_angel_t = v["more_angel_t"]

        # translation anchor of the last re-center (model/traj.py)
        self.kfx = float(init_pose[0, 3])
        self.kfy = float(init_pose[1, 3])
        self.kfz = float(init_pose[2, 3])
        self.first_axis = -1

        self.vol_bnds = self._center_bounds(init_pose)
        if self.version == "more":
            self.vol_bnds = self._more_bounds(init_pose)
            angles, _ = self._axis_angles(init_pose)
            self.first_axis = int(np.argsort([a for a, _ in angles])[0])
        self.vol_bnds = np.asarray(self.vol_bnds, np.float64)
        # brick edge of the brick-major state, 0 for the dense volume
        self.brick = (int(v.get("brick_size", 10))
                      if v.get("brick_fusion", True) else 0)
        self.dims = self._dims_of(self.vol_bnds)
        self.vol_bnds[:, 1] = self.vol_bnds[:, 0] + \
            np.asarray(self.dims) * self.voxel_size
        # bounds history: (first frame, last frame) -> the bounds that held
        # over those frames; start_id is the first frame of the current ones
        self.start_id = 0
        self.frame_to_vrange: dict[tuple[int, int], np.ndarray] = {}
        dev = self.device
        # free-space carve scope: 'frustum' (every in-frustum brick, rotated)
        # or 'seen' (only bricks that ever held a near-surface band)
        self.fs_scope = str(v.get("fs_scope", "frustum"))
        self._fs_phase = 0
        if not self.brick:
            self.state = tsdf_ops.make_volume(self.dims, self.vol_bnds[:, 0],
                                              dev)
            self.tile = 0
            if v.get("tiled_fusion", True):
                self.tile = next((c for c in TILE_EDGES
                                  if all(d % c == 0 for d in self.dims)), 0)
            if self.tile:
                n_tiles = int(np.prod([d // self.tile for d in self.dims]))
                frac = float(v.get("tile_budget_frac", 0.45))
                self.tile_budget = max(1, int(np.ceil(n_tiles * frac)))
            return
        nb = int(np.prod([d // self.brick for d in self.dims]))
        b3 = self.brick ** 3
        self.state = tsdf_ops.VolumeState(
            tsdf=torch.ones((nb, b3), dtype=torch.float32, device=dev),
            weight=torch.zeros((nb, b3), dtype=torch.float32, device=dev),
            color=torch.zeros((nb, b3, 3), dtype=torch.float32, device=dev),
            origin=torch.tensor(self.vol_bnds[:, 0], dtype=torch.float32,
                                device=dev))

        frac = float(v.get("brick_budget_frac", 0.25))
        self.brick_budget = min(((nb + 255) // 256) * 256,
                                max(256, int(math.ceil(nb * frac / 256.0))
                                    * 256))
        self.fs_every = int(v.get("freespace_every", 4))

    def _dims_of(self, bnds) -> tuple:
        """Voxel dims of bounds `bnds`, padded to whole bricks when the
        state is brick-major."""
        b = self.brick or 1
        return tuple(
            int(math.ceil(math.ceil((bnds[i, 1] - bnds[i, 0])
                                    / self.voxel_size) / b)) * b
            for i in range(3))

    # ------------------------------------------------------------- bounds

    def _center_bounds(self, c2w) -> np.ndarray:
        """Camera-centered box, integer-rounded center (Volume.py:1133-1149)."""
        center = np.round(c2w[:3, 3], 0)
        self.kfx, self.kfy, self.kfz = (float(c2w[0, 3]), float(c2w[1, 3]),
                                        float(c2w[2, 3]))
        b = np.zeros((3, 2))
        for i in range(3):
            b[i, 0] = center[i] - self.lens[i]
            b[i, 1] = center[i] + self.lens[i]
        return b

    def _axis_angles(self, c2w):
        """Angle between the camera forward axis and each world axis,
        projected per the 'more' policy (Volume.py:1204-1251)."""
        cam_dir = c2w[:3, :3] @ np.array([0.0, 0.0, 1.0])
        fixed_axis = None
        for i, name in enumerate("xyz"):
            if self.fix[i]:
                fixed_axis = name
        fixed = fixed_axis if fixed_axis is not None else "z"
        out = []
        for axis_vec in (np.array([1.0, 0, 0]), np.array([0, 1.0, 0]),
                         np.array([0, 0, 1.0])):
            if fixed == "x":
                a, b = cam_dir[1:], axis_vec[1:]
            elif fixed == "y":
                a, b = cam_dir[0::2], axis_vec[0::2]
            else:
                a, b = cam_dir[:2], axis_vec[:2]
            cos = a.dot(b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-3)
            ang = float(np.degrees(np.arccos(np.clip(cos, -1, 1))))
            flag = 1
            if ang > 90:
                ang = 180 - ang
                flag = -1
            out.append((ang, flag))
        return out, fixed_axis

    def _more_bounds(self, c2w) -> np.ndarray:
        """Dominant-view-direction anisotropic box (Volume.py:1110-1202);
        pure — check_move commits the anchor when the box is accepted."""
        center = np.round(c2w[:3, 3], 0)
        angles, fixed_axis = self._axis_angles(c2w)
        order = np.argsort([a for a, _ in angles])
        first, second, third = (int(order[0]), int(order[1]), int(order[2]))
        first_flag = angles[first][1]
        b = np.zeros((3, 2))
        f = self.first_len
        fwd = first_flag == 1
        b[first, 0] = center[first] - (math.floor(f / 2) if fwd
                                       else math.ceil(f / 2) + f)
        b[first, 1] = center[first] + (math.ceil(f / 2) + f if fwd
                                       else math.floor(f / 2))
        b[second, 0] = center[second] - self.second_len
        b[second, 1] = center[second] + self.second_len
        b[third, 0] = center[third] - self.third_len
        b[third, 1] = center[third] + self.third_len
        if fixed_axis is not None:
            i = "xyz".index(fixed_axis)
            b[i, 0], b[i, 1] = self.ranges[i]
        return b

    # ----------------------------------------------------------- movement

    def check_move(self, cur_id: int, c2w: np.ndarray) -> bool:
        """Re-center policy for frame cur_id; shifts the device volume when
        thresholds trip (Volume.py:930-1082). Returns True if the volume
        moved, and then records the old bounds for the frames since the
        previous move. Each shift runs under the span
        slice.select.recentre.shift."""
        old_bnds = self.vol_bnds.copy()
        moved = False

        trans = np.array([c2w[0, 3] - self.kfx, c2w[1, 3] - self.kfy,
                          c2w[2, 3] - self.kfz])
        tmp = self.vol_bnds.copy()
        tripped = []
        for i in range(3):
            if abs(trans[i]) > self.t_threshold and not self.fix[i]:
                tmp[i, :] += trans[i]
                tripped.append(i)
        if tripped:
            tmp = np.round(tmp, 0)
            if not np.array_equal(tmp, old_bnds):
                with span("slice.select.recentre.shift"):
                    self._shift_to(tmp)
                moved = True
            # re-anchor only the axes whose bounds moved after rounding: an
            # axis whose move rounded away keeps accumulating drift
            for i in tripped:
                if tmp[i, 0] != old_bnds[i, 0]:
                    if i == 0:
                        self.kfx = float(c2w[0, 3])
                    elif i == 1:
                        self.kfy = float(c2w[1, 3])
                    else:
                        self.kfz = float(c2w[2, 3])

        if self.version == "more":
            angles, _ = self._axis_angles(c2w)
            order = np.argsort([a for a, _ in angles])
            first = int(order[0])
            if first != self.first_axis and angles[first][0] \
                    < self.more_angel_t:
                new_b = np.asarray(self._more_bounds(c2w), np.float64)
                if self._dims_of(new_b) != self.dims:
                    raise ValueError(
                        "'more' re-center changed the volume shape; set "
                        "first_len == second_len for fixed-shape volumes")
                new_b[:, 1] = new_b[:, 0] + \
                    np.asarray(self.dims) * self.voxel_size
                if not np.array_equal(new_b, self.vol_bnds):
                    with span("slice.select.recentre.shift"):
                        self._shift_to(new_b)
                    moved = True
                self.first_axis = first
                self.kfx, self.kfy, self.kfz = (
                    float(c2w[0, 3]), float(c2w[1, 3]), float(c2w[2, 3]))

        if moved:
            self.frame_to_vrange[(self.start_id, cur_id - 1)] = old_bnds
            self.start_id = cur_id
        return moved

    def frameid_to_vrange(self, frame_id: int) -> np.ndarray:
        """Bounds active when frame_id was tracked (Volume.py:1084-1105)."""
        for (s, e), b in self.frame_to_vrange.items():
            if s <= frame_id <= e:
                return b
        return self.vol_bnds

    def _shift_to(self, new_bnds: np.ndarray):
        new_bnds = np.asarray(new_bnds, np.float64)
        new_bnds[:, 1] = new_bnds[:, 0] + np.asarray(self.dims) \
            * self.voxel_size
        off_vox = np.round((new_bnds[:, 0] - self.vol_bnds[:, 0])
                           / self.voxel_size)
        if hasattr(self, "_brick_sel"):
            self._brick_sel.shift_seen(off_vox)
        new_origin = torch.tensor(new_bnds[:, 0], dtype=torch.float32,
                                  device=self.device)
        if not self.brick:
            self.state = tsdf_ops.shift_volume(self.state, new_origin,
                                               self.voxel_size)
        elif np.all(off_vox % self.brick == 0):
            # whole-brick shift straight on the brick-major state
            self.state = tsdf_ops.shift_volume_bm(
                self.state, new_origin, self.voxel_size, self.brick_layout(),
                self.dims)
        else:
            dense = tsdf_ops.shift_volume(self.dense_state(), new_origin,
                                          self.voxel_size)
            self.set_dense_state(dense)
        self.vol_bnds = new_bnds

    def dense_state(self) -> tsdf_ops.VolumeState:
        """The volume as dense [X, Y, Z] tensors (cold paths and tests; the
        state itself when it is dense)."""
        if not self.brick:
            return self.state
        b, dims = self.brick, self.dims
        return tsdf_ops.VolumeState(
            tsdf=tsdf_ops.bm_to_dense(self.state.tsdf, dims, b),
            weight=tsdf_ops.bm_to_dense(self.state.weight, dims, b),
            color=tsdf_ops.bm_to_dense(self.state.color, dims, b),
            origin=self.state.origin)

    def set_dense_state(self, vs: tsdf_ops.VolumeState):
        if not self.brick:
            self.state = tsdf_ops.VolumeState(
                vs.tsdf.contiguous(), vs.weight.contiguous(),
                vs.color.contiguous(), vs.origin)
            return
        b = self.brick
        self.state = tsdf_ops.VolumeState(
            tsdf=tsdf_ops.dense_to_bm(vs.tsdf, b).contiguous(),
            weight=tsdf_ops.dense_to_bm(vs.weight, b).contiguous(),
            color=tsdf_ops.dense_to_bm(vs.color, b).contiguous(),
            origin=vs.origin)

    # ------------------------------------------------------------- export

    def state_arrays(self) -> dict:
        """The volume's part of a resume checkpoint, under the JAX package's
        keys: the state as dense [X, Y, Z] (+ [3] for colour) float32 arrays
        (mv_tsdf, mv_weight, mv_color), the bounds, the translation anchor,
        the 'more' axis, the bounds history (vr_keys [n, 2], vr_vals
        [n, 3, 2]) and the free-space phase."""
        dense = self.dense_state()
        keys = np.asarray(list(self.frame_to_vrange.keys()),
                          np.int64).reshape(-1, 2)
        vals = (np.stack([np.asarray(v, np.float64)
                          for v in self.frame_to_vrange.values()])
                if self.frame_to_vrange else np.zeros((0, 3, 2)))
        return dict(
            mv_tsdf=dense.tsdf.cpu().numpy(),
            mv_weight=dense.weight.cpu().numpy(),
            mv_color=dense.color.cpu().numpy(),
            mv_bnds=np.asarray(self.vol_bnds, np.float64),
            mv_kf=np.asarray([self.kfx, self.kfy, self.kfz], np.float64),
            mv_first_axis=np.asarray(self.first_axis, np.int64),
            mv_start_id=np.asarray(self.start_id, np.int64),
            mv_fs_phase=np.asarray(self._fs_phase, np.int64),
            vr_keys=keys, vr_vals=vals)

    def load_state_arrays(self, data):
        """Inverse of state_arrays (a mapping of numpy arrays); with
        fs_scope 'seen' the carve history is reseeded from the loaded
        volume."""
        dims = tuple(self.dims)
        for key, shape in (("mv_tsdf", dims), ("mv_weight", dims),
                           ("mv_color", dims + (3,))):
            if tuple(data[key].shape) != shape:
                raise ValueError(f"{key} has shape {data[key].shape}, the "
                                 f"volume {shape}")
        self.vol_bnds = np.asarray(data["mv_bnds"], np.float64).copy()
        self.kfx, self.kfy, self.kfz = (float(x) for x in data["mv_kf"])
        self.first_axis = int(data["mv_first_axis"])
        self.start_id = int(data["mv_start_id"])
        self._fs_phase = int(data["mv_fs_phase"])
        self.frame_to_vrange = {
            (int(k[0]), int(k[1])): np.asarray(data["vr_vals"][i])
            for i, k in enumerate(data["vr_keys"])}
        dev = self.device
        self.set_dense_state(tsdf_ops.VolumeState(
            tsdf=torch.from_numpy(data["mv_tsdf"]).to(dev),
            weight=torch.from_numpy(data["mv_weight"]).to(dev),
            color=torch.from_numpy(data["mv_color"]).to(dev),
            origin=torch.tensor(self.vol_bnds[:, 0], dtype=torch.float32,
                                device=dev)))
        self.reseed_seen_from_state()

    def reseed_seen_from_state(self):
        """Rebuild the fs_scope 'seen' carve history from the volume
        (bricks whose min tsdf < 1). Before the selector exists (a fresh
        process) the reseed is held and applied when it is built."""
        if not (self.brick and self.fs_scope == "seen"):
            return
        tmin = self.state.tsdf.min(dim=1).values.cpu().numpy()
        if hasattr(self, "_brick_sel"):
            self._brick_sel.reseed_seen(tmin)
        else:
            self._pending_reseed = tmin

    def get_mesh(self):
        """Local-volume mesh (reference Volume.py:1280-1313: unmasked
        marching at level 0 on the dense view, nearest-voxel colors):
        (world verts, faces, normals, colors uint8)."""
        dense = self.dense_state()
        t = dense.tsdf.cpu().numpy()
        c = dense.color.cpu().numpy()
        verts, faces = marching_cubes(t, 0.0)
        vi = np.clip(np.round(verts).astype(int), 0,
                     np.asarray(self.dims) - 1)
        colors = c[vi[:, 0], vi[:, 1], vi[:, 2]].astype(np.uint8)
        verts_w = verts * self.voxel_size + self.state.origin.cpu().numpy()
        norms = vertex_normals(verts_w, faces)
        return verts_w, faces, norms, colors

    def get_truncated_pc(self, trunc_tsdf: float = 0.5) -> np.ndarray:
        """Near-surface voxels as [N, 7] rows (xyz, sdf, rgb)."""
        return tsdf_ops.extract_truncated_points(
            self.dense_state(), self.voxel_size, self.trunc_margin,
            trunc_tsdf)

    def brick_layout(self):
        """(b, BY, BZ) index spec of the state for ops.tsdf.bm_vox_flat:
        (1, Y, Z) for the dense volume, whose flat index it then is."""
        b = self.brick or 1
        return (b, self.dims[1] // b, self.dims[2] // b)

    # ---------------------------------------------------------- selection

    def _ensure_brick_sel(self, hw, K):
        key = (hw, np.asarray(K, np.float32).tobytes())
        if getattr(self, "_brick_sel_key", None) != key:
            old = getattr(self, "_brick_sel", None)
            self._brick_sel = tsdf_ops.BrickSelector(
                self.dims, self.brick, self.voxel_size, np.asarray(K),
                hw[0], hw[1], fs_scope=self.fs_scope)
            if old is not None:  # keep the carve history across a K change
                self._brick_sel.seen = old.seen
            elif getattr(self, "_pending_reseed", None) is not None:
                # a checkpoint was loaded before the selector existed
                self._brick_sel.reseed_seen(self._pending_reseed)
                self._pending_reseed = None
            self._brick_sel_key = key
        return self._brick_sel

    def frame_bricks_pure(self, origin, c2w_np, depth_np, K, fs_phase,
                          fs_span: int = 1, update_seen: bool = True):
        """Brick selection against an explicit origin/phase snapshot;
        fs_span consecutive free-space phases (a selection reused for
        fs_span frames). Returns (brick coords np int32 [n, 3], near_flat).
        update_seen=False leaves the carve history untouched; the caller
        commits near_flat with apply_seen once the origin snapshot is known
        to hold."""
        sel = self._ensure_brick_sel(depth_np.shape, K)
        bricks, _, n_sel, near_flat = sel.select(
            origin, c2w_np, depth_np, self.trunc_margin, self.brick_budget,
            fs_phase=fs_phase, fs_every=self.fs_every, fs_span=fs_span,
            update_seen=update_seen)
        return bricks[:n_sel], near_flat

    def apply_seen(self, near_flat):
        """Commit a deferred carve-history update (see frame_bricks_pure)."""
        if self.fs_scope == "seen" and hasattr(self, "_brick_sel"):
            self._brick_sel.mark_seen(near_flat)

    def frame_bricks(self, c2w_np, depth_np, K, fs_span: int = 1):
        """Selection for one frame (or fs_span frames) at the current origin
        and free-space phase; advances the phase by fs_span."""
        bricks, _ = self.frame_bricks_pure(
            self.vol_bnds[:, 0], c2w_np, depth_np, K, self._fs_phase,
            fs_span)
        self._fs_phase += fs_span
        return bricks

    def frame_tiles(self, c2w_np, depth_np, K):
        """Dense volume: voxel offsets [n, 3] of the frustum tiles to fuse
        for one frame (frustum_tiles with the far bound max(depth) + trunc
        + 0.1 m and 16 px of image padding, the JAX pipeline's
        _frame_tiles), or None for the full sweep (no tile edge divides
        the dims, or more tiles than tile_budget)."""
        if not self.tile:
            return None
        H, W = depth_np.shape
        offs = tsdf_ops.frustum_tiles(
            self.dims, self.tile, self.vol_bnds[:, 0], self.voxel_size,
            np.asarray(K), c2w_np, H, W,
            max_depth=float(np.max(depth_np)) + self.trunc_margin + 0.1,
            pad_px=16)
        return offs if len(offs) <= self.tile_budget else None

    # ---------------------------------------------------------- integration

    def brick_ids(self, bricks: np.ndarray) -> torch.Tensor:
        """Row ids (device int64) of brick coords [n, 3]."""
        _, BY, BZ = self.brick_layout()
        b = np.asarray(bricks, np.int64)
        return host_to_device((b[:, 0] * BY + b[:, 1]) * BZ + b[:, 2],
                              self.device)

    def fuse(self, ids, depth, rgb255, K, c2w, obs_weight):
        """Fuse one frame (device tensors; rgb255 in 0..255 or None for a
        depth-only update) into the bricks at rows `ids`, in place; on the
        dense volume `ids` are the tile offsets of frame_tiles (None: every
        voxel) and the colour is always fused."""
        if not self.brick:
            tsdf_ops.fuse_dense(
                self.state, depth, rgb255, K, c2w,
                voxel_size=self.voxel_size, trunc_margin=self.trunc_margin,
                weight_clamp=self.weight_clamp, obs_weight=obs_weight,
                tiles=ids, tile=self.tile)
            return
        tsdf_ops.fuse_bricks_bm(
            self.state, ids, depth, rgb255, K, c2w,
            voxel_size=self.voxel_size, trunc_margin=self.trunc_margin,
            layout=self.brick_layout(), weight_clamp=self.weight_clamp,
            obs_weight=obs_weight)

    def integrate_seed(self, rgb01, depth, K, c2w, chunk: int = 2048):
        """First-frame seed: every brick (every voxel of the dense volume)
        fused, as the JAX package's slab-scan full sweep, rgb01 in [0, 1]
        scaled to floor(255 x). Host numpy or device inputs."""
        dev = self.device
        depth_t = torch.as_tensor(np.asarray(depth), dtype=torch.float32,
                                  device=dev)
        if self.brick and self.fs_scope == "seen":
            # the seed's near band joins the carve history so its surface
            # stays erasable by later free-space selections
            sel = self._ensure_brick_sel(tuple(depth_t.shape), np.asarray(K))
            near, _ = sel.near_mask(self.vol_bnds[:, 0], np.asarray(c2w),
                                    np.asarray(depth), self.trunc_margin)
            sel.mark_seen(np.flatnonzero(near))
        rgb255 = torch.floor(torch.as_tensor(
            np.asarray(rgb01), dtype=torch.float32, device=dev) * 255.0)
        K_t = torch.as_tensor(np.asarray(K), dtype=torch.float32, device=dev)
        c2w_t = torch.as_tensor(np.asarray(c2w), dtype=torch.float32,
                                device=dev)
        one = torch.ones((), dtype=torch.float32, device=dev)
        if not self.brick:
            self.fuse(None, depth_t, rgb255, K_t, c2w_t, one)
            return
        nb = self.state.tsdf.shape[0]
        for s in range(0, nb, chunk):
            ids = torch.arange(s, min(s + chunk, nb), device=dev)
            self.fuse(ids, depth_t, rgb255, K_t, c2w_t, one)
