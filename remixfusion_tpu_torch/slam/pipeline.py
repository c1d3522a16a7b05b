"""Online SLAM loop: tracking + local fusion, and the mapping rounds.

Counterpart of remixfusion_tpu.slam.pipeline.RemixFusionTPU (reference
run.py, mp_slam/tracker.py, mp_slam/mapper.py:874-950), on one device:

  - every frame is tracked by ROTracker against the moving local TSDF
    volume and fused into it with the brick fuser; the host re-centers the
    volume and selects the bricks to fuse from poses extrapolated off the
    harvested frontier (RO poses only: mapping never feeds the RO chain),
    one selection serving volume.sel_reuse frames while the origin holds.
    With volume.brick_fusion false the volume is dense and a frame fuses
    the frustum tiles of its extrapolated pose, or every voxel;
  - frame 0 seeds the global keyframe grid and runs mapping.first_iters
    map steps on host-drawn rays (first_frame_mapping);
  - whenever the harvested frontier passes mapping_idx + map_every, a
    mapping round runs at mapping_idx + keyframe_every: the keyframe is
    integrated into the global grid, `iters` map steps train the residual
    field + decoders, `BA_iters` RBA steps refine every keyframe pose, and
    the keyframe's rays join the store. The refined poses are written back
    into the trajectory one round late (the reference's cross-process
    staleness, mapper.py:510-520);
  - finalize drains the rounds, applies the last write-back and composes
    the trajectory (non-keyframes relative to their keyframe): the full
    ATE, all_poses.npy and tracking_result.txt; then the checkpoint when
    mapping.save_ckpt is set, mesh.ply (the residual field's SDF queried
    on the dense grid at mesh.voxel_final on the device, marching
    tetrahedra on the host) and mesh_cull_occlusion.ply (the mesh culled
    with the trajectory and the dataset's depth). The mesh work runs after
    the timed loop and reports its own stage times;
  - mid-run resume (JAX save_state / load_state): with mapping.state_every
    the loop writes <out_dir>/resume.npz every state_every frames, the
    whole state of the loop (poses, counters, scene model, both optimizer
    states, the moving volume with its bounds history, the keyframe ray
    store, the two torch.Generators); load_state restores it into a fresh
    pipeline of the same config and run(resume=True) continues after the
    saved frame;
  - rendering: render_frame renders a full RGB-D frame from the scene
    model (chunks of _RENDER_CHUNK rays through scene_rep.render_rays,
    depth-guided when a target depth is given, the perturbation draws from
    the mapping generator as JAX draws them from its key counter);
    render_img writes the 2x3 render-vs-GT comparison (mesh.render_img, at
    every mesh.vis frame with an ATE line and trajectory plot appended to
    tracking_result.txt); tools/rendering_eval scores a checkpoint's
    renders;
  - the live viewer (viz.live): tools/live_viewer's HTTP page, fed after
    every viz.live_every-th tracked frame from the harvested frontier
    (with a gap-8 render every viz.live_render_every frames), and the
    final trajectory at finalize.

Schedule (single-threaded, same decisions as the JAX pipeline): frame i's
tracked pose is harvested `tracking.harvest_depth` frames later; frame i
fuses the look-ahead brick selection made right after frame i-1's dispatch
from the pose extrapolated off the harvested frontier, or, after a
re-center or before two poses are harvested, a selection made at frame i
itself. Frames reach the device as the sensor-native quantization the JAX
package ships them in (depth to 1 mm, color to 8 bits); the first-frame
seed and first-frame mapping use the float frame, as in JAX. The mapping
round's integrate tiles are selected inline (the JAX package computes the
same selection ahead on a worker thread).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from remixfusion_tpu_torch import host_to_device, resolve_device
from remixfusion_tpu_torch.core.pose import const_speed_np, \
    predict_const_speed
from remixfusion_tpu_torch.datasets import get_dataset
from remixfusion_tpu_torch.datasets.base import update_cam
from remixfusion_tpu_torch.mapping.keyframe import DeviceKeyFrameStore
from remixfusion_tpu_torch.mapping.mapper import Mapper
from remixfusion_tpu_torch.models.encodings import HashGridEncoding
from remixfusion_tpu_torch.models.scene_rep import SceneRepresentation
from remixfusion_tpu_torch.tools.cull_mesh import cull_one_mesh
from remixfusion_tpu_torch.tools.eval_ate import evaluate_ate, \
    pose_evaluation
from remixfusion_tpu_torch.tracking.rotracker import ROTracker, check_modes
from remixfusion_tpu_torch.tracking.volume import MovingVolume
from remixfusion_tpu_torch.utils import plot
from remixfusion_tpu_torch.utils.convert import load_scene_numpy, \
    scene_to_numpy
from remixfusion_tpu_torch.utils.imageio import write_png
from remixfusion_tpu_torch.utils.mesh import extract_mesh
from remixfusion_tpu_torch.utils.meshio import write_ply_mesh
from remixfusion_tpu_torch.utils.spans import span

DEPTH_SCALE = 1000.0  # sensor-native depth quantization (mm)
MAX_DEPTH = 65.535    # u16 ceiling in meters
# rays per render_rays call of render_frame (a short frame is one chunk of
# its own size). On an H100 a 640x480 frame renders in the same time at
# 16,384 to 65,536 rays a chunk, and a 320x240 frame pads least at 16,384
# (scripts/render_profile.py)
_RENDER_CHUNK = 16384

# first-frame pose of the 'Largeindoor' and 'uhumans' sequences (reference
# mapper.py:311-321, ROtracker.py:76-80)
_FIRST_POSE_OVERRIDE = np.array(
    [[0.0, 0.0, 1.0, 0.0],
     [-1.0, 0.0, 0.0, 0.0],
     [0.0, -1.0, 0.0, 0.0],
     [0.0, 0.0, 0.0, 1.0]], np.float32)


# parts of SceneParams in jax.tree_util.tree_flatten order
_PARAM_PARTS = ("hash_table", "decoder", "rba")


def _leaves(tree) -> list:
    """Leaves of a nested dict in tree_flatten order (keys sorted; None
    has none)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _read_npz(path) -> dict:
    """Every array of an .npz file, read into memory."""
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def quantize_depth(depth: np.ndarray) -> np.ndarray:
    """Depth as a u16-mm sensor delivers it, back in float32 meters:
    bitwise what the JAX pipeline's device transport decodes
    (core/frames.py pack_frame -> unpack_frame)."""
    d16 = (np.clip(depth, 0.0, MAX_DEPTH) * DEPTH_SCALE + 0.5).astype(
        np.uint16)
    # the compiled decoder divides by the constant as a multiply by its
    # float32 reciprocal; doing the same keeps the frames bitwise equal
    return d16.astype(np.float32) * np.float32(1.0 / DEPTH_SCALE)


def quantize_rgb(rgb: np.ndarray) -> np.ndarray:
    """RGB in [0, 1] through 8 bits, bitwise as the JAX transport ships
    it (multiply by the float32 reciprocal, like quantize_depth)."""
    rgb8 = (np.clip(rgb, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return rgb8.astype(np.float32) * np.float32(1.0 / 255.0)


def keyframe_capacity(n_frames: int, kf_every: int) -> int:
    """Keyframe slots: n_frames // kf_every + 1 padded to a power of two
    >= 16 (the JAX pipeline's capacity; the RBA network's id input is
    normalized by it)."""
    cap = 16
    while cap < n_frames // kf_every + 1:
        cap *= 2
    return cap


class RemixFusionTorch:
    """The online SLAM loop on one device (CUDA unless device='cpu')."""

    def __init__(self, config, device=None):
        self.config = config
        self.device = resolve_device(device)
        # invalid tracker settings raise before the volume and the frames
        # are built
        check_modes(config)
        vcfg = config["volume"]
        self.update_cam()
        self.dataset = get_dataset(config)
        n_frames = self.dataset.num_frames
        m = config["mapping"]
        self._kf_every = int(m["keyframe_every"])
        self.bound = np.asarray(m["bound"], np.float32)
        self.mc_bound = np.asarray(m["marching_cubes_bound"], np.float32)
        self.num_kf = keyframe_capacity(n_frames, self._kf_every)
        # raw tracker poses (RO), the tracker + BA-refined poses (est) and
        # the keyframe-relative deltas of non-keyframes
        self.RO_c2w_data = np.zeros((n_frames, 4, 4), np.float32)
        self.est_c2w_data = np.zeros((n_frames, 4, 4), np.float32)
        self.est_c2w_data_rel = np.zeros((n_frames, 4, 4), np.float32)
        self.pose_gt = np.stack([np.asarray(p, np.float32)
                                 for p in self.dataset.poses])

        batch0 = self.dataset[0]
        init_pose = self._first_pose(batch0)
        self.RO_c2w_data[0] = init_pose
        self.est_c2w_data[0] = init_pose
        self.mv = MovingVolume(config, init_pose, self.device)
        self.K = self.dataset.K()
        self.K_dev = host_to_device(self.K, self.device)
        self.tracker = ROTracker(
            config, self.dataset.H, self.dataset.W, self.K, self.mv.dims,
            self.mv.voxel_size, self.mv.brick_layout(), self.device)

        # mapping state: scene model, optimizers, keyframe ray store
        self._seed = int(config.get("seed", 42)) & 0xFFFFFFFF
        self._np_rng = np.random.default_rng(self._seed)
        self._gen = torch.Generator(device=self.device).manual_seed(
            self._seed)
        # the tracker's per-pixel along-ray shifts (RO.sample_range != 0)
        # draw from their own stream, so the mapping draws do not move
        self._shift_gen = torch.Generator(device=self.device).manual_seed(
            self._seed + 1)
        self.scene = SceneRepresentation(config, self.bound, self.num_kf,
                                         device=self.device,
                                         generator=self._gen)
        self.mapper = Mapper(config, self.scene)
        self.kfdb = DeviceKeyFrameStore(
            self.num_kf, self.dataset.num_rays_to_save,
            config["cam"]["depth_trunc"], self.device)
        self.bound_dev = host_to_device(self.bound, self.device)
        self.dirs_dev = host_to_device(
            np.asarray(batch0["direction"], np.float32).reshape(-1, 3),
            self.device)
        self.mapping_idx = 0
        self.tracking_idx = 0
        # deferred BA write-back: (poses [num_kf, 4, 4], cur_kf_id, frame)
        self._pending_ba = None
        self._map_frame_cache = None
        self.map_iters_done = 0
        self.ba_iters_done = 0
        self.round_ms = []
        # host time (ms) of each track_frame call (the device work it
        # queues is not waited for)
        self.track_ms = []
        self.state_save_ms = []
        self.first_frame_losses = None
        # stage times and grids of the last final mesh (save_mesh_final)
        self.mesh_info = None

        if self.device.type == "cuda":
            # build + load the kernels now: set-up time, not loop time
            from remixfusion_tpu_torch.ops import build
            if self.tracker.eval_mode == "pallas":
                build.load("brick_eval")
            if isinstance(self.scene.embed_res_fn, HashGridEncoding):
                build.load("hash_enc")
        # the first frame seeds the whole local volume (reference
        # ROtracker.py:132 integrates frame 0 at tracker construction)
        self.mv.integrate_seed(batch0["rgb"], batch0["depth"], self.K,
                               init_pose)

        # tracked frames awaiting their pose readback, oldest first
        self._pending = []
        self._harvest_depth = max(
            1, int(config["tracking"].get("harvest_depth", 2)))
        # device pose chain: RO poses of the last two dispatched frames
        self._dev_pose_prev = None
        self._dev_pose_prev2 = None
        self._dev_fit_prev = None
        # last two HARVESTED (frame_id, pose) pairs for host extrapolation
        self._last_harvested = []
        tcfg = config["tracking"]
        self._const_speed = bool(tcfg["const_speed"])
        self._speed_damp = float(tcfg.get("speed_damp", 1.0))
        self._fit_lo = float(tcfg.get("damp_fit_lo", 0.15))
        self._fit_hi = float(tcfg.get("damp_fit_hi", 0.40))
        # look-ahead brick selection: (frame_id, origin, selection, phase)
        self._lookahead = None
        # brick selection reuse (volume.sel_reuse frames): (frame_id,
        # origin, brick rows) of the last selection made, and the count of
        # frames that fused a reused one
        self._sel_reuse = max(1, int(vcfg.get("sel_reuse", 1)))
        self._sel_cache = None
        self.sel_reused = 0
        # per new brick selection: 1 when the look-ahead one was used, 0
        # when it was made at the frame itself (JAX stats['sel_la_hit'])
        self.sel_la_hit = []
        # keyframe-only color fusion (volume.color_fuse: keyframes | all)
        self._color_fuse = str(vcfg.get("color_fuse", "keyframes"))
        if self._color_fuse not in ("keyframes", "all"):
            raise ValueError(f"volume.color_fuse must be 'keyframes' or "
                             f"'all', got {self._color_fuse!r}")
        # fitness-gated fusion weight (volume.fuse_fit_gate: [lo, hi])
        self._fuse_gate = vcfg.get("fuse_fit_gate")
        self._one = torch.ones((), dtype=torch.float32, device=self.device)
        self._frames = {}
        self.out_dir = os.path.join(config["data"]["output"],
                                    config["data"]["exp_name"])

        # live HTTP viewer (viz.live: 0 off, 1 any free port, else the
        # port); viz.live_every: state and frame publish stride;
        # viz.live_render_every: gap-8 render stride (0: the input frame)
        viz = config.get("viz") or {}
        self.viewer = None
        self._live_every = int(viz.get("live_every", 2))
        self._live_render_every = int(viz.get("live_render_every", 0))
        self._live_clock = None
        live = int(viz.get("live", 0) or 0)
        if live:
            from remixfusion_tpu_torch.tools.live_viewer import LiveViewer
            self.viewer = LiveViewer(port=0 if live == 1 else live)
            print(f"live viewer: http://localhost:{self.viewer.port}/")

    # --------------------------------------------------------------- setup

    def update_cam(self):
        """Intrinsics rescale / crop bookkeeping (datasets.base.update_cam,
        reference run.py:62-84); idempotent."""
        update_cam(self.config["cam"])

    def _first_pose(self, batch) -> np.ndarray:
        """Dataset-specific first-frame pose overrides (the JAX pipeline's
        _first_pose; the names are matched as the configs spell them)."""
        c2w = np.asarray(batch["c2w"], np.float32).copy()
        ds = self.config["dataset"]
        if ds == "Largeindoor":
            return _FIRST_POSE_OVERRIDE.copy()
        if ds == "uhumans":
            c2w[:3, :3] = _FIRST_POSE_OVERRIDE[:3, :3]
        return c2w

    def _get_frame(self, idx: int):
        frame = self._frames.get(idx)
        return frame if frame is not None else self.dataset[idx]

    def _device_frame(self, batch, with_color: bool):
        """Quantized (depth [H, W], rgb*255 floored [H, W, 3] | None) on the
        device, as the fuser consumes them."""
        depth_t = host_to_device(quantize_depth(np.asarray(batch["depth"])),
                                 self.device)
        if not with_color:
            return depth_t, None
        rgb = quantize_rgb(np.asarray(batch["rgb"]))
        return depth_t, torch.floor(host_to_device(rgb, self.device) * 255.0)

    def _map_frame(self, idx: int, batch):
        """Quantized (depth [H, W], rgb [H, W, 3] in [0, 1]) of frame idx on
        the device, as the mapping round consumes them (kept for the
        round's integrate, map and BA steps and the keyframe add)."""
        cache = self._map_frame_cache
        if cache is None or cache[0] != idx:
            cache = (idx, host_to_device(
                quantize_depth(np.asarray(batch["depth"])), self.device),
                host_to_device(quantize_rgb(np.asarray(batch["rgb"])),
                               self.device))
            self._map_frame_cache = cache
        return cache[1], cache[2]

    def _needs_color(self, frame_id: int) -> bool:
        """The dense volume fuses colour on every frame; the brick fuser
        on keyframes only unless volume.color_fuse is 'all'."""
        return (not self.mv.brick or self._color_fuse == "all"
                or frame_id % self._kf_every == 0)

    def _obs_weight(self, res):
        """Frame fusion weight: 1, or with volume.fuse_fit_gate [lo, hi] a
        ramp from 1 (fitness <= lo) down to a 0.05 floor (>= hi)."""
        if not self._fuse_gate:
            return self._one
        lo, hi = float(self._fuse_gate[0]), float(self._fuse_gate[1])
        return torch.clamp((hi - res.origin_value) / (hi - lo), 0.05, 1.0)

    # ----------------------------------------------------------- tracking

    def _harvest(self, keep: int = 0):
        """Read back pending tracked poses (oldest first) until at most
        `keep` remain, and run their host bookkeeping."""
        while len(self._pending) > keep:
            self._harvest_one()

    def _harvest_one(self):
        frame_id, res, init = self._pending.pop(0)
        c2w = res.c2w.cpu().numpy()
        if not np.isfinite(c2w).all():
            # non-finite tracked pose (reference warns, slam.py:243-247):
            # substitute the host extrapolation and reset the device chain
            # so later dispatches do not inherit the poisoned values
            print(f"WARNING: non-finite tracked pose at frame {frame_id}; "
                  f"substituting const-speed extrapolation")
            c2w = self._host_pose_estimate(frame_id).astype(np.float32)
            dev = host_to_device(c2w, self.device)
            self._dev_pose_prev = dev
            self._dev_pose_prev2 = dev
            self._dev_fit_prev = torch.zeros((), dtype=torch.float32,
                                             device=self.device)
        self._last_harvested = (self._last_harvested
                                + [(frame_id, c2w)])[-2:]
        self.RO_c2w_data[frame_id] = c2w
        self.est_c2w_data[frame_id] = c2w
        if frame_id % self._kf_every != 0:
            kf = (frame_id // self._kf_every) * self._kf_every
            self.est_c2w_data_rel[frame_id] = (
                c2w.astype(np.float64)
                @ np.linalg.inv(self.RO_c2w_data[kf].astype(np.float64))
            ).astype(np.float32)
        if self.config.get("print_ape"):
            gt = self.pose_gt[frame_id]
            ape_b = np.abs(gt[:3, 3] - init[:3, 3]).mean()
            ape_a = np.abs(gt[:3, 3] - c2w[:3, 3]).mean()
            tag = "success" if ape_a < ape_b else "fail"
            print(f"final {tag} ape: {ape_b:.6f}->{ape_a:.6f}")
        # local-volume mesh dumps (reference ROtracker.py:941-945)
        ro = self.config["RO"]
        if ro.get("save_volume") and (
                frame_id % ro.get("save_freq", 1000) == 0
                or frame_id == self.dataset.num_frames - 1):
            ro_dir = os.path.join(self.out_dir, "RO")
            os.makedirs(ro_dir, exist_ok=True)
            verts, faces, norms, colors = self.mv.get_mesh()
            write_ply_mesh(os.path.join(ro_dir, f"{frame_id}.ply"), verts,
                           faces, colors=colors, normals=norms)
        self.tracking_idx = frame_id

    def _host_pose_estimate(self, frame_id: int) -> np.ndarray:
        """Pose of frame_id extrapolated from the last two harvested poses
        (const-speed delta per remaining frame); used for the re-center
        thresholds and the margin-padded brick selection. tracking.
        speed_damp damps the translation on every frame, ungated, as the
        JAX pipeline's host extrapolation does (the device predictor keeps
        its fitness gate)."""
        lh = self._last_harvested
        if not lh:
            return self.RO_c2w_data[0].copy()
        if len(lh) < 2 or not self._const_speed:
            return lh[-1][1].copy()
        (_, p2), (i1, p1) = lh[0], lh[1]
        return const_speed_np(p1, p2, steps=max(frame_id - i1, 0),
                              damp=self._speed_damp)

    def _predict_init(self) -> torch.Tensor:
        """Initial pose of the next dispatched frame from the device pose
        chain (no host readback)."""
        if self._dev_pose_prev is None:
            self._dev_pose_prev = host_to_device(self.RO_c2w_data[0],
                                                 self.device)
            self._dev_pose_prev2 = self._dev_pose_prev
            self._dev_fit_prev = torch.zeros((), dtype=torch.float32,
                                             device=self.device)
        return predict_const_speed(
            self._dev_pose_prev, self._dev_pose_prev2, self._dev_fit_prev,
            const_speed=self._const_speed, speed_damp=self._speed_damp,
            fit_lo=self._fit_lo, fit_hi=self._fit_hi)

    def track_frame(self, frame_id: int, batch):
        """Track frame `frame_id` and fuse it into the local volume; its
        pose is harvested harvest_depth frames later (or by _harvest).
        The call's host time goes to self.track_ms."""
        t0 = time.perf_counter()
        # spans name the stages in a torch.profiler trace
        # (tools/profile_slice.py, slambench)
        with span("slice.harvest"):
            self._harvest(keep=self._harvest_depth - 1)
        mv = self.mv
        with span("slice.select"):
            init = self._host_pose_estimate(frame_id)
            with span("slice.select.recentre"):
                mv.check_move(frame_id, init)
            with span("slice.select.bricks"):
                if mv.brick:
                    ids = self._select_bricks(frame_id, batch, init)
                else:
                    ids = mv.frame_tiles(init, np.asarray(batch["depth"]),
                                         self.K)
        with span("slice.upload"):
            fc = self._needs_color(frame_id)
            depth_t, rgb255 = self._device_frame(batch, fc)
        with span("slice.track"):
            res = self.tracker.track(mv.state.tsdf, mv.state.origin,
                                     self._predict_init(), depth_t,
                                     generator=self._shift_gen)
        with span("slice.fuse"):
            mv.fuse(ids, depth_t, rgb255, self.K_dev, res.c2w,
                    self._obs_weight(res))
        self._dev_pose_prev2 = self._dev_pose_prev
        self._dev_pose_prev = res.c2w
        self._dev_fit_prev = res.origin_value
        self._pending.append((frame_id, res, init))

        # look-ahead selection for the next frame from the harvested
        # frontier, unless it reuses this one (discarded if the volume
        # re-centers before it is used)
        nxt = frame_id + 1
        sc = self._sel_cache
        need_sel = (sc is None or nxt - sc[0] >= self._sel_reuse
                    or not np.array_equal(sc[1], mv.vol_bnds[:, 0]))
        if (mv.brick and need_sel and nxt < self.dataset.num_frames
                and len(self._last_harvested) >= 2):
            with span("slice.lookahead"):
                pred = self._host_pose_estimate(nxt)
                origin = mv.vol_bnds[:, 0].copy()
                phase = mv._fs_phase
                sel = mv.frame_bricks_pure(
                    origin, pred, np.asarray(self._get_frame(nxt)["depth"]),
                    self.K, phase, self._sel_reuse, update_seen=False)
                self._lookahead = (nxt, origin, sel, phase)
        self.track_ms.append(1000.0 * (time.perf_counter() - t0))

    def _select_bricks(self, frame_id: int, batch, init) -> torch.Tensor:
        """Brick rows (device int64) that frame_id fuses: the previous
        selection while it is younger than volume.sel_reuse frames and the
        origin has not moved; else the look-ahead selection made for this
        frame at this origin, or a selection made now; a new selection
        takes sel_reuse free-space phases (JAX track_frame)."""
        mv = self.mv
        sc = self._sel_cache
        if (sc is not None and frame_id - sc[0] < self._sel_reuse
                and np.array_equal(sc[1], mv.vol_bnds[:, 0])):
            self.sel_reused += 1
            return sc[2]
        la, self._lookahead = self._lookahead, None
        if (la is not None and la[0] == frame_id
                and np.array_equal(la[1], mv.vol_bnds[:, 0])):
            bricks, near_flat = la[2]
            mv._fs_phase = la[3] + self._sel_reuse
            mv.apply_seen(near_flat)
            self.sel_la_hit.append(1)
        else:
            self.sel_la_hit.append(0)
            with span("slice.select.bricks.inline"):
                bricks = mv.frame_bricks(init, np.asarray(batch["depth"]),
                                         self.K, fs_span=self._sel_reuse)
        ids = mv.brick_ids(bricks)
        self._sel_cache = (frame_id, mv.vol_bnds[:, 0].copy(), ids)
        return ids

    # ------------------------------------------------------------ mapping

    def first_frame_mapping(self):
        """Seed the global grid with frame 0 and run mapping.first_iters
        map steps on rays drawn on the host (reference mapper.py:284-364);
        the draws come from np.random.default_rng(seed), as in the JAX
        pipeline. Returns the losses (numpy [first_iters])."""
        batch = self._get_frame(0)
        c2w = self.RO_c2w_data[0].copy()
        self.est_c2w_data[0] = c2w
        self.est_c2w_data_rel[0] = c2w
        c2w_dev = host_to_device(c2w, self.device)
        self.mapper.reset_global_volume()
        self.mapper.integrate_keyframe(
            host_to_device(np.asarray(batch["depth"], np.float32),
                           self.device),
            host_to_device(np.asarray(batch["rgb"], np.float32),
                           self.device),
            self.K_dev, c2w_dev, self.bound_dev, host_depth=batch["depth"],
            host_c2w=c2w, K_np=self.K)
        self.scene.rba.update_init_pose(0, c2w_dev)

        m = self.config["mapping"]
        n_iters, sample = int(m["first_iters"]), int(m["sample"])
        dirs = np.asarray(batch["direction"]).reshape(-1, 3)
        rgb = np.asarray(batch["rgb"]).reshape(-1, 3)
        depth = np.asarray(batch["depth"]).reshape(-1)
        poses = np.tile(c2w[None], (sample, 1, 1))
        losses = []
        # host batches go up 25 iterations at a time (the JAX pipeline's
        # chunk; the draws are the same whatever the chunk)
        done = 0
        while done < n_iters:
            n = min(25, n_iters - done)
            rays, ro, rd = [], [], []
            for _ in range(n):
                idx = self._np_rng.integers(0, len(depth), sample)
                r = np.concatenate([dirs[idx], rgb[idx], depth[idx, None]],
                                   -1).astype(np.float32)
                o, d = Mapper.rays_to_world_np(r, poses)
                rays.append(r)
                ro.append(o)
                rd.append(d)
            up = lambda a: host_to_device(np.stack(a), self.device)  # noqa
            losses.append(self.mapper.map_step(
                up(rays), up(ro), up(rd), generator=self._gen))
            self.map_iters_done += n
            done += n
        dep_dev, rgb_dev = self._map_frame(0, batch)
        self.kfdb.add_keyframe(0, dep_dev, rgb_dev, self.dirs_dev,
                               filter_depth=m["filter_depth"],
                               generator=self._gen)
        self.first_frame_losses = (torch.cat(losses).cpu().numpy()
                                   if losses else np.zeros(0, np.float32))
        return self.first_frame_losses

    def global_mapping(self, batch, cur_frame_id: int, n_cur=None):
        """`mapping.iters` map steps of a round (reference
        mapper.py:366-423); the keyframes' poses are the current
        trajectory's, the current keyframe's comes from the RBA network.
        n_cur: current-frame rays per batch (None = the round's budget)."""
        m = self.config["mapping"]
        cur_kf_id = cur_frame_id // self._kf_every
        if n_cur is None:
            n_cur = self.mapper.current_ray_budget(len(self.kfdb))
        kf_poses = np.zeros((self.num_kf, 4, 4), np.float32)
        n_valid = cur_kf_id + 1
        kf_poses[:n_valid] = self.est_c2w_data[
            np.arange(n_valid) * self._kf_every]
        dep, rgb = self._map_frame(cur_frame_id, batch)
        losses = self.mapper.map_step_dev(
            self.kfdb, len(self.kfdb), self.dirs_dev, dep, rgb,
            host_to_device(kf_poses, self.device), cur_kf_id,
            int(m["iters"]), n_cur, generator=self._gen)
        self.map_iters_done += int(m["iters"])
        return losses

    def global_pose(self, batch, cur_frame_id: int):
        """`mapping.BA_iters` RBA steps (reference mapper.py:425-520); the
        refined poses are written back at the start of the next round."""
        m = self.config["mapping"]
        if not m["opt_pose"]:
            return None
        cur_kf_id = cur_frame_id // self._kf_every
        n_cur = self.mapper.current_ray_budget(len(self.kfdb))
        dep, rgb = self._map_frame(cur_frame_id, batch)
        losses, poses_all = self.mapper.ba_step_dev(
            self.kfdb, len(self.kfdb), self.dirs_dev, dep, rgb, cur_kf_id,
            int(m["BA_iters"]), n_cur, generator=self._gen)
        self.ba_iters_done += int(m["BA_iters"])
        self._pending_ba = (poses_all, cur_kf_id, cur_frame_id)
        return losses

    def _apply_pending_ba(self, est=None):
        """Write the BA-refined keyframe poses into est_c2w_data (reference
        mapper.py:510-520), one round late; or into the snapshot `est`,
        leaving the write-back pending for the live trajectory."""
        if self._pending_ba is None:
            return
        poses_all, cur_kf_id, cur_frame_id = self._pending_ba
        if est is None:
            self._pending_ba = None
            est = self.est_c2w_data
        poses_all = poses_all.cpu().numpy()
        m = self.config["mapping"]
        if cur_kf_id >= 1:
            est[np.arange(cur_kf_id) * self._kf_every] = \
                poses_all[:cur_kf_id]
            if m["optim_cur"]:
                est[cur_frame_id] = poses_all[cur_kf_id]

    def mapping_round(self, cur_frame_id: int):
        """One mapping round at cur_frame_id (reference
        mapper.py:874-928). Its wall time (host clock, ending in a device
        synchronise) goes to self.round_ms."""
        t0 = time.perf_counter()
        self._apply_pending_ba()
        batch = self._get_frame(cur_frame_id)
        is_kf = cur_frame_id % self._kf_every == 0
        with span("map.integrate"):
            if is_kf:
                cur_kf_id = cur_frame_id // self._kf_every
                c2w = self.est_c2w_data[cur_frame_id].copy()
                c2w_dev = host_to_device(c2w, self.device)
                self.scene.rba.update_init_pose(cur_kf_id, c2w_dev)
                dep, rgb = self._map_frame(cur_frame_id, batch)
                self.mapper.integrate_keyframe(
                    dep, rgb, self.K_dev, c2w_dev, self.bound_dev,
                    host_depth=np.asarray(batch["depth"]), host_c2w=c2w,
                    K_np=self.K, kf_index=cur_kf_id)
        with span("map.map"):
            self.global_mapping(batch, cur_frame_id)
        with span("map.ba"):
            self.global_pose(batch, cur_frame_id)
        self.mapping_idx = cur_frame_id
        with span("map.kfadd"):
            if is_kf:
                dep, rgb = self._map_frame(cur_frame_id, batch)
                self.kfdb.add_keyframe(
                    cur_frame_id, dep, rgb, self.dirs_dev,
                    filter_depth=self.config["mapping"]["filter_depth"],
                    generator=self._gen)
        self._sync()
        self.round_ms.append(1000.0 * (time.perf_counter() - t0))
        self._mesh_snapshots()

    def _mesh_snapshots(self):
        """Snapshots after a round (reference mapper.py:909-928): video.save
        every video.save_freq frames, a mesh at 7.5 cm; every mesh.vis
        frames a mesh at mesh.voxel_eval unless mesh.only_final, the
        render-vs-GT figure when mesh.render_img, and the ATE of the
        trajectory so far appended to tracking_result.txt with its plot."""
        video = self.config.get("video", {})
        if video.get("save") and self.mapping_idx % video.get(
                "save_freq", 20) == 0:
            self.save_mesh(self.mapping_idx, voxel_size=0.075)
        mesh = self.config["mesh"]
        idx = self.mapping_idx
        if not (mesh["vis"] and idx % mesh["vis"] == 0 and idx):
            return
        if not mesh["only_final"]:
            self.save_mesh(idx, voxel_size=mesh["voxel_eval"])
        if mesh.get("render_img"):
            batch = self._get_frame(idx)
            self.render_img(idx, batch["depth"], batch["rgb"],
                            self.est_c2w_data[idx], batch["direction"])
        pose_evaluation(self.pose_gt, self.convert_relative_pose(idx), 1,
                        self.out_dir, idx)

    def _due_rounds(self, n: int):
        """Run the mapping rounds the harvested frontier has unlocked
        (rounds stop at frame n)."""
        map_every = int(self.config["mapping"]["map_every"])
        while self.tracking_idx > self.mapping_idx + map_every:
            cur = self.mapping_idx + self._kf_every
            if cur >= n:
                break
            self.mapping_round(cur)

    def step(self, frame_id: int, n: int):
        """One frame of the online loop: track + fuse frame_id, feed the
        live viewer (viz.live), then the mapping rounds that became due
        (rounds stop at frame n)."""
        batch = self._get_frame(frame_id)
        self.track_frame(frame_id, batch)
        if self.viewer is not None:
            self._publish_live(frame_id, batch)
        self._due_rounds(n)

    def _publish_live(self, idx: int, batch):
        """Feed the live viewer every viz.live_every frames without
        waiting for the device: the poses up to the harvested frontier
        (at most ~400 of them), the input frame at stride 2 or, every
        viz.live_render_every frames, a gap-8 render at the frontier's
        pose. A failure is printed; the run goes on (JAX _publish_live)."""
        if idx % self._live_every:
            return
        try:
            frontier = (self._last_harvested[-1][0]
                        if self._last_harvested else 0)
            step = max(1, (frontier + 1) // 400)
            ids = range(0, frontier + 1, step)
            est = np.stack([self._composed(i)[:3, 3] for i in ids])
            now = time.perf_counter()
            last = self._live_clock
            fps = ((idx - last[0]) / max(now - last[1], 1e-9)
                   if last else 0.0)
            self._live_clock = (idx, now)
            self.viewer.publish_state(
                frame=idx, n=self.dataset.num_frames, fps=fps, est=est,
                gt=self.pose_gt[:frontier + 1:step, :3, 3],
                extra={"mapped_to": self.mapping_idx,
                       "keyframes": self.mapping_idx // self._kf_every + 1})
            if (self._live_render_every
                    and idx % self._live_render_every == 0 and frontier):
                rgb, _ = self.render_frame(self._composed(frontier),
                                           batch["direction"], gap=8)
                self.viewer.publish_frame(rgb)
            else:
                self.viewer.publish_frame(np.asarray(batch["rgb"])[::2, ::2])
        except Exception as e:  # the viewer must never end the run
            print("live viewer publish failed:", e)

    # ---------------------------------------------------------- main loop

    def preload(self, n: int, start: int = 0):
        """Render / load frames [start, n) into memory ahead of a timed run
        (a synthetic scene renders the frames its disk cache lacks on
        threads first)."""
        n = min(n, self.dataset.num_frames)
        if hasattr(self.dataset, "render_missing"):
            self.dataset.render_missing(range(start, n))
        for i in range(start, n):
            if i not in self._frames:
                self._frames[i] = self.dataset[i]

    def _composed(self, i: int) -> np.ndarray:
        """Frame i's pose: a keyframe's as estimated (BA-refined), another
        frame's composed onto its keyframe."""
        if i % self._kf_every == 0:
            return self.est_c2w_data[i]
        kf = (i // self._kf_every) * self._kf_every
        return self.est_c2w_data_rel[i] @ self.est_c2w_data[kf]

    def trajectory(self, n: int) -> np.ndarray:
        """[n, 4, 4] poses of frames [0, n) (reference mapper.py:580-624)."""
        out = np.zeros((n, 4, 4), np.float32)
        for i in range(n):
            out[i] = self._composed(i)
        return out

    def convert_relative_pose(self, idx=None) -> dict:
        """{frame: pose} of frames [0, idx] (default: every frame of the
        dataset) after harvesting the pending tracked poses (JAX
        convert_relative_pose)."""
        self._harvest()
        end = idx + 1 if idx is not None else len(self.est_c2w_data)
        return dict(enumerate(self.trajectory(end)))

    def convert_relative_pose_npy(self, idx=None) -> np.ndarray:
        """convert_relative_pose as [len(dataset), 4, 4], zero past idx."""
        out = np.zeros((len(self.dataset), 4, 4), np.float32)
        for i, p in self.convert_relative_pose(idx).items():
            out[i] = p
        return out

    def run(self, max_frames: int | None = None, warmup: int = 5,
            resume: bool = False):
        """First-frame mapping, then frames 1..n-1 (n = num_frames, or
        max_frames) each tracked and followed by the mapping rounds that
        became due, then finalize. With resume=True (after load_state)
        first-frame mapping is skipped and the loop continues at
        tracking_idx + 1. Frames are preloaded, so the per-frame time (host
        clock, ending in a device synchronise) covers tracking, fusion,
        host selection and the mapping rounds; it is taken over the frames
        after `warmup` (finalize's mesh work and the resume-state saves of
        mapping.state_every, reported as state_save_ms, are outside it; the
        wait for queued device work that a save begins with is inside).
        Writes config.json, ro_poses.npy, all_poses.npy,
        tracking_result.txt, mesh.ply, mesh_cull_occlusion.ply,
        tracking_result.json and, with mapping.state_every, resume.npz to
        the output directory. Returns a stats dict."""
        os.makedirs(self.out_dir, exist_ok=True)
        with open(os.path.join(self.out_dir, "config.json"), "w") as f:
            json.dump(self.config, f, indent=2, default=str)
        n = self.dataset.num_frames
        if max_frames is not None:
            n = max(2, min(n, int(max_frames)))
        start = self.tracking_idx + 1 if resume else 1
        if start >= n:
            raise ValueError(f"nothing to track: the run would continue at "
                             f"frame {start} of {n}")
        self.preload(n + 1, start=self.mapping_idx if resume else 0)
        warmup = min(warmup, (n - start) // 2)
        state_every = int(self.config["mapping"].get("state_every", 0))
        state_path = os.path.join(self.out_dir, "resume.npz")

        first_ms = None
        if not resume:
            t0 = time.perf_counter()
            self.first_frame_mapping()
            self._sync()
            first_ms = 1000.0 * (time.perf_counter() - t0)
        t_start = None
        saves_before = len(self.state_save_ms)
        for idx in range(start, n):
            if idx == start + warmup:
                self._sync()
                t_start = time.perf_counter()
                rounds_before = len(self.round_ms)
                saves_timed = len(self.state_save_ms)
            self.step(idx, n)
            if state_every and idx % state_every == 0:
                self.save_state(state_path)
        self._sync()
        # the state saves fall inside the timed frames; their time is not
        # the loop's
        elapsed = (time.perf_counter() - t_start
                   - sum(self.state_save_ms[saves_timed:]) / 1000.0)
        timed = n - start - warmup
        timed_rounds = len(self.round_ms) - rounds_before
        return self.finalize(n, {
            "frames": n,
            "first_tracked": start,
            "tracked_frames": n - start,
            "timed_frames": timed,
            "ms_per_frame": 1000.0 * elapsed / timed,
            "timed_rounds": timed_rounds,
            "first_frame_mapping_ms": first_ms,
            "state_save_ms": self.state_save_ms[saves_before:],
            "sel_reused": self.sel_reused,
        })

    def finalize(self, n: int, stats: dict) -> dict:
        """Harvest, drain the due mapping rounds, apply the last BA
        write-back, evaluate / write the trajectory of frames [0, n), then
        the checkpoint (mapping.save_ckpt), mesh.ply at mesh.voxel_final and
        the culled mesh (reference mapper.py:930-950). A failure on the mesh
        path raises. The stats gain the mesh stage times (ms: device query,
        host marching, normals + write, culling) and counts."""
        os.makedirs(self.out_dir, exist_ok=True)
        self._harvest()
        self._due_rounds(n)
        self._apply_pending_ba()
        # mapping.final_iters: extra field-only map steps over the keyframe
        # store with the final poses (no current-frame slice: the newest
        # keyframe is in the store already); 0, the default, skips them
        final_iters = int(self.config["mapping"].get("final_iters", 0))
        if final_iters > 0 and self.mapping_idx > 0:
            batch = self._get_frame(self.mapping_idx)
            for _ in range(-(-final_iters
                             // int(self.config["mapping"]["iters"]))):
                self.global_mapping(batch, self.mapping_idx, n_cur=0)
        poses = self.trajectory(n)
        np.save(os.path.join(self.out_dir, "all_poses.npy"), poses)
        np.save(os.path.join(self.out_dir, "ro_poses.npy"),
                self.RO_c2w_data[:n])
        if self.viewer is not None:  # the final trajectory for the page
            try:
                self.viewer.publish_state(
                    frame=n - 1, n=n, est=poses, gt=self.pose_gt[:n],
                    extra={"status": "finished"})
            except Exception as e:  # the viewer must never end the run
                print("live viewer publish failed:", e)
        full = pose_evaluation(self.pose_gt[:n], poses, 1, self.out_dir,
                               n - 1)
        ro = evaluate_ate({float(i): self.pose_gt[i] for i in range(n)},
                          {float(i): self.RO_c2w_data[i] for i in range(n)})
        if self.config["mapping"]["save_ckpt"]:
            self.save_ckpt(os.path.join(self.out_dir, "checkpoint.npz"))
        info = {}
        mesh_path = self.save_mesh_final(
            voxel_size=self.config["mesh"]["voxel_final"], info=info)
        if info["faces"] == 0:
            raise RuntimeError("the final mesh is empty: no masked SDF "
                               "below the isolevel")
        t0 = time.perf_counter()
        cull_path, cull_faces = self.post_process_mesh(mesh_path, poses)
        stats.update({
            "mesh_path": mesh_path, "mesh_cull_path": cull_path,
            "mesh_verts": info["verts"], "mesh_faces": info["faces"],
            "mesh_cull_faces": cull_faces,
            "mesh_query_ms": info["query_ms"],
            "mesh_marching_ms": info["marching_ms"],
            "mesh_write_ms": info["write_ms"],
            "mesh_cull_ms": 1000.0 * (time.perf_counter() - t0),
        })
        ffl = self.first_frame_losses
        stats.update({
            "ate_rmse_cm": full["rmse"] * 100.0,
            "ate_rmse_cm_ro_only": ro["rmse"] * 100.0,
            "mapping_rounds": len(self.round_ms),
            "ms_per_round": (float(np.mean(self.round_ms))
                             if self.round_ms else 0.0),
            "map_iters": self.map_iters_done,
            "ba_iters": self.ba_iters_done,
            "first_frame_loss": ([float(ffl[0]), float(ffl[-1])]
                                 if ffl is not None and len(ffl) else None),
            "device": str(self.device),
        })
        with open(os.path.join(self.out_dir, "tracking_result.json"),
                  "w") as f:
            json.dump(stats, f, indent=2)
        return stats

    # ------------------------------------------------------------ outputs

    def _extract(self, path, voxel_size, explicit_only=False, info=None):
        info = {} if info is None else info
        verts, faces, _ = extract_mesh(
            self.scene, self.config, self.bound, self.mc_bound,
            voxel_size=voxel_size, mesh_savepath=path,
            explicit_only=explicit_only, info=info)
        info.update(verts=len(verts), faces=len(faces))
        return path

    def save_mesh(self, i, voxel_size=0.05):
        return self._extract(
            os.path.join(self.out_dir, f"mesh_track{int(i)}.ply"),
            voxel_size)

    def save_mesh_final(self, voxel_size=0.05, info=None):
        """mesh.ply; `info` (also kept as self.mesh_info) receives the
        stage times, the counts and the queried grids."""
        self.mesh_info = {} if info is None else info
        return self._extract(os.path.join(self.out_dir, "mesh.ply"),
                             voxel_size, info=self.mesh_info)

    def save_mesh_explicit(self, i, voxel_size=0.05):
        return self._extract(
            os.path.join(self.out_dir, f"mesh_track{int(i)}_ex.ply"),
            voxel_size, explicit_only=True)

    def post_process_mesh(self, mesh_path, poses_np, skip: int = 5,
                          eps: float = 0.1):
        """Occlusion-cull the mesh with the poses (every `skip`-th) and the
        dataset's depth maps (reference mapper.py:809-821; the raw mesh is
        kept). Returns (path of mesh_cull_occlusion.ply, kept faces)."""
        c2w_list = [poses_np[i] for i in range(0, len(poses_np), skip)]
        save_path = os.path.join(self.out_dir, "mesh_cull_occlusion.ply")
        with span("mesh.cull"):
            _, kept = cull_one_mesh(self.config, c2w_list, mesh_path,
                                    save_path, skip, self.dataset,
                                    depth_flag=True, remove_occlusion=True,
                                    eps=eps)
        return save_path, len(kept)

    # ---------------------------------------------------------- rendering

    def render_frame(self, c2w, directions, gap: int = 1, target_depth=None):
        """Render an RGB-D frame with the scene model (reference
        slam.py:290-344): the rays of directions[::gap, ::gap] (a ceil(H /
        gap) x ceil(W / gap) image) from the camera centre, depth-guided
        by target_depth[::gap, ::gap] when given, else -1 (the uniform
        samples). Chunks of _RENDER_CHUNK rays (the last padded with rays
        of depth -1) go through render_rays with perturbation draws from
        the mapping generator, so a render moves later mapping draws as a
        JAX render moves its key counter. Returns numpy (rgb [h, w, 3],
        depth [h, w])."""
        sub = np.asarray(directions)[::gap, ::gap]
        h, w = sub.shape[:2]
        dirs = sub.reshape(-1, 3)
        c2w = np.asarray(c2w, np.float32)
        n = len(dirs)
        chunk = min(_RENDER_CHUNK, n)
        n_pad = -(-n // chunk) * chunk
        o = np.zeros((n_pad, 3), np.float32)
        o[:n] = c2w[:3, 3]
        d = np.zeros((n_pad, 3), np.float32)
        d[:, 2] = 1.0
        d[:n] = dirs @ c2w[:3, :3].T
        td = np.full((n_pad, 1), -1.0, np.float32)
        if target_depth is not None:
            td[:n, 0] = np.asarray(target_depth)[::gap, ::gap].reshape(-1)
        o, d, td = (host_to_device(a, self.device) for a in (o, d, td))
        rgbs, depths = [], []
        with torch.no_grad():
            for i in range(0, n_pad, chunk):
                out = self.scene.render_rays(o[i:i + chunk], d[i:i + chunk],
                                             td[i:i + chunk],
                                             generator=self._gen)
                rgbs.append(out["rgb_res_map"])
                depths.append(out["depth_res_map"])
            rgb = torch.cat(rgbs)[:n].reshape(h, w, 3)
            depth = torch.cat(depths)[:n].reshape(h, w)
        return rgb.cpu().numpy(), depth.cpu().numpy()

    def render_img(self, frame_id, gt_depth, gt_rgb, cam_pose, directions,
                   prefix=None, gap=4):
        """The render-vs-GT comparison (reference slam.py:416-528) at
        [::gap, ::gap]: input, rendered and residual depth (plasma, 0 to the
        input's maximum) over input, rendered and residual colour, as
        <out_dir>/<frame_id>[_<prefix>].png. Returns its path."""
        color, depth = self.render_frame(cam_pose, directions, gap=gap)
        panels, vmax = plot.comparison_panels(
            np.asarray(gt_depth)[::gap, ::gap],
            np.asarray(gt_rgb)[::gap, ::gap], color, depth)
        name = f"{frame_id}_{prefix}.png" if prefix else f"{frame_id}.png"
        out = os.path.join(self.out_dir, name)
        os.makedirs(self.out_dir, exist_ok=True)
        write_png(out, plot.comparison_figure(panels, vmax))
        return out

    def update_GBV(self, cur_id):
        """Re-fuse the global grid from the keyframes before cur_id at
        their current (BA-refined) poses, from the dataset's frames
        (reference mapper.py:523-534; not called by the online loop)."""
        self.mapper.reset_global_volume()
        for i in range(0, cur_id, self._kf_every):
            batch = self.dataset[i]
            c2w = self.est_c2w_data[i]
            self.mapper.integrate_keyframe(
                host_to_device(np.asarray(batch["depth"], np.float32),
                               self.device),
                host_to_device(np.asarray(batch["rgb"], np.float32),
                               self.device),
                self.K_dev, host_to_device(c2w, self.device),
                self.bound_dev, host_depth=batch["depth"], host_c2w=c2w,
                K_np=self.K)

    def close(self):
        """Stop the live viewer and release its port; safe to call more
        than once."""
        if self.viewer is not None:
            self.viewer.stop()
            self.viewer = None

    def _model_state_dict(self):
        """The model fields of the checkpoint, under the JAX package's
        names: gbv, gbw, the RBA buffers and param_<i> in the order of
        jax.tree_util.tree_flatten(SceneParams) (hash_table, decoder, rba;
        dict keys sorted)."""
        params, buffers = scene_to_numpy(self.scene)
        flat = [x for part in _PARAM_PARTS for x in _leaves(params[part])]
        rba = buffers["rba"]
        return dict(gbv=buffers["gbv"], gbw=buffers["gbw"],
                    rba_init_c2w=rba["init_c2w"], rba_init_r=rba["init_r"],
                    rba_init_t=rba["init_t"],
                    **{f"param_{i}": p for i, p in enumerate(flat)})

    def _restore_model_state(self, data):
        """Inverse of _model_state_dict: the scene model's parameters and
        buffers from a checkpoint's arrays, copied in place (the
        optimizers keep their parameters), and the bf16 query mirror
        rounded from the loaded grid, as JAX's _restore_model_state packs
        it (the files hold no mirror)."""
        template, _ = scene_to_numpy(self.scene)
        n = sum(len(_leaves(template[part])) for part in _PARAM_PARTS)
        if f"param_{n - 1}" not in data or f"param_{n}" in data:
            raise ValueError(f"the checkpoint's param_<i> do not fit the "
                             f"scene model's {n} parameter arrays")
        it = iter(data[f"param_{i}"] for i in range(n))

        def fill(tree):
            if tree is None:
                return None
            if isinstance(tree, dict):
                return {k: fill(tree[k]) for k in sorted(tree)}
            return next(it)

        params = {part: fill(template[part]) for part in _PARAM_PARTS}
        buffers = {"gbv": data["gbv"], "gbw": data["gbw"],
                   "rba": {k: data[f"rba_{k}"]
                           for k in ("init_c2w", "init_r", "init_t")}}
        load_scene_numpy(self.scene, params, buffers)
        self.scene.refresh_gbq()

    def save_ckpt(self, path):
        """Model + pose checkpoint (reference mapper.py:257-265), with the
        JAX package's keys."""
        np.savez(path, pose=self.est_c2w_data, pose_rel=self.est_c2w_data_rel,
                 **self._model_state_dict())
        print(f"Saved checkpoint to {path}")

    def load_ckpt(self, path):
        """Poses and scene model of a save_ckpt checkpoint."""
        data = _read_npz(path)
        self.est_c2w_data = data["pose"].copy()
        self.est_c2w_data_rel = data["pose_rel"].copy()
        self._restore_model_state(data)

    def state_arrays(self) -> dict:
        """The whole state of the loop as numpy arrays, under the keys of
        the JAX save_state (pose, pose_rel, ro_pose, tracking_idx,
        mapping_idx, the model fields, mv_*, vr_*, kf_rays, kf_frame_ids),
        the moving volume dense; the optimizers in torch's state_dict
        layout (<opt>_state_<i>_<key>, <opt>_param_groups) and the states
        of the mapping and ray-shift generators (gen_state,
        shift_gen_state) in place of the JAX package's optimizer leaves
        and key_counter. A pending BA write-back is folded into `pose`
        only: the live trajectory keeps its one-round-late staleness."""
        est = self.est_c2w_data.copy()
        self._apply_pending_ba(est=est)
        return dict(
            pose=est, pose_rel=self.est_c2w_data_rel.copy(),
            ro_pose=self.RO_c2w_data.copy(),
            tracking_idx=np.asarray(self.tracking_idx, np.int64),
            mapping_idx=np.asarray(self.mapping_idx, np.int64),
            **self._model_state_dict(), **self.mv.state_arrays(),
            **self.kfdb.state_arrays(), **self.mapper.opt_state_arrays(),
            gen_state=self._gen.get_state().numpy(),
            shift_gen_state=self._shift_gen.get_state().numpy())

    def save_state(self, path) -> float:
        """Write the mid-run resume checkpoint (JAX save_state): the
        pose-harvest queue is drained first, then state_arrays goes to a
        temporary file, compressed, and replaces `path` only once complete,
        so a failed save leaves the previous checkpoint intact. Returns the
        save's wall time in ms (also appended to state_save_ms): its clock
        starts after the drain and a device synchronise, so the wait for
        the device work already queued stays in run()'s ms/frame."""
        self._harvest()
        self._sync()
        t0 = time.perf_counter()
        arrays = self.state_arrays()
        tmp = f"{path}.tmp"
        try:
            with open(tmp, "wb") as f:
                np.savez_compressed(f, **arrays)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise
        ms = 1000.0 * (time.perf_counter() - t0)
        self.state_save_ms.append(ms)
        print(f"Saved resume state to {path} (frame {self.tracking_idx}, "
              f"{ms:.1f} ms)")
        return ms

    def load_state(self, path):
        """Restore a save_state checkpoint (JAX load_state) into this
        pipeline, built from the same config; run(resume=True) then
        continues after frame tracking_idx. Raises ValueError when the
        checkpoint was saved for a sequence of another length. The device
        pose chain and the harvested frontier are rebuilt from the raw RO
        poses (the live chain never holds BA-refined ones) with the
        fitness at 0; the pending track results, the pending BA write-back
        and the look-ahead caches are dropped; the host generator is
        reseeded from the resume point."""
        data = _read_npz(path)
        n_ckpt, n_ds = data["pose"].shape[0], self.dataset.num_frames
        if n_ckpt != n_ds:
            raise ValueError(
                f"resume checkpoint was saved for a {n_ckpt}-frame sequence "
                f"but the dataset has {n_ds} frames: resume with the same "
                f"config the saving run used")
        self.est_c2w_data = data["pose"].copy()
        self.est_c2w_data_rel = data["pose_rel"].copy()
        self.RO_c2w_data = data["ro_pose"].copy()
        self.tracking_idx = int(data["tracking_idx"])
        self.mapping_idx = int(data["mapping_idx"])
        self._np_rng = np.random.default_rng(
            (self._seed + 0x9E3779B9 * self.tracking_idx) & 0xFFFFFFFF)
        self._restore_model_state(data)
        self.mapper.load_opt_state_arrays(data)
        self.mv.load_state_arrays(data)
        self.kfdb.load_state_arrays(data)
        self._gen.set_state(torch.from_numpy(data["gen_state"].copy()))
        self._shift_gen.set_state(
            torch.from_numpy(data["shift_gen_state"].copy()))

        i = self.tracking_idx
        self._dev_pose_prev = host_to_device(self.RO_c2w_data[i],
                                             self.device)
        self._dev_pose_prev2 = host_to_device(
            self.RO_c2w_data[max(i - 1, 0)], self.device)
        self._dev_fit_prev = torch.zeros((), dtype=torch.float32,
                                         device=self.device)
        self._last_harvested = [(j, self.RO_c2w_data[j].copy())
                                for j in range(max(i - 1, 0), i + 1)]
        self._pending = []
        self._pending_ba = None
        self._lookahead = None
        self._sel_cache = None
        self._map_frame_cache = None
        print(f"Loaded resume state from {path} (continuing after frame "
              f"{self.tracking_idx})")

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
