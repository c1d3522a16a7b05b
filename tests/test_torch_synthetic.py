"""The port's synthetic variants against the JAX package: the sensor-noise
model (utils/noise.py), the dataset noise hook, and the multi-room corridor
building (SyntheticLargeDataset) at the production layout of
configs/Synthetic/synthetic_corridor.yaml. Everything here is numpy on
both sides with the same operation order, so the comparisons are bitwise;
renders go through the same exact ray tracer and are compared bitwise at a
reduced camera. The last tests mirror tests/test_round4.py's invariants of
the large scene on the port's dataset."""

import copy
import os

import numpy as np
import pytest

from helpers import tiny_config
from remixfusion_tpu.datasets.factory import get_dataset as jax_get_dataset
from remixfusion_tpu.utils import noise as jax_noise
from remixfusion_tpu_torch.config import load_config
from remixfusion_tpu_torch.datasets import get_dataset
from remixfusion_tpu_torch.datasets.synthetic import _look_at
from remixfusion_tpu_torch.utils import noise

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORRIDOR = os.path.join(ROOT, "configs", "Synthetic",
                        "synthetic_corridor.yaml")


def _depth_rgb(seed, H=60, W=80):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.4, 7.5, (H, W)).astype(np.float32)
    depth[:, W // 2:] += 1.5                    # a discontinuity
    depth[rng.random((H, W)) < 0.05] = 0.0      # already invalid
    rgb = rng.random((H, W, 3)).astype(np.float32)
    return depth, rgb


@pytest.mark.parametrize("kwargs", [
    {}, {"sigma0": 0.002, "edge_dropout": 0.5, "hole_rate": 0.01,
         "rgb_sigma": 0.03, "disparity_step": 1e-4}])
def test_add_sensor_noise_bitwise(kwargs):
    depth, rgb = _depth_rgb(1)
    d_t, c_t = noise.add_sensor_noise(depth, rgb,
                                      np.random.default_rng(7), **kwargs)
    d_j, c_j = jax_noise.add_sensor_noise(depth, rgb,
                                          np.random.default_rng(7), **kwargs)
    assert d_t.dtype == d_j.dtype and c_t.dtype == c_j.dtype
    assert np.array_equal(d_t, d_j) and np.array_equal(c_t, c_j)
    assert (d_t[depth == 0] == 0).all()
    assert not np.array_equal(d_t, depth)


def test_add_noise_bitwise():
    pose = _look_at((1.0, 1.5, 2.0), (3.0, 1.2, 4.0))
    for seed, (rn, tn) in enumerate(((0.1, 0.05), (0.02, 0.3))):
        got = noise.add_noise(pose, rn, tn, np.random.default_rng(seed))
        ref = jax_noise.add_noise(pose, rn, tn, np.random.default_rng(seed))
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
        assert np.allclose(got[:3, :3] @ got[:3, :3].T, np.eye(3),
                           atol=1e-6)


@pytest.mark.parametrize("sn", [1, {"sigma_z2": 0.003, "hole_rate": 0.01}])
def test_noisy_synthetic_frame_matches_jax(sn):
    cfg = tiny_config(data={"synthetic": {"sensor_noise": sn}})
    ds_t, ds_j = get_dataset(copy.deepcopy(cfg)), \
        jax_get_dataset(copy.deepcopy(cfg))
    assert ds_t.sensor_noise == ds_j.sensor_noise
    clean = get_dataset(tiny_config())
    for i in (1, 5):
        ft, fj = ds_t[i], ds_j[i]
        assert np.array_equal(ft["depth"], fj["depth"])
        assert np.array_equal(ft["rgb"], fj["rgb"])
        assert not np.array_equal(ft["depth"], clean[i]["depth"])
    # frame-seeded: reading again gives the same noise
    ds_t._cache.clear()
    assert np.array_equal(ds_t[1]["depth"], ds_j[1]["depth"])


def _corridor(n_frames=800, H=None, **syn):
    cfg = load_config(CORRIDOR)
    cfg["data"]["synthetic"].update(n_frames=n_frames, **syn)
    if H is not None:
        # a reduced camera of the same field of view
        s = H / cfg["cam"]["H"]
        cfg["cam"].update(H=H, W=int(cfg["cam"]["W"] * s),
                          fx=cfg["cam"]["fx"] * s, fy=cfg["cam"]["fy"] * s,
                          cx=cfg["cam"]["cx"] * s, cy=cfg["cam"]["cy"] * s)
    return cfg


@pytest.fixture(scope="module")
def corridor():
    cfg = _corridor(H=60)
    return get_dataset(copy.deepcopy(cfg)), \
        jax_get_dataset(copy.deepcopy(cfg))


def _same_boxes(a, b):
    return len(a) == len(b) and all(
        np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
        for x, y in zip(a, b))


def test_large_scene_layout_and_poses_bitwise(corridor):
    """The production layout (22 x 3 x 10 m, 800 frames): the boxes,
    spheres, room dims, doors and path length are equal, every pose is
    bitwise the JAX one."""
    ds_t, ds_j = corridor
    assert type(ds_t).__name__ == "SyntheticLargeDataset"
    assert len(ds_t) == len(ds_j) == 800
    assert ds_t.room_dims == ds_j.room_dims
    assert ds_t._door_x == ds_j._door_x
    assert ds_t._room_x0 == ds_j._room_x0
    assert ds_t.path_len == ds_j.path_len
    assert _same_boxes(ds_t.boxes, ds_j.boxes) and len(ds_t.boxes) > 40
    assert _same_boxes(ds_t.spheres, ds_j.spheres)
    assert ds_t.sensor_noise is None and ds_j.sensor_noise is None
    assert ds_t._cache_key_parts() == ds_j._cache_key_parts()
    for p_t, p_j in zip(ds_t.poses, ds_j.poses):
        assert p_t.dtype == p_j.dtype and np.array_equal(p_t, p_j)


def test_large_scene_turn_rate_cap_poses_bitwise():
    cfg = _corridor(turn_rate_cap=1.2)
    ds_t, ds_j = get_dataset(copy.deepcopy(cfg)), \
        jax_get_dataset(copy.deepcopy(cfg))
    assert ds_t._cache_key_parts() == ds_j._cache_key_parts()
    assert ds_t._cache_key_parts()[-1] == 1.2
    assert all(np.array_equal(a, b) for a, b in zip(ds_t.poses, ds_j.poses))
    # the cap moves the walk (slower in turns)
    plain = get_dataset(_corridor())
    assert not all(np.array_equal(a, b)
                   for a, b in zip(ds_t.poses, plain.poses))


def test_large_scene_gt_sdf_bitwise(corridor):
    ds_t, ds_j = corridor
    rng = np.random.default_rng(11)
    pts = rng.uniform(-0.2, 1.0, (4096, 3)) * np.asarray(ds_t.room_dims)
    got, ref = ds_t.gt_sdf(pts), ds_j.gt_sdf(pts)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert (got < 0).any() and (got > 0.5).any()


@pytest.mark.parametrize("frame", [40, 333])
def test_large_scene_render_bitwise(corridor, frame):
    """Two frames of the walk through both ray tracers (not the shared disk
    cache) at a 60 x 80 camera of the config's field of view."""
    ds_t, ds_j = corridor
    rgb_t, d_t = ds_t.render(ds_t.poses[frame])
    rgb_j, d_j = ds_j.render(ds_j.poses[frame])
    assert d_t.shape == (60, 80)
    assert np.array_equal(d_t, d_j) and np.array_equal(rgb_t, rgb_j)
    assert (d_t > 0).mean() > 0.5


def test_large_scene_render_bitwise_along_the_walk():
    """Every 100th frame of the walk through both ray tracers at a 120 x 160
    camera (several blocks of the box culling and two chunks of rays a
    frame): the port's renderer skips only boxes a block cannot hit."""
    cfg = _corridor(H=120)
    ds_t, ds_j = get_dataset(copy.deepcopy(cfg)), \
        jax_get_dataset(copy.deepcopy(cfg))
    for frame in range(0, 800, 100):
        rgb_t, d_t = ds_t.render(ds_t.poses[frame])
        rgb_j, d_j = ds_j.render(ds_j.poses[frame])
        assert np.array_equal(d_t, d_j), frame
        assert np.array_equal(rgb_t, rgb_j), frame


def test_box_slopes_hold_every_ray_that_hits_the_box():
    """_box_slopes bounds the camera-frame slopes of every pixel ray that
    the renderer's slab test finds entering a box in front of the camera,
    for boxes in front of, behind and through the camera plane; and it
    does exclude rays, so a block of rays skips boxes."""
    from remixfusion_tpu_torch.core.rays import get_camera_rays
    from remixfusion_tpu_torch.datasets.synthetic import (_SLOPE_PAD,
                                                          _box_slopes)

    rng = np.random.default_rng(3)
    dirs = get_camera_rays(48, 64, 30.0, 30.0, 31.5, 23.5).reshape(-1, 3)
    slopes = dirs[:, :2].astype(np.float64) / dirs[:, 2:]
    hits = missed = 0
    for _ in range(20):
        eye = rng.uniform(-1.0, 1.0, 3)
        c2w = _look_at(eye, eye + rng.uniform(-1.0, 1.0, 3))
        lo = rng.uniform(-3.0, 3.0, (16, 3))
        hi = lo + rng.uniform(0.05, 2.0, (16, 3))
        box_s = _box_slopes(lo, hi, c2w)
        d = (dirs @ c2w[:3, :3].T).astype(np.float64)  # as render() does
        inv = np.where(d != 0, 1.0 / d, 1e30)
        o = c2w[:3, 3]
        a = (lo - o)[None] * inv[:, None]
        b = (hi - o)[None] * inv[:, None]
        tmin = np.minimum(a, b).max(-1)
        tmax = np.maximum(a, b).min(-1)
        hit = (tmax > tmin) & (tmin > 1e-6)
        held = ((slopes[:, None, 0] >= box_s[None, :, 0] - _SLOPE_PAD)
                & (slopes[:, None, 0] <= box_s[None, :, 1] + _SLOPE_PAD)
                & (slopes[:, None, 1] >= box_s[None, :, 2] - _SLOPE_PAD)
                & (slopes[:, None, 1] <= box_s[None, :, 3] + _SLOPE_PAD))
        assert (held | ~hit).all()
        hits += int(hit.sum())
        missed += int((~held).sum())
    assert hits > 1000 and missed > 1000


def test_large_scene_gt_mesh_bitwise():
    """The ground-truth mesh of the small building at 8 cm (227 k SDF
    points, four chunks on threads) bitwise the JAX package's."""
    cfg = _large_cfg()
    pv, pf = get_dataset(copy.deepcopy(cfg)).gt_mesh(voxel_size=0.08)
    jv, jf = jax_get_dataset(copy.deepcopy(cfg)).gt_mesh(voxel_size=0.08)
    assert len(pf) > 0
    assert np.array_equal(pv, jv) and np.array_equal(pf, jf)


# ------------------------------------------- the round-4 invariants


def _large_cfg(**syn):
    base = {"n_frames": 120, "n_rooms": 2, "room_width": 3.4,
            "room_depth": 3.2, "corridor_width": 2.0,
            "n_boxes_per_room": 4, "n_spheres_per_room": 2}
    base.update(syn)
    return tiny_config(
        dataset="synthetic_large",
        data={"synthetic": base},
        mapping={"bound": [[0.0, 7.0], [0.0, 3.0], [0.0, 5.4]],
                 "marching_cubes_bound": [[0.0, 7.0], [0.0, 3.0],
                                          [0.0, 5.4]]})


def test_large_scene_geometry_and_trajectory():
    """test_round4's production-layout invariants: extent from the layout,
    a tens-of-meters return pass clear of every surface, smooth motion and
    a map several times the moving volume."""
    ds = get_dataset(tiny_config(
        dataset="synthetic_large",
        data={"synthetic": {"n_frames": 800}},
        mapping={"bound": [[0.0, 22.0], [0.0, 3.0], [0.0, 10.0]],
                 "marching_cubes_bound": [[0.0, 22.0], [0.0, 3.0],
                                          [0.0, 10.0]]}))
    Lx, Ly, Lz = ds.room_dims
    assert abs(Lx - (3 * 7.2 + 2 * 0.2)) < 1e-9
    assert abs(Lz - (2.8 + 0.2 + 7.0)) < 1e-9
    eyes = np.stack([p[:3, 3] for p in ds.poses])
    assert ds.path_len > 20.0
    assert eyes[:, 0].max() - eyes[:, 0].min() > 0.5 * Lx
    assert np.abs(eyes[-1] - eyes[0])[0] < 1.0
    assert ds.gt_sdf(eyes).min() > 0.3
    dt = np.linalg.norm(np.diff(eyes, axis=0), axis=1)
    assert np.abs(np.diff(dt)).max() < 0.02
    R = np.stack([p[:3, :3] for p in ds.poses])
    dR = np.einsum("nij,nkj->nik", R[1:], R[:-1])
    ang = np.degrees(np.arccos(np.clip(
        (np.trace(dR, axis1=1, axis2=2) - 1) / 2, -1, 1)))
    assert ang.max() < 8.0
    assert np.abs(np.diff(ang)).max() < 1.5
    assert (np.abs(np.linalg.det(R) - 1.0) < 1e-5).all()
    assert Lx > 1.5 * 12.0


def test_large_scene_doors_are_open_and_walls_solid():
    ds = get_dataset(_large_cfg())
    cw, w = ds.corridor_w, ds.wall
    d0 = ds._door_x[0]
    eye_y = ds.height - ds.eye_h
    eye = np.array([d0, eye_y, cw + w + 2.0])
    rgb, depth = ds.render(_look_at(eye, np.array([d0, eye_y, 0.0])))
    H, W = depth.shape
    assert depth[H // 2, W // 2] > 2.0 + 0.5
    side = depth[H // 2, W // 8]
    assert side == 0.0 or side < 2.0 + w + 1.0
    door_pt = np.array([[d0, eye_y, cw + w / 2]])
    wall_pt = np.array([[d0 + ds.door_w / 2 + 0.4, eye_y, cw + w / 2]])
    assert ds.gt_sdf(door_pt)[0] > 0.3
    assert ds.gt_sdf(wall_pt)[0] < 0.0


def test_large_scene_rooms_have_distinct_clutter():
    ds = get_dataset(_large_cfg())
    cw, w = ds.corridor_w, ds.wall
    counts = []
    for i in range(ds.n_rooms):
        x0 = ds._room_x0[i]
        n = sum(1 for lo, hi in ds.boxes
                if lo[2] > cw + w - 1e-6 and x0 - 1e-6 <= lo[0]
                and hi[0] <= x0 + ds.room_w + 1e-6
                and (hi - lo).max() < 2.0)
        n += sum(1 for c, _ in ds.spheres
                 if x0 <= c[0] <= x0 + ds.room_w and c[2] > cw + w)
        counts.append(n)
    assert min(counts) >= 2


def test_large_scene_render_depth_matches_sdf():
    """Along random rays of a frame read through the dataset, the SDF at
    the hit point is ~0 and positive halfway to it."""
    ds = get_dataset(_large_cfg())
    f = ds[30]
    depth, c2w, dirs = f["depth"], f["c2w"], f["direction"]
    H, W = depth.shape
    rng = np.random.default_rng(1)
    ii, jj = rng.integers(0, H, 200), rng.integers(0, W, 200)
    d = depth[ii, jj]
    ok = d > 0
    ii, jj, d = ii[ok], jj[ok], d[ok]
    rays_w = dirs[ii, jj] @ c2w[:3, :3].T
    t = d / (rays_w @ c2w[:3, 2])
    hit = c2w[:3, 3][None, :] + t[:, None] * rays_w
    assert np.abs(ds.gt_sdf(hit)).max() < 5e-3
    mid = c2w[:3, 3][None, :] + (0.5 * t)[:, None] * rays_w
    assert ds.gt_sdf(mid).min() > -1e-6


def test_render_missing_fills_the_cache_in_parallel(tmp_path, monkeypatch):
    """render_missing renders in worker processes (forced here: a batch
    this small renders in-process) into the disk cache the frames it
    lacks; __getitem__ then serves them bitwise as a cold render does."""
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    monkeypatch.setattr(
        "remixfusion_tpu_torch.datasets.synthetic._WORKER_RAYS", 0)
    monkeypatch.setattr(
        "remixfusion_tpu_torch.datasets.synthetic._RENDER_WORKERS", 2)
    cfg = _large_cfg(n_frames=40)
    cfg["cam"].update(H=24, W=32, fx=20.0, fy=20.0, cx=15.5, cy=11.5)
    ds = get_dataset(copy.deepcopy(cfg))
    assert ds.render_missing(range(4)) == 4
    assert ds.render_missing(range(5)) == 1
    cold = get_dataset(copy.deepcopy(cfg))
    for i in range(5):
        rgb, depth = cold.render(cold.poses[i])
        f = ds[i]
        assert np.array_equal(f["depth"], depth)
        assert np.array_equal(
            f["rgb"], (rgb * 255).astype(np.uint8).astype(np.float32) / 255.0)
    assert not [p for p in os.listdir(os.path.dirname(
        ds._disk_cache_path(0))) if p.endswith(".tmp")]
