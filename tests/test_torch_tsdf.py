"""Port parity: remixfusion_tpu_torch.ops.tsdf / tracking.volume against the
JAX package's brick-major fuser, shifts and host brick selection, on the
same numpy inputs (CPU, plain PyTorch).

Tolerances: the fuser runs the same float32 operations, but the compiled
JAX fuser contracts some multiply-adds that the port rounds separately, so
tsdf may differ in the last bits (<= 1e-5 after the truncation division);
the update mask and weights must match exactly, and colors may move by one
8-bit step where a rounded running mean sits on a .5 tie. Integer and
selection logic (shifts, brick sets) must match exactly."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_config
from remixfusion_tpu.datasets import get_dataset as jax_dataset
from remixfusion_tpu.ops import tsdf as jt
from remixfusion_tpu.tracking.volume import MovingVolume as JaxVolume
from remixfusion_tpu_torch.ops import tsdf as pt
from remixfusion_tpu_torch.tracking.volume import MovingVolume

torch.set_num_threads(1)


def _random_volume(rng, nb, b3):
    return (rng.uniform(-1, 1, (nb, b3)).astype(np.float32),
            rng.integers(0, 6, (nb, b3)).astype(np.float32),
            rng.integers(0, 256, (nb, b3, 3)).astype(np.float32))


@pytest.mark.parametrize("fuse_color", [True, False])
def test_brick_fuser_matches_jax(fuse_color):
    rng = np.random.default_rng(1)
    dims, b = (80, 60, 80), 10
    layout = (b, dims[1] // b, dims[2] // b)
    nb = (dims[0] // b) * layout[1] * layout[2]
    H, W = 24, 32
    K = np.array([[30.0, 0, 15.5], [0, 30.0, 11.5], [0, 0, 1]], np.float32)
    from scipy.spatial.transform import Rotation
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = Rotation.from_euler("xyz", [7.0, -11.0, 4.0],
                                      degrees=True).as_matrix()
    c2w[:3, 3] = [0.93, 0.71, -0.37]
    depth = rng.uniform(0.4, 2.2, (H, W)).astype(np.float32)
    depth[rng.random((H, W)) < 0.1] = 0.0
    rgb = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    vox, trunc = 0.05, 0.12
    origin = np.array([0.0, -0.5, 0.0], np.float32)
    t0, w0, c0 = _random_volume(rng, nb, b ** 3)

    sel = jt.BrickSelector(dims, b, vox, K, H, W)
    bricks, n_near, n_sel, _ = sel.select(origin, c2w, depth, trunc, nb,
                                          fs_every=1)
    assert 0 < n_near < n_sel
    fuser = jt.make_brick_fuser_bm(
        dims, b, nb, voxel_size=vox, trunc_margin=trunc, im_h=H, im_w=W,
        weight_clamp=True, scale_rgb=True, fuse_color=fuse_color)
    args = (jnp.asarray(bricks), jnp.asarray(depth))
    tail = (jnp.asarray(K), jnp.asarray(c2w), jnp.asarray(origin),
            jnp.asarray(1.0, jnp.float32))
    if fuse_color:
        ref = fuser(jnp.asarray(t0), jnp.asarray(w0), jnp.asarray(c0),
                    *args, jnp.asarray(rgb), *tail)
    else:
        ref = fuser(jnp.asarray(t0), jnp.asarray(w0), *args, *tail)
    ref = [np.asarray(a) for a in ref]

    state = pt.VolumeState(torch.tensor(t0), torch.tensor(w0),
                           torch.tensor(c0), torch.tensor(origin))
    ids = torch.from_numpy(((bricks[:n_sel, 0].astype(np.int64) * layout[1]
                             + bricks[:n_sel, 1]) * layout[2]
                            + bricks[:n_sel, 2]))
    rgb255 = torch.floor(torch.tensor(rgb) * 255.0) if fuse_color else None
    pt.fuse_bricks_bm(state, ids, torch.tensor(depth), rgb255,
                      torch.tensor(K), torch.tensor(c2w), voxel_size=vox,
                      trunc_margin=trunc, layout=layout, weight_clamp=True,
                      obs_weight=torch.ones(()))
    assert (state.weight.numpy() != w0).sum() > 1000  # fusion happened
    assert np.abs(state.tsdf.numpy() - ref[0]).max() <= 1e-5
    assert np.array_equal(state.weight.numpy(), ref[1])
    if fuse_color:
        assert np.abs(state.color.numpy() - ref[2]).max() <= 1.0
    else:
        assert np.array_equal(state.color.numpy(), c0)


def test_seed_matches_jax_full_sweep():
    """The first-frame seed (every brick fused) against the JAX slab-scan
    full sweep, from the axis-aligned first pose of the synthetic orbit."""
    cfg = tiny_config(volume={"voxel_size": 0.05})
    ds = jax_dataset(cfg)
    f = ds[0]
    jv = JaxVolume(copy.deepcopy(cfg), f["c2w"])
    jv.integrate(f["rgb"], f["depth"], jnp.asarray(ds.K()), f["c2w"],
                 rgb_is_unit=True, full_sweep=True)
    tv = MovingVolume(copy.deepcopy(cfg), f["c2w"], "cpu")
    tv.integrate_seed(f["rgb"], f["depth"], ds.K(), f["c2w"])
    assert tv.dims == jv.dims
    assert np.abs(tv.state.tsdf.numpy()
                  - np.asarray(jv.state.tsdf)).max() <= 1e-5
    assert np.array_equal(tv.state.weight.numpy(),
                          np.asarray(jv.state.weight))
    assert np.abs(tv.state.color.numpy()
                  - np.asarray(jv.state.color)).max() <= 1.0


def test_shift_volume_bm_matches_jax():
    rng = np.random.default_rng(2)
    dims, b = (40, 30, 20), 10
    layout = (b, 3, 2)
    t0, w0, c0 = _random_volume(rng, 24, b ** 3)
    origin = np.array([1.0, -2.0, 0.5], np.float32)
    vol_j = jt.VolumeState(jnp.asarray(t0), jnp.asarray(w0), jnp.asarray(c0),
                           jnp.asarray(origin))
    vol_t = pt.VolumeState(torch.tensor(t0), torch.tensor(w0),
                           torch.tensor(c0), torch.tensor(origin))
    for shift in ([0.5, 0.0, -0.5], [-1.0, 0.5, 0.0], [3.0, 0.0, 0.0]):
        new = origin + np.asarray(shift, np.float32)
        rj = jt.shift_volume_bm(vol_j, jnp.asarray(new), 0.05, layout, dims)
        rt = pt.shift_volume_bm(vol_t, torch.tensor(new), 0.05, layout, dims)
        for a, r in zip(rt, rj):
            assert np.array_equal(a.numpy(), np.asarray(r))


def test_dense_shift_and_layout_roundtrip_match_jax():
    rng = np.random.default_rng(3)
    dims, b = (20, 30, 10), 10
    t0, w0, c0 = _random_volume(rng, 6, b ** 3)
    dense_j = [np.asarray(jt.bm_to_dense(jnp.asarray(a), dims, b))
               for a in (t0, w0, c0)]
    dense_t = [pt.bm_to_dense(torch.tensor(a), dims, b) for a in (t0, w0, c0)]
    for a, r in zip(dense_t, dense_j):
        assert np.array_equal(a.numpy(), r)
    assert np.array_equal(pt.dense_to_bm(dense_t[2], b).numpy(), c0)
    origin = np.zeros(3, np.float32)
    new = np.array([0.1, -0.15, 0.05], np.float32)
    rj = jt.shift_volume(jt.VolumeState(*map(jnp.asarray, dense_j),
                                        jnp.asarray(origin)),
                         jnp.asarray(new), 0.05)
    rt = pt.shift_volume(pt.VolumeState(*dense_t, torch.tensor(origin)),
                         torch.tensor(new), 0.05)
    for a, r in zip(rt, rj):
        assert np.array_equal(a.numpy(), np.asarray(r))


@pytest.mark.parametrize("fs_scope", ["frustum", "seen"])
def test_brick_selector_matches_jax(fs_scope):
    cfg = tiny_config(volume={"voxel_size": 0.05})
    ds = jax_dataset(cfg)
    K = ds.K()
    dims, b = (80, 80, 80), 10
    sj = jt.BrickSelector(dims, b, 0.05, K, ds.H, ds.W, fs_scope=fs_scope)
    st = pt.BrickSelector(dims, b, 0.05, K, ds.H, ds.W, fs_scope=fs_scope)
    origin = np.zeros(3, np.float32)
    for i, phase in ((0, 0), (3, 1), (6, 2), (9, 3)):
        f = ds[i]
        rj = sj.select(origin, f["c2w"], f["depth"], 0.06, 256,
                       fs_phase=phase)
        rt = st.select(origin, f["c2w"], f["depth"], 0.06, 256,
                       fs_phase=phase)
        assert rj[1:3] == rt[1:3] and rt[2] > 0
        assert np.array_equal(rj[0], rt[0])
        assert np.array_equal(rj[3], rt[3])
    st.shift_seen(np.array([10.0, -20.0, 0.0]))
    sj.shift_seen(np.array([10.0, -20.0, 0.0]))
    assert np.array_equal(st.seen, sj.seen)


def test_moving_volume_recenters_like_jax():
    cfg = tiny_config(volume={"voxel_size": 0.05})
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (2.0, 2.0, 2.0)
    jv = JaxVolume(copy.deepcopy(cfg), pose)
    tv = MovingVolume(copy.deepcopy(cfg), pose, "cpu")
    rng = np.random.default_rng(4)
    t0, w0, c0 = _random_volume(rng, tv.state.tsdf.shape[0], 1000)
    jv.state = jt.VolumeState(jnp.asarray(t0), jnp.asarray(w0),
                              jnp.asarray(c0), jv.state.origin)
    tv.state = pt.VolumeState(torch.tensor(t0), torch.tensor(w0),
                              torch.tensor(c0), tv.state.origin)
    for i, dx in enumerate((0.4, 1.6, 2.9, 3.3)):
        p = pose.copy()
        p[0, 3] += dx
        p[2, 3] -= 0.5 * dx
        assert tv.check_move(10 + i, p) == jv.check_move(10 + i, p)
        assert np.array_equal(tv.vol_bnds, jv.vol_bnds)
        assert tv.start_id == jv.start_id
        assert tv.frame_to_vrange.keys() == jv.frame_to_vrange.keys()
        for k, b in jv.frame_to_vrange.items():
            assert np.array_equal(tv.frame_to_vrange[k], b)
        for a, r in zip(tv.state, jv.state):
            assert np.array_equal(a.numpy(), np.asarray(r))


def test_filter_low_weight_matches_jax():
    rng = np.random.default_rng(5)
    t0, w0, c0 = _random_volume(rng, 8, 1000)
    origin = np.zeros(3, np.float32)
    rj = jt.filter_low_weight(jt.VolumeState(
        jnp.asarray(t0), jnp.asarray(w0), jnp.asarray(c0),
        jnp.asarray(origin)), 2.0)
    rt = pt.filter_low_weight(pt.VolumeState(
        torch.tensor(t0), torch.tensor(w0), torch.tensor(c0),
        torch.tensor(origin)), 2.0)
    for a, r in zip(rt, rj):
        assert np.array_equal(a.numpy(), np.asarray(r))
