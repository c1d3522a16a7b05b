"""Port parity: remixfusion_tpu_torch.tracking (PST tables, tier vertices and
normals, one full do_tracking call) against the JAX package's ROTracker in
eval_mode 'pallas' (Pallas kernel in interpret mode on the CPU), on the same
volume, initial pose and depth.

Both trackers read the same bf16-rounded 4^3 windows and run the same
float32 arithmetic; sums are taken in another order (~1e-7 relative), so a
full optimisation is held to 1 mm / 0.1 deg. Tables are bitwise equal,
subgrid vertices within 1e-6, normals within 2e-6 (a few ulps of a unit
vector) with the same valid-pixel mask."""

import copy
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from helpers import tiny_config
from remixfusion_tpu.datasets import get_dataset as jax_dataset
from remixfusion_tpu.tracking import pst as jax_pst
from remixfusion_tpu.tracking.rotracker import ROTracker as JaxTracker
from remixfusion_tpu.tracking.volume import MovingVolume as JaxVolume
from remixfusion_tpu_torch.tracking import pst
from remixfusion_tpu_torch.tracking.rotracker import ROTracker
from remixfusion_tpu_torch.utils.convert import volume_state_from_numpy

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(interp="nearest"):
    return tiny_config(
        RO={"particle_iter_lens": 8, "depth_level": [4, 2, 1],
            "eval_mode": "pallas", "tsdf_interp": interp,
            "PST_size": [256, 128, 128], "init_size": 0.03,
            "count_search": 100},
        volume={"voxel_size": 0.025})


def _jax_volume(cfg, ds, n_frames):
    mv = JaxVolume(cfg, ds[0]["c2w"])
    K = jnp.asarray(ds.K())
    for i in range(n_frames):
        f = ds[i]
        mv.integrate(jnp.asarray(np.floor(f["rgb"] * 255.0), jnp.float32),
                     jnp.asarray(f["depth"]), K, jnp.asarray(f["c2w"]))
    return mv


def _pose_gap(a, b):
    dt = np.abs(a[:3, 3] - b[:3, 3]).max()
    rel = a[:3, :3].astype(np.float64) @ b[:3, :3].T.astype(np.float64)
    return dt, np.degrees(Rotation.from_matrix(rel).magnitude())


def test_pst_tables_bitwise_equal():
    sizes = [10240, 3072, 1024]
    a = pst.load_pst("", sizes)
    b = jax_pst.load_pst("", sizes)
    for c in range(3):
        assert a[c].dtype == b[c].dtype and np.array_equal(a[c], b[c])
    assert np.array_equal(pst.slab_index_table(), jax_pst.slab_index_table())
    assert pst.DEPTH_LEVEL == jax_pst.DEPTH_LEVEL


@pytest.mark.parametrize("level,level_index", [(4, 0), (2, 1), (1, 0),
                                               (4, 3), (4, 5)])
def test_tier_vertices_normals_match_jax(level, level_index):
    cfg = _cfg()
    ds = jax_dataset(cfg)
    f = ds[3]
    jt = JaxTracker(cfg, ds.H, ds.W, ds.K(), (80, 80, 80), 0.025)
    tt = ROTracker(copy.deepcopy(cfg), ds.H, ds.W, ds.K(), (80, 80, 80),
                   0.025, (10, 8, 8), "cpu")
    vj, nj, okj = (np.asarray(a) for a in jax.jit(
        lambda d: jt._tier_pixels((None, None, d), level, level_index))(
        jnp.asarray(f["depth"])))
    vt, nt, okt = tt._tier_pixels(
        tt.vertex_normal_maps(torch.tensor(f["depth"])), level, level_index)
    assert vt.shape == vj.shape and nt.shape == nj.shape
    assert np.abs(vt.numpy() - vj).max() <= 1e-6
    # unit normals through a cross product that XLA contracts into FMAs:
    # a few float32 ulps apart; tracking reads only their zero pattern
    assert np.abs(nt.numpy() - nj).max() <= 2e-6
    assert np.array_equal(okt.numpy(), okj) and okj.sum() > 0


@pytest.mark.parametrize("interp", ["nearest", "trilinear"])
def test_do_tracking_matches_jax(interp):
    cfg = _cfg(interp)
    ds = jax_dataset(cfg)
    mv = _jax_volume(copy.deepcopy(cfg), ds, n_frames=5)
    jt = JaxTracker(copy.deepcopy(cfg), ds.H, ds.W, ds.K(), mv.dims,
                    mv.voxel_size,
                    qpack_bm=(mv.brick, mv.dims[1] // mv.brick,
                              mv.dims[2] // mv.brick))
    state = volume_state_from_numpy(
        np.asarray(mv.state.tsdf), np.asarray(mv.state.weight),
        np.asarray(mv.state.color), np.asarray(mv.state.origin), "cpu")
    tt = ROTracker(copy.deepcopy(cfg), ds.H, ds.W, ds.K(), mv.dims,
                   mv.voxel_size, mv.brick_layout(), "cpu")

    f = ds[5]
    init = f["c2w"].copy()
    init[:3, 3] += np.array([0.02, -0.015, 0.01], np.float32)
    init[:3, :3] = (Rotation.from_euler("xyz", [0.8, -0.6, 0.5],
                                        degrees=True).as_matrix()
                    @ init[:3, :3]).astype(np.float32)
    # the JAX pallas path reads a bf16 track volume (slam/pipeline.py)
    rj = jt._track(mv.state.tsdf, mv.state.origin, jnp.asarray(init),
                   jnp.asarray(f["depth"]), jax.random.PRNGKey(0),
                   jt.init_search_size())
    rt = tt.do_tracking(state, init, f["depth"])
    dt, ang = _pose_gap(rt.c2w.numpy(), np.asarray(rj.c2w))
    assert dt < 1e-3 and ang < 0.1, (dt, ang)
    assert rt.first_iter_success == bool(rj.first_iter_success)
    assert abs(float(rt.origin_value) - float(rj.origin_value)) < 1e-4
    # tracking moved the pose toward the truth
    err0 = np.abs(init[:3, 3] - f["c2w"][:3, 3]).mean()
    err1 = np.abs(rt.c2w.numpy()[:3, 3] - f["c2w"][:3, 3]).mean()
    assert err1 < err0


def _jax_sample(key, shape, sr):
    """The JAX tracker's per-pixel draw for a track call with `key`
    (ROTracker._build_track splits once, _compute_vertex draws)."""
    vkey, = jax.random.split(key, 1)
    hi = sr if sr < 1.0 else 1.0
    return np.asarray(jax.random.uniform(vkey, shape, minval=-sr,
                                         maxval=hi))


@pytest.mark.parametrize("sr", [0.1, 2.0])
def test_perturbed_vertex_normal_maps_match_jax(sr):
    """RO.sample_range != 0: the full-image vertex and normal maps from
    JAX's own draw. The expected tsdf and the valid pixels are bitwise;
    xyz within 1e-6 and normals within 2e-6 (XLA contracts into FMAs)."""
    cfg = _cfg()
    cfg["RO"]["sample_range"] = sr
    cfg["RO"]["cut_dist"] = 2.0
    ds = jax_dataset(cfg)
    depth = ds[3]["depth"]
    jt = JaxTracker(cfg, ds.H, ds.W, ds.K(), (80, 80, 80), 0.025)
    tt = ROTracker(copy.deepcopy(cfg), ds.H, ds.W, ds.K(), (80, 80, 80),
                   0.025, (10, 8, 8), "cpu")
    key = jax.random.PRNGKey(11)
    vj = np.asarray(jax.jit(jt._compute_vertex)(
        jnp.asarray(depth), jax.random.split(key, 1)[0]))
    nj = np.asarray(jax.jit(jt._compute_normal)(jnp.asarray(vj)))
    sample = _jax_sample(key, (ds.H, ds.W), sr)
    vt, nt = (a.numpy() for a in tt.vertex_normal_maps(
        torch.tensor(depth), sample=torch.tensor(sample)))
    assert np.array_equal(vt[..., 3], vj[..., 3])
    gt = vj[..., 3][vj[..., 2] != 0]
    # both ends of the expected-tsdf range occur: -sample, and 1.0 past
    # the truncation (sr >= 1 only)
    assert (gt < 0).any() and (gt > 0).any()
    assert (gt == 1.0).any() == (sr >= 1.0)
    assert np.array_equal(vt[..., :3] != 0, vj[..., :3] != 0)
    assert np.abs(vt[..., :3] - vj[..., :3]).max() <= 1e-6
    assert np.array_equal(nt != 0, nj != 0)
    assert np.abs(nt - nj).max() <= 2e-6
    # the tiers gather from these maps as the JAX tiers do
    for level, level_index in ((4, 0), (2, 1), (1, 0)):
        _, _, okj = jt._tier_pixels((jnp.asarray(vj), jnp.asarray(nj),
                                     None), level, level_index)
        _, _, okt = tt._tier_pixels((torch.tensor(vj), torch.tensor(nj)),
                                    level, level_index)
        assert np.array_equal(okt.numpy(), np.asarray(okj))


@pytest.mark.parametrize("sr", [0.1, 2.0])
def test_do_tracking_perturbed_matches_jax(sr):
    """A whole track call with RO.sample_range != 0, JAX's draw injected:
    the same band as the unperturbed call. The JAX tracker's jitted and
    eager runs can land a discrete step apart on the same inputs (XLA's
    FMAs move a candidate's cost by an ulp; at sr = 2.0 here they part by
    2.4 mm / 0.26 deg, and the port matches the eager run to 1e-5 deg even
    when fed JAX's own maps); where the port misses the jitted pose it is
    held to the eager one, as the pipeline lockstep test does."""
    cfg = _cfg()
    cfg["RO"]["sample_range"] = sr
    ds = jax_dataset(cfg)
    mv = _jax_volume(copy.deepcopy(cfg), ds, n_frames=5)
    jt = JaxTracker(copy.deepcopy(cfg), ds.H, ds.W, ds.K(), mv.dims,
                    mv.voxel_size,
                    qpack_bm=(mv.brick, mv.dims[1] // mv.brick,
                              mv.dims[2] // mv.brick))
    state = volume_state_from_numpy(
        np.asarray(mv.state.tsdf), np.asarray(mv.state.weight),
        np.asarray(mv.state.color), np.asarray(mv.state.origin), "cpu")
    tt = ROTracker(copy.deepcopy(cfg), ds.H, ds.W, ds.K(), mv.dims,
                   mv.voxel_size, mv.brick_layout(), "cpu")
    f = ds[5]
    init = f["c2w"].copy()
    init[:3, 3] += np.array([0.015, -0.01, 0.01], np.float32)
    key = jax.random.PRNGKey(5)
    rj = jt._track(mv.state.tsdf, mv.state.origin, jnp.asarray(init),
                   jnp.asarray(f["depth"]), key, jt.init_search_size())
    rt = tt.do_tracking(state, init, f["depth"],
                        sample=_jax_sample(key, (ds.H, ds.W), sr))
    dt, ang = _pose_gap(rt.c2w.numpy(), np.asarray(rj.c2w))
    if not (dt < 1e-3 and ang < 0.1):
        with jax.disable_jit():
            rj = jt._track(mv.state.tsdf, mv.state.origin,
                           jnp.asarray(init), jnp.asarray(f["depth"]), key,
                           jt.init_search_size())
        dt, ang = _pose_gap(rt.c2w.numpy(), np.asarray(rj.c2w))
    assert dt < 1e-3 and ang < 0.1, (dt, ang)
    assert rt.first_iter_success == bool(rj.first_iter_success)
    assert abs(float(rt.origin_value) - float(rj.origin_value)) < 1e-4


def test_perturbed_draw_ranges():
    """The port's own draw (torch.Generator) covers the JAX ranges:
    U(-sr, sr) below 1, U(-sr, 1) from 1 on; same generator state, same
    draw."""
    for sr, lo, hi in ((0.1, -0.1, 0.1), (2.0, -2.0, 1.0)):
        cfg = tiny_config(RO={"eval_mode": "pallas", "sample_range": sr})
        tt = ROTracker(cfg, 48, 64, np.eye(3, dtype=np.float32),
                       (80, 80, 80), 0.05, (10, 8, 8), "cpu")
        s = tt.draw_sample(torch.Generator().manual_seed(3))
        assert s.shape == (48, 64) and s.dtype == torch.float32
        assert lo <= float(s.min()) < lo + 0.05 * (hi - lo)
        assert hi - 0.05 * (hi - lo) < float(s.max()) < hi
        assert torch.equal(s, tt.draw_sample(
            torch.Generator().manual_seed(3)))
        with pytest.raises(ValueError):
            tt.vertex_normal_maps(torch.zeros(48, 64))


def test_tracker_rejects_unported_modes():
    """Every eval_mode and brick_radius of the JAX tracker builds (gather,
    brick at r = 3, pallas, which reads 4^3 windows whatever the radius,
    as in JAX, on a bfloat16 or a float32 track view); the settings no
    tracker runs raise ValueError: trilinear with gather (JAX raises
    alike) and an unknown mode."""
    K = np.eye(3, dtype=np.float32)
    for ro, vol, dtype in (
            ({"eval_mode": "gather"}, {}, "float32"),
            ({"eval_mode": "brick", "brick_radius": 3}, {}, "bfloat16"),
            ({"eval_mode": "pallas", "brick_radius": 3}, {}, "bfloat16"),
            ({"eval_mode": "pallas"}, {"track_dtype": "float32"},
             "float32")):
        tt = ROTracker(tiny_config(RO=ro, volume=vol), 48, 64, K,
                       (80, 80, 80), 0.05, (10, 8, 8), "cpu")
        assert (tt.eval_mode, tt.track_dtype) == (ro["eval_mode"], dtype)
        assert tt.brick_r == ro.get("brick_radius", 2)
    for ro, vol in (({"eval_mode": "gather", "tsdf_interp": "trilinear"},
                     {}),
                    ({"eval_mode": "bricks"}, {})):
        with pytest.raises(ValueError):
            ROTracker(tiny_config(RO=ro, volume=vol), 48, 64, K,
                      (80, 80, 80), 0.05, (10, 8, 8), "cpu")


@pytest.mark.parametrize("interp", ["nearest", "trilinear"])
@pytest.mark.parametrize("level", [4, 1])
def test_pallas_tier_on_float32_view_matches_jax(level, interp):
    """eval_mode pallas with volume.track_dtype float32: one tier's costs
    (score_tier, the tracker's call of brick_eval_volume) against JAX's
    _eval_tier_pallas (the Pallas kernel in interpret mode) on the same
    float32 view, pose and table slab: the windows are scored unrounded
    in both, held to the brick_eval bar; the bfloat16 view's costs
    differ."""
    cfg = _cfg(interp)
    cfg["volume"]["track_dtype"] = "float32"
    ds = jax_dataset(cfg)
    mv = _jax_volume(copy.deepcopy(cfg), ds, n_frames=5)
    jt = JaxTracker(copy.deepcopy(cfg), ds.H, ds.W, ds.K(), mv.dims,
                    mv.voxel_size, brick_layout=mv.brick_layout())
    tt = ROTracker(copy.deepcopy(cfg), ds.H, ds.W, ds.K(), mv.dims,
                   mv.voxel_size, mv.brick_layout(), "cpu")
    assert tt.track_dtype == "float32"
    state = volume_state_from_numpy(
        np.asarray(mv.state.tsdf), np.asarray(mv.state.weight),
        np.asarray(mv.state.color), np.asarray(mv.state.origin), "cpu")
    f = ds[5]
    c2w = f["c2w"].copy()
    c2w[:3, 3] += np.array([0.01, -0.008, 0.006], np.float32)
    R, T = c2w[:3, :3], c2w[:3, 3]
    ss = np.full(6, 0.02, np.float32)
    cls = {4: 0, 2: 1, 1: 2}[level]
    ref = np.asarray(jax.jit(lambda: jt._eval_tier_pallas(
        jt.pst_t[cls][0], level, 0, jnp.asarray(R), jnp.asarray(T),
        jnp.asarray(ss), (None, None, jnp.asarray(f["depth"])),
        (mv.state.tsdf.reshape(-1), None), mv.state.origin))())
    args = (level, 0, torch.tensor(R), torch.tensor(T), torch.tensor(ss),
            tt.vertex_normal_maps(torch.tensor(f["depth"])))
    got = tt.score_tier(cls, 0, *args, tt.track_view(state.tsdf),
                        state.origin).numpy()
    assert got.shape == ref.shape
    assert np.array_equal(got >= 1e6, ref >= 1e6)
    keep = ref < 1e6
    assert keep.sum() > 0.9 * len(ref)
    d = np.abs(got[keep] - ref[keep])
    assert d.max() < 5e-3 and d.mean() < 1e-4, (d.max(), d.mean())
    tt.track_dtype = "bfloat16"
    rounded = tt.score_tier(cls, 0, *args, tt.track_view(state.tsdf),
                            state.origin).numpy()
    assert not np.array_equal(rounded, got)


@pytest.mark.parametrize("pix_ref", ["default", None])
def test_tier_strides_at_720p_match_jax(pix_ref):
    """RO.pix_ref at 1280x720: the tier strides, pixel counts and valid
    masks bitwise the JAX tracker's (vertices within 1e-6), with the
    default [480, 640] (VGA's 300 / 1,200 / 4,800 pixels) and with null
    (absolute strides 32 / 16 / 8)."""
    ro = {"eval_mode": "pallas"}
    if pix_ref != "default":
        ro["pix_ref"] = pix_ref
    cfg = tiny_config(RO=ro)
    H, W = 720, 1280
    K = np.array([[800.0, 0, 639.5], [0, 800.0, 359.5], [0, 0, 1]],
                 np.float32)
    jt = JaxTracker(copy.deepcopy(cfg), H, W, K, (80, 80, 80), 0.05)
    tt = ROTracker(copy.deepcopy(cfg), H, W, K, (80, 80, 80), 0.05,
                   (10, 8, 8), "cpu")
    assert tt.tier_strides == jt.tier_strides
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    depth = 2.0 + 0.3 * np.sin(xx / 97.0) * np.cos(yy / 61.0)
    vn = tt.vertex_normal_maps(torch.tensor(depth))
    counts = []
    for level in tt.class_level:
        for level_index in (0, 5):
            vj, _, okj = (np.asarray(a) for a in jax.jit(
                lambda d: jt._tier_pixels((None, None, d), level,
                                          level_index))(jnp.asarray(depth)))
            vt, _, okt = tt._tier_pixels(vn, level, level_index)
            assert vt.shape == vj.shape, (level, level_index)
            # test_tier_vertices_normals_match_jax's bar: a last-bit
            # difference of the back-projection
            assert np.abs(vt.numpy() - vj).max() <= 1e-6
            assert np.array_equal(okt.numpy(), okj)
        counts.append(len(vj))
    assert counts == ([300, 1200, 4800] if pix_ref == "default"
                      else [880, 3600, 14400]), counts


REAL_CONFIGS = sorted(
    os.path.relpath(p, ROOT) for p in glob.glob(
        os.path.join(ROOT, "configs", "*", "*.yaml"))
    if os.sep + "Synthetic" + os.sep not in p)


@pytest.mark.parametrize("path", REAL_CONFIGS)
def test_real_config_builds_tracker_and_loader_class(path, monkeypatch):
    """Every real-sensor config (ScanNet's sample_range 2.0 and 3.0, TUM's
    0.1 included) builds the port's tracker at its own camera (after
    crop_size / crop_edge) and names a ported loader. The PST tables are
    stubbed small here: generating the real ones takes seconds per config
    (test_pst_tables_bitwise_equal holds them)."""
    from remixfusion_tpu_torch.config import load_config
    from remixfusion_tpu_torch.datasets import loaders
    from remixfusion_tpu_torch.datasets.base import update_cam
    from remixfusion_tpu_torch.tracking import rotracker

    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(rotracker.pst_mod, "load_pst", lambda _p, sizes: {
        c: np.zeros((7, 8, 6), np.float32) for c in range(3)})
    cfg = load_config(path)
    update_cam(cfg["cam"])
    c = cfg["cam"]
    K = np.array([[c["fx"], 0, c["cx"]], [0, c["fy"], c["cy"]], [0, 0, 1]],
                 np.float32)
    tt = ROTracker(cfg, c["H"], c["W"], K, (100, 100, 100),
                   cfg["volume"]["voxel_size"], (10, 10, 10), "cpu")
    assert tt.sample_range == float(cfg["RO"]["sample_range"])
    assert tt.truncation == float(cfg["volume"]["trunc"])
    name = cfg["dataset"].lower().replace("_", "")
    assert any(cls.__name__.lower().startswith(name)
               for cls in vars(loaders).values() if isinstance(cls, type)
               and issubclass(cls, loaders.FileRGBDDataset)), name
