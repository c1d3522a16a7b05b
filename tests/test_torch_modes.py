"""Port parity of the other tracking and fusion modes against the JAX
package on the CPU:

  - the tracker's eval_mode gather (the exact per-(candidate, pixel)
    lookup on a float32 view) and eval_mode brick at brick_radius 2 and 3,
    nearest and trilinear, on a tier of >= 2048 pixels (the rotation-matrix
    branch) and a smaller one: candidate costs on the same tier, and a
    whole do_tracking call;
  - BrickSelector.select with fs_span 2 over a sequence of frames (bitwise);
  - the dense volume's fusers (fuse_frame, the slab fuser's full sweep, the
    frustum-tiled fuser) and reset_volume, trilinear, nearest_tsdf;
  - tiny runs with volume.brick_fusion false and with volume.sel_reuse 2,
    and the resume state of a dense volume.

Tolerances: candidate costs within 2e-6 (the same float32 operations; the
per-candidate sums add in another order, and XLA contracts multiply-adds),
except that with nearest lookups a moved vertex a last bit from a voxel's
rounding edge can read the neighbour voxel: there 95% of the candidates
within 2e-6 and all within the chip smoke's kernel tolerance (max 5e-3,
mean 1e-4);
whole track calls within 1 mm / 0.1 deg (the discrete optimiser amplifies a
last-bit difference into a step at most, as tests/test_torch_tracking.py
states); fusion as tests/test_torch_tsdf.py holds the brick fuser (tsdf
within 1e-5, weights bitwise, colours within one 8-bit step); whole runs'
RO-only ATE within 0.1 cm of JAX's."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from helpers import tiny_config
from remixfusion_tpu.datasets import get_dataset as jax_dataset
from remixfusion_tpu.ops import tsdf as jt
from remixfusion_tpu.tools.eval_ate import evaluate_ate
from remixfusion_tpu.tracking.rotracker import ROTracker as JaxTracker
from remixfusion_tpu.tracking.volume import MovingVolume as JaxVolume
from remixfusion_tpu_torch.ops import tsdf as pt
from remixfusion_tpu_torch.slam import RemixFusionTorch
from remixfusion_tpu_torch.tracking.rotracker import ROTracker
from remixfusion_tpu_torch.tracking.volume import MovingVolume
from remixfusion_tpu_torch.utils.convert import volume_state_from_numpy
from test_torch_pipeline import _jax_run

torch.set_num_threads(1)


def _cfg(mode, r=2, interp="nearest", **ro):
    return tiny_config(
        RO={"particle_iter_lens": 8, "depth_level": [4, 2, 1],
            "eval_mode": mode, "brick_radius": r, "tsdf_interp": interp,
            "PST_size": [256, 128, 128], "init_size": 0.03,
            "count_search": 100, **ro},
        volume={"voxel_size": 0.025})


_VOL = {}


def _volume():
    """A JAX brick-major volume with frames 0..4 of the tiny orbit fused
    (built once), the dataset, and its port copy."""
    if not _VOL:
        cfg = _cfg("pallas")
        ds = jax_dataset(cfg)
        mv = JaxVolume(copy.deepcopy(cfg), ds[0]["c2w"])
        K = jnp.asarray(ds.K())
        for i in range(5):
            f = ds[i]
            mv.integrate(jnp.asarray(np.floor(f["rgb"] * 255.0), jnp.float32),
                         jnp.asarray(f["depth"]), K, jnp.asarray(f["c2w"]))
        _VOL.update(ds=ds, mv=mv, state=volume_state_from_numpy(
            np.asarray(mv.state.tsdf), np.asarray(mv.state.weight),
            np.asarray(mv.state.color), np.asarray(mv.state.origin), "cpu"))
    return _VOL["ds"], _VOL["mv"], _VOL["state"]


def _trackers(cfg):
    ds, mv, state = _volume()
    jtr = JaxTracker(copy.deepcopy(cfg), ds.H, ds.W, ds.K(), mv.dims,
                     mv.voxel_size, brick_layout=mv.brick_layout())
    ttr = ROTracker(copy.deepcopy(cfg), ds.H, ds.W, ds.K(), mv.dims,
                    mv.voxel_size, mv.brick_layout(), "cpu")
    return ds, mv, state, jtr, ttr


def _views(mv, state, dtype):
    """The JAX and port track views of the brick-major volume."""
    jflat = mv.state.tsdf.reshape(-1)
    tflat = state.tsdf.reshape(-1)
    if dtype == "bfloat16":
        return jflat.astype(jnp.bfloat16), tflat.to(torch.bfloat16)
    return jflat, tflat


def _pose(f, dt=(0.01, -0.008, 0.006), deg=(0.4, -0.3, 0.2)):
    p = f["c2w"].copy()
    p[:3, 3] += np.asarray(dt, np.float32)
    p[:3, :3] = (Rotation.from_euler("xyz", deg, degrees=True).as_matrix()
                 @ p[:3, :3]).astype(np.float32)
    return p


def _gap(a, b):
    rel = a[:3, :3].astype(np.float64) @ b[:3, :3].T.astype(np.float64)
    return (np.abs(a[:3, 3] - b[:3, 3]).max(),
            np.degrees(Rotation.from_matrix(rel).magnitude()))


MODES = [("gather", 2, "nearest"), ("brick", 2, "nearest"),
         ("brick", 2, "trilinear"), ("brick", 3, "nearest"),
         ("brick", 3, "trilinear")]


@pytest.mark.parametrize("level", [1, 4])
@pytest.mark.parametrize("mode,r,interp", MODES)
def test_tier_costs_match_jax(mode, r, interp, level):
    """Candidate costs of one tier in gather and brick mode against JAX's
    _eval_tier / _eval_tier_brick on the same volume, pose and table slab:
    level 1 is a 48 x 64 = 3072-pixel tier (brick mode's rotation-matrix
    branch), level 4 a 192-pixel one (the quaternion branch). The view is
    each mode's default track dtype: float32 for gather, bfloat16 for
    brick."""
    cfg = _cfg(mode, r, interp)
    ds, mv, state, jtr, ttr = _trackers(cfg)
    assert ttr.track_dtype == ("float32" if mode == "gather"
                               else "bfloat16")
    f = ds[5]
    depth = f["depth"]
    c2w = _pose(f)
    R, T = c2w[:3, :3], c2w[:3, 3]
    ss = np.full(6, 0.02, np.float32)
    cls = {4: 0, 2: 1, 1: 2}[level]
    jflat, tflat = _views(mv, state, ttr.track_dtype)
    jfn = jtr._eval_tier if mode == "gather" else jtr._eval_tier_brick
    tfn = ttr.eval_gather if mode == "gather" else ttr.eval_brick
    ref = np.asarray(jax.jit(lambda: jfn(
        jtr.pst[cls][0], level, 0, jnp.asarray(R), jnp.asarray(T),
        jnp.asarray(ss), (None, None, jnp.asarray(depth)), (jflat, None),
        mv.state.origin))())
    got = tfn(ttr.pst[cls][0], level, 0, torch.tensor(R), torch.tensor(T),
              torch.tensor(ss), ttr.vertex_normal_maps(torch.tensor(depth)),
              tflat, state.origin).numpy()
    assert np.array_equal(got >= 1e6, ref >= 1e6)
    keep = ref < 1e6
    assert keep.sum() > 0.9 * len(ref)
    d = np.abs(got[keep] - ref[keep])
    if interp == "trilinear":
        assert d.max() <= 2e-6
    else:
        # a moved vertex a last bit from a voxel's rounding edge reads the
        # neighbour voxel: one (candidate, pixel) pair of the tier
        assert (d <= 2e-6).mean() >= 0.95
        assert d.max() < 5e-3 and d.mean() < 1e-4


@pytest.mark.parametrize("mode,r,interp", MODES)
def test_do_tracking_modes_match_jax(mode, r, interp):
    """A whole track call in gather and brick mode: the pose within 1 mm /
    0.1 deg of JAX's, the same first-iteration success, the final fitness
    within 1e-4; and the pose moves toward the truth."""
    cfg = _cfg(mode, r, interp)
    ds, mv, state, jtr, ttr = _trackers(cfg)
    f = ds[5]
    init = _pose(f, (0.02, -0.015, 0.01), (0.8, -0.6, 0.5))
    jflat, _ = _views(mv, state, ttr.track_dtype)
    rj = jtr._track(jflat, mv.state.origin, jnp.asarray(init),
                    jnp.asarray(f["depth"]), jax.random.PRNGKey(0),
                    jtr.init_search_size())
    rt = ttr.do_tracking(state, init, f["depth"])
    dt, ang = _gap(rt.c2w.numpy(), np.asarray(rj.c2w))
    assert dt < 1e-3 and ang < 0.1, (dt, ang)
    assert rt.first_iter_success == bool(rj.first_iter_success)
    assert abs(float(rt.origin_value) - float(rj.origin_value)) < 1e-4
    err0 = np.abs(init[:3, 3] - f["c2w"][:3, 3]).mean()
    err1 = np.abs(rt.c2w.numpy()[:3, 3] - f["c2w"][:3, 3]).mean()
    assert err1 < err0


def test_gather_matches_brick_at_small_search():
    """With a search size small enough that every moved vertex stays in
    its pixel's 4^3 window, brick mode (r = 2) on a float32 view scores
    every candidate as the exact gather does."""
    ds, mv, state, _, tg = _trackers(_cfg("gather"))
    cfg = _cfg("brick")
    cfg["volume"]["track_dtype"] = "float32"
    tb = ROTracker(cfg, ds.H, ds.W, ds.K(), mv.dims, mv.voxel_size,
                   mv.brick_layout(), "cpu")
    f = ds[5]
    args = (torch.tensor(f["c2w"][:3, :3]), torch.tensor(f["c2w"][:3, 3]),
            torch.full((6,), 0.002),
            tg.vertex_normal_maps(torch.tensor(f["depth"])),
            state.tsdf.reshape(-1), state.origin)
    for cls, level in ((0, 4), (2, 1)):
        table = tg.pst[cls][0]
        vg = tg.eval_gather(table, level, 0, *args)
        vb = tb.eval_brick(table, level, 0, *args)
        assert torch.equal(vg >= 1e6, vb >= 1e6)
        d = (vg - vb).abs()
        if level == 4:  # both through the quaternion algebra: the bits
            assert torch.equal(vg, vb)
        else:  # brick mode's matrix branch rounds vertices otherwise
            assert float(d.max()) < 5e-3 and float(d.mean()) < 1e-4


def test_tracker_mode_checks_match_jax():
    """trilinear with gather raises ValueError in both packages; the port
    also refuses unknown modes; eval_mode pallas on a float32 view builds
    in both."""
    ds = jax_dataset(_cfg("gather"))
    for cfg, jax_raises in ((_cfg("gather", interp="trilinear"), True),
                            (_cfg("nope"), False), (_cfg("brick", 0), False)):
        with pytest.raises(ValueError):
            ROTracker(cfg, ds.H, ds.W, ds.K(), (80, 80, 80), 0.05,
                      (10, 8, 8), "cpu")
        if jax_raises:
            with pytest.raises(ValueError):
                JaxTracker(cfg, ds.H, ds.W, ds.K(), (80, 80, 80), 0.05)
    cfg = _cfg("pallas")
    cfg["volume"]["track_dtype"] = "float32"
    JaxTracker(cfg, ds.H, ds.W, ds.K(), (80, 80, 80), 0.05)
    tt = ROTracker(cfg, ds.H, ds.W, ds.K(), (80, 80, 80), 0.05, (10, 8, 8),
                   "cpu")
    assert (tt.eval_mode, tt.track_dtype) == ("pallas", "float32")


def test_brick_selector_fs_span_matches_jax():
    """select(fs_span=2) over a sequence of frames, phases advancing by 2
    (a selection serving two frames): bitwise the JAX selection."""
    cfg = tiny_config(volume={"voxel_size": 0.05})
    ds = jax_dataset(cfg)
    K = ds.K()
    dims, b = (80, 80, 80), 10
    sj = jt.BrickSelector(dims, b, 0.05, K, ds.H, ds.W)
    st = pt.BrickSelector(dims, b, 0.05, K, ds.H, ds.W)
    origin = np.zeros(3, np.float32)
    n_fs = []
    for i, phase in enumerate(range(0, 12, 2)):
        f = ds[i * 2]
        rj = sj.select(origin, f["c2w"], f["depth"], 0.06, 512,
                       fs_phase=phase, fs_every=4, fs_span=2)
        rt = st.select(origin, f["c2w"], f["depth"], 0.06, 512,
                       fs_phase=phase, fs_every=4, fs_span=2)
        assert rj[1:3] == rt[1:3]
        assert np.array_equal(rj[0], rt[0])
        assert np.array_equal(rj[3], rt[3])
        n_fs.append(rt[2] - rt[1])
        one = st.select(origin, f["c2w"], f["depth"], 0.06, 512,
                        fs_phase=phase, fs_every=4)
        assert one[2] - one[1] < n_fs[-1]  # two phases carve more
    assert min(n_fs) > 0


# ------------------------------------------------------------ dense fusion


def _frame_case(seed=1):
    rng = np.random.default_rng(seed)
    H, W = 24, 32
    K = np.array([[30.0, 0, 15.5], [0, 30.0, 11.5], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = Rotation.from_euler("xyz", [7.0, -11.0, 4.0],
                                      degrees=True).as_matrix()
    c2w[:3, 3] = [0.93, 0.71, -0.37]
    depth = rng.uniform(0.4, 2.2, (H, W)).astype(np.float32)
    depth[rng.random((H, W)) < 0.1] = 0.0
    rgb = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    dims = (60, 40, 60)
    t0 = rng.uniform(-1, 1, dims).astype(np.float32)
    w0 = rng.integers(0, 6, dims).astype(np.float32)
    c0 = rng.integers(0, 256, dims + (3,)).astype(np.float32)
    origin = np.array([0.0, -0.5, 0.0], np.float32)
    return dict(H=H, W=W, K=K, c2w=c2w, depth=depth, rgb=rgb, dims=dims,
                vol=(t0, w0, c0, origin), vox=0.05, trunc=0.12)


def _hold(got, ref, w0, tol=1e-5):
    t2, w2, c2 = (a.numpy() for a in got[:3])
    assert (w2 != w0).sum() > 1000  # fusion happened
    assert np.abs(t2 - np.asarray(ref[0])).max() <= tol
    assert np.array_equal(w2, np.asarray(ref[1]))
    assert np.abs(c2 - np.asarray(ref[2])).max() <= 1.0


def _port_state(case):
    return pt.VolumeState(*(torch.tensor(a) for a in case["vol"]))


def _count_updates(monkeypatch):
    """Count fuse_dense's calls of the per-voxel update: one per slab of
    the full sweep, one per chunk of the tiled path."""
    calls = []
    inner = pt._fuse_local_update

    def counted(*a):
        calls.append(1)
        return inner(*a)

    monkeypatch.setattr(pt, "_fuse_local_update", counted)
    return calls


def test_fuse_frame_and_slab_fuser_match_jax(monkeypatch):
    """The port's full sweep (fuse_dense without tiles, in x-slabs of
    pick_slab_count) against JAX's fuse_frame (local mode, colours as
    given) and make_slab_fuser (colours floor(255 x)), with weight_clamp
    on and off. The slab target is cut from its 4M voxels so that this
    small volume sweeps in several slabs, as the 300^3 volume does."""
    assert pt.pick_slab_count(300, 300 * 300) \
        == jt.pick_slab_count(300, 300 * 300, pt._SLAB_TARGET_VOXELS) == 10
    c = _frame_case()
    t0, w0, c0, origin = c["vol"]
    rgb255 = np.floor(c["rgb"] * 255.0)
    targs = (torch.tensor(c["depth"]), torch.tensor(rgb255),
             torch.tensor(c["K"]), torch.tensor(c["c2w"]))
    for clamp in (True, False):
        ref = jt.fuse_frame(
            jt.VolumeState(*map(jnp.asarray, c["vol"])),
            jnp.asarray(c["depth"]), jnp.asarray(rgb255), jnp.asarray(c["K"]),
            jnp.asarray(c["c2w"]), voxel_size=c["vox"],
            trunc_margin=c["trunc"], im_h=c["H"], im_w=c["W"],
            weight_clamp=clamp)
        got = pt.fuse_frame(_port_state(c), *targs, voxel_size=c["vox"],
                            trunc_margin=c["trunc"], weight_clamp=clamp)
        _hold(got, ref, w0)
    monkeypatch.setattr(pt, "_SLAB_TARGET_VOXELS", 20_000)
    n = jt.pick_slab_count(c["dims"][0], c["dims"][1] * c["dims"][2],
                           target_voxels=20_000)
    assert n == pt.pick_slab_count(c["dims"][0],
                                   c["dims"][1] * c["dims"][2]) > 1
    fuser = jt.make_slab_fuser(
        c["dims"], n, voxel_size=c["vox"], trunc_margin=c["trunc"],
        im_h=c["H"], im_w=c["W"], weight_clamp=True, scale_rgb=True)
    ref = fuser(*(jnp.asarray(a) for a in (t0, w0, c0, origin)),
                jnp.asarray(c["depth"]), jnp.asarray(c["rgb"]),
                jnp.asarray(c["K"]), jnp.asarray(c["c2w"]),
                jnp.asarray(1.0, jnp.float32))
    st = _port_state(c)
    calls = _count_updates(monkeypatch)
    got = pt.fuse_dense(st, *targs, voxel_size=c["vox"],
                        trunc_margin=c["trunc"], weight_clamp=True,
                        obs_weight=torch.ones(()))
    assert got is st  # in place
    assert len(calls) == n
    _hold(got, ref, w0)


def test_tiled_fuser_matches_jax_and_the_full_sweep(monkeypatch):
    """The frustum tiles of frustum_tiles (tile 10, which divides every
    dim) through fuse_dense against JAX's make_tiled_fuser (padded with -1
    offsets), and against the port's own full sweep bitwise: the tiles are
    disjoint and hold every voxel the frame can update. The chunk is cut
    to three tiles so that the tiles move through in several chunks."""
    c = _frame_case(2)
    t0, w0, c0, origin = c["vol"]
    tile = 10
    offs = jt.frustum_tiles(c["dims"], tile, origin, c["vox"], c["K"],
                            c["c2w"], c["H"], c["W"],
                            max_depth=float(c["depth"].max()) + c["trunc"]
                            + 0.1, pad_px=16)
    n_tiles = int(np.prod([d // tile for d in c["dims"]]))
    assert 0 < len(offs) < n_tiles
    budget = len(offs) + 3
    fuser = jt.make_tiled_fuser(
        c["dims"], tile, budget, voxel_size=c["vox"],
        trunc_margin=c["trunc"], im_h=c["H"], im_w=c["W"],
        weight_clamp=True, scale_rgb=True)
    pad = np.full((budget - len(offs), 3), -1, np.int32)
    ref = fuser(*(jnp.asarray(a) for a in (t0, w0, c0, origin)),
                jnp.asarray(np.concatenate([offs, pad])),
                jnp.asarray(c["depth"]), jnp.asarray(c["rgb"]),
                jnp.asarray(c["K"]), jnp.asarray(c["c2w"]),
                jnp.asarray(1.0, jnp.float32))
    targs = (torch.tensor(c["depth"]),
             torch.tensor(np.floor(c["rgb"] * 255.0)),
             torch.tensor(c["K"]), torch.tensor(c["c2w"]))
    kw = dict(voxel_size=c["vox"], trunc_margin=c["trunc"],
              weight_clamp=True, obs_weight=torch.ones(()))
    monkeypatch.setattr(pt, "_FUSE_CHUNK", 3 * tile ** 3)
    calls = _count_updates(monkeypatch)
    tiled = pt.fuse_dense(_port_state(c), *targs, tiles=offs, tile=tile,
                          **kw)
    assert len(calls) == -(-len(offs) // 3) > 1
    _hold(tiled, ref, w0)
    full = pt.fuse_dense(_port_state(c), *targs, **kw)
    for a, b in zip(tiled[:3], full[:3]):
        assert torch.equal(a, b)


def test_reset_trilinear_nearest_match_jax():
    c = _frame_case(3)
    t0, w0, c0, origin = c["vol"]
    w0[::3] = 0.0
    rv = pt.reset_volume(_port_state(c))
    rj = jt.reset_volume(jt.VolumeState(*map(jnp.asarray, c["vol"])))
    for a, b in zip(rv, rj):
        assert np.array_equal(a.numpy(), np.asarray(b))
    rng = np.random.default_rng(4)
    lo = origin - 0.1
    hi = origin + np.asarray(c["dims"]) * c["vox"] + 0.1
    pts = rng.uniform(lo, hi, (5000, 3)).astype(np.float32)
    tj = jt.trilinear(*(jnp.asarray(a) for a in (t0, c0, w0, pts, origin)),
                      c["vox"])
    tt = pt.trilinear(*(torch.tensor(a) for a in (t0, c0, w0, pts, origin)),
                      c["vox"])
    assert np.array_equal(tt[2].numpy(), np.asarray(tj[2]))
    assert 0 < tt[2].sum() < len(pts)
    np.testing.assert_allclose(tt[0].numpy(), np.asarray(tj[0]), atol=1e-6)
    np.testing.assert_allclose(tt[1].numpy(), np.asarray(tj[1]), atol=1e-3)
    nj = jt.nearest_tsdf(jnp.asarray(t0).reshape(-1), jnp.asarray(pts),
                         jnp.asarray(origin), c["vox"], c["dims"])
    nt = pt.nearest_tsdf(torch.tensor(t0).reshape(-1), torch.tensor(pts),
                         torch.tensor(origin), c["vox"], c["dims"])
    for a, b in zip(nt, nj):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_dense_volume_matches_jax():
    """volume.brick_fusion false: the dims unpadded, the tile edge and
    budget, the seed's full sweep, a tiled frame (the tiny camera's wide
    frustum needs a budget of 0.9 of the 64 tiles) and a re-centre against
    the JAX MovingVolume."""
    cfg = tiny_config(volume={"voxel_size": 0.025, "brick_fusion": False,
                              "tile_budget_frac": 0.9})
    ds = jax_dataset(cfg)
    f = ds[0]
    jv = JaxVolume(copy.deepcopy(cfg), f["c2w"])
    tv = MovingVolume(copy.deepcopy(cfg), f["c2w"], "cpu")
    assert tv.dims == jv.dims and not tv.brick and not jv.brick
    assert tv.tile == jv.tile == 40 and tv.tile_budget == jv.tile_budget
    assert tv.brick_layout() == (1, tv.dims[1], tv.dims[2])
    K = ds.K()
    jv.integrate(f["rgb"], f["depth"], jnp.asarray(K), f["c2w"],
                 rgb_is_unit=True, full_sweep=True)
    tv.integrate_seed(f["rgb"], f["depth"], K, f["c2w"])
    _hold(tv.state, jv.state, np.zeros(tv.dims, np.float32))
    g = ds[3]
    offs = tv.frame_tiles(g["c2w"], g["depth"], K)
    assert offs is not None and 0 < len(offs) <= tv.tile_budget < 64
    jv.integrate(jnp.asarray(np.floor(g["rgb"] * 255.0)),
                 jnp.asarray(g["depth"]), jnp.asarray(K),
                 jnp.asarray(g["c2w"]))
    before = tv.state.weight.numpy().copy()
    tv.fuse(offs, torch.tensor(g["depth"]),
            torch.floor(torch.tensor(g["rgb"]) * 255.0), torch.tensor(K),
            torch.tensor(g["c2w"]), torch.ones(()))
    # two frames' running means, each within 1e-5
    _hold(tv.state, jv.state, before, 2e-5)
    p = g["c2w"].copy()
    p[0, 3] += 1.6
    assert tv.check_move(4, p) and jv.check_move(4, p)
    assert np.array_equal(tv.vol_bnds, jv.vol_bnds)
    _hold(tv.state, jv.state, np.full(tv.dims, -1.0, np.float32), 2e-5)


def _ro_ate(ro, gt, n):
    return 100 * evaluate_ate({float(i): gt[i] for i in range(n)},
                              {float(i): ro[i] for i in range(n)})["rmse"]


def _run_cfg(tmp, **volume):
    cfg = tiny_config(
        data={"output": str(tmp), "exp_name": "modes",
              "synthetic": {"n_frames": 8, "orbit_degrees": 20.0}},
        RO={"particle_iter_lens": 6, "depth_level": [4, 2, 1],
            "eval_mode": "pallas", "PST_size": [256, 128, 128],
            "init_size": 0.02, "count_search": 100,
            "tsdf_interp": "trilinear"},
        volume={"voxel_size": 0.025, **volume},
        tracking={"harvest_depth": 1})
    return cfg


@pytest.mark.parametrize("volume", [{"brick_fusion": False},
                                    {"sel_reuse": 2}])
def test_tiny_run_ro_ate_matches_jax(volume, tmp_path):
    """A tiny 8-frame run with a dense volume (tiled fusion) and one with
    selections reused for two frames: the port's RO-only ATE within 0.1 cm
    of the JAX pipeline's on the same config (trilinear lookups, as
    test_torch_pipeline's free-running run: with nearest ones both
    packages take discrete steps a last bit apart, 8.5 mm at frame 3 here,
    whatever the fusion mode)."""
    cfg = _run_cfg(tmp_path / "jax", **volume)
    run = _jax_run(None, tmp_path / "jax", cfg, 8)
    ate_jax = _ro_ate(run["ro"], run["gt"], 8)
    cfg = _run_cfg(tmp_path / "port", **volume)
    s = RemixFusionTorch(cfg, device="cpu")
    out = s.run()
    assert out["tracked_frames"] == 7
    if "sel_reuse" in volume:
        assert out["sel_reused"] >= 2
    else:
        assert s.mv.brick == 0 and s.mv.tile
    assert abs(out["ate_rmse_cm_ro_only"] - ate_jax) < 0.1, (
        out["ate_rmse_cm_ro_only"], ate_jax)


def test_dense_volume_resume_round_trip(tmp_path):
    """A dense-volume run's resume.npz holds the volume as it is (dense
    [X, Y, Z]); a fresh pipeline loads it bitwise and continues."""
    cfg = _run_cfg(tmp_path / "a", brick_fusion=False)
    cfg["mapping"]["state_every"] = 4
    slam = RemixFusionTorch(copy.deepcopy(cfg), device="cpu")
    slam.run()
    path = tmp_path / "a" / "modes" / "resume.npz"
    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    assert data["mv_tsdf"].shape == slam.mv.dims
    cfg["data"]["output"] = str(tmp_path / "b")
    fresh = RemixFusionTorch(copy.deepcopy(cfg), device="cpu")
    fresh.load_state(str(path))
    for a, k in zip(fresh.mv.state[:3], ("mv_tsdf", "mv_weight",
                                         "mv_color")):
        assert np.array_equal(a.numpy(), data[k])
    out = fresh.run(resume=True)
    assert out["first_tracked"] == 5 and np.isfinite(out["ate_rmse_cm"])


SHIPPED = [("bench_triplane.yaml", {}), ("ab_triplane.yaml", {}),
           ("synthetic_fast.yaml", {}), ("synthetic_more.yaml", {}),
           ("corridor_v25g.yaml", {}),
           ("synthetic_bench.yaml", {"volume": {"brick_fusion": False}}),
           ("synthetic_bench.yaml", {"RO": {"eval_mode": "brick",
                                            "brick_radius": 3,
                                            "tsdf_interp": "trilinear"},
                                     "volume": {"sel_reuse": 2}})]


@pytest.mark.parametrize("name,over", SHIPPED,
                         ids=[f"{n}-{'-'.join(o) or 'as-shipped'}"
                              for n, o in SHIPPED])
def test_shipped_config_runs_on_cpu(name, over, tmp_path, monkeypatch):
    """Every shipped config this slice ports (and synthetic_bench.yaml with
    a dense volume, or brick mode at radius 3 with reused selections)
    builds RemixFusionTorch on the CPU with its own encoder, tracker mode
    and volume, and runs 6 frames end to end. Widths are cut to CPU size:
    a 64 x 48 camera, small PST tiers, 10 cm voxels, a 32^3 grid, a few
    map steps; the modes stay the config's."""
    import os

    from remixfusion_tpu_torch.config import load_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.chdir(root)
    cfg = load_config(os.path.join("configs", "Synthetic", name))
    for sec, vals in over.items():
        cfg[sec].update(vals)
    cfg["data"].update(output=str(tmp_path))
    cfg["data"]["synthetic"]["n_frames"] = 6
    cfg["cam"].update(H=48, W=64, fx=40.0, fy=40.0, cx=31.5, cy=23.5)
    cfg["RO"].update(PST_size=[256, 128, 64], particle_iter_lens=4,
                     depth_level=[4, 2, 1])
    cfg["mapping"].update(first_iters=5, iters=1, BA_iters=1, sample=64)
    cfg["globalV"]["base_resolution"] = 32
    cfg["volume"]["voxel_size"] = 0.1
    cfg["mesh"]["voxel_final"] = 0.2
    s = RemixFusionTorch(cfg, device="cpu")
    enc = cfg["grid"]["enc"].lower()
    assert type(s.scene.embed_res_fn).__name__.lower().startswith(enc)
    assert s.tracker.eval_mode == cfg["RO"]["eval_mode"]
    assert s.mv.version == cfg["volume"]["version"]
    assert bool(s.mv.brick) == cfg["volume"].get("brick_fusion", True)
    out = s.run()
    assert out["tracked_frames"] == 5
    assert np.isfinite(s.trajectory(6)).all()
    assert np.isfinite(out["ate_rmse_cm"]) and out["mesh_faces"] > 0
    if cfg["volume"].get("sel_reuse", 1) > 1:
        assert out["sel_reused"] > 0
