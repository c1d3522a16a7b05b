"""The explicit grid's bf16 query mirror (`gbq`) of the port against the
JAX package's default buffers on the CPU, at tests/helpers.tiny_config
sizes.

  - the mirror itself, after three keyframes through the dense sweep (R 48)
    and the frustum-tiled path (R 144, the smallest grid of this camera
    whose selections stay under the whole grid), and after
    reset_global_volume. JAX's oct-packed rows are mapped to cells with
    gbq_row_index: corner k of row i is cell i + offset k. Rounded from
    the same grid (the JAX grid converted), the port's mirror is JAX's
    bitwise at every corner. Rounded from the port's own grid, it is the
    rounding of that grid (refreshed after each integrate), equal to JAX's
    wherever the two grids hold the same bits; where the grids differ (the
    tsdf within 1e-5, test_torch_mapping.py) by at most one bf16 step
    beside that 1e-5;
  - the hot query (query_gbq, query_color_sdf with and without clamp) on a
    scene converted from JAX's default buffers: query_gbq within 2.4e-7
    (XLA:CPU contracts the blend's multiply-adds into fused multiply-adds:
    the largest difference seen is 1.2e-7, one float32 step at 1.0), the
    joint query within 1e-6; the float32 read is off by more than 1e-4;
  - load_state and load_ckpt rebuild the mirror bitwise the uninterrupted
    run's, and neither file holds it;
  - several mapping rounds in lockstep, each parameter set trained on its
    own side from one start: a keyframe integrated (the mirror refreshed
    on both sides, or absent on both), two map steps and one BA step on
    JAX's draws, the keyframe stored. Every step's loss at rtol 1e-4 of
    JAX's and the last BA poses within 2e-3, as the one-step lockstep
    tests (test_torch_mapping.py), so that a mirror refreshed at another
    point than JAX's, or a gap that grows with the rounds, would show.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_config
from remixfusion_tpu.datasets import get_dataset
from remixfusion_tpu.mapping.keyframe import DeviceKeyFrameStore as JStore
from remixfusion_tpu.mapping.mapper import Mapper as JMapper
from remixfusion_tpu.models.scene_rep import SceneRepresentation as JScene
from remixfusion_tpu.ops import tsdf as jtsdf
from remixfusion_tpu_torch.mapping.keyframe import DeviceKeyFrameStore
from remixfusion_tpu_torch.mapping.mapper import Mapper
from remixfusion_tpu_torch.models.scene_rep import CORNERS, \
    SceneRepresentation
from remixfusion_tpu_torch.slam import RemixFusionTorch
from remixfusion_tpu_torch.utils.convert import load_scene_numpy, \
    scene_from_numpy
from test_torch_mapping import _jax_draws

torch.set_num_threads(1)
NUM_KF = 8
QUERY_TOL = 2.4e-7
JOINT_TOL = 1e-6


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bits(mirror: torch.Tensor) -> np.ndarray:
    return mirror.view(torch.int16).numpy().view(np.uint16)


_BUILT = {}


def _fused(R):
    """Both packages after keyframes 0, 2 and 4 (integrate_keyframe with
    the host selection); built once per R. Returns (cfg, bound, JAX scene,
    params, dense buffers, mapper, the port scene, its mapper, whether
    JAX took the tiled path)."""
    if R not in _BUILT:
        cfg = tiny_config(globalV={"base_resolution": R})
        ds = get_dataset(cfg)
        bound = np.asarray(cfg["mapping"]["bound"], np.float32)
        js = JScene(cfg, bound, NUM_KF)
        params, buffers = js.init(jax.random.PRNGKey(0))
        jm = JMapper(cfg, js, params)
        ts = SceneRepresentation(cfg, bound, NUM_KF)
        tm = Mapper(cfg, ts)
        K = ds.K()
        tiled = False
        for kfi, i in enumerate((0, 2, 4)):
            f = ds[i]
            c2w = np.asarray(f["c2w"], np.float32)
            buffers = jm.integrate_keyframe(
                buffers, jnp.asarray(f["depth"]), jnp.asarray(f["rgb"]),
                jnp.asarray(K), jnp.asarray(c2w), bound,
                host_depth=f["depth"], host_c2w=c2w, kf_index=kfi)
            tiled |= buffers.gbv_tm is not None
            tm.integrate_keyframe(t(f["depth"]), t(f["rgb"]), t(K), t(c2w),
                                  t(bound), host_depth=f["depth"],
                                  host_c2w=c2w, K_np=K, kf_index=kfi)
        buffers = jm.ensure_dense(buffers)._replace(gbv_tm=None, gbw_tm=None)
        _BUILT[R] = (cfg, bound, js, params, buffers, jm, ts, tm, tiled)
    return _BUILT[R]


def _jax_corners(gbq, R, tile):
    """JAX's mirror rows as cells: for corner k = (dx, dy, dz), the bits
    [R - dx, R - dy, R - dz, 4] that the row of cell (x, y, z) holds for
    cell (x + dx, y + dy, z + dz) (the corners past the grid's edge, which
    no query reads, left out)."""
    rows = np.asarray(gbq).view(np.uint16)
    out = []
    for k, (dx, dy, dz) in enumerate(CORNERS):
        x, y, z = np.meshgrid(np.arange(R - dx), np.arange(R - dy),
                              np.arange(R - dz), indexing="ij")
        idx = np.asarray(jtsdf.gbq_row_index(R, tile, x, y, z))
        out.append(rows[idx, 4 * k:4 * k + 4])
    return out


def _values(bits):
    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16) \
        .float().numpy()


def _check_mirror(mirror_bits, corners, exact=None):
    """Every corner of JAX's rows against the port's mirror bits [R, R, R,
    4]: bitwise, or, where `exact` (bool [R, R, R, 4]: the grids hold the
    same bits) is False, within one bf16 step (2^-7 of the larger
    magnitude) plus the grids' own 1e-5. Returns the count of entries that
    differ."""
    n = 0
    for (dx, dy, dz), want in zip(CORNERS, corners):
        got = mirror_bits[dx:, dy:, dz:]
        diff = got != want
        if exact is None:
            assert not diff.any()
            continue
        assert not (diff & exact[dx:, dy:, dz:]).any()
        a, b = _values(got[diff]), _values(want[diff])
        assert (np.abs(a - b)
                <= 2.0 ** -7 * np.maximum(np.abs(a), np.abs(b)) + 1e-5).all()
        n += int(diff.sum())
    return n


@pytest.mark.parametrize("case", ["dense", "tiled", "reset"])
def test_mirror_matches_jax(case):
    R = 144 if case == "tiled" else 48
    cfg, bound, js, params, buffers, jm, ts, tm, tiled = _fused(R)
    assert tiled == (case == "tiled")
    if case == "reset":
        ts = copy.deepcopy(ts)
        Mapper(cfg, ts).reset_global_volume()
        buffers = jm.reset_global_volume(buffers)
    assert ts.gbq.dtype == torch.bfloat16
    assert torch.equal(ts.gbq, ts.gbv.to(torch.bfloat16))
    corners = _jax_corners(buffers.gbq, R, js.gbq_tile)
    # the mirror rounded from JAX's own grid: bitwise everywhere
    conv = SceneRepresentation(cfg, bound, NUM_KF)
    load_scene_numpy(conv, _np_tree(params), _np_tree(buffers))
    _check_mirror(_bits(conv.gbq), corners)
    # the port's own mirror, rounded from its own grid
    jv = np.asarray(buffers.gbv)
    exact = ts.gbv.numpy().view(np.uint32) == jv.view(np.uint32)
    n = _check_mirror(_bits(ts.gbq), corners, exact)
    if case == "reset":
        assert exact.all() and n == 0
        assert (_bits(ts.gbq)[..., 0] == 0x3F80).all()  # 1.0
    else:
        assert int((np.asarray(buffers.gbw) > 0).sum()) > 0.01 * R ** 3
        assert n <= 1e-3 * ts.gbq.numel()


@pytest.mark.parametrize("clamp", [False, True])
def test_hot_query_matches_jax(clamp):
    cfg, bound, js, params, buffers, jm, ts, tm, _ = _fused(48)
    # decoders with weights large enough to matter (the zero-init output
    # layers would hide the residual)
    params = params._replace(decoder=jax.tree_util.tree_map(
        lambda w: w * 1e3 if w.shape[-1] <= 16 else w, params.decoder))
    scene = scene_from_numpy(cfg, bound, NUM_KF, _np_tree(params),
                             _np_tree(buffers))
    assert scene.gbq is not None
    pts = np.random.default_rng(3).uniform(-0.05, 1.05, (4000, 3)).astype(
        np.float32)
    ref_q, ref_f32, ref = (np.asarray(a) for a in jax.jit(lambda p: (
        js.query_gbvw_fast(buffers, p), js.query_gbv(buffers.gbv, p),
        js.query_color_sdf(params, buffers, p, clamp=clamp)))(
            jnp.asarray(pts)))
    with torch.no_grad():
        got_q = scene.query_gbq(t(pts)).numpy()
        got = scene.query_color_sdf(t(pts), clamp=clamp).numpy()
        got_f32 = scene.query_gbv(t(pts)).numpy()
    assert np.abs(got_q - ref_q).max() <= QUERY_TOL, np.abs(
        got_q - ref_q).max()
    assert np.abs(got - ref).max() <= JOINT_TOL, np.abs(got - ref).max()
    # the float32 read (what query_color_sdf read before the mirror)
    assert np.abs(got_f32 - ref_q).max() > 1e-4
    np.testing.assert_allclose(got_f32, ref_f32, atol=1e-6)
    # without a mirror on both sides the hot query is the float32 read
    scene.gbq = None
    with torch.no_grad():
        np.testing.assert_array_equal(scene.query_gbq(t(pts)).numpy(),
                                      got_f32)


def _resume_cfg(tmp, exp):
    return tiny_config(
        data={"output": str(tmp), "exp_name": exp,
              "synthetic": {"n_frames": 8, "orbit_degrees": 25.0}},
        mapping={"first_iters": 4, "iters": 1, "BA_iters": 1, "sample": 64,
                 "keyframe_every": 2, "map_every": 2},
        mesh={"vis": 0, "voxel_final": 0.2})


@pytest.mark.parametrize("kind", ["state", "ckpt"])
def test_load_rebuilds_the_mirror(tmp_path, kind):
    slam = RemixFusionTorch(_resume_cfg(tmp_path, "a"), device="cpu")
    slam.first_frame_mapping()
    for idx in range(1, 5):
        slam.step(idx, slam.dataset.num_frames)
    path = str(tmp_path / f"{kind}.npz")
    getattr(slam, f"save_{kind}")(path)
    with np.load(path) as f:
        assert not any("gbq" in k for k in f.files)
    fresh = RemixFusionTorch(_resume_cfg(tmp_path, "b"), device="cpu")
    assert fresh.scene.gbq is None
    getattr(fresh, f"load_{kind}")(path)
    assert torch.equal(slam.scene.gbq, slam.scene.gbv.to(torch.bfloat16))
    assert fresh.scene.gbq.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(fresh.scene.gbq),
                                  _bits(slam.scene.gbq))


LOCKSTEP_FRAMES = (0, 2, 4, 6, 8)


@pytest.mark.parametrize("mirror", [False, True], ids=["f32", "gbq"])
def test_mapping_rounds_lockstep_matches_jax(mirror):
    cfg = tiny_config()
    ds = get_dataset(cfg)
    bound = np.asarray(cfg["mapping"]["bound"], np.float32)
    js = JScene(cfg, bound, NUM_KF)
    params, buffers = js.init(jax.random.PRNGKey(0))
    jm = JMapper(cfg, js, params)
    ts = scene_from_numpy(cfg, bound, NUM_KF, _np_tree(params),
                          _np_tree(buffers._replace(gbq=None)))
    tm = Mapper(cfg, ts)
    R = ds.num_rays_to_save
    jstore = JStore(NUM_KF, R, cfg["cam"]["depth_trunc"], 0)
    tstore = DeviceKeyFrameStore(NUM_KF, R, cfg["cam"]["depth_trunc"],
                                 "cpu")
    K = ds.K()
    dirs = np.asarray(ds[0]["direction"], np.float32).reshape(-1, 3)
    poses = np.zeros((NUM_KF, 4, 4), np.float32)
    gaps = []
    for slot, fid in enumerate(LOCKSTEP_FRAMES):
        f = ds[fid]
        c2w = np.asarray(f["c2w"], np.float32)
        buffers = jm.integrate_keyframe(
            buffers, jnp.asarray(f["depth"]), jnp.asarray(f["rgb"]),
            jnp.asarray(K), jnp.asarray(c2w), bound)
        tm.integrate_keyframe(t(f["depth"]), t(f["rgb"]), t(K), t(c2w),
                              t(bound))
        if not mirror:
            buffers = buffers._replace(gbq=None)
            ts.gbq = None
        assert (ts.gbq is None) == (buffers.gbq is None) == (not mirror)
        buffers = buffers._replace(rba=js.rba.update_init_pose(
            buffers.rba, slot, jnp.asarray(c2w)))
        ts.rba.update_init_pose(slot, t(c2w))
        poses[slot] = c2w
        n_kf = len(jstore)
        if n_kf:
            n_cur = tm.current_ray_budget(n_kf)
            args = (jnp.asarray(dirs), jnp.asarray(f["depth"]),
                    jnp.asarray(f["rgb"]))
            targs = (t(dirs), t(f["depth"]), t(f["rgb"]))
            for i in range(2):
                key = jax.random.PRNGKey(100 * slot + i)
                params, lj = jm.map_step_dev(params, buffers, jstore, n_kf,
                                             *args, poses, slot, key, 1,
                                             n_cur)
                lt = tm.map_step_dev(tstore, n_kf, *targs, t(poses), slot,
                                     1, n_cur, draws=[_jax_draws(
                                         cfg, key, n_kf, R, dirs.shape[0],
                                         n_cur, True)[0]])
                gaps.append((f"map {fid}.{i}", float(lt[0]), float(lj[0])))
            key = jax.random.PRNGKey(100 * slot + 50)
            params, lj, jposes = jm.ba_step_dev(params, buffers, jstore,
                                                n_kf, *args, slot, key, 1,
                                                n_cur)
            lt, tposes = tm.ba_step_dev(tstore, n_kf, *targs, slot, 1, n_cur,
                                        draws=[_jax_draws(
                                            cfg, key, n_kf, R, dirs.shape[0],
                                            n_cur, False)[0]])
            gaps.append((f"BA {fid}", float(lt[0]), float(lj[0])))
        jstore.add_keyframe(fid, jnp.asarray(f["depth"]),
                            jnp.asarray(f["rgb"]), jnp.asarray(dirs),
                            jax.random.PRNGKey(slot))
        tstore.rays = t(jstore.rays)
        tstore.frame_ids = list(jstore.frame_ids)
    rel = [(name, abs(a - b) / abs(b)) for name, a, b in gaps]
    assert max(r for _, r in rel) <= 1e-4, rel
    d_pose = np.abs(tposes.numpy() - np.asarray(jposes)).max()
    assert d_pose < 2e-3, d_pose
