"""Port parity of the residual encoders the main path does not use
(Triplane, Frequency, SphericalHarmonics, DenseGrid, Identity), of the
factory's name matching, and of scenes built on them (one map step, one BA
step, the resume state of a scene without a field table) against the JAX
package on the CPU.

Same numpy inputs from a seed go through both packages; JAX parameters go
across with utils/convert. Tolerances, per test: forwards within 1e-6
(Triplane, DenseGrid, SH, Identity: the same float32 operations; XLA may
contract a multiply-add) and 2e-5 for Frequency (sin / cos of the same
float32 arguments, up to ~7e3 rad, from two libraries); table gradients
within 1e-5 of the largest entry (the scatter-adds sum in another order);
map and BA losses at rtol 1e-4 and their gradients within 1e-3 of the
largest entry, as tests/test_torch_mapping.py holds the CPGrid scene."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_config
from remixfusion_tpu.mapping.keyframe import DeviceKeyFrameStore as JStore
from remixfusion_tpu.models import encodings as jenc
from remixfusion_tpu_torch.mapping.keyframe import DeviceKeyFrameStore
from remixfusion_tpu_torch.mapping.mapper import Mapper, frozen
from remixfusion_tpu_torch.models import encodings as tenc
from remixfusion_tpu_torch.models.scene_rep import SceneRepresentation
from remixfusion_tpu_torch.utils.convert import load_scene_numpy, \
    scene_to_numpy
from test_torch_mapping import NUM_KF, _close_scaled, _jax_draws, \
    _rays_world, _systems, t

torch.set_num_threads(1)


def _points(n, seed, lo=-0.1, hi=1.1):
    """n points in [lo, hi]^3, with the unit cube's corners and faces
    (where a grid clips) among them."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    x[:8] = np.array([[i, j, k] for i in (0, 1) for j in (0, 1)
                      for k in (0, 1)], np.float32)
    x[8:11] = [[1.0, 0.5, 0.25], [0.5, 1.0, 0.0], [0.0, 0.3, 1.0]]
    return x


def _vjp(je, pj, x, g):
    """JAX forward, the parameter cotangent (None when parameter-free) and
    the input cotangent."""
    def f(p, xx):
        return je(p, xx)

    out, vjp = jax.vjp(f, pj, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(g))
    return out, gp, gx


def _check(je, te, pj, pt, x, g, fwd_tol, grad_tol=1e-5):
    out_j, gp_j, gx_j = jax.jit(lambda p: _vjp(je, p, x, g))(pj)
    out_j, gx_j = np.asarray(out_j), np.asarray(gx_j)
    xt = torch.tensor(x, requires_grad=True)
    out_t = te(pt, xt)
    assert out_t.shape == out_j.shape
    np.testing.assert_allclose(out_t.detach().numpy(), out_j, rtol=0,
                               atol=fwd_tol)
    if not out_t.requires_grad:  # a constant (SH degree 1)
        assert not gx_j.any()
        return
    (out_t * torch.tensor(g)).sum().backward()
    _close_scaled(gx_j, xt.grad, grad_tol)
    if isinstance(pt, dict):
        for k in pj:
            _close_scaled(gp_j[k], pt[k].grad, grad_tol)
    elif pt is not None:
        _close_scaled(gp_j, pt.grad, grad_tol)


def test_triplane_matches_jax():
    """Forward, table and input gradients of Triplane (3 levels of 4
    features, resolutions 8 / 14 / 24 here) against JAX, on points inside
    and outside the unit cube and on its faces (the clip to
    res - 1 - 1e-6, rounded to float32)."""
    je = jenc.TriplaneEncoding(3, 4, 8, 24)
    te = tenc.TriplaneEncoding(3, 4, 8, 24)
    assert te.resolutions == je.resolutions and te.out_dim == je.out_dim
    pj = je.init(jax.random.PRNGKey(0))
    pt = {k: torch.tensor(np.asarray(v), requires_grad=True)
          for k, v in pj.items()}
    x = _points(4000, 1)
    g = np.random.default_rng(2).normal(
        size=(len(x), je.out_dim)).astype(np.float32)
    _check(je, te, pj, pt, x, g, 1e-6)


def test_triplane_bench_resolutions_and_init():
    """bench_triplane.yaml's widths (desired min(200, 1024)): resolutions
    64 / 113 / 200; the port's init draws planes in +-1e-2 and lines in
    1 +- 1e-2 from a torch.Generator, the JAX shapes and keys."""
    je, _ = jenc.get_encoder("Triplane", desired_resolution=200)
    te, _ = tenc.get_encoder("Triplane", desired_resolution=200)
    assert te.resolutions == je.resolutions == [64, 113, 200]
    pj = je.init(jax.random.PRNGKey(0))
    pt = te.init(torch.Generator().manual_seed(0), "cpu")
    assert set(pt) == set(pj)
    for k in pj:
        assert tuple(pt[k].shape) == pj[k].shape
        lo, hi = (0.99, 1.01) if k.startswith("line") else (-0.01, 0.01)
        assert lo <= float(pt[k].min()) and float(pt[k].max()) <= hi


def test_frequency_matches_jax():
    """12 frequencies: (x * 2^k) * pi in JAX's order, then sin and cos; the
    arguments reach ~7e3 rad, where an ulp is ~5e-4 rad, so a different
    product order would move the features far more than the 2e-5 held."""
    je = jenc.FrequencyEncoding(12, 3)
    te = tenc.FrequencyEncoding(12, 3)
    x = _points(3000, 3)
    g = np.random.default_rng(4).normal(
        size=(len(x), je.out_dim)).astype(np.float32)
    _check(je, te, None, None, x, g, 2e-5, grad_tol=1e-4)


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_spherical_harmonics_matches_jax(degree):
    je = jenc.SphericalHarmonicsEncoding(degree)
    te = tenc.SphericalHarmonicsEncoding(degree)
    assert te.out_dim == je.out_dim == degree ** 2
    x = _points(2000, 5 + degree, 0.0, 1.0)
    g = np.random.default_rng(degree).normal(
        size=(len(x), je.out_dim)).astype(np.float32)
    _check(je, te, None, None, x, g, 1e-6)


def test_dense_grid_matches_jax():
    """DenseGrid at a tiny size (4 dense levels, base 4, desired 24): the
    same rows, resolutions and scales as JAX's (whose per_level_scale is
    set after construction), forward and table gradient (the port's
    hash_table_grad, its plain version on the CPU)."""
    je = jenc.DenseGridEncoding(4, 2, 4, 24)
    te = tenc.DenseGridEncoding(4, 2, 4, 24)
    assert not any(je.inner.hashed) and not any(te.hashed)
    assert te.resolutions == je.inner.resolutions
    assert te.table_size == je.inner.table_size
    assert te.per_level_scale == je.inner.per_level_scale
    pj = jax.random.normal(jax.random.PRNGKey(1),
                           (te.table_size, 2)) * 0.1
    pt = torch.tensor(np.asarray(pj), requires_grad=True)
    x = _points(3000, 6, 0.0, 1.0)
    g = np.random.default_rng(7).normal(
        size=(len(x), je.out_dim)).astype(np.float32)
    _check(je, te, pj, pt, x, g, 1e-6)


def test_identity_matches_jax():
    x = _points(100, 8)
    assert np.array_equal(
        tenc.IdentityEncoding(3)(None, torch.tensor(x)).numpy(),
        np.asarray(jenc.IdentityEncoding(3)(None, jnp.asarray(x))))


NAMES = ["HashGrid", "hash", "TiledGrid", "CPGrid", "cp", "Triplane",
         "DenseGrid", "HashDense", "Spherical", "SphericalHarmonics",
         "OneBlob", "blob", "Frequency", "freq", "Identity"]


@pytest.mark.parametrize("name", NAMES)
def test_get_encoder_matches_jax_names(name):
    """Every name tests/test_models.py uses, and names that two rules
    match (the first rule wins, as in JAX): the same encoder class and
    width."""
    kw = dict(log2_hashmap_size=12, desired_resolution=64, n_frequencies=6,
              degree=3, n_bins=8)
    je, dj = jenc.get_encoder(name, **kw)
    te, dt = tenc.get_encoder(name, **kw)
    assert type(te).__name__ == type(je).__name__ and dt == dj


def test_get_encoder_rejects_unknown_names():
    for pkg in (jenc, tenc):
        with pytest.raises(ValueError):
            pkg.get_encoder("Wavelet")


# ------------------------------------------------------------ scenes


_STATES = {}


def _mapping_state(enc, mirror=False):
    """test_torch_mapping's mapping round on a scene of encoder `enc`: a
    JAX scene with three keyframes in its grid and two in its store, with
    its bf16 query mirror or without (mirror), a fresh port copy, and the
    round's inputs."""
    if enc not in _STATES:
        cfg, ds, bound, js, params, buffers, jm, _, tm = _systems(
            grid={"enc": enc})
        K = jnp.asarray(ds.K())
        jstore = JStore(NUM_KF, ds.num_rays_to_save,
                        cfg["cam"]["depth_trunc"], 0)
        dirs = np.asarray(ds[0]["direction"], np.float32).reshape(-1, 3)
        poses = np.zeros((NUM_KF, 4, 4), np.float32)
        for slot, fid in enumerate((0, 2, 4)):
            f = ds[fid]
            buffers = jm.integrate_keyframe(
                buffers, jnp.asarray(f["depth"]), jnp.asarray(f["rgb"]), K,
                jnp.asarray(f["c2w"]), bound)
            buffers = buffers._replace(rba=js.rba.update_init_pose(
                buffers.rba, slot, jnp.asarray(f["c2w"])))
            poses[slot] = f["c2w"]
            if slot < 2:
                jstore.add_keyframe(fid, jnp.asarray(f["depth"]),
                                    jnp.asarray(f["rgb"]),
                                    jnp.asarray(dirs),
                                    jax.random.PRNGKey(slot))
        buffers = buffers._replace(gbv_tm=None, gbw_tm=None)
        _STATES[enc] = dict(
            cfg=cfg, bound=bound, js=js, params=params, buffers=buffers,
            jm=jm, jstore=jstore, dirs=dirs, poses=poses,
            dep=ds[4]["depth"], rgb=ds[4]["rgb"],
            n_cur=tm.current_ray_budget(2))
    s = dict(_STATES[enc])
    if not mirror:
        s["buffers"] = s["buffers"]._replace(gbq=None)
    ts = SceneRepresentation(s["cfg"], s["bound"], NUM_KF)
    load_scene_numpy(ts, jax.tree_util.tree_map(np.asarray, s["params"]),
                     jax.tree_util.tree_map(np.asarray, s["buffers"]))
    tstore = DeviceKeyFrameStore(NUM_KF, s["jstore"].R,
                                 s["cfg"]["cam"]["depth_trunc"], "cpu")
    tstore.rays = t(s["jstore"].rays)
    tstore.frame_ids = list(s["jstore"].frame_ids)
    s.update(ts=ts, tm=Mapper(s["cfg"], ts), tstore=tstore,
             params=jax.tree_util.tree_map(jnp.copy, s["params"]))
    return s


@pytest.mark.parametrize("mirror", [False, True], ids=["f32", "gbq"])
@pytest.mark.parametrize("enc", ["Triplane", "Frequency"])
def test_map_step_matches_jax(enc, mirror):
    """One map step of a Triplane scene and of a Frequency scene (no field
    table: the map optimizer's field group is empty) against JAX: the
    gradients of the same objective at the same draws, then the step's
    loss against JAX's own step from the same key; with the bf16 query
    mirror on both sides (JAX's default buffers) and without."""
    s = _mapping_state(enc, mirror)
    assert (s["ts"].gbq is None) == (s["buffers"].gbq is None) == (
        not mirror)
    cfg, js, jm, ts, tm = s["cfg"], s["js"], s["jm"], s["ts"], s["tm"]
    params, buffers = s["params"], s["buffers"]
    assert (params.hash_table is None) == (enc == "Frequency")
    assert (ts.field_parameters() == []) == (enc == "Frequency")
    assert tm.map_opt.param_groups[0]["params"] == ts.field_parameters()
    key = jax.random.PRNGKey(21)
    n_kf, R = len(s["jstore"]), s["jstore"].R
    draw, (l1, l2) = _jax_draws(cfg, key, n_kf, R, s["dirs"].shape[0],
                                s["n_cur"], smooth=True)
    cur_pose = js.rba(params.rba, buffers.rba, jnp.asarray([2]))[0]
    poses_all = jnp.asarray(s["poses"]).at[2].set(cur_pose)
    rays, ids = tm.sample_batch(
        s["tstore"], n_kf, t(s["dirs"]), t(s["rgb"]).reshape(-1, 3),
        t(s["dep"]).reshape(-1), 2, s["n_cur"], draw)
    rays_j, ids_j = jnp.asarray(rays.numpy()), jnp.asarray(ids.numpy())

    @jax.jit
    def jloss(p):
        per_ray = poses_all[ids_j]
        rays_d = jnp.einsum("ni,nji->nj", rays_j[:, :3], per_ray[:, :3, :3],
                            precision=jax.lax.Precision.HIGHEST)
        ret = js.mapping_losses(p, buffers, l1, per_ray[:, :3, 3], rays_d,
                                rays_j[:, 3:6], rays_j[:, 6:7])
        return jm._weighted_loss(ret, True, p, buffers, l2)

    lj, gj = jax.value_and_grad(jloss)(params)
    tm.map_loss(rays, *_rays_world(rays, ids, s["poses"], ts),
                draw).backward()
    if enc == "Triplane":
        for k, p in ts.hash_table.items():
            _close_scaled(gj.hash_table[k], p.grad, 1e-3)
    for net in ("sdf_net", "color_net"):
        for i, lin in enumerate(getattr(ts.decoder_res, net).layers):
            _close_scaled(np.asarray(gj.decoder[net][f"w{i}"]).T,
                          lin.weight.grad, 1e-3)
    losses = tm.map_step_dev(s["tstore"], n_kf, t(s["dirs"]), t(s["dep"]),
                             t(s["rgb"]), t(s["poses"]), 2, 1, s["n_cur"],
                             draws=[draw])
    np.testing.assert_allclose(float(losses[0]), float(lj), rtol=1e-4)
    _, jlosses = jm.map_step_dev(
        params, buffers, s["jstore"], n_kf, jnp.asarray(s["dirs"]),
        jnp.asarray(s["dep"]), jnp.asarray(s["rgb"]), s["poses"], 2, key, 1,
        s["n_cur"])
    np.testing.assert_allclose(float(losses[0]), float(jlosses[0]),
                               rtol=1e-4)


@pytest.mark.parametrize("enc", ["Triplane", "Frequency"])
def test_ba_step_matches_jax(enc):
    """One BA step of the same scenes: the RBA gradients of the JAX
    objective, the step's loss against JAX's own step, the field frozen."""
    s = _mapping_state(enc)
    cfg, js, jm, ts, tm = s["cfg"], s["js"], s["jm"], s["ts"], s["tm"]
    params, buffers = s["params"], s["buffers"]
    key = jax.random.PRNGKey(31)
    n_kf, R = len(s["jstore"]), s["jstore"].R
    draw, (l1, l2) = _jax_draws(cfg, key, n_kf, R, s["dirs"].shape[0],
                                s["n_cur"], smooth=False)
    rays, ids = tm.sample_batch(
        s["tstore"], n_kf, t(s["dirs"]), t(s["rgb"]).reshape(-1, 3),
        t(s["dep"]).reshape(-1), 2, s["n_cur"], draw)
    rays_j, ids_j = jnp.asarray(rays.numpy()), jnp.asarray(ids.numpy())

    @jax.jit
    def jloss(rba):
        p = params._replace(rba=rba)
        per_ray = js.rba(rba, buffers.rba, jnp.arange(NUM_KF))[ids_j]
        rays_d = jnp.einsum("ni,nji->nj", rays_j[:, :3], per_ray[:, :3, :3],
                            precision=jax.lax.Precision.HIGHEST)
        ret = js.mapping_losses(p, buffers, l1, per_ray[:, :3, 3], rays_d,
                                rays_j[:, 3:6], rays_j[:, 6:7], clamp=True)
        return jm._weighted_loss(ret, False, p, buffers, l2)

    lj, gj = jax.value_and_grad(jloss)(params.rba)
    with frozen(ts.field_parameters() + ts.decoder_parameters()):
        tm.ba_loss(rays, ids, draw).backward()
    for i, lin in enumerate(ts.rba.mlp.layers):
        _close_scaled(np.asarray(gj[f"w{i}"]).T, lin.weight.grad, 1e-3)
        _close_scaled(np.asarray(gj[f"b{i}"]), lin.bias.grad, 1e-3)
    before = [p.detach().clone() for p in ts.field_parameters()]
    losses, poses = tm.ba_step_dev(
        s["tstore"], n_kf, t(s["dirs"]), t(s["dep"]), t(s["rgb"]), 2, 1,
        s["n_cur"], draws=[draw])
    np.testing.assert_allclose(float(losses[0]), float(lj), rtol=1e-4)
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 ts.field_parameters()))
    _, jlosses, jposes = jm.ba_step_dev(
        params, buffers, s["jstore"], n_kf, jnp.asarray(s["dirs"]),
        jnp.asarray(s["dep"]), jnp.asarray(s["rgb"]), 2, key, 1, s["n_cur"])
    np.testing.assert_allclose(float(losses[0]), float(jlosses[0]),
                               rtol=1e-4)
    assert np.abs(poses.numpy() - np.asarray(jposes)).max() < 2e-3


@pytest.mark.parametrize("enc", ["Triplane", "Frequency"])
def test_converter_round_trips_tables(enc):
    """scene_to_numpy / load_scene_numpy carry Triplane's plane_<l>_<a> /
    line_<l>_<a> dict and Frequency's None table across bitwise."""
    s = _mapping_state(enc)
    p2, _ = scene_to_numpy(s["ts"])
    jp = jax.tree_util.tree_map(np.asarray, s["params"])
    if enc == "Frequency":
        assert p2["hash_table"] is None and jp.hash_table is None
    else:
        assert set(p2["hash_table"]) == set(jp.hash_table)
        for k, v in jp.hash_table.items():
            assert np.array_equal(p2["hash_table"][k], v)
    other = SceneRepresentation(s["cfg"], s["bound"], NUM_KF)
    load_scene_numpy(other, p2, scene_to_numpy(s["ts"])[1])
    for a, b in zip(other.parameters(), s["ts"].parameters()):
        assert torch.equal(a, b)


def test_frequency_scene_resume_round_trip(tmp_path):
    """A tiny Frequency run saves resume.npz (no field table: the field
    group of the map optimizer is empty, the decoders' Adam slots start at
    0) and a fresh pipeline loads it bitwise, then continues to the end."""
    from remixfusion_tpu_torch.slam import RemixFusionTorch

    cfg = tiny_config(grid={"enc": "Frequency"},
                      RO={"eval_mode": "pallas", "depth_level": [4, 2, 1]},
                      mapping={"state_every": 6})
    cfg["data"]["output"] = str(tmp_path / "a")
    cfg["data"]["synthetic"]["n_frames"] = 9
    slam = RemixFusionTorch(copy.deepcopy(cfg), device="cpu")
    slam.run()
    path = tmp_path / "a" / "test" / "resume.npz"
    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    assert "map_opt_state_0_exp_avg" in data
    n_dec = len(slam.scene.decoder_parameters())
    assert f"map_opt_state_{n_dec - 1}_exp_avg" in data
    assert f"map_opt_state_{n_dec}_exp_avg" not in data
    cfg["data"]["output"] = str(tmp_path / "b")
    fresh = RemixFusionTorch(copy.deepcopy(cfg), device="cpu")
    fresh.load_state(str(path))
    got = fresh.state_arrays()
    for k, v in data.items():
        if v.dtype.kind != "U":
            assert np.array_equal(got[k], v), k
    out = fresh.run(resume=True)
    assert out["first_tracked"] == 7 and np.isfinite(out["ate_rmse_cm"])
