"""Port parity of the mapping half (remixfusion_tpu_torch.mapping and the
global-grid ops of ops/tsdf.py) against the JAX package on the CPU, on
tests/helpers.tiny_config sizes.

  - the global integrate's tile selection, bit for bit, with and without
    the gfs_every free-space rotation, and the dense-sweep fallback;
  - the integrated grid, tiled and dense (weights bit for bit, the tsdf
    within 1e-5, colors bit for bit but at a pixel-boundary voxel);
  - the keyframe ray store, with the JAX side's draws injected;
  - one map step and one BA step in lockstep: the same draws, the loss at
    rtol 1e-4 and the gradients within 1e-3 of the largest entry;
  - one Adam update from a shared gradient (optax against torch.optim.Adam,
    eps 1e-15 on the tables) within 1e-6 relative;
  - a whole tiny run of both pipelines (HashGrid, 15 frames, 2 mapping
    rounds): the full ATE (after BA) within a band.

The map-step and BA-step lockstep cases run twice: with JAX's default
buffers, whose hot query reads the bf16 query mirror (gbq), against a port
scene converted from them (which then holds its own mirror), and with the
mirror absent on both sides (gbq=None), where both read the float32 grid."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from helpers import tiny_config
from remixfusion_tpu.datasets import get_dataset
from remixfusion_tpu.mapping.keyframe import DeviceKeyFrameStore as JStore
from remixfusion_tpu.mapping.mapper import Mapper as JMapper
from remixfusion_tpu.models.scene_rep import SceneRepresentation as JScene
from remixfusion_tpu.ops import tsdf as jtsdf
from remixfusion_tpu.slam import RemixFusionTPU
from remixfusion_tpu.tools.eval_ate import evaluate_ate
from remixfusion_tpu_torch.mapping.keyframe import DeviceKeyFrameStore
from remixfusion_tpu_torch.mapping.mapper import Mapper, frozen, \
    rays_world
from remixfusion_tpu_torch.models.scene_rep import SceneRepresentation
from remixfusion_tpu_torch.ops import tsdf as tsdf_ops
from remixfusion_tpu_torch.slam import RemixFusionTorch
from remixfusion_tpu_torch.utils.convert import load_scene_numpy

torch.set_num_threads(1)
NUM_KF = 8
CAM = {"H": 120, "W": 160, "fx": 100.0, "fy": 100.0, "cx": 79.5,
       "cy": 59.5}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _systems(**over):
    cfg = tiny_config(**over)
    ds = get_dataset(cfg)
    bound = np.asarray(cfg["mapping"]["bound"], np.float32)
    js = JScene(cfg, bound, NUM_KF)
    params, buffers = js.init(jax.random.PRNGKey(0))
    jm = JMapper(cfg, js, params)
    ts = SceneRepresentation(cfg, bound, NUM_KF)
    tm = Mapper(cfg, ts)
    return cfg, ds, bound, js, params, buffers, jm, ts, tm


@pytest.mark.parametrize("R,gfs", [(200, 1), (200, 4), (48, 4)])
def test_integrate_tile_selection_matches_jax(R, gfs):
    cfg, ds, bound, js, params, buffers, jm, ts, tm = _systems(
        globalV={"base_resolution": R}, mapping={"gfs_every": gfs},
        cam=CAM, training={"c_trunc": 0.1})
    rotated = 0
    for i in (0, 4, 8):
        f = ds[i]
        for kfi in (None, 1, 2):
            ref = jm.select_integrate_tiles(
                f["depth"], np.asarray(f["c2w"]), ds.K(), bound, ds.H, ds.W,
                kf_index=kfi)
            got = tm.select_integrate_tiles(
                f["depth"], np.asarray(f["c2w"]), ds.K(), bound, ds.H, ds.W,
                kf_index=kfi)
            if ref[0] is None:
                assert got is None
                continue
            n = int((ref[0][:, 0] >= 0).sum())
            np.testing.assert_array_equal(got, ref[0][:n])
            if kfi is not None:
                full = tm.select_integrate_tiles(
                    f["depth"], np.asarray(f["c2w"]), ds.K(), bound, ds.H,
                    ds.W)
                rotated += len(full) - len(got)
    if R == 48:  # 8 tiles: every bucket reaches the grid -> dense sweep
        assert ref[0] is None
    else:
        assert (rotated > 0) == (gfs > 1)


@pytest.mark.parametrize("R", [200, 48])
def test_integrated_grid_matches_jax(R):
    """Keyframes fused in turn (free-space rotation on). R=200 takes the
    tiled path: the JAX side runs integrate_keyframe's tiled integrator
    on its own selection, without the bf16 query mirror the mapper also
    refreshes (a TPU layout of ~0.5 GB at this size); R=48 takes the dense
    sweep through integrate_keyframe itself.

    Weights are held bit for bit. The tsdf within 1e-5: XLA:CPU contracts
    the voxel-ray norms into fused multiply-adds and rounds a few square
    roots differently, ~1 ulp of the distance before the 1/trunc scale.
    Colors bit for bit at all but 1e-5 of the updated voxels: a
    free-space voxel projecting onto a pixel boundary can take its
    neighbour's color in one package."""
    cfg, ds, bound, js, params, buffers, jm, ts, tm = _systems(
        globalV={"base_resolution": R}, mapping={"gfs_every": 4},
        cam=CAM, training={"c_trunc": 0.1})
    K = ds.K()
    gbv, gbw = buffers.gbv, buffers.gbw
    tile = jtsdf.pick_global_tile(R)
    for kfi, i in enumerate((0, 4) if R == 200 else (0, 4, 8)):
        f = ds[i]
        c2w = np.asarray(f["c2w"], np.float32)
        sel = jm.select_integrate_tiles(f["depth"], c2w, K, bound, ds.H,
                                        ds.W, kf_index=kfi)
        if R == 200:
            integ = jtsdf.make_global_tiled_integrator(
                R, tile, sel[1], im_h=ds.H, im_w=ds.W, trunc_margin=0.1)
            gbv, gbw = integ(
                gbv, gbw, jnp.asarray(sel[0]), jnp.asarray(f["depth"]),
                jnp.asarray(f["rgb"]), jnp.asarray(K), jnp.asarray(c2w),
                jnp.asarray(bound), jnp.asarray(1.0, jnp.float32))
        else:
            assert sel[0] is None
            buffers = jm.integrate_keyframe(
                buffers, jnp.asarray(f["depth"]), jnp.asarray(f["rgb"]),
                jnp.asarray(K), jnp.asarray(c2w), bound,
                host_depth=f["depth"], host_c2w=c2w, kf_index=kfi)
            gbv, gbw = buffers.gbv, buffers.gbw
        tm.integrate_keyframe(t(f["depth"]), t(f["rgb"]), t(K), t(c2w),
                              t(bound), host_depth=f["depth"], host_c2w=c2w,
                              K_np=K, kf_index=kfi)
    gbv, gbw = np.asarray(gbv), np.asarray(gbw)
    updated = int((gbw > 0).sum())
    assert updated > 0.01 * gbw.size
    np.testing.assert_array_equal(ts.gbw.numpy(), gbw)
    d = np.abs(ts.gbv.numpy() - gbv)
    assert d[..., 0].max() <= 1e-5
    assert (d[..., 1:].max(-1) > 1e-6).sum() <= 1e-5 * updated


@pytest.mark.parametrize("filtered,trunc", [(False, 100.0), (True, 3.0),
                                            (True, 0.5)])
def test_keyframe_store_matches_jax(filtered, trunc):
    cfg = tiny_config(cam={"depth_trunc": trunc})
    ds = get_dataset(cfg)
    R = ds.num_rays_to_save
    js = JStore(4, R, trunc, 0)
    ts = DeviceKeyFrameStore(4, R, trunc, "cpu")
    dirs = np.asarray(ds[0]["direction"], np.float32).reshape(-1, 3)
    for slot, fid in enumerate((0, 2, 4)):
        f = ds[fid]
        key = jax.random.PRNGKey(100 + slot)
        js.add_keyframe(fid, jnp.asarray(f["depth"]), jnp.asarray(f["rgb"]),
                        jnp.asarray(dirs), key, filter_depth=filtered)
        k1, k2 = jax.random.split(key)
        depth = f["depth"].reshape(-1)
        cnt = int(((depth > 0) & (depth <= trunc)).sum())
        draws = (torch.from_numpy(np.array(jax.random.randint(
            k1, (R,), 0, depth.shape[0]))).long(),
            torch.from_numpy(np.array(jax.random.randint(
                k2, (R,), 1, max(cnt, 1) + 1))).long())
        ts.add_keyframe(fid, t(f["depth"]), t(f["rgb"]), t(dirs),
                        filter_depth=filtered, draws=draws)
    assert ts.frame_ids == js.frame_ids
    np.testing.assert_array_equal(ts.rays.numpy(), np.asarray(js.rays))


_STATE = {}


def _mapping_state(mirror=False):
    """A JAX scene with three keyframes in its grid and two in its store
    (built once per module; the JAX steps get copies, as they donate their
    inputs), with its bf16 query mirror or without (mirror), a fresh port
    copy, and the round's inputs."""
    if not _STATE:
        _STATE.update(_build_mapping_state())
    s = dict(_STATE)
    if not mirror:
        s["buffers"] = s["buffers"]._replace(gbq=None)
    ts = SceneRepresentation(s["cfg"], s["bound"], NUM_KF)
    load_scene_numpy(ts, _np_tree(s["params"]), _np_tree(s["buffers"]))
    tstore = DeviceKeyFrameStore(NUM_KF, s["jstore"].R,
                                 s["cfg"]["cam"]["depth_trunc"], "cpu")
    tstore.rays = t(s["jstore"].rays)
    tstore.frame_ids = list(s["jstore"].frame_ids)
    s.update(ts=ts, tm=Mapper(s["cfg"], ts), tstore=tstore,
             params=jax.tree_util.tree_map(jnp.copy, s["params"]))
    return s


def _build_mapping_state():
    cfg, ds, bound, js, params, buffers, jm, ts, tm = _systems()
    K = jnp.asarray(ds.K())
    R = ds.num_rays_to_save
    jstore = JStore(NUM_KF, R, cfg["cam"]["depth_trunc"], 0)
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
                                jnp.asarray(f["rgb"]), jnp.asarray(dirs),
                                jax.random.PRNGKey(slot))
    buffers = buffers._replace(gbv_tm=None, gbw_tm=None)
    cur = ds[4]
    return dict(cfg=cfg, ds=ds, bound=bound, js=js, params=params,
                buffers=buffers, jm=jm, jstore=jstore, dirs=dirs,
                poses=poses, dep=cur["depth"], rgb=cur["rgb"], cur_kf_id=2,
                n_cur=tm.current_ray_budget(2))


def _jax_draws(cfg, key, n_kf, R, HW, n_cur, smooth):
    """The draws of iteration 0 of a JAX map/BA step with `key`."""
    sample = cfg["mapping"]["sample"]
    S = cfg["training"]["n_range_d"] + cfg["training"]["n_samples_d"]
    ks, kl = jax.random.split(jax.random.split(key, 1)[0])
    k1, k2 = jax.random.split(ks)
    l1, l2 = jax.random.split(kl)
    draw = {"g_idx": jax.random.randint(k1, (sample,), 0, max(n_kf, 1) * R),
            "c_idx": jax.random.randint(k2, (n_cur,), 0, HW),
            "z_u": jax.random.uniform(l1, (sample + n_cur, S))}
    draw = {k: torch.from_numpy(np.asarray(v)) for k, v in draw.items()}
    draw["g_idx"], draw["c_idx"] = draw["g_idx"].long(), draw["c_idx"].long()
    if smooth:
        a, b = jax.random.split(l2)
        draw["smooth_u"] = (t(jax.random.uniform(a, (3,))), t(np.asarray(
            jax.random.uniform(b, (1, 1, 1, 3))).reshape(3)))
    return draw, (l1, l2)


def _close_scaled(ref, got, frac):
    ref, got = np.asarray(ref), np.asarray(got)
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(ref - got).max() <= frac * scale, (
        np.abs(ref - got).max(), scale)


@pytest.mark.parametrize("mirror", [False, True], ids=["f32", "gbq"])
def test_map_step_lockstep_matches_jax(mirror):
    s = _mapping_state(mirror)
    assert (s["ts"].gbq is None) == (s["buffers"].gbq is None) == (
        not mirror)
    cfg, js, jm, ts, tm = s["cfg"], s["js"], s["jm"], s["ts"], s["tm"]
    params, buffers = s["params"], s["buffers"]
    key = jax.random.PRNGKey(21)
    n_kf, R = len(s["jstore"]), s["jstore"].R
    draw, (l1, l2) = _jax_draws(cfg, key, n_kf, R, s["dirs"].shape[0],
                                s["n_cur"], smooth=True)
    # the JAX map-step objective on those draws (mapper.py:426-436)
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
    # the port's gradients of the same objective at the same point
    tm.map_loss(rays, *_rays_world(rays, ids, s["poses"], ts),
                draw).backward()
    _close_scaled(gj.hash_table, ts.hash_table.grad, 1e-3)
    for net in ("sdf_net", "color_net"):
        for i, lin in enumerate(getattr(ts.decoder_res, net).layers):
            _close_scaled(np.asarray(gj.decoder[net][f"w{i}"]).T,
                          lin.weight.grad, 1e-3)
    losses = tm.map_step_dev(s["tstore"], n_kf, t(s["dirs"]), t(s["dep"]),
                             t(s["rgb"]), t(s["poses"]), 2, 1, s["n_cur"],
                             draws=[draw])
    np.testing.assert_allclose(float(losses[0]), float(lj), rtol=1e-4)
    # the JAX step itself draws the same numbers from `key`
    _, jlosses = jm.map_step_dev(
        params, buffers, s["jstore"], n_kf, jnp.asarray(s["dirs"]),
        jnp.asarray(s["dep"]), jnp.asarray(s["rgb"]), s["poses"], 2, key, 1,
        s["n_cur"])
    np.testing.assert_allclose(float(losses[0]), float(jlosses[0]),
                               rtol=1e-4)


def _rays_world(rays, ids, kf_poses, ts):
    """World rays of a map-step batch: the stored keyframe poses, the
    current keyframe's from the RBA network."""
    with torch.no_grad():
        poses = t(kf_poses)
        poses[2] = ts.rba(torch.tensor([2]))[0]
    return rays_world(rays[:, :3], poses[ids])


@pytest.mark.parametrize("mirror", [False, True], ids=["f32", "gbq"])
def test_ba_step_lockstep_matches_jax(mirror):
    s = _mapping_state(mirror)
    assert (s["ts"].gbq is None) == (s["buffers"].gbq is None) == (
        not mirror)
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
    # the port's gradients at the same point: RBA only
    with frozen(ts.field_parameters() + ts.decoder_parameters()):
        tm.ba_loss(rays, ids, draw).backward()
    assert ts.hash_table.grad is None
    for i, lin in enumerate(ts.rba.mlp.layers):
        _close_scaled(np.asarray(gj[f"w{i}"]).T, lin.weight.grad, 1e-3)
        _close_scaled(np.asarray(gj[f"b{i}"]), lin.bias.grad, 1e-3)
    with torch.no_grad():
        table_before = ts.hash_table.clone()
    losses, poses = tm.ba_step_dev(
        s["tstore"], n_kf, t(s["dirs"]), t(s["dep"]), t(s["rgb"]), 2, 1,
        s["n_cur"], draws=[draw])
    np.testing.assert_allclose(float(losses[0]), float(lj), rtol=1e-4)
    assert torch.equal(ts.hash_table, table_before)
    assert ts.hash_table.requires_grad
    _, jlosses, jposes = jm.ba_step_dev(
        params, buffers, s["jstore"], n_kf, jnp.asarray(s["dirs"]),
        jnp.asarray(s["dep"]), jnp.asarray(s["rgb"]), 2, key, 1, s["n_cur"])
    np.testing.assert_allclose(float(losses[0]), float(jlosses[0]),
                               rtol=1e-4)
    # one Adam step moves every RBA weight by about lr; the poses agree to
    # a band, not to the bits (a near-zero gradient's sign is noise)
    assert np.abs(poses.numpy() - np.asarray(jposes)).max() < 2e-3


def test_adam_update_matches_optax():
    """One update of each optimizer from the same gradient: torch.optim.Adam
    groups against the optax chains (eps 1e-15 on the table, weight decay
    1e-6 on the decoders and the RBA network). The parameters' change must
    agree within 1e-6 of its largest entry (optax rounds its bias
    corrections in float32; torch keeps them in double), plus the
    rounding of the parameters themselves."""
    cfg, ds, bound, js, params, buffers, jm, ts, tm = _systems()
    load_scene_numpy(ts, _np_tree(params), _np_tree(buffers))
    rng = np.random.default_rng(8)
    # gradients spanning many magnitudes, some exactly zero
    grads = jax.tree_util.tree_map(
        lambda a: jnp.asarray((rng.standard_normal(a.shape)
                               * 10.0 ** rng.uniform(-8, 0, a.shape)
                               * (rng.random(a.shape) > 0.1)
                               ).astype(np.float32)), params)
    up, _ = jm.map_tx.update(grads, jm.map_tx.init(params), params)
    jp = optax.apply_updates(params, up)
    up, _ = jm.rba_tx.update(grads, jm.rba_tx.init(params), jp)
    jp = optax.apply_updates(jp, up)
    for p, g in _pairs(ts, grads):
        p.grad = t(g)
    tm.map_opt.step()
    tm.rba_opt.step()
    for (p, new), (_, old) in zip(_pairs(ts, jp), _pairs(ts, params)):
        new, old = np.asarray(new), np.asarray(old)
        tol = (1e-6 * np.abs(new.astype(np.float64) - old).max()
               + 2 * np.spacing(np.abs(new).max()))
        assert np.abs(p.detach().numpy() - new).max() <= tol


def _pairs(ts, tree):
    """(port parameter, JAX leaf in the port's layout)."""
    yield ts.hash_table, tree.hash_table
    for net in ("sdf_net", "color_net"):
        for i, lin in enumerate(getattr(ts.decoder_res, net).layers):
            yield lin.weight, np.asarray(tree.decoder[net][f"w{i}"]).T
    for i, lin in enumerate(ts.rba.mlp.layers):
        yield lin.weight, np.asarray(tree.rba[f"w{i}"]).T
        yield lin.bias, tree.rba[f"b{i}"]


N_RUN = 15


def _run_cfg(tmp):
    return tiny_config(
        data={"output": str(tmp), "exp_name": "map",
              "synthetic": {"n_frames": N_RUN, "orbit_degrees": 25.0}},
        RO={"particle_iter_lens": 8, "depth_level": [4, 2, 1],
            "eval_mode": "pallas", "PST_size": [256, 128, 128],
            "init_size": 0.02, "count_search": 100,
            "tsdf_interp": "trilinear"},
        volume={"voxel_size": 0.025},
        mapping={"first_iters": 15, "iters": 2, "BA_iters": 2,
                 "keyframe_every": 5, "map_every": 5, "sample": 128})


def test_whole_run_full_ate_matches_jax(tmp_path):
    """Both pipelines free-running: first-frame mapping, tracking, two
    mapping rounds (frames 5 and 10), the one-round-late BA write-back.
    Measured on a CPU: full ATE 0.600 cm (port) against 0.560 cm (JAX),
    RO-only 0.557 against 0.546; the band is 0.25 cm, as tracking is
    chaotic in float32 (tests/test_torch_pipeline.py)."""
    cfg = _run_cfg(tmp_path / "jax")
    j = RemixFusionTPU(copy.deepcopy(cfg))
    j.first_frame_mapping()

    def due():
        while j.tracking_idx > j.mapping_idx + 5:
            if j.mapping_idx + 5 >= N_RUN:
                break
            j.mapping_round(j.mapping_idx + 5)

    for i in range(1, N_RUN):
        j.track_frame(i, j._get_frame(i))
        due()
    j._harvest_pending_track()
    due()
    j._apply_pending_ba()
    poses_j = j.convert_relative_pose_npy()
    gt = j.pose_gt
    ate_j = 100 * evaluate_ate(
        {float(i): gt[i] for i in range(N_RUN)},
        {float(i): poses_j[i] for i in range(N_RUN)})["rmse"]
    j.close()

    s = RemixFusionTorch(_run_cfg(tmp_path / "port"), device="cpu")
    out = s.run()
    assert out["mapping_rounds"] == 2 and out["map_iters"] == 15 + 2 * 2
    assert out["first_frame_loss"][1] < out["first_frame_loss"][0]
    poses = np.load(tmp_path / "port" / "map" / "all_poses.npy")
    assert poses.shape == (N_RUN, 4, 4) and np.isfinite(poses).all()
    assert (tmp_path / "port" / "map" / "tracking_result.txt").exists()
    # BA moved the keyframes off their tracked poses
    assert not np.array_equal(poses[5], s.RO_c2w_data[5])
    assert abs(out["ate_rmse_cm"] - ate_j) < 0.25, (out["ate_rmse_cm"], ate_j)


def test_final_iters_run_store_only_map_steps(tmp_path):
    """mapping.final_iters adds ceil(final_iters / iters) map calls of
    `iters` steps each at finalize, on the keyframe store alone."""
    cfg = _run_cfg(tmp_path)
    cfg["data"]["synthetic"]["n_frames"] = 8
    cfg["mapping"].update(first_iters=2, keyframe_every=2, map_every=2,
                          final_iters=3)
    s = RemixFusionTorch(cfg, device="cpu")
    out = s.run()
    rounds = out["mapping_rounds"]
    assert rounds > 0
    assert out["map_iters"] == 2 + 2 * rounds + 2 * 2
    assert np.isfinite(np.load(tmp_path / "map" / "all_poses.npy")).all()
