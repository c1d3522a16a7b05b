"""The port's scale-out path (remixfusion_tpu_torch.parallel, the tracker's
group= option) against the JAX package's parallel/sharding.py on the
virtual CPU mesh, and against the port's own single-process path.

One gloo world of D ranks on the CPU per D in {2, 4} (a module-scoped
fixture; tests/sharding_ranks.py runs every case on every rank and imports
no JAX), at tests/helpers.tiny_config sizes. The cases mirror
tests/test_sharding.py:

  - the data-parallel map step (SGD lr 1e-2, the same parameters, rays and
    stratified draw) against JAX's sharded_map_train_step at n_dev = D: the
    loss at rtol 1e-4, the parameters at rtol 2e-3 / atol 2e-5 (JAX's own
    tolerance); and within 1e-6 of the port's single-process step. A step
    moves the hash table by far less than those tolerances, so each leaf's
    update is also held against the reference's, relative to its largest
    entry (1e-3 of it against JAX, 1e-4 against the single process);
  - the slab-sharded fusion of 3 frames against JAX's sharded_fuse_frame
    (weights atol 1e-5, grid atol 1e-4) and bitwise against the port's
    integrate_global;
  - candidate-sharded tracking against JAX's ROTracker(mesh=make_mesh(D))
    in the pallas, gather and brick modes (the pose within 1e-5), the
    gathered costs (at a search size where the low-count guard rejects
    some candidates) within 1e-6 of the port's single-process costs, with
    the same guards; with RO.sample_range != 0 and the ray-shift generator
    seeded otherwise on every rank, every rank's pose bitwise the one the
    single process gets from rank 0's seed;
  - the same data-parallel step on the fused grid with its bf16 query
    mirror (gbq), against JAX's sharded step on those buffers (the mirror
    packed from the grid) and the port's single process, at the same
    tolerances, with SGD at lr FUSED_LR: on this grid the hash table's
    gradient is ~1e-7, and at lr 1e-2 its update would sit at the float32
    spacing of its entries (~7e-12), where the update check would read the
    rounding of the parameters rather than the step;
  - the grid-sharded step: the slab query bitwise the single-process query,
    the update against the JAX single-device step at the lockstep tests'
    tolerance (1e-3 of the largest entry), the loss at rtol 1e-4; once on
    the float32 slabs against JAX with gbq=None, once on the slabs' bf16
    mirror (sharded_fuse_pack_gbq: the concatenated mirrors bitwise the
    single-process rounding, the mirror query bitwise the single-process
    one) against JAX with its mirror, at lr FUSED_LR as above;
  - the interleaved track -> sharded fuse -> DP map dataflow against the
    port's single-process dataflow, with test_sharding.py's
    test_interleaved_track_map_dataflow_sharded tolerances;
  - a world of one rank equal to group=None; ValueError on N % D, C % D and
    a tile budget overflow; the host helpers bitwise against JAX.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sharding_ranks
from helpers import tiny_config
from remixfusion_tpu.mapping.mapper import _pack_gbq
from remixfusion_tpu.ops import tsdf as jtsdf
from remixfusion_tpu.parallel import sharding as jsh
from remixfusion_tpu.tracking.rotracker import ROTracker as JaxTracker
from remixfusion_tpu.tracking.volume import MovingVolume as JaxVolume
from remixfusion_tpu_torch.models.scene_rep import SceneRepresentation
from remixfusion_tpu_torch.ops import tsdf as tsdf_ops
from remixfusion_tpu_torch.parallel import dryrun, sharding
from remixfusion_tpu_torch.parallel.launch import spawn
from remixfusion_tpu_torch.tracking.rotracker import ROTracker
from remixfusion_tpu_torch.utils.convert import volume_state_from_numpy
from test_sharding import BOUND, _scene_and_data

torch.set_num_threads(1)
WORLD_TIMEOUT_S = 240
FUSE_FRAMES = (1, 2, 3)
FLOW_FRAMES = 7
PST = [256, 128, 128]
FUSED_LR = 1.0


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _track_cfg(mode):
    cfg = tiny_config(RO={"eval_mode": mode, "PST_size": PST})
    if mode == "brick":  # the JAX tracker reads the float32 volume here
        cfg["volume"]["track_dtype"] = "float32"
    return cfg


_INPUTS = {}


def _inputs():
    """The shared inputs (numpy and plain dicts only: the ranks load no
    JAX), built once."""
    if _INPUTS:
        return _INPUTS
    (cfg, scene, params, buffers, rays, rays_o, rays_d, lw,
     ds) = _scene_and_data()
    S = cfg["training"]["n_range_d"] + cfg["training"]["n_samples_d"]
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(7),
                                      (rays.shape[0], S)))
    K = jnp.asarray(ds.K())
    mv = JaxVolume(cfg, np.asarray(ds[0]["c2w"], np.float32))
    for i in range(3):
        f = ds[i]
        mv.integrate(f["rgb"], f["depth"], K,
                     np.asarray(f["c2w"], np.float32), rgb_is_unit=True,
                     full_sweep=True)
    st = _np(mv.state)
    # the batch's sample points, for the slab query
    ref = SceneRepresentation(cfg, BOUND, 8)
    z = ref.sample_z_vals(t(rays[:, 6:7]), u=t(u))
    pts = ref.normalize((t(rays_o)[:, None] + t(rays_d)[:, None]
                         * z[..., None]).reshape(-1, 3)).numpy()
    _INPUTS.update(
        cfg=cfg, R=int(cfg["globalV"]["base_resolution"]), bound=BOUND,
        lw=lw, rays=rays, rays_o=rays_o, rays_d=rays_d, u=u,
        params={"hash_table": np.asarray(params.hash_table),
                "decoder": _np(params.decoder), "rba": _np(params.rba)},
        buffers={"gbv": np.asarray(buffers.gbv),
                 "gbw": np.asarray(buffers.gbw),
                 "rba": dict(_np(buffers.rba)._asdict())},
        fuse_frames=FUSE_FRAMES, H=ds.H, W=ds.W, K=ds.K(),
        volume={"tsdf": st.tsdf, "weight": st.weight, "color": st.color,
                "origin": st.origin, "dims": mv.dims,
                "voxel_size": mv.voxel_size, "layout": mv.brick_layout()},
        track_cfg={m: _track_cfg(m) for m in sharding_ranks.MODES},
        track_c2w=np.asarray(ds[2]["c2w"], np.float32),
        track_depth=np.asarray(ds[3]["depth"], np.float32),
        odd_pst=[256, 128, 65], query_pts=pts,
        shift_cfg=tiny_config(RO={"eval_mode": "pallas", "PST_size": PST,
                                  "sample_range": 0.1}),
        flow_cfg=tiny_config(), flow_frames=FLOW_FRAMES,
        jax_mv=mv, jax_scene=scene, jax_params=params, jax_buffers=buffers,
        ds=ds)
    # the JAX single-device grid after FUSE_FRAMES, with the values of its
    # bf16 query mirror (the port scene packs its own from gbv)
    jv, jw = _jax_fused(_INPUTS)
    _INPUTS["jax_fused"] = (jv, jw)
    _INPUTS["fused_buffers"] = dict(
        _INPUTS["buffers"], gbv=jv, gbw=jw,
        gbq=np.asarray(jnp.asarray(jv).astype(jnp.bfloat16), np.float32))
    _INPUTS["fused_lr"] = FUSED_LR
    return _INPUTS


def _rank_inputs(inp):
    return {k: v for k, v in inp.items() if not k.startswith("jax_")
            and k != "ds"}


@pytest.fixture(scope="module", params=[2, 4], ids=lambda d: f"D{d}")
def world(request, tmp_path_factory):
    """(D, inputs, every rank's results) of one gloo world of D ranks."""
    D = request.param
    inp = _inputs()
    rdv = tmp_path_factory.mktemp(f"world{D}") / "rendezvous"
    res = spawn(sharding_ranks.run_cases, D, backend="gloo", device="cpu",
                init_file=str(rdv), timeout_s=WORLD_TIMEOUT_S,
                args=(_rank_inputs(inp),))
    return D, inp, res


def _leaves(port, ref):
    """(port, JAX) leaf pairs of a JAX-layout parameter tree."""
    pairs = [(port["hash_table"], ref.hash_table)]
    for net in ("sdf_net", "color_net"):
        for k in sorted(ref.decoder[net]):
            pairs.append((port["decoder"][net][k], ref.decoder[net][k]))
    for k in sorted(ref.rba):
        pairs.append((port["rba"][k], ref.rba[k]))
    return [(np.asarray(a), np.asarray(b)) for a, b in pairs]


def _flat(tree):
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _flat(tree[k])]
    return [np.asarray(tree)]


def _close_updates(got, want, start, rel):
    """Every leaf's update from `start` (lists of leaves in one order: the
    port's got, the reference's want) within `rel` of the largest entry of
    the reference's update of that leaf."""
    assert len(got) == len(want) == len(start)
    for a, b, p in zip(got, want, start):
        upd, ref = a - p, b - p
        scale = max(np.abs(ref).max(), 1e-30)
        assert np.abs(upd - ref).max() <= rel * scale, (
            np.abs(upd - ref).max() / scale, rel)


def _jax_weighted(ret, lw):
    return (lw[0] * ret["rgb_res_loss"] + lw[1] * ret["depth_res_loss"]
            + lw[2] * ret["sdf_res_loss"] + lw[3] * ret["fs_res_loss"])


def test_ranks_import_no_jax(world):
    D, _, res = world
    assert len(res) == D
    assert all(r["jax_modules"] == [] for r in res)


def _jax_buffers(inp, mirror):
    """The JAX buffers of the initial grid (mirror False), or of the fused
    grid with its bf16 query mirror."""
    if not mirror:
        return inp["jax_buffers"]
    jv, jw = (jnp.asarray(a) for a in inp["jax_fused"])
    return inp["jax_buffers"]._replace(gbv=jv, gbw=jw, gbq=_pack_gbq(jv))


@pytest.mark.parametrize("mirror", [False, True], ids=["f32", "gbq"])
def test_dp_step_matches_jax_and_single_process(world, mirror):
    D, inp, res = world
    key = "dp_gbq" if mirror else "dp"
    tx = optax.sgd(FUSED_LR if mirror else 1e-2)
    params = inp["jax_params"]
    step = jsh.sharded_map_train_step(inp["jax_scene"], tx, jsh.make_mesh(D),
                                      inp["lw"])
    pj, _, lj = step(jax.tree_util.tree_map(lambda x: x.copy(), params),
                     _jax_buffers(inp, mirror), tx.init(params),
                     jnp.asarray(inp["rays"]), jnp.asarray(inp["rays_o"]),
                     jnp.asarray(inp["rays_d"]), jax.random.PRNGKey(7))
    loss, got = res[0][key]
    np.testing.assert_allclose(loss, float(lj), rtol=1e-4)
    pairs = _leaves(got, pj)
    for a, b in pairs:
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-5)
    _close_updates([a for a, _ in pairs], [b for _, b in pairs],
                   [p for p, _ in _leaves(inp["params"], params)], 1e-3)
    # lockstep: every rank holds the same parameters and loss
    for r in res[1:]:
        assert r[key][0] == loss
        assert all(np.array_equal(a, b) for a, b in
                   zip(_flat(r[key][1]), _flat(got)))
    # the port's single-process step
    loss1, single = res[0][f"{key}_none"]
    np.testing.assert_allclose(loss, loss1, rtol=1e-6)
    for a, b in zip(_flat(got), _flat(single)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    _close_updates(_flat(got), _flat(single), _flat(inp["params"]), 1e-4)


def _jax_fused(inp, D=None):
    """The JAX grid after FUSE_FRAMES: sharded over make_mesh(D), or the
    single-device fuse_frame."""
    cfg, ds, R = inp["cfg"], inp["ds"], inp["R"]
    trunc = cfg["training"]["c_trunc"]
    gbv = np.zeros((R, R, R, 4), np.float32)
    gbv[..., 0] = 1.0
    gv, gw = jnp.asarray(gbv), jnp.zeros((R, R, R), jnp.float32)
    K, bound = jnp.asarray(ds.K()), jnp.asarray(BOUND)
    fuse = (None if D is None
            else jsh.sharded_fuse_frame(jsh.make_mesh(D), R, trunc, ds.H,
                                        ds.W))
    for i in FUSE_FRAMES:
        f = ds[i]
        dep, rgb = jnp.asarray(f["depth"]), jnp.asarray(f["rgb"])
        c2w = jnp.asarray(np.asarray(f["c2w"], np.float32))
        if fuse is not None:
            gv, gw = fuse(gv, gw, dep, rgb, K, c2w, bound)
            continue
        out = jtsdf.fuse_frame(
            jtsdf.VolumeState(tsdf=gv[..., 0], weight=gw, color=gv[..., 1:],
                              origin=bound[:, 0]),
            dep, rgb, K, c2w, voxel_size=1.0 / R, trunc_margin=trunc,
            obs_weight=1.0, im_h=ds.H, im_w=ds.W, global_mode=True,
            scale=bound[:, 1] - bound[:, 0], voxel_size_is_normalized=True)
        gv = jnp.concatenate([out.tsdf[..., None], out.color], -1)
        gw = out.weight
    return np.asarray(gv), np.asarray(gw)


def _port_fused(inp):
    cfg, ds, R = inp["cfg"], inp["ds"], inp["R"]
    gbv = torch.zeros((R, R, R, 4))
    gbv[..., 0] = 1.0
    gbw = torch.zeros((R, R, R))
    for i in FUSE_FRAMES:
        f = ds[i]
        tsdf_ops.integrate_global(
            gbv, gbw, t(f["depth"]), t(f["rgb"]), t(ds.K()), t(f["c2w"]),
            t(BOUND), trunc_margin=cfg["training"]["c_trunc"])
    return gbv, gbw


def test_sharded_fusion_matches_jax_and_integrate_global(world):
    D, inp, res = world
    bounds = [r["fuse"][0] for r in res]
    R = inp["R"]
    ref = torch.tensor_split(torch.arange(R), D)
    assert bounds == [(int(a[0]), int(a[-1]) + 1) for a in ref]
    gv = np.concatenate([r["fuse"][1] for r in res])
    gw = np.concatenate([r["fuse"][2] for r in res])
    pv, pw = _port_fused(inp)
    assert np.array_equal(gv, pv.numpy()) and np.array_equal(gw, pw.numpy())
    jv, jw = _jax_fused(inp, D)
    np.testing.assert_allclose(gw, jw, atol=1e-5)
    np.testing.assert_allclose(gv, jv, atol=1e-4)
    assert (gw > 0).sum() > 1000


def _jax_track(inp, mode, D):
    cfg, mv = copy.deepcopy(inp["track_cfg"][mode]), inp["jax_mv"]
    ds = inp["ds"]
    qpack = ((mv.brick, mv.dims[1] // mv.brick, mv.dims[2] // mv.brick)
             if mode == "pallas" else None)
    tr = JaxTracker(cfg, ds.H, ds.W, ds.K(), mv.dims, mv.voxel_size,
                    brick_layout=mv.brick_layout(), mesh=jsh.make_mesh(D),
                    qpack_bm=qpack)
    res = tr.do_tracking(mv.state, jnp.asarray(inp["track_c2w"]),
                         jnp.asarray(inp["track_depth"]),
                         jax.random.PRNGKey(3), tr.init_search_size())
    return np.asarray(res.c2w)


def _port_single_costs(inp, mode):
    cfg, vol = inp["track_cfg"][mode], inp["volume"]
    state = volume_state_from_numpy(vol["tsdf"], vol["weight"], vol["color"],
                                    vol["origin"], "cpu")
    tr = ROTracker(copy.deepcopy(cfg), inp["H"], inp["W"], inp["K"],
                   vol["dims"], vol["voxel_size"], vol["layout"], "cpu")
    c2w, depth = t(inp["track_c2w"]), t(inp["track_depth"])
    vn = tr.vertex_normal_maps(depth)
    view = tr.track_view(state.tsdf)
    ss = tr.init_search_size() * sharding_ranks.GUARD_SEARCH
    costs = [tr.score_tier(cls, 0, tr.class_level[cls], 0, c2w[:3, :3],
                           c2w[:3, 3], ss, vn, view, state.origin).numpy()
             for cls in range(3)]
    return tr.do_tracking(state, c2w, depth).c2w.numpy(), costs


@pytest.mark.parametrize("mode", sharding_ranks.MODES)
def test_candidate_sharded_tracking_matches_jax(world, mode):
    D, inp, res = world
    pose, costs = res[0][f"track_{mode}"]
    for r in res[1:]:
        assert np.array_equal(r[f"track_{mode}"][0], pose)
        assert all(np.array_equal(a, b) for a, b in
                   zip(r[f"track_{mode}"][1], costs))
    single_pose, single = _port_single_costs(inp, mode)
    # the low-count guard rejects some candidates, on every rank's slice
    guarded = np.concatenate(single) >= 1e6
    assert 0 < guarded.sum() < guarded.size
    for got, ref in zip(costs, single):
        assert got.shape == ref.shape
        assert np.array_equal(got >= 1e6, ref >= 1e6)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(pose, single_pose, atol=1e-5)
    np.testing.assert_allclose(pose, _jax_track(inp, mode, D), atol=1e-5)


@pytest.mark.parametrize("mirror", [False, True], ids=["f32", "gbq"])
def test_gridsharded_step_matches_jax(world, mirror):
    D, inp, res = world
    key = "grid_gbq" if mirror else "grid"
    cfg, ds = inp["cfg"], inp["ds"]
    pv, _ = _port_fused(inp)
    ref = SceneRepresentation(cfg, BOUND, 8)
    with torch.no_grad():
        ref.gbv.copy_(pv)
    pts = t(inp["query_pts"])
    query = np.concatenate([r["query"] for r in res])
    assert np.array_equal(query, ref.query_gbv(pts).numpy())
    f32, hot = (np.concatenate([r[f"query_{key}"][i] for r in res])
                for i in (0, 1))
    assert np.array_equal(f32, query)
    if mirror:
        assert all(r["fuse_gbq_bitwise"] for r in res)
        gbq = np.concatenate([r["fuse_gbq"] for r in res])
        assert np.array_equal(
            gbq, pv.to(torch.bfloat16).float().numpy())
        ref.refresh_gbq()
        assert np.array_equal(hot, ref.query_gbq(pts).numpy())
        assert not np.array_equal(hot, query)
    else:
        assert np.array_equal(hot, query)

    # JAX single device on its own fused grid, with its mirror or without
    jv, jw = inp["jax_fused"]
    buffers = inp["jax_buffers"]._replace(
        gbv=jnp.asarray(jv), gbw=jnp.asarray(jw),
        gbq=_pack_gbq(jnp.asarray(jv)) if mirror else None)
    params, lw, js = inp["jax_params"], inp["lw"], inp["jax_scene"]

    def loss_fn(p):
        ret = js.mapping_losses(
            p, buffers, jax.random.PRNGKey(7), jnp.asarray(inp["rays_o"]),
            jnp.asarray(inp["rays_d"]), jnp.asarray(inp["rays"][:, 3:6]),
            jnp.asarray(inp["rays"][:, 6:7]))
        return _jax_weighted(ret, lw)

    lj, gj = jax.jit(jax.value_and_grad(loss_fn))(params)
    lr = FUSED_LR if mirror else 1e-2
    pj = jax.tree_util.tree_map(lambda p, g: p - lr * g, params, gj)
    loss, got, holds_no_grid = res[0][key]
    assert holds_no_grid
    np.testing.assert_allclose(loss, float(lj), rtol=1e-4)
    pairs = _leaves(got, pj)
    _close_updates([a for a, _ in pairs], [b for _, b in pairs],
                   [p for p, _ in _leaves(inp["params"], params)], 1e-3)
    for r in res[1:]:
        assert all(np.array_equal(a, b) for a, b in
                   zip(_flat(r[key][1]), _flat(got)))


def test_tracker_ray_shift_in_lockstep(world):
    """RO.sample_range != 0, each rank's shift generator seeded otherwise:
    every rank tracks with rank 0's draw, which is the single-process pose
    from rank 0's seed (and not the pose from another seed)."""
    D, inp, res = world
    poses = [r["shift"] for r in res]
    assert all(np.array_equal(p, poses[0]) for p in poses[1:])
    seed = sharding_ranks.SHIFT_SEED
    single = sharding_ranks.shifted_pose(inp, None, seed)
    np.testing.assert_allclose(poses[0], single, rtol=0, atol=1e-6)
    other = sharding_ranks.shifted_pose(inp, None, seed + 1)
    assert np.abs(other - single).max() > 1e-4


def test_interleaved_dataflow_matches_single_process(world):
    D, inp, res = world
    single = dryrun.interleaved_dataflow(
        None, inp["flow_cfg"], FLOW_FRAMES, map_every=2, n_rays=128,
        device="cpu")
    flow = [r["dataflow"] for r in res]
    gv = np.concatenate([f["gbv"] for f in flow])
    gw = np.concatenate([f["gbw"] for f in flow])
    np.testing.assert_allclose(flow[0]["poses"], single["poses"], atol=1e-5)
    np.testing.assert_allclose(gw, single["gbw"], atol=1e-5)
    np.testing.assert_allclose(gv, single["gbv"], atol=1e-4)
    assert len(flow[0]["losses"]) == len(single["losses"]) == 3
    for k, v in single["params"].items():
        np.testing.assert_allclose(flow[0]["params"][k], v, rtol=5e-3,
                                   atol=5e-5)
    for f in flow[1:]:
        assert np.array_equal(f["poses"], flow[0]["poses"])


def test_world_of_one_equals_no_group(world):
    """A rank's singleton group gives group=None's bits: the map step and
    the tracker in every mode."""
    _, _, res = world
    for r in res:
        (l1, p1), (l0, p0) = r["dp_solo"], r["dp_none"]
        assert l1 == l0
        assert all(np.array_equal(a, b) for a, b in zip(_flat(p1),
                                                        _flat(p0)))
        for mode in sharding_ranks.MODES:
            (q1, c1), (q0, c0) = (r[f"track_{mode}_solo"],
                                  r[f"track_{mode}_none"])
            assert np.array_equal(q1, q0)
            assert all(np.array_equal(a, b) for a, b in zip(c1, c0))


def test_value_errors(world):
    D, _, res = world
    for r in res:
        assert r["n_error"] and f"over {D} ranks" in r["n_error"]
        assert r["c_error"] and "65 candidates" in r["c_error"]
    offs = np.zeros((5, 3), np.int32)
    with pytest.raises(ValueError, match="budget"):
        sharding.partition_tiles_by_device(offs, 64, 8, D, 4)
    with pytest.raises(ValueError, match="budget"):
        jsh.partition_tiles_by_device(offs, 64, 8, D, 4)


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_host_helpers_match_jax(n_dev):
    """partition_tiles_by_device (the idempotent padding included) and
    pad_rows_for_mesh, bitwise; slab_bounds against torch.tensor_split."""
    rng = np.random.default_rng(n_dev)
    R, tile = 64, 8
    T = R // tile
    tiles = np.unique(rng.integers(0, T, (12, 3)), axis=0) * tile
    for offs in (tiles.astype(np.int32), np.zeros((0, 3), np.int32)):
        got = sharding.partition_tiles_by_device(offs, R, tile, n_dev, 16)
        ref = jsh.partition_tiles_by_device(offs, R, tile, n_dev, 16)
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
    for rows in (5, 8, 13):
        a = rng.standard_normal((rows, 3)).astype(np.float32)
        got = sharding.pad_rows_for_mesh(torch.from_numpy(a), n_dev)
        ref = np.asarray(jsh.pad_rows_for_mesh(jnp.asarray(a), n_dev))
        assert np.array_equal(got.numpy(), ref)
    for R in (7, 48, 200):
        if R < n_dev:
            continue
        split = torch.tensor_split(torch.arange(R), n_dev)
        assert [sharding.slab_bounds(R, n_dev, r) for r in range(n_dev)] \
            == [(int(s[0]), int(s[-1]) + 1) for s in split]


def test_rendezvous_file_is_fresh(tmp_path):
    path = tmp_path / "rendezvous"
    path.write_text("")
    with pytest.raises(ValueError, match="exists"):
        spawn(sharding_ranks.run_cases, 2, backend="gloo", device="cpu",
              init_file=str(path), args=({},))
    assert os.path.exists(path)


def test_spawn_returns_results_by_value_and_raises_a_failed_rank(tmp_path):
    """Results (tensors too) arrive after their ranks exited; a rank's
    exception is raised in the caller with its traceback, and the world's
    other ranks are stopped."""
    res = spawn(sharding_ranks.tensor_of_rank, 2, backend="gloo",
                device="cpu", init_file=str(tmp_path / "a"), timeout_s=60)
    assert [float(r[0]) for r in res] == [0.0, 1.0]
    assert all(r.shape == (1000,) for r in res)
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed") as e:
        spawn(sharding_ranks.fail_on_last, 2, backend="gloo", device="cpu",
              init_file=str(tmp_path / "b"), timeout_s=60)
    assert "ValueError: rank 1 stops here" in str(e.value)


def test_spawn_raises_the_failure_that_a_dead_rank_died_of(tmp_path):
    """Rank 0 exits hard right after rank 1 raised, and rank 1's report
    comes RACE_DELAY_S later: the caller still raises rank 1's failure with
    its traceback, not the dead rank's exit."""
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed") as e:
        spawn(sharding_ranks.fail_late_on_last, 2, backend="gloo",
              device="cpu", init_file=str(tmp_path / "b"), timeout_s=60,
              args=(str(tmp_path / "raised"),))
    assert "ValueError: rank 1 stops here" in str(e.value)
