"""Port parity for the whole slice: RemixFusionTorch (tracking + local
fusion, device='cpu') against the JAX RemixFusionTPU driven frame by frame
through track_frame (no mapping rounds: they never feed the RO chain), on
tiny_config with eval_mode 'pallas' and tracking.harvest_depth 1.

Two views of the same 8-frame run:
  - lockstep (nearest and trilinear lookups): before each frame the port is
    given the JAX pipeline's volume, device pose chain and harvested pose,
    so every frame is held on its own: same selection schedule, same
    prediction, same track + fuse. Each RO pose must be within 2 mm and
    0.1 deg of the JAX one, and the fused volume must agree. The JAX
    tracker's own result depends on how its loop is compiled: run eagerly
    (jax.disable_jit) on the same inputs it can land a discrete step away
    from its jitted run (1.15 mm / 0.20 deg at frame 3 with nearest
    lookups, scripts/jax_track_contexts.py). Where the port misses the
    jitted pose, it is held to the eager one instead.
  - free-running (trilinear): the port runs alone; its RO-only ATE must be
    within 0.1 cm of the JAX run's. The loop is not held pose by pose here:
    one such discrete step moves every later frame, whatever the
    implementation. Quality must agree, not the bits.
The corridor lockstep runs the same way on a small synthetic_large walk
whose volume re-centres every few frames: the re-centre bookkeeping
(vol_bnds, start_id, frame_to_vrange) must be bitwise the JAX one after
every frame; with tracking.speed_damp 0.5 the brick selections must be
too."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from helpers import tiny_config
from remixfusion_tpu.slam import RemixFusionTPU
from remixfusion_tpu.tools.eval_ate import evaluate_ate
from remixfusion_tpu_torch.slam import RemixFusionTorch
from remixfusion_tpu_torch.slam.pipeline import quantize_depth
from remixfusion_tpu_torch.tracking.rotracker import TrackResult
from remixfusion_tpu_torch.utils.convert import volume_state_from_numpy

torch.set_num_threads(1)

N = 8
N_CORRIDOR = 11
# the damped walk re-centres later (the host extrapolation lags)
N_DAMP = 16


def _cfg(tmp, interp):
    return tiny_config(
        data={"output": str(tmp), "exp_name": "slice",
              "synthetic": {"n_frames": N, "orbit_degrees": 20.0}},
        RO={"particle_iter_lens": 6, "depth_level": [4, 2, 1],
            "eval_mode": "pallas", "PST_size": [256, 128, 128],
            "init_size": 0.02, "count_search": 100,
            "tsdf_interp": interp},
        volume={"voxel_size": 0.025},
        tracking={"harvest_depth": 1})


def _state_np(vs):
    return tuple(np.asarray(a) for a in vs)


def _corridor_cfg(tmp):
    """A small two-room building walked at ~25 cm per frame (ramp of 3
    frames), its volume re-centred whenever the camera has moved half a
    metre along an axis: two re-centres within N_CORRIDOR frames."""
    cfg = _cfg(tmp, "nearest")
    cfg["dataset"] = "synthetic_large"
    cfg["data"]["synthetic"] = {
        "n_frames": 80, "n_rooms": 2, "room_width": 3.4, "room_depth": 3.2,
        "corridor_width": 2.0, "n_boxes_per_room": 4,
        "n_spheres_per_room": 2, "ramp_frames": 3}
    cfg["volume"]["t_treshold"] = 0.5
    for key in ("bound", "marching_cubes_bound"):
        cfg["mapping"][key] = [[0.0, 7.0], [0.0, 3.0], [0.0, 5.4]]
    return cfg


def _bounds(mv):
    return (mv.vol_bnds.copy(), mv.start_id,
            {k: v.copy() for k, v in mv.frame_to_vrange.items()})


def _brick_rows(j, frame_id):
    """Row ids of the bricks the JAX pipeline selected for frame_id (its
    padded selection without the -1 rows), or None when it selected none
    at that frame."""
    sc = j._sel_cache
    if sc is None or sc[0] != frame_id:
        return None
    b = np.asarray(sc[2]).astype(np.int64)
    b = b[(b >= 0).all(1)]
    _, BY, BZ = j.mv.brick_layout()
    return (b[:, 0] * BY + b[:, 1]) * BZ + b[:, 2]


def _jax_run(interp, tmp, cfg=None, n=N):
    """The JAX pipeline's run of n frames, with its state before every
    frame, and its re-centre bookkeeping and brick selection after it."""
    cfg = _cfg(tmp, interp) if cfg is None else cfg
    j = RemixFusionTPU(copy.deepcopy(cfg))
    p0 = j._first_pose(j.dataset[0])
    j.est_c2w_data[0] = p0
    j.RO_c2w_data[0] = p0
    before, tracked, bounds, sel = {}, {}, {}, {}
    for i in range(1, n):
        init = (j.est_c2w_data[0] if j._dev_pose_prev is None
                else j._predict_dev(j._dev_pose_prev, j._dev_pose_prev2,
                                    j._dev_fit_prev))
        before[i] = dict(
            state=_state_np(j.mv.state),
            chain=None if j._dev_pose_prev is None else tuple(
                np.asarray(a) for a in (j._dev_pose_prev, j._dev_pose_prev2,
                                        j._dev_fit_prev)),
            init=np.asarray(init),
            pending=[(fid, np.asarray(r.c2w), np.asarray(r.origin_value))
                     for fid, r, _ in j._pending_track])
        j.track_frame(i, j.dataset[i])
        tracked[i] = np.asarray(j._pending_track[-1][1].c2w)
        bounds[i] = _bounds(j.mv)
        sel[i] = _brick_rows(j, i)
    j._harvest_pending_track()
    after = _state_np(j.mv.state)
    j.close()
    return dict(cfg=cfg, n=n, before=before, tracked=tracked, after=after,
                bounds=bounds, sel=sel,
                ro=j.RO_c2w_data.copy(), gt=j.pose_gt, tracker=j.tracker,
                dataset=j.dataset)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    runs = {}

    def get(interp):
        if interp not in runs:
            tmp = tmp_path_factory.mktemp(interp)
            if interp == "corridor":
                runs[interp] = _jax_run("nearest", tmp, _corridor_cfg(tmp),
                                        N_CORRIDOR)
            elif interp == "damp":
                cfg = _corridor_cfg(tmp)
                cfg["tracking"]["speed_damp"] = 0.5
                runs[interp] = _jax_run("nearest", tmp, cfg, N_DAMP)
            else:
                runs[interp] = _jax_run(interp, tmp)
        return runs[interp]
    return get


def _jax_eager_track(run, i):
    """The JAX tracker's call for frame i, run without jit."""
    b, jt = run["before"][i], run["tracker"]
    depth = quantize_depth(run["dataset"][i]["depth"])
    with jax.disable_jit():
        return np.asarray(jt._track(
            jnp.asarray(b["state"][0]), jnp.asarray(b["state"][3]),
            jnp.asarray(b["init"]), jnp.asarray(depth),
            jax.random.PRNGKey(0), jt.init_search_size()).c2w)


def _gap(a, b):
    rel = a[:3, :3].astype(np.float64) @ b[:3, :3].T.astype(np.float64)
    return (np.abs(a[:3, 3] - b[:3, 3]).max(),
            np.degrees(Rotation.from_matrix(rel).magnitude()))


def _lockstep(run, tmp_path, after_frame=None):
    """The port tracking every frame from the JAX pipeline's state; each
    RO pose within 2 mm / 0.1 deg of the JAX one (jitted, else eager), the
    fused volume held where the poses agree. after_frame(i, slam) runs
    after each frame. Returns (slam, frames fused from the same pose)."""
    before, after = run["before"], run["after"]
    cfg = copy.deepcopy(run["cfg"])
    cfg["data"]["output"] = str(tmp_path)
    s = RemixFusionTorch(cfg, device="cpu")
    t = lambda a: torch.tensor(a)  # noqa: E731
    fused_same, n = 0, run["n"]
    for i in range(1, n):
        b = before[i]
        s.mv.state = volume_state_from_numpy(*b["state"], "cpu")
        if b["chain"] is not None:
            s._dev_pose_prev, s._dev_pose_prev2, s._dev_fit_prev = \
                (t(a) for a in b["chain"])
        assert [p[0] for p in s._pending] == [p[0] for p in b["pending"]]
        s._pending = [(fid, TrackResult(t(c2w), None, True, t(fit)), init)
                      for (fid, c2w, fit), (_, _, init)
                      in zip(b["pending"], s._pending)]
        # the port's own prediction agrees to float32 rounding
        # (test_const_speed_prediction_matches_jax); the optimiser is fed
        # the JAX bits, because a 1e-7 nudge can move one candidate's
        # nearest-voxel lookup and, through it, a discrete step
        if b["chain"] is not None:
            own = s._predict_init().numpy()
            assert np.abs(own - b["init"]).max() < 1e-5, i
        s._predict_init = lambda: t(b["init"])
        s.track_frame(i, s.dataset[i])
        if after_frame is not None:
            after_frame(i, s)
        ours = s._pending[-1][1].c2w.numpy()
        dt, ang = _gap(ours, run["tracked"][i])
        if not (dt < 2e-3 and ang < 0.1):
            dt, ang = _gap(ours, _jax_eager_track(run, i))
            assert dt < 2e-3 and ang < 0.1, (i, dt, ang)
            continue  # fused with another pose than the JAX pipeline's
        if dt > 1e-5:
            continue
        fused_same += 1
        ref = before[i + 1]["state"] if i + 1 < n else after
        tsdf, weight = s.mv.state.tsdf.numpy(), s.mv.state.weight.numpy()
        # poses equal to 1e-5 m still move a projection across a pixel
        # boundary here and there: hold all but 1e-4 of the voxels
        close = (weight == ref[1]) & (np.abs(tsdf - ref[0]) < 1e-3)
        assert close.mean() > 0.9999, (i, (~close).sum())
    s._harvest()
    return s, fused_same


@pytest.mark.parametrize("interp", ["nearest", "trilinear"])
def test_slice_lockstep_matches_jax(jax_runs, interp, tmp_path):
    run = jax_runs(interp)
    s, fused_same = _lockstep(run, tmp_path)
    assert fused_same >= 3
    assert np.array_equal(s.mv.vol_bnds[:, 0], run["after"][3])


def _same_bounds(run, i, s):
    """The port's re-centre bookkeeping after frame i bitwise the JAX
    pipeline's."""
    bnds, start, hist = run["bounds"][i]
    assert np.array_equal(s.mv.vol_bnds, bnds), i
    assert s.mv.start_id == start, i
    assert s.mv.frame_to_vrange.keys() == hist.keys(), i
    for k, v in hist.items():
        assert np.array_equal(s.mv.frame_to_vrange[k], v), (i, k)
        assert np.array_equal(s.mv.frameid_to_vrange(k[1]), v)


def test_corridor_lockstep_recentres_like_jax(jax_runs, tmp_path):
    """A synthetic_large walk re-centring at least twice in N_CORRIDOR
    frames, in lockstep:
    vol_bnds, start_id and frame_to_vrange bitwise the JAX pipeline's after
    every frame, the poses within the slice test's tolerance."""
    run = jax_runs("corridor")
    s, fused_same = _lockstep(
        run, tmp_path, lambda i, s: _same_bounds(run, i, s))
    assert len(s.mv.frame_to_vrange) >= 2
    assert fused_same >= 3
    assert np.array_equal(s.mv.vol_bnds[:, 0], run["after"][3])


def test_damp_lockstep_selects_like_jax(jax_runs, tmp_path):
    """The corridor walk at tracking.speed_damp 0.5 over N_DAMP frames, in
    lockstep: fed the JAX pipeline's harvested poses and fitness, the
    port's host extrapolation (damped on every frame, as JAX's, whatever
    the fitness) makes bitwise the JAX pipeline's brick selection and
    re-centre bookkeeping after every frame."""
    run = jax_runs("damp")
    assert run["cfg"]["tracking"]["speed_damp"] == 0.5

    def same_selection(i, s):
        _same_bounds(run, i, s)
        fid, _, rows = s._sel_cache
        assert fid == i and run["sel"][i] is not None, i
        assert np.array_equal(rows.numpy(), run["sel"][i]), i

    s, fused_same = _lockstep(run, tmp_path, same_selection)
    assert len(s.mv.frame_to_vrange) >= 2
    assert fused_same >= 3


def test_slice_free_running_ate_matches_jax(jax_runs, tmp_path):
    run = jax_runs("trilinear")
    ro_jax, gt = run["ro"], run["gt"]
    cfg = copy.deepcopy(run["cfg"])
    cfg["data"]["output"] = str(tmp_path)
    s = RemixFusionTorch(cfg, device="cpu")
    out = s.run()
    assert out["tracked_frames"] == N - 1
    assert np.isfinite(s.RO_c2w_data).all()
    ate_jax = evaluate_ate({float(i): gt[i] for i in range(N)},
                           {float(i): ro_jax[i] for i in range(N)})["rmse"]
    assert abs(out["ate_rmse_cm_ro_only"] - 100 * ate_jax) < 0.1, (
        out["ate_rmse_cm_ro_only"], 100 * ate_jax)
    # the first tracked frame starts from identical state: same pose
    dt, ang = _gap(s.RO_c2w_data[1], ro_jax[1])
    assert dt < 2e-3 and ang < 0.1


def test_const_speed_prediction_matches_jax(jax_runs):
    """Device pose-chain prediction (Newton polar factor) against the JAX
    predict_dev (float32 SVD), with and without the fitness-gated damp."""
    from remixfusion_tpu_torch.core.pose import predict_const_speed
    run = jax_runs("nearest")
    cfg, before = run["cfg"], run["before"]
    for damp in (1.0, 0.5):
        c = copy.deepcopy(cfg)
        c["tracking"]["speed_damp"] = damp
        j = RemixFusionTPU(c)
        for i in range(2, N):
            prev, prev2, fit = before[i]["chain"]
            fit = np.float32(0.3)
            ref = np.asarray(j._predict_dev(prev, prev2, fit))
            out = predict_const_speed(
                torch.tensor(prev), torch.tensor(prev2), torch.tensor(fit),
                const_speed=True, speed_damp=damp).numpy()
            assert np.abs(out - ref).max() < 1e-5, (damp, i)
        j.close()


def test_host_prediction_matches_jax(tmp_path):
    """tracking.speed_damp 0.5: the host extrapolation (re-center and brick
    selection) from the last two harvested poses, 1 to 3 frames ahead,
    against the JAX pipeline's _const_speed_np at the same damp, which it
    applies on every frame whatever the tracker's fitness."""
    cfg = _cfg(tmp_path, "nearest")
    cfg["tracking"]["speed_damp"] = 0.5
    s = RemixFusionTorch(cfg, device="cpu")
    p2 = s.dataset[2]["c2w"].copy()
    p1 = s.dataset[4]["c2w"].copy()
    p1[:3, 3] += np.array([0.03, -0.02, 0.01], np.float32)
    s._last_harvested = [(2, p2), (3, p1)]
    s._dev_fit_prev = torch.tensor(0.05)  # healthy: the device gate is off
    for steps in (1, 2, 3):
        host = s._host_pose_estimate(3 + steps)
        ref = RemixFusionTPU._const_speed_np(p1, p2, steps=steps, damp=0.5)
        assert np.abs(host - ref).max() < 1e-6, steps
        full = RemixFusionTPU._const_speed_np(p1, p2, steps=steps)
        assert np.abs(host[:3, 3] - full[:3, 3]).max() > 1e-3, steps


def test_fuse_fit_gate_matches_jax(tmp_path):
    """volume.fuse_fit_gate [0.18, 0.30]: frames tracked at fitness below,
    inside and above the gate (each package's tracker replaced by one that
    returns the frame's true pose and that fitness) fuse at weight 1, 0.5
    and the 0.05 floor; each frame, fused from the JAX pipeline's state,
    against the JAX pipeline's _obs_w fusion: weights bitwise, tsdf within
    2e-5 (a fractional weight adds a rounding to the running mean: the
    dense fusers' two-frame bar)."""
    from remixfusion_tpu.tracking.rotracker import TrackResult as JaxResult

    cfg = _cfg(tmp_path, "nearest")
    cfg["volume"]["fuse_fit_gate"] = [0.18, 0.30]
    j = RemixFusionTPU(copy.deepcopy(cfg))
    p0 = j._first_pose(j.dataset[0])
    j.est_c2w_data[0] = p0
    j.RO_c2w_data[0] = p0
    s = RemixFusionTorch(copy.deepcopy(cfg), device="cpu")
    weights = []
    obs_weight = s._obs_weight
    s._obs_weight = lambda res: weights.append(obs_weight(res)) or \
        weights[-1]
    for i, fit, w_new in ((1, 0.1, 1.0), (2, 0.24, 0.5), (3, 0.5, 0.05)):
        pose = j.dataset[i]["c2w"]
        # the JAX track program is traced with the fake baked in: rebuild
        # it for every frame
        j.tracker._track = lambda *a, pose=pose, fit=fit: JaxResult(
            jnp.asarray(pose), a[-1], jnp.asarray(True), jnp.float32(fit))
        j.__dict__.pop("_track_jits", None)
        j.__dict__.pop("_tf_fns", None)
        s.tracker.track = lambda *a, pose=pose, fit=fit, **k: TrackResult(
            torch.tensor(pose), None, True, torch.tensor(fit))
        s.mv.state = volume_state_from_numpy(*_state_np(j.mv.state), "cpu")
        w0 = np.asarray(j.mv.state.weight)
        j.track_frame(i, j.dataset[i])
        s.track_frame(i, s.dataset[i])
        ref = _state_np(j.mv.state)
        tsdf, weight = s.mv.state.tsdf.numpy(), s.mv.state.weight.numpy()
        assert np.array_equal(weight, ref[1]), i
        assert np.abs(tsdf - ref[0]).max() <= 2e-5, i
        # voxels first seen by this frame take its gated weight
        fresh = (w0 == 0) & (weight > 0)
        assert fresh.sum() > 100 and np.allclose(weight[fresh], w_new), i
        assert abs(float(weights[-1]) - w_new) < 1e-6, i
    j.close()


def test_tum_layout_run_matches_jax(tmp_path):
    """A tiny run through the real-sensor path: a TUM layout written by the
    port (16-bit depth at 5000 per m, distorted colour, timestamp lists),
    loaded with RO.sample_range 0.1, the fr1_desk distortion, crop_size and
    crop_edge. The port's whole run (mapping rounds and finalize included)
    must hold the JAX pipeline's RO-only ATE on the same directory within
    0.1 cm; the per-pixel shifts are each package's own draws, so the poses
    are not compared one by one."""
    from remixfusion_tpu_torch.tools.write_layout import write_layout

    cfg = _cfg(tmp_path / "out", "nearest")
    cfg["dataset"] = "tum"
    cfg["RO"]["sample_range"] = 0.1
    cfg["RO"]["cut_dist"] = 3.0
    cfg["cam"].update(png_depth_scale=5000.0, crop_edge=2,
                      crop_size=[40, 56],
                      distortion=[0.2624, -0.9531, -0.0054, 0.0026, 1.1633])
    cfg["print_ape"] = 1
    write_layout(cfg, "tum", str(tmp_path / "tum"), N, workers=1)
    cfg["data"]["datadir"] = str(tmp_path / "tum")

    j = RemixFusionTPU(copy.deepcopy(cfg))
    assert j.dataset.H == 40 and j.dataset.W == 56
    p0 = j._first_pose(j.dataset[0])
    j.est_c2w_data[0] = p0
    j.RO_c2w_data[0] = p0
    for i in range(1, N):
        j.track_frame(i, j.dataset[i])
    j._harvest_pending_track()
    j.close()
    gt = j.pose_gt
    ate_jax = evaluate_ate({float(i): gt[i] for i in range(N)},
                           {float(i): j.RO_c2w_data[i]
                            for i in range(N)})["rmse"]

    s = RemixFusionTorch(copy.deepcopy(cfg), device="cpu")
    assert np.array_equal(s.pose_gt, gt)
    f_t, f_j = s.dataset[3], j.dataset[3]
    assert np.array_equal(f_t["depth"], f_j["depth"])
    assert np.abs(f_t["rgb"] - f_j["rgb"]).max() <= 1e-6
    out = s.run()
    assert out["tracked_frames"] == N - 1
    assert np.isfinite(s.RO_c2w_data).all()
    assert abs(out["ate_rmse_cm_ro_only"] - 100 * ate_jax) < 0.1, (
        out["ate_rmse_cm_ro_only"], 100 * ate_jax)
    assert out["mesh_faces"] > 0
