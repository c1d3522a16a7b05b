"""Mid-run resume of the port (RemixFusionTorch.save_state / load_state /
run(resume=True)) against the JAX package's resume semantics
(remixfusion_tpu/slam/pipeline.py save_state, load_state, load_ckpt), on
tiny CPU configs: the checkpoint round trip, a resumed run in a fresh
pipeline, the loaded state bitwise the saved one, the length check, the
atomic write, the BA write-back folded into the snapshot only, the pose
chain rebuilt from the raw RO poses, the fs_scope 'seen' reseed, the npz
keys of the JAX save_state and the run_torch.py --resume CLI."""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from helpers import tiny_config
from remixfusion_tpu_torch.core.pose import const_speed_np
from remixfusion_tpu_torch.slam import RemixFusionTorch
from remixfusion_tpu_torch.tracking.volume import MovingVolume

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 12
SAVE_AT = 6


def _cfg(tmp, exp, n_frames=N, **over):
    cfg = tiny_config(
        data={"output": str(tmp), "exp_name": exp,
              "synthetic": {"n_frames": n_frames, "orbit_degrees": 25.0}},
        RO={"particle_iter_lens": 8, "depth_level": [4, 2, 1],
            "eval_mode": "pallas", "PST_size": [256, 128, 128],
            "init_size": 0.02, "count_search": 100},
        volume={"voxel_size": 0.025},
        mapping={"first_iters": 15, "iters": 2, "BA_iters": 2,
                 "keyframe_every": 2, "map_every": 2, "sample": 128},
        mesh={"vis": 0, "voxel_final": 0.1})
    for k, v in over.items():
        cfg[k].update(v)
    return cfg


def _drive(slam, last):
    """First-frame mapping, then frames 1..last with their mapping rounds
    (the JAX resume test's phase 1)."""
    slam.first_frame_mapping()
    for idx in range(1, last + 1):
        slam.step(idx, slam.dataset.num_frames)


def _load(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _equal(a, b):
    if a.dtype.kind == "U":
        return json.loads(str(a)) == json.loads(str(b))
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A port run to frame SAVE_AT, then save_state (the JAX resume test's
    phase 1); then the rounds the drained harvest unlocks and a second
    save with a BA write-back pending on keyframes past frame 0: the
    checkpoints' paths and the live arrays around the second save."""
    tmp = tmp_path_factory.mktemp("resume")
    slam = RemixFusionTorch(_cfg(tmp, "a"), device="cpu")
    _drive(slam, SAVE_AT)
    path = str(tmp / "resume.npz")
    slam.save_state(path)
    out = dict(slam=slam, tmp=tmp, path=path, map_idx=slam.mapping_idx,
               kfdb=len(slam.kfdb),
               poses=slam.est_c2w_data[:SAVE_AT + 1].copy())
    slam._due_rounds(N)
    out.update(pending=slam._pending_ba[0].numpy().copy(),
               cur_kf=slam._pending_ba[1], live=slam.est_c2w_data.copy(),
               path_ba=str(tmp / "resume_ba.npz"))
    slam.save_state(out["path_ba"])
    out.update(live_after=slam.est_c2w_data.copy(),
               pending_kept=slam._pending_ba is not None)
    return out


def test_checkpoint_roundtrip(tmp_path):
    """save_ckpt / load_ckpt (JAX test_checkpoint_roundtrip): poses and the
    whole scene model come back bitwise."""
    cfg = _cfg(tmp_path, "ckpt", n_frames=4)
    cfg["mapping"].update(first_iters=4, iters=1, BA_iters=1, sample=64,
                          save_ckpt=True)
    cfg["mesh"]["voxel_final"] = 0.2
    slam = RemixFusionTorch(cfg, device="cpu")
    slam.run()
    path = os.path.join(str(tmp_path), "ckpt", "checkpoint.npz")
    assert os.path.exists(path)
    slam2 = RemixFusionTorch(copy.deepcopy(cfg), device="cpu")
    slam2.load_ckpt(path)
    assert np.array_equal(slam2.est_c2w_data, slam.est_c2w_data)
    assert np.array_equal(slam2.est_c2w_data_rel, slam.est_c2w_data_rel)
    ref, got = slam._model_state_dict(), slam2._model_state_dict()
    assert ref.keys() == got.keys()
    for k in ref:
        assert _equal(got[k], ref[k]), k


def test_loaded_state_is_bitwise_the_saved_one(saved):
    """Every array of the checkpoint, the optimizer tensors included, is
    bitwise what a fresh pipeline holds after load_state."""
    data = _load(saved["path"])
    slam2 = RemixFusionTorch(_cfg(saved["tmp"], "b"), device="cpu")
    slam2.load_state(saved["path"])
    got = slam2.state_arrays()
    assert got.keys() == data.keys()
    for k in data:
        assert _equal(got[k], data[k]), k
    # the optimizers' live tensors, not only their export
    for name in ("map_opt", "rba_opt"):
        sd = getattr(slam2.mapper, name).state_dict()["state"]
        assert sd
        for i, st in sd.items():
            for key, v in st.items():
                assert np.array_equal(v.numpy(),
                                      data[f"{name}_state_{i}_{key}"])
    assert np.array_equal(slam2.mv.state.origin.numpy(),
                          data["mv_bnds"][:, 0].astype(np.float32))
    assert np.array_equal(slam2.kfdb.rays.numpy(), data["kf_rays"])
    for gen, key in ((slam2._gen, "gen_state"),
                     (slam2._shift_gen, "shift_gen_state")):
        assert np.array_equal(gen.get_state().numpy(), data[key])


def test_midrun_resume_continues_to_the_end(saved):
    """JAX test_midrun_resume: restore into a fresh pipeline, continue to
    the end, land in the quality class of an uninterrupted run."""
    slam2 = RemixFusionTorch(_cfg(saved["tmp"], "b"), device="cpu")
    slam2.load_state(saved["path"])
    assert slam2.tracking_idx == SAVE_AT
    assert slam2.mapping_idx == saved["map_idx"]
    # the snapshot carries the pending BA write-back: keyframe rows may
    # differ from the live array by that last refinement
    np.testing.assert_allclose(slam2.est_c2w_data[:SAVE_AT + 1],
                               saved["poses"], atol=5e-4)
    assert len(slam2.kfdb) == saved["kfdb"]
    out = slam2.run(resume=True)
    assert out["first_tracked"] == SAVE_AT + 1
    assert out["tracked_frames"] == N - SAVE_AT - 1
    assert out["first_frame_mapping_ms"] is None
    assert np.isfinite(slam2.est_c2w_data).all()
    assert out["ate_rmse_cm"] < 10.0, out["ate_rmse_cm"]
    run_dir = os.path.join(str(saved["tmp"]), "b")
    for name in ("all_poses.npy", "mesh.ply"):
        assert os.path.exists(os.path.join(run_dir, name))


def test_resume_rejects_mismatched_sequence_length(saved):
    slam2 = RemixFusionTorch(_cfg(saved["tmp"], "c", n_frames=10),
                             device="cpu")
    with pytest.raises(ValueError, match="12-frame"):
        slam2.load_state(saved["path"])


def test_failed_save_keeps_previous_checkpoint(saved, tmp_path,
                                               monkeypatch):
    """A save that dies mid-write leaves the previous resume.npz as it was
    (and no temporary file behind)."""
    path = str(tmp_path / "resume.npz")
    with open(saved["path"], "rb") as f:
        before = f.read()
    with open(path, "wb") as f:
        f.write(before)

    def dies(file, **arrays):
        file.write(b"PK\x03\x04 half an archive")
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez_compressed", dies)
    with pytest.raises(OSError, match="disk full"):
        saved["slam"].save_state(path)
    with open(path, "rb") as f:
        assert f.read() == before
    assert os.listdir(tmp_path) == ["resume.npz"]


def test_save_folds_ba_writeback_into_snapshot_only(saved):
    """save_state leaves the live trajectory and the pending write-back
    as they were; the snapshot's keyframe rows carry the BA poses."""
    assert np.array_equal(saved["live_after"], saved["live"])
    assert saved["pending_kept"]
    pose = _load(saved["path_ba"])["pose"]
    n_kf = saved["cur_kf"]
    assert n_kf >= 2
    rows = np.arange(n_kf) * 2
    assert np.array_equal(pose[rows], saved["pending"][:n_kf])
    assert not np.array_equal(pose[rows[1:]], saved["live"][rows[1:]])
    others = np.setdiff1d(np.arange(N), rows)
    assert np.array_equal(pose[others], saved["live"][others])


def test_pose_chain_rebuilt_from_ro_rows(saved, tmp_path):
    """The device pose chain and the harvested frontier come from the raw
    RO poses even where the keyframe's est row differs (BA-refined)."""
    data = _load(saved["path"])
    i = int(data["tracking_idx"])
    assert i % 2 == 0  # a keyframe
    data["pose"][i, :3, 3] += np.float32(0.05)
    data["pose"][i - 1, :3, 3] -= np.float32(0.03)
    path = str(tmp_path / "edited.npz")
    np.savez(path, **data)
    slam2 = RemixFusionTorch(_cfg(tmp_path, "d"), device="cpu")
    slam2.load_state(path)
    ro = data["ro_pose"]
    assert not np.array_equal(slam2.est_c2w_data[i], ro[i])
    assert np.array_equal(slam2._dev_pose_prev.numpy(), ro[i])
    assert np.array_equal(slam2._dev_pose_prev2.numpy(), ro[i - 1])
    assert float(slam2._dev_fit_prev) == 0.0
    assert [j for j, _ in slam2._last_harvested] == [i - 1, i]
    for j, p in slam2._last_harvested:
        assert np.array_equal(p, ro[j])
    assert slam2._pending == [] and slam2._pending_ba is None
    assert slam2._lookahead is None and slam2._map_frame_cache is None
    # the host extrapolation reads RO as well
    assert np.array_equal(slam2._host_pose_estimate(i + 1),
                          const_speed_np(ro[i], ro[i - 1], steps=1,
                                         damp=1.0))


def test_reseed_seen_matches_jax():
    """BrickSelector.reseed_seen, bitwise the JAX one on the same minima
    (values at and just below 1.0 included)."""
    from remixfusion_tpu.ops.tsdf import BrickSelector as JaxSel
    from remixfusion_tpu_torch.ops.tsdf import BrickSelector

    K = np.array([[40.0, 0, 31.5], [0, 40.0, 23.5], [0, 0, 1]], np.float32)
    args = ((80, 80, 60), 10, 0.05, K, 48, 64)
    js, ts = JaxSel(*args, fs_scope="seen"), BrickSelector(
        *args, fs_scope="seen")
    rng = np.random.default_rng(3)
    tmin = rng.uniform(-1.0, 1.0, js.NB).astype(np.float32)
    tmin[::3] = 1.0
    tmin[1::7] = np.float32(1.0 - 1e-7)
    tmin[2::11] = np.float32(1.0 - 2e-6)
    js.reseed_seen(tmin)
    ts.reseed_seen(tmin)
    assert ts.seen.dtype == js.seen.dtype
    assert np.array_equal(ts.seen, js.seen)
    assert 0 < ts.seen.sum() < ts.NB


def test_fs_scope_seen_reseed_applied_when_selector_is_built(saved,
                                                              tmp_path):
    """fs_scope 'seen': a volume loaded before its selector exists holds
    the reseed and applies it when the selector is built; a pipeline that
    loads a checkpoint reseeds its carve history from the volume."""
    data = _load(saved["path"])
    cfg = _cfg(tmp_path, "e", volume={"fs_scope": "seen"})
    pose = data["ro_pose"][SAVE_AT]
    mv = MovingVolume(copy.deepcopy(cfg), pose, "cpu")
    assert not hasattr(mv, "_brick_sel")
    mv.load_state_arrays(data)
    tmin = mv.state.tsdf.min(dim=1).values.numpy()
    want = tmin < 1.0 - 1e-6
    assert 0 < want.sum() < want.size
    assert np.array_equal(mv._pending_reseed, tmin)
    K = np.array([[40.0, 0, 31.5], [0, 40.0, 23.5], [0, 0, 1]], np.float32)
    depth = np.full((48, 64), 1.5, np.float32)
    mv.frame_bricks(pose, depth, K)
    assert mv._pending_reseed is None
    # the selection marks the frame's near bricks on top of the reseed
    assert np.array_equal(mv._brick_sel.seen & want, want)

    slam2 = RemixFusionTorch(cfg, device="cpu")
    slam2.load_state(saved["path"])
    assert np.array_equal(slam2.mv._brick_sel.seen, want)


def test_resume_npz_has_the_jax_keys(saved, tmp_path):
    """The port's checkpoint holds the JAX save_state's keys with their
    shapes and dtypes on the same tiny config and schedule, apart from the
    optimizer entries (torch's state_dict layout for the JAX optimizer
    leaves mopt_* / ropt_*) and the generators (gen_state,
    shift_gen_state for key_counter); the volume is dense [X, Y, Z] where
    JAX writes it brick-major [NB, b^3]."""
    from remixfusion_tpu.slam import RemixFusionTPU

    j = RemixFusionTPU(_cfg(tmp_path, "jax"))
    j.first_frame_mapping()
    for idx in range(1, SAVE_AT + 1):
        j.track_frame(idx, j.dataset[idx])
        while j.tracking_idx > j.mapping_idx + 2:
            j.mapping_round(j.mapping_idx + 2)
    jpath = str(tmp_path / "jax.npz")
    j.save_state(jpath)
    j.close()
    jd, td = _load(jpath), _load(saved["path"])

    def core(keys, opt, gen):
        return {k for k in keys
                if not k.startswith(opt) and k not in gen}

    jk = core(jd, ("mopt_", "ropt_"), {"key_counter"})
    tk = core(td, ("map_opt_", "rba_opt_"), {"gen_state", "shift_gen_state"})
    assert jk == tk
    assert any(k.startswith("mopt_") for k in jd)
    assert any(k.startswith("map_opt_state_") for k in td)
    dims = tuple(saved["slam"].mv.dims)
    for k in sorted(jk):
        assert td[k].dtype == jd[k].dtype, k
        if k in ("mv_tsdf", "mv_weight", "mv_color"):
            assert td[k].shape[:3] == dims, k
            assert td[k].size == jd[k].size, k
        else:
            assert td[k].shape == jd[k].shape, k
    for k in ("tracking_idx", "mapping_idx", "kf_frame_ids", "mv_bnds",
              "mv_start_id"):
        assert np.array_equal(td[k], jd[k]), k


def test_run_torch_resume_cli(saved, tmp_path):
    """run_torch.py --resume ... --device cpu continues the saved run to
    the end in a process of its own."""
    cfg = _cfg(tmp_path, "cli")
    path = str(tmp_path / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, default_flow_style=None)
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "run_torch.py"), "--config",
         path, "--resume", saved["path"], "--device", "cpu"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert f"first_tracked={SAVE_AT + 1}" in out.stdout, out.stdout
    assert "Loaded resume state" in out.stdout
    run_dir = os.path.join(str(tmp_path), "cli")
    for name in ("all_poses.npy", "mesh.ply", "tracking_result.json"):
        assert os.path.exists(os.path.join(run_dir, name))
