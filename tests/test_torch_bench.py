"""bench_torch.py, the port's headline bench, against bench.py on the CPU:
the configuration bench.py:296-324 applies, the steady-state accounting
of bench.py:222-245 on literal frame-time lists, a measured run on
tiny_config against the JAX bench.run_attempt (timed frames, mapping
rounds, the final mapping_idx, RO-only ATE within the band of
test_slice_free_running_ate_matches_jax), and the CLI in a process where
jax, yaml and the JAX package cannot be imported."""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import bench
import bench_torch
from helpers import tiny_config
from remixfusion_tpu.config import load_config as jax_load_config
from remixfusion_tpu.tools.eval_ate import evaluate_ate
from torch_env import child_env

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, WARMUP = 12, 2


def _bench_py_configure(cfg, env):
    """bench.py:296-324 as it stands (its main() inlines them)."""
    if cfg["dataset"] == "synthetic":
        n_frames = int(env.get("BENCH_FRAMES", "200"))
        cfg["data"]["synthetic"]["n_frames"] = n_frames
        cfg["data"]["synthetic"]["orbit_degrees"] = 1.2 * n_frames
    else:
        if env.get("BENCH_FRAMES"):
            cfg["data"]["synthetic"]["n_frames"] = int(env["BENCH_FRAMES"])
        n_frames = int(cfg["data"]["synthetic"]["n_frames"])
    if env.get("BENCH_SEED"):
        cfg["seed"] = int(env["BENCH_SEED"])
    cfg["mesh"]["vis"] = 0
    cfg["mapping"]["first_iters"] = 100
    return n_frames


def _bench_py_accounting(frame_times, frame_mapped, warmup):
    """bench.py:222-245's formula: (fps, stall count, [(frame, t,
    mapped)])."""
    times = np.asarray(frame_times[warmup - 1:])
    mapped = np.asarray(frame_mapped[warmup - 1:])
    ok = times <= 1.0
    n_stall = int((~ok).sum())
    fps = len(times) / float(times.sum())
    slow = [(warmup + int(i), float(times[i]), bool(mapped[i]))
            for i in np.flatnonzero(~ok)]
    return fps, n_stall, slow


@pytest.mark.parametrize("config,env", [
    ("configs/Synthetic/synthetic_bench.yaml", {}),
    ("configs/Synthetic/bench_hashgrid.yaml",
     {"BENCH_FRAMES": "60", "BENCH_SEED": "7"}),
    ("configs/Synthetic/synthetic_corridor.yaml", {}),
    ("configs/Synthetic/synthetic_corridor.yaml", {"BENCH_FRAMES": "90"}),
])
def test_configure_matches_bench_py(config, env, monkeypatch):
    """The orbit takes BENCH_FRAMES (200) frames at 1.2 degrees each; a
    waypoint scene keeps its frame count unless BENCH_FRAMES is set; the
    output goes to output/bench_torch/<config stem>, so two configs that
    share an exp_name (bench_hashgrid.yaml inherits synthetic_bench's) do
    not overwrite each other."""
    monkeypatch.chdir(ROOT)
    ref = jax_load_config(config)
    n_ref = _bench_py_configure(ref, env)
    cfg = jax_load_config(config)
    n = bench_torch.configure(cfg, config, env)
    assert n == n_ref
    stem = os.path.splitext(os.path.basename(config))[0]
    assert cfg["data"].pop("output") == os.path.join("output", "bench_torch")
    assert cfg["data"].pop("exp_name") == stem
    ref["data"].pop("output")
    ref["data"].pop("exp_name", None)
    assert cfg == ref


@pytest.mark.parametrize("n,warmup,slow_at", [(200, 30, (57, 120)),
                                              (12, 2, ())])
def test_steady_state_matches_bench_py(n, warmup, slow_at):
    """170 steady frames of 200 at warmup 30; frames over 1 s (a round's
    frame and one without) are counted in fps and reported with their
    index and whether a round ran."""
    rng = np.random.default_rng(0)
    times = list(rng.uniform(0.05, 0.4, n - 1))
    mapped = [k % 5 == 3 for k in range(n - 1)]
    for frame in slow_at:
        times[frame - 1] = 1.0 + 0.25 * frame / n
    fps, n_stall, slow = _bench_py_accounting(times, mapped, warmup)
    got = bench_torch.steady_state(times, mapped, warmup)
    assert got["frames"] == n - warmup
    assert got["fps"] == fps
    assert got["elapsed_s"] == pytest.approx(sum(times[warmup - 1:]),
                                             rel=1e-12)
    assert got["slow"] == slow and len(slow) == n_stall == len(slow_at)
    assert [s[0] for s in slow] == list(slow_at)
    assert [s[2] for s in slow] == [mapped[f - 1] for f in slow_at]


def _bench_cfg(tmp):
    cfg = tiny_config(data={"output": str(tmp), "exp_name": "bench"})
    n = bench_torch.configure(cfg, "tiny.yaml", {"BENCH_FRAMES": str(N)})
    cfg["data"]["output"] = str(tmp)
    return cfg, n


def _run_against_jax(cfg, n, tmp_path, ro_tol=0.1):
    """run_bench on cfg (n frames, warmup WARMUP, no mesh block) on the CPU
    and the JAX bench's run_attempt on the same config: the same timed
    frames, mapping rounds (bench.py:206-213's interleave), final
    mapping_idx, map iterations, re-centres and keyframes; the RO-only ATE
    (and each row of the ATE over the first n frames) within ro_tol cm of
    the JAX run's (0.1: the band of test_slice_free_running_ate_matches_
    jax), the full ATE within 0.5 cm (BA moves it a little differently in
    each package); every pose finite; no kernel launch on the CPU. Returns
    the port's result."""
    jcfg = copy.deepcopy(cfg)
    jcfg["data"]["output"] = str(tmp_path / "jax")
    res_j, j, _ = bench.run_attempt(jcfg, n, WARMUP)
    rounds_j, idx_j = len(j.stats["map_time"]), j.mapping_idx
    recentres_j, keyframes_j = len(j.mv.frame_to_vrange), len(j.kfdb)
    poses_j = j.convert_relative_pose_npy()  # bench.py's ATE block
    gt = j.pose_gt
    gt_n = {float(i): gt[i] for i in range(n)}
    ate_j = 100 * evaluate_ate(gt_n, {float(i): j.RO_c2w_data[i]
                                      for i in range(n)})["rmse"]
    full_j = 100 * evaluate_ate(gt_n, {float(i): poses_j[i]
                                       for i in range(n)})["rmse"]
    ro_j = np.array(j.RO_c2w_data[:n])
    j.close()

    res = bench_torch.run_bench(cfg, n, WARMUP, torch.device("cpu"),
                                mesh=False)
    # bench.py times frames 1..n-1 and keeps frame_times[warmup - 1:]
    assert res["frames"] == n - WARMUP
    assert res["rounds"] == rounds_j > 0
    assert res["mapping_idx"] == idx_j
    assert abs(res["ate_rmse_cm_ro_only"] - ate_j) < ro_tol, (
        res["ate_rmse_cm_ro_only"], ate_j)
    assert abs(res["ate_rmse_cm"] - full_j) < 0.5, (res["ate_rmse_cm"],
                                                     full_j)
    for k, _, ro in res["ate_by_frames"]:
        ref = 100 * evaluate_ate(
            {float(i): gt[i] for i in range(k)},
            {float(i): ro_j[i] for i in range(k)})["rmse"]
        assert abs(ro - ref) < ro_tol, (k, ro, ref)
    assert res["poses_finite"]
    assert res["tracked_frames"] == n - 1
    assert res["launches"] == {"brick_eval": 0, "hash_table_grad": 0}
    assert np.isfinite(res["fps"]) and res["fps"] > 0
    assert res["map_iters"] == rounds_j * cfg["mapping"]["iters"]
    assert res["recentres"] == recentres_j
    assert res["keyframes"] == keyframes_j
    assert 0.0 <= res["sel_la_hit"] <= 1.0
    assert res["track_graph_hit"] == 0.0  # the CPU runs the loop eagerly
    assert res["map_graph_hit"] == 0.0  # and the map and BA steps
    return res


def test_run_bench_matches_jax_run_attempt(tmp_path):
    """The measured run on tiny_config (12 frames, warmup 2) against the
    JAX bench's run_attempt on the same config (_run_against_jax)."""
    cfg, n = _bench_cfg(tmp_path)
    assert n == N and cfg["data"]["synthetic"]["orbit_degrees"] == 1.2 * N
    res = _run_against_jax(cfg, n, tmp_path)
    assert res["recentres"] == 0 and res["ate_by_frames"] == []


# the tiny corridor: the frames run, the walk's length in frames (~5 cm a
# frame), and the RO-only ATE band: free-running on a walk that re-centres,
# a discrete step of either tracker moves every later frame (each frame
# is held within 2 mm in test_torch_pipeline's corridor lockstep); 0.16 cm
# apart at these widths
N_CORRIDOR, CORRIDOR_WALK, CORRIDOR_RO_TOL = 12, 300, 0.3


def test_run_bench_matches_jax_run_attempt_on_the_corridor(tmp_path,
                                                           monkeypatch):
    """The waypoint branch (bench.py keeps a synthetic_large walk's frame
    count) on test_torch_pipeline's small two-room building with its
    tracker settings, its volume re-centred whenever the camera has moved
    10 cm: the first N_CORRIDOR frames of the walk against the JAX bench's
    run_attempt (_run_against_jax, re-centres included), with the ATE over
    the first 4, 8 and 12 frames (ATE_SPAN 4) against the JAX run's."""
    bound = [[0.0, 7.0], [0.0, 3.0], [0.0, 5.4]]
    cfg = tiny_config(
        dataset="synthetic_large",
        data={"output": str(tmp_path), "exp_name": "bench", "synthetic": {
            "n_frames": CORRIDOR_WALK, "n_rooms": 2, "room_width": 3.4,
            "room_depth": 3.2, "corridor_width": 2.0, "n_boxes_per_room": 4,
            "n_spheres_per_room": 2, "ramp_frames": 3}},
        RO={"particle_iter_lens": 6, "depth_level": [4, 2, 1],
            "eval_mode": "pallas", "PST_size": [256, 128, 128],
            "init_size": 0.02, "count_search": 100,
            "tsdf_interp": "nearest"},
        volume={"voxel_size": 0.025, "t_treshold": 0.1},
        tracking={"harvest_depth": 1},
        mapping={"bound": bound, "marching_cubes_bound": bound})
    assert bench_torch.configure(cfg, "corridor.yaml", {}) == CORRIDOR_WALK
    cfg["data"]["output"] = str(tmp_path)
    monkeypatch.setattr(bench_torch, "ATE_SPAN", 4)
    res = _run_against_jax(cfg, N_CORRIDOR, tmp_path, CORRIDOR_RO_TOL)
    assert res["recentres"] >= 1
    assert [row[0] for row in res["ate_by_frames"]] == [4, 8, 12]
    assert res["ate_by_frames"][-1][1:] == [res["ate_rmse_cm"],
                                            res["ate_rmse_cm_ro_only"]]


def _guarded(code_args, env):
    """Run bench_torch.py's main in a process where jax, yaml and the JAX
    package cannot be imported (test_torch_config's guard)."""
    code = (
        "import sys, runpy\n"
        "for m in ('jax', 'jaxlib', 'yaml', 'remixfusion_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"sys.argv = ['bench_torch.py'] + {code_args!r}\n"
        f"runpy.run_path({os.path.join(ROOT, 'bench_torch.py')!r}, "
        "run_name='__main__')\n")
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600,
                          cwd=env["BENCH_CWD"])


def _tiny_yaml(tmp_path):
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(tiny_config(), default_flow_style=None))
    return str(path)


def test_cli_runs_without_jax_or_pyyaml(tmp_path):
    """`bench_torch.py --config <tiny yaml> --device cpu` at BENCH_FRAMES 8,
    BENCH_WARMUP 2: the last stdout line holds bench.py's four keys with
    the device named; the mesh and ATE lines are on stderr; the outputs
    land in output/bench_torch/tiny under the working directory."""
    env = child_env(PYTHONPATH=ROOT, BENCH_FRAMES="8", BENCH_WARMUP="2",
                    BENCH_CWD=str(tmp_path))
    out = _guarded(["--config", _tiny_yaml(tmp_path), "--device", "cpu"],
                   env)
    assert out.returncode == 0, out.stderr[-4000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(last) == {"metric", "value", "unit", "vs_baseline"}
    assert last["unit"] == "fps" and last["value"] > 0
    assert last["vs_baseline"] == round(last["value"] / 15.0, 3)
    assert last["metric"].endswith("BS3D-like settings, CPU)")
    assert "64x48, tiny" in last["metric"]
    err = out.stderr.splitlines()
    for key in ("# mesh: accuracy_cm=", "# ate_rmse_cm=",
                "# ate_rmse_cm_ro_only="):
        assert any(line.startswith(key) for line in err), key
        assert key not in out.stdout
    result = json.loads(next(line for line in err
                             if line.startswith("# result "))[9:])
    assert result["frames"] == 6 and result["tracked_frames"] == 7
    assert result["mesh"]["f1"] > 0 and result["device"] == "cpu"
    run_dir = tmp_path / "output" / "bench_torch" / "tiny"
    for name in ("mesh.ply", "mesh_cull_occlusion.ply", "gt_mesh_culled.ply"):
        assert (run_dir / name).stat().st_size > 0, name


def test_cli_fails_without_a_card(tmp_path):
    """With no card and no --device cpu the bench refuses to run and says
    why (no fallback to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    env = child_env(PYTHONPATH=ROOT, BENCH_FRAMES="8", BENCH_WARMUP="2",
                    BENCH_CWD=str(tmp_path))
    out = _guarded(["--config", _tiny_yaml(tmp_path)], env)
    assert out.returncode != 0
    assert "CUDA device" in out.stderr and "device='cpu'" in out.stderr
    assert not out.stdout.strip()
