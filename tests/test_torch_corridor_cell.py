"""The benchmark's building-scale cell, cpgrid_building.corridor, on the
CPU: its files load as the cell runs them, and a miniature of it runs
through slambench's run.run_cell with the cell's own limits. The
miniature: a two-room synthetic_large building at 48x64, a non-cubic
80x40x80 brick volume at 5 cm, and a 64-frame walk of ~33 cm a frame that
re-centres the volume by whole bricks, the first time in the window along
two axes at once. A sound run is correct; a re-centre that shifts the
data one brick too far and a selection missing half its bricks are not;
a traced run reports the re-centre and inline-selection metrics.

    python -m pytest tests/test_torch_corridor_cell.py -q
"""

from __future__ import annotations

import copy
import importlib.util
import json
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "slambench")
for p in (BENCH, os.path.join(BENCH, "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness.spec import Cell, load_benchmark, metric_reader  # noqa: E402
from slambench_tiny import TINY, make_tree  # noqa: E402

CELL = "cpgrid_building.corridor"
TINY_CELL = "tiny_building.walk"
N_FRAMES = 64
# the window starts at frame WARMUP + 1; the walk's re-centres fall at
# frames 10, 13, ..., 26, then 29 along x and z at once, ..., 51, 54, 59
WARMUP = 27
TWO_AXES_AT = 29
SEED = 3141592653
NEW_METRICS = ("recentre.host_ms", "select.inline_ms")


def corridor_limits() -> dict:
    with open(os.path.join(BENCH, "cells", CELL + ".json")) as f:
        return json.load(f)["limits"]


def tiny_building() -> tuple:
    """(configuration, traffic) of the miniature: the tiny configuration
    on a two-room building with the corridor's far 8 m, a 4 x 2 x 4 m
    moving volume at 5 cm, and a walk of ~33 cm a frame."""
    cfg = copy.deepcopy(TINY)
    cfg["volume"]["y_config"]["len"] = 1
    cfg["cam"]["far"] = 8.0
    bound = [[0.0, 8.4], [0.0, 3.0], [0.0, 6.0]]
    cfg["mapping"]["bound"] = bound
    cfg["mapping"]["marching_cubes_bound"] = copy.deepcopy(bound)
    traffic = {"about": "a two-room miniature of the corridor walk",
               "dataset": "synthetic_large",
               "synthetic": {"n_frames": N_FRAMES, "scene_seed": 3,
                             "n_rooms": 2, "room_width": 4.0,
                             "room_depth": 3.5, "height": 3.0,
                             "corridor_width": 2.0}}
    return cfg, traffic


def make_building_tree(tmp) -> str:
    """The miniature tree of slambench_tiny with the cell
    tiny_building.walk added (the corridor cell's limits), listed in every
    per-layer metric that names its cells. Returns its slambench
    directory."""
    tmp = str(tmp)
    bench_dir = make_tree(tmp)
    cfg, traffic = tiny_building()
    files = {os.path.join("configs", "tiny_building.json"): cfg,
             os.path.join("traffic", "walk.json"): traffic,
             os.path.join("cells", TINY_CELL + ".json"): {
                 "n_frames": N_FRAMES, "warmup_frames": WARMUP,
                 "limits": corridor_limits()}}
    for rel, obj in files.items():
        with open(os.path.join(bench_dir, rel), "w") as f:
            json.dump(obj, f)
    path = os.path.join(tmp, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny_building", "source": "tests",
                             "file": "slambench/configs/tiny_building.json",
                             "reduced": [], "why": "CPU tests"})
    bench["workloads"].append({"name": TINY_CELL, "config": "tiny_building",
                               "traffic": "walk", "chips": 1,
                               "why": "CPU tests"})
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(TINY_CELL)
    with open(path, "w") as f:
        json.dump(bench, f)
    return bench_dir


def bench_run_module():
    """slambench/run.py, loaded by its path (the repository's root has a
    run.py of its own)."""
    spec = importlib.util.spec_from_file_location(
        "slambench_run", os.path.join(BENCH, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def walk_true_poses(monkeypatch):
    """The miniature's tracker starts each frame from the walk's true
    pose, and the host's re-centre and brick selection take that pose:
    the tiny tracker (48x64, 4 iterations) does not hold a walk of ~33 cm
    a frame by itself, and the re-centres then fall where the walk puts
    them, whatever the tracker's rounding."""
    from remixfusion_tpu_torch import host_to_device
    from remixfusion_tpu_torch.slam import pipeline

    cls = pipeline.RemixFusionTorch
    orig_track = cls.track_frame

    def track_frame(self, frame_id, batch):
        self.walk_frame = frame_id
        return orig_track(self, frame_id, batch)

    monkeypatch.setattr(cls, "track_frame", track_frame)
    monkeypatch.setattr(cls, "_host_pose_estimate",
                        lambda self, frame_id: self.pose_gt[frame_id].copy())
    monkeypatch.setattr(cls, "_predict_init", lambda self: host_to_device(
        self.pose_gt[self.walk_frame], self.device))


def run_building(tmp, monkeypatch, trace=False) -> dict:
    """One run of the miniature on the CPU through run.run_cell."""
    walk_true_poses(monkeypatch)
    bench_run = bench_run_module()
    bench_dir = make_building_tree(tmp)
    work = os.path.join(str(tmp), "work")
    os.makedirs(os.path.join(work, "tmp"), exist_ok=True)
    old_work, old_tmp = bench_run.WORK, tempfile.tempdir
    bench_run.WORK = work
    tempfile.tempdir = os.path.join(work, "tmp")
    try:
        cell = Cell(load_benchmark(str(tmp)), TINY_CELL, bench_dir=bench_dir)
        return bench_run.run_cell(cell, SEED, 120.0, trace, False,
                                  torch.device("cpu"))
    finally:
        bench_run.WORK, tempfile.tempdir = old_work, old_tmp


def record_shifts(monkeypatch) -> list:
    """[(frame, the origin's move in voxels, whether the move went the
    whole-brick path, tsdf.shift_volume_bm)] of every re-centre of the
    run."""
    from remixfusion_tpu_torch.ops import tsdf
    from remixfusion_tpu_torch.tracking import volume

    seen, whole = [], []
    orig = volume.MovingVolume.check_move
    orig_bm = tsdf.shift_volume_bm

    def shift_volume_bm(*a, **k):
        whole.append(True)
        return orig_bm(*a, **k)

    def check_move(self, cur_id, c2w):
        before = self.vol_bnds[:, 0].copy()
        whole.clear()
        moved = orig(self, cur_id, c2w)
        if moved:
            move = np.round((self.vol_bnds[:, 0] - before)
                            / self.voxel_size).astype(int)
            seen.append((cur_id, move, whole == [True]))
        return moved

    monkeypatch.setattr(tsdf, "shift_volume_bm", shift_volume_bm)
    monkeypatch.setattr(volume.MovingVolume, "check_move", check_move)
    return seen


def test_a_sound_miniature_corridor_run_is_correct(tmp_path, monkeypatch):
    shifts = record_shifts(monkeypatch)
    res = run_building(tmp_path, monkeypatch)
    assert res["correct"], res["checks"]
    assert res["attempted"] == N_FRAMES - WARMUP - 1 and res["failed"] == 0
    assert [r[0] for r in res["checks"]] == list(corridor_limits())
    assert {"fps", "frame_p95_ms", "ate_cm", "setup_s"} == set(
        res["metrics"])
    # whole-brick re-centres (20 voxels a metre at 5 cm); the window's
    # first, which recentre.gap checks, along x and z at once
    assert len(shifts) >= 2, shifts
    assert all(whole and not (move % 10).any()
               for _, move, whole in shifts), shifts
    first = [(f, move) for f, move, _ in shifts if f > WARMUP][0]
    assert first[0] == TWO_AXES_AT and np.count_nonzero(first[1]) == 2, \
        shifts


def _fault_recentre_off_by_a_brick(monkeypatch):
    """The whole-brick shift moves the data one brick further along x
    than the origin moves."""
    from remixfusion_tpu_torch.ops import tsdf

    orig = tsdf.shift_volume_bm

    def shift_volume_bm(vol, new_origin, voxel_size, layout, dims):
        bumped = new_origin.clone()
        bumped[0] += voxel_size * layout[0]
        return orig(vol, bumped, voxel_size, layout, dims)._replace(
            origin=new_origin.to(torch.float32))

    monkeypatch.setattr(tsdf, "shift_volume_bm", shift_volume_bm)


def _fault_half_the_surface_bricks(monkeypatch):
    """Every other brick of each new selection, near-surface ones
    included, left out."""
    from remixfusion_tpu_torch.tracking import volume

    orig = volume.MovingVolume.frame_bricks_pure

    def frame_bricks_pure(self, *a, **k):
        bricks, near_flat = orig(self, *a, **k)
        return bricks[::2], near_flat

    monkeypatch.setattr(volume.MovingVolume, "frame_bricks_pure",
                        frame_bricks_pure)


@pytest.mark.parametrize("fault,number", [
    (_fault_recentre_off_by_a_brick, "recentre.gap"),
    (_fault_half_the_surface_bricks, "select.miss"),
])
def test_a_planted_fault_in_the_miniature_is_not_correct(
        tmp_path, monkeypatch, fault, number):
    fault(monkeypatch)
    res = run_building(tmp_path, monkeypatch)
    assert not res["correct"]
    rows = {name: (v, lim) for name, v, lim in res["checks"]}
    v, lim = rows[number]
    assert not v <= lim, rows


def test_the_traced_miniature_reports_the_recentre_and_inline_metrics(
        tmp_path, monkeypatch):
    res = run_building(tmp_path, monkeypatch, trace=True)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    # the traced frames, the walk's last 15, re-centre the volume and
    # then select inline
    for name in NEW_METRICS:
        assert m[name]["value"] > 0, name
        assert m[name]["unit"] == "ms/frame"
    assert m["select.host_ms"]["value"] > m["recentre.host_ms"]["value"]


@pytest.mark.parametrize("name,span", [
    ("recentre.host_ms", "slice.select.recentre"),
    ("select.inline_ms", "slice.select.bricks"),
])
def test_a_new_reader_reads_its_span_a_frame(name, span):
    read = metric_reader(name)
    assert read({"frames": 15, "span_s": {"slice.select": 0.3}}) is None
    spans = {"slice.select": 0.3, "slice.select.recentre": 0.03,
             "slice.select.recentre.shift": 0.02,
             "slice.select.bricks": 0.06,
             "slice.select.bricks.inline": 0.05}
    assert read({"frames": 15, "span_s": spans}) == pytest.approx(
        1e3 * spans[span] / 15)


def test_the_corridor_cell_loads_as_the_cell_runs_it():
    from remixfusion_tpu_torch.tracking.volume import MovingVolume

    bench = load_benchmark(ROOT)
    cell = Cell(bench, CELL)
    assert cell.entry["chips"] == 1
    cfg, n = cell.run_config()
    assert n == 800 and cfg["data"]["synthetic"]["n_frames"] == 800
    assert cfg["dataset"] == "synthetic_large"
    assert int(cell.spec["warmup_frames"]) == 30
    assert set(cell.spec["limits"]) == set(corridor_limits())
    # the volume as the port sizes it, without allocating it
    mv = MovingVolume(cfg, np.eye(4), "meta")
    assert mv.dims == (700, 300, 700) and mv.voxel_size == 0.02
    assert mv.state.tsdf.shape[0] == 147000 and mv.brick_budget == 36864
    assert (cfg["cam"]["H"], cfg["cam"]["W"]) == (720, 1280)
    names = {m["name"] for m in cell.per_layer()}
    assert set(NEW_METRICS) <= names
    assert "brick_eval.roofline_pct" not in names


def test_the_configuration_is_bs3d_resolved():
    """slambench/configs/cpgrid_building.json is configs/BS3D/BS3D.yaml
    resolved, but for the keys `reduced` names (the synthetic building in
    place of a capture, generated candidate tables in place of the PFO
    files, the constant-speed prediction for a walk of ~7 cm a frame,
    BS3D's z-up volume lengths on the y-up building) and the keys
    BS3D.yaml lacks: the scene, the building's bound, and the
    list of what was assumed."""
    from remixfusion_tpu_torch.config import load_config

    entry = {c["name"]: c for c in load_benchmark(ROOT)["configs"]}[
        "cpgrid_building"]
    with open(os.path.join(ROOT, entry["file"])) as f:
        got = json.load(f)
    want = load_config(os.path.join(ROOT, "configs", "BS3D", "BS3D.yaml"))
    want.pop("inherit_from", None)
    assert entry["reduced"] == ["dataset", "RO.PST_path",
                                "tracking.const_speed",
                                "volume.y_config.len", "volume.z_config.len"]
    assert want["dataset"] == "BS3D" and want["RO"]["PST_path"]
    assert want["tracking"]["const_speed"] is False
    lens = [want["volume"][a + "_config"]["len"] for a in "xyz"]
    assert lens == [7, 7, 3]
    want["dataset"] = "synthetic_large"
    want["RO"]["PST_path"] = ""
    want["tracking"]["const_speed"] = True
    want["volume"]["y_config"]["len"] = 3
    want["volume"]["z_config"]["len"] = 7
    assert len(got.pop("assumed")) == 5
    with open(os.path.join(BENCH, "traffic", "corridor.json")) as f:
        assert got["data"].pop("synthetic") == json.load(f)["synthetic"]
    bound = [[0.0, 22.0], [0.0, 3.0], [0.0, 10.0]]
    assert got["mapping"].pop("bound") == bound
    assert got["mapping"].pop("marching_cubes_bound") == bound
    assert got == want
