"""A miniature benchmark tree for the CPU tests: the harness's files
copied into a temporary directory beside a tiny configuration (48x64
frames, an 80^3 brick volume at 5 cm, a 48^3 grid, 4 tracker iterations,
a mapping round every 2 frames), so that a cell runs on the CPU in
seconds, with the plain versions of the port's kernels."""

from __future__ import annotations

import copy
import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {
    "dataset": "synthetic", "print_ape": 0,
    "data": {"downsample": 1, "sc_factor": 1, "translation": 0,
             "num_workers": 0, "exp_name": "tiny", "output": "output",
             "datadir": "", "trainskip": 1,
             "synthetic": {"n_frames": 12, "room_size": 4.0,
                           "sphere_radius": 0.6, "orbit_radius": 1.2,
                           "orbit_degrees": 40.0}},
    "globalV": {"use": 1, "base_resolution": 48, "n_levels": 1,
                "per_level_scale": 1, "n_features_per_level": 4},
    "mapping": {"sample": 128, "first_mesh": False, "iters": 2,
                "BA_iters": 2, "lr_embed": 0.01, "lr_embed_res": 0.01,
                "lr_decoder": 0.01, "lr_rot": 5e-4, "lr_trans": 5e-4,
                "lr_pose": 5e-4, "keyframe_every": 2, "map_every": 2,
                "n_pixels": 0.05, "first_iters": 10, "optim_cur": False,
                "min_pixels_cur": 20, "map_accum_step": 1,
                "pose_accum_step": 1, "map_wait_step": 0,
                "filter_depth": False, "opt_pose": True, "clamp": 2.0,
                "pose_scale": 1.0, "save_ckpt": False,
                "bound": [[0.0, 4.0], [0.0, 4.0], [0.0, 4.0]],
                "marching_cubes_bound": [[0.0, 4.0], [0.0, 4.0],
                                         [0.0, 4.0]]},
    "tracking": {"ignore_edge_W": 2, "ignore_edge_H": 2,
                 "const_speed": True},
    "RO": {"eval_mode": "pallas", "tsdf_interp": "nearest",
           "init_size": 0.02, "scaling_coefficient": 0.09,
           "particle_iter_lens": 4, "PST_path": "",
           "PST_size": [256, 128, 64], "count_search": 50,
           "fix_level_index": 0, "filter_weight": 2, "rgb_rose": 0,
           "rgb_rose_weight": 0.1, "save_volume": 0, "save_freq": 1000,
           "cut": 0, "cut_dist": 8.0, "sample_range": 0.0,
           "iterative_scale": False},
    "grid": {"enc": "CPGrid", "tcnn_encoding": True, "hash_size": 12,
             "voxel_color": 0.08, "voxel_sdf": 0.08},
    "pos": {"enc": "OneBlob", "n_bins": 8},
    "decoder": {"geo_feat_dim": 15, "hidden_dim": 32, "num_layers": 2,
                "num_layers_color": 2, "hidden_dim_color": 32,
                "tcnn_network": False},
    "cam": {"H": 48, "W": 64, "fx": 40.0, "fy": 40.0, "cx": 31.5,
            "cy": 23.5, "png_depth_scale": 1000.0, "crop_edge": 0,
            "near": 0.0, "far": 5.0, "depth_trunc": 100.0},
    "training": {"rgb_weight": 5.0, "depth_weight": 0.1, "sdf_weight": 1000,
                 "fs_weight": 10, "surface_weight": 0, "eikonal_weight": 0,
                 "smooth_weight": 0.001, "smooth_pts": 8, "smooth_vox": 0.1,
                 "smooth_margin": 0.05, "n_samples_d": 5, "range_d": 0.25,
                 "n_range_d": 12, "n_importance": 0, "perturb": 1,
                 "white_bkgd": False, "c_trunc": 0.25, "trunc": 0.06,
                 "rot_rep": "quat", "rgb_missing": 0.0},
    "mesh": {"resolution": 64, "vis": 0, "voxel_eval": 0.1,
             "voxel_final": 0.1, "visualisation": False,
             "mesh_bound_scale": 1.02, "only_final": 1, "render_img": 0},
    "volume": {"voxel_size": 0.05, "version": "center", "trunc": 0.06,
               "weight_threshold": 2.0, "weight_clamp": 1.0,
               "t_treshold": 1,
               "x_config": {"fix": 0, "len": 2, "range": [0, 1]},
               "y_config": {"fix": 0, "len": 2, "range": [0, 1]},
               "z_config": {"fix": 0, "len": 2, "range": [0, 1]},
               "first_len": 2, "second_len": 2, "third_len": 2,
               "more_angel_t": 20},
    "video": {"save": False, "save_freq": 20},
}


def orbit_limits() -> dict:
    """The cpgrid.orbit cell's limits, but for the re-centre's: the tiny
    orbit stays inside its volume (tests/test_slambench_harness.py holds
    the re-centre's reference against the port's shifts)."""
    with open(os.path.join(BENCH, "cells", "cpgrid.orbit.json")) as f:
        limits = json.load(f)["limits"]
    limits.pop("recentre.gap", None)
    return limits


def make_tree(tmp, enc="CPGrid", limits=None, n_frames=40, warmup=4):
    """A benchmark tree under tmp with the real harness, metrics and
    traffic, and one tiny cell `tiny.orbit` (limits: orbit_limits() unless
    given). Returns its slambench directory."""
    tmp = str(tmp)
    bench_dir = os.path.join(tmp, "slambench")
    shutil.copytree(BENCH, bench_dir, ignore=shutil.ignore_patterns(
        "work", "tests", "__pycache__"))
    cfg = copy.deepcopy(TINY)
    cfg["grid"]["enc"] = enc
    with open(os.path.join(bench_dir, "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    if limits is None:
        limits = orbit_limits()
    with open(os.path.join(bench_dir, "cells", "tiny.orbit.json"), "w") as f:
        json.dump({"n_frames": n_frames, "warmup_frames": warmup,
                   "limits": limits}, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny", "source": "tests",
                             "file": "slambench/configs/tiny.json",
                             "reduced": [], "why": "CPU tests"})
    bench["workloads"].append({"name": "tiny.orbit", "config": "tiny",
                               "traffic": "orbit", "chips": 1,
                               "why": "CPU tests"})
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny.orbit")
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return bench_dir


def run_tiny(tmp, seconds=120.0, trace=False, seed=20251018, **tree):
    """One run of the tiny cell on the CPU through run.run_cell: the
    result dict."""
    import tempfile

    import torch

    import run as bench_run
    from harness.spec import Cell, load_benchmark

    bench_dir = make_tree(tmp, **tree)
    work = os.path.join(str(tmp), "work")
    os.makedirs(os.path.join(work, "tmp"), exist_ok=True)
    old_work, old_tmp = bench_run.WORK, tempfile.tempdir
    bench_run.WORK = work
    tempfile.tempdir = os.path.join(work, "tmp")
    try:
        cell = Cell(load_benchmark(str(tmp)), "tiny.orbit",
                    bench_dir=bench_dir)
        return bench_run.run_cell(cell, seed, seconds, trace, False,
                                  torch.device("cpu"))
    finally:
        bench_run.WORK, tempfile.tempdir = old_work, old_tmp
