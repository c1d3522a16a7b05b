"""Dataset readiness checker: validate a config's on-disk data layout.

The port's copy of remixfusion_tpu.tools.check_data, reading through the
port's loaders. For users bringing real captures (BS3D / Replica / ScanNet
/ TUM / FastCaMo / uHumans / Azure / iPhone / ...):
`python -m remixfusion_tpu_torch.tools.check_data --config
configs/BS3D/BS3D.yaml [--input_folder DIR] [--strict]` verifies, without
loading images, that the directory named by `data.datadir` matches the
layout the loader expects (reference layouts: datasets/dataset.py:
89-1506), reports what is missing, and with --strict instantiates the
loader and reads the first frame. Exit code 0: ready for
`python run_torch.py --config ... --input_folder ...`.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

# dataset name -> list of (requirement-kind, relpath-or-glob, description)
# kinds: 'dir' (must exist), 'glob' (>= 1 match), 'file' (must exist),
#        'file_alt' (at least one of the |-separated alternatives)
LAYOUTS = {
    "replica": [
        ("glob", "results/frame*.jpg", "color frames"),
        ("glob", "results/depth*.png", "depth frames"),
        ("file", "traj.txt", "trajectory (flat 4x4 rows)"),
    ],
    "fastsyn": [
        ("glob", "color/*.png|results/frame*.jpg", "color frames"),
        ("glob", "depth/*.png|results/depth*.png", "depth frames"),
        ("file", "traj.txt", "trajectory (flat 4x4 rows)"),
    ],
    "bs3d": [
        ("glob", "color/*.jpg|color/*.png", "color frames"),
        ("glob", "depth/*.png", "depth frames (16-bit png, mm)"),
        ("file", "poses.txt", "poses (idx tx ty tz qx qy qz qw)"),
    ],
    "uhumans": [
        ("glob", "color/*.jpg|color/*.png", "color frames"),
        ("glob", "depth/*.png", "depth frames"),
        ("file", "poses.txt", "poses (idx tx ty tz qx qy qz qw; run "
                              "tools/preprocess.py on raw uHumans2 first)"),
    ],
    "scannet": [
        ("glob", "color/*.jpg", "color frames (numeric names)"),
        ("glob", "depth/*.png", "depth frames"),
        ("glob", "pose/*.txt", "per-frame 4x4 pose files"),
    ],
    "azure": [
        ("glob", "color/*.jpg", "color frames"),
        ("glob", "depth/*.png", "depth frames"),
        ("glob", "pose/*.txt", "per-frame 4x4 pose files"),
    ],
    "rgb": [
        ("glob", "color/*.jpg", "color frames"),
        ("glob", "depth/*.png", "depth frames"),
        ("glob", "pose/*.txt", "per-frame 4x4 pose files"),
    ],
    "realsense": [
        ("glob", "color/*.jpg", "color frames"),
        ("glob", "depth/*.png", "depth frames"),
        ("glob", "pose/*.txt", "per-frame 4x4 pose files"),
    ],
    "largeindoor": [
        ("glob", "color/*.png", "color frames"),
        ("glob", "depth/*.png", "depth frames"),
        ("glob", "pose/*.txt", "per-frame 4x4 pose files"),
    ],
    "iphone": [
        ("glob", "images/*.png", "color frames"),
        ("glob", "depth/*.png", "depth frames"),
        ("file", "odometry.csv", "ARKit odometry csv"),
    ],
    "tum": [
        ("file", "rgb.txt", "rgb timestamp index"),
        ("file", "depth.txt", "depth timestamp index"),
        ("file_alt", "groundtruth.txt|pose.txt", "trajectory"),
        ("glob", "rgb/*.png", "color frames"),
        ("glob", "depth/*.png", "depth frames"),
    ],
    "synthetic": [],
}

CAM_KEYS = ["H", "W", "fx", "fy", "cx", "cy", "png_depth_scale"]


def _kind(cfg) -> str:
    """The layout key of cfg['dataset'], normalized as the dataset factory
    normalizes it ('Fast_syn' -> 'fastsyn'; the JAX tool only lowercases,
    and reports 'Fast_syn' configs as unknown)."""
    return cfg["dataset"].lower().replace("_", "")


def check_layout(cfg) -> list[str]:
    """Returns a list of problems (empty = layout OK)."""
    name = _kind(cfg)
    if name not in LAYOUTS:
        return [f"unknown dataset kind '{name}' "
                f"(known: {sorted(LAYOUTS)})"]
    problems = []
    base = cfg["data"].get("datadir", "")
    if name != "synthetic" and not os.path.isdir(base):
        return [f"data.datadir does not exist: {base!r}"]
    for kind, rel, desc in LAYOUTS[name]:
        alts = rel.split("|")
        if kind in ("glob",):
            counts = {a: len(glob.glob(os.path.join(base, a)))
                      for a in alts}
            if not any(counts.values()):
                problems.append(f"missing {desc}: no match for "
                                f"{' or '.join(alts)} under {base}")
        elif kind == "file":
            if not os.path.isfile(os.path.join(base, rel)):
                problems.append(f"missing {desc}: {rel}")
        elif kind == "file_alt":
            if not any(os.path.isfile(os.path.join(base, a))
                       for a in alts):
                problems.append(f"missing {desc}: one of {alts}")
    for k in CAM_KEYS:
        if k not in cfg.get("cam", {}):
            problems.append(f"config missing cam.{k}")
    return problems


def frame_count_consistency(cfg) -> list[str]:
    """Cross-check color/depth/pose counts where the layout implies 1:1."""
    name = _kind(cfg)
    base = cfg["data"].get("datadir", "")
    counts = {}
    for kind, rel, desc in LAYOUTS.get(name, []):
        if kind != "glob":
            continue
        for a in rel.split("|"):
            n = len(glob.glob(os.path.join(base, a)))
            if n:
                counts[desc] = n
                break
    if len(set(counts.values())) > 1:
        return [f"frame-count mismatch: {counts}"]
    return []


def main(argv=None):
    from remixfusion_tpu_torch.config import load_config

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--input_folder",
                    help="overrides data.datadir from the config")
    ap.add_argument("--strict", action="store_true",
                    help="also instantiate the loader and read frame 0")
    args = ap.parse_args(argv)

    cfg = load_config(args.config)
    if args.input_folder is not None:
        cfg["data"]["datadir"] = args.input_folder
    problems = check_layout(cfg)
    if not problems:
        problems += frame_count_consistency(cfg)
    if problems:
        print(f"NOT READY ({cfg['dataset']} @ "
              f"{cfg['data'].get('datadir')}):")
        for p in problems:
            print(f"  - {p}")
        return 1
    print(f"layout OK: {cfg['dataset']} @ {cfg['data'].get('datadir')}")
    if args.strict and _kind(cfg) != "synthetic":
        from remixfusion_tpu_torch.datasets import get_dataset
        ds = get_dataset(cfg)
        fr = ds[0]
        print(f"loader OK: {len(ds)} frames, first frame "
              f"rgb {fr['rgb'].shape} depth {fr['depth'].shape} "
              f"depth range [{fr['depth'].min():.2f}, "
              f"{fr['depth'].max():.2f}] m")
    return 0


if __name__ == "__main__":
    sys.exit(main())
