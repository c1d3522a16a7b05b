"""RGB-D capture preprocessor: raw timestamped dumps -> organized layout.

The port's copy of remixfusion_tpu.tools.preprocess (reference
preprocess/preprocess.py): generates
timestamp lists from color/ and depth/ folders (filenames are timestamps),
greedily associates nearest timestamps, renames matched pairs to sequential
indices, and rewrites poses.txt so row i corresponds to frame i. Used to
prepare BS3D / uHumans2 style captures for the BS3D loader:

    python -m remixfusion_tpu_torch.tools.preprocess --basedir <capture>
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np


def read_file_list(filename):
    """{timestamp: [fields...]} from 'stamp d1 d2 ...' lines; '#' comments."""
    with open(filename) as f:
        data = f.read()
    lines = data.replace(",", " ").replace("\t", " ").split("\n")
    rows = [[v.strip() for v in line.split(" ") if v.strip()]
            for line in lines if line and line[0] != "#"]
    return {float(r[0]): r[1:] for r in rows if len(r) > 1}


def associate(first_list, second_list, offset=0.0, max_difference=0.02):
    """Greedy nearest-timestamp matching; returns sorted (t1, t2) pairs."""
    potential = sorted(
        (abs(a - (b + offset)), a, b)
        for a in first_list for b in second_list
        if abs(a - (b + offset)) < max_difference)
    used_a, used_b, matches = set(), set(), []
    for _, a, b in potential:
        if a not in used_a and b not in used_b:
            used_a.add(a)
            used_b.add(b)
            matches.append((a, b))
    matches.sort()
    return matches


def generate_timestamp_files(color_dir, depth_dir, output_dir, ext="png"):
    """color.txt / depth.txt with 'timestamp relative/path' rows."""
    os.makedirs(output_dir, exist_ok=True)
    out = []
    for sub, name in ((color_dir, "color"), (depth_dir, "depth")):
        files = sorted(
            (f for f in os.listdir(sub) if f.endswith(ext)),
            key=lambda x: float(os.path.splitext(x)[0]))
        path = os.path.join(output_dir, f"{name}.txt")
        with open(path, "w") as f:
            for fn in files:
                f.write(f"{os.path.splitext(fn)[0]} {name}/{fn}\n")
        out.append(path)
    return tuple(out)


def rename_files(basedir, matches, color_list, depth_list, dry_run=False):
    """Copy matched pairs to color/<i>.png / depth/<i>.png (sequential)."""
    out_color = os.path.join(basedir, "color_organized")
    out_depth = os.path.join(basedir, "depth_organized")
    os.makedirs(out_color, exist_ok=True)
    os.makedirs(out_depth, exist_ok=True)
    kept = []
    for i, (tc, td) in enumerate(matches):
        src_c = os.path.join(basedir, color_list[tc][0])
        src_d = os.path.join(basedir, depth_list[td][0])
        if not dry_run:
            shutil.copy2(src_c, os.path.join(out_color, f"{i}.png"))
            shutil.copy2(src_d, os.path.join(out_depth, f"{i}.png"))
        kept.append((i, tc, td))
    return kept


def rewrite_poses(basedir, matches, pose_file="poses.txt",
                  max_difference=0.05):
    """Associate pose timestamps to the matched color timestamps and write
    poses.txt rows as 'index tx ty tz qx qy qz qw'."""
    poses = read_file_list(os.path.join(basedir, pose_file))
    t_pose = np.array(sorted(poses.keys()))
    rows = []
    for i, (tc, _td) in enumerate(matches):
        j = int(np.argmin(np.abs(t_pose - tc)))
        if abs(t_pose[j] - tc) > max_difference:
            continue
        vals = poses[t_pose[j]]
        rows.append([i] + [float(v) for v in vals[:7]])
    out = os.path.join(basedir, "poses_organized.txt")
    np.savetxt(out, np.asarray(rows), fmt="%.9g")
    return out


def main():
    parser = argparse.ArgumentParser(
        description="Associate + organize a raw RGB-D capture")
    parser.add_argument("--basedir", required=True)
    parser.add_argument("--max_difference", type=float, default=0.02)
    parser.add_argument("--offset", type=float, default=0.0)
    parser.add_argument("--dry_run", action="store_true")
    args = parser.parse_args()

    color_txt, depth_txt = generate_timestamp_files(
        os.path.join(args.basedir, "color"),
        os.path.join(args.basedir, "depth"), args.basedir)
    color_list = read_file_list(color_txt)
    depth_list = read_file_list(depth_txt)
    matches = associate(color_list, depth_list, args.offset,
                        args.max_difference)
    print(f"{len(matches)} associated pairs "
          f"({len(color_list)} color / {len(depth_list)} depth)")
    kept = rename_files(args.basedir, matches, color_list, depth_list,
                        dry_run=args.dry_run)
    print(f"organized {len(kept)} frames")
    if os.path.exists(os.path.join(args.basedir, "poses.txt")):
        out = rewrite_poses(args.basedir, matches)
        print(f"pose index file: {out}")


if __name__ == "__main__":
    main()
