"""Headless reconstruction visualizer.

Counterpart of remixfusion_tpu.tools.viz (the offline replacement for the
reference's open3d viewer, tools/viz.py, tools/visualizer.py): renders a
mesh from the estimated trajectory with the port's z-buffer rasterizer
(utils/raster, host C++) as depth-shaded frames, and draws the trajectory
from above (x against z, the estimate blue, the ground truth black), all
as PNG through utils/imageio, ready for tools/rgb2video:

    python -m remixfusion_tpu_torch.tools.viz --config <yaml> --mesh mesh.ply \
        --poses all_poses.npy [--out_dir viz_out] [--every 10]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from remixfusion_tpu_torch.utils import plot
from remixfusion_tpu_torch.utils.imageio import write_png
from remixfusion_tpu_torch.utils.meshio import read_ply
from remixfusion_tpu_torch.utils.raster import render_mesh_depth


def shade_depth(depth: np.ndarray) -> np.ndarray:
    """Depth -> normal-shaded grayscale uint8 image via screen-space
    gradients (0 where the depth is not positive)."""
    d = depth.copy()
    valid = d > 0
    gx = np.zeros_like(d)
    gy = np.zeros_like(d)
    gx[:, 1:-1] = (d[:, 2:] - d[:, :-2]) * 0.5
    gy[1:-1, :] = (d[2:, :] - d[:-2, :]) * 0.5
    n = 1.0 / np.sqrt(gx * gx + gy * gy + 1.0)
    light = np.clip(0.2 + 0.8 * n, 0, 1)
    img = np.where(valid, light, 0.0)
    return (img * 255).astype(np.uint8)


def render_sequence(mesh_path, poses, K, H, W, out_dir, every=1):
    """viz_<i>.png, the shaded depth of the mesh seen from every `every`-th
    pose; returns the paths written."""
    verts, faces = read_ply(mesh_path)
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for i in range(0, len(poses), every):
        depth = render_mesh_depth(verts, faces, K, poses[i], H, W)
        path = os.path.join(out_dir, f"viz_{i:05d}.png")
        write_png(path, shade_depth(depth))
        written.append(path)
    return written


def plot_trajectory(poses, gt_poses=None, out_path="trajectory.png"):
    """The trajectory from above (x against z) as a PNG."""
    poses = np.asarray(poses)
    lines = []
    if gt_poses is not None:
        gt = np.asarray(gt_poses)
        lines.append((gt[:, 0, 3], gt[:, 2, 3], plot.BLACK))
    lines.append((poses[:, 0, 3], poses[:, 2, 3], plot.BLUE))
    write_png(out_path, plot.plot_polylines(lines))
    return out_path


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--mesh", required=True)
    parser.add_argument("--poses", required=True, help="[N,4,4] .npy")
    parser.add_argument("--out_dir", default="viz_out")
    parser.add_argument("--every", type=int, default=10)
    args = parser.parse_args()

    from remixfusion_tpu_torch.config import load_config
    from remixfusion_tpu_torch.datasets import get_dataset

    cfg = load_config(args.config)
    ds = get_dataset(cfg)
    poses = np.load(args.poses)
    frames = render_sequence(args.mesh, poses, ds.K(), ds.H, ds.W,
                             args.out_dir, every=args.every)
    plot_trajectory(poses, np.stack([np.asarray(p) for p in ds.poses]),
                    os.path.join(args.out_dir, "trajectory.png"))
    print(f"wrote {len(frames)} frames to {args.out_dir}")


if __name__ == "__main__":
    main()
