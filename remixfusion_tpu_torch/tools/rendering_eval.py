"""Offline rendering evaluation: PSNR, SSIM, perceptual distance, depth-L1.

Counterpart of the root rendering_eval.py of the JAX package (reference
rendering_eval.py:1-57, Mapper.calc_2d_metric mp_slam/mapper.py:729-807):
rebuild the scene model from a checkpoint, render every `gap`-th frame of
the run with its estimated poses (depth-guided by the frame's depth), and
score the renders against the dataset's frames, masked by valid depth. The
renders and the metrics run on the card unless --device cpu:

    python rendering_eval_torch.py --config <yaml> [--ckpt checkpoint.npz] \
        [--gap 10] [--save] [--device cuda|cpu]

The poses come from <out_dir>/all_poses.npy (the run's frames only, so only
the frames the run tracked are rendered), else from the checkpoint's
trajectory. --save writes <out_dir>/psnr/<i>.png (8-bit colour) and
<i>_d.png (16-bit depth in mm).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from remixfusion_tpu_torch.utils.imageio import write_png
from remixfusion_tpu_torch.utils.metrics import mse2psnr, \
    perceptual_distance, ssim


def calc_2d_metric(slam, poses, gap=10, save=False):
    """Render frames 0, gap, 2 gap, ... < len(poses) of slam's dataset at
    `poses` and score them. Returns {"psnr", "ssim", <kind>, "depth_l1"
    (m), "frames", "render_ms"} where <kind> is "lpips" or
    "rf_perceptual"; render_ms is each frame's render wall time (host
    clock, ending in a device synchronise)."""
    psnrs, ssims, percep, d_l1, render_ms = [], [], [], [], []
    kind = "lpips"
    out_dir = os.path.join(slam.out_dir, "psnr")
    if save:
        os.makedirs(out_dir, exist_ok=True)
    frames = list(range(0, len(poses), gap))
    dev = slam.device
    for i in frames:
        batch = slam.dataset[i]
        gt_rgb = np.asarray(batch["rgb"])
        gt_depth = np.asarray(batch["depth"])
        slam._sync()
        t0 = time.perf_counter()
        rgb, depth = slam.render_frame(poses[i], batch["direction"],
                                       target_depth=gt_depth)
        slam._sync()
        render_ms.append(1000.0 * (time.perf_counter() - t0))
        rgb = np.clip(rgb, 0.0, 1.0)
        if save:
            write_png(os.path.join(out_dir, f"{i}.png"),
                      (rgb * 255).astype(np.uint8))
            write_png(os.path.join(out_dir, f"{i}_d.png"),
                      (depth * 1000).astype(np.uint16))
        valid = gt_depth > 0
        gt_m = gt_rgb * valid[..., None]
        ours_m = rgb * valid[..., None]
        psnrs.append(mse2psnr(float(((gt_m - ours_m) ** 2).mean())))
        d_l1.append(float(np.abs(gt_depth[valid] - depth[valid]).mean()))
        ssims.append(ssim(ours_m, gt_m, device=dev)[1])
        value, kind = perceptual_distance(ours_m, gt_m, device=dev)
        percep.append(value)
        print(f"{i} psnr:{psnrs[-1]:.2f} ssim:{ssims[-1]:.3f} "
              f"d-l1:{d_l1[-1]:.3f}")
    print(f"PSNR: {np.mean(psnrs):.2f}\nSSIM: {np.mean(ssims):.3f}\n"
          f"{kind.upper()}: {np.nanmean(percep):.3f}\n"
          f"D-L1: {np.mean(d_l1):.3f}")
    return {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims)),
            kind: float(np.nanmean(percep)),
            "depth_l1": float(np.mean(d_l1)), "frames": frames,
            "render_ms": render_ms}


def main():
    from remixfusion_tpu_torch.config import load_config
    from remixfusion_tpu_torch.slam import RemixFusionTorch

    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--ckpt", default=None,
                        help="checkpoint.npz (defaults to the output dir)")
    parser.add_argument("--gap", type=int, default=10)
    parser.add_argument("--save", action="store_true")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args()

    slam = RemixFusionTorch(load_config(args.config), device=args.device)
    slam.load_ckpt(args.ckpt or os.path.join(slam.out_dir, "checkpoint.npz"))
    poses_path = os.path.join(slam.out_dir, "all_poses.npy")
    if os.path.exists(poses_path):
        poses = np.load(poses_path)
    else:
        poses = slam.convert_relative_pose_npy()
    out = calc_2d_metric(slam, poses, gap=args.gap, save=args.save)
    print(json.dumps({"rendering_eval": {**out, "device": str(slam.device)}}))


if __name__ == "__main__":
    main()
