"""Absolute trajectory error (ATE) evaluation, TUM-style (numpy).

Counterpart of remixfusion_tpu.tools.eval_ate (reference tools/eval_ate.py):
timestamp association, Horn closed-form SE(3) alignment, translational RMSE
statistics, an unaligned variant, and the in-pipeline wrappers that append
a result line to tracking_result.txt and draw the trajectories (x against
y, ground truth black, estimate blue: utils/plot, written as PNG).
Runnable as a CLI over [N, 4, 4] .npy pose dumps:

    python -m remixfusion_tpu_torch.tools.eval_ate --est est.npy --gt gt.npy \
        [--no_align] [--plot traj.png]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from remixfusion_tpu_torch.utils import plot
from remixfusion_tpu_torch.utils.imageio import write_png


def associate(first_keys, second_keys, offset=0.0, max_difference=0.02):
    """Greedy nearest-timestamp association (reference eval_ate.py:34-64)."""
    potential = [
        (abs(a - (b + offset)), a, b)
        for a in first_keys for b in second_keys
        if abs(a - (b + offset)) < max_difference
    ]
    potential.sort()
    matches = []
    used_a, used_b = set(), set()
    for _, a, b in potential:
        if a not in used_a and b not in used_b:
            used_a.add(a)
            used_b.add(b)
            matches.append((a, b))
    matches.sort()
    return matches


def align(model: np.ndarray, data: np.ndarray):
    """Horn's closed-form alignment of two [3, N] point sets
    (reference eval_ate.py:66-100). Returns (rot, trans, trans_error)."""
    model_zc = model - model.mean(1, keepdims=True)
    data_zc = data - data.mean(1, keepdims=True)
    W = np.zeros((3, 3))
    for i in range(model.shape[1]):
        W += np.outer(model_zc[:, i], data_zc[:, i])
    U, _, Vh = np.linalg.svd(W.transpose())
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vh) < 0:
        S[2, 2] = -1
    rot = U @ S @ Vh
    trans = data.mean(1, keepdims=True) - rot @ model.mean(1, keepdims=True)
    model_aligned = rot @ model + trans
    err = model_aligned - data
    trans_error = np.sqrt(np.sum(err * err, 0))
    return rot, trans, trans_error


def evaluate_ate(first_list: dict, second_list: dict, plot_path="",
                 no_align=False):
    """first/second: {timestamp: [4, 4] c2w}. Returns stats dict (meters);
    with plot_path, the matched trajectories are drawn there."""
    matches = associate(sorted(first_list.keys()), sorted(second_list.keys()))
    if len(matches) < 2:
        raise ValueError("too few matched poses for ATE")
    first_xyz = np.array(
        [first_list[a][:3, 3] for a, _ in matches]).T
    second_xyz = np.array(
        [second_list[b][:3, 3] for _, b in matches]).T
    if no_align:
        err = first_xyz - second_xyz
        trans_error = np.sqrt(np.sum(err * err, 0))
    else:
        _, _, trans_error = align(first_xyz, second_xyz)
    stats = {
        "compared_pose_pairs": len(matches),
        "rmse": float(np.sqrt(np.mean(trans_error ** 2))),
        "mean": float(np.mean(trans_error)),
        "median": float(np.median(trans_error)),
        "std": float(np.std(trans_error)),
        "min": float(np.min(trans_error)),
        "max": float(np.max(trans_error)),
    }
    if plot_path:
        _plot_traj(first_xyz, second_xyz, plot_path)
    return stats


def _plot_traj(gt_xyz, est_xyz, path):
    """x against y of two [3, N] trajectories as a PNG."""
    write_png(path, plot.plot_polylines([
        (gt_xyz[0], gt_xyz[1], plot.BLACK),
        (est_xyz[0], est_xyz[1], plot.BLUE)]))


def pose_evaluation(poses_gt, poses_est, scale, save_dir, frame_id,
                    img="frame", name="tracking_result.txt", no_align=False):
    """In-pipeline wrapper (reference eval_ate.py:515-581): poses as
    {idx: [4, 4]} or [N, 4, 4]; appends the line "<frame_id> ate-rmse(cm):
    ... mean: ... median: ... pairs: ..." to save_dir/name and draws the
    trajectories into save_dir/<img>_<frame_id>.png. `scale` is unused, as
    in the reference."""
    def to_dict(p):
        if isinstance(p, dict):
            return {float(k): np.asarray(v) for k, v in p.items()}
        p = np.asarray(p)
        return {float(i): p[i] for i in range(len(p))}

    os.makedirs(save_dir, exist_ok=True)
    plot_path = os.path.join(save_dir, f"{img}_{frame_id}.png")
    stats = evaluate_ate(to_dict(poses_gt), to_dict(poses_est),
                         plot_path=plot_path, no_align=no_align)
    line = (f"{frame_id} ate-rmse(cm): {stats['rmse'] * 100:.4f} "
            f"mean: {stats['mean'] * 100:.4f} "
            f"median: {stats['median'] * 100:.4f} "
            f"pairs: {stats['compared_pose_pairs']}\n")
    with open(os.path.join(save_dir, name), "a") as f:
        f.write(line)
    print(line.strip())
    return stats


def pose_evaluation_na(*args, **kwargs):
    """pose_evaluation without the alignment."""
    kwargs["no_align"] = True
    return pose_evaluation(*args, **kwargs)


def pose_evaluation_RO(poses_gt, poses_est, scale, save_dir, frame_id,
                       img="RO", name="RO_result.txt"):
    """ATE of the raw tracker poses (reference eval_ate.py:583-608)."""
    return pose_evaluation(poses_gt, poses_est, scale, save_dir, frame_id,
                           img=img, name=name)


def align_ba(poses_est: np.ndarray, poses_gt: np.ndarray):
    """Horn-align an estimated trajectory onto the ground truth: (aligned
    [N, 4, 4] float32 poses, the 4x4 alignment) (reference
    eval_ate.py:538-553)."""
    rot, trans, _ = align(poses_est[:, :3, 3].T, poses_gt[:, :3, 3].T)
    T = np.eye(4)
    T[:3, :3] = rot
    T[:3, 3] = trans[:, 0]
    out = np.einsum("ij,njk->nik", T, poses_est)
    return out.astype(np.float32), T


def main():
    parser = argparse.ArgumentParser(
        description="ATE over [N,4,4] .npy pose files")
    parser.add_argument("--est", required=True)
    parser.add_argument("--gt", required=True)
    parser.add_argument("--no_align", action="store_true")
    parser.add_argument("--plot", default="",
                        help="draw the trajectories into this PNG")
    args = parser.parse_args()
    est = np.load(args.est)
    gt = np.load(args.gt)
    n = min(len(est), len(gt))
    stats = evaluate_ate(
        {float(i): gt[i] for i in range(n)},
        {float(i): est[i] for i in range(n)},
        plot_path=args.plot, no_align=args.no_align)
    for k, v in stats.items():
        print(f"{k}: {v * 100 if k not in ('compared_pose_pairs',) else v}"
              + (" cm" if k != "compared_pose_pairs" else ""))


if __name__ == "__main__":
    main()
