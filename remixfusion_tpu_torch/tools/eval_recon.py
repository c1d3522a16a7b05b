"""3D reconstruction evaluation: accuracy / completion / ratios / F-score.

Counterpart of remixfusion_tpu.tools.eval_recon (reference
tools/eval_recon.py): sample surface points from each mesh, optionally
ICP-align the reconstruction to the GT, report mean nearest-neighbor
distances (cm), completion/accuracy ratios at a threshold, their
harmonic-mean F-score, and the 2D depth-L1 over random virtual views
(utils/raster.render_mesh_depth). `mesh_quality` is the synthetic bench's
mesh score of a finished run (accuracy against the analytic SDF,
completion against the culled analytic GT mesh).

    python -m remixfusion_tpu_torch.tools.eval_recon --rec_mesh a.ply \
        --gt_mesh b.ply [--runs 3] [--no_align]
    python -m remixfusion_tpu_torch.tools.eval_recon --config <yaml> \
        --run_dir <output>/<exp_name> --frames N
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
from scipy.spatial import cKDTree

from remixfusion_tpu_torch.tools.cull_mesh import cull_one_mesh
from remixfusion_tpu_torch.utils.meshio import read_ply, write_ply_mesh
from remixfusion_tpu_torch.utils.raster import render_mesh_depth


def sample_surface(verts: np.ndarray, faces: np.ndarray, n: int,
                   seed: int = 0) -> np.ndarray:
    """Area-weighted uniform surface sampling of a triangle mesh."""
    rng = np.random.default_rng(seed)
    tri = verts[faces]
    cross = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    area = 0.5 * np.linalg.norm(cross, axis=1)
    if area.sum() <= 0:
        return verts[rng.integers(0, len(verts), n)]
    probs = area / area.sum()
    idx = rng.choice(len(faces), n, p=probs)
    u = rng.random((n, 1))
    v = rng.random((n, 1))
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    t = tri[idx]
    return (t[:, 0] + u * (t[:, 1] - t[:, 0]) + v * (t[:, 2] - t[:, 0])
            ).astype(np.float32)


def icp_align(src: np.ndarray, dst: np.ndarray, n_iters: int = 20,
              threshold: float = 0.1):
    """Point-to-point ICP aligning src -> dst (reference eval_recon.py:53-71
    uses open3d ICP with a distance threshold). Returns a 4x4 transform."""
    T = np.eye(4)
    cur = src.copy()
    tree = cKDTree(dst)
    for _ in range(n_iters):
        d, idx = tree.query(cur, k=1)
        mask = d < threshold
        if mask.sum() < 10:
            break
        a = cur[mask]
        b = dst[idx[mask]]
        ca, cb = a.mean(0), b.mean(0)
        H = (a - ca).T @ (b - cb)
        U, _, Vt = np.linalg.svd(H)
        S = np.eye(3)
        if np.linalg.det(Vt.T @ U.T) < 0:
            S[2, 2] = -1
        R = Vt.T @ S @ U.T
        t = cb - R @ ca
        step = np.eye(4)
        step[:3, :3] = R
        step[:3, 3] = t
        T = step @ T
        cur = cur @ R.T + t
    return T


def completion_ratio(gt_points, rec_points, dist_th=0.05):
    d, _ = cKDTree(rec_points).query(gt_points, k=1)
    return float((d < dist_th).mean())


def accuracy_metric(gt_points, rec_points):
    d, _ = cKDTree(gt_points).query(rec_points, k=1)
    return float(d.mean())


def completion_metric(gt_points, rec_points):
    d, _ = cKDTree(rec_points).query(gt_points, k=1)
    return float(d.mean())


def calc_3d_metric(rec_verts, rec_faces, gt_verts, gt_faces,
                   n_points: int = 200000, com_th: float = 0.05,
                   align: bool = True, seed: int = 0):
    """Accuracy/completion (cm), ratios (%), F-score
    (reference eval_recon.py:104-139)."""
    rec_pts = sample_surface(rec_verts, rec_faces, n_points, seed)
    gt_pts = sample_surface(gt_verts, gt_faces, n_points, seed + 1)
    if align:
        T = icp_align(rec_pts, gt_pts)
        rec_pts = rec_pts @ T[:3, :3].T + T[:3, 3]
    acc = accuracy_metric(gt_pts, rec_pts)
    comp = completion_metric(gt_pts, rec_pts)
    acc_ratio = completion_ratio(rec_pts, gt_pts, com_th)
    comp_ratio = completion_ratio(gt_pts, rec_pts, com_th)
    f1 = 2 * acc_ratio * comp_ratio / max(acc_ratio + comp_ratio, 1e-8)
    return {
        "accuracy_cm": acc * 100,
        "completion_cm": comp * 100,
        "accuracy_ratio_pct": acc_ratio * 100,
        "completion_ratio_pct": comp_ratio * 100,
        "f1": f1,
    }


def calc_2d_depth_l1(rec_mesh, gt_mesh, K, H, W, n_views: int = 100,
                     seed: int = 0):
    """Depth-L1 (cm) over random virtual views inside the GT bounding box
    (reference eval_recon.py:157-322; 1000 views there, configurable here).
    Views are sampled looking at random GT surface points."""
    rec_v, rec_f = rec_mesh
    gt_v, gt_f = gt_mesh
    rng = np.random.default_rng(seed)
    lo, hi = gt_v.min(0), gt_v.max(0)
    targets = gt_v[rng.integers(0, len(gt_v), n_views)]
    errors = []
    for i in range(n_views):
        eye = rng.uniform(lo, hi)
        fwd = targets[i] - eye
        n = np.linalg.norm(fwd)
        if n < 1e-3:
            continue
        fwd = fwd / n
        up = np.array([0.0, -1.0, 0.0])
        right = np.cross(up, fwd)
        if np.linalg.norm(right) < 1e-6:
            right = np.cross([1.0, 0, 0], fwd)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, eye
        d_gt = render_mesh_depth(gt_v, gt_f, K, c2w, H, W)
        d_rec = render_mesh_depth(rec_v, rec_f, K, c2w, H, W)
        mask = (d_gt > 0) & (d_rec > 0)
        if mask.sum() < 100:
            continue
        errors.append(np.abs(d_gt[mask] - d_rec[mask]).mean())
    return float(np.mean(errors) * 100) if errors else float("nan")


def mesh_quality(config, run_dir, n, dataset=None):
    """The synthetic bench's mesh score of a run's culled mesh
    (<run_dir>/mesh_cull_occlusion.ply), as bench.py computes it:
      - accuracy: |analytic SDF| at 100k area-sampled points of the
        reconstruction (seed 0);
      - completion: distance from 100k samples of the analytic GT mesh
        (marching on the exact SDF at 3 cm), culled with the GT poses at
        stride 5 and the dataset depth (eps 0.1), to the nearest
        reconstruction sample;
      - the ratios below 5 cm and their F1.
    One deviation from bench.py: the GT is culled with the poses of frames
    [0, n) only, so a cut run is judged on what it saw (bench.py culls
    with every pose of the dataset). The culled GT mesh is written beside
    the run's as gt_mesh_culled.ply. Returns the metrics and the stage
    times (ms, host clock)."""
    if dataset is None:
        from remixfusion_tpu_torch.datasets import get_dataset
        dataset = get_dataset(config)
    t0 = time.perf_counter()
    rv, rf = read_ply(os.path.join(run_dir, "mesh_cull_occlusion.ply"))
    rec_pts = sample_surface(rv, rf, 100000)
    acc_d = np.abs(dataset.gt_sdf(rec_pts))
    t1 = time.perf_counter()
    gv, gf = dataset.gt_mesh(voxel_size=0.03)
    t2 = time.perf_counter()
    gt_raw = os.path.join(run_dir, "gt_mesh.ply")
    gt_culled = os.path.join(run_dir, "gt_mesh_culled.ply")
    write_ply_mesh(gt_raw, gv, gf)
    poses = [np.asarray(dataset.poses[i], np.float32)
             for i in range(0, n, 5)]
    cull_one_mesh(config, poses, gt_raw, gt_culled, 5, dataset,
                  depth_flag=True, remove_occlusion=True, eps=0.1)
    gcv, gcf = read_ply(gt_culled)
    t3 = time.perf_counter()
    gt_pts = sample_surface(gcv, gcf, 100000)
    comp_d, _ = cKDTree(rec_pts).query(gt_pts, k=1)
    acc_ratio = float((acc_d < 0.05).mean())
    comp_ratio = float((comp_d < 0.05).mean())
    f1 = 2 * acc_ratio * comp_ratio / max(acc_ratio + comp_ratio, 1e-8)
    t4 = time.perf_counter()
    return {
        "accuracy_cm": float(acc_d.mean()) * 100,
        "completion_cm": float(comp_d.mean()) * 100,
        "accuracy_ratio_pct": acc_ratio * 100,
        "completion_ratio_pct": comp_ratio * 100,
        "f1": f1,
        "rec_faces": int(len(rf)), "gt_faces_culled": int(len(gcf)),
        "frames": int(n),
        "ms": {"accuracy": 1000.0 * (t1 - t0),
               "gt_mesh": 1000.0 * (t2 - t1),
               "gt_cull": 1000.0 * (t3 - t2),
               "completion": 1000.0 * (t4 - t3)},
    }


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--rec_mesh")
    parser.add_argument("--gt_mesh")
    parser.add_argument("--com_th", type=float, default=0.05)
    parser.add_argument("--n_points", type=int, default=200000)
    parser.add_argument("--no_align", action="store_true")
    parser.add_argument("--runs", type=int, default=3,
                        help="average over N sampling seeds (reference: 3)")
    parser.add_argument("--config", help="with --run_dir: mesh_quality")
    parser.add_argument("--run_dir")
    parser.add_argument("--frames", type=int, default=None,
                        help="frames the run saw (default: all)")
    args = parser.parse_args()

    if args.run_dir is not None:
        from remixfusion_tpu_torch.config import load_config
        from remixfusion_tpu_torch.datasets import get_dataset

        cfg = load_config(args.config)
        dataset = get_dataset(cfg)
        n = dataset.num_frames if args.frames is None else args.frames
        print(json.dumps(mesh_quality(cfg, args.run_dir, n, dataset)))
        return
    if args.rec_mesh is None or args.gt_mesh is None:
        parser.error("give --rec_mesh and --gt_mesh, or --config and "
                     "--run_dir")
    rec_v, rec_f = read_ply(args.rec_mesh)
    gt_v, gt_f = read_ply(args.gt_mesh)
    agg = {}
    for r in range(args.runs):
        m = calc_3d_metric(rec_v, rec_f, gt_v, gt_f, args.n_points,
                           args.com_th, align=not args.no_align, seed=r)
        for k, v in m.items():
            agg.setdefault(k, []).append(v)
    for k, v in agg.items():
        print(f"{k}: {np.mean(v):.4f}")


if __name__ == "__main__":
    main()
