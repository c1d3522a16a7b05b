"""Mesh culling: remove unobserved / occluded geometry by per-pose voting.

Counterpart of remixfusion_tpu.tools.cull_mesh (reference
tools/cull_mesh.py): for every (skipped) camera pose, project all mesh
vertices; a vertex votes "in frustum" when it projects inside the image with
positive depth, and "observed" when it is also closer than the occlusion
depth (+eps) — the dataset's own depth maps (depth_flag) or a double-sided
depth render of the mesh itself (utils/raster.render_mesh_depth). Triangles
with at least one voting vertex on both counts survive.

    python -m remixfusion_tpu_torch.tools.cull_mesh --config <yaml> \
        --input_mesh mesh.ply --output_mesh out.ply --poses all_poses.npy \
        [--skip 5] [--eps 0.03] [--gt_depth]
"""

from __future__ import annotations

import argparse
import copy
import os

import numpy as np

from remixfusion_tpu_torch.utils.meshio import read_ply, write_ply_mesh
from remixfusion_tpu_torch.utils.raster import render_mesh_depth


def cull_by_bounds(points, scene_bounds, padding=0.02):
    return np.all(points >= scene_bounds[0] - padding, axis=1) & \
        np.all(points <= scene_bounds[1] + padding, axis=1)


def cull_from_one_pose(points, pose, K, H, W, remove_occlusion=True,
                       rendered_depth=None, eps=0.03):
    """(reference cull_mesh.py:162-199)"""
    c2w = copy.deepcopy(np.asarray(pose, np.float64))
    w2c = np.linalg.inv(c2w)
    cam = w2c[:3, :3] @ points.T + w2c[:3, 3][:, None]
    uvz = (np.asarray(K) @ cam).T
    pz = uvz[:, 2] + 1e-8
    px = uvz[:, 0] / pz
    py = uvz[:, 1] / pz
    in_frustum = ((px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1)
                  & (pz > 0))
    u = np.clip(px, 0, W - 1).astype(np.int32)
    v = np.clip(py, 0, H - 1).astype(np.int32)
    obs = in_frustum
    if remove_occlusion:
        assert rendered_depth is not None
        obs = in_frustum & (pz < (rendered_depth[v, u] + eps))
    return in_frustum.astype(np.int32), obs.astype(np.int32)


def cull_one_mesh(cfg, c2w_list, mesh_path, save_path, skip, dataset,
                  depth_flag=False, save_unseen=False, remove_occlusion=True,
                  scene_bounds=None, th_obs=0, eps=0.03):
    """(reference cull_mesh.py:245-343)"""
    vertices, triangles = read_ply(mesh_path)
    if triangles is None:
        raise ValueError(f"{mesh_path} has no faces")

    if scene_bounds is not None:
        inside = cull_by_bounds(vertices, scene_bounds)
        tri_inside = (inside[triangles[:, 0]] | inside[triangles[:, 1]]
                      | inside[triangles[:, 2]])
        triangles = triangles[tri_inside]

    K = dataset.K()
    H, W = dataset.H, dataset.W

    in_frustum_votes = np.zeros(len(vertices))
    obs_votes = np.zeros(len(vertices))
    if depth_flag:
        if hasattr(dataset, "frame_ids"):
            frame_ids = list(dataset.frame_ids)[::skip]
        else:
            frame_ids = list(range(len(dataset)))[::skip]
    else:
        frame_ids = None
    for i, pose in enumerate(c2w_list):
        if remove_occlusion:
            if depth_flag:
                depth = np.asarray(dataset[frame_ids[i]]["depth"])
            else:
                depth = render_mesh_depth(vertices, triangles, K, pose, H, W)
        else:
            depth = None
        inf, obs = cull_from_one_pose(
            vertices, pose, K, H, W, remove_occlusion=remove_occlusion,
            rendered_depth=depth, eps=eps)
        in_frustum_votes += inf
        obs_votes += obs

    inf_tri = ((in_frustum_votes[triangles[:, 0]] > th_obs)
               | (in_frustum_votes[triangles[:, 1]] > th_obs)
               | (in_frustum_votes[triangles[:, 2]] > th_obs))
    if remove_occlusion:
        obs_tri = ((obs_votes[triangles[:, 0]] > th_obs)
                   | (obs_votes[triangles[:, 1]] > th_obs)
                   | (obs_votes[triangles[:, 2]] > th_obs))
        valid = inf_tri & obs_tri
    else:
        valid = inf_tri

    observed = triangles[valid]
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    write_ply_mesh(save_path, vertices, observed)
    print("Mesh is saved to", save_path)
    if save_unseen:
        unseen = triangles[~valid]
        base = os.path.splitext(save_path)[0]
        write_ply_mesh(base + "_unseen.ply", vertices, unseen)
    return vertices, observed


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--input_mesh", required=True)
    parser.add_argument("--output_mesh", required=True)
    parser.add_argument("--poses", required=True,
                        help="[N,4,4] .npy pose file")
    parser.add_argument("--skip", type=int, default=5)
    parser.add_argument("--eps", type=float, default=0.03)
    parser.add_argument("--gt_depth", action="store_true",
                        help="use dataset depth maps for occlusion")
    args = parser.parse_args()

    from remixfusion_tpu_torch.config import load_config
    from remixfusion_tpu_torch.datasets import get_dataset

    cfg = load_config(args.config)
    dataset = get_dataset(cfg)
    poses = np.load(args.poses)
    c2w_list = [poses[i] for i in range(0, len(poses), args.skip)]
    cull_one_mesh(cfg, c2w_list, args.input_mesh, args.output_mesh,
                  args.skip, dataset, depth_flag=args.gt_depth,
                  eps=args.eps)


if __name__ == "__main__":
    main()
