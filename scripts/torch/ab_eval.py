"""Mesh-quality evaluation of a finished synthetic run of the port (A/B
harness; the counterpart of scripts/ab_eval.py).

For an output directory that run_torch.py wrote on a synthetic config:
  - accuracy (cm)        : mean |analytic scene SDF| over 100k points
                           sampled on the culled reconstructed mesh
  - completion (cm)      : mean NN distance from 100k points of the
                           analytic GT mesh, culled with every 5th pose of
                           the dataset, to the reconstruction
  - acc/comp ratios @5cm and their F1
(tools/eval_recon.mesh_quality: bench_torch.py's protocol), plus the full
ATE of all_poses.npy (tools/eval_ate). mesh_cull_occlusion.ply is culled
from mesh.ply with the run's poses at stride 5 when it is missing.

Usage: python scripts/torch/ab_eval.py configs/Synthetic/ab_cpgrid.yaml
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402


def main(cfg_path):
    from remixfusion_tpu_torch.config import load_config
    from remixfusion_tpu_torch.datasets import get_dataset
    from remixfusion_tpu_torch.tools.cull_mesh import cull_one_mesh
    from remixfusion_tpu_torch.tools.eval_ate import evaluate_ate
    from remixfusion_tpu_torch.tools.eval_recon import mesh_quality

    cfg = load_config(cfg_path)
    out_dir = os.path.join(cfg["data"]["output"], cfg["data"]["exp_name"])
    ds = get_dataset(cfg)
    poses_np = np.load(os.path.join(out_dir, "all_poses.npy"))
    culled = os.path.join(out_dir, "mesh_cull_occlusion.ply")
    if not os.path.exists(culled):
        cull_one_mesh(cfg, [poses_np[i] for i in range(0, len(poses_np), 5)],
                      os.path.join(out_dir, "mesh.ply"), culled, 5, ds,
                      depth_flag=True, remove_occlusion=True, eps=0.1)
    q = mesh_quality(cfg, out_dir, len(ds), ds)

    gt = {float(i): np.asarray(ds.poses[i], np.float32)
          for i in range(len(poses_np))}
    est = {float(i): poses_np[i] for i in range(len(poses_np))}
    ate = evaluate_ate(gt, est)["rmse"] * 100

    print(f"{cfg['data']['exp_name']}: ate_rmse_cm={ate:.4f} "
          f"acc_cm={q['accuracy_cm']:.3f} comp_cm={q['completion_cm']:.3f} "
          f"acc_ratio={q['accuracy_ratio_pct']:.2f} "
          f"comp_ratio={q['completion_ratio_pct']:.2f} f1={q['f1']:.4f}")


if __name__ == "__main__":
    main(sys.argv[1])
