"""CLI entry point of the PyTorch/CUDA port:

    python run_torch.py --config configs/Synthetic/synthetic_bench.yaml \
        [--input_folder DIR] [--output DIR] [--max_frames N] \
        [--resume PATH/resume.npz] [--device cuda|cpu]

A real-sensor config (configs/Tum, ScanNet, Replica, BS3D, Fast_syn,
uhumans) reads the capture in --input_folder (overriding data.datadir):
`python run_torch.py --config configs/Tum/fr1_desk.yaml --input_folder
<rgbd_dataset_freiburg1_desk>`. PNG frames are read by the port's own
decoder; JPEG colour frames (Replica, ScanNet, Azure, and BS3D where it
ships .jpg) need OpenCV (cv2). `python -m
remixfusion_tpu_torch.tools.check_data --config ... --input_folder ...`
checks the layout first.

Loads the config (inherit_from chaining, no PyYAML needed), runs the online
SLAM loop of remixfusion_tpu_torch on the GPU (or the CPU when asked):
first-frame mapping, tracking + local fusion of every frame, a mapping
round (global keyframe integrate, residual-field map steps, RBA bundle
adjustment) every mapping.map_every frames, the final trajectory, then the
final mesh (the residual field queried on the dense grid at
mesh.voxel_final on the device, marching tetrahedra on the host) and the
mesh culled with the trajectory and the dataset's depth. Prints the full
ATE (after BA), the RO-only ATE, the time per frame and per mapping round,
the mesh paths with their vertex and face counts and the mesh stage times.
Writes config.json, all_poses.npy, ro_poses.npy, tracking_result.txt,
mesh.ply, mesh_cull_occlusion.ply and tracking_result.json to
<output>/<exp_name>/; with mapping.state_every K also resume.npz every K
frames, the whole state of the loop. `--resume <run>/resume.npz` loads
such a state into a fresh pipeline of the same config and continues the
loop after the saved frame (first-frame mapping skipped), with
--max_frames meaning what it means in a fresh run: the loop stops at frame
N. Score the mesh of a synthetic run with
`python -m remixfusion_tpu_torch.tools.eval_recon --config <yaml>
--run_dir <output>/<exp_name> --frames N`.
"""

import argparse

from remixfusion_tpu_torch.config import load_config
from remixfusion_tpu_torch.slam import RemixFusionTorch


def main():
    parser = argparse.ArgumentParser(
        description="PyTorch/CUDA online RGB-D SLAM")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--input_folder", type=str,
                        help="overrides data.datadir from the config")
    parser.add_argument("--output", type=str,
                        help="overrides data.output from the config")
    parser.add_argument("--max_frames", type=int, default=None,
                        help="track only the first N frames of the sequence")
    parser.add_argument("--resume", type=str, default=None,
                        help="resume.npz written by a run with "
                             "mapping.state_every: continue after its frame")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args()

    cfg = load_config(args.config)
    if args.output is not None:
        cfg["data"]["output"] = args.output
    if args.input_folder is not None:
        cfg["data"]["datadir"] = args.input_folder
    slam = RemixFusionTorch(cfg, device=args.device)
    if args.resume:
        slam.load_state(args.resume)
    out = slam.run(max_frames=args.max_frames, resume=bool(args.resume))
    print(f"# frames={out['frames']} first_tracked={out['first_tracked']} "
          f"device={out['device']} "
          f"ms_per_frame={out['ms_per_frame']:.3f} "
          f"mapping_rounds={out['mapping_rounds']} "
          f"ms_per_round={out['ms_per_round']:.3f} "
          f"state_save_ms={out['state_save_ms']}")
    print(f"# ate_rmse_cm={out['ate_rmse_cm']:.3f} "
          f"ate_rmse_cm_ro_only={out['ate_rmse_cm_ro_only']:.3f}")
    print(f"# mesh={out['mesh_path']} verts={out['mesh_verts']} "
          f"faces={out['mesh_faces']}")
    print(f"# mesh_cull={out['mesh_cull_path']} "
          f"faces={out['mesh_cull_faces']}")
    print(f"# mesh ms: query={out['mesh_query_ms']:.1f} "
          f"marching={out['mesh_marching_ms']:.1f} "
          f"write={out['mesh_write_ms']:.1f} cull={out['mesh_cull_ms']:.1f}")


if __name__ == "__main__":
    main()
