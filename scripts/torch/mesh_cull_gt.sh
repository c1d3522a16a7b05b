#!/bin/bash
# Cull reconstructed meshes with GT poses + dataset depths, then evaluate,
# with the port's tools.
# Usage: scripts/torch/mesh_cull_gt.sh <config.yaml> <exp_dir> <gt_mesh.ply>
set -e
CFG=$1; EXP=$2; GT=$3
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
python -m remixfusion_tpu_torch.tools.cull_mesh --config "$CFG" \
    --input_mesh "$EXP/mesh.ply" --output_mesh "$EXP/mesh_cull_gt.ply" \
    --poses "$EXP/all_poses.npy" --gt_depth --skip 5
python -m remixfusion_tpu_torch.tools.eval_recon \
    --rec_mesh "$EXP/mesh_cull_gt.ply" --gt_mesh "$GT"
