#!/bin/bash
# Cull with estimated poses + mesh-rendered occlusion depth, then evaluate,
# with the port's tools.
# Usage: scripts/torch/mesh_cull_est.sh <config.yaml> <exp_dir> <gt_mesh.ply>
set -e
CFG=$1; EXP=$2; GT=$3
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
python -m remixfusion_tpu_torch.tools.cull_mesh --config "$CFG" \
    --input_mesh "$EXP/mesh.ply" --output_mesh "$EXP/mesh_cull_est.ply" \
    --poses "$EXP/all_poses.npy" --skip 5
python -m remixfusion_tpu_torch.tools.eval_recon \
    --rec_mesh "$EXP/mesh_cull_est.ply" --gt_mesh "$GT"
