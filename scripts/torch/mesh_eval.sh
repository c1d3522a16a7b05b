#!/bin/bash
# 3D reconstruction metrics for an (already culled) mesh against GT, with
# the port's tool.
# Usage: scripts/torch/mesh_eval.sh <rec_mesh.ply> <gt_mesh.ply> [com_th]
set -e
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
python -m remixfusion_tpu_torch.tools.eval_recon \
    --rec_mesh "$1" --gt_mesh "$2" --com_th "${3:-0.05}"
