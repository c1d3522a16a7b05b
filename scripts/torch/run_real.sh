#!/usr/bin/env bash
# One-command run of the PyTorch/CUDA port on a real capture (the port's
# counterpart of scripts/run_real.sh).
#
# Usage:  scripts/torch/run_real.sh configs/BS3D/study_example.yaml [datadir]
#
# 1. (optional) $2 overrides data.datadir (--input_folder)
# 2. checks the capture's on-disk layout for the config's loader
#    (remixfusion_tpu_torch/tools/check_data.py --strict: names what is
#    missing if a download is incomplete)
# 3. runs the online SLAM loop on the card (run_torch.py)
# 4. prints where the outputs landed and how to evaluate them
#
# The layouts each dataset family expects are listed in
# scripts/run_real.sh; `python -m remixfusion_tpu_torch.tools.write_layout`
# renders the synthetic room into any of them. Paths are taken from the
# repository root.
set -euo pipefail

CFG="${1:?usage: scripts/torch/run_real.sh <config.yaml> [datadir]}"
cd "$(dirname "$0")/../.."

EXTRA=()
if [[ $# -ge 2 ]]; then
  EXTRA=(--input_folder "$2")
fi

python -m remixfusion_tpu_torch.tools.check_data --config "$CFG" --strict \
    "${EXTRA[@]}"

python -u run_torch.py --config "$CFG" "${EXTRA[@]}"

OUT=$(python - "$CFG" <<'PY'
import os
import sys

from remixfusion_tpu_torch.config import load_config

c = load_config(sys.argv[1])
print(os.path.join(c["data"]["output"], c["data"]["exp_name"]))
PY
)
echo
echo "Run complete. Outputs in: $OUT"
echo "  trajectory : $OUT/all_poses.npy  (+ tracking_result.txt)"
echo "  mesh       : $OUT/mesh.ply  (culled: mesh_cull_occlusion.ply)"
echo "Evaluate:"
echo "  ATE  : scripts/torch/eval_ate.sh $OUT/all_poses.npy <gt.npy>"
echo "  mesh : scripts/torch/mesh_eval.sh $OUT/mesh_cull_occlusion.ply <gt.ply>"
