#!/bin/bash
# ATE RMSE between two [N,4,4] .npy pose dumps, with the port's tool.
# Usage: scripts/torch/eval_ate.sh <est.npy> <gt.npy>
set -e
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
python -m remixfusion_tpu_torch.tools.eval_ate --est "$1" --gt "$2"
