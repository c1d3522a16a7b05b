#!/bin/bash
# Rendering-quality evaluation from a checkpoint (PSNR/SSIM/LPIPS/D-L1),
# with the port's rendering_eval_torch.py.
# Usage: scripts/torch/rendering.sh <config.yaml> [gap]
set -e
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
python "$ROOT/rendering_eval_torch.py" --config "$1" --gap "${2:-10}"
