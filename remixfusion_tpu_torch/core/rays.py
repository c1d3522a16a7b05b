"""Camera ray generation (OpenCV pinhole convention), numpy.

Counterpart of remixfusion_tpu.core.rays (reference datasets/utils.py:24-57):
per-pixel view directions with z=+1, indexed [H, W, 3] with x varying
along W.
"""

from __future__ import annotations

import numpy as np


def as_intrinsics_matrix(intrinsics) -> np.ndarray:
    """[fx, fy, cx, cy] -> 3x3 K matrix (float64)."""
    K = np.eye(3)
    K[0, 0] = intrinsics[0]
    K[1, 1] = intrinsics[1]
    K[0, 2] = intrinsics[2]
    K[1, 2] = intrinsics[3]
    return K


def get_camera_rays(H, W, fx, fy, cx, cy) -> np.ndarray:
    """Per-pixel ray directions [H, W, 3] float32 in the camera frame."""
    i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    fx, fy = np.float32(fx), np.float32(fy)
    cx, cy = np.float32(cx), np.float32(cy)
    return np.stack([(i - cx) / fx, (j - cy) / fy, np.ones_like(i)], -1)
