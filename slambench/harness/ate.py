"""Absolute trajectory error: Horn's closed-form alignment of the estimated
camera positions onto the ground truth, then the RMSE of the residuals.

Frozen copy of remixfusion_tpu_torch/tools/eval_ate.py (align,
evaluate_ate) for poses indexed by frame, where the timestamp association
is the identity, and of RemixFusionTorch._composed (slam/pipeline.py), the
trajectory a non-keyframe's pose is composed onto its keyframe's for.
"""

from __future__ import annotations

import numpy as np


def align(model: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Residual lengths [N] of model [3, N] aligned onto data [3, N]."""
    mz = model - model.mean(1, keepdims=True)
    dz = data - data.mean(1, keepdims=True)
    W = np.zeros((3, 3))
    for i in range(model.shape[1]):
        W += np.outer(mz[:, i], dz[:, i])
    U, _, Vh = np.linalg.svd(W.transpose())
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vh) < 0:
        S[2, 2] = -1
    rot = U @ S @ Vh
    trans = data.mean(1, keepdims=True) - rot @ model.mean(1, keepdims=True)
    err = rot @ model + trans - data
    return np.sqrt(np.sum(err * err, 0))


def ate_cm(gt: np.ndarray, est: np.ndarray) -> float:
    """ATE RMSE in cm of est [N, 4, 4] against gt [N, 4, 4]."""
    gt_xyz = np.asarray(gt, np.float64)[:, :3, 3].T
    est_xyz = np.asarray(est, np.float64)[:, :3, 3].T
    # eval_ate aligns the ground truth onto the estimate
    err = align(gt_xyz, est_xyz)
    return 100.0 * float(np.sqrt(np.mean(err ** 2)))


def composed(est: np.ndarray, rel: np.ndarray, n: int,
             kf_every: int) -> np.ndarray:
    """[n, 4, 4] poses of frames 0..n-1 from the estimated poses `est`
    (keyframes BA-refined) and the keyframe-relative poses `rel` of the
    others: a keyframe's own, another frame's rel @ its keyframe's."""
    out = np.zeros((n, 4, 4), np.float32)
    for i in range(n):
        kf = (i // kf_every) * kf_every
        out[i] = est[i] if i == kf else rel[i] @ est[kf]
    return out
