"""Pose math: rotation maps for the RBA network, and the const-speed
pose prediction of the online loop.

Rotation maps (remixfusion_tpu.core.pose, reference utils.py:392-454,
model/rba.py:8-20): quaternions (w, x, y, z), axis-angle (Rodrigues) and
c2w assembly, differentiable torch functions on (..., 3|4) batches.

Two forms of the reference's const-speed model (tracker.py:54-72),
mirroring remixfusion_tpu.slam.pipeline:
  - const_speed_np: host float64 extrapolation from harvested poses (re-center
    policy and brick selection), SVD re-orthogonalized;
  - predict_const_speed: the device pose chain's prediction of the next
    frame's initial pose, with the fitness-gated translation damping
    (tracking.speed_damp). It runs on torch tensors without any host
    synchronisation, so it re-orthogonalizes with a Newton polar iteration
    instead of an SVD (torch.linalg.svd synchronises on CUDA). For a
    rotation product (det > 0) the polar factor IS the SVD's U @ Vt.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-8


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> quaternion (..., 4), (w, x, y, z),
    w >= 0: branch-free Shepperd's method (all four candidate forms, the
    best picked per rotation)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def s(v):
        return 2.0 * torch.sqrt(torch.clamp(v, min=_EPS))

    sw, sx, sy, sz = s(qw2), s(qx2), s(qy2), s(qz2)
    cands = torch.stack([
        torch.stack([0.25 * sw, (m21 - m12) / sw, (m02 - m20) / sw,
                     (m10 - m01) / sw], -1),
        torch.stack([(m21 - m12) / sx, 0.25 * sx, (m01 + m10) / sx,
                     (m02 + m20) / sx], -1),
        torch.stack([(m02 - m20) / sy, (m01 + m10) / sy, 0.25 * sy,
                     (m12 + m21) / sy], -1),
        torch.stack([(m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz,
                     0.25 * sz], -1)], -2)
    best = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], -1), -1)
    q = torch.take_along_dim(cands, best[..., None, None], dim=-2)[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)
    return q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + _EPS)


def quat_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    vn = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(vn[..., 0], w)
    return v / torch.clamp(vn, min=_EPS) * angle[..., None]


def matrix_to_axis_angle(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle vector (..., 3)."""
    return quat_to_axis_angle(matrix_to_quat(R))


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3), Rodrigues'
    formula; the identity below an angle of 1e-8."""
    theta = torch.linalg.vector_norm(aa, dim=-1, keepdim=True)
    k = aa / torch.clamp(theta, min=_EPS)
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    zeros = torch.zeros_like(kx)
    K = torch.stack([torch.stack([zeros, -kz, ky], -1),
                     torch.stack([kz, zeros, -kx], -1),
                     torch.stack([-ky, kx, zeros], -1)], -2)
    theta = theta[..., None]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(K.shape)
    R = eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)
    return torch.where(theta > _EPS, R, eye)


def rt_to_c2w(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) + translation (..., 3) -> c2w (..., 4, 4)."""
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype,
                         device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([torch.cat([R, t[..., None]], -1), bottom], -2)


def at_to_c2w(aa: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) + translation (..., 3) -> c2w (..., 4, 4)."""
    return rt_to_c2w(axis_angle_to_matrix(aa), t)


def const_speed_np(prev: np.ndarray, prev_prev: np.ndarray, steps: int = 1,
                   damp: float = 1.0) -> np.ndarray:
    """`delta^steps @ prev` with SVD re-orthogonalization; `damp` scales the
    translational step like the device predictor's speed_damp."""
    prev = prev.astype(np.float64)
    delta = prev @ np.linalg.inv(prev_prev.astype(np.float64))
    pred = np.linalg.matrix_power(delta, steps) @ prev
    if damp != 1.0:
        pred[:3, 3] = prev[:3, 3] + damp * (pred[:3, 3] - prev[:3, 3])
    U, _, Vt = np.linalg.svd(pred[:3, :3])
    S = np.eye(3)
    S[2, 2] = np.sign(np.linalg.det(U @ Vt))
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = (U @ S @ Vt).astype(np.float32)
    out[:3, 3] = pred[:3, 3].astype(np.float32)
    return out


def polar_rotation(M: torch.Tensor, iters: int = 4) -> torch.Tensor:
    """Orthogonal polar factor of a near-rotation [3, 3] (float64 Newton
    iteration X <- (X + X^-T) / 2; X^-T = cofactor(X) / det(X))."""
    X = M.to(torch.float64)
    for _ in range(iters):
        r0, r1, r2 = X[0], X[1], X[2]
        cof = torch.stack([torch.linalg.cross(r1, r2),
                           torch.linalg.cross(r2, r0),
                           torch.linalg.cross(r0, r1)])
        det = torch.dot(r0, cof[0])
        X = 0.5 * (X + cof / det)
    return X


def predict_const_speed(prev: torch.Tensor, prev2: torch.Tensor,
                        fit_prev: torch.Tensor, *, const_speed: bool,
                        speed_damp: float = 1.0, fit_lo: float = 0.15,
                        fit_hi: float = 0.40) -> torch.Tensor:
    """Device const-speed prediction (pipeline.py predict_dev): pred =
    (prev @ inv(prev2)) @ prev; with speed_damp != 1 the translational step
    shrinks to lambda(fit_prev) in [speed_damp, 1] as the previous frame's
    fitness degrades from fit_lo to fit_hi. prev == prev2 gives prev."""
    if not const_speed:
        return prev
    R1, t1 = prev[:3, :3], prev[:3, 3]
    R2, t2 = prev2[:3, :3], prev2[:3, 3]
    Rd = R1 @ R2.T
    td = t1 - Rd @ t2
    Rp = Rd @ R1
    if speed_damp != 1.0:
        u = torch.clamp((fit_prev - fit_lo) / (fit_hi - fit_lo), 0.0, 1.0)
        lam = 1.0 - u * (1.0 - speed_damp)
        tp = t1 + lam * (Rd @ t1 + td - t1)
    else:
        tp = Rd @ t1 + td
    out = torch.eye(4, dtype=torch.float32, device=prev.device)
    out[:3, :3] = polar_rotation(Rp).to(torch.float32)
    out[:3, 3] = tp.to(torch.float32)
    return out
