"""Pose and RGB-D sensor noise for robustness experiments.

Counterpart of remixfusion_tpu.utils.noise (numpy, the same operation order
and the same draws from the caller's np.random.Generator, so both packages
produce bitwise the same noise):
  - add_noise (reference utils.py:18-60): a 4x4 pose perturbed by uniform
    axis-angle rotation noise (scipy's Rotation) and uniform translation
    noise;
  - add_sensor_noise: Kinect-class depth and colour corruption, applied by
    the synthetic datasets when data.synthetic.sensor_noise is set.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation


def add_noise(pose: np.ndarray, rotation_noise: float = 0.1,
              translation_noise: float = 0.05,
              rng: np.random.Generator | None = None) -> np.ndarray:
    rng = rng or np.random.default_rng()
    rot_err = rng.uniform(-rotation_noise, rotation_noise, 3)
    trans_err = rng.uniform(-translation_noise, translation_noise, 3)
    out = np.eye(4)
    out[:3, :3] = Rotation.from_rotvec(rot_err).as_matrix() @ pose[:3, :3]
    out[:3, 3] = pose[:3, 3] + trans_err
    return out


def add_sensor_noise(depth: np.ndarray, rgb: np.ndarray,
                     rng: np.random.Generator, *,
                     sigma0: float = 0.001, sigma_z2: float = 0.0015,
                     disparity_step: float = 2.85e-5,
                     edge_dropout: float = 0.8, edge_thresh: float = 0.08,
                     hole_rate: float = 0.002,
                     rgb_sigma: float = 0.01):
    """Kinect-class RGB-D sensor noise (Khoshelham & Elberink 2012):
      - disparity quantization: q = 1 / (round((1/z) / s) * s), step s in
        1/m;
      - axial Gaussian noise on the quantized depth, sigma(z) = sigma0 +
        sigma_z2 * z^2;
      - edge dropout: pixels on either side of a depth discontinuity
        (forward difference > edge_thresh m) are invalidated with
        probability edge_dropout;
      - salt holes: uniform random invalid pixels (hole_rate);
      - RGB shot noise: additive Gaussian of sigma rgb_sigma, clipped to
        [0, 1].
    Returns new (depth, rgb) arrays; zero depth (invalid) stays zero."""
    depth = np.asarray(depth, np.float32)
    valid = depth > 0
    z = np.where(valid, depth, 1.0)

    inv = 1.0 / z
    inv_q = np.round(inv / disparity_step) * disparity_step
    zq = 1.0 / np.maximum(inv_q, 1e-6)
    sigma = sigma0 + sigma_z2 * zq * zq
    zn = zq + rng.normal(0.0, 1.0, zq.shape).astype(np.float32) * sigma

    gx = np.abs(np.diff(depth, axis=1, append=depth[:, -1:]))
    gy = np.abs(np.diff(depth, axis=0, append=depth[-1:, :]))
    edge = (gx > edge_thresh) | (gy > edge_thresh)
    # both sides of the discontinuity, by non-wrapping shifts
    grow = edge.copy()
    grow[:, 1:] |= edge[:, :-1]
    grow[1:, :] |= edge[:-1, :]
    edge = grow
    drop = edge & (rng.uniform(size=depth.shape) < edge_dropout)
    drop |= rng.uniform(size=depth.shape) < hole_rate

    out_d = np.where(valid & ~drop, zn, 0.0).astype(np.float32)
    out_rgb = np.clip(
        np.asarray(rgb, np.float32)
        + rng.normal(0.0, rgb_sigma, rgb.shape).astype(np.float32),
        0.0, 1.0)
    return out_d, out_rgb
