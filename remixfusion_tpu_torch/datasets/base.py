"""Dataset base class: intrinsics bookkeeping + per-frame dict protocol.

Counterpart of remixfusion_tpu.datasets.base (reference datasets/dataset.py:
55-86): every dataset yields dict(frame_id, c2w [4,4], rgb [H,W,3] float
0-1, depth [H,W] meters, direction [H,W,3]) as numpy arrays and exposes H,
W, fx, fy, cx, cy, num_frames, num_rays_to_save and the GT pose list.
"""

from __future__ import annotations

import numpy as np

from remixfusion_tpu_torch.core.rays import get_camera_rays


def update_cam(cam: dict) -> dict:
    """Intrinsics rescale / crop bookkeeping, in place (reference
    run.py:62-84): cam.crop_size rescales fx, fy, cx, cy and H, W to the
    crop (+ the edge), cam.crop_edge trims the edge. Idempotent through the
    `_cam_updated` flag, like the JAX pipeline. The pipeline applies it
    before the dataset is built, so the loaders' undistort sees the updated
    intrinsics, as in the JAX loader."""
    if cam.get("_cam_updated"):
        return cam
    cam["_cam_updated"] = True
    if "crop_size" in cam:
        crop = cam["crop_size"]
        sx = (crop[1] + cam["crop_edge"] * 2) / cam["W"]
        sy = (crop[0] + cam["crop_edge"] * 2) / cam["H"]
        cam["fx"] *= sx
        cam["fy"] *= sy
        cam["cx"] *= sx
        cam["cy"] *= sy
        cam["W"] = crop[1] + cam["crop_edge"] * 2
        cam["H"] = crop[0] + cam["crop_edge"] * 2
    if cam["crop_edge"] > 0:
        cam["H"] -= cam["crop_edge"] * 2
        cam["W"] -= cam["crop_edge"] * 2
        cam["cx"] -= cam["crop_edge"]
        cam["cy"] -= cam["crop_edge"]
    return cam


class BaseDataset:
    def __init__(self, cfg):
        self.config = cfg
        self.png_depth_scale = cfg["cam"]["png_depth_scale"]
        self.H = cfg["cam"]["H"] // cfg["data"]["downsample"]
        self.W = cfg["cam"]["W"] // cfg["data"]["downsample"]
        self.fx = cfg["cam"]["fx"] // cfg["data"]["downsample"]
        self.fy = cfg["cam"]["fy"] // cfg["data"]["downsample"]
        self.cx = cfg["cam"]["cx"] // cfg["data"]["downsample"]
        self.cy = cfg["cam"]["cy"] // cfg["data"]["downsample"]
        self.distortion = (np.array(cfg["cam"]["distortion"])
                           if "distortion" in cfg["cam"] else None)
        self.crop_size = (cfg["cam"]["crop_size"]
                          if "crop_size" in cfg["cam"] else None)
        self.ignore_w = cfg["tracking"]["ignore_edge_W"]
        self.ignore_h = cfg["tracking"]["ignore_edge_H"]
        self.total_pixels = (self.H - cfg["cam"]["crop_edge"] * 2) * \
                            (self.W - cfg["cam"]["crop_edge"] * 2)
        self.num_rays_to_save = int(
            self.total_pixels * cfg["mapping"]["n_pixels"])
        self.crop_edge = cfg["cam"]["crop_edge"]
        self.rays_d = None
        self.poses = []

    @property
    def num_frames(self):
        return len(self)

    def __len__(self):
        raise NotImplementedError

    def get_direction(self):
        if self.rays_d is None:
            self.rays_d = get_camera_rays(self.H, self.W, self.fx, self.fy,
                                          self.cx, self.cy)
        return self.rays_d

    def K(self) -> np.ndarray:
        return np.array([[self.fx, 0.0, self.cx],
                         [0.0, self.fy, self.cy],
                         [0.0, 0.0, 1.0]], np.float32)
