"""Device-resident keyframe ray store.

Counterpart of remixfusion_tpu.mapping.keyframe.DeviceKeyFrameStore
(reference model/keyframe.py:5-96): a [num_kf * R, 7] tensor of
(direction3, rgb3, depth1) rays, R = num_rays_to_save per keyframe, filled
from the keyframe's device frame and sampled by the map and BA steps
without any host round trip. state_arrays / load_state_arrays carry the
store through a resume checkpoint (the JAX kf_rays / kf_frame_ids keys).
"""

from __future__ import annotations

import numpy as np
import torch


class DeviceKeyFrameStore:
    def __init__(self, num_kf: int, num_rays_to_save: int,
                 depth_trunc: float, device):
        self.R = int(num_rays_to_save)
        self.depth_trunc = float(depth_trunc)
        self.rays = torch.zeros((num_kf * self.R, 7), dtype=torch.float32,
                                device=device)
        self.frame_ids: list[int] = []

    def __len__(self):
        return len(self.frame_ids)

    def sample_indices(self, depth: torch.Tensor, filtered: bool,
                       generator=None, draws=None) -> torch.Tensor:
        """[R] pixel indices of a keyframe: uniform, or (filtered) uniform
        over the valid-depth pixels (0 < d <= depth_trunc) through cumsum +
        searchsorted, falling back to uniform when the valid pool is not
        larger than R (reference keyframe.py:39-44). `draws` = (uniform
        indices [R], valid-pool ranks in 1..count [R]) replaces the
        generator's draws."""
        R, n = self.R, depth.shape[0]
        dev = depth.device
        if draws is None:
            uidx = torch.randint(0, n, (R,), generator=generator, device=dev)
        else:
            uidx = draws[0].to(dev)
        if not filtered:
            return uidx
        valid = (depth > 0.0) & (depth <= self.depth_trunc)
        cnt = valid.sum()
        cdf = torch.cumsum(valid.to(torch.int64), 0)
        if draws is None:
            # rank in 1..max(cnt, 1), drawn on the device (no host sync)
            top = torch.clamp(cnt, min=1)
            u = torch.minimum(
                (torch.rand(R, generator=generator, device=dev)
                 * top).to(torch.int64) + 1, top)
        else:
            u = draws[1].to(dev)
        fidx = torch.clamp(torch.searchsorted(cdf, u), 0, n - 1)
        return torch.where(cnt > R, fidx, uidx)

    def add_keyframe(self, frame_id: int, dep: torch.Tensor,
                     rgb: torch.Tensor, dirs_flat: torch.Tensor,
                     filter_depth: bool = False, generator=None,
                     draws=None):
        """Store R rays of a keyframe (dep [H, W], rgb [H, W, 3], dirs_flat
        [H*W, 3] on the store's device) in the next slot. Frame 0 is always
        sampled uniformly."""
        depth = dep.reshape(-1)
        idx = self.sample_indices(depth, bool(filter_depth and frame_id != 0),
                                  generator=generator, draws=draws)
        slot = len(self.frame_ids)
        self.rays[slot * self.R:(slot + 1) * self.R] = torch.cat(
            [dirs_flat[idx], rgb.reshape(-1, 3)[idx], depth[idx][:, None]],
            -1)
        self.frame_ids.append(int(frame_id))

    def state_arrays(self) -> dict:
        """The store for a resume checkpoint: kf_rays [num_kf * R, 7]
        float32 and kf_frame_ids int64 [n]."""
        return dict(kf_rays=self.rays.cpu().numpy(),
                    kf_frame_ids=np.asarray(self.frame_ids, np.int64))

    def load_state_arrays(self, data):
        rays = np.asarray(data["kf_rays"])
        if tuple(rays.shape) != tuple(self.rays.shape):
            raise ValueError(f"kf_rays has shape {rays.shape}, the store "
                             f"{tuple(self.rays.shape)}")
        self.rays.copy_(torch.from_numpy(rays))
        self.frame_ids = [int(i) for i in data["kf_frame_ids"]]
