"""RBA — residual bundle adjustment network, as a torch module.

Counterpart of remixfusion_tpu.models.rba (reference model/rba.py:23-98):
an ELU MLP 7 -> 256 -> 256 -> 256 -> 6 (biased) maps (normalized keyframe
id, initial axis-angle, initial translation) to scaled pose corrections
added onto the keyframe's initial pose; keyframe 0 is pinned to a zero
correction. The initial poses are buffers (init_c2w, init_r, init_t),
refreshed from tracking by update_init_pose.
"""

from __future__ import annotations

import torch
from torch import nn

from remixfusion_tpu_torch.core import pose as pose_math
from remixfusion_tpu_torch.models.decoder import MLP


class RBA(nn.Module):
    def __init__(self, num_cams: int, layers: int = 2, scale: float = 1e-2):
        super().__init__()
        self.num_cams = num_cams
        self.scale = scale
        self.mlp = MLP([7] + [256] * (layers + 1) + [6],
                       activation=nn.functional.elu, bias=True)
        self.register_buffer(
            "init_c2w", torch.eye(4).expand(num_cams, 4, 4).contiguous())
        self.register_buffer("init_r", torch.zeros(num_cams, 3))
        self.register_buffer("init_t", torch.zeros(num_cams, 3))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """Every parameter ~ N(0, 1e-4) (reference run.py:39-42), so early
        corrections are tiny."""
        for p in self.mlp.parameters():
            p.normal_(0.0, 1e-4, generator=generator)

    @torch.no_grad()
    def update_init_pose(self, cam_id: int, c2w: torch.Tensor):
        """Refresh keyframe cam_id's initial pose from tracking
        (reference rba.py:65-70)."""
        c2w = c2w.to(self.init_c2w)
        self.init_c2w[cam_id] = c2w
        self.init_r[cam_id] = pose_math.matrix_to_axis_angle(c2w[:3, :3])
        self.init_t[cam_id] = c2w[:3, 3]

    def forward(self, cam_ids: torch.Tensor) -> torch.Tensor:
        """cam_ids [B] int -> refined c2w [B, 4, 4]."""
        cam_ids = cam_ids.reshape(-1)
        id_norm = (cam_ids.to(torch.float32) / self.num_cams) * 2.0 - 1.0
        init_r = self.init_r[cam_ids]
        init_t = self.init_t[cam_ids]
        inputs = torch.cat([id_norm[:, None], init_r, init_t], -1)
        out = self.mlp(inputs) * self.scale
        out = torch.where((cam_ids == 0)[:, None], 0.0, out)
        return pose_math.at_to_c2w(out[:, :3] + init_r, out[:, 3:] + init_t)
