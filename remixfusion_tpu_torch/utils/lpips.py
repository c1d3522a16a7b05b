"""LPIPS (AlexNet) as a torch module, with its weights read from an npz file.

Counterpart of remixfusion_tpu.utils.lpips_jax (the reference computes
LPIPS with torchmetrics' AlexNet backbone, mp_slam/mapper.py:729-807). The
pretrained weights are not in the repository; scripts/convert_lpips_weights
.py writes them once, where downloads work, as an npz with the keys
conv{i}_w [O, I, k, k], conv{i}_b [O] and lin{i}_w [O] (i = 0..4). The port
reads the same file from remixfusion_tpu_torch/assets/lpips_alex.npz; when
it is absent, utils/metrics.perceptual_distance uses the random-feature
proxy.

LPIPS (Zhang et al., CVPR 2018, as in torchmetrics):
  1. scale the input from [0, 1] to [-1, 1], then normalise by
     shift (-.030, -.088, -.188) and scale (.458, .448, .450);
  2. AlexNet features after each of the 5 ReLUs (max-pool 3/2 after the
     first two);
  3. unit-normalise each feature map across channels (eps 1e-10);
  4. squared difference, the non-negative 1x1 'lin' weights, spatial mean,
     summed over the 5 layers.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from remixfusion_tpu_torch import resolve_device

ASSET = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "lpips_alex.npz")

# AlexNet-features convolutions: (out_ch, kernel, stride, padding)
CONVS = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
         (256, 3, 1, 1), (256, 3, 1, 1)]
_POOL_AFTER = (0, 1)
_SHIFT = (-.030, -.088, -.188)
_SCALE = (.458, .448, .450)


def weights_available() -> bool:
    """Whether the weights file ASSET exists."""
    return os.path.exists(ASSET)


class LPIPS(nn.Module):
    """LPIPS-AlexNet built from a params dict (numpy arrays under the
    converter's keys)."""

    def __init__(self, params: dict):
        super().__init__()
        for i in range(len(CONVS)):
            for key in (f"conv{i}_w", f"conv{i}_b", f"lin{i}_w"):
                self.register_buffer(key, torch.as_tensor(
                    np.asarray(params[key], np.float32)))
        self.register_buffer("shift", torch.tensor(_SHIFT).reshape(
            1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_SCALE).reshape(
            1, 3, 1, 1))

    def features(self, x: torch.Tensor) -> list:
        feats = []
        for i, (_, _, stride, pad) in enumerate(CONVS):
            x = F.relu(F.conv2d(x, getattr(self, f"conv{i}_w"),
                                getattr(self, f"conv{i}_b"), stride=stride,
                                padding=pad))
            feats.append(x)
            if i in _POOL_AFTER:
                x = F.max_pool2d(x, 3, 2)
        return feats

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a, b: [H, W, 3] float32 in [0, 1] -> scalar distance."""
        def prep(im):
            im = im.permute(2, 0, 1)[None] * 2.0 - 1.0
            return (im - self.shift) / self.scale

        # full float32 convolutions on the card (no TF32), as on the CPU
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            fa, fb = self.features(prep(a)), self.features(prep(b))
        total = torch.zeros((), device=a.device)
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            na = xa / torch.sqrt(torch.sum(xa * xa, 1, keepdim=True) + 1e-10)
            nb = xb / torch.sqrt(torch.sum(xb * xb, 1, keepdim=True) + 1e-10)
            w = getattr(self, f"lin{i}_w")
            total = total + torch.mean(torch.sum(
                (na - nb) ** 2 * w[None, :, None, None], 1))
        return total


def load(device=None) -> LPIPS:
    """The network with the weights of ASSET; FileNotFoundError when the
    file is absent."""
    if not weights_available():
        raise FileNotFoundError(ASSET)
    with np.load(ASSET) as raw:
        params = {k: raw[k] for k in raw.files}
    return LPIPS(params).to(resolve_device(device))


def lpips(img, gt, device=None, net: LPIPS | None = None) -> float:
    """LPIPS of two [H, W, 3] arrays in [0, 1]; the network of the asset
    file unless `net` is given."""
    dev = resolve_device(device)
    net = load(device=dev) if net is None else net
    a = torch.as_tensor(img).to(device=dev, dtype=torch.float32)
    b = torch.as_tensor(gt).to(device=dev, dtype=torch.float32)
    with torch.no_grad():
        return float(net(a, b))
