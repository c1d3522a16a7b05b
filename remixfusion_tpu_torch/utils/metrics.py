"""Image quality metrics of the rendering evaluation: PSNR, SSIM and the
perceptual distance (LPIPS-AlexNet when its weights are present, else the
random-feature proxy), computed with torch on the device.

Counterpart of remixfusion_tpu.utils.metrics (reference utils.py:342-387,
mp_slam/mapper.py:729-807), which computes the same numbers with scipy:

  - SSIM: the 11x11 Gaussian window (sigma 1.5) per channel, as a float64
    conv2d with replicate padding (scipy.ndimage.convolve's mode
    'nearest'); the image is masked where the ground truth is 0;
  - the random-feature proxy: the same filter bank (default_rng(0), 24
    zero-mean unit-norm 3x3x3 filters, numpy data), applied as a true
    convolution with zero padding (scipy.signal.fftconvolve's mode 'same':
    conv2d with the flipped filters), per-pixel unit-normalised across the
    24 channels, over a 3-level 2x2-mean pyramid.

Inputs are [H, W, C] numpy arrays or tensors in [0, 1]; they are moved to
`device` (default: the card, see resolve_device) in float64.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from remixfusion_tpu_torch import resolve_device
from remixfusion_tpu_torch.utils import lpips


def mse2psnr(mse: float) -> float:
    return float(-10.0 * np.log10(max(mse, 1e-12)))


def _to_chw(img, device) -> torch.Tensor:
    """[H, W, C] array or tensor -> float64 [C, 1, H, W] on `device`."""
    t = torch.as_tensor(img).to(device=device, dtype=torch.float64)
    return t.permute(2, 0, 1)[:, None]


def _gaussian_window(size=11, sigma=1.5) -> np.ndarray:
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g)


def ssim(img, gt, window_size=11, device=None):
    """img, gt: [H, W, C] in [0, 1]. Masks img where gt == 0 (reference
    utils.py:355-364). Returns (ssim_map [H, W, C] float64 numpy, mean)."""
    dev = resolve_device(device)
    a, b = _to_chw(img, dev), _to_chw(gt, dev)
    a = torch.where(b != 0, a, torch.zeros((), dtype=a.dtype, device=dev))
    win = torch.as_tensor(_gaussian_window(window_size), device=dev)[None,
                                                                      None]
    p = window_size // 2
    c1, c2 = 0.01 ** 2, 0.03 ** 2

    def filt(x):
        # the window is symmetric: correlation = scipy's convolution
        return F.conv2d(F.pad(x, (p, p, p, p), mode="replicate"), win)

    mu1, mu2 = filt(a), filt(b)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = filt(a * a) - mu1_sq
    s2 = filt(b * b) - mu2_sq
    s12 = filt(a * b) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * s12 + c2)) / \
        ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    ssim_map = ssim_map[:, 0].permute(1, 2, 0)
    return ssim_map.cpu().numpy(), float(ssim_map.mean())


def random_feature_bank(seed=0, n_ch=24) -> np.ndarray:
    """The proxy's fixed random 3x3x3 filters [n_ch, 3, 3, 3] (zero-mean,
    unit-norm): the JAX package's bank, bit for bit."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 1, (n_ch, 3, 3, 3)).astype(np.float64)
    w -= w.mean(axis=(1, 2, 3), keepdims=True)
    w /= np.linalg.norm(w.reshape(n_ch, -1), axis=1).reshape(-1, 1, 1, 1)
    return w


def _rf_features(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[n_ch, H, W] channel-normalised features of a [1, 3, H, W] image;
    `w` is the bank flipped in both spatial axes (convolution)."""
    f = F.conv2d(x, w, padding=1)[0]
    return f / (torch.linalg.vector_norm(f, dim=0, keepdim=True) + 1e-10)


def _half(x: torch.Tensor) -> torch.Tensor:
    return 0.25 * (x[..., 0::2, 0::2] + x[..., 1::2, 0::2]
                   + x[..., 0::2, 1::2] + x[..., 1::2, 1::2])


def random_feature_perceptual(img, gt, n_scales: int = 3, device=None):
    """Self-contained perceptual distance: mean squared distance between
    channel-normalised random-conv features over a dyadic image pyramid
    (0 = identical); the documented LPIPS stand-in where the pretrained
    weights are absent."""
    dev = resolve_device(device)
    a = _to_chw(img, dev).permute(1, 0, 2, 3)
    b = _to_chw(gt, dev).permute(1, 0, 2, 3)
    w = torch.as_tensor(random_feature_bank(), device=dev).flip(-1, -2)
    total = 0.0
    for s in range(n_scales):
        fa, fb = _rf_features(a, w), _rf_features(b, w)
        total += float(((fa - fb) ** 2).sum(0).mean())
        if s < n_scales - 1:
            a, b = _half(a), _half(b)
    return total / n_scales


def perceptual_distance(img, gt, device=None):
    """(value, kind): LPIPS-AlexNet when its weights file is present (kind
    'lpips'), else the random-feature proxy (kind 'rf_perceptual')."""
    if lpips.weights_available():
        return lpips.lpips(img, gt, device=device), "lpips"
    return random_feature_perceptual(img, gt, device=device), "rf_perceptual"
