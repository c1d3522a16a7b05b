"""SDF / color decoder MLPs as torch modules.

Counterpart of remixfusion_tpu.models.decoder (reference model/decoder.py):
  - SDFNet: bias-free MLP [hash + oneblob + explicit tsdf] -> [sdf, geo_feat]
  - ColorNet: bias-free MLP [oneblob + geo_feat + explicit rgb] -> rgb
  - ColorSDFNet: the joint forward of the residual decoders.

The JAX package stores a layer's weight [in, out] and applies h @ w;
nn.Linear stores [out, in] (utils/convert.py transposes).
"""

from __future__ import annotations

import math
from typing import Callable, List

import torch
from torch import nn


class MLP(nn.Module):
    """Plain MLP; bias-free unless `bias`. `zero_init_last` scales the last
    layer's initial weights by 1e-4, so a residual decoder starts at ~0 and
    untrained regions fall back to the explicit TSDF/color."""

    def __init__(self, dims: List[int],
                 activation: Callable = torch.relu, bias: bool = False,
                 zero_init_last: bool = False):
        super().__init__()
        self.dims = list(dims)
        self.activation = activation
        self.layers = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1], bias=bias)
            for i in range(len(dims) - 1))
        self.zero_init_last = zero_init_last

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """U(-1/sqrt(in), 1/sqrt(in)) weights and biases (nn.Linear's
        default, the JAX init), drawn from `generator`."""
        n = len(self.layers)
        for i, lin in enumerate(self.layers):
            bound = 1.0 / math.sqrt(lin.in_features)
            lin.weight.uniform_(-bound, bound, generator=generator)
            if self.zero_init_last and i == n - 1:
                lin.weight.mul_(1e-4)
            if lin.bias is not None:
                lin.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        n = len(self.layers)
        for i, lin in enumerate(self.layers):
            h = lin(h)
            if i != n - 1:
                h = self.activation(h)
        return h


class SDFNet(MLP):
    def __init__(self, input_ch: int, geo_feat_dim: int = 15,
                 hidden_dim: int = 64, num_layers: int = 2):
        super().__init__([input_ch] + [hidden_dim] * (num_layers - 1)
                         + [1 + geo_feat_dim], zero_init_last=True)


class ColorNet(MLP):
    def __init__(self, input_ch: int, geo_feat_dim: int = 15,
                 hidden_dim_color: int = 64, num_layers_color: int = 3):
        super().__init__([input_ch + geo_feat_dim]
                         + [hidden_dim_color] * (num_layers_color - 1) + [3],
                         zero_init_last=True)


class ColorSDFNet(nn.Module):
    """sdf branch sees [embed, embed_pos, explicit tsdf]; color branch
    [embed_pos, geo_feat, explicit rgb] (reference decoder.py:116-146)."""

    def __init__(self, config, input_ch: int, input_ch_pos: int):
        super().__init__()
        dec = config["decoder"]
        self.sdf_net = SDFNet(input_ch + input_ch_pos + 1,
                              geo_feat_dim=dec["geo_feat_dim"],
                              hidden_dim=dec["hidden_dim"],
                              num_layers=dec["num_layers"])
        self.color_net = ColorNet(input_ch_pos + 3,
                                  geo_feat_dim=dec["geo_feat_dim"],
                                  hidden_dim_color=dec["hidden_dim_color"],
                                  num_layers_color=dec["num_layers_color"])

    def reset_parameters(self, generator: torch.Generator):
        self.sdf_net.reset_parameters(generator)
        self.color_net.reset_parameters(generator)

    def forward(self, embed, embed_pos, ex_tsdf, ex_rgb):
        h = self.sdf_net(torch.cat([embed, embed_pos, ex_tsdf], -1))
        sdf, geo_feat = h[..., :1], h[..., 1:]
        rgb = self.color_net(torch.cat([embed_pos, geo_feat, ex_rgb], -1))
        return torch.cat([rgb, sdf], -1)
