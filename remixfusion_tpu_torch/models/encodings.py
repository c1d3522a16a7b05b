"""Input encodings of the residual field, as functional (init, apply)
objects over torch tensors.

Counterpart of remixfusion_tpu.models.encodings (reference
model/encodings.py:6-103) for the encoders the main path uses:
  - HashGridEncoding: the multiresolution hash grid (tcnn convention); its
    table gradient is the hand-written kernel of ops/hash_enc.py;
  - CPGridEncoding: the CP-factorized multiresolution grid (the shipped
    default), as a gather-and-lerp of the two non-zero tents per axis;
  - OneBlobEncoding: the positional branch.
The encoder objects hold no state: `enc(params, x)` with the trainable
table (a tensor, or a dict of factor tensors for CPGrid) passed in, as in
the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from remixfusion_tpu_torch.ops.hash_enc import HashEncodeFunction


class HashGridEncoding:
    """Multiresolution hash-grid encoding (trainable): n_levels levels of
    `level_dim` features, per-level growth exp2(log2(desired / n_levels) /
    (n_levels - 1)), level scale base * growth^l - 1, dense levels where
    res^3 fits the hash map size, sizes aligned to 8 rows."""

    def __init__(self, n_levels: int = 16, level_dim: int = 2,
                 base_resolution: int = 16, log2_hashmap_size: int = 19,
                 desired_resolution: int = 512):
        self.n_levels = n_levels
        self.level_dim = level_dim
        self.base_resolution = base_resolution
        self.hashmap_size = 1 << log2_hashmap_size
        if n_levels > 1:
            self.per_level_scale = 2.0 ** (
                math.log2(desired_resolution / n_levels) / (n_levels - 1))
        else:
            self.per_level_scale = 1.0
        self.out_dim = n_levels * level_dim
        self.resolutions, self.hashed, self.offsets = [], [], [0]
        off = 0
        for lvl in range(n_levels):
            scale = self.base_resolution * (self.per_level_scale ** lvl) - 1.0
            res = int(math.ceil(scale)) + 1
            use_hash = res ** 3 > self.hashmap_size
            size = self.hashmap_size if use_hash else res ** 3
            off += (size + 7) // 8 * 8
            self.resolutions.append(res)
            self.hashed.append(use_hash)
            self.offsets.append(off)
        self.table_size = off
        # the level scales as float32, cast once from Python doubles
        self.scales = [float(np.float32(
            self.base_resolution * (self.per_level_scale ** lvl) - 1.0))
            for lvl in range(n_levels)]

    def init(self, generator: torch.Generator, device) -> torch.Tensor:
        """Table ~ U(-1e-4, 1e-4) (tcnn's hash-table init)."""
        t = torch.empty((self.table_size, self.level_dim),
                        dtype=torch.float32, device=device)
        return t.uniform_(-1e-4, 1e-4, generator=generator)

    def __call__(self, table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """x [N, 3] (nominally [0, 1]) -> features [N, n_levels * level_dim]."""
        return HashEncodeFunction.apply(x, table, self)


class _RoundBF16(torch.autograd.Function):
    """float32 -> float32 rounded to bfloat16, whose gradient is rounded to
    bfloat16 too: what an f32 -> bf16 cast feeding a bf16-operand matmul
    does to the values and the cotangents under JAX autodiff."""

    @staticmethod
    def forward(ctx, a):
        return a.to(torch.bfloat16).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(torch.float32)


class CPGridEncoding:
    """CP-factorized multiresolution grid: per level l three factor tables
    [R_l, C_l]; a point's feature is A_l(x) * B_l(y) * C_l(z), concatenated
    over levels. The JAX package evaluates each 1D interpolation as a tent
    matrix times the table with bf16 operands (f32 accumulation); only two
    tents per row are non-zero, so here the two rows are gathered and
    lerped: tent weights max(0, 1 - |pos - i|) and factor rows rounded to
    bf16, products and their two-term sum in f32 — the same value up to the
    order of that sum."""

    def __init__(self, n_levels: int = 4, base_resolution: int = 48,
                 desired_resolution: int = 640):
        self.n_levels = n_levels
        top = max(min(desired_resolution, 800), base_resolution + 1)
        growth = ((top / base_resolution) ** (1.0 / (n_levels - 1))
                  if n_levels > 1 else 1.0)
        self.resolutions = [int(round(base_resolution * growth ** lvl))
                            for lvl in range(n_levels)]
        base_ch = [16, 32, 48, 48, 64, 64]
        self.channels = [base_ch[min(lvl, len(base_ch) - 1)]
                         for lvl in range(n_levels)]
        self.out_dim = sum(self.channels)

    def init(self, generator: torch.Generator, device) -> dict:
        """x/y factors 1 + U(-0.05, 0.05), z factor U(-1e-2, 1e-2)."""
        params = {}
        for lvl, (res, ch) in enumerate(zip(self.resolutions, self.channels)):
            for a in range(3):
                t = torch.empty((res, ch), dtype=torch.float32, device=device)
                if a < 2:
                    params[f"fac_{lvl}_{a}"] = 1.0 + t.uniform_(
                        -0.05, 0.05, generator=generator)
                else:
                    params[f"fac_{lvl}_{a}"] = t.uniform_(
                        -1e-2, 1e-2, generator=generator)
        return params

    def __call__(self, params, x: torch.Tensor) -> torch.Tensor:
        feats = []
        for lvl, res in enumerate(self.resolutions):
            pos = torch.clamp(x * (res - 1), 0.0, float(res - 1))
            i0 = torch.clamp(torch.floor(pos.detach()), max=res - 2)
            prod = None
            for a in range(3):
                p = pos[:, a:a + 1]
                i = i0[:, a:a + 1]
                w0 = torch.clamp(1.0 - torch.abs(p - i), min=0.0)
                w1 = torch.clamp(1.0 - torch.abs(p - (i + 1.0)), min=0.0)
                fac = _RoundBF16.apply(params[f"fac_{lvl}_{a}"])
                il = i[:, 0].to(torch.int64)
                # index_select, whose backward is an index_add_: a
                # subscript's backward sorts the thousands of repeated
                # rows first, which took most of a map step's device time
                # on the card
                f = (_RoundBF16.apply(w0) * fac.index_select(0, il)
                     + _RoundBF16.apply(w1) * fac.index_select(0, il + 1))
                prod = f if prod is None else prod * f
            feats.append(prod)
        return torch.cat(feats, -1)


class OneBlobEncoding:
    """OneBlob (n_bins per input dim): a Gaussian blob (sigma 1/n_bins)
    centred at the input, integrated over n_bins uniform bins of [0, 1]
    (reference model/encodings.py:65-76)."""

    def __init__(self, n_bins: int = 16, input_dim: int = 3):
        self.n_bins = n_bins
        self.input_dim = input_dim
        self.out_dim = n_bins * input_dim
        self._edges = np.linspace(0.0, 1.0, n_bins + 1, dtype=np.float32)
        self._edges_on = {}  # per device, uploaded once
        self._sigma = 1.0 / n_bins

    def init(self, generator=None, device=None):
        return None

    def __call__(self, _params, x: torch.Tensor) -> torch.Tensor:
        edges = self._edges_on.get(x.device)
        if edges is None:
            edges = torch.from_numpy(self._edges).to(x.device)
            self._edges_on[x.device] = edges
        inv = 1.0 / (self._sigma * math.sqrt(2.0))
        up = torch.special.erf((edges[1:] - x[..., None]) * inv)
        lo = torch.special.erf((edges[:-1] - x[..., None]) * inv)
        val = 0.5 * (up - lo) * self.n_bins * (
            self._sigma * math.sqrt(2 * math.pi))
        return val.reshape(x.shape[0], self.out_dim)


def get_encoder(encoding: str, input_dim: int = 3, n_bins: int = 16,
                n_levels: int = 16, level_dim: int = 2,
                base_resolution: int = 16, log2_hashmap_size: int = 19,
                desired_resolution: int = 512):
    """Encoder factory with the reference's name matching
    (model/encodings.py:6-103). Returns (encoder, out_dim)."""
    enc = encoding.lower()
    # the JAX factory's matching order; names it matches to an encoder the
    # port does not have yet raise
    if "cpgrid" in enc or enc == "cp":
        e = CPGridEncoding(n_levels=4, base_resolution=48,
                           desired_resolution=min(desired_resolution, 800))
    elif "triplane" in enc or "dense" in enc:
        raise _not_ported(encoding)
    elif "hash" in enc or "tiled" in enc:
        e = HashGridEncoding(n_levels, level_dim, base_resolution,
                             log2_hashmap_size, desired_resolution)
    elif "spherical" in enc:
        raise _not_ported(encoding)
    elif "blob" in enc:
        e = OneBlobEncoding(n_bins, input_dim)
    elif "freq" in enc or "identity" in enc:
        raise _not_ported(encoding)
    else:
        raise ValueError(f"unknown encoding {encoding}")
    return e, e.out_dim


def _not_ported(encoding: str) -> NotImplementedError:
    return NotImplementedError(
        f"encoding {encoding!r} is not ported yet (ROADMAP queue 1, item 9: "
        f"the Triplane, Frequency, SphericalHarmonics, Dense and Identity "
        f"encoders)")
