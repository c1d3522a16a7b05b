"""Input encodings of the residual field, as functional (init, apply)
objects over torch tensors.

Counterpart of remixfusion_tpu.models.encodings (reference
model/encodings.py:6-103):
  - HashGridEncoding: the multiresolution hash grid (tcnn convention); its
    table gradient is the hand-written kernel of ops/hash_enc.py;
  - DenseGridEncoding: four dense levels of the same grid (every level
    fits a 2^31 hash map), so the same kernel takes its gradient;
  - CPGridEncoding: the CP-factorized multiresolution grid (the shipped
    default), as a gather-and-lerp of the two non-zero tents per axis;
  - TriplaneEncoding: plane x line factorized levels (TensoRF-VM style);
  - OneBlobEncoding: the positional branch;
  - FrequencyEncoding, SphericalHarmonicsEncoding, IdentityEncoding: no
    trainable parameters (their table is None).
The encoder objects hold no state: `enc(params, x)` with the trainable
table (a tensor, a dict of factor tensors for CPGrid and Triplane, or None)
passed in, as in the JAX package.
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
                 desired_resolution: int = 512, per_level_scale=None):
        self.n_levels = n_levels
        self.level_dim = level_dim
        self.base_resolution = base_resolution
        self.hashmap_size = 1 << log2_hashmap_size
        if per_level_scale is not None:
            self.per_level_scale = float(per_level_scale)
        elif n_levels > 1:
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


class DenseGridEncoding(HashGridEncoding):
    """Multi-level dense grid (tcnn 'Dense' analog): a HashGridEncoding of
    n_levels levels with a 2^31 hash map, so every level is dense, and the
    growth exp2(log2(desired / n_levels) / max(n_levels - 1, 1)) of the
    JAX DenseGridEncoding. Its table gradient is hash_table_grad."""

    def __init__(self, n_levels: int = 4, level_dim: int = 2,
                 base_resolution: int = 16, desired_resolution: int = 512):
        super().__init__(
            n_levels, level_dim, base_resolution, log2_hashmap_size=31,
            desired_resolution=desired_resolution,
            per_level_scale=2.0 ** (math.log2(desired_resolution / n_levels)
                                    / max(n_levels - 1, 1)))


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


class TriplaneEncoding:
    """Factorized triplane + triline encoding (TensoRF-VM style): per level
    l and axis a, a plane [res_l^2, F] sampled bilinearly at two
    coordinates times a line [res_l, F] sampled linearly at the third,
    concatenated over levels and axes (3 * n_levels * F features).
    res_l = round(base * growth^l), capped at 2048. Rows are gathered with
    index_select (its backward is an index_add_); a corner past the last
    row is clamped onto it, as JAX's gather clamps, and its weight is 0."""

    AXES = ((0, 1, 2), (1, 2, 0), (2, 0, 1))  # (u, v, line axis)

    def __init__(self, n_levels: int = 3, level_dim: int = 4,
                 base_resolution: int = 64, desired_resolution: int = 512):
        self.n_levels = n_levels
        self.level_dim = level_dim
        growth = ((desired_resolution / base_resolution)
                  ** (1.0 / (n_levels - 1)) if n_levels > 1 else 1.0)
        self.resolutions = [
            min(int(round(base_resolution * growth ** lvl)), 2048)
            for lvl in range(n_levels)]
        self.out_dim = 3 * n_levels * level_dim

    def init(self, generator: torch.Generator, device) -> dict:
        """Planes U(-1e-2, 1e-2), lines 1 + U(-1e-2, 1e-2) (so plane * line
        starts near the plane)."""
        params = {}
        F = self.level_dim
        for lvl, res in enumerate(self.resolutions):
            for a in range(3):
                t = torch.empty((res * res, F), dtype=torch.float32,
                                device=device)
                params[f"plane_{lvl}_{a}"] = t.uniform_(
                    -1e-2, 1e-2, generator=generator)
                t = torch.empty((res, F), dtype=torch.float32, device=device)
                params[f"line_{lvl}_{a}"] = 1.0 + t.uniform_(
                    -1e-2, 1e-2, generator=generator)
        return params

    @staticmethod
    def _coord(u, res):
        """(integer cell int64, fraction [N, 1]) of u in [0, 1] on a
        res-node axis: u * (res - 1) clipped to [0, res - 1 - 1e-6], the
        upper end rounded to float32 as JAX's weak typing rounds it. The
        clip is jnp.clip's maximum-then-minimum, whose gradient is split
        in half where the value sits on a bound."""
        p = u * (res - 1)
        p = torch.minimum(torch.maximum(p, p.new_zeros(())),
                          p.new_full((), float(np.float32(res - 1 - 1e-6))))
        i = torch.floor(p.detach())
        return i.to(torch.int64), (p - i)[:, None]

    @staticmethod
    def _rows(table, idx):
        return table.index_select(0, idx.clamp(max=table.shape[0] - 1))

    def _bilinear(self, plane, res, u, v):
        iu, fu = self._coord(u, res)
        iv, fv = self._coord(v, res)
        base = iu * res + iv
        p00 = self._rows(plane, base)
        p01 = self._rows(plane, base + 1)
        p10 = self._rows(plane, base + res)
        p11 = self._rows(plane, base + res + 1)
        return ((1 - fu) * ((1 - fv) * p00 + fv * p01)
                + fu * ((1 - fv) * p10 + fv * p11))

    def _linear(self, line, res, w):
        iw, fw = self._coord(w, res)
        return (1 - fw) * self._rows(line, iw) + fw * self._rows(line, iw + 1)

    def __call__(self, params, x: torch.Tensor) -> torch.Tensor:
        """x [N, 3] in [0, 1] -> [N, 3 * n_levels * level_dim]."""
        feats = []
        for lvl, res in enumerate(self.resolutions):
            for a, (ua, va, wa) in enumerate(self.AXES):
                pl = self._bilinear(params[f"plane_{lvl}_{a}"], res,
                                    x[:, ua], x[:, va])
                ln = self._linear(params[f"line_{lvl}_{a}"], res, x[:, wa])
                feats.append(pl * ln)
        return torch.cat(feats, -1)


class FrequencyEncoding:
    """NeRF-style sin / cos encoding: per input dim, sin then cos of
    (x * 2^k) * pi for k < n_frequencies, in the JAX order of products
    (the arguments reach ~6.4e3 rad at k = 11, where an ulp is ~5e-4)."""

    def __init__(self, n_frequencies: int = 12, input_dim: int = 3):
        self.n_frequencies = n_frequencies
        self.input_dim = input_dim
        self.out_dim = input_dim * n_frequencies * 2
        self._freqs = [float(2.0 ** k) for k in range(n_frequencies)]
        self._freqs_on = {}  # per device, uploaded once

    def init(self, generator=None, device=None):
        return None

    def __call__(self, _params, x: torch.Tensor) -> torch.Tensor:
        freqs = self._freqs_on.get(x.device)
        if freqs is None:
            freqs = torch.tensor(self._freqs, dtype=torch.float32,
                                 device=x.device)
            self._freqs_on[x.device] = freqs
        xf = x[..., None] * freqs * math.pi
        enc = torch.cat([torch.sin(xf), torch.cos(xf)], -1)
        return enc.reshape(x.shape[0], self.out_dim)


class SphericalHarmonicsEncoding:
    """Real spherical harmonics of degrees 1..4 (degree^2 coefficients) of
    d = 2x - 1 for x in [0, 1]^3 (tcnn's mapping)."""

    def __init__(self, degree: int = 4):
        if not 1 <= degree <= 4:
            raise ValueError(f"SphericalHarmonics degree must be 1..4, "
                             f"got {degree}")
        self.degree = degree
        self.out_dim = degree ** 2

    def init(self, generator=None, device=None):
        return None

    def __call__(self, _params, d: torch.Tensor) -> torch.Tensor:
        d = d * 2.0 - 1.0
        x, y, z = d[:, 0], d[:, 1], d[:, 2]
        out = [torch.full_like(x, 0.28209479177387814)]
        if self.degree > 1:
            out += [-0.48860251190291987 * y,
                    0.48860251190291987 * z,
                    -0.48860251190291987 * x]
        if self.degree > 2:
            xy, yz, xz = x * y, y * z, x * z
            x2, y2, z2 = x * x, y * y, z * z
            out += [1.0925484305920792 * xy,
                    -1.0925484305920792 * yz,
                    0.94617469575755997 * z2 - 0.31539156525251999,
                    -1.0925484305920792 * xz,
                    0.54627421529603959 * (x2 - y2)]
        if self.degree > 3:
            out += [0.59004358992664352 * y * (-3.0 * x2 + y2),
                    2.8906114426405538 * xy * z,
                    0.45704579946446572 * y * (1.0 - 5.0 * z2),
                    0.3731763325901154 * z * (5.0 * z2 - 3.0),
                    0.45704579946446572 * x * (1.0 - 5.0 * z2),
                    1.4453057213202769 * z * (x2 - y2),
                    0.59004358992664352 * x * (-x2 + 3.0 * y2)]
        return torch.stack(out, -1)


class IdentityEncoding:
    def __init__(self, input_dim: int = 3):
        self.out_dim = input_dim

    def init(self, generator=None, device=None):
        return None

    def __call__(self, _params, x: torch.Tensor) -> torch.Tensor:
        return x


def get_encoder(encoding: str, input_dim: int = 3, degree: int = 4,
                n_bins: int = 16, n_frequencies: int = 12,
                n_levels: int = 16, level_dim: int = 2,
                base_resolution: int = 16, log2_hashmap_size: int = 19,
                desired_resolution: int = 512):
    """Encoder factory with the reference's name matching
    (model/encodings.py:6-103), in the JAX factory's order. Returns
    (encoder, out_dim)."""
    enc = encoding.lower()
    if "cpgrid" in enc or enc == "cp":
        e = CPGridEncoding(n_levels=4, base_resolution=48,
                           desired_resolution=min(desired_resolution, 800))
    elif "triplane" in enc:
        e = TriplaneEncoding(n_levels=3, level_dim=4, base_resolution=64,
                             desired_resolution=min(desired_resolution,
                                                    1024))
    elif "dense" in enc:
        e = DenseGridEncoding(4, level_dim, base_resolution,
                              desired_resolution)
    elif "hash" in enc or "tiled" in enc:
        e = HashGridEncoding(n_levels, level_dim, base_resolution,
                             log2_hashmap_size, desired_resolution)
    elif "spherical" in enc:
        e = SphericalHarmonicsEncoding(degree)
    elif "blob" in enc:
        e = OneBlobEncoding(n_bins, input_dim)
    elif "freq" in enc:
        e = FrequencyEncoding(n_frequencies, input_dim)
    elif "identity" in enc:
        e = IdentityEncoding(input_dim)
    else:
        raise ValueError(f"unknown encoding {encoding}")
    return e, e.out_dim
