"""Plain PyTorch reference of a mapping round's field work: the residual
field's encodings (CPGrid, HashGrid, OneBlob), the bias-free decoders, the
explicit grid read through its bf16 rounding, ray sampling and rendering,
the four mapping losses, the TV smoothness term, and the RBA pose network.

Frozen copy, in float32 and plain torch operations, of the arithmetic of
remixfusion_tpu_torch/models/{encodings,decoder,scene_rep,rba}.py,
mapping/mapper.py (map_loss, ba_loss) and core/pose.py (axis-angle maps) at
the revision this benchmark was written against. It imports nothing of
the program. Parameters come in as a dict of tensors keyed as the
program's SceneRepresentation names them (`hash_table` or
`hash_table.fac_<l>_<a>`, `decoder_res.*`, `rba.*`) plus the float32 grid
`gbv`; the bf16 query mirror is rounded here from `gbv`.

`control=True` rounds the operands of every decoder and RBA matrix
product to TF32 (10 explicit mantissa bits), the precision below the
configuration's float32 with TF32 off: the benchmark's control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_PRIMES = (1, 2654435761, 805459861)
_EPS = 1e-8
CORNERS = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (round to nearest on the 13 dropped bits); the
    gradient passes straight through."""
    d = x.detach().contiguous()
    r = ((d.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    r = torch.where(torch.isfinite(d), r, d)
    return x + (r - d)


class RoundBF16(torch.autograd.Function):
    """float32 rounded through bfloat16, its cotangent likewise."""

    @staticmethod
    def forward(ctx, a):
        return a.to(torch.bfloat16).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(torch.float32)


# ------------------------------------------------------------ encodings


def resolution_sdf(cfg) -> int:
    bb = np.asarray(cfg["mapping"]["bound"], np.float32)
    dim_max = float(np.max(bb[:, 1] - bb[:, 0]))
    v = cfg["grid"]["voxel_sdf"]
    return int(v) if v > 10 else int(dim_max / v)


class HashGrid:
    """Multiresolution hash grid, 16 levels x 2 features, tcnn layout."""

    def __init__(self, cfg, n_levels=16, level_dim=2, base=16):
        desired = resolution_sdf(cfg)
        self.n_levels, self.level_dim = n_levels, level_dim
        hashmap = 1 << int(cfg["grid"]["hash_size"])
        scale = 2.0 ** (math.log2(desired / n_levels) / (n_levels - 1))
        self.res, self.hashed, self.offsets = [], [], [0]
        off = 0
        for lvl in range(n_levels):
            res = int(math.ceil(base * scale ** lvl - 1.0)) + 1
            use_hash = res ** 3 > hashmap
            size = hashmap if use_hash else res ** 3
            off += (size + 7) // 8 * 8
            self.res.append(res)
            self.hashed.append(use_hash)
            self.offsets.append(off)
        self.scales = [float(np.float32(base * scale ** lvl - 1.0))
                       for lvl in range(n_levels)]

    @staticmethod
    def _mul(a, b):
        lo, hi = b & 0xFFFF, b >> 16
        return (a * lo + ((a * hi) & 0xFFFF) * 65536) & _M32

    def corners(self, x):
        """(rows int64 [N, L], weights [N, L]) of the 8 corners."""
        dev = x.device
        scales = torch.tensor(self.scales, dtype=torch.float64, device=dev)
        res = torch.tensor(self.res, dtype=torch.int64, device=dev)
        size = torch.tensor([self.offsets[i + 1] - self.offsets[i]
                             for i in range(self.n_levels)],
                            dtype=torch.int64, device=dev)
        off = torch.tensor(self.offsets[:-1], dtype=torch.int64, device=dev)
        hashed = torch.tensor(self.hashed, dtype=torch.bool, device=dev)
        res2 = self._mul(res, res)
        pos = (x.double()[:, None, :] * scales[None, :, None]
               + 0.5).to(torch.float32)
        c = torch.floor(pos.detach())
        frac = pos - c
        c = c.to(torch.int64)
        out = []
        for dx, dy, dz in CORNERS:
            cx = (c[..., 0] + dx) & _M32
            cy = (c[..., 1] + dy) & _M32
            cz = (c[..., 2] + dz) & _M32
            dense = (cx + self._mul(cy, res) + self._mul(cz, res2)) & _M32
            hsh = cx ^ self._mul(cy, _PRIMES[1]) ^ self._mul(cz, _PRIMES[2])
            row = torch.where(hashed, hsh, dense) % size + off
            w = ((frac[..., 0] if dx else 1 - frac[..., 0])
                 * (frac[..., 1] if dy else 1 - frac[..., 1])
                 * (frac[..., 2] if dz else 1 - frac[..., 2]))
            out.append((row, w))
        return out

    def __call__(self, P, x):
        table = P["hash_table"]
        out = 0.0
        for row, w in self.corners(x):
            out = out + w[..., None] * table[row]
        return out.reshape(x.shape[0], self.n_levels * self.level_dim)

    def leaves(self, P):
        return ["hash_table"]


class CPGrid:
    """CP-factorized grid: per level three factor tables, bf16 rows and
    tents, products in float32."""

    def __init__(self, cfg, n_levels=4, base=48):
        top = max(min(resolution_sdf(cfg), 800), base + 1)
        growth = (top / base) ** (1.0 / (n_levels - 1))
        self.res = [int(round(base * growth ** lvl))
                    for lvl in range(n_levels)]

    def __call__(self, P, x):
        feats = []
        for lvl, res in enumerate(self.res):
            pos = torch.clamp(x * (res - 1), 0.0, float(res - 1))
            i0 = torch.clamp(torch.floor(pos.detach()), max=res - 2)
            prod = None
            for a in range(3):
                p, i = pos[:, a:a + 1], i0[:, a:a + 1]
                w0 = torch.clamp(1.0 - torch.abs(p - i), min=0.0)
                w1 = torch.clamp(1.0 - torch.abs(p - (i + 1.0)), min=0.0)
                fac = RoundBF16.apply(P[f"hash_table.fac_{lvl}_{a}"])
                il = i[:, 0].to(torch.int64)
                f = (RoundBF16.apply(w0) * fac.index_select(0, il)
                     + RoundBF16.apply(w1) * fac.index_select(0, il + 1))
                prod = f if prod is None else prod * f
            feats.append(prod)
        return torch.cat(feats, -1)

    def leaves(self, P):
        return sorted(k for k in P if k.startswith("hash_table."))


def one_blob(x, n_bins):
    sigma = 1.0 / n_bins
    edges = torch.from_numpy(np.linspace(0.0, 1.0, n_bins + 1,
                                         dtype=np.float32)).to(x.device)
    inv = 1.0 / (sigma * math.sqrt(2.0))
    up = torch.special.erf((edges[1:] - x[..., None]) * inv)
    lo = torch.special.erf((edges[:-1] - x[..., None]) * inv)
    val = 0.5 * (up - lo) * n_bins * (sigma * math.sqrt(2 * math.pi))
    return val.reshape(x.shape[0], 3 * n_bins)


def encoder(cfg):
    name = cfg["grid"]["enc"].lower()
    if "cpgrid" in name:
        return CPGrid(cfg)
    if "hash" in name:
        return HashGrid(cfg)
    raise ValueError(f"the reference has no {cfg['grid']['enc']} encoding")


# ------------------------------------------------------------ decoders


def mlp(P, prefix, x, act=torch.relu, bias=False, control=False):
    n = 0
    while f"{prefix}.layers.{n}.weight" in P:
        n += 1
    h = x
    for i in range(n):
        w = P[f"{prefix}.layers.{i}.weight"]
        h = (tf32(h) @ tf32(w).T) if control else h @ w.T
        if bias:
            h = h + P[f"{prefix}.layers.{i}.bias"]
        if i != n - 1:
            h = act(h)
    return h


class Field:
    """The scene's hot query and rendering losses on captured tensors."""

    def __init__(self, cfg, control=False):
        self.cfg = cfg
        self.enc = encoder(cfg)
        self.control = control
        self.bound = torch.tensor(np.asarray(cfg["mapping"]["bound"],
                                             np.float32))
        self.R = int(cfg["globalV"]["base_resolution"])
        t = cfg["training"]
        self.c_trunc, self.trunc = t["c_trunc"], t["trunc"]

    def normalize(self, pts):
        bb = self.bound.to(pts.device)
        return (pts - bb[:, 0]) / (bb[:, 1] - bb[:, 0])

    def grid_query(self, gbq, pts):
        """Trilinear read of the bf16 mirror [R, R, R, 4] at normalized
        points, corners widened to float32."""
        R = self.R
        pos = pts * R
        low = torch.clamp(torch.floor(pos), 0, R - 2)
        frac = torch.clamp(pos - low, 0.0, 1.0)
        li = low.to(torch.int64)
        base = li[:, 0] * (R * R) + li[:, 1] * R + li[:, 2]
        flat = gbq.reshape(R ** 3, -1)
        out = torch.zeros((pts.shape[0], 4), dtype=torch.float32,
                          device=pts.device)
        for dx, dy, dz in CORNERS:
            rows = flat[base + dx * R * R + dy * R + dz].float()
            w = ((frac[:, 0] if dx else 1 - frac[:, 0])
                 * (frac[:, 1] if dy else 1 - frac[:, 1])
                 * (frac[:, 2] if dz else 1 - frac[:, 2]))
            out = out + w[:, None] * rows
        return out

    def color_sdf(self, P, gbq, pts, clamp=False):
        emb = self.enc(P, pts)
        emb_pos = one_blob(pts, int(self.cfg["pos"]["n_bins"]))
        ex = self.grid_query(gbq, pts)
        tmp = ex[..., 0] * self.c_trunc / self.trunc
        if clamp:
            th = self.cfg["mapping"]["clamp"]
            tmp = torch.clamp(tmp, -th, th)
            cin = torch.clamp(tmp, -1.0, 1.0)
        else:
            tmp = torch.clamp(tmp, -1.0, 1.0)
            cin = tmp
        h = mlp(P, "decoder_res.sdf_net",
                torch.cat([emb, emb_pos, cin[:, None]], -1),
                control=self.control)
        sdf_r, geo = h[..., :1], h[..., 1:]
        rgb_r = mlp(P, "decoder_res.color_net",
                    torch.cat([emb_pos, geo, ex[..., 1:]], -1),
                    control=self.control)
        return torch.cat([rgb_r + ex[..., 1:], (sdf_r[..., 0] + tmp)[:, None]],
                         -1)

    def z_vals(self, target_d, gen):
        cfg, t = self.cfg, self.cfg["training"]
        n, dev = target_d.shape[0], target_d.device
        near, far = cfg["cam"]["near"], cfg["cam"]["far"]
        z = torch.linspace(-t["range_d"], t["range_d"], t["n_range_d"],
                           device=dev)[None] + target_d
        fb = torch.linspace(near, far, t["n_range_d"],
                            device=dev)[None].expand_as(z)
        z = torch.where(target_d <= 0, fb, z)
        if t["n_samples_d"] > 0:
            zu = torch.linspace(near, far, t["n_samples_d"],
                                device=dev)[None].expand(n, t["n_samples_d"])
            z = torch.sort(torch.cat([zu, z], -1), -1).values
        if t["perturb"] > 0:
            u = torch.rand(z.shape, generator=gen, device=dev)
            mids = 0.5 * (z[..., 1:] + z[..., :-1])
            upper = torch.cat([mids, z[..., -1:]], -1)
            lower = torch.cat([z[..., :1], mids], -1)
            z = lower + (upper - lower) * u
        return z

    def weights(self, sdf, z):
        trunc = self.trunc
        w = torch.sigmoid(sdf / trunc) * torch.sigmoid(-sdf / trunc)
        signs = sdf[:, 1:] * sdf[:, :-1]
        mask = torch.where(signs < 0.0, 1.0, 0.0)
        inds = torch.argmax(mask, 1)
        z_min = torch.gather(z, 1, inds[:, None])
        sc = self.cfg["data"]["sc_factor"]
        w = w * torch.where(z < z_min + sc * trunc, 1.0, 0.0)
        return w / (torch.sum(w, -1, keepdim=True) + 1e-8)

    def losses(self, P, gbq, rays_o, rays_d, target_rgb, target_d, gen,
               clamp=False):
        cfg = self.cfg
        z = self.z_vals(target_d, gen)
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
        raw = self.color_sdf(P, gbq, self.normalize(pts.reshape(-1, 3)),
                             clamp).reshape(pts.shape[0], pts.shape[1], 4)
        w = self.weights(raw[..., 3], z)
        rgb_map = torch.sum(w[..., None] * raw[..., :3], -2)
        depth_map = torch.sum(w * z, -1)
        td = target_d[:, 0]
        valid = (td > 0.0) & (td < cfg["cam"]["depth_trunc"])
        rw = torch.where(valid, 1.0, float(
            cfg["training"]["rgb_missing"]))[:, None]
        rgb_l = torch.mean((rgb_map * rw - target_rgb * rw) ** 2)
        depth_l = torch.sum((depth_map - td) ** 2 * valid) / torch.clamp(
            torch.sum(valid), min=1)
        tr = cfg["training"]["trunc"] * cfg["data"]["sc_factor"]
        sdf = raw[..., 3]
        front = torch.where(z < (target_d - tr), 1.0, 0.0)
        back = torch.where(z > (target_d + tr), 1.0, 0.0)
        dmask = torch.where(target_d > 0.0, 1.0, 0.0)
        smask = (1.0 - front) * (1.0 - back) * dmask
        num_fs, num_sdf = torch.sum(front > 0), torch.sum(smask > 0)
        num = torch.clamp(num_fs + num_sdf, min=1)
        front = front * valid[:, None]
        smask = smask * valid[:, None]
        fs_l = torch.mean((sdf * front - front) ** 2) * (1.0 - num_fs / num)
        sdf_l = torch.mean(((z + sdf * tr) * smask - target_d * smask) ** 2
                           ) * (1.0 - num_sdf / num)
        t = cfg["training"]
        return (t["rgb_weight"] * rgb_l + t["depth_weight"] * depth_l
                + t["sdf_weight"] * sdf_l + t["fs_weight"] * fs_l)

    def smoothness(self, P, gen):
        t = self.cfg["training"]
        n_pts, vox, margin = t["smooth_pts"], t["smooth_vox"], \
            t["smooth_margin"]
        bb = self.bound.to(gen.device)
        dev = bb.device
        u0 = torch.rand(3, generator=gen, device=dev)
        u1 = torch.rand(3, generator=gen, device=dev)
        off = u0 * (bb[:, 1] - bb[:, 0] - (n_pts - 1) * vox - 2 * margin) \
            + margin
        n = n_pts - 1
        ar = torch.arange(n, device=dev, dtype=torch.float32)
        coords = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), -1)
        pts = (coords + u1.reshape(1, 1, 1, 3)) * vox + bb[:, 0] + off
        emb = self.enc(P, self.normalize(pts.reshape(-1, 3))).reshape(
            n, n, n, -1)
        tv = (torch.sum((emb[1:] - emb[:-1]) ** 2)
              + torch.sum((emb[:, 1:] - emb[:, :-1]) ** 2)
              + torch.sum((emb[:, :, 1:] - emb[:, :, :-1]) ** 2))
        return tv / (n_pts ** 3)

    # -------------------------------------------------------------- steps

    def map_loss(self, P, gbv, rays, rays_o, rays_d, gen):
        """The map step's objective (rendering losses + smoothness)."""
        gbq = gbv.to(torch.bfloat16)
        loss = self.losses(P, gbq, rays_o, rays_d, rays[:, 3:6],
                           rays[:, 6:7], gen)
        w = self.cfg["training"]["smooth_weight"]
        if w > 0:
            loss = loss + w * self.smoothness(P, gen)
        return loss

    def ba_loss(self, P, gbv, rays, ids, num_kf, gen):
        """The BA objective: rendering through the RBA poses, explicit
        TSDF clamped, no smoothness."""
        gbq = gbv.to(torch.bfloat16)
        poses = rba(P, torch.arange(num_kf, device=rays.device), num_kf,
                    self.cfg["mapping"]["pose_scale"], self.control)
        poses = poses.index_select(0, ids)
        rays_d = torch.sum(rays[:, None, :3] * poses[:, :3, :3], -1)
        return self.losses(P, gbq, poses[:, :3, 3], rays_d, rays[:, 3:6],
                           rays[:, 6:7], gen, clamp=True)

    def map_leaves(self, P):
        return self.enc.leaves(P) + sorted(
            k for k in P if k.startswith("decoder_res."))


def rba_leaves(P):
    return sorted(k for k in P if k.startswith("rba.mlp."))


# ----------------------------------------------------------------- Adam

BETAS = (0.9, 0.99)


def adam_settings(cfg, leaf: str) -> tuple:
    """(lr, eps, weight decay) of a leaf's Adam group: the residual
    encoding's tables, the decoders and the RBA network as the mapper
    sets them up from the configuration."""
    m = cfg["mapping"]
    if leaf.startswith("decoder_res."):
        return m["lr_decoder"], 1e-8, 1e-6
    if leaf.startswith("rba."):
        return m["lr_pose"], 1e-15, 1e-6
    return m["lr_embed_res"], 1e-15, 0.0


def adam_step(p, g, state, lr, eps, wd, betas=BETAS):
    """One Adam step (L2 weight decay, bias-corrected, no amsgrad) of
    parameter p with gradient g from `state` = (steps taken, first
    moment, second moment), or None before the first step; the new
    parameter."""
    b1, b2 = betas
    if state is None:
        t, m, v = 0, torch.zeros_like(p), torch.zeros_like(p)
    else:
        t, m, v = state
    if wd:
        g = g + wd * p
    m = m + (1.0 - b1) * (g - m)
    v = v * b2 + (1.0 - b2) * g * g
    t += 1
    denom = v.sqrt() / math.sqrt(1.0 - b2 ** t) + eps
    return p - (lr / (1.0 - b1 ** t)) * (m / denom)


# ------------------------------------------------------------ RBA poses


def axis_angle_to_matrix(aa):
    theta = torch.linalg.vector_norm(aa, dim=-1, keepdim=True)
    k = aa / torch.clamp(theta, min=_EPS)
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    z = torch.zeros_like(kx)
    K = torch.stack([torch.stack([z, -kz, ky], -1),
                     torch.stack([kz, z, -kx], -1),
                     torch.stack([-ky, kx, z], -1)], -2)
    theta = theta[..., None]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(K.shape)
    R = eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)
    return torch.where(theta > _EPS, R, eye)


def rba(P, cam_ids, num_kf, scale, control=False):
    """Refined c2w [B, 4, 4] of keyframe slots cam_ids."""
    idn = (cam_ids.to(torch.float32) / num_kf) * 2.0 - 1.0
    r0, t0 = P["rba.init_r"][cam_ids], P["rba.init_t"][cam_ids]
    out = mlp(P, "rba.mlp", torch.cat([idn[:, None], r0, t0], -1),
              act=torch.nn.functional.elu, bias=True, control=control)
    out = out * scale
    out = torch.where((cam_ids == 0)[:, None], 0.0, out)
    R = axis_angle_to_matrix(out[:, :3] + r0)
    t = out[:, 3:] + t0
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype,
                         device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([torch.cat([R, t[..., None]], -1), bottom], -2)
