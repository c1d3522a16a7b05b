"""Mixed scene representation: explicit global TSDF grid + implicit
residual field, as a torch module.

Counterpart of remixfusion_tpu.models.scene_rep (reference
model/scene_rep.py:13-528):
  - explicit branch: the dense global grid gbv [R, R, R, 4] (tsdf, rgb) and
    its fusion weights gbw [R, R, R] (buffers, written by
    ops/tsdf.integrate_global, read by trilinear queries; node i sits at
    normalized coordinate i / R);
  - implicit branch: the residual encoding's table (`hash_table`: a tensor
    for HashGrid and DenseGrid, a dict of tables for CPGrid and Triplane,
    None for the parameter-free Frequency, SphericalHarmonics and
    Identity encodings) + OneBlob + the
    residual decoders (ColorSDFNet), whose SDF and color residuals are
    added onto the explicit values;
  - the RBA pose-refinement network.

The hot query (query_color_sdf: every map step, BA step and render) reads
the explicit grid through its bf16 query mirror `gbq` [R, R, R, 4], as the
JAX package does (scene_rep.query_gbvw_fast): every corner is the bf16
rounding of the float32 grid, blended in float32. The mirror is state: None
until the grid is first written (mapping/mapper.py refreshes it after every
integrate and reset, slam/pipeline.py after every load), and the hot query
reads the float32 grid while it is None. Every other query (query_gbv,
query_gbw, query_sdf_res, the explicit-only and mesh queries) reads the
float32 grid. JAX's oct-packed tile-major rows of the mirror and its
incremental refresher are TPU layout and have no counterpart.

Every random draw takes an explicit torch.Generator, and sample_z_vals and
smoothness also accept their uniform draws as arguments, so tests can give
both packages the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from remixfusion_tpu_torch.models.decoder import ColorSDFNet
from remixfusion_tpu_torch.models.encodings import get_encoder
from remixfusion_tpu_torch.models.rba import RBA


# corner k of a trilinear cell: (dx, dy, dz) = 000, 001, .., 111
CORNERS = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]


@torch.no_grad()
def refresh_mirror(mirror, grid: torch.Tensor) -> torch.Tensor:
    """The bf16 query mirror of `grid`: its rounding to nearest even,
    written into `mirror` or, when that is None, into a new tensor (the
    JAX mapper's _pack_gbq and incremental refresher give the same
    values)."""
    if mirror is None:
        return grid.to(torch.bfloat16)
    return mirror.copy_(grid)


class SceneRepresentation(nn.Module):
    def __init__(self, config, bound_box, num_kf: int, device="cpu",
                 generator: torch.Generator | None = None, grid_rows=None):
        """grid_rows: None for a scene that holds its explicit grid (the
        buffers gbv [R, R, R, 4], gbw [R, R, R] and the mirror gbq, None
        until refresh_gbq); or a function (name, base [N], offsets) ->
        [N, 8, C], the 8 corner rows (row base + offsets[k]) of the
        flattened grid `name` (gbv, gbw or gbq) held elsewhere, or None for
        a grid held nowhere, as parallel/sharding.SlabGrid.rows reads the
        ranks' slabs. The scene then holds no grid (gbv, gbw and gbq are
        None) and its queries read those rows. The parameters' draws do not
        depend on it."""
        super().__init__()
        self.config = config
        bb = np.asarray(bound_box, np.float32)
        self.register_buffer("bound_box", torch.tensor(bb, device=device))
        self.num_kf = num_kf
        dim_max = float(np.max(bb[:, 1] - bb[:, 0]))
        voxel_sdf = config["grid"]["voxel_sdf"]
        self.resolution_sdf = (int(voxel_sdf) if voxel_sdf > 10
                               else int(dim_max / voxel_sdf))
        self.embedpos_fn, self.input_ch_pos = get_encoder(
            config["pos"]["enc"], n_bins=config["pos"]["n_bins"])
        self.embed_res_fn, self.input_ch = get_encoder(
            config["grid"]["enc"],
            log2_hashmap_size=config["grid"]["hash_size"],
            desired_resolution=self.resolution_sdf)
        self.decoder_res = ColorSDFNet(config, self.input_ch,
                                       self.input_ch_pos)
        self.rba = RBA(num_kf, scale=config["mapping"]["pose_scale"])
        self.gbv_resolution = int(config["globalV"]["base_resolution"])
        self.c_trunc = config["training"]["c_trunc"]
        self.trunc = config["training"]["trunc"]
        self.grid_rows = grid_rows
        R = self.gbv_resolution
        self.corner_offsets = [dx * R * R + dy * R + dz
                               for dx, dy, dz in CORNERS]
        if grid_rows is None:
            gbv = torch.zeros((R, R, R, 4), device=device)
            gbv[..., 0] = 1.0
            self.register_buffer("gbv", gbv)
            self.register_buffer("gbw", torch.zeros((R, R, R),
                                                    device=device))
            self.register_buffer("gbq", None)
            self.register_buffer("corner_off", torch.tensor(
                self.corner_offsets, device=device), persistent=False)
        else:
            self.gbv = self.gbw = self.gbq = None
        self.to(device)

        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        table = self.embed_res_fn.init(generator, device)
        if table is None:
            self.hash_table = None
        elif isinstance(table, dict):
            self.hash_table = nn.ParameterDict(
                {k: nn.Parameter(v) for k, v in table.items()})
        else:
            self.hash_table = nn.Parameter(table)
        with torch.no_grad():
            self.decoder_res.reset_parameters(generator)
            self.rba.reset_parameters(generator)

    # --------------------------------------------------- parameter groups

    def field_parameters(self):
        """The residual encoding's table(s); none for a parameter-free
        encoding."""
        if self.hash_table is None:
            return []
        if isinstance(self.hash_table, nn.ParameterDict):
            return list(self.hash_table.values())
        return [self.hash_table]

    def decoder_parameters(self):
        return list(self.decoder_res.parameters())

    def _table(self):
        if isinstance(self.hash_table, nn.ParameterDict):
            return dict(self.hash_table.items())
        return self.hash_table

    # ---------------------------------------------------- explicit volume

    def refresh_gbq(self):
        """Round the float32 grid into the bf16 query mirror, whole."""
        if self.grid_rows is not None:
            raise ValueError("the scene holds no grid: the slabs keep the "
                             "mirror (parallel/sharding.SlabGrid)")
        self.gbq = refresh_mirror(self.gbq, self.gbv)

    def _corner_rows(self, name: str, base: torch.Tensor):
        """[N, 8, C] corner rows of the grid `name` (flattened to [R^3, C])
        at the low-corner rows base [N], in one gather: from the scene's
        own grid, or from grid_rows when it holds none. None for a grid
        that is not held (a mirror not yet made)."""
        if self.grid_rows is not None:
            return self.grid_rows(name, base, self.corner_offsets)
        grid = getattr(self, name)
        if grid is None:
            return None
        R = self.gbv_resolution
        return grid.reshape(R ** 3, -1)[base[:, None] + self.corner_off]

    def _trilinear(self, names, pts: torch.Tensor):
        """Trilinear lookup at normalized points [N, 3] (node i at i / R,
        clamped to the interpolation range) -> [N, C] float32, of the first
        grid of `names` that is held: gbv (C = 4), gbw (C = 1) or the bf16
        mirror gbq (C = 4, each corner upcast to float32, exactly JAX's
        float32 x bf16 promotion). The corners are weighted and added in
        one order whichever grid they come from."""
        R = self.gbv_resolution
        pos = pts * R
        low = torch.clamp(torch.floor(pos), 0, R - 2)
        frac = torch.clamp(pos - low, 0.0, 1.0)
        li = low.to(torch.int64)
        base = li[:, 0] * (R * R) + li[:, 1] * R + li[:, 2]
        for name in names:
            rows = self._corner_rows(name, base)
            if rows is not None:
                break
        rows = rows.float()
        out = torch.zeros((pts.shape[0], rows.shape[2]),
                          dtype=torch.float32, device=pts.device)
        for k, (dx, dy, dz) in enumerate(CORNERS):
            w = ((frac[:, 0] if dx else 1 - frac[:, 0])
                 * (frac[:, 1] if dy else 1 - frac[:, 1])
                 * (frac[:, 2] if dz else 1 - frac[:, 2]))
            out = out + w[:, None] * rows[:, k]
        return out

    def query_gbv(self, pts: torch.Tensor) -> torch.Tensor:
        """[N, 4] (tsdf, r, g, b) of the float32 grid at normalized points
        [N, 3]."""
        return self._trilinear(("gbv",), pts)

    def query_gbq(self, pts: torch.Tensor) -> torch.Tensor:
        """[N, 4] (tsdf, r, g, b) of the hot query at normalized points
        [N, 3]: through the bf16 mirror when it is held, else the float32
        grid (JAX query_gbvw_fast)."""
        return self._trilinear(("gbq", "gbv"), pts)

    def query_gbw(self, pts: torch.Tensor) -> torch.Tensor:
        """[N] trilinear fusion weight at normalized points [N, 3]."""
        return self._trilinear(("gbw",), pts)[:, 0]

    def normalize(self, pts_world: torch.Tensor) -> torch.Tensor:
        """World -> [0, 1]^3 normalized coordinates."""
        bb = self.bound_box
        return (pts_world - bb[:, 0]) / (bb[:, 1] - bb[:, 0])

    def _explicit_tsdf(self, ex_trgb: torch.Tensor) -> torch.Tensor:
        """Explicit TSDF in the residual field's truncation units."""
        return ex_trgb[..., 0] * self.c_trunc / self.trunc

    # ------------------------------------------------------------ queries

    def query_sdf_res(self, pts: torch.Tensor, embed: bool = False):
        """Residual-corrected SDF at normalized points [N, 3]
        (reference scene_rep.py:212-248); embed=True returns the residual
        encoding alone."""
        embedded = self.embed_res_fn(self._table(), pts)
        if embed:
            return embedded
        embedded_pos = self.embedpos_fn(None, pts)
        tmp_tsdf = torch.clamp(self._explicit_tsdf(self.query_gbv(pts)),
                               -1.0, 1.0)
        h = self.decoder_res.sdf_net(
            torch.cat([embedded, embedded_pos, tmp_tsdf[:, None]], -1))
        return h[..., 0] + tmp_tsdf

    def query_sdf_ex(self, pts: torch.Tensor) -> torch.Tensor:
        """Explicit-only SDF (the raw grid tsdf) at normalized points
        (scene_rep.py:250-265)."""
        return self.query_gbv(pts)[..., 0]

    def query_w_res(self, pts: torch.Tensor) -> torch.Tensor:
        """Fusion weight, the mesh's validity mask (scene_rep.py:269-282)."""
        return self.query_gbw(pts)

    def query_color_residual(self, pts: torch.Tensor) -> torch.Tensor:
        """Residual-corrected color for mesh vertex coloring
        (scene_rep.py:285-298). The decoder gets the explicit tsdf raw:
        neither rescaled by c_trunc / trunc nor clamped, unlike
        query_color_sdf."""
        embedded = self.embed_res_fn(self._table(), pts)
        embedded_pos = self.embedpos_fn(None, pts)
        ex_trgb = self.query_gbv(pts)
        raw = self.decoder_res(embedded, embedded_pos, ex_trgb[..., :1],
                               ex_trgb[..., 1:])
        return raw[..., :3] + ex_trgb[..., 1:]

    def query_color_ex(self, pts: torch.Tensor) -> torch.Tensor:
        """Explicit-only color (scene_rep.py:300-310)."""
        return self.query_gbv(pts)[..., 1:]

    def query_color_sdf(self, pts: torch.Tensor, clamp: bool = False):
        """Joint query of the render path [N, 3] -> [N, 4] (rgb, sdf),
        reading the explicit grid through the bf16 mirror when it is held
        (query_gbq); `clamp` is the bundle-adjustment clamping of the
        explicit TSDF (scene_rep.py:314-349)."""
        embedded = self.embed_res_fn(self._table(), pts)
        embedded_pos = self.embedpos_fn(None, pts)
        ex_trgb = self.query_gbq(pts)
        tmp_tsdf = self._explicit_tsdf(ex_trgb)
        if clamp:
            th = self.config["mapping"]["clamp"]
            tmp_tsdf = torch.clamp(tmp_tsdf, -th, th)
            cin_tsdf = torch.clamp(tmp_tsdf, -1.0, 1.0)
        else:
            tmp_tsdf = torch.clamp(tmp_tsdf, -1.0, 1.0)
            cin_tsdf = tmp_tsdf
        raw = self.decoder_res(embedded, embedded_pos, cin_tsdf[:, None],
                               ex_trgb[..., 1:])
        rgb = raw[..., :3] + ex_trgb[..., 1:]
        sdf = raw[..., 3] + tmp_tsdf
        return torch.cat([rgb, sdf[:, None]], -1)

    # ---------------------------------------------------------- rendering

    def sdf2weights(self, sdf: torch.Tensor, z_vals: torch.Tensor):
        """SDF -> rendering weights: dual sigmoid with first-surface
        masking (reference scene_rep.py:107-127)."""
        trunc = self.config["training"]["trunc"]
        weights = torch.sigmoid(sdf / trunc) * torch.sigmoid(-sdf / trunc)
        signs = sdf[:, 1:] * sdf[:, :-1]
        mask = torch.where(signs < 0.0, 1.0, 0.0)
        inds = torch.argmax(mask, 1)
        z_min = torch.gather(z_vals, 1, inds[:, None])
        sc = self.config["data"]["sc_factor"]
        mask = torch.where(z_vals < z_min + sc * trunc, 1.0, 0.0)
        weights = weights * mask
        return weights / (torch.sum(weights, -1, keepdim=True) + 1e-8)

    def raw2outputs(self, raw: torch.Tensor, z_vals: torch.Tensor):
        weights = self.sdf2weights(raw[..., 3], z_vals)
        rgb_map = torch.sum(weights[..., None] * raw[..., :3], -2)
        depth_map = torch.sum(weights * z_vals, -1)
        return rgb_map, depth_map

    def z_vals_shape(self, n_rays: int):
        t = self.config["training"]
        return (n_rays, t["n_range_d"] + max(t["n_samples_d"], 0))

    def sample_z_vals(self, target_d: torch.Tensor, u: torch.Tensor = None,
                      generator: torch.Generator | None = None):
        """Depth-guided stratified samples along rays [N, S] (reference
        scene_rep.py:416-441); `u` [N, S] the perturbation draws (else
        drawn from `generator`)."""
        cfg = self.config
        t = cfg["training"]
        n_rays = target_d.shape[0]
        dev = target_d.device
        near, far = cfg["cam"]["near"], cfg["cam"]["far"]
        z_samples = torch.linspace(-t["range_d"], t["range_d"],
                                   t["n_range_d"], device=dev)[None] + target_d
        uniform_fb = torch.linspace(near, far, t["n_range_d"],
                                    device=dev)[None].expand_as(z_samples)
        z_samples = torch.where(target_d <= 0, uniform_fb, z_samples)
        if t["n_samples_d"] > 0:
            z_uniform = torch.linspace(near, far, t["n_samples_d"],
                                       device=dev)[None].expand(
                                           n_rays, t["n_samples_d"])
            z_vals = torch.sort(torch.cat([z_uniform, z_samples], -1),
                                -1).values
        else:
            z_vals = z_samples
        if t["perturb"] > 0:
            if u is None:
                u = torch.rand(z_vals.shape, generator=generator, device=dev)
            mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
            upper = torch.cat([mids, z_vals[..., -1:]], -1)
            lower = torch.cat([z_vals[..., :1], mids], -1)
            z_vals = lower + (upper - lower) * u
        return z_vals

    def render_rays(self, rays_o, rays_d, target_d, clamp: bool = False,
                    u=None, generator=None):
        """Render a ray batch: rgb/depth maps, z_vals, raw samples
        (reference scene_rep.py:407-456)."""
        z_vals = self.sample_z_vals(target_d, u=u, generator=generator)
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
        flat = self.normalize(pts.reshape(-1, 3))
        raw = self.query_color_sdf(flat, clamp=clamp).reshape(
            pts.shape[0], pts.shape[1], 4)
        rgb_map, depth_map = self.raw2outputs(raw, z_vals)
        return {"rgb_res_map": rgb_map, "depth_res_map": depth_map,
                "z_vals": z_vals, "raw": raw}

    # ------------------------------------------------------------- losses

    def mapping_losses(self, rays_o, rays_d, target_rgb, target_d,
                       clamp: bool = False, u=None, generator=None,
                       count_reduce=None):
        """Render + the four mapping losses (reference scene_rep.py:460-528,
        model/utils.py:170-256). count_reduce: None, or a function that
        sums a tensor of counts over the ranks of a sharded step, so that
        the masked means divide by the whole batch's counts."""
        cfg = self.config
        rend = self.render_rays(rays_o, rays_d, target_d, clamp=clamp, u=u,
                                generator=generator)
        td = target_d[:, 0]
        valid = (td > 0.0) & (td < cfg["cam"]["depth_trunc"])
        rgb_weight = torch.where(valid, 1.0, float(
            cfg["training"]["rgb_missing"]))[:, None]
        rgb_res_loss = torch.mean((rend["rgb_res_map"] * rgb_weight
                                   - target_rgb * rgb_weight) ** 2)
        derr = (rend["depth_res_map"] - td) ** 2
        n_valid = torch.sum(valid)
        if count_reduce is not None:
            n_valid = count_reduce(n_valid)
        depth_res_loss = torch.sum(derr * valid) / torch.clamp(n_valid, min=1)
        truncation = cfg["training"]["trunc"] * cfg["data"]["sc_factor"]
        fs_res_loss, sdf_res_loss = self.sdf_losses(
            rend["z_vals"], target_d, rend["raw"][..., 3], truncation,
            middle_mask=valid, count_reduce=count_reduce)
        return {"rgb_res_loss": rgb_res_loss,
                "depth_res_loss": depth_res_loss,
                "sdf_res_loss": sdf_res_loss, "fs_res_loss": fs_res_loss,
                "rgb_res": rend["rgb_res_map"],
                "depth_res": rend["depth_res_map"]}

    @staticmethod
    def sdf_losses(z_vals, target_d, predicted_sdf, truncation,
                   middle_mask=None, count_reduce=None):
        """Free-space + SDF regression losses (model/utils.py:170-256);
        count_reduce as mapping_losses takes it."""
        front_mask = torch.where(z_vals < (target_d - truncation), 1.0, 0.0)
        back_mask = torch.where(z_vals > (target_d + truncation), 1.0, 0.0)
        depth_mask = torch.where(target_d > 0.0, 1.0, 0.0)
        sdf_mask = (1.0 - front_mask) * (1.0 - back_mask) * depth_mask
        num_fs = torch.sum(front_mask > 0)
        num_sdf = torch.sum(sdf_mask > 0)
        if count_reduce is not None:
            num_fs, num_sdf = count_reduce(torch.stack([num_fs, num_sdf]))
        num = torch.clamp(num_fs + num_sdf, min=1)
        fs_weight = 1.0 - num_fs / num
        sdf_weight = 1.0 - num_sdf / num
        if middle_mask is not None:
            front_mask = front_mask * middle_mask[:, None]
            sdf_mask = sdf_mask * middle_mask[:, None]
        fs_loss = torch.mean(
            (predicted_sdf * front_mask - front_mask) ** 2) * fs_weight
        sdf_loss = torch.mean(
            ((z_vals + predicted_sdf * truncation) * sdf_mask
             - target_d * sdf_mask) ** 2) * sdf_weight
        return fs_loss, sdf_loss

    def smoothness_points(self, sample_points: int, voxel_size: float,
                          margin: float, u=None, generator=None):
        """The smoothness term's random sub-grid [n^3, 3] (normalized),
        n = sample_points - 1; `u` = (offset draw [3], jitter draw [3])."""
        bb = self.bound_box
        dev = bb.device
        if u is None:
            u = (torch.rand(3, generator=generator, device=dev),
                 torch.rand(3, generator=generator, device=dev))
        grid_size = (sample_points - 1) * voxel_size
        offset_max = bb[:, 1] - bb[:, 0] - grid_size - 2 * margin
        offset = u[0] * offset_max + margin
        n = sample_points - 1
        ar = torch.arange(n, device=dev, dtype=torch.float32)
        coords = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), -1)
        pts = (coords + u[1].reshape(1, 1, 1, 3)) * voxel_size \
            + bb[:, 0] + offset
        return self.normalize(pts.reshape(-1, 3))

    def smoothness(self, sample_points=256, voxel_size=0.1, margin=0.05,
                   u=None, generator=None):
        """TV smoothness of the residual embedding over a random sub-grid
        (reference mp_slam/slam.py:193-217)."""
        n = sample_points - 1
        pts = self.smoothness_points(sample_points, voxel_size, margin, u=u,
                                     generator=generator)
        emb = self.query_sdf_res(pts, embed=True).reshape(n, n, n, -1)
        tv_x = torch.sum((emb[1:] - emb[:-1]) ** 2)
        tv_y = torch.sum((emb[:, 1:] - emb[:, :-1]) ** 2)
        tv_z = torch.sum((emb[:, :, 1:] - emb[:, :, :-1]) ** 2)
        return (tv_x + tv_y + tv_z) / (sample_points ** 3)
