"""Neural mapping + explicit fusion + MLP-amortized bundle adjustment.

Counterpart of remixfusion_tpu.mapping.mapper (reference
mp_slam/mapper.py:191-950):
  - integrate_keyframe: TSDF fusion of a keyframe into the explicit global
    grid (ops/tsdf.integrate_global) over the host-selected frustum tiles,
    or the dense sweep where the selection's budget reaches the whole grid;
    it and reset_global_volume refresh the grid's bf16 query mirror whole
    (SceneRepresentation.refresh_gbq), where JAX refreshes the changed
    tiles of its oct-packed rows: the same values;
  - map_step / map_step_dev: `iters` optimization steps of the residual
    field + decoders through the rendering losses and the TV smoothness,
    on host rays (first frame) or on rays sampled on the device from the
    keyframe store and the current frame;
  - ba_step_dev: `BA_iters` steps of the RBA pose network through the same
    rendering losses with the explicit TSDF clamped; returns the refined
    keyframe poses for the host write-back;
  - opt_state_arrays / load_opt_state_arrays: both optimizers' states for
    a resume checkpoint, in torch's state_dict layout.

The JAX package's optax groups become torch.optim.Adam parameter groups
(betas (0.9, 0.99) everywhere): the field table(s) at eps 1e-15, lr
lr_embed_res, no decay; the decoders at weight decay 1e-6, eps 1e-8, lr
lr_decoder; the RBA network at weight decay 1e-6, eps 1e-15, lr lr_pose
(optax's add_decayed_weights before scale_by_adam is the L2 term of torch's
weight_decay). Its lax.scan over iterations is a Python loop.

Every step takes a torch.Generator for its draws, or `draws`: one dict per
iteration with the sampler's indices (g_idx [sample], c_idx [n_cur]), the
depth-sample perturbation z_u [N, S] and the smoothness draws smooth_u
((offset [3], jitter [3])); tests feed both packages the same numbers
through it.

On a CUDA device the loss bodies inside the scene's mapping_losses and
smoothness replay as CUDA graphs (models/scene_rep.py); the sampling, the
ray transform, the RBA network, zero_grad and Adam stay eager, and every
step still calls map_loss / ba_loss, _step and the scene's two methods
through the instance. `graph_hit` records per step whether replays served
it: `_step` reads the scene's count (utils/cuda_graphs) since the last
step.
"""

from __future__ import annotations

import contextlib
import json

import numpy as np
import torch

from remixfusion_tpu_torch.ops import tsdf as tsdf_ops
from remixfusion_tpu_torch.utils.spans import span


@contextlib.contextmanager
def frozen(params):
    """Treat `params` as constants (no gradient) inside the block: the
    JAX stop_gradient of the field and decoders in bundle adjustment."""
    flags = [p.requires_grad for p in params]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, f in zip(params, flags):
            p.requires_grad_(f)


def rays_world(dirs: torch.Tensor, poses: torch.Tensor):
    """Camera-frame directions [N, 3] and per-ray c2w [N, 4, 4] -> (rays_o,
    rays_d) [N, 3] in the world frame (rays_d[n] = R[n] @ dirs[n])."""
    rays_d = torch.sum(dirs[:, None, :] * poses[:, :3, :3], -1)
    return poses[:, :3, 3], rays_d


class Mapper:
    def __init__(self, config, scene):
        self.config = config
        self.scene = scene
        m = config["mapping"]
        t = config["training"]
        self.sample = m["sample"]
        self.loss_w = (t["rgb_weight"], t["depth_weight"], t["sdf_weight"],
                       t["fs_weight"])
        self.smooth_weight = t["smooth_weight"]
        self.smooth_args = (t["smooth_pts"], t["smooth_vox"],
                            t["smooth_margin"])
        betas = (0.9, 0.99)
        self.map_opt = torch.optim.Adam([
            {"params": scene.field_parameters(), "lr": m["lr_embed_res"],
             "eps": 1e-15, "weight_decay": 0.0},
            {"params": scene.decoder_parameters(), "lr": m["lr_decoder"],
             "eps": 1e-8, "weight_decay": 1e-6}], betas=betas)
        self.rba_opt = torch.optim.Adam(
            scene.rba.parameters(), lr=m["lr_pose"], betas=betas, eps=1e-15,
            weight_decay=1e-6)
        # per map or BA step: 1 when its loss bodies were served by CUDA
        # graph replays (models/loss_graphs.py), 0 when they ran eagerly
        # or captured
        self.graph_hit = []

    # ------------------------------------------------------------ resume

    OPTIMIZERS = ("map_opt", "rba_opt")

    def opt_state_arrays(self) -> dict:
        """Both optimizers' state_dicts as numpy arrays: the tensors of
        parameter slot i under <opt>_state_<i>_<key> (key: step, exp_avg,
        exp_avg_sq) and the parameter groups as JSON under
        <opt>_param_groups."""
        out = {}
        for name in self.OPTIMIZERS:
            sd = getattr(self, name).state_dict()
            for i, st in sd["state"].items():
                for k, v in st.items():
                    out[f"{name}_state_{i}_{k}"] = (
                        v.detach().cpu().numpy() if torch.is_tensor(v)
                        else np.asarray(v))
            out[f"{name}_param_groups"] = np.asarray(
                json.dumps(sd["param_groups"]))
        return out

    def load_opt_state_arrays(self, data):
        """Inverse of opt_state_arrays (a mapping of numpy arrays); the
        tensors go to each parameter's device, as load_state_dict does."""
        for name in self.OPTIMIZERS:
            prefix = f"{name}_state_"
            state = {}
            for key in data.keys():
                if key.startswith(prefix):
                    i, k = key[len(prefix):].split("_", 1)
                    state.setdefault(int(i), {})[k] = torch.from_numpy(
                        np.array(data[key]))
            groups = json.loads(str(data[f"{name}_param_groups"]))
            getattr(self, name).load_state_dict(
                {"state": state, "param_groups": groups})

    # ------------------------------------------------------------- fusion

    def select_integrate_tiles(self, host_depth, host_c2w, K_np, bound,
                               im_h: int, im_w: int, kf_index=None):
        """Host-side tile selection of integrate_keyframe: voxel offsets
        [n, 3] of the tiles to integrate, or None for the dense sweep (no
        tile size, no host depth, or a selection whose budget bucket
        reaches the whole grid — the JAX mapper's decision, so both
        packages integrate the same voxels). With kf_index and
        mapping.gfs_every > 1 the pure free-space tiles rotate over
        gfs_every keyframes (phase kf_index % gfs_every)."""
        R = self.scene.gbv_resolution
        tile = tsdf_ops.pick_global_tile(R)
        if host_depth is None or tile is None:
            return None
        bound_np = np.asarray(bound, np.float64)
        vs = (bound_np[:, 1] - bound_np[:, 0]) / R
        dmax = float(np.max(host_depth))
        lam_max = float(np.sqrt(
            1.0 + max(((0 - K_np[0, 2]) / K_np[0, 0]) ** 2,
                      ((im_w - K_np[0, 2]) / K_np[0, 0]) ** 2)
            + max(((0 - K_np[1, 2]) / K_np[1, 1]) ** 2,
                  ((im_h - K_np[1, 2]) / K_np[1, 1]) ** 2)))
        trunc = self.config["training"]["c_trunc"]
        gfs_every = int(self.config["mapping"].get("gfs_every", 1))
        rot = ((int(kf_index) % gfs_every, gfs_every)
               if kf_index is not None and gfs_every > 1 else None)
        offs = tsdf_ops.frustum_tiles(
            (R, R, R), tile, bound_np[:, 0], vs, K_np,
            np.asarray(host_c2w), im_h, im_w,
            max_depth=lam_max * (dmax + trunc), pad_px=2.0,
            depth_map=host_depth, lam_max=lam_max, trunc=trunc,
            free_rotate=rot)
        n_total = (R // tile) ** 3
        budget = next((b for b in tsdf_ops.global_budget_buckets(n_total)
                       if b >= offs.shape[0]), n_total)
        return None if budget >= n_total else offs

    def integrate_keyframe(self, depth, rgb, K, c2w, bound,
                           obs_weight: float = 1.0, host_depth=None,
                           host_c2w=None, K_np=None, kf_index=None):
        """Fuse a keyframe into the scene's global grid, in place, and
        refresh its bf16 query mirror (reference mapper.py:823-872). depth
        [H, W], rgb [H, W, 3] in [0, 1], K [3, 3], c2w [4, 4], bound [3, 2]
        (the config's mapping.bound): tensors on the grid's device. With
        host_depth (+ host_c2w, K_np as numpy) only the selected frustum
        tiles are swept; the host selection reads the bounds from the
        config, so it never waits for the device."""
        im_h, im_w = int(depth.shape[0]), int(depth.shape[1])
        offs = None
        if host_depth is not None:
            offs = self.select_integrate_tiles(
                host_depth, host_c2w, K_np, self.config["mapping"]["bound"],
                im_h, im_w, kf_index=kf_index)
        s = self.scene
        tsdf_ops.integrate_global(
            s.gbv, s.gbw, depth, rgb, K, c2w, bound,
            trunc_margin=self.config["training"]["c_trunc"],
            obs_weight=obs_weight, tiles=offs,
            tile=tsdf_ops.pick_global_tile(s.gbv_resolution))
        s.refresh_gbq()

    @torch.no_grad()
    def reset_global_volume(self):
        """clean_tsdf: tsdf 1, rgb 0, weights 0 (reference
        mapper.py:161-183); the bf16 query mirror follows."""
        self.scene.gbv.zero_()
        self.scene.gbv[..., 0] = 1.0
        self.scene.gbw.zero_()
        self.scene.refresh_gbq()

    # ------------------------------------------------------------- losses

    def _weighted_loss(self, ret, include_smooth: bool, smooth_u=None,
                       generator=None):
        rgb_w, depth_w, sdf_w, fs_w = self.loss_w
        loss = (rgb_w * ret["rgb_res_loss"] + depth_w * ret["depth_res_loss"]
                + sdf_w * ret["sdf_res_loss"] + fs_w * ret["fs_res_loss"])
        if include_smooth and self.smooth_weight > 0:
            pts, vox, margin = self.smooth_args
            loss = loss + self.smooth_weight * self.scene.smoothness(
                pts, vox, margin, u=smooth_u, generator=generator)
        return loss

    def map_loss(self, rays, rays_o, rays_d, draw=None, generator=None):
        """The map step's objective on a ray batch [N, 7] (world rays
        rays_o/rays_d [N, 3]): weighted rendering losses + smoothness."""
        draw = draw or {}
        ret = self.scene.mapping_losses(
            rays_o, rays_d, rays[:, 3:6], rays[:, 6:7], u=draw.get("z_u"),
            generator=generator)
        return self._weighted_loss(ret, True, draw.get("smooth_u"),
                                   generator)

    def _step(self, opt, loss):
        """One optimizer step on `loss`, inside the round's map.ba.* spans
        for the RBA optimizer and map.map.* for the map optimizer; appends
        the step's graph_hit."""
        pre = "map.ba" if opt is self.rba_opt else "map.map"
        with span(pre + ".backward"):
            opt.zero_grad(set_to_none=True)
            loss.backward()
        with span(pre + ".adam"):
            opt.step()
        self.graph_hit.append(self.scene.graphs.hit())
        return loss.detach()

    # ----------------------------------------------------------- map step

    def map_step(self, ray_batches, rays_o_b, rays_d_b, generator=None):
        """ray_batches [I, N, 7], rays_o_b / rays_d_b [I, N, 3] (world rays
        from fixed poses): I steps of the map optimizer. Returns the
        losses [I] (device tensor)."""
        losses = []
        for i in range(ray_batches.shape[0]):
            with span("map.map.forward"):
                loss = self.map_loss(ray_batches[i], rays_o_b[i],
                                     rays_d_b[i], generator=generator)
            losses.append(self._step(self.map_opt, loss))
        return torch.stack(losses)

    # ---------------------------------------- device-sampled mapping / BA

    def sample_batch(self, kf_store, n_kf, dirs_flat, rgb_flat, depth_flat,
                     cur_kf_id, n_cur, draw=None, generator=None):
        """[N, 7] rays + [N] keyframe slots, N = sample + n_cur: uniform
        with replacement over the stored rays of the first n_kf keyframes,
        then uniform pixels of the current frame (mapper.py:395-415)."""
        dev = kf_store.rays.device
        R = kf_store.R
        if draw is not None and "g_idx" in draw:
            g_idx = draw["g_idx"].to(dev)
            c_idx = draw["c_idx"].to(dev)
        else:
            g_idx = torch.randint(0, max(n_kf, 1) * R, (self.sample,),
                                  generator=generator, device=dev)
            c_idx = torch.randint(0, dirs_flat.shape[0], (n_cur,),
                                  generator=generator, device=dev)
        c_rays = torch.cat([dirs_flat[c_idx], rgb_flat[c_idx],
                            depth_flat[c_idx][:, None]], -1)
        rays = torch.cat([kf_store.rays[g_idx], c_rays], 0)
        ids = torch.cat([g_idx // R, torch.full((n_cur,), cur_kf_id,
                                                dtype=torch.int64,
                                                device=dev)])
        return rays, ids

    def map_step_dev(self, kf_store, n_kf, dirs_flat, dep, rgb, kf_poses,
                     cur_kf_id: int, n_iters: int, n_cur: int,
                     generator=None, draws=None):
        """n_iters map steps on batches sampled from the keyframe store and
        the current frame (dep [H, W], rgb [H, W, 3]). kf_poses [num_kf, 4,
        4] are the keyframes' poses; the current keyframe's comes from the
        RBA network (no gradient). Returns the losses [n_iters]."""
        with torch.no_grad():
            cur = torch.tensor([cur_kf_id], device=kf_poses.device)
            poses_all = kf_poses.clone()
            poses_all[cur_kf_id] = self.scene.rba(cur)[0]
        rgb_flat, depth_flat = rgb.reshape(-1, 3), dep.reshape(-1)
        losses = []
        for i in range(n_iters):
            draw = None if draws is None else draws[i]
            with span("map.map.sample"):
                rays, ids = self.sample_batch(
                    kf_store, n_kf, dirs_flat, rgb_flat, depth_flat,
                    cur_kf_id, n_cur, draw, generator)
                rays_o, rays_d = rays_world(rays[:, :3],
                                            poses_all.index_select(0, ids))
            with span("map.map.forward"):
                loss = self.map_loss(rays, rays_o, rays_d, draw, generator)
            losses.append(self._step(self.map_opt, loss))
        return torch.stack(losses)

    def ba_loss(self, rays, ids, draw=None, generator=None):
        """The BA objective: rendering losses through the RBA poses of
        every keyframe slot, explicit TSDF clamped, no smoothness (its
        points do not depend on the poses)."""
        scene = self.scene
        all_ids = torch.arange(scene.num_kf, device=rays.device)
        rays_o, rays_d = rays_world(
            rays[:, :3], scene.rba(all_ids).index_select(0, ids))
        ret = scene.mapping_losses(
            rays_o, rays_d, rays[:, 3:6], rays[:, 6:7], clamp=True,
            u=None if draw is None else draw.get("z_u"), generator=generator)
        return self._weighted_loss(ret, False)

    def ba_step_dev(self, kf_store, n_kf, dirs_flat, dep, rgb,
                    cur_kf_id: int, n_iters: int, n_cur: int,
                    generator=None, draws=None):
        """n_iters steps of the RBA optimizer (field and decoders held
        constant, as the JAX stop_gradient). Returns (losses [n_iters],
        refined poses of every keyframe slot [num_kf, 4, 4])."""
        scene = self.scene
        rgb_flat, depth_flat = rgb.reshape(-1, 3), dep.reshape(-1)
        losses = []
        with frozen(scene.field_parameters() + scene.decoder_parameters()):
            for i in range(n_iters):
                draw = None if draws is None else draws[i]
                with span("map.ba.sample"):
                    rays, ids = self.sample_batch(
                        kf_store, n_kf, dirs_flat, rgb_flat, depth_flat,
                        cur_kf_id, n_cur, draw, generator)
                with span("map.ba.forward"):
                    loss = self.ba_loss(rays, ids, draw, generator)
                losses.append(self._step(self.rba_opt, loss))
        with torch.no_grad():
            poses_all = scene.rba(torch.arange(scene.num_kf,
                                               device=dirs_flat.device))
        return torch.stack(losses), poses_all

    # ------------------------------------------------- ray batch assembly

    def current_ray_budget(self, n_kf: int) -> int:
        """Current-frame rays of a round: max(sample // n_kf,
        min_pixels_cur) (reference mapper.py:396), in the JAX package's
        three buckets."""
        m = self.config["mapping"]
        raw = max(self.sample // max(n_kf, 1), m["min_pixels_cur"])
        if raw <= m["min_pixels_cur"]:
            return m["min_pixels_cur"]
        if raw >= self.sample // 2:
            return self.sample
        return max(self.sample // 4, m["min_pixels_cur"])

    @staticmethod
    def rays_to_world_np(rays: np.ndarray, poses: np.ndarray):
        """Host ray transform of the first-frame map step. rays [N, 7],
        poses [N, 4, 4] -> (rays_o [N, 3], rays_d [N, 3]) float32."""
        rays_d = np.einsum("ni,nji->nj", rays[:, :3], poses[:, :3, :3])
        return (poses[:, :3, 3].astype(np.float32),
                rays_d.astype(np.float32))
