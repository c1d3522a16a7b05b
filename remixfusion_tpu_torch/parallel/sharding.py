"""Scale-out over torch.distributed: data-parallel and grid-sharded mapping,
slab-sharded global fusion (and, in tracking/rotracker.py,
candidate-sharded tracking).

Counterpart of remixfusion_tpu.parallel.sharding. Where the JAX package
runs one SPMD program over a Mesh, the port runs one process per rank in a
process group (parallel/launch.py); every collective goes through
launch.Collectives.

  - Mapping is data-parallel over rays (sharded_map_train_step): the field,
    decoder and RBA parameters are replicated, rank r takes rows
    [r N/D, (r+1) N/D) of the ray batch and of its stratified draw, the
    masked means divide by the whole batch's counts (mapping_losses'
    count_reduce), and the gradients are summed over the ranks in one flat
    bucket before the optimizer steps. The loss is the four weighted
    rendering terms, no smoothness term, as in JAX.
  - Global fusion is slab-sharded (sharded_fuse_frame): rank r holds only
    the x-slab [x0, x1) of the [R, R, R, 4] grid and the [R, R, R] weights
    and fuses the replicated frame into it with ops/tsdf.integrate_global's
    per-voxel math at the voxels' global indices; no collectives. Slabs
    follow torch.tensor_split's row bounds, so R need not divide by D.
  - Grid-sharded mapping (gridsharded_map_train_step) is the memory-scaling
    mode: the explicit grid is the ranks' slabs (SlabGrid) and no rank holds
    it whole. The scene is built with SceneRepresentation(...,
    grid_rows=slab.rows): each query all-gathers the ranks' corner rows,
    every rank reads the rows it owns (zeros elsewhere), the [M, 8, C] rows
    are summed over the ranks with a reduce-scatter (each rank keeps its own
    points' rows) and the scene weights them in its single-process
    trilinear order, so the result is bitwise the single-process query.
    The hot query reads the slabs' bf16 query mirror (SlabGrid.gbq, the
    rounding of the rank's own slab, refreshed whole after each fuse by
    sharded_fuse_pack_gbq), as JAX's grid-sharded step reads its
    row-sharded gbq; its rows go through the collectives as float32 (the
    exact upcast), so the step stays bitwise the single-process step with
    the mirror. A slab that has no mirror yet serves the float32 slab.

The mirror's values are ported; JAX's oct-packed tile-major rows, their
ppermute halo and the incremental refresher are TPU layout and are not:

  JAX (remixfusion_tpu/parallel/sharding.py)   port
  make_mesh                                    launch.make_group, launch.spawn
  sharded_map_train_step                       sharded_map_train_step
  gridsharded_map_train_step                   gridsharded_map_train_step
  sharded_fuse_frame                           sharded_fuse_frame
  pad_rows_for_mesh                            pad_rows_for_mesh
  partition_tiles_by_device                    partition_tiles_by_device
  sharded_pack_gbq_tm                          SlabGrid.refresh_gbq
  sharded_fuse_pack_gbq                        sharded_fuse_pack_gbq
  make_sharded_gbq_refresher                   SlabGrid.refresh_gbq (whole)
  ROTracker(mesh=...)                          ROTracker(group=...)

`group` is a torch.distributed process group, or None for one process with
no collectives.
"""

from __future__ import annotations

import numpy as np
import torch

from remixfusion_tpu_torch.models.scene_rep import SceneRepresentation, \
    refresh_mirror
from remixfusion_tpu_torch.ops import tsdf as tsdf_ops
from remixfusion_tpu_torch.parallel.launch import collectives, world_rank


def slab_bounds(R: int, world: int, rank: int) -> tuple:
    """[x0, x1) of rank's x-slab: torch.tensor_split's row bounds (the first
    R % world slabs one row longer)."""
    if R < world:
        raise ValueError(f"a grid of {R} x-rows has no slab for each of "
                         f"{world} ranks")
    q, rem = divmod(int(R), int(world))
    x0 = rank * q + min(rank, rem)
    return x0, x0 + q + (1 if rank < rem else 0)


def pad_rows_for_mesh(arr: torch.Tensor, n_dev: int) -> torch.Tensor:
    """Pad axis 0 with zero rows to a multiple of n_dev."""
    pad = (-arr.shape[0]) % n_dev
    if pad == 0:
        return arr
    return torch.cat([arr, arr.new_zeros((pad,) + tuple(arr.shape[1:]))], 0)


def partition_tiles_by_device(offs: np.ndarray, R: int, tile: int,
                              n_dev: int, budget: int) -> np.ndarray:
    """Split a changed-tile set (voxel offsets, multiples of `tile`) into
    per-device groups int32 [n_dev, budget, 3] by the x-slab the tile lies
    in (device = x-tile index // (T / n_dev)). Every padded slot repeats the
    device's first tile, or the slab's tile 0 when it has none (refreshing
    a tile twice is idempotent). The JAX host helper, bit for bit; raises
    ValueError when T = R / tile does not split over n_dev or a device has
    more than `budget` tiles."""
    t = int(tile)
    T = R // t
    if T % n_dev:
        raise ValueError(f"{T} x-tiles do not split over {n_dev} devices")
    txd = T // n_dev
    out = np.zeros((n_dev, budget, 3), np.int32)
    for k in range(n_dev):
        out[k, :, 0] = k * txd * t
    if len(offs):
        dev = (offs[:, 0] // t) // txd
        for k in range(n_dev):
            grp = offs[dev == k]
            if len(grp) > budget:
                raise ValueError(
                    f"device {k} has {len(grp)} changed tiles > budget "
                    f"{budget}")
            if len(grp):
                out[k, :len(grp)] = grp
                out[k, len(grp):] = grp[0]
    return out


# ------------------------------------------------------------------ fusion

def sharded_fuse_frame(group, R: int, trunc_margin: float, H: int, W: int):
    """fuse(gbv, gbw, depth [H, W], rgb [H, W, 3], K, c2w, bound,
    obs_weight=1.0) -> (gbv, gbw): one frame fused in place into this
    rank's slab (SlabGrid's gbv, gbw) of the R^3 global grid, bitwise what
    integrate_global's dense sweep gives those voxels. No collectives.
    fuse.bounds is the slab's [x0, x1)."""
    x0, x1 = slab_bounds(R, *world_rank(collectives(group)))

    def fuse(gbv, gbw, depth, rgb, K, c2w, bound, obs_weight=1.0):
        if tuple(gbv.shape) != (x1 - x0, R, R, 4):
            raise ValueError(f"rank slab [{x0}, {x1}) of R={R}: gbv "
                             f"{tuple(gbv.shape)}")
        if tuple(depth.shape) != (H, W):
            raise ValueError(f"depth {tuple(depth.shape)}, expected "
                             f"{(H, W)}")
        return tsdf_ops.integrate_global(
            gbv, gbw, depth, rgb, K, c2w, bound, trunc_margin=trunc_margin,
            obs_weight=obs_weight, x0=x0)

    fuse.bounds = (x0, x1)
    return fuse


def sharded_fuse_pack_gbq(group, R: int, trunc_margin: float, H: int,
                          W: int):
    """fuse(slab, depth, rgb, K, c2w, bound, obs_weight=1.0) -> slab:
    sharded_fuse_frame into the SlabGrid `slab`, then its bf16 query mirror
    refreshed from the fused slab (SlabGrid.refresh_gbq). fuse.bounds is
    the slab's [x0, x1)."""
    inner = sharded_fuse_frame(group, R, trunc_margin, H, W)

    def fuse(slab, depth, rgb, K, c2w, bound, obs_weight=1.0):
        inner(slab.gbv, slab.gbw, depth, rgb, K, c2w, bound, obs_weight)
        slab.refresh_gbq()
        return slab

    fuse.bounds = inner.bounds
    return fuse


# ------------------------------------------------------------ the slab

def slab_rows(slab_flat: torch.Tensor, x0: int, R: int, base: torch.Tensor,
              offsets) -> torch.Tensor:
    """[B, 8, C]: the 8 corner rows of every low-corner row `base` [B] that
    lie in the slab starting at x-row x0 (slab_flat [S R^2, C]), zeros for
    the rows other slabs hold."""
    lo, n = x0 * R * R, slab_flat.shape[0]
    out = slab_flat.new_empty((base.shape[0], len(offsets),
                               slab_flat.shape[1]))
    for k, off in enumerate(offsets):
        idx = base + (off - lo)
        own = (idx >= 0) & (idx < n)
        out[:, k] = torch.where(own[:, None], slab_flat[idx.clamp(0, n - 1)],
                                0.0)
    return out


class SlabGrid:
    """This rank's x-slab [x0, x1) (`bounds`) of the R^3 global grid: gbv
    [S, R, R, 4] (tsdf 1, colour 0) and gbw [S, R, R] (0), S = x1 - x0, on
    `device`, and gbq, the bf16 query mirror of gbv (None until
    refresh_gbq). sharded_fuse_frame fuses into it (sharded_fuse_pack_gbq
    refreshes the mirror too); a scene built with
    SceneRepresentation(..., grid_rows=slab.rows) reads the grid through
    it, so no rank holds the grid whole."""

    def __init__(self, R: int, group, device):
        self.comm = collectives(group)
        self.R = int(R)
        self.bounds = x0, x1 = slab_bounds(R, *world_rank(self.comm))
        self.gbv = torch.zeros((x1 - x0, R, R, 4), dtype=torch.float32,
                               device=device)
        self.gbv[..., 0] = 1.0
        self.gbw = torch.zeros((x1 - x0, R, R), dtype=torch.float32,
                               device=device)
        self.gbq = None

    def refresh_gbq(self):
        """Round this rank's slab into its bf16 query mirror, whole."""
        self.gbq = refresh_mirror(self.gbq, self.gbv)

    def rows(self, name: str, base: torch.Tensor, offsets):
        """[M, 8, C]: the corner rows of the grid `name` (gbv, gbw or the
        mirror gbq, whose bf16 rows come as float32, the exact upcast) at
        this rank's low-corner rows base [M] (M equal on every rank); None
        for gbq while the slab has no mirror. The ranks' corner rows are
        all-gathered, every rank reads the rows its slab holds (zeros
        elsewhere), and the rows are summed over the ranks with a
        reduce-scatter that leaves each rank its own points' rows: one
        non-zero term each, so the sum is exact and the scene's trilinear
        blend of them is bitwise the single-process query. Detached: the
        grid takes no gradient."""
        x0, x1 = self.bounds
        grid = getattr(self, name)
        if grid is None:
            return None
        flat = grid.detach().reshape((x1 - x0) * self.R ** 2, -1)
        if self.comm is None:
            return slab_rows(flat, x0, self.R, base, offsets).float()
        return self.comm.reduce_scatter_sum(slab_rows(
            flat, x0, self.R, self.comm.all_gather_cat(base),
            offsets).float())


# ------------------------------------------------------------- map steps

def _rank_rows(n: int, world: int, rank: int) -> slice:
    if n % world:
        raise ValueError(f"a batch of {n} rays does not split over {world} "
                         f"ranks")
    m = n // world
    return slice(rank * m, (rank + 1) * m)


def _rank_share(ret, loss_weights, world: int):
    """This rank's share of the whole batch's weighted loss: the mean terms
    are means over equal shards (a D-th each); the depth term already
    divides the rank's sum by the whole batch's count. The shares sum to the
    loss; with one rank this is the four-term sum itself."""
    rgb_w, depth_w, sdf_w, fs_w = loss_weights
    return (rgb_w * ret["rgb_res_loss"] / world
            + depth_w * ret["depth_res_loss"]
            + sdf_w * ret["sdf_res_loss"] / world
            + fs_w * ret["fs_res_loss"] / world)


def _map_step(scene, optimizer, comm, loss_weights, rays, rays_o, rays_d, u,
              generator):
    world, rank = world_rank(comm)
    n = rays.shape[0]
    rows = _rank_rows(n, world, rank)
    if u is None and scene.config["training"]["perturb"] > 0:
        if generator is None:
            raise ValueError("the stratified draw needs `u` or a generator "
                             "seeded alike on every rank")
        u = torch.rand(scene.z_vals_shape(n), generator=generator,
                       device=rays.device)
    reduce = None if comm is None else comm.all_reduce_sum
    ret = scene.mapping_losses(
        rays_o[rows], rays_d[rows], rays[rows, 3:6], rays[rows, 6:7],
        u=None if u is None else u[rows], count_reduce=reduce)
    loss = _rank_share(ret, loss_weights, world)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    loss = loss.detach()
    if comm is not None:
        # the gradients and the loss in one flat bucket; a parameter
        # without a gradient (an empty field group) is skipped on every
        # rank alike, since every rank runs the same graph
        grads = [p.grad for g in optimizer.param_groups for p in g["params"]
                 if p.grad is not None]
        flat = comm.all_reduce_sum(torch.cat(
            [g.reshape(-1) for g in grads] + [loss.reshape(1)]))
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        loss = flat[-1]
    optimizer.step()
    return loss


def sharded_map_train_step(scene: SceneRepresentation, optimizer, group,
                           loss_weights):
    """step(rays [N, 7], rays_o [N, 3], rays_d [N, 3], u=None,
    generator=None) -> the whole batch's loss: one data-parallel map step.
    Every rank passes the whole batch (and the same parameters); rank r
    renders rows [r N/D, (r+1) N/D) of it and of the stratified draw u [N,
    S] (drawn for the whole batch from `generator`, seeded alike on every
    rank, when not given). Raises ValueError when N % D != 0. step.comm
    holds the collectives' traffic."""
    comm = collectives(group)

    def step(rays, rays_o, rays_d, u=None, generator=None):
        return _map_step(scene, optimizer, comm, loss_weights, rays, rays_o,
                         rays_d, u, generator)

    step.comm = comm
    return step


def gridsharded_map_train_step(scene: SceneRepresentation, optimizer, group,
                               loss_weights):
    """sharded_map_train_step of a scene whose explicit grid is the ranks'
    slabs (SceneRepresentation(..., grid_rows=SlabGrid(...).rows), fused by
    sharded_fuse_frame): no rank holds the grid whole. The step is
    step(rays, rays_o, rays_d, u=None, generator=None). Raises ValueError
    for a scene that holds its grid."""
    if scene.grid_rows is None:
        raise ValueError("the scene holds its grid whole: build it with "
                         "grid_rows=SlabGrid(...).rows")
    return sharded_map_train_step(scene, optimizer, group, loss_weights)
