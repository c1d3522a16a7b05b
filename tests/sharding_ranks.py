"""The rank side of tests/test_torch_sharding.py: one function that runs
every case of that file on one rank of a gloo world on the CPU and returns
numpy results. launch.spawn re-imports this module in every rank, so it
imports numpy, torch and the port only (never JAX nor the JAX package)."""

import os
import sys
import time

import numpy as np
import torch

from remixfusion_tpu_torch.datasets import get_dataset
from remixfusion_tpu_torch.models.scene_rep import SceneRepresentation
from remixfusion_tpu_torch.ops import brick_eval as be
from remixfusion_tpu_torch.parallel import dryrun
from remixfusion_tpu_torch.parallel.launch import Collectives, make_group
from remixfusion_tpu_torch.parallel.sharding import (
    SlabGrid, gridsharded_map_train_step, sharded_fuse_frame,
    sharded_map_train_step)
from remixfusion_tpu_torch.tracking.rotracker import ROTracker
from remixfusion_tpu_torch.tracking.volume import MovingVolume
from remixfusion_tpu_torch.utils.convert import (scene_from_numpy,
                                                 scene_to_numpy,
                                                 volume_state_from_numpy)

NUM_KF = 8
MODES = ("pallas", "gather", "brick")
# the tier costs are taken at this multiple of the initial search size,
# where the low-count guard (against the identity candidate's count)
# rejects some candidates of every tier
GUARD_SEARCH = 5.0
# the ray-shift generator's seed on rank 0 (rank r seeds SHIFT_SEED + r)
SHIFT_SEED = 100
# how long the last rank of fail_late_on_last holds its report back: past
# the 5 s that spawn once waited on the queue before it read a dead rank
# process as the failure
RACE_DELAY_S = 7.0


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _dp_step(inp, comm, rays=None):
    """One SGD (lr 1e-2) data-parallel step from the JAX parameters on the
    shared rays and draw; (loss, the parameters after it)."""
    scene = scene_from_numpy(inp["cfg"], inp["bound"], NUM_KF, inp["params"],
                             inp["buffers"])
    step = sharded_map_train_step(
        scene, torch.optim.SGD(scene.parameters(), lr=1e-2), comm,
        inp["lw"])
    rays = inp["rays"] if rays is None else rays
    loss = step(t(rays), t(inp["rays_o"][:len(rays)]),
                t(inp["rays_d"][:len(rays)]), u=t(inp["u"][:len(rays)]))
    return float(loss), scene_to_numpy(scene)[0]


def _tracking(inp, mode, comm):
    """(pose after do_tracking, the gathered costs of the three tiers at the
    initial pose and GUARD_SEARCH times the initial search size) of the
    candidate-sharded tracker in `mode`."""
    cfg = inp["track_cfg"][mode]
    vol = inp["volume"]
    state = volume_state_from_numpy(vol["tsdf"], vol["weight"], vol["color"],
                                    vol["origin"], "cpu")
    tr = ROTracker(cfg, inp["H"], inp["W"], inp["K"], vol["dims"],
                   vol["voxel_size"], vol["layout"], "cpu", group=comm)
    c2w, depth = t(inp["track_c2w"]), t(inp["track_depth"])
    res = tr.do_tracking(state, c2w, depth)
    vn = tr.vertex_normal_maps(depth)
    view = tr.track_view(state.tsdf)
    ss = tr.init_search_size() * GUARD_SEARCH
    costs = [tr.score_tier(cls, 0, tr.class_level[cls], 0, c2w[:3, :3],
                           c2w[:3, 3], ss, vn, view, state.origin).numpy()
             for cls in range(3)]
    return res.c2w.numpy(), costs


def shifted_pose(inp, comm, seed):
    """The pose do_tracking gives with RO.sample_range != 0 (shift_cfg), the
    ray shift drawn from a generator seeded `seed`."""
    vol = inp["volume"]
    state = volume_state_from_numpy(vol["tsdf"], vol["weight"], vol["color"],
                                    vol["origin"], "cpu")
    tr = ROTracker(inp["shift_cfg"], inp["H"], inp["W"], inp["K"],
                   vol["dims"], vol["voxel_size"], vol["layout"], "cpu",
                   group=comm)
    gen = torch.Generator().manual_seed(seed)
    return tr.do_tracking(state, t(inp["track_c2w"]), t(inp["track_depth"]),
                          generator=gen).c2w.numpy()


def run_cases(rank, world, inp):
    comm = Collectives(make_group())
    # every rank makes every singleton group, in the same order
    solo = Collectives([make_group([r]) for r in range(world)][rank])
    cfg, R = inp["cfg"], inp["R"]
    out = {"jax_modules": sorted(m for m in sys.modules
                                 if m.split(".")[0] in ("jax", "jaxlib",
                                                        "remixfusion_tpu"))}

    out["dp"] = _dp_step(inp, comm)
    out["dp_solo"] = _dp_step(inp, solo)
    out["dp_none"] = _dp_step(inp, None)
    try:
        _dp_step(inp, comm, rays=inp["rays"][:-1])
        out["n_error"] = None
    except ValueError as e:
        out["n_error"] = str(e)

    ds = get_dataset(cfg)
    fuse = sharded_fuse_frame(comm, R, cfg["training"]["c_trunc"], ds.H,
                              ds.W)
    slab = SlabGrid(R, comm, "cpu")
    for i in inp["fuse_frames"]:
        f = ds[i]
        fuse(slab.gbv, slab.gbw, t(f["depth"]), t(f["rgb"]), t(ds.K()),
             t(f["c2w"]), t(inp["bound"]))
    out["fuse"] = (fuse.bounds, slab.gbv.numpy().copy(),
                   slab.gbw.numpy().copy())

    for mode in MODES:
        out[f"track_{mode}"] = _tracking(inp, mode, comm)
        out[f"track_{mode}_solo"] = _tracking(inp, mode, solo)
        out[f"track_{mode}_none"] = _tracking(inp, mode, None)
    # every rank's generator seeded otherwise: the tracker gives them rank
    # 0's state before the draw
    out["shift"] = shifted_pose(inp, comm, SHIFT_SEED + rank)
    try:
        odd = dict(inp["track_cfg"]["gather"])
        odd["RO"] = dict(odd["RO"], PST_size=inp["odd_pst"])
        vol = inp["volume"]
        ROTracker(odd, inp["H"], inp["W"], inp["K"], vol["dims"],
                  vol["voxel_size"], vol["layout"], "cpu", group=comm)
        out["c_error"] = None
    except ValueError as e:
        out["c_error"] = str(e)

    # the grid-sharded step on the fused slabs, from a scene without a grid
    ref = scene_from_numpy(cfg, inp["bound"], NUM_KF, inp["params"],
                           inp["buffers"])
    gscene = SceneRepresentation(cfg, inp["bound"], NUM_KF,
                                 grid_rows=slab.rows)
    with torch.no_grad():
        for p, q in zip(gscene.parameters(), ref.parameters()):
            p.copy_(q)
    del ref
    pts = t(inp["query_pts"])
    m = pts.shape[0] // world
    out["query"] = gscene.query_gbv(pts[rank * m:(rank + 1) * m]).numpy()
    step = gridsharded_map_train_step(
        gscene, torch.optim.SGD(gscene.parameters(), lr=1e-2), comm,
        inp["lw"])
    loss = step(t(inp["rays"]), t(inp["rays_o"]), t(inp["rays_d"]),
                u=t(inp["u"]))
    out["grid"] = (float(loss), scene_to_numpy(gscene)[0],
                   gscene.gbv is None)

    out["dataflow"] = dryrun.interleaved_dataflow(
        comm, inp["flow_cfg"], inp["flow_frames"], map_every=2, n_rays=128,
        device="cpu")
    return out


def tier_costs(cfg, comm, device):
    """The costs [C] of the three tiers of frame 1 (depth and pose) against
    the moving volume seeded with frame 0, scored by the tracker of `comm`
    (None: one process) on `device`, and the kernel launches they took."""
    ds = get_dataset(cfg)
    f0, f1 = ds[0], ds[1]
    mv = MovingVolume(cfg, np.asarray(f0["c2w"], np.float32), device)
    mv.integrate_seed(f0["rgb"], f0["depth"], ds.K(),
                      np.asarray(f0["c2w"], np.float32))
    tr = ROTracker(cfg, ds.H, ds.W, ds.K(), mv.dims, mv.voxel_size,
                   mv.brick_layout(), device, group=comm)
    c2w = t(f1["c2w"]).to(device)
    vn = tr.vertex_normal_maps(t(f1["depth"]).to(device))
    view = tr.track_view(mv.state.tsdf)
    be.brick_eval_volume.launches = 0
    costs = [tr.score_tier(cls, 0, tr.class_level[cls], 0, c2w[:3, :3],
                           c2w[:3, 3], tr.init_search_size(), vn, view,
                           mv.state.origin).cpu().numpy()
             for cls in range(3)]
    return costs, be.brick_eval_volume.launches


def tier_costs_rank(rank, world, cfg):
    """tier_costs on this rank's card, candidate-sharded over the world."""
    dev = torch.device("cuda", torch.cuda.current_device())
    return tier_costs(cfg, Collectives(make_group()), dev)


def tensor_of_rank(rank, world):
    """A CPU tensor as the rank's result (it must arrive by value)."""
    return torch.full((1000,), float(rank))


def fail_on_last(rank, world):
    """Raises on the last rank; the others wait in a barrier."""
    if rank == world - 1:
        raise ValueError(f"rank {rank} stops here")
    torch.distributed.barrier()


def fail_late_on_last(rank, world, flag):
    """The last rank raises and reports RACE_DELAY_S late; the others exit
    hard as soon as it has raised (the `flag` file), long before its report
    can reach the caller: the order in which a rank that dies of another
    rank's failure can be seen first."""
    if rank == world - 1:
        try:
            raise ValueError(f"rank {rank} stops here")
        finally:
            open(flag, "w").close()
            time.sleep(RACE_DELAY_S)
    while not os.path.exists(flag):
        time.sleep(0.01)
    os._exit(1)
