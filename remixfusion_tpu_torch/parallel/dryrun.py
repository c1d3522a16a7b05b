"""A multi-rank run of the scale-out path (counterpart of the JAX package's
`__graft_entry__.dryrun_multichip`):

    python -m remixfusion_tpu_torch.parallel.dryrun --ranks N [--device cpu]

Every rank runs, in one process group: a data-parallel map step with Adam,
the slab-sharded fusion of a frame (with the slabs' bf16 query mirror), a
grid-sharded map step reading the fused slabs' mirror (from a scene that
holds no grid of its own), and
`interleaved_dataflow`: candidate-sharded tracking -> slab-sharded fusion
-> a data-parallel map round every second frame over FRAMES frames, all on
configs/Synthetic/verify_small.yaml (320x240). Rank 0 prints the losses, the
RO-only ATE, the times and the collective traffic.

The device is CUDA unless --device cpu. The backend is NCCL when every
rank has a card of its own, else gloo (NCCL refuses two ranks on one card);
the CPU runs on gloo. Nothing here is wired into a config or into
RemixFusionTorch.run: the JAX pipeline runs no sharded path either.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

from remixfusion_tpu_torch.core.pose import const_speed_np
from remixfusion_tpu_torch.datasets import get_dataset
from remixfusion_tpu_torch.models.scene_rep import SceneRepresentation
from remixfusion_tpu_torch.parallel.launch import collectives, spawn
from remixfusion_tpu_torch.parallel.sharding import (
    SlabGrid, gridsharded_map_train_step, sharded_fuse_frame,
    sharded_fuse_pack_gbq, sharded_map_train_step)
from remixfusion_tpu_torch.tools.eval_ate import evaluate_ate
from remixfusion_tpu_torch.tracking.rotracker import ROTracker
from remixfusion_tpu_torch.tracking.volume import MovingVolume

CONFIG = os.path.join("configs", "Synthetic", "verify_small.yaml")
FRAMES = 6
TIMEOUT_S = 900.0
NUM_KF = 8
SEED = 0


def pick_backend(device, world: int) -> tuple:
    """(backend, reason) for `world` ranks on `device`: NCCL when every rank
    has a card of its own, gloo otherwise."""
    if torch.device(device).type == "cpu":
        return "gloo", "CPU tensors (NCCL is CUDA-only)"
    cards = torch.cuda.device_count()
    if world <= cards:
        return "nccl", f"{world} rank(s) on {cards} card(s), one card each"
    return "gloo", (f"{world} ranks share {cards} card(s) and NCCL refuses "
                    f"two ranks on one card ('Duplicate GPU detected')")


def rank_device(device) -> torch.device:
    """This rank's device: the CPU, or the card launch.spawn set current."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def loss_weights(cfg) -> tuple:
    t = cfg["training"]
    return (t["rgb_weight"], t["depth_weight"], t["sdf_weight"],
            t["fs_weight"])


def frame_rays(frame, c2w, rng: np.random.Generator, n_rays: int):
    """n_rays uniform pixels of a dataset frame as the map step's rays [N,
    7] (direction, rgb, depth) with world rays_o / rays_d [N, 3] through
    pose c2w (float32 numpy)."""
    H, W = frame["depth"].shape
    idx = rng.integers(0, H * W, n_rays)
    dirs = np.asarray(frame["direction"]).reshape(-1, 3)[idx]
    rgb = np.asarray(frame["rgb"]).reshape(-1, 3)[idx]
    dep = np.asarray(frame["depth"]).reshape(-1)[idx]
    rays = np.concatenate([dirs, rgb, dep[:, None]], -1).astype(np.float32)
    c2w = np.asarray(c2w, np.float64)
    rays_d = (dirs @ c2w[:3, :3].T).astype(np.float32)
    rays_o = np.tile(c2w[:3, 3].astype(np.float32), (n_rays, 1))
    return rays, rays_o, rays_d


def interleaved_dataflow(group, cfg, n_frames: int, *, map_every: int,
                         n_rays: int, device):
    """The pipeline's interleave on a process group (or None for one
    process): the moving volume seeded with frame 0; every later frame
    tracked (candidate-sharded) from the constant-speed prediction, fused
    into the moving volume (every brick) and slab-sharded into the global
    grid; every map_every frames a data-parallel SGD step (lr 1e-2) on
    n_rays rays of the frame just fused, drawn from a numpy generator seeded
    (SEED) alike on every rank. The map step reads the scene's own replicated grid,
    as the JAX dataflow does. Returns the poses, the RO-only ATE (cm), the
    losses, the per-frame and per-step times (host clock, synchronized),
    the map steps' collective bytes, this rank's slab and the scene's
    parameters (numpy)."""
    comm = collectives(group)
    dev = torch.device(device)
    ds = get_dataset(cfg)
    H, W, K = ds.H, ds.W, ds.K()
    bound = np.asarray(cfg["mapping"]["bound"], np.float32)
    R = int(cfg["globalV"]["base_resolution"])
    gen = torch.Generator(device=dev).manual_seed(SEED)
    # the tracker's ray shift (RO.sample_range != 0) draws from its own
    # stream; the tracker gives it rank 0's state before each draw
    shift_gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    scene = SceneRepresentation(cfg, bound, NUM_KF, device=dev,
                                generator=gen)
    opt = torch.optim.SGD(scene.parameters(), lr=1e-2)
    step = sharded_map_train_step(scene, opt, comm, loss_weights(cfg))
    f0 = ds[0]
    pose0 = np.asarray(f0["c2w"], np.float32)
    mv = MovingVolume(cfg, pose0, dev)
    mv.integrate_seed(f0["rgb"], f0["depth"], K, pose0)
    tracker = ROTracker(cfg, H, W, K, mv.dims, mv.voxel_size,
                        mv.brick_layout(), dev, group=comm)
    fuse = sharded_fuse_frame(comm, R, cfg["training"]["c_trunc"], H, W)
    slab = SlabGrid(R, comm, dev)
    K_t = torch.as_tensor(K, dtype=torch.float32, device=dev)
    bound_t = torch.as_tensor(bound, device=dev)
    rng = np.random.default_rng(SEED)
    poses = [pose0.astype(np.float64)]
    losses, frame_ms, step_ms, step_bytes = [], [], [], []

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for i in range(1, n_frames):
        f = ds[i]
        sync()
        t0 = time.perf_counter()
        init = (poses[-1] if len(poses) < 2
                else const_speed_np(poses[-1], poses[-2]))
        mv.check_move(i, init.astype(np.float32))
        depth = torch.as_tensor(np.asarray(f["depth"], np.float32),
                                device=dev)
        rgb = torch.as_tensor(np.asarray(f["rgb"], np.float32), device=dev)
        res = tracker.do_tracking(mv.state, init.astype(np.float32), depth,
                                  generator=shift_gen)
        c2w = res.c2w.cpu().numpy().astype(np.float64)
        poses.append(c2w)
        mv.integrate_seed(f["rgb"], f["depth"], K, c2w.astype(np.float32))
        fuse(slab.gbv, slab.gbw, depth, rgb, K_t, res.c2w, bound_t)
        sync()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        if i % map_every == 0:
            rays, rays_o, rays_d = (torch.as_tensor(a, device=dev)
                                    for a in frame_rays(f, c2w, rng, n_rays))
            if comm is not None:
                comm.reset_traffic()
            t0 = time.perf_counter()
            losses.append(float(step(rays, rays_o, rays_d, generator=gen)))
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if comm is not None:
                step_bytes.append(dict(comm.bytes))
    poses = np.stack(poses)
    ro = evaluate_ate({float(i): np.asarray(ds.poses[i]) for i in
                       range(n_frames)},
                      {float(i): poses[i] for i in range(n_frames)})
    return {"poses": poses, "ate_rmse_cm_ro_only": ro["rmse"] * 100.0,
            "losses": losses, "frame_ms": frame_ms, "step_ms": step_ms,
            "step_bytes": step_bytes, "gbv": slab.gbv.cpu().numpy(),
            "gbw": slab.gbw.cpu().numpy(),
            "params": {k: v.detach().cpu().numpy()
                       for k, v in scene.named_parameters()}}


def _run_rank(rank, world, cfg, n_frames, device):
    """The dry run on one rank; returns rank 0's report lines."""
    comm = collectives(torch.distributed.group.WORLD)
    dev = rank_device(device)
    ds = get_dataset(cfg)
    H, W = ds.H, ds.W
    bound = np.asarray(cfg["mapping"]["bound"], np.float32)
    R = int(cfg["globalV"]["base_resolution"])
    lw = loss_weights(cfg)
    n = int(cfg["mapping"]["sample"]) // world * world
    f = ds[1]
    rays, rays_o, rays_d = (torch.as_tensor(a, device=dev) for a in
                            frame_rays(f, f["c2w"], np.random.default_rng(0),
                                       n))
    lines = []

    # data-parallel map step, Adam (replicated parameters, summed gradients)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    scene = SceneRepresentation(cfg, bound, NUM_KF, device=dev,
                                generator=gen)
    step = sharded_map_train_step(
        scene, torch.optim.Adam(scene.parameters(), lr=1e-3), comm, lw)
    loss = float(step(rays, rays_o, rays_d, generator=gen))
    if not np.isfinite(loss):
        raise RuntimeError(f"data-parallel map step: loss {loss}")
    lines.append(f"DP map step (Adam, {n} rays): loss {loss:.6f}, "
                 f"collective bytes {dict(step.comm.bytes)}")

    # slab-sharded fusion of frame 1, the slabs' bf16 query mirror
    # refreshed after it
    fuse = sharded_fuse_pack_gbq(comm, R, cfg["training"]["c_trunc"], H, W)
    slab = SlabGrid(R, comm, dev)
    K_t = torch.as_tensor(ds.K(), dtype=torch.float32, device=dev)
    bound_t = torch.as_tensor(bound, device=dev)
    fuse(slab, torch.as_tensor(f["depth"], device=dev),
         torch.as_tensor(f["rgb"], device=dev), K_t,
         torch.as_tensor(np.asarray(f["c2w"], np.float32), device=dev),
         bound_t)
    fused = comm.all_reduce_sum((slab.gbw > 0).sum().reshape(1))
    if int(fused) == 0:
        raise RuntimeError("sharded fusion updated no voxel")
    lines.append(f"sharded fusion: slabs {fuse.bounds} of R={R} on rank "
                 f"{rank}, {int(fused)} voxels fused over all slabs")

    # grid-sharded map step reading those slabs (through their mirror)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    gscene = SceneRepresentation(cfg, bound, NUM_KF, device=dev,
                                 generator=gen, grid_rows=slab.rows)
    gstep = gridsharded_map_train_step(
        gscene, torch.optim.Adam(gscene.parameters(), lr=1e-3), comm, lw)
    gloss = float(gstep(rays, rays_o, rays_d, generator=gen))
    if not np.isfinite(gloss):
        raise RuntimeError(f"grid-sharded map step: loss {gloss}")
    lines.append(f"grid-sharded map step: loss {gloss:.6f}, slab "
                 f"{tuple(slab.gbv.shape)} per rank, collective bytes "
                 f"{dict(gstep.comm.bytes)}")

    out = interleaved_dataflow(comm, cfg, n_frames, map_every=2, n_rays=n,
                               device=dev)
    lines.append(
        f"dataflow over {n_frames} frames: RO-only ATE "
        f"{out['ate_rmse_cm_ro_only']:.4f} cm, map losses {out['losses']}, "
        f"ms per frame {np.mean(out['frame_ms']):.1f}, ms per map step "
        f"{np.mean(out['step_ms']):.1f}, collective bytes per map step "
        f"{out['step_bytes'][-1] if out['step_bytes'] else {}}")
    return lines if rank == 0 else None


def main(argv=None) -> int:
    from remixfusion_tpu_torch import resolve_device
    from remixfusion_tpu_torch.config import load_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, required=True)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(CONFIG)
    backend, why = pick_backend(device, args.ranks)
    print(f"[dryrun] {args.ranks} rank(s) on {device.type}, backend "
          f"{backend}: {why}", flush=True)
    if device.type == "cuda":
        from remixfusion_tpu_torch.ops import build
        build.build_all()
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        res = spawn(_run_rank, args.ranks, backend=backend,
                    device=device.type, init_file=os.path.join(tmp, "rdv"),
                    timeout_s=TIMEOUT_S, args=(cfg, FRAMES, device.type))
    for line in res[0]:
        print(f"[dryrun] {line}", flush=True)
    print(f"[dryrun] ok in {time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
