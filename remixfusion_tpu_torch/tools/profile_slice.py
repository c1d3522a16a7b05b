#!/usr/bin/env python3
"""Where the time of the port's online loop goes, on one CUDA card.

    python3 -m remixfusion_tpu_torch.tools.profile_slice [--frames 30]
        [--profile 10] [--config configs/Synthetic/synthetic_bench.yaml]
        [--out build/profile]

Runs RemixFusionTorch (first-frame mapping, then tracking + local fusion
and the mapping rounds that fall due) over the first --frames frames and
traces the last --profile of them with torch.profiler. Prints and writes
(<out>/profile_slice.json) the wall time per frame, the host time of each
pipeline stage per frame (the slice.* spans of track_frame: harvest,
select, upload, track, fuse, lookahead) and per mapping round (the map.*
spans of mapping_round: integrate, map, ba, kfadd), the device's busy and
idle share of the traced window, kernel launches per frame and the kernels
that take the most device time. Then it traces the end of the run
(RemixFusionTorch.finalize) and prints the host time of its mesh.* spans
(query: the grid and vertex queries on the card; marching: host marching
tetrahedra; write: normals + PLY; cull: occlusion culling) and the
device's busy time there. Needs a card; exits non-zero without one.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def dev_time(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def on_card(e):
    """Kernels and copies, not host ops or span ranges."""
    return ("CUDA" in str(e.device_type) and not e.key.startswith(
        ("slice.", "map.", "mesh.", "aten::")))


def window_summary(prof, frames: int, rounds: int, wall_us: float) -> dict:
    """A traced window of `frames` loop frames (`rounds` mapping rounds,
    `wall_us` of host clock ending in a synchronise): wall and device busy
    time per frame, the device's idle share, kernel launches per frame, the
    host time of the slice.* spans per frame and of the map.* spans per
    round, hash_table_grad launches and the 15 kernels with the most
    device time (name, ms per frame, launches per frame)."""
    avgs = prof.key_averages()
    stages = {e.key: e.cpu_time_total / frames / 1e3 for e in avgs
              if e.key.startswith("slice.") and not on_card(e)
              and e.cpu_time_total > 0}
    round_stages = {e.key: e.cpu_time_total / max(rounds, 1) / 1e3
                    for e in avgs if e.key.startswith("map.")
                    and not on_card(e) and e.cpu_time_total > 0}
    kernels = sorted(((e.key[:120], dev_time(e) / frames / 1e3,
                       e.count / frames)
                      for e in avgs if on_card(e) and dev_time(e) > 0),
                     key=lambda k: -k[1])
    busy_us = sum(dev_time(e) for e in avgs if on_card(e))
    launches = sum(e.count for e in avgs
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC")) / frames
    return {
        "wall_ms_per_frame": wall_us / frames / 1e3,
        "device_busy_ms_per_frame": busy_us / frames / 1e3,
        "device_idle_share": 1.0 - busy_us / wall_us,
        "kernel_launches_per_frame": launches,
        "stage_host_ms_per_frame": stages,
        "mapping_rounds_in_window": rounds,
        "round_stage_host_ms_per_round": round_stages,
        "hash_table_grad_launches_in_window": sum(
            e.count for e in avgs
            if on_card(e) and "hash_table_grad_kernel" in e.key),
        "top_device_kernels_ms_per_frame": kernels[:15],
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=os.path.join(
        ROOT, "configs", "Synthetic", "synthetic_bench.yaml"))
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--profile", type=int, default=10)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile"))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_slice: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from remixfusion_tpu_torch.config import load_config
    from remixfusion_tpu_torch.slam import RemixFusionTorch

    cfg = load_config(args.config)
    cfg["data"]["output"] = os.path.join(ROOT, "build", "profile")
    slam = RemixFusionTorch(cfg, device="cuda")
    n = args.frames
    slam.preload(n + 1)
    first = n - args.profile
    slam.first_frame_mapping()
    for i in range(1, first):
        slam.step(i, n)
    torch.cuda.synchronize()
    rounds0 = len(slam.round_ms)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        for i in range(first, n):
            slam.step(i, n)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    frames = n - first
    rounds = len(slam.round_ms) - rounds0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof_end:
        t0 = time.perf_counter()
        slam.finalize(n, {})
        torch.cuda.synchronize()
        end_us = (time.perf_counter() - t0) * 1e6

    summary = {
        "device": torch.cuda.get_device_name(0),
        "config": os.path.relpath(args.config, ROOT),
        "profiled_frames": frames,
        **window_summary(prof, frames, rounds, wall_us),
        "end_of_run": {
            "wall_ms": end_us / 1e3,
            "mesh_stage_host_ms": {
                e.key: e.cpu_time_total / 1e3
                for e in prof_end.key_averages()
                if e.key.startswith("mesh.") and not on_card(e)
                and e.cpu_time_total > 0},
            "device_busy_ms": sum(dev_time(e) for e in
                                  prof_end.key_averages()
                                  if on_card(e)) / 1e3,
        },
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_slice.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
