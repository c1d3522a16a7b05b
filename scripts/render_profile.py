#!/usr/bin/env python3
"""Where the time of the port's render_frame goes on one CUDA card, and how
it depends on the chunk size.

    python3 scripts/render_profile.py [--frames 10]
        [--config configs/Synthetic/synthetic_bench.yaml]
        [--chunks 16384,32768,65536,131072] [--repeats 3]

Builds RemixFusionTorch on the card, runs first-frame mapping and the online
loop over --frames frames (so the scene holds a fitted field), then renders
the last of those frames at full size with its depth as the target:
  - at each chunk size in turns (forward order, then reversed, --repeats
    times), each render timed on the host clock ending in
    torch.cuda.synchronize();
  - once more at the pipeline's own chunk size under torch.profiler: the
    device's busy time and idle share, kernel launches and the kernels that
    take the most device time.
Prints one JSON line ({"render_profile": ...}) after the card's name and
power limit. Needs a card; exits non-zero without one.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=os.path.join(
        ROOT, "configs", "Synthetic", "synthetic_bench.yaml"))
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--chunks", default="16384,32768,65536,131072")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("render_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from torch.profiler import ProfilerActivity, profile

    from remixfusion_tpu_torch.config import load_config
    from remixfusion_tpu_torch.slam import RemixFusionTorch, pipeline

    cfg = load_config(args.config)
    cfg["data"]["output"] = os.path.join(ROOT, "build", "render_profile")
    slam = RemixFusionTorch(cfg, device="cuda")
    n = args.frames
    slam.preload(n + 1)
    slam.first_frame_mapping()
    for i in range(1, n):
        slam.step(i, n)
    slam._harvest()
    frame = n - 1
    batch = slam.dataset[frame]
    pose = slam.trajectory(n)[frame]

    def render():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slam.render_frame(pose, batch["direction"],
                          target_depth=batch["depth"])
        torch.cuda.synchronize()
        return 1000.0 * (time.perf_counter() - t0)

    chunks = [int(c) for c in args.chunks.split(",")]
    own = pipeline._RENDER_CHUNK
    times = {c: [] for c in chunks}
    try:
        for r in range(args.repeats):
            for c in (chunks if r % 2 == 0 else chunks[::-1]):
                pipeline._RENDER_CHUNK = c
                render()  # warm-up at this chunk's shapes
                times[c].append(render())
    finally:
        pipeline._RENDER_CHUNK = own

    render()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms = render()

    def dev_time(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    def on_card(e):  # kernels and copies, not host ops or span ranges
        return ("CUDA" in str(e.device_type)
                and not e.key.startswith(("render.", "aten::")))

    avgs = prof.key_averages()
    kernels = sorted(((e.key[:100], dev_time(e) / 1e3, e.count)
                      for e in avgs if on_card(e) and dev_time(e) > 0),
                     key=lambda k: -k[1])
    busy_ms = sum(dev_time(e) for e in avgs if on_card(e)) / 1e3
    launches = sum(e.count for e in avgs
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC"))
    peak = torch.cuda.max_memory_allocated()
    H, W = batch["depth"].shape
    S = slam.scene.z_vals_shape(1)[1]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    print(json.dumps({"render_profile": {
        "device": torch.cuda.get_device_name(0),
        "config": os.path.relpath(args.config, ROOT),
        "frame": frame, "rays": H * W, "samples_per_ray": S,
        "points": H * W * S, "pipeline_chunk": own,
        "render_ms_by_chunk": {c: {"median": float(np.median(v)),
                                   "runs": v} for c, v in times.items()},
        "profiled": {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                     "device_idle_share": 1.0 - busy_ms / wall_ms,
                     "kernel_launches": launches,
                     "max_memory_allocated": peak,
                     "top_device_kernels_ms": kernels[:15]},
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
