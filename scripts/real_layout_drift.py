"""How the ScanNet settings drift on a synthetic-room layout, and whether
the JAX package drifts alike.

Two modes, both on layouts written by remixfusion_tpu_torch/tools/
write_layout.py from the synthetic room (the `largeindoor` layout: the
ScanNet directory structure with PNG colour), with the settings of
configs/ScanNet/scene0000.yaml and mapping.bound = marching_cubes_bound =
the room:

  python scripts/real_layout_drift.py card [VARIANT ...]
      On a CUDA card, the port's whole run (RemixFusionTorch.run) of 40
      frames per variant, each one setting changed from the config (see
      VARIANTS); prints one JSON line per variant: full and RO-only ATE,
      ms/frame and the RO pose's translation error at every frame (cm).

  python scripts/real_layout_drift.py cpu [--frames 24] [--scale 0.5]
        [--fx400]
      On the CPU, tracking alone (frame by frame, harvest depth 1) of both
      packages on one layout at `scale` of the camera's size (so it fits
      a CPU); prints each package's RO-only ATE and per-frame error. JAX
      is the reference; the two draw their own per-pixel ray shifts, so
      their errors agree in size, not frame by frame.
"""

import argparse
import copy
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402

CONFIG = os.path.join(ROOT, "configs", "ScanNet", "scene0000.yaml")
FX400 = {"cam.fx": 400.0, "cam.fy": 400.0, "cam.cx": 319.5,
         "cam.cy": 239.5}
VARIANTS = {
    "base": {},
    "trilinear": {"RO.tsdf_interp": "trilinear"},
    "sr0": {"RO.sample_range": 0.0},
    "sr0.1": {"RO.sample_range": 0.1},
    "vox2cm": {"volume.voxel_size": 0.02},
    "tum_ro": {"RO.init_size": 0.01, "RO.scaling_coefficient": 0.09},
    "trunc08": {"volume.trunc": 0.08},
    "cut8": {"RO.cut_dist": 8.0},
    "edge0": {"cam.crop_edge": 0},
    "fx400_edge10": dict(FX400),
    "cam_syn": {**FX400, "cam.crop_edge": 0},
    # the overrides of scripts/smoke_real_layout.py's scannet run
    "jax_smoke": {**FX400, "cam.crop_edge": 0, "volume.voxel_size": 0.02,
                  "len": 3},
    "slow": {"orbit": 0.6},
}


def variant_config(name):
    from remixfusion_tpu_torch.config import load_config
    from remixfusion_tpu_torch.tools.write_layout import ROOM

    cfg = load_config(CONFIG)
    cfg["dataset"] = "largeindoor"
    cfg["mapping"]["bound"] = [list(b) for b in ROOM]
    cfg["mapping"]["marching_cubes_bound"] = [list(b) for b in ROOM]
    v = VARIANTS[name]
    for key, val in v.items():
        if "." in key:
            sec, k = key.split(".")
            cfg[sec][k] = val
    if "len" in v:
        for ax in ("x_config", "y_config", "z_config"):
            cfg["volume"][ax]["len"] = v["len"]
    return cfg, v.get("orbit", 1.2)


def card(names):
    import torch

    from remixfusion_tpu_torch.ops import build
    from remixfusion_tpu_torch.slam import RemixFusionTorch
    from remixfusion_tpu_torch.tools.write_layout import write_layout

    if not torch.cuda.is_available():
        raise SystemExit("card mode needs a CUDA device")
    build.build_all()
    n = 40
    for name in names or list(VARIANTS):
        cfg, degrees = variant_config(name)
        out = os.path.join(ROOT, "build", "drift", name)
        cfg["data"]["datadir"] = out + "_layout"
        cfg["data"]["output"] = out
        t0 = time.time()
        write_layout(cfg, "largeindoor", cfg["data"]["datadir"], n,
                     (968, 1296), degrees_per_frame=degrees)
        slam = RemixFusionTorch(cfg, device="cuda")
        stats = slam.run()
        err = np.abs(slam.RO_c2w_data[:n, :3, 3]
                     - slam.pose_gt[:n, :3, 3]).max(1) * 100
        print(json.dumps({
            "variant": name, "ate": stats["ate_rmse_cm"],
            "ate_ro": stats["ate_rmse_cm_ro_only"],
            "ms_per_frame": stats["ms_per_frame"],
            "wall_s": time.time() - t0,
            "err_cm": [round(float(e), 2) for e in err]}), flush=True)
        del slam
        torch.cuda.empty_cache()


def cpu(n, scale, fx400):
    import conftest  # noqa: F401  (JAX on the CPU)
    import torch

    from remixfusion_tpu.slam import RemixFusionTPU
    from remixfusion_tpu.tools.eval_ate import evaluate_ate
    from remixfusion_tpu_torch.slam import RemixFusionTorch
    from remixfusion_tpu_torch.tools.write_layout import write_layout

    torch.set_num_threads(4)
    cfg, _ = variant_config("base")
    c = cfg["cam"]
    if fx400:
        c.update(fx=400.0, fy=400.0, cx=319.5, cy=239.5, crop_edge=0)
    for k in ("fx", "fy", "cx", "cy"):
        c[k] *= scale
    c["H"], c["W"] = int(480 * scale), int(640 * scale)
    c["crop_edge"] = int(c["crop_edge"] * scale)
    cfg["tracking"]["harvest_depth"] = 1
    tag = f"{scale}_{n}_{'fx400' if fx400 else 'own'}"
    cfg["data"]["datadir"] = os.path.join(ROOT, "build", "drift",
                                          f"cpu_{tag}")
    cfg["data"]["output"] = os.path.join(ROOT, "build", "drift", "cpu_out")
    write_layout(cfg, "largeindoor", cfg["data"]["datadir"], n)

    j = RemixFusionTPU(copy.deepcopy(cfg))
    p0 = j._first_pose(j.dataset[0])
    j.est_c2w_data[0] = p0
    j.RO_c2w_data[0] = p0
    for i in range(1, n):
        j.track_frame(i, j.dataset[i])
    j._harvest_pending_track()
    j.close()
    t = RemixFusionTorch(copy.deepcopy(cfg), device="cpu")
    for i in range(1, n):
        t.track_frame(i, t._get_frame(i))
    t._harvest()
    gt = j.pose_gt
    for name, poses in (("jax", j.RO_c2w_data), ("port", t.RO_c2w_data)):
        ate = evaluate_ate({float(i): gt[i] for i in range(n)},
                           {float(i): poses[i] for i in range(n)})
        err = np.abs(poses[:, :3, 3] - gt[:, :3, 3]).max(1) * 100
        print(json.dumps({"package": name, "camera": tag,
                          "ate_ro": 100 * ate["rmse"],
                          "err_cm": [round(float(e), 2) for e in err]}),
              flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    c = sub.add_parser("card")
    c.add_argument("variants", nargs="*", help=f"of {sorted(VARIANTS)}")
    p = sub.add_parser("cpu")
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--scale", type=float, default=0.5)
    p.add_argument("--fx400", action="store_true")
    args = ap.parse_args()
    if args.mode == "card":
        unknown = set(args.variants) - set(VARIANTS)
        if unknown:
            ap.error(f"unknown variants {sorted(unknown)}")
        card(args.variants)
    else:
        cpu(args.frames, args.scale, args.fx400)


if __name__ == "__main__":
    main()
