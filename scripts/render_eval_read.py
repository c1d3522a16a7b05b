"""Score one checkpoint's renders through the bf16 query mirror and through
the float32 grid, in one process; optionally train it first.

    python scripts/render_eval_read.py --config <yaml> [--out DIR] \
        [--seed N] [--train] [--gap 5] [--device cuda|cpu]

rendering_eval_torch.py scores a checkpoint as the pipeline reloads it:
the hot query reads the grid's bf16 query mirror, rebuilt on load. This
script loads the checkpoint the same way and scores the same frames
(tools/rendering_eval.calc_2d_metric at the run's all_poses.npy, every
--gap-th frame) through the mirror and with the mirror dropped, so that
the hot query reads the float32 grid. The difference is what the read
alone is worth on a fixed model; a difference between two runs'
checkpoints also holds what the training read changed.

--out sets the config's data.output and --seed its seed; --train first
runs the SLAM on that config (the run writes checkpoint.npz and
all_poses.npy). The script imports the port of its own checkout; a copy
run from another checkout trains and scores with that one, whose scene may
hold no mirror (then only the float32 read is scored).

The reads are timed in the order mirror, float32, float32, mirror after
one untimed warm-up pass, so that neither read's times carry the first
pass's set-up. Every pass renders with the perturbation draws of the
loaded pipeline's first render. Prints one JSON line
{"render_eval_read": {"train": {...} or null, "mirror": {...} or null,
"float32": {...} (each read's first pass), "render_ms": [[read, mean ms
per frame, psnr], ...] (every timed pass), "device": ..., "seed": ...}}.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--out", default=None, help="the config's data.output")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--train", action="store_true",
                    help="run the SLAM first, writing the checkpoint")
    ap.add_argument("--gap", type=int, default=5)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)

    import numpy as np

    from remixfusion_tpu_torch.config import load_config
    from remixfusion_tpu_torch.slam import RemixFusionTorch
    from remixfusion_tpu_torch.tools.rendering_eval import calc_2d_metric

    cfg = load_config(args.config)
    if args.out is not None:
        cfg["data"]["output"] = os.path.abspath(args.out)
    if args.seed is not None:
        cfg["seed"] = args.seed
    train = None
    if args.train:
        slam = RemixFusionTorch(cfg, device=args.device)
        out = slam.run()
        train = {k: out[k] for k in ("ate_rmse_cm", "ate_rmse_cm_ro_only",
                                     "ms_per_frame", "ms_per_round")}
        del slam
    slam = RemixFusionTorch(cfg, device=args.device)
    slam.load_ckpt(os.path.join(slam.out_dir, "checkpoint.npz"))
    poses = np.load(os.path.join(slam.out_dir, "all_poses.npy"))
    has_mirror = hasattr(slam.scene, "refresh_gbq")
    reads = ["mirror", "float32"] if has_mirror else ["float32"]

    # every pass draws the perturbations that a fresh load's first render
    # draws (rendering_eval_torch.py's), so that passes differ by the read
    draws = slam._gen.get_state()

    def set_read(read):
        slam._gen.set_state(draws)
        if read == "mirror":
            slam.scene.refresh_gbq()
        elif has_mirror:
            slam.scene.gbq = None

    set_read(reads[0])
    calc_2d_metric(slam, poses, gap=args.gap)  # warm-up, untimed
    out = {"train": train, "mirror": None, "render_ms": [],
           "device": str(slam.device), "seed": cfg.get("seed")}
    for read in reads + reads[::-1]:
        set_read(read)
        res = calc_2d_metric(slam, poses, gap=args.gap)
        if out.get(read) is None:
            out[read] = {k: v for k, v in res.items() if k != "render_ms"}
        out["render_ms"].append([read, float(np.mean(res["render_ms"])),
                                 res["psnr"]])
    print(json.dumps({"render_eval_read": out}))


if __name__ == "__main__":
    main()
