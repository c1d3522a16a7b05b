"""Host costs of numpy paths of the port, each beside the version it
replaced, on the machine it runs on (no card needed):

  python scripts/host_costs.py [--frames 0 50 99] [--pool 48]

- PST tables: seconds to generate the candidate tables of
  configs/Synthetic/synthetic_corridor.yaml's RO.PST_size
  (tracking/pst.load_pst with its process-wide cache empty, as every
  pipeline paid before the cache) against a call that finds them cached.
- Rendering: host ms of one 640x480 frame of the corridor building
  (SyntheticLargeDataset.render, serial) against the same render with the
  box slab test on [M, B, 3] arrays over every box (the broadcast the
  blocked, culled _slab_hits replaced); the renders are held bitwise
  equal.
- The render pool: --pool frames of the walk (from frame 400) rendered by
  SyntheticLargeDataset.render_missing (datasets/synthetic._RENDER_WORKERS
  workers) into an empty temporary cache, as a run's preload renders
  them: seconds per frame.

Prints one JSON line.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from remixfusion_tpu_torch.config import load_config  # noqa: E402
from remixfusion_tpu_torch.datasets import synthetic  # noqa: E402
from remixfusion_tpu_torch.datasets.factory import get_dataset  # noqa: E402
from remixfusion_tpu_torch.tracking import pst  # noqa: E402

CONFIG = os.path.join(ROOT, "configs", "Synthetic", "synthetic_corridor.yaml")


def slab_hits_broadcast(lo_o, hi_o, inv_d, slopes=None, box_slopes=None):
    """The slab test as the renderer had it: [M, B, 3] arrays, every box
    (the culling arguments ignored)."""
    t0 = lo_o[None, :, :] * inv_d[:, None, :]
    t1b = hi_o[None, :, :] * inv_d[:, None, :]
    tmin = np.minimum(t0, t1b).max(axis=2)
    tmax = np.maximum(t0, t1b).min(axis=2)
    hit = (tmax > tmin) & (tmin > 1e-6)
    return np.min(np.where(hit, tmin, np.inf), axis=1)


def render_ms(ds, frames, slab_fn):
    synthetic._slab_hits = slab_fn
    out, ms = [], []
    for i in frames:
        t0 = time.perf_counter()
        out.append(ds.render(ds.poses[i]))
        ms.append(1000.0 * (time.perf_counter() - t0))
    return out, ms


def render_pool(cfg, n):
    """Seconds per frame of render_missing over n frames of the walk from
    frame 400, into an empty temporary cache."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        tempfile.tempdir = tmp
        try:
            ds = get_dataset(cfg)
            t0 = time.perf_counter()
            done = ds.render_missing(range(400, 400 + n))
            s = (time.perf_counter() - t0) / n
        finally:
            tempfile.tempdir = None
    if done != n:
        sys.exit(f"rendered {done} of {n} frames")
    return s


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, nargs="+", default=[0, 50, 99])
    ap.add_argument("--pool", type=int, default=0,
                    help="frames rendered by render_missing (0: none)")
    args = ap.parse_args()
    cfg = load_config(CONFIG)
    pool = ({"frames": args.pool, "workers": synthetic._RENDER_WORKERS,
             "s_per_frame": render_pool(cfg, args.pool)}
            if args.pool else None)
    sizes = list(cfg["RO"]["PST_size"])

    pst._GENERATED.clear()
    t0 = time.perf_counter()
    pst.load_pst("", sizes)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pst.load_pst("", sizes)
    hit_s = time.perf_counter() - t0

    ds = get_dataset(cfg)
    ds.get_direction()
    blocked = synthetic._slab_hits
    new, new_ms = render_ms(ds, args.frames, blocked)
    old, old_ms = render_ms(ds, args.frames, slab_hits_broadcast)
    new2, new2_ms = render_ms(ds, args.frames, blocked)
    synthetic._slab_hits = blocked
    same = all(np.array_equal(a, b) for fa, fb in zip(new, old)
               for a, b in zip(fa, fb))
    same = same and all(np.array_equal(a, b) for fa, fb in zip(new, new2)
                        for a, b in zip(fa, fb))
    print(json.dumps({
        "pst_sizes": sizes,
        "pst_generate_s": gen_s,
        "pst_cached_s": hit_s,
        "render": {"frames": args.frames,
                   "size": [int(ds.H), int(ds.W)],
                   "boxes": len(ds.boxes),
                   "blocked_ms": new_ms, "broadcast_ms": old_ms,
                   "blocked_again_ms": new2_ms,
                   "bitwise_equal": bool(same)},
        "render_pool": pool,
        "cpu_count": os.cpu_count()}))
    if not same:
        sys.exit("the two slab tests render different frames")


if __name__ == "__main__":
    main()
