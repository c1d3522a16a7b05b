"""Host costs of two numpy paths of the port, each beside the version it
replaced, on the machine it runs on (no card needed):

  python scripts/host_costs.py [--frames 0 50 99]

- PST tables: seconds to generate the candidate tables of
  configs/Synthetic/synthetic_corridor.yaml's RO.PST_size
  (tracking/pst.load_pst with its process-wide cache empty, as every
  pipeline paid before the cache) against a call that finds them cached.
- Rendering: host ms of one 640x480 frame of the corridor building
  (SyntheticLargeDataset.render, serial) with the box slab test on
  [_SLAB_ROWS, B] blocks one axis at a time (datasets/synthetic._slab_hits)
  against the [M, B, 3] broadcast it replaced; the two renders are held
  bitwise equal.

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


def slab_hits_broadcast(lo_o, hi_o, inv_d):
    """The slab test as the renderer had it: [M, B, 3] arrays."""
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, nargs="+", default=[0, 50, 99])
    args = ap.parse_args()
    cfg = load_config(CONFIG)
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
        "cpu_count": os.cpu_count()}))
    if not same:
        sys.exit("the two slab tests render different frames")


if __name__ == "__main__":
    main()
