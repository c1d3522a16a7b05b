"""How many torch ops the port's explicit-grid queries dispatch per call.

    python scripts/query_launches.py [--points 4096]

The online loop is host-bound (PERF.md section 5): each op that launches
a kernel costs host time whether or not the card is busy. This script
builds a scene of tests/helpers.tiny_config (the 48^3 grid holding seeded
random values), traces one call of each explicit-grid query with
torch.profiler on the CPU and counts the ops the call dispatches at its
top level: all of them, and those that are not views or metadata (the
ones that launch a kernel on the card). Queries: query_gbv (the float32
read), and, where the port has them, query_gbq through the bf16 mirror and
without it, and query_color_sdf with and without the mirror.

It counts the port of its own checkout; a copy of it run from another
checkout counts that one. CPU only; imports no JAX.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ops that only make a view or read metadata: no kernel on the card
VIEWS = {"aten::view", "aten::reshape", "aten::select", "aten::slice",
         "aten::unsqueeze", "aten::expand", "aten::as_strided",
         "aten::_unsafe_view", "aten::alias", "aten::detach",
         "aten::lift_fresh", "aten::t", "aten::transpose", "aten::squeeze",
         "aten::permute", "aten::numpy_T", "aten::split",
         "aten::unbind", "aten::chunk", "aten::narrow",
         "aten::result_type", "aten::resolve_conj", "aten::resolve_neg"}


def count_ops(fn):
    """(top-level aten ops, those of them that are not views) of one
    call of fn()."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up: lazy set-up is not the call's
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    top = [e.name for e in prof.events()
           if e.name.startswith("aten::")
           and (e.cpu_parent is None
                or not e.cpu_parent.name.startswith("aten::"))]
    return len(top), sum(1 for n in top if n not in VIEWS)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, default=4096)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    sys.path.insert(0, ROOT)

    import numpy as np
    import torch

    from helpers import tiny_config
    from remixfusion_tpu_torch.models.scene_rep import SceneRepresentation

    torch.set_num_threads(1)
    torch.set_grad_enabled(False)
    cfg = tiny_config()
    bound = np.asarray(cfg["mapping"]["bound"], np.float32)
    scene = SceneRepresentation(cfg, bound, 8)
    rng = np.random.default_rng(0)
    scene.gbv.copy_(torch.from_numpy(
        rng.uniform(-1, 1, tuple(scene.gbv.shape)).astype(np.float32)))
    pts = torch.from_numpy(rng.uniform(
        0, 1, (args.points, 3)).astype(np.float32))
    mirror = hasattr(scene, "refresh_gbq")
    print(f"port: {sys.modules[SceneRepresentation.__module__].__file__}")
    cases = [("query_gbv (float32 read)", lambda: scene.query_gbv(pts))]
    if mirror:
        cases.append(("query_gbq, no mirror", lambda: scene.query_gbq(pts)))
    cases.append(("query_color_sdf, no mirror",
                  lambda: scene.query_color_sdf(pts)))
    rows = [(name, *count_ops(fn)) for name, fn in cases]
    if mirror:
        scene.refresh_gbq()
        for name, fn in (("query_gbq, bf16 mirror",
                          lambda: scene.query_gbq(pts)),
                         ("query_color_sdf, bf16 mirror",
                          lambda: scene.query_color_sdf(pts))):
            rows.append((name, *count_ops(fn)))
    for name, n_all, n_launch in rows:
        print(f"{name}: {n_all} top-level ops, {n_launch} not views")


if __name__ == "__main__":
    main()
