#!/usr/bin/env python3
"""Time the port's two CUDA kernels against an older revision of their
sources, in turns, on one CUDA card (sm_90a).

    mkdir -p build/old_src
    git show afe2fdc:remixfusion_tpu_torch/csrc/brick_eval.cu \\
        > build/old_src/brick_eval.cu
    git show afe2fdc:remixfusion_tpu_torch/csrc/hash_enc.cu \\
        > build/old_src/hash_enc.cu
    python3 scripts/kernel_baseline.py --src build/old_src [--frames 10]

The older sources are built with the port's nvcc flags into
build/baseline/ and called through `Old`, an adapter for the C interface
of the sources at commit afe2fdc: brick_eval on a [P, 64] window tensor
(the tracker's gather done outside the kernel, as that revision's tracker
did it), with that revision's launch shape, two allocations and two kernels
per call; hash_table_grad with one thread per (point, level).

The inputs are the main path's, made the way chip_smoke.py makes them:
the tier inputs of slice A's last frame (three tiers, both lookups) and
the points and output gradients of slice B's last map step (render and
smoothness backward), each slice cut to --frames frames. For every kernel
and shape the old and the current kernel are measured in turns old, new,
new, old, each with chip_smoke.py's device_ms (a CUDA graph of the calls,
replayed) and call_ms (a host loop of wrapper calls); each side reports the
mean of its two turns and both turns. The old kernel's output is held to
the current one's first (guard positions for brick_eval, the 1e-5 relative
tolerance for hash_table_grad). Prints one JSON line; exits non-zero on any
failure or without a CUDA card.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def build_old(src_dir):
    """Build <src_dir>/{brick_eval,hash_enc}.cu (one nvcc each, started
    together) into build/baseline/; returns {name: ctypes.CDLL}."""
    from remixfusion_tpu_torch.ops import build

    out = os.path.join(ROOT, "build", "baseline")
    os.makedirs(out, exist_ok=True)
    jobs = {}
    for name in ("brick_eval", "hash_enc"):
        lib = os.path.join(out, f"lib{name}.so")
        jobs[name] = lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", lib,
             os.path.join(src_dir, name + ".cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    libs = {}
    for name, (lib, proc) in jobs.items():
        text = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            cs.fail(f"nvcc failed for the old {name}.cu:\n{text}")
        libs[name] = ctypes.CDLL(lib)
    return libs


class Old:
    """The C interface of the kernel sources at commit afe2fdc."""

    def __init__(self, libs):
        vp, i = ctypes.c_void_p, ctypes.c_int
        self.be = libs["brick_eval"].brick_eval_launch
        self.be.argtypes = [vp, vp, i, vp, i, vp, vp, vp, i, i, i, i, i, vp]
        self.be.restype = i
        self.he = libs["hash_enc"].hash_table_grad_launch
        self.he.argtypes = [vp, vp, vp, vp, vp, i, i, vp]
        self.he.restype = i

    def brick_eval(self, torch, params, pix, bricks, table, interp):
        dev = pix.device
        n_pix, n_cand = pix.shape[0], table.shape[1]
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        cblocks = -(-n_cand // 128)
        tiles = max(1, -(-n_pix // 64))
        want = max(1, min(tiles, -(-2 * n_sm // cblocks)))
        per = -(-tiles // want) * 64
        splits = max(1, -(-n_pix // per))
        partial = torch.empty((splits, 2, n_cand), dtype=torch.float32,
                              device=dev)
        out = torch.empty((n_cand,), dtype=torch.float32, device=dev)
        rc = self.be(params.data_ptr(), pix.data_ptr(), pix.stride(0),
                     bricks.data_ptr(), bricks.stride(0), table.data_ptr(),
                     partial.data_ptr(), out.data_ptr(), n_cand, n_pix,
                     splits, per, int(interp == "trilinear"),
                     torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            cs.fail(f"old brick_eval launch failed: CUDA error {rc}")
        return out

    def hash_table_grad(self, torch, enc, x, g, n_rows):
        from remixfusion_tpu_torch.ops import hash_enc as he

        lv = he.level_tensors(enc, x.device)
        dtable = torch.zeros((n_rows, 2), dtype=torch.float32,
                             device=x.device)
        rc = self.he(x.data_ptr(), g.data_ptr(), dtable.data_ptr(),
                     lv["scales"].data_ptr(), lv["kernel"].data_ptr(),
                     x.shape[0], enc.n_levels,
                     torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            cs.fail(f"old hash_table_grad launch failed: CUDA error {rc}")
        return dtable


def turns(torch, new_fn, old_fn, n, warmup):
    """{"new": ..., "old": ...}: measured old, new, new, old; each side the
    mean of its two turns, with both turns."""
    runs = [cs.measure(torch, f, n, warmup)
            for f in (old_fn, new_fn, new_fn, old_fn)]

    def side(a, b):
        return {"device_ms": (a["device_ms"] + b["device_ms"]) / 2,
                "call_ms": (a["call_ms"] + b["call_ms"]) / 2,
                "turns_device_ms": [a["device_ms"], b["device_ms"]],
                "turns_call_ms": [a["call_ms"], b["call_ms"]]}

    return {"new": side(runs[1], runs[2]), "old": side(runs[0], runs[3])}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True, help="directory with the old "
                    "brick_eval.cu and hash_enc.cu")
    ap.add_argument("--frames", type=int, default=10,
                    help="frames of each slice (at least 6: one mapping "
                    "round)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_baseline: no CUDA device available", file=sys.stderr)
        return 2
    from remixfusion_tpu_torch.ops import brick_eval as be
    from remixfusion_tpu_torch.ops import hash_enc as he

    cs.N_FRAMES = args.frames
    cs.phase_build()
    t0 = time.time()
    old = Old(build_old(os.path.abspath(args.src)))
    print(f"[old] built in {time.time() - t0:.1f} s", flush=True)
    rows = []
    slam, out, _ = cs.phase_slice(torch, "A")
    for args_v in cs.tier_cases(torch, slam, out["frames"]):
        params, pix, base, tsdf, layout, table = args_v
        windows = be.fetch_windows(tsdf, layout, base)
        for interp in ("nearest", "trilinear"):
            def new_fn():
                return be.brick_eval_volume(*args_v, interp=interp)

            def old_fn():
                return old.brick_eval(torch, params, pix, windows, table,
                                      interp)

            if not torch.equal(new_fn() >= 1e6, old_fn() >= 1e6):
                cs.fail(f"old brick_eval guard positions differ at "
                        f"C={table.shape[1]} {interp}")
            r = turns(torch, new_fn, old_fn, 200, 20)
            r.update(kernel="brick_eval", C=table.shape[1], P=pix.shape[0],
                     interp=interp)
            rows.append(r)
            print(f"[turns] brick_eval C={r['C']} P={r['P']} {interp}: "
                  f"device new {r['new']['device_ms']:.4f} old "
                  f"{r['old']['device_ms']:.4f} ms, call new "
                  f"{r['new']['call_ms']:.4f} old {r['old']['call_ms']:.4f} "
                  f"ms", flush=True)
    del slam
    torch.cuda.empty_cache()

    slam, _, _, captured = cs.slice_b_captured(torch)
    for enc, x, g, n_rows in captured:
        def new_fn():
            return he.hash_table_grad(enc, x, g, n_rows)

        def old_fn():
            return old.hash_table_grad(torch, enc, x, g, n_rows)

        ref = new_fn()
        e = float((old_fn() - ref).abs().max())
        if not e <= cs.HASH_TOL * float(ref.abs().max()):
            cs.fail(f"old hash_table_grad disagrees at N={x.shape[0]}: {e}")
        r = turns(torch, new_fn, old_fn, 50, 5)
        r.update(kernel="hash_table_grad", N=x.shape[0])
        rows.append(r)
        print(f"[turns] hash_table_grad N={r['N']}: device new "
              f"{r['new']['device_ms']:.4f} old {r['old']['device_ms']:.4f} "
              f"ms, call new {r['new']['call_ms']:.4f} old "
              f"{r['old']['call_ms']:.4f} ms", flush=True)
    print(cs.card_line(), flush=True)
    print(json.dumps({"turns": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
