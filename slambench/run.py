#!/usr/bin/env python3
"""Online-SLAM benchmark of remixfusion_tpu_torch on one CUDA card.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1> [--control 1]

Set-up: the cell's files (slambench/cells, configs, traffic), the port's
kernels built or found under build/kernels, RemixFusionTorch constructed
with the cell's configuration and `seed`, first-frame mapping, every frame
of the sequence rendered or loaded, and the cell's warm-up frames stepped.
The window: RemixFusionTorch.step frame after frame, closed loop, until
--seconds have passed or the sequence ends, then a synchronise. After it:
the frames up to the ATE's last one (untimed), the poses, the comparison
of what the window's timed path produced at frames and a round drawn from
the seed against the plain reference (slambench/reference), and one JSON
line on stdout. --trace 1 also traces a steady sub-window with
torch.profiler and reports the cell's per-layer metrics instead of its
end-to-end ones. --control 1 (not a benchmark run) also prints the
control's readings, the reference in the precision below the
configuration's, which has to fail, and the readings of two faults
planted in what the program produced (checks.faults).

The process's temporary directory is slambench/work/tmp, so the port's
synthetic frame cache and the run's outputs stay in the checkout at fixed
paths. Exits non-zero without a card, and if JAX or the JAX package is
loaded when the result would be printed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORK = os.path.join(HERE, "work")
FORBIDDEN = ("jax", "jaxlib", "flax", "remixfusion_tpu")
# the ATE covers frames 0..ATE_LAST, from the poses as they stand once
# frame ATE_AT has been stepped: the mapping rounds and their write-backs
# fall at fixed frames, so the poses then do not depend on how far the
# window got (a fast run's later rounds would refine them further)
ATE_LAST, ATE_AT = 199, 214
# the traced sub-window: the TRACE_FRAMES frames after the timed window
# (three mapping rounds at map_every 5)
TRACE_FRAMES = 15
# tracking and fusion are checked at TRACK_CHECKS frames among the
# window's first CHECK_SPAN; the checked round starts after a frame drawn
# in [ROUND_LO, ROUND_HI) of the window
TRACK_CHECKS, CHECK_SPAN, ROUND_LO, ROUND_HI = 3, 24, 2, 12

sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def point_tmp():
    """Fixed, git-ignored temporary and cache directories in the
    checkout, set before the port is imported."""
    tmp = os.path.join(WORK, "tmp")
    os.makedirs(tmp, exist_ok=True)
    os.environ["TMPDIR"] = tmp
    os.environ["TRITON_CACHE_DIR"] = os.path.join(WORK, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(WORK, "extensions")
    tempfile.tempdir = tmp


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not run: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def card_state() -> str:
    """The card's SM clock, power draw, temperature and active throttle
    reasons, and the host's load average (diagnostics beside the
    window)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu,"
             "clocks_throttle_reasons.active", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi not run: {e}"
    return f"{out}; load {os.getloadavg()}"


def geometry(slam) -> dict:
    mv = slam.mv
    return {"H": slam.dataset.H, "W": slam.dataset.W, "K": slam.K,
            "dims": mv.dims, "voxel_size": mv.voxel_size,
            "layout": mv.brick_layout(), "trunc": mv.trunc_margin,
            "clamp_w": mv.weight_clamp}


def traced(slam, taps_cls, step, first, sync):
    """Trace frames first .. first + TRACE_FRAMES - 1; returns (events,
    wall s, rounds, taps)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from harness.trace import WINDOW_SPAN

    taps = taps_cls(slam)
    rounds0 = len(slam.round_ms)
    sync()
    prof = profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA])
    prof.start()
    taps.start()
    t0 = time.perf_counter()
    with record_function(WINDOW_SPAN):
        for i in range(first, first + TRACE_FRAMES):
            step(i)
        sync()
    wall = time.perf_counter() - t0
    taps.stop()
    prof.stop()
    return (prof.profiler.kineto_results.events(), wall,
            len(slam.round_ms) - rounds0, taps)


def kernel_summary(summary, taps, cfg, device):
    """Roofline and MFU inputs of the traced sub-window."""
    from harness import roofline as rl
    from harness.trace import kernel_time_s

    ops_be = bound_be = 0.0
    for params, pix, table, interp in taps.brick:
        reached = rl.reached_pairs(params, pix, table)
        ops, nbytes = rl.brick_eval_counts(
            table.shape[1], pix.shape[0], pix.shape[1], table.shape[0],
            reached, interp)
        ops_be += ops
        bound_be += rl.bound_s(ops, nbytes)
    bound_hg = 0.0
    for n, levels, rows in taps.hash:
        bound_hg += rl.bound_s(*rl.hash_table_grad_counts(n, levels, rows))
    field = (taps.points["map"] + taps.points["ba"]) * rl.field_point_flops(
        cfg, rl.encoding_dim(cfg))
    summary["brick_eval"] = {"launches": len(taps.brick),
                             "device_s": kernel_time_s(summary, "brick_eval"),
                             "bound_s": bound_be}
    summary["hash_table_grad"] = {
        "launches": len(taps.hash),
        "device_s": kernel_time_s(summary, "hash_table_grad"),
        "bound_s": bound_hg}
    summary["ops"] = ops_be + field
    summary["points"] = dict(taps.points)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0, choices=(0, 1))
    ap.add_argument("--control", type=int, default=0, choices=(0, 1))
    args = ap.parse_args(argv)

    from harness.spec import Cell, load_benchmark

    cell = Cell(load_benchmark(ROOT), args.workload)
    point_tmp()
    import torch

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"slambench: cell {cell.name} needs {chips} CUDA device(s); "
            f"found {found}")
        return 2
    device = torch.device("cuda", 0)
    card = card_line()
    log(f"# {cell.name} seed={args.seed} seconds={args.seconds} "
        f"trace={args.trace} card: {card}")
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   bool(args.control), device)
    bad = loaded_forbidden()
    if bad:
        log(f"slambench: {bad} loaded in the benchmark's process")
        return 3
    res["device"].update(kind=torch.cuda.get_device_name(0), count=chips)
    for name, value, limit in res["checks"]:
        log(f"check {name} {value!r} limit {limit!r}")
    print(json.dumps(res), flush=True)
    return 0


def run_cell(cell, seed: int, seconds: float, trace: bool, control: bool,
             device) -> dict:
    """Set-up, window, check; the result dict (device kind and count are
    the caller's)."""
    import numpy as np
    import torch

    from harness import ate, checks, window
    from harness.capture import Capture, TraceTaps, draw_plan
    from harness.spec import metric_reader
    from harness.trace import summarize

    cfg, n_frames = cell.run_config()
    warmup = int(cell.spec["warmup_frames"])
    cfg["seed"] = int(seed)
    cfg["data"]["output"] = os.path.join(WORK, "output")
    cfg["data"]["exp_name"] = cell.name

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if device.type == "cuda":
        from remixfusion_tpu_torch.ops import build

        t0 = time.perf_counter()
        build.build_all()
        log(f"# kernels built or found in {time.perf_counter() - t0:.2f}s")
    from remixfusion_tpu_torch.slam import RemixFusionTorch

    t0 = time.perf_counter()
    slam = RemixFusionTorch(cfg, device=device)
    log(f"# pipeline set-up {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    slam.first_frame_mapping()
    sync()
    log(f"# first-frame mapping {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    slam.preload(n_frames)
    log(f"# {n_frames} frames rendered or loaded "
        f"{time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    for i in range(1, warmup + 1):
        slam.step(i, n_frames)
    sync()
    log(f"# {warmup} warm-up frames {time.perf_counter() - t0:.2f}s")

    first = warmup + 1
    cap = Capture(slam, draw_plan(seed, first, TRACK_CHECKS, CHECK_SPAN,
                                  ROUND_LO, ROUND_HI)).install()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    ate_at = min(ATE_AT, n_frames - 1)
    snap = {}

    def step(i):
        cap.frame = i
        slam.step(i, n_frames)
        if i == ate_at:
            snap["est"] = slam.est_c2w_data.copy()
            snap["rel"] = slam.est_c2w_data_rel.copy()

    if device.type == "cuda":
        log(f"# before the window: {card_state()}")
    # the set-up's objects move out of the collector's sight, so that a
    # full collection in the window does not walk them
    gc.collect()
    gc.freeze()
    rounds0, tracks0 = len(slam.round_ms), len(slam.track_ms)
    setup_s = time.perf_counter() - T_START
    # a traced run keeps the traced sub-window's frames after the window
    w = window.run_window(step, first,
                          n_frames - (TRACE_FRAMES if trace else 0),
                          seconds, sync)
    gc.unfreeze()
    rms = np.asarray(slam.round_ms[rounds0:])
    tms = np.asarray(slam.track_ms[tracks0:])
    if rms.size and tms.size:
        log(f"# in the window: {rms.size} rounds, median "
            f"{np.median(rms):.1f} ms, p90 {np.percentile(rms, 90):.1f}; "
            f"track_frame host median {np.median(tms):.1f} ms, p90 "
            f"{np.percentile(tms, 90):.1f}")
    if device.type == "cuda":
        log(f"# after the window: {card_state()}")
    summary = None
    if trace:
        start = w["next"]
        events, wall, rounds, taps = traced(slam, TraceTaps, step, start,
                                            sync)
        summary = summarize(events, wall, TRACE_FRAMES, rounds)
        del events
        kernel_summary(summary, taps, cfg, device)
        del taps
        w_end = start + TRACE_FRAMES
    else:
        w_end = w["next"]
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    log(f"# window: frames {w['first']}..{w['next'] - 1} ({w['frames']}) in "
        f"{w['window_s']:.3f}s; {len(slam.round_ms)} rounds so far")
    if w["exhausted"]:
        log(f"# the sequence ran out before {seconds} s: all "
            f"{w['frames']} frames over all {w['window_s']:.3f} s are "
            f"reported; lengthen the cell's sequence")
    window.continue_to(step, {"next": w_end}, ate_at)
    sync()
    poses = slam.convert_relative_pose_npy()
    gt = slam.pose_gt
    # frames far enough behind ate_at to have been harvested and composed
    last = min(ATE_LAST, ate_at - (ATE_AT - ATE_LAST))
    ate_full = ate.ate_cm(gt[:last + 1], ate.composed(
        snap["est"], snap["rel"], last + 1,
        int(cfg["mapping"]["keyframe_every"])))
    ate_ro = ate.ate_cm(gt[:last + 1], slam.RO_c2w_data[:last + 1])
    win = np.arange(w["first"], w["next"])
    finite = np.isfinite(poses[win]).all((1, 2))
    failed = int((~finite).sum())
    ate_final = ate.ate_cm(gt[:last + 1], poses[:last + 1])
    log(f"# ate_cm {ate_full!r} ro_only {ate_ro!r} over frames 0..{last} "
        f"as of frame {ate_at} (final poses {ate_final!r}); "
        f"peak {peak} B; {len(slam.mv.frame_to_vrange)} re-centres")

    # the copies the check holds count in the peak: stated apart
    log(f"# the check's copies {cap.nbytes()} B of the peak")
    geom = geometry(slam)
    missing = cap.complete(cell.spec["limits"])
    # the program's state goes before the reference runs; the capture
    # keeps its copies
    del slam, step
    cap.slam = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    if missing:
        log(f"# the window did not reach: {missing}")
        numbers = dict.fromkeys(checks.NUMBERS, float("nan"))
    else:
        numbers = checks.compare(cfg, geom, cap, control=False)
    ok, rows = checks.judge(numbers, cell.spec["limits"])
    log(f"# reference check {time.perf_counter() - t0:.2f}s")
    if control and not missing:
        ctl = checks.compare(cfg, geom, cap, control=True)
        log("# control " + json.dumps(ctl))
        log("# faults " + json.dumps(checks.faults(cfg, geom, cap)))
    del cap

    res = {"correct": bool(ok and failed == 0), "attempted": w["frames"],
           "failed": failed, "metrics": {},
           "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                      "memory_peak_bytes": int(peak)}}
    if not trace:
        values = {"fps": window.fps(w), "frame_p95_ms":
                  window.frame_p95_ms(w), "ate_cm": ate_full,
                  "setup_s": setup_s}
        log(f"# frame_p95_ms over {w['frames']} frames")
        for m in cell.end_to_end():
            res["metrics"][m["name"]] = {"value": values[m["name"]],
                                         "unit": m["unit"]}
    else:
        summary["ate_ro_cm"] = ate_ro
        for m in cell.per_layer():
            v = metric_reader(m["name"], cell.dir)(summary)
            if v is not None:
                res["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        res["device"]["busy_s"] = summary["busy_s"]
        res["device"]["window_s"] = summary["window_s"]
        res["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
        log(f"# traced {TRACE_FRAMES} frames, {summary['rounds']} rounds: "
            f"spans {summary['span_s']}; brick_eval "
            f"{summary['brick_eval']}; hash_table_grad "
            f"{summary['hash_table_grad']}; points {summary['points']}")
    res["checks"] = rows
    return res


if __name__ == "__main__":
    sys.exit(main())
