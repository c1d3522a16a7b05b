#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (remixfusion_tpu_torch).

Run from the repository root on a machine with one CUDA card (sm_90a):

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise and
prints no result line):
  1. build: nvcc compiles every remixfusion_tpu_torch/csrc/*.cu (one process
     per source, started together) into build/kernels/; the ptxas register /
     shared-memory lines are printed; g++ compiles the host sources
     (csrc/*.cpp: marching tetrahedra, the depth rasterizer) into
     build/host/;
  2. slice A: configs/Synthetic/synthetic_bench.yaml (CPGrid residual field)
     at full width (640x480, PST tiers 10240/3072/1024, 20 particle
     iterations, 300^3 local volume at 2 cm in 10^3 bricks, 200^3 global
     grid, 2048-ray map batches) through RemixFusionTorch.run for the first
     N_FRAMES frames (the one cut): first-frame mapping, tracking, a mapping
     round every 5 frames. Kernel launch counts are zeroed just before and
     read just after: brick_eval launched 20 times per tracked frame,
     hash_table_grad never; RO-only and full ATE below 2 cm. The run ends
     in finalize, outside the timed loop: mesh.ply (the residual field's
     SDF and weight queried on the card over the dense 3 cm grid of the
     4 m marching-cubes bound, 134^3 = 2.41 M points; marching tetrahedra
     on the host) and mesh_cull_occlusion.ply;
  2b. mesh A: both meshes exist, are non-empty and have every vertex in
     [-0.5, 4.5]^3; the card's SDF grid agrees with a CPU copy of the same
     scene on a fixed 65,536-point subset of the grid within 1e-4 absolute
     (device-only numerics, e.g. TF32, would show here);
     tools/eval_recon.mesh_quality scores the culled mesh against the
     analytic scene (accuracy, completion, ratios and F1 at 5 cm, the GT
     culled with the poses of the frames run) and prints one JSON line
     {"mesh": {...}} with the mesh stage times; F1 >= 0.90 (a sanity bar
     for a 60-frame cut, not the quality target);
  3. kernel brick_eval (the tracker's entry, windows gathered from the
     brick-major volume inside the kernel) against its plain PyTorch version
     on the card, on the tier inputs of slice A's last frame, at the three
     main-path shapes and in both interpolation modes, with the parity
     tests' tolerance (max |d| < 5e-3, mean < 1e-4, same 1e6-guard
     positions) and the same bits on a second call;
  4. slice B: configs/Synthetic/bench_hashgrid.yaml (HashGrid residual
     field, 16 levels, 2^16 hashed) the same way: brick_eval launched 20
     times per tracked frame, hash_table_grad twice per map iteration (the
     render points' and the smoothness points' backward), full ATE below 2
     cm, the first-frame map loss falling and every parameter finite; then
     its mesh phase as in 2b;
  5. kernel hash_table_grad against its plain version on the card, on the
     points and output gradients of slice B's last map step (render and
     smoothness shapes): max |d| <= 1e-5 * max |plain| (atomics reorder
     float32 sums) and rows no point touched exactly zero; index_add_ on
     precomputed rows is the library yardstick (used nowhere in the port);
  6. real tum: configs/Tum/fr1_desk.yaml at its own cam, RO, volume and
     mapping widths (RO.sample_range 0.1, the U(-sr, sr) branch of the
     per-pixel ray shift; crop_edge 10, crop_size [384, 512], the
     five-term distortion, png_depth_scale 5000, optim_cur,
     filter_depth) on a TUM layout (rgb.txt / depth.txt /
     groundtruth.txt, 16-bit depth PNGs, distorted colour PNGs) that
     tools/write_layout.py renders from the synthetic room; only
     data.datadir, data.output, mapping.bound and marching_cubes_bound
     (the room) and the frame count (REAL_FRAMES) are overridden. The
     frames go through the port's loader (its own PNG decoder, the
     cv2-exact undistort and resize) into RemixFusionTorch.run, as
     `run_torch.py --config ... --input_folder ...` does. brick_eval
     launched 20 times per tracked frame; full and RO-only ATE at most
     1.5 cm;
  7. real scannet: the settings of configs/ScanNet/scene0000.yaml
     (sample_range 2.0, the U(-sr, 1) branch, so the expected tsdf
     saturates to 1.0 past the truncation; 4 cm voxels, crop_edge 10,
     cut_dist 20) with dataset largeindoor: the ScanNet directory
     structure (color/, depth/, pose/*.txt) with PNG colour, so the card
     needs no JPEG decoder; colour written at 1296x968 over 640x480 depth,
     so the colour resize runs; the orbit at 0.6 degrees per frame (half
     the TUM layout's: at 1.2 this config drifts past the bar in both
     packages, PERF.md section 6). The same checks; then brick_eval against
     its plain version (both interpolation modes, phase 3's tolerance) on
     the tier inputs captured from this phase's last frame, whose expected
     tsdf holds 1.0 and values below 0;
  8. the kernels JSON line, a {"phase_wall_s": ...} line; the card's name
     and power limit; and last the {"ok": true, ...} line.
Every kernel is timed two ways: device_ms, the device time of one call (a
CUDA graph of many calls replayed back to back, timed with CUDA events,
divided by the number of calls; the output allocation and zeroing of a
call are in it), and call_ms, one call of the wrapper in a host loop (CUDA
events around the loop: the larger of the host's cost of a call and its
device time).
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIGS = {"A": os.path.join(ROOT, "configs", "Synthetic",
                             "synthetic_bench.yaml"),
           "B": os.path.join(ROOT, "configs", "Synthetic",
                             "bench_hashgrid.yaml")}
N_FRAMES = 60
ATE_BAR_CM = 2.0
# the real-layout phases: config, layout written, dataset name override,
# colour size (H, W) when it differs from depth, orbit degrees per frame.
# ScanNet's 4 cm voxels and 58-degree field of view drift on the synthetic
# orbit at the JAX layout smoke's 1.2 degrees per frame (4.76 cm RO-only
# ATE over 40 frames on an H100; the JAX package drifts alike, PERF.md
# section 6): its layout moves at half that speed, 1.4 cm per frame
REAL = {
    "tum": ("configs/Tum/fr1_desk.yaml", "tum", None, None, 1.2),
    "scannet": ("configs/ScanNet/scene0000.yaml", "largeindoor",
                "largeindoor", (968, 1296), 0.6),
}
REAL_FRAMES = 40
REAL_ATE_BAR_CM = 1.5
MESH_BOX = (-0.5, 4.5)
SDF_TOL = 1e-4
SDF_SUBSET = 65536
F1_BAR = 0.90
TOL_MAX, TOL_MEAN = 5e-3, 1e-4
HASH_TOL = 1e-5
# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations per (candidate, pixel) pair in brick_eval: transform +
# reprojection for every pair, window lookup + accumulation for the pairs
# that reach it (ok and inside the image)
OPS_PAIR = 64
OPS_LOOKUP = {"nearest": 17, "trilinear": 53}


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_cuda(torch, fn, n, warmup):
    """Call time: mean ms per call over n calls of the wrapper in a host
    loop after warm-up (CUDA events around the loop), which is max(host
    cost of a call, its device time). Inputs stay L2-resident, as in the
    main path, where the preceding ops just produced them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def time_device(torch, fn, n, warmup):
    """Device time: mean ms per call of n calls captured in one CUDA graph
    and replayed back to back (CUDA events around the replay), so no host
    cost is in it. The calls are warmed up first, outside the capture."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / n


def measure(torch, fn, n, warmup):
    return {"device_ms": time_device(torch, fn, n, warmup),
            "call_ms": time_cuda(torch, fn, n, warmup)}


def phase_build():
    from remixfusion_tpu_torch.ops import build

    t0 = time.time()
    logs = build.build_all()
    print(f"[build] {len(logs)} source(s) in {time.time() - t0:.1f} s",
          flush=True)
    t0 = time.time()
    for name in build.host_sources():
        build.load_host(name)
    print(f"[build] host sources {build.host_sources()} in "
          f"{time.time() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)


def phase_slice(torch, label):
    """Drive slice `label` through RemixFusionTorch.run with every kernel's
    launch count zeroed just before and read just after."""
    import numpy as np

    from remixfusion_tpu_torch.config import load_config
    from remixfusion_tpu_torch.ops import brick_eval as be
    from remixfusion_tpu_torch.ops import hash_enc as he
    from remixfusion_tpu_torch.slam import RemixFusionTorch

    cfg = load_config(CONFIGS[label])
    cfg["data"]["output"] = os.path.join(ROOT, "build", "smoke", label)
    t0 = time.time()
    slam = RemixFusionTorch(cfg, device="cuda")
    slam.preload(N_FRAMES + 1)
    print(f"[slice {label}] {os.path.relpath(CONFIGS[label], ROOT)}: set-up "
          f"(seed fusion, {N_FRAMES + 1} frames rendered) "
          f"{time.time() - t0:.1f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    be.brick_eval_volume.launches = 0
    he.hash_table_grad.launches = 0
    out = slam.run(max_frames=N_FRAMES)
    launches = {"brick_eval": be.brick_eval_volume.launches,
                "hash_table_grad": he.hash_table_grad.launches}
    peak = torch.cuda.max_memory_allocated()
    iters = int(cfg["RO"]["particle_iter_lens"])
    ffl = slam.first_frame_losses
    print(f"[slice {label}] frames={out['frames']} tracked="
          f"{out['tracked_frames']} ms_per_frame={out['ms_per_frame']} "
          f"(host clock over {out['timed_frames']} frames with "
          f"{out['timed_rounds']} mapping rounds, ending in "
          f"torch.cuda.synchronize) ms_per_round={out['ms_per_round']} "
          f"rounds={out['mapping_rounds']} first_frame_mapping_ms="
          f"{out['first_frame_mapping_ms']} ate_rmse_cm={out['ate_rmse_cm']} "
          f"ate_rmse_cm_ro_only={out['ate_rmse_cm_ro_only']} "
          f"map_iters={out['map_iters']} ba_iters={out['ba_iters']} "
          f"launches={launches} max_memory_allocated={peak}", flush=True)
    print(f"[slice {label}] first-frame map loss every 25 iterations: "
          f"{[float(v) for v in ffl[::25]]} last {float(ffl[-1])}",
          flush=True)
    if launches["brick_eval"] != iters * out["tracked_frames"]:
        fail(f"slice {label}: brick_eval launched {launches['brick_eval']} "
             f"times, expected {iters * out['tracked_frames']}")
    want = 2 * out["map_iters"] if label == "B" else 0
    if launches["hash_table_grad"] != want:
        fail(f"slice {label}: hash_table_grad launched "
             f"{launches['hash_table_grad']} times, expected {want}")
    for key in ("ate_rmse_cm_ro_only", "ate_rmse_cm"):
        if not out[key] < ATE_BAR_CM:
            fail(f"slice {label}: {key} {out[key]} cm >= {ATE_BAR_CM}")
    if not out["mapping_rounds"] > 0:
        fail(f"slice {label}: no mapping round ran")
    if not ffl[-1] < ffl[0]:
        fail(f"slice {label}: first-frame map loss did not fall "
             f"({ffl[0]} -> {ffl[-1]})")
    n = out["frames"]
    if not (np.isfinite(slam.RO_c2w_data[:n]).all()
            and np.isfinite(slam.trajectory(n)).all()):
        fail(f"slice {label}: non-finite pose")
    if not all(bool(torch.isfinite(p).all())
               for p in slam.scene.parameters()):
        fail(f"slice {label}: non-finite scene parameter")
    return slam, out, launches


def phase_mesh(slam, out, label):
    """The end-of-run mesh of slice `label`: files and bounds, the card's
    SDF grid against a CPU recompute, and the mesh quality."""
    import numpy as np

    from remixfusion_tpu_torch.tools.eval_recon import mesh_quality
    from remixfusion_tpu_torch.utils.convert import scene_from_numpy, \
        scene_to_numpy
    from remixfusion_tpu_torch.utils.mesh import grid_points, query_points
    from remixfusion_tpu_torch.utils.meshio import read_ply

    counts = {}
    for key in ("mesh_path", "mesh_cull_path"):
        path = out[key]
        if not os.path.exists(path):
            fail(f"slice {label}: {path} was not written")
        v, f = read_ply(path)
        if v is None or f is None or not len(v) or not len(f):
            fail(f"slice {label}: {path} is empty")
        if not (np.isfinite(v).all() and (v >= MESH_BOX[0]).all()
                and (v <= MESH_BOX[1]).all()):
            fail(f"slice {label}: {path} has vertices outside "
                 f"[{MESH_BOX[0]}, {MESH_BOX[1]}]^3")
        counts[key] = (len(v), len(f))

    sdf = slam.mesh_info["sdf"].reshape(-1)
    _, pts = grid_points(slam.bound, slam.mc_bound,
                         voxel_size=slam.config["mesh"]["voxel_final"])
    if len(pts) != len(sdf):
        fail(f"slice {label}: mesh grid has {len(sdf)} points, expected "
             f"{len(pts)}")
    idx = np.sort(np.random.default_rng(0).choice(len(pts), SDF_SUBSET,
                                                  replace=False))
    params, buffers = scene_to_numpy(slam.scene)
    cpu = scene_from_numpy(slam.config, slam.bound, slam.num_kf, params,
                           buffers, device="cpu")
    ref = query_points(cpu.query_sdf_res, pts[idx], "cpu")
    err = float(np.abs(ref - sdf[idx]).max())
    if not err <= SDF_TOL:
        fail(f"slice {label}: card SDF grid differs from the CPU recompute "
             f"by {err} > {SDF_TOL}")

    t0 = time.time()
    q = mesh_quality(slam.config, slam.out_dir, out["frames"], slam.dataset)
    line = {"slice": label, "grid_points": len(pts),
            "mesh_verts": counts["mesh_path"][0],
            "mesh_faces": counts["mesh_path"][1],
            "mesh_cull_faces": counts["mesh_cull_path"][1],
            "sdf_cpu_max_abs_err": err,
            "stage_ms": {k: out[f"mesh_{k}_ms"]
                         for k in ("query", "marching", "write", "cull")},
            "quality_eval_s": time.time() - t0, **q}
    print(json.dumps({"mesh": line}), flush=True)
    if not q["f1"] >= F1_BAR:
        fail(f"slice {label}: mesh F1 {q['f1']} < {F1_BAR}")
    return line


def tier_cases(torch, slam, frames):
    """brick_eval_volume's arguments (params, pix, base, tsdf_bm, layout,
    table) at the three tiers of the tracker's last frame, its first
    particle iteration."""
    from remixfusion_tpu_torch.slam.pipeline import quantize_depth

    tr = slam.tracker
    last = frames - 1
    depth = torch.tensor(quantize_depth(slam.dataset[last]["depth"]),
                         device=slam.device)
    c2w = torch.tensor(slam.RO_c2w_data[last], device=slam.device)
    ss = tr.init_search_size()
    vn = tr.vertex_normal_maps(depth)
    cases = []
    for cls in range(3):
        params, pix, base = tr.tier_inputs(
            tr.class_level[cls], 0, c2w[:3, :3], c2w[:3, 3], ss, vn,
            slam.mv.state.origin)
        cases.append((params, pix, base, slam.mv.state.tsdf,
                      tr.brick_layout, tr.pst_t[cls][0]))
    return cases


def check_brick_case(torch, args, phase):
    """brick_eval_volume against its plain version on one tier's inputs,
    in both interpolation modes: same bits on a second call, the same
    guard positions, max |d| < TOL_MAX and mean < TOL_MEAN; then its
    device and call times, the plain version's and the bound."""
    from remixfusion_tpu_torch.ops import brick_eval as be

    params, pix, base, tsdf, layout, table = args
    C, P = table.shape[1], pix.shape[0]
    windows = be.fetch_windows(tsdf, layout, base)
    shapes = []
    for interp in ("nearest", "trilinear"):
        got = be.brick_eval_volume(*args, interp=interp)
        again = be.brick_eval_volume(*args, interp=interp)
        ref = be.brick_eval_volume_reference(*args, interp=interp)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"brick_eval gave other bits on a second call at C={C} "
                 f"P={P} {interp} ({phase})")
        if not torch.equal(got >= 1e6, ref >= 1e6):
            fail(f"brick_eval guard positions differ at C={C} P={P} "
                 f"{interp} ({phase})")
        keep = got < 1e6
        d = (got - ref).abs()[keep]
        err_max = float(d.max()) if d.numel() else 0.0
        err_mean = float(d.mean()) if d.numel() else 0.0
        if not (err_max < TOL_MAX and err_mean < TOL_MEAN):
            fail(f"brick_eval disagrees with its plain version at C={C} "
                 f"P={P} {interp} ({phase}): max {err_max} mean {err_mean}")
        t = measure(torch, lambda: be.brick_eval_volume(
            *args, interp=interp), 200, 20)
        p_ms = time_cuda(torch, lambda: be.brick_eval_volume_reference(
            *args, interp=interp), 20, 3)
        reached = int(be.pair_terms(params, pix, windows, table,
                                    interp=interp)[2].sum())
        ops = C * P * OPS_PAIR + reached * OPS_LOOKUP[interp]
        # params, pix, base and table read once, each window's 64 cells
        # read once from the volume, the costs written once
        nbytes = 4 * (32 + P * (pix.shape[1] + 3 + 64)
                      + C * table.shape[0] + C)
        t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
        ok = pix[:, 7] > 0
        gt = pix[ok, 3]
        shapes.append({
            "phase": phase, "C": C, "P": P, "interp": interp,
            "device_ms": t["device_ms"], "call_ms": t["call_ms"],
            "plain_ms": p_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "max_abs_err": err_max, "mean_abs_err": err_mean,
            "guarded": int((~keep).sum()),
            "pairs_reaching_lookup": reached,
            "gt_min": float(gt.min()) if gt.numel() else 0.0,
            "gt_max": float(gt.max()) if gt.numel() else 0.0,
            "gt_ones": int((gt == 1.0).sum()),
            "gt_negative": int((gt < 0).sum())})
        print(f"[kernel] brick_eval ({phase}) C={C} P={P} {interp}: "
              f"max|d|={err_max:.3e} mean|d|={err_mean:.3e} device "
              f"{t['device_ms']:.4f} ms, call {t['call_ms']:.4f} ms, "
              f"plain {p_ms:.4f} ms, bound {max(t_ops, t_bytes):.4f} ms; "
              f"expected tsdf in [{shapes[-1]['gt_min']:.4f}, "
              f"{shapes[-1]['gt_max']:.4f}], {shapes[-1]['gt_ones']} at "
              f"1.0, {shapes[-1]['gt_negative']} below 0", flush=True)
    return shapes


def phase_kernels(torch, slam, frames):
    import numpy as np

    shapes = []
    for args in tier_cases(torch, slam, frames):
        shapes += check_brick_case(torch, args, "A")
    main = [s for s in shapes if s["interp"] == slam.tracker.tsdf_interp]
    mean = lambda k: float(np.mean([s[k] for s in main]))  # noqa: E731
    by = [s["bound_by"] for s in main]
    return {
        "name": "brick_eval", "route": "cuda",
        "source": "remixfusion_tpu_torch/csrc/brick_eval.cu",
        "replaces": "remixfusion_tpu/ops/pallas/brick_eval.py:40",
        "ms": mean("device_ms"), "device_ms": mean("device_ms"),
        "call_ms": mean("call_ms"), "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"),
        "bound_by": max(set(by), key=by.count),
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "library_ms": None,
        "shapes": shapes,
    }


def touched_rows(he, enc, x, n_rows):
    """Rows of the table the points x reach (any corner, any level), and
    the concatenated rows of all corners in the kernel's contribution
    order (for the index_add_ yardstick)."""
    import torch

    corner, frac = he.positions(enc, x)
    rows, weights = [], []
    for row, w, _ in he.corners(enc, corner, frac):
        rows.append(row)
        weights.append(w)
    mask = torch.zeros(n_rows, dtype=torch.bool, device=x.device)
    idx = torch.stack(rows, 1).reshape(-1)
    mask[idx] = True
    return mask, idx, torch.stack(weights, 1)


def phase_hash_kernel(torch, captured):
    """hash_table_grad against its plain version at the shapes of slice B's
    last map step: the render points' backward and the smoothness points'."""
    from remixfusion_tpu_torch.ops import hash_enc as he

    if len(captured) != 2:
        fail(f"captured {len(captured)} hash_table_grad calls, expected 2")
    shapes = []
    for enc, x, g, n_rows in captured:
        n, L = x.shape[0], enc.n_levels
        ref = he.hash_table_grad_reference(enc, x, g, n_rows)
        mask, idx, w = touched_rows(he, enc, x, n_rows)
        if bool((ref[~mask] != 0).any()):
            fail(f"hash_table_grad plain version: an untouched row is not "
                 f"zero (N={n})")
        scale = float(ref.abs().max())

        def check(out, what):
            if bool((out[~mask] != 0).any()):
                fail(f"{what}: an untouched row is not zero (N={n})")
            e = float((out - ref).abs().max())
            if not e <= HASH_TOL * scale:
                fail(f"{what} disagrees with the plain version at N={n}: "
                     f"max |d| {e} > {HASH_TOL} * {scale}")
            return e

        err = check(he.hash_table_grad(enc, x, g, n_rows), "hash_table_grad")
        vals = (w[..., None] * g.reshape(n, 1, L, 2)).reshape(-1, 2)

        def library():
            return torch.zeros((n_rows, 2), device=x.device).index_add_(
                0, idx, vals)

        lib_err = float((library() - ref).abs().max())
        t = measure(torch, lambda: he.hash_table_grad(enc, x, g, n_rows),
                    50, 5)
        p_ms = time_cuda(torch, lambda: he.hash_table_grad_reference(
            enc, x, g, n_rows), 10, 2)
        lib_t = measure(torch, library, 50, 5)
        # bytes: x and grad_out read once, the table gradient written once;
        # operations: ~34 FP32 per (point, level) for positions and
        # weights, 4 per corner for its weight and float2 contribution
        nbytes = 4 * (n * 3 + n * L * 2) + 4 * n_rows * 2
        ops = n * L * (34 + 8 * 4)
        t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
        shapes.append({
            "N": n, "levels": L, "rows": n_rows,
            "device_ms": t["device_ms"], "call_ms": t["call_ms"],
            "plain_ms": p_ms, "library_ms": lib_t["call_ms"],
            "library_device_ms": lib_t["device_ms"],
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "max_abs_err": err, "max_abs_ref": scale,
            "library_max_abs_err": lib_err,
            "rows_touched": int(mask.sum()),
            "atomics_float2_unmerged": n * L * 8,
            "privatized_rows": he.privatized_rows(enc)})
        print(f"[kernel] hash_table_grad N={n} L={L} rows={n_rows}: "
              f"max|d|={err:.3e} (max|ref| {scale:.3e}) device "
              f"{t['device_ms']:.4f} ms, call {t['call_ms']:.4f} ms, "
              f"plain {p_ms:.4f} ms, index_add_ {lib_t['call_ms']:.4f} ms "
              f"(device {lib_t['device_ms']:.4f}), bound "
              f"{max(t_ops, t_bytes):.4f} ms ({int(mask.sum())} rows "
              f"touched)", flush=True)
    mean = lambda k: sum(s[k] for s in shapes) / len(shapes)  # noqa: E731
    return {
        "name": "hash_table_grad", "route": "cuda",
        "source": "remixfusion_tpu_torch/csrc/hash_enc.cu",
        "replaces": "remixfusion_tpu/ops/pallas/hash_enc.py:139",
        "ms": mean("device_ms"), "device_ms": mean("device_ms"),
        "call_ms": mean("call_ms"), "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"), "bound_by": shapes[0]["bound_by"],
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "library_ms": mean("library_ms"), "shapes": shapes,
    }


def slice_b_captured(torch):
    """phase_slice of slice B, keeping the inputs of its last two
    table-gradient calls (its last map step: render points, then smoothness
    points)."""
    from collections import deque

    from remixfusion_tpu_torch.ops import hash_enc as he

    captured = deque(maxlen=2)
    kernel = he.hash_table_grad

    def capture(enc, x, g, n_rows):
        captured.append((enc, x, g, n_rows))
        return kernel(enc, x, g, n_rows)

    he.hash_table_grad = capture
    try:
        slam, out, launches = phase_slice(torch, "B")
    finally:
        he.hash_table_grad = kernel
    return slam, out, launches, list(captured)


def phase_real(torch, label):
    """Write the `label` layout from the synthetic room at the config's own
    camera, then drive RemixFusionTorch.run through the port's loader with
    brick_eval's launch count zeroed just before and read just after.
    Returns (slam, stats, launches, captured tier inputs of the last
    tracked frame: (params, pix, base, tsdf, layout, table) per call)."""
    import numpy as np

    from remixfusion_tpu_torch.config import load_config
    from remixfusion_tpu_torch.ops import brick_eval as be
    from remixfusion_tpu_torch.slam import RemixFusionTorch
    from remixfusion_tpu_torch.tools.write_layout import ROOM, write_layout
    from remixfusion_tpu_torch.tracking import rotracker

    path, layout, dataset, color_hw, degrees = REAL[label]
    cfg = load_config(os.path.join(ROOT, path))
    if dataset is not None:
        cfg["dataset"] = dataset
    data_dir = os.path.join(ROOT, "build", "smoke", f"layout_{label}")
    cfg["data"]["datadir"] = data_dir
    cfg["data"]["output"] = os.path.join(ROOT, "build", "smoke",
                                         f"real_{label}")
    cfg["mapping"]["bound"] = [list(b) for b in ROOM]
    cfg["mapping"]["marching_cubes_bound"] = [list(b) for b in ROOM]
    t0 = time.time()
    write_layout(cfg, layout, data_dir, REAL_FRAMES, color_hw,
                 degrees_per_frame=degrees)
    t_write = time.time() - t0
    note = ""
    if dataset == "largeindoor":
        note = (" (dataset largeindoor: the ScanNet directory structure "
                "color/, depth/, pose/*.txt with PNG colour, so the card "
                "needs no JPEG decoder)")
    print(f"[real {label}] {path}{note}: {layout} layout of {REAL_FRAMES} "
          f"frames written in {t_write:.1f} s (orbit {degrees} degrees per "
          f"frame, colour {color_hw or 'at the depth size'}); "
          f"RO.sample_range "
          f"{cfg['RO']['sample_range']}, volume {cfg['volume']['voxel_size']}"
          f" m voxels, cam {cfg['cam']['W']}x{cfg['cam']['H']} crop_edge "
          f"{cfg['cam']['crop_edge']} crop_size "
          f"{cfg['cam'].get('crop_size')} distortion "
          f"{cfg['cam'].get('distortion')}", flush=True)

    t0 = time.time()
    slam = RemixFusionTorch(cfg, device="cuda")
    slam.preload(REAL_FRAMES)
    t_setup = time.time() - t0
    iters = int(cfg["RO"]["particle_iter_lens"])
    captured = []
    kernel = rotracker.brick_eval_volume

    def capture(params, pix, base, tsdf, layout_, table, interp):
        captured.append((params, pix, base, tsdf, layout_, table))
        del captured[:-iters]
        return kernel(params, pix, base, tsdf, layout_, table,
                      interp=interp)

    rotracker.brick_eval_volume = capture
    try:
        be.brick_eval_volume.launches = 0
        t0 = time.time()
        out = slam.run()
        t_run = time.time() - t0
        launches = be.brick_eval_volume.launches
    finally:
        rotracker.brick_eval_volume = kernel
    print(f"[real {label}] frames={out['frames']} tracked="
          f"{out['tracked_frames']} ms_per_frame={out['ms_per_frame']} "
          f"(host clock over {out['timed_frames']} frames, ending in "
          f"torch.cuda.synchronize) ms_per_round={out['ms_per_round']} "
          f"rounds={out['mapping_rounds']} first_frame_mapping_ms="
          f"{out['first_frame_mapping_ms']} ate_rmse_cm={out['ate_rmse_cm']}"
          f" ate_rmse_cm_ro_only={out['ate_rmse_cm_ro_only']} "
          f"launches={{'brick_eval': {launches}}} mesh_faces="
          f"{out['mesh_faces']} mesh_cull_faces={out['mesh_cull_faces']} "
          f"wall: write {t_write:.1f} s, set-up + load {t_setup:.1f} s, "
          f"run {t_run:.1f} s", flush=True)
    if out["frames"] != REAL_FRAMES:
        fail(f"real {label}: the loader gave {out['frames']} frames, "
             f"expected {REAL_FRAMES}")
    if launches != iters * out["tracked_frames"]:
        fail(f"real {label}: brick_eval launched {launches} times, expected "
             f"{iters * out['tracked_frames']}")
    for key in ("ate_rmse_cm_ro_only", "ate_rmse_cm"):
        if not out[key] <= REAL_ATE_BAR_CM:
            fail(f"real {label}: {key} {out[key]} cm > {REAL_ATE_BAR_CM}")
    if not out["mapping_rounds"] > 0:
        fail(f"real {label}: no mapping round ran")
    n = out["frames"]
    if not (np.isfinite(slam.RO_c2w_data[:n]).all()
            and np.isfinite(slam.trajectory(n)).all()):
        fail(f"real {label}: non-finite pose")
    if not out["mesh_faces"] > 0:
        fail(f"real {label}: empty mesh")
    out["wall_s"] = t_write + t_setup + t_run
    return slam, out, launches, captured


def perturbed_tier_cases(captured):
    """One capture per tier shape (C, P) among a frame's calls; each must
    hold expected tsdf values of 1.0 and below 0 on its valid pixels."""
    cases = {}
    for args in captured:
        pix, table = args[1], args[5]
        key = (table.shape[1], pix.shape[0])
        if key not in cases:
            gt = pix[pix[:, 7] > 0, 3]
            if not (bool((gt == 1.0).any()) and bool((gt < 0).any())):
                fail(f"real scannet: tier C={key[0]} P={key[1]} has no "
                     f"expected tsdf of 1.0 or none below 0")
            cases[key] = args
    return [cases[k] for k in sorted(cases, reverse=True)]


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "remixfusion_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository (the "
              "remixfusion_tpu_torch package is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    wall = {}
    t0 = time.time()
    phase_build()
    wall["build"] = time.time() - t0
    t0 = time.time()
    slam, out_a, launches_a = phase_slice(torch, "A")
    wall["slice A"] = time.time() - t0
    t0 = time.time()
    phase_mesh(slam, out_a, "A")
    wall["mesh A"] = time.time() - t0
    t0 = time.time()
    brick = phase_kernels(torch, slam, out_a["frames"])
    wall["kernel brick_eval"] = time.time() - t0
    del slam
    torch.cuda.empty_cache()

    t0 = time.time()
    slam, out_b, launches_b, captured = slice_b_captured(torch)
    wall["slice B"] = time.time() - t0
    t0 = time.time()
    phase_mesh(slam, out_b, "B")
    wall["mesh B"] = time.time() - t0
    t0 = time.time()
    hashk = phase_hash_kernel(torch, captured)
    wall["kernel hash_table_grad"] = time.time() - t0
    del slam, captured
    torch.cuda.empty_cache()

    real_launches = {}
    for label in REAL:
        t0 = time.time()
        slam, out_r, real_launches[label], tiers = phase_real(torch, label)
        if label == "scannet":
            for args in perturbed_tier_cases(tiers):
                brick["shapes"] += check_brick_case(torch, args,
                                                    "real scannet")
        wall[f"real {label}"] = time.time() - t0
        del slam, tiers
        torch.cuda.empty_cache()

    brick["launches"] = launches_a["brick_eval"]
    brick["launches_by_slice"] = {"A": launches_a["brick_eval"],
                                  "B": launches_b["brick_eval"],
                                  **{f"real {k}": v
                                     for k, v in real_launches.items()}}
    hashk["launches"] = launches_b["hash_table_grad"]
    hashk["launches_by_slice"] = {"A": launches_a["hash_table_grad"],
                                  "B": launches_b["hash_table_grad"]}
    print(json.dumps({"phase_wall_s": wall}), flush=True)
    print(json.dumps({"kernels": [brick, hashk]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
