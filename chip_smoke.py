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
     N_FRAMES["A"] frames (the one cut): first-frame mapping, tracking, a
     mapping round every 5 frames. Kernel launch counts are zeroed just
     before and read just after: brick_eval launched 20 times per tracked
     frame, hash_table_grad never; RO-only and full ATE below 2 cm. The
     run ends in finalize, outside the timed loop: mesh.ply (the residual
     field's SDF and weight queried on the card over the dense 3 cm grid
     of the 4 m marching-cubes bound, 134^3 = 2.41 M points; marching
     tetrahedra on the host) and mesh_cull_occlusion.ply. Then the grid's
     bf16 query mirror (the hot query's read on every map, BA and render
     step, as in the JAX package): bitwise the rounding of the grid;
     query_color_sdf on MIRROR_POINTS points near the last frame's surface
     within MIRROR_TOL of a CPU copy of the scene (grid, mirror and
     parameters); the mirror's query against the float32 grid's within
     MIRROR_REL (2^-8, bf16's unit roundoff) of the corners' blended
     magnitudes; the mirror's bytes and the largest gap printed in a
     {"mirror": ...} line;
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
  3b. render (after phase 3 and the mode checks of phase 10, on slice
     A's finished pipeline, at 640x480): tools/rendering_eval.
     calc_2d_metric over frames 0, 10, .., 50 with the run's poses and
     each frame's depth as the target (307,200 rays x 59 samples a
     frame): one {"render": ...} JSON line with PSNR,
     SSIM, the perceptual distance and its kind, depth-L1, the render ms per
     frame (host clock, ending in torch.cuda.synchronize) and the chunk
     size; a fixed RENDER_SUBSET-ray subset of frame 50 rendered on the
     card and on a CPU copy of the scene with the same perturbation draws,
     rgb and depth within RENDER_TOL; render_img of frame 50 read back as a
     2 x 3 grid of 120x160 panels. Launch counts are zeroed before and read
     after (rendering launches no kernel of the main path);
  3c. sharded (after 3b, on slice A's finished pipeline): the scale-out
     path (remixfusion_tpu_torch/parallel/, ROTracker(group=...)) in two
     worlds on the one card, SHARDED_WORLDS: 2 ranks over gloo (NCCL
     refuses two ranks on one card: a 2-rank NCCL world is started first
     and must fail with "Duplicate GPU detected") and 1 rank over NCCL.
     Each rank (parallel/launch.spawn, file rendezvous, a time limit)
     zeroes its launch counts, then: candidate-sharded tier costs of slice
     A's last frame (a rank's slice of 10240 / 3072 / 1024 candidates, the
     identity column ahead on every rank but the first) and do_tracking
     from the previous RO pose, and again with RO.sample_range SHIFT_RANGE
     and the ray-shift generator seeded SHIFT_SEED + rank (the tracker
     broadcasts rank 0's generator state before the draw); the
     slab-sharded fusion of that frame into
     the 200^3 grid; SHARDED_TIMED_STEPS data-parallel map steps (SGD) and
     as many grid-sharded ones on bench_hashgrid.yaml's scene (seed 0,
     frame 0 fused, mapping.sample rays of frame 0, a seeded stratified
     draw; the grid-sharded scene holds no grid); the interleaved dataflow
     (parallel/dryrun.interleaved_dataflow) over SHARDED_FRAMES frames of
     synthetic_bench.yaml with a DP map step every SHARDED_MAP_EVERY. Held
     against one process on the card: the gathered costs bitwise the
     single-process kernel's (a rank's slice launches with the whole
     table's pixel split, brick_eval_volume's split_for) and within phase
     3's tolerance of the plain version's, the same on every rank; the
     poses within POSE_TOL, the shifted one of the single process's from
     SHIFT_SEED (and more than POSE_TOL off its pose from SHIFT_SEED + 1);
     the concatenated slabs (fused by sharded_fuse_pack_gbq) bitwise
     integrate_global's grid and weights and their bf16 mirrors bitwise its
     rounding; the slab query bitwise query_gbv and the slabs' mirror
     query bitwise query_gbq (and not the float32 query's bits); the map
     steps read the mirror on both sides; the first map step's
     parameters within STEP_RTOL / STEP_ATOL (tests/test_sharding.py's),
     each parameter's update within STEP_UPDATE_REL of the largest entry
     of the single-process update (a step moves the hash table by ~1e-8,
     far inside STEP_ATOL), and its loss within 1e-4; each rank's brick_eval launched 20 times
     per tracked frame and hash_table_grad once per map step, and
     hash_table_grad on the rank's own inputs within phase 5's tolerance
     of its plain version; the dataflow's RO-only ATE below 2 cm. Printed:
     the backends and why, the per-rank shapes, ms per map step against
     one process (the steps after the first), ms per dataflow frame and
     the collective bytes per step. Then brick_eval at a rank's slice
     (C/2 + 1 candidates) and hash_table_grad at a rank's half of the
     batch, checked and timed as in phases 3 and 5;
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
  7b. bench corridor: `python3 bench_torch.py --config
     configs/Synthetic/synthetic_corridor.yaml` in a child process, uncut:
     the JAX package's large-scale record's own command (BASELINE.md:
     876-899) at the config's full width, the whole 800-frame walk (30
     warm-up frames, mapping.first_iters 100, a 400 x 160 x 400 volume at
     2.5 cm, far 8, PST tiers 10240/3072/1024 x 20 iterations, CPGrid, the
     4 cm mesh scored by mesh_quality). Its preload renders the walk into
     the disk render cache that every later corridor phase reads. The bars
     are a broken run's: 799 tracked frames, brick_eval launched 20 times
     per tracked frame (15,980) and hash_table_grad never, a mapping round,
     bench.py's four-key last line, full and RO-only ATE below
     CORRIDOR_BENCH_ATE_BAR_CM, both meshes non-empty inside the bound +-
     CORRIDOR_MESH_PAD, every pose finite. Printed beside the JAX record
     (CORRIDOR_RECORD), with no bar: the ATE over the first 100, 200, ..,
     800 frames, the mesh scores, the re-centre and keyframe counts, the
     peak memory, the frames over 1 s, fps and ms per round with the card's
     name and power limit;
  8. corridor: configs/Synthetic/synthetic_corridor.yaml at its own widths
     (the multi-room building, synthetic_large; 640x480, PST tiers
     10240/3072/1024 and 20 iterations, a 10 x 4 x 10 m moving volume at
     2.5 cm = 400 x 160 x 400 = 25.6 M voxels with brick_budget_frac 0.12,
     trunc 0.06, far 8, CPGrid, a 22 x 3 x 10 m global bound). Overridden:
     data.output, mapping.state_every 32 and the frame count,
     CORRIDOR_FRAMES = 64 of the walk's 800 (the one cut, for this
     script's time limit; phase 7 runs the whole walk), every frame read
     from the render cache [bench corridor] filled (none rendered here, as
     in phase 9). brick_eval launched 20 times per tracked frame;
     at least 3 re-centres of the moving volume (frame_to_vrange); full
     and RO-only ATE below 3 cm; resume.npz written at frame 32; mesh.ply
     and mesh_cull_occlusion.ply non-empty with every vertex inside the
     marching-cubes bound +- 0.5 m (the mesh is not scored: the analytic
     ground-truth mesh of the building at 3 cm is ~10x the room's). Then
     brick_eval against its plain version (both interpolation modes, phase
     3's tolerance) on the tier inputs captured on the first tracked frame
     after the first re-centre: the origin has moved, and the windows reach
     cells at tsdf 1.0 in the slab the re-centre cleared (inside the new
     bounds, outside the old);
  9. corridor resumed: the RO poses [0, 32] and the volume as they stood
     at the save are kept, the pipeline deleted; a fresh RemixFusionTorch
     of the same config (its own output directory) loads resume.npz: every
     array it holds is bitwise the file's, the RO rows and the volume
     bitwise the kept copies; run(resume=True) over frames 33..63:
     brick_eval launched 20 x 31 times, full and RO-only ATE below 3 cm;
     the gap to the uninterrupted run's RO-only ATE is printed;
  10. kernel checks of the other tracker modes, on slice A's last-frame
     tiers (after phase 3): the plain brick mode (RO.eval_mode brick,
     radius 2, a float32 view) against brick_eval fed the same values (the
     volume rounded through bfloat16 first), both interpolation modes; and
     gather against brick radius 2 at search size SMALL_SEARCH, where every
     moved vertex stays in its window; phase 3's tolerance. After phase 5:
     hash_table_grad against its plain version on the DenseGrid table at
     synthetic_bench.yaml's widths (4 dense levels 16^3 .. 800^3, ~522.6 M
     rows, 4.2 GB; DENSE_POINTS seeded points in [0, 1]^3 and a seeded
     output gradient), phase 5's tolerance, untouched rows exactly zero;
  11. gather: configs/Synthetic/corridor_v25g.yaml (the corridor with
     RO.eval_mode gather, a float32 track view) over GATHER_FRAMES frames,
     all read from the disk render cache [bench corridor] filled (none
     rendered here): brick_eval and hash_table_grad never launched, at
     least GATHER_MIN_RECENTRES re-centres, full and RO-only ATE below
     3 cm, meshes inside the bound;
  11b. this slice's phases, each at its config's full width with only the
     frame count cut, each ending in finalize, each printing its full and
     RO-only ATE, its launches (brick_eval's per instantiation too) and
     its wall ("[<phase>] phase wall"):
     corridor hashgrid, corridor damp, corridor gate, corridor noise: the
     corridor with the HashGrid field (corridor_hashgrid.yaml: 16 levels,
     the finer ones capped at 2^19 rows), with tracking.speed_damp 0.5
     (corridor_damp.yaml), with volume.fuse_fit_gate [0.18, 0.30]
     (corridor_gate.yaml) and under sensor noise with RO.cut_dist 4.5
     (corridor_noise.yaml, the noise drawn after the cache), each over
     VARIANT_FRAMES frames of the corridor's render cache (none rendered
     here): brick_eval launched 20 times per tracked frame, hash_table_grad
     twice per map iteration with HashGrid and never otherwise, full and
     RO-only ATE below 3 cm, meshes inside the bound, the host damp of
     every extrapolation equal to tracking.speed_damp (the port applies it
     ungated, as the JAX pipeline does), every frame's fusion weight in
     [0.05, 1] (1 without the gate; min, median and max printed), the
     re-centres printed; with HashGrid, hash_table_grad against its plain
     version and index_add_ on the inputs of the last map step (phase 5's
     check and timing) and the RO poses against [corridor]'s first
     VARIANT_FRAMES (the largest difference printed: a finding, not a
     bar); under noise the ATE beside the JAX record's drift (NOISE_RECORD);
     one {"variant": ...} JSON line each;
     f32 windows: synthetic_bench.yaml with volume.track_dtype float32, 30
     frames: every brick_eval launch through the float32-window
     instantiation (nearest/float32, 20 per tracked frame), ATE below 2
     cm, the mesh phase of 2b; the float32 kernel against its plain
     version on the last frame's tiers (phase 3's check), and against the
     bfloat16 kernel (the largest cost difference, whether the best
     candidate and the improving set change; no bar);
     720p refstride and 720p: synthetic_720p_refstride.yaml (RO.pix_ref
     null: absolute strides, tiers of 880 / 3,600 / 14,400 pixels) and
     synthetic_720p.yaml (the default pix_ref: slice A's 300 / 1,200 /
     4,800 pixels, checked), 30 frames of 1280x720 each: ATE below 2 cm,
     the mesh phase of 2b, the tiers' strides and pixels printed; with
     pix_ref null brick_eval against its plain version at those tiers;
     refine: configs/Synthetic/ab_refine.yaml's whole 40-frame sequence
     (verify_small with mapping.final_iters 200): the map steps finalize
     runs counted (200), ATE below 2 cm, the mesh phase of 2b with F1 >=
     REFINE_F1_BAR, accuracy and completion printed beside the JAX record
     (REFINE_RECORD);
  12. the other slices, at their configs' widths through RemixFusionTorch.run
     as in phase 2, each with its launch and ATE checks (below 2 cm):
     triplane (configs/Synthetic/bench_triplane.yaml, 40 frames): every
     plane and line finite, the first-frame map loss falling, then its mesh
     phase as in 2b; fast (configs/Synthetic/synthetic_fast.yaml,
     Frequency and 128-wide decoders, 40 frames): no field table, the map
     optimizer's field group empty; dense (synthetic_bench.yaml with
     volume.brick_fusion false, 30 frames: a dense 300^3 volume, tile 60,
     budget 57 of 125 tiles): brick_eval on layout (1, 300, 300), then held
     against its plain version on the last frame's tiers (phase 3's
     tolerance), and the dense fuse of that frame on the card against a
     CPU recompute on FUSE_SUBSET of the voxels it updated (tsdf within
     FUSE_TOL, weights equal), and the tiled fuse of every tile in that
     frame's frustum (no budget) on the card bitwise equal to the card's
     full sweep; brick (synthetic_bench.yaml with
     RO.eval_mode brick, brick_radius 3, tsdf_interp trilinear and
     volume.sel_reuse 2, 30 frames): brick_eval never launched, and the
     count of frames that fused a reused selection printed and above 0;
     ab_triplane (configs/Synthetic/ab_triplane.yaml, the 320x240 verify
     scene with Triplane) and more (configs/Synthetic/synthetic_more.yaml,
     Frequency with the 'more' re-centre policy), 20 frames each;
  13. render eval: configs/Synthetic/rendering_eval_example.yaml (the JAX
     package's rendering record, BASELINE.md:734-742) run whole (40 frames,
     mapping.save_ckpt) with mesh.vis RENDER_EVAL_VIS and mesh.render_img 1
     in the smoke's copy of the config (build/smoke/render_eval/): brick_eval
     launched 20 x 39 times, full and RO-only ATE below 2 cm, the mesh.vis
     frame's tracking_result.txt line, trajectory plot and render_img
     figure written; then `rendering_eval_torch.py --config <that copy>
     --gap 5` in a fresh process scores the checkpoint on the card against
     the sanity bars RENDER_BARS, printed beside the record (RENDER_TARGET)
     and the float32 read's (FLOAT32_READ_RECORD) in a {"render_eval": ...}
     line;
  14. live: LIVE_FRAMES frames of configs/Synthetic/verify_small.yaml with
     the live viewer (viz.live 1, live_every 2, live_render_every 4);
     after the run and before close(), /state.json and /frame fetched from
     127.0.0.1 with urllib: the last frame and the whole trajectory, the
     frame a BMP or JPEG at the size of a gap-8 render (30x40) or of the
     input at stride 2 (120x160), the published frames' sizes in order;
     brick_eval launched 20 times per tracked frame; after close() the
     port refuses connections;
  15. bench A and bench B (bench corridor runs as phase 7b): `python3
     bench_torch.py --config
     configs/Synthetic/{synthetic_bench,bench_hashgrid}.yaml` in a child
     process at its defaults, uncut (200 frames of the 240-degree orbit,
     30 warm-up frames, mapping.first_iters 100, the mesh block on; A
     renders the 200 frames into the disk render cache, B reads them
     from it), as a user runs the bench: exit 0 and the last line
     bench.py's four keys with fps > 0; from the child's `# result` line
     on stderr: full and RO-only ATE below 2 cm, mesh F1 (the 4 cm mesh,
     bench.py's score) >= 0.90, brick_eval launched 20 times per tracked
     frame (3,980), hash_table_grad twice per map iteration of the timed
     loop in B and never in A. Printed: fps, ms per round, the frames
     over 1 s, peak memory, the phase wall and the quality beside
     BENCH_r05.json's (BENCH_RECORD) and beside the port's before its hot
     query read the mirror (FLOAT32_READ_RECORD); the child's whole stderr
     is kept in build/smoke/bench_<A|B>.log;
  16. the kernels JSON line, a {"phase_wall_s": ...} line; the card's name
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
SYN = os.path.join(ROOT, "configs", "Synthetic")
# the slices driven through RemixFusionTorch.run: config, frames (the cut),
# the overrides besides data.output
CONFIGS = {"A": os.path.join(SYN, "synthetic_bench.yaml"),
           "B": os.path.join(SYN, "bench_hashgrid.yaml"),
           "triplane": os.path.join(SYN, "bench_triplane.yaml"),
           "fast": os.path.join(SYN, "synthetic_fast.yaml"),
           "dense": os.path.join(SYN, "synthetic_bench.yaml"),
           "brick": os.path.join(SYN, "synthetic_bench.yaml"),
           "ab_triplane": os.path.join(SYN, "ab_triplane.yaml"),
           "more": os.path.join(SYN, "synthetic_more.yaml"),
           "f32": os.path.join(SYN, "synthetic_bench.yaml"),
           "720p_refstride": os.path.join(SYN,
                                          "synthetic_720p_refstride.yaml"),
           "720p": os.path.join(SYN, "synthetic_720p.yaml"),
           "refine": os.path.join(SYN, "ab_refine.yaml")}
N_FRAMES = {"A": 60, "B": 60, "triplane": 40, "fast": 40, "dense": 30,
            "brick": 30, "ab_triplane": 20, "more": 20, "f32": 30,
            "720p_refstride": 30, "720p": 30, "refine": 40}
OVERRIDES = {
    "dense": {"volume": {"brick_fusion": False}},
    "brick": {"RO": {"eval_mode": "brick", "brick_radius": 3,
                     "tsdf_interp": "trilinear"},
              "volume": {"sel_reuse": 2}},
    "f32": {"volume": {"track_dtype": "float32"}},
}
# the printed name of a slice, where it is not "slice <label>"
TAGS = {"f32": "f32 windows", "720p_refstride": "720p refstride",
        "720p": "720p", "refine": "refine"}
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
# cut to 24 frames (from 40) for this script's time limit
REAL_FRAMES = 24
REAL_ATE_BAR_CM = 1.5
CORRIDOR = os.path.join(ROOT, "configs", "Synthetic",
                        "synthetic_corridor.yaml")
CORRIDOR_FRAMES = 64
CORRIDOR_STATE_EVERY = 32
CORRIDOR_ATE_BAR_CM = 3.0
CORRIDOR_MIN_RECENTRES = 3
CORRIDOR_MESH_PAD = 0.5
# [gather]: corridor_v25g.yaml (the corridor with RO.eval_mode gather) over
# frames [bench corridor] rendered into the disk cache
GATHER = os.path.join(SYN, "corridor_v25g.yaml")
GATHER_FRAMES = 50
GATHER_MIN_RECENTRES = 2
# the corridor's variants, each over VARIANT_FRAMES frames of the
# corridor's render cache: the HashGrid field on the corridor's 2^19 table,
# the host and device speed damp, the fitness-gated fusion, sensor noise
# (applied after the cache) with RO.cut_dist 4.5
VARIANTS = {"corridor hashgrid": os.path.join(SYN, "corridor_hashgrid.yaml"),
            "corridor damp": os.path.join(SYN, "corridor_damp.yaml"),
            "corridor gate": os.path.join(SYN, "corridor_gate.yaml"),
            "corridor noise": os.path.join(SYN, "corridor_noise.yaml")}
VARIANT_FRAMES = 60
NOISE_RECORD = ("the JAX record drifts 0.5 -> 22 cm over 325 frames of the "
                "800-frame walk (BASELINE.md:957-966)")
# [refine]: ab_refine.yaml's mesh bar and the JAX record
# (BASELINE.md:674-683: verify_small with 200 final_iters)
REFINE_F1_BAR = 0.95
REFINE_RECORD = {"accuracy_cm": 1.155, "completion_cm": 1.641, "f1": 0.9751}
# the DenseGrid table at synthetic_bench.yaml's widths (desired 200, base
# 16, 4 dense levels: 16^3, 59^3, 218^3, 800^3 rows) and the points of the
# render backward of a map step
DENSE_DESIRED = 200
DENSE_POINTS = 151040
# the search size at which every moved vertex stays in its 4^3 window
SMALL_SEARCH = 0.002
FUSE_SUBSET = 65536
FUSE_TOL = 1e-5
MESH_BOX = (-0.5, 4.5)
SDF_TOL = 1e-4
SDF_SUBSET = 65536
# slice A's bf16 query mirror: MIRROR_POINTS points within 10% of the last
# frame's depth along its rays, queried on the card and on a CPU copy of
# the scene (within MIRROR_TOL); the mirror's blend against the float32
# grid's within MIRROR_REL (bf16's unit roundoff, 8 significant bits) of
# the blend of the corners' magnitudes, plus MIRROR_SLACK for the float32
# blends' own rounding
MIRROR_POINTS = 65536
MIRROR_TOL = 1e-4
MIRROR_REL = 2.0 ** -8
MIRROR_SLACK = 1e-6
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
# [render]: slice A's frames 0, 10, ..., 50 scored; a fixed ray subset of
# frame 50 rendered on the card and on a CPU copy with the same draws
RENDER_GAP = 10
RENDER_SUBSET = 4096
RENDER_TOL = 1e-4
# [render eval]: the JAX package's rendering record (BASELINE.md:734-742:
# rendering_eval_example.yaml, checkpoint reload, every 5th frame) is the
# target; the bars are sanity bars for a broken render
RENDER_EVAL = os.path.join(SYN, "rendering_eval_example.yaml")
RENDER_EVAL_GAP = 5
RENDER_EVAL_VIS = 20
RENDER_TARGET = {"psnr": 27.83, "ssim": 0.915, "depth_l1": 0.015,
                 "rf_perceptual": 0.022}
RENDER_BARS = {"psnr": (">=", 22.0), "ssim": (">=", 0.85),
               "depth_l1": ("<=", 0.03), "rf_perceptual": ("<=", 0.06),
               "lpips": ("<=", 0.3)}
# [live]: verify_small.yaml with the live viewer
LIVE = os.path.join(SYN, "verify_small.yaml")
LIVE_FRAMES = 12
LIVE_VIZ = {"live": 1, "live_every": 2, "live_render_every": 4}
# [sharded]: the worlds (ranks on the one card; backend chosen by
# parallel/dryrun.pick_backend), the dataflow's frames and map period, a
# world's time limit, the map step's parameter tolerance (rtol, atol of
# tests/test_sharding.py), the pose tolerance and the timed extra map steps
SHARDED_WORLDS = (2, 1)
SHARDED_FRAMES = 10
SHARDED_MAP_EVERY = 5
SHARDED_TIMEOUT_S = 420
STEP_RTOL, STEP_ATOL = 2e-3, 2e-5
STEP_UPDATE_REL = 1e-3
POSE_TOL = 1e-5
SHIFT_RANGE, SHIFT_SEED = 0.1, 100
SHARDED_TIMED_STEPS = 6
# [bench corridor] / [bench A] / [bench B]: bench_torch.py uncut on the
# corridor (the JAX package's large-scale record) and the two main-path
# configs, each with its time limit; BENCH_r05.json's chip-independent
# quality digits (the JAX bench's record on synthetic_bench.yaml, the
# target of A and B)
BENCH = {"corridor": CORRIDOR,
         "A": os.path.join(SYN, "synthetic_bench.yaml"),
         "B": os.path.join(SYN, "bench_hashgrid.yaml")}
BENCH_TIMEOUT_S = {"corridor": 900, "A": 480, "B": 480}
BENCH_RECORD = {"ate_rmse_cm": 1.030, "ate_rmse_cm_ro_only": 1.019,
                "f1": 0.976, "accuracy_cm": 1.197, "completion_cm": 1.884}
# [bench corridor]'s bars are those of a broken run, not a quality
# judgement: a runaway tracker reads metres. CORRIDOR_RECORD is the JAX
# package's official 800-frame record (BASELINE.md:876-899, the shipped
# brick/pallas mode; the gather-mode run completes at 39.6 cm), printed
# beside the run's numbers with no bar
CORRIDOR_BENCH_ATE_BAR_CM = 100.0
CORRIDOR_RECORD = {"ate_rmse_cm": 59.14, "ate_rmse_cm_ro_only": 59.10,
                   "accuracy_cm": 13.3, "completion_cm": 21.5, "f1": 0.41,
                   "frames_per_recentre": 14, "gather_ate_rmse_cm": 39.6}
# the port before its hot query read the bf16 mirror (its hot query read
# the float32 grid): this script's numbers on the parent commit, on an
# H100 80GB HBM3 at 700 W (PERF.md section 6, PR 14); printed beside
# [bench A], [bench B] and [render eval], no bar
FLOAT32_READ_RECORD = {
    "bench A": {"ate_rmse_cm": 0.9434, "ate_rmse_cm_ro_only": 0.9717,
                "f1": 0.9740},
    "bench B": {"ate_rmse_cm": 0.9712, "ate_rmse_cm_ro_only": 0.9717,
                "f1": 0.9714},
    "render eval": {"psnr": 27.787, "ssim": 0.9234}}


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


def slice_config(label):
    """The slice's config with data.output and OVERRIDES[label] set."""
    from remixfusion_tpu_torch.config import load_config

    cfg = load_config(CONFIGS[label])
    cfg["data"]["output"] = os.path.join(ROOT, "build", "smoke", label)
    for sec, vals in OVERRIDES.get(label, {}).items():
        cfg[sec].update(vals)
    return cfg


def count_dense_fusions(slam, counts):
    """Count, in `counts`, the dense volume's frames fused on frustum tiles
    and with the full sweep (frame_tiles' decision, wrapped)."""
    frame_tiles = slam.mv.frame_tiles

    def counted(*args):
        tiles = frame_tiles(*args)
        key = "full sweep" if tiles is None else "tiled"
        counts[key] = counts.get(key, 0) + 1
        return tiles

    slam.mv.frame_tiles = counted


def tag_of(label):
    return TAGS.get(label, f"slice {label}")


def phase_slice(torch, label, hook=None):
    """Drive slice `label` through RemixFusionTorch.run with every kernel's
    launch count zeroed just before and read just after: brick_eval
    launched 20 times per tracked frame in eval_mode pallas and never
    otherwise, hash_table_grad twice per map iteration with a hash-grid
    field and never otherwise. hook(slam), when given, runs before."""
    import numpy as np

    from remixfusion_tpu_torch.models.encodings import HashGridEncoding
    from remixfusion_tpu_torch.ops import brick_eval as be
    from remixfusion_tpu_torch.ops import hash_enc as he
    from remixfusion_tpu_torch.slam import RemixFusionTorch

    cfg = slice_config(label)
    frames = N_FRAMES[label]
    t0 = time.time()
    slam = RemixFusionTorch(cfg, device="cuda")
    slam.preload(frames + 1)
    tag = tag_of(label)
    print(f"[{tag}] {os.path.relpath(CONFIGS[label], ROOT)} "
          f"overrides {OVERRIDES.get(label, {})}: grid.enc "
          f"{cfg['grid']['enc']}, RO.eval_mode {slam.tracker.eval_mode} "
          f"(brick_radius {slam.tracker.brick_r}, "
          f"{slam.tracker.tsdf_interp}, track view "
          f"{slam.tracker.track_dtype}), volume {slam.mv.dims} layout "
          f"{slam.mv.brick_layout()}; {frames} frames; set-up (seed fusion, "
          f"{frames + 1} frames rendered) {time.time() - t0:.1f} s",
          flush=True)
    fusions = {}
    if not slam.mv.brick:
        count_dense_fusions(slam, fusions)
    if hook is not None:
        hook(slam)
    torch.cuda.reset_peak_memory_stats()
    be.brick_eval_volume.launches = 0
    be.brick_eval_volume.launches_by_kind.clear()
    he.hash_table_grad.launches = 0
    out = slam.run(max_frames=frames)
    out["dense_fusions"] = fusions
    launches = {"brick_eval": be.brick_eval_volume.launches,
                "hash_table_grad": he.hash_table_grad.launches,
                "brick_eval_by_kind": dict(
                    be.brick_eval_volume.launches_by_kind)}
    peak = torch.cuda.max_memory_allocated()
    iters = int(cfg["RO"]["particle_iter_lens"])
    ffl = slam.first_frame_losses
    print(f"[{tag}] frames={out['frames']} tracked="
          f"{out['tracked_frames']} ms_per_frame={out['ms_per_frame']} "
          f"(host clock over {out['timed_frames']} frames with "
          f"{out['timed_rounds']} mapping rounds, ending in "
          f"torch.cuda.synchronize) ms_per_round={out['ms_per_round']} "
          f"rounds={out['mapping_rounds']} first_frame_mapping_ms="
          f"{out['first_frame_mapping_ms']} ate_rmse_cm={out['ate_rmse_cm']} "
          f"ate_rmse_cm_ro_only={out['ate_rmse_cm_ro_only']} "
          f"map_iters={out['map_iters']} ba_iters={out['ba_iters']} "
          f"launches={launches} max_memory_allocated={peak}"
          + (f" dense fusions {fusions}" if fusions else ""), flush=True)
    print(f"[{tag}] first-frame map loss every 25 iterations: "
          f"{[float(v) for v in ffl[::25]]} last {float(ffl[-1])}",
          flush=True)
    want = (iters * out["tracked_frames"]
            if slam.tracker.eval_mode == "pallas" else 0)
    if launches["brick_eval"] != want:
        fail(f"slice {label}: brick_eval launched {launches['brick_eval']} "
             f"times, expected {want}")
    want = (2 * out["map_iters"]
            if isinstance(slam.scene.embed_res_fn, HashGridEncoding) else 0)
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


def check_mirror(torch, slam, frames):
    """Slice A's bf16 query mirror after its run, on the card: bitwise the
    rounding of the float32 grid; query_color_sdf on MIRROR_POINTS points
    near the last frame's surface within MIRROR_TOL of a CPU copy of the
    scene (grid, mirror and parameters); the mirror's blend against the
    float32 grid's within MIRROR_REL of the blend of the corners'
    magnitudes (+ MIRROR_SLACK). Returns the record."""
    import numpy as np

    from remixfusion_tpu_torch.models.scene_rep import CORNERS
    from remixfusion_tpu_torch.utils.convert import scene_from_numpy, \
        scene_to_numpy

    t0 = time.time()
    scene = slam.scene
    if scene.gbq is None or scene.gbq.dtype != torch.bfloat16:
        fail("slice A: the scene holds no bf16 query mirror")
    if not torch.equal(scene.gbq, scene.gbv.to(torch.bfloat16)):
        fail("slice A: the mirror is not the rounding of the grid")
    f = slam.dataset[frames - 1]
    depth = np.asarray(f["depth"], np.float32).reshape(-1)
    rng = np.random.default_rng(0)
    idx = rng.choice(np.flatnonzero(depth > 0), MIRROR_POINTS,
                     replace=False)
    z = depth[idx] * rng.uniform(0.9, 1.1, MIRROR_POINTS).astype(np.float32)
    c2w = np.asarray(f["c2w"], np.float32)
    dirs = np.asarray(f["direction"], np.float32).reshape(-1, 3)[idx]
    world = (dirs @ c2w[:3, :3].T) * z[:, None] + c2w[:3, 3]
    pts = scene.normalize(torch.as_tensor(world, device=slam.device))
    with torch.no_grad():
        joint = scene.query_color_sdf(pts)
        hot = scene.query_gbq(pts)
        f32 = scene.query_gbv(pts)
        R = scene.gbv_resolution
        pos = pts * R
        low = torch.clamp(torch.floor(pos), 0, R - 2)
        frac = torch.clamp(pos - low, 0.0, 1.0)
        li = low.long()
        base = li[:, 0] * R * R + li[:, 1] * R + li[:, 2]
        mag = scene.gbv.reshape(-1, 4)[base[:, None]
                                       + scene.corner_off].abs()
        w = torch.stack([(frac[:, 0] if dx else 1 - frac[:, 0])
                         * (frac[:, 1] if dy else 1 - frac[:, 1])
                         * (frac[:, 2] if dz else 1 - frac[:, 2])
                         for dx, dy, dz in CORNERS], 1)
        scale = (w[:, :, None] * mag).sum(1)
    gap = (hot - f32).abs()
    over = gap - (MIRROR_REL * scale + MIRROR_SLACK)
    if not bool((over <= 0).all()):
        fail(f"slice A: the mirror's query is off the float32 grid's by "
             f"{float(over.max())} beyond {MIRROR_REL} of the corners' "
             f"blended magnitude")
    params, buffers = scene_to_numpy(scene)
    cpu = scene_from_numpy(slam.config, slam.bound, slam.num_kf, params,
                           buffers, device="cpu")
    if not torch.equal(cpu.gbq, scene.gbq.cpu()):
        fail("slice A: the CPU copy's mirror is not the card's")
    with torch.no_grad():
        ref = cpu.query_color_sdf(pts.cpu())
    err = float((joint.cpu() - ref).abs().max())
    if not err <= MIRROR_TOL:
        fail(f"slice A: query_color_sdf through the mirror differs from "
             f"the CPU recompute by {err} > {MIRROR_TOL}")
    rec = {"mirror_bytes": scene.gbq.numel() * scene.gbq.element_size(),
           "points": MIRROR_POINTS, "query_color_sdf_cpu_max_abs_err": err,
           "mirror_vs_float32_max_abs": float(gap.max()),
           "mirror_vs_float32_max_rel": float(
               (gap / scale.clamp(min=1e-30)).max()),
           "changed_fraction": float((gap > 0).any(1).float().mean()),
           "wall_s": time.time() - t0}
    print(f"[slice A] bf16 query mirror: {rec['mirror_bytes']} B "
          f"({tuple(scene.gbq.shape)} bfloat16), bitwise the grid's "
          f"rounding; query_color_sdf on {MIRROR_POINTS} points vs the CPU "
          f"recompute max|d|={err:.3e} (tol {MIRROR_TOL}); mirror vs float32 "
          f"grid query max|d|={rec['mirror_vs_float32_max_abs']:.3e}, max "
          f"{rec['mirror_vs_float32_max_rel']:.3e} of the corners' blended "
          f"magnitude (bound {MIRROR_REL:.3e}), "
          f"{rec['changed_fraction']:.3f} of the points moved; "
          f"{rec['wall_s']:.1f} s", flush=True)
    print(json.dumps({"mirror": rec}), flush=True)
    return rec


def phase_mesh(slam, out, label, f1_bar=F1_BAR):
    """The end-of-run mesh of slice `label`: files and bounds, the card's
    SDF grid against a CPU recompute, and the mesh quality (F1 at least
    f1_bar)."""
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
    if not q["f1"] >= f1_bar:
        fail(f"slice {label}: mesh F1 {q['f1']} < {f1_bar}")
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
        cases.append((params, pix, base, slam.mv.state.tsdf.reshape(
            -1, tr.brick_layout[0] ** 3), tr.brick_layout, tr.pst_t[cls][0]))
    return cases


def check_brick_case(torch, args, phase, split_for=None,
                     track_dtype="bfloat16"):
    """brick_eval_volume against its plain version on one tier's inputs,
    in both interpolation modes: same bits on a second call, the same
    guard positions, max |d| < TOL_MAX and mean < TOL_MEAN; then its
    device and call times, the plain version's and the bound. split_for
    and track_dtype: brick_eval_volume's (a rank's slice of a table; the
    instantiation that scores the windows rounded through bfloat16 or as
    float32)."""
    from remixfusion_tpu_torch.ops import brick_eval as be

    params, pix, base, tsdf, layout, table = args
    C, P = table.shape[1], pix.shape[0]
    windows = be.fetch_windows(tsdf, layout, base, track_dtype)
    kw = {"split_for": split_for, "track_dtype": track_dtype}
    shapes = []
    for interp in ("nearest", "trilinear"):
        got = be.brick_eval_volume(*args, interp=interp, **kw)
        again = be.brick_eval_volume(*args, interp=interp, **kw)
        ref = be.brick_eval_volume_reference(*args, interp=interp,
                                             track_dtype=track_dtype)
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
            *args, interp=interp, **kw), 200, 20)
        p_ms = time_cuda(torch, lambda: be.brick_eval_volume_reference(
            *args, interp=interp, track_dtype=track_dtype), 20, 3)
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
            "track_dtype": track_dtype,
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
        print(f"[kernel] brick_eval ({phase}) C={C} P={P} {interp} "
              f"{track_dtype} windows: "
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
        "max_abs_err": max(s["max_abs_err"] for s in main),
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


def phase_hash_kernel(torch, captured, table="HashGrid", n_graph=50):
    """hash_table_grad against its plain version on each captured call
    (enc, x, grad_out, n_rows): at the shapes of slice B's last map step
    (the render points' backward and the smoothness points'), or on the
    DenseGrid table. Returns the shapes' records."""
    from remixfusion_tpu_torch.ops import hash_enc as he

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
                    n_graph, 5)
        p_ms = time_cuda(torch, lambda: he.hash_table_grad_reference(
            enc, x, g, n_rows), 10, 2)
        lib_t = measure(torch, library, n_graph, 5)
        # bytes: x and grad_out read once, the table gradient written once;
        # operations: ~34 FP32 per (point, level) for positions and
        # weights, 4 per corner for its weight and float2 contribution
        nbytes = 4 * (n * 3 + n * L * 2) + 4 * n_rows * 2
        ops = n * L * (34 + 8 * 4)
        t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
        shapes.append({
            "table": table, "N": n, "levels": L, "rows": n_rows,
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
        print(f"[kernel] hash_table_grad ({table}) N={n} L={L} "
              f"rows={n_rows}: "
              f"max|d|={err:.3e} (max|ref| {scale:.3e}) device "
              f"{t['device_ms']:.4f} ms, call {t['call_ms']:.4f} ms, "
              f"plain {p_ms:.4f} ms, index_add_ {lib_t['call_ms']:.4f} ms "
              f"(device {lib_t['device_ms']:.4f}), bound "
              f"{max(t_ops, t_bytes):.4f} ms ({int(mask.sum())} rows "
              f"touched)", flush=True)
        del ref, mask, idx, w, vals
        torch.cuda.empty_cache()
    return shapes


def hash_kernel_record(shapes):
    """The kernels-line record of hash_table_grad: the means and the
    largest error over slice B's shapes, every shape listed (the DenseGrid
    table's error under its own entry)."""
    main = [s for s in shapes if s["table"] == "HashGrid"]
    mean = lambda k: sum(s[k] for s in main) / len(main)  # noqa: E731
    return {
        "name": "hash_table_grad", "route": "cuda",
        "source": "remixfusion_tpu_torch/csrc/hash_enc.cu",
        "replaces": "remixfusion_tpu/ops/pallas/hash_enc.py:139",
        "ms": mean("device_ms"), "device_ms": mean("device_ms"),
        "call_ms": mean("call_ms"), "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"), "bound_by": main[0]["bound_by"],
        "max_abs_err": max(s["max_abs_err"] for s in main),
        "library_ms": mean("library_ms"), "shapes": shapes,
    }


def slice_b_captured(torch):
    """phase_slice of slice B, keeping the inputs of its last two
    table-gradient calls (its last map step: render points, then smoothness
    points)."""
    with HashCalls(keep=2) as hc:
        slam, out, launches = phase_slice(torch, "B")
    return slam, out, launches, list(hc.calls)


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

    def capture(params, pix, base, tsdf, layout_, table, **kw):
        captured.append((params, pix, base, tsdf, layout_, table))
        del captured[:-iters]
        return kernel(params, pix, base, tsdf, layout_, table, **kw)

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


def corridor_config(output):
    """synthetic_corridor.yaml with data.output, mapping.state_every and
    nothing else overridden."""
    from remixfusion_tpu_torch.config import load_config

    cfg = load_config(CORRIDOR)
    cfg["data"]["output"] = os.path.join(ROOT, "build", "smoke", output)
    cfg["mapping"]["state_every"] = CORRIDOR_STATE_EVERY
    return cfg


def meshes_in_bound(paths, bound, label):
    """(verts, faces) of each PLY of `paths`; fails unless each is
    non-empty with every vertex finite and inside `bound` [3, 2] +-
    CORRIDOR_MESH_PAD."""
    import numpy as np

    from remixfusion_tpu_torch.utils.meshio import read_ply

    lo = bound[:, 0] - CORRIDOR_MESH_PAD
    hi = bound[:, 1] + CORRIDOR_MESH_PAD
    counts = []
    for path in paths:
        v, f = read_ply(path)
        if v is None or f is None or not len(v) or not len(f):
            fail(f"{label}: {path} is empty")
        if not (np.isfinite(v).all() and (v >= lo).all()
                and (v <= hi).all()):
            fail(f"{label}: {path} has vertices outside the "
                 f"marching-cubes bound +- {CORRIDOR_MESH_PAD} m")
        counts.append((len(v), len(f)))
    return counts


def check_corridor_meshes(out, slam, label):
    raw, culled = meshes_in_bound([out["mesh_path"], out["mesh_cull_path"]],
                                  slam.mc_bound, label)
    print(f"[{label}] mesh.ply {raw} and mesh_cull_occlusion.ply {culled} "
          f"(verts, faces) inside the bound; stage ms: query "
          f"{out['mesh_query_ms']:.1f}, marching "
          f"{out['mesh_marching_ms']:.1f}, write {out['mesh_write_ms']:.1f}"
          f", cull {out['mesh_cull_ms']:.1f}", flush=True)


def cleared_window_cells(torch, be, case, shift, dims):
    """Cells at tsdf 1.0 in the 4^3 windows of one captured tier call whose
    voxel lies inside the volume now and outside it before the re-centre
    (the slab the re-centre cleared): `shift` the origin's move in voxels
    (new - old), `dims` the volume's shape."""
    base, tsdf, layout = case[2:5]
    ones = be.fetch_windows(tsdf, layout, base) == 1.0
    d = torch.arange(be.BRICK_SIDE, device=base.device)
    off = torch.stack(torch.meshgrid(d, d, d, indexing="ij"), -1).reshape(
        1, be.BRICK_CELLS, 3)
    vox = base[:, None, :].to(torch.int64) + off
    dims_t = torch.tensor(dims, device=base.device)
    old = vox + torch.tensor(shift, device=base.device)
    inside_new = ((vox >= 0) & (vox < dims_t)).all(-1)
    outside_old = ((old < 0) | (old >= dims_t)).any(-1)
    return int((ones & inside_new & outside_old).sum())


def phase_corridor(torch):
    """[corridor]: CORRIDOR_FRAMES of synthetic_corridor.yaml through
    RemixFusionTorch.run with brick_eval's count zeroed just before and read
    just after, a resume state written at frame CORRIDOR_STATE_EVERY.
    Returns (stats, launches, what was kept at the save: RO rows, the
    volume state, the checkpoint's path; the tier inputs captured on the
    first tracked frame after the first re-centre)."""
    import numpy as np

    from remixfusion_tpu_torch.ops import brick_eval as be
    from remixfusion_tpu_torch.ops import hash_enc as he
    from remixfusion_tpu_torch.slam import RemixFusionTorch
    from remixfusion_tpu_torch.tracking import rotracker

    cfg = corridor_config("corridor")
    require_cached(cfg, CORRIDOR_FRAMES + 1, "corridor")
    t0 = time.time()
    slam = RemixFusionTorch(cfg, device="cuda")
    origin0 = slam.mv.vol_bnds[:, 0].copy()
    rendered = slam.dataset.render_missing(range(CORRIDOR_FRAMES + 1))
    slam.preload(CORRIDOR_FRAMES + 1)
    t_setup = time.time() - t0
    if rendered:
        fail(f"corridor: {rendered} frames rendered, expected none")
    dims, vs = slam.mv.dims, slam.mv.voxel_size
    print(f"[corridor] {os.path.relpath(CORRIDOR, ROOT)}: "
          f"{cfg['dataset']}, {slam.dataset.W}x{slam.dataset.H}, volume "
          f"{dims} = {int(np.prod(dims))} voxels at {vs} m, PST "
          f"{cfg['RO']['PST_size']}, {cfg['RO']['particle_iter_lens']} "
          f"iterations, far {cfg['cam']['far']}, {cfg['grid']['enc']}, "
          f"bound {cfg['mapping']['bound']}; {CORRIDOR_FRAMES} of "
          f"{slam.dataset.num_frames} frames; set-up (seed fusion, "
          f"{CORRIDOR_FRAMES + 1} frames read from the render cache "
          f"[bench corridor] filled, 0 rendered) {t_setup:.1f} s",
          flush=True)

    iters = int(cfg["RO"]["particle_iter_lens"])
    kept, captured, armed = {}, [], {}
    save_state, check_move = slam.save_state, slam.mv.check_move

    def keep_at_save(path):
        ms = save_state(path)
        kept.update(path=path, tracking_idx=slam.tracking_idx,
                    ro=slam.RO_c2w_data[:slam.tracking_idx + 1].copy(),
                    state=tuple(t.clone() for t in slam.mv.state))
        return ms

    def arm_on_recentre(cur_id, c2w):
        moved = check_move(cur_id, c2w)
        if moved and "frame" not in armed:
            armed["frame"] = cur_id
        return moved

    kernel = rotracker.brick_eval_volume

    def capture(params, pix, base, tsdf, layout, table, **kw):
        if "frame" in armed and len(captured) < iters:
            if "tsdf" not in armed:
                armed["tsdf"] = tsdf.clone()
                armed["origin"] = slam.mv.vol_bnds[:, 0].copy()
            captured.append((params.clone(), pix.clone(), base.clone(),
                             armed["tsdf"], layout, table))
        return kernel(params, pix, base, tsdf, layout, table, **kw)

    slam.save_state = keep_at_save
    slam.mv.check_move = arm_on_recentre
    rotracker.brick_eval_volume = capture
    try:
        be.brick_eval_volume.launches = 0
        he.hash_table_grad.launches = 0
        t0 = time.time()
        out = slam.run(max_frames=CORRIDOR_FRAMES)
        t_run = time.time() - t0
        launches = {"brick_eval": be.brick_eval_volume.launches,
                    "hash_table_grad": he.hash_table_grad.launches}
    finally:
        rotracker.brick_eval_volume = kernel
    recentres = len(slam.mv.frame_to_vrange)
    at = sorted(s for s, _ in slam.mv.frame_to_vrange)[1:] + [
        slam.mv.start_id]
    print(f"[corridor] frames={out['frames']} tracked="
          f"{out['tracked_frames']} ms_per_frame={out['ms_per_frame']} "
          f"(host clock over {out['timed_frames']} frames, ending in "
          f"torch.cuda.synchronize, state saves excluded) ms_per_round="
          f"{out['ms_per_round']} rounds={out['mapping_rounds']} "
          f"first_frame_mapping_ms={out['first_frame_mapping_ms']} "
          f"ate_rmse_cm={out['ate_rmse_cm']} ate_rmse_cm_ro_only="
          f"{out['ate_rmse_cm_ro_only']} launches={launches} "
          f"recentres={recentres} at frames {at} "
          f"state_save_ms={out['state_save_ms']} "
          f"wall: set-up {t_setup:.1f} s, run {t_run:.1f} s", flush=True)
    if launches != {"brick_eval": iters * out["tracked_frames"],
                    "hash_table_grad": 0}:
        fail(f"corridor: launches {launches}, expected brick_eval "
             f"{iters * out['tracked_frames']} and hash_table_grad 0 "
             f"(CPGrid)")
    if recentres < CORRIDOR_MIN_RECENTRES:
        fail(f"corridor: {recentres} re-centres, expected at least "
             f"{CORRIDOR_MIN_RECENTRES}")
    for key in ("ate_rmse_cm_ro_only", "ate_rmse_cm"):
        if not out[key] < CORRIDOR_ATE_BAR_CM:
            fail(f"corridor: {key} {out[key]} cm >= {CORRIDOR_ATE_BAR_CM}")
    n = out["frames"]
    if not (np.isfinite(slam.RO_c2w_data[:n]).all()
            and np.isfinite(slam.trajectory(n)).all()):
        fail("corridor: non-finite pose")
    if (kept.get("tracking_idx") != CORRIDOR_STATE_EVERY
            or len(out["state_save_ms"]) != 1
            or not os.path.exists(kept["path"])):
        fail(f"corridor: resume.npz not written at frame "
             f"{CORRIDOR_STATE_EVERY} (saves {out['state_save_ms']}, "
             f"kept {kept.get('tracking_idx')})")
    check_corridor_meshes(out, slam, "corridor")

    if len(captured) != iters:
        fail(f"corridor: captured {len(captured)} tier calls after the "
             f"first re-centre, expected {iters}")
    cases = {}
    for args in captured:
        cases.setdefault((args[5].shape[1], args[1].shape[0]), args)
    cases = [cases[k] for k in sorted(cases, reverse=True)]
    old_origin = slam.mv.frameid_to_vrange(armed["frame"] - 1)[:, 0]
    new_origin = armed["origin"]
    shift = np.round((new_origin - old_origin) / vs).astype(np.int64)
    ones = sum(int((be.fetch_windows(a[3], a[4], a[2]) == 1.0).sum())
               for a in cases)
    cleared = sum(cleared_window_cells(torch, be, a, shift, dims)
                  for a in cases)
    print(f"[corridor] tier inputs of frame {armed['frame']} (the first "
          f"after the first re-centre; origin {old_origin.tolist()} -> "
          f"{new_origin.tolist()}, {shift.tolist()} voxels): (C, P) "
          f"{[(a[5].shape[1], a[1].shape[0]) for a in cases]}, {ones} "
          f"window cells at tsdf 1.0, {cleared} of them in the slab the "
          f"re-centre cleared", flush=True)
    if not np.array_equal(old_origin, origin0) or not shift.any():
        fail(f"corridor: the captured tiers are not the first after the "
             f"first re-centre (origin {origin0.tolist()} -> "
             f"{old_origin.tolist()} -> {new_origin.tolist()})")
    if cleared == 0:
        fail("corridor: no window of the captured tiers reaches the slab "
             "the re-centre cleared (tsdf 1.0 outside the old bounds)")
    return slam, out, launches, kept, cases


def phase_corridor_resumed(torch, kept, out_full):
    """[corridor resumed]: a fresh pipeline of the same config loads the
    corridor's resume.npz, every loaded array is checked bitwise, and the
    run continues to CORRIDOR_FRAMES with brick_eval's count zeroed just
    before and read just after."""
    import numpy as np

    from remixfusion_tpu_torch.ops import brick_eval as be
    from remixfusion_tpu_torch.ops import hash_enc as he
    from remixfusion_tpu_torch.slam import RemixFusionTorch

    cfg = corridor_config("corridor_resumed")
    require_cached(cfg, CORRIDOR_FRAMES, "corridor resumed")
    t0 = time.time()
    slam = RemixFusionTorch(cfg, device="cuda")
    rendered = slam.dataset.render_missing(range(CORRIDOR_FRAMES))
    t_setup = time.time() - t0
    if rendered:
        fail(f"corridor resumed: {rendered} frames rendered, expected none")
    t0 = time.time()
    slam.load_state(kept["path"])
    t_load = time.time() - t0
    with np.load(kept["path"]) as f:
        data = {k: f[k] for k in f.files}
    got = slam.state_arrays()
    bad = sorted(k for k in data
                 if k not in got or got[k].dtype != data[k].dtype
                 or (got[k].dtype.kind != "U"
                     and not np.array_equal(got[k], data[k]))
                 or (got[k].dtype.kind == "U"
                     and json.loads(str(got[k])) != json.loads(str(data[k]))))
    if bad or got.keys() != data.keys():
        fail(f"corridor resumed: loaded state differs from resume.npz at "
             f"{bad or sorted(set(got) ^ set(data))}")
    i = kept["tracking_idx"]
    if not np.array_equal(slam.RO_c2w_data[:i + 1], kept["ro"]):
        fail("corridor resumed: RO poses [0, save] differ from the kept "
             "copy")
    if not all(torch.equal(a, b) for a, b in zip(slam.mv.state,
                                                 kept["state"])):
        fail("corridor resumed: the volume differs from the kept copy")
    print(f"[corridor resumed] {len(data)} arrays of resume.npz "
          f"({os.path.getsize(kept['path'])} bytes) loaded bitwise, RO rows "
          f"[0, {i}] and the {tuple(slam.mv.dims)} volume bitwise the kept "
          f"copies; set-up {t_setup:.1f} s, load_state {t_load:.1f} s; "
          f"frames 0..{CORRIDOR_FRAMES - 1} in the render cache [bench "
          f"corridor] filled, 0 rendered", flush=True)
    del data, got

    iters = int(cfg["RO"]["particle_iter_lens"])
    be.brick_eval_volume.launches = 0
    he.hash_table_grad.launches = 0
    t0 = time.time()
    out = slam.run(max_frames=CORRIDOR_FRAMES, resume=True)
    t_run = time.time() - t0
    launches = {"brick_eval": be.brick_eval_volume.launches,
                "hash_table_grad": he.hash_table_grad.launches}
    gap = out["ate_rmse_cm_ro_only"] - out_full["ate_rmse_cm_ro_only"]
    print(f"[corridor resumed] frames {out['first_tracked']}.."
          f"{out['frames'] - 1} tracked={out['tracked_frames']} "
          f"ms_per_frame={out['ms_per_frame']} ms_per_round="
          f"{out['ms_per_round']} rounds={out['mapping_rounds']} "
          f"ate_rmse_cm={out['ate_rmse_cm']} ate_rmse_cm_ro_only="
          f"{out['ate_rmse_cm_ro_only']} (uninterrupted "
          f"{out_full['ate_rmse_cm_ro_only']}, gap {gap:+.4f} cm) "
          f"launches={launches} run {t_run:.1f} s", flush=True)
    frames = CORRIDOR_FRAMES - 1 - CORRIDOR_STATE_EVERY
    want = {"brick_eval": iters * frames, "hash_table_grad": 0}
    if out["tracked_frames"] != frames or launches != want:
        fail(f"corridor resumed: launches {launches} over "
             f"{out['tracked_frames']} frames, expected {want} over "
             f"{frames}")
    for key in ("ate_rmse_cm_ro_only", "ate_rmse_cm"):
        if not out[key] < CORRIDOR_ATE_BAR_CM:
            fail(f"corridor resumed: {key} {out[key]} cm >= "
                 f"{CORRIDOR_ATE_BAR_CM}")
    if not np.isfinite(slam.trajectory(out["frames"])).all():
        fail("corridor resumed: non-finite pose")
    check_corridor_meshes(out, slam, "corridor resumed")
    return slam, out, launches


def check_field(slam, label):
    """[triplane]: every plane and line of the field is a finite table of
    the encoder's widths; [fast]: Frequency holds no table and the map
    optimizer's field group is empty."""
    scene = slam.scene
    if label == "triplane":
        enc = scene.embed_res_fn
        keys = sorted(scene.hash_table)
        want = sorted(f"{k}_{lvl}_{a}" for k in ("plane", "line")
                      for lvl in range(enc.n_levels) for a in range(3))
        if keys != want:
            fail(f"triplane: tables {keys}, expected {want}")
        print(f"[slice triplane] {len(keys)} tables (resolutions "
              f"{enc.resolutions}), all finite", flush=True)
    else:
        groups = slam.mapper.map_opt.param_groups
        if scene.hash_table is not None or groups[0]["params"]:
            fail("fast: the Frequency field holds parameters")
        print(f"[slice fast] {scene.embed_res_fn.out_dim} Frequency "
              f"features, no field table; map optimizer groups "
              f"{[len(g['params']) for g in groups]} (field, decoders)",
              flush=True)


def dense_fuse_check(torch, slam, frames):
    """[dense]: one frame's dense fuse (the last frame's tiles at its
    tracked pose, or the full sweep when they exceed the budget) on the
    card against a CPU recompute from the same volume, on a fixed
    FUSE_SUBSET of the voxels it updated: tsdf within FUSE_TOL, weights
    equal, colours within one 8-bit step. Then the tiled path on the card:
    every tile of the frame's frustum, with no budget, fused from the same
    volume must equal the card's full sweep bit for bit (the tiles are
    disjoint and hold every voxel the frame can update)."""
    import numpy as np

    from remixfusion_tpu_torch.ops import tsdf as tsdf_ops
    from remixfusion_tpu_torch.slam.pipeline import quantize_depth, \
        quantize_rgb

    mv = slam.mv
    last = frames - 1
    batch = slam.dataset[last]
    c2w = slam.RO_c2w_data[last]
    tiles = mv.frame_tiles(c2w, np.asarray(batch["depth"]), slam.K)
    depth = torch.tensor(quantize_depth(batch["depth"]))
    rgb255 = torch.floor(torch.tensor(quantize_rgb(batch["rgb"])) * 255.0)
    args = (depth, rgb255, torch.tensor(slam.K), torch.tensor(c2w))
    kw = dict(voxel_size=mv.voxel_size, trunc_margin=mv.trunc_margin,
              weight_clamp=mv.weight_clamp, tile=mv.tile)
    card_args = [a.cuda() for a in args]
    card_one = torch.ones((), device="cuda")
    cpu = tsdf_ops.VolumeState(*(a.cpu() for a in mv.state))
    card = tsdf_ops.VolumeState(*(a.clone() for a in mv.state))
    w0 = cpu.weight.clone()
    t0 = time.time()
    tsdf_ops.fuse_dense(card, *card_args, obs_weight=card_one, tiles=tiles,
                        **kw)
    torch.cuda.synchronize()
    t_card = time.time() - t0
    t0 = time.time()
    tsdf_ops.fuse_dense(cpu, *args, obs_weight=torch.ones(()), tiles=tiles,
                        **kw)
    t_cpu = time.time() - t0
    upd = torch.nonzero((cpu.weight != w0).reshape(-1))[:, 0]
    if upd.numel() < FUSE_SUBSET:
        fail(f"dense: the frame updated {upd.numel()} voxels, fewer than "
             f"{FUSE_SUBSET}")
    pick = upd[torch.from_numpy(np.sort(np.random.default_rng(0).choice(
        upd.numel(), FUSE_SUBSET, replace=False)))]
    got = [a.reshape(-1, *a.shape[3:])[pick.cuda()].cpu()
           for a in card[:3]]
    ref = [a.reshape(-1, *a.shape[3:])[pick] for a in cpu[:3]]
    err = float((got[0] - ref[0]).abs().max())
    c_err = float((got[2] - ref[2]).abs().max())
    w_eq = torch.equal(got[1], ref[1])
    del cpu, got, ref
    offs = tsdf_ops.frustum_tiles(
        mv.dims, mv.tile, mv.vol_bnds[:, 0], mv.voxel_size, slam.K, c2w,
        *batch["depth"].shape,
        max_depth=float(np.max(batch["depth"])) + mv.trunc_margin + 0.1,
        pad_px=16)
    n_tiles = int(np.prod([d // mv.tile for d in mv.dims]))
    if not 0 < len(offs) < n_tiles:
        fail(f"dense: {len(offs)} of {n_tiles} tiles in the frustum; the "
             f"tiled check needs a proper subset")
    if tiles is None:
        full = card
    else:
        full = tsdf_ops.VolumeState(*(a.clone() for a in mv.state))
        tsdf_ops.fuse_dense(full, *card_args, obs_weight=card_one,
                            tiles=None, **kw)
    tiled = tsdf_ops.VolumeState(*(a.clone() for a in mv.state))
    torch.cuda.synchronize()
    t0 = time.time()
    tsdf_ops.fuse_dense(tiled, *card_args, obs_weight=card_one, tiles=offs,
                        **kw)
    torch.cuda.synchronize()
    t_tiled = time.time() - t0
    same = all(torch.equal(a, b) for a, b in zip(tiled[:3], full[:3]))
    n_diff = int((tiled.tsdf != full.tsdf).sum()
                 + (tiled.weight != full.weight).sum()
                 + (tiled.color != full.color).sum())
    del tiled, full
    how = "the full sweep" if tiles is None else f"{len(tiles)} tiles"
    print(f"[dense] fuse of frame {last} ({len(offs)} of {n_tiles} tiles "
          f"of {mv.tile}^3 in its frustum, budget {mv.tile_budget}: {how}): "
          f"{upd.numel()} voxels updated; card vs CPU on {FUSE_SUBSET} of "
          f"them: tsdf max|d| {err:.3e}, weights "
          f"{'equal' if w_eq else 'DIFFER'}, colour "
          f"max|d| {c_err}; card {1000 * t_card:.1f} ms, CPU "
          f"{1000 * t_cpu:.1f} ms", flush=True)
    print(f"[dense] tiled fuse of all {len(offs)} frustum tiles on the "
          f"card vs the card's full sweep: "
          f"{'bitwise equal' if same else f'{n_diff} values DIFFER'}; "
          f"tiled {1000 * t_tiled:.1f} ms", flush=True)
    if not (err <= FUSE_TOL and w_eq and c_err <= 1.0):
        fail(f"dense: the card's fuse differs from the CPU recompute (tsdf "
             f"{err} > {FUSE_TOL}, or weights, or colour {c_err})")
    if not same:
        fail(f"dense: the card's tiled fuse differs from its full sweep in "
             f"{n_diff} values")
    return {"voxels_updated": int(upd.numel()), "tsdf_max_abs_err": err,
            "card_ms": 1000 * t_card, "cpu_ms": 1000 * t_cpu,
            "frustum_tiles": len(offs), "tiled_ms": 1000 * t_tiled,
            "tiled_equals_full_sweep": same}


def mode_tracker(torch, slam, mode, interp):
    """A tracker of slam's config in `mode` (radius 2, float32 view)."""
    import copy

    from remixfusion_tpu_torch.tracking.rotracker import ROTracker

    cfg = copy.deepcopy(slam.config)
    cfg["RO"].update(eval_mode=mode, brick_radius=2, tsdf_interp=interp)
    cfg["volume"]["track_dtype"] = "float32"
    return ROTracker(cfg, slam.dataset.H, slam.dataset.W, slam.K,
                     slam.mv.dims, slam.mv.voxel_size,
                     slam.mv.brick_layout(), slam.device)


def compare_costs(torch, got, ref, what):
    """Phase 3's tolerance between two cost vectors: the same 1e6-guard
    positions, max |d| < TOL_MAX and mean < TOL_MEAN elsewhere."""
    if not torch.equal(got >= 1e6, ref >= 1e6):
        fail(f"{what}: guard positions differ")
    keep = ref < 1e6
    d = (got - ref).abs()[keep]
    e_max = float(d.max()) if d.numel() else 0.0
    e_mean = float(d.mean()) if d.numel() else 0.0
    if not (e_max < TOL_MAX and e_mean < TOL_MEAN):
        fail(f"{what}: max {e_max} mean {e_mean}")
    return e_max, e_mean


def phase_mode_kernels(torch, slam, frames):
    """On slice A's last-frame tiers: the plain brick mode (r = 2, float32
    view) against brick_eval fed the same values (the volume rounded to
    bfloat16 first, so the kernel's rounding changes nothing), both
    interpolation modes; and gather against brick r = 2 at a search size
    (SMALL_SEARCH) at which every moved vertex stays in its window."""
    from remixfusion_tpu_torch.ops import brick_eval as be
    from remixfusion_tpu_torch.slam.pipeline import quantize_depth

    tr = slam.tracker
    last = frames - 1
    depth = torch.tensor(quantize_depth(slam.dataset[last]["depth"]),
                         device=slam.device)
    c2w = torch.tensor(slam.RO_c2w_data[last], device=slam.device)
    R, T = c2w[:3, :3], c2w[:3, 3]
    origin = slam.mv.state.origin
    vn = tr.vertex_normal_maps(depth)
    q = slam.mv.state.tsdf.to(torch.bfloat16).to(torch.float32)
    ss = tr.init_search_size()
    out = []
    for interp in ("nearest", "trilinear"):
        tb = mode_tracker(torch, slam, "brick", interp)
        for cls in range(3):
            level = tr.class_level[cls]
            params, pix, base = tr.tier_inputs(level, 0, R, T, ss, vn,
                                               origin)
            k = be.brick_eval_volume(params, pix, base, q, tr.brick_layout,
                                     tr.pst_t[cls][0], interp=interp)
            p = tb.eval_brick(tr.pst[cls][0], level, 0, R, T, ss, vn,
                              q.reshape(-1), origin)
            e = compare_costs(torch, p, k, f"brick mode r=2 vs brick_eval "
                              f"C={k.numel()} P={pix.shape[0]} {interp}")
            out.append({"check": "brick r=2 vs brick_eval", "C": k.numel(),
                        "P": pix.shape[0], "interp": interp,
                        "max_abs_err": e[0], "mean_abs_err": e[1]})
            print(f"[kernel] brick mode (r=2, float32 view) vs brick_eval "
                  f"C={k.numel()} P={pix.shape[0]} {interp}: "
                  f"max|d|={e[0]:.3e} mean|d|={e[1]:.3e}", flush=True)
    tg = mode_tracker(torch, slam, "gather", "nearest")
    tb = mode_tracker(torch, slam, "brick", "nearest")
    small = torch.full((6,), SMALL_SEARCH, device=slam.device)
    view = slam.mv.state.tsdf.reshape(-1)
    for cls in range(3):
        level = tr.class_level[cls]
        table = tr.pst[cls][0]
        vg = tg.eval_gather(table, level, 0, R, T, small, vn, view, origin)
        vb = tb.eval_brick(table, level, 0, R, T, small, vn, view, origin)
        e = compare_costs(torch, vb, vg, f"gather vs brick r=2 C="
                          f"{vg.numel()}")
        out.append({"check": "gather vs brick r=2", "C": vg.numel(),
                    "search": SMALL_SEARCH, "max_abs_err": e[0],
                    "mean_abs_err": e[1]})
        print(f"[kernel] gather vs brick mode (r=2) at search size "
              f"{SMALL_SEARCH} C={vg.numel()}: max|d|={e[0]:.3e} "
              f"mean|d|={e[1]:.3e}", flush=True)
    return out


def phase_dense_hash(torch):
    """hash_table_grad on the DenseGrid table at synthetic_bench.yaml's
    widths (~522.6 M rows x 2 float32, 4.2 GB) against its plain version:
    DENSE_POINTS seeded points in [0, 1]^3 and a seeded output gradient."""
    from remixfusion_tpu_torch.models.encodings import get_encoder

    enc, _ = get_encoder("DenseGrid", desired_resolution=DENSE_DESIRED)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((DENSE_POINTS, 3), generator=gen, device="cuda")
    g = torch.randn((DENSE_POINTS, enc.out_dim), generator=gen,
                    device="cuda")
    print(f"[kernel] DenseGrid table: levels {enc.resolutions} (dense: "
          f"{not any(enc.hashed)}), {enc.table_size} rows, largest row "
          f"index x 2 = {2 * (enc.table_size - 1)} < 2^31", flush=True)
    if any(enc.hashed) or 2 * enc.table_size >= 2 ** 31:
        fail("DenseGrid table is hashed or its rows pass 2^31 / 2")
    return phase_hash_kernel(torch, [(enc, x, g, enc.table_size)],
                             table="DenseGrid", n_graph=5)


def phase_gather(torch):
    """[gather]: corridor_v25g.yaml (the corridor with RO.eval_mode gather)
    over GATHER_FRAMES frames that [bench corridor] rendered into the
    disk cache (checked: none is rendered here), with the launch counts
    zeroed just before the run and read just after: brick_eval and
    hash_table_grad never; at least GATHER_MIN_RECENTRES re-centres; full
    and RO-only ATE below 3 cm; meshes inside the bound."""
    import numpy as np

    from remixfusion_tpu_torch.config import load_config
    from remixfusion_tpu_torch.ops import brick_eval as be
    from remixfusion_tpu_torch.ops import hash_enc as he
    from remixfusion_tpu_torch.slam import RemixFusionTorch

    cfg = load_config(GATHER)
    cfg["data"]["output"] = os.path.join(ROOT, "build", "smoke", "gather")
    require_cached(cfg, GATHER_FRAMES + 1, "gather")
    t0 = time.time()
    slam = RemixFusionTorch(cfg, device="cuda")
    rendered = slam.dataset.render_missing(range(GATHER_FRAMES + 1))
    slam.preload(GATHER_FRAMES + 1)
    t_setup = time.time() - t0
    if rendered:
        fail(f"gather: {rendered} frames rendered, expected none")
    tr = slam.tracker
    print(f"[gather] {os.path.relpath(GATHER, ROOT)}: RO.eval_mode "
          f"{tr.eval_mode}, track view {tr.track_dtype}, volume "
          f"{slam.mv.dims}; {GATHER_FRAMES + 1} frames read from the "
          f"render cache [bench corridor] filled, 0 rendered; set-up "
          f"{t_setup:.1f} s",
          flush=True)
    be.brick_eval_volume.launches = 0
    he.hash_table_grad.launches = 0
    t0 = time.time()
    out = slam.run(max_frames=GATHER_FRAMES)
    t_run = time.time() - t0
    launches = {"brick_eval": be.brick_eval_volume.launches,
                "hash_table_grad": he.hash_table_grad.launches}
    recentres = len(slam.mv.frame_to_vrange)
    at = sorted(s for s, _ in slam.mv.frame_to_vrange)[1:] + [
        slam.mv.start_id]
    print(f"[gather] frames={out['frames']} tracked={out['tracked_frames']} "
          f"ms_per_frame={out['ms_per_frame']} ms_per_round="
          f"{out['ms_per_round']} rounds={out['mapping_rounds']} "
          f"ate_rmse_cm={out['ate_rmse_cm']} ate_rmse_cm_ro_only="
          f"{out['ate_rmse_cm_ro_only']} launches={launches} recentres="
          f"{recentres} at frames {at} wall: run {t_run:.1f} s", flush=True)
    if tr.eval_mode != "gather" or tr.track_dtype != "float32":
        fail("gather: the tracker is not in gather mode on a float32 view")
    if launches != {"brick_eval": 0, "hash_table_grad": 0}:
        fail(f"gather: launches {launches}, expected none")
    if recentres < GATHER_MIN_RECENTRES:
        fail(f"gather: {recentres} re-centres, expected at least "
             f"{GATHER_MIN_RECENTRES}")
    for key in ("ate_rmse_cm_ro_only", "ate_rmse_cm"):
        if not out[key] < CORRIDOR_ATE_BAR_CM:
            fail(f"gather: {key} {out[key]} cm >= {CORRIDOR_ATE_BAR_CM}")
    if not np.isfinite(slam.trajectory(out["frames"])).all():
        fail("gather: non-finite pose")
    check_corridor_meshes(out, slam, "gather")
    return out, launches


def require_cached(cfg, n, label):
    """Fail unless frames 0..n-1 of cfg's walk are in the render cache
    that [bench corridor] filled."""
    import copy

    from remixfusion_tpu_torch.datasets import get_dataset
    from remixfusion_tpu_torch.datasets.base import update_cam

    probe = copy.deepcopy(cfg)
    update_cam(probe["cam"])
    ds = get_dataset(probe)
    missing = [i for i in range(n)
               if not os.path.exists(ds._disk_cache_path(i))]
    if missing:
        fail(f"{label}: frames {missing} are not in the render cache "
             f"[bench corridor] filled")


def phase_variant(torch, label, ro_corridor):
    """[corridor hashgrid | damp | gate | noise]: VARIANTS[label] over
    VARIANT_FRAMES frames that [bench corridor] rendered into the disk
    cache (none rendered here), with the launch counts zeroed just before
    the run and read just after: brick_eval 20 times per tracked frame,
    hash_table_grad twice per map iteration with the HashGrid field and
    never otherwise; full and RO-only ATE below 3 cm; meshes inside the
    bound. Recorded during the run: the damp of every host extrapolation
    (all tracking.speed_damp: the host damp is ungated) and every frame's
    fusion weight. With HashGrid, the inputs of the last map step's two
    table-gradient calls are kept, and the RO poses are compared with
    [corridor]'s first frames (ro_corridor). Prints a {"variant": ...}
    JSON line; returns (stats, launches, captured hash_table_grad
    calls)."""
    import numpy as np

    from remixfusion_tpu_torch.config import load_config
    from remixfusion_tpu_torch.models.encodings import HashGridEncoding
    from remixfusion_tpu_torch.ops import brick_eval as be
    from remixfusion_tpu_torch.ops import hash_enc as he
    from remixfusion_tpu_torch.slam import RemixFusionTorch
    from remixfusion_tpu_torch.slam import pipeline

    tag, n = f"[{label}]", VARIANT_FRAMES
    cfg = load_config(VARIANTS[label])
    cfg["data"]["output"] = os.path.join(ROOT, "build", "smoke",
                                         label.replace(" ", "_"))
    require_cached(cfg, n + 1, label)
    t0 = time.time()
    slam = RemixFusionTorch(cfg, device="cuda")
    rendered = slam.dataset.render_missing(range(n + 1))
    slam.preload(n + 1)
    t_setup = time.time() - t0
    if rendered:
        fail(f"{label}: {rendered} frames rendered, expected none")
    enc = slam.scene.embed_res_fn
    hashgrid = isinstance(enc, HashGridEncoding)
    damp = float(cfg["tracking"].get("speed_damp", 1.0))
    gate = cfg["volume"].get("fuse_fit_gate")
    noise = cfg["data"]["synthetic"].get("sensor_noise", 0)
    table = ""
    if hashgrid:
        rows = np.diff(enc.offsets).tolist()
        table = (f" ({enc.n_levels} levels, hash_size "
                 f"{cfg['grid']['hash_size']}: rows per level {rows}, "
                 f"{enc.offsets[-1]} in all)")
    print(f"{tag} {os.path.relpath(VARIANTS[label], ROOT)}: grid.enc "
          f"{cfg['grid']['enc']}{table}, tracking.speed_damp {damp}, "
          f"volume.fuse_fit_gate {gate}, sensor_noise {noise}, RO.cut_dist "
          f"{cfg['RO']['cut_dist']}; {n + 1} frames read from the "
          f"render cache [bench corridor] filled, 0 rendered; set-up "
          f"{t_setup:.1f} s",
          flush=True)

    damps, weights = [], []
    const_speed_np, obs_weight = pipeline.const_speed_np, slam._obs_weight

    def record_damp(*args, **kw):
        damps.append(kw["damp"])
        return const_speed_np(*args, **kw)

    def record_weight(res):
        weights.append(obs_weight(res))
        return weights[-1]

    pipeline.const_speed_np = record_damp
    slam._obs_weight = record_weight
    try:
        with HashCalls(keep=2) as hc:
            be.brick_eval_volume.launches = 0
            be.brick_eval_volume.launches_by_kind.clear()
            he.hash_table_grad.launches = 0
            t0 = time.time()
            out = slam.run(max_frames=n)
            t_run = time.time() - t0
            launches = {"brick_eval": be.brick_eval_volume.launches,
                        "hash_table_grad": he.hash_table_grad.launches,
                        "brick_eval_by_kind": dict(
                            be.brick_eval_volume.launches_by_kind)}
    finally:
        pipeline.const_speed_np = const_speed_np
    w = torch.stack([x.reshape(()) for x in weights]).float().cpu().numpy()
    recentres = len(slam.mv.frame_to_vrange)
    at = sorted(s for s, _ in slam.mv.frame_to_vrange)[1:] + [
        slam.mv.start_id]
    record = {"variant": label, "frames": out["frames"],
              "ate_rmse_cm": out["ate_rmse_cm"],
              "ate_rmse_cm_ro_only": out["ate_rmse_cm_ro_only"],
              "ms_per_frame": out["ms_per_frame"],
              "ms_per_round": out["ms_per_round"],
              "rounds": out["mapping_rounds"],
              "map_iters": out["map_iters"], "recentres": recentres,
              "recentre_frames": at, "host_damp_calls": len(damps),
              "host_damps": sorted(set(damps)),
              "fusion_weight": {"min": float(w.min()),
                                "median": float(np.median(w)),
                                "max": float(w.max()), "frames": len(w)},
              "launches": launches, "run_s": t_run}
    print(f"{tag} frames={out['frames']} tracked={out['tracked_frames']} "
          f"ms_per_frame={out['ms_per_frame']} ms_per_round="
          f"{out['ms_per_round']} rounds={out['mapping_rounds']} "
          f"ate_rmse_cm={out['ate_rmse_cm']} ate_rmse_cm_ro_only="
          f"{out['ate_rmse_cm_ro_only']} launches={launches} recentres="
          f"{recentres} at frames {at}; host damp on {len(damps)} "
          f"extrapolations: {sorted(set(damps))}; fusion weight min "
          f"{w.min():.4f} median {np.median(w):.4f} max {w.max():.4f} over "
          f"{len(w)} frames; wall: run {t_run:.1f} s", flush=True)
    iters = int(cfg["RO"]["particle_iter_lens"])
    want = {"brick_eval": iters * out["tracked_frames"],
            "hash_table_grad": 2 * out["map_iters"] if hashgrid else 0}
    if {k: launches[k] for k in want} != want:
        fail(f"{label}: launches {launches}, expected {want}")
    if not damps or set(damps) != {damp}:
        fail(f"{label}: host damps {sorted(set(damps))} over {len(damps)} "
             f"extrapolations, expected {damp} on every one")
    if not ((w >= 0.05) & (w <= 1.0)).all() or (not gate and w.min() < 1):
        fail(f"{label}: fusion weights outside the gate's range")
    for key in ("ate_rmse_cm_ro_only", "ate_rmse_cm"):
        if not out[key] < CORRIDOR_ATE_BAR_CM:
            fail(f"{label}: {key} {out[key]} cm >= {CORRIDOR_ATE_BAR_CM}")
    if not np.isfinite(slam.trajectory(out["frames"])).all():
        fail(f"{label}: non-finite pose")
    check_corridor_meshes(out, slam, label)
    if noise:
        print(f"{tag} RO-only ATE {out['ate_rmse_cm_ro_only']:.4f} cm over "
              f"{n} frames under sensor noise; {NOISE_RECORD}", flush=True)
    if hashgrid:
        ro = slam.RO_c2w_data[:n]
        d = np.abs(ro - ro_corridor[:n])
        record["ro_vs_corridor_max_abs"] = float(d.max())
        record["ro_vs_corridor_bitwise"] = bool(
            np.array_equal(ro, ro_corridor[:n]))
        print(f"{tag} RO poses of frames 0..{n - 1} against [corridor]'s "
              f"(CPGrid): largest difference {float(d.max()):.3e}, "
              f"translation {float(d[:, :3, 3].max()):.3e} m, bitwise "
              f"equal: {record['ro_vs_corridor_bitwise']} (JAX: bitwise "
              f"equal, BASELINE.md:944-946)", flush=True)
        if len(hc.calls) != 2:
            fail(f"{label}: captured {len(hc.calls)} hash_table_grad calls, "
                 f"expected 2")
    print(json.dumps({"variant": record}), flush=True)
    return out, launches, list(hc.calls)


def compare_window_dtypes(torch, cases):
    """The float32-window instantiation against the bfloat16 one on the
    same tiers, both lookup modes (information, no bar): the largest cost
    difference where neither is guarded, whether the best candidate and
    the set of improving candidates (cost below the identity's) change."""
    from remixfusion_tpu_torch.ops import brick_eval as be

    out = []
    for args in cases:
        C, P = args[5].shape[1], args[1].shape[0]
        for interp in ("nearest", "trilinear"):
            f32, bf16 = (be.brick_eval_volume(*args, interp=interp,
                                              track_dtype=dt)
                         for dt in ("float32", "bfloat16"))
            keep = (f32 < 1e6) & (bf16 < 1e6)
            d = (f32 - bf16).abs()[keep]
            rec = {"C": C, "P": P, "interp": interp,
                   "max_abs_diff": float(d.max()) if d.numel() else 0.0,
                   "guards_equal": bool(torch.equal(f32 >= 1e6,
                                                    bf16 >= 1e6)),
                   "best_same": int(f32.argmin()) == int(bf16.argmin()),
                   "improving_same": bool(torch.equal(f32 < f32[0],
                                                      bf16 < bf16[0]))}
            out.append(rec)
            print(f"[kernel] brick_eval float32 vs bfloat16 windows C={C} "
                  f"P={P} {interp}: max|d|={rec['max_abs_diff']:.3e}, "
                  f"guards equal {rec['guards_equal']}, best candidate "
                  f"same {rec['best_same']}, improving set same "
                  f"{rec['improving_same']}", flush=True)
    return out


def phase_f32(torch):
    """[f32 windows]: synthetic_bench.yaml with volume.track_dtype float32
    through phase_slice: every brick_eval launch through the float32-window
    instantiation; the kernel against its plain version on the last
    frame's tiers, and against the bfloat16 instantiation."""
    slam, out, launches = phase_slice(torch, "f32")
    want = {f"{slam.tracker.tsdf_interp}/float32": launches["brick_eval"]}
    if launches["brick_eval_by_kind"] != want:
        fail(f"f32 windows: launches by instantiation "
             f"{launches['brick_eval_by_kind']}, expected {want}")
    phase_mesh(slam, out, "f32")
    cases = tier_cases(torch, slam, out["frames"])
    shapes = []
    for args in cases:
        shapes += check_brick_case(torch, args, "f32 windows",
                                   track_dtype="float32")
    return launches, shapes, compare_window_dtypes(torch, cases)


def phase_720p(torch, label, slice_a_pixels):
    """[720p refstride] / [720p]: 1280x720 frames through phase_slice and
    the mesh phase, then the last frame's tiers: with RO.pix_ref null
    (absolute strides) the kernel against its plain version at the new
    tier sizes; with the default pix_ref the tiers' pixel counts equal
    slice A's (slice_a_pixels)."""
    slam, out, launches = phase_slice(torch, label)
    tr = slam.tracker
    cases = tier_cases(torch, slam, out["frames"])
    pixels = [a[1].shape[0] for a in cases]
    tiers = [(tr.tier_strides[lv], p) for lv, p in zip(tr.class_level,
                                                        pixels)]
    print(f"[{tag_of(label)}] {slam.dataset.W}x{slam.dataset.H}, RO.pix_ref "
          f"{slam.config['RO'].get('pix_ref', 'default')}: tier (stride "
          f"rows, cols) -> pixels {tiers}", flush=True)
    shapes = []
    if label == "720p" and pixels != slice_a_pixels:
        fail(f"720p: tier pixels {pixels}, expected slice A's "
             f"{slice_a_pixels}")
    phase_mesh(slam, out, label)
    if label != "720p":
        for args in cases:
            shapes += check_brick_case(torch, args, "720p refstride")
    return launches, shapes


def phase_refine(torch):
    """[refine]: ab_refine.yaml's whole sequence through phase_slice, the
    map steps of finalize's offline refinement (mapping.final_iters)
    counted; the mesh scored by the mesh phase with F1 >= REFINE_F1_BAR
    and printed beside the JAX record. Returns the launches."""
    steps = {}

    def count_final_steps(slam):
        finalize = slam.finalize

        def counted(n, stats):
            start = slam.map_iters_done
            res = finalize(n, stats)
            steps["final"] = slam.map_iters_done - start
            return res

        slam.finalize = counted

    slam, out, launches = phase_slice(torch, "refine", count_final_steps)
    m = slam.config["mapping"]
    final_iters, iters = int(m["final_iters"]), int(m["iters"])
    want = -(-final_iters // iters) * iters
    print(f"[refine] mapping.final_iters {final_iters}: {steps.get('final')}"
          f" map steps at finalize (expected {want})", flush=True)
    if steps.get("final") != want:
        fail(f"refine: {steps.get('final')} final map steps, expected "
             f"{want}")
    if out["frames"] != slam.dataset.num_frames:
        fail(f"refine: {out['frames']} of {slam.dataset.num_frames} frames")
    mesh = phase_mesh(slam, out, "refine", REFINE_F1_BAR)
    print(f"[refine] mesh accuracy {mesh['accuracy_cm']:.4f} cm, completion "
          f"{mesh['completion_cm']:.4f} cm, F1 {mesh['f1']:.4f}; JAX record "
          f"(BASELINE.md:674-683) {REFINE_RECORD}", flush=True)
    return launches


def phase_render(torch, slam, out):
    """[render] on slice A's finished pipeline: calc_2d_metric over frames
    0, RENDER_GAP, ... with the run's poses and the frames' depth as the
    target; a fixed RENDER_SUBSET-ray subset of the last scored frame on
    the card and on a CPU copy of the scene with the same draws (within
    RENDER_TOL); render_img of that frame read back."""
    import numpy as np

    from remixfusion_tpu_torch.slam import pipeline
    from remixfusion_tpu_torch.tools.rendering_eval import calc_2d_metric
    from remixfusion_tpu_torch.utils.convert import scene_from_numpy, \
        scene_to_numpy
    from remixfusion_tpu_torch.utils.imageio import read_png

    n = out["frames"]
    poses = slam.trajectory(n)
    res = calc_2d_metric(slam, poses, gap=RENDER_GAP)
    kind = "lpips" if "lpips" in res else "rf_perceptual"
    want = list(range(0, n, RENDER_GAP))
    if res["frames"] != want:
        fail(f"render: scored frames {res['frames']}, expected {want}")
    for key in ("psnr", "ssim", kind, "depth_l1"):
        if not np.isfinite(res[key]):
            fail(f"render: {key} is {res[key]}")
    H, W = slam.dataset.H, slam.dataset.W
    S = slam.scene.z_vals_shape(1)[1]

    last = want[-1]
    batch = slam.dataset[last]
    idx = np.sort(np.random.default_rng(0).choice(H * W, RENDER_SUBSET,
                                                  replace=False))
    c2w = poses[last]
    d = np.asarray(batch["direction"], np.float32).reshape(-1, 3)[idx] \
        @ c2w[:3, :3].T
    o = np.tile(c2w[:3, 3], (RENDER_SUBSET, 1))
    td = np.asarray(batch["depth"], np.float32).reshape(-1)[idx][:, None]
    u = torch.rand(slam.scene.z_vals_shape(RENDER_SUBSET),
                   generator=torch.Generator().manual_seed(0))
    params, buffers = scene_to_numpy(slam.scene)
    cpu = scene_from_numpy(slam.config, slam.bound, slam.num_kf, params,
                           buffers, device="cpu")
    got = {}
    for name, scene, dev in (("card", slam.scene, "cuda"), ("cpu", cpu,
                                                            "cpu")):
        with torch.no_grad():
            r = scene.render_rays(*(torch.from_numpy(
                np.ascontiguousarray(a, np.float32)).to(dev)
                for a in (o, d, td)), u=u.to(dev))
        got[name] = (r["rgb_res_map"].cpu().numpy(),
                     r["depth_res_map"].cpu().numpy())
    err_rgb = float(np.abs(got["card"][0] - got["cpu"][0]).max())
    err_depth = float(np.abs(got["card"][1] - got["cpu"][1]).max())
    if not (err_rgb <= RENDER_TOL and err_depth <= RENDER_TOL):
        fail(f"render: card and CPU renders of {RENDER_SUBSET} rays differ "
             f"by {err_rgb} (rgb) / {err_depth} (depth) > {RENDER_TOL}")

    path = slam.render_img(last, batch["depth"], batch["rgb"], c2w,
                           batch["direction"])
    img, _ = read_png(path)
    want_shape = (2 * -(-H // 4), 3 * -(-W // 4), 3)
    if img.shape != want_shape:
        fail(f"render: {path} is {img.shape}, expected {want_shape}")
    line = {"frames": res["frames"], "psnr": res["psnr"],
            "ssim": res["ssim"], "perceptual": res[kind],
            "perceptual_kind": kind, "depth_l1_m": res["depth_l1"],
            "render_ms_per_frame": float(np.mean(res["render_ms"])),
            "render_ms": res["render_ms"], "chunk_rays":
                pipeline._RENDER_CHUNK, "rays_per_frame": H * W,
            "samples_per_ray": S, "points_per_frame": H * W * S,
            "subset_max_abs_err": {"rgb": err_rgb, "depth": err_depth},
            "render_img": os.path.relpath(path, ROOT),
            "render_img_shape": list(img.shape)}
    print(json.dumps({"render": line}), flush=True)
    return line


def render_eval_config(out_dir):
    """The smoke's copy of rendering_eval_example.yaml (output under
    build/smoke/, mesh.vis RENDER_EVAL_VIS with mesh.render_img), as a
    file, for the rendering_eval_torch.py process."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "rendering_eval_smoke.yaml")
    with open(path, "w") as f:
        f.write(f"inherit_from: {RENDER_EVAL}\ndata:\n  output: {out_dir}\n"
                f"mesh:\n  vis: {RENDER_EVAL_VIS}\n  render_img: 1\n")
    return path


def phase_render_eval(torch):
    """[render eval]: the JAX record's protocol. rendering_eval_example.yaml
    runs whole (brick_eval launches counted, ATE < ATE_BAR_CM, the mesh.vis
    frame's tracking_result.txt line, trajectory plot and render_img
    figure), then rendering_eval_torch.py --gap RENDER_EVAL_GAP scores the
    checkpoint that run wrote, in a fresh process, against RENDER_BARS."""
    import numpy as np

    from remixfusion_tpu_torch.config import load_config
    from remixfusion_tpu_torch.ops import brick_eval as be
    from remixfusion_tpu_torch.slam import RemixFusionTorch
    from remixfusion_tpu_torch.utils.imageio import read_png

    out_dir = os.path.join(ROOT, "build", "smoke", "render_eval")
    cfg_path = render_eval_config(out_dir)
    cfg = load_config(cfg_path)
    t0 = time.time()
    slam = RemixFusionTorch(cfg, device="cuda")
    slam.preload(slam.dataset.num_frames)
    t_setup = time.time() - t0
    iters = int(cfg["RO"]["particle_iter_lens"])
    be.brick_eval_volume.launches = 0
    t0 = time.time()
    out = slam.run()
    t_run = time.time() - t0
    launches = be.brick_eval_volume.launches
    print(f"[render eval] {os.path.relpath(RENDER_EVAL, ROOT)} + mesh.vis "
          f"{RENDER_EVAL_VIS}, mesh.render_img 1: frames={out['frames']} "
          f"ms_per_frame={out['ms_per_frame']} ms_per_round="
          f"{out['ms_per_round']} ate_rmse_cm={out['ate_rmse_cm']} "
          f"ate_rmse_cm_ro_only={out['ate_rmse_cm_ro_only']} launches="
          f"{{'brick_eval': {launches}}} wall: set-up {t_setup:.1f} s, run "
          f"{t_run:.1f} s", flush=True)
    if launches != iters * out["tracked_frames"]:
        fail(f"render eval: brick_eval launched {launches} times, expected "
             f"{iters * out['tracked_frames']}")
    for key in ("ate_rmse_cm_ro_only", "ate_rmse_cm"):
        if not out[key] < ATE_BAR_CM:
            fail(f"render eval: {key} {out[key]} cm >= {ATE_BAR_CM}")
    run_dir = slam.out_dir
    with open(os.path.join(run_dir, "tracking_result.txt")) as f:
        ids = [ln.split()[0] for ln in f]
    vis = str(RENDER_EVAL_VIS)
    if ids != [vis, str(out["frames"] - 1)]:
        fail(f"render eval: tracking_result.txt lines at frames {ids}, "
             f"expected [{vis}, {out['frames'] - 1}]")
    for name in (f"frame_{vis}.png", f"{vis}.png", "checkpoint.npz"):
        if not os.path.exists(os.path.join(run_dir, name)):
            fail(f"render eval: {name} was not written")
    fig, _ = read_png(os.path.join(run_dir, f"{vis}.png"))
    H, W = slam.dataset.H, slam.dataset.W
    if fig.shape != (2 * -(-H // 4), 3 * -(-W // 4), 3):
        fail(f"render eval: {vis}.png is {fig.shape}")
    del slam
    torch.cuda.empty_cache()

    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "rendering_eval_torch.py"),
         "--config", cfg_path, "--gap", str(RENDER_EVAL_GAP)], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    t_eval = time.time() - t0
    if proc.returncode != 0:
        fail(f"render eval: rendering_eval_torch.py exited "
             f"{proc.returncode}: {proc.stderr[-2000:]}")
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith('{"rendering_eval"')]
    if len(lines) != 1:
        fail(f"render eval: no result line in {proc.stdout[-2000:]}")
    res = json.loads(lines[0])["rendering_eval"]
    if res["frames"] != list(range(0, out["frames"], RENDER_EVAL_GAP)):
        fail(f"render eval: scored frames {res['frames']}")
    if res["device"] != "cuda":
        fail(f"render eval: scored on {res['device']}")
    kind = "lpips" if "lpips" in res else "rf_perceptual"
    metrics = {k: res[k] for k in ("psnr", "ssim", "depth_l1", kind)}
    for key, value in metrics.items():
        op, bar = RENDER_BARS[key]
        if not (value >= bar if op == ">=" else value <= bar):
            fail(f"render eval: {key} {value} misses the sanity bar "
                 f"{op} {bar}")
    line = {**metrics, "perceptual_kind": kind,
            "target": {k: RENDER_TARGET[k] for k in metrics
                       if k in RENDER_TARGET},
            "bars": {k: RENDER_BARS[k] for k in metrics},
            "render_ms_per_frame": float(np.mean(res["render_ms"])),
            "frames": res["frames"], "eval_process_s": t_eval,
            "online": {k: out[k] for k in ("ate_rmse_cm",
                                           "ate_rmse_cm_ro_only",
                                           "ms_per_frame", "ms_per_round")},
            "launches": {"brick_eval": launches},
            "record_float32_read": FLOAT32_READ_RECORD["render eval"]}
    print(f"[render eval] PSNR {metrics['psnr']:.3f} dB, SSIM "
          f"{metrics['ssim']:.4f}; the float32 read (PR 13's port): "
          f"{line['record_float32_read']}; JAX record {RENDER_TARGET}",
          flush=True)
    print(json.dumps({"render_eval": line}), flush=True)
    return launches


def image_dims(body):
    """(height, width) of a BMP or baseline/progressive JPEG, else None."""
    if body[:2] == b"BM":
        return (abs(int.from_bytes(body[22:26], "little", signed=True)),
                int.from_bytes(body[18:22], "little"))
    if body[:2] != b"\xff\xd8":
        return None
    pos = 2
    while pos + 9 < len(body):
        if body[pos] != 0xFF:
            return None
        marker = body[pos + 1]
        if marker in (0xC0, 0xC1, 0xC2):
            return (int.from_bytes(body[pos + 5:pos + 7], "big"),
                    int.from_bytes(body[pos + 7:pos + 9], "big"))
        pos += 2 + int.from_bytes(body[pos + 2:pos + 4], "big")
    return None


def phase_bench(label):
    """[bench <label>]: bench_torch.py on BENCH[label] in a child process
    at its defaults (the BENCH_* variables cleared), held to its bars (the
    slices' on A and B, a broken run's on the corridor); returns the
    child's `# result` numbers with the phase wall."""
    import numpy as np

    from bench_torch import configure
    from remixfusion_tpu_torch.config import load_config

    tag = f"[bench {label}]"
    rel = os.path.relpath(BENCH[label], ROOT)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BENCH_") and k != "REMIX_PROFILE"}
    cfg = load_config(BENCH[label])
    n_frames = configure(cfg, rel, env={})
    t0 = time.time()
    try:
        out = subprocess.run(
            [sys.executable, os.path.join(ROOT, "bench_torch.py"),
             "--config", rel], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=BENCH_TIMEOUT_S[label])
    except subprocess.TimeoutExpired:
        fail(f"{tag} bench_torch.py ran past {BENCH_TIMEOUT_S[label]} s")
    wall = time.time() - t0
    log = os.path.join(ROOT, "build", "smoke", f"bench_{label}.log")
    os.makedirs(os.path.dirname(log), exist_ok=True)
    with open(log, "w") as f:
        f.write(out.stderr)
    for line in out.stderr.splitlines():
        if line.startswith("# ") and not line.startswith("# result "):
            print(f"{tag} {line[2:]}", flush=True)
    if out.returncode != 0:
        fail(f"{tag} bench_torch.py exited {out.returncode}: "
             f"{out.stderr[-3000:]}")
    try:
        last = json.loads(out.stdout.strip().splitlines()[-1])
        res = json.loads(next(ln for ln in out.stderr.splitlines()
                              if ln.startswith("# result "))[9:])
    except (ValueError, IndexError, StopIteration) as e:
        fail(f"{tag} unreadable output ({e}): {out.stdout[-2000:]}")
    if set(last) != {"metric", "value", "unit", "vs_baseline"}:
        fail(f"{tag} last line {last} lacks bench.py's four keys")
    if not last["value"] > 0:
        fail(f"{tag} fps {last['value']} <= 0")
    iters = int(cfg["RO"]["particle_iter_lens"])
    want = {"brick_eval": iters * (n_frames - 1),
            "hash_table_grad": (2 * res["map_iters"]
                                if cfg["grid"]["enc"] == "HashGrid" else 0)}
    if res["tracked_frames"] != n_frames - 1:
        fail(f"{tag} tracked {res['tracked_frames']} frames, expected "
             f"{n_frames - 1}")
    if res["launches"] != want:
        fail(f"{tag} launches {res['launches']}, expected {want}")
    if not res["rounds"] > 0:
        fail(f"{tag} no mapping round ran")
    if not res["poses_finite"]:
        fail(f"{tag} a pose is not finite")
    q = {"ate_rmse_cm": res["ate_rmse_cm"],
         "ate_rmse_cm_ro_only": res["ate_rmse_cm_ro_only"],
         **{k: res["mesh"][k] for k in ("f1", "accuracy_cm",
                                        "completion_cm")}}
    line = {"bench": label, "config": rel, "fps": last["value"],
            "vs_baseline": last["vs_baseline"], "frames": res["frames"],
            "elapsed_s": res["elapsed_s"], "track_ms": res["track_ms"],
            "ms_per_round": res["ms_per_round"], "rounds": res["rounds"],
            "slow_frames": res["slow"], "sel_la_hit": res["sel_la_hit"],
            "max_memory_allocated": res["max_memory_allocated"],
            "launches": res["launches"], "map_iters": res["map_iters"],
            "recentres": res["recentres"], "keyframes": res["keyframes"],
            "keyframe_slots": res["keyframe_slots"],
            "ate_by_frames": res["ate_by_frames"], "quality": q,
            "mesh_wall_s": res["mesh"]["wall_s"], "phase_wall_s": wall,
            "card": card_line()}
    if label == "corridor":
        line["record_JAX_corridor"] = CORRIDOR_RECORD
        line["frames_per_recentre"] = (n_frames / res["recentres"]
                                       if res["recentres"] else None)
    else:
        line["record_BENCH_r05"] = BENCH_RECORD
        line["record_float32_read"] = FLOAT32_READ_RECORD[f"bench {label}"]
        print(f"{tag} ATE full / RO-only {q['ate_rmse_cm']:.3f} / "
              f"{q['ate_rmse_cm_ro_only']:.3f} cm, mesh F1 {q['f1']:.4f}; "
              f"the float32 read (PR 13's port): "
              f"{line['record_float32_read']}", flush=True)
    print(json.dumps({"bench_phase": line}), flush=True)
    if label == "corridor":
        bound = np.asarray(cfg["mapping"]["marching_cubes_bound"])
        # the child's paths are relative to its working directory, ROOT
        counts = meshes_in_bound(
            [os.path.join(ROOT, res["mesh"][k])
             for k in ("mesh_path", "mesh_cull_path")], bound, tag)
        print(f"{tag} {n_frames} frames, {res['tracked_frames']} tracked, "
              f"fps {last['value']} ({line['card']}); ATE full / RO-only "
              f"{q['ate_rmse_cm']:.3f} / {q['ate_rmse_cm_ro_only']:.3f} cm "
              f"(JAX record {CORRIDOR_RECORD['ate_rmse_cm']} / "
              f"{CORRIDOR_RECORD['ate_rmse_cm_ro_only']}); mesh accuracy / "
              f"completion {q['accuracy_cm']:.2f} / "
              f"{q['completion_cm']:.2f} cm, F1 {q['f1']:.3f} (JAX "
              f"{CORRIDOR_RECORD['accuracy_cm']} / "
              f"{CORRIDOR_RECORD['completion_cm']}, "
              f"{CORRIDOR_RECORD['f1']}); {res['recentres']} re-centres "
              f"(JAX: one per ~{CORRIDOR_RECORD['frames_per_recentre']} "
              f"frames); keyframes {res['keyframes']} in "
              f"{res['keyframe_slots']} slots; peak memory "
              f"{res['max_memory_allocated']} B; {len(res['slow'])} frames "
              f"over 1 s; meshes (verts, faces) {counts} inside the bound "
              f"+- {CORRIDOR_MESH_PAD} m", flush=True)
        bar = CORRIDOR_BENCH_ATE_BAR_CM
    else:
        bar = ATE_BAR_CM
        if not q["f1"] >= F1_BAR:
            fail(f"{tag} mesh F1 {q['f1']} < {F1_BAR}")
    for key in ("ate_rmse_cm", "ate_rmse_cm_ro_only"):
        if not q[key] < bar:
            fail(f"{tag} {key} {q[key]} cm >= {bar}")
    return line


def phase_live(torch):
    """[live]: LIVE_FRAMES frames of verify_small.yaml with the live
    viewer (LIVE_VIZ). After the run, before close(): /state.json holds the
    last frame and the whole trajectory, /frame decodes at the size of a
    gap-8 render or of the input at stride 2, and the frames published were
    those; after close() the port refuses connections."""
    import urllib.error
    import urllib.request

    import numpy as np

    from remixfusion_tpu_torch.config import load_config
    from remixfusion_tpu_torch.ops import brick_eval as be
    from remixfusion_tpu_torch.slam import RemixFusionTorch

    cfg = load_config(LIVE)
    cfg["data"]["output"] = os.path.join(ROOT, "build", "smoke", "live")
    cfg["viz"] = dict(LIVE_VIZ)
    slam = RemixFusionTorch(cfg, device="cuda")
    slam.preload(LIVE_FRAMES + 1)
    port = slam.viewer.port
    shapes = []
    publish = slam.viewer.publish_frame

    def record(rgb):
        shapes.append(tuple(np.asarray(rgb).shape[:2]))
        publish(rgb)

    slam.viewer.publish_frame = record
    be.brick_eval_volume.launches = 0
    try:
        out = slam.run(max_frames=LIVE_FRAMES)
        launches = be.brick_eval_volume.launches
        base = f"http://127.0.0.1:{port}"
        state = json.loads(urllib.request.urlopen(
            base + "/state.json", timeout=30).read())
        body = urllib.request.urlopen(base + "/frame", timeout=30).read()
    finally:
        slam.close()
    H, W = slam.dataset.H, slam.dataset.W
    render_hw = (-(-H // 8), -(-W // 8))
    input_hw = (-(-H // 2), -(-W // 2))
    want = [render_hw if i % LIVE_VIZ["live_render_every"] == 0 else
            input_hw for i in range(1, LIVE_FRAMES)
            if i % LIVE_VIZ["live_every"] == 0]
    dims = image_dims(body)
    print(f"[live] {os.path.relpath(LIVE, ROOT)} + viz {LIVE_VIZ}: "
          f"frames={out['frames']} ate_rmse_cm={out['ate_rmse_cm']} "
          f"launches={{'brick_eval': {launches}}} state frame "
          f"{state['frame']}, trajectory {len(state['est'])} poses, extra "
          f"{state['extra']}; published {shapes}; /frame "
          f"{body[:2]!r} {dims}", flush=True)
    if launches != int(cfg["RO"]["particle_iter_lens"]) * \
            out["tracked_frames"]:
        fail(f"live: brick_eval launched {launches} times")
    if (state["frame"] != LIVE_FRAMES - 1 or len(state["est"]) != LIVE_FRAMES
            or state["extra"].get("status") != "finished"):
        fail(f"live: state {state['frame']} with {len(state['est'])} poses")
    if shapes != want:
        fail(f"live: published frames {shapes}, expected {want}")
    if dims not in (render_hw, input_hw):
        fail(f"live: /frame decodes to {dims}")
    try:
        urllib.request.urlopen(base + "/state.json", timeout=10)
        fail("live: the viewer still answers after close()")
    except urllib.error.URLError:
        pass
    if slam.viewer is not None:
        fail("live: close() kept the viewer")
    return launches


def frame_inputs(torch, ds, i, c2w=None):
    """Frame i as CPU tensors (quantized depth [H, W], rgb [H, W, 3] in
    [0, 1], K, pose: the dataset's, or c2w)."""
    import numpy as np

    from remixfusion_tpu_torch.slam.pipeline import quantize_depth

    f = ds[i]
    pose = f["c2w"] if c2w is None else c2w
    return {"depth": torch.tensor(quantize_depth(f["depth"])),
            "rgb": torch.tensor(np.asarray(f["rgb"], np.float32)),
            "K": torch.tensor(np.asarray(ds.K(), np.float32)),
            "c2w": torch.tensor(np.asarray(pose, np.float32))}


def map_scene(torch, cfg, f0, device, comm=None, whole=True):
    """The map steps' scene: SceneRepresentation of cfg from seed 0 with
    frame f0 fused into the whole grid (whole), or a scene without a grid
    reading the ranks' slabs, f0 fused into this rank's; either way with
    the bf16 query mirror refreshed after the fuse, as the mapper keeps it.
    Returns (scene, slab); the slab (a SlabGrid) is None for the whole
    grid."""
    import numpy as np

    from remixfusion_tpu_torch.models.scene_rep import SceneRepresentation
    from remixfusion_tpu_torch.ops import tsdf as tsdf_ops
    from remixfusion_tpu_torch.parallel import sharding
    from remixfusion_tpu_torch.parallel.dryrun import NUM_KF

    bound = np.asarray(cfg["mapping"]["bound"], np.float32)
    bound_t = torch.as_tensor(bound, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    trunc = cfg["training"]["c_trunc"]
    f = {k: v.to(device) for k, v in f0.items()}
    args = (f["depth"], f["rgb"], f["K"], f["c2w"], bound_t)
    if whole:
        scene = SceneRepresentation(cfg, bound, NUM_KF, device=device,
                                    generator=gen)
        tsdf_ops.integrate_global(scene.gbv, scene.gbw, *args,
                                  trunc_margin=trunc)
        scene.refresh_gbq()
        return scene, None
    R = int(cfg["globalV"]["base_resolution"])
    slab = sharding.SlabGrid(R, comm, device)
    sharding.sharded_fuse_pack_gbq(comm, R, trunc, *f["depth"].shape)(
        slab, *args)
    scene = SceneRepresentation(cfg, bound, NUM_KF, device=device,
                                generator=gen, grid_rows=slab.rows)
    return scene, slab


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class HashCalls:
    """Within the block, the inputs (enc, x, grad_out, n_rows) of every
    hash_table_grad call, or of the last `keep`, are kept in `calls` and
    the kernel is launched as usual. The kernel counts its launches on the
    module's hash_table_grad, here this wrapper: `launches` holds them, and
    they are added to the kernel's own count on leaving."""

    def __init__(self, keep=None):
        self.keep = keep

    def __enter__(self):
        from collections import deque

        from remixfusion_tpu_torch.ops import hash_enc as he

        self.he, self.kernel = he, he.hash_table_grad
        self.calls = deque(maxlen=self.keep)

        def capture(enc, x, g, n_rows):
            self.calls.append((enc, x, g, n_rows))
            return self.kernel(enc, x, g, n_rows)

        capture.launches = 0
        self.wrapper = capture
        he.hash_table_grad = capture
        return self

    @property
    def launches(self):
        return self.wrapper.launches

    def __exit__(self, *exc):
        self.he.hash_table_grad = self.kernel
        self.kernel.launches += self.wrapper.launches


def timed_steps(torch, step, scene, args, n):
    """n calls of a map step of `scene` on one batch: (the first call's
    loss, the parameters after it as numpy, ms per call of the later calls
    on the host clock, each ending in a synchronize)."""
    dev = args[0].device
    loss = float(step(*args))
    sync(torch, dev)
    params = {k: v.detach().cpu().numpy()
              for k, v in scene.named_parameters()}
    ms = []
    for _ in range(n - 1):
        t0 = time.perf_counter()
        step(*args)
        sync(torch, dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    return loss, params, sum(ms) / len(ms)


def shifted_pose(torch, cfg, tracker_args, state, init, depth, comm, seed):
    """do_tracking's pose with RO.sample_range SHIFT_RANGE, the per-pixel
    ray shift drawn from a generator seeded `seed`, on a tracker of cfg
    otherwise (tracker_args: ROTracker's H, W, K, dims, voxel size, brick
    layout and device)."""
    import copy

    from remixfusion_tpu_torch.tracking.rotracker import ROTracker

    cfg = copy.deepcopy(cfg)
    cfg["RO"]["sample_range"] = SHIFT_RANGE
    tr = ROTracker(cfg, *tracker_args, group=comm)
    gen = torch.Generator(device=tracker_args[-1]).manual_seed(seed)
    return tr.do_tracking(state, init, depth,
                          generator=gen).c2w.cpu().numpy()


def nccl_probe_rank(rank, world):
    """One all-reduce over NCCL; the error NCCL raises, or None."""
    import torch
    import torch.distributed as dist

    try:
        dist.all_reduce(torch.ones(1, device="cuda"))
        torch.cuda.synchronize()
        return None
    except dist.DistBackendError as e:
        return str(e)


def sharded_setup(torch, slam, frames, out_dir, cfg_b):
    """The [sharded] phase's inputs, saved for the ranks, and the
    single-process references on the card: slice A's last frame (its
    tiers' costs by the kernel and by the plain version at its RO pose,
    do_tracking from the previous RO pose, its fusion into a fresh 200^3
    grid) and bench_hashgrid.yaml's map step (frame 0 fused into the grid,
    mapping.sample rays of frame 0, a seeded stratified draw)."""
    import numpy as np

    from remixfusion_tpu_torch.ops import brick_eval as be
    from remixfusion_tpu_torch.ops import tsdf as tsdf_ops
    from remixfusion_tpu_torch.parallel import sharding
    from remixfusion_tpu_torch.parallel.dryrun import frame_rays, \
        loss_weights

    dev = slam.device
    tr, mv, ds = slam.tracker, slam.mv, slam.dataset
    last = frames - 1
    fr = frame_inputs(torch, ds, last, slam.RO_c2w_data[last])
    c2w = fr["c2w"].to(dev)
    depth = fr["depth"].to(dev)
    vn = tr.vertex_normal_maps(depth)
    view = tr.track_view(mv.state.tsdf)
    ss = tr.init_search_size()
    refs = {"kernel": [], "plain": [], "tiers": []}
    for cls in range(3):
        level = tr.class_level[cls]
        refs["kernel"].append(tr.score_tier(
            cls, 0, level, 0, c2w[:3, :3], c2w[:3, 3], ss, vn, view,
            mv.state.origin))
        args = tr.tier_inputs(level, 0, c2w[:3, :3], c2w[:3, 3], ss, vn,
                              mv.state.origin)
        refs["tiers"].append(args + (view, tr.brick_layout,
                                     tr.pst_t[cls][0]))
        refs["plain"].append(be.brick_eval_volume_reference(
            *refs["tiers"][-1], interp=tr.tsdf_interp))
    init = slam.RO_c2w_data[last - 1]
    refs["pose"] = tr.do_tracking(mv.state, init, depth).c2w.cpu().numpy()
    targs = (ds.H, ds.W, ds.K(), mv.dims, mv.voxel_size, tr.brick_layout,
             dev)
    refs["shift_pose"], refs["shift_pose_other_seed"] = (
        shifted_pose(torch, slam.config, targs, mv.state, init, depth, None,
                     seed) for seed in (SHIFT_SEED, SHIFT_SEED + 1))
    R = int(slam.config["globalV"]["base_resolution"])
    gbv = torch.zeros((R, R, R, 4), device=dev)
    gbv[..., 0] = 1.0
    gbw = torch.zeros((R, R, R), device=dev)
    tsdf_ops.integrate_global(
        gbv, gbw, depth, fr["rgb"].to(dev), fr["K"].to(dev), c2w,
        torch.as_tensor(slam.bound, device=dev),
        trunc_margin=slam.config["training"]["c_trunc"])
    refs["grid"] = (gbv, gbw, gbv.to(torch.bfloat16))

    f0 = frame_inputs(torch, ds, 0)
    n = int(cfg_b["mapping"]["sample"])
    rays = [torch.as_tensor(a, device=dev) for a in frame_rays(
        ds[0], ds[0]["c2w"], np.random.default_rng(0), n)]
    scene, _ = map_scene(torch, cfg_b, f0, dev)
    refs["params0"] = {k: v.detach().cpu().numpy()
                       for k, v in scene.named_parameters()}
    u = torch.rand(scene.z_vals_shape(n), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
    z = scene.sample_z_vals(rays[0][:, 6:7], u=u)
    pts = scene.normalize((rays[1][:, None] + rays[2][:, None]
                           * z[..., None]).reshape(-1, 3))
    refs["query"] = scene.query_gbv(pts)
    refs["query_gbq"] = scene.query_gbq(pts)
    step = sharding.sharded_map_train_step(
        scene, torch.optim.SGD(scene.parameters(), lr=1e-2), None,
        loss_weights(cfg_b))
    refs["loss"], refs["params"], refs["step_ms"] = timed_steps(
        torch, step, scene, rays + [u], SHARDED_TIMED_STEPS)
    path = os.path.join(out_dir, "inputs.pt")
    torch.save({"tsdf": mv.state.tsdf.cpu(), "origin": mv.state.origin.cpu(),
                "dims": [int(d) for d in mv.dims],
                "voxel_size": float(mv.voxel_size),
                "layout": [int(v) for v in tr.brick_layout], "frame": fr,
                "frame0": f0,
                "init": torch.tensor(init), "rays": [r.cpu() for r in rays],
                "u": u.cpu(), "pts": pts.cpu(), "H": ds.H, "W": ds.W,
                "K": torch.tensor(np.asarray(ds.K(), np.float32))}, path)
    refs["map_inputs"] = (cfg_b, scene, rays, u)
    return path, refs


def sharded_rank(rank, world, path, cfg_a, cfg_b, out_dir, device="cuda"):
    """The [sharded] checks' runs on one rank of the world (the card
    launch.spawn set current): candidate-sharded tier costs and
    do_tracking on slice A's last frame, the slab-sharded fusion of that
    frame (the slab written to out_dir), the DP map step and the
    grid-sharded map step on bench_hashgrid.yaml's scene, and the
    interleaved dataflow over SHARDED_FRAMES frames of synthetic_bench.yaml.
    The launch counts are zeroed at the start and read before the one
    comparison launch (hash_table_grad against its plain version on this
    rank's own inputs)."""
    import numpy as np
    import torch

    from remixfusion_tpu_torch.ops import brick_eval as be
    from remixfusion_tpu_torch.ops import hash_enc as he
    from remixfusion_tpu_torch.ops.tsdf import VolumeState
    from remixfusion_tpu_torch.parallel import dryrun, sharding
    from remixfusion_tpu_torch.parallel.launch import Collectives, make_group
    from remixfusion_tpu_torch.tracking.rotracker import ROTracker

    dev = dryrun.rank_device(device)
    comm = Collectives(make_group())
    inp = torch.load(path)
    out = {"backend": comm.backend, "rank": rank}
    be.brick_eval_volume.launches = 0
    he.hash_table_grad.launches = 0
    t0 = time.time()

    tr = ROTracker(cfg_a, inp["H"], inp["W"], inp["K"].numpy(), inp["dims"],
                   inp["voxel_size"], inp["layout"], dev, group=comm)
    state = VolumeState(inp["tsdf"].to(dev), None, None,
                        inp["origin"].to(dev))
    fr = {k: v.to(dev) for k, v in inp["frame"].items()}
    vn = tr.vertex_normal_maps(fr["depth"])
    view = tr.track_view(state.tsdf)
    c2w = fr["c2w"]
    costs, shapes = [], []
    for cls in range(3):
        level = tr.class_level[cls]
        costs.append(tr.score_tier(
            cls, 0, level, 0, c2w[:3, :3], c2w[:3, 3],
            tr.init_search_size(), vn, view, state.origin).cpu())
        shapes.append((int(tr.pst_t_rank[cls].shape[2]), int(tr.tier_inputs(
            level, 0, c2w[:3, :3], c2w[:3, 3], tr.init_search_size(), vn,
            state.origin)[1].shape[0])))
    out["costs"], out["tier_shapes"] = costs, shapes
    n0 = be.brick_eval_volume.launches
    out["pose"] = tr.do_tracking(state, inp["init"].to(dev),
                                 fr["depth"]).c2w.cpu().numpy()
    out["shift_pose"] = shifted_pose(
        torch, cfg_a, (inp["H"], inp["W"], inp["K"].numpy(), inp["dims"],
                       inp["voxel_size"], inp["layout"], dev),
        state, inp["init"].to(dev), fr["depth"], comm, SHIFT_SEED + rank)
    out["track_launches"] = be.brick_eval_volume.launches - n0
    del state, view, vn, tr

    R = int(cfg_a["globalV"]["base_resolution"])
    fuse = sharding.sharded_fuse_pack_gbq(
        comm, R, cfg_a["training"]["c_trunc"], inp["H"], inp["W"])
    slab = sharding.SlabGrid(R, comm, dev)
    fuse(slab, fr["depth"], fr["rgb"], fr["K"], c2w,
         torch.as_tensor(np.asarray(cfg_a["mapping"]["bound"], np.float32),
                         device=dev))
    out["slab"] = os.path.join(out_dir, f"slab_D{world}_r{rank}.pt")
    torch.save((slab.gbv.cpu(), slab.gbw.cpu(), slab.gbq.cpu()),
               out["slab"])
    out["bounds"] = fuse.bounds
    del slab

    lw = dryrun.loss_weights(cfg_b)
    batch = [r.to(dev) for r in inp["rays"]] + [inp["u"].to(dev)]
    scene, _ = map_scene(torch, cfg_b, inp["frame0"], dev)
    step = sharding.sharded_map_train_step(
        scene, torch.optim.SGD(scene.parameters(), lr=1e-2), comm, lw)
    comm.reset_traffic()
    with HashCalls() as hc:
        out["dp_loss"], out["dp_params"], out["dp_ms"] = timed_steps(
            torch, step, scene, batch, SHARDED_TIMED_STEPS)
    out["dp_launches"] = hc.launches
    out["dp_bytes"] = {k: v // SHARDED_TIMED_STEPS
                       for k, v in comm.bytes.items()}
    del scene, step

    gscene, slab = map_scene(torch, cfg_b, inp["frame0"], dev, comm,
                             whole=False)
    pts = inp["pts"].to(dev)
    m = pts.shape[0] // world
    out["query"] = gscene.query_gbv(pts[rank * m:(rank + 1) * m]).cpu()
    out["query_gbq"] = gscene.query_gbq(pts[rank * m:(rank + 1) * m]).cpu()
    gstep = sharding.gridsharded_map_train_step(
        gscene, torch.optim.SGD(gscene.parameters(), lr=1e-2), comm, lw)
    n0 = he.hash_table_grad.launches
    comm.reset_traffic()
    out["grid_loss"], out["grid_params"], out["grid_ms"] = timed_steps(
        torch, gstep, gscene, batch, SHARDED_TIMED_STEPS)
    out["grid_launches"] = he.hash_table_grad.launches - n0
    out["grid_bytes"] = {k: v // SHARDED_TIMED_STEPS
                         for k, v in comm.bytes.items()}
    out["grid_scene_holds_grid"] = gscene.gbv is not None
    out["slab_shape"] = tuple(slab.gbv.shape)
    del gscene, slab, gstep

    n0 = be.brick_eval_volume.launches
    flow = dryrun.interleaved_dataflow(
        comm, cfg_a, SHARDED_FRAMES, map_every=SHARDED_MAP_EVERY,
        n_rays=int(cfg_a["mapping"]["sample"]), device=dev)
    out["flow_launches"] = be.brick_eval_volume.launches - n0
    out["flow"] = {k: flow[k] for k in ("ate_rmse_cm_ro_only", "losses",
                                         "frame_ms", "step_ms",
                                         "step_bytes")}
    out["launches"] = {"brick_eval": be.brick_eval_volume.launches,
                       "hash_table_grad": he.hash_table_grad.launches}
    out["wall_s"] = time.time() - t0

    # the comparison launch: the kernel on this rank's captured inputs
    enc, x, g, n_rows = hc.calls[0]
    ref = he.hash_table_grad_reference(enc, x, g, n_rows)
    got = he.hash_table_grad(enc, x, g, n_rows)
    out["hash_shape"] = (int(x.shape[0]), int(n_rows))
    out["hash_err"] = float((got - ref).abs().max())
    out["hash_scale"] = float(ref.abs().max())
    return out


def close_params(got, ref, start, what):
    """The map step's parameters within STEP_RTOL / STEP_ATOL of the
    single-process step's, and each parameter's update from `start` within
    STEP_UPDATE_REL of the largest entry of the single-process update.
    Returns (the largest |d| of the parameters, the largest update error
    relative to that entry)."""
    import numpy as np

    worst, worst_upd = 0.0, 0.0
    for k, r in ref.items():
        d = np.abs(got[k] - r)
        if not (d <= STEP_ATOL + STEP_RTOL * np.abs(r)).all():
            fail(f"{what}: parameter {k} off by {float(d.max())}")
        want = r - start[k]
        scale = max(float(np.abs(want).max()), 1e-30)
        e = float(np.abs(got[k] - start[k] - want).max()) / scale
        if not e <= STEP_UPDATE_REL:
            fail(f"{what}: parameter {k}'s update off the single-process "
                 f"update by {e:.3e} of its largest entry {scale:.3e}")
        worst, worst_upd = max(worst, float(d.max())), max(worst_upd, e)
    return worst, worst_upd


def check_world(torch, D, res, refs, iters, R):
    """Every [sharded] check of one world's results against the
    single-process references; returns the world's record."""
    import numpy as np

    tag = f"[sharded D={D} {res[0]['backend']}]"
    rec = {"ranks": D, "backend": res[0]["backend"], "tiers": []}
    for cls in range(3):
        got = res[0]["costs"][cls].to(refs["kernel"][cls].device)
        if not all(torch.equal(r["costs"][cls], res[0]["costs"][cls])
                   for r in res):
            fail(f"{tag} tier {cls}: the ranks gathered other costs")
        if not torch.equal(got, refs["kernel"][cls]):
            fail(f"{tag} tier {cls}: the gathered costs are not the "
                 f"single-process kernel's bits")
        e_k = compare_costs(torch, got, refs["kernel"][cls],
                            f"{tag} tier {cls} vs the single-process kernel")
        e_p = compare_costs(torch, got, refs["plain"][cls],
                            f"{tag} tier {cls} vs the plain version")
        shapes = [r["tier_shapes"][cls] for r in res]
        rec["tiers"].append({"C": int(got.numel()),
                             "per_rank_C_P": shapes,
                             "max_abs_err_vs_kernel": e_k[0],
                             "max_abs_err_vs_plain": e_p[0]})
        print(f"{tag} tier {cls}: C={got.numel()}, per rank (C, P) "
              f"{shapes}; gathered costs bitwise the single-process "
              f"kernel's, vs plain max|d|={e_p[0]:.3e} mean|d|="
              f"{e_p[1]:.3e}; same 1e6 guards", flush=True)
    d = float(np.abs(res[0]["pose"] - refs["pose"]).max())
    if not d < POSE_TOL or any(not np.array_equal(r["pose"], res[0]["pose"])
                               for r in res):
        fail(f"{tag} do_tracking pose off the single-process one by {d}, "
             f"or the ranks differ")
    rec["pose_max_abs_diff"] = d
    d_shift = float(np.abs(res[0]["shift_pose"] - refs["shift_pose"]).max())
    d_other = float(np.abs(refs["shift_pose_other_seed"]
                           - refs["shift_pose"]).max())
    if not d_shift < POSE_TOL or any(
            not np.array_equal(r["shift_pose"], res[0]["shift_pose"])
            for r in res):
        fail(f"{tag} do_tracking with RO.sample_range {SHIFT_RANGE}: pose "
             f"off the single-process one from rank 0's seed by {d_shift}, "
             f"or the ranks differ")
    if not d_other > POSE_TOL:
        fail(f"{tag} another shift seed moves the single-process pose by "
             f"only {d_other}: the shift check cannot see a draw")
    rec["shift_pose_max_abs_diff"] = d_shift
    print(f"{tag} do_tracking with RO.sample_range {SHIFT_RANGE}, each "
          f"rank's shift generator seeded {SHIFT_SEED} + rank: pose vs the "
          f"single process from seed {SHIFT_SEED} max|d|={d_shift:.3e} "
          f"(from seed {SHIFT_SEED + 1}: {d_other:.3e})", flush=True)
    for r in res:
        want = {"track_launches": 2 * iters,
                "flow_launches": iters * (SHARDED_FRAMES - 1),
                "dp_launches": SHARDED_TIMED_STEPS,
                "grid_launches": SHARDED_TIMED_STEPS}
        got = {k: r[k] for k in want}
        if got != want:
            fail(f"{tag} rank {r['rank']}: launches {got}, expected {want}")
        if not r["hash_err"] <= HASH_TOL * r["hash_scale"]:
            fail(f"{tag} rank {r['rank']}: hash_table_grad off its plain "
                 f"version by {r['hash_err']} (scale {r['hash_scale']})")
    print(f"{tag} do_tracking pose vs single-process max|d|={d:.3e}; per "
          f"rank launches: brick_eval {iters} per tracked frame "
          f"({res[0]['track_launches']} in two tracks + dataflow "
          f"{res[0]['flow_launches']}), hash_table_grad 1 per map step; "
          f"hash_table_grad at N={res[0]['hash_shape'][0]} per rank vs "
          f"plain max|d|={max(r['hash_err'] for r in res):.3e}", flush=True)
    rec["hash_shape"] = res[0]["hash_shape"]
    rec["hash_max_abs_err"] = max(r["hash_err"] for r in res)

    slabs = [torch.load(r["slab"]) for r in res]
    for i, what in enumerate(("grid", "weights", "bf16 query mirror")):
        if not torch.equal(torch.cat([sl[i] for sl in slabs]),
                           refs["grid"][i].cpu()):
            fail(f"{tag} the concatenated slabs' {what} are not the "
                 f"single process's")
    print(f"{tag} fusion: slabs {[r['bounds'] for r in res]} of R={R} "
          f"concatenated bitwise integrate_global's grid and weights, and "
          f"their bf16 mirrors bitwise its rounding", flush=True)
    for r in res:
        os.remove(r["slab"])

    e_dp, u_dp = close_params(res[0]["dp_params"], refs["params"],
                              refs["params0"], f"{tag} DP map step")
    query = torch.cat([r["query"] for r in res])
    if not torch.equal(query, refs["query"].cpu()):
        fail(f"{tag} the slab query is not query_gbv's bits")
    query_gbq = torch.cat([r["query_gbq"] for r in res])
    if not torch.equal(query_gbq, refs["query_gbq"].cpu()):
        fail(f"{tag} the slabs' mirror query is not query_gbq's bits")
    if torch.equal(query_gbq, query):
        fail(f"{tag} the mirror query equals the float32 query: the "
             f"mirror was not read")
    e_grid, u_grid = close_params(res[0]["grid_params"], refs["params"],
                                  refs["params0"],
                                  f"{tag} grid-sharded map step")
    for k in ("dp_loss", "grid_loss"):
        if not abs(res[0][k] - refs["loss"]) <= 1e-4 * abs(refs["loss"]):
            fail(f"{tag} {k} {res[0][k]} vs single-process {refs['loss']}")
    if any(r["grid_scene_holds_grid"] for r in res):
        fail(f"{tag} the grid-sharded scene holds a grid")
    rec.update(dp_param_max_abs_diff=e_dp, grid_param_max_abs_diff=e_grid,
               dp_update_max_rel_err=u_dp, grid_update_max_rel_err=u_grid,
               dp_ms=res[0]["dp_ms"], grid_ms=res[0]["grid_ms"],
               single_step_ms=refs["step_ms"], dp_bytes=res[0]["dp_bytes"],
               grid_bytes=res[0]["grid_bytes"],
               slab_shape=res[0]["slab_shape"])
    print(f"{tag} DP map step: parameters vs single-process max|d|="
          f"{e_dp:.3e}, update max|d| {u_dp:.3e} of its largest entry, "
          f"loss {res[0]['dp_loss']:.6f} (single "
          f"{refs['loss']:.6f}); {res[0]['dp_ms']:.2f} ms per step "
          f"(single process {refs['step_ms']:.2f} ms); collective bytes per "
          f"step per rank {res[0]['dp_bytes']}", flush=True)
    print(f"{tag} grid-sharded map step: slab {res[0]['slab_shape']}, "
          f"the scene holds no grid, slab query bitwise "
          f"query_gbv and the slabs' mirror query bitwise query_gbq on "
          f"{query.shape[0]} points, parameters max|d|="
          f"{e_grid:.3e}, update max|d| {u_grid:.3e} of its largest "
          f"entry; {res[0]['grid_ms']:.2f} ms per step; collective "
          f"bytes per step per rank {res[0]['grid_bytes']}", flush=True)

    flow = res[0]["flow"]
    ate = flow["ate_rmse_cm_ro_only"]
    if not ate < ATE_BAR_CM:
        fail(f"{tag} dataflow RO-only ATE {ate} cm >= {ATE_BAR_CM}")
    rec["dataflow"] = {
        "frames": SHARDED_FRAMES, "ate_rmse_cm_ro_only": ate,
        "ms_per_frame": float(np.mean(flow["frame_ms"])),
        "ms_per_map_step": float(np.mean(flow["step_ms"])),
        "collective_bytes_per_map_step": flow["step_bytes"][-1],
        "losses": flow["losses"]}
    print(f"{tag} dataflow over {SHARDED_FRAMES} frames (map step every "
          f"{SHARDED_MAP_EVERY}): RO-only ATE {ate:.4f} cm, "
          f"{rec['dataflow']['ms_per_frame']:.2f} ms per frame, "
          f"{rec['dataflow']['ms_per_map_step']:.2f} ms per map step, "
          f"collective bytes per map step per rank {flow['step_bytes'][-1]}; "
          f"rank walls {[round(r['wall_s'], 1) for r in res]} s", flush=True)
    rec["launches"] = [r["launches"] for r in res]
    return rec


def phase_sharded(torch, slam, frames):
    """[sharded]: the scale-out path (parallel/, ROTracker(group=...)) in
    each world of SHARDED_WORLDS on the one card, every check against the
    single-process path on the card; then brick_eval at a rank's candidate
    slice and hash_table_grad at a rank's points against their plain
    versions, timed. Returns (record, brick_eval shapes, hash_table_grad
    shapes, launches summed over the worlds' ranks)."""
    import tempfile

    from remixfusion_tpu_torch.parallel.dryrun import pick_backend
    from remixfusion_tpu_torch.parallel.launch import spawn

    out_dir = os.path.join(ROOT, "build", "smoke", "sharded")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()
    path, refs = sharded_setup(torch, slam, frames, out_dir,
                               slice_config("B"))
    print(f"[sharded] inputs and single-process references on the card in "
          f"{time.time() - t0:.1f} s", flush=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        errs = spawn(nccl_probe_rank, 2, backend="nccl", device="cuda",
                     init_file=os.path.join(tmp, "rendezvous"),
                     timeout_s=120)
    if not all(e and "Duplicate GPU" in e for e in errs):
        fail(f"[sharded] NCCL was expected to refuse two ranks on one card "
             f"(the reason the 2-rank world runs on gloo): {errs}")
    print(f"[sharded] NCCL with 2 ranks on one card: refused ("
          f"{errs[0].strip().splitlines()[-1]})", flush=True)
    cfg_b = refs["map_inputs"][0]
    iters = int(slam.config["RO"]["particle_iter_lens"])
    R = int(slam.config["globalV"]["base_resolution"])
    record = {"worlds": []}
    launches = {"brick_eval": 0, "hash_table_grad": 0}
    for D in SHARDED_WORLDS:
        backend, why = pick_backend("cuda", D)
        print(f"[sharded] world of {D} rank(s) on the one card: backend "
              f"{backend} ({why})", flush=True)
        t1 = time.time()
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            res = spawn(sharded_rank, D, backend=backend, device="cuda",
                        init_file=os.path.join(tmp, "rendezvous"),
                        timeout_s=SHARDED_TIMEOUT_S,
                        args=(path, slam.config, cfg_b, out_dir))
        rec = check_world(torch, D, res, refs, iters, R)
        rec["wall_s"] = time.time() - t1
        record["worlds"].append(rec)
        for r in res:
            for k in launches:
                launches[k] += r["launches"][k]
    os.remove(path)

    # a rank's kernel shapes (world of 2), timed against the plain versions
    brick_shapes = []
    for args in refs["tiers"]:
        table = args[-1]
        C = table.shape[1]
        half = torch.cat([table[:, :1], table[:, C // 2:]], 1).contiguous()
        brick_shapes += check_brick_case(torch, args[:-1] + (half,),
                                         "sharded rank 1 of 2", split_for=C)
    cfg_b, scene, rays, u = refs["map_inputs"]
    hash_shapes = sharded_hash_shapes(torch, cfg_b, scene, rays, u)
    return record, brick_shapes, hash_shapes, launches


def sharded_hash_shapes(torch, cfg_b, scene, rays, u):
    """hash_table_grad at a rank's points (the first half of the batch, a
    single-process step of those rays capturing its call) against its plain
    version, timed (phase 5's checks)."""
    from remixfusion_tpu_torch.parallel import sharding
    from remixfusion_tpu_torch.parallel.dryrun import loss_weights

    m = rays[0].shape[0] // 2
    step = sharding.sharded_map_train_step(
        scene, torch.optim.SGD(scene.parameters(), lr=1e-2), None,
        loss_weights(cfg_b))
    with HashCalls() as hc:
        step(*(r[:m] for r in rays), u=u[:m])
    return phase_hash_kernel(torch, hc.calls,
                             table="HashGrid, a rank's half of the batch")


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
    from remixfusion_tpu_torch.datasets import synthetic
    from remixfusion_tpu_torch.ops import brick_eval as be
    from remixfusion_tpu_torch.ops import hash_enc as he

    print(f"[host] {os.cpu_count()} CPUs, {len(os.sched_getaffinity(0))} "
          f"usable; frames render in up to {synthetic._RENDER_WORKERS} "
          f"worker processes",
          flush=True)
    wall = {}
    t0 = time.time()
    phase_build()
    wall["build"] = time.time() - t0
    t0 = time.time()
    slam, out_a, launches_a = phase_slice(torch, "A")
    check_mirror(torch, slam, out_a["frames"])
    wall["slice A"] = time.time() - t0
    t0 = time.time()
    phase_mesh(slam, out_a, "A")
    wall["mesh A"] = time.time() - t0
    t0 = time.time()
    brick = phase_kernels(torch, slam, out_a["frames"])
    wall["kernel brick_eval"] = time.time() - t0
    t0 = time.time()
    brick["mode_checks"] = phase_mode_kernels(torch, slam, out_a["frames"])
    wall["kernel brick and gather modes"] = time.time() - t0
    t0 = time.time()
    be.brick_eval_volume.launches = 0
    he.hash_table_grad.launches = 0
    phase_render(torch, slam, out_a)
    render_launches = {"brick_eval": be.brick_eval_volume.launches,
                       "hash_table_grad": he.hash_table_grad.launches}
    wall["render"] = time.time() - t0
    t0 = time.time()
    sharded, sharded_brick, sharded_hash, launches_s = phase_sharded(
        torch, slam, out_a["frames"])
    brick["shapes"] += sharded_brick
    wall["sharded"] = time.time() - t0
    del slam
    torch.cuda.empty_cache()

    t0 = time.time()
    slam, out_b, launches_b, captured = slice_b_captured(torch)
    wall["slice B"] = time.time() - t0
    t0 = time.time()
    phase_mesh(slam, out_b, "B")
    wall["mesh B"] = time.time() - t0
    t0 = time.time()
    if len(captured) != 2:
        fail(f"captured {len(captured)} hash_table_grad calls, expected 2")
    hash_shapes = phase_hash_kernel(torch, captured)
    wall["kernel hash_table_grad"] = time.time() - t0
    del slam, captured
    torch.cuda.empty_cache()
    t0 = time.time()
    hash_shapes += phase_dense_hash(torch) + sharded_hash
    hashk = hash_kernel_record(hash_shapes)
    wall["kernel hash_table_grad (DenseGrid)"] = time.time() - t0
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

    # the whole corridor walk first: its preload renders the 800 frames
    # into the disk cache that every later corridor phase reads
    benches = {}
    t0 = time.time()
    benches["corridor"] = phase_bench("corridor")
    wall["bench corridor"] = time.time() - t0
    print(f"[bench corridor] phase wall {wall['bench corridor']:.1f} s",
          flush=True)
    t0 = time.time()
    slam, out_c, launches_c, kept, cases = phase_corridor(torch)
    ro_corridor = slam.RO_c2w_data[:VARIANT_FRAMES].copy()
    wall["corridor"] = time.time() - t0
    t0 = time.time()
    for args in cases:
        brick["shapes"] += check_brick_case(torch, args, "corridor")
    wall["kernel brick_eval (corridor)"] = time.time() - t0
    del slam, cases
    torch.cuda.empty_cache()
    t0 = time.time()
    slam, _, launches_r = phase_corridor_resumed(torch, kept, out_c)
    wall["corridor resumed"] = time.time() - t0
    del slam, kept
    torch.cuda.empty_cache()
    t0 = time.time()
    _, launches_g = phase_gather(torch)
    wall["gather"] = time.time() - t0
    torch.cuda.empty_cache()

    # this slice's phases: the corridor's variants, the float32 windows,
    # the 720p tiers and the final refinement
    def end_phase(name, t0):
        wall[name] = time.time() - t0
        print(f"[{name}] phase wall {wall[name]:.1f} s", flush=True)
        torch.cuda.empty_cache()

    new_launches = {}
    for label in VARIANTS:
        t0 = time.time()
        _, new_launches[label], calls = phase_variant(
            torch, label, ro_corridor)
        if calls:
            hashk["shapes"] += phase_hash_kernel(
                torch, calls, table="HashGrid corridor")
        del calls
        end_phase(label, t0)
    t0 = time.time()
    new_launches["f32 windows"], shapes, f32_vs_bf16 = phase_f32(torch)
    brick["shapes"] += shapes
    brick["f32_vs_bf16"] = f32_vs_bf16
    end_phase("f32 windows", t0)
    slice_a_pixels = [s["P"] for s in brick["shapes"]
                      if s["phase"] == "A" and s["interp"] == "nearest"]
    for label in ("720p_refstride", "720p"):
        t0 = time.time()
        new_launches[tag_of(label)], shapes = phase_720p(
            torch, label, slice_a_pixels)
        brick["shapes"] += shapes
        end_phase(tag_of(label), t0)
    t0 = time.time()
    new_launches["refine"] = phase_refine(torch)
    end_phase("refine", t0)

    mode_launches = {}
    for label in ("triplane", "fast", "dense", "brick", "ab_triplane",
                  "more"):
        t0 = time.time()
        slam, out_m, mode_launches[label] = phase_slice(torch, label)
        if label in ("triplane", "fast"):
            check_field(slam, label)
        if label == "triplane":
            phase_mesh(slam, out_m, label)
        if label == "dense":
            layout = (1,) + tuple(slam.mv.dims[1:])
            if slam.tracker.brick_layout != layout:
                fail(f"dense: brick_eval reads layout "
                     f"{slam.tracker.brick_layout}, expected {layout}")
            for args in tier_cases(torch, slam, out_m["frames"]):
                brick["shapes"] += check_brick_case(torch, args, "dense")
            brick["dense_fuse"] = dense_fuse_check(torch, slam,
                                                   out_m["frames"])
        if label == "brick":
            print(f"[slice brick] selections reused on "
                  f"{out_m['sel_reused']} of {out_m['tracked_frames']} "
                  f"frames (volume.sel_reuse 2)", flush=True)
            if not out_m["sel_reused"] > 0:
                fail("brick: no brick selection was reused")
        wall[label] = time.time() - t0
        del slam
        torch.cuda.empty_cache()

    t0 = time.time()
    launches_re = phase_render_eval(torch)
    wall["render eval"] = time.time() - t0
    torch.cuda.empty_cache()
    t0 = time.time()
    launches_live = phase_live(torch)
    wall["live"] = time.time() - t0
    torch.cuda.empty_cache()
    for label in ("A", "B"):
        t0 = time.time()
        benches[label] = phase_bench(label)
        wall[f"bench {label}"] = time.time() - t0

    brick["launches"] = launches_a["brick_eval"]
    brick["launches_by_slice"] = {"A": launches_a["brick_eval"],
                                  "B": launches_b["brick_eval"],
                                  **{f"real {k}": v
                                     for k, v in real_launches.items()},
                                  "corridor": launches_c["brick_eval"],
                                  "corridor resumed":
                                      launches_r["brick_eval"],
                                  "gather": launches_g["brick_eval"],
                                  **{k: v["brick_eval"]
                                     for k, v in mode_launches.items()},
                                  "render": render_launches["brick_eval"],
                                  "render eval": launches_re,
                                  "live": launches_live,
                                  "sharded": launches_s["brick_eval"],
                                  **{f"bench {k}": v["launches"]["brick_eval"]
                                     for k, v in benches.items()},
                                  **{k: v["brick_eval"]
                                     for k, v in new_launches.items()}}
    brick["launches_by_kind"] = {
        "A": launches_a["brick_eval_by_kind"],
        **{k: v["brick_eval_by_kind"] for k, v in new_launches.items()}}
    brick["sharded"] = sharded
    hashk["launches"] = launches_b["hash_table_grad"]
    hashk["launches_by_slice"] = {
        "A": launches_a["hash_table_grad"], "B": launches_b["hash_table_grad"],
        "corridor": launches_c["hash_table_grad"],
        "corridor resumed": launches_r["hash_table_grad"],
        "gather": launches_g["hash_table_grad"],
        **{k: v["hash_table_grad"] for k, v in mode_launches.items()},
        "render": render_launches["hash_table_grad"],
        "sharded": launches_s["hash_table_grad"],
        **{f"bench {k}": v["launches"]["hash_table_grad"]
           for k, v in benches.items()},
        **{k: v["hash_table_grad"] for k, v in new_launches.items()}}
    hashk["sharded"] = [{"ranks": w["ranks"], "backend": w["backend"],
                         "N_per_rank": w["hash_shape"][0],
                         "max_abs_err": w["hash_max_abs_err"]}
                        for w in sharded["worlds"]]
    for k in ("brick_eval", "hash_table_grad"):
        if not launches_s[k] > 0:
            fail(f"[sharded] {k} was never launched")
    print(json.dumps({"phase_wall_s": wall}), flush=True)
    print(json.dumps({"kernels": [brick, hashk]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
