"""CPU tests of the benchmark harness: the loader, the window arithmetic,
the trace reduction, the roofline counts, the import check and the entry
without a card. Run from the repository root:

    python -m pytest slambench/tests -q
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from slambench_tiny import BENCH, ROOT, make_tree

from harness import ate, checks, roofline, spec, trace, window  # noqa: E402

import run as bench_run  # noqa: E402


# ------------------------------------------------------------ loader


def test_every_cell_and_metric_of_the_benchmark_loads():
    bench = spec.load_benchmark(ROOT)
    for w in bench["workloads"]:
        cell = spec.Cell(bench, w["name"])
        cfg, n = cell.run_config()
        assert cfg["data"]["synthetic"]["n_frames"] == n
        numbers = set(checks.NUMBERS)
        assert numbers - {"recentre.gap"} <= set(cell.spec["limits"]) \
            <= numbers
        assert {m["name"] for m in cell.end_to_end()} == {
            "fps", "frame_p95_ms", "ate_cm", "setup_s"}
        for m in cell.per_layer():
            assert callable(spec.metric_reader(m["name"]))
    names = {m["name"] for m in bench["per_layer"]}
    assert len(names) == 12
    assert spec.Cell(bench, "cpgrid.orbit").per_layer() != spec.Cell(
        bench, "hashgrid.orbit").per_layer()


def test_a_cell_and_a_metric_are_added_by_files_alone(tmp_path):
    bench_dir = make_tree(tmp_path)
    with open(os.path.join(bench_dir, "traffic", "slow.json"), "w") as f:
        json.dump({"dataset": "synthetic", "degrees_per_frame": 0.6}, f)
    with open(os.path.join(bench_dir, "cells", "tiny.slow.json"), "w") as f:
        json.dump({"n_frames": 60, "warmup_frames": 3, "limits": {}}, f)
    with open(os.path.join(bench_dir, "metrics", "fixture.frames.py"),
              "w") as f:
        f.write("def read(s):\n    return 2.0 * s['frames']\n")
    path = os.path.join(str(tmp_path), "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "tiny.slow", "config": "tiny",
                               "traffic": "slow", "chips": 1, "why": "x"})
    bench["per_layer"].append({
        "name": "fixture.frames", "unit": "frames", "better": "higher",
        "source": "device_trace", "layer": "device", "moves": "fps",
        "workloads": ["tiny.slow"]})
    with open(path, "w") as f:
        json.dump(bench, f)
    cell = spec.Cell(spec.load_benchmark(str(tmp_path)), "tiny.slow",
                     bench_dir=bench_dir)
    cfg, n = cell.run_config()
    assert n == 60
    assert cfg["data"]["synthetic"]["orbit_degrees"] == pytest.approx(36.0)
    assert cfg["grid"]["enc"] == "CPGrid"
    names = [m["name"] for m in cell.per_layer()]
    assert "fixture.frames" in names
    assert spec.metric_reader("fixture.frames", bench_dir)(
        {"frames": 7}) == 14.0


def test_a_walk_keeps_its_own_frame_count():
    cfg = {"dataset": "synthetic", "data": {"synthetic": {"n_frames": 800}}}
    out, n = spec.apply_traffic(cfg, {"dataset": "synthetic_large"}, 800)
    assert out["dataset"] == "synthetic_large" and n == 800
    with pytest.raises(ValueError):
        spec.apply_traffic(cfg, {"dataset": "synthetic_large"}, 500)


# ------------------------------------------------------------ window


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_window_counts_the_closing_synchronise():
    clock = Clock()
    syncs = []

    def step(i):
        clock.t += 0.1 if i % 5 else 0.5

    def sync():
        syncs.append(clock.t)
        clock.t += 0.25

    w = window.run_window(step, 31, 1000, 3.0, sync, clock=clock)
    # frames 31.. until 3 s of host clock have passed since the first
    # synchronise: 31..48, a 0.5 s frame every fifth
    assert w["frames"] == 18 and w["next"] == 49
    assert len(syncs) == 2
    assert w["window_s"] == pytest.approx(sum(w["frame_s"]) + 0.25)
    assert window.fps(w) == pytest.approx(18 / w["window_s"])
    assert window.frame_p95_ms(w) == pytest.approx(500.0)
    assert not w["exhausted"]


def test_window_ends_when_the_sequence_runs_out():
    clock = Clock()

    def step(i):
        clock.t += 0.2

    w = window.run_window(step, 5, 10, 30.0, lambda: None, clock=clock)
    assert w["frames"] == 5 and w["exhausted"]
    assert window.fps(w) == pytest.approx(5.0)


def test_the_ate_continuation_steps_the_frames_the_window_left():
    done = []
    window.continue_to(done.append, {"next": 150}, 199)
    assert done == list(range(150, 200))
    done.clear()
    window.continue_to(done.append, {"next": 260}, 199)
    assert done == []


def test_ate_aligns_a_moved_trajectory_to_zero():
    import numpy as np

    rng = np.random.default_rng(0)
    gt = np.tile(np.eye(4), (50, 1, 1))
    gt[:, :3, 3] = rng.standard_normal((50, 3))
    th = 0.3
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1]])
    est = gt.copy()
    est[:, :3, 3] = gt[:, :3, 3] @ R.T + [1.0, -2.0, 0.5]
    assert ate.ate_cm(gt, est) < 1e-9
    est[:, 0, 3] += 0.01 * (np.arange(50) % 2 * 2 - 1)
    assert ate.ate_cm(gt, est) == pytest.approx(1.0, rel=0.05)


# ------------------------------------------------------------- trace


def test_idle_is_one_minus_the_union_of_device_intervals():
    # two streams overlap in [20, 30): the union is 50 ns, not 60
    dev = [(10, 30, "k1"), (20, 40, "k2"), (60, 80, "k3")]
    assert trace.union(dev) == [(10, 40), (60, 80)]
    assert trace.busy_ns(dev) == 50
    assert trace.busy_ns(dev, 15, 70) == 35


class Ev:
    def __init__(self, name, start, dur, dev):
        self._n, self._s, self._d, self._dev = name, start, dur, dev

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def activity_type(self):
        return "kernel" if self._dev else "cpu_op"


def test_summary_of_a_traced_window():
    events = [
        Ev(trace.WINDOW_SPAN, 0, 1000, False),
        Ev("slice.track", 0, 400, False),
        Ev("slice.select", 400, 100, False),
        Ev("map.map", 500, 500, False),
        Ev("brick_eval_kernel<0>", 100, 100, True),
        Ev("brick_eval_kernel<0>", 150, 100, True),
        Ev("Memcpy HtoD", 600, 50, True),
        Ev("slice.track", 100, 100, True),  # a span's GPU annotation
    ]
    s = trace.summarize(events, 1e-6, 2, 1)
    assert s["busy_s"] == pytest.approx(200e-9)
    assert s["kernels"] == 2
    assert s["span_s"]["slice.track"] == pytest.approx(400e-9)
    assert trace.kernel_time_s(s, "brick_eval") == pytest.approx(200e-9)
    gaps = dict(s["idle_gaps"])
    assert gaps["slice.track"] == pytest.approx(450e-9)
    assert gaps["map.map"] == pytest.approx(350e-9)
    assert sum(gaps.values()) == pytest.approx(800e-9)


# ----------------------------------------------------------- rooflines


@pytest.mark.parametrize("C,P,bound_ms", [(10240, 300, 0.0037),
                                          (3072, 1200, 0.0044),
                                          (1024, 4800, 0.0059)])
def test_brick_eval_bound_at_slice_a_tiers(C, P, bound_ms):
    """The §6 bounds of PERF.md (chip_smoke.py's count on the main path's
    inputs, operations-bound) lie between the count with no pair reaching
    a window and with every pair reaching one."""
    lo = roofline.bound_s(*roofline.brick_eval_counts(C, P, 8, 6, 0))
    hi = roofline.bound_s(*roofline.brick_eval_counts(C, P, 8, 6, C * P))
    assert lo * 1e3 <= bound_ms + 5e-5 and bound_ms - 5e-5 <= hi * 1e3
    ops, nbytes = roofline.brick_eval_counts(C, P, 8, 6, C * P)
    assert ops / roofline.PEAK_FP32 > nbytes / roofline.PEAK_BYTES


@pytest.mark.parametrize("n,bound_ms", [(151040, 0.0082), (29791, 0.0031)])
def test_hash_table_grad_bound_at_slice_b(n, bound_ms):
    ops, nbytes = roofline.hash_table_grad_counts(n, 16, 785816)
    assert roofline.bound_s(ops, nbytes) * 1e3 == pytest.approx(
        bound_ms, abs=5e-5)
    assert nbytes / roofline.PEAK_BYTES > ops / roofline.PEAK_FP32


def test_reached_pairs_counts_what_lands_in_the_image():
    import torch

    params = torch.zeros(32)
    params[0] = params[4] = params[8] = 1.0
    params[18:24] = torch.tensor([40.0, 40.0, 31.5, 23.5, 64.0, 48.0])
    pix = torch.zeros(3, 8)
    pix[:, 2] = 1.0
    pix[0, 0] = 0.1
    pix[1, 0] = 5.0           # far outside the image
    pix[2, 7] = 0.0           # an invalid pixel
    pix[:2, 7] = 1.0
    table = torch.zeros(6, 4)
    assert roofline.reached_pairs(params, pix, table) == 4
    cfg = {"grid": {"enc": "CPGrid"}, "pos": {"n_bins": 16},
           "decoder": {"geo_feat_dim": 15, "hidden_dim": 32,
                       "num_layers": 2, "num_layers_color": 2,
                       "hidden_dim_color": 32}}
    sdf, color = roofline.decoder_dims(cfg, roofline.encoding_dim(cfg))
    assert sdf == [144 + 48 + 1, 32, 16] and color == [48 + 3 + 15, 32, 3]


# ------------------------------------------------------------ imports


def test_the_import_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "remixfusion_tpu_torch_like", sys)
    assert "remixfusion_tpu" not in bench_run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert bench_run.loaded_forbidden() == ["jax"]


def test_what_a_run_imports_loads_no_jax(tmp_path):
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import run\n"
        "from harness import capture, checks, spec, trace, window, ate\n"
        "from reference import field, fusion, tracker\n"
        "import remixfusion_tpu_torch.slam, remixfusion_tpu_torch.ops.build\n"
        "from torch.profiler import profile\n"
        "print(run.loaded_forbidden())\n" % (BENCH, ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_entry_fails_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "cpgrid.orbit", "--seed", str(2 ** 31 + 7), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=str(tmp_path), env=env)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_the_entry_fails_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and slambench/."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), str(tmp_path))
    shutil.copytree(BENCH, os.path.join(str(tmp_path), "slambench"),
                    ignore=shutil.ignore_patterns("work", "__pycache__"))
    out = subprocess.run(
        [sys.executable, "slambench/run.py", "--workload", "cpgrid.orbit",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode != 0
    assert "{" not in out.stdout


# ---------------------------------------------------------- reference


@pytest.mark.parametrize("eps,wd,steps_before", [(1e-15, 0.0, 0),
                                                 (1e-8, 1e-6, 3)])
def test_the_reference_adam_step_is_torchs(eps, wd, steps_before):
    """The reference's Adam step from a captured state gives the parameter
    that torch.optim.Adam gives, to float32 rounding."""
    import torch

    from harness.capture import adam_state
    from reference import field

    g = torch.Generator().manual_seed(5)
    p = torch.nn.Parameter(torch.randn(300, 7, generator=g))
    opt = torch.optim.Adam([p], lr=0.01, betas=field.BETAS, eps=eps,
                           weight_decay=wd)
    for _ in range(steps_before):
        p.grad = torch.randn(300, 7, generator=g)
        opt.step()
    state = adam_state(opt.state.get(p))
    p0 = p.detach().clone()
    grad = torch.randn(300, 7, generator=g) * 1e-3
    p.grad = grad.clone()
    opt.step()
    ref = field.adam_step(p0, grad, state, 0.01, eps, wd)
    assert float((ref - p.detach()).abs().max()) <= 1e-7
    assert float((ref - p0).abs().max()) > 1e-3


def test_the_surface_bricks_lie_in_the_ports_near_band():
    """Every brick holding a strided depth point at the pose lies in the
    port's near-surface selection at that pose; the reference picks them
    without it."""
    import numpy as np
    import torch

    from reference import fusion
    from remixfusion_tpu_torch.ops import tsdf as tsdf_ops

    b, dims, vs = 8, (80, 64, 96), 0.05
    K = np.array([[40.0, 0, 31.5], [0, 40.0, 23.5], [0, 0, 1]], np.float32)
    rng = np.random.default_rng(2)
    depth = rng.uniform(0.5, 3.0, (48, 64)).astype(np.float32)
    depth[:6] = 0.0
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = (2.0, 1.5, 0.2)
    origin = np.zeros(3, np.float32)
    sel = tsdf_ops.BrickSelector(dims, b, vs, K, 48, 64)
    near, _ = sel.near_mask(origin, c2w, depth, 0.06)
    rows = fusion.surface_bricks(torch.from_numpy(depth),
                                 torch.from_numpy(K), torch.from_numpy(c2w),
                                 torch.from_numpy(origin), vs, dims, b)
    assert rows.numel() > 20
    assert bool(near[rows.numpy()].all())
    assert int(near.sum()) > rows.numel()


@pytest.mark.parametrize("off_vox", [(10, -20, 0), (3, 0, -7)])
def test_the_recentre_reference_matches_the_shifts(off_vox):
    """The reference's slicing shift against the port's whole-brick shift
    (brick-major) and its dense voxel shift."""
    import torch

    from reference import fusion
    from remixfusion_tpu_torch.ops import tsdf as tsdf_ops

    b, dims, vs = 10, (40, 30, 50), 0.05
    g = torch.Generator().manual_seed(3)
    nb = (40 // b) * (30 // b) * (50 // b)
    st = tsdf_ops.VolumeState(
        torch.rand((nb, b ** 3), generator=g),
        torch.rand((nb, b ** 3), generator=g) * 40,
        torch.rand((nb, b ** 3, 3), generator=g) * 255,
        torch.tensor([0.5, -1.0, 2.0]))
    new_origin = st.origin + torch.tensor(off_vox, dtype=torch.float32) * vs
    if all(o % b == 0 for o in off_vox):
        got = tsdf_ops.shift_volume_bm(st, new_origin, vs, (b, 3, 5), dims)
    else:
        dense = tsdf_ops.VolumeState(
            tsdf_ops.bm_to_dense(st.tsdf, dims, b),
            tsdf_ops.bm_to_dense(st.weight, dims, b),
            tsdf_ops.bm_to_dense(st.color, dims, b), st.origin)
        d = tsdf_ops.shift_volume(dense, new_origin, vs)
        got = tsdf_ops.VolumeState(tsdf_ops.dense_to_bm(d.tsdf, b),
                                   tsdf_ops.dense_to_bm(d.weight, b),
                                   tsdf_ops.dense_to_bm(d.color, b),
                                   d.origin)
    ref = fusion.recentre(st.tsdf, st.weight, st.color, st.origin,
                          new_origin, dims, b, vs)
    for a, r in zip(got[:3], ref):
        assert torch.equal(a, r)
    low = fusion.recentre(st.tsdf, st.weight, st.color, st.origin,
                          new_origin, dims, b, vs, torch.bfloat16)
    assert float((low[0] - ref[0]).abs().max()) > 1e-4


def test_the_trace_taps_keep_the_kernels_launch_counters():
    """brick_eval_volume and hash_table_grad count their launches on the
    function their modules name; the taps stand in for hash_table_grad
    there while the traced sub-window runs."""
    from harness.capture import TraceTaps
    from remixfusion_tpu_torch.ops import hash_enc
    from remixfusion_tpu_torch.tracking import rotracker

    class Scene:
        def mapping_losses(self, *a, **k):
            return None

        def smoothness(self, *a, **k):
            return None

    class Slam:
        scene = Scene()

    orig_hg, orig_be = hash_enc.hash_table_grad, rotracker.brick_eval_volume
    before = orig_hg.launches
    taps = TraceTaps(Slam()).start()
    try:
        assert hash_enc.hash_table_grad is not orig_hg
        hash_enc.hash_table_grad.launches += 2   # as the kernel path does
    finally:
        taps.stop()
    assert hash_enc.hash_table_grad is orig_hg
    assert rotracker.brick_eval_volume is orig_be
    assert orig_hg.launches == before + 2
    orig_hg.launches = before
