"""The port's profiler spans (utils/spans.py): the gated helper, and the
spans a tiny CPU run opens inside the tracker's iterations, the brick
selection, the re-centre and the map and BA steps, each nested where its
name says."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from helpers import tiny_config
from remixfusion_tpu_torch.slam import RemixFusionTorch
from remixfusion_tpu_torch.utils import spans
from remixfusion_tpu_torch.utils.spans import span

torch.set_num_threads(1)

N = 8
ITERS = 3
MOVE = 4


def _ranges(prof):
    """[(start_ns, end_ns, name)] of the profile's user ranges."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(("slice.", "map.", "unit.")):
            s = int(e.start_ns())
            out.append((s, s + int(e.duration_ns()), e.name()))
    return sorted(out)


def _inside(child, parents):
    return [p for p in parents
            if p[0] <= child[0] and child[1] <= p[1]]


def test_the_span_records_a_range_only_under_a_profiler():
    off = span("unit.off")
    assert off is spans._OFF and off is span("unit.other")
    with off:
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("unit.outer"):
            with span("unit.outer.inner"):
                torch.ones(4).sum()
    got = _ranges(prof)
    assert [n for _, _, n in got] == ["unit.outer", "unit.outer.inner"]
    assert _inside(got[1], got[:1])
    assert span("unit.after") is spans._OFF


@pytest.fixture(scope="module")
def traced_run(tmp_path_factory):
    """A tiny run (gather scoring, a mapping round every 2 frames) with
    frames 2..N-1 under the profiler; the volume's re-centre anchor is set
    back 1.5 m before frame MOVE, so that frame moves the volume."""
    cfg = tiny_config(
        data={"output": str(tmp_path_factory.mktemp("spans")),
              "exp_name": "spans",
              "synthetic": {"n_frames": N + 1, "orbit_degrees": 20.0}},
        RO={"particle_iter_lens": ITERS, "PST_size": [64, 32, 16]})
    slam = RemixFusionTorch(cfg, device="cpu")
    shift = slam.mv._shift_to

    def marked_shift(new_bnds):
        with span("unit.shift"):
            return shift(new_bnds)

    slam.mv._shift_to = marked_shift
    slam.first_frame_mapping()
    slam.step(1, N)
    moves0 = len(slam.mv.frame_to_vrange)
    rounds0 = len(slam.round_ms)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(2, N):
            if i == MOVE:
                slam.mv.kfx -= 1.5
            slam.step(i, N)
    out = dict(ranges=_ranges(prof), cfg=cfg,
               moves=len(slam.mv.frame_to_vrange) - moves0,
               rounds=len(slam.round_ms) - rounds0,
               la_hit=slam.sel_la_hit[-(N - 2):])
    slam.close()
    return out


def _named(run, name):
    return [r for r in run["ranges"] if r[2] == name]


@pytest.mark.parametrize("child", ["slice.track.score",
                                   "slice.track.readback",
                                   "slice.track.update"])
def test_each_tracker_iteration_opens_its_spans_inside_slice_track(
        traced_run, child):
    tracks = _named(traced_run, "slice.track")
    assert len(tracks) == N - 2
    for t in tracks:
        inner = [r for r in _named(traced_run, child) if _inside(r, [t])]
        assert len(inner) == ITERS
    assert len(_named(traced_run, child)) == ITERS * (N - 2)
    vn = _named(traced_run, "slice.track.vn")
    assert len(vn) == N - 2 and all(_inside(r, tracks) for r in vn)


def test_the_tracker_spans_follow_each_other_within_an_iteration(
        traced_run):
    t = _named(traced_run, "slice.track")[0]
    kids = [r for r in traced_run["ranges"]
            if r[2].startswith("slice.track.") and _inside(r, [t])]
    assert [n for _, _, n in kids] == ["slice.track.vn"] + [
        "slice.track.score", "slice.track.readback",
        "slice.track.update"] * ITERS
    assert all(a[1] <= b[0] for a, b in zip(kids, kids[1:]))


@pytest.mark.parametrize("prefix,key", [("map.map", "iters"),
                                        ("map.ba", "BA_iters")])
def test_a_mapping_round_opens_each_step_span_once_a_step(traced_run,
                                                          prefix, key):
    rounds = traced_run["rounds"]
    assert rounds >= 2
    iters = int(traced_run["cfg"]["mapping"][key])
    outer = _named(traced_run, prefix)
    assert len(outer) == rounds
    for part in ("sample", "forward", "backward", "adam"):
        got = _named(traced_run, f"{prefix}.{part}")
        assert len(got) == iters * rounds, part
        assert all(_inside(r, outer) for r in got), part


def test_the_recentre_span_holds_the_volume_move(traced_run):
    select = _named(traced_run, "slice.select")
    for name in ("slice.select.recentre", "slice.select.bricks"):
        got = _named(traced_run, name)
        assert len(got) == N - 2 and all(_inside(r, select) for r in got)
    shifts = _named(traced_run, "unit.shift")
    assert traced_run["moves"] == 1 and len(shifts) == 1
    recentres = _named(traced_run, "slice.select.recentre")
    assert _inside(shifts[0], recentres) == [recentres[MOVE - 2]]


def test_the_shift_span_opens_only_on_a_move(traced_run):
    recentres = _named(traced_run, "slice.select.recentre")
    shifts = _named(traced_run, "slice.select.recentre.shift")
    assert traced_run["moves"] == 1 and len(shifts) == 1
    assert _inside(shifts[0], recentres) == [recentres[MOVE - 2]]
    assert _inside(_named(traced_run, "unit.shift")[0], shifts)


def test_the_inline_span_opens_only_for_a_selection_made_at_the_frame(
        traced_run):
    """A frame selects inline when no look-ahead selection serves it: the
    move at MOVE discards the one made for it at the old origin."""
    bricks = _named(traced_run, "slice.select.bricks")
    inline = _named(traced_run, "slice.select.bricks.inline")
    la_hit = traced_run["la_hit"]
    assert len(bricks) == len(la_hit) == N - 2
    assert la_hit[MOVE - 2] == 0 and 1 in la_hit
    for b, hit in zip(bricks, la_hit):
        assert len([r for r in inline if _inside(r, [b])]) == 1 - hit
    assert len(inline) == la_hit.count(0)


@pytest.mark.parametrize("version", ["center", "more"])
def test_each_recentre_policy_shifts_under_the_shift_span(version):
    """The translation policy (the anchor 1.5 m behind) and the 'more'
    policy (the camera turned from looking along z to along y) each move
    the volume once, inside slice.select.recentre.shift."""
    from remixfusion_tpu_torch.tracking.volume import MovingVolume

    mv = MovingVolume(tiny_config(volume={"version": version}), np.eye(4),
                      "cpu")
    c2w = np.eye(4)
    if version == "center":
        mv.kfx -= 1.5
    else:
        c2w[:3, :3] = [[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert mv.check_move(1, c2w)
    names = [n for _, _, n in _ranges(prof)]
    assert names == ["slice.select.recentre.shift"]


def test_the_recentre_records_nothing_with_no_profiler(monkeypatch):
    from remixfusion_tpu_torch.tracking.volume import MovingVolume

    def boom(name):
        raise AssertionError(f"range {name} recorded with no profiler")

    monkeypatch.setattr(spans, "record_function", boom)
    mv = MovingVolume(tiny_config(), np.eye(4), "cpu")
    origin = mv.vol_bnds[:, 0].copy()
    mv.kfx -= 1.5
    assert mv.check_move(1, np.eye(4))
    moved = mv.vol_bnds[:, 0] != origin
    assert moved.tolist() == [True, False, False]


class _Ev:
    def __init__(self, name, start, dur, kind="kernel", dev=True,
                 annotation=False):
        self._n, self._s, self._d, self._k, self._dev = (name, start, dur,
                                                         kind, dev)
        self._a = annotation

    def is_user_annotation(self):
        return self._a

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def activity_type(self):
        return self._k

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"


def test_profile_slice_counts_overlapping_streams_once():
    """Two kernels on two streams overlap in [20, 30): busy is their union
    (30 + 20 ns), not the sum of their times; span ranges and other
    annotations on the device, and host ops, are left out."""
    from types import SimpleNamespace

    from remixfusion_tpu_torch.tools import profile_slice

    assert profile_slice.union_ns([(10, 30), (20, 40)]) == 30
    assert profile_slice.union_ns([(10, 30), (20, 40), (60, 80),
                                   (62, 70)]) == 50
    events = [_Ev("k1", 10, 20), _Ev("k2", 20, 20),
              _Ev("Memcpy HtoD", 60, 20, kind="gpu_memcpy"),
              _Ev("slice.track", 0, 100, kind="gpu_user_annotation"),
              _Ev("map.map", 0, 100),
              _Ev("Optimizer.step#Adam.step", 0, 100, kind="",
                  annotation=True),
              _Ev("aten::add", 0, 100, kind="cpu_op", dev=False)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    assert profile_slice.busy_us(prof) == pytest.approx(50e-3)
