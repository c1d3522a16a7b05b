"""The correctness check on the CPU, at the tiny configuration: a clean run
is correct; the control (the reference in the precision below the
configuration's) fails the cell's limits; and a run with the timed path
broken underneath comes out not correct, once for each fault the cells can
have. The limits are the cpgrid.orbit cell's (but for the re-centre's),
so these runs also hold that a fault fails those limits and a sound tiny
run meets them.

    python -m pytest slambench/tests/test_slambench_correct.py -q
"""

from __future__ import annotations

import pytest
import torch

from slambench_tiny import orbit_limits, run_tiny

from harness import checks  # noqa: E402


@pytest.mark.parametrize("enc", ["CPGrid", "HashGrid"])
def test_a_sound_tiny_run_is_correct(tmp_path, enc):
    res = run_tiny(tmp_path, enc=enc)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 10 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert {"fps", "frame_p95_ms", "ate_cm", "setup_s"} == set(
        res["metrics"])


def test_the_traced_run_reports_the_per_layer_metrics(tmp_path):
    res = run_tiny(tmp_path, trace=True, enc="HashGrid")
    assert res["correct"], res["checks"]
    m = res["metrics"]
    for name in ("select.host_ms", "track.host_ms", "fuse.host_ms",
                 "integrate.host_ms", "map.host_ms", "ba.host_ms",
                 "track.ate_ro_cm", "device.frame_mfu_pct"):
        assert m[name]["value"] > 0, name
    # on the CPU no operation runs on a device: nothing to read
    assert "brick_eval.roofline_pct" not in m
    assert res["device"]["busy_s"] == 0.0
    assert list(res)[-2:] == ["breakdown", "checks"]


def test_the_control_fails_the_limits(tmp_path, monkeypatch):
    """The reference in the precision below the configuration's (float8
    window cells, bfloat16 fusion, TF32 products) put in the program's
    place fails at least one of the cell's numbers."""
    seen = {}
    orig = checks.compare

    def both(cfg, geom, cap, control=False):
        seen["control"] = orig(cfg, geom, cap, control=True)
        return orig(cfg, geom, cap, control=False)

    monkeypatch.setattr(checks, "compare", both)
    res = run_tiny(tmp_path)
    assert res["correct"]
    ok, rows = checks.judge(seen["control"], orbit_limits())
    assert not ok, rows


def _fault_track_unchanged(monkeypatch):
    from remixfusion_tpu_torch.tracking import rotracker

    def track(self, tsdf, origin, c2w_init, depth, *a, **k):
        return rotracker.TrackResult(
            c2w_init.clone(), self.init_search_size(), False,
            torch.zeros((), device=c2w_init.device))

    monkeypatch.setattr(rotracker.ROTracker, "track", track)


def _fault_track_altered(monkeypatch):
    from remixfusion_tpu_torch.tracking import rotracker

    orig = rotracker.ROTracker.track

    def track(self, *a, **k):
        res = orig(self, *a, **k)
        c2w = res.c2w.clone()
        c2w[0, 3] += 1e-3
        return res._replace(c2w=c2w)

    monkeypatch.setattr(rotracker.ROTracker, "track", track)


def _fault_fuse_unchanged(monkeypatch):
    from remixfusion_tpu_torch.tracking import volume

    monkeypatch.setattr(volume.MovingVolume, "fuse",
                        lambda self, *a, **k: None)


def _fault_integrate_unchanged(monkeypatch):
    from remixfusion_tpu_torch.mapping import mapper

    monkeypatch.setattr(mapper.Mapper, "integrate_keyframe",
                        lambda self, *a, **k: None)


def _fault_map_half_batch(monkeypatch):
    from remixfusion_tpu_torch.mapping import mapper

    orig = mapper.Mapper.map_loss

    def map_loss(self, rays, rays_o, rays_d, draw=None, generator=None):
        n = rays.shape[0] // 2
        return orig(self, rays[:n], rays_o[:n], rays_d[:n], draw, generator)

    monkeypatch.setattr(mapper.Mapper, "map_loss", map_loss)


def _fault_ba_half_batch(monkeypatch):
    from remixfusion_tpu_torch.mapping import mapper

    orig = mapper.Mapper.ba_loss

    def ba_loss(self, rays, ids, draw=None, generator=None):
        n = rays.shape[0] // 2
        return orig(self, rays[:n], ids[:n], draw, generator)

    monkeypatch.setattr(mapper.Mapper, "ba_loss", ba_loss)


def _fault_step_skipped(monkeypatch):
    """The optimizer's step left out: the gradient is right, the
    parameters stay as they were."""
    from remixfusion_tpu_torch.mapping import mapper

    def _step(opt, loss):
        opt.zero_grad(set_to_none=True)
        loss.backward()
        return loss.detach()

    monkeypatch.setattr(mapper.Mapper, "_step", staticmethod(_step))


def _fault_half_the_bricks(monkeypatch):
    """Every other brick of each frame's selection left out of its
    fusion."""
    from remixfusion_tpu_torch.slam import pipeline

    orig = pipeline.RemixFusionTorch._select_bricks

    def select(self, *a, **k):
        return orig(self, *a, **k)[::2]

    monkeypatch.setattr(pipeline.RemixFusionTorch, "_select_bricks",
                        select)


@pytest.mark.parametrize("fault,number", [
    (_fault_track_unchanged, "track.step_um"),
    (_fault_track_altered, "track.step_um"),
    (_fault_fuse_unchanged, "fuse.gap"),
    (_fault_integrate_unchanged, "integrate.gap"),
    (_fault_map_half_batch, "map.grad_rel"),
    (_fault_ba_half_batch, "ba.grad_rel"),
    (_fault_step_skipped, "map.update_rel"),
    (_fault_step_skipped, "ba.update_rel"),
    (_fault_half_the_bricks, "select.miss"),
])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault,
                                            number):
    fault(monkeypatch)
    res = run_tiny(tmp_path)
    assert not res["correct"]
    rows = {name: (v, lim) for name, v, lim in res["checks"]}
    v, lim = rows[number]
    assert not v <= lim, rows
