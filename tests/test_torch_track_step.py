"""The tracker's device-side transform step against the host-branched step
it replaced, bitwise, on the CPU.

`ROTracker._step` computes both outcomes of an iteration (pose moved or
kept, search size blended with the EMA or not) and selects one with
torch.where on the device-side success, so that no host branch waits for
the readback and the step can replay as a CUDA graph. `_host_step` and
`_host_track` below keep the host-branched update as it was written
before, independently of the tracker's code: each iteration read the
success flag back and took the branch on the host. The tier scoring is
scripted, so each case fixes which iterations succeed: successes and
failures, an EMA chain, the count cap and a first-iteration failure.
"""

import numpy as np
import pytest
import torch

from helpers import tiny_config
from remixfusion_tpu_torch.tracking.rotracker import ROTracker

torch.set_num_threads(1)

H, W = 24, 32


def _tracker(iters, iterative_scale):
    cfg = tiny_config(RO={"particle_iter_lens": iters,
                          "iterative_scale": iterative_scale,
                          "depth_level": [4, 2, 1], "eval_mode": "pallas",
                          "PST_size": [256, 128, 64], "count_search": 50})
    K = np.array([[20.0, 0, 15.5], [0, 20.0, 11.5], [0, 0, 1]], np.float32)
    return ROTracker(cfg, H, W, K, (40, 40, 40), 0.05, (8, 5, 5), "cpu")


def _costs(n, success, rng):
    """A [n] cost vector whose step succeeds (some candidate below the
    identity's cost) or fails (none below it; ties do not improve)."""
    if success:
        value = 1.0 + 0.5 * rng.standard_normal(n)
        value[0] = 1.0
    else:
        value = 0.5 + rng.random(n)
        value[0] = 0.5
        value[rng.integers(1, n, 3)] = 0.5
    return torch.tensor(value, dtype=torch.float32)


def _quat_to_rot(q):
    qw, qx, qy, qz = q[0], q[1], q[2], q[3]
    return torch.stack([
        1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
        2 * (qx * qz + qy * qw),
        2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
        2 * (qy * qz - qx * qw),
        2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
        1 - 2 * (qx * qx + qy * qy)]).reshape(3, 3)


def _update_pst(tr, min_tsdf, mean_t, mean_q):
    s = torch.abs(torch.cat([mean_t, mean_q[1:]])) + tr.min_scale
    nrm = torch.sqrt((s * s).sum())
    return tr.scaling_coefficient * min_tsdf * s / nrm + tr.min_scale


def _host_step(tr, success, min_tsdf, mean_t, mean_q, R, T, ss, prev_ss,
               ema_flag):
    """The host-branched update of one iteration: (R, T, ss, prev_ss)."""
    if success:
        T = T + mean_t
        R = (_quat_to_rot(mean_q)[:, :, None] * R[None, :, :]).sum(1)
    ss_new = _update_pst(tr, min_tsdf, mean_t, mean_q)
    if ema_flag and success:
        ss_new = tr.beta * ss_new + (1 - tr.beta) * prev_ss
    elif success:
        prev_ss = ss_new
    return R, T, ss_new, prev_ss


def _host_track(tr, c2w, plan, seed):
    """The host-branched loop: (c2w, ss, first_ok, origin value, per
    iteration (cls, slab, level, level_index, R, T, ss))."""
    rng = np.random.default_rng(seed)
    R, T = c2w[:3, :3].clone(), c2w[:3, 3].clone()
    ss = tr.init_search_size()
    prev_ss = torch.zeros(6)
    count, level_index = 0, 5
    ema_flag, first_ok = False, False
    count_cap = min(tr.particle_iter_lens - 1, 19)
    calls = []
    for i in range(tr.particle_iter_lens):
        cls = count % 3
        slab = tr.slab_table[count]
        level = tr.class_level[cls]
        calls.append((cls, slab, level, level_index, R.clone(), T.clone(),
                      ss.clone()))
        value = _costs(tr.pst[cls].shape[1], plan[i], rng)
        success_t, min_tsdf, mean_t, mean_q = tr._cal_transform(
            value, tr.pst[cls][slab], ss)
        success = bool(success_t)
        assert success == plan[i]
        origin_val = value[0]
        R, T, ss, prev_ss = _host_step(tr, success, min_tsdf, mean_t, mean_q,
                                       R, T, ss, prev_ss, ema_flag)
        if success and count < count_cap:
            count += 1
        level_index = ((1 if tr.fix_level_index else level_index + 5)
                       % tr.depth_level[count])
        ema_flag = (ema_flag and success) or (success and tr.iterative_scale)
        if i == 0:
            first_ok = success
        if not success:
            count = 0
    out = torch.eye(4)
    out[:3, :3] = R
    out[:3, 3] = T
    return out, ss, first_ok, origin_val, calls


def _scripted_track(tr, c2w, plan, seed):
    """tr.track with its tier scoring replaced by the scripted costs."""
    rng = np.random.default_rng(seed)
    calls = []

    def score_tier(cls, slab, level, level_index, R, T, ss, vn, vol, origin):
        calls.append((cls, slab, level, level_index, R.clone(), T.clone(),
                      ss.clone()))
        return _costs(tr.pst[cls].shape[1], plan[len(calls) - 1], rng)

    tr.score_tier = score_tier
    depth = torch.full((H, W), 2.0)
    res = tr.track(torch.zeros(125, 512), torch.zeros(3), c2w, depth)
    return res, calls


def _pose(seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(4)
    q /= np.linalg.norm(q)
    c2w = torch.eye(4)
    c2w[:3, :3] = _quat_to_rot(torch.tensor(q, dtype=torch.float32))
    c2w[:3, 3] = torch.tensor(rng.uniform(-1, 1, 3), dtype=torch.float32)
    return c2w


S, F = True, False
PLANS = {
    # every iteration succeeds: the EMA blends from the second on
    "ema_chain": (8, True, [S] * 8),
    "first_fails": (8, True, [F, S, S, S, F, S, S, S]),
    "mixed": (10, True, [S, S, F, S, F, F, S, S, S, F]),
    # 24 successes: the count stops at 19, the last slab
    "count_cap": (24, True, [S] * 24),
    "no_ema": (10, False, [S, S, F, S, S, S, F, F, S, S]),
    "all_fail": (6, True, [F] * 6),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_track_matches_host_branched_loop(case):
    """track's iterations (tier, level index, pose and search size scored)
    and its result are bitwise the host-branched loop's."""
    iters, iterative_scale, plan = PLANS[case]
    tr = _tracker(iters, iterative_scale)
    assert not tr.graphed
    c2w = _pose(7)
    want_c2w, want_ss, want_first, want_origin, want_calls = _host_track(
        tr, c2w, plan, 11)
    res, calls = _scripted_track(tr, c2w, plan, 11)
    assert len(calls) == len(want_calls) == iters
    for got, want in zip(calls, want_calls):
        assert got[:4] == want[:4]
        for a, b in zip(got[4:], want[4:]):
            assert torch.equal(a, b)
    assert torch.equal(res.c2w, want_c2w)
    assert torch.equal(res.search_size, want_ss)
    assert res.first_iter_success == want_first == plan[0]
    assert torch.equal(res.origin_value, want_origin)
    assert tr.graph_hit == [0] * iters
    if case == "count_cap":
        assert [c[1] for c in calls[-4:]] == [tr.slab_table[19]] * 4
    if case == "all_fail":
        assert torch.equal(res.c2w, c2w)


def test_track_result_belongs_to_the_caller():
    """track keeps a call's pose and search sizes in fixed tensors that the
    next call overwrites; the TrackResult it returned holds none of them,
    so a later call leaves it as it was."""
    iters, iterative_scale, plan = PLANS["mixed"]
    tr = _tracker(iters, iterative_scale)
    res, _ = _scripted_track(tr, _pose(7), plan, 11)
    kept = [t.clone() for t in (res.c2w, res.search_size, res.origin_value)]
    later, _ = _scripted_track(tr, _pose(8), PLANS["no_ema"][2], 12)
    assert not torch.equal(later.c2w, kept[0])
    assert not torch.equal(later.search_size, kept[1])
    for got, want in zip((res.c2w, res.search_size, res.origin_value),
                         kept):
        assert torch.equal(got, want)


@pytest.mark.parametrize("success", [True, False])
@pytest.mark.parametrize("ema_flag", [True, False])
def test_step_matches_host_branches(success, ema_flag):
    """One _step against the host branch it replaces, on a table slab of
    each tier class, from a pose and search sizes off the identity."""
    tr = _tracker(8, True)
    rng = np.random.default_rng(3)
    c2w = _pose(5)
    for cls in range(3):
        table = tr.pst[cls][1]
        value = _costs(table.shape[0], success, rng)
        ss = torch.tensor(rng.uniform(0.005, 0.02, 6), dtype=torch.float32)
        prev_ss = torch.tensor(rng.uniform(0.005, 0.02, 6),
                               dtype=torch.float32)
        R, T = c2w[:3, :3].clone(), c2w[:3, 3].clone()
        got = tr._step(value, table, R, T, ss, prev_ss, ema_flag)
        success_t, min_tsdf, mean_t, mean_q = tr._cal_transform(value, table,
                                                                 ss)
        assert bool(got[0]) == bool(success_t) == success
        want = _host_step(tr, success, min_tsdf, mean_t, mean_q, R, T, ss,
                          prev_ss, ema_flag)
        for a, b in zip(got[1:], want):
            assert torch.equal(a, b)
