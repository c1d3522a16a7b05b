"""The comparison that decides `correct`: what the window's timed path
produced at the drawn frames and round, against the plain reference in
slambench/reference/, worked out from the same inputs.

Numbers compared (each against its limit in the cell's file):
  track.cost_rel    each iteration's candidate costs, scored on the
                    program's own inputs of that iteration (tier, pose,
                    search size): largest gap over the median reference
                    cost, worst iteration of the checked frames (a
                    differing low-count guard reads 1);
  track.step_um     the transform steps, replayed from the program's costs
                    (the reference follows the program step by step): the
                    gap between the reference's pose and search size and
                    the program's at every iteration and at the end,
                    translation plus rotation times 1 m plus search size,
                    micrometres (a differing tier reads infinity);
  select.miss       the bricks that the frame's fusion left out of the
                    reference's own selection: the bricks holding a depth
                    point of every 4th pixel back-projected at the pose the
                    frame was fused with, as a share of them, worst of the
                    checked frames;
  fuse.gap          the moving volume after the frame's fusion, every
                    voxel, against the reference's fusion of the bricks the
                    program's host selection picked (select.miss holds the
                    selection): the largest of |d tsdf|, |d weight| / 40
                    and the colour's gap beyond one of its 256 levels /
                    255;
  integrate.gap     the global grid after the keyframe's integrate, over
                    the same kind of voxels: |d tsdf|, |d colour|,
                    |d weight| / max(1, weight);
  map.grad_rel, ba.grad_rel   the gradient that the round's first map /
                    BA step hands its optimizer, by the worst leaf: the
                    gap of the norms over the larger of the reference's
                    norm of that leaf and of the median leaf; leaves whose
                    reference gradient is under a thousandth of the median
                    leaf's are left out (the step's loss is not compared:
                    the control moves it by as little as sound runs do);
  map.update_rel, ba.update_rel   the same steps' change of the
                    parameters, by the worst leaf, against the reference's
                    Adam step from the program's Adam state before the step
                    with the reference's gradient: the gap of the changes'
                    norms over the larger of the reference's change of
                    that leaf and of the median leaf, over the same leaves
                    (a step that leaves its parameters unchanged reads 1);
  recentre.gap      the moving volume after the window's first re-centre,
                    every voxel: |d tsdf|, |d weight| / 40, |d colour| /
                    255, and the origin's gap in voxels (cells whose
                    camera path re-centres the volume).
A cell compares the numbers its file gives limits for. `faults()` reads
select.miss and the updates on two faults planted in what the program
produced: half of each fused brick set dropped, and the parameters left
as they were before the step.
Every number is 0 for identical results. `control=True` computes the
reference in the precision below the configuration's (bf16 window cells
read as float8, the tracker's pose and search size and float32 fusion in
bfloat16, float32 matrix products in TF32): the control, which has to
fail.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from reference import field as ref_field  # noqa: E402
from reference import fusion as ref_fusion  # noqa: E402
from reference import tracker as ref_tracker  # noqa: E402

NUMBERS = ("track.cost_rel", "track.step_um", "select.miss", "fuse.gap",
           "integrate.gap", "map.grad_rel", "ba.grad_rel",
           "map.update_rel", "ba.update_rel", "recentre.gap")


def pose_gap_um(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    dt = float(torch.linalg.vector_norm(a[:3, 3] - b[:3, 3]))
    # the rotation angle between them from the chord ||Ra - Rb||_F =
    # 2 sqrt(2) sin(angle / 2), well conditioned at small angles
    chord = float(torch.linalg.matrix_norm(a[:3, :3] - b[:3, :3]))
    ang = 2.0 * math.asin(min(1.0, chord / (2.0 * math.sqrt(2.0))))
    return 1e6 * (dt + ang)


def tracker_gaps(rec, c2w, steps) -> tuple:
    """(cost gap, step gap) of one frame: the program's iterations
    (rec["iters"]) against the reference's replay of them."""
    prog = rec["iters"]
    cost = step = 0.0
    for i, (p, r) in enumerate(zip(prog, steps)):
        if tuple(p[:4]) != tuple(r[:4]):
            return math.inf, math.inf
        cost = max(cost, cost_gap(p[7], r[7]))
        pose = torch.eye(4, dtype=torch.float64)
        mine = torch.eye(4, dtype=torch.float64)
        pose[:3, :3], pose[:3, 3] = p[4].cpu(), p[5].cpu()
        mine[:3, :3], mine[:3, 3] = r[4].cpu(), r[5].cpu()
        step = max(step, pose_gap_um(pose, mine) + 1e6 * float(
            (p[6].double().cpu() - r[6].double().cpu()).abs().max()))
    return cost, max(step, pose_gap_um(rec["c2w"], c2w))


def cost_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    pg, rg = prog >= 1e6, ref >= 1e6
    if not torch.equal(pg, rg):
        return 1.0
    keep = ~rg
    if not bool(keep.any()):
        return 0.0
    scale = float(ref[keep].median())
    return float((prog[keep] - ref[keep]).abs().max()) / max(scale, 1e-12)


def _max(x) -> float:
    return float(x.max()) if x.numel() else 0.0


def fuse_gap(after, ref) -> float:
    """Over every voxel of the moving volume (the reference fused the
    program's bricks and left the others as they were)."""
    t1, w1, c1 = after
    rt, rw, rc = ref
    # the fused colour is rounded to a whole 0..255 level: a sum taken in
    # another order may land on the next level, so one level is no gap
    dc = torch.clamp((c1 - rc).abs() - 1.0, min=0.0)
    return max(_max((t1 - rt).abs()), _max((w1 - rw).abs()) / 40.0,
               _max(dc) / 255.0)


def integrate_gap(before, after, ref, band) -> float:
    v0, w0 = before
    v1, w1 = after
    rv, rw = ref
    changed = (v1 != v0).any(-1) | (w1 != w0)
    m = band | changed
    return max(_max((v1 - rv).abs()[m]),
               _max(((w1 - rw).abs() / torch.clamp(rw.abs(), min=1.0))[m]))


def norm_gap(prog: dict, ref: dict, leaves: list) -> float:
    """Worst leaf's |norm(prog) - norm(ref)| over max(norm(ref), the
    median leaf's reference norm)."""
    rn = {k: float(torch.linalg.vector_norm(ref[k])) for k in leaves}
    med = float(np.median(list(rn.values()))) if rn else 0.0
    worst = 0.0
    for k, r in rn.items():
        g = prog.get(k)
        p = float(torch.linalg.vector_norm(g)) if g is not None else 0.0
        worst = max(worst, abs(p - r) / max(r, med, 1e-30))
    return worst


def moving_leaves(ref_grads: dict) -> list:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's (the others move by round-off alone)."""
    rn = {k: float(torch.linalg.vector_norm(g)) for k, g in ref_grads.items()
          if g is not None}
    med = float(np.median(list(rn.values()))) if rn else 0.0
    return [k for k, r in rn.items() if r >= 1e-3 * med]


def grad_gap(prog: dict, ref: dict, leaves: list) -> float:
    """The gradients' norm gap over the moving leaves."""
    return norm_gap(prog, ref, moving_leaves({k: ref.get(k)
                                              for k in leaves}))


def update_gap(cfg, rec, after: dict, ref_grads: dict) -> float:
    """The step's parameter change against the reference's Adam step from
    the program's Adam state before it, over the moving leaves."""
    prog, ref = {}, {}
    for k in moving_leaves(ref_grads):
        p0 = rec["params"][k]
        lr, eps, wd = ref_field.adam_settings(cfg, k)
        ref[k] = ref_field.adam_step(p0, ref_grads[k], rec["adam"].get(k),
                                     lr, eps, wd) - p0
        if after.get(k) is not None:
            prog[k] = after[k] - p0
    return norm_gap(prog, ref, list(ref))


def selection_miss(rec, geom, ids=None) -> float:
    """Share of the reference's surface bricks missing from the frame's
    fused bricks (`ids`, default the program's)."""
    depth, _, K, c2w, _ = rec["fuse_args"]
    ref = ref_fusion.surface_bricks(depth, K, c2w, rec["fuse_before"][3],
                                    geom["voxel_size"], geom["dims"],
                                    geom["layout"][0])
    if ref.numel() == 0:
        return 0.0
    ids = rec["fuse_ids"] if ids is None else ids
    held = torch.isin(ref, ids.to(device=ref.device, dtype=torch.int64))
    return float((~held).sum()) / ref.numel()


def _gen(device, state):
    g = torch.Generator(device=device)
    g.set_state(state)
    return g


def field_step(cfg, rec, kind, control):
    """(gradient gap, update gap, reference gradients) of a captured map
    or BA step."""
    dev = rec["rays"].device
    f = ref_field.Field(cfg, control=control)
    P = {k: v.clone() for k, v in rec["params"].items()}
    leaves = (f.map_leaves(P) if kind == "map"
              else ref_field.rba_leaves(P))
    for k in leaves:
        P[k].requires_grad_(True)
    gen = _gen(dev, rec["gen_state"])
    if kind == "map":
        loss = f.map_loss(P, rec["gbv"], rec["rays"], rec["rays_o"],
                          rec["rays_d"], gen)
    else:
        loss = f.ba_loss(P, rec["gbv"], rec["rays"], rec["ids"],
                         rec["num_kf"], gen)
    grads = dict(zip(leaves, torch.autograd.grad(
        loss, [P[k] for k in leaves])))
    return (grad_gap(rec["grads"], grads, leaves),
            update_gap(cfg, rec, rec["after"], grads), grads)


def compare(cfg, slam_geom: dict, cap, control: bool = False) -> dict:
    """Every number of the module docstring from a finished Capture.
    slam_geom: the tracker's geometry (H, W, K, dims, voxel_size, layout,
    trunc, clamp_w, kf_every, bound)."""
    g = slam_geom
    dev = next(iter(cap.tracks.values()))["origin"].device
    wdt = torch.float8_e4m3fn if control else torch.bfloat16
    fdt = torch.bfloat16 if control else torch.float32
    tr = ref_tracker.Tracker(cfg, g["H"], g["W"], g["K"], g["dims"],
                             g["voxel_size"], g["layout"], dev,
                             window_dtype=wdt)
    out = dict.fromkeys(NUMBERS[:-1], 0.0)
    for f, rec in sorted(cap.tracks.items()):
        if len(rec["iters"]) == tr.iters:
            c2w, steps = tr.track(rec["fuse_before"][0], rec["origin"],
                                  rec["init"], rec["depth"],
                                  given=rec["iters"], state_dtype=fdt)
            cost, step = tracker_gaps(rec, c2w, steps)
        else:
            # the program did not run the configured iterations
            cost = step = math.inf
        out["track.cost_rel"] = max(out["track.cost_rel"], cost)
        out["track.step_um"] = max(out["track.step_um"], step)
        out["select.miss"] = max(out["select.miss"],
                                 selection_miss(rec, g))
        t0, w0, c0, origin = rec["fuse_before"]
        depth, rgb255, K, fc2w, obs = rec["fuse_args"]
        rt, rw, rc, _ = ref_fusion.fuse_local(
            t0, w0, c0, origin, g["layout"], depth, rgb255, K, fc2w,
            g["voxel_size"], g["trunc"], obs, g["clamp_w"], fdt,
            bricks=rec["fuse_ids"])
        out["fuse.gap"] = max(out["fuse.gap"], fuse_gap(
            rec["fuse_after"], (rt, rw, rc)))
        del rt, rw, rc
    r = cap.round
    depth, rgb, K, c2w, bound, obs = r["int_args"]
    gv, gw, band = ref_fusion.integrate_grid(
        *r["int_before"], depth, rgb, K, c2w, bound,
        cfg["training"]["c_trunc"], obs, fdt)
    out["integrate.gap"] = integrate_gap(r["int_before"], r["int_after"],
                                         (gv, gw), band)
    del gv, gw, band
    for kind in ("map", "ba"):
        out[f"{kind}.grad_rel"], out[f"{kind}.update_rel"], _ = field_step(
            cfg, r[kind], kind, control)
    if cap.recentre is not None:
        t0, w0, c0, o0 = cap.recentre["before"]
        t1, w1, c1, o1 = cap.recentre["after"]
        rt, rw, rc = ref_fusion.recentre(t0, w0, c0, o0, o1, g["dims"],
                                         g["layout"][0], g["voxel_size"],
                                         fdt)
        o_ref = o0.double() + torch.round(
            (o1.double() - o0.double()) / g["voxel_size"]) * g["voxel_size"]
        out["recentre.gap"] = max(
            _max((t1 - rt).abs()), _max((w1 - rw).abs()) / 40.0,
            _max((c1 - rc).abs()) / 255.0,
            float((o1.double() - o_ref).abs().max()) / g["voxel_size"])
    return out


def faults(cfg, slam_geom: dict, cap) -> dict:
    """select.miss and the update numbers on the planted faults: every
    other brick of each checked frame's fused set dropped, and each
    checked step's parameters left as they were."""
    out = {"select.miss": max(
        selection_miss(rec, slam_geom, rec["fuse_ids"][::2])
        for rec in cap.tracks.values())}
    for kind in ("map", "ba"):
        rec = cap.round[kind]
        _, _, grads = field_step(cfg, rec, kind, False)
        out[f"{kind}.update_rel"] = update_gap(cfg, rec, rec["params"],
                                               grads)
    return out


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, [[name, value, limit]]) over the numbers `limits` names:
    every one at or under its limit; a number without a reading or a
    limit, or not finite, fails."""
    rows, ok = [], True
    for name in limits:
        v = numbers.get(name)
        lim = limits.get(name)
        good = (v is not None and lim is not None and math.isfinite(v)
                and v <= lim)
        ok = ok and good
        rows.append([name, v, lim])
    return ok, rows
