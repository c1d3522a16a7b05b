"""The corridor walk tracked on the CPU by the JAX package and by the port:
a witness of whether the port's tracker does what the JAX package's does
on the walk's room-3 tour (frames 340-375), where BASELINE.md's 800-frame
record reports a window creep of ~1.7 cm a frame.

Each package tracks configs/Synthetic/synthetic_corridor.yaml's walk at the
config's tracking widths (640x480, PST tiers 10240/3072/1024 x 20
iterations, bf16 track view, 2.5 cm voxels in the 400x160x400 moving
volume, far 8), frame by frame through track_frame from the ground-truth
pose of frame 0, with no mapping round (mapping never feeds the tracker's
poses): the RO-only trajectory that the record's RO-only ATE scores.

  python tests/corridor_witness.py run jax --frames 400 --out jax.npz
  python tests/corridor_witness.py run torch --frames 400 --out torch.npz
  python tests/corridor_witness.py compare jax.npz torch.npz
  python tests/corridor_witness.py lockstep --frames 390 --out step.npz

`run` renders the frames the shared disk cache lacks, tracks them and saves
the RO poses, the ground truth and the re-centre count. `compare` prints
one JSON line: for each package the RO-only ATE over the first 100, 200, ..
frames and over the tour, the largest per-frame drift increment (the
translation of the relative pose against the ground truth's) in the tour
and outside it, and the largest gap between the two trajectories.
`lockstep` runs the JAX pipeline free and, before each of its frames,
gives the port its volume, device pose chain, pending poses and predicted
pose (tests/test_torch_pipeline.py's lockstep at the corridor's widths):
per frame the gap between the two tracked poses (m, degrees) and whether
the re-centre bookkeeping is bitwise the JAX pipeline's; one JSON line
with the frames beyond 2 mm / 0.1 degrees, in the tour and outside it,
and on those frames which of the two poses lies nearer the ground truth.
"""

import argparse
import copy
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CONFIG = os.path.join(ROOT, "configs", "Synthetic", "synthetic_corridor.yaml")
TOUR = (340, 376)
SPAN = 100


def _config():
    from remixfusion_tpu_torch.config import load_config

    cfg = load_config(CONFIG)
    cfg["data"]["output"] = os.path.join(ROOT, "output", "corridor_witness")
    return cfg


def run_jax(cfg, n):
    from remixfusion_tpu.slam import RemixFusionTPU

    j = RemixFusionTPU(copy.deepcopy(cfg))
    p0 = j._first_pose(j.dataset[0])
    j.est_c2w_data[0] = p0
    j.RO_c2w_data[0] = p0
    for i in range(1, n):
        j.track_frame(i, j.dataset[i])
    j._harvest_pending_track()
    out = (j.RO_c2w_data[:n].copy(), np.asarray(j.pose_gt[:n]),
           len(j.mv.frame_to_vrange))
    j.close()
    return out


def run_torch(cfg, n):
    import torch

    from remixfusion_tpu_torch.slam import RemixFusionTorch

    torch.set_num_threads(4)
    s = RemixFusionTorch(copy.deepcopy(cfg), device="cpu")
    p0 = s._first_pose(s.dataset[0])
    s.est_c2w_data[0] = p0
    s.RO_c2w_data[0] = p0
    for i in range(1, n):
        s.track_frame(i, s.dataset[i])
    s._harvest()
    out = (s.RO_c2w_data[:n].copy(), np.asarray(s.pose_gt[:n]),
           len(s.mv.frame_to_vrange))
    s.close()
    return out


def lockstep(cfg, n):
    import torch
    from scipy.spatial.transform import Rotation

    from remixfusion_tpu.slam import RemixFusionTPU
    from remixfusion_tpu_torch.slam import RemixFusionTorch
    from remixfusion_tpu_torch.tracking.rotracker import TrackResult
    from remixfusion_tpu_torch.utils.convert import volume_state_from_numpy

    torch.set_num_threads(4)
    t = torch.tensor
    j = RemixFusionTPU(copy.deepcopy(cfg))
    s = RemixFusionTorch(copy.deepcopy(cfg), device="cpu")
    p0 = j._first_pose(j.dataset[0])
    j.est_c2w_data[0] = p0
    j.RO_c2w_data[0] = p0
    gaps, same_bounds, ours = [[0.0, 0.0]], [True], [p0]
    for i in range(1, n):
        init = np.asarray(
            j.est_c2w_data[0] if j._dev_pose_prev is None
            else j._predict_dev(j._dev_pose_prev, j._dev_pose_prev2,
                                j._dev_fit_prev))
        s.mv.state = volume_state_from_numpy(
            *(np.asarray(a) for a in j.mv.state), "cpu")
        if j._dev_pose_prev is not None:
            s._dev_pose_prev, s._dev_pose_prev2, s._dev_fit_prev = (
                t(np.asarray(a)) for a in (j._dev_pose_prev,
                                           j._dev_pose_prev2,
                                           j._dev_fit_prev))
        assert [p[0] for p in s._pending] == [
            fid for fid, _, _ in j._pending_track], i
        s._pending = [
            (fid, TrackResult(t(np.asarray(r.c2w)), None, True,
                              t(np.asarray(r.origin_value))), own)
            for (fid, r, _), (_, _, own) in zip(j._pending_track,
                                                s._pending)]
        s._predict_init = lambda: t(init)
        s.track_frame(i, s.dataset[i])
        j.track_frame(i, j.dataset[i])
        a = s._pending[-1][1].c2w.numpy().astype(np.float64)
        b = np.asarray(j._pending_track[-1][1].c2w, np.float64)
        ours.append(a)
        rel = a[:3, :3] @ b[:3, :3].T
        gaps.append([float(np.abs(a[:3, 3] - b[:3, 3]).max()),
                     float(np.degrees(
                         Rotation.from_matrix(rel).magnitude()))])
        same_bounds.append(
            bool(np.array_equal(s.mv.vol_bnds, j.mv.vol_bnds))
            and s.mv.start_id == j.mv.start_id
            and s.mv.frame_to_vrange.keys() == j.mv.frame_to_vrange.keys())
    j._harvest_pending_track()
    s._harvest()
    out = (np.array(gaps), np.array(same_bounds), np.array(ours),
           j.RO_c2w_data[:n].copy(), np.asarray(j.pose_gt[:n]),
           len(j.mv.frame_to_vrange))
    j.close()
    s.close()
    return out


def _ate_cm(est, gt, frames):
    from remixfusion_tpu_torch.tools.eval_ate import evaluate_ate

    return 100 * evaluate_ate({float(i): gt[i] for i in frames},
                              {float(i): est[i] for i in frames})["rmse"]


def _drift_cm(est, gt):
    """Per frame i >= 1: |t(rel_est) - t(rel_gt)| of the motion from
    frame i - 1 to i, in cm."""
    out = [0.0]
    for i in range(1, len(est)):
        re = np.linalg.inv(est[i - 1].astype(np.float64)) @ est[i]
        rg = np.linalg.inv(gt[i - 1].astype(np.float64)) @ gt[i]
        out.append(100 * float(np.linalg.norm(re[:3, 3] - rg[:3, 3])))
    return np.array(out)


def summary(ro, gt, recentres):
    n = len(ro)
    tour = [i for i in range(*TOUR) if i < n]
    drift = _drift_cm(ro, gt)
    rest = np.delete(drift, tour)
    return {
        "frames": n, "recentres": int(recentres),
        "finite": bool(np.isfinite(ro).all()),
        "ate_by_frames_cm": [[k, _ate_cm(ro, gt, range(k))]
                             for k in range(SPAN, n + 1, SPAN)],
        "ate_cm": _ate_cm(ro, gt, range(n)),
        "tour_ate_cm": _ate_cm(ro, gt, tour) if len(tour) > 2 else None,
        "tour_drift_cm_max": float(drift[tour].max()) if tour else None,
        "tour_drift_cm_mean": float(drift[tour].mean()) if tour else None,
        "other_drift_cm_max": float(rest.max()),
        "other_drift_cm_mean": float(rest.mean()),
        "error_cm_at": {str(i): 100 * float(np.linalg.norm(
            ro[i][:3, 3] - gt[i][:3, 3]))
            for i in (99, 199, 299, 339, 375, 399) if i < n},
    }


def main():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("package", choices=["jax", "torch"])
    r.add_argument("--frames", type=int, default=400)
    r.add_argument("--out", required=True)
    c = sub.add_parser("compare")
    c.add_argument("files", nargs=2)
    k = sub.add_parser("lockstep")
    k.add_argument("--frames", type=int, default=390)
    k.add_argument("--out", required=True)
    args = ap.parse_args()
    if args.cmd == "lockstep":
        gaps, same, ours, ro, gt, recentres = lockstep(_config(),
                                                       args.frames)
        np.savez(args.out, gaps=gaps, same_bounds=same, ours=ours, ro=ro,
                 gt=gt)
        off = (gaps[:, 0] >= 2e-3) | (gaps[:, 1] >= 0.1)
        tour = np.zeros(len(gaps), bool)
        tour[TOUR[0]:TOUR[1]] = True
        # each frame's tracked translation against the ground truth, from
        # the same inputs: the port's and the JAX pipeline's
        err_t = 100 * np.linalg.norm(ours[:, :3, 3] - gt[:, :3, 3], axis=1)
        err_j = 100 * np.linalg.norm(ro[:, :3, 3] - gt[:, :3, 3], axis=1)
        step = {}
        for name, sel in (("off", off), ("off_in_tour", off & tour)):
            step[name] = {
                "frames": int(sel.sum()),
                "port_closer": int((err_t[sel] < err_j[sel]).sum()),
                "jax_closer": int((err_j[sel] < err_t[sel]).sum()),
                "mean_cm_port_minus_jax": float(
                    (err_t[sel] - err_j[sel]).mean()) if sel.any()
                else None}
        print(json.dumps({
            "frames": args.frames, "recentres": recentres,
            "bounds_bitwise_every_frame": bool(same.all()),
            "gap_m_max": float(gaps[:, 0].max()),
            "gap_deg_max": float(gaps[:, 1].max()),
            "gap_m_median": float(np.median(gaps[1:, 0])),
            "tour_gap_m_max": float(gaps[tour, 0].max()) if tour.any()
            else None,
            "tour_gap_deg_max": float(gaps[tour, 1].max()) if tour.any()
            else None,
            "off_frames": np.flatnonzero(off).tolist(),
            "off_in_tour": int((off & tour).sum()),
            "gap_m_quantiles": [float(np.quantile(gaps[1:, 0], q))
                                for q in (0.5, 0.9, 0.99)],
            "off_frames_error_vs_gt": step,
            "jax": summary(ro, gt, recentres)}))
        return
    if args.cmd == "run":
        cfg = _config()
        from remixfusion_tpu_torch.datasets.factory import get_dataset

        t0 = time.perf_counter()
        rendered = get_dataset(copy.deepcopy(cfg)).render_missing(
            range(args.frames))
        t1 = time.perf_counter()
        fn = run_jax if args.package == "jax" else run_torch
        ro, gt, recentres = fn(cfg, args.frames)
        np.savez(args.out, ro=ro, gt=gt, recentres=recentres)
        print(json.dumps({"package": args.package, "rendered": rendered,
                          "render_s": t1 - t0,
                          "track_s": time.perf_counter() - t1,
                          **summary(ro, gt, recentres)}))
        return
    runs = [np.load(f) for f in args.files]
    gap = [100 * float(np.linalg.norm(a[:3, 3] - b[:3, 3]))
           for a, b in zip(runs[0]["ro"], runs[1]["ro"])]
    print(json.dumps({
        "files": args.files,
        "runs": [summary(d["ro"], d["gt"], d["recentres"]) for d in runs],
        "gap_cm_max": max(gap), "gap_cm_max_at": int(np.argmax(gap)),
        "gap_cm_by_frames": [[k, max(gap[:k])]
                             for k in range(SPAN, len(gap) + 1, SPAN)]}))


if __name__ == "__main__":
    main()
