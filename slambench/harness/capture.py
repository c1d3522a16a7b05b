"""Record, while the window runs, what the correctness check compares.

Hooks are set on the program's objects of this run (instance attributes,
no file of the program is touched) and copy, at the frames and the round
drawn from the seed, the inputs and outputs of: the tracker's call (the
volume it reads, the initial pose, the depth, the pose it returns, and at
every iteration the tier, pose and search size it scored and the costs it
got), the fusion of that frame into the
moving volume (the bricks it fused, the volume before and after), the
window's first
re-centre of the moving volume (before and after), and, in one mapping
round,
the keyframe integrate (the grid before and after), the round's first map
step and first BA step (the parameters and the grid they read, the ray
batch, the generator's state before the step's draws, the gradient the
optimizer gets, its Adam state before the step and the parameters after
it). The copies stay on the device until the window has closed;
`nbytes` counts them.

During the traced sub-window `TraceTaps` also records the shapes each
brick_eval launch and each hash_table_grad launch saw, and the sample
points of every map and BA step, for the roofline and MFU counts.
"""

from __future__ import annotations

import numpy as np
import torch


def _clone(x):
    return None if x is None else x.detach().clone()


def adam_state(st):
    """(steps taken, first moment, second moment) of one parameter's Adam
    state; None before its first step."""
    if not st:
        return None
    return (int(st["step"]), _clone(st["exp_avg"]),
            _clone(st["exp_avg_sq"]))


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


def draw_plan(seed: int, first: int, track_frames: int, span: int,
              round_lo: int, round_hi: int) -> dict:
    """Frames whose tracking and fusion are checked, and the frame after
    which the checked mapping round starts, drawn from the seed among the
    first `span` frames of the window."""
    rng = np.random.default_rng(seed & 0xFFFFFFFFFFFFFFFF)
    frames = sorted(int(f) for f in rng.choice(
        np.arange(first + 1, first + 1 + span), track_frames,
        replace=False))
    return {"track_frames": frames,
            "round_from": first + int(rng.integers(round_lo, round_hi))}


class Capture:
    def __init__(self, slam, plan: dict):
        self.slam = slam
        self.plan = plan
        self.frame = None
        self.tracks = {}
        self.round = None
        self.recentre = None
        self._in_round = None
        self._tracking = None
        self._grads_for = None
        names = {}
        for n, p in slam.scene.named_parameters():
            names[id(p)] = n
        self._names = names

    # ---------------------------------------------------------- install

    def install(self):
        slam = self.slam
        tr, mv, mapper = slam.tracker, slam.mv, slam.mapper
        orig_track, orig_score = tr.track, tr.score_tier
        orig_fuse = mv.fuse
        orig_round = slam.mapping_round
        orig_integrate = mapper.integrate_keyframe
        orig_map_loss, orig_ba_loss = mapper.map_loss, mapper.ba_loss
        orig_step = mapper._step
        want = set(self.plan["track_frames"])

        def track(tsdf, origin, c2w_init, depth, *a, **k):
            f = self.frame
            if f not in want or f in self.tracks:
                return orig_track(tsdf, origin, c2w_init, depth, *a, **k)
            # the volume it reads is copied by the fusion hook: nothing
            # writes it between the tracker and the fusion of a frame
            rec = {"origin": _clone(origin), "init": _clone(c2w_init),
                   "depth": _clone(depth), "iters": []}
            self._tracking = rec
            try:
                res = orig_track(tsdf, origin, c2w_init, depth, *a, **k)
            finally:
                self._tracking = None
            rec["c2w"] = _clone(res.c2w)
            self.tracks[f] = rec
            return res

        def score_tier(cls, slab, level, level_index, R, T, ss, *a, **k):
            value = orig_score(cls, slab, level, level_index, R, T, ss, *a,
                               **k)
            if self._tracking is not None:
                # each iteration's tier, pose and search size as the
                # program scored them, and the costs it got
                self._tracking["iters"].append(
                    (int(cls), int(slab), int(level), int(level_index),
                     _clone(R), _clone(T), _clone(ss), _clone(value)))
            return value

        def fuse(ids, depth, rgb255, K, c2w, obs_weight):
            f = self.frame
            rec = self.tracks.get(f)
            if rec is None or "fuse_after" in rec:
                return orig_fuse(ids, depth, rgb255, K, c2w, obs_weight)
            st = mv.state
            rec["fuse_before"] = (_clone(st.tsdf), _clone(st.weight),
                                  _clone(st.color), _clone(st.origin))
            rec["fuse_args"] = (_clone(depth), _clone(rgb255), _clone(K),
                                _clone(c2w), _clone(obs_weight))
            rec["fuse_ids"] = _clone(ids)
            out = orig_fuse(ids, depth, rgb255, K, c2w, obs_weight)
            st = mv.state
            rec["fuse_after"] = (_clone(st.tsdf), _clone(st.weight),
                                 _clone(st.color))
            return out

        orig_shift = mv._shift_to

        def shift_to(new_bnds):
            if self.recentre is not None or self.frame is None:
                return orig_shift(new_bnds)
            st = mv.state
            rec = {"frame": self.frame,
                   "before": (_clone(st.tsdf), _clone(st.weight),
                              _clone(st.color), _clone(st.origin))}
            out = orig_shift(new_bnds)
            st = mv.state
            rec["after"] = (_clone(st.tsdf), _clone(st.weight),
                            _clone(st.color), _clone(st.origin))
            self.recentre = rec
            return out

        def mapping_round(cur):
            if self.round is not None or cur < self.plan["round_from"]:
                return orig_round(cur)
            self.round = {"frame": cur}
            self._in_round = self.round
            try:
                return orig_round(cur)
            finally:
                self._in_round = None

        def integrate(depth, rgb, K, c2w, bound, *a, **k):
            r = self._in_round
            if r is None or "int_after" in r:
                return orig_integrate(depth, rgb, K, c2w, bound, *a, **k)
            s = slam.scene
            r["int_before"] = (_clone(s.gbv), _clone(s.gbw))
            r["int_args"] = (_clone(depth), _clone(rgb), _clone(K),
                             _clone(c2w), _clone(bound),
                             float(k.get("obs_weight", 1.0)))
            out = orig_integrate(depth, rgb, K, c2w, bound, *a, **k)
            r["int_after"] = (_clone(s.gbv), _clone(s.gbw))
            return out

        def state(gen):
            return {"params": self.params(), "gbv": _clone(slam.scene.gbv),
                    "gen_state": gen.get_state().clone()}

        def map_loss(rays, rays_o, rays_d, draw=None, generator=None):
            r = self._in_round
            if r is None or "map" in r or draw is not None:
                return orig_map_loss(rays, rays_o, rays_d, draw, generator)
            rec = state(generator)
            rec.update(rays=_clone(rays), rays_o=_clone(rays_o),
                       rays_d=_clone(rays_d))
            loss = orig_map_loss(rays, rays_o, rays_d, draw, generator)
            r["map"] = rec
            self._grads_for = rec
            return loss

        def ba_loss(rays, ids, draw=None, generator=None):
            r = self._in_round
            if r is None or "ba" in r or draw is not None:
                return orig_ba_loss(rays, ids, draw, generator)
            rec = state(generator)
            rec.update(rays=_clone(rays), ids=_clone(ids),
                       num_kf=int(slam.scene.num_kf))
            loss = orig_ba_loss(rays, ids, draw, generator)
            r["ba"] = rec
            self._grads_for = rec
            return loss

        def step(opt, loss):
            rec, self._grads_for = self._grads_for, None
            if rec is None:
                return orig_step(opt, loss)
            held = [p for g in opt.param_groups for p in g["params"]]
            rec["adam"] = {self._names[id(p)]: adam_state(opt.state.get(p))
                           for p in held}
            out = orig_step(opt, loss)
            rec["grads"] = {self._names[id(p)]: _clone(p.grad)
                            for p in held if p.grad is not None}
            rec["after"] = {self._names[id(p)]: _clone(p) for p in held}
            return out

        tr.track, tr.score_tier = track, score_tier
        mv.fuse = fuse
        mv._shift_to = shift_to
        slam.mapping_round = mapping_round
        mapper.integrate_keyframe = integrate
        mapper.map_loss, mapper.ba_loss = map_loss, ba_loss
        mapper._step = step
        return self

    def params(self) -> dict:
        """The scene's parameters and the RBA network's initial poses."""
        s = self.slam.scene
        out = {n: _clone(p) for n, p in s.named_parameters()}
        out["rba.init_r"] = _clone(s.rba.init_r)
        out["rba.init_t"] = _clone(s.rba.init_t)
        return out

    def complete(self, numbers=()) -> list:
        """What the window did not reach of what `numbers` compare: empty
        when every planned capture was made."""
        missing = [f"track frame {f}" for f in self.plan["track_frames"]
                   if "fuse_after" not in self.tracks.get(f, {})]
        r = self.round or {}
        for key in ("int_after", "map", "ba"):
            if key not in r or (key != "int_after"
                                and "after" not in r[key]):
                missing.append(f"round {key}")
        if "recentre.gap" in numbers and self.recentre is None:
            missing.append("a re-centre")
        return missing

    def nbytes(self) -> int:
        """Bytes of the copies held for the check."""
        return _nbytes([self.tracks, self.round, self.recentre])


class TraceTaps:
    """Shapes of each kernel launch and the field's sample points, recorded
    between start() and stop() (the traced sub-window)."""

    def __init__(self, slam):
        self.slam = slam
        self.brick = []
        self.hash = []
        self.points = {"map": 0, "ba": 0, "smooth": 0}
        self._undo = []

    def start(self):
        from remixfusion_tpu_torch.ops import hash_enc
        from remixfusion_tpu_torch.tracking import rotracker

        orig_be = rotracker.brick_eval_volume

        def brick_eval_volume(params, pix, base, tsdf_bm, layout, table,
                              **k):
            self.brick.append((params.detach().clone(), pix.detach().clone(),
                               table, k.get("interp", "nearest")))
            return orig_be(params, pix, base, tsdf_bm, layout, table, **k)

        orig_hg = hash_enc.hash_table_grad

        def hash_table_grad(enc, x, grad_out, n_rows):
            self.hash.append((int(x.shape[0]), int(enc.n_levels),
                              int(n_rows)))
            return orig_hg(enc, x, grad_out, n_rows)

        # the kernel's wrapper counts its launches on the function its
        # module names, which is this one while the taps are in
        hash_table_grad.launches = orig_hg.launches

        scene = self.slam.scene
        orig_losses, orig_smooth = scene.mapping_losses, scene.smoothness

        def mapping_losses(rays_o, rays_d, target_rgb, target_d,
                           clamp=False, *a, **k):
            n = int(rays_o.shape[0]) * int(scene.z_vals_shape(1)[1])
            self.points["ba" if clamp else "map"] += n
            return orig_losses(rays_o, rays_d, target_rgb, target_d, clamp,
                               *a, **k)

        def smoothness(sample_points=256, *a, **k):
            self.points["smooth"] += (int(sample_points) - 1) ** 3
            return orig_smooth(sample_points, *a, **k)

        rotracker.brick_eval_volume = brick_eval_volume
        hash_enc.hash_table_grad = hash_table_grad
        scene.mapping_losses = mapping_losses
        scene.smoothness = smoothness
        self._undo = [(rotracker, "brick_eval_volume", orig_be),
                      (hash_enc, "hash_table_grad", orig_hg)]
        return self

    def stop(self):
        for mod, name, fn in self._undo:
            tapped = getattr(mod, name)
            if hasattr(tapped, "launches"):
                fn.launches = tapped.launches
            setattr(mod, name, fn)
        scene = self.slam.scene
        del scene.mapping_losses
        del scene.smoothness
        self._undo = []
