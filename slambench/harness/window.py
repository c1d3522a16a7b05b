"""The timed window and its arithmetic.

The frame accounting follows bench_torch.py's steady_state (frames over
the time they took, the device synchronised after the last), but over a
window of fixed seconds instead of a fixed frame count: frames are stepped
closed loop, each as soon as the previous returns, until the seconds have
passed or the sequence runs out; the window closes with a synchronise and
its length includes it.
"""

from __future__ import annotations

import time

import numpy as np


def run_window(step, first: int, n_frames: int, seconds: float, sync,
               clock=time.perf_counter) -> dict:
    """Step frames first, first + 1, .. until `seconds` have passed or
    frame n_frames - 1 is done."""
    times = []
    i = first
    sync()
    t0 = clock()
    deadline = t0 + seconds
    while i < n_frames and clock() < deadline:
        ts = clock()
        step(i)
        times.append(clock() - ts)
        i += 1
    sync()
    t1 = clock()
    return {"first": first, "next": i, "frames": len(times),
            "window_s": t1 - t0, "frame_s": times,
            "exhausted": i >= n_frames and t1 - t0 < seconds}


def fps(w: dict) -> float:
    """Frames completed in the window over its seconds, the closing
    synchronise included."""
    return w["frames"] / w["window_s"]


def frame_p95_ms(w: dict) -> float:
    """95th percentile (linear interpolation) of the per-frame step time
    over every frame of the window, in ms."""
    return float(np.percentile(np.asarray(w["frame_s"]) * 1e3, 95))


def continue_to(step, w: dict, last: int):
    """Step the frames after the window up to `last` (untimed), so that
    the trajectory covers frames 0..last whatever the window reached."""
    for i in range(w["next"], last + 1):
        step(i)
