"""Reduce a torch.profiler trace of the traced sub-window to a summary.

The device's busy time is the union of its operations' intervals (kernels,
copies and sets: an operation that overlaps another on a second stream is
counted once), the idle share one minus busy over the sub-window's wall,
which ends in a synchronise. Host spans are the program's record_function
ranges (slice.* of a frame, map.* of a mapping round), summed by name.
`window_summary` in the program's tools/profile_slice.py summed kernel
self times instead of taking their union; this is its repair.
"""

from __future__ import annotations

WINDOW_SPAN = "slambench.window"
SPAN_PREFIXES = ("slice.", "map.")


def _kind(e) -> str:
    try:
        return str(e.activity_type()).lower()
    except (AttributeError, RuntimeError):
        return ""


def split_events(events):
    """(device ops [(start_ns, end_ns, name)], host spans [(start_ns,
    end_ns, name)], the window span (start_ns, end_ns) or None) of raw
    profiler events."""
    device, spans, window = [], [], None
    for e in events:
        name = e.name()
        start = int(e.start_ns())
        end = start + int(e.duration_ns())
        on_device = "CUDA" in str(e.device_type())
        if on_device:
            kind = _kind(e)
            if "annotation" in kind or name.startswith(SPAN_PREFIXES) \
                    or name == WINDOW_SPAN or name.startswith("aten::"):
                continue
            device.append((start, end, name))
        elif name == WINDOW_SPAN:
            window = (start, end)
        elif name.startswith(SPAN_PREFIXES):
            spans.append((start, end, name))
    return device, spans, window


def union(intervals) -> list:
    """Merged [(start, end)] of possibly overlapping intervals."""
    out = []
    for s, e in sorted((s, e) for s, e, *_ in intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_ns(intervals, lo=None, hi=None) -> int:
    total = 0
    for s, e in union(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        total += max(0, e - s)
    return total


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def innermost(spans, t):
    """Name of the innermost host span open at t, or '(between spans)'."""
    best = None
    for s, e, name in spans:
        if s <= t < e and (best is None or s > best[0]):
            best = (s, name)
    return best[1] if best else "(between spans)"


def idle_gaps(device, spans, lo, hi, top=10):
    """The device's idle gaps in [lo, hi] summed by the innermost host
    span open when each began: [[name, seconds]], the largest first."""
    spans = sorted(spans)
    gaps, t = {}, lo
    for s, e in union(device) + [(hi, hi)]:
        s, e = max(s, lo), min(e, hi)
        if s > t:
            name = innermost(spans, t)
            gaps[name] = gaps.get(name, 0) + (s - t)
        t = max(t, e)
    return sorted(([n, g / 1e9] for n, g in gaps.items()),
                  key=lambda x: -x[1])[:top]


def summarize(events, window_s: float, frames: int, rounds: int) -> dict:
    """Summary of the traced sub-window for the metric readers."""
    device, spans, window = split_events(events)
    if window is None:
        lo = min((s for s, _, _ in device), default=0)
        hi = max((e for _, e, _ in device), default=0)
    else:
        lo, hi = window
    device = [d for d in device if d[1] > lo and d[0] < hi]
    by_name = {}
    for s, e, name in device:
        t, n = by_name.get(name, (0, 0))
        by_name[name] = (t + (e - s), n + 1)
    span_s = {}
    for s, e, name in spans:
        span_s[name] = span_s.get(name, 0.0) + (e - s) / 1e9
    return {
        "frames": frames, "rounds": rounds, "window_s": window_s,
        "busy_s": busy_ns(device, lo, hi) / 1e9,
        "kernels": sum(n for name, (_, n) in by_name.items()
                       if not is_copy(name)),
        "span_s": span_s,
        "device_time_s": {name: t / 1e9 for name, (t, _) in by_name.items()},
        "device_ops": sorted(([name[:160], t / 1e9]
                              for name, (t, _) in by_name.items()),
                             key=lambda x: -x[1])[:10],
        "idle_gaps": idle_gaps(device, spans, lo, hi),
    }


def kernel_time_s(summary: dict, needle: str) -> float:
    """Device seconds of the kernels whose name contains `needle`."""
    return sum(t for name, t in summary["device_time_s"].items()
               if needle in name)
