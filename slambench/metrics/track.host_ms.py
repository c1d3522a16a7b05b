"""Host ms a frame in the program's slice.track span over the traced frames."""


def read(s):
    t = s["span_s"].get("slice.track")
    return None if t is None else 1e3 * t / s["frames"]
