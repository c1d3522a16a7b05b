"""Host ms a frame in the program's slice.fuse span over the traced frames."""


def read(s):
    t = s["span_s"].get("slice.fuse")
    return None if t is None else 1e3 * t / s["frames"]
