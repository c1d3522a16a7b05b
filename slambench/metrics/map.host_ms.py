"""Host ms a mapping round in the program's map.map span over the traced
sub-window's rounds."""


def read(s):
    t = s["span_s"].get("map.map")
    if t is None or not s["rounds"]:
        return None
    return 1e3 * t / s["rounds"]
