"""Host ms a frame in the brick selection on the frame's own path: the
program's slice.select.bricks span over the traced frames. Every frame
opens it to take the reused or the look-ahead selection; after a
re-centre moved the origin, neither serves and the selection is made
there (slice.select.bricks.inline), which is most of its time."""


def read(s):
    spans = s["span_s"]
    if "slice.select.bricks" not in spans:
        return None
    return 1e3 * spans["slice.select.bricks"] / s["frames"]
