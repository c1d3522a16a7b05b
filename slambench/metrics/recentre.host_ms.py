"""Host ms a frame in the moving volume's re-centre: the program's
slice.select.recentre span over the traced frames. Every frame opens it
for the policy's bounds arithmetic; a frame that moves the volume also
shifts the device state inside it (slice.select.recentre.shift)."""


def read(s):
    spans = s["span_s"]
    if "slice.select.recentre" not in spans:
        return None
    return 1e3 * spans["slice.select.recentre"] / s["frames"]
