"""Share (%) of the card's FP32 peak (67 TFLOP/s) that the traced
sub-window's counted work reached: the tracker's candidate scoring as
brick_eval's operations and the map and BA steps' sample points through
both decoders, forward and backward, over the sub-window's wall."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from harness.roofline import PEAK_FP32  # noqa: E402


def read(s):
    if not s.get("ops"):
        return None
    return 100.0 * s["ops"] / (s["window_s"] * PEAK_FP32)
