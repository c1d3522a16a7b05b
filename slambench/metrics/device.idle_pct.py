"""Share (%) of the traced sub-window in which no operation ran on the
device: one minus the union of the device intervals over the window's
wall, which ends in a synchronise."""


def read(s):
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
