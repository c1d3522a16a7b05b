"""Kernel launches a frame: kernel events on the device in the traced
sub-window over its frames."""


def read(s):
    return s["kernels"] / s["frames"] if s["frames"] else None
