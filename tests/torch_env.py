"""The environment of the processes that the port's tests start.

A child process starts torch with one thread per core of the host, and
beside the test workers that already hold those cores its run slows down
manyfold. Every child of a tests/test_torch_*.py test gets one OpenMP and
one MKL thread, unless the caller's environment already sets a count.
"""

from __future__ import annotations

import contextlib
import os

ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def child_env(**extra) -> dict:
    """os.environ with `extra`, and one thread where no count is set."""
    env = dict(os.environ, **extra)
    for k, v in ONE_THREAD.items():
        env.setdefault(k, v)
    return env


@contextlib.contextmanager
def one_thread_children():
    """os.environ with one thread where no count is set, for the block:
    the processes it spawns inherit it."""
    added = [k for k in ONE_THREAD if k not in os.environ]
    os.environ.update({k: ONE_THREAD[k] for k in added})
    try:
        yield
    finally:
        for k in added:
            os.environ.pop(k, None)
