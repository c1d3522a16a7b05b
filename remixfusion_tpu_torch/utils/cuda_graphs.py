"""The port's one CUDA-graph layer: capture, replay and their count.

On a card the tracker's iterations and the map and BA loss bodies replay
as CUDA graphs, since the host cannot dispatch their small kernels one by
one as fast as the card runs them. `CudaGraphs` owns a capture's side
stream, its memory pools (one per family) and the capture itself; `run`
replays a keyed chain, captures it at the key's first call or runs it
eagerly where no graph serves. Every call a graph could serve is counted
(`note`); both `graph_hit` lists are readings of `hit()`.
"""

from __future__ import annotations

import contextlib

import torch


def feed(dst, src):
    """Copy src into a graph's fixed input dst, unless either is None or
    src is dst."""
    if dst is None or src is None or src is dst:
        return
    with torch.no_grad():
        dst.copy_(src)


class CudaGraphs:
    """The CUDA graphs of one owner on one device, and their count."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.graphs = {}   # run's key -> (CUDAGraph, its outputs)
        self.calls = 0     # calls a graph could serve
        self.replays = 0   # of them, those served by a replay
        self._read = (0, 0)
        self._stream = None
        self._pools = {}

    def note(self, replayed: bool):
        """Count one call, served by a replay or not."""
        self.calls += 1
        self.replays += int(replayed)

    def hit(self) -> int:
        """1 when calls were made since the last hit() and replays served
        them all, else 0."""
        calls, replays = self._read
        self._read = (self.calls, self.replays)
        n = self.calls - calls
        return int(n > 0 and self.replays - replays == n)

    @contextlib.contextmanager
    def side_stream(self):
        """The block on the capture stream, after the caller's stream's
        work so far; the caller's stream waits for the block's work."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            yield
        cur.wait_stream(self._stream)

    def capture(self, graph, fn, family=""):
        """fn()'s outputs, its ops captured into `graph` in the family's
        memory pool (call inside side_stream)."""
        if family not in self._pools:
            with torch.cuda.device(self.device):
                self._pools[family] = torch.cuda.graph_pool_handle()
        # thread_local: only this thread's unsafe calls end a capture
        graph.capture_begin(pool=self._pools[family],
                            capture_error_mode="thread_local")
        try:
            return fn()
        finally:
            graph.capture_end()

    def run(self, key, fn, graphed: bool):
        """fn()'s outputs. Graphed: the key's graph replayed (its outputs
        are overwritten by the key's next call), or at the key's first
        call fn run eagerly, which also warms it up, and then captured.
        Otherwise fn run eagerly."""
        entry = self.graphs.get(key) if graphed else None
        self.note(entry is not None)
        if entry is not None:
            entry[0].replay()
            return entry[1]
        out = fn()
        if graphed:
            graph = torch.cuda.CUDAGraph()
            with self.side_stream():
                self.graphs[key] = (graph, self.capture(graph, fn))
        return out
