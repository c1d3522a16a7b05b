"""The field's loss bodies, forward and backward, replayed as CUDA graphs.

A map or BA step dispatches thousands of small kernels through the field
query, the decoders, the rendering and the four losses, and as many again
through their autograd backward; on an H100 the host's dispatch, not the
card, sets the pace of a mapping round. `LossGraphs` captures a body's
forward and its backward once per shape key and replays them afterwards,
in the way torch.cuda.make_graphed_callables does: the forward replays
inside an autograd Function (`_Replay`), whose backward copies the
incoming output gradients into the backward graph's fixed inputs and
replays it.

What a body reads and is not fed (the parameters, the explicit grid and
its mirror) it reads in place, at addresses that are part of its key. What
it is fed (rays, targets, the generator's draws) is copied into fixed
tensors before each replay; the draws themselves stay eager, in the order
and shapes of the eager body, so a graphed step draws the same numbers.

The hash grid's table gradient stays the eager kernel launch of
ops/hash_enc.hash_table_grad: in a capture, a query whose table takes a
gradient (at points that take none) encodes with the table detached and
its output made a leaf (`defer`); the backward graph gives that leaf's
gradient, and after the replay the kernel turns it into the table's, one
launch per query, counted and seen as any eager launch.

Memory: each key's saved activations stay allocated between replays (the
autograd graph of its capture is kept), so another body's graphs cannot
reuse them. Bodies of one family share a memory pool, which is sound as
long as no other body of the family replays between a body's forward and
its backward: the map and BA bodies share one, the smoothness body, which
runs inside the map body's window, has its own. One key is kept per body
kind: a new shape replaces the old one, whose memory goes back to the
pool. A key's first call warms the body up on the capture stream, forward
and backward, captures it and replays it; its later calls replay. The
capture and the count are the scene's utils/cuda_graphs.CudaGraphs.
"""

from __future__ import annotations

import contextlib

import torch

from remixfusion_tpu_torch.ops import hash_enc
from remixfusion_tpu_torch.utils.cuda_graphs import feed


class _Body:
    """One key's forward and backward graph and the tensors they keep."""

    def __init__(self, key, fwd, fixed, outputs, n_diff, plan, tails,
                 table, enc):
        self.key = key
        self.fwd = fwd
        self.bwd = torch.cuda.CUDAGraph()
        self.fixed = fixed        # fed inputs' fixed copies (None kept)
        self.outputs = outputs    # graph outputs, autograd graph attached
        self.n_diff = n_diff      # outputs [:n_diff] are differentiable
        self.plan = plan          # per _Replay input: grads index or None
        self.tails = tails        # [(points, index of the leaf's grad)]
        self.table, self.enc = table, enc
        self.grad_outs = [torch.zeros_like(o) for o in outputs[:n_diff]]
        self.grads = None         # the backward graph's outputs
        self.gen = 0              # forward replays, to pair each backward

    def table_grad(self):
        """The deferred table's gradient: one kernel launch per query."""
        out = None
        for pts, i in self.tails:
            g = self.grads[i]
            if g is None:
                continue
            d = hash_enc.hash_table_grad(self.enc, pts, g,
                                         self.table.shape[0])
            out = d if out is None else out + d
        return out


class _Replay(torch.autograd.Function):
    """The forward graph's replay; its backward replays the backward
    graph."""

    @staticmethod
    def forward(ctx, body, *args):
        body.fwd.replay()
        body.gen += 1
        ctx.body, ctx.gen = body, body.gen
        outs = tuple(o.detach() for o in body.outputs)
        ctx.mark_non_differentiable(*outs[body.n_diff:])
        return outs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        body = ctx.body
        if ctx.gen != body.gen:
            raise RuntimeError("a graphed loss body's backward ran after "
                               "its next forward: its saved activations "
                               "are gone")
        for dst, g in zip(body.grad_outs, grads[:body.n_diff]):
            dst.copy_(g)
        body.bwd.replay()
        return (None,) + tuple(body.table_grad() if i is None
                               else body.grads[i] for i in body.plan)


@contextlib.contextmanager
def _aliased(module, params):
    """The parameters `params` swapped, where `module` and its submodules
    hold them, for leaves that share their storage; yields {id(param):
    alias}. A traced body then reads the parameters' memory but never
    reaches their gradient accumulators: those stay on the caller's
    stream, where the replays' gradients meet them (an accumulator made
    on the capture stream would make every replayed backward wait across
    streams, and one made on the caller's stream breaks the capture)."""
    aliases = {id(p): p.detach().requires_grad_(p.requires_grad)
               for p in params}
    swapped = []
    for mod in module.modules():
        for name, p in mod._parameters.items():
            if p is not None and id(p) in aliases:
                swapped.append((mod, name, p))
    for mod, name, p in swapped:
        mod._parameters[name] = aliases[id(p)]
    try:
        yield aliases
    finally:
        for mod, name, p in swapped:
            mod._parameters[name] = p


class LossGraphs:
    """A scene's graphed loss bodies; `graphs` (utils/cuda_graphs) captures
    them and counts every call."""

    # body kind -> its memory pool's family (see the module docstring)
    FAMILIES = {"map": "losses", "ba": "losses", "smoothness": "smoothness"}

    def __init__(self, module, graphs):
        self.module = module  # the scene whose parameters bodies read
        self.graphs = graphs
        self.bodies = {}   # body kind -> _Body
        self.tails = None  # while a body is traced: its deferred queries

    def defer(self, enc, table, pts):
        """The encoding at pts inside a capture, with the table's gradient
        deferred to the eager kernel (None outside a capture, or where the
        table takes no gradient or the points take one)."""
        if (self.tails is None or not table.requires_grad
                or pts.requires_grad):
            return None
        leaf = enc(table.detach(), pts).detach().requires_grad_()
        self.tails.append((pts, leaf))
        return leaf

    def run(self, kind, key, body, fed, params, table=None, enc=None,
            n_diff=1):
        """body(*fixed) -> a tuple of outputs, the first n_diff of them
        differentiable; fed: the tensors (or None) body is given; params:
        the parameters body reads, of which it differentiates those that
        take a gradient; table: the hash table whose gradient may be
        deferred (enc its encoding). Returns body's outputs from the
        graphs, overwritten by the kind's next call."""
        entry = self.bodies.get(kind)
        hit = entry is not None and entry.key == key
        self.graphs.note(hit)
        if not hit:
            entry = self._capture(kind, key, body, fed, params, table, enc,
                                  n_diff)
        for dst, src in zip(entry.fixed, fed):
            feed(dst, src)
        args = [p for p in params if p.requires_grad] + [
            x for x in fed if x is not None and x.requires_grad]
        return _Replay.apply(entry, *args)

    def _trace(self, body, fixed, params, table, fwd=None, family=None):
        """body's forward, captured into fwd (in the family's pool) when
        given, and what its backward differentiates: (outputs, wrt, plan,
        tails, deferred)."""
        self.tails = []
        with _aliased(self.module, params) as aliases:
            try:
                outputs = (tuple(body(*fixed)) if fwd is None else
                           self.graphs.capture(
                               fwd, lambda: tuple(body(*fixed)), family))
            finally:
                tails, self.tails = self.tails, None
        deferred = table if tails else None
        wrt, plan = [], []
        for p in params:
            if p.requires_grad:
                plan.append(None if p is deferred else len(wrt))
                if p is not deferred:
                    wrt.append(aliases[id(p)])
        for f in fixed:
            if f is not None and f.requires_grad:
                plan.append(len(wrt))
                wrt.append(f)
        tail_ix = []
        for pts, leaf in tails:
            tail_ix.append((pts, len(wrt)))
            wrt.append(leaf)
        return outputs, wrt, plan, tail_ix, deferred

    def _capture(self, kind, key, body, fed, params, table, enc, n_diff):
        """The key's graphs, after one warm-up of the body, forward and
        backward, on the capture stream (it builds what the body sets up
        lazily, outside the capture)."""
        self.bodies.pop(kind, None)  # its memory back to the pool first
        family = self.FAMILIES[kind]
        fixed = [None if x is None else
                 x.detach().clone().requires_grad_(x.requires_grad)
                 for x in fed]
        with self.graphs.side_stream():
            outputs, wrt, _, _, _ = self._trace(body, fixed, params, table)
            torch.autograd.grad(outputs[:n_diff], wrt,
                                [torch.ones_like(o)
                                 for o in outputs[:n_diff]],
                                allow_unused=True)
            del outputs, wrt
            fwd = torch.cuda.CUDAGraph()
            outputs, wrt, plan, tails, deferred = self._trace(
                body, fixed, params, table, fwd, family)
            entry = _Body(key, fwd, fixed, outputs, n_diff, plan, tails,
                          deferred, enc)
            entry.grads = self.graphs.capture(
                entry.bwd, lambda: torch.autograd.grad(
                    outputs[:n_diff], wrt, entry.grad_outs,
                    retain_graph=True, allow_unused=True), family)
        self.bodies[kind] = entry
        return entry
