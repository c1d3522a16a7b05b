"""Process groups, rank launch and the collectives of the scale-out path.

The counterpart of the JAX package's `make_mesh` (parallel/sharding.py):
where JAX lays a Mesh over the chips of one program, the port runs one
process per rank and joins them in a torch.distributed process group.

  - `spawn(fn, world, ...)` starts `world` ranks (start method `spawn`),
    joins them in a group through a `file://` rendezvous (so concurrent
    test workers never race for a TCP port) with an explicit timeout (a
    hung rank fails the run instead of hanging it), runs
    `fn(rank, world, *args)` on every rank and returns the ranks' results
    in rank order, or raises the first failed rank's traceback in the
    caller. `spawn` re-imports the module that defines `fn` in every rank,
    so that module imports only torch, numpy and this package.
  - `make_group(ranks)` returns the default group or a sub-group.
  - `Collectives(group)` is the one helper every collective goes through:
    all_reduce_sum, all_gather_cat, reduce_scatter_sum and broadcast_ (with
    sync_generator, which broadcasts a generator's state from the group's
    first rank). It uses the group's own backend, with no other path: gloo
    takes the CUDA tensors of all_reduce, all_gather and reduce_scatter
    itself, and NCCL refuses two ranks on one card ("Duplicate GPU
    detected"), which is why a world of several ranks on one card runs on
    gloo (chip_smoke.py's [sharded] phase checks both). It counts the bytes
    each kind of collective moved.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

KINDS = ("all_reduce", "all_gather", "reduce_scatter", "broadcast")
# how long spawn waits, after a rank process died without reporting, for
# another rank's report of the failure that took it down
GRACE_S = 15.0


def make_group(ranks=None):
    """The default process group (ranks None), or the sub-group of `ranks`.
    Like torch.distributed.new_group, every rank of the default group must
    make every sub-group, in the same order."""
    if ranks is None:
        return dist.group.WORLD
    return dist.new_group(ranks=sorted(int(r) for r in ranks))


class Collectives:
    """The collectives of one process group, with their traffic: `bytes`
    per kind, the bytes this rank hands to the collectives."""

    def __init__(self, group=None):
        self.group = make_group() if group is None else group
        self.world = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.backend = str(dist.get_backend(self.group))
        self.reset_traffic()

    def reset_traffic(self):
        self.bytes = dict.fromkeys(KINDS, 0)

    def _count(self, kind: str, t: torch.Tensor):
        self.bytes[kind] += t.numel() * t.element_size()

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the group, in place; returns it."""
        self._count("all_reduce", t)
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def all_gather_cat(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` (one shape on all ranks), concatenated along
        dim 0 in rank order."""
        self._count("all_gather", t)
        t = t.contiguous()
        out = t.new_empty((self.world * t.shape[0],) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t, group=self.group)
        return out

    def reduce_scatter_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Block `rank` (in dim 0) of the group's sum of `t`; dim 0 must be
        a multiple of the world."""
        n = t.shape[0]
        if n % self.world:
            raise ValueError(f"reduce_scatter_sum: {n} rows do not split "
                             f"over {self.world} ranks")
        self._count("reduce_scatter", t)
        out = t.new_empty((n // self.world,) + tuple(t.shape[1:]))
        dist.reduce_scatter_tensor(out, t.contiguous(), op=dist.ReduceOp.SUM,
                                   group=self.group)
        return out

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """The group's first rank's `t`, in place on every rank."""
        self._count("broadcast", t)
        src = dist.get_global_rank(self.group, 0)
        dist.broadcast(t, src=src, group=self.group)
        return t

    def sync_generator(self, generator: torch.Generator):
        """Give `generator` the state it has on the group's first rank, so
        every rank draws the same numbers from it next. The state travels
        on the device the backend takes (the generator's own for NCCL)."""
        state = generator.get_state()
        dev = (torch.device("cuda", torch.cuda.current_device())
               if self.backend == "nccl" else torch.device("cpu"))
        state = self.broadcast_(state.to(dev)).cpu()
        generator.set_state(state)


def collectives(group):
    """Collectives of a process group (a Collectives passes through); None
    for None (one process, no collectives)."""
    if group is None or isinstance(group, Collectives):
        return group
    return Collectives(group)


def world_rank(comm) -> tuple:
    """(world, rank) of a Collectives, (1, 0) for None."""
    return (1, 0) if comm is None else (comm.world, comm.rank)


def _rank_main(fn, rank, world, backend, device, init_file, timeout_s, args,
               results):
    """One rank: join the group, run fn, report (rank, ok, pickled result
    or traceback) on the results queue, then leave the group. The result is
    pickled here, by value: a tensor put on the queue as it is would travel
    as a shared-memory handle that dies with this process. The report is
    flushed into the pipe before the group is left: leaving it fails the
    ranks still waiting in a collective, and what they report (or their
    hard exit) must reach the caller after this rank's own failure."""
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index if dev.index is not None
                                  else rank % torch.cuda.device_count())
        else:
            torch.set_num_threads(1)
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    except Exception:  # no group to leave
        results.put((rank, False, traceback.format_exc()))
        return
    try:
        report = (rank, True, pickle.dumps(fn(rank, world, *args)))
    except Exception:  # the rank's boundary: the caller raises it
        report = (rank, False, traceback.format_exc())
    results.put(report)
    results.close()
    results.join_thread()
    dist.destroy_process_group()


def spawn(fn, world: int, *, backend: str, device="cuda", init_file: str,
          timeout_s: float = 600.0, args=()):
    """Run fn(rank, world, *args) on `world` new processes joined in one
    process group of `backend` ('gloo' or 'nccl'). Every rank's current
    device is `device`; 'cuda' without an index puts rank r on card r modulo
    the card count. `init_file` is the rendezvous file (a path that does
    not exist yet, on a file system every rank sees). Returns the ranks'
    results in rank order. Raises RuntimeError with the failed ranks'
    tracebacks (a rank process that dies without a report, within GRACE_S
    of another rank's report of a failure, is part of that failure), or
    when a rank process died and no report came within GRACE_S; or
    TimeoutError when the ranks have not all reported within timeout_s
    plus a minute to start. Every rank still running then is stopped."""
    if os.path.exists(init_file):
        raise ValueError(f"rendezvous file {init_file} exists already")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(
        fn, r, world, backend, str(device), os.path.abspath(init_file),
        timeout_s, tuple(args), results), daemon=True)
        for r in range(world)]
    for p in procs:
        p.start()
    got, failed = {}, {}
    died = None  # exit code of the first rank process gone unreported
    deadline = time.monotonic() + timeout_s + 60.0
    try:
        # drain the queue before joining: a rank blocks on a full pipe
        while len(got) + len(failed) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                if failed or died is not None:
                    break
                raise TimeoutError(
                    f"{world - len(got)} of {world} ranks did not report "
                    f"within {timeout_s + 60.0:.0f} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                gone = [r for r, p in enumerate(procs)
                        if r not in got and r not in failed
                        and p.exitcode not in (None, 0)]
                if gone and died is None:
                    # a rank that dies hard may be the echo of another
                    # rank's failure (its group torn down) whose report is
                    # still on its way: wait a grace window for it
                    died = procs[gone[0]].exitcode
                    deadline = min(deadline, time.monotonic() + GRACE_S)
                if failed and len(got) + len(failed) + len(gone) == world:
                    break
                continue
            if ok:
                got[rank] = pickle.loads(out)
            else:
                # a failed rank leaves the others waiting in a collective:
                # collect what else fails within a few seconds, then stop
                failed[rank] = out
                deadline = min(deadline, time.monotonic() + 5.0)
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        results.close()
    if failed:
        raise RuntimeError("\n".join(
            f"rank {r} of {world} failed:\n{tb}"
            for r, tb in sorted(failed.items())))
    if len(got) < world:
        raise RuntimeError(f"a rank process exited with code {died} "
                           f"before reporting")
    return [got[r] for r in range(world)]
