"""Ranks as processes: the counterpart of the reference's ``run_spmd`` and
``make_test_mesh``.

The reference runs each rank as its own program on its own device
(``jit(shard_map(fn))``); a rank reaches another's data only through
``lax.ppermute``.  The stacked mode of the port holds all P ranks in one
process as the leading dimension of every tensor.  *Process mode* holds a
contiguous block of ``P / n_procs`` ranks in each of ``n_procs`` processes:

* :class:`SpmdGroup` spawns the rank processes once (the ``spawn`` context:
  CUDA does not survive ``fork``), process ``i`` on ``devices[i %
  len(devices)]``, and runs functions on them one after another;
  :func:`run_spmd` is one call on a group of its own;
* each process builds a process-mode
  :class:`~repro_torch.core.comm.Communicator` (``lo``, ``n_local`` and its
  :class:`RankGroup`), so the schedules, written against ``comm.rank()`` and
  the transports, run unchanged on the rows it holds;
* a step whose pairs cross processes (:meth:`RankGroup.exchange`) copies
  each sender's row into the destination's receive slot of the step's
  parity, in memory every process maps: device buffers shared by CUDA IPC on
  the card, ``share_memory_()`` tensors on the CPU.  Then a host barrier,
  then each receiver copies out of its own slot;
* a packet-router tick's link exchange (:meth:`RankGroup.exchange_links`)
  moves every link's rows in one such step, one barrier a tick, and can
  sum a count over the group beside the barrier (the router's drain test).

Two hazards lie between a copy and the next step, and the stream is
synchronised before every barrier to close both: the receiver reads a slot
only after the sender's copy finished (read after write), and the slot of
parity ``e`` is written again only at step ``e + 2``, after its receiver
synchronised its read and passed barrier ``e + 1`` (write after read).

The control plane is the spawn context's queues and a barrier in shared
memory: no network, no ``torch.distributed``, no NCCL.  Every wait has a
timeout; a rank that raises breaks the barrier and sends its traceback to
the parent, which raises it and ends every rank process.  Slots are held
until a final barrier before teardown, so no process unmaps memory a peer
still reads.

The function a group runs must be importable by the rank processes (pickled
by name): a function of this package, or of a module that imports no JAX.
"""

from __future__ import annotations

import gc
import math
import os
import pickle
import queue
import time
import traceback
import weakref
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import torch

from .comm import Communicator, resolve_device

#: byte alignment of each member of a tuple step inside a slot
SLOT_ALIGN = 256
#: seconds any one wait (a barrier, a queue) may take before it fails
DEFAULT_TIMEOUT = 120.0
#: the slot bytes :func:`run_spmd` gives beyond the largest row of its
#: arguments when none is named (a tuple step's small members, alignment)
SLOT_MARGIN = 64 << 10


class BrokenGroup(RuntimeError):
    """A barrier of the rank group timed out or was broken by a rank that
    raised."""


class SpinBarrier:
    """A reusable barrier of ``parties`` processes in shared memory: the
    arrival count under a lock, the last arrival bumps a generation that the
    others poll (yielding the core while they wait).  A waiter takes the lock
    once after the generation moved, which orders its later reads after
    every other party's writes before arriving.  :meth:`abort` breaks it for
    every waiter, now and later.  ``board`` holds a number a party and
    parity, published before a wait and read after it (a group-wide sum)."""

    def __init__(self, ctx, parties: int):
        self.parties = parties
        self._lock = ctx.Lock()
        self._count = ctx.RawValue("i", 0)
        self._gen = ctx.RawValue("q", 0)
        self._broken = ctx.RawValue("i", 0)
        self.board = ctx.RawArray("q", 2 * parties)

    def abort(self):
        self._broken.value = 1

    def wait(self, timeout: float = DEFAULT_TIMEOUT):
        if self._broken.value:
            raise BrokenGroup("the rank group's barrier is broken")
        with self._lock:
            gen = self._gen.value
            self._count.value += 1
            if self._count.value == self.parties:
                self._count.value = 0
                self._gen.value = gen + 1
                return
        deadline = time.monotonic() + timeout
        spins = 0
        while self._gen.value == gen:
            spins += 1
            if spins > 64:
                os.sched_yield()
                if spins % 1024 == 0:
                    if self._broken.value:
                        raise BrokenGroup("a rank broke the group's barrier")
                    if time.monotonic() > deadline:
                        self.abort()
                        raise BrokenGroup(f"a barrier of the rank group waited {timeout} s")
        with self._lock:
            pass


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class RankGroup:
    """One rank process's view of a process-mode group: the ranks
    ``[lo, lo + n_local)`` it holds, every process's receive slots
    (``boxes[p]``: ``(2, n_local, capacity)`` bytes, one slot a parity and
    rank of process ``p``) and the barrier.  Every process runs the same
    steps in the same order, so their parities stay in step."""

    def __init__(self, proc: int, n_procs: int, n_ranks: int, device: torch.device, boxes,
                 barrier: SpinBarrier, timeout: float):
        self.proc, self.n_procs, self.n_ranks = proc, n_procs, n_ranks
        self.n_local = n_ranks // n_procs
        self.lo = proc * self.n_local
        self.device = device
        self.boxes = boxes
        self.capacity = boxes[proc].shape[2]
        self._barrier = barrier
        self.timeout = timeout
        self._steps = 0
        self._link_plans: dict = {}

    def owner(self, rank: int) -> int:
        return rank // self.n_local

    @property
    def steps(self) -> int:
        """The steps between processes this process has run so far (a
        barrier each)."""
        return self._steps

    def barrier(self):
        """Finish this process's device work, then wait for every rank
        process."""
        _sync(self.device)
        self._barrier.wait(self.timeout)

    def clock(self) -> float:
        """The host's monotonic clock (``time.perf_counter``, one clock for
        every process of a host) right after a barrier: stamps taken here
        bound a barrier-aligned run."""
        self.barrier()
        return time.perf_counter()

    def _layout(self, leaves) -> list[int]:
        """Byte offset of each member of a step inside a slot; raises when
        the step does not fit (a slot is never reallocated mid-run)."""
        offs, at = [], 0
        for v in leaves:
            offs.append(at)
            at += -(-v[0].numel() * v.element_size() // SLOT_ALIGN) * SLOT_ALIGN
        if at > self.capacity:
            raise ValueError(f"a step of {at} bytes a rank does not fit the group's "
                             f"{self.capacity}-byte slots; make the group with larger "
                             f"slot_bytes")
        return offs

    @staticmethod
    def _view(slot: torch.Tensor, off: int, like: torch.Tensor) -> torch.Tensor:
        """The member ``like`` (one rank's row) laid at ``off`` in ``slot``."""
        n = like[0].numel() * like.element_size()
        return slot[off:off + n].view(like.dtype).view(like.shape[1:])

    def exchange(self, x, pairs: tuple):
        """``lax.ppermute`` over the rows this process holds: ``x`` (a
        rank-stacked tensor or a tuple of them, moved as one step) ->
        ``out[dst] = x[src]`` for every pair whose destination is here,
        zeros where no pair arrives.  Pairs inside this process are index
        copies; pairs between processes go through the mailboxes, after
        which every process passes the barrier (a step whose pairs all stay
        inside their processes needs none)."""
        leaves = x if isinstance(x, tuple) else (x,)
        for v in leaves:
            if v.shape[0] != self.n_local:
                raise ValueError(f"process {self.proc} holds {self.n_local} ranks; a step "
                                 f"was given {v.shape[0]} rows")
        lo, hi = self.lo, self.lo + self.n_local
        outs = [torch.zeros_like(v) for v in leaves]
        for s, d in pairs:
            if lo <= s < hi and lo <= d < hi:
                for o, v in zip(outs, leaves):
                    o[d - lo].copy_(v[s - lo])
        if any(self.owner(s) != self.owner(d) for s, d in pairs):
            offs = self._layout(leaves)
            parity = self._steps % 2
            self._steps += 1
            for s, d in pairs:
                if lo <= s < hi and not lo <= d < hi:
                    p = self.owner(d)
                    slot = self.boxes[p][parity, d - p * self.n_local]
                    for off, v in zip(offs, leaves):
                        self._view(slot, off, v).copy_(v[s - lo])
            self.barrier()
            mine = self.boxes[self.proc][parity]
            for s, d in pairs:
                if lo <= d < hi and not lo <= s < hi:
                    for off, o, v in zip(offs, outs, leaves):
                        o[d - lo].copy_(self._view(mine[d - lo], off, v))
        return tuple(outs) if isinstance(x, tuple) else outs[0]


    def _link_plan(self, src: np.ndarray, row_words: int) -> SimpleNamespace:
        """The copies of a link exchange on the table ``src`` (``(n, NL)``:
        the rank whose link-``li`` row lands on ``r``), made once a table:
        for each process that gets rows from this one, its receive slots of
        each parity as ``(n_local, NL, row_words)`` int32 (the process's
        rows laid one after another from the start of its slot area), the
        rows (destination, source, link) and, where it is one row, that row
        (a copy of a view, one operation on the card); and whether any row
        crosses processes."""
        key = (src.tobytes(), src.shape, row_words)
        plan = self._link_plans.get(key)
        if plan is not None:
            return plan
        NL = src.shape[1]
        nbytes = NL * row_words * 4
        if nbytes > self.capacity:
            raise ValueError(f"a tick's {NL} link rows of {row_words * 4} bytes a rank do not "
                             f"fit the group's {self.capacity}-byte slots; make the group with "
                             f"slot_bytes of at least {nbytes}")
        lo, hi = self.lo, self.lo + self.n_local
        rows_to: dict = {}
        for r in range(self.n_ranks):
            for li in range(NL):
                s = int(src[r, li])
                if lo <= s < hi:
                    p = self.owner(r)
                    rows_to.setdefault(p, []).append((r - p * self.n_local, s - lo, li))

        def slots(p):
            return [self.boxes[p][e].view(-1)[:self.n_local * nbytes].view(torch.int32).view(
                self.n_local, NL, row_words) for e in (0, 1)]

        def index(rows):
            return tuple(torch.tensor(c, dtype=torch.long, device=self.device)
                         for c in zip(*rows))

        plan = SimpleNamespace(
            sends=[(slots(p), rows[0] if len(rows) == 1 else None, index(rows))
                   for p, rows in sorted(rows_to.items())],
            mine=slots(self.proc),
            crossing=any(self.owner(int(src[r, li])) != self.owner(r)
                         for r in range(self.n_ranks) for li in range(NL)))
        self._link_plans[key] = plan
        return plan

    def exchange_links(self, snd: torch.Tensor, src: np.ndarray, pending: int | None = None):
        """One router tick's link exchange over the rows this process holds:
        ``arr[r, li] = snd[src[r, li], li]`` for every link ``li`` at once
        (``snd``, ``(n_local, NL, W)`` int32 link rows), the reference's
        packed ``all_to_all`` between ticks.  Every row goes into its
        receiver's slots of this step's parity (one slot a destination rank
        and link: ``src`` names one sender a row), a peer's by CUDA IPC or
        shared memory, this process's own by an index copy; then every
        process passes the barrier once a tick, not once a link, and
        ``arr`` is this process's slots, read in place: valid until the
        exchange after next writes them again.  A group whose rows all stay
        in their processes copies them into a new tensor and passes no
        barrier.  With ``pending`` (this process's count), each process
        publishes it beside the barrier and every process gets the group's
        sum (the reference's ``psum`` drain test), else None.  Returns
        ``(arr, total)``."""
        n_local, NL, W = snd.shape
        if n_local != self.n_local:
            raise ValueError(f"process {self.proc} holds {self.n_local} ranks; a tick was "
                             f"given {n_local} rows")
        plan = self._link_plan(np.ascontiguousarray(src), W)
        if not plan.crossing:  # every row stays here
            arr = torch.empty_like(snd)
            for _, _, (d, s, li) in plan.sends:
                arr[d, li] = snd[s, li]
            return arr, pending
        parity = self._steps % 2
        self._steps += 1
        for slots, one, (d, s, li) in plan.sends:
            if one is not None:
                slots[parity][one[0], one[2]].copy_(snd[one[1], one[2]])
            else:
                slots[parity][d, li] = snd[s, li]
        board = self._barrier.board
        if pending is not None:
            board[parity * self.n_procs + self.proc] = int(pending)
        self.barrier()
        total = None
        if pending is not None:
            total = sum(board[parity * self.n_procs:(parity + 1) * self.n_procs])
        return plan.mine[parity], total


def block_clock(comm: Communicator) -> float:
    """A barrier-aligned stamp of the host's monotonic clock on ``comm``'s
    ranks: after every rank process's barrier in process mode, after the
    device's work in stacked mode."""
    if comm.group is None:
        _sync(comm.device)
        return time.perf_counter()
    return comm.group.clock()


# -- the rank processes -----------------------------------------------------------------


def _to_host(out):
    """A result tree with every tensor on the CPU (what the queue carries)."""
    if torch.is_tensor(out):
        return out.detach().cpu()
    if isinstance(out, (tuple, list)):
        return type(out)(_to_host(v) for v in out)
    if isinstance(out, dict):
        return {k: _to_host(v) for k, v in out.items()}
    return out


def _peak_bytes(device: torch.device) -> int | None:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def _report(barrier: SpinBarrier, results, proc: int, e: BaseException):
    """A rank process failed: break the barrier (its peers stop waiting)
    and send the traceback to the parent; an interrupt or exit goes on."""
    barrier.abort()
    results.put(("error", proc, traceback.format_exc()))
    if not isinstance(e, Exception):
        raise e


def _rank_main(proc, n_procs, n_ranks, device, slot_bytes, inboxes, tasks, results, barrier,
               timeout):
    """The body of rank process ``proc``: map the mailboxes, then run tasks
    until told to stop or until the parent is gone."""
    import multiprocessing

    t0 = time.perf_counter()
    try:
        device = torch.device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:
            torch.set_num_threads(1)  # n_procs processes share the host's cores
        n_local = n_ranks // n_procs
        box = torch.zeros((2, n_local, slot_bytes), dtype=torch.uint8, device=device)
        if device.type == "cpu":
            box.share_memory_()
        for p in range(n_procs):
            if p != proc:
                inboxes[p].put((proc, box))
        boxes = [None] * n_procs
        boxes[proc] = box
        for _ in range(n_procs - 1):
            p, peer = inboxes[proc].get(timeout=timeout)
            boxes[p] = peer
        group = RankGroup(proc, n_procs, n_ranks, device, boxes, barrier, timeout)
        group.barrier()
        results.put(("ready", proc, {"start_s": time.perf_counter() - t0,
                                     "device_bytes": _peak_bytes(device)}))
    except BaseException as e:
        _report(barrier, results, proc, e)
        return
    parent = multiprocessing.parent_process()
    while True:
        try:
            task = tasks.get(timeout=1.0)
        except queue.Empty:  # check that the parent still lives
            if parent is not None and not parent.is_alive():
                return
            continue
        if task is None:
            break
        fn, comm_args, args, kwargs = task
        comm = local = None
        try:
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            comm = Communicator.create(**comm_args, device=device)
            comm = replace(comm, lo=group.lo, n_local=n_local, group=group)
            local = [a.to(device) if torch.is_tensor(a) else a for a in args]
            out = _to_host(fn(comm, *local, **kwargs))
            _sync(device)
            # drop the call's tensors (some may be mapped from the parent)
            # before answering, so none outlives the call here
            task = args = kwargs = local = None
            results.put(("done", proc, out, {"peak_bytes": _peak_bytes(device)}))
        except BaseException as e:
            _report(barrier, results, proc, e)
            return
    # teardown: drop the peers' slots, then wait until every process has, so
    # none frees memory another still maps
    try:
        group = comm = local = boxes = None
        gc.collect()
        _sync(device)
        barrier.wait(timeout)
        results.put(("closed", proc))
    except BaseException as e:
        _report(barrier, results, proc, e)


# -- the parent -------------------------------------------------------------------------


def _has_rows(tree) -> bool:
    if torch.is_tensor(tree):
        return tree.dim() > 0
    if isinstance(tree, (tuple, list)):
        return any(_has_rows(v) for v in tree)
    return isinstance(tree, dict) and any(_has_rows(v) for v in tree.values())


def _stack(outs: list):
    """Join the processes' result trees in rank order: a dict by its keys; a
    tensor with a leading dimension (its rows are ranks) is concatenated, a
    tuple or list holding one is joined member by member; any other value (a
    tuple of counters, a number) becomes the list of every process's."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: _stack([o[k] for o in outs]) for k in first}
    if not _has_rows(first):
        return list(outs)
    if torch.is_tensor(first):
        return torch.cat(outs)
    return type(first)(_stack([o[i] for o in outs]) for i in range(len(first)))


def _end(procs):
    """End every rank process still running (the finaliser of a group)."""
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(timeout=10)
        if p.is_alive():
            p.kill()
            p.join(timeout=10)


def _n_ranks(comm_args: dict) -> int:
    return math.prod(int(s) for s in comm_args["axis_sizes"])


class SpmdGroup:
    """``n_procs`` rank processes holding ``n_ranks`` ranks, ``n_ranks /
    n_procs`` each; a context manager.

    ``device`` (``cuda`` unless named; raises when there is no card) or
    ``devices`` (a list; process ``i`` runs on ``devices[i % len]``) place
    the processes.  ``slot_bytes`` is the capacity of one receive slot: the
    most bytes one rank's row of one step may carry (a tuple step's members
    together, each aligned to :data:`SLOT_ALIGN`).  :data:`DEFAULT_TIMEOUT`
    bounds every wait of the rank processes and the parent's wait for a
    call's results.

    :meth:`run` calls ``fn(comm, *rows, **kwargs)`` in every process, on its
    process-mode communicator and its rows of the rank-stacked tensors among
    ``args``, and stacks what comes back.  ``startup`` holds each process's
    start-up seconds and device bytes; ``peaks`` each process's peak device
    bytes in the last call.
    """

    def __init__(self, n_procs: int, n_ranks: int, *, device=None, devices=None,
                 slot_bytes: int = 1 << 20):
        if n_procs < 1 or n_ranks % n_procs:
            raise ValueError(f"{n_ranks} ranks do not split over {n_procs} processes")
        devs = [resolve_device(d) for d in (devices or [device])]
        self.n_procs, self.n_ranks, self.n_local = n_procs, n_ranks, n_ranks // n_procs
        self.devices = [devs[i % len(devs)] for i in range(n_procs)]
        self.slot_bytes = -(-int(slot_bytes) // SLOT_ALIGN) * SLOT_ALIGN
        self.timeout = DEFAULT_TIMEOUT
        if any(d.type == "cuda" for d in devs):
            from ..kernels.build import library

            library()  # built here once: the rank processes only load it
        import torch.multiprocessing as tmp

        ctx = tmp.get_context("spawn")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(n_procs)]
        inboxes = [ctx.Queue() for _ in range(n_procs)]
        self._barrier = SpinBarrier(ctx, n_procs)
        self._procs = [ctx.Process(target=_rank_main, daemon=True, name=f"smi-rank-{i}",
                                   args=(i, n_procs, n_ranks, str(self.devices[i]),
                                         self.slot_bytes, inboxes, self._tasks[i],
                                         self._results, self._barrier, self.timeout))
                       for i in range(n_procs)]
        self._finalizer = weakref.finalize(self, _end, self._procs)
        self.closed = False
        for p in self._procs:
            p.start()
        ready = self._collect("ready")
        self.startup = [info for (info,) in ready]
        self.peaks: list = [None] * n_procs

    # -- parent side of the control plane --------------------------------------------

    def _fail(self, why: str):
        self.closed = True
        self._barrier.abort()
        self._finalizer()
        raise RuntimeError(why)

    def _first_error(self, msg) -> str:
        """The report of a failed call: the first rank error that is not a
        peer's broken barrier (the others only waited for the failed rank),
        from what arrives within a second."""
        errors = [msg]
        deadline = time.monotonic() + 1.0
        while time.monotonic() < deadline:
            try:
                m = self._results.get(timeout=0.1)
            except queue.Empty:
                continue
            if m[0] == "error":
                errors.append(m)
        root = next((e for e in errors if "BrokenGroup" not in e[2]), errors[0])
        return f"rank process {root[1]} raised:\n{root[2]}"

    def _collect(self, kind: str) -> list:
        """One ``kind`` message from every process, in process order; raises
        (and ends the group) on a rank's error, on a rank process that died,
        or after the group's timeout."""
        got = {}
        deadline = time.monotonic() + self.timeout
        while len(got) < self.n_procs:
            try:
                msg = self._results.get(timeout=0.2)
            except queue.Empty:
                dead = [i for i, p in enumerate(self._procs)
                        if not p.is_alive() and i not in got]
                if dead:
                    self._fail(f"rank process {dead[0]} exited with code "
                               f"{self._procs[dead[0]].exitcode} before it answered")
                if time.monotonic() > deadline:
                    self._fail(f"the rank processes did not answer within {self.timeout} s")
                continue
            if msg[0] == "error":
                self._fail(self._first_error(msg))
            if msg[0] != kind:
                self._fail(f"rank process {msg[1]} sent {msg[0]!r} where {kind!r} was due")
            got[msg[1]] = msg[2:]
        return [got[i] for i in range(self.n_procs)]

    def run(self, fn, comm_args: dict, *args, **kwargs):
        """``fn(comm, *rows, **kwargs)`` in every rank process; returns the
        processes' results stacked in rank order (:func:`_stack`), tensors on
        the CPU.  A tensor among ``args`` is rank-stacked (``(n_ranks,
        ...)``): each process gets its rows, moved to its device; every
        other argument reaches every process as it is.  ``comm_args`` are
        :meth:`Communicator.create`'s (``axis_names``, ``axis_sizes``, and
        optionally ``topology``, ``routing_scheme``, ``name``,
        ``transport``)."""
        if self.closed:
            raise RuntimeError("the rank group is closed")
        pickle.dumps(fn)  # a lambda or a nested function fails here, not in a feeder thread
        if _n_ranks(comm_args) != self.n_ranks:
            raise ValueError(f"the group holds {self.n_ranks} ranks; the communicator has "
                             f"{_n_ranks(comm_args)}")
        for a in args:
            if torch.is_tensor(a) and a.shape[:1] != (self.n_ranks,):
                raise ValueError(f"a rank-stacked argument needs {self.n_ranks} rows, not "
                                 f"{tuple(a.shape)}")
        for i, q in enumerate(self._tasks):
            lo = i * self.n_local
            rows = [a[lo:lo + self.n_local].detach().cpu().contiguous() if torch.is_tensor(a)
                    else a for a in args]
            q.put((fn, comm_args, rows, kwargs))
        done = self._collect("done")
        self.peaks = [info["peak_bytes"] for _, info in done]
        return _stack([out for out, _ in done])

    def close(self):
        """Stop the rank processes after their final barrier (idempotent)."""
        if self.closed:
            return
        self.closed = True
        for q in self._tasks:
            q.put(None)
        try:
            self._collect("closed")
        except RuntimeError:
            pass  # _collect has ended the processes
        for p in self._procs:
            p.join(timeout=self.timeout)
        self._finalizer()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _row_bytes(args) -> int:
    return max([a[0].numel() * a.element_size() for a in args
                if torch.is_tensor(a) and a.dim() > 0] or [0])


def run_spmd(fn, comm_args: dict, *args, n_procs: int, device=None, devices=None,
             slot_bytes: int | None = None, **kwargs):
    """One call of ``fn`` on ``n_procs`` rank processes of a group of its
    own (:meth:`SpmdGroup.run`), the group closed after it.  ``slot_bytes``
    defaults to the largest row of the rank-stacked arguments plus
    :data:`SLOT_MARGIN`."""
    if slot_bytes is None:
        slot_bytes = _row_bytes(args) + SLOT_MARGIN
    with SpmdGroup(n_procs, _n_ranks(comm_args), device=device, devices=devices,
                   slot_bytes=slot_bytes) as group:
        return group.run(fn, comm_args, *args, **kwargs)
