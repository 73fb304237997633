"""Transient collective channels (paper §2.4: SMI_Open_bcast/reduce/
scatter/gather_channel), on the rank-stacked runtime.

The paper's collectives are channels: a program opens a transient
collective channel and pushes and pops elements through it.

* **bcast** — the root pushes; every rank pops.  A pipelined chain (one hop
  a pop): the element pushed first reaches ring distance d after d pops;
  validity travels in-band as a float32 flag, so bubbles gate cleanly.  On
  a line (bus) topology the chain splits at the root into an upward and a
  downward pipe.
* **reduce** — every rank pushes its contribution; the root pops reduced
  elements.  A pipelined chain toward the root with a P-deep contribution
  FIFO a rank (the paper's credit window): the farthest rank injects, each
  rank folds its matching element into the passing stream (a plain add
  through the transport's ``accumulate``: kernel A on the fused wire).
* **scatter / gather / allreduce** — round channels: each pop runs one
  element-sized round of the streamed schedule.

Every kind also has the whole-message :meth:`CollectiveChannel.transfer`,
which runs the ``_stream_*_impl`` schedules (or, with a Plan on the spec,
the ``bcast``/``reduce``/``allreduce`` dispatchers) through the channel's
backend and stats tag: the same bits and counters as calling them directly.

State is rank-stacked as in :mod:`.channel`: every register has a leading
rank dimension, and ``push`` takes one element (every rank's) or a
rank-stacked ``(P, ...)`` tensor of per-rank elements.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.comm import Communicator
from .channel import _ChannelBase, _claim, _mask_sel, _stacked, _tagged
from .spec import ChannelSpec


def _i32(pred: torch.Tensor) -> torch.Tensor:
    return pred.to(torch.int32)


def _f32flag(pred: torch.Tensor) -> torch.Tensor:
    return pred.to(torch.float32)


@dataclass
class CollectiveChannel(_ChannelBase):
    """Rank-stacked collective-channel state; its layout depends on
    ``spec.kind`` (see :func:`_open`).  ``pushed``/``popped`` ``(P,)`` count
    accepted pushes and valid deliveries at each rank."""

    spec: ChannelSpec
    state: tuple
    pushed: torch.Tensor
    popped: torch.Tensor

    def _limit(self) -> torch.Tensor:
        """Deliverable-element bound: pushes so far, capped by ``count``."""
        if self.spec.count is None:
            return self.pushed
        return self.pushed.clamp(max=self.spec.count)

    def _op(self):
        return self.spec.op

    # ------------------------------------------------------------- push

    def push(self, elem) -> "CollectiveChannel":
        """SMI_Push: stage one element at every rank.

        bcast: the root's element is the payload; reduce, gather, allreduce:
        every rank's element is its contribution; scatter: the root pushes
        a ``(P, *elem_shape)`` row, one element a destination.

        Non-blocking with a credit window (§3.3): a push past this rank's
        window (P deep for bcast and reduce, 1 for the round channels) is
        refused — not staged, not counted in ``pushed`` — and never
        overwrites an element the schedule has not consumed."""
        kind = self.spec.kind
        P = self.spec.comm.size
        if kind in ("bcast", "reduce"):
            # the consumption pointer of this rank's FIFO: the root (bcast)
            # or the farthest rank (reduce) injects slot `sent`; a reduce
            # rank folds slot `folded`; one of the two moves on each rank
            consumed = self.state[1] if kind == "bcast" else self.state[3] + self.state[4]
            ok = (self.pushed - consumed) < P
            buf = self.state[0]
            e = _stacked(elem, buf[:, 0])
            staged = buf.clone()
            staged[torch.arange(P, device=buf.device), self.pushed % P] = e
            state = (_mask_sel(ok, staged, buf),) + self.state[1:]
        else:  # one-deep staging, consumed by one round (`state[1]`)
            ok = (self.pushed - self.state[1]) < 1
            state = (_mask_sel(ok, _stacked(elem, self.state[0]), self.state[0]),) \
                + self.state[1:]
        return CollectiveChannel(self.spec, state, self.pushed + _i32(ok), self.popped)

    # ------------------------------------------------------------- pop

    def pop(self):
        """SMI_Pop: advance the collective pipeline one step and extract.

        Returns ``(chan', value, valid)``, ``value`` rank-stacked and
        ``valid`` a ``(P,)`` bool.  bcast: the next broadcast element (every
        rank, after its pipeline latency); reduce: the next reduced element
        (root only); scatter: this rank's element of the next pushed row;
        gather: the ``(P, *elem_shape)`` row of pushed elements (root only);
        allreduce: the next reduced element (every rank)."""
        return getattr(self, f"_pop_{self.spec.kind}")()

    def _pop_bcast(self):
        from ..core.collectives import _line_perms, _take

        spec = self.spec
        comm, root = spec.comm, spec.root
        P, r = comm.size, comm.rank()
        buf, sent, up, up_v, down, down_v = self.state
        t = spec.step_transport()
        if comm.topology.dims is None:  # a line: the chain splits at the root
            up_pairs, down_pairs = _line_perms(comm, root)
        else:
            up_pairs, down_pairs = comm.ring_perm(+1), None

        at_root = r == root
        inj_ok = at_root & (sent < self._limit())
        inj = _take(buf, sent % P)

        # the root always overwrites its registers (injection or bubble), so
        # stale elements never recirculate around the wrap
        def reg(pipe, pipe_v):
            return (_mask_sel(at_root, _mask_sel(inj_ok, inj, torch.zeros_like(pipe)), pipe),
                    torch.where(at_root, _f32flag(inj_ok), pipe_v))

        with _tagged(t, spec.stats_tag):
            moved_u, moved_uv = t.permute(reg(up, up_v), comm, up_pairs)
            if down_pairs is not None:
                moved_d, moved_dv = t.permute(reg(down, down_v), comm, down_pairs)
            else:
                moved_d, moved_dv = down, down_v

        if down_pairs is not None:
            arriving = _mask_sel(r > root, moved_u, moved_d)
            arr_v = torch.where(r > root, moved_uv, moved_dv)
        else:
            arriving, arr_v = moved_u, moved_uv
        recv_ok = (arr_v > 0.5) & ~at_root
        value = _mask_sel(at_root, inj, arriving)
        valid = torch.where(at_root, inj_ok, recv_ok)
        new = CollectiveChannel(
            spec, (buf, sent + _i32(inj_ok), moved_u, moved_uv, moved_d, moved_dv),
            self.pushed, self.popped + _i32(valid))
        return new, value, valid

    def _pop_reduce(self):
        from ..core.collectives import _fold, _take

        spec = self.spec
        comm, root = spec.comm, spec.root
        P, r = comm.size, comm.rank()
        buf, pipe, pipe_v, sent, folded = self.state
        t = spec.step_transport()

        farthest = (r - root) % P == P - 1
        inj_ok = farthest & (sent < self._limit())
        # the farthest rank always overwrites its register (injection or
        # bubble), killing the recirculation from the root around the wrap
        reg = _mask_sel(farthest,
                        _mask_sel(inj_ok, _take(buf, sent % P), torch.zeros_like(pipe)), pipe)
        reg_v = torch.where(farthest, _f32flag(inj_ok), pipe_v)
        with _tagged(t, spec.stats_tag):
            moved, moved_v = t.permute((reg, reg_v), comm, comm.ring_perm(-1))

        arrived = moved_v > 0.5
        fold_ok = arrived & ~farthest
        # a plain-add fold runs on the transport's accumulate (kernel A on
        # the fused wire); the validity mask stays outside it
        folded_val = _fold(t, self._op(), moved, _take(buf, folded % P))
        new_pipe = _mask_sel(fold_ok, folded_val, moved)
        valid = (r == root) & arrived
        new = CollectiveChannel(
            spec, (buf, new_pipe, moved_v, sent + _i32(inj_ok), folded + _i32(fold_ok)),
            self.pushed, self.popped + _i32(valid))
        return new, new_pipe, valid

    def _round(self):
        """(transport, step, avail) shared by the round channels."""
        step = self.state[1]
        return self.spec.step_transport(), step, step < self._limit()

    def _pop_scatter(self):
        from ..core.collectives import _stream_scatter_impl

        spec = self.spec
        t, step, avail = self._round()
        staged = self.state[0]  # (P, P, *elem_shape): the root's row counts
        with _tagged(t, spec.stats_tag):
            y = _stream_scatter_impl(staged, spec.comm, root=spec.root, transport=t)
        new = CollectiveChannel(spec, (staged, step + 1), self.pushed,
                                self.popped + _i32(avail))
        return new, y[:, 0], avail

    def _pop_gather(self):
        from ..core.collectives import _stream_gather_impl

        spec = self.spec
        t, step, avail = self._round()
        staged = self.state[0]
        with _tagged(t, spec.stats_tag):
            y = _stream_gather_impl(staged[:, None], spec.comm, root=spec.root, transport=t)
        valid = (spec.comm.rank() == spec.root) & avail
        new = CollectiveChannel(spec, (staged, step + 1), self.pushed,
                                self.popped + _i32(valid))
        return new, y, valid

    def _pop_allreduce(self):
        from ..core.collectives import _stream_allreduce_impl

        spec = self.spec
        t, step, avail = self._round()
        staged = self.state[0]
        with _tagged(t, spec.stats_tag):
            y = _stream_allreduce_impl(staged, spec.comm, transport=t)
        new = CollectiveChannel(spec, (staged, step + 1), self.pushed,
                                self.popped + _i32(avail))
        return new, y, avail

    # ---------------------------------------------------------- transfer

    def transfer(self, x: torch.Tensor, n_chunks: int | None = None, **kw):
        """Whole-message collective over this channel: the ``_stream_*``
        schedule (or, with a Plan on the spec, the dispatcher) through the
        channel's backend and stats tag, equal bit for bit to the direct
        call.  Extra keywords reach the schedule (``bidir=``; a reduce's
        ``op`` defaults to the spec's)."""
        from ..core import collectives as C

        spec = self.spec
        kind = spec.kind
        if spec.plan is not None and kind in ("bcast", "reduce", "allreduce"):
            # the dispatcher owns the schedule and chunk count; the channel
            # owns the backend instance (the spec's transport, else the
            # plan's key, with the spec's wire) and the stats tag
            p = C._resolve_plan(spec.plan, x)
            t = (spec.resolve() if spec.transport is not None
                 else spec.replace(transport=p.transport_key).resolve())
            with _tagged(t, spec.stats_tag):
                if kind == "bcast":
                    return C.bcast(x, spec.comm, root=spec.root, plan=p, transport=t)
                if kind == "reduce":
                    kw.setdefault("op", self._op())
                    return C.reduce(x, spec.comm, root=spec.root, plan=p, transport=t, **kw)
                return C.allreduce(x, spec.comm, plan=p, transport=t, **kw)

        t = spec.resolve()
        nc = n_chunks if n_chunks is not None else spec.n_chunks
        with _tagged(t, spec.stats_tag):
            if kind == "bcast":
                return C._stream_bcast_impl(x, spec.comm, root=spec.root, n_chunks=nc,
                                            transport=t)
            if kind == "reduce":
                kw.setdefault("op", self._op())
                return C._stream_reduce_impl(x, spec.comm, root=spec.root, n_chunks=nc,
                                             transport=t, **kw)
            if kind == "scatter":
                return C._stream_scatter_impl(x, spec.comm, root=spec.root, transport=t)
            if kind == "gather":
                return C._stream_gather_impl(x, spec.comm, root=spec.root, transport=t)
            return C._stream_allreduce_impl(x, spec.comm, transport=t, **kw)


# ---------------------------------------------------------------------------
# open_*_channel: the SMI_Open_*_channel family
# ---------------------------------------------------------------------------


def _open(kind: str, comm: Communicator, *, count, root, port, elem_shape, dtype, transport,
          wire, tag, plan, n_chunks, op, allocator) -> CollectiveChannel:
    spec = _claim(ChannelSpec(comm=comm, kind=kind, count=count, root=root, port=port,
                              transport=transport, wire=wire, tag=tag, plan=plan,
                              n_chunks=n_chunks, op=op), allocator)
    P, es = comm.size, tuple(elem_shape)

    def z(shape, dt=dtype):
        return torch.zeros((P,) + shape, dtype=dt, device=comm.device)

    i32, f32 = torch.int32, torch.float32
    if kind == "bcast":
        # FIFO, sent, pipe up and its valid flag, pipe down (line
        # topologies) and its valid flag
        state = (z((P,) + es), z((), i32), z(es), z((), f32), z(es), z((), f32))
    elif kind == "reduce":
        # contribution FIFO, pipe, pipe valid, sent (farthest rank), folded
        state = (z((P,) + es), z(es), z((), f32), z((), i32), z((), i32))
    elif kind == "scatter":
        state = (z((P,) + es), z((), i32))
    else:  # gather / allreduce
        state = (z(es), z((), i32))
    return CollectiveChannel(spec=spec, state=state, pushed=z((), i32), popped=z((), i32))


def _open_doc(fn, what):
    fn.__doc__ = f"""SMI_Open_{fn.__name__[5:-8]}_channel: open a transient
    {what} channel on ``comm``.

    Claims ``port`` on the allocator (``None``: anonymous) and zeroes the
    rank-stacked state on the communicator's device; nothing moves until
    elements flow.  The spec carries the channel's whole comm config:
    ``transport`` (registry key, instance or None = the communicator's
    default), ``wire`` ("raw" | "int8"), ``tag`` (stats bucket), ``plan``
    and ``n_chunks``."""
    return fn


@lambda f: _open_doc(f, "broadcast")
def open_bcast_channel(comm, *, count=None, root=0, port=0, elem_shape=(), dtype=torch.float32,
                       transport=None, wire="raw", tag=None, plan=None, n_chunks=1,
                       allocator=None):
    return _open("bcast", comm, count=count, root=root, port=port, elem_shape=elem_shape,
                 dtype=dtype, transport=transport, wire=wire, tag=tag, plan=plan,
                 n_chunks=n_chunks, op=None, allocator=allocator)


@lambda f: _open_doc(f, "rooted-reduction")
def open_reduce_channel(comm, *, count=None, root=0, port=0, elem_shape=(), dtype=torch.float32,
                        op=None, transport=None, wire="raw", tag=None, plan=None, n_chunks=1,
                        allocator=None):
    return _open("reduce", comm, count=count, root=root, port=port, elem_shape=elem_shape,
                 dtype=dtype, transport=transport, wire=wire, tag=tag, plan=plan,
                 n_chunks=n_chunks, op=op, allocator=allocator)


@lambda f: _open_doc(f, "scatter")
def open_scatter_channel(comm, *, count=None, root=0, port=0, elem_shape=(),
                         dtype=torch.float32, transport=None, wire="raw", tag=None, plan=None,
                         n_chunks=1, allocator=None):
    return _open("scatter", comm, count=count, root=root, port=port, elem_shape=elem_shape,
                 dtype=dtype, transport=transport, wire=wire, tag=tag, plan=plan,
                 n_chunks=n_chunks, op=None, allocator=allocator)


@lambda f: _open_doc(f, "gather")
def open_gather_channel(comm, *, count=None, root=0, port=0, elem_shape=(), dtype=torch.float32,
                        transport=None, wire="raw", tag=None, plan=None, n_chunks=1,
                        allocator=None):
    return _open("gather", comm, count=count, root=root, port=port, elem_shape=elem_shape,
                 dtype=dtype, transport=transport, wire=wire, tag=tag, plan=plan,
                 n_chunks=n_chunks, op=None, allocator=allocator)


@lambda f: _open_doc(f, "ring all-reduce")
def open_allreduce_channel(comm, *, count=None, port=0, elem_shape=(), dtype=torch.float32,
                           transport=None, wire="raw", tag=None, plan=None, n_chunks=1,
                           allocator=None):
    return _open("allreduce", comm, count=count, root=0, port=port, elem_shape=elem_shape,
                 dtype=dtype, transport=transport, wire=wire, tag=tag, plan=plan,
                 n_chunks=n_chunks, op=None, allocator=allocator)
