"""Streamed collectives (paper §3.2, §4.4) as index-copy schedules.

Each function takes a rank-stacked tensor ``x`` of shape ``(P, ...)`` —
row ``r`` is rank ``r``'s buffer — and returns one, running the same
schedule as ``repro.core.collectives``: who sends what in which step is
unchanged, so results and :class:`~repro_torch.transport.TransportStats`
equal the reference's bit for bit and step for step.

* the paper-faithful linear/ring pipelined schedules for Bcast / Scatter /
  Gather / Reduce;
* ring AllGather / ReduceScatter / AllReduce / AllToAll;
* binomial-tree and host-staged Bcast/Reduce;
* the ``bcast``/``reduce``/``allreduce`` dispatchers, driven by a
  :class:`~repro_torch.netsim.Plan` (``plan=None`` is the static default).

A per-rank index (``lax.axis_index`` arithmetic in the reference) is a
tensor over the rank dimension here: :func:`_take` and :func:`_put` are the
per-rank ``dynamic_index``/``dynamic_update_index`` along a rank's own
leading axis.  Every plain-add fold goes through the transport's
``accumulate`` hook, so the fused backend runs it on its CUDA kernel; masks
stay outside the hook.  Inputs are never modified.
"""

from __future__ import annotations

import torch

from .comm import Communicator
from .streaming import _mask_sel


def _resolve(transport, comm: Communicator):
    from ..transport.registry import resolve_transport

    return resolve_transport(transport, comm)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row ``idx[r]`` of rank ``r``'s buffer: ``x[r, idx[r]]`` for every r."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def _put(x: torch.Tensor, idx: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Copy of ``x`` with ``x[r, idx[r]] = v[r]`` for every rank r."""
    return _put_(x.clone(), idx, v)


def _put_(x: torch.Tensor, idx: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """:func:`_put` in place: ``x[r, idx[r]] = v[r]`` for every rank r, on
    a buffer the caller owns; returns ``x``."""
    x[torch.arange(x.shape[0], device=x.device), idx] = v
    return x


def _chunks(x: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """Rank-stacked ``(P, S, ...)`` viewed as ``(P, n_chunks, S/n, ...)``."""
    P, S = x.shape[0], x.shape[1]
    return x.reshape((P, n_chunks, S // n_chunks) + tuple(x.shape[2:]))


def _schedule_loop(tp, steps: int, body, carry):
    """Run a static schedule loop of ``steps`` ticks.

    The reference traces one iteration of a rolled ``fori_loop`` and scales
    its step/byte counters by ``steps``; here the loop runs every tick and
    the transport tallies each one, which gives the same counts because
    every schedule moves the same bytes each tick."""
    for t in range(steps):
        carry = body(t, carry)
    return carry


def _line_perms(comm: Communicator, root: int):
    """Up/down chain permutations for bus (no-wrap) topologies."""
    P = comm.size
    up = [(i, i + 1) for i in range(root, P - 1)]
    down = [(i, i - 1) for i in range(1, root + 1)]
    return up, down


def _is_add(op) -> bool:
    return op is None or op is torch.add


def _fold(tp, op, a, b):
    return tp.accumulate(a, b) if _is_add(op) else op(a, b)


# ---------------------------------------------------------------------------
# Ring AllGather / ReduceScatter / AllReduce / AllToAll
# ---------------------------------------------------------------------------


def stream_allgather(x: torch.Tensor, comm: Communicator, *, bidir: bool = False,
                     transport=None):
    """Ring all-gather: every rank's ``(m, ...)`` shard -> ``(P*m, ...)``
    on every rank.  ``bidir`` streams both ring directions (beyond-paper;
    about halves the number of steps for even P)."""
    P = comm.size
    r = comm.rank()
    t = _resolve(transport, comm)
    # a fresh buffer, filled in place (one copy of each arriving shard)
    out = _put_(x.new_empty((x.shape[0], P) + tuple(x.shape[1:])), r, x)

    def flat(o):
        return o.reshape((o.shape[0], P * x.shape[1]) + tuple(x.shape[2:]))

    if P == 1:
        return flat(out)
    if not bidir:
        buf = x
        for s in range(1, P):
            buf = t.shift(buf, comm, +1)  # buf now originated at rank r - s
            _put_(out, (r - s) % P, buf)
    else:
        up = down = x
        n_up = (P - 1 + 1) // 2  # ceil((P-1)/2)
        n_down = (P - 1) // 2
        for s in range(1, n_up + 1):
            up = t.shift(up, comm, +1)
            _put_(out, (r - s) % P, up)
            if s <= n_down:
                down = t.shift(down, comm, -1)
                _put_(out, (r + s) % P, down)
    return flat(out)


def stream_reduce_scatter(x: torch.Tensor | None, comm: Communicator, *,
                          compute_chunk=None, transport=None):
    """Ring reduce-scatter.  Each rank's ``(P*m, ...)`` partials ->
    ``(m, ...)``: block ``r`` summed over ranks, on rank ``r``.  The inner
    step is the transport's ``shift_accumulate`` (the add kernel on the
    fused backend).

    ``compute_chunk(blk)`` produces the partial blocks just in time, one
    ring step before they are needed, in place of ``x`` (the streamed
    matmul + reduce-scatter of :mod:`~repro_torch.core.overlap`).  Ranks are
    stacked, so ``blk`` is a ``(P,)`` tensor: rank ``r`` asks for block
    ``blk[r]``, and the call returns the rank-stacked ``(P, m, ...)``
    blocks."""
    P = comm.size
    r = comm.rank()
    t = _resolve(transport, comm)
    if compute_chunk is None:
        xb = _chunks(x, P)

        def compute_chunk(blk):
            return _take(xb, blk)

    acc = compute_chunk((r - 1) % P)
    if P == 1:
        return acc
    for s in range(1, P):
        acc = t.shift_accumulate(acc, compute_chunk((r - s - 1) % P), comm, +1)
    return acc


def _stream_allreduce_impl(x: torch.Tensor, comm: Communicator, *, bidir: bool = False,
                           transport=None):
    """Ring all-reduce (RS + AG) of each rank's arbitrary-shaped buffer."""
    P = comm.size
    if P == 1:
        return x
    shape = x.shape
    t = _resolve(transport, comm)
    flat = x.reshape(shape[0], -1)
    orig = flat.shape[1]
    pad = (-orig) % P
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    red = stream_reduce_scatter(flat, comm, transport=t)
    full = stream_allgather(red, comm, bidir=bidir, transport=t)
    if pad:
        full = full[:, :orig]
    return full.reshape(shape)


def stream_alltoall(x: torch.Tensor, comm: Communicator, *, transport=None):
    """All-to-all: each rank's ``(P, m, ...)`` block d goes to rank d;
    slot s of the result holds the block rank s sent."""
    P = comm.size
    r = comm.rank()
    t = _resolve(transport, comm)
    out = _put(torch.zeros_like(x), r, _take(x, r))
    for s in range(1, P):
        # send the block destined to rank r+s; it arrives from rank r-s
        got = t.shift(_take(x, (r + s) % P), comm, +s)
        out = _put(out, (r - s) % P, got)
    return out


# ---------------------------------------------------------------------------
# Rooted streaming collectives (paper-faithful linear pipelined schemes)
# ---------------------------------------------------------------------------


def _stream_bcast_impl(x: torch.Tensor, comm: Communicator, *, root: int = 0,
                       n_chunks: int = 1, transport=None):
    """Pipelined chain broadcast (paper §4.4 linear scheme).

    Chunks leave the root every step and ripple through the chain; every
    rank taps the passing stream.  Steps = n_chunks + P - 2."""
    P = comm.size
    if P == 1:
        return x
    S = x.shape[1]
    if S % n_chunks:
        raise ValueError(f"message length {S} not divisible by n_chunks={n_chunks}")
    csz = S // n_chunks
    r = comm.rank()
    tp = _resolve(transport, comm)
    is_line = comm.topology.dims is None  # bus et al: chain both directions
    if is_line:
        up_pairs, down_pairs = _line_perms(comm, root)
        dist = (r - root).abs()
    else:
        up_pairs, down_pairs = comm.ring_perm(+1), None
        dist = (r - root) % P

    def body(t, carry):
        out, pipe_u, pipe_d = carry
        k = min(t, n_chunks - 1) * csz
        inj = x[:, k:k + csz]
        at_root_live = (r == root) & (t < n_chunks)
        pipe_u = tp.permute(_mask_sel(at_root_live, inj, pipe_u), comm, up_pairs)
        if down_pairs is not None:
            pipe_d = tp.permute(_mask_sel(at_root_live, inj, pipe_d), comm, down_pairs)
            arriving = _mask_sel(r > root, pipe_u, pipe_d)
        else:
            arriving = pipe_u
        c = t - dist + 1
        ok = (c >= 0) & (c < n_chunks) & (dist > 0)
        upd = _put(_chunks(out, n_chunks), c.clamp(0, n_chunks - 1), arriving)
        out = _mask_sel(ok, upd.reshape(out.shape), out)
        return out, pipe_u, pipe_d

    pipe0 = x.new_zeros((x.shape[0], csz) + tuple(x.shape[2:]))
    out, _, _ = _schedule_loop(tp, n_chunks + P - 2, body,
                               (torch.zeros_like(x), pipe0, pipe0))
    return _mask_sel(r == root, x, out)


def _stream_reduce_impl(x: torch.Tensor, comm: Communicator, *, root: int = 0,
                        n_chunks: int = 1, op=None, transport=None):
    """Pipelined chain reduction to ``root`` (credit/tile-based, paper §4.4).

    Tiles stream down the chain toward the root, each rank folding in its
    local contribution as the tile passes.  ``op`` None or ``torch.add``
    folds through the transport's ``accumulate`` hook."""
    P = comm.size
    if P == 1:
        return x
    S = x.shape[1]
    if S % n_chunks:
        raise ValueError(f"message length {S} not divisible by n_chunks={n_chunks}")
    r = comm.rank()
    tp = _resolve(transport, comm)
    dist = (r - root) % P  # ring distance (chain order: farthest = P-1)
    down_pairs = comm.ring_perm(-1)
    xc = _chunks(x, n_chunks)

    def body(t, carry):
        out, pipe = carry
        # the farthest rank injects chunk t
        if t < n_chunks:
            pipe = _mask_sel(dist == P - 1, xc[:, t], pipe)
        pipe = tp.permute(pipe, comm, down_pairs)
        # after the shift at step t, the rank at ring distance d holds chunk
        # c = t - (P - 2 - d): injected at step c, it has moved t - c + 1 hops
        c = t - (P - 2 - dist)
        cidx = c.clamp(0, n_chunks - 1)
        live = (c >= 0) & (c < n_chunks)
        add_ok = live & (dist < P - 1)
        # a masked rank keeps `pipe` bit-exactly, not `pipe + 0`
        pipe = _mask_sel(add_ok, _fold(tp, op, pipe, _take(xc, cidx)), pipe)
        # the root delivers
        upd = _put(_chunks(out, n_chunks), cidx, pipe).reshape(out.shape)
        out = _mask_sel((r == root) & live, upd, out)
        return out, pipe

    pipe0 = x.new_zeros((x.shape[0], S // n_chunks) + tuple(x.shape[2:]))
    out, _ = _schedule_loop(tp, n_chunks + P - 2, body, (torch.zeros_like(x), pipe0))
    return _mask_sel(r == root, out, torch.zeros_like(x))


def _stream_gather_impl(x: torch.Tensor, comm: Communicator, *, root: int = 0,
                        transport=None):
    """Convoy gather: every shard shifts one hop toward the root per step;
    the root receives nearest-first, one shard per step."""
    P = comm.size
    r = comm.rank()
    tp = _resolve(transport, comm)
    out = _put(x.new_zeros((x.shape[0], P) + tuple(x.shape[1:])), r, x)

    def flat(o):
        return o.reshape((o.shape[0], P * x.shape[1]) + tuple(x.shape[2:]))

    if P == 1:
        return flat(out)
    pipe = x
    for t in range(P - 1):
        pipe = tp.shift(pipe, comm, -1)  # toward root (ring -1 = decreasing dist)
        out = _mask_sel(r == root, _put(out, (r + t + 1) % P, pipe), out)
    out = _mask_sel(r == root, out, torch.zeros_like(out))
    return flat(out)


def _stream_scatter_impl(x: torch.Tensor, comm: Communicator, *, root: int = 0,
                         transport=None):
    """Convoy scatter: the root injects blocks farthest-first; after P-1
    shifts every rank's pipe register holds its own block."""
    P = comm.size
    r = comm.rank()
    tp = _resolve(transport, comm)
    xb = _chunks(x, P)
    if P == 1:
        return xb[:, 0]
    pipe = torch.zeros_like(xb[:, 0])
    for t in range(P - 1):
        d = P - 1 - t  # inject the block for ring distance d
        pipe = _mask_sel(r == root, xb[:, (root + d) % P], pipe)
        pipe = tp.shift(pipe, comm, +1)
    return _mask_sel(r == root, _take(xb, r), pipe)


# ---------------------------------------------------------------------------
# Beyond-paper: binomial trees (the paper's explicit future work)
# ---------------------------------------------------------------------------


def _tree_rounds(P: int):
    k = 0
    while (1 << k) < P:
        yield 1 << k
        k += 1


def tree_bcast(x: torch.Tensor, comm: Communicator, *, root: int = 0, transport=None):
    """Binomial-tree broadcast: O(log P) rounds of whole-message sends."""
    P = comm.size
    r = comm.rank()
    tp = _resolve(transport, comm)
    rel = (r - root) % P
    buf = _mask_sel(r == root, x, torch.zeros_like(x))
    for h in _tree_rounds(P):
        pairs = [((root + i) % P, (root + i + h) % P) for i in range(h) if i + h < P]
        moved = tp.permute(buf, comm, pairs)
        buf = _mask_sel((rel >= h) & (rel < 2 * h), moved, buf)
    return buf


def tree_reduce(x: torch.Tensor, comm: Communicator, *, root: int = 0, op=None,
                transport=None):
    """Binomial-tree reduction to root: O(log P) rounds."""
    P = comm.size
    r = comm.rank()
    tp = _resolve(transport, comm)
    rel = (r - root) % P
    buf = x
    for h in reversed(list(_tree_rounds(P))):
        pairs = [((root + i + h) % P, (root + i) % P) for i in range(h) if i + h < P]
        moved = tp.permute(buf, comm, pairs)
        # ranks in [h, 2h) sent; ranks in [0, h) fold the arrival in
        sent_exists = (rel < h) & (rel + h < P)
        buf = _mask_sel(sent_exists, _fold(tp, op, buf, moved), buf)
    return _mask_sel(r == root, buf, torch.zeros_like(buf))


# ---------------------------------------------------------------------------
# Host-staged baseline (the paper's MPI+OpenCL comparison point)
# ---------------------------------------------------------------------------


def staged_bcast(x: torch.Tensor, comm: Communicator, *, root: int = 0, transport=None):
    """Unpipelined baseline: root sends the whole message to each rank in
    turn (serialized bulk transfers, no streaming overlap)."""
    P = comm.size
    r = comm.rank()
    tp = _resolve(transport, comm)
    from_root = _mask_sel(r == root, x, torch.zeros_like(x))
    out = from_root
    for d in range(1, P):
        dst = (root + d) % P
        path = comm.route_table.path(root, dst)
        buf = from_root
        for a, b in zip(path[:-1], path[1:]):
            buf = tp.permute(buf, comm, [(a, b)])
        out = _mask_sel(r == dst, buf, out)
    return out


def staged_reduce(x: torch.Tensor, comm: Communicator, *, root: int = 0, op=None,
                  transport=None):
    """Unpipelined baseline reduce: each rank's full buffer travels to the
    root sequentially."""
    P = comm.size
    r = comm.rank()
    tp = _resolve(transport, comm)
    zeros = torch.zeros_like(x)
    acc = _mask_sel(r == root, x, zeros)
    for d in range(1, P):
        src = (root + d) % P
        path = comm.route_table.path(src, root)
        buf = _mask_sel(r == src, x, zeros)
        for a, b in zip(path[:-1], path[1:]):
            buf = tp.permute(buf, comm, [(a, b)])
        acc = _mask_sel(r == root, _fold(tp, op, acc, buf), acc)
    return acc


# ---------------------------------------------------------------------------
# Plan-driven dispatchers
# ---------------------------------------------------------------------------


def _resolve_plan(plan, x: torch.Tensor):
    """``None`` -> the static default; a Plan passes through (an ``int8``
    wire applies to floating payloads only; integer data moves raw).
    ``"auto"`` needs the tuner, which is not ported yet."""
    import dataclasses

    from ..netsim.tune import DEFAULT_PLAN, Plan

    if plan is None:
        return DEFAULT_PLAN
    if not isinstance(plan, Plan):
        raise NotImplementedError(
            f"plan={plan!r}: only None or a Plan; plan='auto' (the netsim "
            "tuner) comes with the tuner slice of the port"
        )
    if plan.wire != "raw" and not x.dtype.is_floating_point:
        plan = dataclasses.replace(plan, wire="raw")
    return plan


def bcast(x: torch.Tensor, comm: Communicator, *, root: int = 0, plan=None,
          transport=None):
    """Broadcast by plan: pipelined chain, binomial tree or staged, with
    the plan's chunk count and backend; ``transport`` overrides the
    plan's backend."""
    p = _resolve_plan(plan, x)
    tp = transport if transport is not None else p.transport_key
    if p.algo == "tree":
        return tree_bcast(x, comm, root=root, transport=tp)
    if p.algo == "staged":
        return staged_bcast(x, comm, root=root, transport=tp)
    return _stream_bcast_impl(x, comm, root=root,
                              n_chunks=p.clamp_chunks(x.shape[1]), transport=tp)


def reduce(x: torch.Tensor, comm: Communicator, *, root: int = 0, op=None, plan=None,
           transport=None):
    """Rooted reduction by plan (same dispatch rules as :func:`bcast`)."""
    p = _resolve_plan(plan, x)
    tp = transport if transport is not None else p.transport_key
    if p.algo == "tree":
        return tree_reduce(x, comm, root=root, op=op, transport=tp)
    if p.algo == "staged":
        return staged_reduce(x, comm, root=root, op=op, transport=tp)
    return _stream_reduce_impl(x, comm, root=root, op=op,
                               n_chunks=p.clamp_chunks(x.shape[1]), transport=tp)


def allreduce(x: torch.Tensor, comm: Communicator, *, plan=None, transport=None, **kw):
    """Ring all-reduce.  Only the plan's transport applies: the RS+AG
    schedule fixes its own chunking (nbytes/P blocks)."""
    p = _resolve_plan(plan, x)
    tp = transport if transport is not None else p.transport_key
    return _stream_allreduce_impl(x, comm, transport=tp, **kw)
