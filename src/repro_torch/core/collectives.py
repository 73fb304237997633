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
* the ``bcast``/``reduce``/``allreduce`` dispatchers, driven by the
  netsim tuner (``plan="auto"``, their default) or a
  :class:`~repro_torch.netsim.Plan` (``plan=None`` is the static default);
* the once-quantised reduce-scatter of a lossy (int8) wire, and
  :func:`make_int8_codec` for the deprecated ``quantize=`` keywords;
* the deprecated ``stream_*`` collective shims over transient channels.

A per-rank index (``lax.axis_index`` arithmetic in the reference) is a
tensor over the rank dimension here: :func:`_take` and :func:`_put` are the
per-rank ``dynamic_index``/``dynamic_update_index`` along a rank's own
leading axis.  Every plain-add fold goes through the transport's
``accumulate`` hook, so the fused backend runs it on its CUDA kernel; masks
stay outside the hook.  Inputs are never modified.
"""

from __future__ import annotations

import functools
import warnings

import torch

from .comm import Communicator
from .streaming import _mask_sel


def _resolve(transport, comm: Communicator):
    from ..transport.registry import resolve_transport

    return resolve_transport(transport, comm)


def _codec_shim(t, quantize, dequantize):
    """The deprecated ``quantize=``/``dequantize=`` keywords: ``t`` wrapped
    in a :class:`~repro_torch.transport.compressed.CompressedTransport`
    carrying the caller's codec, the same error-feedback wire as
    ``transport="compressed"``."""
    warnings.warn(
        "quantize=/dequantize= kwargs are deprecated; pass transport='compressed' (or "
        "'compressed:<inner>') instead — the compressed transport carries blockwise int8 "
        "scales, per-hop error feedback and byte-accurate wire stats",
        DeprecationWarning, stacklevel=3)
    from ..transport.compressed import CompressedTransport

    return CompressedTransport(inner=t, codec=(quantize, dequantize))


def _is_lossy(t) -> bool:
    return bool(getattr(t, "lossy_wire", False))


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
                          compute_chunk=None, quantize=None, dequantize=None, transport=None):
    """Ring reduce-scatter.  Each rank's ``(P*m, ...)`` partials ->
    ``(m, ...)``: block ``r`` summed over ranks, on rank ``r``.  The inner
    step is the transport's ``shift_accumulate`` (the add kernel on the
    fused backend).

    A lossy wire (``transport="compressed"``, or the deprecated
    ``quantize=``/``dequantize=`` keywords, which wrap the transport in it)
    takes the once-quantised schedule instead: round ``s`` quantises each
    rank's contribution to block ``(r + s) % P`` once, with the transport's
    error-feedback residual (zero at the start of every call), and ships it
    straight home with a distance-``s`` ring permute; the sums stay float32
    and are never re-rounded, so the error does not grow with P.

    ``compute_chunk(blk)`` produces the partial blocks just in time, one
    ring step before they are needed, in place of ``x`` (the streamed
    matmul + reduce-scatter of :mod:`~repro_torch.core.overlap`).  Ranks are
    stacked, so ``blk`` is a ``(P,)`` tensor: rank ``r`` asks for block
    ``blk[r]``, and the call returns the rank-stacked ``(P, m, ...)``
    blocks."""
    P = comm.size
    r = comm.rank()
    t = _resolve(transport, comm)
    if quantize is not None:
        t = _codec_shim(t, quantize, dequantize)
    if compute_chunk is None:
        xb = _chunks(x, P)

        def compute_chunk(blk):
            return _take(xb, blk)

    if _is_lossy(t):
        t.reset_state()
        own = compute_chunk(r)
        if P == 1:
            return own
        acc = own.float()
        for s in range(1, P):
            # the contribution to block (r + s) % P, arriving at its home rank
            acc = acc + t.send_contribution(compute_chunk((r + s) % P), comm, +s)
        return acc.to(own.dtype)

    acc = compute_chunk((r - 1) % P)
    if P == 1:
        return acc
    for s in range(1, P):
        acc = t.shift_accumulate(acc, compute_chunk((r - s - 1) % P), comm, +1)
    return acc


def _stream_allreduce_impl(x: torch.Tensor, comm: Communicator, *, quantize=None,
                           dequantize=None, bidir: bool = False, transport=None):
    """Ring all-reduce (RS + AG) of each rank's arbitrary-shaped buffer.  A
    lossy wire needs a floating dtype (casting approximate sums back to an
    integer type would corrupt them silently).  The deprecated
    ``quantize=``/``dequantize=`` keywords compress the reduce-scatter only;
    ``transport="compressed"`` compresses both phases."""
    P = comm.size
    if P == 1:
        return x
    shape, dtype = x.shape, x.dtype
    t = _resolve(transport, comm)
    rs_t = t if quantize is None else _codec_shim(t, quantize, dequantize)
    if _is_lossy(rs_t) and not dtype.is_floating_point:
        raise TypeError(
            f"compressed/quantized all-reduce of {dtype} payload: the lossy wire yields "
            "approximate floats and casting back would silently corrupt integer data; use a "
            "raw transport for integer reduces")
    flat = x.reshape(shape[0], -1)
    orig = flat.shape[1]
    pad = (-orig) % P
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    red = stream_reduce_scatter(flat, comm, transport=rs_t)
    full = stream_allgather(red, comm, bidir=bidir, transport=t)
    if pad:
        full = full[:, :orig]
    return full.reshape(shape).to(dtype)


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
# Deprecated stream_* entry points: thin shims over transient channels.  Each
# opens an anonymous-port collective channel carrying the call's config and
# transfers through it, so results and stats equal the schedules above;
# new code opens a tagged channel (repro_torch.channels) or calls the
# parallel layers.
# ---------------------------------------------------------------------------


def _deprecated(alt: str):
    """Make a function a deprecated shim: every call warns, naming ``alt``."""

    def deco(fn):
        @functools.wraps(fn)
        def shim(*args, **kw):
            warnings.warn(
                f"{fn.__name__} is a deprecated transient-channel shim: untagged, untuned comm "
                f"invisible to the per-tag step accounting.  Use {alt} (see "
                "repro_torch.parallel), or open a tagged channel via repro_torch.channels.",
                DeprecationWarning, stacklevel=2)
            return fn(*args, **kw)

        return shim

    return deco


# each shim's def line names it: the reference's lint (SMI001) flags the names
# outside its own definition site, so these lines carry its suppression


@_deprecated("a tagged bcast channel")
def stream_bcast(x: torch.Tensor, comm: Communicator, *, root: int = 0,  # smilint: ignore[SMI001]
                 n_chunks: int = 1, transport=None):
    """Pipelined chain broadcast (:func:`_stream_bcast_impl`) through a
    transient broadcast channel."""
    from ..channels import open_bcast_channel

    return open_bcast_channel(comm, root=root, port=None, transport=transport,
                              n_chunks=n_chunks).transfer(x)


@_deprecated("a tagged reduce channel")
def stream_reduce(x: torch.Tensor, comm: Communicator, *, root: int = 0,  # smilint: ignore[SMI001]
                  n_chunks: int = 1, op=None, transport=None):
    """Pipelined chain reduction to ``root`` (:func:`_stream_reduce_impl`)
    through a transient reduce channel."""
    from ..channels import open_reduce_channel

    return open_reduce_channel(comm, root=root, port=None, op=op, transport=transport,
                               n_chunks=n_chunks).transfer(x)


@_deprecated("repro_torch.parallel.gather_sequence")
def stream_gather(x: torch.Tensor, comm: Communicator, *,  # smilint: ignore[SMI001]
                  root: int = 0, transport=None):
    """Convoy gather (:func:`_stream_gather_impl`) through a transient
    gather channel."""
    from ..channels import open_gather_channel

    return open_gather_channel(comm, root=root, port=None, transport=transport).transfer(x)


@_deprecated("repro_torch.parallel.reduce_scatter_sequence")
def stream_scatter(x: torch.Tensor, comm: Communicator, *,  # smilint: ignore[SMI001]
                   root: int = 0, transport=None):
    """Convoy scatter (:func:`_stream_scatter_impl`) through a transient
    scatter channel."""
    from ..channels import open_scatter_channel

    return open_scatter_channel(comm, root=root, port=None, transport=transport).transfer(x)


@_deprecated("repro_torch.parallel.all_reduce")
def stream_allreduce(x: torch.Tensor, comm: Communicator, *,  # smilint: ignore[SMI001]
                     quantize=None, dequantize=None, bidir: bool = False, transport=None):
    """Ring all-reduce (:func:`_stream_allreduce_impl`) through a transient
    all-reduce channel; the deprecated ``quantize=``/``dequantize=`` reach
    the schedule's codec shim unchanged."""
    from ..channels import open_allreduce_channel

    return open_allreduce_channel(comm, port=None, transport=transport).transfer(
        x, quantize=quantize, dequantize=dequantize, bidir=bidir)


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


def _resolve_plan(plan, op: str, comm: Communicator, x: torch.Tensor):
    """Turn a plan argument into a concrete netsim Plan.

    ``"auto"`` consults the communicator's cached tuning table for the
    bytes of ONE rank's row of the rank-stacked ``x`` (the reference's
    shard inside ``shard_map``); ``None`` is the static default; a
    :class:`~repro_torch.netsim.Plan` passes through.  A tuned ``int8``
    wire applies to floating payloads only: integer data moves raw, on the
    same plan."""
    import dataclasses

    from ..netsim.tune import DEFAULT_PLAN, Plan

    if plan is None:
        return DEFAULT_PLAN
    if isinstance(plan, Plan):
        p = plan
    elif plan == "auto":
        p = comm.plan(op, x[0].numel() * x.element_size())
    else:
        raise ValueError(f"plan must be 'auto', None or a Plan; got {plan!r}")
    if p.wire != "raw" and not x.dtype.is_floating_point:
        p = dataclasses.replace(p, wire="raw")
    return p


def bcast(x: torch.Tensor, comm: Communicator, *, root: int = 0, plan="auto",
          transport=None):
    """Autotuned broadcast: the tuning table picks the schedule (pipelined
    chain, binomial tree or staged), the chunk count, the backend and the
    wire (an int8 plan matches within the codec's bound) for this topology
    and message size.  ``transport`` overrides the plan's backend only;
    ``plan=None`` runs the static default."""
    p = _resolve_plan(plan, "bcast", comm, x)
    tp = transport if transport is not None else p.transport_key
    if p.algo == "tree":
        return tree_bcast(x, comm, root=root, transport=tp)
    if p.algo == "staged":
        return staged_bcast(x, comm, root=root, transport=tp)
    return _stream_bcast_impl(x, comm, root=root,
                              n_chunks=p.clamp_chunks(x.shape[1]), transport=tp)


def reduce(x: torch.Tensor, comm: Communicator, *, root: int = 0, op=None, plan="auto",
           transport=None):
    """Autotuned rooted reduction (same dispatch rules as :func:`bcast`)."""
    p = _resolve_plan(plan, "reduce", comm, x)
    tp = transport if transport is not None else p.transport_key
    if p.algo == "tree":
        return tree_reduce(x, comm, root=root, op=op, transport=tp)
    if p.algo == "staged":
        return staged_reduce(x, comm, root=root, op=op, transport=tp)
    return _stream_reduce_impl(x, comm, root=root, op=op,
                               n_chunks=p.clamp_chunks(x.shape[1]), transport=tp)


def allreduce(x: torch.Tensor, comm: Communicator, *, plan="auto", transport=None, **kw):
    """Autotuned ring all-reduce.  Only the plan's backend applies: the
    RS+AG schedule fixes its own chunking (nbytes/P blocks)."""
    p = _resolve_plan(plan, "allreduce", comm, x)
    tp = transport if transport is not None else p.transport_key
    return _stream_allreduce_impl(x, comm, transport=tp, **kw)


# ---------------------------------------------------------------------------
# int8 codec for the deprecated quantize=/dequantize= keywords
# ---------------------------------------------------------------------------


def make_int8_codec(axis_elems: int | None = None):
    """``(quantize, dequantize)``: the int8 codec of one rank's tensor, one
    float32 scale per ``axis_elems`` flattened elements (``None``: one scale
    a tensor).  New code passes ``transport="compressed"`` instead: the same
    codec with error feedback and the wire's byte counts."""
    from ..transport.compressed import dequantize_int8, quantize_int8

    def quantize(v):
        return quantize_int8(v, axis_elems)

    def dequantize(wire):
        return dequantize_int8(wire, axis_elems)

    return quantize, dequantize
