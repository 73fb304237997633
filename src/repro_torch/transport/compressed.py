"""Compressed-link transport: an int8 wire over any inner backend, a port of
``repro.transport.compressed``.

:class:`CompressedTransport` wraps an *inner* backend (static, fused or
packet) and quantises every rank's payload at the send edge of each logical
step — ``permute``/``shift``, ``shift_accumulate``, ``p2p`` — and
dequantises it at the receive edge.  Registry keys: ``"compressed"``
(static inner) and ``"compressed:<inner>"``.

Wire format, per rank and per tensor: the payload flattens to float32 and
splits into ``axis_elems``-sized blocks, each with one float32 scale
(``max|block| / 127``, computed as the reference's compiled codec computes
it, a multiply by float32(1/127)) beside its int8 codes; on the wire the codes and the
scales' bytes (bit-cast) travel as one flat int8 row, so every inner backend
moves it unchanged (the packet wire carries int8 values exactly) and the
inner backend's stats count the true wire bytes, ``n + 4 * ceil(n /
axis_elems)`` a rank.  Codes divide (``blocks / scales``, never a multiply
by the reciprocal) and round half to even, as in the reference, so the
codes and scales equal those the reference's wire carries bit for bit.  Requantising a
dequantised block reproduces its codes, so multi-hop chains pay the
quantisation error once.

The ring reduce-scatter does not re-round a travelling partial sum:
:meth:`CompressedTransport.send_contribution` quantises each hop's
contribution once, with an error-feedback residual (transmit ``Q(c + e)``,
carry ``e' = (c + e) - dq(Q(c + e))``), and ``stream_reduce_scatter`` ships
it straight to its home rank.  The reference keeps that residual for one
JAX trace; an eager instance here would carry it from one call into the
next, so ``stream_reduce_scatter`` starts every call at a zero residual
(:meth:`reset_state`): two calls on one instance equal two calls on fresh
instances.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..netsim.model import WIRE_AXIS_ELEMS, clamp_chunks
from .base import Transport
from .registry import register_transport

# ------------------------------------------------------------------ codec


def _n_blocks(n: int, axis_elems: int) -> int:
    return -(-n // axis_elems) if n else 0


def _block_elems(n: int, axis_elems: int | None) -> int:
    """Effective block size: ``None`` means one scale for the whole tensor;
    otherwise clamped to the element count."""
    if axis_elems is None:
        return max(n, 1)
    return max(1, min(int(axis_elems), max(n, 1)))


#: the scale of a block is ``max|block|`` times float32(1/127): the reference
#: writes ``max / 127.0``, and XLA compiles a division by a constant into a
#: multiply by its reciprocal, so that product is what its wire carries
_INV_127 = 1.0 / 127.0


def _quantize_rows(x: torch.Tensor, axis_elems):
    """Rank-stacked ``x`` ``(P, ...)`` -> ``(q, scales)``: int8 codes shaped
    like ``x`` and ``(P, n_blocks)`` float32 scales, every rank's row
    quantised on its own."""
    if not x.dtype.is_floating_point:
        raise TypeError(
            f"int8 wire compression carries floating payloads; got {x.dtype} "
            "(a lossy wire on integer data would silently corrupt it)")
    P = x.shape[0]
    flat = x.reshape(P, -1).float()
    n = flat.shape[1]
    ae = _block_elems(n, axis_elems)
    nb = _n_blocks(n, ae)
    blocks = F.pad(flat, (0, nb * ae - n)).reshape(P, nb, ae)
    scales = blocks.abs().amax(dim=2).clamp_min(1e-8) * _INV_127
    q = torch.clamp(torch.round(blocks / scales[..., None]), -127, 127)
    return q.to(torch.int8).reshape(P, nb * ae)[:, :n].reshape(x.shape), scales


def _dequantize_rows(q: torch.Tensor, scales: torch.Tensor, axis_elems) -> torch.Tensor:
    """Inverse of :func:`_quantize_rows` (float32, shaped like ``q``)."""
    n = q[0].numel()
    ae = _block_elems(n, axis_elems)
    per_elem = scales.repeat_interleave(ae, dim=1)[:, :n].reshape(q.shape)
    return q.float() * per_elem


def quantize_int8(v: torch.Tensor, axis_elems: int | None = WIRE_AXIS_ELEMS):
    """``v`` (any shape, floating) -> ``(q, scales)``: int8 codes shaped like
    ``v`` and one float32 scale per ``axis_elems``-sized block of the
    flattened payload (``None``: one scale for the tensor)."""
    q, scales = _quantize_rows(v.reshape((1,) + tuple(v.shape)), axis_elems)
    return q[0], scales[0]


def dequantize_int8(wire, axis_elems: int | None = WIRE_AXIS_ELEMS) -> torch.Tensor:
    """Inverse of :func:`quantize_int8` (a float32 result shaped like ``q``)."""
    q, scales = wire
    return _dequantize_rows(q[None], scales[None], axis_elems)[0]


def _pack_wire(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Rank-stacked ``(q, scales)`` -> ``(P, n + 4 n_blocks)`` int8 rows: the
    codes, then the scales' bytes."""
    P = q.shape[0]
    return torch.cat((q.reshape(P, -1), scales.contiguous().view(torch.int8).reshape(P, -1)),
                     dim=1)


def _unpack_wire(wire: torch.Tensor, shape, n_blocks: int):
    n = wire.shape[1] - 4 * n_blocks
    q = wire[:, :n].reshape(shape)
    scales = wire[:, n:].contiguous().view(torch.float32)
    return q, scales


# -------------------------------------------------------------- transport


@register_transport("compressed")
@dataclass
class CompressedTransport(Transport):
    """int8 compressed links over any inner backend.

    ``inner`` is a registry key or a Transport instance (the wrapper adopts
    its stats, so steps and bytes tally in one place, at the wire's bytes).
    ``axis_elems`` is the scale-block size (``None``: one scale a tensor);
    ``error_feedback`` turns on the residual of :meth:`send_contribution`;
    ``codec`` replaces the built-in codec with a ``(quantize, dequantize)``
    pair of one-rank functions whose wire is a tuple of tensors (the
    deprecated ``quantize=``/``dequantize=`` keywords; the
    ``send_contribution`` and ``permute`` paths only).
    """

    inner: object = "static"
    axis_elems: int | None = WIRE_AXIS_ELEMS
    error_feedback: bool = True
    codec: tuple | None = None

    #: results differ from the raw wire within the codec's error bound
    lossy_wire = True
    #: registry marker: ``"compressed:<inner>"`` keys construct this class
    wraps_inner = True

    def __post_init__(self):
        from .registry import get_transport

        if isinstance(self.inner, Transport) and self.device is None:
            self.device = self.inner.device
        super().__post_init__()
        if not isinstance(self.inner, Transport):
            self.inner = get_transport(self.inner or "static", device=self.device)
        self.stats = self.inner.stats
        self._ef = None  # error-feedback residual of the current collective call

    # ------------------------------------------------------------- wire

    def _encode(self, v: torch.Tensor) -> tuple:
        """Rank-stacked ``v`` -> the tuple of rank-stacked wire tensors."""
        if self.codec is not None:
            wires = [tuple(self.codec[0](row)) for row in v]
            return tuple(torch.stack(leaf) for leaf in zip(*wires))
        return (_pack_wire(*_quantize_rows(v, self.axis_elems)),)

    def _decode_f32(self, wire: tuple, ref: torch.Tensor) -> torch.Tensor:
        """Wire -> float32 payload shaped like ``ref``."""
        if self.codec is not None:
            return torch.stack([self.codec[1](tuple(leaf[r] for leaf in wire))
                                for r in range(ref.shape[0])]).reshape(ref.shape)
        n = ref[0].numel()
        nb = _n_blocks(n, _block_elems(n, self.axis_elems))
        return _dequantize_rows(*_unpack_wire(wire[0], ref.shape, nb), self.axis_elems)

    def _decode(self, wire: tuple, ref: torch.Tensor) -> torch.Tensor:
        return self._decode_f32(wire, ref).to(ref.dtype)

    # ------------------------------------------------------------- steps

    def permute(self, x, comm, pairs):
        """One inner step moving every member's wire (a tuple ``x`` rides as
        one step, as in the reference)."""
        leaves = x if isinstance(x, tuple) else (x,)
        self._check(leaves)
        wires = [self._encode(v) for v in leaves]
        moved = self.inner.permute(tuple(w for ws in wires for w in ws), comm, pairs)
        out, i = [], 0
        for ws, v in zip(wires, leaves):
            out.append(self._decode(moved[i:i + len(ws)], v))
            i += len(ws)
        return tuple(out) if isinstance(x, tuple) else out[0]

    def shift_accumulate(self, x, addend, comm, step: int = 1):
        """The generic lossy hot path, ``dq(shift(Q(x))) + addend`` in
        float32: it re-rounds a travelling accumulator, so error compounds
        with the hops; ``stream_reduce_scatter`` does not use it on a lossy
        wire (it takes :meth:`send_contribution`'s schedule)."""
        return self.shift(x, comm, step).float() + addend.float()

    def send_contribution(self, c, comm, step: int = 1):
        """Quantise ``c`` once (with error feedback) and ship it a ring
        distance ``step``; returns the dequantised float32 arrival.  The
        residual is taken against the local wire, which the inner backend
        moves bit for bit, so it is what the destination dequantises."""
        self._check(c)
        u = c.float()
        if self.error_feedback:
            # a residual of another shape (another collective) starts at zero
            fresh = self._ef is None or self._ef.shape != u.shape
            u = u + (torch.zeros_like(u) if fresh else self._ef)
        wire = self._encode(u)
        if self.error_feedback:
            self._ef = u - self._decode_f32(wire, u)
        moved = self.inner.permute(wire, comm, comm.ring_perm(step))
        return self._decode_f32(moved, u)

    def p2p(self, x, *, src, dst, comm, n_chunks: int = 1):
        if self.codec is not None:
            raise NotImplementedError(
                "custom-codec CompressedTransport supports shift/permute paths only; use "
                "the built-in int8 codec for p2p")
        if src == dst:
            return x
        self._check(x)
        wire = _pack_wire(*_quantize_rows(x, self.axis_elems))
        nc = clamp_chunks(n_chunks, wire.shape[1])
        got = self.inner.p2p(wire, src=src, dst=dst, comm=comm, n_chunks=nc)
        return self._decode((got,), x)

    # ------------------------------------------------------ residual, stats

    def reset_state(self):
        """Drop the error-feedback residual (a fresh collective call)."""
        self._ef = None

    def reset_stats(self):
        super().reset_stats()
        self.inner.stats = self.stats
        self.reset_state()
