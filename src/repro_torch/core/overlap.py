"""Collective-compute overlap (the paper's core idea) and the halo exchange.

SMI's streaming messages exist so that communication happens *during*
pipelined computation rather than before or after it.  Applied to a GEMM
that is the *collective matmul* family (``repro.core.overlap``): each ring
step's shift is interleaved with the per-chunk product, so the transfer of
chunk i+1 overlaps the multiply of chunk i.

* :func:`stream_allgather_matmul` — the column-parallel linear after
  sequence sharding: ``AG(x) @ W`` with the all-gather streamed through the
  GEMM;
* :func:`stream_matmul_reducescatter` — the row-parallel linear:
  ``RS(x @ W)`` with each row block's partial product computed just in
  time;
* :func:`stream_ring_attention` — sequence-parallel attention: the K/V
  blocks stream around the ring inside the online-softmax update;
* :func:`halo_exchange_2d_start` / :func:`halo_exchange_2d_finish` — the
  paper's stencil halo pattern, split so that the caller runs the interior
  update between the two.

Tensors are rank-stacked: row ``r`` of every ``(P, ...)`` tensor is rank
``r``'s buffer.  ``matmul`` is injectable, so kernel D
(:func:`repro_torch.kernels.matmul.matmul`) multiplies each ring step of
all P ranks in one launch; the default is ``torch.matmul`` cast back to the
input's dtype.
"""

from __future__ import annotations

import torch

from ..netsim.schedule import halo_pairs as halo_perm
from .collectives import _chunks, _put_, _take, stream_reduce_scatter
from .comm import Communicator


def _resolve(transport, comm: Communicator):
    from ..transport.registry import resolve_transport

    return resolve_transport(transport, comm)


def _default_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b).to(a.dtype)


def stream_allgather_matmul(x: torch.Tensor, w: torch.Tensor, comm: Communicator, *,
                            matmul=None, bidir: bool = False, return_gathered: bool = False,
                            transport=None):
    """``concat_p(x) @ w`` with the all-gather streamed through the GEMM.

    x: ``(P, m, K)`` — each rank's row block (its sequence shard);
    w: ``(P, K, N)`` — each rank's resident weight (a column shard);
    returns ``(P, P*m, N)``: full rows, local columns, on every rank.

    Per ring step every rank shifts the block it holds one rank on and
    multiplies the block that just arrived: one ``matmul`` call over all P
    ranks.  Rank ``r``'s product of the block that originated at rank
    ``(r - s) % P`` lands in place in row ``(r - s) % P`` of its output.
    ``return_gathered`` also returns the gathered input ``(P, P*m, K)``,
    free on the ring (every shard passes through every rank); ``bidir``
    streams both ring directions."""
    mm = matmul or _default_mm
    P = comm.size
    r = comm.rank()
    t = _resolve(transport, comm)
    Pr, m = x.shape[0], x.shape[1]
    out = _put_(x.new_empty((Pr, P, m, w.shape[-1])), r, mm(x, w))
    gat = _put_(x.new_empty((Pr, P) + tuple(x.shape[1:])), r, x) if return_gathered else None

    def land(buf, slot):
        _put_(out, slot, mm(buf, w))
        if return_gathered:
            _put_(gat, slot, buf)

    if P > 1 and not bidir:
        buf = x
        for s in range(1, P):
            buf = t.shift(buf, comm, +1)  # originated at rank r - s
            land(buf, (r - s) % P)
    elif P > 1:
        up = down = x
        n_up, n_down = P // 2, (P - 1) // 2
        for s in range(1, n_up + 1):
            up = t.shift(up, comm, +1)
            land(up, (r - s) % P)
            if s <= n_down:
                down = t.shift(down, comm, -1)
                land(down, (r + s) % P)
    y = out.reshape(Pr, P * m, -1)
    return (y, gat.reshape(Pr, P * m, -1)) if return_gathered else y


def stream_matmul_reducescatter(x: torch.Tensor, w: torch.Tensor, comm: Communicator, *,
                                matmul=None, transport=None):
    """``reduce_scatter(x @ w)`` with per-block partial GEMMs just in time.

    x: ``(P, P*m, K_local)`` — each rank's full rows, contraction-sharded
    columns; w: ``(P, K_local, N)`` — the matching row shards of the
    weight; returns ``(P, m, N)``: each rank's fully reduced row block.
    Each ring step multiplies the row block every rank needs next, all P
    ranks in one ``matmul`` call."""
    mm = matmul or _default_mm
    xb = _chunks(x, comm.size)

    def compute_chunk(blk):
        return mm(_take(xb, blk), w)

    return stream_reduce_scatter(None, comm, compute_chunk=compute_chunk, transport=transport)


def stream_ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          comm: Communicator, *, causal: bool = True,
                          sm_scale: float | None = None, local_window: int | None = None,
                          transport=None) -> torch.Tensor:
    """Ring attention: the K/V blocks stream around the ring during a
    flash-style online-softmax accumulation (SMI streaming applied to
    attention), in plain PyTorch, as the reference's ``jnp`` body.

    q: ``(P, B, Sq, H, D)`` — each rank's query block (global positions
    ``r*Sq..``); k, v: ``(P, B, Skv, Hkv, D)`` — each rank's K/V block,
    ``Hkv`` dividing ``H`` (GQA).  Returns ``(P, B, Sq, H, D)`` in q's
    dtype.  An arriving block is processed in chunks of ``min(512, Skv)``
    keys, as the reference blocks it; a shard of more than 512 keys that is
    not a multiple of 512 raises ``ValueError``.  ``local_window`` (tokens)
    masks keys at that distance or more; blocks wholly outside it still ride
    the ring (one schedule for every rank)."""
    P = comm.size
    r = comm.rank()
    t = _resolve(transport, comm)
    Pr, B, Sq, H, D = q.shape
    Hkv = k.shape[3]
    g = H // Hkv
    scale = sm_scale if sm_scale is not None else D ** -0.5
    dev = q.device

    qf = q.float() * scale
    m_i = torch.full((Pr, B, H, Sq), -1e30, dtype=torch.float32, device=dev)
    l_i = torch.zeros((Pr, B, H, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((Pr, B, H, Sq, D), dtype=torch.float32, device=dev)
    q_pos = r[:, None] * Sq + torch.arange(Sq, device=dev)          # (P, Sq)
    blk = min(512, k.shape[2])
    if k.shape[2] % blk:
        raise ValueError(f"stream_ring_attention blocks {k.shape[2]} keys a rank in chunks of "
                         f"{blk}; the shard must be a multiple of it (as the reference's reshape "
                         f"needs)")

    def block_update(carry, kv, owner):
        """The online-softmax update of one arriving K/V block, whose keys
        sit at ``owner * Skv..``, in chunks of ``blk`` keys."""
        m_i, l_i, acc = carry
        kb, vb = kv
        Skv = kb.shape[2]
        for j in range(Skv // blk):
            kbe = kb[:, :, j * blk:(j + 1) * blk].float().repeat_interleave(g, dim=3)
            vbe = vb[:, :, j * blk:(j + 1) * blk].float().repeat_interleave(g, dim=3)
            kv_pos = owner[:, None] * Skv + j * blk + torch.arange(blk, device=dev)  # (P, blk)
            s = torch.einsum("pbqhd,pbkhd->pbhqk", qf, kbe)
            mask = torch.ones((Pr, Sq, blk), dtype=torch.bool, device=dev)
            if causal:
                mask = q_pos[:, :, None] >= kv_pos[:, None, :]
            if local_window is not None:
                mask = mask & (q_pos[:, :, None] - kv_pos[:, None, :] < local_window)
            mask = mask[:, None, None]
            s = torch.where(mask, s, -1e30)
            m_new = torch.maximum(m_i, s.amax(dim=-1))
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            corr = torch.exp(m_i - m_new)
            l_i = l_i * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("pbhqk,pbkhd->pbhqd", p, vbe)
            m_i = m_new
        return m_i, l_i, acc

    carry = block_update((m_i, l_i, acc), (k, v), r)
    kv = (k, v)
    for s_ in range(1, P):
        kv = t.shift(kv, comm, +1)
        carry = block_update(carry, kv, (r - s_) % P)
    m_i, l_i, acc = carry
    out = acc / l_i.clamp_min(1e-30)[..., None]
    return out.transpose(2, 3).to(q.dtype)                          # (P, B, Sq, H, D)


def halo_exchange_2d_start(
    x: torch.Tensor,
    comm: Communicator,
    *,
    grid: tuple[int, int],
    halo: tuple[int, int] = (1, 1),
    transport=None,
    tag: str = "halo",
):
    """Launch the four neighbour permutes of a 2D halo exchange and return
    the in-flight halo slabs (south, north, east, west) — the *send edge*
    of the overlap window.  Steps are accounted under ``tag``."""
    RX, RY = grid
    hx, hy = halo
    if comm.size != RX * RY:
        raise ValueError(f"grid {grid} needs {RX * RY} ranks; communicator has {comm.size}")
    t = _resolve(transport, comm)

    with t.tagged(tag):
        def shift(buf, drx, dry):
            pairs = halo_perm(grid, drx, dry)
            if not pairs:
                # a 1-row/1-column grid has no neighbours this direction: no
                # wire step at all (and none accounted) — the paper's unused
                # channels; every rank's halo is zeros
                return torch.zeros_like(buf)
            return t.permute(buf, comm, pairs)

        # x[:, :hx] are each rank's north boundary rows; the north
        # neighbour (rx-1) needs them as its south halo, and so on per
        # direction.
        south_halo = shift(x[:, :hx], -1, 0)   # from rx+1: their north rows
        north_halo = shift(x[:, -hx:], +1, 0)  # from rx-1: their south rows
        east_halo = shift(x[:, :, :hy], 0, -1)  # from ry+1: their west cols
        west_halo = shift(x[:, :, -hy:], 0, +1)  # from ry-1: their east cols
    return south_halo, north_halo, east_halo, west_halo


def halo_exchange_2d_finish(
    x: torch.Tensor,
    inflight,
    comm: Communicator,
    *,
    grid: tuple[int, int],
    halo: tuple[int, int] = (1, 1),
):
    """Assemble the padded tiles from ``x`` and the slabs returned by
    :func:`halo_exchange_2d_start` — the *receive edge* of the overlap
    window.  Physical-boundary halos are zeroed (Dirichlet)."""
    RX, RY = grid
    hx, hy = halo
    south_halo, north_halo, east_halo, west_halo = inflight
    r = comm.rank(x.dim())
    rx, ry = r // RY, r % RY
    P, Nx, Ny = x.shape[0], x.shape[1], x.shape[2]
    out = x.new_zeros((P, Nx + 2 * hx, Ny + 2 * hy) + tuple(x.shape[3:]))
    zero = x.new_zeros(())
    out[:, hx:-hx, hy:-hy] = x
    out[:, :hx, hy:-hy] = torch.where(rx > 0, north_halo, zero)
    out[:, -hx:, hy:-hy] = torch.where(rx < RX - 1, south_halo, zero)
    out[:, hx:-hx, :hy] = torch.where(ry > 0, west_halo, zero)
    out[:, hx:-hx, -hy:] = torch.where(ry < RY - 1, east_halo, zero)
    return out


def halo_exchange_2d(
    x: torch.Tensor,
    comm: Communicator,
    *,
    grid: tuple[int, int],
    halo: tuple[int, int] = (1, 1),
    transport=None,
):
    """Exchange N/S/E/W halo slabs of a 2D-decomposed domain (paper
    Fig. 14) and return the tiles padded with the received halos (zero at
    physical boundaries).  The non-overlapped composition."""
    inflight = halo_exchange_2d_start(x, comm, grid=grid, halo=halo, transport=transport)
    return halo_exchange_2d_finish(x, inflight, comm, grid=grid, halo=halo)
