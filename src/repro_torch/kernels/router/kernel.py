"""Kernel C: a whole packet-router run in one CUDA launch, or one tick of a
block of ranks a launch (:func:`router_tick_block`, for ranks run as
processes).

:func:`router_run` launches ``csrc/router.cu`` on CUDA tensors and runs the
plain version :func:`~.ref.router_run_ref` on CPU tensors.  It replaces the
Pallas kernel ``router_tick_pallas`` of
``src/repro/kernels/router/kernel.py``, which runs one tick of one rank per
``pallas_call`` inside a ``lax.scan`` with an ``all_to_all`` between ticks.
Here one thread block runs every tick of every rank, with the exchange a
read of the neighbour's send slot; it is bound by the chain of dependent
ticks, not by bytes (see the source's note).  The route table is a runtime
input, so a new table builds and loads nothing.

Two CUDA kernels compute it, and :func:`router_path` picks one by shape
alone: :data:`WARP` (a rank on a warp's lanes, several ranks a warp when
they fit, the tick a chain of shared-memory and warp operations, payloads
gathered once after the run) for P <= 32 when its shared memory fits,
:data:`THREAD` (the first kernel, one thread per rank, the staged headers,
transit ring and payload copies in device memory) for the rest.  The pick
is not a fallback: a call the dispatch sends to a path launches that
path's kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from ..build import check_launch, current_stream, library
from .ref import I32, ROW_HEAD, TickSpec, router_run_ref, router_tick_block_plain

#: most input FIFOs per rank the thread path takes (n_ports + 1 candidates <= 16)
MAX_PORTS = 15
WARP, THREAD = "warp", "thread"
#: most ranks, and most candidates or links a rank, the warp path takes (a lane each)
WARP_MAX_RANKS = WARP_MAX_LANES = 32
#: warps of the warp path's block: its ranks' control and delivery warps
WARP_MAX_WARPS = 32
#: the warp path packs a packet's origin (its row of the staged input) in 20 bits
WARP_MAX_ORIGINS = 1 << 20
#: shared memory a block can have on an H100 (227 KB)
MAX_SHARED_BYTES = 232448


def warp_shared_bytes(P: int, n_ports: int, n_links: int, fifo_cap: int,
                      transit_cap: int) -> int:
    """Shared memory of the warp path (``csrc/router.cu`` computes the same):
    two sets of send slots, the route table and the deliveries' overflow, 4
    bytes each; the transit rings, an origin each (2 bytes while the staged
    packets number at most 2^16, else 4); the staged headers, a byte each."""
    origins = P * n_ports * fifo_cap
    ring = 2 if origins <= 1 << 16 else 4
    return 4 * (2 * P * n_links + P * P + P) + ring * P * transit_cap + origins


def warp_lanes(n_ports: int, n_links: int) -> int:
    """Lanes a rank takes on the warp path: the power of two that holds its
    candidates (the FIFO heads and the transit head) and its links."""
    lanes = 1
    while lanes < max(n_ports + 1, n_links):
        lanes *= 2
    return lanes


def router_path(P: int, n_ports: int, n_links: int, fifo_cap: int, transit_cap: int) -> str:
    """Which kernel C runs a router of ``P`` ranks with this shape:
    :data:`WARP` for ``P <= 32`` when a lane holds each candidate and each
    link, the ranks' control and delivery warps fit a block, the staged
    packets fit the 20-bit origin and the warp path's shared memory fits a
    block; :data:`THREAD` for the rest."""
    lanes = warp_lanes(n_ports, n_links)
    fits = (P <= WARP_MAX_RANKS and lanes <= WARP_MAX_LANES
            and 2 * -(-P // (32 // lanes)) <= WARP_MAX_WARPS
            and P * n_ports * fifo_cap < WARP_MAX_ORIGINS
            and warp_shared_bytes(P, n_ports, n_links, fifo_cap, transit_cap)
            <= MAX_SHARED_BYTES)
    return WARP if fits else THREAD


@functools.lru_cache(maxsize=64)
def _link_ids(link_ids: tuple, device: torch.device) -> torch.Tensor:
    """The link ids on ``device``, made once per fabric: a copy from host
    memory to the card would synchronise every launch."""
    return torch.tensor(link_ids, dtype=I32, device=device)


def _threads(P: int, NL: int, E: int) -> int:
    """One thread per 16-byte word of a tick's largest payload move, in
    whole warps, between 128 and 1024."""
    words = P * NL * (E // 4 if E % 4 == 0 else E)
    return max(128, min(1024, -(-words // 32) * 32))


def router_run(spec: TickSpec, route_tbl, src, inq_pay, inq_dst, inq_len, n_steps: int,
               tick_batch: int = 4, path: str | None = None):
    """Up to ``n_steps`` router ticks on every rank: the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors (``tick_batch`` is the plain
    version's drain-check period; the kernels check every tick).

    ``route_tbl (P, P)``, ``src (P, NL)``, ``inq_dst (P, NP, fifo_cap)`` and
    ``inq_len (P, NP)`` are int32; ``inq_pay (P, NP, fifo_cap, E)`` is
    float32; the link ids are distinct.  ``path`` names the kernel (default
    :func:`router_path`'s pick).  Returns ``(out_pay, out_cnt, overflow,
    t_done, ticks)``; on the card ``ticks`` is a ``(1,)`` int32 tensor (no
    host sync), on the CPU a Python int.  Raises on anything the kernel does
    not take and on a failed launch.  ``router_run.launches`` counts kernel
    launches, ``router_run.warp_launches`` those of the warp path.
    """
    args = (route_tbl, src, inq_pay, inq_dst, inq_len)
    dev = inq_pay.device
    if any(a.device != dev for a in args):
        raise ValueError("router_run needs all its tensors on one device")
    if dev.type == "cpu":
        return router_run_ref(spec, route_tbl, src, inq_pay, inq_dst, inq_len, n_steps,
                              tick_batch)
    if dev.type != "cuda":
        raise ValueError(f"router_run runs on cuda or cpu, not {dev}")
    P, NP, FC, E, NL = inq_pay.shape[0], spec.n_ports, spec.fifo_cap, spec.pkt_elems, spec.n_links
    if inq_pay.dtype != torch.float32:
        raise TypeError(f"router_run kernel moves a float32 wire, not {inq_pay.dtype}")
    if any(a.dtype != I32 for a in (route_tbl, src, inq_dst, inq_len)):
        raise TypeError("router_run kernel needs int32 route table, exchange table and headers")
    if not all(a.is_contiguous() for a in args):
        raise ValueError("router_run kernel needs contiguous tensors")
    shapes = {"inq_pay": (P, NP, FC, E), "inq_dst": (P, NP, FC), "inq_len": (P, NP),
              "route_tbl": (P, P), "src": (P, NL)}
    for name, a in zip(("route_tbl", "src", "inq_pay", "inq_dst", "inq_len"), args):
        if tuple(a.shape) != shapes[name]:
            raise ValueError(f"router_run: {name} has shape {tuple(a.shape)}, "
                             f"expected {shapes[name]}")
    TC, OC = spec.transit_cap, spec.out_cap
    if spec.n != P or NL == 0 or NP < 1 or min(FC, TC, OC) < 1:
        raise ValueError(f"router_run kernel does not take {spec} on {P} ranks")
    if len(set(spec.link_ids)) != NL:
        raise ValueError(f"router_run kernel needs distinct link ids, not {spec.link_ids}")
    path = path or router_path(P, NP, NL, FC, TC)
    if path == WARP and router_path(P, NP, NL, FC, TC) != WARP:
        raise ValueError(f"the warp path of router_run does not take {spec} on {P} ranks")
    if path == THREAD and NP > MAX_PORTS:
        raise ValueError(f"the thread path of router_run takes at most {MAX_PORTS} ports, "
                         f"not {NP}")
    if path not in (WARP, THREAD):
        raise ValueError(f"kernel C has the paths {WARP!r} and {THREAD!r}, not {path!r}")

    out_cnt = torch.empty((P, NP), dtype=I32, device=dev)
    overflow = torch.empty((P,), dtype=I32, device=dev)
    t_done = torch.empty((P,), dtype=I32, device=dev)
    ticks = torch.empty((1,), dtype=I32, device=dev)
    link_ids = _link_ids(spec.link_ids, dev)
    lib = library()
    if path == WARP:
        # every slot is written by the payload gather: no zero fill
        out_pay = torch.empty((P, NP, OC, E), dtype=torch.float32, device=dev)
        org = torch.empty((P, NP, OC), dtype=I32, device=dev)
        with torch.cuda.device(dev):
            err = lib.smi_router_run_warp(
                inq_pay.data_ptr(), inq_dst.data_ptr(), inq_len.data_ptr(),
                route_tbl.data_ptr(), src.data_ptr(), link_ids.data_ptr(), out_pay.data_ptr(),
                out_cnt.data_ptr(), overflow.data_ptr(), t_done.data_ptr(), ticks.data_ptr(),
                org.data_ptr(), P, NP, FC, TC, OC, E, NL, spec.R, int(spec.switch_bubble),
                int(n_steps), current_stream(inq_pay))
        check_launch(err, "router_run (warp)")
        router_run.warp_launches += 1
    else:
        out_pay = torch.zeros((P, NP, OC, E), dtype=torch.float32, device=dev)
        tr_pay = torch.empty((P, TC + 1, E), dtype=torch.float32, device=dev)
        tr_ctl = torch.empty((2, P, TC + 1), dtype=I32, device=dev)
        with torch.cuda.device(dev):
            err = lib.smi_router_run(
                inq_pay.data_ptr(), inq_dst.data_ptr(), inq_len.data_ptr(),
                route_tbl.data_ptr(), src.data_ptr(), link_ids.data_ptr(), out_pay.data_ptr(),
                out_cnt.data_ptr(), overflow.data_ptr(), t_done.data_ptr(), ticks.data_ptr(),
                tr_pay.data_ptr(), tr_ctl.data_ptr(), P, NP, FC, TC, OC, E, NL, spec.R,
                int(spec.switch_bubble), int(n_steps), _threads(P, NL, E),
                current_stream(inq_pay))
        check_launch(err, "router_run (thread)")
    router_run.launches += 1
    return out_pay, out_cnt, overflow, t_done, ticks


router_run.launches = 0
router_run.warp_launches = 0

#: the router state the block-tick form reads and writes in place (ref.py:init_state's keys)
STATE_KEYS = ("inq_head", "tr_pay", "tr_dst", "tr_port", "tr_head", "tr_cnt", "out_pay",
              "out_cnt", "overflow", "last_src", "stick", "t_done")
#: most links a rank takes on the block-tick form
TICK_MAX_LINKS = 32


def router_tick_block(spec: TickSpec, my_tbl, inq_pay, inq_dst, inq_len, st, arr, lo: int,
                      t: int, arbitrate: bool = True):
    """One router tick of the ranks ``[lo, lo + n)`` of ``spec.n``: kernel
    C's block-tick form on CUDA tensors, its plain version
    :func:`~.ref.router_tick_block_plain` on CPU tensors.

    The form ranks run as processes use: a process ticks the ranks it holds,
    one launch a tick, and the link rows cross between processes between
    launches (:meth:`~repro_torch.core.spmd.RankGroup.exchange_links`).
    ``my_tbl (n, P)``, ``inq_dst (n, NP, fifo_cap)`` and ``inq_len (n, NP)``
    are int32, ``inq_pay (n, NP, fifo_cap, E)`` float32, ``st`` the block's
    state (:func:`~.ref.init_state` of ``n`` ranks), ``arr (n, NL, ROW_HEAD +
    E)`` int32 the rows that arrived from tick ``t - 1``.  Returns ``(st,
    snd, pending)`` as the plain version does; on the card ``st``'s tensors
    are updated in place.  Raises on anything the kernel does not take and
    on a failed launch.  ``router_tick_block.launches`` counts launches.
    """
    dev = inq_pay.device
    args = (my_tbl, inq_pay, inq_dst, inq_len, arr, *(st[k] for k in STATE_KEYS))
    if any(a.device != dev for a in args):
        raise ValueError("router_tick_block needs all its tensors on one device")
    if dev.type == "cpu":
        return router_tick_block_plain(spec, my_tbl, inq_pay, inq_dst, inq_len, st, arr, lo, t,
                                       arbitrate)
    if dev.type != "cuda":
        raise ValueError(f"router_tick_block runs on cuda or cpu, not {dev}")
    n, NP, FC, E, NL = inq_pay.shape[0], spec.n_ports, spec.fifo_cap, spec.pkt_elems, spec.n_links
    TC, OC, P = spec.transit_cap, spec.out_cap, spec.n
    payloads = (inq_pay, st["tr_pay"], st["out_pay"])
    if any(a.dtype != torch.float32 for a in payloads):
        raise TypeError("router_tick_block kernel moves a float32 wire")
    if any(a.dtype != I32 for a in args if all(a is not b for b in payloads)):
        raise TypeError("router_tick_block kernel needs int32 tables, headers, rows and counters")
    if not all(a.is_contiguous() for a in args):
        raise ValueError("router_tick_block kernel needs contiguous tensors")
    shapes = {"my_tbl": (n, P), "inq_pay": (n, NP, FC, E), "inq_dst": (n, NP, FC),
              "inq_len": (n, NP), "arr": (n, NL, ROW_HEAD + E), "inq_head": (n, NP),
              "tr_pay": (n, TC, E), "tr_dst": (n, TC), "tr_port": (n, TC), "tr_head": (n,),
              "tr_cnt": (n,), "out_pay": (n, NP, OC, E), "out_cnt": (n, NP), "overflow": (n,),
              "last_src": (n, NL), "stick": (n, NL), "t_done": (n,)}
    for name, a in zip(("my_tbl", "inq_pay", "inq_dst", "inq_len", "arr", *STATE_KEYS), args):
        if tuple(a.shape) != shapes[name]:
            raise ValueError(f"router_tick_block: {name} has shape {tuple(a.shape)}, "
                             f"expected {shapes[name]}")
    if not (0 <= lo and lo + n <= P) or NP > MAX_PORTS or not 1 <= NL <= TICK_MAX_LINKS \
            or min(FC, TC, OC, NP) < 1:
        raise ValueError(f"router_tick_block kernel does not take {spec} on ranks "
                         f"[{lo}, {lo + n})")
    snd = pending = None  # the absorb alone writes neither
    if arbitrate:
        snd = torch.empty((n, NL, ROW_HEAD + E), dtype=I32, device=dev)
        pending = torch.empty((n,), dtype=I32, device=dev)
    link_ids = _link_ids(spec.link_ids, dev)
    with torch.cuda.device(dev):
        err = library().smi_router_tick_block(
            inq_pay.data_ptr(), inq_dst.data_ptr(), inq_len.data_ptr(), my_tbl.data_ptr(),
            link_ids.data_ptr(), arr.data_ptr(), snd.data_ptr() if arbitrate else None,
            *(st[k].data_ptr() for k in STATE_KEYS),
            pending.data_ptr() if arbitrate else None, n, lo, P, NP, FC, TC,
            OC, E, NL, spec.R, int(spec.switch_bubble), int(t), int(arbitrate),
            current_stream(inq_pay))
    check_launch(err, "router_tick_block")
    router_tick_block.launches += 1
    return st, snd, pending


router_tick_block.launches = 0
