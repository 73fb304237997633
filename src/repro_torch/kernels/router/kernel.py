"""Kernel C: a whole packet-router run in one CUDA launch.

:func:`router_run` launches ``csrc/router.cu`` on CUDA tensors and runs the
plain version :func:`~.ref.router_run_ref` on CPU tensors.  It replaces the
Pallas kernel ``router_tick_pallas`` of
``src/repro/kernels/router/kernel.py``, which runs one tick of one rank per
``pallas_call`` inside a ``lax.scan`` with an ``all_to_all`` between ticks.
Here one thread block runs every tick of every rank, with the router's
control state in shared memory and the exchange a read of the neighbour's
send slot; it is bound by the chain of dependent ticks, not by bytes (see
the source's note).  The route table is a runtime input, so a new table
builds and loads nothing.
"""

from __future__ import annotations

import functools

import torch

from ..build import check_launch, current_stream, library
from .ref import I32, TickSpec, router_run_ref

#: most input FIFOs per rank the kernel takes (n_ports + 1 candidates <= 16)
MAX_PORTS = 15


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
               tick_batch: int = 4):
    """Up to ``n_steps`` router ticks on every rank: the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors (``tick_batch`` is the plain
    version's drain-check period; the kernel checks every tick).

    ``route_tbl (P, P)``, ``src (P, NL)``, ``inq_dst (P, NP, fifo_cap)`` and
    ``inq_len (P, NP)`` are int32; ``inq_pay (P, NP, fifo_cap, E)`` is
    float32.  Returns ``(out_pay, out_cnt, overflow, t_done, ticks)``; on
    the card ``ticks`` is a ``(1,)`` int32 tensor (no host sync), on the CPU
    a Python int.  Raises on anything the kernel does not take and on a
    failed launch.  ``router_run.launches`` counts kernel launches.
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
    if spec.n != P or NL == 0 or not 1 <= NP <= MAX_PORTS or min(FC, spec.transit_cap) < 1:
        raise ValueError(f"router_run kernel does not take {spec} on {P} ranks")

    out_pay = torch.zeros((P, NP, spec.out_cap, E), dtype=torch.float32, device=dev)
    out_cnt = torch.empty((P, NP), dtype=I32, device=dev)
    overflow = torch.empty((P,), dtype=I32, device=dev)
    t_done = torch.empty((P,), dtype=I32, device=dev)
    ticks = torch.empty((1,), dtype=I32, device=dev)
    tr_pay = torch.empty((P, spec.transit_cap + 1, E), dtype=torch.float32, device=dev)
    tr_ctl = torch.empty((2, P, spec.transit_cap + 1), dtype=I32, device=dev)
    link_ids = _link_ids(spec.link_ids, dev)
    lib = library()
    with torch.cuda.device(dev):
        err = lib.smi_router_run(
            inq_pay.data_ptr(), inq_dst.data_ptr(), inq_len.data_ptr(), route_tbl.data_ptr(),
            src.data_ptr(), link_ids.data_ptr(), out_pay.data_ptr(), out_cnt.data_ptr(),
            overflow.data_ptr(), t_done.data_ptr(), ticks.data_ptr(), tr_pay.data_ptr(),
            tr_ctl.data_ptr(), P, NP, FC, spec.transit_cap, spec.out_cap, E, NL, spec.R,
            int(spec.switch_bubble), int(n_steps), _threads(P, NL, E), current_stream(inq_pay))
    check_launch(err, "router_run")
    router_run.launches += 1
    return out_pay, out_cnt, overflow, t_done, ticks


router_run.launches = 0
