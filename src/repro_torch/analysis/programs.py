"""The in-repo programs smilint's capture pass sweeps
(``repro.analysis.programs``).

Each entry runs one real program of the port — the training step, the
continuous-serving decode step and slot migration, the distributed
stencil, and channel-API programs in the shape of the collective benchmark
and the quickstart example — under :func:`repro_torch.analysis.capture`,
then verifies the recorded ledger.  The sweep gates every entry on **zero
diagnostics** and **zero real transport steps** (no message moved).

The port has no ``lower()``: a captured program runs eagerly, every
collective returning zeros from the abstract backend while the compute
runs.  The programs run on ``device`` — ``cuda`` unless the caller names
the CPU — at the reference's smoke sizes (the meta device is not used: the
serving step samples tokens on the host and the caches are written in
place, which a meta tensor cannot do).  They are the reference's programs
at its sizes; the one difference in what they record is that an eager loop
records its body once an iteration (the quickstart's pipeline records 12
pushes and 14 pops where the reference's rolled loop records one of each).

Imports the launch stack, so the CLI imports this module explicitly.
"""

from __future__ import annotations

import torch

from . import capture as _capture
from .verify import verify_ledger


def capture_train(dims=(2, 4), comm_mode: str = "smi:static", device=None):
    """One smoke training step of yi-6b (the validate-comm recipe),
    captured."""
    from ..configs import ShapeConfig, get_arch, smoke
    from ..launch.steps import TrainSettings, build_train

    cfg = smoke(get_arch("yi-6b"))
    shape = ShapeConfig("smilint", seq_len=128, global_batch=8, kind="train")
    settings = TrainSettings(comm_mode=comm_mode, remat="nothing", base_lr=3e-4, loss_chunks=1,
                             total_steps=10, warmup_steps=1)
    with _capture.capture() as led:
        art = build_train(cfg, shape, settings, mesh=tuple(dims), device=device)
        batch = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in art["input_specs"].items()}
        art["step"](art["init_state"](), batch)
    return led


def capture_serve(dims=(2, 4), comm_mode: str = "smi:static", *, cfg=None, params=None,
                  device=None):
    """One continuous decode step and one slot migration over the
    persistent ``serve.*`` channel pool, captured; the pool closes inside
    the block so its claims balance (no SMI105).  ``cfg`` defaults to the
    reference's program, glm4-9b's smoke config; ``params`` (laid out for
    the runtime) default to seeded ones."""
    from ..configs import get_arch, smoke
    from ..core.comm import resolve_device
    from ..interop import shard_params
    from ..launch.steps import build_continuous_serve
    from ..models import init_lm
    from ..models.model import model_dtype
    from ..serving.engine import token_shape

    cfg = cfg if cfg is not None else smoke(get_arch("glm4-9b"))
    dev = resolve_device(device)
    tp = dims[-1]
    with _capture.capture() as led:
        rt = build_continuous_serve(cfg, mesh=tuple(dims), comm_mode=comm_mode, batch_slots=2,
                                    capacity=64, device=dev)
        ctx = rt["ctx"]
        if params is None:
            gen = torch.Generator(device=dev).manual_seed(0)
            params = shard_params(init_lm(cfg, gen, dev, dtype=model_dtype(cfg), ctx=ctx), cfg,
                                  ctx, rt["plan"])
        B = rt["batch_slots"]
        caches = rt["init_caches"]()
        tok = torch.zeros(token_shape(cfg, B), dtype=torch.int32, device=dev)
        pos = torch.zeros(B, dtype=torch.int32, device=dev)
        rt["step"](params, caches, tok, pos)
        if tp > 1:
            inflight = rt["migrate_start"](caches, 0)
            rt["migrate_finish"](caches, inflight, 0)
        if rt["pool"] is not None:
            rt["pool"].close()
    return led


def capture_stencil(grid=(2, 4), domain=(32, 32), comm_mode: str = "smi", n_steps: int = 1,
                    device=None):
    """``n_steps`` steps of the distributed halo-exchange stencil,
    captured."""
    from ..apps import DistributedStencil

    app = DistributedStencil.create(tuple(grid), comm_mode=comm_mode, device=device)
    tiles = app.scatter(torch.zeros(tuple(domain), dtype=torch.float32))
    with _capture.capture() as led:
        app.run(tiles, n_steps)
    return led


def capture_bench_collectives(size: int = 8, device=None):
    """The collective-benchmark program shape: all five collective channel
    kinds opened anonymously and driven by one whole-message transfer
    each."""
    from ..channels import (
        open_allreduce_channel,
        open_bcast_channel,
        open_gather_channel,
        open_reduce_channel,
        open_scatter_channel,
    )
    from ..core import Communicator

    comm = Communicator.create("x", (size,), device=device)
    dev = comm.device
    v = torch.zeros((size, 4, 3), device=dev)
    gv = torch.zeros((size, 2, 3), device=dev)
    fv = torch.zeros((size, size * 2, 3), device=dev)
    with _capture.capture() as led:
        open_bcast_channel(comm, root=1, port=None, n_chunks=2).transfer(v)
        open_reduce_channel(comm, root=0, port=None, n_chunks=2).transfer(v)
        open_gather_channel(comm, root=0, port=None).transfer(gv)
        open_scatter_channel(comm, root=0, port=None).transfer(fv)
        open_allreduce_channel(comm, port=None).transfer(v)
    return led


def capture_quickstart(size: int = 8, count: int = 12, device=None):
    """The quickstart example's element pipeline: a claimed p2p channel
    pushed and popped through the warm-up/drain loop (paper Listing 1),
    then a whole-message transfer and a broadcast over anonymous ports.
    The loop pushes ``count`` elements and pops ``count + hops - 1``
    times (the reference's rolled loop pushes on every iteration; the
    ones past ``count`` are never delivered, which an eager record would
    report as SMI103)."""
    from ..channels import open_bcast_channel, open_channel
    from ..core import Communicator, Topology

    comm = Communicator.create("x", (size,), topology=Topology.bus(size), device=device)
    dev = comm.device
    src, dst = 0, 3
    hops = comm.route_table.n_hops(src, dst)
    with _capture.capture() as led:
        with open_channel(comm, count=count, src=src, dst=dst, port=0, elem_shape=(),
                          dtype=torch.float32) as chan:
            acc = torch.zeros((size, count), device=dev)
            for i in range(count + hops - 1):
                if i < count:
                    chan = chan.push(torch.sin(torch.tensor(float(i), device=dev)))
                chan, val, valid = chan.pop()
                slot = max(i - (hops - 1), 0)
                acc[:, slot] = torch.where(valid, val, acc[:, slot])
        y = open_channel(comm, src=src, dst=dst, port=None, n_chunks=4).transfer(acc)
        open_bcast_channel(comm, root=dst, port=None, n_chunks=2).transfer(y)
    return led


#: name -> capture entry (keyword ``device``); the CLI's sweep
PROGRAMS = {
    "launch.train": capture_train,
    "launch.serve": capture_serve,
    "launch.stencil": capture_stencil,
    "bench.collectives": capture_bench_collectives,
    "examples.quickstart": capture_quickstart,
}


def run_programs(names=None, device=None) -> tuple[list, bool]:
    """Capture + verify each named program on ``device``.  ``(rows,
    all_ok)``: a row carries the op counts, the real-step counter (must be
    0) and the diagnostics (must be empty)."""
    rows = []
    ok = True
    for name in names or sorted(PROGRAMS):
        led = PROGRAMS[name](device=device)
        diags = verify_ledger(led, name=name)
        clean = not diags and led.real_steps == 0
        ok = ok and clean
        rows.append({
            "program": name,
            "ops": led.counts(),
            "size": led.size,
            "real_steps": led.real_steps,
            "transport_steps": led.transport_steps,
            "ok": clean,
            "diagnostics": [d.to_dict() for d in diags],
        })
    return rows, ok
