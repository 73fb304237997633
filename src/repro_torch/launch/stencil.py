"""Launch the distributed halo-exchange stencil (paper §5.4.2).

Runs ``repro_torch.apps.DistributedStencil`` over a rank grid, streams halos
through the selected transport backend, checks the result against the
single-rank sweep bit for bit (within ``LOSSY_MAX_ERR`` over the int8 wire,
``--comm-mode smi:compressed``), and prints the wall time per step (a second,
timed run after the first) and the ``halo`` tag's steps and bytes per rank
over one run.

    python -m repro_torch.launch.stencil --grid 2x4 --domain 8192x8192 --steps 32
    python -m repro_torch.launch.stencil --case ring8 --comm-mode smi:fused \\
        --device cpu --json out.json
    python -m repro_torch.launch.stencil --grid 2x4 --plan auto
    python -m repro_torch.launch.stencil --trace trace.json --metrics metrics.json
    python -m repro_torch.launch.stencil --ranks process --procs 8
    python -m repro_torch.launch.stencil --ranks process --procs 2 --device cpu
    python -m repro_torch.launch.stencil --ranks process --procs 2 --device cpu \
        --comm-mode smi:packet --domain 64x64 --steps 3

``--ranks stacked`` (the default) holds every rank in this process, stacked
on one device.  ``--ranks process`` runs the ranks as ``--procs`` processes
(one a rank unless named), each holding a block of them on its own CUDA
context (``--devices``: the cards the processes are placed on in turn,
default ``--device``), the halos moving through mailboxes the processes map
from each other (:mod:`repro_torch.core.spmd`); the tiles come back to this
process for the check, the ``halo`` counters are one rank's, as stacked,
and the wall time is taken between barrier-aligned stamps around the timed
run.  Over the packet wire each process routes the ranks it holds, one
tick of kernel C's block-tick form a launch, the link rows crossing the
mailboxes after every tick.  ``--trace`` and ``--metrics`` run stacked
only.

``--plan auto`` lets the netsim tuning table pick the halo backend (the
card's link model; never a lossy wire) and cannot be combined with a
pinned ``--comm-mode``; the run is labelled ``smi(auto)``.

``--trace`` turns the tracer on around the timed run and writes a
Chrome-trace / Perfetto file: one lane per rank with each step's own
duration (CUDA events on the card, ``perf_counter`` on the CPU), the
channel/halo/router events the run emitted on the host lane, and one lane
per directed link with the netsim-predicted halo flit timeline.
``--metrics`` writes the obs metrics snapshot: the halo transport's
counters per tag over the timed run and the ``stencil/wall_vs_model``
drift gauge against the card's link model.

The device is ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..configs import COMM_MODES, STENCIL_CASES

#: slot bytes of the rank processes beyond one halo slab (see core/spmd.py)
SLOT_MARGIN = 4096
#: the gate of a run whose halos ride the int8 wire: the largest error
#: against the single-rank sweep stays under this (the reference's bound)
LOSSY_MAX_ERR = 1e-1


def _pair(s: str) -> tuple[int, int]:
    a, _, b = s.partition("x")
    return int(a), int(b)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _traced_run(app, tiles, steps: int, overlapped: bool, tp, dev):
    """The timed run one step at a time, each step's (start, seconds) on
    the card's clock (CUDA events; ``perf_counter`` on the CPU), starts
    relative to the first step's.  The same steps as ``app.run``: one
    transport instance, the same schedule."""
    cuda = dev.type == "cuda"
    marks = []
    x = tiles
    for _ in range(steps):
        if cuda:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
        else:
            a = time.perf_counter()
        x = app.run(x, 1, overlapped=overlapped, transport=tp)
        if cuda:
            b.record()
        else:
            b = time.perf_counter()
        marks.append((a, b))
    _sync(dev)
    first = marks[0][0]
    if cuda:
        step_s = [(first.elapsed_time(a) / 1e3, a.elapsed_time(b) / 1e3) for a, b in marks]
    else:
        step_s = [(a - first, b - a) for a, b in marks]
    return x, step_s


def _write_trace(path, app, grid, tile, steps: int, step_s, mode_label: str, t_wall0: float):
    """The Chrome trace of the timed run: the tracer's events, one
    ``run.step`` slice a step on every rank's lane (the ranks run each
    step together on the one card), and the netsim overlay of the halo
    rounds, one lane a directed link."""
    from ..netsim.schedule import halo_rounds, halo_slab_elems
    from ..netsim.sim import simulate
    from ..obs import trace as obs_trace
    from ..obs.export import sim_report_events, write_chrome_trace

    tracer = obs_trace.disable()
    events = list(tracer.events())
    base = t_wall0 - tracer.t0  # the timed run's start on the tracer's clock
    for r in range(app.comm.size):
        for s, (start, dur) in enumerate(step_s):
            events.append({"ts": base + start, "rank": r, "kind": "run.step", "tag": mode_label,
                           "port": None, "attrs": {"dur": dur, "step": s}})
    ns_e, ew_e = halo_slab_elems(tuple(tile))
    reports = [simulate(app.comm.topology, app.comm.route_table, msgs, trace=True)
               for msgs in halo_rounds(grid, ns_e * 4, ew_e * 4)]
    return write_chrome_trace(path, events + sim_report_events(app.comm.topology, reports))


def _rank_run(comm, tiles, grid, steps: int, overlapped: bool, comm_mode, plan) -> dict:
    """One rank process's part of a process-mode launch: the first run (the
    result and the warm-up) and the timed run between barrier-aligned
    stamps, each over one transport instance; this process's ``halo``
    counters of each run and its launches of kernel B and of kernel C's
    block-tick form (the packet wire)."""
    from ..apps import HALO_TAG, DistributedStencil
    from ..core.spmd import block_clock
    from ..kernels.router import router_tick_block
    from ..kernels.stencil import stencil_sweep

    b0, c0 = stencil_sweep.launches, router_tick_block.launches
    app = DistributedStencil.create(grid, comm=comm, comm_mode=comm_mode, plan=plan)
    tp = app.halo_schedule.resolve_transport(tiles)
    got = app.run(tiles, steps, overlapped=overlapped, transport=tp)
    halo = tp.stats.tag_counts(HALO_TAG)
    tp.reset_stats()
    t0 = block_clock(comm)
    timed = app.run(tiles, steps, overlapped=overlapped, transport=tp)
    t1 = block_clock(comm)
    return {"got": got, "timed": timed, "halo": halo,
            "halo_timed": tp.stats.tag_counts(HALO_TAG), "t0": t0, "t1": t1,
            "backend": tp.name, "launches_b": stencil_sweep.launches - b0,
            "launches_c": router_tick_block.launches - c0}


def run_process(group, app, tiles, steps: int, overlapped: bool, comm_mode, plan) -> dict:
    """The stencil on ``group``'s rank processes (``app``'s communicator
    and grid, the rank-stacked ``tiles``): every process's tiles stacked
    back in rank order, on ``tiles``' device; the ``halo`` counters, equal
    in every process (else a ``ValueError``); the wall seconds from the
    first opening stamp to the last closing one; kernel B's and kernel C's
    block-tick launches of each process."""
    c = app.comm
    res = group.run(_rank_run, {"axis_names": c.axis_names, "axis_sizes": c.axis_sizes,
                                "topology": c.topology},
                    tiles, app.grid, steps, overlapped, comm_mode, plan)
    if len(set(res["halo"])) != 1 or len(set(res["halo_timed"])) != 1:
        raise ValueError(f"the rank processes counted unequal halo traffic: {res['halo']}, "
                         f"{res['halo_timed']}")
    return {"got": res["got"].to(tiles.device), "timed": res["timed"].to(tiles.device),
            "halo": res["halo"][0], "halo_timed": res["halo_timed"][0],
            "wall": max(res["t1"]) - min(res["t0"]), "backend": res["backend"][0],
            "launches_b": res["launches_b"], "launches_c": res["launches_c"],
            "peaks": group.peaks}


def main(argv=None, *, group=None) -> int:
    """The launcher; ``group`` (an :class:`~repro_torch.core.spmd.SpmdGroup`
    of the grid's ranks) runs ``--ranks process`` on processes already
    spawned instead of a group of its own."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--case", default=None, choices=sorted(STENCIL_CASES),
                    help="predefined (grid, domain, steps) cell")
    ap.add_argument("--grid", default="2x4", help="rank grid RXxRY")
    ap.add_argument("--domain", default="256x256", help="global domain XxY")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--comm-mode", default="smi", choices=COMM_MODES,
                    help="smi:<backend> selects the transport; 'smi' = static; "
                         "'smi:compressed' moves the halos on the int8 wire, gated within "
                         "1e-1 of the single-rank sweep; 'bulk' maps onto no channel and "
                         "is refused")
    ap.add_argument("--plan", default=None, choices=["auto"],
                    help="'auto' lets the netsim tuning table pick the halo backend")
    ap.add_argument("--no-overlap", action="store_true",
                    help="run the non-overlapped reference schedule")
    ap.add_argument("--json", default=None, metavar="OUT",
                    help="write machine-readable results to OUT")
    ap.add_argument("--trace", default=None, metavar="OUT",
                    help="write a Chrome trace (rank lanes + per-link netsim-predicted "
                         "overlay) to OUT")
    ap.add_argument("--metrics", default=None, metavar="OUT",
                    help="write an obs metrics snapshot (transport counters + drift "
                         "gauges) to OUT")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--ranks", default="stacked", choices=("stacked", "process"),
                    help="every rank in this process (stacked) or ranks as processes")
    ap.add_argument("--procs", type=int, default=None,
                    help="rank processes of --ranks process (default: one a rank)")
    ap.add_argument("--devices", default=None, metavar="I,J,...",
                    help="card indices the rank processes are placed on in turn "
                         "(--ranks process; default: --device)")
    args = ap.parse_args(argv)
    process = args.ranks == "process"
    if not process and (args.procs is not None or args.devices is not None):
        ap.error("--procs and --devices place rank processes: they need --ranks process")
    if process and (args.trace or args.metrics):
        ap.error("--trace and --metrics run stacked only")
    if args.devices is not None and args.device != "cuda":
        ap.error("--devices names cards; it needs --device cuda")
    if args.comm_mode == "bulk":
        ap.error("the halos stream over channels, which only the smi comm modes map onto; "
                 "bulk has no channel (the reference refuses it too)")

    from ..apps import HALO_TAG, DistributedStencil

    grid, domain, steps = _pair(args.grid), _pair(args.domain), args.steps
    if args.case:
        c = STENCIL_CASES[args.case]
        grid, domain, steps = c["grid"], c["domain"], c["steps"]

    if args.plan == "auto":
        if args.comm_mode != "smi":
            ap.error("--plan auto lets the tuner pick the backend; it cannot be combined "
                     "with an explicit --comm-mode")
        comm_mode = None
    else:
        comm_mode = args.comm_mode
    mode_label = args.comm_mode if args.plan != "auto" else "smi(auto)"
    app = DistributedStencil.create(grid, comm_mode=comm_mode, plan=args.plan,
                                    device=args.device)
    dev = app.device
    world = torch.from_numpy(np.random.RandomState(0).randn(*domain).astype(np.float32)).to(dev)
    tiles = app.scatter(world)
    overlapped = not args.no_overlap
    nx, ny = domain[0] // grid[0], domain[1] // grid[1]
    procs = None
    if process:
        from ..core.router import link_row_bytes
        from ..core.spmd import SpmdGroup
        from ..transport.packet import PacketTransport

        P = grid[0] * grid[1]
        procs = args.procs or P
        devices = ([f"cuda:{int(i)}" for i in args.devices.split(",")] if args.devices
                   else [dev])
        # a slot holds a halo slab, or a router tick's link rows on the packet wire
        slot = max(max(nx, ny) * world.element_size(),
                   link_row_bytes(grid, PacketTransport.pkt_elems)) + SLOT_MARGIN
        if group is None:
            with SpmdGroup(procs, P, devices=devices, slot_bytes=slot) as own:
                res = run_process(own, app, tiles, steps, overlapped, comm_mode, args.plan)
        else:
            if (group.n_procs, group.n_ranks) != (procs, P):
                raise ValueError(f"the group holds {group.n_ranks} ranks on {group.n_procs} "
                                 f"processes, not {P} on {procs}")
            res = run_process(group, app, tiles, steps, overlapped, comm_mode, args.plan)
        got, timed, wall = res["got"], res["timed"], res["wall"]
        halo_steps, halo_bytes = res["halo"]
        halo_timed, backend = res["halo_timed"], res["backend"]
    else:
        # one instance for every step, resolved from the tiles (a tuned plan
        # is keyed on their slab size), so its counters hold the run's halo
        # traffic
        tp = app.halo_schedule.resolve_transport(tiles)

        # the first run gives the result and warms up (allocator, module
        # loads); the second is timed, its counters alone on the transport
        got = app.run(tiles, steps, overlapped=overlapped, transport=tp)
        halo_steps, halo_bytes = tp.stats.tag_counts(HALO_TAG)
        tp.reset_stats()
        if args.trace:
            from ..obs import trace as obs_trace

            obs_trace.enable(capacity=1 << 18)
        _sync(dev)
        t0 = time.perf_counter()
        if args.trace:
            timed, step_s = _traced_run(app, tiles, steps, overlapped, tp, dev)
        else:
            timed = app.run(tiles, steps, overlapped=overlapped, transport=tp)
        _sync(dev)
        wall = time.perf_counter() - t0
        halo_timed, backend = tp.stats.tag_counts(HALO_TAG), tp.name

    want = app.single_rank_reference(world, steps)
    err = float((app.gather(got) - want).abs().max())
    # lossy only where the int8 wire moves the halos (a tuned plan never
    # picks it, so --plan auto is gated exactly)
    lossy = (comm_mode or "").startswith("smi:compressed")
    ok = (err < LOSSY_MAX_ERR if lossy else bool(torch.equal(app.gather(got), want))) \
        and bool(torch.equal(timed, got)) and halo_timed == (halo_steps, halo_bytes)
    model_s = app.predicted_step_time((nx, ny), wire="int8" if lossy else "raw") * steps

    from ..obs.metrics import REGISTRY

    if not process:
        REGISTRY.track("halo", tp)
    REGISTRY.drift("stencil/wall_vs_model", predicted=model_s, measured=wall)

    sched = "overlapped" if overlapped else "reference"
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    ranks = f"process procs={procs}" if process else "stacked"
    print(f"[stencil] grid={grid} domain={domain} steps={steps} "
          f"comm_mode={mode_label} halo_backend={backend} schedule={sched} device={kind} "
          f"ranks={ranks}")
    print(f"[stencil] wall_per_step={wall / max(steps, 1) * 1e3:.4f}ms "
          f"halo_steps={halo_steps} halo_bytes_per_rank={halo_bytes} "
          f"max|err|={err:.3g} {'OK' if ok else 'MISMATCH'}")
    if args.trace:
        n_ev = _write_trace(args.trace, app, grid, (nx, ny), steps, step_s, mode_label, t0)
        print(f"[stencil] wrote {n_ev} trace events to {args.trace}")
    if args.metrics:
        with open(args.metrics, "w") as fm:
            json.dump(REGISTRY.snapshot(), fm, indent=1)
        print(f"[stencil] wrote metrics snapshot to {args.metrics}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({
                "grid": grid, "domain": domain, "steps": steps,
                "comm_mode": mode_label, "halo_backend": backend, "schedule": sched,
                "device": kind, "ranks": args.ranks, "procs": procs,
                "launches_b": res["launches_b"] if process else None,
                "launches_c": res["launches_c"] if process else None,
                "peak_bytes": res["peaks"] if process else None,
                "wall_s": wall, "wall_per_step_s": wall / max(steps, 1),
                "halo_steps": halo_steps, "halo_bytes_per_rank": halo_bytes,
                "model_halo_s": model_s, "max_err": err, "ok": ok,
                "metrics": REGISTRY.snapshot(),
            }, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
