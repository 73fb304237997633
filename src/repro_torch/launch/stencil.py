"""Launch the distributed halo-exchange stencil (paper §5.4.2).

Runs ``repro_torch.apps.DistributedStencil`` over a rank grid stacked on
one device, streams halos through the selected transport backend, checks
the result against the single-rank sweep bit for bit, and prints the wall
time per step (a second, timed run after the first) and the ``halo`` tag's
steps and bytes per rank over one run.

    python -m repro_torch.launch.stencil --grid 2x4 --domain 8192x8192 --steps 32
    python -m repro_torch.launch.stencil --case ring8 --comm-mode smi:fused \\
        --device cpu --json out.json
    python -m repro_torch.launch.stencil --grid 2x4 --plan auto
    python -m repro_torch.launch.stencil --trace trace.json --metrics metrics.json

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--case", default=None, choices=sorted(STENCIL_CASES),
                    help="predefined (grid, domain, steps) cell")
    ap.add_argument("--grid", default="2x4", help="rank grid RXxRY")
    ap.add_argument("--domain", default="256x256", help="global domain XxY")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--comm-mode", default="smi", choices=COMM_MODES,
                    help="smi:<backend> selects the transport; 'smi' = static")
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
    args = ap.parse_args(argv)

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
    # one instance for every step, resolved from the tiles (a tuned plan is
    # keyed on their slab size), so its counters hold the run's halo traffic
    tp = app.halo_schedule.resolve_transport(tiles)

    # the first run gives the result and warms up (allocator, module loads);
    # the second is timed, its counters alone on the transport
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

    want = app.single_rank_reference(world, steps)
    ok = bool(torch.equal(app.gather(got), want)) and bool(torch.equal(timed, got)) \
        and tp.stats.tag_counts(HALO_TAG) == (halo_steps, halo_bytes)
    err = float((app.gather(got) - want).abs().max())
    nx, ny = domain[0] // grid[0], domain[1] // grid[1]
    model_s = app.predicted_step_time((nx, ny)) * steps

    from ..obs.metrics import REGISTRY

    REGISTRY.track("halo", tp)
    REGISTRY.drift("stencil/wall_vs_model", predicted=model_s, measured=wall)

    sched = "overlapped" if overlapped else "reference"
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[stencil] grid={grid} domain={domain} steps={steps} "
          f"comm_mode={mode_label} halo_backend={tp.name} schedule={sched} device={kind}")
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
                "comm_mode": mode_label, "halo_backend": tp.name, "schedule": sched,
                "device": kind,
                "wall_s": wall, "wall_per_step_s": wall / max(steps, 1),
                "halo_steps": halo_steps, "halo_bytes_per_rank": halo_bytes,
                "model_halo_s": model_s, "max_err": err, "ok": ok,
                "metrics": REGISTRY.snapshot(),
            }, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
