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

``--plan auto`` lets the netsim tuning table pick the halo backend (the
card's link model; never a lossy wire) and cannot be combined with a
pinned ``--comm-mode``; the run is labelled ``smi(auto)``.

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
    # the second is timed
    got = app.run(tiles, steps, overlapped=overlapped, transport=tp)
    halo_steps, halo_bytes = tp.stats.tag_counts(HALO_TAG)
    _sync(dev)
    t0 = time.perf_counter()
    app.run(tiles, steps, overlapped=overlapped, transport=tp)
    _sync(dev)
    wall = time.perf_counter() - t0

    want = app.single_rank_reference(world, steps)
    ok = bool(torch.equal(app.gather(got), want))
    err = float((app.gather(got) - want).abs().max())

    sched = "overlapped" if overlapped else "reference"
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[stencil] grid={grid} domain={domain} steps={steps} "
          f"comm_mode={mode_label} halo_backend={tp.name} schedule={sched} device={kind}")
    print(f"[stencil] wall_per_step={wall / max(steps, 1) * 1e3:.4f}ms "
          f"halo_steps={halo_steps} halo_bytes_per_rank={halo_bytes} "
          f"max|err|={err:.3g} {'OK' if ok else 'MISMATCH'}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({
                "grid": grid, "domain": domain, "steps": steps,
                "comm_mode": mode_label, "halo_backend": tp.name, "schedule": sched,
                "device": kind,
                "wall_s": wall, "wall_per_step_s": wall / max(steps, 1),
                "halo_steps": halo_steps, "halo_bytes_per_rank": halo_bytes,
                "max_err": err, "ok": ok,
            }, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
