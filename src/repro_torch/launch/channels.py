"""Launch the paper's channel measurements on the rank-stacked runtime.

* **Latency** (paper Tab. 3, after the reference's ``benchmarks/latency.py``):
  on an 8-rank bus, a message of 8 float32 from rank 0 to ranks 1, 4 and 7
  (1, 4 and 7 hops) by ``open_channel(...).transfer`` at ``n_chunks=1``, and
  a push/pop loop of 64 one-element pushes and ``count + hops - 1``
  pops, which must deliver its first element on exactly the ``hops``-th pop
  and ``count`` elements in all.  Microseconds per transfer and per pop.
* **Bandwidth** (paper Fig. 9, after ``benchmarks/bandwidth.py``): the same
  bus, messages of ``--sizes-kib`` per rank, 1, 4 and 7 hops, ``n_chunks=16``,
  over each wire, beside the unpipelined ``staged_p2p`` (the whole message
  a hop).  GB/s of payload per rank.

Every delivered message is checked: bit for bit on the exact wires, within
the int8 codec's bound on the compressed one.  One line a row; the exit
code is 1 if a check fails.

``--ranks process`` runs both programs with the 8 ranks as ``--procs``
processes (one a rank unless named; ``--devices``: the cards they are placed
on in turn), each on its own CUDA context, the steps moving through the
mailboxes of :mod:`repro_torch.core.spmd` (over the packet wire, a router
tick's link rows after every tick); the rows come back to this process for
the checks, and a row's time is taken between barrier-aligned stamps around
its calls.  ``--validate-sim`` runs stacked only.

``--validate-sim`` (the reference's ``benchmarks/{latency,bandwidth}.py
--validate-sim``) records the static wire's latency and bandwidth
transfers as netsim calibration points (``TransportStats.record`` of one
transfer, seconds the median of 9 readings taken in turns), fits a
:class:`~repro_torch.netsim.LinkModel` to each set and gates its drift at
2x, then prints the fit of both sets together.

    python -m repro_torch.launch.channels --device cpu --sizes-kib 16,256
    python -m repro_torch.launch.channels --measure latency
    python -m repro_torch.launch.channels --validate-sim
    python -m repro_torch.launch.channels --ranks process --procs 8

The device is ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time
from contextlib import ExitStack
from types import SimpleNamespace

import torch

from ..channels import open_channel
from ..core.comm import Communicator, ppermute, resolve_device
from ..core.spmd import block_clock
from ..core.streaming import _mask_sel
from ..core.topology import Topology
from ..transport import get_transport

#: (destination, hops) from rank 0 on the 8-rank bus
HOPS = ((1, 1), (4, 4), (7, 7))
#: the latency message: one small packet's worth of float32
LAT_ELEMS = 8
LAT_WIRES = ("static", "fused", "packet")
#: the reference's bandwidth sizes per rank (KiB)
BW_SIZES_KIB = (16, 256, 4096)
BW_WIRES = ("static", "fused", "packet", "compressed:static")
BW_CHUNKS = 16
#: the packet wire's payload a packet in the bandwidth runs (the reference's)
PACKET_BENCH_ELEMS = 4096
#: the largest message (KiB per rank) the packet wire is run at
PACKET_MAX_KIB = 4096
#: slot bytes of the rank processes beyond the largest message a rank
SLOT_MARGIN = 64 << 10


def bus_comm(device) -> Communicator:
    return Communicator.create("x", (8,), topology=Topology.bus(8), device=device)


def bus_comm_args() -> dict:
    """:func:`bus_comm`'s communicator as a rank group's ``comm_args``."""
    return {"axis_names": ("x",), "axis_sizes": (8,), "topology": Topology.bus(8)}


def staged_p2p(x: torch.Tensor, *, src: int, dst: int, comm: Communicator) -> torch.Tensor:
    """The unpipelined baseline: the whole message moves one hop a step
    (the reference's ``benchmarks/bandwidth.py staged_p2p``)."""
    path = comm.route_table.path(src, dst)
    buf = _mask_sel(comm.rank() == src, x, torch.zeros_like(x))
    for a, b in zip(path[:-1], path[1:]):
        buf = ppermute(buf, [(a, b)], comm)
    return buf


def time_ms(fn, device: torch.device, reps: int = 5, warmup: int = 2) -> float:
    """Mean wall milliseconds a call: CUDA events around ``reps`` calls on
    the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def _bw_wires(wires, kib: int) -> list:
    """The wires a bandwidth row runs at ``kib`` KiB a rank: the packet
    wire only up to :data:`PACKET_MAX_KIB`."""
    return [w for w in wires if w != "packet" or kib <= PACKET_MAX_KIB]


def _transport(wire: str, device, **kw):
    if wire.partition(":")[0] == "packet":
        return get_transport(wire, device=device, **kw)
    return get_transport(wire, device=device)


def _clocked(fn, comm: Communicator, reps: int, warmup: int = 2) -> tuple[float, float]:
    """Barrier-aligned stamps of the host's clock around ``reps`` calls of
    ``fn`` (after ``warmup``) in a rank process: the parent takes the span
    from the first opening stamp to the last closing one."""
    for _ in range(warmup):
        fn()
    t0 = block_clock(comm)
    for _ in range(reps):
        fn()
    return t0, block_clock(comm)


def _span_ms(stamps, reps: int) -> float:
    """Milliseconds a call from every process's :func:`_clocked` stamps."""
    return (max(b for _, b in stamps) - min(a for a, _ in stamps)) * 1e3 / reps


def _check_delivery(y, x, src: int, dst: int, lossy: bool, what: str):
    others = torch.cat((y[:dst], y[dst + 1:]))
    if others.count_nonzero():
        raise AssertionError(f"{what}: a rank other than {dst} received data")
    if lossy:
        bound = float(x[src].abs().max()) / 254 * 1.05 + 1e-6
        err = float((y[dst].double() - x[src].double()).abs().max())
        if err > bound:
            raise AssertionError(f"{what}: int8 wire off by {err} > {bound}")
    elif not torch.equal(y[dst].view(torch.int32), x[src].view(torch.int32)):
        raise AssertionError(f"{what}: delivered message differs from the source's")


def _push_pop_rows(comm: Communicator, dst: int, wire, count: int):
    """:func:`push_pop` keeping every rank this process holds: the channel
    and each pop's ``(valid, value)`` as ``(n_local, pops)`` rows."""
    hops = comm.route_table.n_hops(0, dst)
    ch = open_channel(comm, count=count, src=0, dst=dst, port=None, transport=wire)
    oks, vals = [], []
    for i in range(count + hops - 1):
        if i < count:
            ch = ch.push(float(i + 1))
        ch, val, ok = ch.pop()
        oks.append(ok)
        vals.append(val)
    return ch, torch.stack(oks, 1), torch.stack(vals, 1)


def push_pop(comm: Communicator, dst: int, wire, count: int):
    """``count`` one-element pushes at rank 0 and ``count + hops - 1`` pops:
    returns the channel and the destination's ``(valid, value)`` of every
    pop, stacked (read after the loop: no host sync inside it)."""
    ch, oks, vals = _push_pop_rows(comm, dst, wire, count)
    return ch, oks[dst], vals[dst]


def _check_push_pop(ch, oks, vals, dst: int, hops: int, count: int, what: str):
    oks, vals = oks.cpu(), vals.cpu()
    first = int(oks.int().argmax())
    if not oks.any() or first != hops - 1 or int(oks.sum()) != count:
        raise AssertionError(f"{what}: first element on pop {first + 1} (not {hops}), "
                             f"{int(oks.sum())} of {count} delivered")
    want = torch.arange(1, count + 1, dtype=vals.dtype)
    if not torch.equal(vals[oks], want) or int(ch.popped[dst]) != count:
        raise AssertionError(f"{what}: values or popped count wrong "
                             f"(popped {int(ch.popped[dst])})")


def _latency_rank(comm: Communicator, x, wires, count: int, reps: int) -> list[dict]:
    """One rank process's part of :func:`latency`: per hops and wire, its
    rows of a transfer and of a push/pop loop, and the stamps around the
    timed calls of each."""
    out = []
    for dst, _ in HOPS:
        for wire in wires:
            t = _transport(wire, comm.device)
            ch = open_channel(comm, src=0, dst=dst, port=None, n_chunks=1, transport=t)
            y = ch.transfer(x)
            transfer = _clocked(lambda: ch.transfer(x), comm, reps)
            pc, oks, vals = _push_pop_rows(comm, dst, t, count)  # warms the loop up
            loop = _clocked(lambda: _push_pop_rows(comm, dst, t, count), comm, 1, warmup=0)
            out.append({"y": y, "oks": oks, "vals": vals, "popped": pc.popped,
                        "transfer": transfer, "loop": loop})
    return out


def latency(device, wires=LAT_WIRES, count: int = 64, reps: int = 20,
            group=None) -> list[dict]:
    """Tab. 3's rows: per hops and wire, µs per ``transfer`` of
    ``LAT_ELEMS`` float32 and µs per pop of a ``count``-element push/pop
    loop.  With ``group`` (an :class:`~repro_torch.core.spmd.SpmdGroup` of
    8 ranks) the ranks run as its processes."""
    dev = resolve_device(device)
    comm = bus_comm(dev)
    x = torch.arange(8 * LAT_ELEMS, dtype=torch.float32, device=dev).reshape(8, LAT_ELEMS) + 1
    rows = []
    if group is not None:
        res = iter(group.run(_latency_rank, bus_comm_args(), x, wires, count, reps))
        for dst, hops in HOPS:
            for wire in wires:
                r = next(res)
                what = f"latency {wire} hops={hops} ranks as processes"
                _check_delivery(r["y"].to(dev), x, 0, dst, False, what)
                _check_push_pop(SimpleNamespace(popped=r["popped"]), r["oks"][dst],
                                r["vals"][dst], dst, hops, count, f"push/pop {what}")
                rows.append(dict(measure="latency", hops=hops, wire=wire, elems=LAT_ELEMS,
                                 us_per_transfer=_span_ms(r["transfer"], reps) * 1e3,
                                 count=count, pops=count + hops - 1, ranks="process",
                                 us_per_pop=_span_ms(r["loop"], 1) * 1e3 / (count + hops - 1)))
        return rows
    for dst, hops in HOPS:
        if comm.route_table.n_hops(0, dst) != hops:
            raise AssertionError(f"bus route 0 -> {dst} is not {hops} hops")
        for wire in wires:
            t = _transport(wire, dev)
            ch = open_channel(comm, src=0, dst=dst, port=None, n_chunks=1, transport=t)
            _check_delivery(ch.transfer(x), x, 0, dst, False, f"latency {wire} hops={hops}")
            ms_transfer = time_ms(lambda: ch.transfer(x), dev, reps=reps)
            what = f"push/pop {wire} hops={hops}"
            _check_push_pop(*push_pop(comm, dst, t, count), dst, hops, count, what)
            ms_loop = time_ms(lambda: push_pop(comm, dst, t, count), dev, reps=3, warmup=1)
            rows.append(dict(measure="latency", hops=hops, wire=wire, elems=LAT_ELEMS,
                             us_per_transfer=ms_transfer * 1e3, count=count,
                             pops=count + hops - 1,
                             us_per_pop=ms_loop * 1e3 / (count + hops - 1)))
    return rows


def _bandwidth_rank(comm: Communicator, x, wires, reps: int) -> list[dict]:
    """One rank process's part of :func:`bandwidth` at one size: per hops
    and wire (then the staged baseline), its rows of a transfer and the
    stamps around the timed ones."""
    out = []
    for dst, _ in HOPS:
        for wire in (*wires, "staged"):
            if wire == "staged":
                def fn():
                    return staged_p2p(x, src=0, dst=dst, comm=comm)
            else:
                t = _transport(wire, comm.device, pkt_elems=PACKET_BENCH_ELEMS)
                ch = open_channel(comm, src=0, dst=dst, port=None, n_chunks=BW_CHUNKS,
                                  transport=t)

                def fn(ch=ch):
                    return ch.transfer(x)
            out.append({"y": fn(), "stamps": _clocked(fn, comm, reps)})
    return out


def bandwidth(device, sizes_kib=BW_SIZES_KIB, wires=BW_WIRES, reps: int = 5,
              group=None) -> list[dict]:
    """Fig. 9's rows: per size, hops and wire (and the staged baseline), ms
    per transfer and GB/s of payload per rank.  With ``group`` (an
    :class:`~repro_torch.core.spmd.SpmdGroup` of 8 ranks whose slots hold a
    whole message) the ranks run as its processes."""
    dev = resolve_device(device)
    comm = bus_comm(dev)
    g = torch.Generator(device=dev).manual_seed(9)
    rows = []
    for kib in sizes_kib:
        elems = kib * 256
        x = torch.randn((8, elems), generator=g, device=dev)
        if group is not None:
            runs = _bw_wires(wires, kib)
            res = iter(group.run(_bandwidth_rank, bus_comm_args(), x, runs, reps))
            for dst, hops in HOPS:
                for wire in (*runs, "staged"):
                    r = next(res)
                    what = f"bandwidth {wire} {kib} KiB hops={hops} ranks as processes"
                    _check_delivery(r["y"].to(dev), x, 0, dst, wire.startswith("compressed"),
                                    what)
                    ms = _span_ms(r["stamps"], reps)
                    rows.append(dict(measure="bandwidth", kib=kib, hops=hops, wire=wire,
                                     n_chunks=BW_CHUNKS, ms=ms, ranks="process",
                                     gb_per_s=elems * 4 / (ms * 1e-3) / 1e9))
            continue
        for dst, hops in HOPS:
            for wire in (*_bw_wires(wires, kib), "staged"):
                what = f"bandwidth {wire} {kib} KiB hops={hops}"
                if wire == "staged":
                    def fn():
                        return staged_p2p(x, src=0, dst=dst, comm=comm)
                else:
                    t = _transport(wire, dev, pkt_elems=PACKET_BENCH_ELEMS)
                    ch = open_channel(comm, src=0, dst=dst, port=None, n_chunks=BW_CHUNKS,
                                      transport=t)

                    def fn(ch=ch):
                        return ch.transfer(x)
                _check_delivery(fn(), x, 0, dst, wire.startswith("compressed"), what)
                ms = time_ms(fn, dev, reps=reps)
                rows.append(dict(measure="bandwidth", kib=kib, hops=hops, wire=wire,
                                 n_chunks=BW_CHUNKS, ms=ms,
                                 gb_per_s=elems * 4 / (ms * 1e-3) / 1e9))
        del x
    return rows


def _interleaved_median_s(fns, device: torch.device, reps: int, warmup: int = 2) -> list:
    """Median seconds of ``reps`` single calls of each of ``fns``, taken in
    rounds (every function once a round, in turn) so that a drift of the
    host's pace between the first reading and the last falls on every
    function alike.  A reading is the CUDA events around one call on an
    idle card (a synchronize before each: a call queued behind another's
    device work would read short), or the host clock on the CPU."""
    for fn in fns:
        for _ in range(warmup):
            fn()
    times = [[] for _ in fns]
    for _ in range(reps):
        for ts, fn in zip(times, fns):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                torch.cuda.synchronize(device)
                ts.append(start.elapsed_time(end) * 1e-3)
            else:
                t0 = time.perf_counter()
                fn()
                ts.append(time.perf_counter() - t0)
    return [sorted(ts)[len(ts) // 2] for ts in times]


def calibration_records(device, sizes_kib=BW_SIZES_KIB, reps: int = 9):
    """netsim calibration points of the static wire on the 8-rank bus:
    ``(latency, bandwidth)`` lists of ``TransportStats.record`` dicts, one
    per transfer shape — Tab. 3's (8 float32 at 1, 4 and 7 hops,
    ``n_chunks=1``) and Fig. 9's (``sizes_kib`` per rank at 1, 4 and 7 hops,
    ``n_chunks=16``).  Each record holds the steps and bytes of ONE transfer
    and the median seconds of ``reps`` (at least 9) timed transfers, the
    shapes of a set timed in turns."""
    if reps < 9:
        raise ValueError(f"reps={reps}: the calibration takes the median of at least 9")
    dev = resolve_device(device)
    comm = bus_comm(dev)
    g = torch.Generator(device=dev).manual_seed(9)
    shapes = [("latency", LAT_ELEMS, 1)] + [("bandwidth", kib * 256, BW_CHUNKS)
                                             for kib in sizes_kib]
    runs = []  # (measure, name, transport, call)
    for measure, elems, n_chunks in shapes:
        x = torch.randn((8, elems), generator=g, device=dev)
        for dst, hops in HOPS:
            t = get_transport("static", device=dev)
            ch = open_channel(comm, src=0, dst=dst, port=None, n_chunks=n_chunks, transport=t)
            _check_delivery(ch.transfer(x), x, 0, dst, False,
                            f"calibration {elems} float32 hops={hops}")
            runs.append((measure, f"{measure} {elems * 4}B hops={hops} n_chunks={n_chunks}", t,
                         lambda ch=ch, x=x: ch.transfer(x)))
    out = {"latency": [], "bandwidth": []}
    for measure, recs in out.items():  # each set in turns of its own shapes
        mine = [r for r in runs if r[0] == measure]
        secs = _interleaved_median_s([fn for *_, fn in mine], dev, reps)
        for (_, name, t, fn), sec in zip(mine, secs):
            t.reset_stats()
            fn()
            recs.append(t.stats.record(sec, name))
    return out["latency"], out["bandwidth"]


def validate_sim(device, sizes_kib=BW_SIZES_KIB, reps: int = 9, tol: float = 2.0):
    """Fit and gate each record set at ``tol`` (an AssertionError on a
    miss), then fit both together.  Returns ``(fit of both, latency
    records, bandwidth records)``."""
    from ..netsim import calibrate

    lat, bw = calibration_records(device, sizes_kib, reps)
    calibrate.validate(lat, tol=tol, label="latency_tab3")
    calibrate.validate(bw, tol=tol, label="bandwidth_fig9")
    return calibrate.fit(lat + bw), lat, bw


def _line(row: dict) -> str:
    ranks = " (ranks as processes)" if row.get("ranks") == "process" else ""
    if row["measure"] == "latency":
        return (f"latency hops={row['hops']} wire={row['wire']}: "
                f"{row['us_per_transfer']:.2f} us/transfer ({row['elems']} float32), "
                f"{row['us_per_pop']:.2f} us/pop ({row['count']} elements, {row['pops']} "
                f"pops){ranks}")
    return (f"bandwidth {row['kib']} KiB hops={row['hops']} wire={row['wire']}: "
            f"{row['ms']:.4f} ms, {row['gb_per_s']:.2f} GB/s{ranks}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--measure", default="latency,bandwidth",
                    help="comma-separated: latency, bandwidth")
    ap.add_argument("--sizes-kib", default=",".join(map(str, BW_SIZES_KIB)),
                    help="bandwidth message sizes per rank, KiB")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--validate-sim", action="store_true",
                    help="fit a LinkModel to the static wire's transfers and gate its drift")
    ap.add_argument("--ranks", default="stacked", choices=("stacked", "process"),
                    help="every rank in this process (stacked) or ranks as processes")
    ap.add_argument("--procs", type=int, default=None,
                    help="rank processes of --ranks process (default: 8, one a rank)")
    ap.add_argument("--devices", default=None, metavar="I,J,...",
                    help="card indices the rank processes are placed on in turn "
                         "(--ranks process; default: --device)")
    args = ap.parse_args(argv)
    measures = args.measure.split(",")
    sizes = tuple(int(s) for s in args.sizes_kib.split(","))
    process = args.ranks == "process"
    if not process and (args.procs is not None or args.devices is not None):
        ap.error("--procs and --devices place rank processes: they need --ranks process")
    if process and args.validate_sim:
        ap.error("--validate-sim runs stacked only")
    with ExitStack() as stack:
        group = None
        if process:
            from ..core.router import link_row_bytes
            from ..core.spmd import SpmdGroup

            devices = ([f"cuda:{int(i)}" for i in args.devices.split(",")] if args.devices
                       else [args.device])
            # a slot holds the largest message, or a router tick's link rows
            biggest = max(max(sizes) * 1024 if "bandwidth" in measures else LAT_ELEMS * 4,
                          link_row_bytes((8,), PACKET_BENCH_ELEMS))
            group = stack.enter_context(SpmdGroup(args.procs or 8, 8, devices=devices,
                                                  slot_bytes=biggest + SLOT_MARGIN))
        try:
            if args.validate_sim:
                model, _, _ = validate_sim(args.device, sizes)
                print(f"fitted {model!r}", flush=True)
                return 0
            if "latency" in measures:
                for row in latency(args.device, group=group):
                    print(_line(row), flush=True)
            if "bandwidth" in measures:
                for row in bandwidth(args.device, sizes, group=group):
                    print(_line(row), flush=True)
        except AssertionError as e:
            print(f"FAILED: {e}", flush=True)
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
