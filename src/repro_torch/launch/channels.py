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

    python -m repro_torch.launch.channels --device cpu --sizes-kib 16,256
    python -m repro_torch.launch.channels --measure latency

The device is ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..channels import open_channel
from ..core.comm import Communicator, ppermute, resolve_device
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


def bus_comm(device) -> Communicator:
    return Communicator.create("x", (8,), topology=Topology.bus(8), device=device)


def staged_p2p(x: torch.Tensor, *, src: int, dst: int, comm: Communicator) -> torch.Tensor:
    """The unpipelined baseline: the whole message moves one hop a step
    (the reference's ``benchmarks/bandwidth.py staged_p2p``)."""
    path = comm.route_table.path(src, dst)
    buf = _mask_sel(comm.rank() == src, x, torch.zeros_like(x))
    for a, b in zip(path[:-1], path[1:]):
        buf = ppermute(buf, [(a, b)])
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


def _transport(wire: str, device, **kw):
    if wire.partition(":")[0] == "packet":
        return get_transport(wire, device=device, **kw)
    return get_transport(wire, device=device)


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


def push_pop(comm: Communicator, dst: int, wire, count: int):
    """``count`` one-element pushes at rank 0 and ``count + hops - 1`` pops:
    returns the channel and the destination's ``(valid, value)`` of every
    pop, stacked (read after the loop: no host sync inside it)."""
    hops = comm.route_table.n_hops(0, dst)
    ch = open_channel(comm, count=count, src=0, dst=dst, port=None, transport=wire)
    oks, vals = [], []
    for i in range(count + hops - 1):
        if i < count:
            ch = ch.push(float(i + 1))
        ch, val, ok = ch.pop()
        oks.append(ok[dst])
        vals.append(val[dst])
    return ch, torch.stack(oks), torch.stack(vals)


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


def latency(device, wires=LAT_WIRES, count: int = 64, reps: int = 20) -> list[dict]:
    """Tab. 3's rows: per hops and wire, µs per ``transfer`` of
    ``LAT_ELEMS`` float32 and µs per pop of a ``count``-element push/pop
    loop."""
    dev = resolve_device(device)
    comm = bus_comm(dev)
    x = torch.arange(8 * LAT_ELEMS, dtype=torch.float32, device=dev).reshape(8, LAT_ELEMS) + 1
    rows = []
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


def bandwidth(device, sizes_kib=BW_SIZES_KIB, wires=BW_WIRES, reps: int = 5) -> list[dict]:
    """Fig. 9's rows: per size, hops and wire (and the staged baseline), ms
    per transfer and GB/s of payload per rank."""
    dev = resolve_device(device)
    comm = bus_comm(dev)
    g = torch.Generator(device=dev).manual_seed(9)
    rows = []
    for kib in sizes_kib:
        elems = kib * 256
        x = torch.randn((8, elems), generator=g, device=dev)
        for dst, hops in HOPS:
            runs = [w for w in wires if w != "packet" or kib <= PACKET_MAX_KIB] + ["staged"]
            for wire in runs:
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


def _line(row: dict) -> str:
    if row["measure"] == "latency":
        return (f"latency hops={row['hops']} wire={row['wire']}: "
                f"{row['us_per_transfer']:.2f} us/transfer ({row['elems']} float32), "
                f"{row['us_per_pop']:.2f} us/pop ({row['count']} elements, {row['pops']} pops)")
    return (f"bandwidth {row['kib']} KiB hops={row['hops']} wire={row['wire']}: "
            f"{row['ms']:.4f} ms, {row['gb_per_s']:.2f} GB/s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--measure", default="latency,bandwidth",
                    help="comma-separated: latency, bandwidth")
    ap.add_argument("--sizes-kib", default=",".join(map(str, BW_SIZES_KIB)),
                    help="bandwidth message sizes per rank, KiB")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    measures = args.measure.split(",")
    try:
        if "latency" in measures:
            for row in latency(args.device):
                print(_line(row), flush=True)
        if "bandwidth" in measures:
            sizes = tuple(int(s) for s in args.sizes_kib.split(","))
            for row in bandwidth(args.device, sizes):
                print(_line(row), flush=True)
    except AssertionError as e:
        print(f"FAILED: {e}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
