"""Quickstart on the PyTorch port: the paper's Listing 1 on rank-stacked
channels.

Rank 0 opens a send channel and pushes N elements from inside its loop;
rank 3 pops them as they arrive (pipeline latency = network hops).  Then
the same message moves with a whole-message channel transfer, a transient
broadcast channel shares it with every rank, the autotuned ``bcast`` picks
its own schedule, and the same broadcast channel opens over the int8
compressed-link backend -- the channel's spec carries the transport, so no
call site changes.  The last two sections make a linear layer
column-parallel over a tagged channel and trace a channel into a Chrome
trace.  The eight ranks are rows of one tensor on one device (``cuda``
unless ``--device cpu``).

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu --trace trace.json
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.channels import (  # noqa: E402
    default_channel_spec,
    open_bcast_channel,
    open_channel,
)
from repro_torch.core import Communicator, Topology  # noqa: E402
from repro_torch.core.collectives import bcast  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--trace", default=None, metavar="OUT",
                    help="also write the traced channel's Chrome trace to OUT")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    # the 8-FPGA bus of the paper's latency experiment
    comm = Communicator.create("x", (8,), topology=Topology.bus(8), device=dev)
    N, SRC, DST = 12, 0, 3
    hops = comm.route_table.n_hops(SRC, DST)
    print(f"channel {SRC} -> {DST}: {hops} hops over {comm.topology.name}")

    # ---- element-level: SMI_Open_channel / SMI_Push / SMI_Pop ----------
    # Opening claims port 0 on the communicator's allocator; leaving the
    # `with` scope releases it (two live channels cannot share a port).
    with open_channel(comm, count=N, src=SRC, dst=DST, port=0, elem_shape=(),
                      dtype=torch.float32) as chan:
        acc = torch.zeros((comm.size, N), device=dev)
        want = torch.sin(torch.arange(N, dtype=torch.float32))  # "compute" (Listing 1)
        for i in range(N + hops - 1):
            if i < N:
                chan = chan.push(float(want[i]))        # SMI_Push at rank 0
            chan, val, valid = chan.pop()               # SMI_Pop at rank 3
            slot = max(i - (hops - 1), 0)
            acc[:, slot] = torch.where(valid, val, acc[:, slot])
    got = acc[DST].cpu()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    print(f"push/pop pipeline delivered {N} elements:", got[:5].tolist(), "...")

    # ---- transfer-level: whole messages over transient channels ---------
    msg = torch.arange(8 * 64, dtype=torch.float32, device=dev).reshape(8, 64)
    y = open_channel(comm, src=SRC, dst=DST, port=None, n_chunks=8).transfer(msg)
    out = open_bcast_channel(comm, root=DST, port=None, n_chunks=4).transfer(y)
    for r in range(8):
        torch.testing.assert_close(out[r], msg[SRC], rtol=0, atol=0)
    print("channel transfer + broadcast channel: all 8 ranks hold rank-0's message ✓")

    # ---- one-line autotuned collective ---------------------------------
    # bcast() consults the netsim tuning table: the link simulator picks the
    # schedule shape, chunk count and transport backend for this topology
    # and message size -- no manual n_chunks to get wrong.
    out = bcast(msg, comm, root=SRC)
    for r in range(8):
        torch.testing.assert_close(out[r], msg[SRC], rtol=0, atol=0)
    plan = comm.plan("bcast", msg[SRC].numel() * 4)
    print(f"autotuned bcast ✓ (netsim chose {plan})")

    # ---- compressed links: comm_mode="smi:compressed" -------------------
    # The launch-layer comm_mode strings map onto channel specs: the spec
    # carries the int8 compressed-link backend (blockwise scales + error
    # feedback), and the same broadcast-channel call site moves over it.
    spec = default_channel_spec(comm, "smi:compressed")
    out = open_bcast_channel(comm, root=SRC, port=None, transport=spec.transport,
                             n_chunks=4).transfer(msg)
    bound = float(msg[SRC].abs().max()) / 254 * 1.05
    for r in range(8):
        torch.testing.assert_close(out[r], msg[SRC], rtol=0, atol=bound)
    print("compressed-link broadcast ✓ (int8 wire, within codec bound)")

    # ---- parallel layers: model comm as tagged channels ----------------
    # Two lines make a linear layer column-parallel: a ParallelCtx over the
    # mesh, then the layer call.  plan="auto" lets the netsim tuning table
    # pick the transport backend + wire for this payload size; the layer's
    # "tp.col" tag makes its traffic attributable in metrics snapshots,
    # Chrome traces and the --validate-comm byte accounting.
    from repro_torch.mesh.api import make_ctx
    from repro_torch.parallel import column_parallel_linear

    ctx = make_ctx((1, 8), comm_mode="smi", device=dev)
    K, NCOL = 64, 32
    g = torch.Generator().manual_seed(0)
    xs = torch.randn(16, K, generator=g).to(dev)
    ws = torch.randn(K, NCOL, generator=torch.Generator().manual_seed(1)).to(dev)
    # rows sequence-sharded over the 8 model ranks, columns split among them
    x2d = xs.reshape(8, 16 // 8, K)
    w = ws.reshape(K, 8, NCOL // 8).permute(1, 0, 2).contiguous()
    yl = column_parallel_linear(x2d, w, ctx, plan="auto")       # (8, 16, NCOL / 8)
    yfull = yl.permute(1, 0, 2).reshape(16, NCOL)
    # the layer's products are row blocks of x @ w: bit for bit where the
    # library's kernel for a block sums as the whole product's does (the
    # CPU), else within float32 rounding (cuBLAS picks its kernel by shape)
    want = xs @ ws
    torch.testing.assert_close(yfull, want, rtol=1e-5, atol=1e-5)
    diff = float((yfull - want).abs().max())
    print('column-parallel linear over a tagged "tp.col" channel ✓ '
          f"(plan='auto', max |y - x @ w| = {diff:.3g})")

    # ---- tracing a channel ---------------------------------------------
    # The obs tracer records channel open/transfer/close events as the
    # channel runs; repro_torch.obs.export renders them as a Chrome trace
    # that loads in Perfetto.  Off by default -- a disabled tracer costs
    # one attribute load per call site.
    from repro_torch.obs import trace as obs_trace
    from repro_torch.obs.export import to_chrome_trace, write_chrome_trace

    with obs_trace.enabled(capacity=4096) as tracer:
        open_channel(comm, src=SRC, dst=DST, port=None, n_chunks=8).transfer(msg)
        events = tracer.events()
    doc = to_chrome_trace(events)
    print(f"traced {len(events)} channel events {sorted(tracer.kinds())} "
          f"-> {len(doc['traceEvents'])} viewer records")
    if args.trace:
        n = write_chrome_trace(args.trace, events)
        print(f"wrote {n} trace records to {args.trace}")
    return {"hops": hops, "plan": plan, "linear_max_diff": diff, "events": len(events),
            "records": len(doc["traceEvents"])}


if __name__ == "__main__":
    main()
