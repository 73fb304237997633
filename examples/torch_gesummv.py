"""GESUMMV on the PyTorch port (paper §5.4.1): MPMD functional
decomposition over 2 ranks.

y = alpha*A@x + beta*B@x.  Rank 0 computes the A-GEMV and streams its
result into rank 1, which computes the B-GEMV from its own memory and
combines -- the paper's 8-line-diff distribution.  Both ranks are rows of
one tensor on one device (``cuda`` unless ``--device cpu``), so they share
its memory: the example shows the channel at work, not the paper's 2x.
Times are taken by CUDA events on the card (``perf_counter`` on the CPU)
and printed beside the card's name and power limit.

    PYTHONPATH=src python examples/torch_gesummv.py [--device cpu]
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.apps import gesummv, gesummv_two_ranks  # noqa: E402
from repro_torch.core import Communicator  # noqa: E402

SIZES = (1024, 2048)


def device_label(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them, or
    ``cpu``."""
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={dev.index or 0}"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out or f"{torch.cuda.get_device_name(dev)}, power limit not read"


def timeit(fn, dev: torch.device, reps: int = 20) -> float:
    """Mean seconds of one call after a warm-up call."""
    fn()
    if dev.type == "cuda":
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def run(sizes=SIZES, device="cuda"):
    """``[(N, single_s, two_rank_s)]``: both forms timed at each ``N``, the
    two-rank result held within 2e-4 of the single rank's."""
    dev = torch.device(device)
    comm = Communicator.create("x", (2,), device=dev)
    rows = []
    for N in sizes:
        g = torch.Generator().manual_seed(0)
        A, B = (torch.randn(N, N, generator=g).to(dev) for _ in range(2))
        x = torch.randn(N, generator=g).to(dev)
        want = gesummv(A, B, x)
        AB = torch.stack([A, B])  # rank 0 holds A, rank 1 holds B
        got = gesummv_two_ranks(AB, x, comm)[1]
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
        t1 = timeit(lambda: gesummv(A, B, x), dev)
        t2 = timeit(lambda: gesummv_two_ranks(AB, x, comm), dev)
        rows.append((N, t1, t2))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    rows = run(device=args.device)
    label = device_label(torch.device(args.device))
    for N, t1, t2 in rows:
        print(f"N={N}: single {t1 * 1e3:.4f} ms | 2-rank SMI {t2 * 1e3:.4f} ms ({label}; "
              f"both ranks share one device's memory)")
    return rows


if __name__ == "__main__":
    main()
