#!/usr/bin/env python3
"""Kernel D's host cost on one NVIDIA GPU, from a tree's own ``chip_smoke.py``.

    python3 scripts/d_host_cost.py [ROOT] [--reps N]

Imports ``chip_smoke.py`` from ``ROOT`` (default: this checkout), builds
the kernels, and ``--reps`` times (default 3) reads the host microseconds
a call of kernel D's entry point costs (``_host_us_per_call``) and times
phase 19's yi-6b prefill at P = 8 with D and without it
(``phase_tp_prefill``, host-bound: 1,280 launches of D).  Prints one JSON
line ``D_HOST_COST {...}`` with every reading.  The host's pace varies
between runs, so compare two trees in turns (A, B, B, A), each in its own
process, on one machine in one run: unpack the other tree with
``git archive`` into a directory ``.gitignore`` lists and pass it as
``ROOT``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("root", nargs="?", default=os.path.join(os.path.dirname(__file__), ".."))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("d_host_cost: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cs.phase_build()
    out = {"root": args.root, "host_us": [], "ms_d": [], "ms_none": []}
    for _ in range(args.reps):
        out["host_us"].append(cs._host_us_per_call(dev)["matmul"])
        _launches, res, tp_params = cs.phase_tp_prefill(dev)
        out["ms_d"].append(res["ms_d"])
        out["ms_none"].append(res["ms_matmul_fn_none"])
        del tp_params, res
        gc.collect()
        torch.cuda.empty_cache()
    print("D_HOST_COST " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
