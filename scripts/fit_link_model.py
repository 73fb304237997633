#!/usr/bin/env python3
"""Fit the port's netsim link model on one NVIDIA GPU.

    python3 scripts/fit_link_model.py [--json OUT]

Runs the phases of ``chip_smoke.py`` the fit reads — 1 (build the
kernels), 5 (the reductions, for ``unfused_add_latency``), 9 (Tab. 4's
injection, for ``switch_cycles``), 22 (channel bandwidth, for
``quant_latency``) and 25 (the calibration records, fitted and gated at
2x) — and prints the fitted ``LinkModel`` and the card's name and power
limit.  Its fields are what ``repro_torch/netsim/model.py`` takes as its
defaults; ``chip_smoke.py`` phase 25 prints the same fit from its own run
and the committed defaults' drift on it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--json", default=None, metavar="OUT", help="write the fit and its inputs")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("fit_link_model: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    cs.phase_build()
    _, reduce_times = cs.phase_reductions(dev)
    torch.cuda.empty_cache()
    injection = cs.phase_injection(dev)
    bandwidth_rows, _ = cs.phase_channel_bandwidth(dev)
    torch.cuda.empty_cache()
    res = cs.phase_link_fit(dev, reduce_times, injection, bandwidth_rows)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res | {"card": card, "reduce_times": reduce_times,
                             "injection": injection, "bandwidth_rows": bandwidth_rows}, f,
                      indent=1)
    print(card)
    for name, value in res["model"].items():
        print(f"    {name}: float = {value!r}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
