"""Serve a small model with continuous batching on the PyTorch port.

Default: the single-device ContinuousEngine -- requests admit into any
free slot mid-decode, prompts replay through the same step their
batch-mates generate in.  Uncomment the mesh/comm-mode args to decode
tensor-parallel over persistent SMI channels (one port claim per layer
tag, held until engine shutdown); add ``--validate-comm`` to byte-check
the ``serve.*`` channel ledger against the netsim prediction instead.
Runs on ``cuda`` unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.serve import main as serve  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    return serve(["--arch", "yi-6b", "--smoke", "--requests", "6",
                  "--max-new", "10", "--slots", "3",
                  # "--mesh", "1,8", "--comm-mode", "smi:static",
                  "--device", args.device])


if __name__ == "__main__":
    raise SystemExit(main())
