"""Distributed stencil on the PyTorch port (paper §5.4.2): pipelined halo
exchange over a grid.

The domain is scattered 2x4 over 8 ranks; every sweep streams N/S/E/W halo
slabs through the selected SMI transport *while* the interior update runs
(the overlap window), and the assembled result equals the single-rank
sweep -- bit for bit on exact wires, within the codec bound on the int8
compressed links this example finishes with.  The ranks are rows of one
tensor on one device (``cuda`` unless ``--device cpu``); the last column is
the link model's halo time a step, the H100 fit of ``netsim/model.py``.

    PYTHONPATH=src python examples/torch_stencil.py [comm_mode ...] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.apps import DistributedStencil  # noqa: E402

MODES = ("smi", "smi:packet", "smi:fused", "smi:compressed")
#: the int8 wire's gate against the single-rank sweep (the launcher's)
LOSSY_MAX_ERR = 1e-1


def main(modes=MODES, *, device="cuda", domain=(256, 256), steps=8) -> dict:
    """Run every mode; returns each mode's assembled overlapped result."""
    grid = (2, 4)
    world = torch.from_numpy(np.random.RandomState(0).randn(*domain).astype(np.float32))
    want = DistributedStencil.single_rank_reference(world, steps)
    out = {}
    for mode in modes:
        # comm_mode maps onto the halo channel's spec: the "exchange"
        # ChannelSpec carries the selected transport backend
        app = DistributedStencil.create(grid, comm_mode=mode, device=device)
        assert app.halo_schedule.spec.kind == "exchange"
        tiles = app.scatter(world.to(app.device))
        ref = app.gather(app.run(tiles, steps, overlapped=False)).cpu()
        ovl = app.gather(app.run(tiles, steps, overlapped=True)).cpu()
        assert torch.equal(ref, ovl), mode
        err = float((ovl - want).abs().max())
        lossy = mode.startswith("smi:compressed")
        assert err < LOSSY_MAX_ERR if lossy else err == 0.0, (mode, err)
        exact = "bit-exact" if err == 0.0 else f"max|err|={err:.2g}"
        nx, ny = domain[0] // grid[0], domain[1] // grid[1]
        halo_us = app.halo_schedule.predicted_time(
            (nx, ny), wire="int8" if lossy else "raw") * 1e6
        print(f"{mode:<16} overlapped == reference ✓  vs single-rank: {exact:<18} "
              f"H100-fit halo/step: {halo_us:.1f}us")
        out[mode] = ovl
    print("distributed stencil == single-rank reference on all backends ✓")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("modes", nargs="*", default=list(MODES), metavar="comm_mode")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    main(tuple(args.modes), device=args.device)
