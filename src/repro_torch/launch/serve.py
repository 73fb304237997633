"""Serving driver (``repro.launch.serve``): wave or continuous-batching
decode of random-weight requests at tensor-parallel degree 1.

    python -m repro_torch.launch.serve --arch yi-6b --requests 8 --max-new 16 \\
        --slots 4 --capacity 256 --engine wave
    python -m repro_torch.launch.serve --smoke --device cpu

Params are drawn from a ``torch.Generator`` seeded 0 on the device, in the
model dtype; prompts come from ``numpy.random.RandomState(0)`` as in the
reference, so both packages submit the same prompts.  Prints tokens/s and
each request's tokens; ``--json`` writes them with the decode steps and
the milliseconds per step.  The device is ``cuda`` unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..configs import get_arch, smoke
from ..core.comm import resolve_device
from ..mesh.api import TP_ROADMAP, make_ctx
from ..models import init_lm
from ..models.model import model_dtype
from ..serving import ContinuousEngine, Request, ServeEngine


def _submit_all(eng, cfg, n_requests, max_new, seed=0):
    rng = np.random.RandomState(seed)
    for uid in range(n_requests):
        plen = int(rng.randint(3, 9))
        prompt = rng.randint(0, cfg.vocab_size, (plen,)).tolist()
        eng.submit(Request(uid=uid, prompt=prompt, max_new=max_new))


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--smoke", action="store_true", help="the arch's reduced smoke config")
    ap.add_argument("--engine", default="continuous", choices=["continuous", "wave"])
    ap.add_argument("--mesh", default="1,1", help="data,model grid (1,1 only)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--capacity", type=int, default=64)
    ap.add_argument("--validate-comm", action="store_true",
                    help="the predicted-vs-measured channel gate (needs tensor parallelism)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--json", default=None, metavar="OUT",
                    help="write machine-readable results to OUT")
    args = ap.parse_args(argv)

    dims = tuple(int(x) for x in args.mesh.split(","))
    if args.validate_comm:
        raise NotImplementedError(f"--validate-comm: {TP_ROADMAP}")
    if any(d > 1 for d in dims):
        raise NotImplementedError(f"--mesh {args.mesh}: {TP_ROADMAP}")
    ctx = make_ctx(dims)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke(cfg)
    dev = resolve_device(args.device)

    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev, dtype=model_dtype(cfg))
    cls = ServeEngine if args.engine == "wave" else ContinuousEngine
    eng = cls(cfg, params, ctx=ctx, batch_slots=args.slots, capacity=args.capacity)
    _submit_all(eng, cfg, args.requests, args.max_new)
    _sync(dev)
    t0 = time.perf_counter()
    done = eng.run(max_steps=1024)
    _sync(dev)
    dt = time.perf_counter() - t0
    toks = sum(len(r.out) for r in done)
    ms_step = dt * 1e3 / max(eng.decode_steps, 1)
    print(f"[serve] engine={args.engine} arch={cfg.name} device={dev} completed {len(done)}/"
          f"{args.requests} requests, {toks} tokens in {dt:.3f}s ({toks / dt:.1f} tok/s), "
          f"{eng.decode_steps} decode steps ({ms_step:.3f} ms/step)")
    for r in done:
        print(f"  req {r.uid}: {r.out[:8]}{'...' if len(r.out) > 8 else ''}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"engine": args.engine, "arch": cfg.name, "device": str(dev),
                       "requests": args.requests, "completed": len(done), "tokens": toks,
                       "seconds": dt, "tok_per_s": toks / dt, "decode_steps": eng.decode_steps,
                       "ms_per_step": ms_step, "out": {str(r.uid): r.out for r in done}}, f)
    return 0 if len(done) == args.requests else 1


if __name__ == "__main__":
    raise SystemExit(main())
