"""Serving driver (``repro.launch.serve``): wave or continuous-batching
decode of random-weight requests, at any ``(data, model)`` or ``(pod,
data, model)`` mesh.

    python -m repro_torch.launch.serve --arch yi-6b --requests 8 --max-new 16 \\
        --slots 4 --capacity 256 --engine wave
    python -m repro_torch.launch.serve --smoke --device cpu

    # tensor-parallel continuous batching on persistent channels
    python -m repro_torch.launch.serve --arch yi-6b --mesh 1,8 --comm-mode smi:static

    # predicted-vs-measured channel gate of ONE decode step + one migration
    python -m repro_torch.launch.serve --arch yi-6b --smoke --device cpu \\
        --mesh 2,4 --comm-mode smi:static --validate-comm

    # the MoE, Mamba2, RG-LRU hybrid and audio (codebook) families at tp > 1
    python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --mesh 1,8

    # FSDP weights over the data axis (where one model shard's bfloat16
    # weights pass 10 GB, as qwen3-moe-30b-a3b's do at 2,4)
    python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --mesh 2,4
    python -m repro_torch.launch.serve --arch mamba2-2.7b --mesh 1,8 --comm-mode smi:static
    python -m repro_torch.launch.serve --arch recurrentgemma-9b --mesh 1,8
    python -m repro_torch.launch.serve --arch musicgen-medium --mesh 1,8

Params are drawn from a ``torch.Generator`` seeded 0 on the device, in the
model dtype (at tp > 1 with the heads padded to a multiple of tp, then
split by ``interop.shard_params``); prompts come from
``numpy.random.RandomState(0)`` as in the reference, so both packages
submit the same prompts (a codebook model's a ``(plen, n_cb)`` draw each).
At tp > 1 the continuous engine decodes over ONE persistent channel a layer
tag from the serving ``ChannelPool``, released at shutdown, and the wave
engine over ``launch.steps.build_serve``'s step.  On FSDP weights every
step gathers each layer's over the data ring (tag ``fsdp.gather``).
Prints tokens/s and each request's tokens; ``--json`` writes them with the
decode steps and the milliseconds per step.  The device is ``cuda`` unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..configs import COMM_MODES, ShapeConfig, get_arch, smoke
from ..core.comm import resolve_device
from ..interop import shard_params
from ..models import init_lm
from ..models.model import model_dtype
from ..serving import ContinuousEngine, Request, ServeEngine
from ..serving.engine import token_shape
from .steps import build_continuous_serve, build_serve


def _params(cfg, rt, dev):
    """Seeded global params in the model dtype, laid out for the runtime
    ``rt`` (split over its context's model axis, FSDP-stored by its plan:
    views of the global leaves where they can be, so one copy is held)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    ctx = rt["ctx"]
    return shard_params(init_lm(cfg, gen, dev, dtype=model_dtype(cfg), ctx=ctx), cfg, ctx,
                        rt["plan"])


def step_ledger(cfg, rt, settings, capacity: int, dev) -> tuple[dict, dict, int]:
    """One decode step of the continuous runtime ``rt`` (seeded params laid
    out for it), plus one slot migration at tp > 1, under a ledger capture:
    the measured per-tag table, its prediction by
    :func:`repro_torch.netsim.predict_decode_step_stats` (``eager=True``:
    the port runs each layer; the FSDP gathers where ``rt`` has a plan),
    and the number of migrations.  ``settings`` duck-types ``comm_mode``.
    Closes the runtime's channel pool."""
    from ..netsim import predict_decode_step_stats
    from ..parallel import ledger

    dp, tp = rt["ctx"].dp, rt["ctx"].tp
    params = _params(cfg, rt, dev)
    caches = rt["init_caches"]()
    B = rt["batch_slots"]
    tok = torch.zeros(token_shape(cfg, B), dtype=torch.int32, device=dev)
    pos = torch.zeros(B, dtype=torch.int32, device=dev)
    migrations = 1 if tp > 1 else 0
    with ledger.capture() as led:
        rt["step"](params, caches, tok, pos)
        if migrations:
            rt["migrate_finish"](caches, rt["migrate_start"](caches, 0), 1)
    measured = {t: dict(e) for t, e in led.by_tag.items()}
    predicted = predict_decode_step_stats(cfg, (dp, tp), B, settings, capacity=capacity,
                                          migrations=migrations, eager=True,
                                          fsdp=rt["plan"] is not None)
    if rt["pool"] is not None:
        rt["pool"].close()
    return measured, predicted, migrations


def validate_comm(cfg, dims, args, dev) -> int:
    """Predicted-vs-measured channel traffic gate of the serving step: runs
    :func:`step_ledger` on a continuous runtime and diffs the per-tag ledger
    against the prediction, per ``serve.*`` tag, byte for byte and step for
    step.  A bare ``smi`` returns 2: the tuner would pick schedules the
    predictor does not see."""
    if ":" not in args.comm_mode:
        print("[validate-comm] need a pinned backend (smi:<backend>); bare 'smi' lets the "
              "per-tag tuner pick schedules the predictor cannot see")
        return 2
    rt = build_continuous_serve(cfg, mesh=dims, comm_mode=args.comm_mode,
                                batch_slots=args.slots, capacity=args.capacity, device=dev)
    B = rt["batch_slots"]
    measured, predicted, migrations = step_ledger(cfg, rt, args, args.capacity, dev)

    print(f"[validate-comm] arch={cfg.name} mesh={','.join(map(str, dims))} "
          f"comm={args.comm_mode} slots={B} migrations={migrations} layers={cfg.n_layers} "
          f"fsdp={rt['plan'] is not None}")
    print(f"  {'tag':<22} {'pred bytes':>12} {'meas bytes':>12} {'pred steps':>11} "
          f"{'meas steps':>11}")
    failures = 0
    for tag in sorted(set(predicted) | set(measured)):
        p = predicted.get(tag, {"steps": 0, "bytes": 0})
        m = measured.get(tag, {"steps": 0, "bytes": 0})
        ok = p == m
        failures += 0 if ok else 1
        print(f"  {tag:<22} {p['bytes']:>12} {m['bytes']:>12} {p['steps']:>11} "
              f"{m['steps']:>11}  {'ok' if ok else 'FAIL'}")
    if failures:
        print(f"[validate-comm] FAIL: {failures} tag(s) diverge")
        return 1
    print(f"[validate-comm] ok: {len(measured)} tags byte-exact "
          f"({sum(e['bytes'] for e in measured.values())} bytes/step)")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"arch": cfg.name, "mesh": list(dims), "comm_mode": args.comm_mode,
                       "predicted": predicted, "measured": measured}, f)
    return 0


def _submit_all(eng, cfg, n_requests, max_new, seed=0):
    rng = np.random.RandomState(seed)
    for uid in range(n_requests):
        plen = int(rng.randint(3, 9))
        prompt = rng.randint(0, cfg.vocab_size, token_shape(cfg, plen)).tolist()
        eng.submit(Request(uid=uid, prompt=prompt, max_new=max_new))


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--smoke", action="store_true", help="the arch's reduced smoke config")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (full width)")
    ap.add_argument("--engine", default="continuous", choices=["continuous", "wave"])
    ap.add_argument("--mesh", default="1,1", help="data,model or pod,data,model grid")
    ap.add_argument("--comm-mode", default="smi", choices=list(COMM_MODES))
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--capacity", type=int, default=64)
    ap.add_argument("--validate-comm", action="store_true",
                    help="run one serve step + migration and gate the serve.* channel ledger "
                         "against netsim, byte for byte")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--json", default=None, metavar="OUT",
                    help="write machine-readable results to OUT")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke(cfg)
    if args.layers is not None:
        cfg = cfg.scaled(n_layers=args.layers)
    dims = tuple(int(x) for x in args.mesh.split(","))
    dev = resolve_device(args.device)
    if args.validate_comm:
        return validate_comm(cfg, dims, args, dev)

    if args.engine == "wave":
        rt = build_serve(cfg, ShapeConfig("serve", args.capacity, args.slots, "decode"),
                         mesh=dims, comm_mode=args.comm_mode, device=dev)
        eng = ServeEngine(cfg, _params(cfg, rt, dev), runtime=rt)
    else:
        rt = build_continuous_serve(cfg, mesh=dims, comm_mode=args.comm_mode,
                                    batch_slots=args.slots, capacity=args.capacity, device=dev)
        eng = ContinuousEngine(cfg, _params(cfg, rt, dev), runtime=rt)
        if rt["pool"] is not None:
            print(f"[serve] persistent channels: {sorted(rt['pool'].ports().items())}")
    _submit_all(eng, cfg, args.requests, args.max_new)
    _sync(dev)
    t0 = time.perf_counter()
    done = eng.run(max_steps=1024)
    _sync(dev)
    dt = time.perf_counter() - t0
    if isinstance(eng, ContinuousEngine):
        eng.shutdown()
    toks = sum(len(r.out) for r in done)
    ms_step = dt * 1e3 / max(eng.decode_steps, 1)
    print(f"[serve] engine={args.engine} arch={cfg.name} mesh={args.mesh} comm={args.comm_mode} "
          f"fsdp={rt['plan'] is not None} device={dev} completed {len(done)}/{args.requests} "
          f"requests, {toks} tokens in "
          f"{dt:.3f}s ({toks / dt:.1f} tok/s), {eng.decode_steps} decode steps "
          f"({ms_step:.3f} ms/step)")
    for r in done:
        print(f"  req {r.uid}: {r.out[:8]}{'...' if len(r.out) > 8 else ''}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"engine": args.engine, "arch": cfg.name, "mesh": list(dims),
                       "comm_mode": args.comm_mode, "fsdp": rt["plan"] is not None,
                       "device": str(dev),
                       "requests": args.requests, "completed": len(done), "tokens": toks,
                       "seconds": dt, "tok_per_s": toks / dt, "decode_steps": eng.decode_steps,
                       "ms_per_step": ms_step, "out": {str(r.uid): r.out for r in done}}, f)
    return 0 if len(done) == args.requests else 1


if __name__ == "__main__":
    raise SystemExit(main())
