"""The training driver (``repro.launch.train``): arch config -> mesh ->
training step -> synthetic data pipeline -> checkpoints -> watchdog.

    python -m repro_torch.launch.train --arch yi-6b --layers 8 --seq-len 4096 --batch 2
    python -m repro_torch.launch.train --arch yi-6b --layers 8 --mesh 1,8 --comm-mode smi:fused
    python -m repro_torch.launch.train --arch yi-6b --smoke --device cpu --steps 3
    python -m repro_torch.launch.train --arch mamba2-2.7b --layers 16 --seq-len 4096 \
        --batch 2 --comm-mode smi:fused --compressed-grads --validate-comm
    python -m repro_torch.launch.train --arch yi-6b --layers 4 --mesh 2,2,2 --seq-len 4096 \
        --batch 4 --steps 2 --comm-mode smi:fused

``--smoke`` takes the arch's reduced config; ``--layers`` cuts the depth at
full width (yi-6b's 32 layers with float32 AdamW state need 96 GB, more
than one card holds).  Runs on ``cuda`` unless ``--device cpu``.  The mesh
is ``data,model`` (``2,4`` unless named, as the reference's) or
``pod,data,model``: the ``pod x data`` groups split the batch, with the
weights FSDP-stored over them, and
``--compressed-grads`` rings the gradients of the leaves stored whole over
the int8 wire.  At tp > 1 on the card the tensor-parallel GEMMs are
kernel D.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..checkpoint import Checkpointer
from ..configs import COMM_MODES, ShapeConfig, get_arch, smoke
from ..data import SyntheticTokenPipeline
from ..ft import StepWatchdog
from ..interop import unshard_train_state
from .steps import TrainSettings, build_train


def train_loop(cfg, shape, settings: TrainSettings, *, mesh=None, steps: int,
               ckpt_dir: str | None = None, ckpt_every: int = 50, log_every: int = 10,
               seed: int = 0, state=None, start_step: int = 0, fail_at: int | None = None,
               matmul_fn=None, device=None, use_kernel=None):
    """Train ``steps - start_step`` steps from ``state`` (``init_state(seed)``
    when ``None``) on the synthetic pipeline's batches (a restart's pipeline
    starts again from its first batch, as the reference's does), logging
    every ``log_every`` steps and the last, and checkpointing the global
    state every ``ckpt_every`` steps (asynchronously) and at the end.
    ``fail_at`` raises at that step (an injected node failure).  Returns
    ``(state, history)``: each logged step's ``{"loss", "ce", "gnorm",
    "lr", "step", "straggler"}``."""
    art = build_train(cfg, shape, settings, mesh=mesh, matmul_fn=matmul_fn, device=device)
    if state is None:
        state = art["init_state"](seed)
    ctx, plan = art["ctx"], art["plan"]
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    pipe = SyntheticTokenPipeline(cfg.vocab_size, shape.seq_len, shape.global_batch, seed=seed,
                                  n_codebooks=cfg.n_codebooks)
    wd = StepWatchdog()
    wd.start()
    history = []
    try:
        for step in range(start_step, steps):
            if fail_at is not None and step == fail_at:
                raise RuntimeError("injected node failure")
            batch = dict(pipe.next())
            if cfg.frontend == "vit_stub":
                rng = np.random.RandomState(seed * 7919 + step)
                pix = (rng.randn(shape.global_batch, cfg.n_patches, cfg.d_model) * 0.02)
                batch["pixel_embeds"] = torch.from_numpy(pix.astype(np.float32)).to(
                    torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32)
            state, metrics = art["step"](state, batch, use_kernel=use_kernel)
            slow = wd.lap(step)
            if step % log_every == 0 or step == steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=step, straggler=slow)
                history.append(m)
                print(f"[train] step={step} loss={m['loss']:.4f} ce={m['ce']:.4f} "
                      f"gnorm={m['gnorm']:.3f} lr={m['lr']:.2e}", flush=True)
            if ckpt and step > 0 and step % ckpt_every == 0:
                ckpt.save(unshard_train_state(state, cfg, ctx, plan), step, async_=True)
        if ckpt:
            ckpt.save(unshard_train_state(state, cfg, ctx, plan), steps)
    finally:
        pipe.close()
        if ckpt:
            # a failure waits for the checkpoint in flight: the restart reads it
            ckpt.wait()
    return state, history


def validate_comm(cfg, dims, shape, settings: TrainSettings, *, matmul_fn=None,
                  device=None) -> int:
    """The predicted-against-measured gate of a training step's channel
    traffic: one step runs eagerly under a ledger capture, and every tag's
    steps and bytes must equal :func:`~repro_torch.netsim.
    predict_train_step_stats` (``eager=True``: every layer counted once, a
    rematerialised layer's recompute not at all).  Prints a table; returns
    0 when every tag is equal, 1 otherwise."""
    from ..netsim import predict_train_step_stats
    from ..parallel import ledger

    dp, tp = int(np.prod(dims[:-1])) if len(dims) > 1 else 1, dims[-1]
    art = build_train(cfg, shape, settings, mesh=dims, matmul_fn=matmul_fn, device=device)
    state = art["init_state"](0)
    pipe = SyntheticTokenPipeline(cfg.vocab_size, shape.seq_len, shape.global_batch,
                                  n_codebooks=cfg.n_codebooks)
    try:
        batch = dict(pipe.next())
    finally:
        pipe.close()
    if cfg.frontend == "vit_stub":
        batch["pixel_embeds"] = torch.zeros(
            (shape.global_batch, cfg.n_patches, cfg.d_model),
            dtype=torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32)
    with ledger.capture() as led:
        art["step"](state, batch)
    measured = {t: dict(e) for t, e in led.by_tag.items()}
    predicted = predict_train_step_stats(cfg, (dp, tp), shape, settings, eager=True)

    print(f"[validate-comm] arch={cfg.name} mesh={','.join(map(str, dims))} "
          f"comm={settings.comm_mode}")
    print(f"  {'tag':<16} {'pred bytes':>12} {'meas bytes':>12} {'pred steps':>11} "
          f"{'meas steps':>11}")
    failures = 0
    for tag in sorted(set(predicted) | set(measured)):
        p = predicted.get(tag, {"steps": 0, "bytes": 0})
        m = measured.get(tag, {"steps": 0, "bytes": 0})
        ok = p == m
        failures += 0 if ok else 1
        print(f"  {tag:<16} {p['bytes']:>12} {m['bytes']:>12} {p['steps']:>11} "
              f"{m['steps']:>11}  {'ok' if ok else 'FAIL'}")
    if failures:
        print(f"[validate-comm] FAIL: {failures} tag(s) diverge")
        return 1
    print(f"[validate-comm] ok: {len(measured)} tags byte-exact "
          f"({sum(e['bytes'] for e in measured.values())} bytes/step)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--smoke", action="store_true", help="the arch's reduced smoke config")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (full width)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--mesh", default="2,4", help="data,model or pod,data,model grid")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--comm-mode", default="smi", choices=list(COMM_MODES),
                    help="collective mode; smi:<backend> pins the transport")
    ap.add_argument("--remat", default="nothing")
    ap.add_argument("--compressed-grads", action="store_true",
                    help="the gradient ring over the data axis on the int8 wire")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--validate-comm", action="store_true",
                    help="run one step and gate the per-tag channel ledger against "
                         "netsim's prediction, byte-exact")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke(cfg)
    if args.layers is not None:
        cfg = cfg.scaled(n_layers=args.layers)
    dims = tuple(int(x) for x in args.mesh.split(","))
    shape = ShapeConfig("cli", seq_len=args.seq_len, global_batch=args.batch, kind="train")
    st = TrainSettings(comm_mode=args.comm_mode, remat=args.remat, base_lr=args.lr,
                       loss_chunks=1 if args.smoke else 8,
                       compressed_grads=args.compressed_grads,
                       total_steps=max(args.steps, 10), warmup_steps=max(args.steps // 10, 1))
    dev = torch.device(args.device)
    matmul_fn = None
    if dev.type == "cuda" and dims[-1] > 1:
        from ..kernels.matmul import matmul as matmul_fn
    if args.validate_comm:
        return validate_comm(cfg, dims, shape, st, matmul_fn=matmul_fn, device=dev)
    t0 = time.time()
    _, history = train_loop(cfg, shape, st, mesh=dims, steps=args.steps, ckpt_dir=args.ckpt_dir,
                            matmul_fn=matmul_fn, device=dev)
    print(f"[train] done in {time.time() - t0:.1f}s; first loss {history[0]['loss']:.4f} -> "
          f"last {history[-1]['loss']:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
