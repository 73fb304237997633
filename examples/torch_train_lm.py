"""End-to-end training on the PyTorch port: train a ~100M-param
llama-family model with the full production stack -- SMI streamed
collectives (TP+SP over the model axis, FSDP over data), AdamW, the
synthetic data pipeline with prefetch, async checkpointing, the watchdog.

Default runs a ~25M config for a quick demonstration; pass --full-100m for
the 100M variant.  Both are cut from yi-6b and run on a (2, 4) mesh, the
eight ranks stacked on one device (``cuda`` unless ``--device cpu``).
Checkpoints go to ``--ckpt-dir`` (a temporary directory unless named).

    PYTHONPATH=src python examples/torch_train_lm.py --steps 40
    PYTHONPATH=src python examples/torch_train_lm.py --full-100m --comm-mode smi:compressed
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import COMM_MODES, ShapeConfig, get_arch  # noqa: E402
from repro_torch.launch.steps import TrainSettings  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402

MESH = (2, 4)


def config(full_100m: bool):
    """The example's model and batch: yi-6b cut to ~25M (or ~100M)
    parameters, float32."""
    base = get_arch("yi-6b")  # llama-family
    if full_100m:
        cfg = base.scaled(n_layers=8, d_model=768, n_heads=8, n_kv_heads=4, head_dim=96,
                          d_ff=2048, vocab_size=32_000, dtype="float32")
        return cfg, ShapeConfig("e2e", seq_len=256, global_batch=8, kind="train")
    cfg = base.scaled(n_layers=6, d_model=384, n_heads=8, n_kv_heads=4, head_dim=48,
                      d_ff=1024, vocab_size=8_192, dtype="float32")
    return cfg, ShapeConfig("e2e", seq_len=128, global_batch=8, kind="train")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--comm-mode", default="smi", choices=list(COMM_MODES))
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg, shape = config(args.full_100m)
    print(f"[train_lm] {cfg.name}-derived config: {cfg.param_count() / 1e6:.1f}M params, "
          f"seq={shape.seq_len}, batch={shape.global_batch}, mode={args.comm_mode}")
    st = TrainSettings(comm_mode=args.comm_mode, remat="nothing", loss_chunks=1, base_lr=3e-3,
                       warmup_steps=max(args.steps // 5, 4),
                       total_steps=max(args.steps, 10) * 4)
    dev = torch.device(args.device)
    matmul_fn = None
    if dev.type == "cuda":
        from repro_torch.kernels.matmul import matmul as matmul_fn  # kernel D
    with tempfile.TemporaryDirectory() as tmp:
        _, hist = train_loop(cfg, shape, st, mesh=MESH, steps=args.steps,
                             ckpt_dir=args.ckpt_dir or tmp,
                             ckpt_every=max(args.steps // 2, 10),
                             log_every=max(args.steps // 10, 1), matmul_fn=matmul_fn,
                             device=dev)
    print(f"[train_lm] CE {hist[0]['ce']:.3f} -> {hist[-1]['ce']:.3f} over {args.steps} steps")
    return hist


if __name__ == "__main__":
    main()
