"""The roofline (``repro.launch.roofline``) on an NVIDIA H100, and the
hill-climb driver of ``scripts/hillclimb.py``.

Per (arch x shape) cell, the three terms of a step's time on one device
of the mesh, from a dry-run record (``launch/dryrun.py``):

    compute_t    = FLOPs / PEAK_FLOPS
    memory_t     = bytes accessed / HBM_BYTES_PER_S
    collective_t = collective wire bytes / the link's rate     (per device)

The reference assembles XLA's counts as ``full_step + (n_periods - 1) *
period_probe`` (its ``cost_analysis`` counts a scanned layer body once);
the port's record holds the whole step already, assembled from its
period probes the same way (``launch/dryrun.py``), and the one period's
counts beside it.  Model FLOPs are ``6 N_active D`` (train) and ``2
N_active D`` (inference), embeddings in N; the fraction of the roofline is
the model FLOPs' time over the dominant term (for decode the larger of
that and the least HBM traffic's time).

The peaks are the H100 SXM data sheet's: 989e12 dense bfloat16
tensor-core operations a second, 3.35e12 bytes a second of HBM3.  The
collective term is ``netsim.LinkModel().serialization``, the link fitted
on the card (``scripts/fit_link_model.py``): the one-card rank stack's,
144.7 GB/s of one rank's payload, its index copies on one card; a fit
across cards waits for a multi-card transport (ROADMAP item 1).

    python -m repro_torch.launch.roofline --results dryrun_torch_results.jsonl
    python -m repro_torch.launch.roofline --arch yi-6b --shape train_4k --variant sg
"""

from __future__ import annotations

import argparse
import json
import sys

from ..configs import SHAPES, get_arch
from ..netsim import LinkModel

#: H100 SXM dense bfloat16 tensor-core rate, operations per second (data sheet)
BF16_OPS_PER_S = 989e12
#: H100 SXM float32 rate outside the tensor cores, operations per second
F32_OPS_PER_S = 67e12
#: H100 SXM device-memory rate (HBM3), bytes per second
HBM_BYTES_PER_S = 3.35e12
#: the roofline's compute peak
PEAK_FLOPS = BF16_OPS_PER_S
#: the collective term's link: the card's fit (module docstring)
NET_MODEL = LinkModel()

#: the hill-climb's variants (``scripts/hillclimb.py``): the dry-run options
#: of each
VARIANTS = {
    "base":      dict(shared_gather=False, ring_attn=False, remat="nothing"),
    "sg":        dict(shared_gather=True,  ring_attn=False, remat="nothing"),
    "ra":        dict(shared_gather=False, ring_attn=True,  remat="nothing"),
    "sg_ra":     dict(shared_gather=True,  ring_attn=True,  remat="nothing"),
    "sg_dnb":    dict(shared_gather=True,  ring_attn=False, remat="dots_nb"),
    "sg_ra_dnb": dict(shared_gather=True,  ring_attn=True,  remat="dots_nb"),
}


def useful_bytes_per_device(cfg, shape, n_chips):
    """Minimum HBM traffic per device per step: params (+opt state for
    train) + KV/state caches (decode) + activations in/out, bf16/f32."""
    n = cfg.param_count()
    if shape.kind == "train":
        # fwd+bwd param reads (bf16) + grad write + Adam m/v read/write (f32)
        per_dev = n / n_chips
        return per_dev * (2 * 2 + 4 + 4 * 4)
    if shape.kind == "prefill":
        return (n / n_chips) * 2
    # decode: params (bf16) + full KV/state cache read per token
    cache = 0
    S_eff = shape.seq_len if cfg.local_window is None else min(
        shape.seq_len, cfg.local_window)
    for kind in cfg.layer_pattern:
        if kind in ("attn", "moe"):
            cache += 2 * cfg.n_kv_heads * cfg.hd * S_eff * shape.global_batch * 2
        elif kind == "ssm":
            d_in = cfg.ssm_expand * cfg.d_model
            nh = d_in // cfg.ssm_headdim
            cache += nh * cfg.ssm_state * cfg.ssm_headdim * shape.global_batch * 4
        elif kind == "rec":
            cache += (cfg.lru_width or cfg.d_model) * shape.global_batch * 4
    n_act = cfg.active_param_count()
    return (n_act * 2 + cache) / n_chips


def model_flops_per_device(cfg, shape, n_chips):
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        total = 6 * n_active * tokens
    elif shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        total = 2 * n_active * tokens
    else:
        total = 2 * n_active * shape.global_batch  # one new token per seq
    return total / n_chips


def n_chips_of(rec) -> int:
    """The devices of a record's mesh (``"16x16"``: 256, ``"2x16x16"``: 512)."""
    n = 1
    for d in rec["mesh"].split("x"):
        n *= int(d)
    return n


def _recounted(rec, settings: dict) -> dict:
    """``rec``, or the same cell counted again under ``settings`` where the
    record was counted under others (the reference compiles its probe here
    with the settings it is given)."""
    if all(rec.get("settings", {}).get(k) == v for k, v in settings.items()):
        return rec
    from .dryrun import run_cell

    got = run_cell(rec["arch"], rec["shape"], multi_pod=rec["mesh"].count("x") == 2,
                   comm_mode=rec["comm_mode"], variant=rec.get("variant", "base"),
                   verbose=False, **settings)
    if not got["ok"]:
        raise RuntimeError(f"{rec['arch']} {rec['shape']} under {settings}: {got['error']}")
    return got


def analyze_cell(rec, *, comm_mode="smi", remat="nothing", shared_gather=False,
                 ring_attn=False):
    """The roofline row of a dry-run record (the reference's keys).  The
    record's counts are per device and whole; one counted under other
    settings than these is counted again under these."""
    shape = SHAPES[rec["shape"]]
    rec = _recounted(rec, dict(remat=remat if shape.kind == "train" else "nothing",
                               shared_gather=shared_gather, ring_attn=ring_attn))
    return roofline_row(rec, get_arch(rec["arch"]), shape, comm_mode=comm_mode)


def roofline_row(rec, cfg, shape, *, comm_mode="smi") -> dict:
    """The roofline row of ``rec``, a dry-run record of ``cfg``'s step on
    ``shape`` (an arch's cut as well as a cell)."""
    n_chips = n_chips_of(rec)
    full = {"flops": rec["cost"]["flops"], "bytes": rec["cost"]["bytes_accessed"],
            "coll": rec["collectives"]["total"]}
    total = dict(full)
    terms = {
        "compute_s": total["flops"] / PEAK_FLOPS,
        "memory_s": total["bytes"] / HBM_BYTES_PER_S,
        "collective_s": NET_MODEL.serialization(total["coll"]),
    }
    dominant = max(terms, key=terms.get)
    mf = model_flops_per_device(cfg, shape, n_chips)
    ub = useful_bytes_per_device(cfg, shape, n_chips)
    useful_s = mf / PEAK_FLOPS
    useful_mem_s = ub / HBM_BYTES_PER_S
    # compute-roofline fraction for compute kinds; memory-roofline fraction
    # (how close HBM traffic is to the minimum) for decode
    frac = max(useful_s, useful_mem_s if shape.kind == "decode" else 0.0) \
        / max(terms[dominant], 1e-30)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "kind": shape.kind,
        "comm_mode": comm_mode, "variant": rec.get("variant", "base"),
        "period_probe": rec["period_probe"], "full_step": full, "total": total,
        "terms_s": {k: round(v, 6) for k, v in terms.items()},
        "dominant": dominant,
        "model_flops_per_dev": mf,
        "useful_bytes_per_dev": ub,
        "useful_mem_s": round(useful_mem_s, 6),
        "hlo_over_model_flops": total["flops"] / max(mf, 1e-30),
        "roofline_fraction": round(frac, 4),
        "temp_gb": rec["memory"]["temp_gb"],
        "mesh": rec["mesh"], "n_chips": n_chips,
    }


def _print_row(row, prefix="[roofline]"):
    t = row["terms_s"]
    print(f"{prefix} {row['arch']:24s} {row['shape']:12s} {row.get('variant', 'base'):9s} "
          f"comp={t['compute_s']:.4f}s mem={t['memory_s']:.4f}s "
          f"coll={t['collective_s']:.4f}s dom={row['dominant']:12s} "
          f"frac={row['roofline_fraction']:.3f} "
          f"hlo/model={row['hlo_over_model_flops']:.2f} temp={row['temp_gb']:.3f}GB", flush=True)


def hillclimb(arch: str, shape: str, variant: str, *, out: str | None = None) -> dict:
    """One cell under a named variant on the single-pod mesh: the dry run
    plus its roofline row (``scripts/hillclimb.py``), appended to ``out``."""
    from .dryrun import run_cell

    opts = VARIANTS[variant]
    rec = run_cell(arch, shape, multi_pod=False, comm_mode="smi", variant=variant, **opts)
    if not rec["ok"]:
        raise RuntimeError(rec.get("error"))
    row = analyze_cell(rec, comm_mode="smi", **opts)
    if out:
        with open(out, "a") as f:
            f.write(json.dumps(row) + "\n")
    _print_row(row, "[hillclimb]")
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--results", default="dryrun_torch_results.jsonl")
    ap.add_argument("--out", default=None,
                    help="rows appended here (roofline_torch_results.jsonl, or "
                         "hillclimb_torch_results.jsonl with --variant)")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--comm-mode", default="smi")
    ap.add_argument("--remat", default="nothing")
    ap.add_argument("--variant", default=None, choices=sorted(VARIANTS),
                    help="hill-climb one cell (--arch, --shape): dry run and roofline row")
    args = ap.parse_args(argv)

    if args.variant:
        if not (args.arch and args.shape):
            print("--variant needs --arch and --shape", file=sys.stderr)
            return 2
        hillclimb(args.arch, args.shape, args.variant,
                  out=args.out or "hillclimb_torch_results.jsonl")
        return 0
    out = args.out or "roofline_torch_results.jsonl"
    recs = {}
    with open(args.results) as f:
        for line in f:
            r = json.loads(line)
            if r.get("ok") and not r.get("skipped") and r["mesh"] == "16x16":
                recs[(r["arch"], r["shape"])] = r  # last wins
    bad = 0
    for (arch, shape), rec in sorted(recs.items()):
        if (args.arch and arch != args.arch) or (args.shape and shape != args.shape):
            continue
        try:
            row = analyze_cell(rec, comm_mode=args.comm_mode, remat=args.remat)
        except Exception as e:  # noqa: BLE001 -- a failing cell is reported, the rest run
            bad += 1
            print(f"[roofline] {arch} {shape} FAILED: {type(e).__name__}: {e}", flush=True)
            continue
        _print_row(row)
        with open(out, "a") as f:
            f.write(json.dumps(row) + "\n")
    return 0 if not bad else 2


if __name__ == "__main__":
    sys.exit(main())
