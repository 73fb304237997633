"""smilint CLI: both verifier passes over the port, one exit code
(``repro.analysis.lint``).

    PYTHONPATH=src python -m repro_torch.analysis.lint          # everything
    python -m repro_torch.analysis.lint --ast                   # source lints only
    python -m repro_torch.analysis.lint --capture --programs launch.train --device cpu
    python -m repro_torch.analysis.lint --corpus --json report.json

Three gates, all of which must hold for exit 0:

1. **AST pass** — every source file of the port's tree
   (``src/repro_torch/`` and ``chip_smoke.py``) is clean under the SMI00x
   rules (``--ast``).
2. **Capture pass** — every in-repo channel program runs under
   :func:`repro_torch.analysis.capture` with zero diagnostics and zero
   *real* transport steps (``--capture``; abstract interpretation moves no
   message), on ``--device`` (``cuda`` unless ``cpu`` is given).
3. **Corpus pass** — every seeded defect reports exactly its golden rule
   ids (``--corpus``; a verifier that goes quiet fails the same gate as
   a program that goes bad).

``--json`` writes the full machine-readable report (rule id, severity,
rank, port, tag, source location per diagnostic).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _ast_pass(root: str) -> tuple[dict, bool]:
    from .rules import lint_paths

    diags = lint_paths(root)
    for d in diags:
        print(f"  {d}")
    ok = not diags
    return {"diagnostics": [d.to_dict() for d in diags]}, ok


def _capture_pass(names, device) -> tuple[dict, bool]:
    from .programs import PROGRAMS, run_programs

    unknown = [n for n in names or [] if n not in PROGRAMS]
    if unknown:
        raise SystemExit(
            f"unknown program(s) {unknown}; have {sorted(PROGRAMS)}")
    rows, ok = run_programs(names or None, device=device)
    for row in rows:
        mark = "ok" if row["ok"] else "FAIL"
        n_ops = sum(row["ops"].values())
        print(f"  [{mark}] {row['program']}: {n_ops} ops over "
              f"{len(row['transport_steps'])} channels, "
              f"real_steps={row['real_steps']}, "
              f"{len(row['diagnostics'])} diagnostics")
        for d in row["diagnostics"]:
            print(f"      {d['rule']} {d['message']}")
    return {"programs": rows}, ok


def _corpus_pass() -> tuple[dict, bool]:
    from .corpus import run_corpus

    rows, ok = run_corpus()
    for row in rows:
        mark = "ok" if row["ok"] else "FAIL"
        print(f"  [{mark}] {row['case']}: golden={row['golden']} "
              f"reported={row['reported']}")
    return {"corpus": rows}, ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="smilint",
        description="static + capture-mode verifier for the port's SMI "
                    "channel programs")
    ap.add_argument("--ast", action="store_true",
                    help="AST source lints over the repo")
    ap.add_argument("--capture", action="store_true",
                    help="capture-mode verification of in-repo programs")
    ap.add_argument("--corpus", action="store_true",
                    help="golden-rule check over the seeded defect corpus")
    ap.add_argument("--programs", nargs="*", default=None, metavar="NAME",
                    help="capture only these programs (default: all)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the machine-readable report here")
    ap.add_argument("--root", default=None,
                    help="repo root for the AST sweep (default: cwd)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the capture pass runs its programs")
    args = ap.parse_args(argv)

    # no pass selected = every pass
    run_all = not (args.ast or args.capture or args.corpus)
    report: dict = {}
    ok = True

    if run_all or args.ast:
        root = args.root or os.getcwd()
        print(f"smilint: AST pass over {root}")
        part, good = _ast_pass(root)
        report["ast"] = part
        ok = ok and good
        print(f"  -> {'clean' if good else 'DIAGNOSTICS'}")
    if run_all or args.capture:
        print(f"smilint: capture pass on {args.device} (abstract interpretation, no comm)")
        part, good = _capture_pass(args.programs, args.device)
        report["capture"] = part
        ok = ok and good
        print(f"  -> {'clean' if good else 'FAILED'}")
    if run_all or args.corpus:
        print("smilint: corpus pass (seeded defects vs golden rules)")
        part, good = _corpus_pass()
        report["corpus"] = part
        ok = ok and good
        print(f"  -> {'all matched' if good else 'MISMATCH'}")

    report["ok"] = ok
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
        print(f"smilint: report -> {args.json}")
    print(f"smilint: {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
