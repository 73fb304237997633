"""smilint in the port (``repro_torch.analysis``) against ``repro.analysis``.

The corpus programs and their golden rule ids, the rule catalog, the AST
rules over the reference's seeded sources (SMI004 on its port form: a raw
move over the rank dimension), suppression, the port's tree clean under
its own rules, and capture mode: the stencil and channel-API programs
recorded op for op as the reference records them (every field but the
source location; the communicator by its order of appearance), the train
and serve programs clean, no real transport step in any capture, and a
real run after a capture equal to one without it.
"""

import gc
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from _torch_ref import port_comm, ref_comm, run_ref, to_port

from repro.analysis import CATALOG as REF_CATALOG
from repro.analysis import programs as ref_programs
from repro.analysis.corpus import corpus as ref_corpus
from repro.analysis.rules import lint_source as ref_lint_source
from repro_torch.analysis import CATALOG, Diagnostic, ProgramBuilder, verify_program
from repro_torch.analysis import capture as cap
from repro_torch.analysis import programs
from repro_torch.analysis.corpus import corpus, run_corpus
from repro_torch.analysis.rules import ALL_RULES, lint_paths, lint_source, port_paths
from repro_torch.analysis.verify import verify_ledger
from repro_torch.channels import open_bcast_channel, open_channel
from repro_torch.core import PortAllocator
from repro_torch.transport import get_transport

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF_CASES = {c.name: c for c in ref_corpus()}


# ---------------------------------------------------------------------------
# the corpus and the catalog
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", corpus(), ids=lambda c: c.name)
def test_corpus_case_equals_reference(case):
    ref = REF_CASES[case.name]
    assert case.golden == ref.golden
    assert case.reported() == case.golden, f"{case.name}: {[str(d) for d in case.run()]}"
    if case.program is not None:
        prog, rprog = case.program, ref.program
        assert (prog.size, prog.spmd, prog.name) == (rprog.size, rprog.spmd, rprog.name)
        assert {r: [o.to_dict() for o in ops] for r, ops in prog.ranks.items()} == \
            {r: [o.to_dict() for o in ops] for r, ops in rprog.ranks.items()}
        assert [d.to_dict() for d in case.run()] == [d.to_dict() for d in ref.run()]
    elif case.golden != {"SMI004"}:
        assert case.source == ref.source


def test_catalog_equals_reference():
    assert CATALOG == REF_CATALOG
    assert {r.rule_id for r in ALL_RULES} == {r for r in CATALOG if r.startswith("SMI0")}
    rows, ok = run_corpus()
    assert ok and len(rows) == len(REF_CASES)


@pytest.mark.parametrize("name", [n for n, c in REF_CASES.items() if c.source is not None])
def test_reference_seeds_give_the_same_ids(name):
    """The reference's seeded sources, at the port's paths, report the
    reference's rule ids; SMI004's lax form is no raw move in the port,
    and its port form is."""
    ref = REF_CASES[name]
    rel = (ref.relpath or f"src/repro/seeded/{name}.py").replace("src/repro/", "src/repro_torch/")
    got = {d.rule for d in lint_source(ref.source, relpath=rel)}
    want = {d.rule for d in ref_lint_source(ref.source, relpath=ref.relpath or
                                            f"src/repro/seeded/{name}.py")}
    assert want == ref.golden
    if ref.golden == {"SMI004"}:
        assert got == set()
        port_case = next(c for c in corpus() if c.name == name)
        assert port_case.reported() == ref.golden
    else:
        assert got == want


@pytest.mark.parametrize("src", [
    "def f(x, pairs):\n    return ppermute(x, pairs)\n",
    "def f(x, comm, pairs):\n    return comm.ppermute(x, pairs)\n",
    "def f(pairs, n, d):\n    return _full_gather(pairs, n, d)\n",
    "def f(pairs, d):\n    return C._pair_index(pairs, d)\n",
    "def f(x):\n    dist.all_reduce(x)\n",
    "def f(x):\n    torch.distributed.all_gather_into_tensor(x, x)\n",
    "def f(x):\n    return dist.send(x, 1)\n",
])
def test_smi004_port_form(src):
    for scope in ("models", "parallel", "serving"):
        rel = f"src/repro_torch/{scope}/seeded.py"
        assert [d.rule for d in lint_source(src, relpath=rel)] == ["SMI004"]
    # the tagged channel layer is the one allowed site; elsewhere out of scope
    assert lint_source(src, relpath="src/repro_torch/parallel/layers.py") == []
    assert lint_source(src, relpath="src/repro_torch/transport/seeded.py") == []
    clean = "def f(x, ctx):\n    return psum_tagged(x, ctx, 'tp')\n"
    assert lint_source(clean, relpath="src/repro_torch/models/seeded.py") == []


def test_suppression_comment_silences_exactly_the_named_rule():
    rel = "src/repro_torch/seeded.py"
    shim = "y = stream_bcast(x, comm)"
    assert lint_source(shim + "  # smilint: ignore[SMI001]\n", relpath=rel) == []
    assert [d.rule for d in lint_source(shim + "\n", relpath=rel)] == ["SMI001"]
    other = lint_source(shim + "  # smilint: ignore[SMI004]\n", relpath=rel)
    assert [d.rule for d in other] == ["SMI001"]
    raw = "def f(x, p):\n    return ppermute(x, p)  # smilint: ignore[SMI004,SMI001]\n"
    assert lint_source(raw, relpath="src/repro_torch/models/seeded.py") == []


def test_close_discipline_accepts_escapes_and_with():
    clean = (
        "def mk(comm):\n"
        "    ch = open_channel(comm, port=1)\n"
        "    return ch\n"
        "def use(comm, x):\n"
        "    with open_channel(comm, port=2) as ch:\n"
        "        pass\n"
        "    anon = open_channel(comm, port=None)\n"
        "    ch2 = open_channel(comm, port=3)\n"
        "    ch2.close()\n"
    )
    assert lint_source(clean, relpath="src/repro_torch/seeded.py") == []
    # the channels layer builds what it hands out
    bad = "def f(comm):\n    ch = open_channel(comm, port=4)\n    ch.push(1)\n"
    assert [d.rule for d in lint_source(bad)] == ["SMI002"]
    assert lint_source(bad, relpath="src/repro_torch/channels/seeded.py") == []


def test_port_tree_is_clean_under_its_own_rules():
    paths = port_paths(ROOT)
    assert ROOT / "chip_smoke.py" in paths
    assert ROOT / "src" / "repro_torch" / "analysis" / "rules.py" in paths
    assert not any("/src/repro/" in str(p) for p in paths)
    assert lint_paths(str(ROOT)) == []


def test_lint_cli_ast_and_corpus(tmp_path):
    out = tmp_path / "report.json"
    res = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint", "--ast", "--corpus",
                          "--root", str(ROOT), "--json", str(out)],
                         capture_output=True, text=True, cwd=ROOT, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert res.returncode == 0, res.stdout + res.stderr
    report = json.loads(out.read_text())
    assert report["ok"] and report["ast"]["diagnostics"] == []
    assert all(r["ok"] for r in report["corpus"]["corpus"])


def test_verifier_reports_seeded_collision():
    b = ProgramBuilder(size=2)
    s = b.spmd()
    s.open(kind="p2p", port=3, src=0, dst=1, count=1, dtype="float32")
    s.open(kind="p2p", port=3, src=0, dst=1, count=1, dtype="float32")
    d = next(d for d in verify_program(b.build("seeded")) if d.rule == "SMI101")
    assert d.to_dict()["port"] == 3 and d.severity == CATALOG["SMI101"][0]
    d = Diagnostic(rule="SMI104", message="window overrun", rank=1, port=3, tag="tp.col",
                   location="src/x.py:9")
    assert "SMI104" in str(d) and "src/x.py:9" in str(d)


# ---------------------------------------------------------------------------
# capture mode
# ---------------------------------------------------------------------------


def _norm(ops):
    """Every field but the source location, the communicator named by its
    order of appearance (its id differs between packages)."""
    comms: dict = {}
    out = []
    for o in ops:
        d = o.to_dict()
        d.pop("location")
        d["comm"] = comms.setdefault(d["comm"], f"comm{len(comms)}")
        out.append(d)
    return out


def test_stencil_capture_equals_reference():
    want = ref_programs.capture_stencil()
    got = programs.capture_stencil(device="cpu")
    assert got.real_steps == 0 and want.real_steps == 0
    assert _norm(got.ops) == _norm(want.ops)
    assert got.transport_steps == want.transport_steps == {"halo": {"steps": 4, "bytes": 192}}
    assert verify_ledger(got) == []
    # eager: k steps record k times the one-step pattern
    k = programs.capture_stencil(n_steps=3, device="cpu")
    assert k.transport_steps == {"halo": {"steps": 12, "bytes": 576}}


def test_bench_collectives_capture_equals_reference():
    want = ref_programs.capture_bench_collectives()
    got = programs.capture_bench_collectives(device="cpu")
    assert got.real_steps == 0
    assert _norm(got.ops) == _norm(want.ops)
    assert [o.op for o in got.ops] == ["open", "transfer"] * 5
    assert verify_ledger(got) == []


def test_bench_collectives_abstract_tallies_equal_a_real_run():
    """The abstract backend accounts what the real one would: the same
    program on one static instance tallies the capture's totals."""
    from repro_torch.channels import (
        open_allreduce_channel,
        open_gather_channel,
        open_reduce_channel,
        open_scatter_channel,
    )
    from repro_torch.core import Communicator

    led = programs.capture_bench_collectives(device="cpu")
    comm = Communicator.create("x", (8,), device="cpu")
    t = get_transport("static", device="cpu")
    v, gv, fv = torch.zeros(8, 4, 3), torch.zeros(8, 2, 3), torch.zeros(8, 16, 3)
    open_bcast_channel(comm, root=1, port=None, n_chunks=2, transport=t).transfer(v)
    open_reduce_channel(comm, root=0, port=None, n_chunks=2, transport=t).transfer(v)
    open_gather_channel(comm, root=0, port=None, transport=t).transfer(gv)
    open_scatter_channel(comm, root=0, port=None, transport=t).transfer(fv)
    open_allreduce_channel(comm, port=None, transport=t).transfer(v)
    assert led.transport_steps == {"untagged": {"steps": t.stats.steps,
                                                "bytes": t.stats.bytes_moved}}


def test_quickstart_capture_is_the_reference_loop_unrolled():
    want = _norm(ref_programs.capture_quickstart().ops)
    led = programs.capture_quickstart(device="cpu")
    got = _norm(led.ops)
    assert led.real_steps == 0
    # the reference records the loop body once (one push, one pop); the
    # eager loop pushes count = 12 elements and pops count + hops - 1 = 14
    assert [o["op"] for o in want[:3]] == ["open", "push", "pop"]
    unrolled = [want[0]] + [want[1], want[2]] * 12 + [want[2]] * 2 + want[3:]
    assert got == unrolled
    assert verify_ledger(led) == []


def test_train_and_serve_captures_are_clean():
    led = programs.capture_train(device="cpu")
    assert led.real_steps == 0, "the captured train step moved bytes"
    assert led.transport_steps and all(e["steps"] > 0 for e in led.transport_steps.values())
    assert verify_ledger(led, name="launch.train") == []
    led = programs.capture_serve(device="cpu")
    assert led.real_steps == 0, "the captured serve step moved bytes"
    counts = led.counts()
    assert counts.get("pool.open", 0) >= 1 and counts["pool.open"] == counts["pool.close"]
    assert "serve.migrate" in led.transport_steps
    assert verify_ledger(led, name="launch.serve") == []
    rows, ok = programs.run_programs(["launch.stencil", "bench.collectives"], device="cpu")
    assert ok and [r["real_steps"] for r in rows] == [0, 0]


def test_capture_is_invisible_to_real_execution():
    """A channel's real backend, cached on its spec, survives a capture of
    the same channel, and a run after the capture equals one before it bit
    for bit; inside, the abstract backend moves nothing."""
    x = np.random.RandomState(4).randn(8, 6).astype(np.float32)
    rc, comm = ref_comm("ring"), port_comm("ring")
    t = get_transport("static", device="cpu")
    ch = open_channel(comm, src=0, dst=3, port=None, n_chunks=2, transport=t,
                      elem_shape=(6,))

    def run():
        c = ch.push(to_port(x))
        for _ in range(3):
            c, val, _ = c.pop()
        return val, ch.transfer(to_port(x))

    v0, y0 = run()
    steps = t.stats.steps
    assert steps > 0
    with cap.capture() as led:
        v_cap, y_cap = run()
    assert not cap.ACTIVE and cap.LEDGER is None
    assert led.real_steps == 0 and t.stats.steps == steps
    assert [o.op for o in led.ops] == ["push", "pop", "pop", "pop", "transfer"]
    assert not v_cap.any() and not y_cap.any()
    v1, y1 = run()
    assert t.stats.steps == 2 * steps
    assert torch.equal(v0, v1) and torch.equal(y0, y1)
    want = run_ref(lambda v: open_channel_ref(rc, v), "ring", x)
    np.testing.assert_array_equal(y1.numpy(), want)


def open_channel_ref(rc, v):
    import repro.channels as C

    return C.open_channel(rc, src=0, dst=3, port=None, n_chunks=2).transfer(v)


def test_capture_counts_a_real_backend_stepping():
    comm = port_comm("ring")
    t = get_transport("static", device="cpu")
    with cap.capture() as led:
        t.shift(torch.ones(8, 4), comm, 1)  # an instance made before the capture
        get_transport("fused", device="cpu").shift(torch.ones(8, 4), comm, 1)
    assert led.real_steps == 1
    assert led.transport_steps == {"untagged": {"steps": 1, "bytes": 16}}


def test_capture_flags_port_collision_and_does_not_nest():
    comm = port_comm("ring")
    pa = PortAllocator()
    with pytest.raises(ValueError, match="already claimed"):
        with cap.capture():
            open_channel(comm, src=0, dst=1, port=3, allocator=pa)
            open_channel(comm, src=0, dst=2, port=3, allocator=pa)
    assert not cap.ACTIVE
    with cap.capture():
        with pytest.raises(RuntimeError, match="do not nest"):
            with cap.capture():
                pass
    b = ProgramBuilder(size=8)
    s = b.spmd()
    s.open(kind="p2p", port=3, src=0, dst=1)
    s.open(kind="p2p", port=3, src=0, dst=2)
    assert {d.rule for d in verify_program(b.build())} >= {"SMI101"}
    gc.collect()
