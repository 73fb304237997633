"""Ranks as processes (``repro_torch.core.spmd``) against the stacked mode
and the reference.

P = 8 ranks run as 8 processes (one a rank) and as 2 (four a rank), on the
CPU, their rows moving through shared-memory mailboxes.  Bit for bit
(tolerance 0: every operation is a copy or the same ordered float32 add):
the process-mode ``ppermute`` against the stacked one, zeros where a rank
receives nothing; the five collectives on ring(1x8) and torus(2x4) over the
static and fused wires against the reference's ``run_spmd``, with the
reference's per-tag steps and bytes in every process; the 2x4 stencil
against the reference's ``DistributedStencil.jitted``; p2p transfers and a
push/pop loop at 1, 4 and 7 hops against the stacked run.  The packet
wire in process mode is tests/test_torch_spmd_packet.py's.  The rank
processes run the functions of ``_torch_spmd_cases`` (no JAX there).  One
group a process layout serves the file, the launcher's case included.
"""

import json

import numpy as np
import pytest
import torch
from _torch_cases import _f32
from _torch_ref import TOPOS, TRANSPORTS, assert_bits_equal, ref_comm, ref_transport, run_ref

import _torch_spmd_cases as K
import repro.core.collectives as rc
from repro.apps import DistributedStencil as RefStencil
from repro_torch.core import Communicator, SpmdGroup
from repro_torch.core.comm import ppermute
from repro_torch.core.topology import Topology
from repro_torch.launch import stencil as launch_stencil

P = 8
LAYOUTS = (8, 2)  # rank processes: one a rank, four ranks a process
#: one slot holds the largest step of these cases (an allgather's row)
SLOT_BYTES = 16 << 10

_GROUPS: dict = {}


def _group(n_procs: int) -> SpmdGroup:
    """The file's group of ``n_procs`` processes, spawned on first use
    (again only if a case ended it)."""
    g = _GROUPS.get(n_procs)
    if g is None or g.closed:
        g = _GROUPS[n_procs] = SpmdGroup(n_procs, P, device="cpu", slot_bytes=SLOT_BYTES)
    return g


@pytest.fixture(scope="module", autouse=True)
def _close_groups():
    yield
    for g in _GROUPS.values():
        g.close()


def _comm_args(topo: str, **kw) -> dict:
    names, sizes = TOPOS[topo]
    return {"axis_names": names, "axis_sizes": sizes, **kw}


# -- ppermute ------------------------------------------------------------------------


_PPERMUTE: dict = {}


def _ppermutes(n_procs: int):
    """Every ppermute case on one input, in process mode (cached a layout)
    and stacked."""
    if n_procs not in _PPERMUTE:
        x = torch.from_numpy(_f32(P, 5, 3, seed=21))
        y = torch.from_numpy(_f32(P, 2, seed=22))
        comm = Communicator.create(*TOPOS["ring"], device="cpu")
        _PPERMUTE[n_procs] = (_group(n_procs).run(K.ppermutes, _comm_args("ring"), x, y),
                              K.ppermutes(comm, x, y), x, y)
    return _PPERMUTE[n_procs]


@pytest.mark.parametrize("case", [*K.ppermute_steps(P), "tuple"])
@pytest.mark.parametrize("n_procs", LAYOUTS)
def test_process_ppermute_equals_stacked(n_procs, case):
    got, want, x, y = _ppermutes(n_procs)
    if case == "tuple":
        assert isinstance(got[case], tuple) and len(got[case]) == 2
        for g, w in zip(got[case], want[case]):
            assert_bits_equal(g, w.numpy(), f"tuple step at {n_procs} processes")
        return
    assert_bits_equal(got[case], want[case].numpy(), f"{case} at {n_procs} processes")
    pairs = K.ppermute_steps(P)[case]
    silent = sorted(set(range(P)) - {d for _, d in pairs})
    assert not got[case][silent].any(), "a rank that receives nothing must get zeros"
    assert_bits_equal(ppermute(x, pairs), want[case].numpy(), "the stacked ppermute")


def test_partial_permutation_leaves_ranks_without_data():
    assert sorted(set(range(P)) - {d for _, d in K.PARTIAL}) == [2, 5]


# -- collectives against the reference -------------------------------------------------


_REF: dict = {}


def _reference(name: str, topo: str, transport: str, x: np.ndarray):
    """The reference's ``run_spmd`` of one collective, tagged with its name:
    the result and its transport (cached)."""
    key = (name, topo, transport)
    if key not in _REF:
        rcomm, rt = ref_comm(topo), ref_transport(transport)

        def fn(v):
            with rt.tagged(name):
                return K.COLLECTIVES[name](rc, rcomm, rt, v)

        _REF[key] = (run_ref(fn, topo, x), rt)
    return _REF[key]


_COLL: dict = {}


@pytest.mark.parametrize("name", sorted(K.COLLECTIVES))
@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("topo", sorted(TOPOS))
@pytest.mark.parametrize("n_procs", LAYOUTS)
def test_process_collective_matches_reference(n_procs, topo, transport, name):
    x = _f32(P, 16, 3, seed=23)
    key = (n_procs, topo)
    if key not in _COLL:  # every collective and wire of a layout in one call
        _COLL[key] = _group(n_procs).run(K.collectives, _comm_args(topo), torch.from_numpy(x),
                                         sorted(K.COLLECTIVES), TRANSPORTS)
    got = _COLL[key][f"{name}/{transport}"]
    want, rt = _reference(name, topo, transport, x)
    what = f"{name} on {topo}/{transport} at {n_procs} processes"
    assert_bits_equal(got["y"], want, what)
    want_stats = (rt.stats.steps, rt.stats.bytes_moved, rt.stats.by_tag)
    assert got["stats"] == [want_stats] * n_procs, what
    # kernel A has no CPU mode: its wrappers ran their plain versions
    assert got["launches"] == {"fold": [0] * n_procs, "shift": [0] * n_procs}


# -- the slice as a whole: the stencil ---------------------------------------------------


@pytest.fixture(scope="module")
def world():
    return np.random.RandomState(0).randn(64, 64).astype(np.float32)


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("overlapped", [True, False], ids=["overlapped", "reference"])
@pytest.mark.parametrize("n_procs", LAYOUTS)
def test_process_stencil_matches_reference(n_procs, overlapped, transport, world):
    ref = RefStencil.create((2, 4), use_pallas=False)
    rt = ref_transport(transport)
    tiles = ref.scatter(world)
    want = np.asarray(ref.jitted(ref.make_mesh(), n_steps=3, overlapped=overlapped,
                                 transport=rt)(tiles))
    got = _group(n_procs).run(K.stencil, _comm_args("torus"), torch.from_numpy(tiles), 3,
                              overlapped, transport)
    assert_bits_equal(got["tiles"], want, f"stencil at {n_procs} processes")
    halo = rt.stats.by_tag["halo"]
    assert got["halo"] == [(halo["steps"], halo["bytes"])] * n_procs


# -- p2p ---------------------------------------------------------------------------------


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("n_procs", LAYOUTS)
def test_process_p2p_equals_stacked(n_procs, transport):
    comm_args = {"axis_names": ("x",), "axis_sizes": (P,), "topology": Topology.bus(P)}
    x = torch.from_numpy(_f32(P, 8, seed=24))
    got = _group(n_procs).run(K.p2p, comm_args, x, transport=transport)
    comm = Communicator.create("x", (P,), topology=Topology.bus(P), device="cpu")
    want = K.p2p(comm, x, transport=transport)
    for dst, w in want.items():
        for key in ("y", "oks", "vals", "popped"):
            assert_bits_equal(got[dst][key], w[key].numpy(), f"{key} to {dst}")
        assert got[dst]["stats"] == [w["stats"]] * n_procs
        # the destination delivered every element, the first on the hops-th pop
        hops = comm.route_table.n_hops(0, dst)
        oks = got[dst]["oks"][dst]
        assert int(oks.sum()) == 6 and int(oks.int().argmax()) == hops - 1


# -- what stays stacked -------------------------------------------------------------------


@pytest.mark.parametrize("flag", ["--trace", "--metrics"])
def test_trace_and_metrics_stay_stacked(flag, tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        launch_stencil.main(["--device", "cpu", "--domain", "16x16", "--steps", "1",
                             "--ranks", "process", flag, str(tmp_path / "out.json")])
    assert exc.value.code == 2  # a usage error
    assert "run stacked only" in capsys.readouterr().err


def test_a_partial_block_needs_its_group():
    from dataclasses import replace

    comm = Communicator.create("x", (P,), device="cpu")
    with pytest.raises(ValueError, match="rank group"):
        replace(comm, lo=4, n_local=4)
    with pytest.raises(ValueError, match="not a block"):
        replace(comm, lo=6, n_local=4, group=object())


# -- the launcher -------------------------------------------------------------------------


def test_launch_stencil_process_mode_on_cpu(tmp_path, capsys):
    argv = ["--device", "cpu", "--domain", "64x64", "--steps", "3"]
    runs = {}
    for ranks, extra in (("stacked", []), ("process", ["--ranks", "process", "--procs", "8"])):
        out = tmp_path / f"{ranks}.json"
        # process mode on the file's 8-process group (the launcher's own
        # group would be a third spawn)
        group = _group(8) if ranks == "process" else None
        assert launch_stencil.main([*argv, *extra, "--json", str(out)], group=group) == 0
        runs[ranks] = json.loads(out.read_text())
    assert "ranks=process procs=8" in capsys.readouterr().out
    stacked, process = runs["stacked"], runs["process"]
    assert process["ok"] and process["max_err"] == 0.0 and process["procs"] == 8
    assert (process["halo_steps"], process["halo_bytes_per_rank"]) == \
        (stacked["halo_steps"], stacked["halo_bytes_per_rank"])
    assert process["launches_b"] == [0] * 8  # the plain version on the CPU


# -- a rank that raises (last: it ends the two-process group) -----------------------------


def test_a_raising_rank_fails_the_call_and_ends_every_process():
    import time

    group = _group(2)
    procs = list(group._procs)
    x = torch.from_numpy(_f32(P, 4, seed=25))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 3 failed on purpose"):
        group.run(K.raise_on_rank, _comm_args("ring"), x, 3)
    assert time.monotonic() - t0 < group.timeout
    assert group.closed
    for p in procs:
        p.join(timeout=10)
    assert not any(p.is_alive() for p in procs)
    with pytest.raises(RuntimeError, match="closed"):
        group.run(K.loaded_modules, _comm_args("ring"))
