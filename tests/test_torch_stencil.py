"""The port's distributed halo-exchange stencil against ``repro.apps``.

Bit for bit (tolerance 0: every point is the same float32 expression):
overlapped == reference schedule, distributed == single-rank sweep, and the
port == ``repro``'s ``DistributedStencil`` on 2x4 and 1x8 over the static
and fused wires.  The ``halo`` tag's counters equal the reference
transport's and ``repro.netsim.predict_halo_stats``.
"""

import numpy as np
import pytest
from _torch_ref import TRANSPORTS, assert_bits_equal, ref_transport, to_port

from repro.apps import DistributedStencil as RefStencil
from repro.netsim.schedule import predict_halo_stats
from repro_torch.apps import HALO_TAG, DistributedStencil
from repro_torch.interop import communicator_from_reference
from repro_torch.launch import stencil as launch_stencil
from repro_torch.transport import get_transport

GRIDS = {"torus2x4": (2, 4), "ring1x8": (1, 8)}
STEPS = 3


@pytest.fixture(scope="module")
def world():
    return np.random.RandomState(0).randn(32, 48).astype(np.float32)


def _apps(grid_name, transport):
    ref = RefStencil.create(GRIDS[grid_name], use_pallas=False)
    rc = ref.comm
    comm = communicator_from_reference(rc.topology.to_json(), rc.axis_names, rc.axis_sizes,
                                       device="cpu")
    return ref, DistributedStencil.create(GRIDS[grid_name], comm=comm, transport=transport)


@pytest.mark.parametrize("overlapped", [True, False], ids=["overlapped", "reference"])
@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("grid_name", sorted(GRIDS))
def test_port_matches_reference_app(grid_name, transport, overlapped, world):
    ref, app = _apps(grid_name, transport)
    rt = ref_transport(transport)
    tiles = ref.scatter(world)
    want = np.asarray(ref.jitted(ref.make_mesh(), n_steps=STEPS, overlapped=overlapped,
                                 transport=rt)(tiles))
    pt = get_transport(transport, device="cpu")
    x = to_port(tiles)
    got = app.run(x, STEPS, overlapped=overlapped, transport=pt)
    assert_bits_equal(got, want, f"{grid_name}/{transport}")
    assert_bits_equal(x, tiles, "input tiles were modified")
    assert pt.stats.by_tag[HALO_TAG] == rt.stats.by_tag[HALO_TAG]
    assert (pt.stats.steps, pt.stats.bytes_moved) == (rt.stats.steps, rt.stats.bytes_moved)
    nx, ny = tiles.shape[1:]
    steps, nbytes = predict_halo_stats(ref.comm, grid=GRIDS[grid_name], shape=(nx, ny),
                                       transport=transport)
    assert pt.stats.tag_counts(HALO_TAG) == (STEPS * steps, STEPS * nbytes)


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("grid_name", sorted(GRIDS) + ["torus2x2"])
def test_overlapped_equals_reference_and_single_rank(grid_name, transport, world):
    grid = GRIDS.get(grid_name, (2, 2))
    app = DistributedStencil.create(grid, comm_mode=f"smi:{transport}", device="cpu")
    w = to_port(world)
    x = app.scatter(w)
    ovl = app.run(x, STEPS, overlapped=True)
    ref = app.run(x, STEPS, overlapped=False)
    assert_bits_equal(ovl, ref.numpy(), "overlapped vs reference")
    single = app.single_rank_reference(w, STEPS)
    assert_bits_equal(app.gather(ovl), single.numpy(), "distributed vs single rank")
    assert_bits_equal(app.gather(x), world, "scatter/gather round trip")


def test_single_rank_reference_matches_repro(world):
    got = DistributedStencil.single_rank_reference(to_port(world), STEPS)
    assert_bits_equal(got, RefStencil.single_rank_reference(world, STEPS), "oracle")


@pytest.mark.parametrize("argv", [
    ["--domain", "64x64", "--steps", "3"],
    ["--domain", "64x64", "--steps", "3", "--no-overlap", "--comm-mode", "smi:fused"],
    ["--case", "ring8", "--comm-mode", "smi:static"],
    ["--domain", "64x64", "--steps", "3", "--plan", "auto"],
])
def test_launch_stencil_on_cpu(argv, tmp_path, capsys):
    out = tmp_path / "r.json"
    assert launch_stencil.main([*argv, "--device", "cpu", "--json", str(out)]) == 0
    assert "OK" in capsys.readouterr().out
    import json

    res = json.loads(out.read_text())
    assert res["ok"] and res["max_err"] == 0.0 and res["halo_steps"] > 0


def test_launch_stencil_plan_auto(tmp_path, capsys):
    """``--plan auto`` is labelled ``smi(auto)``, names the tuned halo
    backend, equals the single-rank sweep and the predicted halo traffic;
    with a pinned ``--comm-mode`` it is an error, as in the reference."""
    import json

    out = tmp_path / "r.json"
    assert launch_stencil.main(["--domain", "64x48", "--steps", "2", "--plan", "auto",
                                "--device", "cpu", "--json", str(out)]) == 0
    res = json.loads(out.read_text())
    app = DistributedStencil.create((2, 4), plan="auto", device="cpu")
    tuned = app.comm.plan("halo", app.halo_schedule.slab_nbytes((32, 12)))
    assert res["comm_mode"] == "smi(auto)" and res["halo_backend"] == tuned.transport_key
    steps, nbytes = app.halo_schedule.predicted_stats((32, 12), transport=tuned.transport_key)
    assert (res["halo_steps"], res["halo_bytes_per_rank"]) == (2 * steps, 2 * nbytes)
    assert "comm_mode=smi(auto)" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        launch_stencil.main(["--plan", "auto", "--comm-mode", "smi:fused", "--device", "cpu"])
    assert "cannot be combined" in capsys.readouterr().err
