"""The port's examples (``examples/torch_*.py``) on the CPU, each at small
arguments, and two of them against the reference:

* ``torch_quickstart``: all six sections with their asserts (the
  column-parallel linear bit-identical to ``x @ w`` here); its tuned
  ``bcast`` plan equals the reference's ``comm.plan("bcast", ...)`` on the
  same bus under one link model (both tuning caches filled with the
  reference's default model, cleared after); its Chrome trace written;
* ``torch_stencil``: the four modes on the 2x4 grid, each mode's result
  equal to the reference ``DistributedStencil``'s on the same world bit for
  bit, ``smi:compressed``'s too (the halos carry the same int8 codes and a
  sweep adds them as the reference does);
* ``torch_gesummv``, ``torch_serve_lm`` and ``torch_train_lm`` run to
  their end (one training step).
"""

import dataclasses
import importlib
import json
import os
import sys

import numpy as np
import pytest

from _torch_dp_cases import one_thread  # noqa: F401 (the module's fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def _example(name):
    if EXAMPLES not in sys.path:
        sys.path.insert(0, EXAMPLES)
    return importlib.import_module(name)


def test_quickstart_runs_and_its_plan_equals_reference(tmp_path):
    import repro.netsim as rns
    from repro.core import Communicator as RefComm
    from repro.core import Topology as RefTopology
    from repro.netsim import tune as rtune

    import repro_torch.netsim as pns
    from repro_torch.core import Communicator, Topology
    from repro_torch.netsim import tune as ptune

    rc = RefComm.create("x", (8,), topology=RefTopology.bus(8))
    pcomm = Communicator.create("x", (8,), topology=Topology.bus(8), device="cpu")
    fields = {f.name: getattr(rns.LinkModel(), f.name) for f in dataclasses.fields(pns.LinkModel)}
    try:
        rtune.tuning_table_for(rc.topology, rc.route_table, model=rns.LinkModel(**fields))
        ptune.tuning_table_for(pcomm.topology, pcomm.route_table, model=pns.LinkModel(**fields))
        out = tmp_path / "trace.json"
        res = _example("torch_quickstart").main(["--device", "cpu", "--trace", str(out)])
        want = rc.plan("bcast", 64 * 4)
    finally:
        rtune.clear_cache()
        ptune.clear_cache()
    assert dataclasses.asdict(res["plan"]) == dataclasses.asdict(want)
    assert res["hops"] == 3 and res["events"] > 0
    assert res["linear_max_diff"] == 0.0  # the CPU's blocks sum as the whole product does
    assert len(json.loads(out.read_text())["traceEvents"]) == res["records"]


def test_stencil_example_equals_reference():
    import jax.numpy as jnp

    from repro.apps import DistributedStencil as RefStencil

    ex = _example("torch_stencil")
    domain, steps = (32, 32), 2
    got = ex.main(ex.MODES, device="cpu", domain=domain, steps=steps)
    world = np.random.RandomState(0).randn(*domain).astype(np.float32)
    for mode in ex.MODES:
        app = RefStencil.create((2, 4), comm_mode=mode)
        want = app.gather(np.asarray(
            app.jitted(n_steps=steps, overlapped=True)(jnp.asarray(app.scatter(world)))))
        assert got[mode].numpy().tobytes() == want.tobytes(), mode


def test_gesummv_example_runs():
    ex = _example("torch_gesummv")
    rows = ex.main(["--device", "cpu"])
    assert [r[0] for r in rows] == list(ex.SIZES)
    assert all(t1 > 0 and t2 > 0 for _, t1, t2 in rows)


def test_serve_lm_example_runs():
    assert _example("torch_serve_lm").main(["--device", "cpu"]) == 0


def test_train_lm_example_runs(tmp_path):
    ex = _example("torch_train_lm")
    hist = ex.main(["--device", "cpu", "--steps", "1", "--comm-mode", "smi:compressed",
                    "--ckpt-dir", str(tmp_path)])
    assert len(hist) == 1 and np.isfinite(hist[0]["ce"])
    assert [p.name for p in tmp_path.iterdir()] == ["step_00000001"]  # the final checkpoint
