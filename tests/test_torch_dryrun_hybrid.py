"""The dry run's assembly (``launch/dryrun.py``) for the RG-LRU hybrid,
whose period of three layers leaves two remainder layers: one data group
and the layer-period probes, extrapolated, equal the whole step counted
eagerly, exactly, at tp = 1, (1, 2), (2, 2) and (2, 2, 2), training,
prefill and decode (the other families' in
tests/test_torch_dryrun_assembly.py)."""

from __future__ import annotations

import pytest

from _torch_dp_cases import one_thread  # noqa: F401 (the module's fixture)
from _torch_dryrun_cases import KINDS, MESHES, assert_assembly_is_whole

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("kind", KINDS)
def test_hybrid_assembly_equals_whole_step(kind, mesh):
    assert_assembly_is_whole("recurrentgemma-9b", kind, mesh)
