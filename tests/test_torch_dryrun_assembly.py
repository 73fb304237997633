"""The dry run's assembly (``launch/dryrun.py``): one data group counted
for every group and the layer-period probes extrapolated to the whole
depth equal the whole step counted eagerly, exactly, for the dense, SSM
and MoE families at tp = 1, (1, 2), (2, 2) and (2, 2, 2), training,
prefill and decode (the hybrid's cases in
tests/test_torch_dryrun_hybrid.py)."""

from __future__ import annotations

import pytest

from _torch_dp_cases import one_thread  # noqa: F401 (the module's fixture)
from _torch_dryrun_cases import KINDS, MESHES, assert_assembly_is_whole

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-2.7b", "qwen3-moe-30b-a3b"])
def test_assembly_equals_whole_step(arch, kind, mesh):
    assert_assembly_is_whole(arch, kind, mesh)
