"""Shared cases of the port's dry-run tests (tests/test_torch_dryrun*.py):
the smoke configs deep enough that the period assembly extrapolates, and
the check that it equals the whole step counted eagerly."""

from repro_torch import configs
from repro_torch.launch import dryrun

#: smoke depths past the probes' (launch/dryrun.py PROBE_PERIODS): five
#: periods, the hybrid's two remainder layers behind its five
DEPTH = {"yi-6b": 5, "mamba2-2.7b": 5, "qwen3-moe-30b-a3b": 5, "recurrentgemma-9b": 17}
MESHES = ((1,), (1, 2), (2, 2), (2, 2, 2))
KINDS = ("train", "prefill", "decode")


def assert_assembly_is_whole(arch: str, kind: str, mesh: tuple):
    """One data group and the period probes, assembled, equal the whole
    step run eagerly on the meta device (every group, full depth): FLOPs,
    bytes accessed and every tag's collective steps and bytes, as exact
    integers."""
    cfg = configs.smoke(configs.get_arch(arch)).scaled(n_layers=DEPTH[arch])
    n_periods = cfg.n_layers // len(cfg.pattern)
    assert len(dryrun._depths(cfg, kind)) > 1 and n_periods > dryrun.PROBE_PERIODS[-1]
    shape = configs.ShapeConfig(kind, 32, 8, kind)
    got = dryrun.count_step(cfg, shape, mesh, comm_mode="smi:static")
    whole = dryrun.count_step(cfg, shape, mesh, comm_mode="smi:static", whole=True)
    for k in ("flops", "bytes", "coll", "groups", "by_tag"):
        assert got[k] == whole[k], (k, got[k], whole[k])
    assert isinstance(got["flops"], int) and isinstance(got["bytes"], int)
