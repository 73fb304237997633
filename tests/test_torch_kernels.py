"""The port's two kernels against the reference's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; that version is
held bit for bit against the Pallas kernel in interpret mode (called
outside ``shard_map``) and the reference's ``stencil_ref``.  The cases
marked ``cuda`` hold the CUDA kernels against the plain versions on the
card, and skip where there is none.  The reference (JAX) is imported only
inside the CPU cases, so that on a machine with a card and no JAX the
``cuda`` cases run alone:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels.stencil import (
    stencil_interior,
    stencil_ref,
    stencil_sweep,
    stencil_sweep_plain,
)
from repro_torch.transport.fused import FusedTransport, accumulate_plain, fused_accumulate

DTYPES = ("bfloat16", "float32", "int32")


@pytest.fixture
def ref():
    """The reference package's kernels (imports JAX)."""
    import jax.numpy as jnp
    from _torch_ref import assert_bits_equal  # loads the reference registry first

    from repro.kernels.stencil import stencil_ref, stencil_step
    from repro.kernels.stencil.kernel import stencil_pallas
    from repro.transport.fused import fused_accumulate

    return SimpleNamespace(jnp=jnp, assert_bits_equal=assert_bits_equal,
                           stencil_ref=stencil_ref, stencil_step=stencil_step,
                           stencil_pallas=stencil_pallas, fused_accumulate=fused_accumulate)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _operand(jnp, shape, dtype, seed):
    """(numpy array of the reference, torch tensor of the port) with the
    same bits; bfloat16 crosses as its uint16 bit pattern."""
    rng = np.random.RandomState(seed)
    if dtype == "int32":
        a = rng.randint(-2**31, 2**31 - 1, size=shape, dtype=np.int64).astype(np.int32)
        return a, torch.from_numpy(a.copy())
    a = np.asarray(jnp.asarray(rng.randn(*shape) * 100, getattr(jnp, dtype)))
    if dtype == "bfloat16":
        bits = a.view(np.uint16).copy()
        return a, torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    return a, torch.from_numpy(a.copy())


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _ref_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


# -- kernel A: the fused transport's add ---------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(5,), (33, 7), (1000,), (3, 129), (8, 130, 3)])
def test_accumulate_plain_matches_pallas_interpret(shape, dtype, ref):
    jnp, assert_bits_equal = ref.jnp, ref.assert_bits_equal
    a, ta = _operand(jnp, shape, dtype, 1)
    b, tb = _operand(jnp, shape, dtype, 2)
    want = ref.fused_accumulate(jnp.asarray(a), jnp.asarray(b), interpret=True)
    before = fused_accumulate.launches
    got = fused_accumulate(ta, tb)  # CPU tensor: the plain version
    assert fused_accumulate.launches == before
    assert_bits_equal(_bits(got), _ref_bits(want), f"{dtype}{shape}")
    assert_bits_equal(_bits(accumulate_plain(ta, tb)), _ref_bits(want), "plain")


def test_accumulate_refuses_what_the_kernel_does_not_take():
    a = torch.ones(4)
    with pytest.raises(ValueError):
        fused_accumulate(a, torch.ones(5))
    with pytest.raises(ValueError):
        fused_accumulate(a, torch.ones(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_accumulate(a.to("meta"), a.to("meta"))


def test_fused_transport_on_cpu_uses_the_plain_version():
    t = FusedTransport(device="cpu")
    a, b = torch.randn(8, 5), torch.randn(8, 5)
    assert torch.equal(t.accumulate(a, b), a + b)


# -- kernel B: the stencil sweep ---------------------------------------------------


@pytest.mark.parametrize("shape", [(128, 40), (256, 24), (384, 1)])
def test_stencil_plain_matches_pallas_interpret(shape, ref):
    """M a multiple of the Pallas row block (128): the kernel runs as is."""
    jnp, assert_bits_equal = ref.jnp, ref.assert_bits_equal
    x, tx = _operand(jnp, shape, "float32", 3)
    want = ref.stencil_pallas(jnp.asarray(x), block_m=128, interpret=True)
    assert_bits_equal(stencil_sweep(tx), want, f"{shape}")
    assert_bits_equal(stencil_sweep_plain(tx), want, "plain")


@pytest.mark.parametrize("shape", [(33, 17), (70, 50), (129, 9), (1, 1)])
def test_stencil_plain_matches_reference_at_ragged_shapes(shape, ref):
    """M not a multiple of 128: the reference pads before its kernel."""
    jnp, assert_bits_equal = ref.jnp, ref.assert_bits_equal
    x, tx = _operand(jnp, shape, "float32", 4)
    assert_bits_equal(stencil_ref(tx), ref.stencil_ref(jnp.asarray(x)), "stencil_ref")
    want = ref.stencil_step(jnp.asarray(x), interpret=True)
    assert_bits_equal(stencil_sweep(tx), want, "stencil_step(interpret)")
    assert_bits_equal(stencil_interior(tx), np.asarray(want)[1:-1, 1:-1], "interior")


def test_stencil_stack_and_bfloat16_match_reference(ref):
    jnp, assert_bits_equal = ref.jnp, ref.assert_bits_equal
    x, tx = _operand(jnp, (3, 40, 24), "float32", 5)
    got = stencil_sweep(tx)
    for p in range(3):
        assert_bits_equal(got[p], ref.stencil_ref(jnp.asarray(x[p])), f"tile {p}")
    xb, txb = _operand(jnp, (40, 24), "bfloat16", 6)
    assert_bits_equal(_bits(stencil_sweep(txb)),
                      _ref_bits(ref.stencil_ref(jnp.asarray(xb))), "bfloat16")


def test_stencil_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        stencil_sweep(torch.ones(5))
    with pytest.raises(ValueError, match="cuda or cpu"):
        stencil_sweep(torch.ones(4, 4, device="meta"))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A missing compiler is an error, never a silent switch to the plain
    version."""
    from repro_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(build, "NVCC_FALLBACK", str(tmp_path / "nvcc"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").rglob("*.so"))


def test_build_digest_follows_every_file_under_csrc(tmp_path):
    """An edit to a header the sources include (as ``hopper.cuh`` is by
    kernels D and E) changes the build's key, so a stale library is never
    loaded; an unchanged tree keeps its key."""
    from repro_torch.kernels import build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "hopper.cuh"\n')
    (csrc / "hopper.cuh").write_text("// v1\n")
    first = build._digest(csrc)
    assert build._digest(csrc) == first
    (csrc / "hopper.cuh").write_text("// v2\n")
    second = build._digest(csrc)
    assert second != first
    (csrc / "extra.cuh").write_text("// new\n")
    assert build._digest(csrc) not in (first, second)
    assert set(build.HEADERS) <= {p.name for p in build.CSRC.iterdir()}


def _chip_smoke():
    """``chip_smoke.py`` as a module (its top level imports the standard
    library only), for its case tables."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _matmul_cases():
    """(id, K, N, dtype, path) of every card case of kernel D: the cuda
    tests' and ``chip_smoke.py``'s."""
    from test_torch_matmul import CARD_CASES

    cases = [(f"test:{name}", xs[-1], ws[-1], dtype, path)
             for name, xs, ws, dtype, path in CARD_CASES]
    cases += [(f"chip_smoke:{name}", xs[-1], ws[-1], dtype, path)
              for name, xs, ws, dtype, _strided, path in _chip_smoke().MM_CASES]
    return cases


def _attention_cases():
    """(id, dtype, head dim) of every card case of kernel E: the cuda tests'
    and ``chip_smoke.py``'s."""
    from test_torch_flash_attention import CUDA_CASES

    cases = [(f"test:{name}", c[9], c[6]) for name, c in CUDA_CASES.items()]
    cases += [(f"chip_smoke:{c[0]}", getattr(torch, c[10]), c[7]) for c in _chip_smoke().FA_CASES]
    return cases


def _ssd_cases():
    """(id, dtype, Dh, Dst, chunk, path) of every card case of kernel F (the
    cuda tests' and ``chip_smoke.py``'s, each naming its path) and of the
    dims around mamba2's that go to the FMA kernel."""
    from test_torch_ssd import CUDA_CASES

    cases = [(f"test:{name}", c[6], c[2], c[3], c[5], c[7]) for name, c in CUDA_CASES.items()]
    cases += [(f"chip_smoke:{c[0]}", getattr(torch, c[7]), c[3], c[4], c[6], c[9])
              for c in _chip_smoke().SSD_CASES]
    cases += [(f"dims:{dtype}_{dh}_{dst}_{chunk}", getattr(torch, dtype), dh, dst, chunk, "fma")
              for dtype, dh, dst, chunk in [("bfloat16", 16, 128, 128), ("bfloat16", 64, 8, 128),
                                            ("float32", 16, 8, 64)]]
    return cases


@pytest.mark.parametrize("case", _matmul_cases(), ids=lambda c: c[0])
def test_matmul_dispatch_sends_card_cases_to_their_path(case):
    from repro_torch.kernels.matmul import matmul_path

    _, K, N, dtype, path = case
    dt = getattr(torch, dtype)
    assert matmul_path(K, N, dt) == path
    # the rule: bfloat16 whose K and N TMA can stride (16-byte rows)
    assert (path == "wgmma") == (dt == torch.bfloat16 and K % 8 == 0 and N % 8 == 0)


@pytest.mark.parametrize("case", _attention_cases(), ids=lambda c: c[0])
def test_attention_dispatch_sends_card_cases_to_their_path(case):
    from repro_torch.kernels.flash_attention import flash_attention_path

    _, dtype, D = case
    padded = next(d for d in (64, 128, 256) if d >= D)
    assert flash_attention_path(dtype, padded) == ("wgmma" if dtype == torch.bfloat16 else "fma")


@pytest.mark.parametrize("case", _ssd_cases(), ids=lambda c: c[0])
def test_ssd_dispatch_sends_card_cases_to_their_path(case):
    from repro_torch.kernels.ssd import ssd_path

    _, dtype, Dh, Dst, chunk, path = case
    assert ssd_path(dtype, Dh, Dst, chunk) == path


def test_attention_dispatch_refuses_what_no_kernel_takes():
    from repro_torch.kernels.flash_attention import flash_attention_path

    with pytest.raises(ValueError):
        flash_attention_path(torch.bfloat16, 512)
    with pytest.raises(ValueError):
        flash_attention_path(torch.float16, 128)


# -- on the card -------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.int32])
@pytest.mark.parametrize("n", [1, 1000, 257 * 129, (1 << 20) + 3])
def test_accumulate_kernel_matches_plain(n, dtype, cuda_device):
    g = torch.Generator(device="cpu").manual_seed(n)
    if dtype == torch.int32:
        a = torch.randint(-2**31, 2**31 - 1, (n,), generator=g, dtype=torch.int32)
        b = torch.randint(-2**31, 2**31 - 1, (n,), generator=g, dtype=torch.int32)
    else:
        a = (torch.randn(n, generator=g) * 100).to(dtype)
        b = (torch.randn(n, generator=g) * 100).to(dtype)
    a, b = a.to(cuda_device), b.to(cuda_device)
    before = fused_accumulate.launches
    got = fused_accumulate(a, b)
    torch.cuda.synchronize()
    assert fused_accumulate.launches == before + 1
    assert torch.equal(got.view(torch.uint8), accumulate_plain(a, b).view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 1), (37, 300), (3, 129, 257), (8, 512, 256)])
def test_stencil_kernel_matches_plain(shape, dtype, cuda_device):
    g = torch.Generator(device="cpu").manual_seed(7)
    x = torch.randn(shape, generator=g).to(dtype).to(cuda_device)
    before = stencil_sweep.launches
    got = stencil_sweep(x)
    torch.cuda.synchronize()
    assert stencil_sweep.launches == before + 1
    assert torch.equal(got.view(torch.uint8), stencil_sweep_plain(x).view(torch.uint8))


@pytest.mark.cuda
def test_kernels_refuse_bad_input_on_the_card(cuda_device):
    a = torch.ones(16, device=cuda_device)
    with pytest.raises(TypeError):
        fused_accumulate(a.double(), a.double())
    with pytest.raises(ValueError, match="contiguous"):
        fused_accumulate(a[::2], a[::2])
    with pytest.raises(TypeError):
        stencil_sweep(torch.ones(4, 4, dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        stencil_sweep(torch.ones(8, 8, device=cuda_device).t()[:, :4])
