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
