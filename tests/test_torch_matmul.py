"""Kernel D (the overlap engine's per-chunk GEMM) and its entry point
against the reference.

On the CPU, the port's ``matmul`` runs its plain version
:func:`~repro_torch.kernels.matmul.matmul_ref`, which is held against the
reference's Pallas kernel in interpret mode (called outside ``shard_map``)
and against the reference's ``matmul_ref``, at the shapes of the
reference's own kernel test (ragged ones included).  Inputs are unit
normals from ``numpy.random.RandomState``.  Tolerances, as the reference's
test states them: float32 within 2e-5, bfloat16 within 2e-2.

The cases marked ``cuda`` hold kernel D against its plain version on the
card, at the shapes the yi-6b tensor-parallel prefill gives it, and skip
where there is none.  Their tolerance is relative to the largest magnitude
of the plain result: 2e-5 in float32, 2e-2 in bfloat16 (one rounding of the
float32 sum to bfloat16 is 2**-8 of a value).  The reference (JAX) is
imported only in the CPU cases, so on a machine with a card and no JAX they
run alone:

    python -m pytest --noconftest -m cuda tests/test_torch_matmul.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels.matmul import matmul, matmul_ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: the reference's kernel-test shapes (M, K, N), the ragged one included
SHAPES = [(128, 128, 128), (256, 384, 128), (100, 70, 50), (8, 512, 8)]


@pytest.fixture
def ref():
    """The reference's matmul (imports JAX)."""
    import jax.numpy as jnp

    from repro.kernels.matmul import matmul as ref_matmul
    from repro.kernels.matmul import matmul_ref as ref_matmul_ref

    return SimpleNamespace(jnp=jnp, matmul=ref_matmul, matmul_ref=ref_matmul_ref)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel D has no CPU mode)")
    return torch.device("cuda", 0)


def _randn(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _f32(t) -> np.ndarray:
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor) else t, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_plain_matches_reference(ref, M, K, N, dtype):
    x, w = _randn((M, K), 0), _randn((K, N), 1)
    jdt = getattr(ref.jnp, dtype)
    xj, wj = ref.jnp.asarray(x, jdt), ref.jnp.asarray(w, jdt)
    got = matmul(torch.from_numpy(x).to(getattr(torch, dtype)),
                 torch.from_numpy(w).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (M, N)
    for want in (ref.matmul(xj, wj, interpret=True), ref.matmul_ref(xj, wj)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_and_out_dtype_match_reference(ref, dtype):
    """A leading batch dimension is one 2-D product per entry; a shared 2-D
    weight serves every entry; ``out_dtype`` picks the result's type."""
    x, w = _randn((3, 40, 70), 2), _randn((3, 70, 24), 3)
    tdt, jdt = getattr(torch, dtype), getattr(ref.jnp, dtype)
    xt, wt = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    got = matmul(xt, wt)
    assert tuple(got.shape) == (3, 40, 24)
    for b in range(3):
        want = ref.matmul(ref.jnp.asarray(x[b], jdt), ref.jnp.asarray(w[b], jdt),
                          interpret=True)
        np.testing.assert_allclose(_f32(got[b]), _f32(want), rtol=TOL[dtype], atol=TOL[dtype])
    shared = matmul(xt, wt[1])
    np.testing.assert_array_equal(_f32(shared[1]), _f32(got[1]))
    out32 = matmul(xt, wt, out_dtype=torch.float32)
    want32 = ref.matmul(ref.jnp.asarray(x[0], jdt), ref.jnp.asarray(w[0], jdt),
                        out_dtype=ref.jnp.float32, interpret=True)
    assert out32.dtype == torch.float32
    np.testing.assert_allclose(_f32(out32[0]), _f32(want32), rtol=2e-5, atol=2e-5)


def test_use_kernel_on_cpu_raises():
    x = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="no CPU mode"):
        matmul(x, x, use_kernel=True)
    before = matmul.launches
    assert torch.equal(matmul(x, x, use_kernel=False), x)
    assert torch.equal(matmul(x, x), x) and matmul.launches == before


# -- kernel D on the card -------------------------------------------------------------

#: (name, x shape, w shape, dtype, path): the yi-6b TP prefill's ring steps
#: at P = 8 (512 rows a rank; Q, MLP-up with the ragged N = 1376, MLP-down
#: with the ragged K = 1376, the out-projection), float32 ones, a 2-D call, a
#: shared weight, the reference's ragged shape, and edges inside a tile; the
#: path is the kernel ``matmul_path`` sends them to (bfloat16 with K and N
#: multiples of 8 on wgmma, the rest on mma.sync)
CARD_CASES = [
    ("q_bf16", (8, 512, 4096), (8, 4096, 512), "bfloat16", "wgmma"),
    ("mlp_up_bf16", (8, 512, 4096), (8, 4096, 1376), "bfloat16", "wgmma"),
    ("mlp_down_bf16", (8, 512, 1376), (8, 1376, 4096), "bfloat16", "wgmma"),
    ("out_bf16", (8, 512, 512), (8, 512, 4096), "bfloat16", "wgmma"),
    ("mlp_up_f32", (8, 512, 1024), (8, 1024, 1376), "float32", "mma_sync"),
    ("ragged_2d_f32", (100, 70), (70, 50), "float32", "mma_sync"),
    ("ragged_2d_bf16", (100, 70), (70, 50), "bfloat16", "mma_sync"),
    ("odd_k_bf16", (3, 65, 131), (3, 131, 33), "bfloat16", "mma_sync"),
    ("shared_w_bf16", (4, 256, 512), (512, 384), "bfloat16", "wgmma"),
    ("m_n_edges_bf16", (3, 100, 72), (3, 72, 40), "bfloat16", "wgmma"),
    ("edges_2d_bf16", (1000, 136), (136, 336), "bfloat16", "wgmma"),
    # slice 10's ring steps at P = 8: recurrentgemma-9b's MLP-up and down
    # (its ssm.in and ssm.out are q_bf16's and out_bf16's shapes),
    # internvl2-1b's MLP-up (the ragged N = 608) and Q (N = 128, 14 heads
    # padded to 16), musicgen-medium's Q (N = 192) and out-projection (K = 192)
    ("rg_mlp_up_bf16", (8, 512, 4096), (8, 4096, 1536), "bfloat16", "wgmma"),
    ("rg_mlp_down_bf16", (8, 512, 1536), (8, 1536, 4096), "bfloat16", "wgmma"),
    ("vlm_mlp_up_bf16", (8, 512, 896), (8, 896, 608), "bfloat16", "wgmma"),
    ("vlm_q_bf16", (8, 512, 896), (8, 896, 128), "bfloat16", "wgmma"),
    ("audio_q_bf16", (8, 512, 1536), (8, 1536, 192), "bfloat16", "wgmma"),
    ("audio_out_bf16", (8, 512, 192), (8, 192, 1536), "bfloat16", "wgmma"),
]


def _card_close(got, want, dtype):
    torch.cuda.synchronize()
    mag = float(want.abs().max())
    err = float((got.double() - want.double()).abs().max())
    assert torch.isfinite(got).all() and err <= TOL[dtype] * mag, (err, mag)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_kernel_matches_plain_on_card(cuda_device, case):
    """Each output dtype; the case's path takes the launch (the wgmma
    counter moves for exactly the wgmma cases)."""
    _, xs, ws, dtype, path = case
    g = torch.Generator(device=cuda_device).manual_seed(16)
    dt = getattr(torch, dtype)
    x = torch.randn(xs, generator=g, device=cuda_device).to(dt)
    w = torch.randn(ws, generator=g, device=cuda_device).to(dt)
    before, before_wg = matmul.launches, matmul.wgmma_launches
    got = matmul(x, w)
    assert matmul.launches == before + 1 and got.dtype == dt
    assert matmul.wgmma_launches == before_wg + (path == "wgmma")
    _card_close(got, matmul_ref(x, w), dtype)
    got32 = matmul(x, w, out_dtype=torch.float32)
    _card_close(got32, matmul_ref(x, w, out_dtype=torch.float32), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
def test_wgmma_grids_agree_on_card(cuda_device, out_dtype):
    """The wgmma path's two grids (persistent, one CTA a tile) give the same
    bits, at the MLP-up ring step, whose N = 1376 ends inside a tile."""
    from repro_torch.kernels.matmul.kernel import launch_matmul

    g = torch.Generator(device=cuda_device).manual_seed(18)
    x = torch.randn((8, 512, 4096), generator=g, device=cuda_device).to(torch.bfloat16)
    w = torch.randn((8, 4096, 1376), generator=g, device=cuda_device).to(torch.bfloat16)
    od = getattr(torch, out_dtype)
    outs = []
    for persistent in (True, False):
        out = torch.full((8, 512, 1376), float("nan"), dtype=od, device=cuda_device)
        assert launch_matmul(x, w, out, persistent=persistent) == "wgmma"
        outs.append(out)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    _card_close(outs[1], matmul_ref(x, w, out_dtype=od), "bfloat16")


@pytest.mark.cuda
def test_kernel_takes_strided_batches_on_card(cuda_device):
    """Operands that are views (every other rank row of a ring buffer, a
    transposed weight) give what their contiguous copies give."""
    g = torch.Generator(device=cuda_device).manual_seed(17)
    buf = torch.randn((16, 512, 1024), generator=g, device=cuda_device).to(torch.bfloat16)
    wt = torch.randn((8, 1376, 1024), generator=g, device=cuda_device).to(torch.bfloat16)
    x, w = buf[::2], wt.transpose(1, 2)
    assert not x.is_contiguous() and not w.is_contiguous()
    got = matmul(x, w)
    assert torch.equal(got, matmul(x.contiguous(), w.contiguous()))
    _card_close(got, matmul_ref(x, w), "bfloat16")


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros((4, 8), device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        matmul(x, x.T)
    with pytest.raises(ValueError):
        matmul(torch.zeros((2, 4, 8), device=cuda_device), torch.zeros((3, 8, 4),
                                                                       device=cuda_device))
