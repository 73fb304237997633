"""Kernel F (the SSD chunked scan) and the SSD entry points against the
reference.

On the CPU, :func:`ssd_scan_plain` (what kernel F's wrapper runs on a CPU
tensor) is held against the Pallas kernel ``ssd_pallas`` in interpret mode,
called outside ``shard_map``, and against the reference's chunked CPU
dispatch ``_ssd_chunked_jnp``, within 2e-5; both, and the port's
sequential ``ssd_ref``, against the reference's ``ssd_ref`` within 2e-4 (the
chunked and the sequential forms sum in different orders).  Inputs follow
the reference's own tests: x, B and C ``0.5 * randn``, dt uniform in
[0.05, 0.55), A ``-exp(0.3 * randn)``, from ``numpy.random.RandomState``.
bfloat16 inputs (float32 arithmetic, a bfloat16 output) are held within
1.6e-2 of the largest reference magnitude, two bfloat16 steps.

Kernel F's bfloat16 path on the card (``ssd_path`` -> ``"wgmma"``) computes
the scan in another decomposition: dt folded into the scores and the state
weights, the scores split into two bf16 parts, and bf16 roundings of the
weighted x and the state's copy.  :func:`_emulate_wgmma`, test-only,
computes that decomposition in plain PyTorch; on the CPU it is held against
``ssd_scan_plain`` (float32, no rounding: within 1e-4) and, rounded as the
kernel rounds, against the reference's ``_ssd_chunked_jnp`` and
``ssd_pallas`` in interpret mode within 1.6e-2.  A second gate,
``ROUNDING_LIMIT``, sees the scores' precision, which 1.6e-2 cannot.

The cases marked ``cuda`` hold kernel F against the plain version on the
card and skip where there is none; each asserts the path its case names
through the counters.  The reference (JAX) is imported only in the CPU cases, so on a
machine with a card and no JAX they run alone:

    python -m pytest --noconftest -m cuda tests/test_torch_ssd.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels.common import pad_to
from repro_torch.kernels.ssd import (
    ssd_decode_step,
    ssd_path,
    ssd_ref,
    ssd_scan,
    ssd_scan_kernel,
    ssd_scan_plain,
)

TOL = {"float32": 2e-5, "bfloat16": 1.6e-2}


@pytest.fixture
def ref():
    """The reference's SSD functions (imports JAX)."""
    import jax.numpy as jnp

    from repro.kernels.ssd import ssd_decode_step as ref_decode_step
    from repro.kernels.ssd import ssd_ref as ref_ssd_ref
    from repro.kernels.ssd import ssd_scan as ref_ssd_scan
    from repro.kernels.ssd.ops import _ssd_chunked_jnp

    return SimpleNamespace(jnp=jnp, scan=ref_ssd_scan, chunked=_ssd_chunked_jnp,
                           seq=ref_ssd_ref, decode_step=ref_decode_step)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel F has no CPU mode)")
    return torch.device("cuda", 0)


def _inputs(BH, S, Dh, Dst, seed, G=None):
    """x, dt, B, C, A as float32 numpy arrays; B and C have ``G`` rows
    (``BH`` unless named)."""
    rng = np.random.RandomState(seed)
    G = BH if G is None else G
    x = rng.randn(BH, S, Dh) * 0.5
    dt = rng.rand(BH, S) * 0.5 + 0.05
    B = rng.randn(G, S, Dst) * 0.5
    C = rng.randn(G, S, Dst) * 0.5
    A = -np.exp(rng.randn(BH, 1) * 0.3)
    return [a.astype(np.float32) for a in (x, dt, B, C, A)]


def _torch(arrays, dtype="float32"):
    return [torch.from_numpy(a.copy()).to(getattr(torch, dtype)) for a in arrays]


def _jax(ref, arrays, dtype="float32"):
    return [ref.jnp.asarray(a, getattr(ref.jnp, dtype)) for a in arrays]


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want).astype(np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max abs err {err} > {tol} * {scale}"


# (BH, S, Dh, Dst, chunk): the reference's test shapes (tests/test_kernels.py),
# S = 200 at chunk 64 pads; then mamba2's head and state dims
SCAN_CASES = {
    "s128_c64": (4, 128, 16, 8, 64),
    "s256_c128": (4, 256, 16, 8, 128),
    "s200_c64_pads": (4, 200, 16, 8, 64),
    "s192_c64": (2, 192, 8, 4, 64),
    "mamba2_dims_s300": (2, 300, 64, 128, 128),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_plain_matches_pallas_interpret_and_chunked(ref, case, dtype):
    BH, S, Dh, Dst, chunk = SCAN_CASES[case]
    arrays = _inputs(BH, S, Dh, Dst, 5)
    want = ref.scan(*_jax(ref, arrays, dtype), chunk=chunk, interpret=True)
    got = ssd_scan_plain(*_torch(arrays, dtype), chunk=chunk)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (BH, S, Dh)
    _close(got, want, TOL[dtype])
    _close(got, ref.chunked(*_jax(ref, arrays, dtype), chunk=chunk), TOL[dtype])
    # the CPU dispatch of the entry point is the plain version
    assert torch.equal(ssd_scan(*_torch(arrays, dtype), chunk=chunk), got)


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_scan_matches_sequential_reference(ref, case):
    BH, S, Dh, Dst, chunk = SCAN_CASES[case]
    arrays = _inputs(BH, S, Dh, Dst, 6)
    want = ref.seq(*_jax(ref, arrays))
    _close(ssd_scan(*_torch(arrays), chunk=chunk), want, 2e-4)
    _close(ssd_ref(*_torch(arrays)), want, 1e-5)


def test_kernel_wrapper_on_cpu_is_the_plain_version():
    arrays = _torch(_inputs(4, 256, 16, 8, 7))
    before = ssd_scan_kernel.launches
    assert torch.equal(ssd_scan_kernel(*arrays, chunk=128), ssd_scan_plain(*arrays, chunk=128))
    assert ssd_scan_kernel.launches == before


@pytest.mark.parametrize("G", [1, 2])
def test_shared_rows_equal_the_broadcast_layout(G):
    """B and C as ``G`` rows shared by ``BH // G`` heads compute what the
    reference's layout (each row copied to every head) computes."""
    x, dt, B, C, A = _torch(_inputs(6, 200, 16, 8, 8, G=G))
    rep = 6 // G
    got = ssd_scan(x, dt, B, C, A, chunk=64)
    want = ssd_scan(x, dt, B.repeat_interleave(rep, 0), C.repeat_interleave(rep, 0), A, chunk=64)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_strong_decay_stays_finite():
    """dt * |A| of 25 a step: within a chunk cum falls to -3200, so the
    masked exponents above the diagonal would overflow; they are selected
    away before the exp and the result is finite and equal to the
    sequential recurrence."""
    x, dt, B, C, A = _torch(_inputs(2, 256, 8, 4, 9))
    dt, A = torch.full_like(dt, 5.0), torch.full_like(A, -5.0)
    got = ssd_scan(x, dt, B, C, A, chunk=128)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ssd_ref(x, dt, B, C, A), atol=1e-5, rtol=1e-5)


def test_decode_step_matches_reference(ref):
    rng = np.random.RandomState(10)
    BH, Dst, Dh = 6, 8, 16
    h = rng.randn(BH, Dst, Dh).astype(np.float32)
    xt = rng.randn(BH, Dh).astype(np.float32)
    dtt = (rng.rand(BH) * 0.5 + 0.05).astype(np.float32)
    Bt, Ct = (rng.randn(BH, Dst).astype(np.float32) for _ in range(2))
    A = -np.exp(rng.randn(BH, 1) * 0.3).astype(np.float32)
    arrays = (h, xt, dtt, Bt, Ct, A)
    want_h, want_y = ref.decode_step(*_jax(ref, arrays))
    got_h, got_y = ssd_decode_step(*_torch(arrays))
    assert got_h.dtype == torch.float32 and got_y.dtype == torch.float32
    _close(got_h, want_h, 1e-5)
    _close(got_y, want_y, 1e-5)


def test_decode_steps_reproduce_the_scan():
    """Decoding token by token carries the state as the scan does: every
    step's output equals the scan's row, the padded tail included."""
    x, dt, B, C, A = _torch(_inputs(2, 70, 8, 4, 11))
    want = ssd_scan(x, dt, B, C, A, chunk=64)
    h = torch.zeros((2, 4, 8))
    ys = []
    for t in range(70):
        h, y = ssd_decode_step(h, x[:, t], dt[:, t], B[:, t], C[:, t], A)
        ys.append(y)
    torch.testing.assert_close(torch.stack(ys, dim=1), want, atol=2e-4, rtol=0)


def test_use_kernel_on_cpu_raises():
    arrays = _torch(_inputs(2, 64, 8, 4, 12))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan(*arrays, use_kernel=True)


@pytest.mark.parametrize("bad", ["ragged_s", "groups", "A", "dt"])
def test_kernel_wrapper_rejects_bad_shapes(bad):
    x, dt, B, C, A = _torch(_inputs(4, 128, 8, 4, 13))
    if bad == "ragged_s":
        x, dt, B, C = x[:, :100], dt[:, :100], B[:, :100], C[:, :100]
    elif bad == "groups":
        B, C = B[:3], C[:3]
    elif bad == "A":
        A = A[:2]
    else:
        dt = dt[:, :64]
    with pytest.raises(ValueError):
        ssd_scan_kernel(x, dt, B, C, A, chunk=128)


# -- the wgmma path: dispatch, and its decomposition emulated on the CPU ---------


@pytest.mark.parametrize("bad", [(torch.float16, 64, 128, 128), (torch.bfloat16, 128, 128, 128),
                                 (torch.bfloat16, 64, 256, 128), (torch.bfloat16, 64, 128, 256)])
def test_ssd_path_refuses_what_no_kernel_takes(bad):
    with pytest.raises(ValueError):
        ssd_path(*bad)


def _emulate_wgmma(x, dt, B, C, A, *, L=128, rounded=True, split=True):
    """Kernel F's wgmma path in plain PyTorch, float32 inside: x ``(BH, S,
    Dh)``, dt ``(BH, S)``, B/C ``(G, S, Dst)``, A ``(BH, 1)``, ``S`` a
    multiple of ``L``.  Each head row's chunks are walked in order from a
    zero state; dt is folded into the scores' columns and the state
    weights.  ``rounded`` rounds the weighted x and the state's copy for
    ``C . h`` to bfloat16 as the kernel does (the carried state stays
    float32) and the scores to two bfloat16 parts (hi + lo), or to one
    with ``split=False``.  Returns y in x's dtype."""
    BH, S, Dh = x.shape
    G, Dst = B.shape[0], B.shape[-1]
    n = S // L
    rnd = (lambda t: t.to(torch.bfloat16).float()) if rounded else (lambda t: t)
    parts = (lambda t: rnd(t) + rnd(t - rnd(t))) if split else rnd
    xf = x.float().reshape(BH, n, L, Dh)
    Bf = B.float().repeat_interleave(BH // G, 0).reshape(BH, n, L, Dst)
    Cf = C.float().repeat_interleave(BH // G, 0).reshape(BH, n, L, Dst)
    dtf = dt.float().reshape(BH, n, L)
    cum = torch.cumsum(dtf * A.float().reshape(BH, 1, 1), dim=-1)   # (BH, n, L)
    last = cum[..., -1:]
    wd = torch.exp(last - cum) * dtf                                 # the state weights
    el = torch.exp(last)[..., None]                                  # (BH, n, 1, 1)
    tri = torch.ones((L, L), dtype=torch.bool).tril()
    decay = torch.exp(torch.where(tri, cum[..., :, None] - cum[..., None, :], float("-inf")))
    scores = parts((Cf @ Bf.transpose(-1, -2)) * decay * dtf[..., None, :])
    upd = Bf.transpose(-1, -2) @ rnd(xf * wd[..., None])             # (BH, n, Dst, Dh)
    y = torch.empty((BH, n, L, Dh))
    h = torch.zeros((BH, Dst, Dh))
    for c in range(n):
        y[:, c] = torch.exp(cum[:, c])[..., None] * (Cf[:, c] @ rnd(h)) \
            + scores[:, c] @ xf[:, c]
        h = el[:, c] * h + upd[:, c]
    return y.reshape(BH, S, Dh).to(x.dtype)


def _emulate_padded(x, dt, B, C, A, **kw):
    """:func:`_emulate_wgmma` behind the entry point's padding of S."""
    S = x.shape[1]
    x, dt, B, C = (pad_to(t, 128, 1)[0] for t in (x, dt, B, C))
    return _emulate_wgmma(x, dt, B, C, A, **kw)[:, :S]


# (BH, S, Dh, Dst, G): one chunk; five chunks; a ragged S the entry point
# pads; twenty chunks; mamba2's dims on the first two, B and C shared by all
# heads (G = 1) or two groups
EMU_CASES = {
    "one_chunk": (4, 128, 64, 128, 1),
    "s640_five_chunks": (4, 640, 64, 128, 1),
    "s1000_pads_g2": (4, 1000, 16, 8, 2),
    "s2560_twenty_chunks": (2, 2560, 16, 8, 1),
}


@pytest.mark.parametrize("case", sorted(EMU_CASES))
def test_wgmma_decomposition_equals_plain_in_float32(case):
    """The walk with dt in the weights computes the plain chunked scan:
    unrounded, within the float32 gate."""
    BH, S, Dh, Dst, G = EMU_CASES[case]
    arrays = _torch(_inputs(BH, S, Dh, Dst, 21, G=G))
    got = _emulate_padded(*arrays, rounded=False)
    want = ssd_scan(*arrays, chunk=128)
    _close(got, want.numpy(), 1e-4)


@pytest.mark.parametrize("case", sorted(EMU_CASES))
def test_wgmma_emulation_matches_reference_in_bfloat16(ref, case):
    """Rounded as the kernel rounds, on bfloat16 inputs: within the bfloat16
    gate of the plain scan and of the reference's chunked form and Pallas
    kernel (interpret mode; the reference takes B and C per head)."""
    BH, S, Dh, Dst, G = EMU_CASES[case]
    arrays = _inputs(BH, S, Dh, Dst, 22, G=G)
    got = _emulate_padded(*_torch(arrays, "bfloat16"))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (BH, S, Dh)
    _close(got, ssd_scan(*_torch(arrays, "bfloat16"), chunk=128).float().numpy(), TOL["bfloat16"])
    x, dt, B, C, A = arrays
    jarrays = _jax(ref, [x, dt, np.repeat(B, BH // G, 0), np.repeat(C, BH // G, 0), A], "bfloat16")
    _close(got, ref.chunked(*jarrays, chunk=128), TOL["bfloat16"])
    _close(got, ref.scan(*jarrays, chunk=128, interpret=True), TOL["bfloat16"])


def test_wgmma_emulation_strong_decay_stays_finite():
    """dt * |A| of 25 a step: the chunk decays underflow to 0 and the
    masked exponents would overflow; the emulation, rounded, stays finite
    and within the bfloat16 gate of the sequential recurrence."""
    x, dt, B, C, A = _torch(_inputs(2, 640, 16, 8, 23, G=1))
    dt, A = torch.full_like(dt, 5.0), torch.full_like(A, -5.0)
    got = _emulate_wgmma(*(t.to(torch.bfloat16) for t in (x, dt, B, C, A)))
    assert torch.isfinite(got.float()).all()
    want = ssd_ref(x, dt, B.repeat(2, 1, 1), C.repeat(2, 1, 1), A)
    _close(got, want.numpy(), TOL["bfloat16"])


@pytest.mark.parametrize("bad", ["strided_x", "bf16_dt", "A_column", "misaligned_B", "ragged_s",
                                 "small_dh"])
def test_launch_refuses_what_is_not_the_kernel_layout(bad):
    """The kernels read raw pointers (the wgmma one through tensor maps of
    dense strides): any other layout raises before a launch."""
    from repro_torch.kernels.ssd.kernel import launch_ssd_scan

    x, dt, B, C, A = _torch(_inputs(4, 256, 64, 128, 25, G=1), "bfloat16")
    dt, A = dt.float(), A.float().reshape(-1)
    if bad == "strided_x":
        x = torch.zeros((4, 256, 128), dtype=x.dtype)[..., :64]
    elif bad == "bf16_dt":
        dt = dt.to(torch.bfloat16)
    elif bad == "A_column":
        A = A.reshape(-1, 1)
    elif bad == "misaligned_B":
        B = torch.zeros(B.numel() + 1, dtype=B.dtype)[1:].reshape(B.shape)
    elif bad == "ragged_s":
        x, dt, B, C = x[:, :200].contiguous(), dt[:, :200].contiguous(), B[:, :200].contiguous(), \
            C[:, :200].contiguous()
    else:
        x = x[..., :16].contiguous()
    with pytest.raises(ValueError):
        launch_ssd_scan(x, dt, B, C, A, torch.empty_like(x), chunk=128, path="wgmma")


# -- the scores' precision: what the 1.6e-2 gate cannot see --------------------
#
# The kernel and the plain version both compute in float32 and round y once
# to bfloat16.  Where the kernel's products keep the float32 sums (the scores
# split into two bf16 parts), the two round nearly every element alike; one
# bf16 rounding of the scores moves about a third of the elements by an ulp.
# Either stays well inside 1.6e-2 of the largest magnitude, but mamba2's
# per-layer output (a group norm amplifies small rows) fell from a row cosine
# of 0.9999 to 0.9988.  So the mean over rows of |y - y_plain| / |y_plain|,
# both bfloat16, is gated at ROUNDING_LIMIT: with dt in mamba2's range
# [0.01, 3.7) and A = -1 the emulation reads ~3e-5 split and ~2.6e-3 with
# one rounding.
ROUNDING_LIMIT = 1e-3


def _layer_range_inputs(BH=8, S=512, seed=24):
    """bfloat16 x, dt, B, C, A at mamba2's dims: dt uniform in [0.01, 3.7),
    the range of a mamba2-2.7b layer's dt, A = -1, B and C one row (G = 1)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(BH, S, 64) * 0.5
    dt = 0.01 + rng.rand(BH, S) * 3.69
    B, C = (rng.randn(1, S, 128) * 0.5 for _ in range(2))
    return _torch([a.astype(np.float32) for a in (x, dt, B, C, -np.ones((BH, 1)))], "bfloat16")


def _mean_row_rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    return float(((got - want).norm(dim=-1) / want.norm(dim=-1)).mean())


@pytest.mark.parametrize("split", [True, False], ids=["hi_lo", "one_rounding"])
def test_rounding_gate_separates_split_scores_from_one_rounding(split):
    """The emulation with the kernel's hi + lo scores passes the gate; with
    the scores rounded once it fails it, so the gate sees that defect."""
    arrays = _layer_range_inputs()
    reading = _mean_row_rel_err(_emulate_wgmma(*arrays, split=split), ssd_scan_plain(*arrays))
    assert (reading <= ROUNDING_LIMIT) == split, reading


# -- on the card: kernel F against its plain version ---------------------------

CUDA_CASES = {
    # (BH, S, Dh, Dst, G, chunk, dtype, path)
    "f32_mamba2_dims": (16, 1024, 64, 128, 16, 128, torch.float32, "fma"),
    "f32_shared_rows": (16, 512, 64, 128, 2, 128, torch.float32, "fma"),
    "bf16_shared_rows": (80, 1024, 64, 128, 1, 128, torch.bfloat16, "wgmma"),
    "f32_chunk64_small_dims": (4, 256, 16, 8, 4, 64, torch.float32, "fma"),
    "bf16_chunk64": (8, 512, 64, 128, 8, 64, torch.bfloat16, "fma"),
    "bf16_prefill_shape": (80, 4096, 64, 128, 1, 128, torch.bfloat16, "wgmma"),
    "bf16_shared_rows_g2": (16, 1024, 64, 128, 2, 128, torch.bfloat16, "wgmma"),
    "bf16_one_chunk": (8, 128, 64, 128, 1, 128, torch.bfloat16, "wgmma"),
    "bf16_s640_five_chunks": (8, 640, 64, 128, 2, 128, torch.bfloat16, "wgmma"),
    "bf16_small_dims": (4, 512, 16, 8, 4, 128, torch.bfloat16, "fma"),
    "bf16_40_heads": (40, 4096, 64, 128, 1, 128, torch.bfloat16, "wgmma"),
}


def _card_inputs(dev, BH, S, Dh, Dst, G, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((BH, S, Dh), generator=g, device=dev) * 0.5
    dt = torch.rand((BH, S), generator=g, device=dev) * 0.5 + 0.05
    B, C = (torch.randn((G, S, Dst), generator=g, device=dev) * 0.5 for _ in range(2))
    A = -torch.exp(torch.randn((BH, 1), generator=g, device=dev) * 0.3)
    return [t.to(dtype) for t in (x, dt, B, C, A)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_kernel_matches_plain_on_card(cuda_device, case):
    BH, S, Dh, Dst, G, chunk, dtype, path = CUDA_CASES[case]
    arrays = _card_inputs(cuda_device, BH, S, Dh, Dst, G, dtype, 14)
    before, before_wgmma = ssd_scan_kernel.launches, ssd_scan_kernel.wgmma_launches
    got = ssd_scan_kernel(*arrays, chunk=chunk)
    want = ssd_scan_plain(*arrays, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan_kernel.launches == before + 1
    assert ssd_scan_kernel.wgmma_launches == before_wgmma + (path == "wgmma")
    assert got.dtype == dtype and tuple(got.shape) == (BH, S, Dh) and torch.isfinite(got).all()
    tol = 1e-4 if dtype == torch.float32 else 1.6e-2
    assert float((got.float() - want.float()).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.cuda
def test_wgmma_rounding_matches_plain_on_card(cuda_device):
    """The wgmma path keeps the scores' float32 sums: on the layer-range
    inputs it rounds y as the plain version does, within ROUNDING_LIMIT."""
    arrays = [t.to(cuda_device) for t in _layer_range_inputs()]
    before = ssd_scan_kernel.wgmma_launches
    got = ssd_scan_kernel(*arrays)
    want = ssd_scan_plain(*arrays)
    torch.cuda.synchronize()
    assert ssd_scan_kernel.wgmma_launches == before + 1
    reading = _mean_row_rel_err(got, want)
    assert reading <= ROUNDING_LIMIT, reading


@pytest.mark.cuda
def test_entry_point_pads_and_matches_sequential_on_card(cuda_device):
    x, dt, B, C, A = _card_inputs(cuda_device, 4, 200, 16, 8, 4, torch.float32, 15)
    before = ssd_scan_kernel.launches
    got = ssd_scan(x, dt, B, C, A, chunk=64)
    want = ssd_ref(x, dt, B, C, A)
    torch.cuda.synchronize()
    assert ssd_scan_kernel.launches == before + 1 and tuple(got.shape) == (4, 200, 16)
    assert float((got - want).abs().max()) <= 2e-4 * float(want.abs().max())
