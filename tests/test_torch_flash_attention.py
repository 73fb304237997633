"""Kernel E and the flash-attention entry point against the reference.

On the CPU, :func:`flash_attention_plain` (what kernel E's wrapper runs on a
CPU tensor) is held against the Pallas kernel ``flash_attention_pallas`` in
interpret mode, called outside ``shard_map``; the port's ``flash_attention``
CPU dispatch is held against the reference's non-Pallas dispatch, the
chunked branch above ``2048**2`` included.  Inputs are unit normals from
``numpy.random.RandomState``.  Tolerances: float32 within 1e-5 (the two sum
the same terms in another order); bfloat16 inputs, float32 arithmetic, a
bfloat16 output: within 1.6e-2, two bfloat16 steps at unit scale.

The cases marked ``cuda`` hold kernel E against the plain version on the
card and skip where there is none.  The reference (JAX) is imported only in
the CPU cases, so on a machine with a card and no JAX they run alone:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_attention.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_kernel,
    flash_attention_plain,
)

TOL = {"float32": 1e-5, "bfloat16": 1.6e-2}


@pytest.fixture
def ref():
    """The reference's flash attention (imports JAX)."""
    import jax.numpy as jnp

    from repro.kernels.flash_attention import flash_attention as ref_flash_attention
    from repro.kernels.flash_attention.kernel import flash_attention_pallas

    return SimpleNamespace(jnp=jnp, flash_attention=ref_flash_attention,
                           pallas=flash_attention_pallas)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel E has no CPU mode)")
    return torch.device("cuda", 0)


def _randn(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _to_torch(a: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(a.copy()).to(getattr(torch, dtype))


def _to_jax(jnp, a: np.ndarray, dtype: str):
    return jnp.asarray(a, getattr(jnp, dtype))


def _as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


# (B, H, Hkv, Sq, Skv, D, causal, window): the padded kernel layout is
# (B*H, Sq, D); Sq and Skv get padded to the 128 blocks, Skv is skv_actual
KERNEL_CASES = {
    "causal": (1, 2, 2, 128, 128, 16, True, None),
    "noncausal": (2, 2, 2, 128, 128, 16, False, None),
    "window": (1, 2, 2, 256, 256, 16, True, 48),
    "window_noncausal": (1, 2, 2, 128, 128, 64, False, 40),
    "gqa_4_2": (2, 4, 2, 128, 128, 16, True, None),
    "gqa_8_1": (1, 8, 1, 128, 128, 64, True, None),
    "ragged_40": (1, 4, 2, 40, 40, 16, True, None),
    "ragged_130": (2, 2, 1, 130, 130, 64, True, None),
    "sq_ne_skv": (1, 2, 2, 128, 256, 16, True, None),
    "sq_ne_skv_ragged": (1, 4, 2, 40, 130, 16, False, None),
}


def _padded(B, H, Sq, D, seed, block=128):
    S = -(-Sq // block) * block
    a = np.zeros((B * H, S, D), np.float32)
    a[:, :Sq] = _randn((B * H, Sq, D), seed)
    return a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_plain_matches_pallas_interpret(ref, case, dtype):
    B, H, Hkv, Sq, Skv, D, causal, window = KERNEL_CASES[case]
    q = _padded(B, H, Sq, D, 1)
    k = _padded(B, Hkv, Skv, D, 2)
    v = _padded(B, Hkv, Skv, D, 3)
    kw = dict(n_q_heads=H, n_kv_heads=Hkv, scale=D ** -0.5, causal=causal, window=window,
              skv_actual=Skv)
    want = ref.pallas(*(_to_jax(ref.jnp, a, dtype) for a in (q, k, v)), interpret=True, **kw)
    got = flash_attention_plain(*(_to_torch(a, dtype) for a in (q, k, v)), **kw)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == q.shape
    # padded query rows are finite and compared too: the wrapper trims them
    np.testing.assert_allclose(_as_f32(got), _as_f32(want), atol=TOL[dtype], rtol=0)
    # on CPU tensors the kernel's wrapper is the plain version
    same = flash_attention_kernel(*(_to_torch(a, dtype) for a in (q, k, v)), **kw)
    assert torch.equal(same, got)


def test_kernel_positions_are_left_aligned(ref):
    """With Sq != Skv the kernel counts query positions from 0, not from
    Skv - Sq as the refs do: query 0 sees key 0 alone, causally."""
    q = _padded(1, 1, 128, 16, 4)
    k = _padded(1, 1, 256, 16, 5)
    v = _padded(1, 1, 256, 16, 6)
    got = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), n_q_heads=1,
                                n_kv_heads=1, scale=0.25, causal=True)
    np.testing.assert_allclose(got[0, 0].numpy(), v[0, 0], atol=1e-6)


# (B, Sq, Skv, H, Hkv, D, causal, window) in the (B, S, H, D) layout
DISPATCH_CASES = {
    "causal": (2, 64, 64, 4, 2, 16, True, None),
    "noncausal_gqa": (1, 96, 96, 8, 1, 16, False, None),
    "window": (1, 80, 80, 4, 4, 16, True, 24),
    "decode_shape": (2, 8, 72, 4, 2, 16, True, None),
    "chunked_causal": (1, 2100, 2100, 2, 1, 16, True, None),
    "chunked_window": (1, 2100, 2100, 2, 2, 16, True, 600),
}


@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
def test_cpu_dispatch_matches_reference(ref, case):
    B, Sq, Skv, H, Hkv, D, causal, window = DISPATCH_CASES[case]
    q, k, v = (_randn(s, i) for i, s in enumerate(((B, Sq, H, D), (B, Skv, Hkv, D),
                                                    (B, Skv, Hkv, D))))
    want = ref.flash_attention(*(ref.jnp.asarray(a) for a in (q, k, v)), causal=causal,
                               window=window, use_pallas=False)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                          window=window)
    assert tuple(got.shape) == (B, Sq, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_model_layout_equals_kernel_layout_at_prefill():
    """At Sq == Skv the refs' right-aligned positions are the kernel's, so
    the CPU dispatch equals the plain kernel run through the wrapper's
    layout and padding (what the card runs)."""
    B, S, H, D = 2, 70, 4, 16
    q, k, v = (torch.from_numpy(_randn((B, S, H, D), i)) for i in range(3))
    got = flash_attention(q, k, v, causal=True, window=32)
    flat = [torch.nn.functional.pad(t.transpose(1, 2).reshape(B * H, S, D), (0, 0, 0, 58))
            for t in (q, k, v)]
    want = flash_attention_plain(*flat, n_q_heads=H, n_kv_heads=H, scale=D ** -0.5,
                                 causal=True, window=32, skv_actual=S)
    want = want[:, :S].reshape(B, H, S, D).transpose(1, 2)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_use_kernel_on_cpu_raises():
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q, use_kernel=True)


@pytest.mark.parametrize("bad", ["heads", "skv", "ndim"])
def test_kernel_wrapper_rejects_bad_shapes(bad):
    q = torch.zeros((4, 64, 16))
    k = torch.zeros((2, 64, 16))
    kw = dict(n_q_heads=4, n_kv_heads=2, scale=0.25)
    if bad == "heads":
        kw["n_kv_heads"] = 3
    elif bad == "skv":
        kw["skv_actual"] = 65
    else:
        q = q[None]
    with pytest.raises(ValueError):
        flash_attention_kernel(q, k, k, **kw)


# -- on the card: kernel E against its plain version -------------------------

#: (BH, H, Hkv, Sq, Skv, skv, D, causal, window, dtype); bfloat16 runs on the
#: wgmma kernel, float32 on the FMA one (``flash_attention_path``)
CUDA_CASES = {
    "bf16_causal_d128": (8, 8, 8, 512, 512, 512, 128, True, None, torch.bfloat16),
    "f32_gqa_ragged": (32, 32, 4, 1024, 1024, 1000, 128, True, None, torch.float32),
    "f32_sq_ne_skv": (4, 4, 4, 256, 1024, 1024, 64, True, None, torch.float32),
    "f32_window_d256": (2, 2, 1, 1024, 1024, 1024, 256, True, 200, torch.float32),
    "f32_noncausal_d16": (4, 2, 1, 128, 256, 200, 16, False, None, torch.float32),
    "bf16_window_noncausal_d64": (4, 4, 2, 256, 256, 256, 64, False, 100, torch.bfloat16),
    "bf16_gqa_ragged": (32, 32, 4, 1024, 1024, 1000, 128, True, None, torch.bfloat16),
    "bf16_sq_ne_skv": (32, 32, 32, 256, 1024, 1024, 128, True, None, torch.bfloat16),
    "bf16_window2048_d256": (4, 4, 4, 4096, 4096, 4096, 256, True, 2048, torch.bfloat16),
    "bf16_noncausal": (8, 8, 8, 1024, 1024, 1024, 128, False, None, torch.bfloat16),
    "bf16_noncausal_d16": (4, 2, 1, 128, 256, 200, 16, False, None, torch.bfloat16),
    "bf16_sq_odd_64s": (8, 8, 2, 320, 320, 300, 128, True, None, torch.bfloat16),
    # slice 10's prefills at 4096 tokens: internvl2-1b (14 heads, their KV
    # expanded) and musicgen-medium (24 heads) at head dim 64, and the 8
    # ranks' 2 padded heads of internvl2-1b at P = 8
    "bf16_vlm_d64": (14, 14, 14, 4096, 4096, 4096, 64, True, None, torch.bfloat16),
    "bf16_audio_d64": (24, 24, 24, 4096, 4096, 4096, 64, True, None, torch.bfloat16),
    "bf16_vlm_tp8_d64": (16, 2, 2, 4096, 4096, 4096, 64, True, None, torch.bfloat16),
    "f32_audio_d64": (24, 24, 24, 1024, 1024, 1024, 64, True, None, torch.float32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_kernel_matches_plain_on_card(cuda_device, case):
    """Each case against the plain version; the wgmma counter moves for
    exactly the bfloat16 cases."""
    BH, H, Hkv, Sq, Skv, skv, D, causal, window, dtype = CUDA_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(7)
    q = torch.randn((BH, Sq, D), generator=g, device=cuda_device).to(dtype)
    k, v = (torch.randn((BH // H * Hkv, Skv, D), generator=g, device=cuda_device).to(dtype)
            for _ in range(2))
    kw = dict(n_q_heads=H, n_kv_heads=Hkv, scale=D ** -0.5, causal=causal, window=window,
              skv_actual=skv)
    before, before_wg = flash_attention_kernel.launches, flash_attention_kernel.wgmma_launches
    got = flash_attention_kernel(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == before + 1
    assert flash_attention_kernel.wgmma_launches == before_wg + (dtype == torch.bfloat16)
    assert got.dtype == dtype and torch.isfinite(got).all()
    tol = 1e-4 if dtype == torch.float32 else 1.6e-2
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.cuda
def test_entry_point_launches_kernel_on_card(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(8)
    q, k, v = (torch.randn((2, 200, 4, 64), generator=g, device=cuda_device) for _ in range(3))
    before = flash_attention_kernel.launches
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention(q, k, v, causal=True, use_kernel=False)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == before + 1
    assert float((got - want).abs().max()) <= 1e-4
