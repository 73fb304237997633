"""The autograd Functions that carry gradients through kernels A, D, E and
F (``transport/fused.py``, ``kernels/matmul/ops.py``,
``kernels/common.py RecomputeFn``).

Each kernel writes into a ``torch.empty``, which autograd would cut from
the graph; on the card each entry point launches through a Function.  On
the CPU the entry points run their plain versions, so these tests plug a
plain version into each Function in place of the kernel:

* ``torch.autograd.gradcheck`` in float64 of A's two Functions (the add;
  the gather-fused ring step, a ring shift and a partial permutation), of
  D's (``(M, K) @ (K, N)``, a batch of weights, one weight for a batch) and
  of ``RecomputeFn`` around a float64 attention;
* the real plain versions of E and F (which compute in float32) inside
  ``RecomputeFn``: its gradients bit-equal to their own autograd's;
* the model path: ``lm_loss`` with every kernel entry replaced by its
  Function around a counting plain version, the gradients equal to the
  plain path's, the Functions' forwards counted once a layer and once more
  in each layer's remat recompute.

The cases marked ``cuda`` hold each Function's gradients on the card
against the plain version's autograd, and skip where there is none.  This
module imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_autograd.py
"""

import contextlib
import functools
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.kernels.common import RecomputeFn
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.matmul import matmul, matmul_ref
from repro_torch.kernels.matmul.ops import MatmulFn
from repro_torch.kernels.ssd import ssd_scan, ssd_scan_plain
from repro_torch.transport.fused import (
    AccumulateFn,
    ShiftAccumulateFn,
    accumulate_plain,
    fused_accumulate,
    fused_shift_accumulate,
    shift_accumulate_plain,
)

P = 8
#: a ring shift and a partial permutation (ranks 2 and 5 receive nothing)
PERMS = {"ring": [(r, (r + 1) % P) for r in range(P)],
         "partial": [(0, 3), (1, 0), (3, 1), (4, 7), (6, 4), (7, 6)]}


def _t(*shape, seed=0, dtype=torch.float64, scale=1.0):
    a = np.random.RandomState(seed).randn(*shape) * scale
    return torch.from_numpy(a).to(dtype).requires_grad_(True)


def _src(perm):
    src = [-1] * P
    for s, d in perm:
        src[d] = s
    return torch.tensor(src, dtype=torch.int32)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


# -- gradcheck in float64 with the plain forward plugged in --------------------------

def test_accumulate_fn_gradcheck():
    a, b = _t(P, 5, seed=1), _t(P, 5, seed=2)
    assert torch.autograd.gradcheck(lambda x, y: AccumulateFn.apply(accumulate_plain, x, y),
                                    (a, b))


@pytest.mark.parametrize("perm", sorted(PERMS))
def test_shift_accumulate_fn_gradcheck(perm):
    src = _src(PERMS[perm])
    x, addend = _t(P, 3, 2, seed=3), _t(P, 3, 2, seed=4)
    assert torch.autograd.gradcheck(
        lambda u, v: ShiftAccumulateFn.apply(shift_accumulate_plain, u, v, src), (x, addend))


@pytest.mark.parametrize("perm", sorted(PERMS))
def test_shift_accumulate_fn_matches_plain_autograd_bit_for_bit(perm):
    """float32 and bfloat16: the Function's gradients equal the plain
    version's own autograd (an index gather and an add) bit for bit."""
    src = _src(PERMS[perm])
    for dtype in (torch.float32, torch.bfloat16):
        x, addend = _t(P, 64, seed=5, dtype=dtype), _t(P, 64, seed=6, dtype=dtype)
        g = torch.from_numpy(np.random.RandomState(7).randn(P, 64)).to(dtype)
        got = torch.autograd.grad(ShiftAccumulateFn.apply(shift_accumulate_plain, x, addend,
                                                          src), (x, addend), g)
        want = torch.autograd.grad(shift_accumulate_plain(x, addend, src), (x, addend), g)
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                               b.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))


MM_SHAPES = {"2d": ((6, 5), (5, 4)), "batched": ((3, 6, 5), (3, 5, 4)),
             "shared_w": ((3, 6, 5), (5, 4))}


def _matmul64(a, b, out_dtype=None):
    """The product in the operands' float64 (``matmul_ref`` accumulates in
    float32, too coarse for gradcheck)."""
    return torch.matmul(a, b)


@pytest.mark.parametrize("case", sorted(MM_SHAPES))
def test_matmul_fn_gradcheck(case):
    xs, ws = MM_SHAPES[case]
    x, w = _t(*xs, seed=8), _t(*ws, seed=9)
    assert torch.autograd.gradcheck(lambda a, b: MatmulFn.apply(_matmul64, a, b, None), (x, w))


def test_matmul_fn_backward_calls_its_forward_twice():
    """D's backward is two more calls of the forward (dX, dW): on the card,
    two launches of kernel D; one when only x needs a gradient."""
    calls = []

    def fwd(a, b, od):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return matmul_ref(a, b, od)

    x, w = _t(3, 6, 5, seed=10, dtype=torch.float32), _t(5, 4, seed=11, dtype=torch.float32)
    MatmulFn.apply(fwd, x, w, None).sum().backward()
    assert calls == [((3, 6, 5), (5, 4)), ((3, 6, 4), (4, 5)), ((5, 18), (18, 4))]
    calls.clear()
    w.requires_grad_(False)
    MatmulFn.apply(fwd, x, w, None).sum().backward()
    assert len(calls) == 2


def _attention64(q, k, v):
    """A causal attention in float64 (the gradcheck's plain function)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    S = q.shape[1]
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


def test_recompute_fn_gradcheck():
    """RecomputeFn's backward is its plain function's autograd: gradcheck
    with a float64 attention as both forward and plain function, and with
    only some inputs needing a gradient."""
    q, k, v = (_t(1, 5, 2, 3, seed=s) for s in (12, 13, 14))
    assert torch.autograd.gradcheck(
        lambda a, b, c: RecomputeFn.apply(_attention64, _attention64, a, b, c), (q, k, v))
    k.requires_grad_(False)
    out = RecomputeFn.apply(_attention64, _attention64, q, k, v)
    gq, gv = torch.autograd.grad(out.sum(), (q, v))
    wq, wv = torch.autograd.grad(_attention64(q, k, v).sum(), (q, v))
    assert torch.equal(gq, wq) and torch.equal(gv, wv)


@pytest.mark.parametrize("seq", [64, 2100])
def test_recompute_fn_around_e_plain_matches_its_autograd(seq):
    """E's plain version (the refs' dispatch; the chunked ref beyond 2048²
    positions) inside RecomputeFn: q, k, v's gradients bit-equal to the
    plain path's own autograd."""
    q, k, v = (_t(1, seq, 2, 16, seed=s, dtype=torch.float32) for s in (15, 16, 17))
    g = torch.from_numpy(np.random.RandomState(18).randn(1, seq, 2, 16)).float()
    plain = functools.partial(fa_ops._plain, causal=True, window=None, scale=None)
    got = torch.autograd.grad(RecomputeFn.apply(plain, plain, q, k, v), (q, k, v), g)
    want = torch.autograd.grad(flash_attention(q, k, v, use_kernel=False), (q, k, v), g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_recompute_fn_around_f_plain_matches_its_autograd():
    """F's plain scan inside RecomputeFn: every input's gradient bit-equal
    to the plain scan's own autograd (B and C as shared rows)."""
    rng = np.random.RandomState(19)
    x = torch.from_numpy(rng.randn(4, 200, 8) * 0.5).float().requires_grad_(True)
    dt = torch.from_numpy(rng.rand(4, 200) * 0.5 + 0.05).float().requires_grad_(True)
    B, C = (torch.from_numpy(rng.randn(2, 200, 6) * 0.5).float().requires_grad_(True)
            for _ in range(2))
    A = torch.from_numpy(-np.exp(rng.randn(4, 1) * 0.3)).float().requires_grad_(True)
    g = torch.from_numpy(rng.randn(4, 200, 8)).float()
    plain = functools.partial(ssd_scan_plain, chunk=64)
    got = torch.autograd.grad(RecomputeFn.apply(plain, plain, x, dt, B, C, A),
                              (x, dt, B, C, A), g)
    want = torch.autograd.grad(ssd_scan(x, dt, B, C, A, chunk=64), (x, dt, B, C, A), g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# -- the model path through the Functions --------------------------------------------

def _counting_functions(counts):
    """Stand-ins for the four kernel entry points that go through their
    Functions around counting plain versions (what the card runs, with the
    plain version in the kernel's place)."""
    def fa(q, k, v, *, causal=True, window=None, scale=None, use_kernel=None, **_):
        plain = functools.partial(fa_ops._plain, causal=causal, window=window, scale=scale)

        def fwd(*t):
            counts["E"] += 1
            return plain(*t)
        return RecomputeFn.apply(fwd, plain, q, k, v)

    def ssd(x, dt, B, C, A, *, chunk=128, use_kernel=None):
        plain = functools.partial(ssd_scan_plain, chunk=chunk)

        def fwd(*t):
            counts["F"] += 1
            return plain(*t)
        return RecomputeFn.apply(fwd, plain, x, dt, B, C, A)

    def mm(x, w, *, out_dtype=None, use_kernel=None):
        def fwd(a, b, od):
            counts["D"] += 1
            return matmul_ref(a, b, od)
        return MatmulFn.apply(fwd, x, w, out_dtype)

    def shift(x, addend, src):
        def fwd(*t):
            counts["A"] += 1
            return shift_accumulate_plain(*t)
        return ShiftAccumulateFn.apply(fwd, x, addend, src)

    return fa, ssd, mm, shift


@pytest.mark.parametrize("arch,remat", [("yi-6b", "nothing"), ("yi-6b", "none"),
                                        ("mamba2-2.7b", "nothing")])
def test_model_gradients_pass_through_the_functions(arch, remat):
    """smoke ``lm_loss`` at (1, 8) over ``smi:fused`` with kernel D on the
    GEMMs, every kernel entry point its Function around the counting plain
    version: every leaf's gradient equal to the plain path's within float32
    rounding; the Functions' forwards run once a layer (E or F), once more
    a layer under remat, and D's backward adds two calls a forward call."""
    from repro_torch.configs import get_arch, smoke
    from repro_torch.interop import shard_params
    from repro_torch.mesh.api import make_ctx
    from repro_torch.models import attention, init_lm, lm_loss, ssm
    from repro_torch.models.common import tree_leaves_with_path
    from repro_torch.transport import fused

    cfg = smoke(get_arch(arch))
    cfg = cfg.scaled(n_heads=8) if cfg.family != "ssm" else cfg
    rng = np.random.RandomState(20)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 32)).astype(np.int32))
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 32)).astype(np.int32))

    def run(counts=None):
        ctx = make_ctx((1, P), comm_mode="smi:fused", device="cpu", matmul_fn=matmul)
        params = shard_params(init_lm(cfg, torch.Generator().manual_seed(0), "cpu", ctx=ctx),
                              cfg, ctx)
        leaves = [t.requires_grad_(True) for _, t in tree_leaves_with_path(params)]
        patches = []
        if counts is not None:
            fa, sd, mm, sh = _counting_functions(counts)
            ctx = make_ctx((1, P), comm_mode="smi:fused", device="cpu", matmul_fn=mm)
            patches = [mock.patch.object(attention, "flash_attention", fa),
                       mock.patch.object(ssm, "ssd_scan", sd),
                       mock.patch.object(fused, "fused_shift_accumulate", sh)]
        with contextlib.ExitStack() as stack:
            for p in patches:
                stack.enter_context(p)
            loss, _ = lm_loss(params, tokens, labels, cfg, ctx, remat=remat, loss_chunks=2)
            fwd = dict(counts) if counts is not None else None
            grads = torch.autograd.grad(loss, leaves)
        return grads, fwd

    counts = {"A": 0, "D": 0, "E": 0, "F": 0}
    got, fwd = run(counts)
    want, _ = run()
    for a, b in zip(got, want):
        assert a.abs().max() > 0
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-7)
    L = cfg.n_layers
    key = "F" if cfg.family == "ssm" else "E"
    again = 2 if remat == "nothing" else 1
    assert fwd[key] == L and counts[key] == again * L
    assert fwd["D"] > 0 and counts["D"] == fwd["D"] * (again + 2)
    if remat == "nothing":
        assert counts["A"] > fwd["A"] > 0
    else:
        assert counts["A"] == fwd["A"] > 0


# -- on the card ---------------------------------------------------------------------

def _card_grads(fn, inputs, g):
    leaves = [t.detach().requires_grad_(t.is_floating_point()) for t in inputs]
    return torch.autograd.grad(fn(*leaves), [t for t in leaves if t.requires_grad], g)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_functions_carry_gradients_on_card(cuda_device, dtype):
    """Each kernel's Function on the card against the plain version's
    autograd: A bit for bit; D, E and F within 1e-4 (float32) and their
    forward tolerances (bfloat16: D 2e-2, E and F 1.6e-2) of the largest
    magnitude; every gradient finite and non-zero."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(21)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=cuda_device) * scale).to(dt)

    def close(got, want, tol):
        for a, b in zip(got, want):
            assert torch.isfinite(a).all() and a.abs().max() > 0
            assert float((a.double() - b.double()).abs().max()) <= tol * float(b.abs().max())

    a, b, up = rnd(P, 4096), rnd(P, 4096), rnd(P, 4096)
    src = _src(PERMS["partial"]).to(cuda_device)
    for k_fn, p_fn, args in ((fused_accumulate, accumulate_plain, (a, b)),
                             (lambda x, y: fused_shift_accumulate(x, y, src),
                              lambda x, y: shift_accumulate_plain(x, y, src), (a, b))):
        for u, v in zip(_card_grads(k_fn, args, up), _card_grads(p_fn, args, up)):
            assert torch.equal(u, v)
    f32 = dtype == "float32"
    x, w, up = rnd(8, 256, 512), rnd(8, 512, 384, scale=512 ** -0.5), rnd(8, 256, 384)
    before = matmul.launches
    got = _card_grads(matmul, (x, w), up)
    assert matmul.launches == before + 3
    close(got, _card_grads(matmul_ref, (x, w), up), 1e-4 if f32 else 2e-2)
    q, k, v, up = (rnd(2, 512, 4, 128) for _ in range(4))
    close(_card_grads(flash_attention, (q, k, v), up),
          _card_grads(lambda *t: flash_attention(*t, use_kernel=False), (q, k, v), up),
          1e-4 if f32 else 1.6e-2)
    x = rnd(8, 512, 64, scale=0.5)
    dtt = (torch.rand((8, 512), generator=g, device=cuda_device) * 0.5 + 0.05).to(dt)
    B, C = rnd(2, 512, 128, scale=0.5), rnd(2, 512, 128, scale=0.5)
    A = (-torch.exp(torch.randn((8, 1), generator=g, device=cuda_device) * 0.3)).to(dt)
    up = rnd(8, 512, 64)
    close(_card_grads(ssd_scan, (x, dtt, B, C, A), up),
          _card_grads(lambda *t: ssd_scan(*t, use_kernel=False), (x, dtt, B, C, A), up),
          1e-4 if f32 else 1.6e-2)
