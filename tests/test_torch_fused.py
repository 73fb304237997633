"""Kernel A's gather-fused form, ``fused_shift_accumulate``, against the
unfused composition and the reference.

Tolerance 0 throughout: ``out[r] = x[src[r]] + addend[r]`` is a copy and one
add in the operands' dtype (float for the half types, rounded once; int32
wraps), so the kernel, its plain version ``shift_accumulate_plain``, the
port's ``ppermute`` + add and the reference's Pallas ``fused_accumulate`` in
interpret mode (called outside ``shard_map`` on the rank shift done with
numpy) agree bit for bit.  A rank that receives nothing adds a real zero, so
a ``-0.0`` addend there comes out ``+0.0``, as on the static wire.  The cases
marked ``cuda`` hold the kernel against the plain version on the card and
skip where there is none; the reference (JAX) is imported only inside the
CPU cases, so they run alone where there is no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_fused.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import Communicator
from repro_torch.core.collectives import allreduce, stream_reduce_scatter
from repro_torch.core.comm import ppermute
from repro_torch.transport import get_transport
from repro_torch.transport.fused import (
    accumulate_plain,
    fused_accumulate,
    fused_shift_accumulate,
    shift_accumulate_plain,
    source_index,
)

P = 8
DTYPES = ("float32", "bfloat16", "int32")
#: (name, pairs): ring shifts of +-1 and +-2, and a partial permutation in
#: which ranks 2 and 5 receive nothing
PERMS = {
    "ring+1": [(i, (i + 1) % P) for i in range(P)],
    "ring-1": [(i, (i - 1) % P) for i in range(P)],
    "ring+2": [(i, (i + 2) % P) for i in range(P)],
    "ring-2": [(i, (i - 2) % P) for i in range(P)],
    "partial": [(0, 3), (1, 0), (3, 1), (4, 7), (6, 4), (7, 6)],
}


@pytest.fixture
def ref():
    """The reference's Pallas add (imports JAX)."""
    import jax.numpy as jnp
    from _torch_ref import assert_bits_equal  # loads the reference registry first

    from repro.transport.fused import fused_accumulate as ref_accumulate

    return SimpleNamespace(jnp=jnp, assert_bits_equal=assert_bits_equal,
                           fused_accumulate=ref_accumulate)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel A has no CPU mode)")
    return torch.device("cuda", 0)


def _operand(shape, dtype, seed):
    """A seeded numpy operand (bfloat16 as float32 values that bfloat16
    holds exactly) and the same bits as a torch tensor."""
    rng = np.random.RandomState(seed)
    if dtype == "int32":
        a = rng.randint(-2**31, 2**31 - 1, size=shape, dtype=np.int64).astype(np.int32)
        return a, torch.from_numpy(a.copy())
    a = (rng.randn(*shape) * 100).astype(np.float32)
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    return t.float().numpy(), t


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _numpy_shift(x: np.ndarray, pairs) -> np.ndarray:
    """The rank shift done outside any kernel: ``np.roll`` of the rank axis
    for a ring shift, zeros on a rank that receives nothing otherwise."""
    src = dict((d, s) for s, d in pairs)
    if len(src) == P:
        k = (pairs[0][1] - pairs[0][0]) % P
        if all(d == (s + k) % P for s, d in pairs):
            return np.roll(x, k, axis=0)
    out = np.zeros_like(x)
    for d, s in src.items():
        out[d] = x[s]
    return out


@pytest.mark.parametrize("perm", sorted(PERMS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_matches_ppermute_add_and_pallas_interpret(dtype, perm, ref):
    jnp = ref.jnp
    pairs = PERMS[perm]
    shape = (P, 37, 3)
    x, tx = _operand(shape, dtype, 1)
    a, ta = _operand(shape, dtype, 2)
    if dtype != "int32":
        a[2] = -0.0  # rank 2 receives nothing under "partial": 0 + -0.0 = +0.0
        ta[2] = -0.0
    src = source_index(tuple(pairs), P, torch.device("cpu"))
    got = shift_accumulate_plain(tx, ta, src)
    assert torch.equal(got.view(torch.uint8), (ppermute(tx, pairs) + ta).view(torch.uint8))
    jdt = getattr(jnp, dtype)
    want = ref.fused_accumulate(jnp.asarray(_numpy_shift(x, pairs), jdt), jnp.asarray(a, jdt),
                                interpret=True)
    want = np.asarray(want)
    ref.assert_bits_equal(_bits(got), want.view(np.int16) if dtype == "bfloat16" else want,
                          f"{dtype} {perm}")
    before = fused_shift_accumulate.launches
    assert torch.equal(fused_shift_accumulate(tx, ta, src).view(torch.uint8),
                       got.view(torch.uint8))  # CPU tensor: the plain version
    assert fused_shift_accumulate.launches == before
    if perm == "partial" and dtype != "int32":
        assert not torch.signbit(got[2].float()).any(), "-0.0 + 0 must round to +0.0"


@pytest.mark.parametrize("topo", [(("x",), (8,)), (("x", "y"), (2, 4))])
@pytest.mark.parametrize("op", ["reduce_scatter", "allreduce"])
def test_fused_transport_matches_static_on_cpu(op, topo):
    comm = Communicator.create(*topo, device="cpu")
    x = torch.from_numpy(np.random.RandomState(3).randn(P, P * 6, 5).astype(np.float32))
    run = {"reduce_scatter": lambda t: stream_reduce_scatter(x, comm, transport=t),
           "allreduce": lambda t: allreduce(x, comm, transport=t)}[op]
    ts, tf = get_transport("static", device="cpu"), get_transport("fused", device="cpu")
    with ts.tagged("ring"), tf.tagged("ring"):
        want, got = run(ts), run(tf)
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    assert (tf.stats.steps, tf.stats.bytes_moved, tf.stats.by_tag) == \
        (ts.stats.steps, ts.stats.bytes_moved, ts.stats.by_tag)
    assert tf.stats.steps > 0


def test_source_index_and_refusals():
    src = source_index(tuple(PERMS["partial"]), P, torch.device("cpu"))
    assert src.dtype == torch.int32
    assert src.tolist() == [1, 3, -1, 0, 6, -1, 7, 4]
    with pytest.raises(ValueError, match="receives twice"):
        source_index(((0, 1), (2, 1)), 3, torch.device("cpu"))
    x = torch.ones(P, 4)
    with pytest.raises(ValueError):
        fused_shift_accumulate(x, torch.ones(P, 5), src)
    with pytest.raises(ValueError):
        fused_shift_accumulate(x, torch.ones(P, 4), src[:4])
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_shift_accumulate(x.to("meta"), x.to("meta"), src.to("meta"))


# -- on the card -------------------------------------------------------------------

#: the phase-2 sizes of chip_smoke.py (a ragged million and 64 MiB) and small
#: odd rows; ``offset`` starts the operands that many elements into a buffer,
#: so their pointers sit off the 16-byte boundary
CARD_SIZES = [(P, 1), (P, 1001), (P, 1_000_003 // P + 1), (P, (64 << 20) // 4 // P)]


def _card_operand(shape, dtype, seed, offset, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    n = int(np.prod(shape)) + offset
    if dtype == torch.int32:
        flat = torch.randint(-2**31, 2**31 - 1, (n,), generator=g, dtype=torch.int32)
    else:
        flat = (torch.randn(n, generator=g) * 100).to(dtype)
    return flat.to(device)[offset:].view(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.int32])
@pytest.mark.parametrize("shape", CARD_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("perm", ["ring+1", "ring-2", "partial"])
def test_shift_kernel_matches_plain(perm, shape, dtype, offset, cuda_device):
    x = _card_operand(shape, dtype, 1, offset, cuda_device)
    a = _card_operand(shape, dtype, 2, 0, cuda_device)
    if dtype.is_floating_point:
        a[2] = -0.0
    src = source_index(tuple(PERMS[perm]), P, cuda_device)
    before = fused_shift_accumulate.launches
    got = fused_shift_accumulate(x, a, src)
    torch.cuda.synchronize()
    assert fused_shift_accumulate.launches == before + 1
    want = shift_accumulate_plain(x, a, src)
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("n", [1, 7, 1_000_003])
def test_accumulate_kernel_off_the_16_byte_boundary(n, dtype, offset, cuda_device):
    """Operands that start ``offset`` elements into their buffers: the same
    offset (scalar head, vector body, scalar tail) and different ones
    (scalar throughout)."""
    a = _card_operand((n,), dtype, 3, offset, cuda_device)
    for b_offset in (offset, 0):
        b = _card_operand((n,), dtype, 4, b_offset, cuda_device)
        got = fused_accumulate(a, b)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.uint8), accumulate_plain(a, b).view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("topo", [(("x",), (8,)), (("x", "y"), (2, 4))])
def test_fused_reduce_scatter_launches_once_per_ring_step(topo, cuda_device):
    comm = Communicator.create(*topo, device=cuda_device)
    x = torch.randn((P, P * 1000 + P), device=cuda_device)
    ts, tf = get_transport("static", device=cuda_device), get_transport("fused", device=cuda_device)
    before = (fused_shift_accumulate.launches, fused_accumulate.launches)
    got = stream_reduce_scatter(x, comm, transport=tf)
    torch.cuda.synchronize()
    assert (fused_shift_accumulate.launches, fused_accumulate.launches) == \
        (before[0] + P - 1, before[1])
    want = stream_reduce_scatter(x, comm, transport=ts)
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    assert (tf.stats.steps, tf.stats.bytes_moved) == (ts.stats.steps, ts.stats.bytes_moved)
