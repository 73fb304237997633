"""Message schedules for the simulator, mirroring the port's transports
(``repro.netsim.schedule``).

Two jobs:

1. **Schedule builders** turn a logical operation (a routed p2p, a ring
   shift, a collective under a given algorithm, the halo exchange) into the
   :class:`~repro_torch.netsim.sim.Message` rounds the simulator replays.
   They encode the schedules ``transport/static.py`` and
   ``core/collectives.py`` run, so simulated ticks are the schedule's steps.

2. **Exact stats prediction** (:func:`predict_transport_stats`,
   :func:`predict_halo_stats`, :func:`predict_channel_stats`): the
   (steps, bytes) a backend tallies into its
   :class:`~repro_torch.transport.base.TransportStats` for an operation,
   per rank.  For the static backend this is the simulator's tick count;
   for the packet backend the router's schedule bound from the port's own
   ``PacketTransport._bounds`` (no second formula to drift).

3. **Whole-step prediction** of the serving decode ledger
   (:func:`predict_decode_step_stats`, per ``serve.*`` tag), the gate of
   ``launch/serve --validate-comm``, and of a training step's ledger
   (:func:`predict_train_step_stats`, at a data axis of one rank), the gate
   of ``launch/train --validate-comm``.
"""

from __future__ import annotations

from types import SimpleNamespace

from .sim import Message, simulate, simulate_rounds


def _dtype_size(dtype) -> int:
    """Bytes an element of ``dtype``: a torch or numpy dtype, or its name."""
    if hasattr(dtype, "itemsize"):
        return int(dtype.itemsize)
    import numpy as np

    return np.dtype(dtype).itemsize


# ---------------------------------------------------------------------------
# schedule builders
# ---------------------------------------------------------------------------


def p2p_messages(rt, src: int, dst: int, nbytes: float, n_chunks: int = 1):
    """The static transport's chunk-pipelined routed transfer."""
    n_chunks = max(int(n_chunks), 1)
    return [
        Message(
            src, dst, n_flits=n_chunks, flit_bytes=nbytes / n_chunks,
            pipelined=True,
        )
    ]


def ring_perm_round(n_ranks: int, nbytes: float, step: int = 1):
    """One logical ring-permute round: every rank forwards its buffer to
    the rank ``step`` positions along the linearised order.  Routed through
    the route table, so a logical hop that is not a physical link (the
    wrap-around edge on a bus, a distance-``s`` shift anywhere) costs its
    real multi-hop path — exactly what the physical fabric pays."""
    return [
        Message(i, (i + step) % n_ranks, n_flits=1, flit_bytes=nbytes)
        for i in range(n_ranks)
    ]


def compressed_reduce_scatter_rounds(n_ranks: int, nbytes: float):
    """The once-quantised contribution schedule the compressed wire's ring
    reduce-scatter executes (DESIGN.md §7): round ``s`` ships every rank's
    block contribution a logical distance ``s`` — charged its real routed
    multi-hop cost, which is how the tuner sees that this schedule trades
    byte-hops for P-independent quantisation error."""
    return [
        ring_perm_round(n_ranks, nbytes, step=s) for s in range(1, n_ranks)
    ]


def _expand_chain(rt, order):
    """Route-expand a logical chain: each consecutive pair of the rank
    ``order`` is replaced by its full routed path, so a logical hop that is
    not a physical link costs its real multi-hop traversal (e.g. the wrap
    edge of a linearised ring on a bus, or rank-order chains on a snake)."""
    path = [order[0]]
    for a, b in zip(order[:-1], order[1:]):
        path.extend(rt.path(a, b)[1:])
    return path


def _chain_paths(topo, rt, root: int):
    """Chain path(s) for the pipelined rooted collectives: one wrap-around
    ring chain on tori, an up+down pair on line topologies (the schedule
    ``core/collectives.py`` runs), route-expanded onto physical links."""
    P = topo.n_ranks
    if topo.dims is not None:
        order = [[(root + i) % P for i in range(P)]]
    else:
        order = [p for p in (list(range(root, P)), list(range(root, -1, -1)))
                 if len(p) >= 2]
    return [_expand_chain(rt, o) for o in order]


def collective_rounds(
    topo, rt, op: str, algo: str, nbytes: float, *,
    n_chunks: int = 1, root: int = 0,
):
    """Barrier-separated message rounds for ``op`` under ``algo``.

    ops: ``bcast`` / ``reduce`` (rooted), ``allgather``, ``allreduce``.
    algos: ``ring`` (the pipelined chain / ring schedule — the repo's
    default), ``tree`` (binomial rounds), ``staged`` (serial whole-message
    sends, the host-staged baseline).
    """
    P = topo.n_ranks
    n_chunks = max(int(n_chunks), 1)
    if P == 1:
        return []

    if op in ("bcast", "reduce"):
        if algo == "ring":
            # pipelined chain: n_chunks flits streamed along the chain(s);
            # reduce runs the same schedule in reverse (same cost)
            rounds = [[]]
            for path in _chain_paths(topo, rt, root):
                p = path if op == "bcast" else list(reversed(path))
                rounds[0].append(
                    Message(p[0], p[-1], n_flits=n_chunks,
                            flit_bytes=nbytes / n_chunks, path=p)
                )
            return rounds
        if algo == "tree":
            rounds = []
            h = 1
            while h < P:
                msgs = []
                for i in range(h):
                    if i + h >= P:
                        continue
                    a, b = (root + i) % P, (root + i + h) % P
                    if op == "reduce":
                        a, b = b, a
                    msgs.append(Message(a, b, n_flits=1, flit_bytes=nbytes))
                rounds.append(msgs)
                h <<= 1
            return rounds if op == "bcast" else list(reversed(rounds))
        if algo == "staged":
            # serial whole-message sends, one destination at a time
            rounds = []
            for d in range(1, P):
                peer = (root + d) % P
                a, b = (root, peer) if op == "bcast" else (peer, root)
                rounds.append(
                    [Message(a, b, n_flits=1, flit_bytes=nbytes,
                             pipelined=False)]
                )
            return rounds
        raise ValueError(f"unknown {op} algorithm {algo!r}")

    if op == "allgather":
        return [ring_perm_round(P, nbytes) for _ in range(P - 1)]
    if op == "reduce_scatter":
        return [ring_perm_round(P, nbytes / P) for _ in range(P - 1)]
    if op == "allreduce":
        # ring RS + AG of nbytes/P blocks — the streaming all-reduce schedule
        return [ring_perm_round(P, nbytes / P) for _ in range(2 * (P - 1))]
    raise ValueError(f"unknown collective op {op!r}")


# ---------------------------------------------------------------------------
# halo-exchange schedules (the apps stencil's communication phase)
# ---------------------------------------------------------------------------


def halo_pairs(grid, drx: int, dry: int):
    """(src, dst) pairs of one halo direction: rank (sx, sy) of the
    row-major ``grid`` sends to (sx + drx, sy + dry) where that rank exists
    (no wrap).  The one wiring of the exchange (``core/overlap.py``) and
    the simulator's replay."""
    RX, RY = grid
    pairs = []
    for s in range(RX * RY):
        sx, sy = s // RY, s % RY
        tx, ty = sx + drx, sy + dry
        if 0 <= tx < RX and 0 <= ty < RY:
            pairs.append((s, tx * RY + ty))
    return pairs


#: the four halo directions in trace order: (drx, dry, slab_axis) where
#: slab_axis 0 = an N/S row slab, 1 = an E/W column slab
HALO_DIRECTIONS = ((-1, 0, 0), (+1, 0, 0), (0, -1, 1), (0, +1, 1))


def halo_slab_elems(shape, halo=(1, 1)) -> tuple[int, int]:
    """(ns_elems, ew_elems): element counts of one N/S row slab and one E/W
    column slab of a per-rank tile ``shape`` = (Nx, Ny, ...)."""
    import numpy as np

    hx, hy = halo
    trail = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    return hx * shape[1] * trail, shape[0] * hy * trail


def halo_rounds(grid, ns_bytes: float, ew_bytes: float):
    """Barrier-separated message rounds of the 2D halo exchange: one round
    per non-empty direction (N, S, W, E), each a neighbour permute carrying
    the direction's slab.  The simulator route-expands each pair through
    the route table, so a grid laid over a non-matching topology pays its
    real multi-hop cost."""
    rounds = []
    for drx, dry, axis in HALO_DIRECTIONS:
        pairs = halo_pairs(grid, drx, dry)
        if not pairs:
            continue
        nbytes = ns_bytes if axis == 0 else ew_bytes
        rounds.append(
            [Message(s, d, n_flits=1, flit_bytes=nbytes) for s, d in pairs]
        )
    return rounds


def predict_halo_stats(
    comm, *, grid, shape, dtype="float32", halo=(1, 1),
    transport: str = "static", pkt_elems: int = 32, slack_steps: int = 4,
    axis_elems: int | None = None,
):
    """Exact (steps, bytes) a fresh backend tallies for one halo exchange
    (``core/overlap.py halo_exchange_2d_start``): one permute per
    non-empty direction; the compressed wire carries the int8 payload and
    scale sidecar; the packet backend pays its router bound per direction.
    ``shape`` is one rank's tile."""
    from .model import WIRE_AXIS_ELEMS, int8_wire_nbytes

    ns_elems, ew_elems = halo_slab_elems(shape, halo)
    esz = _dtype_size(dtype)
    rt = comm.route_table
    steps = 0
    nbytes = 0
    for drx, dry, axis in HALO_DIRECTIONS:
        pairs = halo_pairs(grid, drx, dry)
        if not pairs:
            continue
        elems = ns_elems if axis == 0 else ew_elems
        if transport in ("compressed", "compressed:static"):
            wire = int8_wire_nbytes(
                elems, WIRE_AXIS_ELEMS if axis_elems is None else axis_elems
            )
            steps += 1
            nbytes += wire
        elif transport in ("static", "fused"):
            steps += 1
            nbytes += elems * esz
        elif transport == "packet":
            K = packet_n_packets(elems, pkt_elems)
            n_steps, _ = packet_bounds(
                rt, pairs, K, pkt_elems=pkt_elems, slack_steps=slack_steps
            )
            steps += n_steps
            nbytes += elems * esz
        else:
            raise ValueError(f"no halo stats model for transport {transport!r}")
    return steps, nbytes


def predict_halo_time(
    comm, *, grid, shape, dtype="float32", halo=(1, 1), model=None,
    wire: str = "raw",
):
    """Predicted seconds of one halo exchange under a
    :class:`~repro_torch.netsim.model.LinkModel` (the card's fit unless
    given): replay the direction rounds through the tick simulator and
    convert ticks through the wire-aware hop time."""
    from .model import LinkModel

    model = model or LinkModel()
    ns_elems, ew_elems = halo_slab_elems(shape, halo)
    esz = _dtype_size(dtype)
    rounds = halo_rounds(grid, ns_elems * esz, ew_elems * esz)
    _, _, reports = simulate_rounds(comm.topology, comm.route_table, rounds)
    return sum(
        r.ticks * model.hop_time_wire(r.flit_bytes_max, wire) for r in reports
    )


# ---------------------------------------------------------------------------
# packet-backend schedule bounds (shared with the device path)
# ---------------------------------------------------------------------------


def packet_bounds(rt, pairs, n_packets: int, *, pkt_elems: int = 32,
                  slack_steps: int = 4, transit_cap: int | None = None):
    """(n_steps, transit_cap) for a packet-routed permutation, computed by
    the port's ``PacketTransport._bounds`` itself, so the prediction is the
    schedule the router runs."""
    from ..transport.packet import PacketTransport  # lazy: imports torch

    tp = PacketTransport(
        pkt_elems=pkt_elems, slack_steps=slack_steps, transit_cap=transit_cap,
        device="cpu",
    )
    shim = SimpleNamespace(route_table=rt, size=rt.topo.n_ranks)
    active = [(s, d) for s, d in pairs if s != d]
    return tp._bounds(shim, active, n_packets)


def packet_n_packets(n_elems: int, pkt_elems: int = 32) -> int:
    """Packets per sender for an ``n_elems``-element wire vector (the f32
    wire format of ``transport/packet.py``)."""
    return -(-int(n_elems) // int(pkt_elems))


# ---------------------------------------------------------------------------
# exact TransportStats prediction
# ---------------------------------------------------------------------------


def predict_transport_stats(
    comm, op: str, *, shape, dtype="float32", transport: str = "static",
    src: int = 0, dst: int = 0, n_chunks: int = 1,
    pkt_elems: int = 32, slack_steps: int = 4, axis_elems: int | None = None,
):
    """Exact (steps, bytes_moved) a fresh backend instance tallies for one
    operation — the numbers ``Transport.stats`` holds after the run.

    ops: ``p2p`` (uses src/dst/n_chunks), ``shift`` (one ring step),
    ``allgather`` (P-1 shifts of the local shard).  ``shape`` is the
    per-rank array shape.  ``transport="compressed"`` (static inner)
    predicts the int8 wire's exact byte count — payload plus the bitcast
    scale sidecar of ``axis_elems``-sized blocks (None = the transport's
    default), the same :func:`repro_torch.netsim.model.int8_wire_nbytes` figure
    the backend accounts.
    """
    import numpy as np

    from .model import WIRE_AXIS_ELEMS, clamp_chunks, int8_wire_nbytes

    elems = int(np.prod(shape)) if shape else 1
    nbytes = elems * _dtype_size(dtype)
    topo, rt = comm.topology, comm.route_table

    if transport in ("compressed", "compressed:static"):
        # the compressed wire is one flat int8 vector per leaf; the static
        # inner backend then moves (and accounts) exactly those bytes
        W = int8_wire_nbytes(
            elems, WIRE_AXIS_ELEMS if axis_elems is None else axis_elems
        )
        if op == "p2p":
            if src == dst:
                return 0, 0
            nc = clamp_chunks(n_chunks, W)
            rep = simulate(topo, rt, p2p_messages(rt, src, dst, W, nc))
            return rep.ticks, (W // nc) * rep.ticks
        if op == "shift":
            rep = simulate(topo, rt, ring_perm_round(comm.size, W))
            return rep.ticks, W * rep.ticks
        if op == "allgather":
            ticks, _, _ = simulate_rounds(
                topo, rt, collective_rounds(topo, rt, "allgather", "ring", W)
            )
            return ticks, W * ticks
        raise ValueError(f"unknown op {op!r}")

    if transport == "static":
        if op == "p2p":
            if src == dst:
                return 0, 0
            rep = simulate(topo, rt, p2p_messages(rt, src, dst, nbytes, n_chunks))
            # the backend accounts chunk_bytes per tick (wire bytes per rank
            # per step, the schedule-cost convention of TransportStats)
            csz_bytes = nbytes // max(int(n_chunks), 1)
            return rep.ticks, csz_bytes * rep.ticks
        if op == "shift":
            rep = simulate(topo, rt, ring_perm_round(comm.size, nbytes))
            return rep.ticks, nbytes * rep.ticks
        if op == "allgather":
            ticks, _, _ = simulate_rounds(
                topo, rt, collective_rounds(topo, rt, "allgather", "ring", nbytes)
            )
            return ticks, nbytes * ticks
        raise ValueError(f"unknown op {op!r}")

    if transport == "packet":
        if op == "p2p":
            if src == dst:
                return 0, 0
            K = packet_n_packets(elems, pkt_elems)
            n_steps, _ = packet_bounds(
                rt, [(src, dst)], K,
                pkt_elems=pkt_elems, slack_steps=slack_steps,
            )
            return n_steps, nbytes
        if op == "shift":
            K = packet_n_packets(elems, pkt_elems)
            pairs = [(i, (i + 1) % comm.size) for i in range(comm.size)]
            n_steps, _ = packet_bounds(
                rt, pairs, K, pkt_elems=pkt_elems, slack_steps=slack_steps
            )
            return n_steps, nbytes
        raise ValueError(f"unknown op {op!r}")

    raise ValueError(f"no stats model for transport {transport!r}")


def predict_channel_stats(spec, *, shape, dtype="float32", n_chunks=None,
                          **kw):
    """Exact (steps, bytes_moved) one whole-message ``transfer`` of
    ``shape`` over a p2p channel tallies into its backend's stats —
    and, because every channel step is accounted under the channel's
    :attr:`~repro_torch.channels.ChannelSpec.stats_tag`, the numbers
    ``stats.tag_counts(spec.stats_tag)`` holds after the transfer.

    ``spec`` is a :class:`~repro_torch.channels.ChannelSpec` (duck-typed:
    any object with ``comm`` / ``kind`` / ``src`` / ``dst`` /
    ``transport_key`` / ``n_chunks`` attributes works).  The
    channel's transport key selects the stats model — ``"static"`` /
    ``"fused"`` (same wire), ``"packet"`` (router schedule bounds), or the
    int8 compressed link (``"compressed"`` over a static inner) — exactly
    the backends :func:`predict_transport_stats` covers.
    """
    assert spec.kind == "p2p", (
        f"channel-stats prediction covers p2p channels; got {spec.kind!r}"
    )
    key = spec.transport_key
    if key == "fused":
        key = "static"  # identical permute schedule and wire accounting
    elif key == "compressed:fused":
        key = "compressed:static"  # same aliasing under the int8 wire
    nc = n_chunks if n_chunks is not None else spec.n_chunks
    return predict_transport_stats(
        spec.comm, "p2p", shape=shape, dtype=dtype, transport=key,
        src=spec.src, dst=spec.dst, n_chunks=nc, **kw,
    )


# ---------------------------------------------------------------------------
# whole-step prediction (per channel tag)
# ---------------------------------------------------------------------------


def _shift_cost(leaves, key, *, pkt_elems=32, slack_steps=4):
    """Exact (steps, wire_bytes) ONE ring shift (hop distance 1) of a
    payload tallies, per backend family.  ``leaves``: [(elems, itemsize,
    is_float)].  Mirrors the transports' accounting: static and fused move
    the raw bytes in one step; the compressed link re-wires float leaves as
    int8 plus the scale sidecar; the packet router's schedule bound is
    ``hops + n_packets + slack`` over the flattened float32 wire."""
    from .model import WIRE_AXIS_ELEMS, int8_wire_nbytes

    raw = sum(n * sz for n, sz, _ in leaves)
    fam, _, inner = key.partition(":")
    if fam == "compressed":
        wire = sum(int8_wire_nbytes(n, WIRE_AXIS_ELEMS) if fl else n * sz for n, sz, fl in leaves)
        if inner == "packet":
            k = packet_n_packets(-(-wire // 4), pkt_elems)
            return 1 + k + slack_steps, wire
        return 1, wire
    if fam == "packet":
        k = packet_n_packets(-(-raw // 4), pkt_elems)
        return 1 + k + slack_steps, raw
    return 1, raw


def _slot_nbytes(cfg, tp: int, capacity: int) -> int:
    """Bytes of one rank's packed slot image (every layer's cache rows of
    one slot), from the config alone: the KV ring of an attention (or MoE)
    layer at ``capacity / tp`` slots (a windowed layer's at its window,
    padded to a multiple of tp), the SSM conv windows and state, the RG-LRU
    conv window and state, as the reference's ``lm_caches`` lays them."""
    from ..models.transformer import _pow2_pad  # lazy: the cache's own cap

    esz = 2 if cfg.dtype == "bfloat16" else 4
    K = cfg.ssm_conv
    total = 0
    for kind in cfg.layer_pattern:
        if kind in ("attn", "moe"):
            cap = capacity if cfg.local_window is None else min(
                capacity, _pow2_pad(cfg.local_window, tp))
            cap_loc = cap // tp
            total += cap_loc * (2 * cfg.n_kv_heads * cfg.hd * esz + 4)
        elif kind == "ssm":
            d_in = cfg.ssm_expand * cfg.d_model
            nh_loc = d_in // cfg.ssm_headdim // tp
            total += (K - 1) * (nh_loc * cfg.ssm_headdim + 2 * cfg.ssm_state) * esz
            total += nh_loc * cfg.ssm_state * cfg.ssm_headdim * 4
        elif kind == "rec":
            w_loc = (cfg.lru_width or cfg.d_model) // tp
            total += (K - 1) * w_loc * esz + w_loc * 4
        else:
            raise ValueError(kind)
    return total


def predict_train_step_stats(cfg, mesh_shape, shape, settings, *, pkt_elems=32, slack_steps=4,
                             eager=False):
    """Per-tag predicted channel traffic of ONE training step (the forward
    with its loss and the backward) as the channel ledger measures it:
    ``{tag: {"steps": int, "bytes": int}}``, bytes one rank's.

    ``mesh_shape`` is ``(dp, tp)``, ``shape`` a ShapeConfig (seq_len,
    global_batch), ``settings`` duck-types ``TrainSettings`` (comm_mode,
    fsdp, loss_chunks, shared_gather, ring_attn, compressed_grads).  The
    backward's collectives mirror their forward channels and are counted
    there, by the ledger and by this table alike.

    The reference's ledger is filled while it traces, and a ``lax.scan`` over
    layer periods traces each period position once: its per-block tags count
    once per traced position, which is this table by default (equal to the
    reference's function).  The port runs every layer, and recomputes a
    rematerialised layer with its ledger paused, so its ledger holds every
    layer's traffic once: ``eager=True`` counts the per-block tags once a
    layer, and an RG-LRU block's MLP, which the reference's table leaves
    out.  Over a data axis of more than one rank with ``fsdp``, each
    FSDP leaf's gather (``fsdp.gather``: the reference's one a traced
    gather site, the port's one a layer with ``eager=True``) and each leaf
    stored whole's gradient ring (``grad``, on the compressed link with
    ``compressed_grads``) are counted by :func:`_fsdp_leaf_walk`."""
    from ..transport.registry import resolve_comm_mode

    dp, tp = int(mesh_shape[0]), int(mesh_shape[1])
    base_mode, key = resolve_comm_mode(settings.comm_mode)
    if base_mode != "smi":
        raise ValueError(f"predict_train_step_stats models smi comm modes; got "
                         f"{settings.comm_mode!r}")
    esz = 2 if cfg.dtype == "bfloat16" else 4
    B = shape.global_batch // dp
    S = shape.seq_len
    S_loc = S // tp if tp > 1 else S
    rows = B * S_loc
    D = cfg.d_model
    shared = bool(getattr(settings, "shared_gather", False))
    acc: dict = {}

    def add(tag, steps, nbytes):
        e = acc.setdefault(tag, {"steps": 0, "bytes": 0})
        e["steps"] += int(steps)
        e["bytes"] += int(nbytes)

    def ring(tag, leaves, P, n_shifts=None, tkey=key):
        if P <= 1:
            return
        ns = (P - 1) if n_shifts is None else n_shifts
        s, b = _shift_cost(leaves, tkey, pkt_elems=pkt_elems, slack_steps=slack_steps)
        add(tag, s * ns, b * ns)

    def psum(tag, nbytes, n=1):
        if tp > 1:
            add(tag, n, nbytes * n)

    def act(elems):
        return [(int(elems), esz, True)]

    # forward activations: embed -> block positions -> loss
    if tp > 1:
        ring("tp.embed", act(rows * D), tp)

    period = len(cfg.pattern)
    n_full = cfg.n_layers // period
    rem = cfg.n_layers % period
    if eager:
        blocks = list(cfg.pattern) * n_full + list(cfg.pattern[:rem])
    else:
        blocks = (list(cfg.pattern) if n_full > 0 else []) + list(cfg.pattern[:rem])

    for kind in blocks:
        if tp <= 1:
            break
        if kind in ("attn", "moe"):
            if getattr(settings, "ring_attn", False):
                hd = cfg.hd
                Hp = -(-cfg.n_heads // tp) * tp
                ring("tp.attn.qkv", act(D * Hp * hd // tp), tp)
                if cfg.qkv_bias:
                    ring("tp.attn.qkv", act(Hp * hd // tp), tp)
                ring("tp.attn.out", act(Hp * hd // tp * D), tp)
                kv = B * S_loc * cfg.n_kv_heads * hd
                ring("tp.attn.ring", act(kv) + act(kv), tp)
            else:
                ring("tp.attn.qkv", act(rows * D), tp)
                if not shared:
                    ring("tp.attn.kv", act(rows * D), tp)
                ring("tp.attn.out", act(rows * D), tp)
        # an RG-LRU block's MLP streams too, which the reference's traced
        # table leaves out (ROADMAP.md §3): the eager table counts it
        if kind == "attn" or (kind == "moe" and cfg.shared_expert) or (kind == "rec" and eager):
            n_up = 1 if (cfg.mlp_type != "swiglu" or shared) else 2
            ring("tp.mlp.up", act(rows * D), tp, n_shifts=n_up * (tp - 1))
            ring("tp.mlp.down", act(rows * D), tp)
        if kind == "moe":
            ring("ep.dispatch", act(rows * D), tp)
            ring("ep.combine", act(rows * D), tp)
        if kind == "ssm":
            n_in = 1 if shared else 2
            ring("ssm.in", act(rows * D), tp, n_shifts=n_in * (tp - 1))
            if not shared:
                ring("ssm.gather", act(rows * D), tp)
            ring("ssm.out", act(rows * D), tp)
        if kind == "rec":
            n_in = 1 if shared else 2
            ring("ssm.in", act(rows * D), tp, n_shifts=n_in * (tp - 1))
            ring("ssm.out", act(rows * D), tp)

    lc = int(getattr(settings, "loss_chunks", 1))
    csz = S_loc // lc
    n_tables = cfg.n_codebooks if cfg.n_codebooks > 1 else 1
    if tp > 1:
        for _ in range(lc):
            ring("tp.loss.gather", act(B * csz * D), tp)
            psum("tp.loss.ce", B * tp * csz * 4, n=3 * n_tables)

    # the FSDP gathers and the gradient sync over the data ring
    if getattr(settings, "fsdp", False) and dp > 1:
        gathered, grad_rings = _fsdp_leaf_walk(cfg, dp, tp, n_full, eager=eager)
        for loc_elems in gathered:
            ring("fsdp.gather", act(loc_elems), dp)
        gkey = key
        if getattr(settings, "compressed_grads", False) and key.partition(":")[0] != "compressed":
            gkey = f"compressed:{key}"
        for loc_elems in grad_rings:
            m = -(-loc_elems // dp)  # the padded ring chunk
            ring("grad", [(m, 4, True)], dp, n_shifts=2 * (dp - 1), tkey=gkey)

    return {t: acc[t] for t in sorted(acc)}


def _fsdp_leaf_walk(cfg, dp: int, tp: int, n_full: int, *, eager: bool = False):
    """One device's element counts of the FSDP plan's leaves at ``(dp,
    tp)``: ``(gathered, rings)``.  ``gathered`` lists a gather's payload a
    shift for every FSDP leaf (its model shard, a layer's of a period leaf,
    over ``dp``), once a traced gather site (the reference's) or, with
    ``eager``, once a layer (the port's, which gathers every layer).
    ``rings`` lists the model shard of every leaf stored whole, which the
    gradient sync all-reduces over a ``"grad"`` channel."""
    from ..mesh.api import fsdp_dim_for, make_ctx
    from ..models.common import tree_leaves_with_path
    from ..models.model import lm_specs, param_shapes

    ctx = make_ctx((dp, tp), comm_mode="smi:static", device="cpu")
    shapes = tree_leaves_with_path(param_shapes(cfg, ctx))
    specs = dict(tree_leaves_with_path(lm_specs(cfg, ctx)))
    gathered, rings = [], []
    for path, sh in shapes:
        sp = specs[path]
        stacked = "periods" in path
        dim = fsdp_dim_for(tuple(sh.shape), sp, dp, skip_dim0=stacked)
        tp_div = tp ** sum(d is not None for d in tuple(sp))
        loc = sh.numel() // tp_div
        if dim < 0:
            rings.append(loc)
        elif stacked:
            gathered.extend([loc // n_full // dp] * (n_full if eager else 1))
        else:
            gathered.append(loc // dp)
    return gathered, rings


def predict_decode_step_stats(cfg, mesh_shape, batch_slots, settings, *, capacity=128,
                              migrations=0, prefix="serve.", pkt_elems=32, slack_steps=4,
                              eager=False, fsdp=False):
    """Per-tag predicted channel traffic of ONE serving decode step
    (``lm_decode_step`` with ``gather_logits=False``, as
    ``launch.steps.build_continuous_serve`` runs it), plus ``migrations``
    slot migrations, as the channel ledger measures it: ``{tag: {"steps":
    int, "bytes": int}}``, bytes one rank's, tags under the serving pool's
    ``prefix``.

    ``mesh_shape`` is ``(dp, tp)``: serving replicates slots over the data
    axes, so only ``tp`` moves bytes.  ``settings`` duck-types
    ``comm_mode`` (an smi mode).  Migration always rides the static
    schedule on a raw wire (the slot image is reinterpreted bytes),
    whatever the layer backend.

    The reference's ledger is filled while it traces, and a ``lax.scan``
    over layer periods traces each period position once: its per-block
    tags count once per traced position, which is this table by default.
    The port runs every layer, so its ledger holds every layer's traffic:
    ``eager=True`` counts the per-block tags once a layer.  On FSDP
    weights (``fsdp``, a data axis of more than one rank) the port's step
    gathers every FSDP leaf over the data ring, a layer's as it runs:
    ``eager=True`` counts those gathers under ``fsdp.gather`` (the data
    ring's own channel, outside the pool's prefix).  The reference's
    continuous runtime gathers nothing there (ROADMAP.md §3), and its
    table has no such term."""
    from ..transport.registry import resolve_comm_mode

    dp, tp = int(mesh_shape[0]), int(mesh_shape[1])
    base_mode, key = resolve_comm_mode(settings.comm_mode)
    if base_mode != "smi":
        raise ValueError(f"predict_decode_step_stats models smi comm modes; got "
                         f"{settings.comm_mode!r}")
    esz = 2 if cfg.dtype == "bfloat16" else 4
    B = int(batch_slots)
    D = cfg.d_model
    acc: dict = {}

    def add(tag, steps, nbytes):
        e = acc.setdefault(prefix + tag, {"steps": 0, "bytes": 0})
        e["steps"] += int(steps)
        e["bytes"] += int(nbytes)

    def ring(tag, leaves, P, n_shifts=None, tkey=key):
        if P <= 1:
            return
        ns = (P - 1) if n_shifts is None else n_shifts
        s, b = _shift_cost(leaves, tkey, pkt_elems=pkt_elems, slack_steps=slack_steps)
        add(tag, s * ns, b * ns)

    def psum(tag, nbytes, n=1):
        if tp > 1:
            add(tag, n, nbytes * n)

    def allreduce(tag, elems, itemsize=None):
        # _stream_allreduce_impl: pad to a tp multiple, RS + AG =
        # 2*(tp-1) shifts of the padded ring chunk
        m = -(-int(elems) // tp)
        ring(tag, [(m, esz if itemsize is None else itemsize, True)], tp,
             n_shifts=2 * (tp - 1))

    def act(elems):
        return [(int(elems), esz, True)]

    # embed: one partial-sum tally of the (B, D) embedding
    psum("tp.embed", B * D * esz)

    period = len(cfg.pattern)
    n_full = cfg.n_layers // period
    rem = cfg.n_layers % period
    if eager:
        blocks = list(cfg.pattern) * n_full + list(cfg.pattern[:rem])
    else:
        blocks = (list(cfg.pattern) if n_full > 0 else []) + list(cfg.pattern[:rem])
    hd = cfg.hd
    Hp = -(-cfg.n_heads // tp) * tp

    for kind in blocks:
        if tp <= 1:
            break
        if kind in ("attn", "moe"):
            # query-head gather (1, B, H_loc*hd) and the four softmax /
            # out-projection partial-sum tallies (m, l float32; o float32;
            # y in the model dtype)
            ring("tp.attn.qkv", act(B * Hp * hd // tp), tp)
            psum("tp.attn.out", B * Hp * 4)
            psum("tp.attn.out", B * Hp * 4)
            psum("tp.attn.out", B * Hp * hd * 4)
            psum("tp.attn.out", B * D * esz)
        if kind == "attn" or (kind == "moe" and cfg.shared_expert):
            allreduce("tp.mlp.down", B * D)
        if kind == "moe":
            allreduce("ep.combine", B * D)
        if kind == "ssm":
            allreduce("ssm.out", B * D)
        if kind == "rec":
            allreduce("ssm.out", B * D)
            allreduce("tp.mlp.down", B * D)

    # slot migrations: a gather and a scatter leg, one rank's (1, N) uint8
    # image a shift, static and raw whatever the layers' backend
    if migrations and tp > 1:
        n = _slot_nbytes(cfg, tp, capacity)
        ring("migrate", [(n, 1, False)], tp, n_shifts=2 * (tp - 1) * int(migrations),
             tkey="static")

    if fsdp and eager and dp > 1:
        for loc_elems in _fsdp_leaf_walk(cfg, dp, tp, n_full, eager=True)[0]:
            s, b = _shift_cost(act(loc_elems), key, pkt_elems=pkt_elems, slack_steps=slack_steps)
            e = acc.setdefault("fsdp.gather", {"steps": 0, "bytes": 0})
            e["steps"] += s * (dp - 1)
            e["bytes"] += b * (dp - 1)

    return {t: acc[t] for t in sorted(acc)}
