"""Continuous-batching serve loop on persistent SMI channels
(``repro.serving.continuous``).

* per-slot positions: ``pos`` is a (B,) vector, so every slot advances on
  its own;
* per-slot admission and invalidation: a request lands in any free slot;
  :func:`reset_slot` clears exactly that slot's rows of every cache leaf;
* prefill/decode overlap: newly admitted slots replay their prompts through
  the same decode step their batch-mates generate in;
* persistent channels: under tensor parallelism the decode step's layer
  channels come from a :class:`~repro_torch.channels.ChannelPool` carried
  by the runtime's context (``launch.steps.build_continuous_serve``): one
  persistent spec a layer tag, claimed once, reused every step, released
  only at :meth:`ContinuousEngine.shutdown`;
* streamed migration: a slot's cache rows, packed into one byte image a
  rank (:func:`pack_slot`), stream to the root over the pool's persistent
  gather channel and back out over its scatter channel, both tallied under
  ``serve.migrate``, with decode ticks of the other slots between the two
  legs while the image is in flight.

Migration always rides the lossless static schedule on a raw wire: the
image is reinterpreted bytes (bfloat16 KV, int32 positions, float32 state).
The cache helpers update the cache in place and return it (the reference
returns new arrays); at tp = P > 1 they take ``tp`` and the caches' rank
dimension.
"""

from __future__ import annotations

import numpy as np
import torch

from ..channels.channel import _tagged
from ..core.collectives import _stream_gather_impl, _stream_scatter_impl
from ..mesh.api import ParallelCtx
from ..models import lm_caches
from ..models.common import tree_leaves_with_path
from ..models.model import _cast, model_dtype
from ..parallel import ledger
from .engine import Request, emitted, hit_eos, local_step, params_device, token_shape

#: the stats tag migration traffic tallies under (pool-prefixed:
#: ``serve.migrate``); the gather and scatter legs share it
MIGRATE_TAG = "migrate"

#: sentinel occupying a slot whose cache image is in flight (migration):
#: not decodable, not admittable
_MIGRATING = object()


# ------------------------------------------------------------- cache rows
#
# Cache trees are {"periods": tuple of stacked block trees, "rem": tuple of
# block trees} (models/transformer.py): leaves under "periods" carry a
# leading layer dim; at tp > 1 every leaf then carries the rank dim (the
# SSM's replicated ``conv_bc`` too, a copy a rank, so that a rank's slot
# image holds the reference's device-local bytes); the batch dim follows.
# ``slot_pos`` leaves hold -1 for "no entry".


def cache_batch_dim(path, tp: int = 1) -> int:
    """The batch (slot) dimension of a cache leaf at ``path``."""
    return int("periods" in path) + int(tp > 1)


def _slot_rows(caches, slot: int, tp: int):
    """[(path, leaf, the leaf's rows of ``slot`` as a view)] in flatten order."""
    return [(path, leaf, leaf.select(cache_batch_dim(path, tp), int(slot)))
            for path, leaf in tree_leaves_with_path(caches)]


def _rank_first(path, rows: torch.Tensor, tp: int) -> torch.Tensor:
    """A slot's rows with the rank dimension first (tp > 1)."""
    return rows if tp == 1 else rows.movedim(int("periods" in path), 0)


def reset_slot(caches, slot, tp: int = 1):
    """Invalidate one batch slot across every cache leaf, in place: its
    ``slot_pos`` rows go to -1 (no valid entry), all other state to 0.  The
    other slots' rows are untouched."""
    for path, _, rows in _slot_rows(caches, slot, tp):
        rows.fill_(-1 if "slot_pos" in path else 0)
    return caches


def copy_slot(caches, src, dst, tp: int = 1):
    """Slot-to-slot row copy, in place: the exactness oracle of migration."""
    for path, leaf, rows in _slot_rows(caches, dst, tp):
        rows.copy_(leaf.select(cache_batch_dim(path, tp), int(src)))
    return caches


def pack_slot(caches, slot, tp: int = 1) -> torch.Tensor:
    """One slot's rows across every cache leaf as a flat uint8 image, leaves
    in flatten order, each row's bytes as they lie (a copy): (N,) at tp = 1,
    each rank's own (P, N) at tp = P > 1."""
    lead = () if tp == 1 else (tp,)
    return torch.cat([_rank_first(path, rows, tp).reshape(lead + (-1,)).contiguous()
                      .view(torch.uint8) for path, _, rows in _slot_rows(caches, slot, tp)],
                     dim=-1)


def unpack_slot(caches, image: torch.Tensor, slot, tp: int = 1):
    """Inverse of :func:`pack_slot`: write the uint8 image ((N,), or (P, N)
    at tp = P > 1) back into ``slot``'s rows across every cache leaf, in
    place."""
    slots = _slot_rows(caches, slot, tp)
    total = sum(rows.numel() // tp * leaf.element_size() for _, leaf, rows in slots)
    want = (total,) if tp == 1 else (tp, total)
    if image.dtype != torch.uint8 or tuple(image.shape) != want:
        raise ValueError(f"a {image.dtype} image of shape {tuple(image.shape)} for a slot of "
                         f"{want} bytes")
    off = 0
    for path, leaf, rows in slots:
        nbytes = rows.numel() // tp * leaf.element_size()
        piece = image[..., off:off + nbytes].clone()   # a fresh, aligned buffer
        dst = _rank_first(path, rows, tp)
        dst.copy_(piece.view(leaf.dtype).reshape(dst.shape))
        off += nbytes
    return caches


# --------------------------------------------------------- migration legs


def open_migration(pool):
    """The persistent gather/scatter channel pair one engine's migrations
    ride: both tagged ``serve.migrate``, both pinned to the lossless static
    schedule on a raw wire (the image is reinterpreted bytes)."""
    g = pool.spec(MIGRATE_TAG, kind="gather", transport="static", wire="raw",
                  key=pool.retag(MIGRATE_TAG) + "#gather")
    s = pool.spec(MIGRATE_TAG, kind="scatter", transport="static", wire="raw",
                  key=pool.retag(MIGRATE_TAG) + "#scatter")
    return g, s


def migrate_gather(caches, slot, gspec, tp: int):
    """Start leg: pack ``slot``'s rows on every rank and stream each rank's
    image to the root over the persistent gather channel.  Returns the
    in-flight (P, P, N) buffer (meaningful at the root)."""
    image = pack_slot(caches, slot, tp)
    t = ledger.attach(gspec.resolve())
    with _tagged(t, gspec.stats_tag):
        return _stream_gather_impl(image[:, None], gspec.comm, root=gspec.root, transport=t)


def migrate_scatter(caches, inflight, slot, sspec, tp: int):
    """Finish leg: stream each rank's image back out of the root over the
    persistent scatter channel and write it into ``slot``'s rows."""
    t = ledger.attach(sspec.resolve())
    with _tagged(t, sspec.stats_tag):
        image = _stream_scatter_impl(inflight, sspec.comm, root=sspec.root, transport=t)
    return unpack_slot(caches, image[:, 0], slot, tp)


def local_runtime(cfg, ctx, batch_slots: int, capacity: int, device, fsdp_plan=None) -> dict:
    """The runtime of an engine on ``ctx`` alone: the transient channel
    lifecycle (no pool), and migration holding the image locally, as the
    reference's engine does without a TP runtime.  ``fsdp_plan`` gathers
    FSDP-stored params in the step."""
    tp = ctx.tp
    return dict(
        ctx=ctx, pool=None, step=local_step(cfg, ctx, fsdp_plan), batch_slots=batch_slots,
        capacity=capacity,
        init_caches=lambda: lm_caches(cfg, batch_slots, capacity, ctx, device),
        reset=lambda caches, slot: reset_slot(caches, slot, tp),
        migrate_start=lambda caches, slot: pack_slot(caches, slot, tp),
        migrate_finish=lambda caches, image, slot: unpack_slot(caches, image, slot, tp))


# ------------------------------------------------------------- the engine


class ContinuousEngine:
    """Continuous-batching serve loop; greedy sampling, deterministic.

    Runs on ``ctx`` (tp = 1 unless given) with the transient channel
    lifecycle; pass the ``runtime`` dict of
    :func:`repro_torch.launch.steps.build_continuous_serve` to run its
    tensor-parallel decode step on the persistent channels of its pool.
    A request's greedy output equals the wave engine's for the same params:
    each slot's computation depends only on its own row (per-slot
    positions, per-row cache masking), so batch-mates, and when they were
    admitted, cannot perturb it.
    """

    def __init__(self, cfg, params, *, ctx: ParallelCtx | None = None, batch_slots: int = 4,
                 capacity: int = 128, eos: int | None = None, runtime: dict | None = None):
        self.cfg = cfg
        self.params = _cast(params, model_dtype(cfg))
        self.device = params_device(params)
        self.eos = eos
        if runtime is None:
            runtime = local_runtime(cfg, ctx or ParallelCtx(), batch_slots, capacity,
                                    self.device)
        self.ctx = runtime["ctx"]
        self.pool = runtime.get("pool")
        self.B = B = runtime["batch_slots"]
        self.capacity = runtime["capacity"]
        self.caches = runtime["init_caches"]()
        self._step = runtime["step"]
        self._reset = runtime["reset"]
        self._mig_start = runtime["migrate_start"]
        self._mig_finish = runtime["migrate_finish"]
        self.slot_req: list = [None] * B
        self.queue: list[Request] = []
        self.pos = np.zeros(B, dtype=np.int32)      # per-slot next position
        self.cursor = np.zeros(B, dtype=np.int64)   # per-slot prompt cursor
        self._cur = np.zeros(token_shape(cfg, B), dtype=np.int32)
        self.steps_done = 0
        self.decode_steps = 0                        # decode steps run
        self.admit_step: dict[int, int] = {}   # uid -> tick admitted
        self.finish_step: dict[int, int] = {}  # uid -> tick completed

    # -- queue / admission ---------------------------------------------------

    def submit(self, req: Request):
        self.queue.append(req)

    @staticmethod
    def _active(r) -> bool:
        return r is not None and r is not _MIGRATING

    def _admit(self) -> int:
        """Admit waiting requests into free slots; only each slot's cache
        rows are invalidated."""
        n = 0
        for i in range(self.B):
            if self.slot_req[i] is None and self.queue:
                req = self.queue.pop(0)
                self.caches = self._reset(self.caches, i)
                self.slot_req[i] = req
                self.pos[i] = 0
                self.cursor[i] = 0
                self._cur[i] = 0
                self.admit_step[req.uid] = self.steps_done
                n += 1
        return n

    # -- the decode tick -----------------------------------------------------

    def tick(self) -> list[Request]:
        """Admit, run ONE decode step for every occupied slot (prompt
        replay and generation share the step), harvest completions.
        Returns the requests completed this tick."""
        self._admit()
        if not any(self._active(r) for r in self.slot_req):
            return []
        for i, req in enumerate(self.slot_req):
            if not self._active(req):
                self._cur[i] = 0
            elif self.cursor[i] < len(req.prompt):
                self._cur[i] = req.prompt[int(self.cursor[i])]
        logits, self.caches = self._step(self.params, self.caches,
                                         torch.from_numpy(self._cur).to(self.device),
                                         torch.from_numpy(self.pos).to(self.device))
        self.decode_steps += 1
        nxt = logits.argmax(dim=1).cpu().numpy()
        done: list[Request] = []
        for i, req in enumerate(self.slot_req):
            if not self._active(req):
                continue
            self.pos[i] += 1
            self.cursor[i] += 1
            if self.cursor[i] >= len(req.prompt):
                tok = emitted(nxt[i])
                req.out.append(tok)
                self._cur[i] = tok
                if len(req.out) >= req.max_new or hit_eos(tok, self.eos):
                    req.done = True
                    self.finish_step[req.uid] = self.steps_done + 1
                    done.append(req)
                    self.slot_req[i] = None   # freed now: no wave barrier
        self.steps_done += 1
        return done

    def run(self, *, max_steps: int = 256, arrivals=None) -> list[Request]:
        """Drain the queue; returns completed requests.  ``arrivals`` is an
        optional ``[(tick, Request), ...]`` schedule keyed on the engine's
        tick clock (``steps_done``)."""
        completed: list[Request] = []
        pending = sorted(arrivals, key=lambda a: a[0]) if arrivals else []
        steps = 0
        while (pending or any(r is not None for r in self.slot_req)
               or self.queue) and steps < max_steps:
            while pending and pending[0][0] <= self.steps_done:
                self.queue.append(pending.pop(0)[1])
            if not self.queue and not any(self._active(r) for r in self.slot_req):
                self.steps_done += 1  # idle tick: waiting on arrivals
                steps += 1
                continue
            completed.extend(self.tick())
            steps += 1
        return completed

    # -- migration -----------------------------------------------------------

    def migrate(self, src: int, dst: int, *, overlap_ticks: int = 0):
        """Move the request in slot ``src`` into free slot ``dst`` by
        streaming its cache image over the migration channels (at tp = 1,
        or without a pool, the image is held locally): ``overlap_ticks``
        decode ticks for the other slots run between the start and finish
        legs while the image is in flight.  Both slots are out of decoding
        and admission meanwhile."""
        req = self.slot_req[src]
        if not self._active(req):
            raise ValueError(f"slot {src} holds no request")
        if self.slot_req[dst] is not None:
            raise ValueError(f"slot {dst} is not free")
        inflight = self._mig_start(self.caches, src)
        self.slot_req[src] = _MIGRATING
        self.slot_req[dst] = _MIGRATING
        state = (self.pos[src], self.cursor[src], self._cur[src].copy())
        for _ in range(overlap_ticks):
            self.tick()
        self.caches = self._mig_finish(self.caches, inflight, dst)
        self.slot_req[src] = None
        self.slot_req[dst] = req
        self.pos[dst], self.cursor[dst], self._cur[dst] = state
        return req

    # -- lifecycle -----------------------------------------------------------

    def shutdown(self):
        """Release the pool's persistent port claims: the only point where a
        persistent channel's port returns to the allocator."""
        if self.pool is not None and not self.pool.closed:
            self.pool.close()

    def __enter__(self) -> "ContinuousEngine":
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
