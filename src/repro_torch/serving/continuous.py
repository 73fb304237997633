"""Continuous-batching serve loop (``repro.serving.continuous``),
single-device.

* per-slot positions: ``pos`` is a (B,) vector, so every slot advances on
  its own;
* per-slot admission and invalidation: a request lands in any free slot;
  :func:`reset_slot` clears exactly that slot's rows of every cache leaf;
* prefill/decode overlap: newly admitted slots replay their prompts through
  the same decode step their batch-mates generate in;
* migration: a slot's cache rows, packed into one byte image
  (:func:`pack_slot`), move to another slot (:func:`unpack_slot`), with
  decode ticks of the other slots in between.

The cache helpers update the cache in place and return it (the reference
returns new arrays).  Tensor parallelism, and with it the persistent
channel pool and the streamed migration legs, waits for the TP slice.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mesh.api import TP_ROADMAP, ParallelCtx
from ..models import lm_caches, lm_decode_step
from ..models.common import tree_leaves_with_path
from ..models.model import _cast, model_dtype
from .engine import Request, params_device

#: sentinel occupying a slot whose cache image is in flight (migration):
#: not decodable, not admittable
_MIGRATING = object()


# ------------------------------------------------------------- cache rows
#
# Cache trees are {"periods": tuple of stacked block trees, "rem": tuple of
# block trees} (models/transformer.py): leaves under "periods" carry a
# leading layer dim, so their batch dim is 1; everything else is batch-dim
# 0.  ``slot_pos`` leaves hold -1 for "no entry".


def _batch_dim(path) -> int:
    return 1 if "periods" in path else 0


def _slot_rows(caches, slot: int):
    """[(path, leaf, the leaf's rows of ``slot`` as a view)] in flatten order."""
    return [(path, leaf, leaf.select(_batch_dim(path), int(slot)))
            for path, leaf in tree_leaves_with_path(caches)]


def reset_slot(caches, slot):
    """Invalidate one batch slot across every cache leaf, in place: its
    ``slot_pos`` rows go to -1 (no valid entry), all other state to 0.  The
    other slots' rows are untouched."""
    for path, _, rows in _slot_rows(caches, slot):
        rows.fill_(-1 if "slot_pos" in path else 0)
    return caches


def copy_slot(caches, src, dst):
    """Slot-to-slot row copy, in place: the exactness oracle of migration."""
    for path, leaf, rows in _slot_rows(caches, dst):
        rows.copy_(leaf.select(_batch_dim(path), int(src)))
    return caches


def pack_slot(caches, slot) -> torch.Tensor:
    """One slot's rows across every cache leaf as a flat (N,) uint8 image,
    leaves in flatten order, each row's bytes as they lie (a copy)."""
    return torch.cat([rows.contiguous().reshape(-1).view(torch.uint8)
                      for _, _, rows in _slot_rows(caches, slot)])


def unpack_slot(caches, image: torch.Tensor, slot):
    """Inverse of :func:`pack_slot`: write the uint8 image back into
    ``slot``'s rows across every cache leaf, in place."""
    slots = _slot_rows(caches, slot)
    total = sum(rows.numel() * leaf.element_size() for _, leaf, rows in slots)
    if image.dtype != torch.uint8 or image.numel() != total:
        raise ValueError(f"a {image.dtype} image of {image.numel()} for a slot of {total} bytes")
    off = 0
    for _, leaf, rows in slots:
        nbytes = rows.numel() * leaf.element_size()
        piece = image[off:off + nbytes].clone()   # a fresh, aligned buffer
        rows.copy_(piece.view(leaf.dtype).reshape(rows.shape))
        off += nbytes
    return caches


# ------------------------------------------------------------- the engine


class ContinuousEngine:
    """Continuous-batching serve loop; greedy sampling, deterministic.

    A request's greedy output equals the wave engine's for the same params:
    each slot's computation depends only on its own row (per-slot positions,
    per-row cache masking), so batch-mates, and when they were admitted,
    cannot perturb it.
    """

    def __init__(self, cfg, params, *, ctx: ParallelCtx | None = None, batch_slots: int = 4,
                 capacity: int = 128, eos: int | None = None, runtime: dict | None = None):
        if runtime is not None:
            raise NotImplementedError(f"a tensor-parallel serving runtime: {TP_ROADMAP}")
        self.cfg = cfg
        self.params = _cast(params, model_dtype(cfg))
        self.device = params_device(params)
        self.eos = eos
        self.ctx = ctx or ParallelCtx()
        if self.ctx.tp > 1:
            raise NotImplementedError(f"serving at tp = {self.ctx.tp}: {TP_ROADMAP}")
        self.B = B = batch_slots
        self.capacity = capacity
        self.caches = lm_caches(cfg, B, capacity, self.ctx, self.device)
        self.slot_req: list = [None] * B
        self.queue: list[Request] = []
        self.pos = np.zeros(B, dtype=np.int32)      # per-slot next position
        self.cursor = np.zeros(B, dtype=np.int64)   # per-slot prompt cursor
        self._cur = np.zeros((B,), dtype=np.int32)
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
                reset_slot(self.caches, i)
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
        logits, self.caches = lm_decode_step(
            self.params, self.caches, torch.from_numpy(self._cur).to(self.device),
            torch.from_numpy(self.pos).to(self.device), self.cfg, self.ctx)
        self.decode_steps += 1
        nxt = logits.argmax(dim=1).cpu().numpy()
        done: list[Request] = []
        for i, req in enumerate(self.slot_req):
            if not self._active(req):
                continue
            self.pos[i] += 1
            self.cursor[i] += 1
            if self.cursor[i] >= len(req.prompt):
                tok = int(nxt[i])
                req.out.append(tok)
                self._cur[i] = tok
                if len(req.out) >= req.max_new or (self.eos is not None and tok == self.eos):
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
        """Move the request in slot ``src`` into free slot ``dst`` through
        its packed cache image: ``overlap_ticks`` decode ticks for the other
        slots run while the image is held.  Both slots are out of decoding
        and admission meanwhile."""
        req = self.slot_req[src]
        if not self._active(req):
            raise ValueError(f"slot {src} holds no request")
        if self.slot_req[dst] is not None:
            raise ValueError(f"slot {dst} is not free")
        inflight = pack_slot(self.caches, src)
        self.slot_req[src] = _MIGRATING
        self.slot_req[dst] = _MIGRATING
        state = (self.pos[src], self.cursor[src], self._cur[src].copy())
        for _ in range(overlap_ticks):
            self.tick()
        unpack_slot(self.caches, inflight, dst)
        self.slot_req[src] = None
        self.slot_req[dst] = req
        self.pos[dst], self.cursor[dst], self._cur[dst] = state
        return req
