"""Batched serving engine (``repro.serving.engine``): prefill-as-decode and
wave batching, at any tensor-parallel degree.

A fixed-width batch of slots decodes in lock-step; when a wave of requests
completes, the caches are reset and the next wave is admitted.  The batch
shares one cache position, so this engine is the bit-exactness oracle of
:class:`~repro_torch.serving.continuous.ContinuousEngine`.  Prompts are
replayed through decode steps.  Greedy sampling; deterministic.  A codebook
model's tokens are ``(n_cb,)`` rows: its prompts are lists of them, and
``Request.out`` takes a list a step.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..mesh.api import ParallelCtx
from ..models import assemble_logits, lm_caches, lm_decode_step
from ..models.common import tree_leaves_with_path
from ..models.model import _cast, model_dtype


@dataclass
class Request:
    uid: int
    prompt: list
    max_new: int = 16
    out: list = field(default_factory=list)
    done: bool = False


def token_shape(cfg, B: int) -> tuple:
    """A decode step's token batch: (B,), or (B, n_cb) for a codebook
    model."""
    return (B, cfg.n_codebooks) if cfg.n_codebooks > 1 else (B,)


def emitted(tok: np.ndarray):
    """A greedy token as ``Request.out`` keeps it: an int, or a list of
    ``n_cb`` ints."""
    return tok.tolist() if tok.ndim else int(tok)


def hit_eos(tok, eos) -> bool:
    """Whether ``tok`` ends a request (single-stream tokens only, as in the
    reference)."""
    return eos is not None and not isinstance(tok, list) and tok == eos


def params_device(params) -> torch.device:
    """The device the params lie on (every leaf's)."""
    return tree_leaves_with_path(params)[0][1].device


def local_step(cfg, ctx, fsdp_plan=None):
    """The decode step ``step(params, caches, token, pos) -> (logits (B, V)
    or (B, V, n_cb), caches)`` of ``ctx``: at tp = P > 1 every rank's vocabulary shard,
    assembled without a wire (the reference's ``out_specs``).  ``fsdp_plan``
    gathers FSDP-stored params for ``ctx.data_group``."""
    if ctx.tp == 1:
        return lambda p, c, t, pos: lm_decode_step(p, c, t, pos, cfg, ctx, fsdp_plan=fsdp_plan)

    def step(params, caches, token, pos):
        logits, caches = lm_decode_step(params, caches, token, pos, cfg, ctx,
                                        gather_logits=False, fsdp_plan=fsdp_plan)
        return assemble_logits(logits), caches

    return step


class ServeEngine:
    """The wave engine.  Runs where ``params`` lie (at tp > 1
    :func:`~repro_torch.interop.shard_params`'s); casts them to the model
    dtype once, here, rather than on every step (the same bits).  Decodes
    on ``ctx`` (tp = 1 unless given), or on the step of ``runtime``, the
    dict of :func:`repro_torch.launch.steps.build_serve`, whose batch and
    capacity it takes."""

    def __init__(self, cfg, params, *, ctx: ParallelCtx | None = None, batch_slots: int = 4,
                 capacity: int = 128, eos: int | None = None, runtime: dict | None = None):
        self.cfg = cfg
        self.params = _cast(params, model_dtype(cfg))
        self.device = params_device(params)
        if runtime is not None:
            self.ctx = runtime["ctx"]
            batch_slots, capacity = runtime["batch"], runtime["capacity"]
            self._decode = runtime["step"]
        else:
            self.ctx = ctx or ParallelCtx()
            self._decode = local_step(cfg, self.ctx)
        self.B = batch_slots
        self.capacity = capacity
        self.eos = eos
        self.caches = lm_caches(cfg, batch_slots, capacity, self.ctx, self.device)
        self.slot_req: list[Request | None] = [None] * batch_slots
        self.queue: list[Request] = []
        self.admit_step: dict[int, int] = {}   # uid -> tick admitted
        self.finish_step: dict[int, int] = {}  # uid -> tick completed
        self.decode_steps = 0                  # decode steps run, over every run

    def submit(self, req: Request):
        self.queue.append(req)

    def _step(self, cur: np.ndarray, pos) -> np.ndarray:
        """One decode step of every slot; returns the greedy tokens (B,) or
        (B, n_cb)."""
        logits, self.caches = self._decode(self.params, self.caches,
                                           torch.from_numpy(cur).to(self.device), pos)
        self.decode_steps += 1
        return logits.argmax(dim=1).cpu().numpy()

    def _fill_wave(self):
        """Admit a new wave only when every slot is free (the cache reset
        keeps per-slot histories from leaking across requests)."""
        if any(r is not None for r in self.slot_req):
            return 0
        n = 0
        for i in range(self.B):
            if self.queue:
                self.slot_req[i] = self.queue.pop(0)
                n += 1
        if n:
            self.caches = lm_caches(self.cfg, self.B, self.capacity, self.ctx, self.device)
        return n

    def run(self, *, max_steps: int = 256, arrivals=None) -> list[Request]:
        """Drain the queue; returns completed requests.

        ``arrivals`` is an optional ``[(tick, Request), ...]`` schedule: each
        request joins the queue at its tick (idle ticks pass when nothing is
        resident yet).  ``admit_step`` / ``finish_step`` record per-uid
        admission and completion ticks either way."""
        completed: list[Request] = []
        pending = sorted(arrivals, key=lambda a: a[0]) if arrivals else []
        cur = np.zeros(token_shape(self.cfg, self.B), dtype=np.int32)
        cursor = np.zeros(self.B, dtype=np.int64)  # prompt read positions
        pos = 0
        steps = 0
        while (pending or any(r is not None for r in self.slot_req)
               or self.queue) and steps < max_steps:
            while pending and pending[0][0] <= steps:
                self.queue.append(pending.pop(0)[1])
            if all(r is None for r in self.slot_req):
                if self._fill_wave():
                    pos = 0
                    cur[:] = 0
                    cursor[:] = 0
                    for r in self.slot_req:
                        if r is not None:
                            self.admit_step[r.uid] = steps
                else:
                    steps += 1  # idle tick: waiting on arrivals
                    continue
            # the input token per slot: prompt replay or the last sample
            for i, req in enumerate(self.slot_req):
                if req is None:
                    cur[i] = 0
                elif cursor[i] < len(req.prompt):
                    cur[i] = req.prompt[int(cursor[i])]
            nxt = self._step(cur, pos)
            for i, req in enumerate(self.slot_req):
                if req is None:
                    continue
                cursor[i] += 1
                if cursor[i] >= len(req.prompt):
                    tok = emitted(nxt[i])
                    req.out.append(tok)
                    cur[i] = tok
                    if len(req.out) >= req.max_new or hit_eos(tok, self.eos):
                        req.done = True
                        self.finish_step[req.uid] = steps + 1
                        completed.append(req)
                        self.slot_req[i] = None
                        cursor[i] = 0
            pos += 1
            steps += 1
        return completed
