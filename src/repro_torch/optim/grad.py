"""Gradient utilities (``repro.optim.grad``): global-norm clipping and the
end-to-end error feedback of a lossy (int8) gradient sync.

Two error-feedback levels cooperate: per hop, inside the compressed
link's ring reduce-scatter (``transport/compressed.py``), and end to end,
here: the residual between what a step meant to sync and what the lossy
ring delivered is added to the next step's gradients (EF-SGD).
"""

from __future__ import annotations

import torch

from ..models.common import tree_flatten, tree_map


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` so their global L2 norm is at most ``max_norm``;
    returns ``(grads, norm)``, the norm a float32 0-dim tensor.  The squares
    are summed in float32, leaf by leaf in the reference's flatten order; a
    rank-stacked leaf's blocks are each rank's own and a replicated leaf is
    stored once, so each element counts once.  The scale is applied in
    float32 and cast back to each leaf's dtype, in place."""
    leaves = tree_flatten(grads)
    sq = torch.zeros((), dtype=torch.float32, device=leaves[0].device if leaves else None)
    for g in leaves:
        sq = sq + (g.float() ** 2).sum()
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in leaves:
        g.copy_(g.float() * scale)
    return grads, norm


class ErrorFeedback:
    """End-to-end residual accumulator for a lossy gradient sync (EF-SGD):
    ``corrected = ef.add(state, grads)``; sync ``corrected`` over the lossy
    wire to ``synced``; ``state = ef.update(corrected, synced)``.  The
    state is a float32 tree shaped as the grads; every method returns new
    trees."""

    @staticmethod
    def init(params):
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)

    @staticmethod
    def add(ef_state, grads):
        return tree_map(lambda e, g: g.float() + e, ef_state, grads)

    @staticmethod
    def update(corrected, synced):
        # the residual: what was meant to be sent less what the lossy sync delivered
        return tree_map(lambda c, s: c - s.float(), corrected, synced)

    @classmethod
    def sync(cls, ef_state, grads, sync_fn=None, *, comm=None, tag: str = "grad",
             wire: str = "int8"):
        """Correct, sync and roll the residual; returns ``(synced,
        new_state)``.  The sync is ``sync_fn`` (any lossy all-reduce of a
        tree), or, given the data ranks' ``comm``, a ring all-reduce of
        each ``(dp, ...)`` stack over a fresh ``tag`` channel
        (:func:`~repro_torch.parallel.grad_allreduce`, the int8 wire by
        default: the compressed link's per-hop feedback stacks under this
        one)."""
        if sync_fn is None:
            if comm is None:
                raise ValueError("ErrorFeedback.sync needs sync_fn or comm")
            from ..parallel import grad_allreduce

            def sync_fn(tree):
                return tree_map(lambda g: grad_allreduce(g, comm, tag=tag, wire=wire), tree)
        corrected = cls.add(ef_state, grads)
        synced = sync_fn(corrected)
        return synced, cls.update(corrected, synced)
