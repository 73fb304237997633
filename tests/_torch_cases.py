"""The collective cases the port's tests run on every wire: name ->
(call, rank-stacked numpy input).  One call serves both packages: it takes
(collectives module, comm, transport, x, Plan class).  numpy only, so a
test module that needs no JAX can import it."""

import numpy as np

P = 8


def _f32(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _i32(*shape, seed=0):
    return np.random.RandomState(seed).randint(-1000, 1000, size=shape).astype(np.int32)


CASES = {
    "allgather": (lambda m, c, t, x, _: m.stream_allgather(x, c, transport=t), _f32(P, 2, 3)),
    "allgather_bidir": (lambda m, c, t, x, _: m.stream_allgather(x, c, bidir=True, transport=t),
                        _f32(P, 2, 3, seed=1)),
    "reduce_scatter": (lambda m, c, t, x, _: m.stream_reduce_scatter(x, c, transport=t),
                       _f32(P, P * 2, 3, seed=2)),
    "allreduce": (lambda m, c, t, x, _: m.allreduce(x, c, plan=None, transport=t),
                  _f32(P, 13, 3, seed=3)),
    "allreduce_bidir": (lambda m, c, t, x, _: m.allreduce(x, c, plan=None, transport=t,
                                                          bidir=True), _f32(P, 40, seed=4)),
    "allreduce_int32": (lambda m, c, t, x, _: m.allreduce(x, c, plan=None, transport=t),
                        _i32(P, 21, seed=5)),
    "alltoall": (lambda m, c, t, x, _: m.stream_alltoall(x, c, transport=t),
                 _f32(P, P, 2, 3, seed=6)),
    "bcast_chain": (lambda m, c, t, x, _: m._stream_bcast_impl(x, c, root=3, n_chunks=2,
                                                               transport=t), _f32(P, 8, 3, seed=7)),
    "reduce_chain": (lambda m, c, t, x, _: m._stream_reduce_impl(x, c, root=5, n_chunks=4,
                                                                 transport=t), _f32(P, 8, 3, seed=8)),
    "gather": (lambda m, c, t, x, _: m._stream_gather_impl(x, c, root=2, transport=t),
               _f32(P, 2, 3, seed=9)),
    "scatter": (lambda m, c, t, x, _: m._stream_scatter_impl(x, c, root=6, transport=t),
                _f32(P, P * 2, 3, seed=10)),
    "tree_bcast": (lambda m, c, t, x, _: m.tree_bcast(x, c, root=1, transport=t),
                   _f32(P, 5, 3, seed=11)),
    "tree_reduce": (lambda m, c, t, x, _: m.tree_reduce(x, c, root=4, transport=t),
                    _f32(P, 5, 3, seed=12)),
    "staged_bcast": (lambda m, c, t, x, _: m.staged_bcast(x, c, root=2, transport=t),
                     _f32(P, 5, 3, seed=13)),
    "staged_reduce": (lambda m, c, t, x, _: m.staged_reduce(x, c, root=7, transport=t),
                      _f32(P, 5, 3, seed=14)),
    "bcast_plan_chunks": (lambda m, c, t, x, plan: m.bcast(x, c, root=0, transport=t,
                                                           plan=plan("static", 4, "ring")),
                          _f32(P, 12, seed=15)),
    "reduce_plan_chunks": (lambda m, c, t, x, plan: m.reduce(x, c, root=6, transport=t,
                                                             plan=plan("static", 3, "ring")),
                           _f32(P, 12, seed=16)),
    "reduce_plan_tree": (lambda m, c, t, x, plan: m.reduce(x, c, root=1, transport=t,
                                                           plan=plan("static", 1, "tree")),
                         _f32(P, 12, seed=17)),
    "bcast_plan_staged": (lambda m, c, t, x, plan: m.bcast(x, c, root=5, transport=t,
                                                           plan=plan("static", 1, "staged")),
                          _f32(P, 12, seed=18)),
}
