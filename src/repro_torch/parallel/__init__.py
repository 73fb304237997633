from .layers import (
    all_reduce,
    column_parallel_linear,
    gather_sequence,
    layer_spec,
    moe_combine,
    moe_dispatch,
    parallel_embedding,
    parallel_embedding_partial,
    pmax_tagged,
    psum_tagged,
    reduce_scatter_sequence,
    ring_attention,
    row_parallel_linear,
    vocab_parallel_cross_entropy,
)

__all__ = ["all_reduce", "column_parallel_linear", "gather_sequence", "layer_spec", "moe_combine",
           "moe_dispatch", "parallel_embedding", "parallel_embedding_partial", "pmax_tagged",
           "psum_tagged", "reduce_scatter_sequence", "ring_attention", "row_parallel_linear",
           "vocab_parallel_cross_entropy"]
