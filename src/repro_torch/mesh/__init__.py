from .api import ParallelCtx, PartitionSpec, make_ctx

__all__ = ["ParallelCtx", "PartitionSpec", "make_ctx"]
