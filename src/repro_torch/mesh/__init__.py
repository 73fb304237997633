from .api import ParallelCtx, make_ctx

__all__ = ["ParallelCtx", "make_ctx"]
