from .kernel import matmul_path
from .ops import matmul
from .ref import matmul_ref

__all__ = ["matmul", "matmul_path", "matmul_ref"]
