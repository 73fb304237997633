from .kernel import flash_attention_kernel, flash_attention_path, flash_attention_plain
from .ops import flash_attention
from .ref import attention_chunked_ref, attention_ref

__all__ = ["attention_chunked_ref", "attention_ref", "flash_attention", "flash_attention_kernel",
           "flash_attention_path", "flash_attention_plain"]
