"""repro_torch: the SMI reproduction in PyTorch, for an NVIDIA H100.

The PyTorch port of the JAX package ``repro``, which stays the reference.
All P ranks run on one card as the leading dimension of every tensor (see
:mod:`repro_torch.core.comm`).  This package imports neither JAX nor
anything of ``repro``.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; on a CUDA tensor every kernel wrapper launches its
hand-written CUDA kernel, on a CPU tensor its plain PyTorch version.
"""
