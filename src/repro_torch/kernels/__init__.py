"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each kernel's wrapper launches the kernel on a CUDA tensor and runs the
plain version on a CPU tensor; ``build`` compiles the sources at first use.
"""
