"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

``ops`` is the entry point (CUDA kernel for CUDA tensors, plain version for
CPU tensors); ``ref`` holds the plain versions; ``ellmean``, ``hindex`` and
``topk`` wrap the CUDA sources in ``repro_torch/csrc/`` and count their
launches; ``build`` compiles those sources with ``nvcc`` at first use.
"""
