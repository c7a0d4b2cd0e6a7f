"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

``ops`` is the entry point (CUDA kernel for CUDA tensors, plain version for
CPU tensors); ``ref`` holds the plain versions; ``ellmean``,
``flash_decode``, ``hindex``, ``sgns`` and ``topk`` wrap the CUDA sources in
``repro_torch/csrc/`` and count their launches, and while a ``cost`` tally
is open reckon each launch's bytes and operations into it; ``build``
compiles those sources with ``nvcc`` at first use.
"""
