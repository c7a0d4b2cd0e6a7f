"""PyTorch/CUDA port of the repository's system, beside the JAX package.

The JAX package (``repro``) is the reference; this package imports neither
JAX nor anything of it, keeps the old module paths and names, and runs its
hand-written Hopper kernels (``csrc/``) on CUDA tensors and their plain
PyTorch versions on CPU tensors. Entry points default to ``device="cuda"``
and raise when CUDA is absent; the tests pass ``device="cpu"``.
"""
