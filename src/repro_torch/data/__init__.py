"""Token data for LM training: a copy of the JAX package's ``repro.data``."""
