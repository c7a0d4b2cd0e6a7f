"""Optimizers of the port (the Adam that SGNS and the link-prediction fit use)."""
