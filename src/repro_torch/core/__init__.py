"""K-core decomposition and §2.2 shell propagation."""
