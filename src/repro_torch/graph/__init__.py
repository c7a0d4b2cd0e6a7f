"""Graph containers (``csr``), deterministic generators and dataset presets."""
