"""Random-walk engine of the port (uniform and node2vec walks on the device)."""
