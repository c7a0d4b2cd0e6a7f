"""The LM side of the port: configs, layers, attention, the dense
transformer and its serving steps (the torch counterpart of
``repro.models``)."""
