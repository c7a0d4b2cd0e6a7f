"""The LM side of the port: configs, layers, attention, MoE, mamba2, the
dense / MoE / SSM / hybrid model assembly and its train and serving steps
(the torch counterpart of ``repro.models``)."""
