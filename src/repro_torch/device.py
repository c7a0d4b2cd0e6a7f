"""Device selection shared by the port's constructors and entry points.

Every entry point takes an explicit ``device`` and defaults to ``"cuda"``.
Asking for CUDA on a machine without it raises: the port never drops to the
CPU on its own, and runs there only when the caller passes ``"cpu"``.
``"meta"`` builds shapes and dtypes with no storage (the dry run's
parameter, optimizer and cache trees at full width; the counterpart of
``jax.eval_shape``).
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "synchronize"]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with a concrete CUDA index; raises
    when CUDA is asked for and absent, or for a device type other than
    cuda, cpu and meta."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available; "
                "pass device='cpu' to run the plain PyTorch versions"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda', 'cpu' "
                         "or 'meta'")
    return dev


def synchronize(dev: torch.device) -> None:
    """Wait for ``dev``'s queued work (a no-op on the CPU): timings read
    after it cover the device's work, not only its enqueueing."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
