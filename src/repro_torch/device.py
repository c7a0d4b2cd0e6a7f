"""Device selection shared by the port's constructors and entry points.

Every entry point takes an explicit ``device`` and defaults to ``"cuda"``.
Asking for CUDA on a machine without it raises: the port never drops to the
CPU on its own, and runs there only when the caller passes ``"cpu"``.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "synchronize"]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with a concrete CUDA index; raises
    when CUDA is asked for and absent, or for any other device type."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available; "
                "pass device='cpu' to run the plain PyTorch versions"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def synchronize(dev: torch.device) -> None:
    """Wait for ``dev``'s queued work (a no-op on the CPU): timings read
    after it cover the device's work, not only its enqueueing."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
