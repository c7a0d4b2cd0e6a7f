"""Small shared helpers for the serve package."""
from __future__ import annotations

__all__ = ["pow2"]


def pow2(n: int) -> int:
    """Smallest power of two >= n (and >= 1).

    The repair's candidate matrices pad their dimensions to this, as in the
    JAX package.
    """
    return 1 << max(int(n) - 1, 0).bit_length()
