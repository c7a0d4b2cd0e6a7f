"""Gradient compression with error feedback (int8), on tensors.

The torch counterpart of ``repro.distributed.compression``: symmetric
per-tensor int8 quantisation whose residual (what the int8 grid lost) is
added to the next step's gradient (Seide et al. 2014), so the compression
error telescopes instead of accumulating. ``compress_decompress`` is the
wire format's round trip; on one card there is no all-reduce to shrink, so
it runs the arithmetic that the reduce would see.

The caller carries the returned ``EFState`` into the next step. The JAX
launcher stores it from inside its jitted step, where it is a tracer, so
there every step compresses from a zero residual (``ROADMAP.md`` queue 3);
the port's launcher carries the real tensors.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.train.tree import leaves, leaves_up_to, tree_map, unflatten

__all__ = ["EFState", "ErrorFeedbackInt8", "quantize_int8",
           "dequantize_int8"]


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8: returns (q, scale), scale a 0-dim fp32
    tensor."""
    xf = x.float()
    scale = xf.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


class EFState(NamedTuple):
    residual: Any


class ErrorFeedbackInt8:
    def init(self, params) -> EFState:
        return EFState(tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params))

    def compress_decompress(self, grads, state: EFState):
        """Returns (the decompressed grads, fp32, as the all-reduce would
        deliver them; the new state)."""
        deq, res = [], []
        for g, r in zip(leaves(grads),
                        leaves_up_to(grads, state.residual)):
            corrected = g.float() + r
            d = dequantize_int8(*quantize_int8(corrected))
            deq.append(d)
            res.append(corrected - d)
        return unflatten(grads, deq), EFState(unflatten(grads, res))
