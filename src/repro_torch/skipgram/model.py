"""SGNS embedding model: parameters and the batch loss.

The torch counterpart of ``repro.skipgram.model``. Two embedding tables
(input/"center" and output/"context"), as in word2vec; the final node
representation is ``emb_in`` (gensim convention, matching the paper's
DeepWalk setup). The row gathers are torch indexing outside the kernel, as
in the JAX package; the gradient of ``emb_out``, which is gathered twice
(contexts and negatives), is the sum of both scatter-adds that autograd of
the indexing gives.

Every step gives the same bits from the same state, which crash recovery
needs (a replayed retrain must rebuild the table it built before). On CUDA
the indexing's backward sorts the ids and sums each id's rows in order. On
the CPU it adds with atomics across threads, in an order that changes from
run to run, so there the rows are summed by ``_SortedRows`` instead: the
ids sorted stably, one segment sum per id.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import is_dtensor, sharded_rows
from repro_torch.kernels import ops
from repro_torch.train.optim import AdamState

__all__ = ["init_params", "init_rows", "batch_loss", "from_jax_params",
           "Params"]

Params = Dict[str, torch.Tensor]
INIT_CHUNK_ROWS = 1 << 16  # rows of ``init_rows``' draws, at most


def init_params(n_nodes: int, dim: int, gen: torch.Generator,
                dtype=torch.float32, *, device="cuda") -> Params:
    """word2vec-style init: uniform(-0.5, 0.5)/dim for input, zeros for
    output; ``gen`` must live on ``device``."""
    device = resolve_device(device)
    u = torch.rand((n_nodes, dim), generator=gen, device=device)
    emb_in = (u - 0.5) / dim
    emb_out = torch.zeros((n_nodes, dim), device=device)
    return {"emb_in": emb_in.to(dtype), "emb_out": emb_out.to(dtype)}


def init_rows(lo: int, hi: int, n_nodes: int, dim: int, seed: int,
              dtype=torch.float32, *, device="cuda") -> torch.Tensor:
    """Rows ``lo:hi`` of the input table of ``init_params``' law
    (uniform(-0.5, 0.5)/dim) for a table of ``n_nodes`` rows, drawn chunk
    by chunk (``INIT_CHUNK_ROWS`` rows, at most 1/64 of the table): chunk c
    from a generator on ``device`` seeded by (seed, c) alone, drawn whole
    and cut to the rows asked for. So any range of rows is the same rows
    of the whole table bit for bit (a rank's shard of a row-split table
    draws its own chunks and no more), and no draw is larger than a
    chunk."""
    device = resolve_device(device)
    n = max(1, min(INIT_CHUNK_ROWS, n_nodes >> 6))
    out = torch.empty((hi - lo, dim), dtype=dtype, device=device)
    for c in range(lo // n, -(-hi // n)):
        gen = torch.Generator(device=device).manual_seed((seed << 32) + c)
        u = torch.rand((n, dim), generator=gen, device=device)
        a, b = max(lo, c * n), min(hi, (c + 1) * n)
        out[a - lo:b - lo] = ((u[a - c * n:b - c * n] - 0.5) / dim).to(dtype)
    return out


class _SortedRows(torch.autograd.Function):
    """``table[ids]`` whose backward sums each id's gradient rows in the
    order of a stable sort of the ids: the same bits on every run."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return table[ids]

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        flat = ids.reshape(-1)
        order = torch.argsort(flat, stable=True)
        uniq, counts = torch.unique_consecutive(flat[order],
                                                return_counts=True)
        g = grad.reshape(flat.numel(), -1)[order]
        out = grad.new_zeros((ctx.rows, g.shape[1]))
        out[uniq] = torch.segment_reduce(g, "sum", lengths=counts)
        return out, None


def _rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with a backward that gives the same bits every run:
    CUDA's own (sorted) on the card, ``_SortedRows`` on the CPU. A
    row-sharded DTensor table is looked up by each rank in its own rows (a
    partial sum, ``distributed.sharding.sharded_rows``)."""
    if is_dtensor(table):
        return sharded_rows(table, ids)
    if table.is_cuda:
        return table[ids]
    return _SortedRows.apply(table, ids)


def batch_loss(params: Params, centers, contexts, negatives,
               impl: str = "auto") -> torch.Tensor:
    """Mean SGNS loss over a batch of (center, context, K negatives) ids."""
    c = _rows(params["emb_in"], centers)  # (B, D)
    x = _rows(params["emb_out"], contexts)  # (B, D)
    n = _rows(params["emb_out"], negatives)  # (B, K, D)
    return ops.sgns_loss(c, x, n, impl=impl).mean()


def from_jax_params(params, opt_state=None, *, device="cuda"):
    """Carry the JAX package's SGNS parameters (and optionally its Adam
    state) across: ``params`` is ``{"emb_in", "emb_out"}`` of numpy arrays;
    ``opt_state`` is the state of ``repro.train.optim.adam`` with numpy
    leaves, i.e. ``(AdamState(count, mu, nu), (), count)``. Returns
    ``(params, AdamState or None)`` as torch tensors on ``device``."""
    device = resolve_device(device)

    def t(a):
        return torch.tensor(np.asarray(a), device=device)

    p = {k: t(params[k]) for k in ("emb_in", "emb_out")}
    state: Optional[AdamState] = None
    if opt_state is not None:
        count, mu, nu = opt_state[0]
        state = AdamState(int(np.asarray(count)),
                          {k: t(mu[k]) for k in p}, {k: t(nu[k]) for k in p})
    return p, state
