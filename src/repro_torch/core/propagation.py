"""Mean-embedding propagation from a k₀-core (paper §2.2, after Salha et al.).

Embeddings are computed only on the k₀-core; every lower shell is then filled
in, shell by shell (k-core -> (k-1)-core). New nodes T (core index == k-1)
satisfy the linear system

    x_t = mean_{u in N(t) ∩ ((k-1)-core)} x_u        for t in T,

solved by Jacobi-style iterative averaging; ``solve_shell_exact`` is the
oracle.

Backends:
  * ``scipy`` — CSR sparse matvec sweeps, a copy of the JAX package's (the
                paper's own implementation choice).
  * ``torch`` — ELL neighbour-mean sweeps through ``kernels.ops.ell_mean``
                (the CUDA kernel on the card), the counterpart of the JAX
                package's ``jax`` backend.
"""
from __future__ import annotations

from typing import Literal

import numpy as np
import scipy.sparse as sp
import torch

from repro_torch.device import resolve_device
from repro_torch.graph.csr import Graph
from repro_torch.kernels import ops

__all__ = ["propagate", "solve_shell_exact", "propagation_schedule"]


def propagation_schedule(core: np.ndarray, k0: int) -> list[int]:
    """Shell indices processed: k0-1, k0-2, ..., min core index present."""
    core = np.asarray(core)
    lo = int(core.min())
    return [k for k in range(k0 - 1, lo - 1, -1) if np.any(core == k)]


def _to_scipy(g: Graph) -> sp.csr_matrix:
    data = np.ones(g.n_arcs, dtype=np.float32)
    return sp.csr_matrix((data, g.indices, g.indptr), shape=(g.n_nodes, g.n_nodes))


def propagate(
    g: Graph,
    core: np.ndarray,
    k0: int,
    base_emb: np.ndarray,
    *,
    n_iters: int = 30,
    backend: Literal["scipy", "torch"] = "scipy",
    impl: str = "auto",
    device="cuda",
) -> np.ndarray:
    """Fill embeddings for all nodes below the k₀-core.

    base_emb: (n_nodes, D); rows with core >= k0 must already be embedded.
    Returns a full (n_nodes, D) float32 embedding matrix. ``device`` is
    where the ``torch`` backend sweeps; the ``scipy`` backend runs on the
    host.
    """
    core = np.asarray(core)
    x = np.array(base_emb, dtype=np.float32, copy=True)
    if backend == "scipy":
        A = _to_scipy(g)
        for k in propagation_schedule(core, k0):
            T = core == k
            allowed = core >= k
            deg_allowed = np.asarray(A[T] @ allowed.astype(np.float32)).reshape(-1)
            denom = np.maximum(deg_allowed, 1.0)[:, None]
            x[T] = 0.0
            AT = A[T].multiply(allowed.astype(np.float32)[None, :]).tocsr()
            for _ in range(n_iters):
                x[T] = (AT @ x) / denom
        return x
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r}")

    dev = resolve_device(device)
    nbr, _ = g.ell_arrays()
    core_ext = np.concatenate([core, [-1]])  # sentinel row never allowed
    xt = torch.tensor(
        np.concatenate([x, np.zeros((1, x.shape[1]), np.float32)]), device=dev
    )
    for k in propagation_schedule(core, k0):
        T = np.where(core == k)[0]
        idx_T = torch.tensor(nbr[T], device=dev)
        valid_T = torch.tensor(
            (nbr[T] != g.n_nodes) & (core_ext[nbr[T]] >= k), device=dev
        )
        rows = torch.tensor(T, device=dev)
        xt[rows] = 0.0
        for _ in range(n_iters):
            # Jacobi: the mean reads the previous sweep's table, then the
            # shell's rows are overwritten in place
            xt[rows] = ops.ell_mean(idx_T, valid_T, xt, impl=impl)
    return xt[:-1].cpu().numpy()


def solve_shell_exact(
    g: Graph, core: np.ndarray, k: int, x: np.ndarray, reg: float = 1e-6
) -> np.ndarray:
    """Exact solve of one shell's system (oracle for tests).

    Returns x with rows of shell k replaced by the exact solution of
    (D - A_TT) x_T = A_TS x_S restricted to the (k)-core-allowed neighbours.
    """
    core = np.asarray(core)
    T = np.where(core == k)[0]
    S_mask = core >= k + 1
    allowed = core >= k
    A = _to_scipy(g)
    AT = A[T].multiply(allowed.astype(np.float32)[None, :]).tocsr()
    deg = np.asarray(AT.sum(axis=1)).reshape(-1)
    A_TT = AT[:, T]
    A_TS = AT[:, S_mask]
    D = sp.diags(np.maximum(deg, 1.0))
    rhs = A_TS @ x[S_mask]
    M = (D - A_TT) + reg * sp.eye(len(T))
    x = np.array(x, copy=True)
    x[T] = sp.linalg.spsolve(M.tocsr(), rhs)
    return x
