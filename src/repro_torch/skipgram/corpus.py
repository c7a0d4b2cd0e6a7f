"""Walk corpus construction and SGNS batch sampling.

The torch counterpart of ``repro.skipgram.corpus``. The corpus is the set of
random walks (W, L) generated from a WalkPlan — the *size* of this corpus is
what the paper's CoreWalk shrinks. Training samples (center, context) pairs
exactly like word2vec: uniform walk, uniform position, uniform offset in
[1, window] with random sign (reflected at the walk's ends), and draws K
negatives from the unigram^0.75 noise distribution over corpus token
counts. Walks and samples live on the walks' device; draws come from the
caller's ``torch.Generator``.

Epoch accounting follows the paper: one epoch = ``pairs_per_walk * n_real``
sampled pairs, so a smaller corpus (CoreWalk / k-core) trains in
proportionally fewer steps — the hardware-independent speedup.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.corewalk import WalkPlan
from repro_torch.graph.csr import EllGraph
from repro_torch.walks.engine import node2vec_walks, random_walks

__all__ = ["WalkCorpus", "build_corpus", "noise_cdf", "sample_positions",
           "sample_batch"]


@dataclasses.dataclass
class WalkCorpus:
    walks: torch.Tensor  # (W, L) int32, padding walks included
    n_real: int  # number of real (non-padding) walks
    length: int
    noise_cdf: torch.Tensor  # (V,) float32 cumulative unigram^0.75
    n_nodes: int

    @property
    def n_tokens(self) -> int:
        return self.n_real * self.length

    def pairs_per_epoch(self, window: int) -> int:
        # every position pairs with ~window contexts on average (edge-clipped)
        return self.n_real * self.length * window


def noise_cdf(walks: torch.Tensor, n_real: int, n_nodes: int) -> np.ndarray:
    """(V,) float32 cumulative unigram^0.75 distribution of the real walks'
    tokens. The counts are exact integers (``bincount`` on the walks'
    device); the powers and the cumulative sum are float64 on the host, as
    in ``corpus.py:69-75``."""
    counts = torch.bincount(walks[:n_real].reshape(-1).long(),
                            minlength=n_nodes)
    probs = counts.cpu().numpy().astype(np.float64) ** 0.75
    total = probs.sum()
    probs = probs / total if total > 0 else np.full_like(probs, 1.0 / len(probs))
    return np.cumsum(probs).astype(np.float32)


def build_corpus(
    ell: EllGraph,
    plan: WalkPlan,
    length: int,
    gen: torch.Generator,
    *,
    p: float = 1.0,
    q: float = 1.0,
    chunk: int = 65536,
) -> WalkCorpus:
    """Run the plan's walks in bounded-memory chunks of ``chunk`` roots and
    assemble the corpus on the ELL's device."""
    roots = torch.as_tensor(plan.roots, dtype=torch.int32).to(ell.device)
    outs = []
    for start in range(0, plan.n_slots, chunk):
        sub = roots[start : start + chunk]
        if p == 1.0 and q == 1.0:
            outs.append(random_walks(ell, sub, length, gen))
        else:
            outs.append(node2vec_walks(ell, sub, length, gen, p=p, q=q))
    walks = torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]
    cdf = noise_cdf(walks, plan.n_real, ell.n_nodes)
    return WalkCorpus(
        walks=walks,
        n_real=plan.n_real,
        length=length,
        noise_cdf=torch.from_numpy(cdf).to(ell.device),
        n_nodes=ell.n_nodes,
    )


def sample_positions(gen: torch.Generator, batch: int, window: int,
                     length: int, n_real: int, device):
    """-> walk w, center position i and context position j, each (B,)
    int64: i uniform in [0, length), |j - i| uniform in [1, window] with a
    random sign, reflected back into the walk at its ends."""
    w = torch.randint(0, n_real, (batch,), generator=gen, device=device)
    i = torch.randint(0, length, (batch,), generator=gen, device=device)
    off = torch.randint(1, window + 1, (batch,), generator=gen, device=device)
    sign = torch.randint(0, 2, (batch,), generator=gen, device=device) * 2 - 1
    j = i + sign * off
    # reflect at the boundaries (keeps offset magnitude, stays in-walk)
    j = torch.where(j < 0, i + off, j)
    j = torch.where(j >= length, i - off, j)
    return w, i, j


def sample_batch(corpus: WalkCorpus, gen: torch.Generator, *, batch: int,
                 window: int, n_neg: int):
    """-> centers (B,), contexts (B,), negatives (B, K) int64 node ids."""
    walks = corpus.walks
    w, i, j = sample_positions(gen, batch, window, corpus.length,
                               corpus.n_real, walks.device)
    centers = walks[w, i].long()
    contexts = walks[w, j].long()
    u = torch.rand((batch, n_neg), generator=gen, device=walks.device)
    negatives = torch.searchsorted(corpus.noise_cdf, u)
    negatives = negatives.clamp_max(corpus.noise_cdf.shape[0] - 1)
    return centers, contexts, negatives
