"""Downstream link-prediction evaluation (paper §1.2.2, §3.1.2).

The torch counterpart of ``repro.eval.linkpred``. A logistic regression is
trained on the concatenation of the two node embeddings of each candidate
pair (the paper's protocol) and scored with F1: a full-batch fit of 400
Adam steps at lr 0.05 with an L2 penalty of 1e-4, in torch on the given
device. ``auc_score`` and ``f1_score`` are copies (numpy).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.train import optim

__all__ = [
    "LinkPredResult",
    "auc_score",
    "evaluate_link_prediction",
    "f1_score",
]


def auc_score(y_true: np.ndarray, scores: np.ndarray) -> float:
    """Ranking AUC: P(score of a positive > score of a negative), ties 0.5.

    Computed from the Mann–Whitney U statistic over average ranks — no
    threshold sweep and no sklearn dependency. The serving benchmark uses
    this on raw dot-product link scores (pre/post retrain), where a logistic
    fit would conflate embedding quality with classifier training.
    """
    y = np.asarray(y_true).astype(bool).reshape(-1)
    s = np.asarray(scores, np.float64).reshape(-1)
    n_pos = int(y.sum())
    n_neg = len(y) - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    order = np.argsort(s, kind="mergesort")
    ranks = np.empty(len(s), np.float64)
    ranks[order] = np.arange(1, len(s) + 1)
    # average the ranks of tied scores so ties count half either way
    uniq, inv, counts = np.unique(s, return_inverse=True, return_counts=True)
    if len(uniq) != len(s):
        sums = np.zeros(len(uniq))
        np.add.at(sums, inv, ranks)
        ranks = (sums / counts)[inv]
    u = ranks[y].sum() - n_pos * (n_pos + 1) / 2
    return float(u / (n_pos * n_neg))


def f1_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    tp = float(np.sum((y_pred == 1) & (y_true == 1)))
    fp = float(np.sum((y_pred == 1) & (y_true == 0)))
    fn = float(np.sum((y_pred == 0) & (y_true == 1)))
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


@dataclasses.dataclass
class LinkPredResult:
    f1: float
    accuracy: float
    n_train: int
    n_test: int


def fit_logreg(X: torch.Tensor, y: torch.Tensor, iters: int = 400,
               lr: float = 0.05):
    """Full-batch logistic regression from zeros -> (w (D,), b ()) float32."""
    params = {"w": torch.zeros(X.shape[1], device=X.device),
              "b": torch.zeros((), device=X.device)}
    opt = optim.adam(lr)
    state = opt.init(params)
    zero = torch.zeros((), device=X.device)
    for _ in range(iters):
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        with torch.enable_grad():
            logits = X @ leaves["w"] + leaves["b"]
            loss = torch.mean(torch.logaddexp(logits, zero) - y * logits) \
                + 1e-4 * torch.sum(leaves["w"] ** 2)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        upd, state = opt.update(dict(zip(leaves, grads)), state, params)
        params = optim.apply_updates(params, upd)
    return params["w"], params["b"]


def _features(emb: np.ndarray, pairs: np.ndarray, mode: str = "concat") -> np.ndarray:
    a, b = emb[pairs[:, 0]], emb[pairs[:, 1]]
    if mode == "concat":  # the paper's choice
        return np.concatenate([a, b], axis=1)
    if mode == "hadamard":
        return a * b
    raise ValueError(mode)


def evaluate_link_prediction(
    emb: np.ndarray,
    pairs: np.ndarray,
    labels: np.ndarray,
    *,
    train_frac: float = 0.6,
    feature_mode: str = "concat",
    seed: int = 0,
    device="cuda",
) -> LinkPredResult:
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(pairs))
    n_train = int(train_frac * len(pairs))
    tr, te = order[:n_train], order[n_train:]

    X = _features(emb.astype(np.float32), pairs, feature_mode)
    mu, sd = X[tr].mean(0), X[tr].std(0) + 1e-8
    X = (X - mu) / sd

    dev = resolve_device(device)
    w, b = fit_logreg(torch.tensor(X[tr], device=dev),
                      torch.tensor(labels[tr], device=dev))
    logits = X[te] @ w.cpu().numpy() + float(b)
    pred = (logits > 0).astype(np.int32)
    y = labels[te].astype(np.int32)
    return LinkPredResult(
        f1=f1_score(y, pred),
        accuracy=float(np.mean(pred == y)),
        n_train=len(tr),
        n_test=len(te),
    )
