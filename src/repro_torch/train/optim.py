"""Optimizers, as the JAX package's ``repro.train.optim`` computes them.

Transforms compose with ``chain``; every optimizer is a ``GradientTransform``
over trees of tensors (nested dicts, tuples, NamedTuples; ``train.tree``).
Moments are fp32 whatever the parameter dtype, updates are cast back to it,
and a schedule's rate ``lr(count)`` is read before the count advances. The
state trees are the JAX package's: ``adamw`` holds ``(AdamState(count, mu,
nu), (), count)``, ``adafactor`` ``AdafactorState(count, vr, vc)``, ``sgd``
``count`` or ``(count, velocity)``; counts are Python ints.

Each transform has two forms over the same per-leaf arithmetic:
  * ``step(grads, state, params) -> state``, which every caller in the
    port uses (LM training, SGNS training, the link-prediction fit): it
    adds each leaf's update to its parameter in place (``apply_updates``'
    arithmetic: an in-place add in the parameter's dtype) and advances the
    moments in place, one leaf at a time. At qwen3-4b's full width the
    bf16 params and grads and the fp32 moments hold 48 GB; trees of new
    moments and updates would add as much again. Here the largest transient
    is a few fp32 copies of one leaf, and an elementwise transform (every
    one but adafactor) takes a leaf above ``SLICE_BYTES`` of fp32 in slices
    along its leading axis (``rows``), with the same bits: zamba2-7b's
    stacked ``in_proj`` at 36 layers is 2.0 G entries, 8 GB a copy. A
    DTensor leaf is sliced likewise on each rank's local shard (a node
    table's 4.3 GB shard at 2^25 nodes on four ranks), and its state must
    then be DTensors laid out as the leaf is (``launch.train.sharded_state``):
    ``init`` on DTensor params gives each rank whole moments, whose rows a
    slice of the shard does not index, and the step raises;
  * ``update(grads, state, params) -> (updates, state)``, the JAX
    package's functional form, which copies the state first and leaves the
    one passed in as it was: the reference the parity tests hold ``step``
    and the JAX package against.
Both are built from ``begin(state, grads) -> (ctx, state)``, once a step
(counts, rates, the global norm), and ``leaf(ctx, i, u, p, rows=None) ->
u``, once a leaf (``rows``: a ``Rows`` of its leading axis, which ``u``
and ``p`` already are, and of which the leaf's state is read); ``chain``
composes those. A transform that reads the whole gradient
(``clip_by_global_norm``) must therefore come first in a chain.

``adam`` is the Adam of SGNS training and the link-prediction fit: state
``AdamState`` alone and a constant rate (the JAX package's schedule and
decay stages are identities there). ``make_optimizer("adam")`` returns the
JAX package's ``adam``, which is ``adamw`` without decay. Every parameter
moves every step, those without gradient too (their moments decay), as in
the JAX package: no lazy or sparse row updates.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.distributed.sharding import is_dtensor, shard_map

from .tree import leaves, leaves_up_to, tree_map, unflatten

__all__ = [
    "GradientTransform", "AdamState", "AdafactorState", "apply_updates",
    "global_norm", "chain", "scale", "scale_by_schedule",
    "clip_by_global_norm", "add_decayed_weights", "scale_by_adam", "sgd",
    "adam", "adamw", "adafactor", "make_optimizer", "warmup_cosine",
    "constant_schedule", "adam_state_specs", "adafactor_state_specs",
    "optimizer_state_specs",
]

Schedule = Callable[[int], float]
F32 = np.float32
SLICE_BYTES = 1 << 30  # fp32 bytes of a leaf above which ``step`` slices it


class GradientTransform(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable  # (grads, state, params=None) -> (updates, state)
    step: Callable  # (grads, state, params) -> state; params in place
    begin: Callable  # (state, grads tree or None) -> (ctx, state)
    # (ctx, i, update leaf, param leaf or None, rows=None) -> update
    leaf: Callable
    elementwise: bool = False  # each entry's update reads its entry alone


class AdamState(NamedTuple):
    count: int
    mu: Any
    nu: Any


class AdafactorState(NamedTuple):
    count: int
    vr: Any  # row second moments (the full moment where not factored)
    vc: Any  # column second moments (() where not factored)


def _clone(state):
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                    else x, state)


def _local(t):
    """A DTensor's local shard; any other tensor as it is."""
    return t.to_local() if is_dtensor(t) else t


class Rows(NamedTuple):
    """A slice of a leaf's leading axis; ``placements``: where the leaf is
    a DTensor, its placements (the slice is of its local shard)."""
    at: slice
    placements: Optional[tuple] = None


def _row_slices(g: torch.Tensor, p=None):
    """``Rows`` of the leading axis of gradient ``g`` holding at most
    ``SLICE_BYTES`` of fp32 each (one row if a row holds more); [None] for a
    leaf below it. A DTensor is sliced on its local shard (``launch/train
    --mesh``, the graph cell: each rank updates its own shard), where
    ``g`` is laid out as its parameter ``p``."""
    placements = None
    if is_dtensor(g):
        placements = tuple(g.placements)
        if p is None or not is_dtensor(p) or tuple(p.placements) != \
                placements:
            return [None]
    t = _local(g)
    if t.dim() == 0 or t.numel() * 4 <= SLICE_BYTES:
        return [None]
    n = max(1, SLICE_BYTES // max(t[0].numel() * 4, 1))
    return [Rows(slice(k, k + n), placements)
            for k in range(0, t.shape[0], n)]


def _at(t, rows):
    """A state leaf, or its ``rows``: of its local shard where the leaf is
    a DTensor, whose state must then be laid out as it is."""
    if rows is None:
        return t
    if rows.placements is not None and (
            not is_dtensor(t) or tuple(t.placements) != rows.placements):
        raise ValueError(
            "optim: a DTensor leaf is updated in slices of its local shard, "
            "but its state is not laid out as the leaf is (build it on the "
            "leaf's shards: launch.train.sharded_state)")
    return _local(t)[rows.at]


def _transform(init, begin, leaf, elementwise=False) -> GradientTransform:
    def update(grads, state, params=None):
        gs = leaves(grads)
        ps = leaves(params) if params is not None else [None] * len(gs)
        ctx, state = begin(_clone(state), grads)
        return unflatten(grads, [leaf(ctx, i, g, p) for i, (g, p) in
                                 enumerate(zip(gs, ps))]), state

    @torch.no_grad()
    def step(grads, state, params):
        ctx, state = begin(state, grads)
        for i, (g, p) in enumerate(zip(leaves(grads), leaves(params))):
            for rows in _row_slices(g, p) if elementwise else [None]:
                if rows is None:
                    p.add_(leaf(ctx, i, g, p).to(p.dtype))
                else:
                    pr = _local(p)[rows.at]
                    pr.add_(leaf(ctx, i, _local(g)[rows.at], pr, rows)
                            .to(p.dtype))
        return state

    return GradientTransform(init, update, step, begin, leaf, elementwise)


def _zeros32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _rate(lr: Union[float, Schedule]) -> Schedule:
    return lr if callable(lr) else constant_schedule(lr)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u.to(p.dtype)).to(p.dtype), params,
                    updates)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum() for x in leaves(tree)))


def chain(*transforms: GradientTransform) -> GradientTransform:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def begin(state, grads):
        ctxs, new = [], []
        for k, (t, s) in enumerate(zip(transforms, state)):
            c, s = t.begin(s, grads if k == 0 else None)
            ctxs.append(c)
            new.append(s)
        return ctxs, tuple(new)

    def leaf(ctxs, i, u, p, rows=None):
        for t, c in zip(transforms, ctxs):
            u = t.leaf(c, i, u, p, rows)
        return u

    return _transform(init, begin, leaf,
                      all(t.elementwise for t in transforms))


def _stateless(leaf) -> GradientTransform:
    return _transform(lambda p: (), lambda s, g: (None, s), leaf, True)


def scale(factor: float) -> GradientTransform:
    return _stateless(lambda ctx, i, u, p, rows=None: u * factor)


def scale_by_schedule(schedule: Schedule) -> GradientTransform:
    def begin(count, grads):
        return float(schedule(count)), count + 1

    return _transform(lambda p: 0, begin,
                      lambda s, i, u, p, rows=None: u * s, True)


def clip_by_global_norm(max_norm: float) -> GradientTransform:
    def begin(state, grads):
        if grads is None:
            raise ValueError("clip_by_global_norm reads the whole gradient: "
                             "put it first in a chain")
        norm = global_norm(grads)
        return torch.clamp(max_norm / (norm + 1e-9), max=1.0), state

    return _transform(lambda p: (), begin,
                      lambda f, i, u, p, rows=None: u * f, True)


def add_decayed_weights(weight_decay: float) -> GradientTransform:
    def leaf(ctx, i, u, p, rows=None):
        if weight_decay == 0.0 or p is None:
            return u
        return u + weight_decay * p.to(u.dtype)

    return _stateless(leaf)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransform:
    """Bias-corrected ``m_hat / (sqrt(v_hat) + eps)``."""

    def init(params):
        return AdamState(0, tree_map(_zeros32, params),
                         tree_map(_zeros32, params))

    def begin(state, grads):
        count = state.count + 1
        # the bias corrections in float32, as the JAX package computes them:
        # 1 - b2 is a small difference, so its rounding shows in every update
        c1 = float(F32(1) - F32(b1) ** F32(count))
        c2 = float(F32(1) - F32(b2) ** F32(count))
        ctx = (c1, c2, leaves(state.mu), leaves(state.nu))
        return ctx, AdamState(count, state.mu, state.nu)

    def leaf(ctx, i, u, p, rows=None):
        c1, c2, mu, nu = ctx
        g = u.float()
        # b1 * m + (1 - b1) * g
        m = _at(mu[i], rows).mul_(b1).add_((1 - b1) * g)
        v = _at(nu[i], rows).mul_(b2).add_((1 - b2) * g * g)
        return (m / c1).div_(torch.sqrt(v / c2).add_(eps))

    return _transform(init, begin, leaf, True)


def sgd(lr: Union[float, Schedule], momentum: float = 0.0) -> GradientTransform:
    def init(params):
        if momentum == 0.0:
            return 0
        return (0, tree_map(_zeros32, params))

    def begin(state, grads):
        count, vel = (state, None) if momentum == 0.0 else state
        rate = float(lr(count)) if callable(lr) else lr
        new = count + 1 if momentum == 0.0 else (count + 1, vel)
        return (rate, None if vel is None else leaves(vel)), new

    def leaf(ctx, i, u, p, rows=None):
        rate, vel = ctx
        g = u.float()
        if vel is not None:
            g = _at(vel[i], rows).mul_(momentum).add_(g)
        return -rate * g

    return _transform(init, begin, leaf, True)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransform:
    """``scale_by_adam`` followed by a step of ``-lr``, with the state
    ``AdamState`` alone (SGNS training and the link-prediction fit)."""
    inner = scale_by_adam(b1, b2, eps)
    return _transform(inner.init, inner.begin,
                      lambda ctx, i, u, p, rows=None:
                      inner.leaf(ctx, i, u, p, rows) * -lr, True)


def adamw(lr: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0) -> GradientTransform:
    sched = _rate(lr)
    return chain(
        scale_by_adam(b1, b2, eps),
        add_decayed_weights(weight_decay),
        scale_by_schedule(lambda c: -sched(c)),
    )


def _over_outer(g, r, c):
    """``g / (r[..., None] * c[..., None, :])``: g (..., m, n), r (..., m),
    c (..., n). On DTensors each rank divides its own block of g by the
    outer product of its slices of r and c (``shard_map``): DTensor's own
    broadcast may lay the product out whole along a dim that g splits (on
    H100s under torch 2.11, a 3.2 GB block a rank at grok-1-314b's
    experts on 2x2)."""
    if not is_dtensor(g):
        return g / (r[..., None] * c[..., None, :])
    from torch.distributed.tensor import Replicate, Shard

    n = g.ndim
    g_pl = [p if isinstance(p, Shard) else Replicate() for p in g.placements]
    r_pl = [p if isinstance(p, Shard) and p.dim < n - 1 else Replicate()
            for p in g_pl]
    c_pl = [p if isinstance(p, Shard) and p.dim < n - 2
            else Shard(n - 2) if p == Shard(n - 1) else Replicate()
            for p in g_pl]
    return shard_map(lambda g, r, c: g / (r[..., None] * c[..., None, :]),
                     g.device_mesh, (g_pl, r_pl, c_pl), g_pl)(g, r, c)


def adafactor(lr: Union[float, Schedule], decay: float = 0.8,
              eps: float = 1e-30, clip_threshold: float = 1.0,
              min_dim_size_to_factor: int = 128,
              weight_decay: float = 0.0) -> GradientTransform:
    """Factored second moments (Shazeer & Stern 2018): a matrix whose two
    trailing dims are both >= ``min_dim_size_to_factor`` keeps a row and a
    column moment instead of a full one."""
    sched = _rate(lr)

    def factored(p):
        return (p.ndim >= 2 and p.shape[-1] >= min_dim_size_to_factor
                and p.shape[-2] >= min_dim_size_to_factor)

    def init(params):
        def vr(p):
            return torch.zeros(p.shape[:-1] if factored(p) else p.shape,
                               dtype=torch.float32, device=p.device)

        def vc(p):
            if not factored(p):
                return ()
            return torch.zeros(p.shape[:-2] + p.shape[-1:],
                               dtype=torch.float32, device=p.device)

        return AdafactorState(0, tree_map(vr, params), tree_map(vc, params))

    def begin(state, grads):
        count = state.count + 1
        beta = F32(1) - F32(count) ** F32(-decay)
        ctx = (float(beta), float(F32(1) - beta), float(sched(state.count)),
               leaves_up_to(grads, state.vr), leaves_up_to(grads, state.vc))
        return ctx, AdafactorState(count, state.vr, state.vc)

    def leaf(ctx, i, u, p, rows=None):  # whole leaves only: not elementwise
        # each fp32 temporary is dropped once read: at grok-1-314b's expert
        # leaf (8 x 6144 x 32768) one is 6.4 GB, and at most three live
        beta, one_minus, rate, vr, vc = ctx
        g = u.float()
        g2 = g * g + eps
        if factored(g):
            r_mom = vr[i].mul_(beta).add_(one_minus * g2.mean(-1))
            c_mom = vc[i].mul_(beta).add_(one_minus * g2.mean(-2))
            del g2
            r = r_mom / r_mom.mean(-1, keepdim=True).clamp_min(1e-30)
            u = _over_outer(g, torch.sqrt(r), torch.sqrt(c_mom))
        else:
            u = g / torch.sqrt(vr[i].mul_(beta).add_(one_minus * g2))
            del g2
        del g
        rms = torch.sqrt(u.square().mean() + 1e-30)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        if weight_decay and p is not None:
            u = u + weight_decay * p.float()
        return -rate * u

    return _transform(init, begin, leaf)


def make_optimizer(name: str, lr, weight_decay: float = 0.0) -> GradientTransform:
    if name == "adamw":
        return adamw(lr, weight_decay=weight_decay)
    if name == "adam":  # the JAX package's adam: adamw without decay
        return adamw(lr)
    if name == "adafactor":
        return adafactor(lr, weight_decay=weight_decay)
    if name == "sgd":
        return sgd(lr, momentum=0.9)
    raise ValueError(name)


def adam_state_specs(param_specs):
    """Logical-name tree mirroring adamw's state (``distributed.sharding``):
    the moments take their parameters' names, the counts ()."""
    return (AdamState(count=(), mu=param_specs, nu=param_specs), (), ())


def adafactor_state_specs(params, param_specs, min_dim_size_to_factor=128):
    """Logical-name tree mirroring adafactor's factored state: a factored
    leaf's row moment drops the last name, its column moment the one before
    it; an unfactored leaf keeps its names in ``vr`` and () in ``vc``."""

    def factored(a):
        return (a.ndim >= 2 and a.shape[-1] >= min_dim_size_to_factor
                and a.shape[-2] >= min_dim_size_to_factor)

    flat_a, flat_s = leaves(params), leaves_up_to(params, param_specs)
    vr = unflatten(params, [s[:-1] if factored(a) else s
                            for a, s in zip(flat_a, flat_s)])
    vc = unflatten(params, [s[:-2] + s[-1:] if factored(a) else ()
                            for a, s in zip(flat_a, flat_s)])
    return AdafactorState(count=(), vr=vr, vc=vc)


def optimizer_state_specs(name: str, params, param_specs):
    """The logical-name tree of ``make_optimizer(name)``'s state for
    ``params`` (tensors, meta ones too) named by ``param_specs``."""
    if name in ("adamw", "adam"):
        return adam_state_specs(param_specs)
    if name == "adafactor":
        return adafactor_state_specs(params, param_specs)
    if name == "sgd":
        return ((), param_specs)
    raise ValueError(name)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  end_lr_ratio: float = 0.1) -> Schedule:
    """Linear warmup to ``peak_lr``, then a cosine decay to ``end_lr_ratio``
    of it, in float32 with the JAX package's order of operations."""

    def sched(count: int) -> float:
        c = F32(count)
        if c < warmup_steps:
            return float(F32(peak_lr) * (c + F32(1)) / F32(max(warmup_steps, 1)))
        t = np.clip((c - F32(warmup_steps))
                    / F32(max(total_steps - warmup_steps, 1)), F32(0), F32(1))
        cos = F32(end_lr_ratio * peak_lr) + F32(
            (1 - end_lr_ratio) * peak_lr * 0.5) * (F32(1) + np.cos(F32(np.pi) * t))
        return float(cos)

    return sched


def constant_schedule(lr: float) -> Schedule:
    """``lr`` rounded to float32, as JAX holds a constant rate."""
    return lambda c: float(F32(lr))
