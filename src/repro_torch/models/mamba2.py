"""Mamba2 (SSD, state-space duality) block: chunked full-sequence path and
one-token decode.

The torch counterpart of ``repro.models.mamba2``. The SSD algorithm (Dao &
Gu 2024) cuts the sequence into chunks of Q positions (``ssd.chunk``, halved
until it divides S): inside a chunk the recurrence is a masked, decay-
weighted quadratic form (batched matmuls); across chunks a small (h, n, p)
state is carried by a loop (the JAX package's ``lax.scan``). Decode is one
state update. Everything after the input projection runs in fp32; the SSD
state is fp32, the conv cache in the compute dtype. None of it is a Pallas
kernel in the JAX package, so here it is plain PyTorch.

Under a mesh the block runs by heads where the scope's rule puts
``ssm_heads`` on a mesh axis (the JAX package constrains the SSD's input
to ("batch", "seq", "ssm_heads", None)): each rank of that axis runs the
conv and the SSD on its own run of h/n heads and the groups they read
(``_by_heads``), and elsewhere the block runs on each rank's batch rows
with its work replicated (``_by_rows``, the fallback contract).

Layout (B batch, S sequence, h heads, p head_dim, g groups, n state):
  x: (B, S, h, p)   B_in / C: (B, S, g, n)   dt: (B, S, h)   state: (B, h, n, p)
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (constrain, is_dtensor, matmul,
                                              placements_for, shard_map,
                                              spec_for)

from .config import ModelConfig
from .layers import normal, rms_norm_groups

__all__ = ["init_mamba", "spec_mamba", "mamba_forward", "mamba_decode",
           "xbc_conv_state",
           "init_mamba_cache", "ssd_reference", "ssd_chunked"]


# ------------------------------------------------------------------ params --


def init_mamba(gen, cfg: ModelConfig, *, device, lead=()):
    """The JAX package's draws: in_proj and out_proj normal / sqrt(fan-in),
    conv_w normal * 0.1, dt_bias the inverse softplus of dt ~ logU[1e-3,
    1e-1], a_log = log(1..h), d_skip and norm_scale 1."""
    s = cfg.ssm
    d = cfg.d_model
    di, h = s.d_inner(d), s.n_heads(d)
    g, n, w = s.n_groups, s.d_state, s.d_conv
    conv_dim = di + 2 * g * n
    dt = cfg.pdtype()
    f32 = torch.float32
    proj_out = 2 * di + 2 * g * n + h
    in_proj = normal(gen, (*lead, d, proj_out), 1.0 / np.sqrt(d), dt, device)
    conv_w = normal(gen, (*lead, w, conv_dim), 0.1, dt, device)
    u = torch.rand((*lead, h), generator=gen, device=device)
    dt0 = torch.exp(u * float(np.log(0.1) - np.log(1e-3))
                    + float(np.log(1e-3)))
    out_proj = normal(gen, (*lead, di, d), 1.0 / np.sqrt(di), dt, device)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((*lead, conv_dim), dtype=f32, device=device),
        "a_log": torch.log(torch.arange(1, h + 1, dtype=f32, device=device)
                           ).expand(*lead, h).contiguous(),
        "dt_bias": dt0 + torch.log(-torch.expm1(-dt0)),  # inverse softplus
        "d_skip": torch.ones((*lead, h), dtype=f32, device=device),
        "norm_scale": torch.ones((*lead, di), dtype=f32, device=device),
        "out_proj": out_proj,
    }


def spec_mamba(cfg: ModelConfig):
    return {
        "in_proj": ("embed", "mlp"),
        "conv_w": ("conv", "mlp"),
        "conv_b": ("mlp",),
        "a_log": ("ssm_heads",),
        "dt_bias": ("ssm_heads",),
        "d_skip": ("ssm_heads",),
        "norm_scale": ("mlp",),
        "out_proj": ("mlp", "embed"),
    }


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) = logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), device=x.device))


# --------------------------------------------------------------------- ssd --


def _segsum(logd):
    """out[..., i, j] = sum_{j < k <= i} logd[..., k] for i >= j, -inf above
    the diagonal. logd: (..., Q) -> (..., Q, Q)."""
    Q = logd.shape[-1]
    cum = torch.cumsum(logd, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=logd.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_reference(x, dt, a, B_in, C, *, h_per_g: int):
    """Sequential recurrence (the tests' oracle). x: (B, S, h, p), dt:
    (B, S, h), a: (h,), B_in / C: (B, S, g, n) -> (y (B, S, h, p) fp32,
    final state (B, h, n, p) fp32)."""
    Bb, S, h, p = x.shape
    n = B_in.shape[-1]
    Br = B_in.repeat_interleave(h_per_g, dim=2).float()  # (B, S, h, n)
    Cr = C.repeat_interleave(h_per_g, dim=2).float()
    x, dt = x.float(), dt.float()
    state = torch.zeros((Bb, h, n, p), device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(a * dt[:, t])[..., None, None]
        state = state * decay + Br[:, t, :, :, None] \
            * (x[:, t] * dt[:, t, :, None])[..., None, :]
        ys.append(torch.einsum("bhn,bhnp->bhp", Cr[:, t], state))
    return torch.stack(ys, dim=1), state


def ssd_chunked(x, dt, a, B_in, C, *, h_per_g: int, chunk: int):
    """Chunked SSD; the contract of ``ssd_reference``."""
    Bb, S, h, p = x.shape
    n = B_in.shape[-1]
    Q = min(chunk, S)
    while S % Q:
        Q //= 2
    nc = S // Q

    xr = x.reshape(Bb, nc, Q, h, p).float()
    dtr = dt.reshape(Bb, nc, Q, h).float()
    Br = B_in.repeat_interleave(h_per_g, dim=2).reshape(Bb, nc, Q, h, n) \
        .float()
    Cr = C.repeat_interleave(h_per_g, dim=2).reshape(Bb, nc, Q, h, n).float()

    xd = xr * dtr[..., None]  # the discretised input
    logd = a * dtr  # (B, nc, Q, h) log decay per step
    cum = torch.cumsum(logd, dim=2)

    # inside a chunk: the quadratic form under the decay mask
    L = torch.exp(_segsum(logd.movedim(3, 2)))  # (B, nc, h, Q, Q)
    CB = torch.einsum("bcihn,bcjhn->bchij", Cr, Br)
    y_intra = torch.einsum("bchij,bcjhp->bcihp", CB * L, xd)

    # each chunk's summary state: sum_j exp(cum_end - cum_j) B_j x~_j
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    S_c = torch.einsum("bcjhn,bcjh,bcjhp->bchnp", Br, decay_to_end, xd)

    # across chunks: H_c = exp(sum logd_c) H_{c-1} + S_c, from H_0 = 0
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B, nc, h)
    H = torch.zeros((Bb, h, n, p), device=x.device)
    prevs = []
    for c in range(nc):
        prevs.append(H)
        H = H * chunk_decay[:, c, :, None, None] + S_c[:, c]
    Hprev = torch.stack(prevs, dim=1)  # (B, nc, h, n, p): entering chunk c

    # the state carried in, read by C and decayed from the chunk's start
    y_inter = torch.einsum("bcihn,bchnp->bcihp", Cr, Hprev) \
        * torch.exp(cum)[..., None]
    return (y_intra + y_inter).reshape(Bb, S, h, p), H


# ------------------------------------------------------------------- block --


def _split_proj(z, cfg: ModelConfig):
    """in_proj's output -> (z gate, x, B, C, dt) along the last axis."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    gn = s.n_groups * s.d_state
    return torch.split(z, [di, di, gn, gn, s.n_heads(cfg.d_model)], dim=-1)


def _depthwise_conv(x, w, b):
    """Causal depthwise conv, accumulated in fp32. x: (B, S, C); w: (W, C);
    b: (C,) fp32 -> (B, S, C) in x's dtype."""
    W, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros(x.shape, device=x.device)
    for i in range(W):
        out = out + pad[:, i:i + S].float() * w[i].float()
    return (out + b).to(x.dtype)


def _ssd_block(zg, xbc, dt, conv_w, conv_b, params, cfg: ModelConfig,
               h: int, g: int):
    """The block from in_proj's output to the gated norm's input, on ``h``
    heads that read ``g`` groups (all of them, or one rank's share): zg
    (B, S, h p), xbc (B, S, h p + 2 g n) pre-conv, dt (B, S, h) -> (the
    gated y (B, S, h p) fp32, the final SSD state (B, h, n, p) fp32).
    ``params`` holds the h heads' a_log, dt_bias and d_skip."""
    s = cfg.ssm
    p, n = s.head_dim, s.d_state
    xbc = _depthwise_conv(xbc, conv_w, conv_b)
    xbc = F.silu(xbc.float()).to(zg.dtype)
    x, B_in, C = torch.split(xbc, [h * p, g * n, g * n], dim=-1)

    Bsz, S = zg.shape[0], zg.shape[1]
    xh = x.reshape(Bsz, S, h, p)
    dtv = _softplus(dt.float() + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    y, state = ssd_chunked(xh, dtv, a, B_in.reshape(Bsz, S, g, n),
                           C.reshape(Bsz, S, g, n), h_per_g=h // g,
                           chunk=s.chunk)
    y = y + params["d_skip"][:, None] * xh.float()
    return y.reshape(Bsz, S, h * p) * F.silu(zg.float()), state


def _ssd_step(zg, window, dt, conv_w, conv_b, ssm_state, params,
              cfg: ModelConfig, h: int, g: int):
    """One decode step of ``_ssd_block``: window (B, d_conv, h p + 2 g n)
    the last pre-conv features with the new token's last -> (the gated y
    (B, 1, h p) fp32, the new SSD state)."""
    s = cfg.ssm
    p, n = s.head_dim, s.d_state
    xbc = torch.einsum("bwc,wc->bc", window.float(),
                       conv_w.float()) + conv_b
    xbc = F.silu(xbc).to(zg.dtype)
    x, B_in, C = torch.split(xbc, [h * p, g * n, g * n], dim=-1)

    Bsz = zg.shape[0]
    xh = x.reshape(Bsz, h, p).float()
    Bg = B_in.reshape(Bsz, g, n).repeat_interleave(h // g, dim=1).float()
    Cg = C.reshape(Bsz, g, n).repeat_interleave(h // g, dim=1).float()
    dtv = _softplus(dt[:, 0].float() + params["dt_bias"])  # (B, h)
    a = -torch.exp(params["a_log"])

    decay = torch.exp(a * dtv)[..., None, None]
    ssm_state = ssm_state * decay + Bg[..., :, None] \
        * (xh * dtv[..., None])[..., None, :]
    y = torch.einsum("bhn,bhnp->bhp", Cg, ssm_state)
    y = y + params["d_skip"][:, None] * xh
    return y.reshape(Bsz, 1, h * p) * F.silu(zg.float()), ssm_state


def mamba_forward(params, xin, cfg: ModelConfig, *,
                  return_state: bool = False):
    """xin: (B, S, d) -> (B, S, d) [, (conv_state, ssm_state)]. On
    DTensors, by heads over the ``ssm_heads`` axis (``_by_heads``; the
    output then in the residual's layout), else each rank's batch rows on
    their own (``_by_rows``)."""
    if not is_dtensor(xin):
        return _forward(params, xin, cfg, return_state=return_state)
    plan = _heads_plan(cfg, params, xin)
    if plan is not None:
        return _forward_by_heads(params, xin, cfg, plan, return_state)
    if not return_state:
        return _by_rows(lambda p, x: _forward(p, x, cfg), 1, params, xin)

    def flat(p, x):
        out, (conv, state) = _forward(p, x, cfg, return_state=True)
        return out, conv, state

    out, conv, state = _by_rows(flat, 3, params, xin)
    return out, (conv, state)


def _forward(params, xin, cfg: ModelConfig, *, return_state: bool = False):
    """``mamba_forward`` on plain tensors."""
    s = cfg.ssm
    g, h = s.n_groups, s.n_heads(cfg.d_model)
    zg, x, B_in, C, dt = _split_proj(xin @ params["in_proj"], cfg)
    y, state = _ssd_block(zg, torch.cat([x, B_in, C], dim=-1), dt,
                          params["conv_w"], params["conv_b"], params, cfg,
                          h, g)
    y = rms_norm_groups(y, params["norm_scale"], g)
    out = y.to(xin.dtype) @ params["out_proj"]
    if not return_state:
        return out
    return out, (xbc_conv_state(xin, params, cfg), state)


def xbc_conv_state(xin, params, cfg: ModelConfig):
    """The last (d_conv - 1) pre-conv features, the decode-time conv cache:
    in_proj run again on the last d_conv - 1 inputs, as the JAX package
    does. -> (B, d_conv - 1, conv_dim)."""
    z = xin[:, -(cfg.ssm.d_conv - 1):] @ params["in_proj"]
    _, x, B_in, C, _ = _split_proj(z, cfg)
    return torch.cat([x, B_in, C], dim=-1)


def init_mamba_cache(batch: int, cfg: ModelConfig, dtype=torch.float32, *,
                     device, lead=()):
    """Zeroed (conv (*lead, B, d_conv - 1, conv_dim) in ``dtype``, ssd
    (*lead, B, h, n, p) fp32)."""
    s = cfg.ssm
    d = cfg.d_model
    conv_dim = s.d_inner(d) + 2 * s.n_groups * s.d_state
    return (
        torch.zeros((*lead, batch, s.d_conv - 1, conv_dim), dtype=dtype,
                    device=device),
        torch.zeros((*lead, batch, s.n_heads(d), s.d_state, s.head_dim),
                    device=device),
    )


def mamba_decode(params, xin, conv_state, ssm_state, cfg: ModelConfig):
    """One-token step. xin: (B, 1, d) -> (y (B, 1, d), (conv_state,
    ssm_state)), the states new tensors. On DTensors, by heads as
    ``mamba_forward`` (the states in the cache's own layouts), else each
    rank's batch rows on their own (``_by_rows``)."""
    if is_dtensor(xin):
        plan = _heads_plan(cfg, params, xin)
        if plan is not None:
            return _decode_by_heads(params, xin, conv_state, ssm_state, cfg,
                                    plan)

        def flat(p, x, conv, ssm):
            out, (conv, ssm) = mamba_decode(p, x, conv, ssm, cfg)
            return out, conv, ssm

        out, conv, ssm = _by_rows(flat, 3, params, xin, conv_state,
                                  ssm_state)
        return out, (conv, ssm)
    s = cfg.ssm
    g, h = s.n_groups, s.n_heads(cfg.d_model)
    zg, x, B_in, C, dt = _split_proj(xin @ params["in_proj"], cfg)
    window = torch.cat([conv_state, torch.cat([x, B_in, C], dim=-1)], dim=1)
    y, ssm_state = _ssd_step(zg, window, dt, params["conv_w"],
                             params["conv_b"], ssm_state, params, cfg, h, g)
    y = rms_norm_groups(y, params["norm_scale"], g)
    out = y.to(xin.dtype) @ params["out_proj"]
    return out, (window[:, 1:], ssm_state)


# ----------------------------------------------------------- under a mesh --


def _rows(x):
    """x's placements with its batch (dim 0) split kept and every other
    mesh axis replicated."""
    from torch.distributed.tensor import Replicate, Shard
    return [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in x.placements]


def _by_rows(fn, n_out: int, params, x, *states):
    """``fn(params, x, *states)`` (a mamba block's forward or decode step:
    ``n_out`` batch-major outputs, flat) on DTensors: each rank runs it on
    its own batch rows (``shard_map``) with the whole weights and states,
    gathered, and its outputs keep the rows split. The fallback where the
    heads do not split over the ``ssm_heads`` axis (``_heads_plan``): the
    block runs unsplit over the other mesh axes, its work replicated there,
    as a fallback dim's is."""
    from torch.distributed.tensor import Replicate

    mesh = x.device_mesh
    rows = _rows(x)
    whole = [Replicate()] * mesh.ndim
    names = sorted(params)

    def local(x, *rest):
        return fn(dict(zip(names, rest)), x, *rest[len(names):])

    return shard_map(
        local, mesh, (rows,) + (whole,) * len(names) + (rows,) * len(states),
        rows if n_out == 1 else (rows,) * n_out)(
        x, *[params[k] for k in names], *states)


class _Heads:
    """One rank's share of a mamba block split by heads over mesh dim
    ``m`` (``n`` ranks, this one ``r``): heads [h0, h0 + hr), the groups
    [g0, g0 + gl) they read (gl = hr / (h / g) whole groups, or 1 shared
    by several ranks: ``shared``), and the columns of in_proj's packed
    output [z | x | B | C | dt] (``proj``) and of the conv's [x | B | C]
    (``conv``) that hold them, in that order."""

    def __init__(self, cfg: ModelConfig, m: int, n: int, r: int):
        s = cfg.ssm
        di, g, ns = s.d_inner(cfg.d_model), s.n_groups, s.d_state
        h, p = s.n_heads(cfg.d_model), s.head_dim
        hpg = h // g
        self.m = m
        self.hr = h // n
        self.h0 = r * self.hr
        self.g0 = self.h0 // hpg
        self.gl = max(self.hr // hpg, 1)
        self.shared = self.hr < hpg
        ch = range(self.h0 * p, (self.h0 + self.hr) * p)
        gc = range(self.g0 * ns, (self.g0 + self.gl) * ns)
        conv = [*ch, *(di + c for c in gc), *(di + g * ns + c for c in gc)]
        self.conv = conv
        self.proj = [*ch, *(di + c for c in conv),
                     *(2 * di + 2 * g * ns + i
                       for i in range(self.h0, self.h0 + self.hr))]

    @staticmethod
    def index(cols, like):
        """``cols`` as a long tensor on ``like``'s device."""
        return torch.tensor(cols, dtype=torch.long, device=like.device)


def _heads_plan(cfg: ModelConfig, params, x):
    """The by-heads share of this rank where the per-head vectors (laid out
    by ``ssm_heads``) are split over exactly one mesh axis, that axis does
    not split x's rows, and each rank's run of heads reads whole groups or
    lies in one group; else None (``_by_rows``). Read from the params'
    placements, not the scope's rules: a rematerialised block recomputes in
    the backward, on the autograd engine's thread, where no scope is bound
    (and x's sequence may still be split there: the region gathers it)."""
    from torch.distributed.tensor import Shard

    a = params["a_log"]
    if not is_dtensor(a):
        return None
    split = [m for m, p in enumerate(a.placements) if isinstance(p, Shard)]
    if len(split) != 1:
        return None
    s = cfg.ssm
    h, g = s.n_heads(cfg.d_model), s.n_groups
    mesh, m = x.device_mesh, split[0]
    n = mesh.size(m)
    hr, hpg = h // n, h // g
    if (hr % hpg and hpg % hr) or x.placements[m] == Shard(0):
        return None
    return _Heads(cfg, m, n, mesh.get_local_rank(m))


def _split_local(z, cfg: ModelConfig, plan: _Heads):
    """A rank's in_proj columns (``plan.proj``) -> (zg, xbc, dt)."""
    p = cfg.ssm.head_dim
    hp = plan.hr * p
    return torch.split(z, [hp, len(plan.conv), plan.hr], dim=-1)


def _own(mesh, plan: _Heads, dim: int):
    """Placements split along ``dim`` over ``plan.m`` alone."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(dim) if i == plan.m else Replicate()
            for i in range(mesh.ndim)]


_HEAD_VECS = ("a_log", "dt_bias", "d_skip")  # (h,): the rank's own heads


def _gated_out(params, y, ssq, cfg: ModelConfig, plan: _Heads, rows, dtype):
    """The gated norm and out_proj of the rank's heads: ``y`` (B, S, hr p)
    the normed output in ``dtype`` (whole groups), or the gated fp32 output
    with ``ssq`` (B, S, g), each group's sum of squares summed over the
    ranks that share it; out_proj's "mlp" rows are the rank's own channels,
    so the product is a partial sum, constrained to the residual's
    layout."""
    if plan.shared:
        s = cfg.ssm
        per = s.d_inner(cfg.d_model) // s.n_groups

        def norm(yg, ssq, scale):  # rms_norm_groups of a group's share
            rms = torch.sqrt(ssq[..., plan.g0:plan.g0 + 1] / per + 1e-6)
            return (yg / rms * scale).to(dtype)

        mesh, pl = y.device_mesh, list(y.placements)
        y = shard_map(norm, mesh, (pl, rows, _own(mesh, plan, 0)), pl)(
            y, ssq.redistribute(mesh, rows), params["norm_scale"])
    out = matmul(y, params["out_proj"])
    return constrain(out, "batch", "res_seq", "act_embed")


def _forward_by_heads(params, xin, cfg: ModelConfig, plan: _Heads,
                      return_state: bool):
    """``mamba_forward`` on DTensors by heads: each rank of ``plan.m``
    projects its rows onto its own in_proj columns (the weight gathered
    whole and its columns picked: at the forward's many tokens a row of
    weights is cheaper to move than a token's packed features), runs the
    conv and ``ssd_chunked`` on its hr heads, and, where its heads hold
    whole groups, the gated norm; a group shared by several ranks sums its
    squares across them first. The conv state is written in the cache's
    own layout ("mlp" columns of [x | B | C] split contiguously); the SSD
    state split by heads."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    s = cfg.ssm
    mesh = xin.device_mesh
    rows = _rows(xin)
    whole = [Replicate()] * mesh.ndim
    mine, heads_pl, ssq_pl = list(rows), list(rows), list(rows)
    mine[plan.m], heads_pl[plan.m], ssq_pl[plan.m] = \
        Shard(2), Shard(1), Partial()
    g, d_conv = s.n_groups, s.d_conv
    if return_state:  # prefill: the conv cache's own layout
        conv_dim = s.d_inner(cfg.d_model) + 2 * g * s.d_state
        conv_shape = (xin.shape[0], d_conv - 1, conv_dim)
        conv_pl = placements_for(spec_for(conv_shape, ("batch", None,
                                                       "mlp")), mesh)
        c_shape, c_off = compute_local_shape_and_global_offset(
            conv_shape, mesh, conv_pl)
        state_cols = [s.d_inner(cfg.d_model) + c
                      for c in range(c_off[2], c_off[2] + c_shape[2])]

    def local(x, w_in, conv_w, conv_b, scale, *vecs):
        p = dict(zip(_HEAD_VECS, vecs))
        proj = plan.index(plan.proj, w_in)
        conv = plan.index(plan.conv, w_in)
        zg, xbc, dt = _split_local(x @ w_in.index_select(1, proj), cfg, plan)
        y, state = _ssd_block(zg, xbc, dt, conv_w.index_select(1, conv),
                              conv_b.index_select(0, conv), p, cfg, plan.hr,
                              plan.gl)
        if plan.shared:
            part = y.new_zeros((*y.shape[:2], g))
            part[..., plan.g0] = y.square().sum(-1)
            outs = (y, part)
        else:
            outs = (rms_norm_groups(y, scale, plan.gl).to(x.dtype), None)
        if return_state:
            last = x[:, -(d_conv - 1):]
            outs += (last @ w_in.index_select(1, plan.index(state_cols,
                                                            w_in)), state)
        return tuple(o for o in outs if o is not None)

    out_pl = (mine, ssq_pl) if plan.shared else (mine,)
    if return_state:
        out_pl += (conv_pl, heads_pl)
    own = _own(mesh, plan, 0)
    got = shard_map(local, mesh, (rows, whole, whole, whole, own)
                    + (own,) * len(_HEAD_VECS), out_pl)(
        xin, params["in_proj"], params["conv_w"], params["conv_b"],
        params["norm_scale"], *[params[k] for k in _HEAD_VECS])
    if not isinstance(got, tuple):
        got = (got,)
    out = _gated_out(params, got[0], got[1] if plan.shared else None, cfg,
                     plan, rows, xin.dtype)
    if not return_state:
        return out
    return out, tuple(got[-2:])


def _decode_by_heads(params, xin, conv_state, ssm_state, cfg: ModelConfig,
                     plan: _Heads):
    """``mamba_decode`` on DTensors by heads: in_proj's product stays split
    as its columns are ("mlp") and is gathered whole (one token a row: its
    packed features are cheaper to move than the weight), as is the conv
    cache (d_conv - 1 rows); each rank of ``plan.m`` then steps the conv
    and the SSD state of its own heads, and writes the new token's
    features into its own columns of the conv cache, in the cache's
    layout. The SSD state stays split by heads; the gated norm and
    out_proj as in ``_forward_by_heads``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    s = cfg.ssm
    mesh = xin.device_mesh
    rows = _rows(xin)
    whole = [Replicate()] * mesh.ndim
    mine, heads_pl, ssq_pl = list(rows), list(rows), list(rows)
    mine[plan.m], heads_pl[plan.m], ssq_pl[plan.m] = \
        Shard(2), Shard(1), Partial()
    di, g = s.d_inner(cfg.d_model), s.n_groups
    conv_pl = list(conv_state.placements)
    c_shape, c_off = compute_local_shape_and_global_offset(
        conv_state.shape, mesh, conv_pl)
    c0, cl = c_off[2], c_shape[2]
    z = matmul(xin, params["in_proj"])

    def local(z, conv, ssm, conv_w, conv_b, scale, *vecs):
        p = dict(zip(_HEAD_VECS, vecs))
        proj = plan.index(plan.proj, z)
        cols = plan.index(plan.conv, z)
        window = torch.cat([conv, z[..., di:di + conv.shape[-1]]], dim=1)
        zg, _, dt = _split_local(z.index_select(-1, proj), cfg, plan)
        y, ssm = _ssd_step(zg, window.index_select(-1, cols), dt,
                           conv_w.index_select(1, cols),
                           conv_b.index_select(0, cols), ssm, p, cfg,
                           plan.hr, plan.gl)
        new_conv = window[:, 1:, c0:c0 + cl]
        if plan.shared:
            part = y.new_zeros((*y.shape[:2], g))
            part[..., plan.g0] = y.square().sum(-1)
            return y, part, new_conv, ssm
        return (rms_norm_groups(y, scale, plan.gl).to(xin.dtype), new_conv,
                ssm)

    own = _own(mesh, plan, 0)
    out_pl = ((mine, ssq_pl) if plan.shared else (mine,)) \
        + (conv_pl, heads_pl)
    got = shard_map(local, mesh, (rows, rows, heads_pl, whole, whole, own)
                    + (own,) * len(_HEAD_VECS), out_pl)(
        z, conv_state, ssm_state, params["conv_w"], params["conv_b"],
        params["norm_scale"], *[params[k] for k in _HEAD_VECS])
    out = _gated_out(params, got[0], got[1] if plan.shared else None, cfg,
                     plan, rows, xin.dtype)
    return out, tuple(got[-2:])
