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

Layout (B batch, S sequence, h heads, p head_dim, g groups, n state):
  x: (B, S, h, p)   B_in / C: (B, S, g, n)   dt: (B, S, h)   state: (B, h, n, p)
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import constrain, is_dtensor, shard_map

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


def _by_rows(fn, n_out: int, params, x, *states):
    """``fn(params, x, *states)`` (a mamba block's forward or decode step:
    ``n_out`` batch-major outputs, flat) on DTensors: each rank runs it on
    its own batch rows (``shard_map``) with the whole weights and states,
    gathered, and its outputs keep the rows split. The block's in_proj
    output mixes z, x, B, C and dt along one dim, so no split of it holds
    whole heads: the block runs unsplit over the other mesh axes (its work
    is replicated there, as a fallback dim's is)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in x.placements]
    whole = [Replicate()] * mesh.ndim
    names = sorted(params)

    def local(x, *rest):
        return fn(dict(zip(names, rest)), x, *rest[len(names):])

    return shard_map(
        local, mesh, (rows,) + (whole,) * len(names) + (rows,) * len(states),
        rows if n_out == 1 else (rows,) * n_out)(
        x, *[params[k] for k in names], *states)


def mamba_forward(params, xin, cfg: ModelConfig, *,
                  return_state: bool = False):
    """xin: (B, S, d) -> (B, S, d) [, (conv_state, ssm_state)]. On
    DTensors, each rank's batch rows on their own (``_by_rows``)."""
    if not is_dtensor(xin):
        return _forward(params, xin, cfg, return_state=return_state)
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
    d = cfg.d_model
    di, g, n = s.d_inner(d), s.n_groups, s.d_state
    h, p = s.n_heads(d), s.head_dim

    zg, x, B_in, C, dt = _split_proj(xin @ params["in_proj"], cfg)
    xbc = _depthwise_conv(torch.cat([x, B_in, C], dim=-1), params["conv_w"],
                          params["conv_b"])
    xbc = F.silu(xbc.float()).to(xin.dtype)
    x, B_in, C = torch.split(xbc, [di, g * n, g * n], dim=-1)

    Bsz, S = xin.shape[0], xin.shape[1]
    xh = constrain(x.reshape(Bsz, S, h, p), "batch", "seq", "ssm_heads", None)
    dtv = _softplus(dt.float() + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    y, state = ssd_chunked(xh, dtv, a, B_in.reshape(Bsz, S, g, n),
                           C.reshape(Bsz, S, g, n), h_per_g=h // g,
                           chunk=s.chunk)
    y = y + params["d_skip"][:, None] * xh.float()
    y = rms_norm_groups(y.reshape(Bsz, S, di) * F.silu(zg.float()),
                        params["norm_scale"], g)
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
    ssm_state)), the states new tensors. On DTensors, each rank's batch
    rows on their own (``_by_rows``)."""
    if is_dtensor(xin):
        def flat(p, x, conv, ssm):
            out, (conv, ssm) = mamba_decode(p, x, conv, ssm, cfg)
            return out, conv, ssm

        out, conv, ssm = _by_rows(flat, 3, params, xin, conv_state,
                                  ssm_state)
        return out, (conv, ssm)
    s = cfg.ssm
    d = cfg.d_model
    di, g, n = s.d_inner(d), s.n_groups, s.d_state
    h, p = s.n_heads(d), s.head_dim

    zg, x, B_in, C, dt = _split_proj(xin @ params["in_proj"], cfg)
    window = torch.cat([conv_state, torch.cat([x, B_in, C], dim=-1)], dim=1)
    xbc = torch.einsum("bwc,wc->bc", window.float(),
                       params["conv_w"].float()) + params["conv_b"]
    xbc = F.silu(xbc).to(xin.dtype)
    x, B_in, C = torch.split(xbc, [di, g * n, g * n], dim=-1)

    Bsz = xin.shape[0]
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
    y = rms_norm_groups(y.reshape(Bsz, 1, di) * F.silu(zg.float()),
                        params["norm_scale"], g)
    out = y.to(xin.dtype) @ params["out_proj"]
    return out, (window[:, 1:], ssm_state)
