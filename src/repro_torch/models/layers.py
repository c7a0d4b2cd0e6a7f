"""Shared neural layers: norms, rotary embeddings, MLPs, the embedding table.

The torch counterpart of ``repro.models.layers``. Compute follows the
JAX package's mixed-precision contract: params may be bf16, all norm and
rope math runs in fp32 and is cast back to the input's dtype. Weights keep
JAX's ``(in, out)`` layout, so a JAX parameter tree carries across as a
copy. Every ``init_*`` draws in fp32 from ``gen`` on ``device`` and casts
to the config's ``param_dtype``; ``lead`` prefixes a stacking shape (the
layer axis), as the JAX package's ``vmap`` over layer keys does.
``apply_mrope`` (qwen2-vl) waits for that family (``ROADMAP.md``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig

__all__ = ["init_norm", "apply_norm", "rope_frequencies", "apply_rope",
           "init_mlp", "apply_mlp", "init_embedding", "normal"]


def normal(gen: torch.Generator, shape, scale: float, dtype, device):
    """``N(0, 1) * scale`` drawn in fp32, then cast to ``dtype``."""
    x = torch.randn(tuple(shape), generator=gen, device=device)
    return x.mul_(float(scale)).to(dtype)


# ------------------------------------------------------------------ norms --


def init_norm(cfg: ModelConfig, d: int, *, device, lead=()):
    p = {"scale": torch.ones((*lead, d), device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros((*lead, d), device=device)
    return p


def apply_norm(params, x, cfg: ModelConfig, eps: float = 1e-6):
    xf = x.float()
    if cfg.norm_type == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, correction=0, keepdim=True)
        out = (xf - mu) / torch.sqrt(var + eps) * params["scale"] \
            + params["bias"]
    else:
        rms = torch.sqrt(xf.square().mean(-1, keepdim=True) + eps)
        out = xf / rms * params["scale"]
    return out.to(x.dtype)


# ------------------------------------------------------------------- rope --


def rope_frequencies(head_dim: int, fraction: float, theta: float):
    """(inverse frequencies (rot/2,) float32 numpy, rotated dims), computed
    in numpy float32 exactly as the JAX package does."""
    rot = int(head_dim * fraction) // 2 * 2
    inv = 1.0 / (theta ** (np.arange(0, rot, 2, dtype=np.float32) / rot))
    return inv.astype(np.float32), rot


@functools.lru_cache(maxsize=16)
def _inv_freq(head_dim: int, fraction: float, theta: float,
              device: torch.device):
    # one copy per device: a fresh host-to-device copy in every layer of
    # every decode step would stall the host
    inv, _ = rope_frequencies(head_dim, fraction, theta)
    return torch.from_numpy(inv).to(device)


def apply_rope(x, positions, cfg: ModelConfig):
    """x: (..., S, H, Dh); positions: (..., S) integer."""
    _, rot = rope_frequencies(cfg.head_dim, cfg.rope_fraction, cfg.rope_theta)
    inv = _inv_freq(cfg.head_dim, cfg.rope_fraction, cfg.rope_theta, x.device)
    ang = positions[..., :, None].float() * inv  # (..., S, rot/2)
    sin = torch.sin(ang)[..., :, None, :]
    cos = torch.cos(ang)[..., :, None, :]
    xf = x.float()
    xr, xp = xf[..., :rot], xf[..., rot:]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, xp], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------------- mlp --


def init_mlp(gen, cfg: ModelConfig, d_in: int, d_ff: int, *, device,
             lead=()):
    dt = cfg.pdtype()
    s_in, s_ff = 1.0 / np.sqrt(d_in), 1.0 / np.sqrt(d_ff)
    p = {
        "w_up": normal(gen, (*lead, d_in, d_ff), s_in, dt, device),
        "w_down": normal(gen, (*lead, d_ff, d_in), s_ff, dt, device),
    }
    if cfg.mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = normal(gen, (*lead, d_in, d_ff), s_in, dt, device)
    return p


def apply_mlp(params, x, cfg: ModelConfig):
    h = x @ params["w_up"]
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ params["w_gate"]) * h
    elif cfg.mlp_type == "geglu":
        h = F.gelu(x @ params["w_gate"], approximate="tanh") * h
    elif cfg.mlp_type == "gelu":
        h = F.gelu(h, approximate="tanh")
    elif cfg.mlp_type == "relu2":  # nemotron squared-ReLU
        h = torch.square(F.relu(h))
    else:
        raise ValueError(cfg.mlp_type)
    return h @ params["w_down"]


# -------------------------------------------------------------- embedding --


def init_embedding(gen, cfg: ModelConfig, *, device):
    dt = cfg.pdtype()
    p = {"embedding": normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt,
                             device)}
    if not cfg.tie_embeddings:
        p["unembed"] = normal(gen, (cfg.d_model, cfg.vocab_size),
                              1.0 / np.sqrt(cfg.d_model), dt, device)
    return p
