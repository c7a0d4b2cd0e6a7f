"""Shared neural layers: norms, rotary embeddings (incl. M-RoPE), MLPs, the
embedding table.

The torch counterpart of ``repro.models.layers``. Compute follows the
JAX package's mixed-precision contract: params may be bf16, all norm and
rope math runs in fp32 and is cast back to the input's dtype. Weights keep
JAX's ``(in, out)`` layout, so a JAX parameter tree carries across as a
copy. Every ``init_*`` draws in fp32 from ``gen`` on ``device`` and casts
to the config's ``param_dtype`` (``normal``: a leaf above ``DRAW_BYTES`` in
fp32 slice by slice; on ``meta`` no draw at all); ``lead`` prefixes a
stacking shape (the layer axis), as the JAX package's ``vmap`` over layer
keys does. Every ``init_*`` has
a twin ``spec_*`` returning the same tree of logical axis-name tuples
(``distributed.sharding``), without the stacking names (``transformer.
model_specs`` adds them).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import constrain, matmul

from .config import ModelConfig

__all__ = ["init_norm", "apply_norm", "rms_norm_groups", "rope_frequencies",
           "apply_rope", "apply_mrope", "init_mlp", "apply_mlp", "init_embedding", "normal",
           "DRAW_BYTES", "spec_norm", "spec_mlp", "spec_embedding"]

# The largest fp32 draw ``normal`` makes at once. Every leaf of qwen3-4b and
# gemma2-2b at full width is below it (the largest, qwen3-4b's stacked MLP
# weight, takes 3.58 GB), so they keep the bits of one draw; a stacked expert
# weight of moonshot-v1-16b-a3b (48 x 64 x 2048 x 1408) would take 35.4 GB.
DRAW_BYTES = 4 << 30


def normal(gen: torch.Generator, shape, scale: float, dtype, device):
    """``N(0, 1) * scale`` drawn in fp32, then cast to ``dtype``. A leaf
    whose fp32 draw would exceed ``DRAW_BYTES`` is drawn and cast slice by
    slice along its leading axes (the same generator in order), so no more
    than that is ever held in fp32."""
    shape = tuple(shape)
    if torch.device(device).type == "meta":  # a shape: nothing to draw
        return torch.empty(shape, dtype=dtype, device=device)
    if len(shape) < 2 or 4 * math.prod(shape) <= DRAW_BYTES:
        x = torch.randn(shape, generator=gen, device=device)
        return x.mul_(float(scale)).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        out[i] = normal(gen, shape[1:], scale, dtype, device)
    return out


# ------------------------------------------------------------------ norms --


def init_norm(cfg: ModelConfig, d: int, *, device, lead=()):
    p = {"scale": torch.ones((*lead, d), device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros((*lead, d), device=device)
    return p


def spec_norm(cfg: ModelConfig):
    if cfg.norm_type == "layernorm":
        return {"scale": ("embed",), "bias": ("embed",)}
    return {"scale": ("embed",)}


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


def rms_norm_groups(x, scale, n_groups: int, eps: float = 1e-6):
    """Grouped RMSNorm (mamba2's gated output norm): each of ``n_groups``
    equal slices of the last axis normalised on its own, then scaled."""
    xf = x.float()
    xg = xf.unflatten(-1, (n_groups, xf.shape[-1] // n_groups))
    rms = torch.sqrt(xg.square().mean(-1, keepdim=True) + eps)
    return ((xg / rms).flatten(-2) * scale).to(x.dtype)


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
    return _rotate(x, ang, rot)


@functools.lru_cache(maxsize=16)
def _section_ids(sections, device: torch.device):
    # which of the (t, h, w) streams each of the rot/2 frequencies uses
    return torch.repeat_interleave(torch.arange(3),
                                   torch.tensor(sections)).to(device)


def apply_mrope(x, positions3, cfg: ModelConfig):
    """Multimodal RoPE (qwen2-vl). x: (..., S, H, Dh); positions3:
    (3, ..., S) integer, the (t, h, w) streams. The rotary half splits into
    ``cfg.mrope_sections`` runs of frequencies, and each run rotates by its
    own stream; dims past the rotary ones stay as they are."""
    sections = tuple(cfg.mrope_sections)
    _, rot = rope_frequencies(cfg.head_dim, cfg.rope_fraction, cfg.rope_theta)
    if sum(sections) != rot // 2:
        raise ValueError(f"mrope sections {sections} must sum to {rot // 2}")
    inv = _inv_freq(cfg.head_dim, cfg.rope_fraction, cfg.rope_theta, x.device)
    pos = torch.movedim(positions3, 0, -1).float()  # (..., S, 3)
    ang = pos[..., _section_ids(sections, x.device)] * inv  # (..., S, rot/2)
    return _rotate(x, ang, rot)


def _rotate(x, ang, rot: int):
    """Rotate the first ``rot`` dims of x (..., S, H, Dh) by the angles
    (..., S, rot/2) in fp32 (halves, not interleaved pairs), cast back."""
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


def spec_mlp(cfg: ModelConfig):
    p = {"w_up": ("embed", "mlp"), "w_down": ("mlp", "embed")}
    if cfg.mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = ("embed", "mlp")
    return p


def apply_mlp(params, x, cfg: ModelConfig):
    h = matmul(x, params["w_up"])
    if cfg.mlp_type == "swiglu":
        h = F.silu(matmul(x, params["w_gate"])) * h
    elif cfg.mlp_type == "geglu":
        h = F.gelu(matmul(x, params["w_gate"]), approximate="tanh") * h
    elif cfg.mlp_type == "gelu":
        h = F.gelu(h, approximate="tanh")
    elif cfg.mlp_type == "relu2":  # nemotron squared-ReLU
        h = torch.square(F.relu(h))
    else:
        raise ValueError(cfg.mlp_type)
    h = constrain(h, "batch", "seq", "mlp")
    return matmul(h, params["w_down"])


# -------------------------------------------------------------- embedding --


def init_embedding(gen, cfg: ModelConfig, *, device):
    dt = cfg.pdtype()
    p = {"embedding": normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt,
                             device)}
    if not cfg.tie_embeddings:
        p["unembed"] = normal(gen, (cfg.d_model, cfg.vocab_size),
                              1.0 / np.sqrt(cfg.d_model), dt, device)
    return p


def spec_embedding(cfg: ModelConfig):
    p = {"embedding": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        p["unembed"] = ("embed", "vocab")
    return p
