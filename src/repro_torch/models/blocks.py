"""Residual blocks: the dense transformer block.

The torch counterpart of the dense part of ``repro.models.blocks``: pre-norm
attention and MLP sublayers with residual adds, and gemma2's optional
post-norms. The MoE, mamba and zamba2 shared blocks wait for their families
(``ROADMAP.md``).
"""
from __future__ import annotations

from .attention import apply_attention, init_attention
from .config import ModelConfig
from .layers import apply_mlp, apply_norm, init_mlp, init_norm

__all__ = ["init_transformer_block", "apply_transformer_block"]


def init_transformer_block(gen, cfg: ModelConfig, *, device, lead=()):
    if cfg.moe is not None:
        raise NotImplementedError(
            "MoE blocks are not ported yet (ROADMAP.md)")
    p = {
        "attn_norm": init_norm(cfg, cfg.d_model, device=device, lead=lead),
        "attn": init_attention(gen, cfg, device=device, lead=lead),
        "mlp_norm": init_norm(cfg, cfg.d_model, device=device, lead=lead),
        "mlp": init_mlp(gen, cfg, cfg.d_model, cfg.d_ff, device=device,
                        lead=lead),
    }
    if cfg.post_norm:
        p["attn_post_norm"] = init_norm(cfg, cfg.d_model, device=device,
                                        lead=lead)
        p["mlp_post_norm"] = init_norm(cfg, cfg.d_model, device=device,
                                       lead=lead)
    return p


def apply_transformer_block(params, h, cfg: ModelConfig, *,
                            layer_local: bool = False, return_kv=False):
    """Pre-norm residual block (causal). Returns h, or (h, (k, v)) with
    return_kv."""
    a = apply_attention(
        params["attn"], apply_norm(params["attn_norm"], h, cfg), cfg,
        layer_local=layer_local, return_kv=return_kv,
    )
    kv = None
    if return_kv:
        a, kv = a
    if cfg.post_norm:
        a = apply_norm(params["attn_post_norm"], a, cfg)
    h = h + a
    m = apply_mlp(params["mlp"], apply_norm(params["mlp_norm"], h, cfg), cfg)
    if cfg.post_norm:
        m = apply_norm(params["mlp_post_norm"], m, cfg)
    h = h + m
    if return_kv:
        return h, kv
    return h
