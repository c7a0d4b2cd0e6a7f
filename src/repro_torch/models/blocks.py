"""Residual blocks: the dense / MoE transformer block, the mamba block and
zamba2's shared attention block with its per-invocation LoRA.

The torch counterpart of ``repro.models.blocks``: pre-norm sublayers with
residual adds, gemma2's optional post-norms, the MoE branch (which returns
its aux losses), the encoder-decoder's cross-attention sublayer, and the
hybrid family's shared block, which sees
concat(hidden, initial embedding) projected back to d and folds this
invocation's LoRA deltas into the shared q/k/v weights at every call,
decode included.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed.sharding import constrain, matmul

from .attention import apply_attention, init_attention, spec_attention
from .config import ModelConfig
from .layers import (apply_mlp, apply_norm, init_mlp, init_norm, normal,
                     spec_mlp, spec_norm)
from .mamba2 import init_mamba, mamba_forward, spec_mamba
from .moe import apply_moe, init_moe, spec_moe

__all__ = ["init_transformer_block", "apply_ffn", "apply_transformer_block",
           "init_mamba_block", "apply_mamba_block", "init_shared_block",
           "init_shared_lora", "lora_attention_params", "apply_shared_block",
           "spec_transformer_block", "spec_mamba_block", "spec_shared_block",
           "spec_shared_lora"]


# ------------------------------------------------- dense / moe transformer --


def _normed(params, h, cfg: ModelConfig):
    """A sublayer's input: the normed residual, its sequence whole (under
    a mesh, a sequence-parallel residual is gathered here, where GSPMD
    gathers it in the JAX package)."""
    return constrain(apply_norm(params, h, cfg), "batch", "seq", "act_embed")


def init_transformer_block(gen, cfg: ModelConfig, *, device, lead=(),
                           cross: bool = False):
    """A block's params; ``cross`` adds the decoder's cross-attention
    sublayer (``cross_norm``, ``cross_attn``), drawn after the rest."""
    p = {
        "attn_norm": init_norm(cfg, cfg.d_model, device=device, lead=lead),
        "attn": init_attention(gen, cfg, device=device, lead=lead),
        "mlp_norm": init_norm(cfg, cfg.d_model, device=device, lead=lead),
    }
    if cfg.moe is not None:
        p["moe"] = init_moe(gen, cfg, device=device, lead=lead)
    else:
        p["mlp"] = init_mlp(gen, cfg, cfg.d_model, cfg.d_ff, device=device,
                            lead=lead)
    if cfg.post_norm:
        p["attn_post_norm"] = init_norm(cfg, cfg.d_model, device=device,
                                        lead=lead)
        p["mlp_post_norm"] = init_norm(cfg, cfg.d_model, device=device,
                                       lead=lead)
    if cross:
        p["cross_norm"] = init_norm(cfg, cfg.d_model, device=device,
                                    lead=lead)
        p["cross_attn"] = init_attention(gen, cfg, device=device, lead=lead,
                                         cross=True)
    return p


def spec_transformer_block(cfg: ModelConfig, *, cross: bool = False):
    p = {
        "attn_norm": spec_norm(cfg),
        "attn": spec_attention(cfg),
        "mlp_norm": spec_norm(cfg),
    }
    if cfg.moe is not None:
        p["moe"] = spec_moe(cfg)
    else:
        p["mlp"] = spec_mlp(cfg)
    if cfg.post_norm:
        p["attn_post_norm"] = spec_norm(cfg)
        p["mlp_post_norm"] = spec_norm(cfg)
    if cross:
        p["cross_norm"] = spec_norm(cfg)
        p["cross_attn"] = spec_attention(cfg, cross=True)
    return p


def apply_ffn(params, x, cfg: ModelConfig):
    """The block's feed-forward sublayer on normed x -> (y, aux): the MLP
    (aux {}) or the MoE layer (its aux losses)."""
    if cfg.moe is not None:
        return apply_moe(params["moe"], x, cfg)
    return apply_mlp(params["mlp"], x, cfg), {}


def apply_transformer_block(params, h, cfg: ModelConfig, *,
                            causal: bool = True, positions=None,
                            enc_out=None, layer_local: bool = False,
                            return_kv=False):
    """Pre-norm residual block: self-attention (``causal``, rotated at
    ``positions``), then, given the encoder's output ``enc_out``,
    cross-attention over it, then the FFN. Returns (h, aux), or (h, aux,
    (k, v)) of the self-attention with return_kv; aux holds the MoE losses
    ({} for an MLP)."""
    a = apply_attention(
        params["attn"], _normed(params["attn_norm"], h, cfg), cfg,
        causal=causal, positions=positions, layer_local=layer_local,
        return_kv=return_kv,
    )
    kv = None
    if return_kv:
        a, kv = a
    if cfg.post_norm:
        a = apply_norm(params["attn_post_norm"], a, cfg)
    # constrain the sublayer OUTPUT (a TP partial sum) straight to the
    # residual's layout: a reduce-scatter instead of an all-reduce and a
    # gather
    a = constrain(a, "batch", "res_seq", "act_embed")
    h = constrain(h + a, "batch", "res_seq", "act_embed")
    if enc_out is not None:
        c = apply_attention(
            params["cross_attn"], _normed(params["cross_norm"], h, cfg),
            cfg, causal=False, kv_override=enc_out)
        h = constrain(h + c, "batch", "res_seq", "act_embed")
    m, aux = apply_ffn(params, _normed(params["mlp_norm"], h, cfg), cfg)
    if cfg.post_norm:
        m = apply_norm(params["mlp_post_norm"], m, cfg)
    m = constrain(m, "batch", "res_seq", "act_embed")
    h = constrain(h + m, "batch", "res_seq", "act_embed")
    if return_kv:
        return h, aux, kv
    return h, aux


# ------------------------------------------------------------------- mamba --


def init_mamba_block(gen, cfg: ModelConfig, *, device, lead=()):
    return {"norm": init_norm(cfg, cfg.d_model, device=device, lead=lead),
            "mamba": init_mamba(gen, cfg, device=device, lead=lead)}


def spec_mamba_block(cfg: ModelConfig):
    return {"norm": spec_norm(cfg), "mamba": spec_mamba(cfg)}


def apply_mamba_block(params, h, cfg: ModelConfig, *, return_state=False):
    """h + mamba(norm(h)); with return_state also the (conv, ssd) state."""
    y = mamba_forward(params["mamba"], _normed(params["norm"], h, cfg),
                      cfg, return_state=return_state)
    state = None
    if return_state:
        y, state = y
    h = constrain(h + y, "batch", "res_seq", "act_embed")
    if return_state:
        return h, state
    return h


# ------------------------------------------------- zamba2 shared attention --


def init_shared_block(gen, cfg: ModelConfig, *, device):
    """One set of attention + MLP weights, used at every invocation."""
    d = cfg.d_model
    return {
        "in_proj": normal(gen, (2 * d, d), 1.0 / np.sqrt(2 * d),
                          cfg.pdtype(), device),
        "norm": init_norm(cfg, d, device=device),
        "attn": init_attention(gen, cfg, device=device),
        "mlp_norm": init_norm(cfg, d, device=device),
        "mlp": init_mlp(gen, cfg, d, cfg.d_ff, device=device),
    }


def spec_shared_block(cfg: ModelConfig):
    return {
        "in_proj": ("embed", "embed"),
        "norm": spec_norm(cfg),
        "attn": spec_attention(cfg),
        "mlp_norm": spec_norm(cfg),
        "mlp": spec_mlp(cfg),
    }


def init_shared_lora(gen, cfg: ModelConfig, *, device, lead=()):
    """Per-invocation LoRA on the shared block's q/k/v: A normal /
    sqrt(d), B zero (each LoRA starts as the identity)."""
    r, d = cfg.shared_lora_rank, cfg.d_model
    dt = cfg.pdtype()
    out = {"q": cfg.n_heads * cfg.head_dim,
           "k": cfg.n_kv_heads * cfg.head_dim,
           "v": cfg.n_kv_heads * cfg.head_dim}
    p = {}
    for name, width in out.items():
        p[name + "A"] = normal(gen, (*lead, d, r), 1.0 / np.sqrt(d), dt,
                               device)
        p[name + "B"] = torch.zeros((*lead, r, width), dtype=dt,
                                    device=device)
    return p


def spec_shared_lora(cfg: ModelConfig):
    return {
        "qA": ("embed", "lora"), "qB": ("lora", "heads_joined"),
        "kA": ("embed", "lora"), "kB": ("lora", "kv_joined"),
        "vA": ("embed", "lora"), "vB": ("lora", "kv_joined"),
    }


def lora_attention_params(shared, lora, cfg: ModelConfig):
    """The shared attention weights with this invocation's LoRA deltas
    folded in (new tensors; the shared ones are left as they are)."""
    attn_p = dict(shared["attn"])
    for name in ("q", "k", "v"):
        w = attn_p["w" + name]
        delta = lora[name + "A"] @ lora[name + "B"]
        attn_p["w" + name] = w + delta.reshape(w.shape)
    return attn_p


def apply_shared_block(shared, lora, h, emb0, cfg: ModelConfig, *,
                       return_kv=False):
    """Zamba2's shared block, with this invocation's LoRA. Returns h, or
    (h, (k, v)) with return_kv."""
    u = matmul(torch.cat([h, emb0], dim=-1), shared["in_proj"])
    x = apply_norm(shared["norm"], u, cfg)
    a = apply_attention(lora_attention_params(shared, lora, cfg), x, cfg,
                        return_kv=return_kv)
    kv = None
    if return_kv:
        a, kv = a
    h = constrain(h + a, "batch", "res_seq", "act_embed")
    m = apply_mlp(shared["mlp"], _normed(shared["mlp_norm"], h, cfg), cfg)
    h = constrain(h + m, "batch", "res_seq", "act_embed")
    if return_kv:
        return h, kv
    return h
