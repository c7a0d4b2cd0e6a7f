"""Model assembly for the dense decoder-only family, and its serving cache.

The torch counterpart of ``repro.models.transformer`` for the dense family.
Params have the JAX package's structure, so a JAX parameter tree carries
across as a copy (``from_jax_params``):
  embed        {"embedding": (V, d)[, "unembed": (d, V)]}
  layers       block params stacked on a leading n_layers axis
  final_norm   {"scale": (d,)}

Forward modes: ``forward_full`` runs a whole sequence for training (each
layer under ``torch.utils.checkpoint`` as ``cfg.remat`` says), and
``lm_loss`` takes the cross-entropy in chunks of ``cfg.loss_chunk``
positions, each chunk recomputed in backward, so the (B, S, V) fp32 logits
never live at once; ``forward_prefill`` runs the whole prompt and builds the
serving cache; ``forward_decode`` runs one token against it, **updating the
cache in place** (the JAX launcher donates the cache to the same effect: at
qwen3-4b's width the cache of 8 slots of 1088 positions is 1.28 GB). Layers
run as a Python loop over per-layer views of the stacked params
(``_unstack``), where the JAX package scans; their gradients land in the
stacked tensors. The MoE, SSM, hybrid and encoder-decoder families raise
``NotImplementedError`` until they are ported (``ROADMAP.md``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve_device

from .attention import (apply_attention_decode, layer_window,
                        quantize_kv_rows)
from .blocks import apply_transformer_block, init_transformer_block
from .config import ModelConfig
from .layers import apply_mlp, apply_norm, init_embedding, init_norm

__all__ = ["init_model", "from_jax_params", "from_jax_opt_state",
           "embed_tokens", "logits_from_hidden", "forward_full", "lm_loss",
           "init_cache", "forward_prefill", "forward_decode"]


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet; the "
            "port runs the dense family so far (ROADMAP.md)")


def _unstack(tree, n: int):
    """A tree of stacked (n, ...) tensors -> n trees of per-layer views."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return list(tree.unbind(0))


# ------------------------------------------------------------------- init --


def init_model(cfg: ModelConfig, gen: torch.Generator, device="cuda"):
    """Parameters drawn as the JAX package's ``init_model`` draws them
    (normal / sqrt(fan-in), the embedding normal * 0.02, norms 1), in fp32
    from ``gen`` (which lives on ``device``), cast to ``cfg.param_dtype``;
    the same tree of shapes and dtypes, not the same numbers."""
    _dense_only(cfg)
    device = resolve_device(device)
    return {
        "embed": init_embedding(gen, cfg, device=device),
        "layers": init_transformer_block(gen, cfg, device=device,
                                         lead=(cfg.n_layers,)),
        "final_norm": init_norm(cfg, cfg.d_model, device=device),
    }


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: carry the bits across
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def from_jax_params(params, cfg: ModelConfig, *, device="cuda"):
    """The JAX package's ``init_model`` tree (numpy leaves: ``embed``,
    ``layers`` stacked on a leading L axis, ``final_norm``) as the port's
    parameters on ``device``: the same layout and values, so both packages
    compute the same function."""
    _dense_only(cfg)
    device = resolve_device(device)

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return _tensor(tree, device)

    out = conv({k: params[k] for k in ("embed", "layers", "final_norm")})
    n = out["layers"]["attn"]["wq"].shape[0]
    if n != cfg.n_layers:
        raise ValueError(f"params have {n} layers, {cfg.name} {cfg.n_layers}")
    return out


def from_jax_opt_state(state, like, *, device="cuda"):
    """A JAX optimizer state (``repro.train.optim``, numpy leaves) as the
    port's, on ``device``. ``like`` is the port's state of the same
    optimizer (``opt.init(params)``): the two trees flatten in the same
    order (``train.tree``), so each JAX leaf takes the place of the port's,
    a count as an int, an array as a tensor of the same shape."""
    from repro_torch.train.tree import leaves, unflatten

    device = resolve_device(device)
    theirs, mine = leaves(state), leaves(like)
    if len(theirs) != len(mine):
        raise ValueError(f"JAX state has {len(theirs)} leaves, the port's "
                         f"{len(mine)}: not the same optimizer")
    out = []
    for x, ref in zip(theirs, mine):
        if isinstance(ref, int):
            out.append(int(np.asarray(x)))
            continue
        t = _tensor(x, device)
        if t.shape != ref.shape:
            raise ValueError(f"JAX leaf {tuple(t.shape)} against the port's "
                             f"{tuple(ref.shape)}")
        out.append(t)
    return unflatten(like, out)


# ------------------------------------------------------------------ embed --


def embed_tokens(params, tokens, cfg: ModelConfig):
    h = params["embed"]["embedding"][tokens.long()].to(cfg.cdtype())
    if cfg.embed_scale:
        # the JAX package multiplies by a numpy float32 scalar, which
        # promotes a bf16 hidden state to float32
        h = h.float() * float(np.sqrt(cfg.d_model).astype(np.float32))
    return h


def logits_from_hidden(params, hidden, cfg: ModelConfig):
    """Final norm and unembedding: the matmul in the compute dtype, the
    logits cast to float32, then the final softcap."""
    h = apply_norm(params["final_norm"], hidden, cfg)
    if cfg.tie_embeddings:
        logits = (h @ params["embed"]["embedding"].T).float()
    else:
        logits = (h @ params["embed"]["unembed"]).float()
    if cfg.final_softcap > 0:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


# ------------------------------------------------------------------ remat --


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    """The JAX package's ``dots_with_no_batch_dims_saveable``: keep the
    projections' outputs (2-D products); recompute the rest, the attention
    einsums (batched products) included."""
    if op in _MATMULS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, cfg: ModelConfig):
    """``cfg.remat``: "full" recomputes the whole layer in backward,
    "dots" saves the matrix products and recomputes the rest, "none" keeps
    every activation."""
    if cfg.remat == "none":
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_matmuls)
    return lambda *a: checkpoint(fn, *a, use_reentrant=False, **kw)


# ----------------------------------------------------------- full forward --


def forward_full(params, cfg: ModelConfig, *, tokens):
    """Full-sequence forward of tokens (B, S) -> (hidden (B, S, d), aux);
    aux is {} (MoE losses come with that family)."""
    _dense_only(cfg)
    h = embed_tokens(params, tokens, cfg).to(cfg.cdtype())
    for i, layer in enumerate(_unstack(params["layers"], cfg.n_layers)):
        block = functools.partial(
            apply_transformer_block, cfg=cfg,
            layer_local=cfg.layer_is_local(i))
        h = _maybe_remat(block, cfg)(layer, h)
    return h, {}


def lm_loss(params, hidden, targets, mask, cfg: ModelConfig):
    """Masked mean softmax cross-entropy over chunks of ``cfg.loss_chunk``
    positions (halved until it divides S), each chunk's logits recomputed
    in backward."""
    B, S, _ = hidden.shape
    C = min(cfg.loss_chunk, S)
    while S % C:
        C //= 2

    def chunk_nll(h_c, t_c, m_c):
        logits = logits_from_hidden(params, h_c, cfg)  # (B, C, V) f32
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, t_c.long()[..., None])[..., 0]
        return ((lse - gold) * m_c).sum()

    tot = cnt = torch.zeros((), device=hidden.device)
    for c0 in range(0, S, C):
        part = slice(c0, c0 + C)
        tot = tot + checkpoint(chunk_nll, hidden[:, part], targets[:, part],
                               mask[:, part], use_reentrant=False)
        cnt = cnt + mask[:, part].sum()
    return tot / torch.clamp(cnt, min=1.0)


# ------------------------------------------------------------------ cache --


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> Dict[str, Any]:
    """Zeroed cache + length counter for decode: ``len`` (B,) int32; ``k``,
    ``v`` (L, B, S, Hkv, Dh) in the compute dtype (int8 with cfg.kv_quant,
    plus ``k_scale`` / ``v_scale`` (L, B, S, Hkv) float32)."""
    _dense_only(cfg)
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    kv_dt = torch.int8 if cfg.kv_quant else cfg.cdtype()
    cache = {
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
        "k": torch.zeros(shape, dtype=kv_dt, device=device),
        "v": torch.zeros(shape, dtype=kv_dt, device=device),
    }
    if cfg.kv_quant:
        cache["k_scale"] = torch.zeros(shape[:-1], device=device)
        cache["v_scale"] = torch.zeros(shape[:-1], device=device)
    return cache


def _pad_cache_seq(x, max_len: int, axis: int = -3):
    """Pad (with zeros) or cut a (..., S, Hkv, Dh) cache tensor along S to
    max_len (``axis=-2`` for the (..., S, Hkv) scales)."""
    n = x.shape[axis]
    if n >= max_len:
        return x.narrow(axis, 0, max_len)
    pad = list(x.shape)
    pad[axis] = max_len - n
    return torch.cat([x, x.new_zeros(pad)], dim=axis)


# ---------------------------------------------------------------- prefill --


def forward_prefill(params, cfg: ModelConfig, *, tokens,
                    max_len: Optional[int] = None):
    """Full-sequence forward of tokens (B, S) that also builds the serving
    cache. Returns (hidden (B, S, d), cache); max_len pads the cache for
    later decoding (len = S, the prompt length)."""
    _dense_only(cfg)
    h = embed_tokens(params, tokens, cfg).to(cfg.cdtype())
    B, S = h.shape[0], h.shape[1]
    max_len = max_len or S
    cache = init_cache(cfg, B, max_len, device=h.device)
    cache["len"].fill_(S)
    layers = _unstack(params["layers"], cfg.n_layers)
    for i, layer in enumerate(layers):
        h, (k, v) = apply_transformer_block(
            layer, h, cfg, layer_local=cfg.layer_is_local(i), return_kv=True)
        if cfg.kv_quant:
            k, k_sc = quantize_kv_rows(k)
            v, v_sc = quantize_kv_rows(v)
            cache["k_scale"][i] = _pad_cache_seq(k_sc, max_len, -2)
            cache["v_scale"][i] = _pad_cache_seq(v_sc, max_len, -2)
        cache["k"][i] = _pad_cache_seq(k, max_len)
        cache["v"][i] = _pad_cache_seq(v, max_len)
    return h, cache


# ----------------------------------------------------------------- decode --


def forward_decode(params, cache, tokens, cfg: ModelConfig):
    """One-token decode. tokens: (B, 1) -> (logits (B, 1, V) float32,
    cache). The cache's tensors are updated in place and its ``len``
    replaced by len + 1; the same dict is returned."""
    _dense_only(cfg)
    h = embed_tokens(params, tokens, cfg).to(cfg.cdtype())
    length = cache["len"]
    layers = _unstack(params["layers"], cfg.n_layers)
    for i, layer in enumerate(layers):
        scales = None
        if cfg.kv_quant:
            scales = (cache["k_scale"][i], cache["v_scale"][i])
        x = apply_norm(layer["attn_norm"], h, cfg)
        a = apply_attention_decode(
            layer["attn"], x, cache["k"][i], cache["v"][i], length, cfg,
            window=layer_window(cfg, cfg.layer_is_local(i)), scales=scales,
        )
        if cfg.post_norm:
            a = apply_norm(layer["attn_post_norm"], a, cfg)
        h = h + a
        m = apply_mlp(layer["mlp"], apply_norm(layer["mlp_norm"], h, cfg),
                      cfg)
        if cfg.post_norm:
            m = apply_norm(layer["mlp_post_norm"], m, cfg)
        h = h + m
    cache["len"] = length + 1
    return logits_from_hidden(params, h, cfg), cache
