"""Model assembly for the dense, MoE, SSM, hybrid and encoder-decoder
families (the vision frontend and M-RoPE included), and their serving
cache.

The torch counterpart of ``repro.models.transformer``. Params have the JAX
package's structure, so a JAX parameter tree carries across as a copy
(``from_jax_params``):
  embed        {"embedding": (V, d)[, "unembed": (d, V)]}
  layers       block params stacked on a leading n_layers axis (dense and
               MoE transformer blocks, or mamba blocks); hybrid: mamba
               blocks stacked on (groups, per)
  tail         (hybrid) the trailing mamba blocks, stacked
  shared       (hybrid) zamba2's shared attention block
  loras        (hybrid) its per-invocation LoRA, stacked on groups
  encoder      (encdec) the encoder's blocks, stacked; the decoder's blocks
               in ``layers`` carry ``cross_norm`` and ``cross_attn``
  enc_norm     (encdec) the encoder's final norm
  final_norm   {"scale": (d,)}

Forward modes: ``forward_full`` runs a whole sequence for training (each
layer under ``torch.utils.checkpoint`` as ``cfg.remat`` says), and
``lm_loss`` takes the cross-entropy in chunks of ``cfg.loss_chunk``
positions, each chunk recomputed in backward, so the (B, S, V) fp32 logits
never live at once; ``forward_prefill`` runs the whole prompt and builds the
serving cache (KV for attention, conv + SSD state for mamba blocks, the
cross-attention's K/V of the encoder's output); ``forward_decode`` runs
one token against it, **updating the cache in
place** (the JAX launcher donates the cache to the same effect: at
qwen3-4b's width the cache of 8 slots of 1088 positions is 1.28 GB). Layers
run as a Python loop over per-layer views of the stacked params
(``_unstack``), where the JAX package scans; their gradients land in the
stacked tensors. The vision frontend is a stub, as in the JAX package:
precomputed patch embeddings come in as ``embeds`` (``steps``), with
(3, B, S) M-RoPE positions; so are the audio frames the encoder takes.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve_device

from .attention import (apply_attention_decode,
                        apply_cross_attention_decode, cross_kv, layer_window,
                        quantize_kv_rows)
from .blocks import (apply_ffn, apply_mamba_block, apply_shared_block,
                     apply_transformer_block, init_mamba_block,
                     init_shared_block, init_shared_lora,
                     init_transformer_block, lora_attention_params)
from .config import ModelConfig
from .layers import apply_mlp, apply_norm, init_embedding, init_norm
from .mamba2 import init_mamba_cache, mamba_decode

__all__ = ["init_model", "from_jax_params", "from_jax_opt_state",
           "hybrid_layout", "embed_tokens", "logits_from_hidden",
           "forward_full", "lm_loss", "init_cache", "forward_prefill",
           "forward_decode"]


def hybrid_layout(cfg: ModelConfig):
    """(groups, mamba blocks per group, trailing mamba blocks) of a
    zamba2-style hybrid: each group's blocks are followed by one call of the
    shared attention block."""
    per = cfg.shared_every
    groups = cfg.n_layers // per
    return groups, per, cfg.n_layers - groups * per


def _unstack(tree, n: int):
    """A tree of stacked (n, ...) tensors -> n trees of per-layer views."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return list(tree.unbind(0))


# ------------------------------------------------------------------- init --


def init_model(cfg: ModelConfig, gen: torch.Generator, device="cuda"):
    """Parameters drawn as the JAX package's ``init_model`` draws them
    (normal / sqrt(fan-in), the embedding normal * 0.02, norms 1, mamba's
    and the LoRA's own), in fp32 from ``gen`` (which lives on ``device``),
    cast to ``cfg.param_dtype``; the same tree of shapes and dtypes, not
    the same numbers."""
    device = resolve_device(device)
    params = {"embed": init_embedding(gen, cfg, device=device)}
    if cfg.family in ("dense", "moe", "encdec"):
        params["layers"] = init_transformer_block(
            gen, cfg, device=device, lead=(cfg.n_layers,),
            cross=cfg.family == "encdec")
    elif cfg.family == "ssm":
        params["layers"] = init_mamba_block(gen, cfg, device=device,
                                            lead=(cfg.n_layers,))
    elif cfg.family == "hybrid":
        groups, per, trailing = hybrid_layout(cfg)
        params["layers"] = init_mamba_block(gen, cfg, device=device,
                                            lead=(groups, per))
        if trailing:
            params["tail"] = init_mamba_block(gen, cfg, device=device,
                                              lead=(trailing,))
        params["shared"] = init_shared_block(gen, cfg, device=device)
        params["loras"] = init_shared_lora(gen, cfg, device=device,
                                           lead=(groups,))
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    if cfg.family == "encdec":
        params["encoder"] = init_transformer_block(
            gen, cfg, device=device, lead=(cfg.n_encoder_layers,))
        params["enc_norm"] = init_norm(cfg, cfg.d_model, device=device)
    params["final_norm"] = init_norm(cfg, cfg.d_model, device=device)
    return params


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: carry the bits across
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _stack_shapes(cfg: ModelConfig):
    """{top-level key: its leading stacking shape} of the family's tree."""
    if cfg.family == "encdec":
        return {"layers": (cfg.n_layers,),
                "encoder": (cfg.n_encoder_layers,)}
    if cfg.family != "hybrid":
        return {"layers": (cfg.n_layers,)}
    groups, per, trailing = hybrid_layout(cfg)
    out = {"layers": (groups, per), "loras": (groups,)}
    if trailing:
        out["tail"] = (trailing,)
    return out


def from_jax_params(params, cfg: ModelConfig, *, device="cuda"):
    """The JAX package's ``init_model`` tree (numpy leaves: ``embed``,
    ``layers`` stacked on a leading L axis, or (groups, per) with ``tail``,
    ``shared`` and ``loras`` for the hybrid, ``encoder`` and ``enc_norm``
    for the encoder-decoder, ``final_norm``) as the port's parameters on
    ``device``: the same layout and values, so both packages compute the
    same function."""
    device = resolve_device(device)

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return _tensor(tree, device)

    keys = ["embed", "layers", "final_norm"]
    if cfg.family == "hybrid":
        keys += ["shared", "loras"] + (["tail"] if "tail" in params else [])
    if cfg.family == "encdec":
        keys += ["encoder", "enc_norm"]
    out = conv({k: params[k] for k in keys})
    for key, lead in _stack_shapes(cfg).items():
        got = tuple(_first_leaf(out[key]).shape[:len(lead)])
        if got != lead:
            raise ValueError(f"params[{key!r}] are stacked {got}, "
                             f"{cfg.name} needs {lead}")
    return out


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


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


def _ssm_stack(layers, h, cfg: ModelConfig):
    n = layers["norm"]["scale"].shape[0]
    block = _maybe_remat(functools.partial(apply_mamba_block, cfg=cfg), cfg)
    for layer in _unstack(layers, n):
        h = block(layer, h)
    return h


def _hybrid_stack(params, h, cfg: ModelConfig, emb0):
    """Each group's mamba blocks, then the shared block with the group's
    LoRA (one recomputed unit in backward, as the JAX package's scan body),
    then the trailing blocks."""
    groups, per, trailing = hybrid_layout(cfg)

    def group(layers, lora, h):
        for layer in _unstack(layers, per):
            h = apply_mamba_block(layer, h, cfg)
        return apply_shared_block(params["shared"], lora, h, emb0, cfg)

    body = _maybe_remat(group, cfg)
    for layers, lora in zip(_unstack(params["layers"], groups),
                            _unstack(params["loras"], groups)):
        h = body(layers, lora, h)
    if trailing:
        h = _ssm_stack(params["tail"], h, cfg)
    return h


def _dense_stack(layers, h, cfg: ModelConfig, *, causal=True,
                 positions=None, enc_out=None):
    """Stacked transformer blocks over h, each under ``cfg.remat`` ->
    (h, aux): the MoE family's aux losses summed over the layers, else
    {}."""
    n = layers["attn_norm"]["scale"].shape[0]
    aux = {}
    if cfg.moe is not None:
        aux = {k: torch.zeros((), device=h.device)
               for k in ("load_balance_loss", "router_z_loss")}
    for i, layer in enumerate(_unstack(layers, n)):
        block = functools.partial(
            apply_transformer_block, cfg=cfg, causal=causal,
            positions=positions, enc_out=enc_out,
            layer_local=cfg.layer_is_local(i))
        h, layer_aux = _maybe_remat(block, cfg)(layer, h)
        aux = {k: aux[k] + v for k, v in layer_aux.items()}
    return h, aux


def _embed(params, cfg: ModelConfig, tokens, embeds):
    h = embed_tokens(params, tokens, cfg) if embeds is None else embeds
    return h.to(cfg.cdtype())


def _encode(params, enc_embeds, cfg: ModelConfig):
    """The encoder (encdec): non-causal blocks over the frame embeddings
    (B, T, d) at positions 0..T-1, then ``enc_norm``."""
    h, _ = _dense_stack(params["encoder"], enc_embeds.to(cfg.cdtype()), cfg,
                        causal=False)
    return apply_norm(params["enc_norm"], h, cfg)


def forward_full(params, cfg: ModelConfig, *, tokens=None, embeds=None,
                 positions=None, enc_embeds=None):
    """Full-sequence forward of tokens (B, S), or of their embeddings
    ``embeds`` (B, S, d), -> (hidden (B, S, d), aux). ``positions``: (B, S),
    or (3, B, S) for M-RoPE (default 0..S-1); the encoder-decoder encodes
    ``enc_embeds`` (B, T, d) first and every decoder block cross-attends to
    it. aux is {} but for the MoE family: its load-balance and router
    z-losses summed over the layers."""
    h = _embed(params, cfg, tokens, embeds)
    if cfg.family == "ssm":
        return _ssm_stack(params["layers"], h, cfg), {}
    if cfg.family == "hybrid":
        return _hybrid_stack(params, h, cfg, emb0=h), {}
    enc_out = _encode(params, enc_embeds, cfg) \
        if cfg.family == "encdec" else None
    return _dense_stack(params["layers"], h, cfg, positions=positions,
                        enc_out=enc_out)


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


def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int = 0,
               *, device="cuda") -> Dict[str, Any]:
    """Zeroed cache + length counter for decode: ``len`` (B,) int32, and
    * dense, MoE, encdec: ``k``, ``v`` (L, B, S, Hkv, Dh) in the compute
      dtype (int8 with cfg.kv_quant, plus ``k_scale`` / ``v_scale`` (L, B,
      S, Hkv) float32); encdec also ``cross_k``, ``cross_v`` (L, B,
      enc_len, Hkv, Dh) in the compute dtype;
    * SSM: ``conv`` (L, B, d_conv - 1, conv_dim) in the compute dtype and
      ``ssd`` (L, B, h, n, p) float32;
    * hybrid: ``conv``, ``ssd`` stacked on (groups, per), ``tail_conv``,
      ``tail_ssd`` on the trailing blocks, and one ``k``, ``v`` (groups, B,
      S, Hkv, Dh) per call of the shared block."""
    device = resolve_device(device)
    dt = cfg.cdtype()
    cache = {"len": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if cfg.family == "ssm":
        cache["conv"], cache["ssd"] = init_mamba_cache(
            batch, cfg, dt, device=device, lead=(cfg.n_layers,))
        return cache
    kv = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    if cfg.family == "hybrid":
        groups, per, trailing = hybrid_layout(cfg)
        cache["conv"], cache["ssd"] = init_mamba_cache(
            batch, cfg, dt, device=device, lead=(groups, per))
        if trailing:
            cache["tail_conv"], cache["tail_ssd"] = init_mamba_cache(
                batch, cfg, dt, device=device, lead=(trailing,))
        cache["k"] = torch.zeros((groups, *kv), dtype=dt, device=device)
        cache["v"] = torch.zeros((groups, *kv), dtype=dt, device=device)
        return cache
    shape = (cfg.n_layers, *kv)
    kv_dt = torch.int8 if cfg.kv_quant else dt
    cache["k"] = torch.zeros(shape, dtype=kv_dt, device=device)
    cache["v"] = torch.zeros(shape, dtype=kv_dt, device=device)
    if cfg.kv_quant:
        cache["k_scale"] = torch.zeros(shape[:-1], device=device)
        cache["v_scale"] = torch.zeros(shape[:-1], device=device)
    if cfg.family == "encdec":
        cross = (cfg.n_layers, batch, enc_len, *kv[2:])
        cache["cross_k"] = torch.zeros(cross, dtype=dt, device=device)
        cache["cross_v"] = torch.zeros(cross, dtype=dt, device=device)
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


def forward_prefill(params, cfg: ModelConfig, *, tokens=None, embeds=None,
                    positions=None, enc_embeds=None,
                    max_len: Optional[int] = None):
    """Full-sequence forward of tokens (B, S), or of ``embeds``, at
    ``positions`` (as ``forward_full``), that also builds the serving cache.
    Returns (hidden (B, S, d), cache); max_len pads the KV cache for later
    decoding (len = S, the prompt length). The encoder-decoder encodes
    ``enc_embeds`` (B, T, d) and caches each decoder block's cross K/V of
    the result (T positions)."""
    h = _embed(params, cfg, tokens, embeds)
    B, S = h.shape[0], h.shape[1]
    max_len = max_len or S
    enc_out = _encode(params, enc_embeds, cfg) \
        if cfg.family == "encdec" else None
    cache = init_cache(cfg, B, max_len,
                       0 if enc_out is None else enc_out.shape[1],
                       device=h.device)
    cache["len"].fill_(S)
    if cfg.family == "ssm":
        h = _prefill_mamba(params["layers"], h, cfg, cache["conv"],
                           cache["ssd"])
        return h, cache
    if cfg.family == "hybrid":
        return _prefill_hybrid(params, h, cfg, cache, max_len), cache
    layers = _unstack(params["layers"], cfg.n_layers)
    for i, layer in enumerate(layers):
        h, _, (k, v) = apply_transformer_block(
            layer, h, cfg, positions=positions, enc_out=enc_out,
            layer_local=cfg.layer_is_local(i), return_kv=True)
        if enc_out is not None:
            cache["cross_k"][i], cache["cross_v"][i] = cross_kv(
                layer["cross_attn"], enc_out)
        if cfg.kv_quant:
            k, k_sc = quantize_kv_rows(k)
            v, v_sc = quantize_kv_rows(v)
            cache["k_scale"][i] = _pad_cache_seq(k_sc, max_len, -2)
            cache["v_scale"][i] = _pad_cache_seq(v_sc, max_len, -2)
        cache["k"][i] = _pad_cache_seq(k, max_len)
        cache["v"][i] = _pad_cache_seq(v, max_len)
    return h, cache


def _prefill_mamba(layers, h, cfg: ModelConfig, conv, ssd):
    """Mamba blocks stacked on conv's leading axis, each writing its final
    (conv, ssd) state into that slot of ``conv`` and ``ssd``."""
    for i, layer in enumerate(_unstack(layers, conv.shape[0])):
        h, (conv[i], ssd[i]) = apply_mamba_block(layer, h, cfg,
                                                 return_state=True)
    return h


def _prefill_hybrid(params, h, cfg: ModelConfig, cache, max_len: int):
    groups, per, trailing = hybrid_layout(cfg)
    emb0 = h
    for gi, (layers, lora) in enumerate(zip(
            _unstack(params["layers"], groups),
            _unstack(params["loras"], groups))):
        h = _prefill_mamba(layers, h, cfg, cache["conv"][gi],
                           cache["ssd"][gi])
        h, (k, v) = apply_shared_block(params["shared"], lora, h, emb0, cfg,
                                       return_kv=True)
        cache["k"][gi] = _pad_cache_seq(k, max_len)
        cache["v"][gi] = _pad_cache_seq(v, max_len)
    if trailing:
        h = _prefill_mamba(params["tail"], h, cfg, cache["tail_conv"],
                           cache["tail_ssd"])
    return h


# ----------------------------------------------------------------- decode --


def forward_decode(params, cache, tokens, cfg: ModelConfig):
    """One-token decode. tokens: (B, 1) -> (logits (B, 1, V) float32,
    cache). The cache's tensors are updated in place and its ``len``
    replaced by len + 1; the same dict is returned."""
    h = embed_tokens(params, tokens, cfg).to(cfg.cdtype())
    length = cache["len"]
    if cfg.family == "ssm":
        h = _decode_mamba(params["layers"], h, cfg, cache["conv"],
                          cache["ssd"])
    elif cfg.family == "hybrid":
        h = _decode_hybrid(params, h, cfg, cache)
    else:
        h = _decode_transformer(params, h, cfg, cache)
    cache["len"] = length + 1
    return logits_from_hidden(params, h, cfg), cache


def _decode_mamba(layers, h, cfg: ModelConfig, conv, ssd):
    """One token through mamba blocks stacked on conv's leading axis, each
    block's (conv, ssd) slot updated in place."""
    for i, layer in enumerate(_unstack(layers, conv.shape[0])):
        x = apply_norm(layer["norm"], h, cfg)
        y, (nconv, nssd) = mamba_decode(layer["mamba"], x, conv[i], ssd[i],
                                        cfg)
        conv[i].copy_(nconv)
        ssd[i].copy_(nssd)
        h = h + y
    return h


def _decode_hybrid(params, h, cfg: ModelConfig, cache):
    groups, per, trailing = hybrid_layout(cfg)
    shared, emb0 = params["shared"], h
    for gi, (layers, lora) in enumerate(zip(
            _unstack(params["layers"], groups),
            _unstack(params["loras"], groups))):
        h = _decode_mamba(layers, h, cfg, cache["conv"][gi],
                          cache["ssd"][gi])
        u = torch.cat([h, emb0], dim=-1) @ shared["in_proj"]
        a = apply_attention_decode(
            lora_attention_params(shared, lora, cfg),
            apply_norm(shared["norm"], u, cfg), cache["k"][gi],
            cache["v"][gi], cache["len"], cfg, window=cfg.sliding_window)
        h = h + a
        h = h + apply_mlp(shared["mlp"],
                          apply_norm(shared["mlp_norm"], h, cfg), cfg)
    if trailing:
        h = _decode_mamba(params["tail"], h, cfg, cache["tail_conv"],
                          cache["tail_ssd"])
    return h


def _decode_transformer(params, h, cfg: ModelConfig, cache):
    """Each block: self-attention decode (a flash-decode launch), then for
    the encoder-decoder cross-attention over the cached encoder K/V at its
    full length (a second launch), then the FFN."""
    length = cache["len"]
    layers = _unstack(params["layers"], cfg.n_layers)
    cross = cfg.family == "encdec"
    if cross:
        enc_len = torch.full_like(length, cache["cross_k"].shape[2])
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
        if cross:
            h = h + apply_cross_attention_decode(
                layer["cross_attn"], apply_norm(layer["cross_norm"], h, cfg),
                cache["cross_k"][i], cache["cross_v"][i], enc_len)
        m, _ = apply_ffn(layer, apply_norm(layer["mlp_norm"], h, cfg), cfg)
        if cfg.post_norm:
            m = apply_norm(layer["mlp_post_norm"], m, cfg)
        h = h + m
    return h
