"""GQA attention: reference, chunked prefill path, decode.

The torch counterpart of ``repro.models.attention``. Three execution paths,
one semantics:
  * ``attention_reference`` — full (B, Hkv, G, Sq, Skv) scores; tests and
    ragged shapes.
  * ``attention_chunked`` — online softmax over KV chunks, one Q chunk at a
    time; never materialises the whole score matrix. The prefill path: it
    runs outside any kernel in the JAX package too (an XLA scan), so here it
    is plain PyTorch matmuls, in fp32, with the same masks and softcap.
  * ``kernels.ops.decode_attention`` — single-token flash-decode (the
    hand-written CUDA kernel on the card), used by the decode step.

Variants: GQA grouping (K/V are never repeated into H heads), logit softcap
(gemma2), sliding window (gemma2 local layers), per-head qk RMSNorm (qwen3),
partial RoPE. Weights keep the JAX layout: ``wq`` (d, H, Dh), ``wo``
(H, Dh, d). Sharding constraints of the JAX package are the identity on one
device and have no counterpart; M-RoPE (qwen2-vl) and cross-attention
(encdec) wait for their families.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.ops import decode_attention

from .config import ModelConfig
from .layers import apply_rope, normal

__all__ = ["init_attention", "attention_reference", "attention_chunked",
           "layer_window", "apply_attention", "quantize_kv_rows",
           "apply_attention_decode", "NEG_INF"]

NEG_INF = -1.0e30


# ------------------------------------------------------------------ params --


def init_attention(gen, cfg: ModelConfig, *, device, lead=()):
    dt = cfg.pdtype()
    d = cfg.d_model
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s, so = 1.0 / np.sqrt(d), 1.0 / np.sqrt(H * Dh)
    p = {
        "wq": normal(gen, (*lead, d, H, Dh), s, dt, device),
        "wk": normal(gen, (*lead, d, Hkv, Dh), s, dt, device),
        "wv": normal(gen, (*lead, d, Hkv, Dh), s, dt, device),
        "wo": normal(gen, (*lead, H, Dh, d), so, dt, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((*lead, Dh), device=device)
        p["k_norm"] = torch.ones((*lead, Dh), device=device)
    return p


def _qk_norm(x, scale, eps=1e-6):
    xf = x.float()
    rms = torch.sqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (xf / rms * scale).to(x.dtype)


def _project(x, w):
    """``einsum("bsd,dhe->bshe", x, w)`` as one matmul."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


# ------------------------------------------------------------------- cores --


def _mask(pos_q, pos_k, *, causal: bool, window: int):
    """(Sq, Sk) boolean mask from absolute positions; window <= 0 disables
    the sliding window."""
    pq = pos_q[..., :, None]
    pk = pos_k[..., None, :]
    m = torch.ones(pq.shape[:-1] + pk.shape[-1:], dtype=torch.bool,
                   device=pos_q.device)
    if causal:
        m = m & (pk <= pq)
    if window > 0:
        m = m & (pq - pk < window)
    return m


def attention_reference(q, k, v, *, causal: bool, window: int = 0,
                        softcap: float = 0.0):
    """q: (B, Sq, H, Dh); k, v: (B, Sk, Hkv, Dh) -> (B, Sq, H, Dh)."""
    B, Sq, H, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, Dh).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    s = s / float(np.sqrt(Dh))
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    m = _mask(torch.arange(Sq, device=q.device),
              torch.arange(Sk, device=q.device), causal=causal, window=window)
    s = s.masked_fill(~m, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def attention_chunked(q, k, v, *, causal: bool, window: int = 0,
                      softcap: float = 0.0, chunk_q: int = 512,
                      chunk_kv: int = 1024):
    """Online-softmax attention; same contract as attention_reference.
    KV chunks with no visible pair for a Q chunk are skipped; shapes that
    the chunks do not divide go to ``attention_reference``."""
    B, Sq, H, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    cq, ckv = min(chunk_q, Sq), min(chunk_kv, Sk)
    if Sq % cq or Sk % ckv:
        return attention_reference(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    scale = float(1.0 / np.sqrt(Dh))
    dev = q.device
    qg = q.reshape(B, Sq, Hkv, G, Dh)
    outs = []
    for q0 in range(0, Sq, cq):
        qc = qg[:, q0:q0 + cq].float()
        m_run = torch.full((B, Hkv, G, cq), NEG_INF, device=dev)
        l_run = torch.zeros((B, Hkv, G, cq), device=dev)
        acc = torch.zeros((B, Hkv, G, cq, Dh), device=dev)
        pos_q = q0 + torch.arange(cq, device=dev)
        for k0 in range(0, Sk, ckv):
            if causal and k0 > q0 + cq - 1:
                continue  # every key is after every query
            if window > 0 and k0 + ckv - 1 <= q0 - window:
                continue  # every key is outside every query's window
            kb = k[:, k0:k0 + ckv].float()
            vb = v[:, k0:k0 + ckv].float()
            s = torch.einsum("bqhgd,bkhd->bhgqk", qc, kb) * scale
            if softcap > 0:
                s = softcap * torch.tanh(s / softcap)
            msk = _mask(pos_q, k0 + torch.arange(ckv, device=dev),
                        causal=causal, window=window)
            s = s.masked_fill(~msk, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(-1))
            alpha = torch.exp(m_run - m_new)
            p = torch.exp(s - m_new[..., None]).masked_fill(~msk, 0.0)
            l_run = alpha * l_run + p.sum(-1)
            acc = alpha[..., None] * acc + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vb)
            m_run = m_new
        out = acc / l_run.clamp_min(1e-30)[..., None]  # (B, Hkv, G, cq, Dh)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, cq, H, Dh)
                    .to(q.dtype))
    return torch.cat(outs, dim=1)


# ------------------------------------------------------------ full module --


def layer_window(cfg: ModelConfig, layer_local: bool) -> int:
    """The sliding window of a layer (0: full attention); gemma2's local
    layers have one, its global ones none."""
    if cfg.local_global_pattern:
        return cfg.sliding_window if layer_local else 0
    return cfg.sliding_window


def apply_attention(params, x, cfg: ModelConfig, *, layer_local: bool = False,
                    return_kv: bool = False):
    """Causal self-attention sublayer, prefill, through
    ``attention_chunked``. return_kv=True also returns the post-rope
    (k, v): the serving cache entries of this layer."""
    B, S, _ = x.shape
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if cfg.qk_norm and "q_norm" in params:
        q = _qk_norm(q, params["q_norm"])
        k = _qk_norm(k, params["k_norm"])
    pos = torch.arange(S, device=x.device).expand(B, S)
    q = apply_rope(q, pos, cfg)
    k = apply_rope(k, pos, cfg)
    out = attention_chunked(q, k, v, causal=True,
                            window=layer_window(cfg, layer_local),
                            softcap=cfg.attn_softcap,
                            chunk_q=cfg.attn_chunk_q,
                            chunk_kv=cfg.attn_chunk_kv)
    y = out.flatten(-2) @ params["wo"].flatten(0, 1)
    if return_kv:
        return y, (k, v)
    return y


def quantize_kv_rows(x):
    """Symmetric int8 quantisation over the last axis: x (..., Dh) ->
    (int8 rows, (...) float32 scales)."""
    xf = x.float()
    scale = xf.abs().amax(-1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _append(cache, rows, pos, keep, new):
    """``cache[rows, pos] = new`` for the rows where ``keep``; the others
    keep what they hold. A row whose length has reached S keeps decoding
    in the JAX launcher, and there the out-of-range write is dropped; an
    index past S would be an error here, so it is clamped and masked."""
    old = cache[rows, pos]
    cache[rows, pos] = torch.where(keep, new.to(cache.dtype), old)


def apply_attention_decode(params, x, cache_k, cache_v, cache_len,
                           cfg: ModelConfig, *, window: int = 0,
                           scales=None):
    """Single-token decode. x: (B, 1, d); cache: (B, S, Hkv, Dh) views that
    are updated in place (the token's k, v written at cache_len; rows with
    cache_len >= S keep their cache, as the JAX package drops those
    writes). With cfg.kv_quant the cache is int8 and ``scales`` is the
    ((B, S, Hkv), (B, S, Hkv)) float32 scale pair, updated in place too.
    Returns (B, 1, d)."""
    B = x.shape[0]
    S = cache_k.shape[1]
    q = _project(x, params["wq"])[:, 0]  # (B, H, Dh)
    k = _project(x, params["wk"])[:, 0]
    v = _project(x, params["wv"])[:, 0]
    if cfg.qk_norm and "q_norm" in params:
        q = _qk_norm(q, params["q_norm"])
        k = _qk_norm(k, params["k_norm"])
    q = apply_rope(q[:, None], cache_len[:, None], cfg)[:, 0]
    k = apply_rope(k[:, None], cache_len[:, None], cfg)[:, 0]

    rows = torch.arange(B, device=x.device)
    at = cache_len.clamp_max(S - 1).long()
    keep = (cache_len < S)[:, None, None]
    k_scale = v_scale = None
    if cfg.kv_quant:
        k_scale, v_scale = scales
        kq, ks = quantize_kv_rows(k)
        vq, vs = quantize_kv_rows(v)
        _append(cache_k, rows, at, keep, kq)
        _append(cache_v, rows, at, keep, vq)
        _append(k_scale, rows, at, keep[..., 0], ks)
        _append(v_scale, rows, at, keep[..., 0], vs)
    else:
        _append(cache_k, rows, at, keep, k)
        _append(cache_v, rows, at, keep, v)

    out = decode_attention(
        q, cache_k, cache_v, cache_len + 1, softcap=cfg.attn_softcap,
        window=window, k_scale=k_scale, v_scale=v_scale,
    )  # (B, H, Dh)
    return (out.flatten(-2) @ params["wo"].flatten(0, 1))[:, None]
