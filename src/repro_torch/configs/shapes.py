"""The assigned input-shape sets and their input trees without storage.

The torch counterpart of ``repro.configs.shapes``. Four shapes per LM arch
(train_4k / prefill_32k / decode_32k / long_500k); ``decode_*``/``long_*``
run the decode step (one token against a cache of seq_len), not the train
step. ``long_500k`` requires sub-quadratic attention: it runs for the ssm
and hybrid families and is skipped (with the reason) for full-attention
archs. Where the JAX package returns ``ShapeDtypeStruct`` trees,
``input_specs`` and ``cache_specs_avals`` return ``meta`` tensors of the
same shapes and dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import init_cache

__all__ = ["ShapeSpec", "SHAPES", "shape_supported", "batch_logical_names",
           "input_specs", "cache_specs_avals"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def shape_supported(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return (
            False,
            "long_500k needs sub-quadratic attention; "
            f"{cfg.name} is full-attention (family={cfg.family})",
        )
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _token_batch(cfg: ModelConfig, B: int, S: int, *, train: bool):
    i32 = torch.int32
    batch = {"tokens": _meta((B, S), i32)}
    if train:
        batch["targets"] = _meta((B, S), i32)
        batch["mask"] = _meta((B, S), torch.float32)
    if cfg.family == "encdec":
        # audio frontend stub: precomputed frame embeddings, 4x compressed
        batch["src_embeds"] = _meta((B, max(S // 4, 8), cfg.d_model),
                                    cfg.cdtype())
    if cfg.frontend == "vision":
        P = min(cfg.n_vision_patches, S)
        batch["vision_embeds"] = _meta((B, P, cfg.d_model), cfg.cdtype())
        batch["positions"] = _meta((3, B, S), i32)
    return batch


def batch_logical_names(cfg: ModelConfig, *, train: bool):
    names = {"tokens": ("batch", "seq")}
    if train:
        names["targets"] = ("batch", "seq")
        names["mask"] = ("batch", "seq")
    if cfg.family == "encdec":
        names["src_embeds"] = ("batch", "frames", "act_embed")
    if cfg.frontend == "vision":
        names["vision_embeds"] = ("batch", None, "act_embed")
        names["positions"] = (None, "batch", "seq")
    return names


def cache_specs_avals(cfg: ModelConfig, batch: int, max_len: int,
                      enc_len: int = 0):
    """The decode cache as meta tensors (no allocation)."""
    return init_cache(cfg, batch, max_len, enc_len, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec):
    """The step kind's argument trees (after the params) as meta tensors:
    (batch,) for train and prefill, (cache, tokens) for decode."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return (_token_batch(cfg, B, S, train=True),)
    if shape.kind == "prefill":
        return (_token_batch(cfg, B, S, train=False),)
    if shape.kind == "decode":
        enc_len = max(S // 4, 8) if cfg.family == "encdec" else 0
        cache = cache_specs_avals(cfg, B, S, enc_len)
        return (cache, _meta((B, 1), torch.int32))
    raise ValueError(shape.kind)
