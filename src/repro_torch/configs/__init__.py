"""Model configurations, one module per architecture, their registry and
the assigned input-shape grid: the port's copy of ``repro/configs``.

``get_config(arch)``, ``SHAPES``, ``cell_enabled(arch, shape)`` (the
reference's skip table) and ``input_specs(cfg, shape)``, whose stand-ins
for the model inputs are tensors on the ``meta`` device: shapes and dtypes
with no memory behind them, as the reference's ``jax.ShapeDtypeStruct``.
The direct model runs every one of them as published."""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..models.config import ModelConfig
from . import (gemma2_9b, jamba_v01_52b, llava_next_mistral_7b, olmoe_1b_7b,
               qwen15_4b, qwen3_4b, qwen3_moe_235b_a22b, rwkv6_3b,
               starcoder2_3b, whisper_tiny)

_REGISTRY = {
    "whisper-tiny": whisper_tiny,
    "rwkv6-3b": rwkv6_3b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b,
    "llava-next-mistral-7b": llava_next_mistral_7b,
    "qwen1.5-4b": qwen15_4b,
    "starcoder2-3b": starcoder2_3b,
    "gemma2-9b": gemma2_9b,
    "qwen3-4b": qwen3_4b,
    "jamba-v0.1-52b": jamba_v01_52b,
}

ARCHS = tuple(_REGISTRY)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    try:
        mod = _REGISTRY[arch]
    except KeyError:
        raise ValueError(f"unknown arch {arch!r}; have {sorted(_REGISTRY)}")
    return mod.SMOKE if smoke else mod.CONFIG


def cell_enabled(arch: str, shape: str) -> Tuple[bool, str]:
    """The skip table.  Returns (enabled, reason-if-skipped)."""
    cfg = get_config(arch)
    if shape == "long_500k" and not cfg.subquadratic:
        return False, ("full-attention arch: 500k decode KV cache has no "
                       "sub-quadratic path (DESIGN.md §5)")
    return True, ""


def input_specs(cfg: ModelConfig,
                shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """``meta`` tensors standing in for every model input of the entry
    point this shape runs (a training step, a prefill or a decode step);
    the decode entry's cache is ``init_cache`` on ``meta``."""
    b, s = shape.global_batch, shape.seq_len
    cd = cfg.compute_dtype

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    extras: Dict[str, torch.Tensor] = {}
    if cfg.family == "encdec":
        extras["frames"] = meta((b, cfg.encoder_seq, cfg.d_model), cd)
    if cfg.family == "vlm":
        extras["patch_embeds"] = meta((b, cfg.n_patches, cfg.d_model), cd)
    toks = s - (cfg.n_patches if cfg.family == "vlm" else 0)
    if shape.kind == "train":
        return {"tokens": meta((b, toks), torch.int32),
                "labels": meta((b, toks), torch.int32), **extras}
    if shape.kind == "prefill":
        return {"tokens": meta((b, toks), torch.int32), **extras}
    # decode: one token with a seq_len-deep cache
    from ..models.transformer import init_cache
    out = {"token": meta((b, 1), torch.int32),
           "cache": init_cache(cfg, b, s, dtype=cd, device="meta")}
    if cfg.family == "encdec":
        out["enc_out"] = meta((b, cfg.encoder_seq, cfg.d_model), cd)
    return out
