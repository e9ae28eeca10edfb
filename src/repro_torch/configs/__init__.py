"""Model configurations, one module per architecture, and their registry:
the reference's ``repro/configs`` for the architectures ported so far,
``qwen15_4b`` (the LM lane and the direct model) and ``rwkv6_3b`` (the
direct model's RWKV6 layers).  The reference's shape grid
(``cell_enabled``, ``input_specs``) comes with the outer layers."""

from __future__ import annotations

from ..models.config import ModelConfig
from . import qwen15_4b, rwkv6_3b

_REGISTRY = {
    "rwkv6-3b": rwkv6_3b,
    "qwen1.5-4b": qwen15_4b,
}

ARCHS = tuple(_REGISTRY)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    try:
        mod = _REGISTRY[arch]
    except KeyError:
        raise ValueError(f"unknown arch {arch!r}; have {sorted(_REGISTRY)}")
    return mod.SMOKE if smoke else mod.CONFIG
