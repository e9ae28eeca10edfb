"""Unified model configuration: the port's copy of ``repro/models/config.py``.

One dataclass, family-specific behaviour via fields.  ``layer_pattern()``
gives the per-layer kind sequence and ``scan_groups()`` its smallest
repeating unit, which is how parameters are stacked (one leading "layers"
axis per unit position).  Plain data: the only difference from the
reference is that :attr:`ModelConfig.compute_dtype` is a ``torch.dtype``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden dim
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    load_balance_coef: float = 1e-2
    n_shared_experts: int = 0


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2               # d_inner = expand * d_model
    dt_rank: Optional[int] = None  # default ceil(d_model/16)


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    # attention features
    qkv_bias: bool = False                  # qwen1.5
    qk_norm: bool = False                   # qwen3
    attn_softcap: Optional[float] = None    # gemma2 (50.0)
    final_softcap: Optional[float] = None   # gemma2 (30.0)
    sliding_window: Optional[int] = None    # gemma2 local layers (4096)
    local_global_period: Optional[int] = None  # gemma2: 2 → alternate L,G
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    act: str = "silu"                       # silu (swiglu) | gelu (geglu/mlp)
    norm_plus_one: bool = False             # gemma-style (1+g) scale
    # MoE / SSM / hybrid
    moe: Optional[MoEConfig] = None
    moe_period: int = 1                     # apply MoE every k-th layer
    mamba: Optional[MambaConfig] = None
    attn_period: Optional[int] = None       # jamba: attention every k layers
    attn_offset: int = 0                    # jamba: first attn layer index
    rwkv: Optional[RWKVConfig] = None
    # encoder-decoder (whisper)
    n_encoder_layers: int = 0
    encoder_seq: int = 0                    # frames after conv stub (1500)
    # vlm (llava)
    n_patches: int = 0                      # patch embeddings per image
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    opt_state_dtype: str = "int8"   # int8 | bf16 | f32 Adam moments
    num_microbatches: Optional[int] = None   # None = memory-aware heuristic
    remat: bool = True
    # long-context capability (for the long_500k shape gate)
    subquadratic: bool = False

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def layer_pattern(self) -> List[Tuple[str, str]]:
        """[(mixer, ffn)] per layer.  mixer ∈ {attn, attn_local, mamba,
        rwkv}; ffn ∈ {mlp, moe}."""
        out = []
        for l in range(self.n_layers):
            if self.rwkv is not None:
                mixer = "rwkv"
            elif self.mamba is not None and self.attn_period:
                mixer = ("attn" if l % self.attn_period == self.attn_offset
                         else "mamba")
            elif self.local_global_period:
                mixer = ("attn_local" if l % self.local_global_period == 0
                         else "attn")
            else:
                mixer = "attn"
            if self.moe is not None and (l % self.moe_period ==
                                         (self.moe_period - 1)):
                ffn = "moe"
            else:
                ffn = "mlp"
            out.append((mixer, ffn))
        return out

    def scan_groups(self) -> Tuple[List[Tuple[str, str]], int]:
        """Smallest repeating unit of the layer pattern and its repeat
        count — the scan body is the unit, the scan length the count."""
        pat = self.layer_pattern()
        n = len(pat)
        for unit_len in range(1, n + 1):
            if n % unit_len == 0 and pat == pat[:unit_len] * (n // unit_len):
                return pat[:unit_len], n // unit_len
        return pat, 1

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + layers)."""
        d, hd = self.d_model, self.hd
        per_attn = d * (self.n_heads * hd) * 2 \
            + d * (self.n_kv_heads * hd) * 2
        per_mlp = 3 * d * self.d_ff if self.act == "silu" else 2 * d * self.d_ff
        total = 0
        for mixer, ffn in self.layer_pattern():
            if mixer in ("attn", "attn_local"):
                total += per_attn
            elif mixer == "mamba":
                m = self.mamba
                d_in = m.expand * d
                dtr = m.dt_rank or -(-d // 16)
                total += d * d_in * 2 + d_in * m.d_conv \
                    + d_in * (dtr + 2 * m.d_state) + dtr * d_in \
                    + d_in * m.d_state + d_in + d_in * d
            elif mixer == "rwkv":
                total += 6 * d * d + 2 * d   # r,k,v,w,g,o (+ mixing vectors)
            if ffn == "moe":
                total += self.moe.n_experts * 3 * d * self.moe.d_expert
            else:
                total += per_mlp
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total += self.n_encoder_layers * (per_attn * 2 + per_mlp + 0)
        return total

    def active_params(self) -> int:
        """Activated parameters per token (MoE: top_k of n_experts)."""
        if self.moe is None:
            return self.n_params()
        full = self.n_params()
        moe_layers = sum(1 for _, f in self.layer_pattern() if f == "moe")
        all_exp = moe_layers * self.moe.n_experts * 3 * self.d_model * self.moe.d_expert
        act_exp = moe_layers * self.moe.top_k * 3 * self.d_model * self.moe.d_expert
        return full - all_exp + act_exp

    def scaled(self, **kw) -> "ModelConfig":
        """Reduced copy for smoke tests."""
        return dataclasses.replace(self, **kw)
