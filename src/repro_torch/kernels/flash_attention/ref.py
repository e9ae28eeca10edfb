"""Plain PyTorch version of flash attention (kernel B3), a naive
materialized softmax: the port's copy of ``repro/kernels/flash_attention/
ref.py``."""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def reference_attention(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q: ``(B, Hq, Sq, D)``; k/v: ``(B, Hkv, Sk, D)``.  float32 softmax;
    query head ``h`` reads kv head ``h // (Hq // Hkv)``."""
    _, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    group = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    k = torch.repeat_interleave(k, group, dim=1)
    v = torch.repeat_interleave(v, group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.clamp_min(torch.sum(p, dim=-1, keepdim=True), 1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        v.to(torch.float32)).to(q.dtype)
