"""Plain PyTorch version of fused add+RMSNorm (kernel B4): the port's copy
of ``repro/kernels/rmsnorm/ref.py``.  Computed in float32; returns
``(y, h)`` in ``x.dtype``."""

from __future__ import annotations

import torch


def reference_add_rmsnorm(x, residual, gamma, *, eps: float = 1e-6,
                          plus_one: bool = False):
    """``h = x + residual``; ``y = h * rsqrt(mean(h**2) + eps) * g`` with
    ``g = gamma`` (or ``1 + gamma`` when ``plus_one``)."""
    h = x.to(torch.float32) + residual.to(torch.float32)
    var = torch.mean(h * h, dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    g = gamma.to(torch.float32)
    if plus_one:
        g = g + 1.0
    return (h * inv * g).to(x.dtype), h.to(x.dtype)
