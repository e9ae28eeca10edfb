"""LR schedules: the port's copy of ``repro/optim/schedule.py``."""

from __future__ import annotations

import math

import torch


def cosine_warmup(step, *, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> torch.Tensor:
    """Linear warm-up from 0 (step 0 gives lr 0) to ``peak_lr`` over
    ``warmup`` steps, then a cosine decay to ``floor * peak_lr`` at step
    ``total``.  ``step`` is a tensor (the optimizer's int32 step, on its
    device) or an int; the result is a float32 0-d tensor on the step's
    device, computed in float32 in the reference's order.  The divisors
    are tensors: a CUDA divide by a host scalar multiplies by its
    reciprocal, which is not the correctly rounded quotient."""
    if isinstance(step, torch.Tensor):
        s = step.to(torch.float32)
    else:
        s = torch.tensor(float(step), dtype=torch.float32)

    def const(x):
        return torch.tensor(float(x), dtype=torch.float32, device=s.device)

    warm = peak_lr * torch.clamp(s / const(max(warmup, 1)), max=1.0)
    t = torch.clamp((s - warmup) / const(max(total - warmup, 1)), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5
                     * (1 + torch.cos(math.pi * t)))
    return torch.where(s < warmup, warm, cos)
