"""Public fused add+RMSNorm op: the port of ``repro/kernels/rmsnorm/
ops.py``.  Forward is :func:`kernel.fused_add_rmsnorm` (the kernel on CUDA
tensors, the plain version on CPU tensors: the tensors' device takes the
place of the reference's ``interpret`` flag); backward is autograd through
the plain version, as the reference's is ``jax.vjp`` of its reference."""

from __future__ import annotations

import torch

from .kernel import fused_add_rmsnorm
from .ref import reference_add_rmsnorm


class _AddRMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, residual, gamma, eps, plus_one):
        ctx.save_for_backward(x, residual, gamma)
        ctx.opts = dict(eps=eps, plus_one=plus_one)
        return fused_add_rmsnorm(x, residual, gamma, **ctx.opts)

    @staticmethod
    def backward(ctx, gy, gh):
        ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = reference_add_rmsnorm(*ins, **ctx.opts)
        return (*torch.autograd.grad(outs, ins, (gy, gh)), None, None)


def add_rmsnorm(x, residual, gamma, eps: float = 1e-6, plus_one: bool = False):
    """``(y, h)`` of :func:`kernel.fused_add_rmsnorm`, differentiable in
    ``x``, ``residual`` and ``gamma``."""
    return _AddRMSNorm.apply(x, residual, gamma, eps, plus_one)
