"""Public Mamba scan op: the port of ``repro/kernels/mamba_scan/ops.py``.
Forward is :func:`kernel.mamba_scan` (the kernel on CUDA tensors, the plain
version on CPU tensors: the tensors' device takes the place of the
reference's ``interpret`` flag); backward is autograd through the plain
version, as the reference's is ``jax.vjp`` of its reference."""

from __future__ import annotations

import torch

from .kernel import mamba_scan
from .ref import reference_mamba


class _Mamba(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, b, c, a, d, chunk):
        ctx.save_for_backward(x, dt, b, c, a, d)
        return mamba_scan(x, dt, b, c, a, d, chunk=chunk)

    @staticmethod
    def backward(ctx, g):
        ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = reference_mamba(*ins)
        return (*torch.autograd.grad(y, ins, g), None)


def mamba(x, dt, b, c, a, d, chunk: int = 64):
    """:func:`kernel.mamba_scan`, differentiable in every input."""
    return _Mamba.apply(x, dt, b, c, a, d, chunk)
