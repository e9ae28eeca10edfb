"""Public RWKV6 scan op: the port of ``repro/kernels/rwkv6_scan/ops.py``.
Forward is :func:`kernel.rwkv6_scan` (the kernel on CUDA tensors, the plain
version on CPU tensors: the tensors' device takes the place of the
reference's ``interpret`` flag); backward is autograd through the plain
version, as the reference's is ``jax.vjp`` of its reference."""

from __future__ import annotations

import torch

from .kernel import rwkv6_scan
from .ref import reference_rwkv6


class _RWKV6(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u, chunk):
        ctx.save_for_backward(r, k, v, w, u)
        return rwkv6_scan(r, k, v, w, u, chunk=chunk)

    @staticmethod
    def backward(ctx, g):
        ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            o = reference_rwkv6(*ins)
        return (*torch.autograd.grad(o, ins, g), None)


def rwkv6(r, k, v, w, u, chunk: int = 64):
    """:func:`kernel.rwkv6_scan`, differentiable in every input."""
    return _RWKV6.apply(r, k, v, w, u, chunk)
