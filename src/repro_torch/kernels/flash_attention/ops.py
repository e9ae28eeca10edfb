"""Public attention op: the port of ``repro/kernels/flash_attention/
ops.py``.  Forward is :func:`kernel.flash_attention` (the kernel on CUDA
tensors, the plain version on CPU tensors: the tensors' device takes the
place of the reference's ``interpret`` flag); backward is autograd through
the plain version, as the reference's is ``jax.vjp`` of its reference."""

from __future__ import annotations

from typing import Optional

import torch

from ...core.obs import trace
from .kernel import flash_attention
from .ref import reference_attention


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        scale=scale)
        return flash_attention(q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, g):
        # a span (a profiler range while a tracer is installed), so a
        # trace can tell this plain float32 recompute from the model's own
        # GEMMs and elementwise kernels
        with trace.span("flash_attention.backward"):
            ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            with torch.enable_grad():
                out = reference_attention(*ins, **ctx.opts)
            grads = torch.autograd.grad(out, ins, g)
        return (*grads, None, None, None, None)


def attention(q, k, v, causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None, scale: Optional[float] = None):
    """:func:`kernel.flash_attention`, differentiable in q, k and v."""
    return _Attention.apply(q, k, v, causal, window, softcap, scale)
