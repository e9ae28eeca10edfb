"""Public Mamba scan op: the port of ``repro/kernels/mamba_scan/ops.py``.
Forward is :func:`kernel.mamba_scan` (the kernel on CUDA tensors, the plain
version on CPU tensors: the tensors' device takes the place of the
reference's ``interpret`` flag); backward is the operator
:func:`kernel.backward_op`, the VJP of the plain version on CPU and CUDA
tensors alike, as the reference's is ``jax.vjp`` of its reference.  It
takes an optional initial state and returns the final one when asked, as
a model's prefill and decode need."""

from __future__ import annotations

import torch

from ...core.obs import trace
from .kernel import backward_op, mamba_scan


class _Mamba(torch.autograd.Function):
    @staticmethod
    def forward(ctx, chunk, return_state, x, dt, b, c, a, d, state):
        ctx.return_state = return_state
        ctx.save_for_backward(x, dt, b, c, a, d, state)
        return mamba_scan(x, dt, b, c, a, d, chunk=chunk, state=state,
                          return_state=return_state)

    @staticmethod
    def backward(ctx, *grads):
        x, dt, b, c, a, d, state = ctx.saved_tensors
        gy, gh = grads if ctx.return_state else (grads[0], None)
        with trace.span("mamba_scan.backward"):
            *gs, gstate, _work = backward_op(x, dt, b, c, a, d, state,
                                             gy, gh)
        return (None, None, *gs, None if state is None else gstate)


def mamba(x, dt, b, c, a, d, chunk: int = 64, *, state=None,
          return_state: bool = False, out_state=None):
    """:func:`kernel.mamba_scan`, differentiable in every input (the
    initial state included).  With ``out_state`` (serving) the final state
    is written into that tensor, which may be ``state`` itself, and
    returned; that form writes in place and is not differentiable."""
    if out_state is not None:
        if torch.is_grad_enabled() and any(
                z is not None and z.requires_grad
                for z in (x, dt, b, c, a, d, state)):
            raise ValueError("mamba: out_state writes in place and takes "
                             "no gradient")
        return mamba_scan(x, dt, b, c, a, d, chunk=chunk, state=state,
                          out_state=out_state)
    return _Mamba.apply(chunk, return_state, x, dt, b, c, a, d, state)
