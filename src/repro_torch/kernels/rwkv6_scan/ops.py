"""Public RWKV6 ops: the port of ``repro/kernels/rwkv6_scan/ops.py``, for
both kernels.  :func:`rwkv6` runs the token recurrence (B6,
:func:`kernel.rwkv6_scan`) and :func:`rwkv6_chunked` the chunk algebra
(B7, :func:`kernel_chunked.rwkv6_chunked`): each kernel on CUDA tensors,
its plain version on CPU tensors (the tensors' device takes the place of
the reference's ``interpret`` flag).  Backward is autograd through the
kernel's plain version, as the reference's is ``jax.vjp`` of its
reference.  Both take an optional initial state and return the final one
when asked, as a model's prefill and decode need."""

from __future__ import annotations

import torch

from .kernel import rwkv6_scan
from .kernel_chunked import rwkv6_chunked as rwkv6_chunked_kernel
from .ref import reference_rwkv6, reference_rwkv6_chunked


class _RWKV6(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, plain, chunk, return_state, r, k, v, w, u,
                state):
        ctx.plain, ctx.chunk, ctx.return_state = plain, chunk, return_state
        ctx.save_for_backward(r, k, v, w, u, state)
        return kernel(r, k, v, w, u, chunk=chunk, state=state,
                      return_state=return_state)

    @staticmethod
    def backward(ctx, *grads):
        ins = [None if t is None else t.detach().requires_grad_()
               for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = ctx.plain(*ins[:5], chunk=ctx.chunk, state=ins[5],
                             return_state=ctx.return_state)
        outs = outs if ctx.return_state else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        wrt = [t for t in ins if t is not None]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                       [g for _, g in pairs],
                                       allow_unused=True))
        return (None, None, None, None,
                *(None if t is None else next(got) for t in ins))


def _plain_scan(r, k, v, w, u, *, chunk, state, return_state):
    return reference_rwkv6(r, k, v, w, u, state=state,
                           return_state=return_state)


def rwkv6(r, k, v, w, u, chunk: int = 64, *, state=None,
          return_state: bool = False, out_state=None):
    """:func:`kernel.rwkv6_scan` (kernel B6), differentiable in every
    input.  With ``out_state`` (serving) the final state is written into
    that tensor, which may be ``state`` itself, and returned; that form
    writes in place and is not differentiable."""
    if out_state is not None:
        if torch.is_grad_enabled() and any(
                z is not None and z.requires_grad
                for z in (r, k, v, w, u, state)):
            raise ValueError("rwkv6: out_state writes in place and takes "
                             "no gradient")
        return rwkv6_scan(r, k, v, w, u, chunk=chunk, state=state,
                          out_state=out_state)
    return _RWKV6.apply(rwkv6_scan, _plain_scan, chunk, return_state, r, k,
                        v, w, u, state)


def rwkv6_chunked(r, k, v, w, u, chunk: int = 32, *, state=None,
                  return_state: bool = False):
    """:func:`kernel_chunked.rwkv6_chunked` (kernel B7), differentiable in
    every input."""
    return _RWKV6.apply(rwkv6_chunked_kernel, reference_rwkv6_chunked, chunk,
                        return_state, r, k, v, w, u, state)
