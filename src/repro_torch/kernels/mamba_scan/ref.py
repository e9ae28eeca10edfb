"""Plain PyTorch version of the selective SSM scan (kernel B5): the port's
copy of ``repro/kernels/mamba_scan/ref.py``, a Python loop over the tokens.
(The reference's per-chunk rematerialization only changes what its
backward pass saves, not the forward values.)"""

from __future__ import annotations

import torch


def reference_mamba(x, dt, b, c, a, d, state=None, return_state=False):
    """x, dt: ``(B, T, d_inner)``; b, c: ``(B, T, d_state)``; a: ``(d_inner,
    d_state)``; d: ``(d_inner,)`` -> y: ``(B, T, d_inner)`` in ``x.dtype``.
    ``state``: optional initial SSM state ``(B, d_inner, d_state)``; with
    ``return_state`` the final state comes back too."""
    bsz, t, d_inner = x.shape
    d_state = b.shape[-1]
    xf, dtf, bf, cf = (z.to(torch.float32) for z in (x, dt, b, c))
    af, df = a.to(torch.float32), d.to(torch.float32)
    h = (state.to(torch.float32) if state is not None else
         torch.zeros((bsz, d_inner, d_state), dtype=torch.float32,
                     device=x.device))
    ys = []
    for i in range(t):
        da = torch.exp(dtf[:, i, :, None] * af[None])
        h = da * h + (dtf[:, i] * xf[:, i])[:, :, None] * bf[:, i, None, :]
        ys.append(torch.einsum("bis,bs->bi", h, cf[:, i]) + df[None] * xf[:, i])
    y = (torch.stack(ys, dim=1) if ys else
         torch.zeros((bsz, 0, d_inner), device=x.device)).to(x.dtype)
    return (y, h) if return_state else y
