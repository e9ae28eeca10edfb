"""Plain PyTorch version of the RWKV6 recurrence (kernel B6): the port's
copy of ``repro/kernels/rwkv6_scan/ref.py``, a Python loop over the
tokens.  (The reference's per-chunk rematerialization only changes what its
backward pass saves, not the forward values.)"""

from __future__ import annotations

import torch


def reference_rwkv6(r, k, v, w, u, state=None, return_state=False):
    """r, k, v, w: ``(BH, T, N)``; u: ``(N,)`` -> o: ``(BH, T, N)`` in
    ``r.dtype``.  ``state``: optional initial ``(BH, N, N)`` wkv state;
    with ``return_state`` the final state comes back too."""
    bh, t, n = r.shape
    rf, kf, vf, wf = (z.to(torch.float32) for z in (r, k, v, w))
    uf = u.to(torch.float32)
    s = (state.to(torch.float32) if state is not None else
         torch.zeros((bh, n, n), dtype=torch.float32, device=r.device))
    outs = []
    for i in range(t):
        kv = kf[:, i, :, None] * vf[:, i, None, :]
        wkv = s + uf[None, :, None] * kv
        outs.append(torch.einsum("bi,bij->bj", rf[:, i], wkv))
        s = wf[:, i, :, None] * s + kv
    o = (torch.stack(outs, dim=1) if outs else
         torch.zeros((bh, 0, n), device=r.device)).to(r.dtype)
    return (o, s) if return_state else o
