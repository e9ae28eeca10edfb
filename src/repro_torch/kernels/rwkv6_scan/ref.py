"""Plain PyTorch versions of the RWKV6 recurrence: the port's copy of
``repro/kernels/rwkv6_scan/ref.py`` (kernel B6's plain version, a Python
loop over the tokens) and the chunk algebra of
``repro/kernels/rwkv6_scan/kernel_chunked.py`` (kernel B7's).  (The
reference's per-chunk rematerialization only changes what its backward
pass saves, not the forward values.)"""

from __future__ import annotations

import torch


def row_bonus(u: torch.Tensor, bh: int) -> torch.Tensor:
    """The bonus of each of ``bh`` rows as a float32 ``(bh, N)``: ``u`` is
    ``(N,)``, one bonus for every row, or ``(H, N)``, row ``b·H + h``
    taking ``u[h]``."""
    u2 = u.to(torch.float32).reshape(-1, u.shape[-1])
    return u2[torch.arange(bh, device=u.device) % u2.shape[0]]


def reference_rwkv6(r, k, v, w, u, state=None, return_state=False):
    """r, k, v, w: ``(BH, T, N)``; u: ``(N,)`` or ``(H, N)`` (see
    :func:`row_bonus`) -> o: ``(BH, T, N)`` in ``r.dtype``.  ``state``:
    optional initial ``(BH, N, N)`` wkv state; with ``return_state`` the
    final state comes back too."""
    bh, t, n = r.shape
    rf, kf, vf, wf = (z.to(torch.float32) for z in (r, k, v, w))
    ur = row_bonus(u, bh)
    s = (state.to(torch.float32) if state is not None else
         torch.zeros((bh, n, n), dtype=torch.float32, device=r.device))
    outs = []
    for i in range(t):
        kv = kf[:, i, :, None] * vf[:, i, None, :]
        wkv = s + ur[:, :, None] * kv
        outs.append(torch.einsum("bi,bij->bj", rf[:, i], wkv))
        s = wf[:, i, :, None] * s + kv
    o = (torch.stack(outs, dim=1) if outs else
         torch.zeros((bh, 0, n), device=r.device)).to(r.dtype)
    return (o, s) if return_state else o


def reference_rwkv6_chunked(r, k, v, w, u, *, chunk: int = 32, state=None,
                            return_state=False):
    """The same function as :func:`reference_rwkv6`, computed as the TPU
    kernel ``rwkv6_chunked`` computes it: chunks of ``min(chunk, T)``
    tokens, a ragged last chunk padded with ``r = k = v = 0`` and ``w = 1``,
    and per chunk, with ``Cum`` the inclusive cumulative product of ``w``,
    ``r̃ = r·Cum_{t-1}`` and ``k̃ = k/Cum``: ``o = r̃S₀ + mask(r̃k̃ᵀ)v +
    ((r·u)·k)v`` and ``S ← Cum_C·(S₀ + k̃ᵀv)``, all in float32."""
    bh, t, n = r.shape
    c = max(1, min(chunk, t))
    n_chunks = -(-t // c)
    pad = n_chunks * c - t
    rf, kf, vf, wf = (z.to(torch.float32) for z in (r, k, v, w))
    if pad:
        zeros = torch.zeros((bh, pad, n), dtype=torch.float32,
                            device=r.device)
        rf, kf, vf = (torch.cat([z, zeros], dim=1) for z in (rf, kf, vf))
        wf = torch.cat([wf, zeros + 1.0], dim=1)
    ur = row_bonus(u, bh)[:, None, :]
    s = (state.to(torch.float32) if state is not None else
         torch.zeros((bh, n, n), dtype=torch.float32, device=r.device))
    strictly_causal = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                            device=r.device), diagonal=-1)
    outs = []
    for ci in range(n_chunks):
        sl = slice(ci * c, (ci + 1) * c)
        rc, kc, vc, wc = rf[:, sl], kf[:, sl], vf[:, sl], wf[:, sl]
        cum = torch.cumprod(wc, dim=1)
        cum_prev = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]],
                             dim=1)
        r_t, k_t = rc * cum_prev, kc / cum
        inter = r_t @ s
        scores = torch.where(strictly_causal, r_t @ k_t.transpose(1, 2), 0.0)
        bonus = torch.sum((rc * ur) * kc, dim=2)
        outs.append(inter + scores @ vc + bonus[..., None] * vc)
        s = cum[:, -1, :, None] * (s + k_t.transpose(1, 2) @ vc)
    o = (torch.cat(outs, dim=1)[:, :t] if outs else
         torch.zeros((bh, 0, n), device=r.device)).to(r.dtype)
    return (o, s) if return_state else o


def chunk_products(r, k, v, w, u, *, chunk: int = 32, state=None,
                   return_state=False, mm=torch.matmul):
    """:func:`reference_rwkv6_chunked`'s function computed by kernel B7's
    route (off the main path: the tests hold it against the JAX package
    and emulate the kernel's tensor-core arithmetic through ``mm``, the
    function that takes each of the four products): the chunks in order,
    and per chunk the scores ``P = r̃k̃ᵀ`` (masked to ``τ < t``), the
    outputs ``o = r̃S + PV + ((r·u)·k)v`` summed in the type ``mm``
    returns and rounded once, and ``S ← Cum_{C-1}·(S + D)`` in float32
    with ``D = k̃ᵀV`` rounded to float32 first.  ``r̃``, ``k̃`` and the
    bonus are float32, as in :func:`reference_rwkv6_chunked`, whose
    arithmetic this is with ``torch.matmul``; the same padding."""
    bh, t, n = r.shape
    c = max(1, min(chunk, t))
    n_chunks = -(-t // c)
    pad = n_chunks * c - t
    rf, kf, vf, wf = (z.to(torch.float32) for z in (r, k, v, w))
    if pad:
        zeros = torch.zeros((bh, pad, n), dtype=torch.float32,
                            device=r.device)
        rf, kf, vf = (torch.cat([z, zeros], dim=1) for z in (rf, kf, vf))
        wf = torch.cat([wf, zeros + 1.0], dim=1)
    ur = row_bonus(u, bh)[:, None, :]
    s = (state.to(torch.float32) if state is not None else
         torch.zeros((bh, n, n), dtype=torch.float32, device=r.device))
    strictly_causal = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                            device=r.device), diagonal=-1)
    outs = []
    for ci in range(n_chunks):
        sl = slice(ci * c, (ci + 1) * c)
        rc, kc, vc, wc = rf[:, sl], kf[:, sl], vf[:, sl], wf[:, sl]
        cum = torch.cumprod(wc, dim=1)
        cum_prev = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]],
                             dim=1)
        r_t, k_t = rc * cum_prev, kc / cum
        scores = mm(r_t, k_t.transpose(1, 2))
        scores = torch.where(strictly_causal, scores, 0.0)
        bonus = torch.sum((rc * ur) * kc, dim=2)
        o = mm(r_t, s) + mm(scores, vc)
        outs.append((o + bonus[..., None].to(o.dtype) * vc.to(o.dtype))
                    .to(torch.float32))
        d = mm(k_t.transpose(1, 2), vc).to(torch.float32)
        s = cum[:, -1, :, None] * (s + d)
    o = (torch.cat(outs, dim=1)[:, :t] if outs else
         torch.zeros((bh, 0, n), device=r.device)).to(r.dtype)
    return (o, s) if return_state else o
