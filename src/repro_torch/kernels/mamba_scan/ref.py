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


#: log2(e) rounded to float32, as the kernel scales A by it
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)


def _fma(a, b, c):
    """``a·b + c`` rounded once to float32, as the card's FFMA: the
    product of two float32 values is exact in float64, and its sum with
    ``c`` is rounded there and then to float32 (a double rounding that
    differs from one rounding only on rare ties)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def route_mamba(x, dt, b, c, a, d, *, lanes: int, spl: int):
    """The kernel's route (``csrc/mamba_scan.cu``) in plain PyTorch, for the
    CPU tests: A pre-scaled by :data:`LOG2E` in float32, each decay
    ``exp2(dt · A')`` of float32 operands, ``h = fma(decay, h, (dt·x)·B)``,
    each of the ``lanes`` lanes summing its ``spl`` states' ``h·C`` in
    state order by FMAs from ``D·x`` (lane 0) or 0, and y the lanes'
    partial sums added in lane order, then rounded to ``x.dtype``.  Not
    bitwise the card (its ``ex2.approx`` is within 2 ulp of ``exp2``), but
    the same operations in the same order."""
    bsz, t, d_inner = x.shape
    d_state = b.shape[-1]
    g = lanes * spl
    if g < d_state:
        raise ValueError(f"{lanes} lanes x {spl} states < d_state {d_state}")
    pad = (0, g - d_state)
    xf, dtf = x.to(torch.float32), dt.to(torch.float32)
    bf = torch.nn.functional.pad(b.to(torch.float32), pad)
    cf = torch.nn.functional.pad(c.to(torch.float32), pad)
    a2 = torch.nn.functional.pad(a.to(torch.float32), pad) * LOG2E
    df = d.to(torch.float32)
    h = torch.zeros((bsz, d_inner, g), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(t):
        dti, xi = dtf[:, i, :, None], xf[:, i]
        dx = (dtf[:, i] * xi)[:, :, None]
        h = _fma(torch.exp2(dti * a2[None]), h, dx * bf[:, i, None, :])
        parts = []
        for lane in range(lanes):
            p = df * xi if lane == 0 else torch.zeros_like(xi)
            for j in range(lane * spl, (lane + 1) * spl):
                p = _fma(h[:, :, j], cf[:, i, None, j], p)
            parts.append(p)
        y = parts[0]
        for p in parts[1:]:
            y = y + p
        ys.append(y)
    y = (torch.stack(ys, dim=1) if ys else
         torch.zeros((bsz, 0, d_inner), device=x.device))
    return y.to(x.dtype)
