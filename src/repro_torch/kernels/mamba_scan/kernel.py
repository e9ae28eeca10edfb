"""Selective state-space (Mamba) scan in CUDA C++ — kernel B5, the Hopper
port of ``repro/kernels/mamba_scan/kernel.py:mamba_scan``.

The kernel is ``src/repro_torch/csrc/mamba_scan.cu`` (its header says what
bounds it and how it is laid out): one loop over T inside each block, work
split over (batch, channel, state), a thread holding 2 channels x ``spl``
states in float32 registers (``lanes`` threads a channel, 64 channels a
block), the decay as one ``ex2`` of a pre-scaled A, x/dt/B/C tiles
streamed into shared memory by ``cp.async`` while the scan runs, and the
lanes' partial outputs summed once a tile.  :func:`layout` picks
``lanes`` and ``spl`` for each ``d_state``.  The state may start from a
given one and its final value may be written out, over the initial one
in place if asked (``out_state=state``, as a served decode step's static
cache has it).  It is built by :mod:`..cuda_build` at first use.

On CPU tensors :func:`mamba_scan` runs the plain version
(``ref.py:reference_mamba``; ``ref.py:route_mamba`` emulates the kernel's
roundings); on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ...core.device import kernel_device
from .. import cuda_build
from .ref import reference_mamba

MAX_STATE = 64                      # the widest d_state the kernel holds
DTYPES = (torch.float32, torch.bfloat16)


def layout(d_state: int) -> tuple:
    """``(lanes, spl)`` of the kernel for ``d_state``: ``lanes`` threads a
    channel, each holding ``spl`` of its states — 4 (2 for a d_state of 1
    or 2), the fastest of ``tools/mamba_layouts.py``'s sweep on an H100 —
    and as few lanes as cover ``d_state``."""
    if not 1 <= d_state <= MAX_STATE:
        raise ValueError(f"mamba_scan: d_state {d_state} (the kernel holds "
                         f"1 to {MAX_STATE})")
    spl = 2 if d_state <= 2 else 4
    return -(-d_state // spl), spl


#: launches of the kernel (one per call on CUDA tensors); reset it to 0 to
#: count the launches of one run
LAUNCHES = {"mamba_scan": 0}


def mamba_scan(x, dt, b, c, a, d, *, chunk: int = 64, state=None,
               return_state: bool = False, out_state=None):
    """x, dt: ``(B, T, d_inner)``; b, c: ``(B, T, d_state)``; a: ``(d_inner,
    d_state)``; d: ``(d_inner,)``.  Returns y: ``(B, T, d_inner)`` in
    ``x.dtype``, and with ``return_state`` the final float32 ``(B,
    d_inner, d_state)`` state too; ``state`` is the initial one (zeros
    when None; float32 on the card).  ``out_state``: a float32 ``(B,
    d_inner, d_state)`` tensor the final state is written into and
    returned as (it may be ``state`` itself, updated in place); implies
    ``return_state``.  ``chunk`` is the TPU kernel's sequence tile: it must
    be positive and changes nothing else, as there."""
    bsz, t, d_inner = x.shape
    d_state = b.shape[-1]
    hs = (bsz, d_inner, d_state)
    if dt.shape != x.shape or b.shape != (bsz, t, d_state) \
            or c.shape != b.shape or a.shape != (d_inner, d_state) \
            or d.shape != (d_inner,) \
            or (state is not None and state.shape != hs) \
            or (out_state is not None and out_state.shape != hs):
        raise ValueError(
            f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, b "
            f"{tuple(b.shape)}, c {tuple(c.shape)}, a {tuple(a.shape)}, d "
            f"{tuple(d.shape)}, state "
            f"{None if state is None else tuple(state.shape)}, out_state "
            f"{None if out_state is None else tuple(out_state.shape)}")
    if chunk < 1:
        raise ValueError(f"chunk {chunk}")
    return_state = return_state or out_state is not None
    ins = {"x": x, "dt": dt, "b": b, "c": c, "a": a, "d": d}
    states = {k: v for k, v in (("state", state), ("out_state", out_state))
              if v is not None}
    device = kernel_device({**ins, **states}, "mamba_scan")
    if device is None:
        out = reference_mamba(x, dt, b, c, a, d, state=state,
                              return_state=return_state)
        if out_state is None:
            return out
        return out[0], out_state.copy_(out[1])
    cuda_build.require(ins, DTYPES, "mamba_scan")
    if states:
        cuda_build.require(states, (torch.float32,), "mamba_scan")
    lanes, spl = layout(d_state)
    y = torch.empty_like(x)
    h_out = out_state
    if h_out is None and return_state:
        h_out = torch.empty(hs, dtype=torch.float32, device=x.device)
    if y.numel() == 0:            # no step to take: h_T is h_0
        if h_out is not None and state is not None:
            h_out.copy_(state)
        elif h_out is not None:
            h_out.zero_()
        return (y, h_out) if return_state else y
    cuda_build.launch(
        "repro_mamba_scan_fwd", "pppppppppiiiiiiip",
        [x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
         a.data_ptr(), d.data_ptr(),
         None if state is None else state.data_ptr(),
         None if h_out is None else h_out.data_ptr(), y.data_ptr(),
         cuda_build.DTYPE_CODES[x.dtype], bsz, t, d_inner, d_state, lanes,
         spl], device)
    LAUNCHES["mamba_scan"] += 1
    return (y, h_out) if return_state else y
