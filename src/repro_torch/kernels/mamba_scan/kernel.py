"""Selective state-space (Mamba) scan in CUDA C++ — kernel B5, the Hopper
port of ``repro/kernels/mamba_scan/kernel.py:mamba_scan``.

The kernel is ``src/repro_torch/csrc/mamba_scan.cu`` (its header says what
bounds it and how it is laid out): one loop over T inside each block, work
split over (batch, channel), four lanes per channel holding the float32
state in registers, B_t and C_t staged in shared memory.  It is built by
:mod:`..cuda_build` at first use.

On CPU tensors :func:`mamba_scan` runs the plain version (``ref.py``); on
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ...core.device import kernel_device
from .. import cuda_build
from .ref import reference_mamba

MAX_STATE = 64                      # the widest d_state the kernel holds
DTYPES = (torch.float32, torch.bfloat16)

#: launches of the kernel (one per call on CUDA tensors); reset it to 0 to
#: count the launches of one run
LAUNCHES = {"mamba_scan": 0}


def mamba_scan(x, dt, b, c, a, d, *, chunk: int = 64) -> torch.Tensor:
    """x, dt: ``(B, T, d_inner)``; b, c: ``(B, T, d_state)``; a: ``(d_inner,
    d_state)``; d: ``(d_inner,)``.  Returns y: ``(B, T, d_inner)`` in
    ``x.dtype``.  ``chunk`` is the TPU kernel's sequence tile: it must be
    positive and changes nothing else, as there."""
    bsz, t, d_inner = x.shape
    d_state = b.shape[-1]
    if dt.shape != x.shape or b.shape != (bsz, t, d_state) \
            or c.shape != b.shape or a.shape != (d_inner, d_state) \
            or d.shape != (d_inner,):
        raise ValueError(f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"b {tuple(b.shape)}, c {tuple(c.shape)}, a "
                         f"{tuple(a.shape)}, d {tuple(d.shape)}")
    if chunk < 1:
        raise ValueError(f"chunk {chunk}")
    ins = {"x": x, "dt": dt, "b": b, "c": c, "a": a, "d": d}
    device = kernel_device(ins, "mamba_scan")
    if device is None:
        return reference_mamba(x, dt, b, c, a, d)
    cuda_build.require(ins, DTYPES, "mamba_scan")
    if not 1 <= d_state <= MAX_STATE:
        raise ValueError(f"mamba_scan: d_state {d_state} (the kernel holds "
                         f"1 to {MAX_STATE})")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    cuda_build.launch(
        "repro_mamba_scan_fwd", "pppppppiiiiip",
        [x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
         a.data_ptr(), d.data_ptr(), y.data_ptr(),
         cuda_build.DTYPE_CODES[x.dtype], bsz, t, d_inner, d_state], device)
    LAUNCHES["mamba_scan"] += 1
    return y
