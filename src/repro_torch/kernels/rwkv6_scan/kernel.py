"""The RWKV6 (Finch) recurrence in CUDA C++ — kernel B6, the Hopper port of
``repro/kernels/rwkv6_scan/kernel.py:rwkv6_scan``.

The kernel is ``src/repro_torch/csrc/rwkv6_scan.cu`` (its header says what
bounds it and how it is laid out): one block per (batch x head) row, one
loop over T inside it, thread ``j`` holding the state column ``S[:, j]``
in float32 registers for the whole sequence.  It is built by
:mod:`..cuda_build` at first use.

On CPU tensors :func:`rwkv6_scan` runs the plain version (``ref.py``); on
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ...core.device import kernel_device
from .. import cuda_build
from .ref import reference_rwkv6

HEAD_DIMS = (32, 64)                # the head sizes the kernel is built for
DTYPES = (torch.float32, torch.bfloat16)

#: launches of the kernel (one per call on CUDA tensors); reset it to 0 to
#: count the launches of one run
LAUNCHES = {"rwkv6_scan": 0}


def rwkv6_scan(r, k, v, w, u, *, chunk: int = 64) -> torch.Tensor:
    """r, k, v, w: ``(BH, T, N)``; u: ``(N,)``, one bonus for every row.
    Returns o: ``(BH, T, N)`` in ``r.dtype``.  ``w`` is the per-token,
    per-channel decay (already ``exp(-exp(.))``'d).  ``T`` must be a
    multiple of ``chunk`` or below it, as the TPU kernel asserts."""
    bh, t, n = r.shape
    if k.shape != r.shape or v.shape != r.shape or w.shape != r.shape \
            or u.shape != (n,):
        raise ValueError(f"shapes r {tuple(r.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, w {tuple(w.shape)}, u "
                         f"{tuple(u.shape)}")
    assert t % chunk == 0 or t < chunk, (t, chunk)
    ins = {"r": r, "k": k, "v": v, "w": w, "u": u}
    device = kernel_device(ins, "rwkv6_scan")
    if device is None:
        return reference_rwkv6(r, k, v, w, u)
    cuda_build.require(ins, DTYPES, "rwkv6_scan")
    if n not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan: head size {n} (the kernel is built "
                         f"for {HEAD_DIMS})")
    o = torch.empty_like(r)
    if o.numel() == 0:
        return o
    cuda_build.launch(
        "repro_rwkv6_scan_fwd", "ppppppiiiip",
        [r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
         u.data_ptr(), o.data_ptr(), cuda_build.DTYPE_CODES[r.dtype], bh, t,
         n], device)
    LAUNCHES["rwkv6_scan"] += 1
    return o
