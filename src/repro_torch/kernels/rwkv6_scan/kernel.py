"""The RWKV6 (Finch) recurrence in CUDA C++ — kernel B6, the Hopper port of
``repro/kernels/rwkv6_scan/kernel.py:rwkv6_scan``.

The kernel is ``src/repro_torch/csrc/rwkv6_scan.cu`` (its header says what
bounds it and how it is laid out): one block per (batch x head) row, one
loop over T inside it, thread ``j`` holding the state column ``S[:, j]``
in float32 registers for the whole sequence, read from an optional
initial state and written to an optional final state; a decode step's
one token (T == 1) splits each column over 8 threads.  The final state
may overwrite the initial one in place (``out_state=state``), as the
decode graph's static cache has it.  It is built by :mod:`..cuda_build`
at first use.

On CPU tensors :func:`rwkv6_scan` runs the plain version (``ref.py``); on
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ...core.device import kernel_device
from .. import cuda_build
from .ref import reference_rwkv6

HEAD_DIMS = (32, 64)                # the head sizes the kernels are built for
DTYPES = (torch.float32, torch.bfloat16)

#: launches of the kernel (one per call on CUDA tensors); reset it to 0 to
#: count the launches of one run
LAUNCHES = {"rwkv6_scan": 0}


def check_inputs(r, k, v, w, u, state, what: str):
    """Raise unless r, k, v, w are one ``(BH, T, N)`` shape, ``u`` is
    ``(N,)`` or ``(H, N)`` with ``H`` dividing ``BH``, and ``state`` is
    None or ``(BH, N, N)``.  Returns the kernel's device (None on the CPU:
    the caller runs its plain version)."""
    bh, t, n = r.shape
    h = 1 if u.dim() == 1 else u.shape[0]
    if k.shape != r.shape or v.shape != r.shape or w.shape != r.shape \
            or u.shape[-1:] != (n,) or u.dim() > 2 or bh % h \
            or (state is not None and state.shape != (bh, n, n)):
        raise ValueError(
            f"{what}: shapes r {tuple(r.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, w {tuple(w.shape)}, u {tuple(u.shape)}, state "
            f"{None if state is None else tuple(state.shape)}")
    ins = {"r": r, "k": k, "v": v, "w": w, "u": u}
    if state is not None:
        ins["state"] = state
    return kernel_device(ins, what)


def launch_args(r, k, v, w, u, state, return_state: bool, what: str,
                s_out=None):
    """What both RWKV6 launchers take, on CUDA tensors: r, k, v contiguous
    and of one dtype among :data:`DTYPES` (the output's too); w and u in
    float32 (a bf16 w or u is widened, which is exact); the optional state
    float32.  ``s_out``, when given, is the ``(BH, N, N)`` float32 tensor
    the final state goes to (else one is made when ``return_state``).
    Returns ``(o, final state or None, [pointers of r, k, v, w,
    u, state in, state out, o], H, keep)``; ``keep`` holds the widened
    tensors alive until the launch."""
    cuda_build.require({"r": r, "k": k, "v": v}, DTYPES, what)
    n = r.shape[2]
    if n not in HEAD_DIMS:
        raise ValueError(f"{what}: head size {n} (the kernel is built for "
                         f"{HEAD_DIMS})")
    keep = []
    for name, z in (("w", w), ("u", u)):
        if z.dtype not in DTYPES:
            raise TypeError(f"{what}: {name} is {z.dtype}, the kernel takes "
                            f"float32 (or bf16, widened)")
        keep.append(z.to(torch.float32).contiguous())
    if state is not None:
        cuda_build.require({"state": state}, (torch.float32,), what)
    wf, uf = keep
    o = torch.empty_like(r)
    if s_out is not None:
        cuda_build.require({"out_state": s_out}, (torch.float32,), what)
        if s_out.shape != (r.shape[0], n, n) or s_out.device != r.device:
            raise ValueError(f"{what}: out_state {tuple(s_out.shape)} on "
                             f"{s_out.device}, want {(r.shape[0], n, n)} on "
                             f"{r.device}")
    elif return_state:
        s_out = torch.empty((r.shape[0], n, n), dtype=torch.float32,
                            device=r.device)
    ptrs = [r.data_ptr(), k.data_ptr(), v.data_ptr(), wf.data_ptr(),
            uf.data_ptr(), None if state is None else state.data_ptr(),
            None if s_out is None else s_out.data_ptr(), o.data_ptr()]
    return o, s_out, ptrs, 1 if u.dim() == 1 else u.shape[0], keep


def rwkv6_scan(r, k, v, w, u, *, chunk: int = 64, state=None,
               return_state: bool = False, out_state=None):
    """r, k, v, w: ``(BH, T, N)``; u: ``(N,)``, one bonus for every row, or
    ``(H, N)``, row ``b·H + h`` taking ``u[h]``.  Returns o: ``(BH, T,
    N)`` in ``r.dtype``, and with ``return_state`` the final float32
    ``(BH, N, N)`` state too; ``state`` is the initial one (zeros when
    None).  ``w`` is the per-token, per-channel decay (already
    ``exp(-exp(.))``'d).  ``T`` must be a multiple of ``chunk`` or below
    it, as the TPU kernel asserts.  ``out_state``: a float32 ``(BH, N,
    N)`` tensor the final state is written into and returned as (it may be
    ``state`` itself, updated in place); implies ``return_state``."""
    device = check_inputs(r, k, v, w, u, state, "rwkv6_scan")
    bh, t, n = r.shape
    assert t % chunk == 0 or t < chunk, (t, chunk)
    return_state = return_state or out_state is not None
    if device is None:
        out = reference_rwkv6(r, k, v, w, u, state=state,
                              return_state=return_state)
        if out_state is None:
            return out
        return out[0], out_state.copy_(out[1])
    o, s_out, ptrs, h, _keep = launch_args(r, k, v, w, u, state,
                                           return_state, "rwkv6_scan",
                                           out_state)
    if bh == 0:                        # no block to launch
        return (o, s_out) if return_state else o
    cuda_build.launch(
        "repro_rwkv6_scan_fwd", "ppppppppiiiiip",
        [*ptrs, cuda_build.DTYPE_CODES[r.dtype], bh, t, n, h], device)
    LAUNCHES["rwkv6_scan"] += 1
    return (o, s_out) if return_state else o
