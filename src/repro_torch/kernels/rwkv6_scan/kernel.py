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

It runs as two custom operators, ``torch.ops.repro_torch.rwkv6_scan``
(:func:`scan_op`) and its in-place form ``rwkv6_scan_`` (:func:`scan_op_`,
which writes the final state into ``out_state``), whose implementation the
dispatcher picks by the tensors' device: the kernel on CUDA tensors (it
launches or raises), the plain version (``ref.py``) on CPU tensors, and on
fake or ``meta`` tensors a fake one that makes the outputs' shapes, dtypes
and strides and, on fake CUDA tensors, refuses what the kernel refuses.
Its operation count (:func:`rwkv6_ops`) is both its FLOP formula and the
work ``chip_smoke.py``'s bound reads.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from ...core.device import op_device
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
    None or ``(BH, N, N)``, all on one device."""
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
    op_device(ins, what)


def refuse(r, k, v, w, u, state, what: str, s_out=None) -> None:
    """Raise for what both RWKV6 kernels do not take (on the card and in a
    fake trace of them): r, k, v not contiguous or not of one dtype of
    :data:`DTYPES`, a head size outside :data:`HEAD_DIMS`, w or u of
    another dtype, a state or ``s_out`` that is not float32 and contiguous
    or of the wrong shape."""
    cuda_build.require({"r": r, "k": k, "v": v}, DTYPES, what)
    n = r.shape[2]
    if n not in HEAD_DIMS:
        raise ValueError(f"{what}: head size {n} (the kernel is built for "
                         f"{HEAD_DIMS})")
    for name, z in (("w", w), ("u", u)):
        if z.dtype not in DTYPES:
            raise TypeError(f"{what}: {name} is {z.dtype}, the kernel takes "
                            f"float32 (or bf16, widened)")
    if state is not None:
        cuda_build.require({"state": state}, (torch.float32,), what)
    if s_out is not None:
        cuda_build.require({"out_state": s_out}, (torch.float32,), what)
        if s_out.shape != (r.shape[0], n, n) or s_out.device != r.device:
            raise ValueError(f"{what}: out_state {tuple(s_out.shape)} on "
                             f"{s_out.device}, want {(r.shape[0], n, n)} on "
                             f"{r.device}")


def launch_args(r, k, v, w, u, state, return_state: bool, what: str,
                s_out=None):
    """What both RWKV6 launchers take, on CUDA tensors (:func:`refuse`
    first): r, k, v contiguous and of one dtype among :data:`DTYPES` (the
    output's too); w and u in float32 (a bf16 w or u is widened, which is
    exact); the optional state float32.  ``s_out``, when given, is the
    ``(BH, N, N)`` float32 tensor the final state goes to (else one is
    made when ``return_state``).  Returns ``(o, final state or None,
    [pointers of r, k, v, w, u, state in, state out, o], H, keep)``;
    ``keep`` holds the widened tensors alive until the launch."""
    refuse(r, k, v, w, u, state, what, s_out)
    n = r.shape[2]
    keep = [z.to(torch.float32).contiguous() for z in (w, u)]
    wf, uf = keep
    o = torch.empty_like(r)
    if s_out is None and return_state:
        s_out = torch.empty((r.shape[0], n, n), dtype=torch.float32,
                            device=r.device)
    ptrs = [r.data_ptr(), k.data_ptr(), v.data_ptr(), wf.data_ptr(),
            uf.data_ptr(), None if state is None else state.data_ptr(),
            None if s_out is None else s_out.data_ptr(), o.data_ptr()]
    return o, s_out, ptrs, 1 if u.dim() == 1 else u.shape[0], keep


def fresh_state(s, state):
    """The plain version's final state ``s``, cloned where it is the
    initial one (no step taken): an operator's output is never one of its
    inputs."""
    return s.clone() if state is not None and s is state else s


def fake_outputs(r, return_state: bool):
    """The outputs' stand-ins: o as r, the state ``(BH, N, N)`` float32 or
    an empty ``(0,)`` one."""
    n = r.shape[2]
    hs = (r.shape[0], n, n) if return_state else (0,)
    return r.new_empty(r.shape), r.new_empty(hs, dtype=torch.float32)


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
    check_inputs(r, k, v, w, u, state, "rwkv6_scan")
    t = r.shape[1]
    assert t % chunk == 0 or t < chunk, (t, chunk)
    if out_state is not None:
        op_device({"r": r, "out_state": out_state}, "rwkv6_scan")
        return scan_op_(r, k, v, w, u, state, out_state), out_state
    o, s = scan_op(r, k, v, w, u, state, return_state)
    return (o, s) if return_state else o


def _launch(r, k, v, w, u, state, return_state, s_out=None):
    o, s_out, ptrs, h, _keep = launch_args(r, k, v, w, u, state,
                                           return_state, "rwkv6_scan", s_out)
    bh, t, n = r.shape
    if bh:                             # else no block to launch
        cuda_build.launch(
            "repro_rwkv6_scan_fwd", "ppppppppiiiiip",
            [*ptrs, cuda_build.DTYPE_CODES[r.dtype], bh, t, n, h], r.device)
        LAUNCHES["rwkv6_scan"] += 1
    return o, s_out


@torch.library.custom_op("repro_torch::rwkv6_scan", mutates_args=(),
                         device_types="cpu")
def scan_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor, state: Optional[torch.Tensor],
            return_state: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The operator: ``(o, final state)``, the state an empty ``(0,)``
    tensor unless ``return_state``; on CPU tensors the plain version."""
    o, s = reference_rwkv6(r, k, v, w, u, state=state, return_state=True)
    s = fresh_state(s, state) if return_state else s.new_empty((0,))
    return o.contiguous(), s


@scan_op.register_kernel("cuda")
def _scan_cuda(r, k, v, w, u, state, return_state):
    o, s = _launch(r, k, v, w, u, state, return_state)
    return o, s if return_state else o.new_empty((0,), dtype=torch.float32)


@scan_op.register_fake
def _scan_fake(r, k, v, w, u, state, return_state):
    if r.device.type == "cuda":
        refuse(r, k, v, w, u, state, "rwkv6_scan")
    return fake_outputs(r, return_state)


@torch.library.custom_op("repro_torch::rwkv6_scan_",
                         mutates_args=("out_state",), device_types="cpu")
def scan_op_(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, state: Optional[torch.Tensor],
             out_state: torch.Tensor) -> torch.Tensor:
    """The in-place operator: o, the final state written into
    ``out_state`` (which may be ``state``); on CPU tensors the plain
    version."""
    o, s = reference_rwkv6(r, k, v, w, u, state=state, return_state=True)
    out_state.copy_(s)
    return o.contiguous()


@scan_op_.register_kernel("cuda")
def _scan_cuda_(r, k, v, w, u, state, out_state):
    return _launch(r, k, v, w, u, state, True, out_state)[0]


@scan_op_.register_fake
def _scan_fake_(r, k, v, w, u, state, out_state):
    if r.device.type == "cuda":
        refuse(r, k, v, w, u, state, "rwkv6_scan", out_state)
    return r.new_empty(r.shape)


def rwkv6_ops(bh, t, n) -> dict:
    """B6's operations: per step and row ``sum_i r_i S_ij``, ``k_i v_j``
    and ``w_i S_ij + k_i v_j`` (3 N²) and the bonus ``(sum_i r_i u_i k_i)
    v_j`` (3 N), in float32."""
    return {"float32": bh * t * (3 * n * n + 3 * n)}


@register_flop_formula([torch.ops.repro_torch.rwkv6_scan,
                        torch.ops.repro_torch.rwkv6_scan_])
def scan_flops(r_shape, *args, out_shape=None, **kw) -> int:
    """FLOPs of one call: :func:`rwkv6_ops`' operations, one each."""
    return sum(rwkv6_ops(*r_shape).values())
